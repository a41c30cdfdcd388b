"""PyTorch/CUDA port of the PiC-BNN reproduction (`src/repro/` is the
JAX reference it is held against).

The layout mirrors the reference so each module has one counterpart:
`core/` (bit packing, folding, CAM arrays, the Algorithm-1 head),
`kernels/` (hand-written CUDA kernels for the Hopper card, each with a
plain PyTorch version beside it), `spec.py`, `pipeline.py`,
`configs/`, `serve/`, and `convert.py` for weights carried across from
the JAX package.  Nothing here imports `jax` or `repro`.

Packed bit vectors are `torch.int32` tensors holding the bit pattern of
the reference's little-endian `uint32` words; the kernels reinterpret
them as `uint32`.
"""
