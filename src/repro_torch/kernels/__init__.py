"""Hand-written CUDA kernels for the Hopper card (sources in `csrc/`),
each beside its plain PyTorch version (port of `repro.kernels`).

  binary_gemm — kernel 1, bit-packed XNOR-popcount GEMM (Hamming
                distances); the custom op `repro_torch::binary_gemm_hd`
  cam_search  — kernel 2, the fused multi-threshold CAM vote (Algorithm 1
                in one pass); the custom op `repro_torch::cam_vote`
  fused_mlp   — kernel 3, the whole deployed BNN in one launch
  fused_conv  — kernel 4, the end-to-end binary CNN in one launch
  ops         — public wrappers
  ref         — plain-PyTorch oracles used by the tests
"""

from repro_torch.kernels import ops, ref  # noqa: F401
