"""Shared inputs for the tests of the PyTorch/CUDA port (`repro_torch`).

Every input is made with numpy from a seed and handed to both packages;
the JAX package is the reference.
"""

import numpy as np
import torch

from repro.core import bnn as jbnn
from repro_torch import convert

# Net shapes whose head rows (n_hidden + bias cells) land on each of the
# macro's three logical row widths (tests/test_pipeline.py's BANK_NETS).
BANK_NETS = {
    "512x256": (300, 192, 12),
    "1024x128": (784, 64, 10),
    "2048x64": (96, 32, 5),
}
BANK_BIAS = {"512x256": 64, "1024x128": 64, "2048x64": 32}
PAPER_NETS = {"mnist": (784, 128, 10), "hg": (4096, 128, 20)}


def random_folded(sizes, seed, bias_cells):
    """Random deployed net with fold-style parity-adjusted C_j, as the
    reference's folded layers and as the port's."""
    rng = np.random.default_rng(seed)
    layers = []
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        c = jbnn.parity_adjust_c(
            rng.integers(-bias_cells, bias_cells + 1, n_out), n_in, bias_cells
        )
        layers.append(jbnn.FoldedLayer(
            weights_pm1=rng.choice([-1, 1], (n_out, n_in)).astype(np.int8),
            c=c,
        ))
    return layers, convert.folded_from_jax(layers)


def pm1(rng, shape):
    """Random ±1 float32 activations."""
    return rng.choice([-1.0, 1.0], shape).astype(np.float32)


def packed(rng, n, k):
    """Random packed rows as (uint32 numpy words, the port's int32 tensor)."""
    from repro.core import binarize as jbin

    words = jbin.np_pack_bits(rng.integers(0, 2, (n, k)).astype(np.uint8))
    return words, convert.rows_from_jax(words)


def i32(a):
    """Any int array/tensor -> int32 numpy view for bit-exact compares."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32)
