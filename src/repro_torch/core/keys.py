"""Counter-based normals keyed by raw uint32 words (the port's counterpart
of the reference's per-request `jax.random` keys).

A per-request silicon draw must depend only on the request's own key,
never on which other requests share its batch or how the batch is
padded.  A `torch.Generator` cannot give that (its stream is shared by
the whole call), so each request's draws come from Threefry-2x32 with
20 rounds (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3",
SC 2011; the generator the reference's `jax.random` also uses), keyed by
the request's two uint32 words and evaluated at a counter that names the
draw:

    counter word 0 = Monte-Carlo sample index
    counter word 1 = pass << 22 | row << 2 | stream

`stream` separates the V_ref (0), strobe-jitter (1) and per-row (2)
draws; pass-global draws use row 0.  The two output words become one
standard normal by Box-Muller in float64 (u1 = (w0 + 1) / 2**32 in
(0, 1], u2 = w1 / 2**32), rounded to float32 at the end.

Everything is plain PyTorch int64/float64 arithmetic on whatever device
the keys are on.  The same key gives the same words on every device;
the float64 transcendentals may differ between devices in the last bit,
which rounding to float32 hides except within an ulp of a rounding
boundary.  The streams differ from `jax.random`'s (the reference derives
its draws by key splitting), so the two packages agree in distribution,
not draw for draw.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
MAX_PASSES = 1 << 10  # pass field of counter word 1
MAX_ROWS = 1 << 20  # row field of counter word 1
STREAM_VREF, STREAM_TJITTER, STREAM_ROW = 0, 1, 2


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, c0: torch.Tensor,
                 c1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds, on int64 tensors holding uint32 values
    (broadcast together).  Returns the two output words, int64 in
    [0, 2**32)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + ks[0]) & _MASK
    x1 = (c1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def as_key_words(keys, device=None) -> torch.Tensor:
    """Raw uint32 [..., 2] key words (numpy uint32/int32/int64, a torch
    int32 view or int64 tensor) -> int64 tensor in [0, 2**32)."""
    if isinstance(keys, torch.Tensor):
        if keys.is_floating_point() or keys.dtype == torch.bool:
            raise TypeError(f"keys must be integer words, got {keys.dtype}")
        return keys.to(device=device or keys.device,
                       dtype=torch.int64) & _MASK
    a = np.asarray(keys)
    if a.dtype.kind not in "iu":
        raise TypeError(f"keys must be integer words, got {a.dtype}")
    return torch.from_numpy(a.astype(np.int64) & _MASK).to(device)


def keyed_normals(key_words: torch.Tensor, n_samples: int, n_passes: int,
                  n_rows: int, stream: int) -> torch.Tensor:
    """[P, S, B, n_rows] float32 standard normals for B keys [B, 2]:
    sample s, pass p of key b, row r is the normal at counter
    (s, p << 22 | r << 2 | stream) under key b."""
    if n_passes > MAX_PASSES or n_rows > MAX_ROWS:
        raise ValueError(f"counter fields hold {MAX_PASSES} passes and "
                         f"{MAX_ROWS} rows, got {n_passes} and {n_rows}")
    ar = dict(dtype=torch.int64, device=key_words.device)
    sample = torch.arange(n_samples, **ar)[None, :, None, None]
    passes = torch.arange(n_passes, **ar)[:, None, None, None]
    rows = torch.arange(n_rows, **ar)[None, None, None, :]
    k = key_words[None, None, :, None, :]
    w0, w1 = threefry2x32(k[..., 0], k[..., 1], sample,
                          (passes << 22) | (rows << 2) | stream)
    u1 = (w0.to(torch.float64) + 1.0) * 2.0 ** -32
    u2 = w1.to(torch.float64) * 2.0 ** -32
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
    return z.to(torch.float32)
