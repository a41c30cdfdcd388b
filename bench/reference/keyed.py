"""Per-request silicon thresholds from raw uint32 key words: a frozen copy
of the counter-based arithmetic the serving determinism contract fixes.

Threefry-2x32 with 20 rounds (Salmon et al., SC 2011) keyed by a row's
two words, evaluated at counter (sample, pass << 22 | row << 2 | stream)
with stream 0 for V_ref, 1 for the strobe jitter and 2 for the per-row
offset; Box-Muller in float64 (u1 = (w0 + 1) / 2**32, u2 = w1 / 2**32),
rounded to float32.  `float64=False` runs Box-Muller in float32: the
precision control.
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, c0, c1):
    """Two output words, int64 tensors in [0, 2**32)."""
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


def normals(key_words: torch.Tensor, n_passes: int, n_rows: int,
            stream: int, float64: bool = True) -> torch.Tensor:
    """[P, 1, B, n_rows] float32 standard normals of B keys [B, 2] (one
    Monte-Carlo sample)."""
    ar = dict(dtype=torch.int64, device=key_words.device)
    sample = torch.arange(1, **ar)[None, :, None, None]
    passes = torch.arange(n_passes, **ar)[:, None, None, None]
    rows = torch.arange(n_rows, **ar)[None, None, None, :]
    k = key_words[None, None, :, None, :]
    w0, w1 = threefry2x32(k[..., 0], k[..., 1], sample,
                          (passes << 22) | (rows << 2) | stream)
    ft = torch.float64 if float64 else torch.float32
    u1 = (w0.to(ft) + 1.0) * 2.0 ** -32
    u2 = w1.to(ft) * 2.0 ** -32
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
    return z.to(torch.float32)


def thresholds(key_words: torch.Tensor, base: torch.Tensor,
               m_logical: torch.Tensor, dm_dvref: torch.Tensor, noise: dict,
               n_rows: int, float64: bool = True) -> torch.Tensor:
    """Effective thresholds [P, 1, B, n_rows] float32: per (pass, key)
    one V_ref and one strobe draw, a per-row draw, on the base sweep."""
    p = base.shape[0]
    lead = (p, 1, 1, 1)
    z_v = normals(key_words, p, 1, 0, float64)
    z_t = normals(key_words, p, 1, 1, float64)
    z_r = normals(key_words, p, n_rows, 2, float64)
    dv = noise["sigma_vref"] * z_v
    tj = 1.0 + noise["sigma_tjitter"] * z_t
    row = noise["sigma_hd"] * z_r
    delta = (dm_dvref.reshape(lead) * dv
             + m_logical.reshape(lead) * (1.0 / torch.clamp(tj, min=0.5)
                                          - 1.0)
             + row + noise["temp_drift_hd"])
    return base.reshape(lead) + delta
