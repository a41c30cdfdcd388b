"""The keyed sampler: per-request effective thresholds from key words.

    out[p, s, b, r] = thresholds[p] + combine_deltas(z_vref, z_tj, z_row)

with the three normals of row b drawn from Threefry-2x32 on b's own key
words (`core/keys.py`: V_ref and strobe once per (pass, sample), one per
row) and the threshold arithmetic of `core/physics.py` `combine_deltas`.
`SearchPhysics.sample_keyed` calls it inside its `sampler` span.

`keyed_thresholds` launches `csrc/keyed_sampler.cu` for tensors on the
card (counted in `keyed_thresholds.launches`) and takes
`keyed_thresholds_plain` on the CPU: `keys.keyed_normals` for the three
streams, `physics.combine_deltas` and the base schedule, the composition
the kernel reproduces bit for bit on the card.  Nothing falls back: a
failed launch raises.  The port's own kernel; the reference draws its
silicon noise with `jax.random` and has no Pallas twin of it.
"""

from __future__ import annotations

import torch

from repro_torch.core import keys as _keys
from repro_torch.core import physics as _physics
from repro_torch.core.device_model import NoiseModel
from repro_torch.kernels import _build


def keyed_thresholds_plain(key_words: torch.Tensor, thresholds: torch.Tensor,
                           m_logical: torch.Tensor, dm_dvref: torch.Tensor,
                           noise: NoiseModel, n_rows: int,
                           n_samples: int = 1) -> torch.Tensor:
    """Plain PyTorch version: three `keyed_normals` streams, then
    `combine_deltas` on the base schedule, on the keys' device."""
    lead = (thresholds.shape[0], 1, 1, 1)
    z = [_keys.keyed_normals(key_words, n_samples, thresholds.shape[0], n,
                             stream)
         for n, stream in ((1, _keys.STREAM_VREF),
                           (1, _keys.STREAM_TJITTER),
                           (n_rows, _keys.STREAM_ROW))]
    delta = _physics.combine_deltas(noise, m_logical.reshape(lead),
                                    dm_dvref.reshape(lead), *z)
    return thresholds.reshape(lead) + delta


def _check(key_words, fields, n_rows, n_samples) -> None:
    if key_words.dtype != torch.int64:
        raise TypeError(f"key_words must be int64 uint32 words "
                        f"(keys.as_key_words), got {key_words.dtype}")
    if key_words.ndim != 2 or key_words.shape[1] != 2:
        raise ValueError(f"key_words must be [B, 2], got "
                         f"{tuple(key_words.shape)}")
    p = fields[0].shape[0] if fields[0].ndim == 1 else -1
    for name, f in zip(("thresholds", "m_logical", "dm_dvref"), fields):
        if f.dtype != torch.float32 or f.ndim != 1 or f.shape[0] != p:
            raise ValueError(f"{name} must be [P] float32 like thresholds, "
                             f"got {f.dtype} {tuple(f.shape)}")
        if f.device != key_words.device:
            raise ValueError(f"{name} is on {f.device}, key_words on "
                             f"{key_words.device}")
    if p > _keys.MAX_PASSES or not 0 <= n_rows <= _keys.MAX_ROWS:
        raise ValueError(f"counter fields hold {_keys.MAX_PASSES} passes and "
                         f"{_keys.MAX_ROWS} rows, got {p} and {n_rows}")
    if n_samples < 0:
        raise ValueError(f"n_samples must be >= 0, got {n_samples}")


def keyed_thresholds(key_words: torch.Tensor, thresholds: torch.Tensor,
                     m_logical: torch.Tensor, dm_dvref: torch.Tensor,
                     noise: NoiseModel, n_rows: int,
                     n_samples: int = 1) -> torch.Tensor:
    """Per-request thresholds ``[P, n_samples, B, n_rows]`` float32.

    key_words : [B, 2] int64 uint32 words (`keys.as_key_words`).
    thresholds, m_logical, dm_dvref : [P] float32, the `SearchPhysics`
        fields, on the keys' device.
    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    fields = (thresholds, m_logical, dm_dvref)
    _check(key_words, fields, n_rows, n_samples)
    if key_words.device.type == "cpu":
        return keyed_thresholds_plain(key_words, *fields, noise, n_rows,
                                      n_samples)
    if key_words.device.type != "cuda":
        raise ValueError(f"unsupported device {key_words.device}")
    return _launch(key_words, fields, noise, n_rows, n_samples)


keyed_thresholds.launches = 0


def _launch(key_words, fields, noise, n_rows, n_samples) -> torch.Tensor:
    p, b = fields[0].shape[0], key_words.shape[0]
    out = torch.empty((p, n_samples, b, n_rows), dtype=torch.float32,
                      device=key_words.device)
    if out.numel() == 0:
        return out
    k = key_words.contiguous()
    thr, m_log, dm = (f.contiguous() for f in fields)
    lib = _build.library("keyed_sampler")
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream(k.device).cuda_stream
        # ctypes rounds each Python float to float32, as PyTorch rounds a
        # Python scalar against a float32 tensor
        err = lib.keyed_thresholds_launch(
            k.data_ptr(), thr.data_ptr(), m_log.data_ptr(), dm.data_ptr(),
            float(noise.sigma_vref), float(noise.sigma_tjitter),
            float(noise.sigma_hd), float(noise.temp_drift_hd), p, n_samples,
            b, n_rows, out.data_ptr(), stream)
    _build.check(lib, err, "keyed_thresholds")
    keyed_thresholds.launches += 1
    return out
