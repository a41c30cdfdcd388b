"""Row-wise passes of the LM's activations in one launch each.

    rms_norm(x, scale, eps) -> x * rsqrt(mean(x^2) + eps) * scale, in
        float32 on each row of x [..., D], in x's dtype (the port's RMS
        norm, `models/layers.py` `apply_norm`);
    sign_rows(x) -> (bits, beta): a BitLinear input's operands, the rows'
        packed sign bits [..., ceil(D/32)] (x >= 0 -> 1) and beta = E|x|
        [...] in x's dtype.

Each launches `csrc/rows.cu` for plain bfloat16 tensors on the card with
nothing to differentiate (counted in `.launches`) and otherwise (a CPU
tensor, a DTensor or fake tensor, a training step) takes its plain
PyTorch version (`*_plain`),
the composition the kernel reproduces (a norm's output or a beta may
differ from it in the last bfloat16 bit: another summation order; the
sign bits are equal).
"""

from __future__ import annotations

import torch

from repro_torch.core.binarize import pack_bits
from repro_torch.kernels import _build

F32 = torch.float32


def rms_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """Plain PyTorch version of `rms_norm`."""
    xf = x.to(F32)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(F32)).to(x.dtype)


def sign_rows_plain(x: torch.Tensor):
    """Plain PyTorch version of `sign_rows`."""
    return pack_bits((x >= 0).to(torch.uint8)), x.abs().mean(-1)


def _on_card(x: torch.Tensor, *params: torch.Tensor) -> bool:
    """A plain bfloat16 tensor on the card, and nothing to differentiate
    (the kernels have no backward)."""
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (x, *params))
    return (type(x) is torch.Tensor and x.is_cuda
            and x.dtype == torch.bfloat16 and not grad)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
    """x [..., D], scale [D] -> [..., D] in x's dtype."""
    if not _on_card(x, scale):
        return rms_norm_plain(x, scale, eps)
    d = x.shape[-1]
    xc, sc = x.contiguous(), scale.to(x.dtype).contiguous()
    y = torch.empty_like(xc)
    lib = _build.library("rows")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rms_norm_rows_launch(xc.data_ptr(), sc.data_ptr(),
                                       xc.numel() // d, d, float(eps),
                                       y.data_ptr(), stream)
    _build.check(lib, err, "rms_norm_rows")
    rms_norm.launches += 1
    return y


rms_norm.launches = 0


def sign_rows(x: torch.Tensor):
    """x [..., D] -> (bits [..., ceil(D/32)] int32, beta [...])."""
    if not _on_card(x):
        return sign_rows_plain(x)
    *lead, d = x.shape
    xc = x.contiguous()
    bits = torch.empty((*lead, -(-d // 32)), dtype=torch.int32,
                       device=x.device)
    beta = torch.empty(lead, dtype=x.dtype, device=x.device)
    lib = _build.library("rows")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sign_rows_launch(xc.data_ptr(), xc.numel() // d, d,
                                   bits.data_ptr(), beta.data_ptr(), stream)
    _build.check(lib, err, "sign_rows")
    sign_rows.launches += 1
    return bits, beta


sign_rows.launches = 0
