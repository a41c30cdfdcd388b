"""The dropless BitLinear MoE's steps around kernel 1's grouped entry.

    swiglu_signs(hd, alpha, beta, expert, k_in) -> (bits, beta_act)
        from the sorted slots' gate and up distances [S, 2F] (gate
        columns first) and their experts' alphas [E, 2F]: gate and up
        = (k_in - 2 HD) * alpha[expert] * beta, rounded to the dtype;
        act = silu(gate) * up; the down projection's operands, act's
        packed sign bits [S, ceil(F/32)] and beta_act = E|act| [S].
    combine(hd, alpha, beta, expert, back, gate, k_in) -> y [T, D]
        each slot's down output (k_in - 2 HD) * alpha[expert] * beta and
        each token's gate-weighted sum of its k slots (slot t * k + j
        sits at sorted row back[t * k + j]), in float32, j in order.

Each launches `csrc/expert_ffn.cu` for bfloat16 tensors on the card
(counted in `.launches`) and otherwise takes its plain PyTorch version
(`*_plain`), the composition the kernels reproduce (the kernel's beta_act
may differ from it in its last bfloat16 bit: another summation order).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.binarize import pack_bits
from repro_torch.kernels import _build

F32 = torch.float32


def _scaled(hd, alpha, beta, expert, k_in) -> torch.Tensor:
    """(k_in - 2 HD) * alpha[expert] * beta in float32, in beta's dtype."""
    return ((k_in - 2 * hd).to(F32) * alpha[expert] * beta[:, None]).to(
        beta.dtype)


def swiglu_signs_plain(hd, alpha, beta, expert, k_in: int):
    """Plain PyTorch version of `swiglu_signs`."""
    f = hd.shape[1] // 2
    v = _scaled(hd, alpha, beta, expert, k_in)
    act = F.silu(v[:, :f].to(F32)).to(v.dtype) * v[:, f:]
    return pack_bits((act >= 0).to(torch.uint8)), act.abs().mean(-1)


def combine_values(v: torch.Tensor, back: torch.Tensor,
                   gate: torch.Tensor) -> torch.Tensor:
    """Each token's gate-weighted sum of its slots' outputs v [S, D]
    (sorted), in float32, slot j = 0, 1, ... in order; in v's dtype."""
    t, k = gate.shape
    vt = v[back].view(t, k, -1).to(F32)
    y = vt[:, 0] * gate[:, :1]
    for j in range(1, k):
        y = y + vt[:, j] * gate[:, j:j + 1]
    return y.to(v.dtype)


def combine_plain(hd, alpha, beta, expert, back, gate, k_in: int):
    """Plain PyTorch version of `combine`."""
    return combine_values(_scaled(hd, alpha, beta, expert, k_in), back, gate)


def _on_card(hd: torch.Tensor, beta: torch.Tensor) -> bool:
    return hd.is_cuda and beta.dtype == torch.bfloat16


def swiglu_signs(hd: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                 expert: torch.Tensor, k_in: int):
    """hd [S, 2F] int32, alpha [E, 2F], beta [S] (the activations' dtype),
    expert [S] int32 -> (bits [S, ceil(F/32)] int32, beta_act [S])."""
    if not _on_card(hd, beta):
        return swiglu_signs_plain(hd, alpha, beta, expert, k_in)
    s, f2 = hd.shape
    f = f2 // 2
    bits = torch.empty((s, -(-f // 32)), dtype=torch.int32, device=hd.device)
    beta_act = torch.empty((s,), dtype=beta.dtype, device=hd.device)
    args = [t.contiguous() for t in (hd, alpha, beta, expert.to(torch.int32))]
    lib = _build.library("expert_ffn")
    with torch.cuda.device(hd.device):
        stream = torch.cuda.current_stream(hd.device).cuda_stream
        err = lib.expert_swiglu_signs_launch(
            *(a.data_ptr() for a in args), s, f, k_in, bits.data_ptr(),
            beta_act.data_ptr(), stream)
    _build.check(lib, err, "expert_swiglu_signs")
    swiglu_signs.launches += 1
    return bits, beta_act


swiglu_signs.launches = 0


def combine(hd: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
            expert: torch.Tensor, back: torch.Tensor, gate: torch.Tensor,
            k_in: int) -> torch.Tensor:
    """hd [S, D] int32, alpha [E, D], beta [S], expert [S] int32, back
    [T * k] int64, gate [T, k] float32 -> y [T, D] in beta's dtype."""
    if not _on_card(hd, beta):
        return combine_plain(hd, alpha, beta, expert, back, gate, k_in)
    t, k = gate.shape
    n = hd.shape[1]
    y = torch.empty((t, n), dtype=beta.dtype, device=hd.device)
    args = [a.contiguous() for a in (hd, alpha, beta, expert.to(torch.int32),
                                     back.to(torch.int64), gate.to(F32))]
    lib = _build.library("expert_ffn")
    with torch.cuda.device(hd.device):
        stream = torch.cuda.current_stream(hd.device).cuda_stream
        err = lib.expert_combine_launch(*(a.data_ptr() for a in args), t, n,
                                        k, k_in, y.data_ptr(), stream)
    _build.check(lib, err, "expert_combine")
    combine.launches += 1
    return y


combine.launches = 0
