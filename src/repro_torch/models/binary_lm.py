"""The paper's technique in the LM substrate (port of
`repro/models/binary_lm.py`), on the port's kernels.

  * ``binary_ffn`` -- BitLinear FFN projections: weights and activations
    binarized to ±1 with XNOR-Net scale recovery (alpha = E|W| per output
    channel, beta = E|x| per token).  With autograd off (serving) the ±1
    product is kernel 1, `ops.binary_gemm_hd`, on packed sign bits:
    dot = K - 2*HD, exact.  With autograd on it is the reference's
    differentiable float ±1 product through `sign_ste` (training), which
    is also the plain version the tests hold the packed route against.

  * ``cam_head`` -- the PiC-BNN CAM-ensemble LM head for greedy decode:
    the vocab projection replaced by Algorithm 1.  The final hidden
    state's sign bits against every binarized vocab row: the votes
    #{t : HD <= T_t} over the sweep are kernel 2, `ops.cam_vote`
    ("votes"); the exact readout D - 2*HD is kernel 1 ("exact").

Weight rows are packed once per loaded model (`packed_rows`, refreshed
when a weight changes); activations are packed at each call, sign at 0
-> +1 as in `sign_ste`.  On CPU tensors the kernels' wrappers take their
plain versions.

On DTensors (a mesh, `sharding.use_rules`) both heads call the same
kernels on the local shards (`sharding.rules.local_plan`): a dim that
the input's batch shards is gathered on the weight instead
(weight-gathered serving); a weight split along K (row-parallel) gives each rank the
partial dot K_loc - 2*HD_loc, an integer summed exactly over the ranks,
each shard packed on its own (its last word zero-padded in both
operands, so any K_loc is exact); a split along N (column-parallel, or
the CAM head's vocab rows) gives each rank its own output columns.  The
CAM head's votes need the whole HD, so its rows are gathered along D.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.binarize import pack_bits, sign_ste
from repro_torch.kernels import ops
from repro_torch.models.layers import _normal_
from repro_torch.sharding import shard
from repro_torch.sharding.rules import (is_dtensor, keep, local, local_plan,
                                        summed)

F32 = torch.float32


def sign_bits(x: torch.Tensor) -> torch.Tensor:
    """Packed sign bits along the last axis (x >= 0 -> 1, i.e. +1)."""
    return pack_bits((x >= 0).to(torch.uint8))


def _once(owner: nn.Module, name: str, w: torch.Tensor, make):
    """`make(w)`, computed once per version of `w` and kept on `owner`.

    Keyed by the tensor's storage, device and version counter (a
    DTensor's: its local shard's), so loading new weights (an in-place
    copy) or moving the model recomputes it.
    """
    cache = owner.__dict__.setdefault("_packed", {})
    local = w.to_local() if is_dtensor(w) else w
    key = (local.data_ptr(), local.device, local._version)
    hit = cache.get(name)
    if hit is None or hit[0] != key:
        with torch.no_grad():
            hit = (key, make(w))
        cache[name] = hit
    return hit[1]


def packed_rows(owner: nn.Module, name: str, w: torch.Tensor) -> torch.Tensor:
    """`w`'s rows as packed sign bits, packed once per weight version."""
    return _once(owner, name, w, sign_bits)


# ---------------------------------------------------------------------------
# BitLinear FFN
# ---------------------------------------------------------------------------
def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with the reference's derivative at 0: +1, as `jnp.abs` has it
    (torch's `abs` has 0).  A BitLinear input is exactly 0 wherever a ±1
    dot product of an earlier projection is 0, so the two differ there."""
    return torch.where(x >= 0, x, -x)


def _bit_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sign(x) @ sign(w) with XNOR-Net scale recovery, differentiable.

    x: [..., K] latent activations; w: [K, N] latent weights.  The
    reference's float ±1 product: the plain version of `_bit_matmul_packed`
    and the training form.
    """
    alpha = _abs(w).mean(0)  # [N], in w's dtype
    beta = _abs(x).mean(-1, keepdim=True)  # [..., 1], in x's dtype
    xb = sign_ste(x.to(F32))
    wb = sign_ste(w.to(F32))
    return (torch.matmul(xb, wb) * alpha * beta).to(x.dtype)


def bitlinear_weights(owner: nn.Module, name: str):
    """`owner.<name>` ([K, N] latent weights) as kernel 1 serves it: the
    packed sign rows of w.T [N, K/32] and alpha = E|w| [N] in w's dtype,
    computed once per weight version."""
    return _once(owner, name, getattr(owner, name),
                 lambda w: (sign_bits(w.t()), w.abs().mean(0)))


def _bit_matmul_packed(owner: nn.Module, name: str,
                       x: torch.Tensor) -> torch.Tensor:
    """`_bit_matmul` at inference: the ±1 product from kernel 1 on packed
    sign bits (K - 2*HD, exact), scaled as the reference scales it."""
    rows, alpha = bitlinear_weights(owner, name)
    beta = x.abs().mean(-1, keepdim=True)
    *lead, k = x.shape
    hd = ops.binary_gemm_hd(sign_bits(x.reshape(-1, k)), rows)
    dot = (k - 2 * hd).to(F32).reshape(*lead, rows.shape[0])
    return (dot * alpha * beta).to(x.dtype)


def _bit_matmul_sharded(owner: nn.Module, name: str,
                        x: torch.Tensor) -> torch.Tensor:
    """`_bit_matmul_packed` on DTensors: kernel 1 on the local shards.

    The integer partial dots of a K-split weight are summed over the
    ranks before the scaling, alpha = E|w| is taken over whole columns
    and beta = E|x| over the whole K, so the result is the unsharded
    one's up to the order of beta's float sum."""
    from torch.distributed.tensor import DTensor

    w = getattr(owner, name)  # [K, N]
    mesh, nd = w.device_mesh, x.ndim
    xt, wt, out = local_plan(x, w, 0, 1)

    def make(_):
        wl = local(w, wt)
        # alpha over whole columns: K gathered, N split as the output is
        cols = local(w, keep(wt, lambda q: q.is_shard(1)))
        return sign_bits(wl.t()), wl.shape[0], cols.abs().mean(0)

    rows, k_loc, alpha = _once(owner, f"{name}@{wt}", w, make)
    lead = keep(xt, lambda q: q.is_shard() and not q.is_shard(nd - 1))
    beta = local(x.abs().mean(-1, keepdim=True), lead)
    xl = local(x, xt)
    hd = ops.binary_gemm_hd(sign_bits(xl.reshape(-1, k_loc)), rows)
    dot = (k_loc - 2 * hd).to(F32).reshape(*xl.shape[:-1], rows.shape[0])
    dot = DTensor.from_local(dot, mesh, out).redistribute(mesh, summed(out))
    y = (dot.to_local() * alpha * beta).to(x.dtype)
    return DTensor.from_local(y, mesh, summed(out))


def bitlinear_mlp(p: nn.Module, cfg: ModelConfig,
                  h: torch.Tensor) -> torch.Tensor:
    """Drop-in binary replacement for `layers.mlp` (same parameters).

    Autograd off: every projection through kernel 1 (on DTensors, on
    their local shards); on: the float ±1 form (`_bit_matmul`)."""
    if torch.is_grad_enabled():
        def bit(x, name):
            return _bit_matmul(x, getattr(p, name))
    elif is_dtensor(h):
        def bit(x, name):
            return _bit_matmul_sharded(p, name, x)
    else:
        def bit(x, name):
            return _bit_matmul_packed(p, name, x)
    if cfg.mlp_act == "swiglu":
        gate = bit(h, "w_gate")
        up = bit(h, "w_up")
        act = shard(F.silu(gate.to(F32)).to(h.dtype) * up,
                    "batch", "seq", "mlp")
        return shard(bit(act, "w_down"), "batch", "seq", "embed")
    act = F.gelu(bit(h, "w_in").to(F32), approximate="tanh").to(h.dtype)
    act = shard(act, "batch", "seq", "mlp")
    return shard(bit(act, "w_out"), "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# CAM-ensemble LM head (Algorithm 1 as the vocab projection)
# ---------------------------------------------------------------------------
class CamHead(nn.Module):
    """rows [V, D] (the vocab rows, binarized at use) and the int32 [P]
    threshold sweep (a buffer)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.rows = nn.Parameter(torch.empty(
            (cfg.vocab_size, cfg.d_model), dtype=cfg.torch_dtype,
            device=device))
        self.register_buffer("thresholds", torch.empty(
            (cfg.cam_head_thresholds,), dtype=torch.int32, device=device))
        self.cfg = cfg

    def draw(self, generator: torch.Generator) -> None:
        """rows normal x d_model^-0.5 in the model dtype; the sweep of
        `cam_thresholds`."""
        _normal_((self.rows,), self.rows.shape[1] ** -0.5, generator)
        with torch.no_grad():
            self.thresholds.copy_(cam_thresholds(self.cfg,
                                                 self.thresholds.device))


def cam_head_axes(cfg: ModelConfig) -> dict:
    return {"rows": ("p_vocab", "p_mlp_d"), "thresholds": (None,)}


def cam_thresholds(cfg: ModelConfig, device=None) -> torch.Tensor:
    """The sweep: cam_head_thresholds passes over center ± halfspan.

    Centred on the majority point of a d_model-bit row; the reference
    widens the paper's ±32 HD to bracket the best-matching row among V
    candidates (extreme-value theory: min-HD over V ~Binomial(D, 1/2)
    rows sits at center - sigma*sqrt(2 ln V), sigma = sqrt(D)/2, plus one
    sigma of margin).  The rounding is `jnp.round(jnp.linspace(...))` in
    float32: stop * (i / (n-1)) for i < n-1, then stop itself, ties to
    even.
    """
    n_pass = cfg.cam_head_thresholds
    center = cfg.d_model // 2
    sigma = (cfg.d_model ** 0.5) / 2.0
    halfspan = max(
        int(sigma * (math.sqrt(2.0 * math.log(max(cfg.vocab_size, 2))) + 1.0)
            + 0.5),
        1,
    )
    stop = torch.tensor(float(2 * halfspan), dtype=F32)
    if n_pass > 1:
        div = n_pass - 1
        steps = torch.arange(div, dtype=F32) / div
        grid = torch.cat([stop * steps, stop[None]])
    else:
        grid = torch.zeros((n_pass,), dtype=F32)
    t = center - halfspan + torch.round(grid).to(torch.int32)
    return t.to(device)


def cam_head_logits_pm1(p: CamHead, cfg: ModelConfig,
                        h: torch.Tensor) -> torch.Tensor:
    """The reference's form: a float ±1 product of the sign tensors, then
    the HD compare.  Plain version of `cam_head_logits`."""
    hb = torch.where(h >= 0, 1.0, -1.0).to(cfg.torch_dtype)
    rb = torch.where(p.rows >= 0, 1.0, -1.0).to(cfg.torch_dtype)
    dot = torch.matmul(hb.to(F32), rb.to(F32).t())  # [B, V]
    if cfg.cam_head_mode == "exact":
        return dot
    hd = (cfg.d_model - dot) * 0.5
    return (hd[..., None] <= p.thresholds.to(F32)).sum(-1).to(F32)


def cam_head_logits(p: CamHead, cfg: ModelConfig,
                    h: torch.Tensor) -> torch.Tensor:
    """Greedy-decode 'logits' from the binary CAM match, on the kernels.

    h: [B, D] final hidden states.  cfg.cam_head_mode:
      "votes" -- Algorithm-1 vote counts #{t : HD <= T_t} (kernel 2,
                 `ops.cam_vote`; purely binary measurements, no ADC);
      "exact" -- the full-precision readout D - 2*HD (kernel 1,
                 `ops.binary_gemm_hd`; the ADC/TDC baseline).
    Output is float32 [B, V], so argmax/sampling is unchanged.
    """
    if is_dtensor(h):
        return _cam_head_sharded(p, cfg, h)
    q = sign_bits(h)
    rows = packed_rows(p, "rows", p.rows)
    if cfg.cam_head_mode == "exact":
        return (cfg.d_model - 2 * ops.binary_gemm_hd(q, rows)).to(F32)
    return ops.cam_vote(q, rows, p.thresholds).to(F32)


def _cam_head_sharded(p: CamHead, cfg: ModelConfig,
                      h: torch.Tensor) -> torch.Tensor:
    """`cam_head_logits` on DTensors: the kernels on the local shards.
    A vote needs the whole HD, so the rows are gathered along D; their
    vocab split stays, giving each rank its own columns of the votes
    (`Shard(1)` over the vocab where the rows are split)."""
    from torch.distributed.tensor import DTensor

    mesh, nd = p.rows.device_mesh, h.ndim
    xt, wt, out = local_plan(h, p.rows, 1, 0)
    wt = keep(wt, lambda q: not q.is_shard(1))
    xt = keep(xt, lambda q: not q.is_shard(nd - 1))
    rows = _once(p, f"rows@{wt}", p.rows,
                 lambda w: sign_bits(local(w, wt)))
    q = sign_bits(local(h, xt))
    if cfg.cam_head_mode == "exact":
        v = cfg.d_model - 2 * ops.binary_gemm_hd(q, rows)
    else:
        thr = p.thresholds
        v = ops.cam_vote(q, rows, thr.to_local() if is_dtensor(thr) else thr)
    return DTensor.from_local(v.to(F32), mesh, summed(out))
