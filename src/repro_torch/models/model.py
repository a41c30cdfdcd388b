"""The unified decoder-only model covering all ten architectures (port of
`repro/models/model.py`).

One definition, driven entirely by ModelConfig:
  * dense / GQA transformers (stablelm, llama3.2, starcoder2, llama3-405b,
    chameleon, musicgen)
  * MoE transformers (mixtral, llama4-maverick)
  * attention-free SSM (falcon-mamba)
  * hybrid interleaves (jamba: 1 attn : 7 mamba, MoE every other layer)

`CausalLM` holds `embed`, a `ModuleList` of blocks (each the config's
LayerPattern superblock: `sub0`, `sub1`, ... sublayers), `final_norm`,
`lm_head` unless the embeddings are tied, and `cam_head` when enabled:
the reference's parameter tree with the stacked blocks unstacked.  The
block stack is a Python loop in place of the reference's `lax.scan`.

Entry points:
  init_params                    -- CausalLM drawn from a torch.Generator
  forward / final_hidden         -- [B, S] tokens -> [B, S, V] logits
                                    (or the normed hidden states)
  loss_fn / chunked_loss         -- chunked-vocab cross entropy (+ MoE
                                    aux), each block and chunk under the
                                    config's remat policy
  init_cache / prefill / decode  -- serving paths
  param_axes / cache_axes        -- each leaf's logical axes (the
                                    reference's, blocks axis dropped);
                                    `*_pspecs` map them through a rule set
  shard_params                   -- the parameters as DTensors on a mesh

Under `sharding.use_rules(rules, mesh)` with DTensor parameters the same
code runs sharded: activations carry the reference's `shard` sites,
plain tensors (tokens, positions, masks) count as replicated, a new
cache is laid out by `cache_pspecs`, and the BitLinear FFN and the CAM
head call their kernels on the local shards (`models/binary_lm.py`).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import binary_lm
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.pipeline import resolve_device
from repro_torch.sharding import rules as R
from repro_torch.sharding import shard

F32 = torch.float32
FULL_WINDOW = 1 << 30


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
class Sublayer(nn.Module):
    """norm1 + attn (or mamba), then norm2 + ffn (dense MLP or MoE) on
    attention sublayers and on hybrid mamba sublayers."""

    def __init__(self, cfg: ModelConfig, kind: str, use_moe: bool, device):
        super().__init__()
        self.norm1 = L.Norm(cfg, device)
        if kind == "attn":
            self.attn = L.Attention(cfg, device)
        elif kind == "mamba":
            self.mamba = S.Mamba(cfg, device)
        else:
            raise ValueError(kind)
        if kind == "attn" or cfg.family == "hybrid":
            self.norm2 = L.Norm(cfg, device)
            self.ffn = (L.MoE if use_moe else L.MLP)(cfg, device)


class Block(nn.Module):
    """One superblock: the sublayers `sub0` .. `sub{n-1}` of the pattern."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        pat = cfg.pattern()
        for i in range(pat.size):
            self.add_module(f"sub{i}", Sublayer(
                cfg, pat.kinds[i], pat.moe_mask[i], device))


class CausalLM(nn.Module):
    """The model's parameters, uninitialised until `draw` (or a
    `load_state_dict`, e.g. of `convert.lm_params_from_jax`).
    `forward(tokens=..., embeds=...)` runs `model.forward` with the
    model's own config.  `device` None means the CUDA card, raising when
    there is none.
    """

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = L._param((cfg.vocab_size, cfg.d_model), cfg, dev)
        self.blocks = nn.ModuleList(Block(cfg, dev)
                                    for _ in range(cfg.blocks))
        self.final_norm = L.Norm(cfg, dev)
        if not cfg.tie_embeddings:
            self.lm_head = L._param((cfg.d_model, cfg.vocab_size), cfg, dev)
        if cfg.cam_head:
            self.cam_head = binary_lm.CamHead(cfg, dev)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def draw(self, generator: torch.Generator) -> None:
        """Every parameter from the reference's distributions: embed and
        lm_head normal x d_model^-0.5, then each layer's own `draw`."""
        L._normal_([self.embed] + ([self.lm_head] if hasattr(self, "lm_head")
                                   else []),
                   self.cfg.d_model ** -0.5, generator)
        for m in self.modules():
            if m is not self and hasattr(m, "draw"):
                m.draw(generator)

    def forward(self, tokens=None, embeds=None, positions=None,
                collect_aux: bool = False):
        return forward(self, self.cfg, tokens, embeds, positions,
                       collect_aux)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> CausalLM:
    """A CausalLM with the reference's distributions (`CausalLM.draw`),
    drawn from `generator`, which must live on the target device.  The
    draws differ from `jax.random`'s; they agree in distribution.
    `device` None means the CUDA card (raising when there is none).
    """
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters on "
                         f"{dev}: draw with a generator on the target device")
    model = CausalLM(cfg, dev)
    model.draw(generator)
    return model


# ---------------------------------------------------------------------------
# Logical axes and placement
# ---------------------------------------------------------------------------
def _sublayer_axes(cfg: ModelConfig, kind: str, use_moe: bool) -> dict:
    norm_ax = {"scale": (None,)}
    if cfg.norm == "layernorm":
        norm_ax["bias"] = (None,)
    p = {"norm1": norm_ax}
    if kind == "attn":
        p["attn"] = L.attention_param_axes(cfg)
    else:
        p["mamba"] = S.mamba_param_axes(cfg)
    if kind == "attn" or cfg.family == "hybrid":
        p["norm2"] = norm_ax
        p["ffn"] = L.moe_param_axes(cfg) if use_moe else L.mlp_param_axes(cfg)
    return p


def _flat(tree: dict, prefix: str = "") -> dict:
    """Nested dicts of axis tuples -> {dotted name: tuple}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def param_axes(cfg: ModelConfig) -> dict:
    """{state-dict name: logical-axis tuple} for every `CausalLM`
    parameter (and the CAM head's threshold buffer): the reference's
    `param_axes` under the port's names, without its leading blocks
    axis (the port's blocks are unstacked)."""
    pat = cfg.pattern()
    sub = {f"sub{i}": _sublayer_axes(cfg, pat.kinds[i], pat.moe_mask[i])
           for i in range(pat.size)}
    tree = {"embed": ("p_embed_v", "p_embed_d"),
            "blocks": {str(b): sub for b in range(cfg.blocks)},
            "final_norm": {"scale": (None,)}
            | ({"bias": (None,)} if cfg.norm == "layernorm" else {})}
    if not cfg.tie_embeddings:
        tree["lm_head"] = ("p_mlp_d", "p_vocab")
    if cfg.cam_head:
        tree["cam_head"] = binary_lm.cam_head_axes(cfg)
    return _flat(tree)


def param_pspecs(cfg: ModelConfig, rules) -> dict:
    """{state-dict name: PartitionSpec} under `rules`."""
    return {k: rules.spec(*ax) for k, ax in param_axes(cfg).items()}


def shard_params(params: CausalLM, mesh, rules) -> CausalLM:
    """Every parameter and buffer of `params` replaced, in place, by a
    DTensor on `mesh` laid out by `param_pspecs` (sanitised: a dim the
    mesh does not divide stays whole).  Every rank must hold the same
    full tensors.  Returns `params`."""
    specs = param_pspecs(params.cfg, rules)
    with torch.no_grad():
        for name, t in list(params.state_dict(keep_vars=True).items()):
            owner, _, leaf = name.rpartition(".")
            mod = params.get_submodule(owner) if owner else params
            dt = R.distribute(t.detach(), specs[name], mesh)
            if isinstance(t, nn.Parameter):
                setattr(mod, leaf, nn.Parameter(dt, requires_grad=
                                                t.requires_grad))
            else:
                mod.register_buffer(leaf, dt)
    return params


def _sharded(params) -> contextlib.AbstractContextManager:
    """Inside: plain tensors meeting a DTensor count as replicated, when
    the parameters are DTensors; else nothing changes."""
    return R.replicated_plain([params.embed])


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
# matrix products, the outputs that remat "dots" keeps (the reference's
# jax.checkpoint_policies.checkpoint_dots)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(cfg: ModelConfig, fn):
    """`fn` under the config's remat policy: "none" keeps every
    activation, "dots" only the matrix products' outputs, anything else
    ("full") only the inputs.  Non-reentrant checkpointing recomputes
    with autograd on, so a BitLinear FFN recomputes its training form."""
    if cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)

    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)

    return wrapped


def _run_sublayer(p: Sublayer, cfg: ModelConfig, kind: str, use_moe: bool,
                  window: Optional[int], h, positions, inv_freq,
                  cache: Optional[dict], cache_index, aux: Optional[dict]):
    x = L.apply_norm(p.norm1, cfg, h)
    if kind == "attn":
        w = FULL_WINDOW if window is None else window
        y, new_cache = L.attention(p.attn, cfg, x, positions, inv_freq,
                                   window=w, cache=cache,
                                   cache_index=cache_index)
    else:
        y, new_cache = S.mamba_block(p.mamba, cfg, x, cache=cache)
    h = h + y
    if hasattr(p, "ffn"):
        x2 = L.apply_norm(p.norm2, cfg, h)
        if use_moe:
            y2 = L.moe(p.ffn, cfg, x2, aux=aux)
        else:
            y2 = L.mlp(p.ffn, cfg, x2)
        h = h + y2
    return h, new_cache


def _run_block(block: Block, cfg: ModelConfig, h, positions, inv_freq,
               block_cache: Optional[dict], cache_index, collect_aux: bool):
    """One superblock.  Returns (h, its new cache dict, its MoE aux loss
    or None)."""
    pat = cfg.pattern()
    aux = {"moe_aux": torch.zeros((), dtype=F32, device=h.device)} \
        if collect_aux else None
    new_cache = {}
    for i in range(pat.size):
        sub = f"sub{i}"
        c = block_cache[sub] if block_cache is not None else None
        h, nc = _run_sublayer(getattr(block, sub), cfg, pat.kinds[i],
                              pat.moe_mask[i], pat.windows[i], h,
                              positions, inv_freq, c, cache_index, aux)
        if nc is not None:
            new_cache[sub] = nc
    return h, new_cache, (aux["moe_aux"] if collect_aux else None)


def _stack(params: CausalLM, cfg: ModelConfig, h, positions, cache,
           cache_index, collect_aux: bool):
    """Run the block stack.  cache: a list of per-block dicts or None.
    Returns (h, new cache or None, summed MoE aux loss).  Under autograd
    each block runs through the config's remat policy."""
    inv_freq = L.rope_frequencies(cfg, h.device)
    aux_sum = torch.zeros((), dtype=F32, device=h.device)
    new_cache = [] if cache is not None else None
    block_fn = (_remat_wrap(cfg, _run_block) if torch.is_grad_enabled()
                else _run_block)
    for b, block in enumerate(params.blocks):
        # sequence-parallel residual carry (no-op unless the active rules
        # map "act_seq" to a mesh axis -- see TRAIN_SP_RULES)
        h = shard(h, "batch", "act_seq", "embed")
        h, block_cache, aux = block_fn(
            block, cfg, h, positions, inv_freq,
            cache[b] if cache is not None else None, cache_index,
            collect_aux)
        if new_cache is not None:
            new_cache.append(block_cache)
        if collect_aux:
            aux_sum = aux_sum + aux
    return h, new_cache, aux_sum


def _embed_in(params: CausalLM, cfg: ModelConfig, tokens, embeds):
    if embeds is not None:
        h = embeds.to(cfg.torch_dtype)
    else:
        h = _embedding(params, tokens)
    return shard(h, "batch", "seq", "embed")


def _embedding(params: CausalLM, tokens) -> torch.Tensor:
    """Rows of the embedding table (the tokens replicated on the table's
    mesh when it is a DTensor, so its backward sees DTensors only)."""
    if R.is_dtensor(params.embed):
        tokens = R.as_dtensor(tokens, params.embed.device_mesh)
    return F.embedding(tokens, params.embed)


def _lm_head(params: CausalLM, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params.embed.t()
    return params.lm_head


def _logits(params: CausalLM, cfg: ModelConfig, h) -> torch.Tensor:
    """[..., D] -> float32 [..., V] through the vocab projection."""
    return L._matmul(h, _lm_head(params, cfg)).to(F32)


def final_hidden(params: CausalLM, cfg: ModelConfig, tokens=None,
                 embeds=None, positions=None, collect_aux: bool = False):
    """The normed final hidden states [B, S, D] of the whole sequence (what
    the vocab projection or the CAM head reads), and the MoE aux loss."""
    b, s = (tokens.shape if tokens is not None else embeds.shape[:2])
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=params.device).expand(b, s)
    h = _embed_in(params, cfg, tokens, embeds)
    h, _, aux = _stack(params, cfg, h, positions, None, None, collect_aux)
    return L.apply_norm(params.final_norm, cfg, h), aux


def forward(params: CausalLM, cfg: ModelConfig, tokens=None, embeds=None,
            positions=None, collect_aux: bool = False):
    """Training-mode forward: (full-sequence float32 logits [B, S, V],
    the summed MoE aux loss)."""
    with _sharded(params):
        h, aux = final_hidden(params, cfg, tokens, embeds, positions,
                              collect_aux)
        return shard(_logits(params, cfg, h), "batch", "seq", "vocab"), aux


def chunked_loss(params: CausalLM, cfg: ModelConfig, h, labels,
                 chunk: int = 512) -> torch.Tensor:
    """Mean cross entropy of h [B, S, D] against labels [B, S], with the
    [B, chunk, V] logits tensor bounded: the sequence in chunks of
    `chunk` (one chunk of S when S is not a multiple), each chunk's
    logits in float32 under the config's remat policy, a float32
    logsumexp less the gold logit, summed and divided by B * S."""
    b, s, _ = h.shape
    head = _lm_head(params, cfg)
    if s % chunk != 0:
        chunk = s
    body = (_remat_wrap(cfg, _chunk_ce) if torch.is_grad_enabled()
            else _chunk_ce)
    total = torch.zeros((), dtype=F32, device=h.device)
    for i in range(0, s, chunk):
        total = total + body(h[:, i:i + chunk], labels[:, i:i + chunk], head)
    return total / (b * s)


def _chunk_ce(h, labels, head) -> torch.Tensor:
    """Summed cross entropy of one chunk: logsumexp - gold, float32."""
    logits = shard(L._matmul(h, head).to(F32), "batch", "seq", "vocab")
    if not R.is_dtensor(logits):
        gold = logits.gather(-1, labels[..., None].long())[..., 0]
        return (torch.logsumexp(logits, -1) - gold).sum()
    # over a vocab split: the gold logit as a masked sum, logsumexp as
    # max + log-sum-exp of the rest (the max without gradient, as
    # logsumexp's own)
    onehot = F.one_hot(labels.long(), logits.shape[-1]).to(F32)
    gold = (logits * onehot).sum(-1)
    m = logits.detach().amax(-1, keepdim=True)
    lse = (logits - m).exp().sum(-1).log() + m[..., 0]
    return (lse - gold).sum()


def loss_fn(params: CausalLM, cfg: ModelConfig, batch: dict,
            aux_weight: float = 0.01):
    """batch: {"tokens" | "embeds", "labels"} (tensors on the model's
    device) -> (ce + aux_weight * MoE aux, {"ce", "moe_aux"})."""
    with _sharded(params):
        h, aux = final_hidden(params, cfg, batch.get("tokens"),
                              batch.get("embeds"),
                              collect_aux=cfg.n_experts > 0)
        ce = chunked_loss(params, cfg, h, batch["labels"])
        return ce + aux_weight * aux, {"ce": ce, "moe_aux": aux}


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------
def _attn_cache(cfg: ModelConfig, batch: int, max_len: int, window,
                device) -> dict:
    length = max_len if window is None else min(window, max_len)
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
        "pos": torch.full((batch, length), -1, dtype=torch.int32,
                          device=device),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> list:
    """A list over blocks of {sub_i: cache}: attention sublayers hold
    k/v [B, L, G, dh] and pos [B, L] (-1 = empty; L is max_len, capped at
    the window), mamba sublayers their conv taps and float32 state.
    `device` None means the CUDA card.
    Inside `sharding.use_rules(rules, mesh)` each leaf is a DTensor laid
    out by `cache_pspecs`."""
    pat = cfg.pattern()
    device = resolve_device(device)

    def one_block():
        return {f"sub{i}": (_attn_cache(cfg, batch, max_len, pat.windows[i],
                                        device)
                            if pat.kinds[i] == "attn"
                            else S.init_mamba_cache(cfg, batch, device=device))
                for i in range(pat.size)}

    cache = [one_block() for _ in range(cfg.blocks)]
    rules, mesh = R.current_rules(), R.current_mesh()
    if rules is not None and mesh is not None:
        specs = cache_pspecs(cfg, rules)
        cache = [{sub: {k: R.distribute(t, specs[b][sub][k], mesh)
                        for k, t in leaves.items()}
                  for sub, leaves in blk.items()}
                 for b, blk in enumerate(cache)]
    return cache


def cache_axes(cfg: ModelConfig) -> list:
    """Logical axes of the cache: a list over blocks of {sub_i: {leaf:
    axes}}, the reference's `cache_axes` without its blocks axis."""
    pat = cfg.pattern()
    block = {}
    for i in range(pat.size):
        if pat.kinds[i] == "attn":
            block[f"sub{i}"] = {
                "k": ("batch", "kv_seq", "kv_heads", None),
                "v": ("batch", "kv_seq", "kv_heads", None),
                "pos": ("batch", "kv_seq"),
            }
        else:
            block[f"sub{i}"] = {
                "conv": ("batch", None, "mlp"),
                "h": ("batch", "mlp", None),
            }
    return [block for _ in range(cfg.blocks)]


def cache_pspecs(cfg: ModelConfig, rules) -> list:
    """`cache_axes` as PartitionSpecs under `rules`."""
    return [{sub: {k: rules.spec(*ax) for k, ax in leaves.items()}
             for sub, leaves in blk.items()} for blk in cache_axes(cfg)]


@torch.no_grad()
def prefill(params: CausalLM, cfg: ModelConfig, tokens=None, embeds=None,
            max_len: Optional[int] = None):
    """Process the prompt; return (last-position logits [B, V], cache).

    max_len sizes the cache (>= prompt length); decode steps beyond it
    roll (window semantics).  Default: prompt length + 64 decode slots.
    Autograd is off, so a BitLinear FFN runs on kernel 1.
    """
    b, s = (tokens.shape if tokens is not None else embeds.shape[:2])
    dev = params.device
    positions = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    cache = init_cache(cfg, b, max_len if max_len is not None else s + 64,
                       dev)
    with _sharded(params):
        h = _embed_in(params, cfg, tokens, embeds)
        h, new_cache, _ = _stack(params, cfg, h, positions, cache, None,
                                 False)
        h = L.apply_norm(params.final_norm, cfg, h[:, -1:, :])
        return shard(_logits(params, cfg, h)[:, 0], "batch",
                     "vocab"), new_cache


@torch.no_grad()
def decode(params: CausalLM, cfg: ModelConfig, cache: list, tokens, pos: int):
    """One decode step.

    tokens: [B, 1] int (or embeds [B, 1, D] when cfg.embeds_input); pos:
    the absolute position of the new token (uniform across the batch).
    The cache is updated in place (the reference donates it) and
    returned.  Returns (logits [B, V], cache): the CAM head's votes (or
    exact readout) when cfg.cam_head, else the vocab projection.
    """
    with _sharded(params):
        if cfg.embeds_input and tokens.ndim == 3:
            h = tokens.to(cfg.torch_dtype)
        else:
            h = _embedding(params, tokens)
        h = shard(h, "batch", "seq", "embed")
        b = h.shape[0]
        positions = torch.full((b, 1), int(pos), dtype=torch.int32,
                               device=params.device)
        h, new_cache, _ = _stack(params, cfg, h, positions, cache, pos,
                                 False)
        h = L.apply_norm(params.final_norm, cfg, h)
        if cfg.cam_head:
            logits = binary_lm.cam_head_logits(params.cam_head, cfg, h[:, 0])
        else:
            logits = _logits(params, cfg, h)[:, 0]
        return shard(logits, "batch", "vocab"), new_cache
