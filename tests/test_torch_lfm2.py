"""LFM2-8B-A1B in the port (`configs/lfm2_8b_a1b.py`, the "conv"
sublayer, learned QK-norm scales, the sigmoid-and-bias router, dropless
dispatch and the binary experts on kernel 1's grouped entry) against the
plain reference `bench/reference/lfm2.py` on seeded random weights, at
the `+smoke` size in float32 on the CPU; the ten mirrored architectures
keep every port-only setting off; and, on the card (marker `cuda`), the
grouped entry bit for bit against its plain twin."""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import configs, obs
from repro_torch.configs import lfm2_8b_a1b
from repro_torch.kernels import binary_gemm as bg
from repro_torch.kernels import expert_ffn, ops
from repro_torch.kernels import rows as row_ops
from repro_torch.models import binary_lm
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import ssm

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from bench.reference import lfm2 as reference  # noqa: E402

SMOKE = "lfm2-8b-a1b+binary-ffn+smoke"
# float32 on both sides, the same arithmetic in another order (measured
# 4e-7 to 6e-7): a BitLinear input within rounding of 0 may flip its
# sign, which the tolerance leaves room for at this size
TOL = 1e-4
MIRRORED = configs.list_archs()


def _ref_cfg(cfg) -> dict:
    """The reference's keys (config.json's names) for a port config."""
    pat = cfg.pattern()
    return {"hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads, "norm_eps": cfg.norm_eps,
            "rope_theta": cfg.rope_theta, "num_experts": cfg.n_experts,
            "num_experts_per_tok": cfg.moe_top_k, "norm_topk_prob": True,
            "routed_scaling_factor": 1.0,
            "num_dense_layers": pat.moe_mask.index(True),
            "layer_types": ["full_attention" if k == "attn" else "conv"
                            for k in pat.kinds]}


def _model(seed: int = 1, name: str = SMOKE, bias_std: float = 0.1):
    """A smoke model with every norm and QK-norm scale drawn near 1 and
    the expert bias drawn, so each of them reaches the logits."""
    cfg = configs.get_config(name)
    g = torch.Generator().manual_seed(seed)
    m = M.init_params(cfg, g, device="cpu")
    with torch.no_grad():
        for n, p in m.named_parameters():
            if n.endswith(("q_norm", "k_norm", "scale")):
                p.copy_(1 + 0.2 * torch.randn(p.shape, generator=g))
        for n, b in m.named_buffers():
            if n.endswith("expert_bias"):
                b.copy_(bias_std * torch.randn(b.shape, generator=g))
    return cfg, m, g


def _rel(got, want) -> float:
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())


def test_config_is_port_only_at_the_published_widths():
    assert len(configs.list_archs()) == 10
    assert "lfm2-8b-a1b" not in configs.REGISTRY
    assert "lfm2-8b-a1b" not in configs.ALIASES.values()
    cfg = configs.get_config("lfm2-8b-a1b+binary-ffn")
    assert isinstance(cfg, lfm2_8b_a1b.Lfm2Config) and cfg.binary_ffn
    pat = cfg.pattern()
    assert cfg.blocks == 1 and pat.size == 24
    assert [i for i, k in enumerate(pat.kinds) if k == "attn"] == \
        [2, 6, 10, 14, 18, 21]
    assert set(pat.kinds) == {"attn", "conv"}
    assert pat.moe_mask == (False,) * 2 + (True,) * 22
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == \
        (2048, 32, 8, 64)
    assert (cfg.n_experts, cfg.moe_top_k, cfg.expert_d_ff, cfg.d_ff,
            cfg.vocab_size) == (32, 4, 1792, 7168, 65536)
    assert round(cfg.param_count() / 1e9, 2) == 8.34
    assert round(cfg.active_param_count() / 1e9, 2) == 1.56
    with torch.device("meta"):
        model = M.CausalLM(cfg, "meta")
    n = sum(t.numel() for t in model.state_dict().values())
    assert n == cfg.param_count()
    sub = model.blocks[0]
    assert tuple(sub.sub5.ffn.w_gate.shape) == (32, 2048, 1792)
    assert tuple(sub.sub0.ffn.w_gate.shape) == (2048, 7168)
    assert tuple(sub.sub0.conv.in_proj.shape) == (2048, 6144)
    assert tuple(sub.sub2.attn.q_norm.shape) == (64,)
    smoke = configs.get_config("lfm2-8b-a1b+smoke")
    assert smoke.dtype == "float32" and not smoke.binary_ffn
    assert set(smoke.pattern().kinds) == {"attn", "conv"}
    assert smoke.pattern().moe_mask[:3] == (False, False, True)
    assert smoke.expert_d_ff != smoke.d_ff


@pytest.mark.parametrize("mod", ["", "+binary-ffn"])
@pytest.mark.parametrize("arch", MIRRORED)
def test_mirrored_configs_keep_the_port_only_settings_off(arch, mod):
    cfg = configs.get_config(arch + mod)
    assert type(cfg) is configs.ModelConfig
    assert (cfg.norm_eps, cfg.qk_norm_scale, cfg.expert_d_ff,
            cfg.moe_router, cfg.moe_dropless, cfg.binary_experts) == \
        (1e-6, False, None, "softmax", False, False)
    assert "conv" not in cfg.pattern().kinds
    assert {f.name for f in dataclasses.fields(cfg)}.isdisjoint(
        {"norm_eps", "qk_norm_scale", "expert_d_ff", "moe_router",
         "moe_dropless", "binary_experts", "conv_cache"})


def test_mixtral_binary_ffn_keeps_float_experts_and_capacity(monkeypatch):
    cfg = configs.get_config("mixtral-8x7b+smoke+binary-ffn")
    model = M.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    tok = torch.randint(0, cfg.vocab_size, (2, 8))

    def refuse(*a, **k):
        raise AssertionError("a port-only MoE path ran for mixtral")

    monkeypatch.setattr(binary_lm, "grouped_bitlinear_ffn", refuse)
    monkeypatch.setattr(L, "_moe_dropless", refuse)
    calls = []
    bmm = torch.bmm
    monkeypatch.setattr(torch, "bmm", lambda *a: calls.append(1) or bmm(*a))
    with torch.no_grad():
        M.prefill(model, cfg, tok)
    assert calls  # the experts' float products


def test_prefill_and_forward_match_the_reference_at_every_position():
    cfg, m, g = _model()
    tok = torch.randint(0, cfg.vocab_size, (3, 20), generator=g)
    want = reference.forward(dict(m.state_dict()), _ref_cfg(cfg), tok,
                             all_positions=True)
    with torch.no_grad():
        every, _ = M.forward(m, cfg, tok)
    last, _ = M.prefill(m, cfg, tok)
    assert _rel(every, want) < TOL
    assert _rel(last, want[:, -1]) < TOL


def test_prefill_then_decode_through_both_caches_matches_the_reference():
    cfg, m, g = _model(seed=2)
    tok = torch.randint(0, cfg.vocab_size, (2, 17), generator=g)
    want = reference.forward(dict(m.state_dict()), _ref_cfg(cfg), tok,
                             all_positions=True)
    logits, cache = M.prefill(m, cfg, tok[:, :13], max_len=24)
    assert _rel(logits, want[:, 12]) < TOL
    kinds = cfg.pattern().kinds
    assert set(cache[0]["sub0"]) == {"conv"}
    assert tuple(cache[0]["sub0"]["conv"].shape) == (2, 2, cfg.d_model)
    assert set(cache[0][f"sub{kinds.index('attn')}"]) == {"k", "v", "pos"}
    for i in range(13, 17):
        logits, cache = M.decode(m, cfg, cache, tok[:, i:i + 1], i)
        assert _rel(logits, want[:, i]) < TOL, i


def _ragged(loads, kw, n, gen):
    e = len(loads)
    x = torch.randint(-2**31, 2**31 - 1, (sum(loads), kw), generator=gen,
                      dtype=torch.int64).to(torch.int32)
    w = torch.randint(-2**31, 2**31 - 1, (e, n, kw), generator=gen,
                      dtype=torch.int64).to(torch.int32)
    offsets = torch.tensor([0, *torch.tensor(loads).cumsum(0).tolist()],
                           dtype=torch.int32)
    return x, offsets, w


LOADS = {"one_empty": [5, 0, 33, 1], "one_has_all": [0, 0, 70, 0],
         "empty_last": [31, 32, 1, 0]}


@pytest.mark.parametrize("loads", sorted(LOADS))
def test_grouped_twin_equals_per_expert_products(loads):
    gen = torch.Generator().manual_seed(5)
    loads = LOADS[loads]
    x, offsets, w = _ragged(loads, 3, 10, gen)
    hd = ops.grouped_bitlinear_hd(x, offsets, w)
    lo = 0
    for e, n in enumerate(loads):
        assert torch.equal(hd[lo:lo + n], bg.binary_gemm_hd(x[lo:lo + n],
                                                            w[e]))
        lo += n



@pytest.mark.parametrize("loads", sorted(LOADS))
def test_grouped_experts_equal_each_experts_bitlinear(loads):
    """The grouped route (one gate-and-up launch, SwiGLU and the down
    operands in one pass, one down launch, the combine) equals each
    expert's own `_bit_matmul_packed` projections and the gate-weighted
    sum, value for value, at ragged loads."""
    gen = torch.Generator().manual_seed(5)
    loads = LOADS[loads]
    e, d, f = len(loads), 40, 24
    p = torch.nn.Module()
    for name, shape in (("w_gate", (e, d, f)), ("w_up", (e, d, f)),
                        ("w_down", (e, f, d))):
        setattr(p, name, torch.nn.Parameter(torch.randn(shape,
                                                        generator=gen)))
    s = sum(loads)
    x = torch.randn((s, d), generator=gen)
    tok = torch.arange(s)
    expert = torch.repeat_interleave(torch.arange(e), torch.tensor(loads))
    offsets = torch.tensor([0, *torch.tensor(loads).cumsum(0).tolist()],
                           dtype=torch.int32)
    hd, alpha, beta, k_in = binary_lm.grouped_bitlinear_ffn(
        p, x, tok, expert, offsets)
    gate = torch.rand((s, 1), generator=gen)
    got = expert_ffn.combine(hd, alpha, beta, expert, tok, gate, k_in)
    lo = 0
    for j, n in enumerate(loads):
        one = torch.nn.Module()
        for name in ("w_gate", "w_up", "w_down"):
            setattr(one, name, torch.nn.Parameter(
                getattr(p, name)[j].detach().clone()))
        rows = x[lo:lo + n]
        act = torch.nn.functional.silu(binary_lm._bit_matmul_packed(
            one, "w_gate", rows)) * binary_lm._bit_matmul_packed(
            one, "w_up", rows)
        want = binary_lm._bit_matmul_packed(one, "w_down", act)
        assert torch.equal(got[lo:lo + n], want * gate[lo:lo + n]), j
        lo += n


def test_dropless_keeps_every_slot_of_a_skewed_router():
    cfg, m, g = _model(seed=4)
    with torch.no_grad():
        for n, b in m.named_buffers():
            if n.endswith("expert_bias"):
                b.zero_()
                b[0] = 10.0  # every token chooses expert 0
    tok = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
    obs.take()
    obs.enable()
    try:
        last, _ = M.prefill(m, cfg, tok)
    finally:
        obs.disable()
    records, _ = obs.take()
    routes = [r.counts for r in records if r.name == "moe.route"]
    assert len(routes) == sum(cfg.pattern().moe_mask)
    assert all(c["max_load"] == c["tokens"] == 32 for c in routes)
    w, rc = dict(m.state_dict()), _ref_cfg(cfg)
    want = reference.forward(w, rc, tok)
    assert _rel(last, want) < TOL
    # the capacity path's cut (1.25 * 32 * 4 / 8 = 20 slots of expert 0)
    # drops 12 tokens' slots there, and the logits move
    assert _rel(reference.forward(w, rc, tok, control="capacity_1.25"),
                want) > 100 * TOL


def test_dropless_float_experts_equal_the_capacity_path_with_room():
    """Without `+binary-ffn` the dropless dispatch runs float experts, one
    product each: with a capacity that drops nothing the capacity path
    gives the same outputs."""
    cfg, m, g = _model(seed=17, name="lfm2-8b-a1b+smoke")
    ffn = m.blocks[0].sub4.ffn
    ws = {n: getattr(ffn, n) for n in ("router", "w_gate", "w_up", "w_down",
                                       "expert_bias")}
    h = torch.randn((2, 9, cfg.d_model), generator=g)
    with torch.no_grad():
        got = L._moe_dropless(ffn, ws, cfg, h)
        want, _, _ = L._moe_groups(h.reshape(1, 18, cfg.d_model), ws, cfg,
                                   18 * cfg.moe_top_k)
    torch.testing.assert_close(got, want.view(2, 9, -1), rtol=1e-5,
                               atol=1e-6)


def test_gates_ignore_the_expert_bias_while_the_selection_uses_it():
    cfg = configs.get_config(SMOKE)
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((64, cfg.d_model), generator=gen)
    router = torch.randn((cfg.d_model, cfg.n_experts), generator=gen) * 0.1
    bias = torch.randn(cfg.n_experts, generator=gen)
    scores, gate, idx = L._route(x, {"router": router, "expert_bias": bias},
                                 cfg)
    s = torch.sigmoid(x @ router)
    assert torch.equal(scores, s)
    assert torch.equal(idx, torch.topk(s + bias, cfg.moe_top_k).indices)
    assert not torch.equal(idx.sort(-1).values,
                           torch.topk(s, cfg.moe_top_k).indices.sort(-1)
                           .values)
    chosen = s.gather(-1, idx)
    torch.testing.assert_close(gate, chosen / (chosen.sum(-1, keepdim=True)
                                               + 1e-6), rtol=0, atol=0)


@pytest.mark.parametrize("control", reference.CONTROLS)
def test_controls_move_the_logits_beyond_the_tolerance(control):
    cfg, m, g = _model(seed=7)
    tok = torch.randint(0, cfg.vocab_size, (4, 16), generator=g)
    w, rc = dict(m.state_dict()), _ref_cfg(cfg)
    got, _ = M.prefill(m, cfg, tok)
    assert _rel(got, reference.forward(w, rc, tok)) < TOL
    assert _rel(got, reference.forward(w, rc, tok, control=control)) > \
        100 * TOL


def test_spans_of_a_prefill():
    cfg, m, g = _model(seed=8)
    tok = torch.randint(0, cfg.vocab_size, (2, 8), generator=g)
    obs.take()
    obs.enable()
    try:
        M.prefill(m, cfg, tok)
    finally:
        obs.disable()
    records, dropped = obs.take()
    names = [r.name for r in records]
    pat = cfg.pattern()
    moe = sum(pat.moe_mask)
    assert dropped == 0 and names[-1] == "lm.prefill"
    assert names.count("lm.attention") == pat.kinds.count("attn")
    assert names.count("lm.short_conv") == pat.kinds.count("conv")
    for name in ("moe.route", "moe.experts", "moe.combine"):
        assert names.count(name) == moe
    assert all(r.counts == {"launches": 0} for r in records
               if r.name == "moe.experts")
    top = records[-1].id
    assert all(r.call == top for r in records)


def test_binary_experts_refuse_the_capacity_path():
    """The binary experts have no training form: under autograd, where
    the MoE takes the capacity path, they raise rather than run as float
    experts."""
    cfg, m, g = _model(seed=9)
    tok = torch.randint(0, cfg.vocab_size, (2, 12), generator=g)
    with pytest.raises(NotImplementedError, match="dropless"):
        M.forward(m, cfg, tok)


def test_prefill_taps_the_residual_stream_layer_by_layer():
    """`prefill(taps=...)` records each sublayer's input and its state
    after the operator, then the last output; the reference's operator,
    FFN and head, each run on the program's own input there, give what
    the program added, and the taps leave the logits as they were."""
    cfg, m, g = _model(seed=10)
    tok = torch.randint(0, cfg.vocab_size, (2, 12), generator=g)
    w, rc = dict(m.state_dict()), _ref_cfg(cfg)
    taps = []
    logits, _ = M.prefill(m, cfg, tok, taps=taps)
    assert torch.equal(logits, M.prefill(m, cfg, tok)[0])
    assert len(taps) == 2 * cfg.n_layers + 1
    assert all(t.shape == (2, 12, cfg.d_model) for t in taps)
    for i in range(cfg.n_layers):
        lw = reference.layer_weights(w, i)
        h_in, h_mid, h_out = taps[2 * i:2 * i + 3]
        assert _rel(h_mid - h_in, reference.operator(lw, rc, i, h_in)) < TOL
        assert _rel(h_out - h_mid, reference.ffn(lw, rc, i, h_mid)) < TOL
    assert _rel(logits, reference.head(w, rc, taps[-1][:, -1])) < TOL
    ref_taps = []
    want = reference.forward(w, rc, tok, taps=ref_taps)
    assert len(ref_taps) == len(taps) and _rel(logits, want) < TOL


def test_short_conv_decodes_one_token_at_a_time():
    cfg = configs.get_config(SMOKE)
    p = ssm.ShortConv(cfg, "cpu")
    p.draw(torch.Generator().manual_seed(10))
    x = torch.randn((2, 9, cfg.d_model))
    whole, _ = ssm.short_conv(p, cfg, x)
    cache = {"conv": torch.zeros((2, cfg.conv_cache - 1, cfg.d_model))}
    steps = []
    for t in range(9):
        y, cache = ssm.short_conv(p, cfg, x[:, t:t + 1], cache=cache)
        steps.append(y)
    torch.testing.assert_close(torch.cat(steps, 1), whole, rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    """The card, or a skip: decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda", 0)


def _skewed_loads(gen, slots: int, experts: int) -> list:
    """Loads of `slots` over `experts`, uneven as a biased router's."""
    w = torch.rand(experts, generator=gen) ** 3
    loads = (w / w.sum() * slots).floor().long()
    loads[int(w.argmax())] += slots - int(loads.sum())
    return loads.tolist()


GROUPED_SHAPES = {  # (slots, Kw, N, experts) at the cell's projections
    "cell_gate_up": (32768, 64, 1792, 32), "cell_down": (32768, 56, 2048, 32),
    "cell_b2_down": (16384, 56, 2048, 32), "unaligned": (1000, 5, 300, 7)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(GROUPED_SHAPES))
def test_grouped_entry_equals_its_twin_on_the_card(card, shape):
    slots, kw, n, e = GROUPED_SHAPES[shape]
    gen = torch.Generator().manual_seed(11)
    loads = _skewed_loads(gen, slots, e)
    loads[1], loads[0] = 0, loads[0] + loads[1]  # an expert with none
    x, offsets, w = _ragged(loads, kw, n, gen)
    before = bg.grouped_bitlinear_hd.launches
    got = ops.grouped_bitlinear_hd(x.to(card), offsets.to(card), w.to(card))
    torch.cuda.synchronize()
    assert bg.grouped_bitlinear_hd.launches == before + 1
    lo = 0
    for j, m in enumerate(loads):  # the twin, run by run on the card
        if m:
            assert torch.equal(got[lo:lo + m], bg.binary_gemm_hd(
                x[lo:lo + m].to(card), w[j].to(card))), (j, m)
        lo += m
    if slots <= 1000:
        assert torch.equal(got.cpu(), bg.grouped_bitlinear_hd_plain(
            x, offsets, w))


@pytest.mark.cuda
@pytest.mark.parametrize("loads", sorted(LOADS))
def test_grouped_entry_at_ragged_loads_on_the_card(card, loads):
    gen = torch.Generator().manual_seed(12)
    x, offsets, w = _ragged(LOADS[loads], 64, 256, gen)
    got = ops.grouped_bitlinear_hd(x.to(card), offsets.to(card), w.to(card))
    assert torch.equal(got.cpu(), bg.grouped_bitlinear_hd_plain(x, offsets,
                                                                w))


@pytest.mark.cuda
def test_lfm2_on_the_card_launches_the_grouped_entry_and_equals_cpu(card):
    cfg, m, g = _model(seed=13)
    tok = torch.randint(0, cfg.vocab_size, (2, 40), generator=g)
    want, _ = M.prefill(m, cfg, tok)
    mc = M.CausalLM(cfg, card)
    mc.load_state_dict(m.state_dict())
    before = bg.grouped_bitlinear_hd.launches
    got, cache = M.prefill(mc, cfg, tok.to(card), max_len=44)
    step, _ = M.decode(mc, cfg, cache, tok[:, :1].to(card), 40)
    torch.cuda.synchronize()
    moe = sum(cfg.pattern().moe_mask)
    assert bg.grouped_bitlinear_hd.launches - before == 2 * 2 * moe
    assert _rel(got.cpu(), want) < TOL
    assert torch.isfinite(step).all()


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [2, 4])
def test_expert_steps_equal_their_twins_on_the_card(card, batch):
    """SwiGLU-and-signs and the combine at the cell's shapes (bfloat16):
    the kernels' sign bits and outputs equal the plain versions' on the
    card bit for bit, beta within its last bfloat16 bit."""
    gen = torch.Generator(card).manual_seed(14)
    t, k, e, d, f = batch * 2048, 4, 32, 2048, 1792
    s = t * k
    expert = torch.randint(0, e, (s,), generator=gen, device=card)
    expert = expert.sort().values.to(torch.int32)
    hd = torch.randint(0, d + 1, (s, 2 * f), generator=gen, device=card,
                       dtype=torch.int32)
    alpha = torch.rand((e, 2 * f), generator=gen, device=card).to(
        torch.bfloat16)
    beta = torch.rand((s,), generator=gen, device=card).to(torch.bfloat16)
    before = expert_ffn.swiglu_signs.launches
    bits, b_act = expert_ffn.swiglu_signs(hd, alpha, beta, expert, d)
    want_bits, want_b = expert_ffn.swiglu_signs_plain(hd, alpha, beta,
                                                      expert, d)
    assert expert_ffn.swiglu_signs.launches == before + 1
    assert torch.equal(bits, want_bits)
    torch.testing.assert_close(b_act.float(), want_b.float(), rtol=2 ** -7,
                               atol=0)
    hd2 = torch.randint(0, f + 1, (s, d), generator=gen, device=card,
                        dtype=torch.int32)
    alpha2 = torch.rand((e, d), generator=gen, device=card).to(torch.bfloat16)
    back = torch.randperm(s, generator=gen, device=card)
    gate = torch.rand((t, k), generator=gen, device=card)
    got = expert_ffn.combine(hd2, alpha2, want_b, expert, back, gate, f)
    assert torch.equal(got, expert_ffn.combine_plain(
        hd2, alpha2, want_b, expert, back, gate, f))


@pytest.mark.cuda
def test_lfm2_in_bfloat16_on_the_card_takes_the_kernels(card, monkeypatch):
    """The smoke model in bfloat16 on the card: the expert steps' kernels
    give the logits of their plain versions (the same composition)."""
    cfg, m, g = _model(seed=15)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    mc = M.CausalLM(cfg, card)
    mc.load_state_dict(m.state_dict())
    tok = torch.randint(0, cfg.vocab_size, (2, 64), generator=g).to(card)
    before = expert_ffn.combine.launches
    got, _ = M.prefill(mc, cfg, tok)
    assert expert_ffn.combine.launches - before == sum(cfg.pattern().moe_mask)
    monkeypatch.setattr(expert_ffn, "_on_card", lambda *ts: False)
    want, _ = M.prefill(mc, cfg, tok)
    assert _rel(got.float().cpu(), want.float().cpu()) < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4096, 2048), (2, 2048, 32, 64), (7, 45)])
def test_row_kernels_equal_their_twins_on_the_card(card, shape):
    """The RMS norm and the BitLinear input's signs and beta on bfloat16
    rows of the cell's shapes (and a ragged one): the sign bits equal the
    plain versions', the norm and beta within their last bfloat16 bit."""
    gen = torch.Generator(card).manual_seed(16)
    x = torch.randn(shape, generator=gen, device=card).to(torch.bfloat16)
    scale = (1 + 0.2 * torch.randn(shape[-1], generator=gen, device=card)
             ).to(torch.bfloat16)
    before = row_ops.rms_norm.launches
    got = row_ops.rms_norm(x, scale, 1e-5)
    assert row_ops.rms_norm.launches == before + 1
    torch.testing.assert_close(got.float(), row_ops.rms_norm_plain(
        x, scale, 1e-5).float(), rtol=2 ** -7, atol=0)
    bits, beta = row_ops.sign_rows(x)
    want_bits, want_beta = row_ops.sign_rows_plain(x)
    assert torch.equal(bits, want_bits)
    torch.testing.assert_close(beta.float(), want_beta.float(),
                               rtol=2 ** -7, atol=0)


def test_graphed_prefill_off_the_card_is_prefill():
    cfg, m, g = _model(seed=17)
    tok = torch.randint(0, cfg.vocab_size, (2, 10), generator=g)
    want, want_cache = M.prefill(m, cfg, tok, max_len=12)
    for _ in range(3):
        got, cache = M.prefill_graphed(m, cfg, tok, max_len=12)
        assert torch.equal(got, want)
        assert torch.equal(cache[0]["sub0"]["conv"],
                           want_cache[0]["sub0"]["conv"])
    assert "_prefill_graphs" not in m.__dict__


@pytest.mark.cuda
def test_graphed_prefill_replays_what_op_by_op_computes(card):
    """`prefill_graphed` on the card: the first call at a shape runs op
    by op, the second captures a CUDA graph, later calls replay it with
    no launch from the host; each call's logits and cache are its own and
    equal, bit for bit, to `prefill` op by op on the same tokens (the
    same kernels); a changed weight captures anew."""
    cfg, m, g = _model(seed=18)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    mc = M.CausalLM(cfg, card)
    mc.load_state_dict(m.state_dict())
    toks = [torch.randint(0, cfg.vocab_size, (2, 48), generator=g).to(card)
            for _ in range(3)]

    def equal(got, tok):
        want, want_cache = M.prefill(mc, cfg, tok, max_len=52)
        assert torch.equal(got[0], want)
        for blk, wblk in zip(got[1], want_cache):
            for sub, leaves in blk.items():
                for n, t in leaves.items():
                    assert torch.equal(t, wblk[sub][n]), (sub, n)

    equal(M.prefill_graphed(mc, cfg, toks[0], max_len=52), toks[0])
    equal(M.prefill_graphed(mc, cfg, toks[1], max_len=52), toks[1])
    before = bg.grouped_bitlinear_hd.launches
    third = M.prefill_graphed(mc, cfg, toks[2], max_len=52)  # replayed
    held = third[0].clone()
    M.prefill_graphed(mc, cfg, toks[0], max_len=52)
    assert bg.grouped_bitlinear_hd.launches == before
    assert torch.equal(third[0], held)
    equal(third, toks[2])
    with torch.no_grad():
        mc.final_norm.scale.mul_(2.0)
    equal(M.prefill_graphed(mc, cfg, toks[0], max_len=52), toks[0])

