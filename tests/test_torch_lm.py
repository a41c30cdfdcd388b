"""The port's LM substrate (`repro_torch.configs`, `models/`) against the
JAX reference on the CPU, with no mesh: the reference's parameters
carried across (`convert.lm_params_from_jax`), the same numpy inputs,
then forward logits for all ten architectures, prefill + decode step by
step (logits and caches), the BitLinear FFN through kernel 1's packed
route and the CAM head through kernels 2 and 1 (plain versions on the
CPU), the MoE dispatch, the Mamba recurrence, RoPE, the initial
distributions and the config registry.  Configs are `+smoke` (float32,
d_model 64, two blocks) unless stated."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import binary_lm as jblm
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import ssm as JS
from repro.serve import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import binary_lm as tblm
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from repro_torch.serve import steps as tsteps

ARCHS = tconfigs.list_archs()
# float32 logits: the same arithmetic in another summation order
TOL = 1e-4
# bf16: a 2^-8 relative rounding at every cast, through two blocks
BF16_TOL = 2e-2
BF16_MARGIN = 0.05


@pytest.fixture(scope="module")
def lm():
    """name -> (reference cfg, reference params, port cfg, port model),
    built once per module."""
    built = {}

    def get(name, **replace):
        key = (name, tuple(sorted(replace.items())))
        if key not in built:
            jcfg = dataclasses.replace(jconfigs.get_config(name), **replace)
            tcfg = dataclasses.replace(tconfigs.get_config(name), **replace)
            jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
            model = TM.CausalLM(tcfg, "cpu")
            model.load_state_dict(convert.lm_params_from_jax(jp, tcfg))
            built[key] = (jcfg, jp, tcfg, model)
        return built[key]

    return get


def _inputs(cfg, b, s, seed=1):
    """Token ids (or frame embeddings) from numpy: (jax kwargs, torch
    kwargs)."""
    rng = np.random.default_rng(seed)
    if cfg.embeds_input:
        e = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        return {"embeds": jnp.asarray(e)}, {"embeds": torch.from_numpy(e)}
    t = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return {"tokens": jnp.asarray(t)}, {"tokens": torch.from_numpy(t)}


def _close(got, want, tol=TOL, msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=msg)


# ---------------------------------------------------------------------------
# 1. forward, every architecture
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(lm, arch):
    """Dense, GQA, MoE, SSM, hybrid, QK-norm, sliding window, tied
    embeddings, layernorm/gelu and embeds-input paths."""
    jcfg, jp, tcfg, model = lm(arch + "+smoke")
    jin, tin = _inputs(tcfg, 2, 12)
    want, jaux = JM.forward(jp, jcfg, collect_aux=True, **jin)
    with torch.no_grad():
        got, aux = TM.forward(model, tcfg, collect_aux=True, **tin)
    assert got.dtype == torch.float32 and got.shape == (2, 12,
                                                        tcfg.vocab_size)
    _close(got, want)
    _close(aux, jaux)


# ---------------------------------------------------------------------------
# 2. prefill + decode, step by step, logits and caches
# ---------------------------------------------------------------------------
def _close_cache(got, want, cfg, msg):
    want = convert.lm_cache_from_jax(want, cfg)
    assert len(got) == len(want)
    for b, (gb, wb) in enumerate(zip(got, want)):
        assert gb.keys() == wb.keys()
        for sub in gb:
            assert gb[sub].keys() == wb[sub].keys()
            for k in gb[sub]:
                if k == "pos":
                    assert torch.equal(gb[sub][k], wb[sub][k]), msg
                else:
                    _close(gb[sub][k], wb[sub][k].numpy(),
                           msg=f"{msg} block {b} {sub}.{k}")


@pytest.mark.parametrize("arch,b,s,extra", [
    ("llama3.2-1b", 2, 12, 3),
    ("mixtral-8x7b", 1, 20, 4),  # s > window 16, decode past it: rolling
    ("falcon-mamba-7b", 2, 12, 3),
    ("jamba-v0.1-52b", 2, 12, 3),
])
def test_prefill_decode_match_reference(lm, arch, b, s, extra):
    jcfg, jp, tcfg, model = lm(arch + "+smoke")
    jin, tin = _inputs(tcfg, b, s + extra, seed=2)
    jt, tt = jin["tokens"], tin["tokens"]
    jl, jc = JM.prefill(jp, jcfg, tokens=jt[:, :s])
    tl, tc = TM.prefill(model, tcfg, tokens=tt[:, :s])
    _close(tl, jl, msg="prefill logits")
    _close_cache(tc, jc, tcfg, "prefill cache")
    jdecode = jsteps.make_decode_step(jcfg, donate=False)  # one compile
    for i in range(extra):
        jl, jc = jdecode(jp, jc, jt[:, s + i:s + i + 1], jnp.int32(s + i))
        tl, tc = TM.decode(model, tcfg, tc, tt[:, s + i:s + i + 1], s + i)
        _close(tl, jl, msg=f"decode step {i}")
        _close_cache(tc, jc, tcfg, f"decode step {i} cache")


def test_decode_takes_embeds_and_cam_head(lm):
    """musicgen's CAM head at decode: frame embeddings in, votes out (the
    reference's steps take embeds; its engine does not)."""
    jcfg, jp, tcfg, model = lm("musicgen-medium+smoke+cam-head")
    jin, tin = _inputs(tcfg, 2, 9, seed=3)
    je, te = jin["embeds"], tin["embeds"]
    jl, jc = jsteps.prefill_step(jcfg, jp, {"embeds": je[:, :8]})
    tl, tc = tsteps.prefill_step(tcfg, model, {"embeds": te[:, :8]})
    _close(tl, jl)
    jv, _ = jsteps.decode_step(jcfg, jp, jc, je[:, 8:9], jnp.int32(8))
    tv, _ = tsteps.decode_step(tcfg, model, tc, te[:, 8:9], 8)
    assert np.array_equal(tv.numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# 3. Engine.generate: the reference engine's tokens and Result fields
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", ["", "+binary-ffn", "+cam-head"])
def test_engine_generate_matches_reference(lm, variant):
    from repro.serve import engine as jeng
    from repro_torch.serve import engine as teng

    jcfg, jp, tcfg, model = lm("llama3.2-1b+smoke" + variant)
    rng = np.random.default_rng(4)
    lens, news = (5, 9, 3, 7, 6), (6, 4, 6, 1, 5)
    prompts = [rng.integers(1, tcfg.vocab_size, n).astype(np.int32)
               for n in lens]

    def requests(mod):
        return [mod.Request(uid=i, prompt=p, max_new_tokens=m)
                for i, (p, m) in enumerate(zip(prompts, news))]

    # an EOS the model emits: request 1's third token without one
    free = teng.Engine(tcfg, model, teng.EngineConfig(max_batch=2, eos_id=-1),
                       device="cpu").generate(requests(teng))
    eos = free[1].tokens[2]
    got = teng.Engine(tcfg, model, teng.EngineConfig(max_batch=2,
                                                     eos_id=eos),
                      device="cpu").generate(requests(teng))
    want = jeng.Engine(jcfg, jp, jeng.EngineConfig(max_batch=2, eos_id=eos)
                       ).generate(requests(jeng))
    assert [f.name for f in dataclasses.fields(teng.Result)] == \
        [f.name for f in dataclasses.fields(jeng.Result)]
    assert [(r.uid, r.tokens) for r in got] == \
        [(r.uid, r.tokens) for r in want]
    assert got[1].tokens == free[1].tokens[:free[1].tokens.index(eos) + 1]
    assert any(len(r.tokens) == m < 6 for r, m in zip(got, news)
               if r.tokens[-1] != eos)
    for r in got:
        assert r.latency_ms == r.queue_ms + r.service_ms >= 0


def test_serve_launcher_on_cpu(capsys):
    """The reference launcher's CLI and [serve] line, asked for the CPU."""
    from repro_torch.launch import serve

    res = serve.main(["--arch", "llama3.2-1b+smoke", "--cam-head",
                      "--requests", "3", "--max-new", "4", "--batch", "2",
                      "--device", "cpu"])
    assert [len(r.tokens) for r in res] == [4, 4, 4]
    line = capsys.readouterr().out.splitlines()[0]
    assert line.startswith("[serve] arch=llama3.2-1b+smoke+cam-head "
                           "requests=3 new_tokens=12")


def test_engine_refuses_embeds_input(lm):
    from repro_torch.serve import engine as teng

    _, _, tcfg, model = lm("musicgen-medium+smoke+cam-head")
    with pytest.raises(ValueError, match="embeds"):
        teng.Engine(tcfg, model, teng.EngineConfig(), device="cpu")


# ---------------------------------------------------------------------------
# 4. the CAM head: kernels 2 and 1 (plain versions) == reference, exactly
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["votes", "exact"])
def test_cam_head_logits_bit_equal(lm, mode):
    suffix = "+cam-head" if mode == "votes" else "+cam-head-exact"
    for arch in ("llama3.2-1b", "musicgen-medium"):
        jcfg, jp, tcfg, model = lm(arch + "+smoke" + suffix)
        rng = np.random.default_rng(5)
        h = rng.standard_normal((7, tcfg.d_model)).astype(np.float32)
        h[:, ::9] = 0.0  # sign at zero -> +1
        want = np.asarray(jblm.cam_head_logits(jp["cam_head"], jcfg,
                                               jnp.asarray(h)))
        ht = torch.from_numpy(h)
        got = tblm.cam_head_logits(model.cam_head, tcfg, ht)
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), want)
        # the kernels' route == the reference's float ±1 form, bit for bit
        assert torch.equal(got, tblm.cam_head_logits_pm1(model.cam_head,
                                                         tcfg, ht))


@pytest.mark.parametrize("d,v,p", [(64, 256, 9), (1536, 2048, 33),
                                   (64, 128256, 33), (2048, 4096, 33)])
def test_cam_head_thresholds_match_reference(d, v, p):
    """The extreme-value sweep, int32, at smoke, musicgen and llama3.2
    widths and vocabularies."""
    kw = dict(d_model=d, vocab_size=v, cam_head_thresholds=p)
    jcfg = dataclasses.replace(jconfigs.get_config("llama3.2-1b+cam-head"),
                               dtype="float32", **kw)
    tcfg = dataclasses.replace(tconfigs.get_config("llama3.2-1b+cam-head"),
                               dtype="float32", **kw)
    want = np.asarray(jblm.init_cam_head(jcfg, jax.random.PRNGKey(0))
                      ["thresholds"])
    got = tblm.cam_thresholds(tcfg)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# 5. the BitLinear FFN: kernel 1's packed route
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["llama3.2-1b", "starcoder2-15b"])
def test_bitlinear_mlp_packed_route_matches_reference(lm, arch):
    """swiglu and gelu: the packed route (autograd off) and the float ±1
    route (autograd on) against the reference, exact up to the float32
    rounding of the scales."""
    jcfg, jp, tcfg, model = lm(arch + "+smoke+binary-ffn")
    rng = np.random.default_rng(6)
    h = rng.standard_normal((2, 5, tcfg.d_model)).astype(np.float32)
    ffn = model.blocks[0].sub0.ffn
    jffn = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["sub0"]["ffn"])
    want = np.asarray(jblm.bitlinear_mlp(jffn, jcfg, jnp.asarray(h)))
    with torch.no_grad():
        packed = tblm.bitlinear_mlp(ffn, tcfg, torch.from_numpy(h))
    floated = tblm.bitlinear_mlp(ffn, tcfg, torch.from_numpy(h))
    assert floated.requires_grad and not packed.requires_grad
    _close(packed, want, tol=1e-5)
    _close(floated, want, tol=1e-5)


def test_bitlinear_bf16_matches_reference(lm):
    """llama3.2-1b+smoke in bfloat16: the FFN within BF16_TOL of the
    reference on the same input, and the whole model's greedy tokens
    equal wherever the reference's top-2 logit margin exceeds
    BF16_MARGIN."""
    jcfg, jp, tcfg, model = lm("llama3.2-1b+smoke+binary-ffn",
                               dtype="bfloat16")
    rng = np.random.default_rng(7)
    h = rng.standard_normal((2, 5, tcfg.d_model)).astype(np.float32)
    ffn = model.blocks[0].sub0.ffn
    jffn = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["sub0"]["ffn"])
    want = jblm.bitlinear_mlp(jffn, jcfg, jnp.asarray(h, jnp.bfloat16))
    with torch.no_grad():
        got = tblm.bitlinear_mlp(ffn, tcfg,
                                 torch.from_numpy(h).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want.astype(jnp.float32)), tol=BF16_TOL)

    jin, tin = _inputs(tcfg, 2, 16, seed=8)
    jl, _ = JM.forward(jp, jcfg, **jin)
    with torch.no_grad():
        tl, _ = TM.forward(model, tcfg, **tin)
    jl = np.asarray(jl)
    top2 = np.sort(jl, -1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > BF16_MARGIN
    assert sure.mean() > 0.5
    assert np.array_equal(tl.numpy().argmax(-1)[sure], jl.argmax(-1)[sure])


# ---------------------------------------------------------------------------
# 6. MoE dispatch, the Mamba recurrence, RoPE
# ---------------------------------------------------------------------------
def _moe_pair(lm, cf):
    jcfg, jp, tcfg, model = lm("mixtral-8x7b+smoke", capacity_factor=cf)
    jmoe = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["sub0"]["ffn"])
    return jcfg, jmoe, tcfg, model.blocks[0].sub0.ffn


def test_moe_ample_capacity_equals_dense_mixture(lm):
    """With capacity >= T*k nothing drops: the explicit gated mixture."""
    _, _, cfg, p = _moe_pair(lm, 100.0)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 6, cfg.d_model)).astype(np.float32))
    got = TL.moe(p, cfg, x)
    t = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(t @ p.router, -1)
    gate, idx = torch.topk(probs, cfg.moe_top_k)
    gate = gate / gate.sum(-1, keepdim=True)
    want = torch.zeros_like(t)
    for i in range(t.shape[0]):
        for j in range(cfg.moe_top_k):
            e = int(idx[i, j])
            o = (torch.nn.functional.silu(t[i] @ p.w_gate[e])
                 * (t[i] @ p.w_up[e])) @ p.w_down[e]
            want[i] += gate[i, j] * o
    _close(got, want.reshape(2, 6, cfg.d_model).detach().numpy(), tol=2e-3)


def test_moe_capacity_drops_the_reference_tokens(lm):
    """At capacity factor 0.1 the same tokens overflow and output 0."""
    jcfg, jmoe, tcfg, p = _moe_pair(lm, 0.1)
    x = np.random.default_rng(10).standard_normal(
        (2, 16, tcfg.d_model)).astype(np.float32)
    want = np.asarray(JL.moe(jmoe, jcfg, jnp.asarray(x)))
    with torch.no_grad():
        got = TL.moe(p, tcfg, torch.from_numpy(x)).numpy()
    dropped = np.all(want == 0, -1)
    assert 0 < dropped.sum() < dropped.size
    assert np.array_equal(np.all(got == 0, -1), dropped)
    _close(got, want)


def test_mamba_decode_equals_scan():
    cfg = tconfigs.get_config("falcon-mamba-7b+smoke")
    p = TS.Mamba(cfg, "cpu")
    p.draw(torch.Generator().manual_seed(0))
    b, s = 2, 10
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        y_full, _ = TS.mamba_block(p, cfg, x)
        cache = TS.init_mamba_cache(cfg, b, torch.float32)
        ys = []
        for t in range(s):
            y_t, cache = TS.mamba_block(p, cfg, x[:, t:t + 1], cache=cache)
            ys.append(y_t)
    _close(torch.cat(ys, 1), y_full.numpy())


def test_mamba_block_matches_reference(lm):
    """The scan and its conv/state cache on the reference's weights."""
    jcfg, jp, tcfg, model = lm("falcon-mamba-7b+smoke")
    jm = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["sub0"]["mamba"])
    x = np.random.default_rng(12).standard_normal(
        (2, 7, tcfg.d_model)).astype(np.float32)
    jc = JS.init_mamba_cache(jcfg, 2)
    want, jnc = JS.mamba_block(jm, jcfg, jnp.asarray(x), cache=jc)
    with torch.no_grad():
        got, nc = TS.mamba_block(model.blocks[0].sub0.mamba, tcfg,
                                 torch.from_numpy(x),
                                 cache=TS.init_mamba_cache(tcfg, 2))
    _close(got, want)
    for k in ("conv", "h"):
        _close(nc[k], jnc[k])


def test_rope_relative_position_properties():
    cfg = tconfigs.get_config("llama3.2-1b+smoke")
    model = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.arange(8)[None]
    with torch.no_grad():
        l1, _ = TM.forward(model, cfg, tokens=toks)
        # RoPE is relative: a uniform shift leaves logits invariant...
        l2, _ = TM.forward(model, cfg, tokens=toks, positions=toks + 5)
        # ...but stretching relative distances changes them
        l3, _ = TM.forward(model, cfg, tokens=toks, positions=2 * toks)
    _close(l2, l1.numpy(), tol=2e-3)
    assert not np.allclose(l1.numpy(), l3.numpy(), atol=1e-4)


def test_rope_and_norms_match_reference():
    """Split-half RoPE and both norms, leaf functions on the same input."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 1000, (2, 5)).astype(np.int32)
    for arch in ("llama3.2-1b", "stablelm-3b"):
        jcfg = jconfigs.get_config(arch + "+smoke")
        tcfg = tconfigs.get_config(arch + "+smoke")
        jf, tf = JL.rope_frequencies(jcfg), TL.rope_frequencies(tcfg)
        _close(tf, jf, tol=1e-6)
        _close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), tf),
               JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), jf), tol=1e-5)
        h = rng.standard_normal((4, tcfg.d_model)).astype(np.float32)
        jn = {"scale": jnp.asarray(rng.standard_normal(tcfg.d_model),
                                   jnp.float32)}
        tn = TL.Norm(tcfg, "cpu")
        tn.scale.data = torch.tensor(np.asarray(jn["scale"]))
        if tcfg.norm == "layernorm":
            jn["bias"] = jnp.asarray(rng.standard_normal(tcfg.d_model),
                                     jnp.float32)
            tn.bias.data = torch.tensor(np.asarray(jn["bias"]))
        _close(TL.apply_norm(tn, tcfg, torch.from_numpy(h)),
               JL.apply_norm(jn, jcfg, jnp.asarray(h)), tol=1e-5)


# ---------------------------------------------------------------------------
# 7. initial distributions, parameter counts, the registry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["llama3.2-1b+cam-head", "mixtral-8x7b",
                                  "jamba-v0.1-52b", "musicgen-medium"])
def test_init_params_match_reference_distributions(lm, arch):
    """Same leaves, shapes and dtypes; leaves the reference draws with
    no randomness (norms, Mamba A_log/D/dt_bias/conv_b, the CAM sweep)
    equal (A_log to float32 log's last bit); random leaves' mean and std
    within 6 standard errors."""
    jcfg, jp, tcfg, _ = lm(arch + "+smoke")
    jp1 = JM.init_params(jcfg, jax.random.PRNGKey(1))
    want = convert.lm_params_from_jax(jp, tcfg)
    fixed = {k: torch.equal(v, w) for (k, v), w in zip(
        want.items(), convert.lm_params_from_jax(jp1, tcfg).values())}
    got = TM.init_params(tcfg, torch.Generator().manual_seed(3), "cpu")
    state = got.state_dict()
    assert state.keys() == want.keys()
    for k, w in want.items():
        g = state[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if fixed[k]:
            assert torch.allclose(g, w, rtol=2 ** -23, atol=0), k
            continue
        g, w = g.double(), w.double()
        n = w.numel()
        sd = float(w.std())
        assert abs(float(g.mean()) - float(w.mean())) < 6 * sd * (2 / n) ** .5
        assert abs(float(g.std()) / sd - 1) < 6 * (1 / n) ** .5, k


def test_param_count_and_registry_match_reference():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert tconfigs.ALIASES == jconfigs.ALIASES
    mods = ["", "+binary-ffn", "+cam-head", "+cam-head-exact", "+bf16ar",
            "+smoke", "+smoke+binary-ffn+cam-head"]
    for arch in jconfigs.list_archs():
        for mod in mods:
            jc, tc = (jconfigs.get_config(arch + mod),
                      tconfigs.get_config(arch + mod))
            assert dataclasses.asdict(tc) == dataclasses.asdict(jc), arch + mod
            assert tc.param_count() == jc.param_count()
            assert tc.active_param_count() == jc.active_param_count()
            assert tc.blocks == jc.blocks
            assert [s.name for s in tconfigs.applicable_shapes(tc)] == \
                [s.name for s in jconfigs.applicable_shapes(jc)]
    smoke = tconfigs.get_config("jamba-v0.1-52b+smoke")
    model = TM.CausalLM(smoke, "cpu")
    assert sum(p.numel() for n, p in model.named_parameters()) == \
        smoke.param_count()
    with pytest.raises(KeyError):
        tconfigs.get_config("llama3.2-1b+nope")
