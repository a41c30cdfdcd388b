"""The port's chunked online-softmax attention (`models/layers.py`
`_chunked_attention`, the counterpart of the reference's
`_flash_attention`) against the JAX reference on the CPU: the function
itself with its gradients, prefill and decode of two `+smoke` archs at a
sequence of several key chunks, and a training step under each remat
policy, which must make no [B, G, R, S, S] score tensor and keep none.
Inputs come from numpy seeds; float32 throughout, held to 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import model as JM
from repro.serve import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import hlo_cost
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

# float32: the same arithmetic in another summation order
TOL = 1e-4


def _flash_inputs(seed=0, b=2, g=2, r=2, s=37, dh=16):
    """q [B, G, R, S, dh], k and v [B, G, S, dh] (the reference's layout),
    positions [B, S] with some keys at -1."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, g, r, s, dh)).astype(np.float32)
    k = rng.standard_normal((b, g, s, dh)).astype(np.float32)
    v = rng.standard_normal((b, g, s, dh)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1)) + \
        np.array([[0], [3]], np.int32)
    kpos = pos.copy()
    kpos[0, [2, 9, 30]] = -1
    kpos[1, [0, 17]] = -1
    w = rng.standard_normal((b, g, r, s, dh)).astype(np.float32)
    return q, k, v, pos, kpos, w


def _port_flash(q, k, v, pos, kpos, window, chunk):
    """The port's chunks on the reference's layouts: q scaled in float32,
    k and v in their stored [B, S, G, dh] layout."""
    qf = q.to(torch.float32) * q.shape[-1] ** -0.5
    return TL._chunked_attention(qf, k.transpose(1, 2), v.transpose(1, 2),
                                 pos, kpos, window, chunk, q.dtype)


@pytest.mark.parametrize("window", [11, 1 << 30])
def test_chunked_attention_and_grads_match_flash_attention(window):
    """GQA (G = 2, R = 2), S = 37 in chunks of 8 (a padded tail), a window
    shorter than S and keys at position -1: the output and the q, k and
    v gradients of sum(out * w) against `jax.grad`, to 1e-4."""
    q, k, v, pos, kpos, w = _flash_inputs()
    chunk = 8

    def ref(q_, k_, v_):
        out = JL._flash_attention(q_, k_, v_, jnp.asarray(pos),
                                  jnp.asarray(kpos), window, chunk)
        return (out * w).sum(), out

    (_, want), jg = jax.value_and_grad(ref, argnums=(0, 1, 2),
                                       has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    got = _port_flash(tq, tk, tv, torch.from_numpy(pos),
                      torch.from_numpy(kpos), window, chunk)
    tg = torch.autograd.grad((got * torch.from_numpy(w)).sum(),
                             (tq, tk, tv))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)
    for name, a, b in zip("qkv", tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL,
                                   rtol=TOL, err_msg=f"d/d{name}")
    with torch.no_grad():  # the same chunks without the checkpoint
        plain = _port_flash(tq, tk, tv, torch.from_numpy(pos),
                            torch.from_numpy(kpos), window, chunk)
    assert torch.equal(plain, got.detach())


@pytest.fixture(scope="module")
def lm():
    built = {}

    def get(name):
        if name not in built:
            jcfg, tcfg = jconfigs.get_config(name), tconfigs.get_config(name)
            jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
            model = TM.CausalLM(tcfg, "cpu")
            model.load_state_dict(convert.lm_params_from_jax(jp, tcfg))
            built[name] = (jcfg, jp, tcfg, model)
        return built[name]

    return get


def _close(got, want, msg):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=TOL,
                               rtol=TOL, err_msg=msg)


@pytest.mark.parametrize("arch", ["llama3.2-1b+smoke", "mixtral-8x7b+smoke"])
def test_long_prefill_and_decode_match_reference(lm, arch):
    """Prefill at S = 37 (attn_chunk 8: five key chunks, the last padded;
    mixtral's window of 16 rolls the cache), then 3 decode steps over the
    cache read in chunks: logits and every cache leaf to 1e-4."""
    jcfg, jp, tcfg, model = lm(arch)
    assert tcfg.attn_chunk == 8
    b, s, extra = 2, 37, 3
    tok = np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (b, s + extra)).astype(np.int32)
    jt, tt = jnp.asarray(tok), torch.from_numpy(tok)
    jl, jc = JM.prefill(jp, jcfg, tokens=jt[:, :s])
    with torch.no_grad():
        tl, tc = TM.prefill(model, tcfg, tokens=tt[:, :s])
    _close(tl, jl, "prefill logits")

    def caches(i):
        want = convert.lm_cache_from_jax(jc, tcfg)
        for gb, wb in zip(tc, want):
            for sub in gb:
                for name in gb[sub]:
                    if name == "pos":
                        assert torch.equal(gb[sub][name], wb[sub][name])
                    else:
                        _close(gb[sub][name], wb[sub][name].numpy(),
                               f"step {i} {sub}.{name}")

    caches("prefill")
    jdecode = jsteps.make_decode_step(jcfg, donate=False)
    for i in range(extra):
        jl, jc = jdecode(jp, jc, jt[:, s + i:s + i + 1], jnp.int32(s + i))
        with torch.no_grad():
            tl, tc = TM.decode(model, tcfg, tc, tt[:, s + i:s + i + 1],
                               s + i)
        _close(tl, jl, f"decode step {i}")
        caches(i)


def _step(cfg, b, s):
    """loss_fn's forward and backward on the CPU under the port's counter:
    (the live-storage peak of the storage made inside the step, the
    largest element count of any op's result)."""
    model = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(6)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    with hlo_cost.CostCounter(record=True) as c:
        loss, _ = TM.loss_fn(model, cfg, batch)
        loss.backward()
    return c.peak_bytes, max(int(np.prod(o)) for op in c.ops
                             for o in op["out"])


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_step_peak_holds_no_score_tensor(remat, monkeypatch):
    """llama3.2-1b+smoke at S = 256, attn_chunk 32, forward and backward,
    under each remat policy: no op makes a tensor as large as one
    [B, G, R, S, S] score tensor, and the live-storage peak is at least
    that tensor's bytes below the same step's with one chunk of S keys
    (the whole score tensor at once).  Under "dots", whose policy saves
    matrix products, the peak rises by at least that tensor when the
    attention chunks' products are not exempt (`layers.in_chunk_body`):
    the exemption is what keeps the saved scores of every chunk, one
    whole S x S, out of memory.  (The step's other live storage, its
    activations, gradients and the per-chunk carries the reference's
    scan keeps too, is itself above one score tensor at these widths.)"""
    b, s = 1, 256
    cfg = dataclasses.replace(tconfigs.get_config("llama3.2-1b+smoke"),
                              remat=remat, attn_chunk=32)
    scores = b * cfg.n_heads * s * s
    peak, largest = _step(cfg, b, s)
    whole, whole_largest = _step(dataclasses.replace(cfg, attn_chunk=s), b, s)
    assert largest < scores <= whole_largest
    assert peak + 4 * scores <= whole, (peak, whole)
    if remat == "dots":
        monkeypatch.setattr(TL, "in_chunk_body", lambda: False)
        kept, _ = _step(cfg, b, s)
        assert kept >= peak + 4 * scores, (kept, peak)


def _attention_counts(fake: bool):
    """The counter's totals for `_chunked_attention`'s forward and
    backward at S = 64 in chunks of 16, on fakes or on real CPU tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    q, k, v, pos, kpos, _ = _flash_inputs(s=64)
    mode = FakeTensorMode() if fake else torch.enable_grad()
    with mode:
        tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
        tp, tkp = torch.tensor(pos), torch.tensor(kpos)
        with hlo_cost.CostCounter() as c:
            out = _port_flash(tq, tk, tv, tp, tkp, 11, 16)
            out.sum().backward()
    return c.totals


def test_counter_charges_an_attention_chunk_once_per_trip():
    """Under autograd the key chunks run through `scan_chunks`: on fakes
    one chunk runs, forward and recomputed backward, charged four times;
    FLOPs, HBM bytes and the op count equal the real run's."""
    fake, real = _attention_counts(True), _attention_counts(False)
    for key in ("flops", "hbm_bytes", "n_ops"):
        assert getattr(fake, key) == getattr(real, key), key
    assert real.flops > 0
