"""The port's LM training half (`models.model.loss_fn`/`chunked_loss`,
remat, `train/`) against the JAX reference on the CPU, with no mesh:
the reference's parameters carried across (`convert.lm_params_from_jax`,
which also carries the optimizer's m / v / master trees), the same numpy
batches, then the loss, its metrics and every gradient leaf against
`jax.value_and_grad(M.loss_fn)` for all ten architectures and two
BitLinear configs.  Configs are `+smoke` (float32, d_model 64, two
blocks) unless stated.  The optimizer, schedule, compression and the
twelve-step trajectories are in tests/test_torch_train.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import binary_lm as tblm
from repro_torch.models import model as TM
from repro_torch.train import TrainConfig
from repro_torch.train.train_step import loss_and_grads

ARCHS = tconfigs.list_archs()
# the loss to 1e-5 relative; gradients at tests/test_train.py's
# microbatch-equivalence tolerance (float32 sums in another order)
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
B, S = 2, 12


def build(name, **replace):
    """(reference cfg, reference params, port cfg, port model)."""
    jcfg = dataclasses.replace(jconfigs.get_config(name), **replace)
    tcfg = dataclasses.replace(tconfigs.get_config(name), **replace)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = TM.CausalLM(tcfg, "cpu")
    model.load_state_dict(convert.lm_params_from_jax(jp, tcfg))
    return jcfg, jp, tcfg, model


def batch_for(cfg, b=B, s=S, seed=1):
    """A batch from numpy: {"tokens" | "embeds", "labels"}."""
    rng = np.random.default_rng(seed)
    key = "embeds" if cfg.embeds_input else "tokens"
    x = (rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
         if cfg.embeds_input
         else rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32))
    return {key: x,
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32)}


def reference_loss_and_grads(jcfg, jp, batch):
    fn = jax.jit(jax.value_and_grad(
        lambda p, bt: JM.loss_fn(p, jcfg, bt), has_aux=True))
    (loss, metrics), grads = fn(jp, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    return loss, metrics, grads


def port_loss_and_grads(tcfg, model, batch):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = TM.loss_fn(model, tcfg, tb)
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), metrics, dict(zip(names, grads))


def assert_grads_close(got: dict, want: dict, msg=""):
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k].detach().float().numpy(),
                                   want[k].float().numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=f"{msg} {k}")


def check_against_reference(name, **replace):
    jcfg, jp, tcfg, model = build(name, **replace)
    batch = batch_for(tcfg)
    jl, jm, jg = reference_loss_and_grads(jcfg, jp, batch)
    tl, tm, tg = port_loss_and_grads(tcfg, model, batch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    assert tm.keys() == {"ce", "moe_aux"}
    for k in tm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    assert_grads_close(tg, convert.lm_params_from_jax(jg, tcfg), name)
    return tcfg, tm


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """Dense, GQA, MoE (with its aux loss), SSM, hybrid, QK-norm, sliding
    window, tied embeddings, layernorm/gelu and embeds-input archs."""
    tcfg, metrics = check_against_reference(arch + "+smoke")
    if tcfg.n_experts:
        assert float(metrics["moe_aux"]) > 0
    else:
        assert float(metrics["moe_aux"]) == 0.0


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x7b"])
def test_binary_ffn_loss_and_grads_match_reference(arch, monkeypatch):
    """The BitLinear FFN's training form (float ±1 through sign_ste).  An
    activation within 1e-5 of 0 could flip its sign between the two
    packages' summation orders; the test names that cause instead of
    hiding it.  Exact zeros are allowed: they come from a ±1 dot product
    of 0 (exact in any order), and there the gradient of |x| is the
    reference's +1.  The weights are the same bits in both packages.
    mixtral's FFNs are all MoE, which keeps float experts (as the
    reference's), so its BitLinear never runs."""
    near_zero, zeros = [], []
    inner = tblm._bit_matmul

    def recording(x, w):
        a = x.detach().abs()
        near_zero.append(int(((a > 0) & (a <= 1e-5)).sum()))
        zeros.append(int((a == 0).sum()))
        return inner(x, w)

    monkeypatch.setattr(tblm, "_bit_matmul", recording)
    tcfg, _ = check_against_reference(arch + "+smoke+binary-ffn")
    assert tcfg.binary_ffn
    assert bool(near_zero) == (tcfg.n_experts == 0)
    assert sum(near_zero) == 0, (
        f"BitLinear inputs within 1e-5 of 0 (not 0): {near_zero}")
    if near_zero:
        assert sum(zeros) > 0  # the case the derivative at 0 decides


def test_microbatches_1_against_4():
    """grads(mb=1) == grads(mb=4): the float32 sum of the microbatches'
    gradients over 4, the mean loss, the last microbatch's metrics."""
    _, _, tcfg, model = build("llama3.2-1b+smoke")
    batch = batch_for(tcfg, b=8, s=16, seed=3)
    l1, g1, m1 = loss_and_grads(tcfg, TrainConfig(microbatches=1), model,
                                batch)
    l4, g4, m4 = loss_and_grads(tcfg, TrainConfig(microbatches=4), model,
                                batch)
    np.testing.assert_allclose(float(l1), float(l4), rtol=1e-5)
    assert all(g.dtype == torch.float32 for g in g4.values())
    assert_grads_close(g4, g1, "mb 4 vs 1")
    last = {k: v[6:] for k, v in batch.items()}
    lw, mw = TM.loss_fn(model, tcfg, {k: torch.from_numpy(v)
                                      for k, v in last.items()})
    np.testing.assert_allclose(float(m4["ce"]), float(mw["ce"]), rtol=1e-6)


@pytest.mark.parametrize("arch", ["llama3.2-1b+smoke+binary-ffn",
                                  "mixtral-8x7b+smoke"])
def test_remat_policies_agree(arch):
    """remat none / full / dots: the same loss and gradients (full and
    dots recompute under autograd, so BitLinear keeps its float form)."""
    out = {}
    for remat in ("none", "full", "dots"):
        _, _, tcfg, model = build(arch, remat=remat)
        out[remat] = port_loss_and_grads(tcfg, model, batch_for(tcfg))
    for remat in ("full", "dots"):
        np.testing.assert_allclose(float(out[remat][0]),
                                   float(out["none"][0]), rtol=1e-6)
        assert_grads_close(out[remat][2], out["none"][2], remat)


def test_remat_full_recomputes_and_dots_saves_products():
    """The policies differ in what they keep: the backward pass of "full"
    recomputes the forward's matrix products, that of "dots" finds them
    saved (as many products as with no remat).  An attention chunk's
    products are recomputed under every policy (the chunk's own
    checkpoint), so they are left out of the count."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models import layers as TL

    class CountMM(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            CountMM.n += func in TM._DOTS and not TL.in_chunk_body()
            return func(*args, **(kwargs or {}))

    counts = {}
    for remat in ("none", "full", "dots"):
        _, _, tcfg, model = build("llama3.2-1b+smoke", remat=remat)
        loss, _ = TM.loss_fn(model, tcfg, {
            k: torch.from_numpy(v) for k, v in batch_for(tcfg).items()})
        CountMM.n = 0
        with CountMM():
            loss.backward()
        counts[remat] = CountMM.n
    assert counts["dots"] == counts["none"] < counts["full"], counts


@pytest.mark.parametrize("s,chunk", [(12, 4), (12, 5)])
def test_chunked_loss_matches_reference(s, chunk):
    """S a multiple of the chunk (three chunks) and not (one chunk of S),
    value and gradients wrt h and the head."""
    jcfg, jp, tcfg, model = build("llama3.2-1b+smoke")
    rng = np.random.default_rng(7)
    h = rng.standard_normal((B, s, tcfg.d_model)).astype(np.float32)
    lab = rng.integers(0, tcfg.vocab_size, (B, s)).astype(np.int32)
    want, (jgh, jgp) = jax.value_and_grad(
        lambda hh, p: JM.chunked_loss(p, jcfg, hh, jnp.asarray(lab),
                                      chunk=chunk), argnums=(0, 1))(
        jnp.asarray(h), jp)
    th = torch.from_numpy(h).requires_grad_(True)
    got = TM.chunked_loss(model, tcfg, th, torch.from_numpy(lab),
                          chunk=chunk)
    gh, ge = torch.autograd.grad(got, [th, model.embed])
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    np.testing.assert_allclose(gh.numpy(), np.asarray(jgh), atol=GRAD_ATOL,
                               rtol=GRAD_RTOL)
    np.testing.assert_allclose(ge.numpy(), np.asarray(jgp["embed"]),
                               atol=GRAD_ATOL, rtol=GRAD_RTOL)
