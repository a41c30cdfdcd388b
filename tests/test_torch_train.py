"""The port's training substrate (`repro_torch.train`: AdamW with float32
masters, the schedule, clipping, the train step, EF-signSGD) against the
JAX reference on the CPU: tests/test_train.py's cases on the port, each
also held against the reference's value where it has one, then twelve
`train_step`s of llama3.2-1b+smoke from the same parameters and batches
against the reference's (parameters, m, v and master to 1e-4), and a
bf16 config's masters."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.train import TrainConfig as JTrainConfig
from repro.train import grad_compress as JG
from repro.train import init_train_state as jinit_train_state
from repro.train import optimizer as JO
from repro.train import train_step as jtrain_step  # the function
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.data.tokens import DataConfig, synthetic_stream
from repro_torch.models import model as TM
from repro_torch.train import TrainConfig, init_train_state
from repro_torch.train import grad_compress as G
from repro_torch.train import optimizer as O
from repro_torch.train.train_step import make_train_step, train_step

# twelve AdamW steps from the same start, float32 sums in another order.
# m and v to 1e-4 of each leaf's largest |value| (they differ by 2.4e-6 of
# it); parameters and masters to 1e-2 of each leaf's largest movement over
# the twelve steps (3.4e-3 of it: Adam's g / (sqrt(v) + eps) where |g| is
# near eps), which a skipped or doubled step (~1/12 of it) exceeds.
TRAJ_MOMENT_RTOL, TRAJ_PARAM_RTOL = 1e-4, 1e-2


def test_adamw_converges_on_quadratic():
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    ocfg = O.OptimizerConfig(lr=0.1, weight_decay=0.0, warmup_steps=0)
    state = O.init_opt_state(ocfg, params)
    for _ in range(200):
        g = {"w": 2 * params["w"]}
        params, state, _ = O.apply_updates(ocfg, params, g, state)
    assert float(params["w"].abs().max()) < 1e-2
    assert int(state["step"]) == 200


def test_grad_clip_applies():
    params = {"w": torch.zeros(3)}
    ocfg = O.OptimizerConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0,
                             warmup_steps=0)
    state = O.init_opt_state(ocfg, params)
    _, _, metrics = O.apply_updates(ocfg, params,
                                    {"w": torch.tensor([100.0, 0.0, 0.0])},
                                    state)
    assert float(metrics["grad_norm"]) == pytest.approx(100.0)
    # clipped to norm 1, then Adam's first step: lr * sign
    np.testing.assert_allclose(params["w"].numpy(), [-1.0, 0.0, 0.0],
                               atol=1e-6)


def test_master_is_a_copy_not_the_parameter():
    """`p.float()` of a float32 parameter is the parameter itself; the
    master must not alias it."""
    p = torch.ones(4)
    state = O.init_opt_state(O.OptimizerConfig(), {"w": p})
    assert state["master"]["w"].data_ptr() != p.data_ptr()
    p.add_(1.0)
    assert float(state["master"]["w"][0]) == 1.0


@pytest.mark.parametrize("ocfg", [
    O.OptimizerConfig(lr=1.0, warmup_steps=10, decay_steps=110),
    O.OptimizerConfig(lr=3e-4),
    O.OptimizerConfig(lr=2e-3, warmup_steps=0, decay_steps=20),
], ids=["warmup+cosine", "default", "cosine-only"])
def test_lr_schedule_matches_reference(ocfg):
    steps = [0, 1, 5, 10, 60, 100, 109, 200]
    got = [float(O.schedule(ocfg, torch.tensor(s, dtype=torch.int32)))
           for s in steps]
    jcfg = JO.OptimizerConfig(**dataclasses.asdict(ocfg))
    want = [float(JO.schedule(jcfg, jnp.int32(s))) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    if ocfg.decay_steps == 110:  # tests/test_train.py's shape
        assert got[0] < got[2] < got[3]
        assert got[3] == pytest.approx(1.0, abs=0.01)
        assert got[4] < got[3] and got[6] < 0.01


def test_apply_updates_matches_reference_on_a_tree():
    """One update of a three-leaf tree (one bf16 leaf) with clipping and
    weight decay: parameters, moments and masters against the
    reference's."""
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2)}
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    g = {k: (3 * rng.standard_normal(s)).astype(np.float32)
         for k, s in shapes.items()}
    ocfg = O.OptimizerConfig(lr=1e-2, warmup_steps=3)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jp["c"] = jp["c"].astype(jnp.bfloat16)
    jstate = JO.init_opt_state(JO.OptimizerConfig(
        **dataclasses.asdict(ocfg)), jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    tp["c"] = tp["c"].to(torch.bfloat16)
    tstate = O.init_opt_state(ocfg, tp)
    for _ in range(3):
        jp, jstate, jm = JO.apply_updates(JO.OptimizerConfig(
            **dataclasses.asdict(ocfg)), jp,
            {k: jnp.asarray(v) for k, v in g.items()}, jstate)
        tp, tstate, tm = O.apply_updates(
            ocfg, tp, {k: torch.from_numpy(v) for k, v in g.items()},
            tstate)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    for k in shapes:
        for got, want in ((tp[k], jp[k]), (tstate["m"][k], jstate["m"][k]),
                          (tstate["v"][k], jstate["v"][k]),
                          (tstate["master"][k], jstate["master"][k])):
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    assert tp["c"].dtype == torch.bfloat16
    assert torch.equal(tp["c"], tstate["master"]["c"].to(torch.bfloat16))


def test_sign_compress_roundtrip_scale():
    x = torch.tensor([-3.0, 1.0, 0.5, -0.25, 0.0])
    bits, s = G.sign_compress(x)
    np.testing.assert_array_equal(bits.numpy(), [-1, 1, 1, -1, 1])
    y = G.sign_decompress(bits, s)
    assert float(torch.sign(y[0])) == -1.0
    assert float(s) == pytest.approx(float(x.abs().mean()))
    for scale in ("mean_abs", "l2"):
        jb, js = JG.sign_compress(jnp.asarray(x.numpy()), scale)
        tb, ts = G.sign_compress(x, scale)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)


def test_compress_with_feedback_matches_reference():
    rng = np.random.default_rng(1)
    g = {"a": rng.standard_normal((8, 4)).astype(np.float32),
         "b": rng.standard_normal(6).astype(np.float32)}
    jres = JG.init_residual({k: jnp.asarray(v) for k, v in g.items()})
    tres = G.init_residual({k: torch.from_numpy(v) for k, v in g.items()})
    for _ in range(3):
        jhat, jres = JG.compress_with_feedback(
            {k: jnp.asarray(v) for k, v in g.items()}, jres)
        that, tres = G.compress_with_feedback(
            {k: torch.from_numpy(v) for k, v in g.items()}, tres)
    for k in g:
        np.testing.assert_allclose(that[k].numpy(), np.asarray(jhat[k]),
                                   rtol=1e-6)
        np.testing.assert_allclose(tres[k].numpy(), np.asarray(jres[k]),
                                   rtol=1e-5, atol=1e-6)


def test_ef_signsgd_converges_least_squares():
    """EF-signSGD drives a least-squares problem to near-zero loss: the
    error feedback makes 1-bit gradients unbiased in the limit."""
    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
    w = {"w": torch.zeros(16)}
    res = G.init_residual(w)
    loss = lambda w_: 0.5 * torch.mean((A @ w_ - b) ** 2)
    for _ in range(400):
        g = {"w": A.t() @ (A @ w["w"] - b) / A.shape[0]}
        g_hat, res = G.compress_with_feedback(g, res)
        w = {"w": w["w"] - 0.05 * g_hat["w"]}
    w_star = torch.linalg.lstsq(A, b[:, None]).solution[:, 0]
    assert float(loss(w["w"])) < float(loss(w_star)) + 0.05


def test_compression_ratio_near_32x():
    params = {"a": torch.zeros((1024, 1024)), "b": torch.zeros((4096,))}
    r = G.compression_ratio(params)
    assert 25.0 < r < 32.0
    assert r == pytest.approx(JG.compression_ratio(
        {"a": jnp.zeros((1024, 1024)), "b": jnp.zeros((4096,))}))


def test_train_step_with_compression_runs():
    cfg = tconfigs.get_config("llama3.2-1b+smoke")
    tcfg = TrainConfig(compression=G.CompressionConfig(enabled=True))
    state = init_train_state(cfg, tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    batch = {"tokens": np.zeros((2, 16), np.int32),
             "labels": np.zeros((2, 16), np.int32)}
    new_state, metrics = train_step(cfg, tcfg, state, batch)
    assert new_state is state
    assert bool(torch.isfinite(metrics["loss"]))
    assert float(metrics["compressed"]) == 1.0


def _trajectories(ocfg, n_steps=12):
    """The reference's and the port's train states after n_steps from the
    same parameters and batches (llama3.2-1b+smoke), and the parameters
    they started from."""
    name = "llama3.2-1b+smoke"
    jcfg, tcfg = jconfigs.get_config(name), tconfigs.get_config(name)
    jt = JTrainConfig(opt=JO.OptimizerConfig(**dataclasses.asdict(ocfg)))
    tt = TrainConfig(opt=ocfg)
    jstate = jinit_train_state(jcfg, jt, jax.random.PRNGKey(0))
    model = TM.CausalLM(tcfg, "cpu")
    start = convert.lm_params_from_jax(jstate["params"], tcfg)
    model.load_state_dict(start)
    tstate = {"params": model, "opt": O.init_opt_state(ocfg, model)}
    jstep = jax.jit(lambda s, b: jtrain_step(jcfg, jt, s, b))
    tstep = make_train_step(tcfg, tt)
    data = synthetic_stream(DataConfig(batch=4, seq_len=16,
                                       vocab_size=tcfg.vocab_size))
    for _ in range(n_steps):
        batch = next(data)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    return jstate, tstate, tcfg, start


@pytest.mark.parametrize("ocfg", [
    O.OptimizerConfig(),
    O.OptimizerConfig(warmup_steps=0, decay_steps=20),
], ids=["default", "no-warmup-cosine-20"])
def test_twelve_train_steps_match_reference(ocfg):
    jstate, tstate, tcfg, start = _trajectories(ocfg)
    assert int(tstate["opt"]["step"]) == int(jstate["opt"]["step"]) == 12
    pairs = [(dict(tstate["params"].named_parameters()),
              jstate["params"], "params")]
    pairs += [(tstate["opt"][k], jstate["opt"][k], k)
              for k in ("m", "v", "master")]
    for got, want, what in pairs:
        want = convert.lm_params_from_jax(want, tcfg)
        assert got.keys() == want.keys()
        for k in got:
            want_k = want[k].numpy()
            if what in ("m", "v"):
                atol = TRAJ_MOMENT_RTOL * np.abs(want_k).max()
            else:
                atol = TRAJ_PARAM_RTOL * np.abs(want_k - start[k].numpy()).max()
            assert atol > 0, f"{what} {k}: nothing to compare"
            np.testing.assert_allclose(
                got[k].detach().numpy(), want_k, atol=atol, rtol=0,
                err_msg=f"{what} {k}")


def test_bf16_params_follow_float32_masters():
    """bf16 llama3.2-1b+smoke: the masters and moments stay float32 and
    every parameter equals its master rounded to bf16 after each step;
    the loss falls."""
    cfg = dataclasses.replace(tconfigs.get_config("llama3.2-1b+smoke"),
                              dtype="bfloat16")
    tcfg = TrainConfig(opt=O.OptimizerConfig(lr=1e-2, warmup_steps=0))
    state = init_train_state(cfg, tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    data = synthetic_stream(DataConfig(batch=4, seq_len=16,
                                       vocab_size=cfg.vocab_size))
    losses = []
    for _ in range(6):
        state, metrics = train_step(cfg, tcfg, state, next(data))
        losses.append(float(metrics["loss"]))
        for k, p in state["params"].named_parameters():
            assert p.dtype == torch.bfloat16
            master = state["opt"]["master"][k]
            assert master.dtype == torch.float32
            assert state["opt"]["m"][k].dtype == torch.float32
            assert torch.equal(p, master.to(torch.bfloat16)), k
    assert losses[-1] < losses[0]
