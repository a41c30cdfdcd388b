"""The port's fault tolerance (`repro_torch.ft`), its checkpoint of bf16
train states and the train launcher, on the CPU: tests/test_ft.py's
cases on the port, a restart before the first checkpoint with the
in-place LM train step, the heartbeat, and `launch.train.main`."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import ckpt
from repro_torch.data.tokens import DataConfig, synthetic_stream
from repro_torch.ft import (
    InjectedFailure,
    StragglerMonitor,
    Supervisor,
    SupervisorConfig,
    failing_step,
    rescale_microbatches,
    reshard_state,
    slow_step,
)
from repro_torch.launch import train as launch_train
from repro_torch.train import TrainConfig, init_train_state
from repro_torch.train.train_step import make_train_step


def _toy_problem():
    """Deterministic least-squares toy: state is a weight vector."""
    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.normal(size=(32, 8)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(32,)).astype(np.float32))

    def step(state, batch):
        w = state["w"]
        g = A.t() @ (A @ w - b) / 32 + batch["noise"] * 0.0
        w = w - 0.1 * g
        loss = 0.5 * torch.mean((A @ w - b) ** 2)
        return {"w": w}, {"loss": loss}

    def make_data(start):
        def gen():
            s = start
            while True:
                yield {"noise": torch.tensor(float(s))}
                s += 1
        return gen()

    return step, make_data, {"w": torch.zeros(8)}


def _run(tmp_path, step_fn, make_data, init, n_steps, **cfg_kw):
    cfg = SupervisorConfig(ckpt_dir=tmp_path, ckpt_every=5, backoff_s=0.0,
                           **cfg_kw)
    sup = Supervisor(cfg, step_fn, make_data, init)
    return sup, sup.run(init, n_steps)


def test_supervisor_completes_without_failures(tmp_path):
    step, data, init = _toy_problem()
    sup, state = _run(tmp_path, step, data, init, 20)
    assert len(sup.history) == 20
    assert sup.history[-1]["loss"] < sup.history[0]["loss"]


def test_supervisor_survives_injected_failures(tmp_path):
    step, data, init = _toy_problem()
    flaky = failing_step(step, fail_at=[7, 13])
    sup, state = _run(tmp_path, flaky, data, init, 25)
    assert sup.restarts == 2
    steps_run = [h["step"] for h in sup.history]
    assert steps_run[-1] == 24
    assert set(range(25)).issubset(set(steps_run))
    assert ckpt.latest_step(tmp_path) is not None


def test_supervisor_result_matches_failure_free_run(tmp_path):
    step, data, init = _toy_problem()
    _, clean = _run(tmp_path / "clean", step, data, init, 25)
    _, faulted = _run(tmp_path / "flaky", failing_step(step, fail_at=[11]),
                      data, _toy_problem()[2], 25)
    np.testing.assert_allclose(clean["w"].numpy(), faulted["w"].numpy(),
                               atol=1e-6)


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    step, data, init = _toy_problem()
    always = failing_step(step, fail_at=range(0, 1000))
    cfg = SupervisorConfig(ckpt_dir=tmp_path, ckpt_every=5, max_restarts=3,
                           backoff_s=0.0)
    sup = Supervisor(cfg, always, data, init)
    with pytest.raises(InjectedFailure):
        sup.run(init, 10)
    assert sup.restarts == 4


def test_straggler_monitor_fires_on_sustained_outliers():
    m = StragglerMonitor(alpha=0.2, z=3.0, patience=2)
    for s in range(20):
        m.observe(s, 0.10 + 0.001 * (s % 3))
    fired = [s for s in range(20, 26) if m.observe(s, 0.50)]
    assert fired, "sustained 5x slowdown must alert"


def test_straggler_monitor_ignores_single_blip():
    m = StragglerMonitor(alpha=0.2, z=3.0, patience=3)
    for s in range(20):
        m.observe(s, 0.1)
    assert not m.observe(20, 0.5)
    assert not m.observe(21, 0.1)
    assert m.strikes == 0


def test_heartbeat_written(tmp_path):
    step, data, init = _toy_problem()
    hb = tmp_path / "heartbeat.json"
    _run(tmp_path, step, data, init, 5, heartbeat=hb)
    beat = json.loads(hb.read_text())
    assert beat["step"] == 4 and beat["time"] > 0


def test_rescale_microbatches():
    assert rescale_microbatches(256, 32, 16, 2) == 4
    assert rescale_microbatches(256, 16, 32, 4) == 2


# a straggler's extra seconds a step: well above a smoke step's time on a
# CPU shared with other test workers, which can start the EWMA high
STRAGGLER_S = 1.0


def _lm_run(tmp_path, fail_at=(), slow_at=(), n_steps=8, dtype="float32"):
    """llama3.2-1b+smoke under the supervisor, the port's in-place train
    step, checkpoints every 5 steps; returns (supervisor, final state)."""
    cfg = dataclasses.replace(tconfigs.get_config("llama3.2-1b+smoke"),
                              dtype=dtype)
    tcfg = TrainConfig()
    state = init_train_state(cfg, tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    step = slow_step(failing_step(make_train_step(cfg, tcfg), fail_at),
                     slow_at, STRAGGLER_S)

    def make_data(start):
        it = synthetic_stream(DataConfig(batch=2, seq_len=8,
                                         vocab_size=cfg.vocab_size))
        for _ in range(start):
            next(it)
        return it

    alerts = []
    sup = Supervisor(SupervisorConfig(ckpt_dir=tmp_path, ckpt_every=5,
                                      backoff_s=0.0, straggler_z=3.0,
                                      straggler_patience=2),
                     step, make_data, state, on_straggler=alerts.append)
    return sup, sup.run(state, n_steps), alerts


def _assert_states_equal(a, b):
    got, want = ckpt.leaf_paths(a), ckpt.leaf_paths(b)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, x), (_, y) in zip(got, want):
        assert torch.equal(x, y), name


def test_restart_before_first_checkpoint_equals_failure_free(tmp_path):
    """A failure at step 2, before the first checkpoint (step 5): the
    in-place step has already changed the state, so the supervisor must
    restart from the initial state as it was (its host copy), and the
    final state equals the failure-free run's bit for bit."""
    _, clean, _ = _lm_run(tmp_path / "clean")
    sup, faulted, _ = _lm_run(tmp_path / "flaky", fail_at=[2])
    assert sup.restarts == 1
    assert [h["step"] for h in sup.history] == [0, 1] + list(range(8))
    _assert_states_equal(faulted, clean)
    # and after the first checkpoint: restored from step 5
    sup, late, _ = _lm_run(tmp_path / "late", fail_at=[6])
    assert [h["step"] for h in sup.history][-3:] == [5, 6, 7]
    _assert_states_equal(late, clean)


def test_ft_demo_scenario_on_the_lm(tmp_path):
    """examples/ft_demo.py's scenario, shortened: two failures (one before
    and one after a checkpoint) and a straggler episode; the final
    parameters equal the failure-free run's and the straggler alerts."""
    _, clean, _ = _lm_run(tmp_path / "clean", n_steps=12)
    sup, faulted, alerts = _lm_run(tmp_path / "flaky", fail_at=[3, 8],
                                   slow_at=range(9, 12), n_steps=12)
    assert sup.restarts == 2
    # the straggler episode raised an alert; on a CPU shared with other
    # test workers, contention may raise real ones before it
    assert any(a["dt"] > STRAGGLER_S for a in alerts), alerts
    _assert_states_equal(faulted, clean)


def _bf16_state():
    cfg = dataclasses.replace(tconfigs.get_config("llama3.2-1b+smoke"),
                              dtype="bfloat16")
    return init_train_state(cfg, TrainConfig(),
                            torch.Generator().manual_seed(3), device="cpu")


def test_bf16_train_state_round_trips(tmp_path):
    """A bf16 CausalLM train state through save / restore (with and
    without device=) and AsyncCheckpointer: bit for bit, bf16 leaves
    named "bfloat16" in the manifest, written as their uint16 pattern."""
    state = _bf16_state()
    d = ckpt.save(tmp_path / "sync", 7, state)
    manifest = json.loads((d / "manifest.json").read_text())
    dtypes = {e["path"]: e["dtype"] for e in manifest["leaves"]}
    assert dtypes["params/embed"] == "bfloat16"
    assert dtypes["opt/master/embed"] == "float32"
    assert dtypes["opt/step"] == "int32"
    assert np.load(d / "params__embed.npy").dtype == np.uint16

    for device in (None, "cpu"):
        values, step = ckpt.restore(tmp_path / "sync", None, state,
                                    device=device)
        assert step == 7
        emb = values["params"]["embed"]
        assert isinstance(emb, torch.Tensor) and emb.dtype == torch.bfloat16
        assert torch.equal(emb, state["params"].embed)
        fresh = _bf16_state()
        with torch.no_grad():
            for p in fresh["params"].parameters():
                p.zero_()
        ckpt.load_into(fresh, values)
        _assert_states_equal(fresh, state)

    before = state["params"].embed.detach().clone()
    ac = ckpt.AsyncCheckpointer(tmp_path / "async")
    ac.save_async(9, state)
    with torch.no_grad():  # a later in-place update must not reach the files
        state["params"].embed.add_(1.0)
    ac.wait()
    values, _ = ckpt.restore(tmp_path / "async", 9, state)
    assert torch.equal(values["params"]["embed"], before)


def test_reference_bf16_checkpoint_loads_in_the_port(tmp_path):
    """The reference writes a bf16 leaf as |V2 bytes named "bfloat16" (and
    cannot read it back); the port restores it bit for bit."""
    w = np.random.default_rng(0).standard_normal(6).astype(np.float32)
    jckpt.save(tmp_path, 1, {"w": jnp.asarray(w, jnp.bfloat16)})
    values, _ = ckpt.restore(tmp_path, 1, {"w": np.zeros(6)})
    assert values["w"].dtype == torch.bfloat16
    assert torch.equal(values["w"], torch.from_numpy(w).to(torch.bfloat16))


def test_reshard_state_moves_every_leaf():
    state = reshard_state(_bf16_state(), "cpu")
    assert all(x.device.type == "cpu" for _, x in ckpt.leaf_paths(state))


def test_launcher_trains_on_cpu_with_and_without_checkpoints(tmp_path,
                                                             capsys):
    args = ["--device", "cpu", "--arch", "llama3.2-1b+smoke", "--steps",
            "12", "--batch", "4", "--seq", "16", "--lr", "1e-2",
            "--log-every", "4"]
    plain = launch_train.main(args)
    assert len(plain) == 12 and all(np.isfinite(plain))
    assert plain[-1] < plain[0]
    sup = launch_train.main(args + ["--ckpt-dir", str(tmp_path),
                                    "--ckpt-every", "5"])
    assert sup == plain  # same seed, same batches, same steps
    assert ckpt.latest_step(tmp_path) == 10
    out = capsys.readouterr().out
    assert "[train] step     4 loss" in out and "improved" in out


def test_launcher_refuses_model_parallel():
    """The train launcher refuses a --model-parallel below 1; above the
    world size it is capped (one CPU rank: a (1, 1) mesh training the
    unsharded losses), and the group it started is gone."""
    import torch.distributed as dist

    args = ["--device", "cpu", "--arch", "llama3.2-1b+smoke", "--steps",
            "2", "--batch", "2", "--seq", "16"]
    with pytest.raises(ValueError, match="model-parallel"):
        launch_train.main(args + ["--model-parallel", "0"])
    capped = launch_train.run(args + ["--model-parallel", "2"])
    assert not dist.is_initialized()
    assert capped["state"]["params"].embed.device_mesh.mesh.shape == (1, 1)
    np.testing.assert_allclose(capped["losses"], launch_train.main(args),
                               rtol=1e-6)
