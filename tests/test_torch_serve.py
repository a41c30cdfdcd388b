"""The port's serving engine (`repro_torch.serve`): served results equal a
direct `run`, batches never mix models, the micro-batcher makes the same
decisions as the reference's, and what waits for later slices raises."""

import numpy as np
import pytest
import torch

from _torch_port import BANK_BIAS, BANK_NETS, pm1, random_folded
from repro.serve import scheduler as jsched
from repro_torch import pipeline as tpipe
from repro_torch.core import ensemble as tens
from repro_torch.serve import scheduler as tsched
from repro_torch.serve.picbnn import BatchingPolicy, PicBnnServer, QueueFullError
from repro_torch.spec import InferenceSpec


def _pipe(bank, device="cpu"):
    sizes, bias = BANK_NETS[bank], BANK_BIAS[bank]
    _, tf = random_folded(sizes, sum(map(ord, bank)), bias)
    return tpipe.compile_pipeline(tf, tens.EnsembleConfig(bias_cells=bias),
                                  device=device, min_bucket=8), sizes


def _serve_and_check(devices, pipes, policy):
    server = PicBnnServer(policy, devices=devices)
    for name, (pipe, _) in pipes.items():
        server.register(name, pipe)
    times = server.warmup()
    assert set(times) == set(pipes)
    rng = np.random.default_rng(0)
    xs = {n: pm1(rng, (70, s[0])) for n, (_, s) in pipes.items()}
    with server:
        singles = {n: [server.submit(n, x[i]) for i in range(30)]
                   for n, x in xs.items()}
        bursts = {n: server.submit_many(n, x[30:]) for n, x in xs.items()}
        for n, (pipe, _) in pipes.items():
            direct = pipe.run(xs[n], InferenceSpec()).cpu().numpy()
            got = [h.result(timeout=60) for h in singles[n]]
            np.testing.assert_array_equal(np.stack([r.votes for r in got]),
                                          direct[:30])
            assert [r.pred for r in got] == list(direct[:30].argmax(-1))
            assert all(r.model_id == n and r.bucket >= r.batch_size
                       for r in got)
            np.testing.assert_array_equal(bursts[n].votes_all(timeout=60),
                                          direct[30:])
            np.testing.assert_array_equal(bursts[n].wait_all(timeout=60),
                                          direct[30:].argmax(-1))
    stats = server.stats()
    assert stats.n_requests == 70 * len(pipes)
    assert set(stats.per_model) == set(pipes)
    assert "inf/s" in stats.summary()
    return stats


@pytest.mark.parametrize("bank", sorted(BANK_NETS))
def test_served_equals_direct_on_cpu(bank):
    _serve_and_check(["cpu"], {bank: _pipe(bank)},
                     BatchingPolicy(max_batch=16, max_wait_us=200))


def test_mixed_models_never_mix_batches():
    pipes = {b: _pipe(b) for b in sorted(BANK_NETS)}
    _serve_and_check(["cpu", "cpu"], pipes,
                     BatchingPolicy(max_batch=32, max_wait_us=500))


def test_queue_full_and_drain_on_close():
    pipe, sizes = _pipe("2048x64")
    server = PicBnnServer(BatchingPolicy(max_batch=8, max_queue=4),
                          devices=["cpu"])
    server.register("m", pipe)
    x = pm1(np.random.default_rng(0), (5, sizes[0]))
    handles = [server.submit("m", x[i]) for i in range(4)]
    with pytest.raises(QueueFullError):
        server.submit("m", x[4], block=False)
    server.start()
    server.close()
    assert all(h.done() for h in handles)
    np.testing.assert_array_equal(
        np.stack([h.result().votes for h in handles]),
        pipe.run(x[:4], InferenceSpec()).numpy())
    with pytest.raises(RuntimeError):
        server.submit("m", x[0])


def test_submit_validation_and_unported_options():
    pipe, sizes = _pipe("2048x64")
    server = PicBnnServer(devices=["cpu"])
    server.register("m", pipe)
    with pytest.raises(KeyError):
        server.submit("nope", np.ones(sizes[0]))
    with pytest.raises(ValueError, match="expected image"):
        server.submit("m", np.ones(sizes[0] + 1))
    with pytest.raises(ValueError, match="noiseless"):
        server.submit("m", np.ones(sizes[0]), key=np.zeros(2, np.uint32))
    with pytest.raises(ValueError, match="already registered"):
        server.register("m", pipe)
    with pytest.raises(ValueError, match="mc_samples"):
        server.register("m2", pipe, mc_samples=4)
    for kw in (dict(layer_sizes=sizes), dict(silicon_cost=object())):
        with pytest.raises(NotImplementedError):
            server.register("m3", pipe, **kw)
    for model in ("some/dir", object()):
        with pytest.raises(NotImplementedError, match="deployment"):
            server.register("m4", model)
    with pytest.raises(NotImplementedError, match="spmd"):
        PicBnnServer(devices=["cpu"], fanout="spmd")
    with pytest.raises(ValueError, match="fanout"):
        PicBnnServer(devices=["cpu"], fanout="ring")
    server.close()


def test_default_devices_are_cuda():
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in PicBnnServer().devices)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            PicBnnServer()


def _drive(mod, events):
    """Replay put/next_batch events on a batcher with a fake clock."""
    now = [0.0]
    b = mod.MicroBatcher(mod.BatchingPolicy(max_batch=4, max_wait_us=1000),
                         clock=lambda: now[0])
    out = []
    for ev in events:
        if ev[0] == "put":
            b.put(ev[1], ev[2], size=ev[3])
        elif ev[0] == "tick":
            now[0] += ev[1]
        else:
            got = b.next_batch(timeout=0)
            out.append(None if got is None else
                       (got[0], [(s.lot, s.lo, s.hi) for s in got[1]]))
    return out


def test_micro_batcher_matches_reference():
    events = [("put", "a", "l1", 3), ("next",), ("put", "b", "l2", 1),
              ("put", "a", "l3", 2), ("next",), ("next",), ("tick", 0.002),
              ("next",), ("put", "b", "l4", 9), ("next",), ("next",),
              ("tick", 0.01), ("next",), ("next",)]
    assert _drive(tsched, events) == _drive(jsched, events)
    s = tsched.latency_summary([1.0, 2.0, 3.0, 4.0])
    assert s == tsched.LatencySummary(**vars(jsched.latency_summary(
        [1.0, 2.0, 3.0, 4.0])))
