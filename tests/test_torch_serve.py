"""The port's serving engine (`repro_torch.serve`): served results equal a
direct `run` (noiseless, and silicon with per-request keys under any
coalescing), batches never mix models, the SPMD fan-out over four CPU
devices equals round-robin and a direct `run` (device -1 on every
result), the micro-batcher makes the same decisions as the reference's,
the Table-II stats equal the reference's, and what waits for later
slices raises."""

import threading

import numpy as np
import pytest
import torch

from _torch_port import BANK_BIAS, BANK_NETS, pm1, random_cnn, random_folded
from repro import deploy as jdep
from repro import pipeline as jpipe
from repro.core import convnet as jconv
from repro.core import ensemble as jens
from repro.serve import scheduler as jsched
from repro.serve.picbnn import BatchingPolicy as JPolicy
from repro.serve.picbnn import PicBnnServer as JServer
from repro_torch import deploy as tdep
from repro_torch import obs
from repro_torch.core import convnet as tconv
from repro_torch import pipeline as tpipe
from repro_torch.core import ensemble as tens
from repro_torch.core.device_model import NOISELESS, SILICON
from repro_torch.serve import scheduler as tsched
from repro_torch.serve.picbnn import BatchingPolicy, PicBnnServer, QueueFullError
from repro_torch.spec import InferenceSpec


def _jfolded(bank):
    sizes, bias = BANK_NETS[bank], BANK_BIAS[bank]
    return random_folded(sizes, sum(map(ord, bank)), bias)[0]


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


def test_dispatch_thread_records_its_own_run_spans():
    """With spans on, each served batch's `run` is recorded on the
    server's dispatch thread, its children nested under it and sharing its
    call id."""
    pipe, sizes = _pipe("2048x64")
    x = pm1(np.random.default_rng(1), (20, sizes[0]))
    server = PicBnnServer(BatchingPolicy(max_batch=8, max_wait_us=200),
                          devices=["cpu"])
    server.register("m", pipe)
    obs.take()
    obs.enable()
    try:
        with server:
            dispatch = server._dispatch_t.native_id
            got = server.submit_many("m", x).votes_all(timeout=60)
    finally:
        obs.disable()
    records, dropped = obs.take()
    np.testing.assert_array_equal(got, pipe.run(x, InferenceSpec()).numpy())
    runs = {r.id: r for r in records if r.name == "run"}
    assert dropped == 0 and len(runs) >= 3  # 20 rows in batches of <= 8
    # the server hands `run` its batches padded to their buckets
    assert all(r.counts["rows"] == r.counts["bucket"] for r in runs.values())
    assert sum(r.counts["rows"] for r in runs.values()) >= 20
    assert all(r.parent is None and r.call == r.id and r.thread == dispatch
               for r in runs.values())
    assert dispatch != threading.get_native_id()
    by_id = {r.id: r for r in records}
    for r in records:
        if r.name != "run":
            assert r.call in runs and r.thread == dispatch
            assert by_id[r.parent].call == r.call
    assert {r.name for r in records} == {"run", "run.pack", "run.bucket",
                                         "run.program"}


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
    # the Table-II options are ported: the reference's ValueErrors, word
    # for word
    jserver = JServer()
    jpipe_ = jpipe.compile_pipeline(_jfolded("2048x64"),
                                    jens.EnsembleConfig(bias_cells=32))
    bad = (dict(layer_sizes=sizes, silicon_cost=object()),
           dict(layer_sizes=(sizes[0] + 1, *sizes[1:])),
           dict(layer_sizes=(*sizes[:-1], sizes[-1] + 1)))
    for kw in bad:
        with pytest.raises(ValueError) as want:
            jserver.register("m3", jpipe_, **kw)
        with pytest.raises(ValueError) as got:
            server.register("m3", pipe, **kw)
        assert str(got.value) == str(want.value)
    # Deployments and saved directories are ported: a directory without
    # a deployment.json and an object of another type are rejected
    with pytest.raises(FileNotFoundError, match="deployment"):
        server.register("m4", "some/dir")
    with pytest.raises(TypeError, match="Deployment"):
        server.register("m4", object())
    # the SPMD fan-out is ported: it builds, and a bucket that does not
    # split over the devices is refused at start
    odd = PicBnnServer(BatchingPolicy(max_batch=16), devices=["cpu"] * 3,
                       fanout="spmd")
    odd.register("m", pipe)
    with pytest.raises(ValueError, match="do not divide"):
        odd.start()
    odd.close()
    with pytest.raises(ValueError, match="fanout"):
        PicBnnServer(devices=["cpu"], fanout="ring")
    server.close()


def test_table2_stats_equal_reference():
    """`silicon_inf_per_s` from `layer_sizes=` (given, or derived from a
    Deployment) and from `silicon_cost=` equals the reference server's on
    the same models; `vs_silicon` is the served rate over it."""
    bank = "1024x128"
    sizes, bias = BANK_NETS[bank], BANK_BIAS[bank]
    jf, tf = random_folded(sizes, 3, bias)
    jcnn, tcnn, jcfg, tcfg = random_cnn(2)
    tpipe_ = tpipe.compile_pipeline(tf, tens.EnsembleConfig(bias_cells=bias),
                                    device="cpu", min_bucket=8)
    models = {
        "given": (dict(model=tpipe_, layer_sizes=sizes),
                  dict(model=jpipe.compile_pipeline(
                      jf, jens.EnsembleConfig(bias_cells=bias),
                      min_bucket=8), layer_sizes=sizes)),
        "derived": (dict(model=tdep.deploy(tf, ens_cfg=tens.EnsembleConfig(
                        bias_cells=bias), device="cpu", min_bucket=8)),
                    dict(model=jdep.deploy(jf, ens_cfg=jens.EnsembleConfig(
                        bias_cells=bias), min_bucket=8))),
        "cnn": (dict(model=tdep.deploy(tcnn, config=tcfg, device="cpu",
                                       min_bucket=8),
                     silicon_cost=tconv.cnn_inference_cost(tcfg)),
                dict(model=jdep.deploy(jcnn, config=jcfg, min_bucket=8),
                     silicon_cost=jconv.cnn_inference_cost(jcfg))),
        "plain": (dict(model=tpipe_), dict(model=None)),
    }
    rng = np.random.default_rng(1)
    xs = {mid: pm1(rng, (12, sizes[0])) for mid in ("given", "derived",
                                                     "plain")}
    xs["cnn"] = rng.random((12, tcfg.n_in)).astype(np.float32)
    tsrv = PicBnnServer(BatchingPolicy(max_batch=8, max_wait_us=200),
                        devices=["cpu"])
    jsrv = JServer(JPolicy(max_batch=8, max_wait_us=200))
    for mid, (tkw, jkw) in models.items():
        tsrv.register(mid, tkw.pop("model"), **tkw)
        jm = jkw.pop("model")
        if jm is not None:
            jsrv.register(mid, jm, **jkw)
    for srv, names in ((tsrv, list(models)), (jsrv, list(models)[:-1])):
        with srv:
            hs = [srv.submit(n, xs[n][i]) for n in names for i in range(12)]
            for h in hs:
                h.result(timeout=60)
    tst, jst = tsrv.stats(), jsrv.stats()
    for mid in ("given", "derived", "cnn"):
        t, j = tst.per_model[mid], jst.per_model[mid]
        assert t.silicon_inf_per_s == j.silicon_inf_per_s > 0
        assert t.vs_silicon == t.inf_per_s / t.silicon_inf_per_s
    assert tst.per_model["plain"].silicon_inf_per_s is None
    assert tst.per_model["plain"].vs_silicon is None
    summary = tst.summary()
    assert summary.count("of Table II") == 3
    assert "silicon-equivalent" in summary


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


# ---------------------------------------------------------------------------
# silicon models: per-request keys, served == direct whatever the batching
# ---------------------------------------------------------------------------
def _keys(n, seed):
    return np.random.default_rng(seed).integers(
        0, 2 ** 32, (n, 2), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("mc", [0, 3])
def test_served_silicon_equals_direct_any_batching(mc):
    """Two coalescing policies, singles and a burst split across
    micro-batches: served votes equal a direct per-request `run` with the
    same keys (tests/test_serve_picbnn.py:333,352)."""
    sizes, bias = BANK_NETS["2048x64"], BANK_BIAS["2048x64"]
    _, tf = random_folded(sizes, 7, bias)
    pipe = tpipe.compile_pipeline(tf, tens.EnsembleConfig(bias_cells=bias),
                                  device="cpu", min_bucket=8, max_bucket=32,
                                  noise=SILICON)
    x = pm1(np.random.default_rng(4), (29, sizes[0]))
    keys = _keys(29, 11)
    spec = (InferenceSpec(noise="per_request", mc_samples=mc,
                          reduction="sum") if mc
            else InferenceSpec(noise="per_request"))
    want = pipe.run(x, spec, keys=keys).numpy()
    for pol in (BatchingPolicy(max_batch=4, max_wait_us=100.0),
                BatchingPolicy(max_batch=32, max_wait_us=5000.0)):
        srv = PicBnnServer(pol, devices=["cpu"])
        srv.register("si", pipe, mc_samples=mc)
        assert srv._models["si"].spec == spec
        with srv:
            hs = [srv.submit("si", x[i], key=keys[i]) for i in range(12)]
            burst = srv.submit_many("si", x[12:], keys=keys[12:])
            got = np.concatenate([np.stack([h.result(timeout=60).votes
                                            for h in hs]),
                                  burst.votes_all(timeout=60)])
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(burst.wait_all(timeout=60),
                                      want[12:].argmax(-1))


def test_silicon_submit_validation():
    sizes, bias = BANK_NETS["2048x64"], BANK_BIAS["2048x64"]
    _, tf = random_folded(sizes, 7, bias)
    cfg = tens.EnsembleConfig(bias_cells=bias)
    si = tpipe.compile_pipeline(tf, cfg, device="cpu", noise=SILICON)
    nl = tpipe.compile_pipeline(tf, cfg, device="cpu", noise=NOISELESS)
    server = PicBnnServer(devices=["cpu"])
    server.register("si", si)
    server.register("nl", nl)  # noiseless physics: served as noiseless
    assert server._models["nl"].spec == InferenceSpec()
    with pytest.raises(ValueError, match="mc_samples"):
        server.register("nl2", nl, mc_samples=2)
    x = np.ones(sizes[0])
    with pytest.raises(ValueError, match="PRNG key"):
        server.submit("si", x)
    with pytest.raises(ValueError, match="keys must be"):
        server.submit("si", x, key=np.zeros(3, np.uint32))
    with pytest.raises(ValueError, match="keys must be"):
        server.submit_many("si", np.ones((2, sizes[0])),
                           keys=np.zeros((3, 2), np.uint32))
    with pytest.raises(ValueError, match="noiseless"):
        server.submit("nl", x, key=np.zeros(2, np.uint32))
    server.close()


def _spmd_model(kind):
    """(pipeline, input batch, per-request keys or None) for the SPMD
    cases: a bank MLP, the tiny CNN, or a silicon MLP."""
    rng = np.random.default_rng(8)
    if kind == "cnn":
        _, tf, _, tcfg = random_cnn(5)
        pipe = tpipe.compile_pipeline(tf, tens.EnsembleConfig(),
                                      device="cpu", min_bucket=8,
                                      image_side=tcfg.side,
                                      image_encoding=tcfg.encoding)
        return pipe, rng.random((37, tcfg.n_in)).astype(np.float32), None
    sizes, bias = BANK_NETS["1024x128"], BANK_BIAS["1024x128"]
    _, tf = random_folded(sizes, 3, bias)
    noise = SILICON if kind == "silicon" else None
    pipe = tpipe.compile_pipeline(tf, tens.EnsembleConfig(bias_cells=bias),
                                  device="cpu", min_bucket=8, noise=noise)
    keys = _keys(37, 2) if noise is not None else None
    return pipe, pm1(rng, (37, sizes[0])), keys


@pytest.mark.parametrize("kind", ["mlp", "cnn", "silicon"])
def test_spmd_fanout_equals_round_robin_and_direct(kind):
    pipe, x, keys = _spmd_model(kind)
    spec = (InferenceSpec(noise="per_request") if keys is not None
            else InferenceSpec())
    direct = pipe.run(x, spec, keys=keys).numpy()
    served = {}
    for fanout in ("spmd", "round_robin"):
        srv = PicBnnServer(BatchingPolicy(max_batch=16, max_wait_us=300),
                           devices=["cpu"] * 4, fanout=fanout)
        srv.register("m", pipe)
        times = srv.warmup()["m"]
        assert set(times) == {(spec, b) for b in (8, 16)}
        with srv:
            hs = [srv.submit("m", x[i], key=None if keys is None
                             else keys[i]) for i in range(20)]
            burst = srv.submit_many("m", x[20:], keys=None if keys is None
                                    else keys[20:])
            res = [h.result(timeout=60) for h in hs]
            votes = np.concatenate([np.stack([r.votes for r in res]),
                                    burst.votes_all(timeout=60)])
        served[fanout] = votes
        devices = {r.device for r in res}
        assert devices == {-1} if fanout == "spmd" else -1 not in devices
        np.testing.assert_array_equal(
            [r.pred for r in res], direct[:20].argmax(-1))
    np.testing.assert_array_equal(served["spmd"], direct)
    np.testing.assert_array_equal(served["spmd"], served["round_robin"])

