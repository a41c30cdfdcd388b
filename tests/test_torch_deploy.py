"""The port's checkpoint directories and Deployment artifact
(`repro_torch.checkpoint.ckpt`, `repro_torch.deploy`) against the JAX
reference: a directory saved by either package loads in the other with
the same weights, configs and noiseless votes (bit-exact), a port round
trip keeps per-request silicon votes bit-exact, the shared compile
options map as documented, and the server registers a Deployment and a
saved directory (tests/test_deploy.py:122-216)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import BANK_BIAS, BANK_NETS, pm1, random_cnn, random_folded
from repro import deploy as jdep
from repro.checkpoint import ckpt as jckpt
from repro.core import bnn as jbnn
from repro.core import device_model as jdm
from repro.core import ensemble as jens
from repro.spec import InferenceSpec as JSpec
from repro_torch import convert
from repro_torch import deploy as tdep
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import paper_cnn as tpaper
from repro_torch.configs import paper_mlp as tmlp
from repro_torch.core import bnn as tbnn
from repro_torch.core import device_model as tdm
from repro_torch.core import ensemble as tens
from repro_torch.serve.picbnn import BatchingPolicy, PicBnnServer
from repro_torch.spec import InferenceSpec

VOTES = InferenceSpec()
EACH = InferenceSpec(noise="per_request")


def _tree():
    rng = np.random.default_rng(0)
    return {"layers": [{"w": rng.integers(0, 2 ** 32, (3, 2), np.uint64)
                        .astype(np.uint32),
                        "c": rng.integers(-9, 9, 3).astype(np.int32)}
                       for _ in range(2)],
            "b": np.arange(4, dtype=np.float32)}


def test_checkpoint_directories_are_shared(tmp_path):
    tree = _tree()
    for save, restore, tmpl in (
            (tckpt.save, jckpt.restore,
             jax.tree_util.tree_map(
                 lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), tree)),
            (jckpt.save, tckpt.restore, tree),
            (tckpt.save, tckpt.restore, tree)):
        root = tmp_path / f"{save.__module__}-{restore.__module__}"
        save(root, 3, tree)
        got, step = restore(root, None, tmpl)
        assert step == 3
        want = jax.tree_util.tree_leaves(tree)
        have = [np.asarray(v) for v in jax.tree_util.tree_leaves(got)]
        assert len(want) == len(have)
        for u, v in zip(want, have):
            np.testing.assert_array_equal(u, v)
            assert u.dtype == v.dtype
    # the two packages write the same manifest entries
    jckpt.save(tmp_path / "j", 0, tree)
    tckpt.save(tmp_path / "t", 0, tree)
    mf = [json.loads((tmp_path / d / "step_00000000" / "manifest.json")
                     .read_text())["leaves"] for d in ("j", "t")]
    assert mf[0] == mf[1]
    # keep_last prunes, a missing leaf and a bad shape are refused
    for s in range(5):
        tckpt.save(tmp_path / "k", s, tree, keep_last=2)
    assert sorted(p.name for p in (tmp_path / "k").glob("step_*")) == \
        ["step_00000003", "step_00000004"]
    assert tckpt.latest_step(tmp_path / "k") == 4
    with pytest.raises(KeyError, match="missing leaf"):
        tckpt.restore(tmp_path / "t", 0, {**tree, "z": np.zeros(1)})
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.restore(tmp_path / "t", 0, {**tree, "b": np.zeros(5)})
    with pytest.raises(FileNotFoundError):
        tckpt.restore(tmp_path / "none", None, tree)


def _deployments(name, jnoise, **opts):
    """The same model as a reference Deployment and a port one."""
    if name == "cnn":
        jf, tf, jcfg, tcfg = random_cnn(5)
        return (jdep.deploy(jf, config=jcfg, noise=jnoise, impl="xla",
                            min_bucket=4, **opts),
                tdep.deploy(tf, config=tcfg, device="cpu", min_bucket=4,
                            impl="xla", **opts,
                            noise=None if jnoise is None
                            else convert.noise_from_jax(jnoise)),
                tcfg.n_in, True)
    sizes, bias = BANK_NETS[name], BANK_BIAS[name]
    jf, tf = random_folded(sizes, sum(map(ord, name)), bias)
    return (jdep.deploy(jf, ens_cfg=jens.EnsembleConfig(bias_cells=bias),
                        noise=jnoise, impl="xla", min_bucket=8, **opts),
            tdep.deploy(tf, ens_cfg=tens.EnsembleConfig(bias_cells=bias),
                        noise=None if jnoise is None
                        else convert.noise_from_jax(jnoise),
                        device="cpu", impl="xla", min_bucket=8, **opts),
            sizes[0], False)


def _inputs(n_in, conv, n=13, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.random((n, n_in)).astype(np.float32) if conv
            else pm1(rng, (n, n_in)))


@pytest.mark.parametrize("noise", [None, "SILICON"])
@pytest.mark.parametrize("name", sorted(BANK_NETS) + ["cnn"])
def test_directories_load_across_packages(name, noise, tmp_path):
    jn = getattr(jdm, noise) if noise else None
    jd, td, n_in, conv = _deployments(name, jn)
    x = _inputs(n_in, conv)
    want = np.asarray(jd.run(jnp.asarray(x), JSpec()))
    np.testing.assert_array_equal(td.run(x, VOTES).numpy(), want)
    # reference-saved -> port
    jd.save(tmp_path / "j")
    assert tdep.is_deployment_dir(tmp_path / "j")
    back = tdep.Deployment.load(tmp_path / "j", device="cpu")
    assert back.ens_cfg == td.ens_cfg and back.noise == td.noise
    assert back.compile_options == jd.compile_options
    assert back.image_side == td.image_side
    assert back.image_encoding == td.image_encoding
    for a, b in zip(td.folded, back.folded):
        np.testing.assert_array_equal(a.weights_pm1, b.weights_pm1)
        np.testing.assert_array_equal(a.c, b.c)
        assert getattr(a, "stride", 1) == getattr(b, "stride", 1)
    np.testing.assert_array_equal(back.run(x, VOTES).numpy(), want)
    # port-saved -> reference
    td.save(tmp_path / "t")
    jback = jdep.Deployment.load(tmp_path / "t")
    assert jback.noise == jn and jback.ens_cfg == jd.ens_cfg
    assert jback.compile_options == jd.compile_options
    np.testing.assert_array_equal(np.asarray(jback.run(jnp.asarray(x),
                                                       JSpec())), want)
    if noise:  # a port round trip keeps the silicon draws bit-exact
        keys = np.arange(26, dtype=np.uint32).reshape(13, 2)
        tback = tdep.Deployment.load(tmp_path / "t", device="cpu")
        assert torch.equal(tback.run(x, EACH, keys=keys),
                           td.run(x, EACH, keys=keys))
        assert not tback.pipeline().physics.is_noiseless


def test_calibrated_and_noise_configs_round_trip(tmp_path):
    """Non-default ensemble fields (calibrated heads, ens_cfg.noise) and
    analog params survive both directions; calibrated votes agree."""
    sizes, bias = BANK_NETS["2048x64"], BANK_BIAS["2048x64"]
    jf, tf = random_folded(sizes, 1, bias)
    p = jdm.AnalogParams(v_th=0.25)
    jd = jdep.deploy(jf, ens_cfg=jens.EnsembleConfig(
        bias_cells=bias, calibrated=True, noise=jdm.SILICON),
        noise=jdm.NOISELESS, params=p, impl="xla", min_bucket=8)
    jd.save(tmp_path / "j")
    td = tdep.Deployment.load(tmp_path / "j", device="cpu")
    assert td.ens_cfg == tens.EnsembleConfig(
        bias_cells=bias, calibrated=True, noise=tdm.SILICON)
    assert td.noise == tdm.NOISELESS
    assert td.params == convert.analog_params_from_jax(p)
    x = pm1(np.random.default_rng(2), (9, sizes[0]))
    np.testing.assert_array_equal(td.run(x, VOTES).numpy(),
                                  np.asarray(jd.run(jnp.asarray(x), JSpec())))
    td.save(tmp_path / "t")
    assert jdep.Deployment.load(tmp_path / "t").ens_cfg == jd.ens_cfg


def test_compile_options_map_as_documented(tmp_path):
    """min_bucket/max_bucket map, impl/interpret/chunk/bq are ignored,
    donate=True compiles and gives the same votes, unknown options are
    refused."""
    jd, _, n_in, _ = _deployments("2048x64", None, max_bucket=32, bq=16,
                                  chunk=2, interpret=True)
    jd.save(tmp_path / "j")
    td = tdep.Deployment.load(tmp_path / "j", device="cpu")
    pipe = td.pipeline()
    assert (pipe.min_bucket, pipe.max_bucket) == (8, 32)
    assert pipe is td.pipeline("cpu")
    x = _inputs(n_in, False)
    np.testing.assert_array_equal(td.run(x, VOTES).numpy(),
                                  np.asarray(jd.run(jnp.asarray(x), JSpec())))
    dd = dataclasses.replace(td, compile_options={"donate": True}, _pipes={})
    np.testing.assert_array_equal(dd.run(x, VOTES).numpy(),
                                  td.run(x, VOTES).numpy())
    with pytest.raises(ValueError, match="unknown compile options"):
        tdep.deploy(td.folded, block_size=4)
    with pytest.raises(ValueError, match="config="):
        tdep.deploy({"layers": []})
    assert tdep.COMPILE_OPTIONS == jdep.COMPILE_OPTIONS


def test_deploy_from_trained_params_and_configs():
    rng = np.random.default_rng(0)
    sizes = (64, 32, 4)
    params = {"layers": [
        {"w": rng.standard_normal((a, b)).astype(np.float32),
         "gamma": rng.uniform(0.5, 2, b).astype(np.float32),
         "beta": rng.standard_normal(b).astype(np.float32),
         "mean": rng.standard_normal(b).astype(np.float32) * 3,
         "var": rng.uniform(0.5, 2, b).astype(np.float32)}
        for a, b in zip(sizes[:-1], sizes[1:])]}
    jd = jdep.deploy(params, config=jbnn.MLPConfig(sizes, bias_cells=32),
                     impl="xla", min_bucket=8)
    td = tmlp.deploy_mlp(tbnn.MLPConfig(sizes, bias_cells=32), params,
                         device="cpu", min_bucket=8)
    assert td.ens_cfg.bias_cells == 32 and td.layer_sizes == sizes
    x = pm1(rng, (5, 64))
    np.testing.assert_array_equal(td.run(x, VOTES).numpy(),
                                  np.asarray(jd.run(jnp.asarray(x), JSpec())))
    _, tf, _, tcfg = random_cnn(3)
    dc = tpaper.deploy_cnn(tcfg, tf, device="cpu", min_bucket=4)
    assert (dc.image_side, dc.image_encoding) == (tcfg.side, tcfg.encoding)
    assert dc.layer_sizes is None and len(dc.conv_layers) == 1
    assert dc.pipeline().n_in == tcfg.side ** 2


def test_load_rejects_non_deployment_dirs(tmp_path):
    with pytest.raises(FileNotFoundError, match="deployment.json"):
        tdep.Deployment.load(tmp_path / "missing")
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "deployment.json").write_text('{"schema": "other/v9"}')
    with pytest.raises(ValueError, match="schema"):
        tdep.Deployment.load(bad)
    assert not tdep.is_deployment_dir(tmp_path / "missing")


def test_server_registers_deployment_and_directory(tmp_path):
    jd, _, n_in, _ = _deployments("2048x64", None, max_bucket=32)
    jsi, tsi, _, _ = _deployments("2048x64", jdm.SILICON, max_bucket=32)
    jsi.save(tmp_path / "si")  # saved by the reference
    tnl = tdep.Deployment.load(_save(jd, tmp_path / "nl"), device="cpu")
    x = _inputs(n_in, False, n=17, seed=3)
    keys = np.arange(34, dtype=np.uint32).reshape(17, 2)
    want_nl = np.asarray(jd.run(jnp.asarray(x), JSpec()))
    want_si = tsi.run(x, EACH, keys=keys).numpy()
    srv = PicBnnServer(BatchingPolicy(max_batch=8, max_wait_us=200.0),
                       devices=["cpu"])
    srv.register("live", tnl)
    srv.register("disk", str(tmp_path / "si"))
    with srv:
        hs_nl = [srv.submit("live", x[i]) for i in range(len(x))]
        hs_si = srv.submit_many("disk", x, keys=keys)
        got_nl = np.stack([h.result(timeout=60).votes for h in hs_nl])
        got_si = hs_si.votes_all(timeout=60)
    np.testing.assert_array_equal(got_nl, want_nl)
    np.testing.assert_array_equal(got_si, want_si)


def _save(dep, root):
    dep.save(root)
    return root
