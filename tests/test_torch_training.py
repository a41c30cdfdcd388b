"""The port's training half (`repro_torch.core.bnn` / `convnet` training,
`binarize.sign_ste`, `data.synthetic`, `checkpoint.ckpt.AsyncCheckpointer`)
against the JAX reference on the CPU: the STE, losses and every gradient
leaf from the same carried-across params, a few Adam steps from the same
initial params, the synthetic data bit for bit, trained accuracy within
the reference test's band, and a port-trained net deployed through both
packages' pipelines to the same votes."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import cnn_configs
from repro import pipeline as jpipe
from repro.core import binarize as jbin
from repro.core import bnn as jbnn
from repro.core import convnet as jconv
from repro.core import ensemble as jens
from repro.core import mapping as jmap
from repro.data import synthetic as jsyn
from repro_torch import convert
from repro_torch import pipeline as tpipe
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.core import binarize as tbin
from repro_torch.core import bnn as tbnn
from repro_torch.core import convnet as tconv
from repro_torch.core import ensemble as tens
from repro_torch.core import mapping as tmap
from repro_torch.data import synthetic as tsyn
from repro_torch.spec import InferenceSpec

# A small CNN with two conv layers (a stride-1 layer after a stride-2
# one), a hidden FC layer and a thermometer input: every piece of
# cnn_forward at a fast size.
CNN2 = (12, ("thermometer", 3), ((3, 8, 2), (3, 12, 1)), (16,), 4)

# Tolerances.  Losses and gradients: the same float32 arithmetic in
# another summation order (the ±1 products are exact integers in both).
GRAD_TOL = 1e-5
# A few Adam steps: the latent weights move by lr = 2e-3 a step, and a
# gradient entry of ~1e-9 on one side against ~1e-8 on the other changes
# that step by a fraction of lr (eps = 1e-8 sits beside sqrt(v)), so the
# latents agree to 1e-4; the BN affine terms to 1e-5; the running
# statistics (variances up to ~10^3) to a relative 1e-5.
W_TOL, AFFINE_TOL, STATS_RTOL = 1e-4, 1e-5, 1e-5


def _carried(jparams, requires_grad=False):
    """A JAX param tree -> the port's, as float32 tensors on the CPU."""
    return {g: [{k: torch.tensor(v, requires_grad=requires_grad
                                 and k in tbnn.TRAINED)
                 for k, v in layer.items()} for layer in layers]
            for g, layers in convert.params_from_jax(jparams).items()}


def _models(which):
    """(reference loss, port loss, reference params, port config, inputs,
    labels) for an MLP or a CNN, inputs and labels from numpy."""
    rng = np.random.default_rng(11)
    if which == "mlp":
        sizes = (100, 32, 16, 7)
        jcfg, tcfg = jbnn.MLPConfig(sizes), tbnn.MLPConfig(sizes)
        jp = jax.jit(jbnn.init_params, static_argnums=1)(
            jax.random.PRNGKey(0), jcfg)
        x = rng.choice([-1.0, 1.0], (64, sizes[0])).astype(np.float32)
        return (jbnn.loss_fn, tbnn.loss_fn, jp, jcfg, tcfg, x,
                rng.integers(0, sizes[-1], 64))
    jcfg, tcfg = cnn_configs(CNN2) if which == "cnn2" else cnn_configs()
    jp = jax.jit(jconv.init_cnn_params, static_argnums=1)(
        jax.random.PRNGKey(1), jcfg)
    x = rng.random((48, jcfg.n_in)).astype(np.float32)
    return (jconv.cnn_loss, tconv.cnn_loss, jp, jcfg, tcfg, x,
            rng.integers(0, jcfg.n_classes, 48))


def test_sign_ste_forward_and_backward_match_jax():
    x = np.array([0.0, -0.0, 1.0, -1.0, 1.0000001, -1.0000001, 0.5, -0.5,
                  2.0, -3.0, 1e-30, -1e-30], np.float32)
    g = np.linspace(-2.0, 3.0, x.size).astype(np.float32)
    tx = torch.tensor(x, requires_grad=True)
    y = tbin.sign_ste(tx)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(jbin.sign_ste(jnp.asarray(x))))
    assert y[0] == 1.0 and y[1] == 1.0  # 0 maps to +1
    (tgrad,) = torch.autograd.grad((y * torch.from_numpy(g)).sum(), tx)
    jgrad = jax.grad(lambda v: (jbin.sign_ste(v) * g).sum())(jnp.asarray(x))
    np.testing.assert_array_equal(tgrad.numpy(), np.asarray(jgrad))
    # |x| == 1 passes the gradient, |x| > 1 does not
    assert tgrad[2] == g[2] and tgrad[3] == g[3]
    assert tgrad[4] == 0 and tgrad[8] == 0


@pytest.mark.parametrize("which", ["mlp", "cnn", "cnn2"])
def test_loss_and_gradients_match_jax(which):
    jloss, tloss, jp, jcfg, tcfg, x, y = _models(which)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True),
                             static_argnums=3)(
        jp, jnp.asarray(x), jnp.asarray(y), jcfg)
    tp = _carried(jp, requires_grad=True)
    tl, taux = tloss(tp, x, y, tcfg)
    names = [(g, i, k) for g, layers in tp.items()
             for i in range(len(layers)) for k in tbnn.TRAINED]
    tg = torch.autograd.grad(tl, [tp[g][i][k] for g, i, k in names])
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=0,
                               atol=GRAD_TOL)
    for (g, i, k), grad in zip(names, tg):
        np.testing.assert_allclose(grad.numpy(), np.asarray(jg[g][i][k]),
                                   rtol=0, atol=GRAD_TOL, err_msg=f"{g}{i}{k}")
    for g, layers in taux.items():
        for i, layer in enumerate(layers):
            for k in ("mean", "var"):
                np.testing.assert_allclose(
                    layer[k].numpy(), np.asarray(jaux[g][i][k]),
                    rtol=STATS_RTOL, atol=GRAD_TOL)
    # eval mode leaves the stats as they were and uses them
    fwd = tbnn.forward if which == "mlp" else tconv.cnn_forward
    jfwd = jbnn.forward if which == "mlp" else jconv.cnn_forward
    with torch.no_grad():
        tlog, same = fwd(taux, x, tcfg)
    jlog, _ = jax.jit(jfwd, static_argnums=2)(jaux, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4,
                               atol=1e-4)
    assert all(a["var"] is b["var"] for g in same
               for a, b in zip(same[g], taux[g]))


def _train_both(which, jtrain, ttrain, jinit, init_name, jcfg, tcfg, x, y,
                **kw):
    j0 = jinit(jax.random.PRNGKey(5), jcfg)
    jp = jtrain(jax.random.PRNGKey(5), jcfg, x, y, **kw)
    mod = tbnn if which == "mlp" else tconv
    orig = getattr(mod, init_name)
    setattr(mod, init_name, lambda gen, cfg, dtype=torch.float32:
            _carried(j0))
    try:
        tp = ttrain(torch.Generator().manual_seed(0), tcfg, x, y,
                    device="cpu", **kw)
    finally:
        setattr(mod, init_name, orig)
    return jp, tp


@pytest.mark.parametrize("which", ["mlp", "cnn2"])
def test_training_steps_match_jax(which):
    """Twelve Adam steps (three epochs of four) from the same initial
    params, the same batches in the same order."""
    rng = np.random.default_rng(2)
    if which == "mlp":
        sizes = (196, 32, 10)
        jcfg, tcfg = jbnn.MLPConfig(sizes), tbnn.MLPConfig(sizes)
        x = rng.choice([-1.0, 1.0], (4 * 64 + 17, 196)).astype(np.float32)
        args = (jbnn.train_mlp, tbnn.train_mlp, jbnn.init_params,
                "init_params")
    else:
        jcfg, tcfg = cnn_configs(CNN2)
        x = rng.random((4 * 64 + 17, jcfg.n_in)).astype(np.float32)
        args = (jconv.train_cnn, tconv.train_cnn, jconv.init_cnn_params,
                "init_cnn_params")
    y = rng.integers(0, 4 if which != "mlp" else 10, x.shape[0])
    jp, tp = _train_both(which, *args, jcfg, tcfg, x, y, epochs=3, batch=64,
                         lr=2e-3)
    moved = 0.0
    for g, layers in tp.items():
        for i, layer in enumerate(layers):
            j = jp[g][i]
            assert not layer["w"].requires_grad
            np.testing.assert_allclose(layer["w"].numpy(), np.asarray(j["w"]),
                                       rtol=0, atol=W_TOL)
            for k in ("gamma", "beta"):
                np.testing.assert_allclose(layer[k].numpy(), np.asarray(j[k]),
                                           rtol=0, atol=AFFINE_TOL)
            for k in ("mean", "var"):
                np.testing.assert_allclose(layer[k].numpy(), np.asarray(j[k]),
                                           rtol=STATS_RTOL, atol=AFFINE_TOL)
            moved = max(moved, float(np.abs(np.asarray(j["beta"])).max()))
    assert moved > 1e-3  # the twelve steps did move the params


def test_train_cnn_clips_only_latent_weights():
    """The port's twin of tests/test_conv.py's: BN running stats track
    the real batch statistics, the latents stay in [-1, 1]."""
    _, tcfg = cnn_configs((12, ("thermometer", 4), ((3, 8, 2),), (), 4))
    rng = np.random.default_rng(1)
    tx = rng.random((256, tcfg.n_in)).astype(np.float32)
    ty = rng.integers(0, tcfg.n_classes, 256)
    params = tconv.train_cnn(torch.Generator().manual_seed(0), tcfg, tx, ty,
                             epochs=2, batch=64, lr=0.2, device="cpu")
    var = params["conv"][0]["var"].numpy()
    assert var.max() > 1.5, var  # 36-bit dot variance; 1.0 means clipped
    hit = False
    for layer in params["conv"] + params["fc"]:
        w = layer["w"].numpy()
        assert w.min() >= -1.0 and w.max() <= 1.0  # latents ARE clipped
        hit |= bool((np.abs(w) == 1.0).any())
    assert hit  # at lr 0.2 some latents reach the clip


def test_init_params_shapes_ranges_and_generator():
    cfg = tbnn.MLPConfig((50, 20, 5))
    a = tbnn.init_params(torch.Generator().manual_seed(3), cfg)
    b = tbnn.init_params(torch.Generator().manual_seed(3), cfg)
    ref = jbnn.init_params(jax.random.PRNGKey(3), jbnn.MLPConfig((50, 20, 5)))
    for la, lb, lr in zip(a["layers"], b["layers"], ref["layers"]):
        assert set(la) == set(lr)
        for k in la:
            assert la[k].shape == np.asarray(lr[k]).shape
            assert torch.equal(la[k], lb[k])  # the generator decides
        lim = float(np.sqrt(6.0 / sum(la["w"].shape)))
        assert la["w"].abs().max() <= lim and la["w"].std() > lim / 3
    _, tcfg = cnn_configs(CNN2)
    jcfg, _ = cnn_configs(CNN2)
    tp = tconv.init_cnn_params(torch.Generator().manual_seed(0), tcfg)
    jp = jconv.init_cnn_params(jax.random.PRNGKey(0), jcfg)
    for g in ("conv", "fc"):
        for lt, lj in zip(tp[g], jp[g], strict=True):
            assert {k: tuple(v.shape) for k, v in lt.items()} == \
                {k: np.asarray(v).shape for k, v in lj.items()}


@pytest.mark.parametrize("spec,n,noise,seed", [
    (tsyn.MNIST_LIKE, 40, 0.15, 0), (tsyn.HG_LIKE, 12, 0.15, 3),
    (tsyn.DatasetSpec("small", 5, 12), 30, 0.3, 7)])
def test_synthetic_data_bit_equal(spec, n, noise, seed):
    jspec = jsyn.DatasetSpec(spec.name, spec.n_classes, spec.side)
    got = tsyn.make_dataset(spec, n_train=n, n_test=n // 2, noise=noise,
                            seed=seed)
    want = jsyn.make_dataset(jspec, n_train=n, n_test=n // 2, noise=noise,
                             seed=seed)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tsyn.binarize_images(got[0]),
                                  jsyn.binarize_images(want[0]))
    with pytest.raises(ValueError, match="side"):
        tsyn.make_dataset(tsyn.DatasetSpec("tiny", 2, 4), n_train=1)


@pytest.fixture(scope="module")
def trained():
    """tests/test_bnn_training.py's net and data, trained in each
    package from its own initialisation."""
    sizes = (784, 64, 10)
    jcfg = jbnn.MLPConfig(layer_sizes=sizes, bias_cells=64)
    tcfg = tbnn.MLPConfig(layer_sizes=sizes, bias_cells=64)
    tx, ty, vx, vy = tsyn.make_dataset(tsyn.MNIST_LIKE, n_train=3000,
                                       n_test=600, seed=0)
    txb, vxb = tsyn.binarize_images(tx), tsyn.binarize_images(vx)
    jp = jbnn.train_mlp(jax.random.PRNGKey(0), jcfg, txb, ty, epochs=6,
                        batch=128, lr=2e-3)
    tp = tbnn.train_mlp(torch.Generator().manual_seed(0), tcfg, txb, ty,
                        epochs=6, batch=128, lr=2e-3, device="cpu")
    return jcfg, tcfg, jp, tp, vxb, vy


def test_trained_accuracy_within_band_of_reference(trained):
    jcfg, tcfg, jp, tp, vxb, vy = trained
    jacc = jbnn.eval_accuracy(jp, jcfg, vxb, vy, topk=(1, 2))
    tacc = tbnn.eval_accuracy(tp, tcfg, vxb, vy, topk=(1, 2))
    assert tacc["top1"] > 0.85 and jacc["top1"] > 0.85, (tacc, jacc)
    assert abs(tacc["top1"] - jacc["top1"]) <= 0.05, (tacc, jacc)
    assert tacc["top2"] >= tacc["top1"]
    # the port's eval on the reference's trained params: the same logits
    # up to float32 summation order, so at most a near-tie apart
    carried = tbnn.eval_accuracy(_carried(jp), tcfg, vxb, vy, topk=(1, 2))
    for k in ("top1", "top2"):
        assert abs(carried[k] - jacc[k]) <= 2 / len(vy), (carried, jacc)


def test_port_trained_net_deploys_to_the_reference_votes(trained):
    """fold of the port's tensor params equals the reference's fold of the
    same values; the folded net gives the same votes through both
    pipelines and the same activations through both CAM mappings."""
    jcfg, tcfg, _, tp, vxb, vy = trained
    folded = tbnn.fold(tp, tcfg)
    jfolded = jbnn.fold(convert.params_from_jax(
        {g: [{k: v.numpy() for k, v in layer.items()} for layer in ls]
         for g, ls in tp.items()}), jcfg)
    for a, b in zip(folded, jfolded, strict=True):
        np.testing.assert_array_equal(a.weights_pm1, b.weights_pm1)
        np.testing.assert_array_equal(a.c, b.c)
    got = tpipe.compile_pipeline(folded, tens.EnsembleConfig(),
                                 device="cpu").run(vxb, InferenceSpec())
    want = jpipe.compile_pipeline(jfolded, jens.EnsembleConfig()).run(
        jnp.asarray(vxb), InferenceSpec())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    acc = float((got.argmax(-1).numpy() == vy).mean())
    assert acc > tbnn.eval_accuracy(tp, tcfg, vxb, vy)["top1"] - 0.05
    # the hidden layer through the CAM tiles (784 bits: four 256-bit tiles)
    tm = tmap.map_layer(folded[0], tcfg.bias_cells)
    jm = jmap.map_layer(jfolded[0], jcfg.bias_cells)
    assert len(tm.col_tiles) == 4
    for mode in ("exact", "hierarchical"):
        np.testing.assert_array_equal(
            tmap.layer_forward(tm, torch.from_numpy(vxb[:200]), mode).numpy(),
            np.asarray(jmap.layer_forward(jm, jnp.asarray(vxb[:200]), mode)))


def test_async_checkpointer_round_trip_snapshot_and_errors(tmp_path):
    tree = {"layers": [{"w": torch.arange(6.0).reshape(2, 3),
                        "mean": torch.zeros(3)}],
            "step": np.array([4], np.int64)}
    ck = tckpt.AsyncCheckpointer(tmp_path / "ck", keep_last=2)
    ck.save_async(1, tree)
    # the snapshot was taken at the call: an in-place update after it
    # (an optimiser step) does not reach the files
    tree["layers"][0]["w"].add_(100.0)
    ck.wait()
    got, step = tckpt.restore(tmp_path / "ck", None, tree)
    assert step == 1
    np.testing.assert_array_equal(got["layers"][0]["w"],
                                  np.arange(6.0).reshape(2, 3))
    ck.save_async(2, tree)
    ck.save_async(3, tree)  # waits for step 2 first
    ck.wait()
    assert tckpt.latest_step(tmp_path / "ck") == 3
    assert sorted(p.name for p in (tmp_path / "ck").glob("step_*")) == [
        "step_00000002", "step_00000003"]
    back, _ = tckpt.restore(tmp_path / "ck", 3, target_tree=tree,
                            device="cpu")
    assert isinstance(back["layers"][0]["w"], torch.Tensor)
    assert torch.equal(back["layers"][0]["w"], tree["layers"][0]["w"])
    assert torch.equal(back["step"], torch.tensor([4]))
    # a writer error surfaces at the next wait(), once
    (tmp_path / "file").write_text("")
    bad = tckpt.AsyncCheckpointer(tmp_path / "file" / "ck")
    bad.save_async(0, tree)
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()
    # the writer (the step's files, `_write_step`) runs on a thread of
    # its own
    seen = []
    orig = tckpt._write_step
    tckpt._write_step = lambda *a, **k: seen.append(
        threading.current_thread())
    try:
        ck.save_async(9, tree)
        ck.wait()
    finally:
        tckpt._write_step = orig
    assert seen and seen[0] is not threading.current_thread()
