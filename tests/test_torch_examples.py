"""The port's four examples (`examples/torch_*.py`) on the CPU, each
through its `main(["--device", "cpu", ...])` at the fast presets, against
the JAX reference where the reference computes the same thing:

- quickstart --fast: Table II (cycles, inf/s) from the reference's
  `model_inference_cost` on the same plans, the first knob row from its
  `knob_schedule`, the deployed argmax equal to `folded_forward_exact` +
  `votes_fused` on the example's folded weights, the saved-then-loaded
  deployment's served predictions equal to the direct ones (the CNN's
  too);
- picbnn_serve on the reference's `init_params(cfg, PRNGKey(0))` weights
  and its `init_cam_head` sweep heads: the same greedy streams of both
  readouts and the same pass-sweep agreements as the reference's
  prefill / decode / `cam_head_logits` (recomputed here);
- lm_train --preset tiny: at least 60 finite losses;
- ft_demo: two restarts, final parameters equal to the failure-free run.

About 60 s of CPU time in one process (quickstart ~16 s, picbnn_serve
~15 s with the reference, lm_train ~9 s, ft_demo ~13 s)."""

import dataclasses
import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import bnn as jbnn
from repro.core import device_model as jdm
from repro.core import ensemble as jens
from repro.core import mapping as jmapping
from repro.models import binary_lm as jblm
from repro.models import model as jM
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import binary_lm as tblm
from repro_torch.models import model as tM

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example(name: str):
    sys.path.insert(0, str(EXAMPLES))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(str(EXAMPLES))


@pytest.fixture(scope="module")
def quickstart():
    return _example("torch_quickstart").main(["--fast", "--device", "cpu"])


def _jplan(plan):
    return jmapping.TilePlan(**dataclasses.asdict(plan))


def test_quickstart_table2_and_knobs_equal_reference(quickstart):
    made = quickstart["made"]
    jfolded = [jbnn.FoldedLayer(weights_pm1=np.asarray(l.weights_pm1),
                                c=np.asarray(l.c)) for l in made["folded"]]
    jplans = [jmapping.map_layer(l, 64).plan for l in jfolded[:-1]] + [
        jmapping.plan_layer(10, 128, 64)]
    assert [_jplan(p) for p in made["plans"]] == jplans
    cost = jmapping.model_inference_cost(jplans, 33)
    assert quickstart["table2_cycles"] == cost.cycles
    assert quickstart["table2_inf_per_s"] == cost.inferences_per_s
    assert quickstart["table2_inf_per_s_per_w"] == 1.0 / cost.energy_j
    knobs, achieved = jdm.knob_schedule(33, 64)
    assert quickstart["knob0"] == knobs[0].round(3).tolist()
    assert quickstart["achieved0"] == pytest.approx(float(achieved[0]),
                                                    abs=1e-5)


def test_quickstart_deployed_argmax_equals_digital_oracle(quickstart):
    made = quickstart["made"]
    jfolded = [jbnn.FoldedLayer(weights_pm1=np.asarray(l.weights_pm1),
                                c=np.asarray(l.c)) for l in made["folded"]]
    y = jbnn.folded_forward_exact(jfolded[:-1], jnp.asarray(made["vxb"]))
    hidden = jnp.where(y >= 0, 1.0, -1.0)
    votes = jens.votes_fused(jens.build_head(jfolded[-1],
                                             jens.EnsembleConfig()), hidden)
    want = np.asarray(jnp.argmax(votes, -1))
    np.testing.assert_array_equal(made["pred"].numpy(), want)
    assert quickstart["binary_top1"] == float((want == made["vy"]).mean())
    assert quickstart["binary_top1"] > 0.9  # the synthetic task is easy


def test_quickstart_loaded_deployment_serves_the_same_predictions(
        quickstart):
    made = quickstart["made"]
    # the server held the saved-then-loaded deployment
    np.testing.assert_array_equal(made["served"],
                                  made["pred"].numpy()[:512])
    assert quickstart["served_pred0"] == quickstart["direct_pred0"]
    assert quickstart["served_cnn_pred0"] == quickstart["direct_cnn_pred0"]
    assert quickstart["cnn_binary_top1"] > 0.8


def test_picbnn_serve_equals_reference_on_its_weights():
    ex = _example("torch_picbnn_serve")
    jv = jconfigs.get_config(ex.ARCH + "+cam-head")
    je = jconfigs.get_config(ex.ARCH + "+cam-head-exact")
    tv = tconfigs.get_config(ex.ARCH + "+cam-head")
    te = tconfigs.get_config(ex.ARCH + "+cam-head-exact")
    jp = jM.init_params(jv, jax.random.PRNGKey(0))
    params = tM.CausalLM(tv, "cpu")
    params.load_state_dict(convert.lm_params_from_jax(jp, tv))
    jheads, heads = {}, {}
    for n in ex.PASSES:
        c = dataclasses.replace(jv, cam_head_thresholds=n)
        jheads[n] = jblm.init_cam_head(c, jax.random.PRNGKey(0))
        heads[n] = tblm.CamHead(dataclasses.replace(tv,
                                                    cam_head_thresholds=n),
                                "cpu")
        with torch.no_grad():
            heads[n].rows.copy_(torch.from_numpy(
                np.array(jheads[n]["rows"])))
            heads[n].thresholds.copy_(torch.from_numpy(
                np.array(jheads[n]["thresholds"])))
    got = ex.run(params, te, tv, heads, torch.device("cpu"))

    # the reference's computation (examples/picbnn_serve.py) on them
    embeds, frames = ex.frames(jv.d_model)
    for name, cfg in (("adc-exact-readout", je), ("picbnn-votes", jv)):
        logits, cache = jM.prefill(jp, cfg, embeds=jnp.asarray(embeds),
                                   max_len=ex.S + ex.STEPS)
        toks = [np.argmax(np.asarray(logits), -1)]
        for t, f in enumerate(frames):
            lg, cache = jM.decode(jp, cfg, cache, jnp.asarray(f),
                                  jnp.int32(ex.S + t))
            toks.append(np.argmax(np.asarray(lg), -1))
        np.testing.assert_array_equal(got["made"]["streams"][name],
                                      np.stack(toks, 1), err_msg=name)
    h = jnp.asarray(ex.sweep_hidden(jv.d_model))
    for n, ph in jheads.items():
        c = dataclasses.replace(jv, cam_head_thresholds=n)
        votes = np.asarray(jblm.cam_head_logits(ph, c, h))
        exact = np.asarray(jblm.cam_head_logits(
            ph, dataclasses.replace(c, cam_head_mode="exact"), h))
        assert got["sweep"][str(n)] == float(
            (votes.argmax(-1) == exact.argmax(-1)).mean()), n
    assert got["sweep"][str(ex.PASSES[-1])] >= got["sweep"][str(ex.PASSES[0])]


def test_lm_train_tiny_returns_sixty_finite_losses():
    res = _example("torch_lm_train").main(["--device", "cpu"])
    assert res["steps"] >= 60 and len(res["losses"]) >= 60
    assert np.isfinite(res["losses"]).all()
    assert res["last_loss"] < res["first_loss"]


def test_ft_demo_restarts_twice_and_replays_to_the_clean_params():
    res = _example("torch_ft_demo").main(["--device", "cpu"])
    assert res["restarts"] == 2
    assert res["params_identical"] is True
    assert res["final_loss"] == res["clean_final_loss"]
