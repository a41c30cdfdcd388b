"""The port's sharding layer (`repro_torch.sharding`, `launch/mesh.py`,
the models' axes, `ft.state_shardings`) against the JAX reference:
every rule set's specs and resolution equal the reference's, sanitize
over 200 seeded draws, `param_pspecs` / `cache_pspecs` leaf for leaf
for all ten archs; specs -> DTensor placements, the mesh helpers and the
sharded launchers on a one-rank gloo group; and two gloo ranks in a
subprocess (meshes (1, 2) and (2, 1)): sharded serving (logits to 1e-5,
CAM votes and Engine tokens equal, no float ±1 fallback), a sharded
train step to 1e-5, and the MoE's dispatch groups (G = 2) to 1e-5 of the
reference's `moe`.  The reference's own mesh paths fail under the
installed JAX, so the sharded port is held against the unsharded port
where the reference cannot run."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.models import layers as jL
from repro.models import model as jM
from repro.sharding import rules as jR
from repro_torch import configs, convert
from repro_torch.models import model as M
from repro_torch.sharding import rules as R

RULE_SETS = ["TRAIN_RULES", "TRAIN_SP_RULES", "ZERO1_PARAM_RULES",
             "SERVE_RULES", "SERVE_SEQCACHE_RULES", "LONG_CONTEXT_RULES",
             "PICBNN_SERVE_RULES"]
MESHES = [(("data", "model"), (1, 1)), (("data", "model"), (2, 2)),
          (("data", "model"), (4, 2)), (("pod", "data", "model"), (2, 16, 16))]


class _Mesh:
    """A mesh's shape without devices: what `resolve`, `sanitize_spec`
    and `logical_axis_size` read (the reference's Mesh attributes)."""

    def __init__(self, axes, shape):
        self.axis_names = axes
        self.devices = np.empty(shape)


@pytest.mark.parametrize("name", RULE_SETS)
def test_rule_set_specs_equal_reference(name):
    ref, port = getattr(jR, name), getattr(R, name)
    assert port.name == ref.name and port.rules == ref.rules
    names = list(ref.rules) + [None, "not_a_rule"]
    for a in names:
        assert tuple(port.spec(a)) == tuple(ref.spec(a)), a
        for b in names:
            assert tuple(port.spec(a, b)) == tuple(ref.spec(a, b)), (a, b)


@pytest.mark.parametrize("axes,shape", MESHES)
def test_resolve_equals_reference(axes, shape):
    mesh = _Mesh(axes, shape)
    for name in RULE_SETS:
        ref = getattr(jR, name).resolve(mesh)
        port = getattr(R, name).resolve(mesh)
        assert port.name == ref.name and port.rules == ref.rules
        for a in ref.rules:
            assert tuple(port.spec(a, "batch")) == tuple(ref.spec(a, "batch"))
        with jR.use_rules(ref, mesh), R.use_rules(port, mesh):
            for a in ref.rules:
                assert R.logical_axis_size(a) == jR.logical_axis_size(a)


def test_sanitize_spec_equals_reference_over_seeded_draws():
    rng = np.random.default_rng(0)
    entries = [None, "data", "model", "pod", ("data", "model"),
               ("pod", "data")]
    for _ in range(200):
        axes, shape = MESHES[rng.integers(len(MESHES))]
        mesh = _Mesh(axes, shape)
        nd = int(rng.integers(1, 5))
        dims = tuple(int(d) for d in rng.integers(1, 70, nd))
        spec = [entries[i] for i in rng.integers(len(entries),
                                                 size=rng.integers(0, nd + 1))]
        want = jR.sanitize_spec(jR.P(*spec), dims, mesh)
        got = R.sanitize_spec(R.P(*spec), dims, mesh)
        assert isinstance(got, R.PartitionSpec)
        assert tuple(got) == tuple(want), (dims, spec, shape)


@pytest.mark.parametrize("rules", ["TRAIN_RULES", "SERVE_RULES"])
@pytest.mark.parametrize("arch", jconfigs.list_archs()
                         # the CAM head carries its own axes
                         + ["llama3.2-1b+cam-head"])
def test_param_and_cache_pspecs_equal_reference(arch, rules):
    jcfg = jconfigs.get_config(arch + "+smoke")
    cfg = configs.get_config(arch + "+smoke")
    want = convert.lm_specs_from_jax(
        jM.param_pspecs(jcfg, getattr(jR, rules)), jcfg)
    got = {k: tuple(v) for k, v in
           M.param_pspecs(cfg, getattr(R, rules)).items()}
    assert got == want
    # every name is a parameter (or the CAM head's threshold buffer)
    assert set(got) == set(M.CausalLM(cfg, "cpu").state_dict())
    assert M.cache_pspecs(cfg, getattr(R, rules)) == \
        convert.lm_cache_specs_from_jax(
            jM.cache_pspecs(jcfg, getattr(jR, rules)), jcfg)
    cache = M.init_cache(cfg, 2, 4, "cpu")
    axes = M.cache_axes(cfg)
    assert [{s: set(v) for s, v in b.items()} for b in axes] == \
        [{s: set(v) for s, v in b.items()} for b in cache]


def test_serve_mesh_shardings_split_as_the_reference_places():
    """The classifier server's local placements: the batch sharding is
    PICBNN_SERVE_RULES' batch spec (the reference's), split into equal
    contiguous slices; the replicated one hands every device the whole
    tensor; a batch that does not divide raises."""
    mesh = R.serve_mesh(["cpu"] * 4)
    assert mesh.axis_names == ("data",) and R.logical_axis_size("batch") == 1
    bs = R.batch_sharding(mesh)
    assert tuple(bs.spec) == tuple(jR.PICBNN_SERVE_RULES.spec("batch"))
    x = torch.arange(24.0).reshape(8, 3)
    parts = bs.split(x)
    assert [tuple(p.shape) for p in parts] == [(2, 3)] * 4
    assert torch.equal(torch.cat(parts), x)
    assert all(p is x for p in R.replicated_sharding(mesh).split(x))
    with pytest.raises(ValueError, match="split evenly"):
        bs.split(x[:6])
    with R.use_rules(R.PICBNN_SERVE_RULES, mesh):
        assert R.logical_axis_size("batch") == 4
        assert R.logical_to_spec("batch", "classes") == ("data", None)
    assert R.logical_to_spec("batch", "classes") == (None, None)


# ---------------------------------------------------------------------------
# one rank
# ---------------------------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def one_rank():
    """A gloo group of one, destroyed after the test."""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_spec_to_placements_and_shard_on_one_rank(one_rank):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch import mesh as lm

    mesh = lm.make_mesh((1, 1), ("data", "model"), "cpu")
    assert lm.validate_mesh(mesh) == {"axes": {"data": 1, "model": 1},
                                      "n_devices": 1, "platform": "cpu"}
    assert R.placements(R.P("data", None), mesh) == (Shard(0), Replicate())
    assert R.placements(R.P(None, "model"), mesh) == (Replicate(), Shard(1))
    assert R.placements(R.P("model", "data"), mesh) == (Shard(1), Shard(0))
    # one dim over two axes keeps them major to minor, as GSPMD tiles
    assert R.placements(R.P(None, ("data", "model")), mesh) == \
        (Shard(1), Shard(1))
    with pytest.raises(ValueError, match="order"):
        R.placements(R.P(("model", "data")), mesh)
    assert R.placements(R.P(("pod", "data")), mesh) == (Shard(0), Replicate())
    # a real DeviceMesh resolves as the reference resolves its shape
    assert R.SERVE_RULES.resolve(mesh).rules == \
        jR.SERVE_RULES.resolve(_Mesh(("data", "model"), (1, 1))).rules
    # shard: the identity outside a rules+mesh context and on plain tensors
    x = torch.arange(12.0).reshape(3, 4)
    dt = distribute_tensor(x, mesh, (Replicate(), Replicate()))
    assert R.shard(dt, "batch", "mlp") is dt
    with R.use_rules(R.SERVE_RULES.resolve(mesh), mesh):
        assert R.shard(x, "batch", "mlp") is x
        assert R.logical_axis_size("batch") == 1
        y = R.shard(dt, "batch", "mlp")
        assert torch.equal(y.full_tensor(), x)
    assert R.current_rules() is None
    # the host mesh reuses the group; the production mesh needs 256 ranks
    assert lm.make_host_mesh(4, "cpu").mesh.shape == (1, 1)
    with pytest.raises(RuntimeError, match="256 ranks"):
        lm.make_production_mesh(device_type="cpu")


def test_state_shardings_place_the_train_state(one_rank, tmp_path):
    """state_shardings + reshard_state put every leaf as a DTensor equal
    to the plain one; a checkpoint of the sharded state (each leaf
    gathered whole) restores into it in place."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.ft import reshard_state, state_shardings
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import TrainConfig, init_train_state

    cfg = configs.get_config("llama3.2-1b+smoke")
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    state = init_train_state(cfg, TrainConfig(),
                             torch.Generator().manual_seed(0), "cpu")
    before = {k: p.detach().clone()
              for k, p in state["params"].named_parameters()}
    sh = state_shardings(cfg, mesh, R.TRAIN_RULES, state)
    assert set(sh["params"]) == set(before)
    assert set(sh["opt"]) == {"m", "v", "master", "step"}
    assert sh["opt"]["m"] == sh["params"] == sh["opt"]["master"]
    state = reshard_state(state, sh)
    for k, p in state["params"].named_parameters():
        assert R.is_dtensor(p) and torch.equal(p.full_tensor(), before[k])
        assert R.is_dtensor(state["opt"]["m"][k])
    assert R.is_dtensor(state["opt"]["step"])
    ckpt.save(tmp_path, 3, state)
    with torch.no_grad():
        for p in state["params"].parameters():
            p.zero_()
        state["opt"]["step"].fill_(7)
    values, step = ckpt.restore(tmp_path, None, state)
    ckpt.load_into(state, values)
    assert step == 3 and int(state["opt"]["step"].full_tensor()) == 0
    for k, p in state["params"].named_parameters():
        assert R.is_dtensor(p) and torch.equal(p.full_tensor(), before[k])


def test_launchers_model_parallel_one_equal_unsharded():
    """`--model-parallel 1` on the CPU: the launchers start a group of one
    (destroyed on return) and serve the tokens / train the losses of the
    unsharded launchers."""
    from repro_torch.launch import serve, train

    args = ["--arch", "llama3.2-1b+smoke", "--device", "cpu"]
    sv = ["--requests", "2", "--max-new", "4", "--cam-head"]
    plain = serve.main(args + sv)
    sharded = serve.main(args + sv + ["--model-parallel", "1"])
    assert not dist.is_initialized()
    assert [r.tokens for r in sharded] == [r.tokens for r in plain]
    tr = ["--steps", "2", "--batch", "2", "--seq", "16"]
    want = train.main(args + tr)
    got = train.main(args + tr + ["--model-parallel", "1"])
    assert not dist.is_initialized()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_launchers_leave_a_callers_group():
    """A group the caller started outlives the launchers' runs: they
    build their mesh on it and destroy only a group they started."""
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import serve, train

    args = ["--arch", "llama3.2-1b+smoke", "--device", "cpu",
            "--model-parallel", "1"]
    lmesh.ensure_process_group("cpu")
    try:
        group = dist.group.WORLD
        serve.main(args + ["--requests", "1", "--max-new", "2"])
        assert dist.is_initialized() and dist.group.WORLD is group
        train.main(args + ["--steps", "1", "--batch", "2", "--seq", "16"])
        assert dist.is_initialized() and dist.group.WORLD is group
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# two ranks (a subprocess)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Run tests/_torch_sharded_worker.py over two gloo ranks once: its
    one result line as a dict, and the directory holding the MoE's
    inputs and the port's output."""
    out = tmp_path_factory.mktemp("sharded")
    cfg = jconfigs.get_config("mixtral-8x7b+smoke")
    rng = np.random.default_rng(0)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    moe_in = {"h": rng.standard_normal((4, 8, d)).astype(np.float32),
              "router": rng.standard_normal((d, e)).astype(np.float32)
              * d ** -0.5}
    for n, shape, s in (("w_gate", (e, d, f), d), ("w_up", (e, d, f), d),
                        ("w_down", (e, f, d), f)):
        moe_in[n] = rng.standard_normal(shape).astype(np.float32) * s ** -0.5
    np.savez(out / "moe_in.npz", **moe_in)
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, str(root / "tests" / "_torch_sharded_worker.py"),
         str(_free_port()), str(out)],
        capture_output=True, text=True, timeout=180,
        env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [l for l in proc.stdout.splitlines()
             if l.startswith("SHARDED-OK ")]
    assert len(lines) == 1, proc.stdout[-2000:]
    return json.loads(lines[0].split(" ", 1)[1]), out, moe_in


@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
def test_sharded_serving_equals_unsharded(two_ranks, mesh):
    res, _, _ = two_ranks
    cam = f"{mesh}/llama3.2-1b+smoke+binary-ffn+cam-head"
    ffn = f"{mesh}/llama3.2-1b+smoke+binary-ffn"
    assert res[f"{cam}/prefill_err"] <= 1e-5
    assert res[f"{ffn}/prefill_err"] <= 1e-5
    assert res[f"{ffn}/decode_err"] <= 1e-5
    assert res[f"{cam}/votes_equal"] is True
    assert res[f"{cam}/tokens_equal"] is True
    # a K split of 48 bits a shard (not whole 32-bit words) stays exact
    assert res[f"{mesh}/bitlinear_k48/err"] <= 1e-5
    if mesh == "1x2":  # the vocab rows split over 'model', d_ff too
        assert "Shard(dim=1)" in res[f"{cam}/votes_placements"]
        assert "Shard(dim=0)" in res[f"{mesh}/bitlinear_k48/placements"]


@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
def test_sharded_train_step_equals_unsharded(two_ranks, mesh):
    res, _, _ = two_ranks
    assert "Shard" in res[f"{mesh}/train/placements"]
    assert res[f"{mesh}/train/loss_err"] <= 1e-5
    # lr 3e-4 with no warmup: the update is ~lr, held to lr / 30
    lr = res[f"{mesh}/train/lr"]
    assert res[f"{mesh}/train/update_max"] >= lr / 2
    assert res[f"{mesh}/train/update_err"] <= lr / 30
    assert res[f"{mesh}/train/opt_err"] <= 1e-5


def test_moe_dispatch_groups_equal_reference(two_ranks, monkeypatch):
    res, out, moe_in = two_ranks
    assert res["moe/groups"] == 2
    cfg = jconfigs.get_config("mixtral-8x7b+smoke")
    monkeypatch.setattr(jR, "logical_axis_size", lambda logical: 2)
    aux = {}
    p = {k: jnp.asarray(v) for k, v in moe_in.items() if k != "h"}
    want = np.asarray(jL.moe(p, cfg, jnp.asarray(moe_in["h"]), aux=aux))
    got = np.load(out / "moe_port.npz")
    np.testing.assert_allclose(got["y"], want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["aux"], float(aux["moe_aux"]), rtol=1e-5)
    # two groups are not one: the per-group capacity drops other tokens
    monkeypatch.setattr(jR, "logical_axis_size", lambda logical: 1)
    one = np.asarray(jL.moe(p, cfg, jnp.asarray(moe_in["h"])))
    assert np.abs(one - want).max() > 1e-3
