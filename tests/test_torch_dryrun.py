"""The port's dry-run tooling (`repro_torch.launch.specs`, `roofline`,
`dryrun`) against the JAX reference (`repro.launch.*`): the fake input
specs, the parameter / optimizer / cache trees (the reference's
`jax.eval_shape` trees, leaf for leaf in shape and dtype) for all ten
archs at full size, `model_flops` for every arch and shape,
`auto_microbatches` and `rules_for` on both production meshes, the
roofline's bottleneck logic with the H100's constants, and one
full-size cell (llama3.2-1b decode_32k) traced on a fake 16 x 16 group
with its argument bytes equal to the local shard bytes of the
reference's specs.  The fake group is started and destroyed inside the
test that needs it.  The reference's own lowering on a mesh is red under
the installed JAX, so the oracle is its pure pieces."""

import json
import math

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import roofline as jroofline
from repro.launch import specs as jspecs
from repro.models import model as jM
from repro.sharding import rules as jR
from repro_torch import configs
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.launch import dryrun, roofline, specs
from repro_torch.sharding import TRAIN_RULES
from repro_torch.train import TrainConfig

ARCHS = jconfigs.list_archs()


class _Mesh:
    """A mesh's shape without devices (the reference Mesh's attributes),
    as in tests/test_torch_sharding.py."""

    def __init__(self, axes, shape):
        self.axis_names = axes
        self.devices = np.empty(shape)


MESHES = [_Mesh(("data", "model"), (16, 16)),
          _Mesh(("pod", "data", "model"), (2, 16, 16))]


def _reference_dryrun():
    """`repro.launch.dryrun`, whose import sets XLA_FLAGS to 512 host
    devices: the backend is started first with this process's devices,
    and the variable is put back once the module is in."""
    import os

    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jd

    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return jd


def _sd(x) -> tuple:
    """(shape, dtype name) of a jax ShapeDtypeStruct or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), str(x.dtype).removeprefix("torch.")
    return tuple(x.shape), str(np.dtype(x.dtype))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _ref_by_port_name(tree, blocks: int) -> dict:
    """The reference's stacked tree -> {port name: (shape, dtype)}: each
    block leaf unstacked to `blocks.{b}.<name>`."""
    out = {n: _sd(v) for n, v in _flat({k: v for k, v in tree.items()
                                         if k != "blocks"})}
    for n, v in _flat(tree["blocks"]):
        shape, dt = _sd(v)
        assert shape[0] == blocks, n
        for b in range(blocks):
            out[f"blocks.{b}.{n}"] = (shape[1:], dt)
    return out


def test_dryrun_imports_start_no_group():
    """The launch package does not import the dry-run, and importing the
    dry-run starts no process group: only its entry point's `fake_group`
    does (a fresh interpreter, as the entry point's import would be)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    probe = ("import sys, torch.distributed as dist, repro_torch.launch\n"
             "assert 'repro_torch.launch.dryrun' not in sys.modules\n"
             "import repro_torch.launch.dryrun as d\n"
             "assert not dist.is_initialized()\n"
             "with d.fake_group(4):\n"
             "    assert dist.get_world_size() == 4\n"
             "assert not dist.is_initialized()\n"
             "print('NO-GROUP')\n")
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(src)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "NO-GROUP" in out.stdout


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(arch):
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    for name, jshape in JSHAPES.items():
        want = {k: _sd(v) for k, v in jspecs.input_specs(jcfg, jshape).items()}
        with FakeTensorMode() as mode:
            got = specs.input_specs(cfg, SHAPES[name], mode)
        assert {k: _sd(v) for k, v in got.items()} == want, name
        assert all(v.device.type == specs.fake_device()
                   for v in got.values())
        b_ps = specs.batch_pspecs(cfg, SHAPES[name], TRAIN_RULES)
        j_ps = jspecs.batch_pspecs(jcfg, jshape, jR.TRAIN_RULES)
        assert {k: tuple(v) for k, v in b_ps.items()} == \
            {k: tuple(v) for k, v in j_ps.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_state_and_cache_specs_equal_reference_eval_shape(arch):
    """params / opt state / decode cache, full size: the port's fake
    trees equal the reference's `jax.eval_shape` trees leaf for leaf."""
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    jstate = jspecs.state_specs(jcfg)
    jcache = jspecs.cache_specs(jcfg, JSHAPES["decode_32k"])
    with FakeTensorMode() as mode:
        state = specs.state_specs(cfg, TrainConfig(), mode)
        cache = specs.cache_specs(cfg, SHAPES["decode_32k"], mode)
        params = specs.params_specs(cfg, mode)
    want = _ref_by_port_name(jstate["params"], cfg.blocks)
    got = {k: _sd(v) for k, v in state["params"].state_dict().items()}
    assert got == want
    assert {k: _sd(v) for k, v in params.state_dict().items()} == want
    for t in ("m", "v", "master"):
        assert {k: _sd(v) for k, v in state["opt"][t].items()} == \
            _ref_by_port_name(jstate["opt"][t], cfg.blocks), t
    assert _sd(state["opt"]["step"]) == _sd(jstate["opt"]["step"])
    assert set(state["opt"]) == set(jstate["opt"])
    for b, blk in enumerate(cache):
        assert set(blk) == set(jcache)
        for sub, leaves in blk.items():
            assert {k: _sd(v) for k, v in leaves.items()} == \
                {k: (_sd(v)[0][1:], _sd(v)[1])
                 for k, v in jcache[sub].items()}, (b, sub)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_reference(arch):
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    for name, jshape in JSHAPES.items():
        assert roofline.model_flops(cfg, SHAPES[name]) == \
            jroofline.model_flops(jcfg, jshape), name


@pytest.mark.parametrize("mesh", MESHES, ids=["pod", "multipod"])
def test_auto_microbatches_and_rules_equal_reference(mesh):
    jd = _reference_dryrun()

    for arch in ARCHS:
        jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
        for name, jshape in JSHAPES.items():
            assert dryrun.auto_microbatches(cfg, SHAPES[name], mesh) == \
                jd.auto_microbatches(jcfg, jshape, mesh), (arch, name)
    for name, jshape in JSHAPES.items():
        for variant in ("baseline", "sp", "zero1", "seqcache",
                        "sp-seqcache"):
            want = jd.rules_for(jshape, variant).resolve(mesh)
            got = dryrun.rules_for(SHAPES[name], variant).resolve(mesh)
            assert (got.name, got.rules) == (want.name, want.rules)
    assert dryrun.cell_id("a", "b", True) == jd.cell_id("a", "b", True)
    assert dryrun.cell_id("a", "b", False) == jd.cell_id("a", "b", False)


def test_roofline_derive_bottleneck_logic_h100():
    """The reference's bottleneck test, with the H100 SXM's constants."""
    cfg = configs.get_config("llama3.2-1b")
    rep = roofline.derive(cfg, SHAPES["train_4k"], 256, device_flops=1e12,
                          device_hbm_bytes=1e9, device_wire_bytes=1e6)
    assert rep.bottleneck == "compute"
    assert rep.compute_s == pytest.approx(1e12 / 989.4e12)
    rep = roofline.derive(cfg, SHAPES["train_4k"], 256, device_flops=1e9,
                          device_hbm_bytes=1e12, device_wire_bytes=1e6)
    assert rep.bottleneck == "memory"
    assert rep.memory_s == pytest.approx(1e12 / 3.35e12)
    assert 0.0 <= rep.roofline_fraction <= 1.0
    # wire bytes at the network's rate unless named NVLink's
    rep = roofline.derive(cfg, SHAPES["train_4k"], 256, device_flops=1e9,
                          device_hbm_bytes=1e9, device_wire_bytes=1e11,
                          device_nvlink_bytes=4e10)
    assert rep.bottleneck == "collective"
    assert rep.collective_s == pytest.approx(4e10 / 450e9 + 6e10 / 50e9)
    # kernels 1 and 2 at the 1-bit tensor-core rate, inside compute
    rep = roofline.derive(cfg, SHAPES["decode_32k"], 256, device_flops=0.0,
                          device_hbm_bytes=0.0, device_wire_bytes=0.0,
                          device_binary_ops=9.96e15)
    assert rep.binary_s == pytest.approx(1.0, rel=1e-3)
    assert rep.compute_s == rep.binary_s and rep.bottleneck == "compute"
    assert roofline.PEAK_FLOPS != jroofline.PEAK_FLOPS  # no v5e constant


def _local_bytes(tree, pspecs, mesh) -> int:
    """Bytes a device holds of a reference spec tree laid out by its
    (sanitised) specs on `mesh`."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    total = 0
    for (_, sds), spec in zip(
            jax.tree_util.tree_leaves_with_path(tree),
            jax.tree_util.tree_leaves(
                pspecs, is_leaf=lambda x: isinstance(x, jR.P))):
        spec = jR.sanitize_spec(spec, sds.shape, mesh)
        factor = 1
        for ax in spec:
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                factor *= sizes.get(a, 1) if a else 1
        total += math.prod(sds.shape) // factor * np.dtype(sds.dtype).itemsize
    return total


def test_full_size_decode_cell_on_fake_pod(tmp_path):
    """llama3.2-1b decode_32k on the fake 16 x 16 group: status ok, a
    record with the reference's keys, and argument bytes a device equal
    to the local shard bytes of the reference's param_pspecs and
    cache_pspecs under SERVE_RULES, plus the tokens and the position."""
    with dryrun.fake_group(256):
        rec = dryrun.run_cell("llama3.2-1b", "decode_32k", False, tmp_path)
    assert rec["status"] == "ok", rec.get("traceback")
    saved = json.loads((tmp_path / "llama3.2-1b__decode_32k__pod.json")
                       .read_text())
    for key in ("arch", "shape", "mesh", "multi_pod", "variant", "status",
                "compile_s", "memory_analysis", "cost_analysis_raw",
                "hlo_walker", "roofline", "hlo_size_bytes"):
        assert key in saved, key
    assert saved["mesh"]["axes"] == {"data": 16, "model": 16}
    jcfg = jconfigs.get_config("llama3.2-1b")
    mesh = MESHES[0]
    rules = jR.SERVE_RULES.resolve(mesh)
    shape = JSHAPES["decode_32k"]
    want = (_local_bytes(jspecs.params_specs(jcfg),
                         jM.param_pspecs(jcfg, rules), mesh)
            + _local_bytes(jspecs.cache_specs(jcfg, shape),
                           jM.cache_pspecs(jcfg, rules), mesh)
            + shape.global_batch * 4 + 4)
    mem = rec["memory_analysis"]
    assert mem["argument_bytes_per_device"] == want
    # the cache is written in place (the reference donates it)
    assert mem["alias_bytes_per_device"] == _local_bytes(
        jspecs.cache_specs(jcfg, shape), jM.cache_pspecs(jcfg, rules), mesh)
    w = rec["hlo_walker"]
    assert w["device_flops"] > 0 and w["collective_count"] > 0
    assert w["collective_count"] == sum(w["comm_debug_counts"].values())
    assert rec["cost_analysis_raw"]["flops"] > 0
    # decode reads the bf16 cache once, a chunk at a time (no float32
    # copy): about the arguments' bytes, and the step bound by its
    # collectives
    assert w["device_hbm_bytes"] < 1.1 * mem["argument_bytes_per_device"]
    assert rec["roofline"]["bottleneck"] == "collective"


# ---------------------------------------------------------------------------
# the repairs of the sharded loss, embedding and seqcache decode, on a
# fake 2 x 2 group at smoke size
# ---------------------------------------------------------------------------
SMOKE_TRAIN = ShapeConfig("train_4k", "train", 64, 8)
SMOKE_DECODE = ShapeConfig("decode_32k", "decode", 64, 4)


@pytest.fixture
def fake_2x2():
    with dryrun.fake_group(4):
        yield dryrun.fake_mesh((2, 2), ("data", "model"))


def _one_hot_gold(logits, labels):
    """The gold logit as the port computed it before: a plain one-hot of
    the whole batch's labels over the whole vocabulary, a masked sum."""
    from repro_torch.models import layers as L

    onehot = L.one_hot(labels.long(), logits.shape[-1]).to(torch.float32)
    return (logits * onehot).sum(-1)


def test_vocab_split_train_trace_holds_no_whole_one_hot(fake_2x2,
                                                        monkeypatch):
    """llama3.2-1b+smoke (vocab widened to 16,384 so the loss dominates)
    train step on a fake 2 x 2 mesh, vocab split over 'model', batch over
    'data': no tensor of B * chunk * V elements is made (the one-hot of
    the whole batch over the whole vocabulary), the embedding looks up
    the whole batch on the device's own columns, [B, S, D/dp] (its
    tokens, fewer than dp times the table's local rows, are cheaper to
    gather than the table's columns: `test_vocab_split_embedding_gathers_
    the_cheaper_operand`), and the counted peak falls by at least that
    one-hot's bytes (int64, as `F.one_hot` makes it) against the same
    trace with the one-hot gold logit, and below the trace with the vocab
    unsplit."""
    import dataclasses

    from repro_torch.models import model as tM
    from repro_torch.sharding import TRAIN_RULES

    cfg = dataclasses.replace(configs.get_config("llama3.2-1b+smoke"),
                              vocab_size=16384)
    b, s, v, d = SMOKE_TRAIN.global_batch, SMOKE_TRAIN.seq_len, 16384, 64
    tr = dryrun.lower_cell(cfg, SMOKE_TRAIN, fake_2x2, record=True)
    whole = b * s * v
    assert not [o for o in tr.ops for shape in o["out"]
                if math.prod(shape) >= whole], "a whole-batch one-hot"
    emb = [o["out"][0] for o in tr.ops if o["op"] == "aten.embedding"]
    assert emb and all(shape == [b, s, d // 2] for shape in emb), emb

    monkeypatch.setattr(tM, "_gold_logit", _one_hot_gold)
    old = dryrun.lower_cell(cfg, SMOKE_TRAIN, fake_2x2)
    monkeypatch.undo()
    assert tr.memory["temp_bytes_per_device"] <= \
        old.memory["temp_bytes_per_device"] - 8 * whole
    unsplit = dataclasses.replace(TRAIN_RULES, rules={
        **TRAIN_RULES.rules, "vocab": None, "p_vocab": None,
        "p_embed_v": None})
    monkeypatch.setattr(dryrun, "rules_for", lambda shape, variant: unsplit)
    whole_v = dryrun.lower_cell(cfg, SMOKE_TRAIN, fake_2x2)
    assert tr.memory["temp_bytes_per_device"] < \
        whole_v.memory["temp_bytes_per_device"]


@pytest.mark.parametrize("b, s, gathered", [(4, 8, "tokens"),
                                             (8, 256, "table")])
def test_vocab_split_embedding_gathers_the_cheaper_operand(fake_2x2, b, s,
                                                           gathered):
    """A [1024, 64] table under TRAIN_RULES on a fake 2 x 2 mesh (V split
    over 'model', D over 'data', the tokens' batch over 'data'): each
    device's output is [B/2, S, D], a partial sum over the vocab shards.
    Where the tokens number fewer than 2 x the 512 local table rows the
    tokens are gathered (every row looked up on the device's own 32
    columns, moved to its batch shard), else the table's columns (the
    device's own rows looked up on all 64): the lookup's shape shows
    which, and only the second gathers the table's 512 x 64 local rows."""
    from repro_torch.launch import hlo_cost
    from repro_torch.sharding import use_rules
    from repro_torch.sharding.rules import distribute, sharded_embedding

    rules = TRAIN_RULES.resolve(fake_2x2)
    v, d = 1024, 64
    with FakeTensorMode(), use_rules(rules, fake_2x2):
        dev = specs.fake_device()
        table = distribute(torch.zeros(v, d, device=dev),
                           rules.spec("p_embed_v", "p_embed_d"), fake_2x2)
        tokens = torch.zeros(b, s, dtype=torch.int32, device=dev)
        with hlo_cost.CostCounter(record=True) as counter:
            y = sharded_embedding(tokens, table)
    assert tuple(y.to_local().shape) == (b // 2, s, d)
    assert str(y.placements) == "(Shard(dim=0), Replicate())"
    emb = [o["out"][0] for o in counter.ops if o["op"] == "aten.embedding"]
    assert emb == ([[b, s, d // 2]] if gathered == "tokens"
                   else [[b // 2, s, d]])
    table_moves = [o for o in counter.ops if o["op"].startswith(
        "collective.all_gather") and v // 2 * d in
        [math.prod(x) for x in o["out"]]]
    assert bool(table_moves) == (gathered == "table"), table_moves


def test_seqcache_decode_traces_on_a_fake_mesh(fake_2x2):
    """stablelm-3b+smoke decode under SERVE_SEQCACHE_RULES on a fake 2 x 2
    mesh (the cache's sequence split over 'model', the query's heads
    too): it traces (it failed in DTensor's strided-shard propagation),
    and the cache stays split along its sequence."""
    cfg = configs.get_config("stablelm-3b+smoke")
    tr = dryrun.lower_cell(cfg, SMOKE_DECODE, fake_2x2, variant="seqcache")
    assert tr.totals.flops > 0
    assert tr.memory["alias_bytes_per_device"] > 0  # written in place


def test_sharded_init_cache_makes_only_local_shards(fake_2x2):
    """`init_cache` inside the rules: each leaf a DTensor laid out by
    `cache_pspecs`, and the storage it makes a device (the counter's
    peak) exactly its local shards' bytes (it made every block's whole
    cache on every rank, the prefill_32k cells' peak)."""
    from repro_torch.launch import hlo_cost
    from repro_torch.models import model as tM
    from repro_torch.sharding import SERVE_RULES, use_rules

    cfg = configs.get_config("stablelm-3b+smoke")
    rules = SERVE_RULES.resolve(fake_2x2)
    with FakeTensorMode(), use_rules(rules, fake_2x2), \
            hlo_cost.CostCounter() as counter:
        cache = tM.init_cache(cfg, 4, 128, specs.fake_device())
    leaves = [t for blk in cache for sub in blk.values() for t in
              sub.values()]
    local = sum(t.to_local().untyped_storage().nbytes() for t in leaves)
    whole = sum(t.numel() * t.element_size() for t in leaves)
    assert counter.peak_bytes == local < whole
    k = cache[0]["sub0"]["k"]
    assert tuple(k.to_local().shape) == (2, 128, 2, 16)  # batch, kv heads
