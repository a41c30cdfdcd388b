"""The port's per-device cost counter (`repro_torch.launch.hlo_cost`)
against the reference's trip-count-aware HLO walker
(`repro.launch.hlo_cost`): the walker's loop rules (a loop of 9 matrix
products counts 9x, nested loops multiply), per-device counting on a
fake 16 x 16 group (a sharded product counts global/256, the global
FlopCounterMode figure is recorded apart, an all-gather's wire bytes are
(n-1)/n of its result), the HBM rules, the matrix-product FLOPs of the
llama3.2-1b+smoke decode, prefill and train steps against the dot FLOPs
of the reference's compiled HLO (and of +binary-ffn / +cam-head on their
bf16 part, kernels 1 and 2 counted apart), and kernels 1 and 2 tracing
as custom ops on fake and meta tensors."""

import re

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro.configs.base import ShapeConfig
from repro.launch import hlo_cost as jh
from repro.models import model as jM
from repro.serve import steps as jsteps
from repro.train import TrainConfig as JTrainConfig
from repro.train import optimizer as jO
from repro.train.train_step import train_step as j_train_step
from repro_torch import configs
from repro_torch.kernels import binary_gemm, cam_search
from repro_torch.launch import hlo_cost
from repro_torch.models import model as M
from repro_torch.serve import steps
from repro_torch.train import TrainConfig, init_train_state, train_step

# tests/test_dryrun_unit.py's small shapes
SMALL_TRAIN = ShapeConfig("train_4k", "train", 64, 4)
SMALL_PREFILL = ShapeConfig("prefill_32k", "prefill", 64, 2)
SMALL_DECODE = ShapeConfig("decode_32k", "decode", 64, 2)
# the port's matrix-product FLOPs against the reference HLO's dot FLOPs:
# the same products, counted from shapes on both sides, so they agree
# exactly but for products one side fuses or splits differently
MATMUL_RTOL = 1e-6


def _compiled(f, *args):
    return jax.jit(f).lower(*args).compile()


def _ref_dot_flops(text: str) -> float:
    """Dot and convolution FLOPs of compiled HLO text, with the walker's
    parser and trip counts (`jh._walk`'s rules, dots only)."""
    comps = jh.parse_hlo(text)
    entry = next(jh._COMP_HEAD_RE.match(line.strip()).group(1)
                 for line in text.splitlines() if line.startswith("ENTRY"))
    memo = {}

    def walk(comp) -> float:
        if comp.name in memo:
            return memo[comp.name]
        f = 0.0
        for op in comp.ops:
            if op.opcode in ("dot", "convolution"):
                f += jh._dot_flops(op, comp)
            elif op.opcode == "while":
                body = re.search(r"body=%?([\w.\-]+)", op.rest).group(1)
                cond = re.search(r"condition=%?([\w.\-]+)", op.rest).group(1)
                tm = jh._TRIP_RE.search(op.rest)
                trips = (int(tm.group(1)) if tm
                         else jh._trip_count(comps[cond]))
                f += trips * walk(comps[body])
            elif op.opcode in ("fusion", "call", "async-start"):
                m = re.search(r"(?:calls|to_apply)=%?([\w.\-]+)", op.rest)
                if m and m.group(1) in comps:
                    f += walk(comps[m.group(1)])
            elif op.opcode == "conditional":
                f += sum(walk(comps[n]) for n in
                         re.findall(r"%([\w.\-]+)", op.rest) if n in comps)
        memo[comp.name] = f
        return f

    return walk(comps[entry])


def _port_matmul_flops(counter) -> float:
    from torch.utils.flop_counter import flop_registry

    names = {str(k) for k in flop_registry}
    return sum(o["flops"] for o in counter.ops if o["op"] in names)


# ---------------------------------------------------------------------------
# the walker's loop rules
# ---------------------------------------------------------------------------
def test_loop_trips_multiply_as_the_walkers_scan():
    """9 products in a loop count 9x one product, as the walker counts a
    scan of 9 (and within its 20% band)."""
    n = 128

    def nine(x):
        for _ in range(9):
            x = x @ x
        return x

    _, t, _ = hlo_cost.analyze(nine, torch.randn(n, n))
    dot = 2 * n ** 3
    assert t.flops == 9 * dot

    def f(x):
        y, _ = jax.lax.scan(lambda c, _: (c @ c, None), x, None, length=9)
        return y

    ref = jh.analyze_hlo_text(_compiled(
        f, jax.ShapeDtypeStruct((n, n), jnp.float32)).as_text())
    assert 9 * dot <= ref.flops <= 9 * dot * 1.2
    assert abs(t.flops - ref.flops) / ref.flops < 0.2


def test_nested_loops_multiply():
    n = 32
    x = torch.randn(n, n)

    def f():
        y = x
        for _ in range(3):
            for _ in range(4):
                y = y @ y
        return y

    _, t, _ = hlo_cost.analyze(f)
    assert t.flops == 12 * 2 * n ** 3
    assert t.collective_count == 0 and t.collective_wire_bytes == 0.0


def test_hbm_rules_views_resident_and_slice_writes():
    """Views charge nothing; a tensor made in the step at most
    RESIDENT_BYTES stays in the L2; an argument charges on every read; a
    write into a slice charges the slice; an index_put_ twice its
    operands besides the buffer."""
    cache = torch.zeros(64, 1024, 1024)  # 256 MiB: an argument
    new = torch.ones(64, 1024)
    idx = torch.tensor([3])

    def step():
        v = cache[:, 5]  # a view
        cache[:, 7] = new  # copy_ into a slice
        cache.index_put_((idx,), torch.ones(1, 1024, 1024))
        small = new * 2  # made here, 256 KiB: resident
        return (small + 1).sum(), v

    _, t, c = hlo_cost.analyze(step, record=True)
    by_op = {}
    for o in c.ops:
        by_op.setdefault(o["op"], []).append(o["hbm_bytes"])
    slice_bytes = 64 * 1024 * 4
    # copy_: the source (an argument) and the slice written
    assert by_op["aten.copy_"] == [2 * slice_bytes]
    # index_put_: the index (8 bytes) and the values, read and written;
    # the 4 MiB values are made here and resident
    assert by_op["aten.index_put_"] == [2 * 8]
    assert by_op["aten.mul"] == [slice_bytes]  # new read; result resident
    assert "aten.select" not in by_op and "aten.slice" not in by_op
    assert c.peak_bytes >= 1024 * 1024 * 4


# ---------------------------------------------------------------------------
# per-device counts on the fake production mesh
# ---------------------------------------------------------------------------
@pytest.fixture
def fake_pod():
    """A fake 256-rank group and its 16 x 16 mesh, destroyed after."""
    from repro_torch.launch import dryrun

    with dryrun.fake_group(256):
        yield dryrun.production_mesh(False)


def test_sharded_product_counts_per_device(fake_pod):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.specs import fake_device

    mesh, dev = fake_pod, fake_device()
    m, k, n = 4096, 2048, 8192
    with FakeTensorMode():
        a = DTensor.from_local(
            torch.empty(m // 16, k, dtype=torch.bfloat16, device=dev), mesh,
            (Shard(0), Replicate()), run_check=False, shape=(m, k),
            stride=(k, 1))
        b = DTensor.from_local(
            torch.empty(k, n // 16, dtype=torch.bfloat16, device=dev), mesh,
            (Replicate(), Shard(1)), run_check=False, shape=(k, n),
            stride=(n, 1))
        for _ in range(2):  # DTensor's propagation caches cold, then warm
            with hlo_cost.CostCounter(record=True) as c, \
                    FlopCounterMode(display=False) as fc:
                out = a @ b
                full = out.redistribute(mesh, (Shard(0), Replicate()))
            mm = [o for o in c.ops if o["op"] == "aten.mm"]
            assert [o["flops"] for o in mm] == [2 * m * k * n / 256]
            assert hlo_cost.cost_analysis_dict(fc)["flops"] == 2 * m * k * n
            gathers = [o for o in c.ops if o["op"].startswith("collective.")]
            assert len(gathers) == 1 and gathers[0]["group_size"] == 16
            result = (m // 16) * n * 2  # the gathered [M/16, N] bf16
            assert gathers[0]["wire_bytes"] == result * 15 / 16
            assert c.totals.by_collective == {"all-gather": result * 15 / 16}
            # 'model' holds 16 consecutive ranks: two nodes of 8
            assert dict(c.totals.wire_by_link) == {"network": result * 15
                                                   / 16}
            assert tuple(full.to_local().shape) == (m // 16, n)


# ---------------------------------------------------------------------------
# unsharded smoke steps against the reference's compiled HLO
# ---------------------------------------------------------------------------
def _ref_step_dots(jcfg, shape) -> float:
    key = jax.random.PRNGKey(0)
    params = jM.init_params(jcfg, key)
    b, s = shape.global_batch, shape.seq_len
    tok = jnp.zeros((b, s), jnp.int32)
    if shape.kind == "decode":
        cache = jM.init_cache(jcfg, b, s)
        c = jax.jit(lambda p, ca, t, pos: jsteps.decode_step(
            jcfg, p, ca, t, pos)).lower(params, cache, tok[:, :1],
                                        jnp.int32(s - 1)).compile()
    elif shape.kind == "prefill":
        c = jax.jit(lambda p, bt: jsteps.prefill_step(jcfg, p, bt)).lower(
            params, {"tokens": tok}).compile()
    else:
        tcfg = JTrainConfig()
        state = {"params": params, "opt": jO.init_opt_state(tcfg.opt, params)}
        c = jax.jit(lambda st, bt: j_train_step(jcfg, tcfg, st, bt)).lower(
            state, {"tokens": tok, "labels": tok}).compile()
    return _ref_dot_flops(c.as_text())


def _port_step(cfg, shape):
    b, s = shape.global_batch, shape.seq_len
    tok = torch.zeros((b, s), dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    if shape.kind == "train":
        state = init_train_state(cfg, TrainConfig(), gen, "cpu")
        fn = lambda: train_step(cfg, TrainConfig(), state,  # noqa: E731
                                {"tokens": tok, "labels": tok})
    else:
        params = M.init_params(cfg, gen, "cpu")
        if shape.kind == "prefill":
            fn = lambda: steps.prefill_step(cfg, params,  # noqa: E731
                                            {"tokens": tok})
        else:
            cache = M.init_cache(cfg, b, s, "cpu")
            fn = lambda: steps.decode_step(cfg, params, cache,  # noqa: E731
                                           tok[:, :1], s - 1)
    _, totals, counter = hlo_cost.analyze(fn, record=True)
    return _port_matmul_flops(counter), totals


@pytest.mark.parametrize("shape", [SMALL_DECODE, SMALL_PREFILL, SMALL_TRAIN],
                         ids=lambda s: s.kind)
def test_smoke_step_matmul_flops_equal_reference_dots(shape):
    """Equal products; in training both attentions also recompute their
    scores QK^T in the backward pass (each key chunk rematerialised), and
    the port's recomputed chunk also takes its product with V (2 B H S^2
    dh a block), which the reference's compiled backward drops as
    unused."""
    arch = "llama3.2-1b+smoke"
    cfg = configs.get_config(arch)
    want = _ref_step_dots(jconfigs.get_config(arch), shape)
    got, totals = _port_step(cfg, shape)
    if shape.kind == "train":
        want += cfg.blocks * 2 * shape.global_batch * cfg.n_heads \
            * shape.seq_len ** 2 * cfg.head_dim
    assert got == pytest.approx(want, rel=MATMUL_RTOL)
    assert totals.binary_ops == 0 and totals.collective_count == 0


@pytest.mark.parametrize("variant", ["+binary-ffn", "+cam-head"])
@pytest.mark.parametrize("shape", [SMALL_DECODE, SMALL_PREFILL],
                         ids=lambda s: s.kind)
def test_binary_variants_bf16_part_and_binary_ops(variant, shape):
    """The reference computes the BitLinear projections and the CAM head
    as float ±1 dots; the port as kernels 1 and 2.  Its bf16 matrix
    products equal the reference's dots less those, and its binary ops
    are 2 bit-operations per bit pair of the same products (+ the CAM
    head's threshold compares)."""
    arch = "llama3.2-1b+smoke" + variant
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    want = _ref_step_dots(jcfg, shape)
    got, totals = _port_step(cfg, shape)
    b = shape.global_batch
    t = b * (1 if shape.kind == "decode" else shape.seq_len)
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    if variant == "+binary-ffn":  # gate, up, down in every block
        pm1 = cfg.blocks * 3 * 2 * t * d * f
        bits = cfg.blocks * 2 * (2 * t * f * 32 * -(-d // 32)
                                 + t * d * 32 * -(-f // 32))
    elif shape.kind == "decode":  # the CAM head: [B, D] against [V, D]
        pm1 = 2 * b * d * v
        bits = 2 * b * v * 32 * -(-d // 32) + b * v * cfg.cam_head_thresholds
    else:  # prefill's logits are the vocab projection on both sides
        pm1 = bits = 0
    assert got == pytest.approx(want - pm1, rel=MATMUL_RTOL)
    assert totals.binary_ops == bits


def test_kernel_custom_ops_trace_on_fake_and_meta():
    """Kernels 1 and 2 are custom ops with fake forms: they trace under
    FakeTensorMode (on the CUDA device type too) and on the meta device,
    giving the right shapes and dtypes, and the counter sees them."""
    for dev in ("cpu", "cuda"):
        with FakeTensorMode():
            x = torch.empty(5, 3, dtype=torch.int32, device=dev)
            w = torch.empty(7, 3, dtype=torch.int32, device=dev)
            thr = torch.empty(33, dtype=torch.int32, device=dev)
            samples = torch.empty(5, 7, 33, dtype=torch.float32, device=dev)
            with hlo_cost.CostCounter() as c:
                hd = binary_gemm.binary_gemm_hd(x, w)
                votes = cam_search.cam_vote(x, w, thr)
                sampled = cam_search.cam_vote(x, w, thr, thr_samples=samples)
            for r in (hd, votes, sampled):
                assert (tuple(r.shape), r.dtype, r.device.type) == \
                    ((5, 7), torch.int32, dev)
            assert c.totals.binary_ops == 3 * 2 * 5 * 7 * 32 * 3 \
                + 2 * 5 * 7 * 33
    meta = torch.empty(5, 3, dtype=torch.int32, device="meta")
    assert tuple(binary_gemm.binary_gemm_hd(meta, meta[:4]).shape) == (5, 4)
    assert torch.ops.repro_torch.binary_gemm_hd.default is not None
    assert torch.ops.repro_torch.cam_vote.default is not None
