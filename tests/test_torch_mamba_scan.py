"""The port's chunked, rematerialised Mamba scan (`models/ssm.py`,
`_SCAN_CHUNK` = 256, through `models.scan.scan_chunks`) against the
JAX reference on the CPU at sequences longer than one chunk, and the
cost counter's trip rule: on fake tensors one chunk is run and charged
once per trip, which must equal the real run's charge for every chunk.
Inputs come from numpy seeds; float32 `+smoke` configs, held to 1e-4
(the block, its cache and its gradients) and to
tests/test_torch_lm_train.py's loss and gradient tolerances (the
models)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro.models import model as JM
from repro.models import ssm as JS
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import hlo_cost
from repro_torch.models import model as TM
from repro_torch.models import scan
from repro_torch.models import ssm as TS

TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4


def _build(name):
    jcfg, tcfg = jconfigs.get_config(name), tconfigs.get_config(name)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = TM.CausalLM(tcfg, "cpu")
    model.load_state_dict(convert.lm_params_from_jax(jp, tcfg))
    return jcfg, jp, tcfg, model


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol, err_msg=msg)


def test_scan_chunk_is_the_references():
    assert TS._SCAN_CHUNK == JS._SCAN_CHUNK == 256


def test_mamba_block_over_two_chunks_matches_reference():
    """S = 300: two chunks of 256, the second padded with dt = 0.  The
    output, the last state h (exact through the padding) and the conv
    buffer, from a non-zero cache state; and the gradients of
    sum(out * w) wrt x and the parameters against `jax.grad`, all to
    1e-4 (sums over 2 x 300 positions of O(1) values)."""
    jcfg, jp, tcfg, model = _build("falcon-mamba-7b+smoke")
    jm = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["sub0"]["mamba"])
    tm = model.blocks[0].sub0.mamba
    rng = np.random.default_rng(21)
    b, s = 2, 300
    x = rng.standard_normal((b, s, tcfg.d_model)).astype(np.float32)
    h0 = rng.standard_normal((b, tcfg.d_inner, tcfg.ssm_state)).astype(
        np.float32) * 0.1
    w = rng.standard_normal((b, s, tcfg.d_model)).astype(np.float32)
    jc = dict(JS.init_mamba_cache(jcfg, b), h=jnp.asarray(h0))
    want, jnc = JS.mamba_block(jm, jcfg, jnp.asarray(x), cache=jc)
    with torch.no_grad():
        tc = dict(TS.init_mamba_cache(tcfg, b), h=torch.from_numpy(h0))
        got, nc = TS.mamba_block(tm, tcfg, torch.from_numpy(x), cache=tc)
    _close(got, want)
    for k in ("conv", "h"):
        _close(nc[k], jnc[k], msg=k)

    def ref(p, xx):
        return (JS.mamba_block(p, jcfg, xx)[0] * w).sum()

    jg_p, jg_x = jax.grad(ref, argnums=(0, 1))(jm, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    names, leaves = zip(*tm.named_parameters())
    out, _ = TS.mamba_block(tm, tcfg, tx)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                (tx, *leaves))
    _close(grads[0], jg_x, msg="dx")
    for n, g in zip(names, grads[1:]):
        _close(g, jg_p[n], msg=n)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b+smoke",
                                  "jamba-v0.1-52b+smoke"])
def test_loss_and_grads_over_two_chunks_match_reference(arch):
    """The loss and every gradient leaf at S = 300 against
    `jax.value_and_grad(M.loss_fn)` (jamba's attention layers run their
    own key chunks at the same time)."""
    jcfg, jp, tcfg, model = _build(arch)
    rng = np.random.default_rng(22)
    b, s = 1, 300
    batch = {k: rng.integers(0, tcfg.vocab_size, (b, s)).astype(np.int32)
             for k in ("tokens", "labels")}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, bt: JM.loss_fn(p, jcfg, bt), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, _ = TM.loss_fn(model, tcfg, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    want = convert.lm_params_from_jax(jg, tcfg)
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[n].float().numpy(),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=n)


def _block_counts(cfg, s, fake: bool):
    """The counter's totals for one Mamba block's forward and backward at
    [2, s, d_model], on fakes or on real CPU tensors."""
    mode = FakeTensorMode() if fake else None
    with mode if fake else torch.no_grad():
        p = TS.Mamba(cfg, "cpu")
        if not fake:
            p.draw(torch.Generator().manual_seed(0))
        x = torch.randn(2, s, cfg.d_model)
    x.requires_grad_(True)
    with (mode if fake else torch.enable_grad()), \
            hlo_cost.CostCounter() as c:
        out, _ = TS.mamba_block(p, cfg, x)
        out.sum().backward()
    return c.totals, c.peak_bytes


def test_counter_charges_a_scan_chunk_once_per_trip():
    """S = 600: three chunks (the last padded).  On fakes the scan runs
    its first chunk alone, forward and recomputed backward, charged three
    times; on real tensors every chunk runs.  FLOPs, HBM bytes and the
    op count are equal, and the fake run's live-storage peak is within
    one chunk's temporaries of the real one's."""
    cfg = tconfigs.get_config("falcon-mamba-7b+smoke")
    fake, fake_peak = _block_counts(cfg, 600, fake=True)
    real, real_peak = _block_counts(cfg, 600, fake=False)
    for k in ("flops", "hbm_bytes", "n_ops", "binary_ops",
              "collective_count"):
        assert getattr(fake, k) == getattr(real, k), k
    assert real.flops > 0 and real.n_ops > 3 * 256
    assert abs(fake_peak - real_peak) <= 0.1 * real_peak, (fake_peak,
                                                           real_peak)


def test_counter_runs_one_chunk_on_fakes():
    """The trip rule really skips trips: on fakes the scan's step runs
    once (one step of one chunk, charged 3 x 256 times), on real tensors
    once a position of the three chunks."""
    cfg = tconfigs.get_config("falcon-mamba-7b+smoke")
    runs = {}
    for fake in (True, False):
        seen = []

        class Spy(torch.utils._python_dispatch.TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                seen.append(func)
                return func(*args, **(kwargs or {}))

        mode = FakeTensorMode() if fake else torch.no_grad()
        with mode:
            p = TS.Mamba(cfg, "cpu")
            x = torch.zeros(1, 600, cfg.d_model)
            with hlo_cost.CostCounter(), Spy():
                TS.mamba_block(p, cfg, x)
        runs[fake] = seen.count(torch.ops.aten.add.Tensor)
    # one add a step: 3 x 256 - 1 steps fewer on fakes
    assert runs[False] - runs[True] == 3 * 256 - 1, runs


def test_scan_chunks_without_counter_equals_one_loop():
    """On real tensors without a counter: the chunked scan (three chunks,
    the last padded) == one loop over all positions, values and h."""
    cfg = tconfigs.get_config("falcon-mamba-7b+smoke")
    rng = np.random.default_rng(23)
    b, s, din, n = 2, 600, cfg.d_inner, cfg.ssm_state
    dt = torch.from_numpy(rng.uniform(0, 0.1, (b, s, din)).astype(np.float32))
    bm, cm = (torch.from_numpy(rng.standard_normal((b, s, n)).astype(
        np.float32)) for _ in range(2))
    xs = torch.from_numpy(rng.standard_normal((b, s, din)).astype(np.float32))
    a = -torch.rand(din, n)
    h0 = torch.zeros(b, din, n)
    (h1,), y1 = TS._scan_steps((h0,), (dt, bm, cm, xs), (a,))
    pad = 768 - s
    seq = tuple(torch.nn.functional.pad(t, (0, 0, 0, pad))
                for t in (dt, bm, cm, xs))
    (h2,), y2 = scan.scan_chunks(TS._scan_steps, (h0,), seq, (a,), 256)
    assert torch.equal(y2[:, :s], y1) and torch.equal(h2, h1)
