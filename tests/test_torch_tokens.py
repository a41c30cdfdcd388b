"""The port's token streams (`repro_torch.data.tokens`, its own numpy copy)
against the reference's: bit-equal batches for the same `DataConfig`,
restart at step k, disjoint host shards, memmap files written by either
package."""

import numpy as np
import pytest

from repro.data import tokens as J
from repro_torch.data import tokens as T


def _equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _take(it, n):
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("kw", [
    dict(batch=4, seq_len=16, vocab_size=100, seed=5),
    dict(batch=8, seq_len=7, vocab_size=32000, seed=0, host_index=3,
         host_count=4),
])
def test_synthetic_stream_equals_reference(kw):
    got = _take(T.synthetic_stream(T.DataConfig(**kw)), 6)
    want = _take(J.synthetic_stream(J.DataConfig(**kw)), 6)
    for g, w in zip(got, want):
        _equal(g, w)
    np.testing.assert_array_equal(got[0]["tokens"][:, 1:],
                                  got[0]["labels"][:, :-1])
    assert (got[0]["tokens"] > 0).all()
    assert (got[0]["tokens"] < kw["vocab_size"]).all()


def test_synthetic_stream_restarts_at_step_k():
    """The launcher's restart: a fresh stream fast-forwarded k steps
    replays the batches from step k on (per-step seeding)."""
    cfg = T.DataConfig(batch=4, seq_len=16, vocab_size=100, seed=5)
    full = _take(T.synthetic_stream(cfg), 8)
    it = T.synthetic_stream(cfg)
    _take(it, 5)
    for b, w in zip(_take(it, 3), full[5:]):
        _equal(b, w)


def test_host_shards_disjoint_and_equal_reference():
    """Per-host streams: each host's batch of the global one, the same as
    the reference's host, and different hosts draw different sequences."""
    parts = []
    for h in range(4):
        kw = dict(batch=8, seq_len=4, vocab_size=100, seed=1, host_index=h,
                  host_count=4)
        b = next(T.synthetic_stream(T.DataConfig(**kw)))
        _equal(b, next(J.synthetic_stream(J.DataConfig(**kw))))
        assert b["tokens"].shape == (2, 4)
        parts.append(b["tokens"])
    rows = {r.tobytes() for p in parts for r in p}
    assert len(rows) == 8


def test_memmap_stream_equals_reference(tmp_path):
    """A file written by each package; strided host reads; start_step
    matches the continued stream; every batch equal to the reference's."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 1000, 10_000).astype(np.uint32)
    T.write_token_file(tmp_path / "t.bin", toks)
    J.write_token_file(tmp_path / "j.bin", toks)
    assert (tmp_path / "t.bin").read_bytes() == (
        tmp_path / "j.bin").read_bytes()
    for kw in (dict(batch=4, seq_len=16, vocab_size=1000),
               dict(batch=4, seq_len=16, vocab_size=1000, host_index=1,
                    host_count=2)):
        got = _take(T.memmap_stream(tmp_path / "t.bin", T.DataConfig(**kw)),
                    5)
        want = _take(J.memmap_stream(tmp_path / "j.bin", J.DataConfig(**kw)),
                     5)
        for g, w in zip(got, want):
            _equal(g, w)
        jumped = next(T.memmap_stream(tmp_path / "t.bin", T.DataConfig(**kw),
                                      start_step=3))
        _equal(jumped, got[3])
    host = [next(T.memmap_stream(tmp_path / "t.bin", T.DataConfig(
        batch=4, seq_len=16, vocab_size=1000, host_index=h, host_count=2)))
        ["tokens"] for h in range(2)]
    assert not np.array_equal(host[0], host[1])


def test_embeds_stream_equals_reference():
    kw = dict(batch=4, seq_len=6, vocab_size=2048, seed=2)
    got = _take(T.embeds_stream(T.DataConfig(**kw), 32), 3)
    want = _take(J.embeds_stream(J.DataConfig(**kw), 32), 3)
    for g, w in zip(got, want):
        _equal(g, w)
    assert got[0]["embeds"].dtype == np.float32
    assert got[0]["embeds"].shape == (4, 6, 32)
