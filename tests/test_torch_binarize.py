"""The port's bit layout (`repro_torch.core.binarize`) against the JAX
reference: packed words, popcount and distances must be bit-identical,
including bit 31 and widths with n_bits % 32 != 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import i32, packed
from repro.core import binarize as jbin
from repro_torch.core import binarize as tbin

WIDTHS = [1, 31, 32, 33, 64, 100, 784]


@pytest.mark.parametrize("k", WIDTHS)
def test_pack_bits_matches_reference(k):
    rng = np.random.default_rng(k)
    bits = rng.integers(0, 2, (5, 3, k)).astype(np.uint8)
    want = np.asarray(jbin.pack_bits(jnp.asarray(bits)))
    got = tbin.pack_bits(torch.from_numpy(bits))
    assert got.dtype == torch.int32
    assert got.shape == want.shape == (5, 3, tbin.packed_width(k))
    np.testing.assert_array_equal(i32(got), i32(want))
    np.testing.assert_array_equal(i32(tbin.np_pack_bits(bits)), i32(want))
    back = tbin.unpack_bits(got, k)
    np.testing.assert_array_equal(back.numpy(), bits)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jbin.unpack_bits(jnp.asarray(want), k)))


def test_bit31_round_trips_and_counts():
    bits = np.zeros((2, 32), np.uint8)
    bits[0, 31] = 1
    bits[1, :] = 1
    words = tbin.pack_bits(torch.from_numpy(bits))
    np.testing.assert_array_equal(
        i32(words), i32(np.asarray(jbin.pack_bits(jnp.asarray(bits)))))
    assert words[0, 0] == -(2 ** 31) and words[1, 0] == -1
    np.testing.assert_array_equal(tbin.popcount32(words).numpy(), [[1], [32]])
    np.testing.assert_array_equal(tbin.unpack_bits(words, 32).numpy(), bits)


@pytest.mark.parametrize("shape", [(7, 33), (4, 3, 300), (1, 1024)])
def test_hamming_and_pm1_pack(shape):
    rng = np.random.default_rng(sum(shape))
    a = rng.choice([-1.0, 1.0], shape).astype(np.float32)
    b = rng.choice([-1.0, 1.0], shape).astype(np.float32)
    ja, jb = jbin.pack_pm1(jnp.asarray(a)), jbin.pack_pm1(jnp.asarray(b))
    ta, tb = tbin.pack_pm1(torch.from_numpy(a)), tbin.pack_pm1(
        torch.from_numpy(b))
    np.testing.assert_array_equal(i32(ta), i32(ja))
    np.testing.assert_array_equal(
        tbin.hamming_packed(ta, tb).numpy(),
        np.asarray(jbin.hamming_packed(ja, jb)))
    np.testing.assert_array_equal(
        tbin.from_bits(tbin.to_bits(torch.from_numpy(a))).numpy(), a)
    hd = tbin.hamming_packed(ta, tb)
    dot = tbin.dot_from_hd(hd, shape[-1])
    np.testing.assert_array_equal(dot.numpy(), (a * b).sum(-1).astype(int))
    np.testing.assert_array_equal(tbin.hd_from_dot(dot, shape[-1]).numpy(),
                                  hd.numpy())


@pytest.mark.parametrize("k", [31, 300])
def test_binary_matvec_packed_matches_reference(k):
    rng = np.random.default_rng(k)
    w_np, w = packed(rng, 9, k)
    x_np, x = packed(rng, 6, k)
    want = np.asarray(jbin.binary_matvec_packed(
        jnp.asarray(w_np), jnp.asarray(x_np.reshape(2, 3, -1)), k))
    got = tbin.binary_matvec_packed(w, x.reshape(2, 3, -1), k)
    np.testing.assert_array_equal(got.numpy(), want)


def test_packed_width_and_word_views():
    for k in WIDTHS:
        assert tbin.packed_width(k) == jbin.packed_width(k)
    words = np.array([[0, 1, 2 ** 31, 2 ** 32 - 1]], np.uint32)
    t = tbin.words_to_torch(words)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy().view(np.uint32), words)
    with pytest.raises(TypeError):
        tbin.words_to_torch(words.astype(np.int64))
