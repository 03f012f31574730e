"""Port vs JAX: Exp-Golomb symbols, the bit packer and emulation prevention.

Seeded numpy inputs go through the JAX function and its PyTorch
counterpart; the tolerance is exact equality (integer outputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_scroll_encoder_tpu.ops import bitpack as jbitpack
from h264_scroll_encoder_tpu.ops import ebsp as jebsp
from h264_scroll_encoder_tpu.ops import expgolomb as jeg
from h264_scroll_encoder_tpu_torch import cases
from h264_scroll_encoder_tpu_torch.ops import bitpack, ebsp, expgolomb

torch.set_num_threads(1)

U32_EDGES = np.asarray([0, 1, 2, 3, 7, 254, 255, 256, 2 ** 16 - 1, 2 ** 31 - 1,
                        2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1], np.uint64)
I32_EDGES = np.asarray([0, 1, -1, 2, -2, 1000, -1000, 2 ** 30, -2 ** 30,
                        2 ** 31 - 1, -2 ** 31], np.int64)


def _t(a):
    """Inputs in the JAX package's widths: uint32 and int32 values as
    int32 bits."""
    return torch.as_tensor(cases.int32_bits(a))


def _eq(port, want):
    """Equal values in the JAX value's width (cases.jax_width)."""
    np.testing.assert_array_equal(*cases.jax_width(port, want))


def _u32_values(seed):
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 5000, 300).astype(np.uint64)
    big = rng.integers(0, 2 ** 32, 300, dtype=np.uint64)
    return np.concatenate([U32_EDGES, small, big])


def _i32_values(seed):
    rng = np.random.default_rng(seed)
    small = rng.integers(-5000, 5000, 300)
    big = rng.integers(-2 ** 31, 2 ** 31, 300)
    return np.concatenate([I32_EDGES, small, big])


@pytest.mark.parametrize("seed", [0, 1])
def test_ue_and_bit_length(seed):
    v = _u32_values(seed)
    p, n = expgolomb.ue(_t(v))
    jp, jn = jeg.ue(jnp.asarray(v.astype(np.uint32)))
    _eq(p, jp)
    _eq(n, jn)
    _eq(expgolomb.ue_bit_length(_t(v)),
        jeg.ue_bit_length(jnp.asarray(v.astype(np.uint32))))


@pytest.mark.parametrize("seed", [0, 1])
def test_se_and_se_mapped(seed):
    v = _i32_values(seed)
    jv = jnp.asarray(v.astype(np.int32))
    _eq(expgolomb.se_mapped(_t(v)), jeg.se_mapped(jv))
    p, n = expgolomb.se(_t(v))
    jp, jn = jeg.se(jv)
    _eq(p, jp)
    _eq(n, jn)


def test_te_per_session_num_values():
    rng = np.random.default_rng(3)
    v = rng.integers(0, 12, (4, 50))
    num = np.asarray([1, 2, 3, 10])
    p, n = expgolomb.te(_t(v), _t(num)[:, None])
    jp, jn = jax.vmap(jeg.te)(jnp.asarray(v.astype(np.uint32)),
                              jnp.asarray(num.astype(np.int32)))
    _eq(p, jp)
    _eq(n, jn)


def _symbols(seed, B, n, max_bits=33):
    """Random symbols with absent slots and the 0 / 32 width edges."""
    rng = np.random.default_rng(seed)
    nb = rng.integers(0, max_bits, (B, n))
    nb[rng.random((B, n)) < 0.3] = 0
    nb[:, :4] = [0, 32, 1, 32]
    pat = rng.integers(0, 2 ** 32, (B, n), dtype=np.uint64)
    return pat, nb


@pytest.mark.parametrize("num_words,start_bit",
                         [(40, 0), (200, 0), (200, 13), (12, 0)])
def test_pack_words(num_words, start_bit):
    pat, nb = _symbols(num_words, 3, 160)
    words, total = bitpack.pack_words(_t(pat), _t(nb), num_words, start_bit)
    for b in range(3):
        jw, jt = jbitpack.pack_words(jnp.asarray(pat[b].astype(np.uint32)),
                                     jnp.asarray(nb[b].astype(np.int32)),
                                     num_words, start_bit)
        _eq(words[b], jw)
        assert int(total[b]) == int(jt)
    offs, tot = bitpack.bit_offsets(_t(nb))
    jo, jt = jbitpack.bit_offsets(jnp.asarray(nb[1].astype(np.int32)))
    _eq(offs[1], jo)
    assert int(tot[1]) == int(jt)


def test_pack_bytes_and_words_to_bytes():
    pat, nb = _symbols(5, 2, 90)
    got, total = bitpack.pack_bytes(_t(pat), _t(nb), 400)
    for b in range(2):
        want, jt = jbitpack.pack_bytes(jnp.asarray(pat[b].astype(np.uint32)),
                                       jnp.asarray(nb[b].astype(np.int32)),
                                       400)
        _eq(got[b], want)
        assert int(total[b]) == int(jt)
    assert got.dtype == torch.uint8


def test_merge_symbol_pairs_and_trailing_bits():
    rng = np.random.default_rng(7)
    n1 = rng.integers(0, 17, 500)
    n2 = rng.integers(0, 16, 500)
    p1 = rng.integers(0, 2 ** 16, 500) & ((1 << n1) - 1)
    p2 = rng.integers(0, 2 ** 16, 500) & ((1 << n2) - 1)
    p, n = bitpack.merge_symbol_pairs(_t(p1), _t(n1), _t(p2), _t(n2))
    jp, jn = jbitpack.merge_symbol_pairs(
        jnp.asarray(p1.astype(np.uint32)), jnp.asarray(n1.astype(np.int32)),
        jnp.asarray(p2.astype(np.uint32)), jnp.asarray(n2.astype(np.int32)))
    _eq(p, jp)
    _eq(n, jn)
    totals = np.arange(0, 40)
    p, n = bitpack.trailing_bits_symbol(_t(totals))
    jp, jn = jbitpack.trailing_bits_symbol(jnp.asarray(totals.astype(np.int32)))
    _eq(p, jp)
    _eq(n, jn)


def _byte_streams(seed, B, size, zero_frac):
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 256, (B, size))
    b[rng.random((B, size)) < zero_frac] = 0
    low = rng.random((B, size)) < 0.15          # emulation triggers 0..3
    b[low] = rng.integers(0, 4, int(low.sum()))
    n = rng.integers(size // 2, size + 1, B)
    return b.astype(np.uint8), n


@pytest.mark.parametrize("zero_frac", [0.0, 0.5, 0.9])
def test_rbsp_to_ebsp_exact(zero_frac):
    size = 240
    b, n = _byte_streams(int(zero_frac * 10), 4, size, zero_frac)
    max_out = size * 3 // 2 + 8
    out, out_len = ebsp.rbsp_to_ebsp(torch.as_tensor(b), _t(n), max_out)
    for i in range(4):
        jo, jl = jebsp.rbsp_to_ebsp(jnp.asarray(b[i]), int(n[i]), max_out)
        to, tl = jebsp.rbsp_to_ebsp_tree(jnp.asarray(b[i]), int(n[i]),
                                         max_out)
        _eq(out[i], jo)
        _eq(out[i], to)
        assert int(out_len[i]) == int(jl) == int(tl)
        np.testing.assert_array_equal(
            out[i, :int(out_len[i])].numpy(),
            ebsp.rbsp_to_ebsp_np(b[i, :int(n[i])]))


@pytest.mark.parametrize("zero_frac,min_checked", [(0.0, 6), (0.3, 1),
                                                   (0.8, 0)])
def test_rbsp_to_ebsp_bounded(zero_frac, min_checked):
    """Short zero runs: the bounded rule equals the JAX bounded staged
    form (whose 64-byte window differs only near 64-byte runs) wherever
    the insertion count is within the cap, and both flag the rest."""
    size, cap = 240, 16
    b, n = _byte_streams(7 + int(zero_frac * 10), 6, size, zero_frac)
    max_out = size + cap + 8
    out, out_len = ebsp.rbsp_to_ebsp_bounded(torch.as_tensor(b), _t(n),
                                             max_out, cap)
    checked = 0
    for i in range(6):
        jo, jl = jebsp.rbsp_to_ebsp_tree(jnp.asarray(b[i]), int(n[i]),
                                         max_out, max_insertions=cap)
        flagged = int(out_len[i]) - int(n[i]) > cap
        assert flagged == (int(jl) - int(n[i]) > cap)
        if not flagged:
            _eq(out[i], jo)
            assert int(out_len[i]) == int(jl)
            checked += 1
    assert checked >= min_checked


def test_ebsp_np_round_trip():
    b, n = _byte_streams(11, 8, 300, 0.7)
    for i in range(8):
        raw = b[i, :n[i]]
        esc = ebsp.rbsp_to_ebsp_np(raw)
        np.testing.assert_array_equal(esc, jebsp.rbsp_to_ebsp_np(raw))
        np.testing.assert_array_equal(ebsp.ebsp_to_rbsp_np(esc), raw)
        np.testing.assert_array_equal(ebsp.ebsp_to_rbsp_np(esc),
                                      jebsp.ebsp_to_rbsp_np(esc))
