"""K2's plain version (ops/bitpack_flat) vs the JAX package's batched
Pallas pack (interpret mode here) and the scatter reference.  Tolerance:
exact equality of words and totals."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_scroll_encoder_tpu.ops import bitpack as jbitpack
from h264_scroll_encoder_tpu.ops import bitpack_flat as jflat
from h264_scroll_encoder_tpu_torch import cases
from h264_scroll_encoder_tpu_torch.ops import bitpack_flat

torch.set_num_threads(1)


@pytest.mark.parametrize("n,num_words", [(1024, 300), (64, 80), (200, 64),
                                         (4096, 1300), (8483, 1490),
                                         (100, 300)])
def test_place_batch_matches_jax(n, num_words):
    pat, nb = cases.pack_cases(n, 4, n, num_words)
    words, total = bitpack_flat.pack_words_place_batch(
        torch.as_tensor(cases.int32_bits(pat)), torch.as_tensor(nb), num_words)
    jw, jt = jflat.pack_words_place_pallas_batch(
        jnp.asarray(pat), jnp.asarray(nb), num_words)
    np.testing.assert_array_equal(*cases.jax_width(words, jw))
    np.testing.assert_array_equal(*cases.jax_width(total, jt))
    for b in range(4):
        sw, st = jbitpack.pack_words(pat[b], nb[b], num_words)
        np.testing.assert_array_equal(*cases.jax_width(words[b], sw))
        assert int(total[b]) == int(st)


def test_rejects_mismatched_shapes():
    with pytest.raises(ValueError):
        bitpack_flat.pack_words_place_batch(torch.zeros((2, 5), dtype=torch.int32),
                                            torch.zeros((2, 6), dtype=torch.int32), 4)


@pytest.mark.parametrize("n,num_words", [(100, 10), (257, 30), (64, 3),
                                         (5, 1), (1000, 40), (33, 100)])
def test_pack_words_batch_matches_merge_tree(n, num_words):
    """K4 (`pack_words_batch`) vs the JAX package's merge-tree Pallas pack
    (interpret mode here) and its scatter reference: widths of 0 and 32,
    lane counts that are not powers of two, and streams cut at num_words
    (all but the last case overflow their budget)."""
    pat, nb = cases.pack_edge_case(n, n, num_words)
    words, total = bitpack_flat.pack_words_batch(
        torch.as_tensor(cases.int32_bits(pat))[None],
        torch.as_tensor(nb)[None], num_words)
    jw, jt = jflat.pack_words_pallas(jnp.asarray(pat), jnp.asarray(nb),
                                     num_words)
    np.testing.assert_array_equal(*cases.jax_width(words[0], jw))
    assert int(total[0]) == int(jt) == int(nb.sum())
    sw, st = jbitpack.pack_words(pat, nb, num_words)
    np.testing.assert_array_equal(*cases.jax_width(words[0], sw))
    assert int(st) == int(jt)


@pytest.mark.parametrize("n,num_words", [(200, 64), (1024, 300)])
def test_pack_words_batch_matches_merge_tree_in_budget(n, num_words):
    pat, nb = cases.pack_cases(n + 1, 3, n, num_words)
    words, total = bitpack_flat.pack_words_batch(
        torch.as_tensor(cases.int32_bits(pat)), torch.as_tensor(nb), num_words)
    for b in range(3):
        jw, jt = jflat.pack_words_pallas(jnp.asarray(pat[b]),
                                         jnp.asarray(nb[b]), num_words)
        np.testing.assert_array_equal(*cases.jax_width(words[b], jw))
        assert int(total[b]) == int(jt)


@functools.lru_cache(maxsize=None)
def _jax_boundary(n):
    pat, nb, n_rbsp = cases.pack_boundary_cases(n, sentinels=False)
    jw, jt = jflat.pack_words_place_pallas_batch(jnp.asarray(pat),
                                                 jnp.asarray(nb), n_rbsp // 4)
    return np.asarray(jw), np.asarray(jt)


@pytest.mark.parametrize("entry", ["place", "words"])
@pytest.mark.parametrize("int32", [False, True], ids=["int64", "int32"])
@pytest.mark.parametrize("n", cases.PACK_BOUNDARY_LENGTHS)
def test_pack_boundaries_match_jax(n, int32, entry):
    """K2 and K4 through their wrappers with int64 and int32 symbols, on
    the CUDA pack's run and chunk boundaries (cases.pack_boundary_cases,
    width 0 where K1's cases put sentinels), against interpret-mode
    `pack_words_place_pallas`: the JAX package's uint32 words (as int32
    bits) and int32 totals from either."""
    pat, nb, n_rbsp = cases.pack_boundary_cases(n, sentinels=False)
    fn = (bitpack_flat.pack_words_place_batch if entry == "place"
          else bitpack_flat.pack_words_batch)
    to = cases.int32_bits if int32 else (lambda a: a.astype(np.int64))
    words, total = fn(torch.as_tensor(to(pat)), torch.as_tensor(to(nb)),
                      n_rbsp // 4)
    jw, jt = _jax_boundary(n)
    assert words.dtype == total.dtype == torch.int32
    np.testing.assert_array_equal(*cases.jax_width(words, jw))
    np.testing.assert_array_equal(*cases.jax_width(total, jt))


def test_rejects_other_dtypes():
    z = torch.zeros((2, 5), dtype=torch.int32)
    for pat, nb in ((z, z.to(torch.int64)), (z.to(torch.int16),) * 2,
                    (z.to(torch.float64),) * 2):
        with pytest.raises(TypeError):
            bitpack_flat.pack_words_batch(pat, nb, 4)
