"""K2's plain version (ops/bitpack_flat) vs the JAX package's batched
Pallas pack (interpret mode here) and the scatter reference.  Tolerance:
exact equality of words and totals."""

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
        torch.as_tensor(pat.astype(np.int64)),
        torch.as_tensor(nb.astype(np.int64)), num_words)
    jw, jt = jflat.pack_words_place_pallas_batch(
        jnp.asarray(pat), jnp.asarray(nb), num_words)
    np.testing.assert_array_equal(words.numpy(), np.asarray(jw).astype(np.int64))
    np.testing.assert_array_equal(total.numpy(), np.asarray(jt))
    for b in range(4):
        sw, st = jbitpack.pack_words(pat[b], nb[b], num_words)
        np.testing.assert_array_equal(words[b].numpy(),
                                      np.asarray(sw).astype(np.int64))
        assert int(total[b]) == int(st)


def test_rejects_mismatched_shapes():
    with pytest.raises(ValueError):
        bitpack_flat.pack_words_place_batch(torch.zeros((2, 5), dtype=torch.int64),
                                            torch.zeros((2, 6), dtype=torch.int64), 4)


@pytest.mark.parametrize("n,num_words", [(100, 10), (257, 30), (64, 3),
                                         (5, 1), (1000, 40), (33, 100)])
def test_pack_words_batch_matches_merge_tree(n, num_words):
    """K4 (`pack_words_batch`) vs the JAX package's merge-tree Pallas pack
    (interpret mode here) and its scatter reference: widths of 0 and 32,
    lane counts that are not powers of two, and streams cut at num_words
    (all but the last case overflow their budget)."""
    pat, nb = cases.pack_edge_case(n, n, num_words)
    words, total = bitpack_flat.pack_words_batch(
        torch.as_tensor(pat.astype(np.int64))[None],
        torch.as_tensor(nb.astype(np.int64))[None], num_words)
    jw, jt = jflat.pack_words_pallas(jnp.asarray(pat), jnp.asarray(nb),
                                     num_words)
    np.testing.assert_array_equal(words[0].numpy(),
                                  np.asarray(jw).astype(np.int64))
    assert int(total[0]) == int(jt) == int(nb.sum())
    sw, st = jbitpack.pack_words(pat, nb, num_words)
    np.testing.assert_array_equal(words[0].numpy(),
                                  np.asarray(sw).astype(np.int64))
    assert int(st) == int(jt)


@pytest.mark.parametrize("n,num_words", [(200, 64), (1024, 300)])
def test_pack_words_batch_matches_merge_tree_in_budget(n, num_words):
    pat, nb = cases.pack_cases(n + 1, 3, n, num_words)
    words, total = bitpack_flat.pack_words_batch(
        torch.as_tensor(pat.astype(np.int64)),
        torch.as_tensor(nb.astype(np.int64)), num_words)
    for b in range(3):
        jw, jt = jflat.pack_words_pallas(jnp.asarray(pat[b]),
                                         jnp.asarray(nb[b]), num_words)
        np.testing.assert_array_equal(words[b].numpy(),
                                      np.asarray(jw).astype(np.int64))
        assert int(total[b]) == int(jt)
