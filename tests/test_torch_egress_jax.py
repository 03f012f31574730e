"""Egress compaction, port vs JAX: the plain version (K8's contract,
parallel/batch.compact_batch_nal_plain) against the JAX package's
`parallel.batch.compact_batch_nal` on every case of cases.COMPACT_CASES at
each of its caps, on the same inputs (the port's as strided tensors where
the case lays them out so, the JAX package's as dense arrays).

The JAX package's word funnel drops a byte where a session's row is
filled to within its phase (offset mod 4) of the row's width rounded up
to 4: the bytes shifted past the last word of the row are lost, and
packed reads 0 there.  `funnel_drops` gives those positions; the JAX
package's output must equal the plain version's with exactly those bytes
zeroed (the numpy concatenation, test_torch_egress.py, holds the plain
version to every byte).  Tolerance: exact equality (bytes and integers)."""

import numpy as np
import pytest
import torch

from h264_scroll_encoder_tpu.parallel import batch as jbatch
from h264_scroll_encoder_tpu_torch import cases
from h264_scroll_encoder_tpu_torch.parallel import batch

torch.set_num_threads(1)


def funnel_drops(width: int, lens, cap: int) -> np.ndarray:
    """Positions below `cap` that the JAX package's compact_batch_nal
    leaves zero: the bytes j of session b with j + (offset_b mod 4) at or
    past `width` rounded up to 4."""
    lens = np.asarray(lens, np.int64)
    start = np.cumsum(lens) - lens
    first = np.maximum(0, width + (-width) % 4 - (start & 3))
    pos = [np.arange(s + f, s + n) for s, f, n in zip(start, first, lens)
           if f < n]
    pos = np.concatenate(pos) if pos else np.zeros(0, np.int64)
    return pos[pos < cap]


@pytest.mark.parametrize("name", list(cases.COMPACT_CASES))
def test_compact_plain_equals_jax(name):
    """packed, total and overflow at every cap of the case: the plain
    version's, with the JAX funnel's dropped bytes zeroed, equal the JAX
    package's byte for byte."""
    import jax.numpy as jnp

    case = cases.compact_case(name)
    nal, lens = cases.compact_tensors(case, "cpu")
    j_nal = jnp.asarray(np.ascontiguousarray(case["nal"]))
    j_lens = jnp.asarray(np.ascontiguousarray(case["nal_len"]))
    for cap in case["caps"]:
        packed, total, ovf = batch.compact_batch_nal_plain(nal, lens, cap)
        j_packed, j_total, j_ovf = jbatch.compact_batch_nal(j_nal, j_lens, cap)
        want = packed.numpy().copy()
        want[funnel_drops(nal.shape[1], case["nal_len"], cap)] = 0
        np.testing.assert_array_equal(np.asarray(j_packed), want,
                                      err_msg=f"{name} cap {cap}")
        assert int(total) == int(j_total) == case["total"]
        assert bool(ovf) == bool(j_ovf) == (case["total"] > cap)

