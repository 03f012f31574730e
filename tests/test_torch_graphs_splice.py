"""The port's compiled splice steps (utils/graphs) on the CPU: the rows
step's compact and static-chrome programs (the serving hot path) and the
dense step.  As in test_torch_graphs.py, each step is checked for capture
hazards, traced once with make_fx(tracing_mode="fake") on one batch of
donors and replayed on fresh donors of the same row class (other
payloads, other frame numbers, another background), where the replay
must equal the eager port and the JAX package's jit(vmap) step exactly:
one compiled program serves every donor of the class, as the JAX
package's serving contract says.  Donor payloads come from seeded numpy
fixtures; the port's host wire goes to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from h264_scroll_encoder_tpu.config import ComposerConfig as JaxConfig
from h264_scroll_encoder_tpu.parallel import batch as jbatch
from h264_scroll_encoder_tpu_torch import cases
from h264_scroll_encoder_tpu_torch.config import ComposerConfig, MAX_WAYPOINTS
from h264_scroll_encoder_tpu_torch.models import mb_transcode as mbt
from h264_scroll_encoder_tpu_torch.models import splice_device as sd
from h264_scroll_encoder_tpu_torch.ops.bitio import BitWriter
from h264_scroll_encoder_tpu_torch.parallel import batch
from h264_scroll_encoder_tpu_torch.syntax.slice_headers import (
    p_slice_header_symbols)
from h264_scroll_encoder_tpu_torch.utils import fixtures

from test_torch_graphs import assert_same, traced

torch.set_num_threads(1)

SMALL = (320, 240)          # 20 x 15 MBs
C0, R0, C, R, B = 8, 5, 5, 4, 3
CLASS = 256                 # pinned row chunk class: every donor fits it


def _payload(rng, ipcm: bool) -> bytes:
    grid = fixtures.representative_donor_grid(rng, C, R)
    if ipcm:
        grid[0][0] = fixtures.random_ipcm_mb(rng, in_p_slice=True)
    bw = BitWriter()
    mbt.emit_p_slice_mbs(bw, grid, 1)
    bw.write_trailing_bits()
    return bw.getvalue()


def _inputs(seed, cfg, *, band: bool):
    """One batch: header symbols at a seeded frame number, a background
    (all skip, or a coded band of vertical motion above the rect) and the
    blob wire of B seeded donors (one of them I_PCM-bearing).  Returns
    (port args, JAX args, donor_bits)."""
    rng = np.random.default_rng(seed)
    frame_num = int(rng.integers(2, 16))
    pays = [_payload(rng, ipcm=b == 1) for b in range(B)]
    host, (bits, _) = sd.prepare_donor_rows_wire(
        pays, [0] * B, R, C, 1, 2, s_row=CLASS, blob_wire=True,
        s_flat=sd.flat_chunk_class(R * CLASS), s_exc=32, engine="python")
    hp, hn = p_slice_header_symbols(
        cfg, torch.full((B,), frame_num, dtype=torch.int32), 2 * frame_num,
        False, -1, 0, torch.zeros((B, MAX_WAYPOINTS), dtype=torch.int32),
        torch.zeros((B, MAX_WAYPOINTS), dtype=torch.bool))
    H, W = cfg.mb_height, cfg.mb_width
    ref = np.zeros((B, H, W), np.int32)
    mvy = np.zeros((B, H, W), np.int32)
    coded = np.zeros((B, H, W), bool)
    if band:
        y0 = int(rng.integers(0, 3))
        ref[:, y0:y0 + 2] = 1
        mvy[:, y0:y0 + 2] = 4 * int(rng.integers(-30, 31))
        coded[:, y0:y0 + 2] = True
    bg = (ref, np.zeros_like(ref), mvy, coded)
    port = (hp, hn, *map(torch.as_tensor, bg),
            sd.donor_arrays_from_numpy(host, "cpu"))
    jax_args = (jnp.asarray(hp.numpy().astype(np.uint32)),
                jnp.asarray(hn.numpy().astype(np.int32)),
                *map(jnp.asarray, bg), {k: jnp.asarray(v)
                                        for k, v in host.items()})
    return port, jax_args, int(np.max(bits))


@pytest.mark.parametrize("program", ["compact", "static"])
def test_rows_step_trace_serves_fresh_donors(program):
    """The rows step's compact and static-chrome programs, traced on one
    batch of donors and replayed on fresh donors of the same class."""
    cfg, jcfg = ComposerConfig(*SMALL), JaxConfig(*SMALL)
    static = program == "static"
    first, jfirst, bits1 = _inputs(20, cfg, band=not static)
    second, jsecond, bits2 = _inputs(21, cfg, band=not static)
    assert [x.shape for x in pytree.tree_leaves(first)] == \
        [x.shape for x in pytree.tree_leaves(second)]
    kw = dict(has_align=True, n_rbsp=sd.splice_rbsp_budget(
        cfg, R * C, max(bits1, bits2)), s_row=CLASS,
        s_flat=sd.flat_chunk_class(R * CLASS), s_exc=32)
    kw.update(bg_static_skip=True) if static else kw.update(compact_x=True)
    step = batch.make_batched_splice_step_rows(cfg, C0, R0, C, R, 2, **kw)
    jstep = jbatch.make_batched_splice_step_rows(jcfg, C0, R0, C, R, 2, **kw)
    gm = traced(step.eager, *first)
    got = gm(*second)
    assert not bool(got[3].any())
    assert_same(got, [np.asarray(x) for x in step.eager(*second)],
                jstep(*jsecond))


def test_dense_step_trace_serves_fresh_donors():
    """The dense step traced on one batch of donors (dense wire) and
    replayed on another of the same chunk class."""
    cfg, jcfg = ComposerConfig(*SMALL), JaxConfig(*SMALL)
    kw = dict(rect_at_left_edge=False, rect_at_top_edge=False,
              rect_at_right_edge=False, engine="python")

    def wire(seed):
        rng = np.random.default_rng(seed)
        dds = [sd.prepare_donor_dense_from_slice(
            _payload(rng, ipcm=b == 1), 0, C, R, 1, 2, **kw) for b in range(B)]
        return cases.stack_dense(dds), max(dd.donor_bits for dd in dds)

    (w1, bits1), (w2, bits2) = wire(30), wire(31)
    assert {k: v.shape for k, v in w1.items()} == \
        {k: v.shape for k, v in w2.items()}
    budget = sd.splice_rbsp_budget(cfg, R * C, max(bits1, bits2))
    step = batch.make_batched_splice_step_dense(cfg, C0, R0, C, R, 2,
                                                has_align=True, n_rbsp=budget)
    jstep = jbatch.make_batched_splice_step_dense(jcfg, C0, R0, C, R, 2,
                                                  has_align=True,
                                                  n_rbsp=budget)
    hdr1, hdr2 = (_inputs(s, cfg, band=True)[:2] for s in (32, 33))
    first = (*hdr1[0][:6], sd.donor_arrays_from_numpy(w1, "cpu"))
    second = (*hdr2[0][:6], sd.donor_arrays_from_numpy(w2, "cpu"))
    gm = traced(step.eager, *first)
    got = gm(*second)
    assert not bool(got[3].any())
    assert_same(got, [np.asarray(x) for x in step.eager(*second)],
                jstep(*hdr2[1][:6], {k: jnp.asarray(v) for k, v in w2.items()}))
