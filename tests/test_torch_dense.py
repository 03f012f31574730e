"""Port vs JAX package: the dense splice path
(models/splice_device.emit_spliced_frame_dense, dense_device_arrays,
parallel/batch.make_batched_splice_step_dense).

The same numpy donors — representative, I_PCM-bearing (so K1's plain
version runs with `align`), with all-skip rows, the rect at the frame's
edges — go through the JAX emitter per session (staged back end on the
CPU) and the port's batched step at B >= 2 on CPU tensors, where K1 and
K2 take their plain versions; with the honest and the default budget, and
the `ebsp_exact` retry.  The port's dense bytes also equal its rows
bytes, and its 720p dense frames equal golden/splice_dense_720p.json (the
JAX package's digests, regenerated by `python tests/test_torch_golden.py`).

Tolerance: exact equality of NAL bytes, nal_len, rbsp_bits and the
overflow flag.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_scroll_encoder_tpu.config import ComposerConfig as JaxConfig
from h264_scroll_encoder_tpu.config import MAX_WAYPOINTS
from h264_scroll_encoder_tpu.models import splice_device as jsd
from h264_scroll_encoder_tpu.parallel import batch as jbatch
from h264_scroll_encoder_tpu.syntax.slice_headers import (
    p_slice_header_symbols as jheader)
from h264_scroll_encoder_tpu_torch import cases
from h264_scroll_encoder_tpu_torch.config import ComposerConfig
from h264_scroll_encoder_tpu_torch.models import mb_transcode as mbt
from h264_scroll_encoder_tpu_torch.models import splice_device as sd
from h264_scroll_encoder_tpu_torch.ops.bitio import BitWriter
from h264_scroll_encoder_tpu_torch.parallel import batch
from h264_scroll_encoder_tpu_torch.utils import fixtures

torch.set_num_threads(1)

SMALL = (320, 240)          # 20 x 15 MBs


def _grid(kind, rng, C, R):
    if kind == "representative":
        return fixtures.representative_donor_grid(rng, C, R)
    g = fixtures.random_p_slice_grid(rng, C, R, 1)
    for row in g:
        for i, mb in enumerate(row):
            if mb is not mbt.SKIP and mb.kind == "ipcm":
                row[i] = fixtures.random_inter_mb(rng, 1)
    if kind == "ipcm":
        g[0][0] = fixtures.random_ipcm_mb(rng, in_p_slice=True)
        g[R - 1][C - 1] = fixtures.random_ipcm_mb(rng, in_p_slice=True)
    elif kind == "skip_rows":
        g[0] = [mbt.SKIP] * C
        g[R - 1] = [mbt.SKIP] * C
    return g


def _payload(grid) -> bytes:
    bw = BitWriter()
    mbt.emit_p_slice_mbs(bw, grid, 1)
    bw.write_trailing_bits()
    return bw.getvalue()


def _donors(kind, seeds, cfg, c0, r0, R, C):
    """Port and JAX DonorDense lists of the seeded donors (Python engines,
    the rect's edges), and the stacked numpy wire."""
    kw = dict(rect_at_left_edge=c0 == 0, rect_at_top_edge=r0 == 0,
              rect_at_right_edge=c0 + C == cfg.mb_width, engine="python")
    pays = [_payload(_grid(kind, np.random.default_rng(s), C, R))
            for s in seeds]
    dds = [sd.prepare_donor_dense_from_slice(p, 0, C, R, 1, 2, **kw)
           for p in pays]
    jdds = [jsd.prepare_donor_dense_from_slice(p, 0, C, R, 1, 2, **kw)
            for p in pays]
    wire = cases.stack_dense(dds)
    jwire = cases.stack_dense(jdds)
    for k in wire:
        np.testing.assert_array_equal(wire[k], jwire[k])
    return dds, wire


def _bg(cfg, kind):
    """Background fields [H, W]: all-skip, or a coded band above the rect
    of vertical motion to a seeded reference."""
    H, W = cfg.mb_height, cfg.mb_width
    ref = np.zeros((H, W), np.int32)
    mvy = np.zeros((H, W), np.int32)
    coded = np.zeros((H, W), bool)
    if kind == "band":
        ref[1:3] = 1
        mvy[1:3] = 24
        coded[1:3] = True
    return ref, np.zeros((H, W), np.int32), mvy, coded


def _jax_headers(jcfg, frame_num=3):
    return jheader(jcfg, jnp.int32(frame_num), jnp.int32(2 * frame_num),
                   is_reference=False, long_term_idx=-1,
                   num_waypoints=jnp.int32(0),
                   wp_long_term_idx=jnp.zeros(MAX_WAYPOINTS, jnp.int32),
                   wp_valid=jnp.zeros(MAX_WAYPOINTS, bool))


def _jax_dense(jcfg, c0, r0, R, C, bg, wire, **kw):
    """The JAX dense emitter per session: (nal, nal_len, bits, ovf) numpy
    arrays with a leading session axis."""
    f = jax.jit(functools.partial(jsd.emit_spliced_frame_dense, jcfg, c0, r0,
                                  R, C, 2, **kw))
    hp, hn = _jax_headers(jcfg)
    jbg = tuple(jnp.asarray(a) for a in bg)
    outs = [f(hp, hn, *jbg, {k: jnp.asarray(v[b]) for k, v in wire.items()})
            for b in range(wire["coded"].shape[0])]
    return tuple(np.stack([np.asarray(o[i]) for o in outs]) for i in range(4))


def _port_dense(cfg, c0, r0, R, C, bg, wire, **kw):
    B = wire["coded"].shape[0]
    hp, hn, *_ = cases.splice_session_inputs(cfg, B, "cpu")
    pbg = tuple(torch.as_tensor(a).expand((B,) + a.shape) for a in bg)
    step = batch.make_batched_splice_step_dense(cfg, c0, r0, C, R, 2, **kw)
    return step(hp, hn, *pbg, sd.donor_arrays_from_numpy(wire, "cpu"))


def _assert_equal(got, want):
    nal, nal_len, bits, ovf = got
    jn, jl, jb, jo = want
    assert nal.dtype == torch.uint8 and nal.shape == jn.shape
    np.testing.assert_array_equal(ovf.numpy(), jo)
    np.testing.assert_array_equal(nal_len.numpy(), jl)
    np.testing.assert_array_equal(bits.numpy(), jb)
    np.testing.assert_array_equal(nal.numpy(), jn)


CASES = {
    # (donor kind, rect c0, r0, C, R, background)
    "representative": ("representative", 6, 4, 5, 4, "skip"),
    "representative_band": ("representative", 6, 4, 5, 4, "band"),
    "ipcm": ("ipcm", 3, 5, 4, 3, "skip"),
    "skip_rows": ("skip_rows", 8, 2, 6, 5, "band"),
    "top_left": ("ipcm", 0, 0, 4, 4, "skip"),
    "bottom_right": ("representative", 14, 10, 6, 5, "band"),
}


@pytest.mark.parametrize("budget", ["honest", "default", "exact"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_step_matches_jax(case, budget):
    """Three donors per case at B = 3; the honest budget (the widest
    donor's exact bits), the chunk class's default, and `ebsp_exact`."""
    kind, c0, r0, C, R, bg_kind = CASES[case]
    cfg, jcfg = ComposerConfig(*SMALL), JaxConfig(*SMALL)
    dds, wire = _donors(kind, (11, 12, 13), cfg, c0, r0, R, C)
    kw = dict(has_align=any(dd.has_align for dd in dds))
    if budget != "default":
        kw["n_rbsp"] = sd.splice_rbsp_budget(cfg, R * C,
                                             max(dd.donor_bits for dd in dds))
    if budget == "exact":
        kw["ebsp_exact"] = True
    bg = _bg(cfg, bg_kind)
    got = _port_dense(cfg, c0, r0, R, C, bg, wire, **kw)
    _assert_equal(got, _jax_dense(jcfg, c0, r0, R, C, bg, wire, **kw))
    assert not bool(got[3].any())
    assert kw["has_align"] == (kind == "ipcm")


def test_jax_batched_dense_step_matches():
    """The JAX package's own batched step (jit of vmap) on the stacked
    wire, against the port's."""
    cfg, jcfg = ComposerConfig(*SMALL), JaxConfig(*SMALL)
    c0, r0, C, R = 4, 6, 5, 3
    dds, wire = _donors("representative", (21, 22), cfg, c0, r0, R, C)
    bg = _bg(cfg, "band")
    jstep = jbatch.make_batched_splice_step_dense(jcfg, c0, r0, C, R, 2)
    hp, hn = _jax_headers(jcfg)
    want = jstep(jnp.broadcast_to(hp, (2,) + hp.shape),
                 jnp.broadcast_to(hn, (2,) + hn.shape),
                 *(jnp.broadcast_to(jnp.asarray(a), (2,) + a.shape)
                   for a in bg),
                 {k: jnp.asarray(v) for k, v in wire.items()})
    _assert_equal(_port_dense(cfg, c0, r0, R, C, bg, wire),
                  tuple(np.asarray(x) for x in want))


@pytest.mark.parametrize("kind", ["representative", "ipcm", "skip_rows"])
def test_dense_equals_rows(kind):
    """The port's dense bytes equal its rows bytes on the same donors
    (the JAX package's own parity, __graft_entry__.dryrun_multichip)."""
    cfg = ComposerConfig(*SMALL)
    c0, r0, C, R = 5, 3, 6, 4
    dds, wire = _donors(kind, (31, 32), cfg, c0, r0, R, C)
    bg = _bg(cfg, "band")
    align = any(dd.has_align for dd in dds)
    dense = _port_dense(cfg, c0, r0, R, C, bg, wire, has_align=align)
    s_row = max(sd.pack_donor_rows(dd, R, C).row_patterns.shape[1]
                for dd in dds)
    rows = [sd.rows_device_arrays(sd.pack_donor_rows(dd, R, C,
                                                     min_class=s_row), "cpu")
            for dd in dds]
    dn = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    hp, hn, *_ = cases.splice_session_inputs(cfg, 2, "cpu")
    pbg = tuple(torch.as_tensor(a).expand((2,) + a.shape) for a in bg)
    got = batch.make_batched_splice_step_rows(cfg, c0, r0, C, R, 2,
                                              has_align=align)(hp, hn, *pbg, dn)
    assert not bool(dense[3].any()) and not bool(got[3].any())
    for b in range(2):
        n = int(dense[1][b])
        assert int(got[1][b]) == n
        assert torch.equal(got[0][b, :n], dense[0][b, :n])


def test_dense_device_arrays_match_jax():
    """dense_device_arrays: the JAX package's keys, values and widths
    (uint32 chunks as int32 bits), carried across by
    donor_arrays_from_numpy."""
    cfg = ComposerConfig(*SMALL)
    dds, _ = _donors("ipcm", (41,), cfg, 2, 2, 3, 3)
    jdd = jsd.prepare_donor_dense_from_slice(
        _payload(_grid("ipcm", np.random.default_rng(41), 3, 3)), 0, 3, 3,
        1, 2, engine="python")
    got = sd.dense_device_arrays(dds[0], "cpu")
    want = jsd.dense_device_arrays(jdd)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(*cases.jax_width(got[k], v))
    assert got["patterns"].dtype == torch.int32
    carried = sd.donor_arrays_from_numpy({k: np.asarray(v)
                                          for k, v in want.items()}, "cpu")
    for k in got:
        assert torch.equal(carried[k], got[k])


def test_dense_rejects_a_rect_outside_the_frame():
    cfg = ComposerConfig(*SMALL)
    dds, wire = _donors("representative", (51,), cfg, 0, 0, 3, 3)
    with pytest.raises(ValueError):
        _port_dense(cfg, 18, 0, 3, 3, _bg(cfg, "skip"), wire)


# ---------------------------------------------------------------------------
# The 720p golden file.
# ---------------------------------------------------------------------------

def test_dense_golden_file():
    """The committed digests: no frame overflows, the representative
    configuration's first donors equal the rows golden file's (the JAX
    package's dense/rows parity), the I_PCM one runs at n_nal 237,600."""
    committed = json.loads(cases.DENSE_GOLDEN_PATH.read_text())
    assert committed["config"] == cases.dense_golden_config()
    for config in cases.DENSE_CONFIGS:
        assert len(committed[config]) == cases.DENSE_DONORS
        assert not any(d["overflow"] for d in committed[config])
    rows = json.loads(cases.SPLICE_GOLDEN_PATH.read_text())["compact"]
    assert committed["representative"][:len(rows)] == rows
    cfg = ComposerConfig(cases.GOLDEN_WIDTH, cases.GOLDEN_HEIGHT)
    dn, bits, align = cases.prepare_dense_donors("ipcm", engine="native",
                                                 device="cpu", n=2)
    assert align and dn["patterns"].shape[-1] == 104
    nal = cases.dense_step(cfg, "ipcm", bits, align)(
        *cases.splice_session_inputs(cfg, 2, "cpu"), dn)[0]
    assert nal.shape[1] == 237_600


def test_port_matches_dense_golden():
    committed = json.loads(cases.DENSE_GOLDEN_PATH.read_text())
    assert cases.port_dense_golden(device="cpu") == committed


def test_port_dense_equals_port_rows_at_720p():
    """All 32 representative donors through the port's rows step (blob
    wire, bench.py's compact program) give the dense golden digests."""
    committed = json.loads(cases.DENSE_GOLDEN_PATH.read_text())
    cfg = ComposerConfig(cases.GOLDEN_WIDTH, cases.GOLDEN_HEIGHT)
    payloads = [cases.dense_donor_payload(k)
                for k in range(cases.DENSE_DONORS)]
    dn, bits, align = cases.prepare_splice_donors(payloads, engine="native",
                                                  device="cpu")
    step = cases.splice_steps(cfg, int(bits.max()), bool(align.any()))["compact"]
    nal, nal_len, _bits, ovf = step(
        *cases.splice_session_inputs(cfg, cases.DENSE_DONORS, "cpu"), dn)
    got = cases.digest_step(nal.numpy(), nal_len.numpy(),
                            np.zeros(cases.DENSE_DONORS, bool), ovf.numpy())
    assert got == committed["representative"]

