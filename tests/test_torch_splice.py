"""Port vs JAX package: the device half of the rows splice
(models/splice_device, parallel/batch.make_batched_splice_step_rows).

Cases mirror tests/test_splice_device.py and tests/test_bg_budget.py:
rows layout across donor families (with I_PCM alignment sentinels, so
K1's plain version runs with `align`), the compact background and the
generic one, rect edges and degenerate rects, one step serving many
donors, fresh-donor batches, the wide layout past 4,095 MBs, the flat
and blob wires, the static-chrome program and the bounded background
budget.  The JAX side runs per session (staged back end on the CPU); the
port runs batched on CPU tensors, where K1 and K2 take their plain
versions.  Donor payloads come from seeded numpy fixtures.

Tolerance: exact equality of NAL bytes, nal_len and rbsp_bits on frames
neither side flags, and of the overflow flag itself (the cases stay off
the EBSP window boundary, where K1's 16-word window and the staged
path's 64-byte window can differ).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_scroll_encoder_tpu import native_bridge as jax_native
from h264_scroll_encoder_tpu.config import ComposerConfig as JaxConfig
from h264_scroll_encoder_tpu.config import MAX_WAYPOINTS
from h264_scroll_encoder_tpu.models import splice as jsplice
from h264_scroll_encoder_tpu.models import splice_device as jsd
from h264_scroll_encoder_tpu.parallel import batch as jbatch
from h264_scroll_encoder_tpu.syntax.nal import write_nal_unit
from h264_scroll_encoder_tpu.syntax.slice_headers import (
    p_slice_header_symbols as jheader, write_p_slice_header)
from h264_scroll_encoder_tpu_torch.config import ComposerConfig
from h264_scroll_encoder_tpu_torch.models import mb_transcode as mbt
from h264_scroll_encoder_tpu_torch.models import splice_device as sd
from h264_scroll_encoder_tpu_torch.ops.bitio import BitWriter
from h264_scroll_encoder_tpu_torch.parallel import batch
from h264_scroll_encoder_tpu_torch.syntax.slice_headers import (
    p_slice_header_symbols)
from h264_scroll_encoder_tpu_torch.utils import fixtures

torch.set_num_threads(1)

SMALL = (320, 240)          # 20 x 15 MBs


def _grid(kind, rng, C, R):
    if kind == "representative":
        return fixtures.representative_donor_grid(rng, C, R)
    if kind == "dense":
        return fixtures.dense_donor_grid(rng, C, R)
    if kind == "skip":
        return [[mbt.SKIP] * C for _ in range(R)]
    g = fixtures.random_p_slice_grid(rng, C, R, 1)
    if kind == "ipcm":
        g[0][0] = fixtures.random_ipcm_mb(rng, in_p_slice=True)
        if R > 2:
            g[R - 1][C - 1] = mbt.SKIP
            g[1] = [mbt.SKIP] * C
    elif kind == "no_ipcm":
        for row in g:
            for i, mb in enumerate(row):
                if mb is not mbt.SKIP and mb.kind == "ipcm":
                    row[i] = fixtures.random_inter_mb(rng, 1)
    return g


def _payload(grid) -> bytes:
    bw = BitWriter()
    mbt.emit_p_slice_mbs(bw, grid, 1)
    bw.write_trailing_bits()
    return bw.getvalue()


def _edges(cfg, c0, r0, R, C):
    return dict(rect_at_left_edge=c0 == 0, rect_at_top_edge=r0 == 0,
                rect_at_right_edge=c0 + C == cfg.mb_width)


def _donor(pay, cfg, c0, r0, R, C, *, min_class=0):
    """(port DonorRows, JAX DonorRows) of one payload, Python engines."""
    kw = _edges(cfg, c0, r0, R, C)
    dd = sd.prepare_donor_dense_from_slice(pay, 0, C, R, 1, 2,
                                           engine="python", **kw)
    jdd = jsd.prepare_donor_dense_from_slice(pay, 0, C, R, 1, 2,
                                             engine="python", **kw)
    return (sd.pack_donor_rows(dd, R, C, min_class=min_class),
            jsd.pack_donor_rows(jdd, R, C, min_class=min_class))


def _headers(cfg, jcfg, B, frame_num=3, **kw):
    """Port header tensors [B, nh] and the JAX header arrays [nh]; the
    same symbols."""
    hp, hn = p_slice_header_symbols(
        cfg, torch.full((B,), frame_num, dtype=torch.int64), 2 * frame_num,
        kw.get("is_reference", False), -1, 0,
        torch.zeros((B, MAX_WAYPOINTS), dtype=torch.int64),
        torch.zeros((B, MAX_WAYPOINTS), dtype=torch.bool),
        prev_ref_abs_diff=kw.get("prev_ref_abs_diff", 0))
    jhp, jhn = jheader(
        jcfg, jnp.int32(frame_num), jnp.int32(2 * frame_num),
        is_reference=kw.get("is_reference", False), long_term_idx=-1,
        num_waypoints=jnp.int32(0),
        wp_long_term_idx=jnp.zeros(MAX_WAYPOINTS, jnp.int32),
        wp_valid=jnp.zeros(MAX_WAYPOINTS, bool),
        prev_ref_abs_diff=kw.get("prev_ref_abs_diff", 0))
    np.testing.assert_array_equal(hp[0].numpy(), np.asarray(jhp))
    np.testing.assert_array_equal(hn[0].numpy(), np.asarray(jhn))
    return (hp, hn), (jhp, jhn)


def _bg(cfg, B, bg=None):
    """Background fields: port tensors [B, H, W], JAX arrays [H, W]."""
    H, W = cfg.mb_height, cfg.mb_width
    if bg is None:
        bg = (np.zeros((H, W), np.int32),) * 3 + (np.zeros((H, W), bool),)
    port = tuple(torch.as_tensor(a).expand((B,) + a.shape) for a in bg)
    return port, tuple(jnp.asarray(a) for a in bg)


def _jax_emit(jcfg, c0, r0, R, C, jhdr, jbg, jdn, **kw):
    f = jax.jit(functools.partial(jsd.emit_spliced_frame_rows, jcfg, c0, r0,
                                  R, C, 2, **kw))
    return f(*jhdr, *jbg, jdn)


def _port_step(cfg, c0, r0, R, C, hdr, bg, dn, **kw):
    step = batch.make_batched_splice_step_rows(cfg, c0, r0, C, R, 2, **kw)
    return step(*hdr, *bg, dn)


def _assert_session(port, b, want):
    nal, nal_len, bits, ovf = port
    jn, jl, jb, jo = (np.asarray(x) for x in want)
    assert bool(ovf[b]) == bool(jo)
    assert nal.dtype == torch.uint8 and nal.shape[1:] == jn.shape
    if not bool(jo):
        assert int(nal_len[b]) == int(jl) and int(bits[b]) == int(jb)
        np.testing.assert_array_equal(nal[b].numpy(), jn)


def _run_one(size, c0, r0, R, C, kind, seed, bg=None, **kw):
    """One donor through the port's batched step (B = 1, the port's own
    Python-engine prep) and the JAX emitter; returns the port's outputs."""
    cfg, jcfg = ComposerConfig(*size), JaxConfig(*size)
    pay = _payload(_grid(kind, np.random.default_rng(seed), C, R))
    dr, jdr = _donor(pay, cfg, c0, r0, R, C)
    budget = sd.splice_rbsp_budget(cfg, R * C, dr.donor_bits)
    kw = dict(has_align=dr.has_align, n_rbsp=budget, **kw)
    hdr, jhdr = _headers(cfg, jcfg, 1)
    pbg, jbg = _bg(cfg, 1, bg)
    dn = {k: v[None] for k, v in sd.rows_device_arrays(dr, "cpu").items()}
    got = _port_step(cfg, c0, r0, R, C, hdr, pbg, dn, **kw)
    _assert_session(got, 0, _jax_emit(jcfg, c0, r0, R, C, jhdr, jbg,
                                      jsd.rows_device_arrays(jdr), **kw))
    return got, dr


def _band(cfg, rows=slice(1, 8), mvy=32, ref=0):
    H, W = cfg.mb_height, cfg.mb_width
    bg_ref = np.zeros((H, W), np.int32)
    bg_mvy = np.zeros((H, W), np.int32)
    bg_coded = np.zeros((H, W), bool)
    bg_ref[rows] = ref
    bg_mvy[rows] = mvy
    bg_coded[rows] = True
    return bg_ref, np.zeros((H, W), np.int32), bg_mvy, bg_coded


# ---------------------------------------------------------------------------
# Layouts and donor families.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ebsp_exact", [False, True])
@pytest.mark.parametrize("kind", ["representative", "dense", "ipcm"])
def test_rows_layout_matches_jax(kind, ebsp_exact):
    """Representative, worst-case dense and I_PCM-bearing donors (the
    alignment sentinels fused mid-row resolve in K1's `align` path or,
    for ebsp_exact, in the exact path)."""
    got, dr = _run_one(SMALL, 4, 3, 5, 6, kind, 5, ebsp_exact=ebsp_exact)
    assert dr.has_align == (kind == "ipcm")
    assert not bool(got[3].any())


GEOMS = [(4, 3, 5, 4), (0, 0, 5, 4), (15, 3, 5, 4), (4, 11, 5, 4),
         (0, 5, 20, 3), (6, 6, 4, 1), (16, 13, 4, 2)]


@pytest.mark.parametrize("geom", GEOMS, ids=lambda g: "c%d-r%d-%dx%d" % g)
def test_compact_background_matches_jax_and_generic(geom):
    """compact_x (2 slots per background MB, 3 in the donor-adjacent
    ring) against JAX and against the port's generic layout, with a coded
    hint band overlapping the ring."""
    c0, r0, C, R = geom
    cfg = ComposerConfig(*SMALL)
    band = _band(cfg)
    generic, _ = _run_one(SMALL, c0, r0, R, C, "dense", 6, bg=band)
    compact, _ = _run_one(SMALL, c0, r0, R, C, "dense", 6, bg=band,
                          compact_x=True)
    assert not bool(generic[3].any())
    n = int(generic[1][0])
    assert int(compact[1][0]) == n
    assert torch.equal(compact[0][0, :n], generic[0][0, :n])


@pytest.mark.parametrize("r0,c0,hinted", [(0, 0, False), (2, 4, True)])
def test_ipcm_donor_at_edges_matches_jax(r0, c0, hinted):
    """I_PCM donor MBs (alignment sentinels) at the frame's top-left
    corner (edge availability) and inside, under a hinted band."""
    size = (192, 160)
    cfg = ComposerConfig(*size)
    bg = _band(cfg, slice(1, 2), mvy=64, ref=1) if hinted else None
    got, dr = _run_one(size, c0, r0, 4, 4, "ipcm", 77, bg=bg)
    assert dr.has_align
    assert not bool(got[3].any())


@pytest.mark.parametrize("case", [(1, 6, 4, 5), (1, 6, 0, 0), (5, 1, 7, 3),
                                  (5, 1, 19, 9), (1, 1, 10, 10),
                                  (1, 1, 19, 14), (2, 1, 0, 5)],
                         ids=lambda c: "%dx%d-c%d-r%d" % c)
def test_degenerate_rects_match_jax(case):
    """1-row, 1-column and 1x1 rects (empty right rings, first and last
    row one) at interior and frame-edge placements."""
    R, C, c0, r0 = case
    got, _ = _run_one(SMALL, c0, r0, R, C, "no_ipcm", 7 + R * C)
    assert not bool(got[3].any())


def test_wide_layout_past_4095_mbs_matches_jax():
    """1920x1088 (8,160 MBs): the skip run takes its own slot, under a
    coded band of ten rows."""
    size = (1920, 1088)
    cfg = ComposerConfig(*size)
    assert cfg.mb_height * cfg.mb_width > 4095
    got, _ = _run_one(size, 60, 30, 4, 5, "no_ipcm", 101,
                      bg=_band(cfg, slice(0, 10), mvy=96, ref=1))
    assert not bool(got[3].any())


def test_rows_step_matches_jax_host_path():
    """The rows step's bytes equal the JAX package's host splice path
    (splice_p_frame + finalize_spliced_frame) on a representative donor,
    an independent reference."""
    size, (c0, r0, R, C) = SMALL, (7, 3, 6, 5)
    rng = np.random.default_rng(2024)
    grid = _grid("representative", rng, C, R)
    got, _ = _run_one(SMALL, c0, r0, R, C, "representative", 2024)
    jcfg = JaxConfig(*size)
    hints = jsplice.FrameHints(motion_regions=(), dynamic_mb_x=c0,
                               dynamic_mb_y=r0)
    host = jsplice.finalize_spliced_frame(
        jcfg, jsplice.splice_p_frame(jcfg, hints, grid, 2), 2,
        lambda bw: write_p_slice_header(bw, jcfg, 3))
    want = write_nal_unit(host, 0, 1)
    assert got[0][0, :int(got[1][0])].numpy().tobytes() == want


# ---------------------------------------------------------------------------
# Serving: one step, many donors; wires.
# ---------------------------------------------------------------------------

FAMILIES = ("no_ipcm", "dense", "representative", "ipcm")
CLASS = 256


def _family_payloads(seed, n, C, R):
    rng = np.random.default_rng(seed)
    return [_payload(_grid(FAMILIES[k % 4], rng, C, R)) for k in range(n)]


def _jax_batch(jcfg, c0, r0, R, C, jhdr, B, jdn, **kw):
    step = jbatch.make_batched_splice_step_rows(jcfg, c0, r0, C, R, 2, **kw)
    H, W = jcfg.mb_height, jcfg.mb_width
    zero = jnp.zeros((B, H, W), jnp.int32)
    return step(*(jnp.broadcast_to(h, (B,) + h.shape) for h in jhdr),
                zero, zero, zero, zero.astype(bool), jdn)


def _assert_batch(port, want):
    for b in range(port[0].shape[0]):
        _assert_session(port, b, [x[b] for x in want])


def test_one_step_serves_many_donors():
    """Twelve donors of four families (all-skip rows, trailing skips,
    I_PCM) in one batched call of one step (pinned row class, phase scan
    always on), each session equal to the JAX package's."""
    cfg, jcfg = ComposerConfig(*SMALL), JaxConfig(*SMALL)
    c0, r0, R, C, B = 7, 3, 5, 6, 12
    pays = _family_payloads(2024, B, C, R)
    drs = [_donor(p, cfg, c0, r0, R, C, min_class=CLASS) for p in pays]
    budget = sd.splice_rbsp_budget(cfg, R * C, R * CLASS * 32)
    kw = dict(has_align=True, n_rbsp=budget, compact_x=True)
    wires = [sd.rows_wire(dr) for dr, _ in drs]
    dn = sd.donor_arrays_from_numpy(
        {k: np.stack([w[k] for w in wires]) for k in wires[0]}, "cpu")
    hdr, jhdr = _headers(cfg, jcfg, B)
    got = _port_step(cfg, c0, r0, R, C, hdr, _bg(cfg, B)[0], dn, **kw)
    jw = [jsd.rows_device_arrays(jdr) for _, jdr in drs]
    want = _jax_batch(jcfg, c0, r0, R, C, jhdr, B,
                      {k: jnp.stack([w[k] for w in jw]) for k in jw[0]}, **kw)
    assert not bool(got[3].any())
    _assert_batch(got, want)


@pytest.mark.parametrize("wire", ["padded", "flat", "blob"])
def test_fresh_donor_batches_match_jax(wire, monkeypatch):
    """Fresh donors every step through prepare_donor_rows_serving (Python
    engine) and one step per wire, against the JAX package's serving
    ingest and batched step (its native engine switched off)."""
    monkeypatch.setattr(jax_native, "native_available", lambda: False)
    cfg, jcfg = ComposerConfig(*SMALL), JaxConfig(*SMALL)
    c0, r0, R, C, B = 8, 5, 4, 5, 4
    budget = sd.splice_rbsp_budget(cfg, R * C, R * CLASS * 32)
    kw = dict(has_align=True, n_rbsp=budget, compact_x=True)
    wire_kw = {}
    if wire != "padded":
        kw["s_row"] = CLASS
        wire_kw = {f"{wire}_wire": True}
    if wire == "blob":
        kw.update(s_flat=sd.flat_chunk_class(R * CLASS), s_exc=32)
        wire_kw.update(s_flat=kw["s_flat"], s_exc=kw["s_exc"])
    hdr, jhdr = _headers(cfg, jcfg, B)
    for t in range(2):
        pays = _family_payloads(99 + t, B, C, R)
        dn, (bits, _) = sd.prepare_donor_rows_serving(
            pays, [0] * B, R, C, 1, 2, s_row=CLASS, engine="python",
            device="cpu", **wire_kw)
        jdn, (jbits, _) = jsd.prepare_donor_rows_serving(
            pays, [0] * B, R, C, 1, 2, s_row=CLASS, **wire_kw)
        np.testing.assert_array_equal(bits, jbits)
        if wire == "blob":
            assert set(dn) == {"blob"}
        got = _port_step(cfg, c0, r0, R, C, hdr, _bg(cfg, B)[0], dn, **kw)
        want = _jax_batch(jcfg, c0, r0, R, C, jhdr, B, jdn, **kw)
        assert not bool(got[3].any())
        _assert_batch(got, want)


def test_jax_donor_wire_carried_across():
    """A JAX donor wire (blob) taken to the port's tensors by
    donor_arrays_from_numpy composes the same frames."""
    cfg, jcfg = ComposerConfig(*SMALL), JaxConfig(*SMALL)
    c0, r0, R, C, B = 3, 7, 5, 6, 6
    pays = _family_payloads(505, B, C, R)
    s_flat, s_exc = sd.flat_chunk_class(R * CLASS), 32
    drs = [_donor(p, cfg, c0, r0, R, C, min_class=CLASS)[1] for p in pays]
    wires = [{k: np.asarray(v) for k, v in jsd.rows_device_arrays(d).items()}
             for d in drs]
    host = {k: np.stack([w[k] for w in wires]) for k in wires[0]}
    fw, _, _ = jsd.rows_flat_wire(host.pop("row_patterns"),
                                  host.pop("row_nbits"), s_flat=s_flat,
                                  s_exc=s_exc)
    host.update(fw)
    jdn = {"blob": jnp.asarray(jsd.pack_rows_blob(host, R, C, s_flat, s_exc))}
    kw = dict(has_align=True, compact_x=True, s_row=CLASS, s_flat=s_flat,
              s_exc=s_exc,
              n_rbsp=sd.splice_rbsp_budget(cfg, R * C, R * CLASS * 32))
    hdr, jhdr = _headers(cfg, jcfg, B)
    dn = sd.donor_arrays_from_numpy({k: np.asarray(v) for k, v in jdn.items()},
                                    "cpu")
    assert dn["blob"].dtype == torch.int64
    got = _port_step(cfg, c0, r0, R, C, hdr, _bg(cfg, B)[0], dn, **kw)
    _assert_batch(got, _jax_batch(jcfg, c0, r0, R, C, jhdr, B, jdn, **kw))


def test_flat_wire_roundtrip_matches_jax():
    """rows_flat_wire -> _rows_from_flat rebuilds the padded rows exactly
    (ALIGN sentinels, partial tails, full interior chunks, empty rows),
    as the JAX package's decoder does."""
    rng = np.random.default_rng(31)
    N, R, s_row = 7, 6, 48
    pat = np.zeros((N, R, s_row), np.uint32)
    nb = np.zeros((N, R, s_row), np.int32)
    for i in range(N):
        for r in range(R):
            L = int(rng.integers(0, s_row + 1))
            if L == 0:
                continue
            pat[i, r, :L] = rng.integers(0, 1 << 32, L, dtype=np.uint64)
            nb[i, r, :L] = 32
            nb[i, r, L - 1] = int(rng.integers(1, 33))
            for _ in range(int(rng.integers(0, 3))):
                nb[i, r, int(rng.integers(0, L))] = int(rng.choice([-1, 7, 15]))
    wire, _, _ = sd.rows_flat_wire(pat, nb)
    got_pat, got_nb = sd._rows_from_flat(
        sd.donor_arrays_from_numpy(wire, "cpu"), R, s_row)
    np.testing.assert_array_equal(got_nb.numpy(), nb)
    np.testing.assert_array_equal(got_pat.numpy() * (nb != 0),
                                  pat.astype(np.int64) * (nb != 0))
    jpat, jnb = jax.vmap(lambda d: jsd._rows_from_flat(d, R, s_row))(
        {k: jnp.asarray(v) for k, v in wire.items()})
    np.testing.assert_array_equal(got_nb.numpy(), np.asarray(jnb))


def test_unblob_and_edge_roles_match_jax():
    R, C = 5, 6
    pays = _family_payloads(77, 4, C, R)
    s_flat, s_exc = sd.flat_chunk_class(R * CLASS), 32
    host, _ = sd.prepare_donor_rows_wire(pays, [0] * 4, R, C, 1, 2,
                                         s_row=CLASS, engine="python",
                                         blob_wire=True, s_flat=s_flat,
                                         s_exc=s_exc)
    got = sd._unblob(sd.donor_arrays_from_numpy(host, "cpu")["blob"], R, C,
                     s_flat, s_exc)
    want = jax.vmap(lambda b: jsd._unblob(b, R, C, s_flat, s_exc))(
        jnp.asarray(host["blob"]))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(want[k]).astype(
                                          got[k].numpy().dtype), err_msg=k)
    full = sd.edge_roles_to_full(got, R, C)
    jfull = jax.vmap(lambda d: jsd.edge_roles_to_full(d, R, C))(
        {k: v for k, v in want.items() if k.startswith("edge")})
    for k in full:
        np.testing.assert_array_equal(full[k].numpy(), np.asarray(jfull[k]))


# ---------------------------------------------------------------------------
# Static chrome and the bounded background budget.
# ---------------------------------------------------------------------------

STATIC = [((4, 3, 5, 4), "dense"), ((0, 0, 5, 4), "representative"),
          ((15, 3, 5, 4), "ipcm"), ((4, 11, 5, 4), "skip"),
          ((0, 5, 20, 3), "dense"), ((6, 6, 1, 1), "representative")]


@pytest.mark.parametrize("geom,kind", STATIC,
                         ids=lambda x: x if isinstance(x, str) else "c%d-r%d-%dx%d" % x)
def test_bg_static_skip_matches_jax_and_generic(geom, kind):
    """The static-chrome program on an all-skip background: equal to the
    JAX package's, to the port's generic program, and within the tight
    static budget."""
    c0, r0, C, R = geom
    cfg = ComposerConfig(*SMALL)
    generic, dr = _run_one(SMALL, c0, r0, R, C, kind, 907)
    static, _ = _run_one(SMALL, c0, r0, R, C, kind, 907, bg_static_skip=True)
    n = int(generic[1][0])
    assert not bool(generic[3].any()) and int(static[1][0]) == n
    assert torch.equal(static[0][0, :n], generic[0][0, :n])
    tight = sd.splice_rows_rbsp_budget(cfg, R * C, R, dr.donor_bits,
                                       static_bg=True)
    hdr, _ = _headers(cfg, JaxConfig(*SMALL), 1)
    dn = {k: v[None] for k, v in sd.rows_device_arrays(dr, "cpu").items()}
    out = _port_step(cfg, c0, r0, R, C, hdr, _bg(cfg, 1)[0], dn,
                     has_align=dr.has_align, n_rbsp=tight,
                     bg_static_skip=True)
    assert not bool(out[3].any()) and int(out[1][0]) == n
    assert torch.equal(out[0][0, :n], generic[0][0, :n])


@pytest.mark.parametrize("layout", ["all_skip", "sparse", "over_budget"])
def test_bg_budget_matches_jax(layout):
    """bg_budget = 6 lanes per background row segment: byte-identical on
    all-skip and sparse (two coded MBs a row) backgrounds; a row with five
    coded MBs (10 lanes) flags overflow through the trailing sentinel on
    both sides, where the generic program does not."""
    cfg = ComposerConfig(*SMALL)
    H, W = cfg.mb_height, cfg.mb_width
    c0, r0, R, C = 8, 4, 5, 5
    coded = np.zeros((H, W), bool)
    if layout == "sparse":
        rng = np.random.default_rng(3)
        allowed = [c for c in range(W) if not c0 - 1 <= c <= c0 + C]
        for r in range(H):
            coded[r, rng.choice(allowed, 2, replace=False)] = True
    elif layout == "over_budget":
        coded[1, 0:5] = True
    zero = np.zeros((H, W), np.int32)
    bg = (zero, zero, zero, coded)
    budgeted, _ = _run_one(SMALL, c0, r0, R, C, "representative", 11, bg=bg,
                           compact_x=True, bg_budget=6)
    generic, _ = _run_one(SMALL, c0, r0, R, C, "representative", 11, bg=bg,
                          compact_x=True)
    assert not bool(generic[3][0])
    assert bool(budgeted[3][0]) == (layout == "over_budget")
    if layout != "over_budget":
        n = int(generic[1][0])
        assert int(budgeted[1][0]) == n
        assert torch.equal(budgeted[0][0, :n], generic[0][0, :n])


def test_compact_bg_rows_matches_jax():
    rng = np.random.default_rng(8)
    pat = rng.integers(0, 1 << 20, (3, 5, 24))
    nb = rng.integers(0, 21, (3, 5, 24)) * (rng.random((3, 5, 24)) < 0.3)
    p, n, over = sd._compact_bg_rows(torch.as_tensor(pat), torch.as_tensor(nb),
                                     6)
    for b in range(3):
        jp, jn, jo = jsd._compact_bg_rows(jnp.asarray(pat[b], jnp.uint32),
                                          jnp.asarray(nb[b], jnp.int32), 6)
        np.testing.assert_array_equal(n[b].numpy(), np.asarray(jn))
        np.testing.assert_array_equal(p[b].numpy() * (n[b].numpy() != 0),
                                      np.asarray(jp) * (np.asarray(jn) != 0))
        assert bool(over[b]) == bool(jo)


# ---------------------------------------------------------------------------
# Successive donors (native engine).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [(8, 5, 6, 5, "representative"),
                                  (0, 0, 5, 4, "dense"),
                                  (15, 11, 5, 4, "no_ipcm"),
                                  (4, 9, 7, 3, "representative")],
                         ids=lambda c: "%s-c%d-r%d" % (c[4], c[0], c[1]))
def test_successive_donor_retarget_matches_jax_host_path(case):
    """The native engine's in-place MV retarget plus the rows step
    reproduce the JAX package's host path with donor_mv_targets and a
    short-term-lead header, byte for byte."""
    from h264_scroll_encoder_tpu_torch import native_bridge
    try:
        native_bridge.cxx_path()
    except RuntimeError:
        pytest.skip("no C++ compiler: the native engine cannot be built")
    c0, r0, C, R, kind = case
    size = SMALL
    cfg, jcfg = ComposerConfig(*size), JaxConfig(*size)
    grid = _grid(kind, np.random.default_rng(31 + c0), C, R)
    pay = _payload(grid)
    hints = jsplice.FrameHints(motion_regions=(), dynamic_mb_x=c0,
                               dynamic_mb_y=r0)
    jgrid = jsplice.splice_p_frame(
        jcfg, hints, grid, 3, (0,),
        donor_mv_targets=jsplice.donor_mv_targets_from_grid(grid))
    want = write_nal_unit(jsplice.finalize_spliced_frame(
        jcfg, jgrid, 3, lambda bw: write_p_slice_header(
            bw, jcfg, 4, is_reference=True, prev_ref_abs_diff=1)), 2, 1)
    dd = sd.prepare_donor_dense_from_slice(
        pay, 0, C, R, 1, 3, (0,), engine="native", retarget_mvs=True,
        **_edges(cfg, c0, r0, R, C))
    dr = sd.pack_donor_rows(dd, R, C)
    hdr, _ = _headers(cfg, jcfg, 1, frame_num=4, is_reference=True,
                      prev_ref_abs_diff=1)
    step = batch.make_batched_splice_step_rows(
        cfg, c0, r0, C, R, 3, nal_ref_idc=2, has_align=dr.has_align,
        n_rbsp=sd.splice_rbsp_budget(cfg, R * C, dr.donor_bits))
    dn = {k: v[None] for k, v in sd.rows_device_arrays(dr, "cpu").items()}
    nal, nal_len, _, ovf = step(*hdr, *_bg(cfg, 1)[0], dn)
    assert not bool(ovf[0])
    assert nal[0, :int(nal_len[0])].numpy().tobytes() == want
