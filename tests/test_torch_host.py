"""Port vs JAX package: the host modules of the rows splice slice.

Bit I/O, CAVLC, NAL and parameter sets, macroblock transcoding, the MV
field decoder and the seeded fixtures must give the same bytes and
values as the JAX package's (which are jax-free copies of the same
code); the donor prep of models/splice_device (Python engine), its wires
and budgets must give the JAX package's arrays.  The native C++ engine
is held against the Python one where a C++ compiler exists.  Inputs are
made from seeds with numpy.  Tolerance: exact equality.
"""

import dataclasses
import os
import runpy
import shutil

import numpy as np
import pytest
import torch

from h264_scroll_encoder_tpu import native_bridge as jax_native
from h264_scroll_encoder_tpu.config import ComposerConfig as JaxConfig
from h264_scroll_encoder_tpu.models import mb_transcode as jmbt
from h264_scroll_encoder_tpu.models import mv_field as jmv
from h264_scroll_encoder_tpu.models import splice_device as jsd
from h264_scroll_encoder_tpu.ops import bitio as jbitio
from h264_scroll_encoder_tpu.ops import cavlc as jcavlc
from h264_scroll_encoder_tpu.syntax import nal as jnal
from h264_scroll_encoder_tpu.syntax import params as jparams
from h264_scroll_encoder_tpu.utils import fixtures as jfx
from h264_scroll_encoder_tpu_torch import cases, cli, native_bridge
from h264_scroll_encoder_tpu_torch.config import ComposerConfig
from h264_scroll_encoder_tpu_torch.models import hints, ipcm
from h264_scroll_encoder_tpu_torch.models import mb_transcode as mbt
from h264_scroll_encoder_tpu_torch.models import mv_field
from h264_scroll_encoder_tpu_torch.models import splice_device as sd
from h264_scroll_encoder_tpu_torch.models.splice import FrameHints
from h264_scroll_encoder_tpu_torch.ops import bitio, cavlc
from h264_scroll_encoder_tpu_torch.parallel import batch
from h264_scroll_encoder_tpu_torch.session import (ComposerSession,
                                                   WaypointRegistry)
from h264_scroll_encoder_tpu_torch.syntax import nal, params
from h264_scroll_encoder_tpu_torch.utils import fixtures

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DENSE_FIELDS = ("patterns", "nbits", "coded", *sd.ROLE_FIELDS, "donor_bits",
                "has_align")
ROWS_FIELDS = ("row_patterns", "row_nbits", "first_c", "coded",
               *sd.ROLE_FIELDS, "donor_bits", "has_align")


def _grids(kind, seed, C, R):
    """The same donor grid from both packages' fixtures."""
    def make(fx, mb):
        rng = np.random.default_rng(seed)
        if kind == "representative":
            return fx.representative_donor_grid(rng, C, R)
        if kind == "dense":
            return fx.dense_donor_grid(rng, C, R)
        g = fx.random_p_slice_grid(rng, C, R, 1)
        if kind == "ipcm":
            g[0][min(1, C - 1)] = fx.random_ipcm_mb(rng, in_p_slice=True)
            g[R - 1] = [mb.SKIP] * C
        return g
    return make(fixtures, mbt), make(jfx, jmbt)


def _payload(mod, writer, grid) -> bytes:
    bw = writer()
    mod.emit_p_slice_mbs(bw, grid, 1)
    bw.write_trailing_bits()
    return bw.getvalue()


def _assert_same(port, want, fields):
    for f in fields:
        a, b = getattr(port, f), getattr(want, f)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f)
        assert np.asarray(a).dtype == np.asarray(b).dtype, f


# ---------------------------------------------------------------------------
# Bitstream building blocks.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w,h,refs,seed,bug_compat", [
    (64, 48, 1, 0, False), (96, 64, 2, 3, False), (64, 48, 1, 5, True)])
def test_synthetic_stream_matches_jax(w, h, refs, seed, bug_compat):
    """SPS + PPS + random IDR + random P slices: fixtures, parameter
    sets, NAL framing, bit writer and macroblock emission end to end."""
    got = fixtures.synthetic_cavlc_stream(w, h, 3, seed, refs,
                                          bug_compat=bug_compat)
    assert got == jfx.synthetic_cavlc_stream(w, h, 3, seed, refs,
                                             bug_compat=bug_compat)


@pytest.mark.parametrize("kind", ["representative", "dense", "ipcm"])
def test_donor_grids_emit_and_parse_like_jax(kind):
    grid, jgrid = _grids(kind, 17, 6, 5)
    pay = _payload(mbt, bitio.BitWriter, grid)
    assert pay == _payload(jmbt, jbitio.BitWriter, jgrid)
    parsed = mbt.parse_p_slice_mbs(bitio.BitReader(pay), 6, 5, 1)
    jparsed = jmbt.parse_p_slice_mbs(jbitio.BitReader(pay), 6, 5, 1)
    for row, jrow in zip(parsed, jparsed):
        for mb, jmb in zip(row, jrow):
            assert (mb is mbt.SKIP) == (jmb is jmbt.SKIP)
            if mb is not mbt.SKIP:
                assert dataclasses.asdict(mb) == dataclasses.asdict(jmb)
    assert _payload(mbt, bitio.BitWriter, parsed) == pay     # round trip


def test_bit_io_matches_jax():
    rng = np.random.default_rng(4)
    ops = [(int(rng.integers(0, 4)), int(rng.integers(0, 3000)))
           for _ in range(400)]
    writers = (bitio.BitWriter(), jbitio.BitWriter())
    for w in writers:
        for op, v in ops:
            if op == 0:
                w.write_ue(v)
            elif op == 1:
                w.write_se(v - 1500)
            elif op == 2:
                w.write_te(v % 3, 3)          # three values: ue(v)
            else:
                w.write_bits(v & 0x3FF, 10)
        w.write_trailing_bits()
    data = writers[0].getvalue()
    assert data == writers[1].getvalue()
    br = bitio.BitReader(data)
    for op, v in ops:
        if op == 0:
            assert br.read_ue() == v
        elif op == 1:
            assert br.read_se() == v - 1500
        elif op == 2:
            assert br.read_ue() == v % 3
        else:
            assert br.read_bits(10) == v & 0x3FF


@pytest.mark.parametrize("w,h", [(320, 240), (1280, 720)])
def test_parameter_sets_and_nal_match_jax(w, h):
    sps = params.generate_sps(w, h, max_num_ref_frames=3)
    pps = params.generate_pps(num_ref_idx_l0_default_active_minus1=2)
    assert sps == jparams.generate_sps(w, h, max_num_ref_frames=3)
    assert pps == jparams.generate_pps(num_ref_idx_l0_default_active_minus1=2)
    rbsp = bytes([0, 0, 1, 0, 0, 0, 3, 0, 0, 2]) + sps
    for ref_idc, nal_type in ((3, 7), (0, 1), (2, 5)):
        assert (nal.write_nal_unit(rbsp, ref_idc, nal_type)
                == jnal.write_nal_unit(rbsp, ref_idc, nal_type))


def test_residual_blocks_match_jax():
    rng = np.random.default_rng(9)
    for _ in range(60):
        max_coeff = int(rng.choice([4, 15, 16]))
        blk = fixtures.random_residual_block(rng, max_coeff)
        for nc in (-1, 0, 2, 5, 9):
            if (nc == -1) != (max_coeff == 4):
                continue
            bw, jbw = bitio.BitWriter(), jbitio.BitWriter()
            cavlc.write_residual_block(bw, blk, nc)
            jblk = jcavlc.ResidualBlock(*dataclasses.astuple(blk))
            jcavlc.write_residual_block(jbw, jblk, nc)
            bw.write_trailing_bits()
            jbw.write_trailing_bits()
            assert bw.getvalue() == jbw.getvalue()
            back = cavlc.read_residual_block(bitio.BitReader(bw.getvalue()),
                                             nc, max_coeff)
            assert back.tail == blk.tail and back.total_coeff == blk.total_coeff


@pytest.mark.parametrize("seed", [1, 2])
def test_mv_field_matches_jax(seed):
    grid, jgrid = _grids("dense", seed, 8, 6)
    f = mv_field.decode_p_slice_mv_field(grid, 8, 6)
    jf = jmv.decode_p_slice_mv_field(jgrid, 8, 6)
    for name in ("ref", "mvx", "mvy"):
        np.testing.assert_array_equal(getattr(f, name), getattr(jf, name))
    for y in range(6):
        for x in range(8):
            assert mv_field.mb_level_mv(f, x, y) == jmv.mb_level_mv(jf, x, y)


# ---------------------------------------------------------------------------
# Donor prep (Python engine), wires and budgets.
# ---------------------------------------------------------------------------

# (kind, R, C, at_left, at_top, at_right, rings from a moving background)
PREP_CASES = [("representative", 5, 6, False, False, False, False),
              ("dense", 4, 5, True, True, False, False),
              ("ipcm", 4, 4, False, False, True, False),
              ("dense", 3, 5, False, False, False, True)]


def _prep(case, engine="python"):
    kind, R, C, left, top, right, moving = case
    grid, jgrid = _grids(kind, 23 + R, C, R)
    pay = _payload(mbt, bitio.BitWriter, grid)
    kw = dict(rect_at_left_edge=left, rect_at_top_edge=top,
              rect_at_right_edge=right)
    if moving:
        H, W = 12, 16
        rng = np.random.default_rng(5)
        bg = [rng.integers(-40, 40, (H, W)) for _ in range(3)]
        bg[0] = np.abs(bg[0]) % 2
        rings = sd.rings_from_bg(*bg, 4, 3, R, C)
        assert rings == jsd.rings_from_bg(*bg, 4, 3, R, C)
        kw.update(zip(("left_ring", "top_ring", "right_ring"), rings))
    dd = sd.prepare_donor_dense_from_slice(pay, 0, C, R, 1, 2, engine=engine,
                                           **kw)
    jdd = jsd.prepare_donor_dense_from_slice(pay, 0, C, R, 1, 2,
                                             engine="python", **kw)
    return pay, dd, jdd


@pytest.mark.parametrize("case", PREP_CASES, ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}")
def test_prepare_donor_dense_matches_jax(case):
    _pay, dd, jdd = _prep(case)
    _assert_same(dd, jdd, DENSE_FIELDS)
    assert dd.has_align == (case[0] == "ipcm")


@pytest.mark.parametrize("case", PREP_CASES[:3], ids=lambda c: c[0])
def test_rows_and_wires_match_jax(case):
    _pay, dd, jdd = _prep(case)
    R, C = case[1], case[2]
    for min_class in (0, 64):
        dr = sd.pack_donor_rows(dd, R, C, min_class=min_class)
        jdr = jsd.pack_donor_rows(jdd, R, C, min_class=min_class)
        _assert_same(dr, jdr, ROWS_FIELDS)
    wire = sd.rows_wire(dr)
    jwire = {k: np.asarray(v) for k, v in jsd.rows_device_arrays(jdr).items()}
    assert wire.keys() == jwire.keys()
    for k in wire:
        np.testing.assert_array_equal(wire[k], jwire[k], err_msg=k)
        assert wire[k].dtype == jwire[k].dtype, k
    fw, s_flat, s_exc = sd.rows_flat_wire(dr.row_patterns[None],
                                          dr.row_nbits[None])
    jfw, js_flat, js_exc = jsd.rows_flat_wire(jdr.row_patterns[None],
                                              jdr.row_nbits[None])
    assert (s_flat, s_exc) == (js_flat, js_exc)
    for k in jfw:
        np.testing.assert_array_equal(fw[k], jfw[k], err_msg=k)
        assert fw[k].dtype == jfw[k].dtype, k
    assert sd.flat_wire_layout(R, C, s_flat, s_exc) == jsd.flat_wire_layout(
        R, C, s_flat, s_exc)
    host = dict(fw, first_c=wire["first_c"][None], coded=wire["coded"][None],
                **{k: v[None] for k, v in wire.items() if k.startswith("edge")})
    np.testing.assert_array_equal(
        sd.pack_rows_blob(host, R, C, s_flat, s_exc),
        jsd.pack_rows_blob(host, R, C, s_flat, s_exc))


@pytest.mark.parametrize("wire", ["padded", "flat", "blob"])
def test_prepare_donor_rows_serving_matches_jax(wire, monkeypatch):
    """A batch of fresh donors through the serving ingest, Python engine
    on both sides (the JAX package's native engine switched off)."""
    monkeypatch.setattr(jax_native, "native_available", lambda: False)
    R, C, s_row = 4, 5, 256
    pays = [_payload(mbt, bitio.BitWriter, _grids(kind, 40 + i, C, R)[0])
            for i, kind in enumerate(("representative", "dense", "ipcm"))]
    kw = dict(s_row=s_row, rect_at_top_edge=True)
    if wire != "padded":
        kw.update(s_flat=sd.flat_chunk_class(R * s_row), s_exc=32,
                  **{f"{wire}_wire": True})
    host, (bits, align) = sd.prepare_donor_rows_wire(
        pays, [0] * 3, R, C, 1, 2, engine="python", **kw)
    jdn, (jbits, jalign) = jsd.prepare_donor_rows_serving(
        pays, [0] * 3, R, C, 1, 2, **kw)
    np.testing.assert_array_equal(bits, jbits)
    np.testing.assert_array_equal(align, jalign)
    assert host.keys() == jdn.keys()
    for k, v in jdn.items():
        np.testing.assert_array_equal(host[k], np.asarray(v), err_msg=k)
        assert host[k].dtype == np.asarray(v).dtype, k
    dn, _ = sd.prepare_donor_rows_serving(pays, [0] * 3, R, C, 1, 2,
                                          engine="python", device="cpu", **kw)
    for k, v in dn.items():
        assert v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(jdn[k]).astype(v.numpy().dtype))


def test_budgets_and_classes_match_jax():
    for w, h in ((320, 240), (1280, 720), (1920, 1088)):
        cfg, jcfg = ComposerConfig(w, h), JaxConfig(w, h)
        for m, rows, bits in ((529, 23, 47811), (30, 5, 12416), (1, 1, 0)):
            for bgb in (None, 4, 16):
                assert (sd.splice_rbsp_budget(cfg, m, bits, bg_bits_per_mb=bgb)
                        == jsd.splice_rbsp_budget(jcfg, m, bits,
                                                  bg_bits_per_mb=bgb))
                for static in (False, True):
                    assert (sd.splice_rows_rbsp_budget(
                                cfg, m, rows, bits, bg_bits_per_mb=bgb,
                                static_bg=static)
                            == jsd.splice_rows_rbsp_budget(
                                jcfg, m, rows, bits, bg_bits_per_mb=bgb,
                                static_bg=static))
    for need in (1, 7, 8, 9, 33, 104, 129, 600, 1505, 2048):
        assert sd.row_chunk_class(need) == jsd.row_chunk_class(need)
        assert sd.flat_chunk_class(need) == jsd.flat_chunk_class(need)
        assert sd.exc_class(need) == jsd.exc_class(need)


def test_donor_edge_motion_matches_jax():
    grid, jgrid = _grids("dense", 8, 5, 4)
    left, top, right = sd._default_rings(4, 5, False, True, False)
    left[1] = (1, 12, -8)
    got = sd.donor_edge_motion(grid, left_ring=left, top_ring=top,
                               right_ring=right, rect_at_top_edge=True)
    want = jsd.donor_edge_motion(jgrid, left_ring=left, top_ring=top,
                                 right_ring=right, rect_at_top_edge=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_golden_donor_payloads_match_jax_fixtures():
    for k in (0, 5):
        jgrid = jfx.representative_donor_grid(
            np.random.default_rng(cases.SPLICE_DONOR_SEED + k),
            cases.SPLICE_C, cases.SPLICE_R)
        assert cases.splice_donor_payload(k) == _payload(
            jmbt, jbitio.BitWriter, jgrid)


# ---------------------------------------------------------------------------
# Entry points default to the card.
# ---------------------------------------------------------------------------

def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _small_wire():
    _pay, dd, _ = _prep(PREP_CASES[0])
    return sd.pack_donor_rows(dd, 5, 6)


def _ipcm_donor(tmp) -> str:
    """An I_PCM donor stream (SPS, PPS, IDR) at 64x48."""
    path = tmp / "ipcm_donor.h264"
    path.write_bytes(nal.write_nal_unit(params.generate_sps(64, 48), 3, 7)
                     + nal.write_nal_unit(params.generate_pps(), 3, 8)
                     + ipcm.idr_frame_color(ComposerConfig(64, 48), 81, 90,
                                            240))
    return str(path)


def _cavlc_donor(tmp) -> str:
    path = tmp / "cavlc_donor.h264"
    path.write_bytes(fixtures.synthetic_cavlc_stream(96, 96, n_p_frames=1,
                                                     seed=9))
    return str(path)


@pytest.mark.parametrize("entry", [
    lambda tmp: batch.SessionState.create(2),
    lambda tmp: batch.SessionState.from_numpy(
        batch.SessionState.create(2, device="cpu").to_numpy()),
    lambda tmp: cases.port_golden(),
    lambda tmp: cases.port_splice_golden(engine="python"),
    lambda tmp: sd.rows_device_arrays(_small_wire()),
    lambda tmp: sd.donor_arrays_from_numpy(sd.rows_wire(_small_wire())),
    lambda tmp: sd.prepare_donor_rows_serving(
        [_payload(mbt, bitio.BitWriter, _grids("dense", 3, 5, 4)[0])], [0],
        4, 5, 1, 2, s_row=256, engine="python"),
    lambda tmp: ComposerSession(ComposerConfig(64, 48)),
    lambda tmp: batch.make_batched_hint_step(ComposerConfig(64, 48)),
    lambda tmp: hints.emit_hint_frame(ComposerConfig(64, 48), 2, FrameHints()),
    lambda tmp: hints.hint_fields(ComposerConfig(64, 48), FrameHints()),
    lambda tmp: WaypointRegistry.empty().as_arrays(),
    lambda tmp: cases.port_session_golden(),
    lambda tmp: cli.scroll_encoder_main(["-n", "1", "-w", "64", "-H", "48",
                                         "-o", str(tmp / "e.h264")]),
    lambda tmp: cli.composer_main(["--ref-a", _ipcm_donor(tmp),
                                   "--ref-b", _ipcm_donor(tmp),
                                   "-o", str(tmp / "c.h264")]),
    lambda tmp: cli.splice_demo_main(["--donor", _cavlc_donor(tmp),
                                      "-o", str(tmp / "s.h264")]),
    lambda tmp: sd.dense_device_arrays(_prep(PREP_CASES[0])[1]),
    lambda tmp: cases.port_dense_golden(),
    lambda tmp: cases.large_golden(cases.port_package()),
], ids=["create", "from_numpy", "port_golden", "port_splice_golden",
        "rows_device_arrays", "donor_arrays_from_numpy", "serving",
        "ComposerSession", "make_batched_hint_step", "emit_hint_frame",
        "hint_fields", "registry_as_arrays", "port_session_golden",
        "scroll_encoder_cli", "composer_cli", "splice_demo_cli",
        "dense_device_arrays", "port_dense_golden", "large_golden"])
def test_entry_points_default_to_cuda(entry, monkeypatch, tmp_path):
    """Without CUDA, every entry point's default device raises instead of
    falling back to the CPU (the CLIs through their --device default)."""
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry(tmp_path)


# ---------------------------------------------------------------------------
# The native engine (built with g++ on first use).
# ---------------------------------------------------------------------------

def test_tables_inc_equals_the_jax_generator(tmp_path):
    """The port's cavlc_tables.inc equals native/gen_tables.py's output,
    bar the two comment lines naming the generator."""
    shutil.copy(os.path.join(REPO, "native", "gen_tables.py"), tmp_path)
    runpy.run_path(str(tmp_path / "gen_tables.py"), run_name="__main__")
    want = (tmp_path / "cavlc_tables.inc").read_text().splitlines()
    got = native_bridge.tables_inc().splitlines()
    assert got[2:] == want[2:]
    assert len(got) > 100


@pytest.fixture
def native():
    try:
        native_bridge.cxx_path()
    except RuntimeError:
        pytest.skip("no C++ compiler: the native engine cannot be built")
    native_bridge.load_library()     # a build or load failure fails here


@pytest.mark.parametrize("case", PREP_CASES, ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}")
def test_native_engine_matches_python(native, case):
    pay, dd, _ = _prep(case)
    ndd = _prep(case, engine="native")[1]
    _assert_same(ndd, dd, DENSE_FIELDS)


@pytest.mark.parametrize("wire", ["padded", "blob"])
def test_native_serving_wire_matches_python(native, wire):
    R, C, s_row = 5, 6, 256
    pays = [_payload(mbt, bitio.BitWriter, _grids(kind, 60 + i, C, R)[0])
            for i, kind in enumerate(("representative", "dense", "ipcm") * 2)]
    kw = dict(s_row=s_row, rect_at_left_edge=True)
    if wire == "blob":
        kw.update(blob_wire=True, s_flat=sd.flat_chunk_class(R * s_row),
                  s_exc=32)
    got, (bits, align) = sd.prepare_donor_rows_wire(
        pays, [0] * len(pays), R, C, 1, 2, engine="native", n_threads=3, **kw)
    want, (pbits, palign) = sd.prepare_donor_rows_wire(
        pays, [0] * len(pays), R, C, 1, 2, engine="python", **kw)
    np.testing.assert_array_equal(bits, pbits)
    np.testing.assert_array_equal(align, palign)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_native_engine_raises_on_a_bad_payload(native):
    with pytest.raises(cavlc.CAVLCError):
        sd.prepare_donor_dense_from_slice(b"\xff" * 4, 0, 5, 4, 1, 2,
                                          engine="native")
