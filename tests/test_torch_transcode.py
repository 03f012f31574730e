"""The trans-resizer in the port (models/splice.transcode_pad_stream,
cli.trans_resizer_main, the native_bridge bindings it and its tests use)
against the JAX package's.

Seeded synthetic CAVLC streams (I and P slices, I_PCM macroblocks, one
and two references) are widened from 320x320 to 720x320 by both engines
of the port and by the JAX package, with bug_compat on and off; the
port's CLI writes the bytes the JAX package's CLI writes.  Host code
only: no tensor or kernel is involved.

Tolerance: exact equality of stream bytes.
"""

import numpy as np
import pytest

from h264_scroll_encoder_tpu import cli as jcli
from h264_scroll_encoder_tpu import native_bridge as jnative
from h264_scroll_encoder_tpu.models import splice as jsplice
from h264_scroll_encoder_tpu_torch import cli, native_bridge
from h264_scroll_encoder_tpu_torch.models import mb_transcode as mbt
from h264_scroll_encoder_tpu_torch.models import splice
from h264_scroll_encoder_tpu_torch.ops.bitio import BitReader, BitWriter
from h264_scroll_encoder_tpu_torch.utils import fixtures
from h264_scroll_encoder_tpu_torch.verify import verify_stream


def _stream(seed, nref, bug_compat):
    # The stream's I_PCM nC rule must match the transcode's (bug_compat
    # changes both the parse and the emit side).
    return fixtures.synthetic_cavlc_stream(
        320, 320, n_p_frames=2, seed=seed, num_ref_idx_l0=nref,
        bug_compat=bug_compat)


@pytest.mark.parametrize("engine", ["native", "python"])
@pytest.mark.parametrize("bug_compat", [False, True])
@pytest.mark.parametrize("seed,nref", [(3, 1), (11, 2)])
def test_transcode_matches_jax(seed, nref, bug_compat, engine):
    stream = _stream(seed, nref, bug_compat)
    want = jsplice.transcode_pad_stream(stream, 720, 320,
                                        bug_compat=bug_compat,
                                        engine="python")
    got = splice.transcode_pad_stream(stream, 720, 320, bug_compat=bug_compat,
                                      engine=engine)
    assert got == want
    if not bug_compat:      # the reference's defect is not a valid stream
        assert verify_stream(got).ok


def test_transcode_at_other_widths_matches_jax():
    """Generalized geometry: no padding, and one padding column."""
    stream = _stream(5, 1, False)
    for width in (320, 336):
        want = jsplice.transcode_pad_stream(stream, width, 320,
                                            engine="python")
        for engine in ("native", "python"):
            assert splice.transcode_pad_stream(stream, width, 320,
                                               engine=engine) == want


def test_transcode_rejects_what_it_cannot_do():
    stream = _stream(3, 1, False)
    with pytest.raises(ValueError, match="only widens"):
        splice.transcode_pad_stream(stream, 304, 320)
    with pytest.raises(ValueError, match="only widens"):
        splice.transcode_pad_stream(stream, 720, 336)
    with pytest.raises(ValueError, match="engine"):
        splice.transcode_pad_stream(stream, 720, 320, engine="auto")


def test_native_engine_that_cannot_build_raises(monkeypatch):
    """engine="native" never falls back to the Python engine."""
    def broken():
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(native_bridge, "_lib", None)
    monkeypatch.setattr(native_bridge, "build", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        splice.transcode_pad_stream(_stream(3, 1, False), 720, 320,
                                    engine="native")


@pytest.mark.parametrize("bug_compat", [False, True])
def test_trans_resizer_cli_matches_jax(tmp_path, bug_compat):
    inp = tmp_path / "in.h264"
    inp.write_bytes(_stream(8, 1, bug_compat))
    flags = ["--out-width", "720"] + (["--bug-compat"] if bug_compat else [])
    # Self-verification passes on the corrected stream and fails on the
    # reference's defect, in both packages.
    rc = jcli.trans_resizer_main([str(inp), str(tmp_path / "jax.h264")]
                                 + flags)
    assert rc == int(bug_compat)
    assert cli.trans_resizer_main([str(inp), str(tmp_path / "port.h264")]
                                  + flags) == rc
    assert ((tmp_path / "port.h264").read_bytes()
            == (tmp_path / "jax.h264").read_bytes())
    assert cli.main(["trans-resizer", str(inp), str(tmp_path / "m.h264")]
                    + flags) == rc
    assert ((tmp_path / "m.h264").read_bytes()
            == (tmp_path / "jax.h264").read_bytes())


def test_trans_resizer_cli_reports_a_bad_stream(tmp_path, capsys):
    inp = tmp_path / "in.h264"
    inp.write_bytes(b"\x00\x00\x00\x01\x09\xf0")
    assert cli.trans_resizer_main([str(inp), str(tmp_path / "o.h264")]) == 1
    assert "Error" in capsys.readouterr().err


@pytest.mark.parametrize("seed,is_p,num_ref", [(1, False, 1), (2, True, 1),
                                               (3, True, 2), (4, True, 4)])
def test_parse_slice_native_matches_python(seed, is_p, num_ref):
    """The engine's parse, converted to Macroblocks, re-emits the slice
    byte for byte and ends where the Python parser ends."""
    rng = np.random.default_rng(seed)
    w, h = 8, 6
    grid = (fixtures.random_p_slice_grid(rng, w, h, num_ref) if is_p
            else fixtures.random_i_slice_grid(rng, w, h))
    bw = BitWriter()
    if is_p:
        mbt.emit_p_slice_mbs(bw, grid, num_ref)
    else:
        mbt.emit_i_slice_mbs(bw, grid)
    bw.write_trailing_bits()
    rbsp = bw.getvalue()
    br = BitReader(rbsp)
    (mbt.parse_p_slice_mbs(br, w, h, num_ref) if is_p
     else mbt.parse_i_slice_mbs(br, w, h))
    nat_grid, end = native_bridge.parse_slice_native(rbsp, 0, w, h, is_p,
                                                     num_ref)
    assert end == br.bit_position
    bw2 = BitWriter()
    if is_p:
        mbt.emit_p_slice_mbs(bw2, nat_grid, num_ref)
    else:
        mbt.emit_i_slice_mbs(bw2, nat_grid)
    bw2.write_trailing_bits()
    assert bw2.getvalue() == rbsp


def test_native_bindings_match_jax():
    """emit_slice_raw, pad_grid_raw and pack_rows_native give the JAX
    package's bytes and arrays on the same inputs."""
    from h264_scroll_encoder_tpu_torch.models import splice_device as sd

    rng = np.random.default_rng(21)
    w, h = 6, 4
    grid = fixtures.random_p_slice_grid(rng, w, h, 1)
    bw = BitWriter()
    mbt.emit_p_slice_mbs(bw, grid, 1)
    bw.write_trailing_bits()
    rbsp = bw.getvalue()
    recs, _ = native_bridge.parse_slice_raw(rbsp, 0, w, h, True, 1)
    jrecs, _ = jnative.parse_slice_raw(rbsp, 0, w, h, True, 1)
    out, aux, last = native_bridge.pad_grid_raw(recs, w, h, w + 3, True)
    jout, jaux, jlast = jnative.pad_grid_raw(jrecs, w, h, w + 3, True)
    assert (aux, last) == (jaux, jlast)
    for phase in (0, 3):
        assert (native_bridge.emit_slice_raw(out, w + 3, h, True, 1, rbsp, aux,
                                             start_phase=phase)
                == jnative.emit_slice_raw(jout, w + 3, h, True, 1, rbsp, jaux,
                                          start_phase=phase))
    dd = sd.prepare_donor_dense_from_slice(rbsp, 0, w, h, 1, 2,
                                           engine="python")
    for s_row in (8, 64):
        got = native_bridge.pack_rows_native(dd.patterns, dd.nbits, dd.coded,
                                             h, w, s_row)
        want = jnative.pack_rows_native(dd.patterns, dd.nbits, dd.coded, h,
                                        w, s_row)
        assert (got is None) == (want is None)
        if got is not None:
            for g, wv in zip(got, want):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(wv))
