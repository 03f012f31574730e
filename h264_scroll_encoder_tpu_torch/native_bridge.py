"""ctypes bridge to the native CAVLC engine (csrc/cavlc_decode.cpp).

Port of h264_scroll_encoder_tpu/native_bridge.py: the loader and
`parse_slice_raw`, `prepare_dense_raw`, `mv_edge_roles_raw`,
`prepare_rows_batch` and `prepare_rows_blob_batch` (the splice slices),
`retarget_recs_raw` (the successive-donor mode of
`prepare_donor_dense_from_slice`), and `emit_slice_raw`, `pad_grid_raw`,
`parse_slice_native` and `pack_rows_native` (the trans-resizer,
models/splice.transcode_pad_stream, and its tests).

The port builds the engine itself, on first use and never at import:
`cavlc_tables.inc` is generated from the port's own ops/cavlc_tables.py
(the logic of native/gen_tables.py, which imports the JAX package), and
csrc/cavlc_decode.cpp is compiled with g++ into `_build/` (gitignored),
under a file lock into a temporary name that is then renamed, so
concurrent processes neither race nor load a half-written library.

There is no silent fallback: `load_library()` raises when the engine
cannot be built or its interface does not match.  Callers choose between
this engine and the Python one explicitly (`engine="native"` /
`"python"` in models/splice_device).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from .ops import cavlc
from .ops import cavlc_tables as T

_SOURCE = Path(__file__).resolve().parent / "csrc" / "cavlc_decode.cpp"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
_ABI_VERSION = 7

_lock = threading.Lock()
_lib = None


class _BlockRec(ctypes.Structure):
    _fields_ = [
        ("tc", ctypes.c_int16),
        ("t1", ctypes.c_int16),
        ("total_zeros", ctypes.c_int16),
        ("tail_start", ctypes.c_int32),
        ("tail_len", ctypes.c_int32),
    ]


class _MBRec(ctypes.Structure):
    _fields_ = [
        ("kind", ctypes.c_int32),
        ("mb_type", ctypes.c_int32),
        ("cbp", ctypes.c_int32),
        ("qp_delta", ctypes.c_int32),
        ("chroma_pred", ctypes.c_int32),
        ("i16_idx", ctypes.c_int32),
        ("pred_bits_start", ctypes.c_int32),
        ("pred_bits_len", ctypes.c_int32),
        ("ipcm_byte_start", ctypes.c_int64),
        ("sub_mb_types", ctypes.c_int32 * 4),
        ("ref_idx", ctypes.c_int32 * 4),
        ("n_ref", ctypes.c_int32),
        ("mvds", (ctypes.c_int32 * 2) * 16),
        ("n_mvds", ctypes.c_int32),
        ("blocks", _BlockRec * 27),
    ]


# ---------------------------------------------------------------------------
# cavlc_tables.inc, generated from ops/cavlc_tables.py.
# ---------------------------------------------------------------------------

def _token_table(name: str, cls: str) -> list:
    rows = sorted((len(code), int(code, 2), tc, t1) for code, (tc, t1)
                  in T.coeff_token_decode_table(cls).items())
    out = [f"static const CoeffTokenRow {name}[] = {{"]
    out += [f"  {{{ln}, 0x{code:x}u, {tc}, {t1}}}," for ln, code, tc, t1
            in rows]
    return out + ["};", f"static const int {name}_len = {len(rows)};"]


def _vlc_list(name: str, codes_by_row: dict) -> list:
    """Rows indexed by key; each row maps value -> code string."""
    out = [f"static const VlcRow {name}[][18] = {{"]
    for key in range(1, max(codes_by_row) + 1):
        cells = [f"{{{len(c)}, 0x{int(c, 2):x}u}}"
                 for c in codes_by_row.get(key, [])]
        cells += ["{0, 0u}"] * (18 - len(cells))
        out.append("  {" + ", ".join(cells) + "},")
    return out + ["};"]


def _u8_array(name: str, values) -> str:
    values = list(values)
    return (f"static const uint8_t {name}[{len(values)}] = {{"
            + ", ".join(map(str, values)) + "};")


def tables_inc() -> str:
    """The engine's table header, from ops/cavlc_tables.py: decode tables
    as (length, code) -> value rows sorted by length, and the encode
    tables (CBP inverses, coeff_token by class nc0/nc2/nc4/flc/chroma)."""
    out = [
        "// Generated by h264_scroll_encoder_tpu_torch/native_bridge.py from",
        "// h264_scroll_encoder_tpu_torch/ops/cavlc_tables.py.",
        "#pragma once",
        "#include <cstdint>",
        "struct CoeffTokenRow { uint8_t len; uint32_t code; "
        "int8_t tc; int8_t t1; };",
        "struct VlcRow { uint8_t len; uint32_t code; };",
    ]
    out += _token_table("kCoeffTokenNc0", "nc0")
    out += _token_table("kCoeffTokenNc2", "nc2")
    out += _token_table("kCoeffTokenNc4", "nc4")
    out += _token_table("kCoeffTokenChromaDc", "chroma_dc")
    out += _vlc_list("kTotalZeros4x4", T.TOTAL_ZEROS_4x4)
    out += _vlc_list("kTotalZerosChromaDc", T.TOTAL_ZEROS_CHROMA_DC)
    out += _vlc_list("kRunBefore", T._RUN_BEFORE)
    out.append(_u8_array("kCbpIntra", T.CBP_INTRA))
    out.append(_u8_array("kCbpInter", T.CBP_INTER))
    out.append(_u8_array("kScanToRaster", T.SCAN_TO_RASTER))
    inv_intra, inv_inter = [0] * 48, [0] * 48
    for code, cbp in enumerate(T.CBP_INTRA):
        inv_intra[cbp] = code
    for code, cbp in enumerate(T.CBP_INTER):
        inv_inter[cbp] = code
    out.append(_u8_array("kCbpIntraInv", inv_intra))
    out.append(_u8_array("kCbpInterInv", inv_inter))
    cls_blocks = []
    for cls_nc in (0, 2, 4, 8, -1):
        tc_blocks = []
        for tc in range(17):
            cells = []
            for t1 in range(4):
                if t1 > min(3, tc) or (cls_nc == -1 and tc > 4):
                    cells.append("{0, 0u}")
                    continue
                code = T.coeff_token_code(cls_nc, tc, t1)
                cells.append(f"{{{len(code)}, 0x{int(code, 2):x}u}}")
            tc_blocks.append("{" + ", ".join(cells) + "}")
        cls_blocks.append("{" + ",\n  ".join(tc_blocks) + "}")
    out.append("static const VlcRow kCoeffTokenEnc[5][17][4] = {\n "
               + ",\n ".join(cls_blocks) + "};")
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# Build and load.
# ---------------------------------------------------------------------------

def cxx_path() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler (g++) found: the native CAVLC "
                       "engine cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SOURCE.read_bytes())
    h.update(tables_inc().encode())
    return _BUILD_DIR / f"libh264t_cavlc_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the engine (if the cached library is missing) and return
    its path.  Raises with the compiler's output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / ".cavlc.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():               # another process built it meanwhile
            return out
        with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
            (Path(tmp) / "cavlc_tables.inc").write_text(tables_inc())
            so = Path(tmp) / out.name
            cmd = [cxx_path(), *CXX_FLAGS, "-I", tmp, str(_SOURCE),
                   "-o", str(so), "-lpthread"]
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"g++ failed ({r.returncode}):\n"
                                   f"{r.stdout}\n{r.stderr}")
            os.replace(so, out)
    return out


def _bind(lib) -> None:
    P, I, L = ctypes.POINTER, ctypes.c_int, ctypes.c_long
    u8, i32, u32 = P(ctypes.c_uint8), P(ctypes.c_int32), P(ctypes.c_uint32)
    rec = P(_MBRec)
    sigs = {
        "cavlc_parse_slice": [u8, L, L, I, I, I, I, rec, P(L), I],
        "cavlc_emit_slice": [rec, I, I, I, I, u8, u8, I, L, u8, L, P(L), I],
        "cavlc_pack_rows": [u32, i32, u8, I, I, I, I, u32, i32, i32, P(L),
                            P(I)],
        "cavlc_prepare_dense": [rec, I, I, I, i32, I, I, I, u8, L, u32, i32,
                                I, u8, P(L), P(I), P(I), I],
        "cavlc_mv_edge_roles": [rec, I, I, I, i32, I, i32, u8, i32, u8, i32,
                                u8, i32, i32, i32],
        "cavlc_retarget_recs": [rec, I, I, I, i32, I, i32, u8, i32, u8, i32,
                                u8],
        "cavlc_prepare_rows_batch": [u8, P(L), P(L), I, I, I, I, I, i32, I,
                                     I, I, i32, u8, i32, u8, i32, u8, I, u32,
                                     i32, i32, u8, i32, i32, i32, P(L), i32,
                                     i32, I, I, I, I],
        "cavlc_prepare_rows_blob_batch": [u8, P(L), P(L), I, I, I, I, I, i32,
                                          I, I, I, i32, u8, i32, u8, i32, u8,
                                          I, I, I, u32, P(L), i32, i32, i32,
                                          I, I, I, I],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    lib.cavlc_blob_stride.restype = ctypes.c_long
    lib.cavlc_blob_stride.argtypes = [ctypes.c_int] * 4


def load_library():
    """Build (on first use) and load the engine; raises on any failure,
    including an interface that does not match this bridge."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.cavlc_abi_version.restype = ctypes.c_long
            lib.cavlc_mbrec_size.restype = ctypes.c_long
            if lib.cavlc_abi_version() != _ABI_VERSION:
                raise RuntimeError(
                    f"native CAVLC engine ABI {lib.cavlc_abi_version()} != "
                    f"{_ABI_VERSION}")
            if lib.cavlc_mbrec_size() != ctypes.sizeof(_MBRec):
                raise RuntimeError("native MBRec layout mismatch")
            _bind(lib)
            _lib = lib
        return _lib


# ---------------------------------------------------------------------------
# Calls.
# ---------------------------------------------------------------------------

def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _i32p(a):
    return _ptr(a, ctypes.c_int32)


def _u8p(a):
    return _ptr(a, ctypes.c_uint8)


def _i64p(a):
    return _ptr(a, ctypes.c_long)


def parse_slice_raw(rbsp: bytes, start_bit: int, mb_width: int,
                    mb_height: int, is_p: bool, num_ref_idx_l0: int, *,
                    bug_compat: bool = False):
    """Raw-record parse -> (ctypes MBRec array, end_bit).

    bug_compat selects the reference's zeroed I_PCM nC rule (see
    mb_transcode.ipcm_context); the default is the spec rule nN = 16."""
    lib = load_library()
    data = np.frombuffer(rbsp, np.uint8)
    recs = (_MBRec * (mb_width * mb_height))()
    end_bit = ctypes.c_long(0)
    err = lib.cavlc_parse_slice(
        _u8p(data), len(rbsp), start_bit, mb_width, mb_height, int(is_p),
        num_ref_idx_l0, recs, ctypes.byref(end_bit), int(bug_compat))
    if err:
        raise cavlc.CAVLCError(f"native CAVLC parse failed: code {err}")
    return recs, int(end_bit.value)


def emit_slice_raw(recs, mb_width: int, mb_height: int, is_p: bool,
                   num_ref_idx_l0: int, src_rbsp: bytes,
                   aux: bytes = b"", *, duplicate_final_skip: bool = False,
                   start_phase: int = 0, capacity: int | None = None,
                   bug_compat: bool = False):
    """Native re-emission of an MBRec grid -> (payload_bytes, nbits).

    The payload is the MB data only (no slice header or trailing bits).
    `start_phase` is the bit phase (mod 8) of the payload's position in
    the final stream (I_PCM alignment depends on it); the returned bytes
    carry `start_phase` leading zero bits and nbits counts them."""
    lib = load_library()
    if capacity is None:
        capacity = len(src_rbsp) + mb_width * mb_height * 400 + 4096
    out = np.zeros(capacity, np.uint8)
    src = np.frombuffer(src_rbsp, np.uint8)
    aux_arr = np.frombuffer(aux, np.uint8) if aux else np.zeros(1, np.uint8)
    nbits = ctypes.c_long(0)
    err = lib.cavlc_emit_slice(
        recs, mb_width, mb_height, int(is_p), num_ref_idx_l0, _u8p(src),
        _u8p(aux_arr), int(duplicate_final_skip), start_phase, _u8p(out),
        capacity, ctypes.byref(nbits), int(bug_compat))
    if err:
        raise cavlc.CAVLCError(f"native CAVLC emit failed: code {err}")
    n = int(nbits.value)
    return out[: (n + 7) // 8].tobytes(), n


def pad_grid_raw(recs, in_w: int, in_h: int, out_w: int, is_p: bool, *,
                 edge_y: int = 235):
    """Widen a raw MBRec grid with padding records (P slices: skip; I
    slices: I_PCM with aux payloads, the first one edge-compatible).
    -> (out_recs, aux_bytes, last_input_is_skip)."""
    from .models.splice import ipcm_padding_mb

    out_recs = (_MBRec * (out_w * in_h))()
    pad = out_w - in_w
    rec_size = ctypes.sizeof(_MBRec)
    # Aux payloads: [0] = the first padding MB (edge), [384] = a black MB.
    aux = (ipcm_padding_mb(edge_y, first_padding=True).ipcm_samples
           + ipcm_padding_mb().ipcm_samples)
    for row in range(in_h):
        ctypes.memmove(ctypes.byref(out_recs, row * out_w * rec_size),
                       ctypes.byref(recs, row * in_w * rec_size),
                       in_w * rec_size)
        if not is_p:
            for p in range(pad):
                dst = out_recs[row * out_w + in_w + p]
                dst.kind = 4
                dst.mb_type = 25
                dst.ipcm_byte_start = -((0 if p == 0 else 384) + 1)
        # P slices: zero-initialised records are already P_Skip (kind 0).
    return out_recs, aux, recs[in_w * in_h - 1].kind == 0


_NO_QP = -(2 ** 31)


def _bit_span(bits: np.ndarray, start: int, length: int) -> str:
    return "".join("1" if b else "0" for b in bits[start:start + length])


def _decode_tail(blk: _BlockRec, bits: np.ndarray) -> cavlc.ResidualBlock:
    if blk.tc == 0:
        return cavlc.EMPTY_BLOCK
    # Levels and runs are not re-derived (the emitter needs tc, t1 and the
    # tail bits only).
    return cavlc.ResidualBlock(int(blk.tc), int(blk.t1),
                               _bit_span(bits, blk.tail_start, blk.tail_len),
                               (), int(blk.total_zeros), ())


def _convert(rec: _MBRec, bits: np.ndarray, rbsp: bytes):
    """One native MBRec -> models/mb_transcode.Macroblock (or mbt.SKIP)."""
    from .models import mb_transcode as mbt

    if rec.kind == 0:
        return mbt.SKIP
    qp = None if rec.qp_delta == _NO_QP else int(rec.qp_delta)
    luma = tuple(_decode_tail(rec.blocks[1 + r], bits) for r in range(16))
    chroma_ac = tuple(tuple(_decode_tail(rec.blocks[19 + c * 4 + k], bits)
                            for k in range(4)) for c in range(2))
    cb_dc = (_decode_tail(rec.blocks[17], bits)
             if rec.blocks[17].tail_start or rec.blocks[17].tc else None)
    cr_dc = (_decode_tail(rec.blocks[18], bits)
             if rec.blocks[18].tail_start or rec.blocks[18].tc else None)
    if (rec.cbp >> 4) & 3 == 0:
        cb_dc = cr_dc = None
    if rec.kind == 1:
        return mbt.Macroblock(
            kind="inter", mb_type=int(rec.mb_type),
            sub_mb_types=tuple(int(s) for s in rec.sub_mb_types[:4])
            if rec.mb_type >= 3 else (),
            ref_idx=tuple(int(r) for r in rec.ref_idx[: rec.n_ref]),
            mvds=tuple((int(rec.mvds[k][0]), int(rec.mvds[k][1]))
                       for k in range(rec.n_mvds)),
            cbp=int(rec.cbp), qp_delta=qp, luma=luma, cb_dc=cb_dc,
            cr_dc=cr_dc, chroma_ac=chroma_ac)
    if rec.kind == 2:
        return mbt.Macroblock(
            kind="i4x4", mb_type=int(rec.mb_type),
            pred_mode_bits=_bit_span(bits, rec.pred_bits_start,
                                     rec.pred_bits_len),
            chroma_pred=int(rec.chroma_pred), cbp=int(rec.cbp), qp_delta=qp,
            luma=luma, cb_dc=cb_dc, cr_dc=cr_dc, chroma_ac=chroma_ac)
    if rec.kind == 3:
        return mbt.Macroblock(
            kind="i16x16", mb_type=int(rec.mb_type),
            i16_idx=int(rec.i16_idx), chroma_pred=int(rec.chroma_pred),
            cbp=int(rec.cbp), qp_delta=qp,
            luma_dc=_decode_tail(rec.blocks[0], bits), luma=luma,
            cb_dc=cb_dc, cr_dc=cr_dc, chroma_ac=chroma_ac)
    if rec.kind == 4:
        start = int(rec.ipcm_byte_start)
        samples = rbsp[start:start + 384]
        if len(samples) != 384:
            # The native parser rejects payloads past the RBSP end, so a
            # short one means a corrupted record: never truncate samples.
            raise cavlc.CAVLCError(
                f"I_PCM payload truncated ({len(samples)}/384 bytes at "
                f"byte {start})")
        return mbt.Macroblock(kind="ipcm", mb_type=int(rec.mb_type),
                              ipcm_samples=samples)
    raise cavlc.CAVLCError(f"native parser returned bad kind {rec.kind}")


def parse_slice_native(rbsp: bytes, start_bit: int, mb_width: int,
                       mb_height: int, is_p: bool, num_ref_idx_l0: int, *,
                       bug_compat: bool = False):
    """-> (grid, end_bit) as mb_transcode.parse_*_slice_mbs gives them
    (P_Skip as mbt.SKIP), parsed by the engine."""
    recs, end_bit = parse_slice_raw(rbsp, start_bit, mb_width, mb_height,
                                    is_p, num_ref_idx_l0,
                                    bug_compat=bug_compat)
    bits = np.unpackbits(np.frombuffer(rbsp, np.uint8))
    grid = [[_convert(recs[r * mb_width + c], bits, rbsp)
             for c in range(mb_width)] for r in range(mb_height)]
    return grid, end_bit


def pack_rows_native(patterns: np.ndarray, nbits: np.ndarray,
                     coded: np.ndarray, R: int, C: int, s_row: int):
    """Row-contiguous repack (cavlc_pack_rows) -> (row_patterns,
    row_nbits, first_c, donor_bits, needed), or None when the rows need
    more than s_row slots (the caller retries with a bigger class)."""
    lib = load_library()
    patterns = np.ascontiguousarray(patterns, np.uint32)
    nbits = np.ascontiguousarray(nbits, np.int32)
    coded_u8 = np.ascontiguousarray(coded, np.uint8)
    out_pat = np.zeros((R, s_row), np.uint32)
    out_nb = np.zeros((R, s_row), np.int32)
    first_c = np.zeros(R, np.int32)
    donor_bits = ctypes.c_long(0)
    needed = ctypes.c_int(0)
    err = lib.cavlc_pack_rows(
        _ptr(patterns, ctypes.c_uint32), _i32p(nbits), _u8p(coded_u8), R, C,
        patterns.shape[1], s_row, _ptr(out_pat, ctypes.c_uint32),
        _i32p(out_nb), _i32p(first_c), ctypes.byref(donor_bits),
        ctypes.byref(needed))
    if err:
        return None
    return out_pat, out_nb, first_c, int(donor_bits.value), needed.value


def _ring_arrays(ring, n):
    """Ring (list of (ref, mvx, mvy) or None) -> (i32[n, 3], u8[n])."""
    vals = np.zeros((n, 3), np.int32)
    valid = np.zeros(n, np.uint8)
    for i, ent in enumerate(ring or ()):
        if ent is not None:
            vals[i] = ent
            valid[i] = 1
    return vals, valid


def _rings(R, C, left_ring, top_ring, right_ring):
    tv, tm = _ring_arrays(top_ring, C + 2)
    lv, lm = _ring_arrays(left_ring, R)
    rv, rm = _ring_arrays(right_ring, max(R - 1, 0))
    return (_i32p(tv), _u8p(tm), _i32p(lv), _u8p(lm), _i32p(rv), _u8p(rm)), \
        (tv, tm, lv, lm, rv, rm)


def prepare_dense_raw(recs, mb_width: int, mb_height: int, rbsp: bytes,
                      num_ref_composite: int, ref_map,
                      at_left_edge: bool, at_top_edge: bool,
                      chunk_classes=(8, 12, 16, 24, 32, 48, 64, 104, 352),
                      *, bug_compat: bool = False):
    """Native dense prep over parsed MBRecs -> (patterns u32[M, S],
    nbits i32[M, S], coded bool[M], donor_bits, has_align), retrying
    chunk classes upward."""
    lib = load_library()
    data = np.frombuffer(rbsp, np.uint8)
    m_total = mb_width * mb_height
    rmap = np.asarray(ref_map, np.int32)
    needed = ctypes.c_int(0)
    for s_class in chunk_classes:
        patterns = np.zeros((m_total, s_class), np.uint32)
        nbits = np.zeros((m_total, s_class), np.int32)
        coded = np.zeros(m_total, np.uint8)
        donor_bits = ctypes.c_long(0)
        has_align = ctypes.c_int(0)
        err = lib.cavlc_prepare_dense(
            recs, mb_height, mb_width, num_ref_composite, _i32p(rmap),
            len(rmap), int(at_left_edge), int(at_top_edge), _u8p(data),
            len(rbsp), _ptr(patterns, ctypes.c_uint32), _i32p(nbits),
            s_class, _u8p(coded), ctypes.byref(donor_bits),
            ctypes.byref(has_align), ctypes.byref(needed), int(bug_compat))
        if err == -101:
            continue
        if err == -103:
            raise NotImplementedError(
                "donor P_Skips with donor_ref_map[0] != 0: skips hardwire "
                "composite ref 0 — use retarget_mvs=True")
        if err:
            raise cavlc.CAVLCError(f"native dense prep failed: {err}")
        return (patterns, nbits, coded.astype(bool),
                int(donor_bits.value), bool(has_align.value))
    raise OverflowError(
        f"donor MB needs {needed.value} chunk slots > max class")


def mv_edge_roles_raw(recs, mb_width: int, mb_height: int,
                      num_ref_composite: int, ref_map,
                      left_ring, top_ring, right_ring):
    """Native composite MV-field decode -> a/b/d role arrays (i32[M, 3]
    each: ref, mvx, mvy)."""
    lib = load_library()
    R, C = mb_height, mb_width
    rmap = np.asarray(ref_map, np.int32)
    ring_ptrs, _keep = _rings(R, C, left_ring, top_ring, right_ring)
    a, b, d = (np.zeros((R * C, 3), np.int32) for _ in range(3))
    err = lib.cavlc_mv_edge_roles(recs, R, C, num_ref_composite,
                                  _i32p(rmap), len(rmap), *ring_ptrs,
                                  _i32p(a), _i32p(b), _i32p(d))
    if err:
        raise cavlc.CAVLCError(f"native mv edge roles failed: {err}")
    return a, b, d


def retarget_recs_raw(recs, mb_width: int, mb_height: int,
                      num_ref_composite: int, ref_map,
                      left_ring, top_ring, right_ring) -> None:
    """In-place successive-donor MV retarget of a parsed MBRec grid: each
    donor MB's decoded motion survives the composite context exactly;
    skips become explicit P_L0_16x16 pinned to their donor-context skip
    MV.  Rings as in mv_edge_roles_raw."""
    lib = load_library()
    R, C = mb_height, mb_width
    rmap = np.asarray(ref_map, np.int32)
    ring_ptrs, _keep = _rings(R, C, left_ring, top_ring, right_ring)
    err = lib.cavlc_retarget_recs(recs, R, C, num_ref_composite,
                                  _i32p(rmap), len(rmap), *ring_ptrs)
    if err:
        raise cavlc.CAVLCError(f"native retarget failed: {err}")


def _marshal_rows_inputs(payloads, start_bits, R, C, ref_map,
                         at_left_edge, at_top_edge, at_right_edge,
                         left_ring, top_ring, right_ring, rings_per_donor):
    """Shared input marshalling of the batched rows / blob prep calls."""
    from .models.splice_device import _default_rings

    n = len(payloads)
    concat = np.frombuffer(b"".join(payloads), np.uint8)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(p) for p in payloads], out=offsets[1:])
    sbits = np.asarray(start_bits, np.int64)
    rmap = np.asarray(ref_map, np.int32)
    dl, dt, drr = _default_rings(R, C, at_left_edge, at_top_edge,
                                 at_right_edge)
    top_ring = dt if top_ring is None else top_ring
    left_ring = dl if left_ring is None else left_ring
    right_ring = drr if right_ring is None else right_ring
    if rings_per_donor:
        # One ring set per donor (sessions with different backgrounds),
        # stacked on a leading donor axis.
        if not len(top_ring) == len(left_ring) == len(right_ring) == n:
            raise ValueError("rings_per_donor needs one ring set per donor")
        rings = [np.stack([_ring_arrays(ring[i], k)[j] for i in range(n)])
                 for ring, k in ((top_ring, C + 2), (left_ring, R),
                                 (right_ring, max(R - 1, 0)))
                 for j in (0, 1)]
    else:
        rings = [a for ring, k in ((top_ring, C + 2), (left_ring, R),
                                   (right_ring, max(R - 1, 0)))
                 for a in _ring_arrays(ring, k)]
    rings = [np.ascontiguousarray(a) for a in rings]
    return concat, offsets, sbits, rmap, rings


def _ring_ptrs(rings):
    tv, tm, lv, lm, rv, rm = rings
    return (_i32p(tv), _u8p(tm), _i32p(lv), _u8p(lm), _i32p(rv), _u8p(rm))


def _raise_donor_errors(out_err, s_row, what):
    bad = np.flatnonzero(out_err)
    if not bad.size:
        return
    codes = out_err[bad]
    known = {-101, -103, -104, -105}
    parse = bad[~np.isin(codes, list(known))]
    if parse.size:
        raise cavlc.CAVLCError(
            f"{what} failed for donors {parse[:8].tolist()}: codes "
            f"{out_err[parse][:8].tolist()}")
    if (codes == -103).any():
        raise NotImplementedError(
            "donor P_Skips with donor_ref_map[0] != 0: skips hardwire "
            f"composite ref 0 — use retarget_mvs=True (donors "
            f"{bad[codes == -103][:8].tolist()})")
    if (codes == -104).any():
        raise ValueError(
            "donor edge-role MVs exceed the int16 wire range for donors "
            f"{bad[codes == -104][:8].tolist()}")
    if (codes == -105).any():
        raise OverflowError(
            f"{int((codes == -105).sum())} donors need more nbits "
            "exceptions than the class holds; retry with a bigger class")
    raise OverflowError(
        f"{int((codes == -101).sum())} donors need more than the "
        f"{s_row}-slot row chunk class; retry with a bigger class")


def prepare_rows_batch(payloads, start_bits, R: int, C: int,
                       num_ref_donor: int, num_ref_composite: int,
                       ref_map, s_row: int, *,
                       at_left_edge: bool = False,
                       at_top_edge: bool = False,
                       at_right_edge: bool = False,
                       left_ring=None, top_ring=None, right_ring=None,
                       rings_per_donor: bool = False,
                       n_threads: int = 0, bug_compat: bool = False,
                       retarget_mvs: bool = False) -> dict:
    """Fused, threaded serving prep of a batch of donor payloads: parse ->
    composite-nC dense chunks -> row pack -> MV edge roles, one native
    call (n_threads <= 0: hardware concurrency).

    Returns batch-stacked numpy arrays {row_patterns u32[N, R, s_row],
    row_nbits i32, first_c i32[N, R], coded bool[N, M], a_ref .. d_mvy
    i32[N, M], donor_bits i64[N], has_align bool[N]}.  Raises on any
    donor's error; OverflowError when a donor needs more than s_row row
    slots."""
    lib = load_library()
    n, m_total = len(payloads), R * C
    concat, offsets, sbits, rmap, rings = _marshal_rows_inputs(
        payloads, start_bits, R, C, ref_map, at_left_edge, at_top_edge,
        at_right_edge, left_ring, top_ring, right_ring, rings_per_donor)
    out_pat = np.zeros((n, R, s_row), np.uint32)
    out_nb = np.zeros((n, R, s_row), np.int32)
    out_first_c = np.zeros((n, R), np.int32)
    out_coded = np.zeros((n, m_total), np.uint8)
    out_a, out_b, out_d = (np.zeros((n, m_total, 3), np.int32)
                           for _ in range(3))
    out_bits = np.zeros(n, np.int64)
    out_align = np.zeros(n, np.int32)
    out_err = np.zeros(n, np.int32)
    lib.cavlc_prepare_rows_batch(
        _u8p(concat), _i64p(offsets), _i64p(sbits), n, R, C, num_ref_donor,
        num_ref_composite, _i32p(rmap), len(rmap), int(at_left_edge),
        int(at_top_edge), *_ring_ptrs(rings), s_row,
        _ptr(out_pat, ctypes.c_uint32), _i32p(out_nb), _i32p(out_first_c),
        _u8p(out_coded), _i32p(out_a), _i32p(out_b), _i32p(out_d),
        _i64p(out_bits), _i32p(out_align), _i32p(out_err),
        n_threads, int(bug_compat), int(retarget_mvs), int(rings_per_donor))
    _raise_donor_errors(out_err, s_row, "batch prep")
    out = {"row_patterns": out_pat, "row_nbits": out_nb,
           "first_c": out_first_c, "coded": out_coded.astype(bool),
           "donor_bits": out_bits, "has_align": out_align.astype(bool)}
    for role, arr in (("a", out_a), ("b", out_b), ("d", out_d)):
        for k, f in enumerate(("ref", "mvx", "mvy")):
            out[f"{role}_{f}"] = arr[:, :, k].copy()
    return out


def prepare_rows_blob_batch(payloads, start_bits, R: int, C: int,
                            num_ref_donor: int, num_ref_composite: int,
                            ref_map, s_row: int, s_flat: int, s_exc: int,
                            *, at_left_edge: bool = False,
                            at_top_edge: bool = False,
                            at_right_edge: bool = False,
                            left_ring=None, top_ring=None, right_ring=None,
                            rings_per_donor: bool = False,
                            n_threads: int = 0, bug_compat: bool = False,
                            retarget_mvs: bool = False):
    """prepare_rows_batch with each donor's whole serving wire (the flat
    chunk stream, row metadata, exceptions, first_c/coded and edge roles
    of splice_device.flat_wire_layout) compacted in C into one uint32
    record.  Returns (blob u32[N, stride], donor_bits i64[N],
    has_align bool[N])."""
    lib = load_library()
    n = len(payloads)
    concat, offsets, sbits, rmap, rings = _marshal_rows_inputs(
        payloads, start_bits, R, C, ref_map, at_left_edge, at_top_edge,
        at_right_edge, left_ring, top_ring, right_ring, rings_per_donor)
    stride = int(lib.cavlc_blob_stride(R, C, s_flat, s_exc))
    out_blob = np.zeros((n, stride), np.uint32)
    out_bits = np.zeros(n, np.int64)
    out_align = np.zeros(n, np.int32)
    out_needed = np.zeros(n, np.int32)
    out_err = np.zeros(n, np.int32)
    lib.cavlc_prepare_rows_blob_batch(
        _u8p(concat), _i64p(offsets), _i64p(sbits), n, R, C, num_ref_donor,
        num_ref_composite, _i32p(rmap), len(rmap), int(at_left_edge),
        int(at_top_edge), *_ring_ptrs(rings), s_row, s_flat, s_exc,
        _ptr(out_blob, ctypes.c_uint32), _i64p(out_bits), _i32p(out_align),
        _i32p(out_needed), _i32p(out_err),
        n_threads, int(bug_compat), int(retarget_mvs), int(rings_per_donor))
    _raise_donor_errors(out_err, s_row, "blob batch prep")
    return out_blob, out_bits, out_align.astype(bool)
