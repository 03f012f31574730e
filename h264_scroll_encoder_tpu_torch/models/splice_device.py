"""Dynamic-rect splice, batched: the row-contiguous and the dense layouts.

Port of h264_scroll_encoder_tpu/models/splice_device.py: a pre-encoded
CAVLC donor rect is composed into a P frame of static (or hinted)
background.

  host (numpy; native C++ engine or the Python one): parse the donor
    slice, resolve every residual block's coeff_token against the
    *composite* nC (the rect position is static, so it is known at prep
    time), fuse each rect row's macroblocks into one chunk stream with
    its interior skip runs encoded, and decode the composite MV edge
    roles (prepare_donor_rows_serving, pack_donor_rows).

  device (torch, leading session dimension): lay the donor row streams
    into the frame's symbol stream beside the background macroblocks and
    skip runs (rows_splice_symbols), then the shared slice tail: I_PCM
    alignment, trailing bits, pack, emulation prevention, Annex-B
    framing — kernel K1, or K2 plus exact EBSP on the retry path
    (_finish_splice -> models/scroll.finish_slice).

Every donor-dependent value (row chunks, first_c, coded mask, edge roles)
is a tensor, so one step serves any donor of a geometry.  The dense
layout (emit_spliced_frame_dense over dense_device_arrays: each donor MB
as its own run of S chunk slots) is the rows layout's byte-for-byte
parity partner; the JAX package's per-slot prepare path survives here as
the Python engine behind prepare_donor_dense.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import _kernels
from ..config import ComposerConfig
from ..ops import bitpack, expgolomb
from ..ops import cavlc_tables as T
from ..ops.bitpack import U32
from . import mb_transcode as mbt
from . import scroll as scroll_model

# Per-donor-MB symbol slot budget of the Python engine's intermediate
# form: PRE = pre-residual syntax chunks (worst case P_8x8: 43), then per
# residual block (27, in emission order) one token slot + tail chunks.
PRE_SLOTS = 48
TAIL_CHUNK_CLASSES = (2, 4, 8, 16)
TAIL_CHUNKS = 16
N_BLOCKS = 27

# nC class codes for the token table lookup.
CLASS_NC0, CLASS_NC2, CLASS_NC4, CLASS_FLC, CLASS_CHROMA = 0, 1, 2, 3, 4

# Sentinel nbits of a pcm_alignment_zero_bits slot: its width depends on
# the final bit position and is resolved on the device (_finish_splice).
ALIGN_SENTINEL = -1

ROLE_FIELDS = ("a_ref", "a_mvx", "a_mvy", "b_ref", "b_mvx", "b_mvy",
               "d_ref", "d_mvx", "d_mvy")


# ===========================================================================
# Host half (numpy).
# ===========================================================================

@functools.lru_cache(maxsize=1)
def token_tables():
    """coeff_token (pattern, length) tables [class 0..4][tc 0..16][t1 0..3];
    class 0 = nC<2, 1 = nC<4, 2 = nC<8, 3 = nC>=8 (FLC), 4 = chroma DC.
    Invalid (tc, t1) combinations hold zeros."""
    pat = np.zeros((5, 17, 4), np.uint32)
    ln = np.zeros((5, 17, 4), np.int32)
    for ci, cls in enumerate(("nc0", "nc2", "nc4")):
        for (tc, t1), code in T._TOKEN_TABLES[cls].items():
            pat[ci, tc, t1] = int(code, 2)
            ln[ci, tc, t1] = len(code)
    for tc in range(17):
        for t1 in range(min(3, tc) + 1):
            code = T.coeff_token_code(8, tc, t1)
            pat[CLASS_FLC, tc, t1] = int(code, 2)
            ln[CLASS_FLC, tc, t1] = len(code)
    for (tc, t1), code in T._TOKEN_TABLES["chroma_dc"].items():
        pat[CLASS_CHROMA, tc, t1] = int(code, 2)
        ln[CLASS_CHROMA, tc, t1] = len(code)
    return pat, ln


@dataclasses.dataclass
class DonorSymbols:
    """Per-slot symbol arrays of one donor rect (R x C macroblocks,
    row-major m = r*C + c): the Python engine's intermediate form."""
    pre_patterns: np.ndarray      # u32 [M, PRE_SLOTS]
    pre_nbits: np.ndarray         # i32 [M, PRE_SLOTS]
    tail_patterns: np.ndarray     # u32 [M, N_BLOCKS, tail chunks]
    tail_nbits: np.ndarray        # i32 [M, N_BLOCKS, tail chunks]
    tok_tc: np.ndarray            # i32 [M, N_BLOCKS] (emission position)
    tok_t1: np.ndarray            # i32 [M, N_BLOCKS]
    tok_present: np.ndarray       # bool [M, N_BLOCKS]
    tok_block_id: np.ndarray      # i32 [M, N_BLOCKS] canonical block id
    luma_tc: np.ndarray           # i32 [M, 16] raster order
    chroma_tc: np.ndarray         # i32 [M, 2, 4]
    coded: np.ndarray             # bool [M] (False = donor P_Skip)
    ipcm: np.ndarray              # bool [M]


def _bits_of_str(s: str) -> list:
    """bit-string -> (pattern, nbits) chunks of <= 32 bits."""
    return [(int(s[i:i + 32], 2), len(s[i:i + 32]))
            for i in range(0, len(s), 32)]


class _SlotWriter:
    """Accumulate (pattern, nbits) pairs into fixed slot arrays."""

    def __init__(self, n_slots: int):
        self.patterns = np.zeros(n_slots, np.uint32)
        self.nbits = np.zeros(n_slots, np.int32)
        self.i = 0

    def put(self, pattern: int, nbits: int) -> None:
        if nbits == 0:
            return
        if self.i >= self.patterns.size:
            raise OverflowError("slot budget exceeded")
        self.patterns[self.i] = pattern & 0xFFFFFFFF
        self.nbits[self.i] = nbits          # may be ALIGN_SENTINEL
        self.i += 1

    def put_ue(self, v: int) -> None:
        m = (v + 1).bit_length() - 1
        self.put(v + 1, 2 * m + 1)

    def put_se(self, v: int) -> None:
        self.put_ue(2 * v - 1 if v > 0 else -2 * v)

    def put_bits_str(self, s: str) -> None:
        for p, n in _bits_of_str(s):
            self.put(p, n)


def _emission_blocks(mb: mbt.Macroblock):
    """Yield (block_id, ResidualBlock, nc_kind) in emission order; block
    ids: 0 luma DC, 1 + raster luma, 17/18 chroma DC, 19+ chroma AC."""
    cbp_luma = mb.cbp & 0xF
    cbp_chroma = (mb.cbp >> 4) & 0x3
    if mb.kind == "i16x16":
        yield 0, mb.luma_dc, "luma"
        for s in range(16):
            raster = T.SCAN_TO_RASTER[s]
            if cbp_luma & (1 << (s // 4)):
                yield 1 + raster, mb.luma[raster], "luma"
    elif mb.kind in ("inter", "i4x4") and mb.cbp > 0:
        for s in range(16):
            raster = T.SCAN_TO_RASTER[s]
            if cbp_luma & (1 << (s // 4)):
                yield 1 + raster, mb.luma[raster], "luma"
    if (mb.cbp > 0 or mb.kind == "i16x16") and cbp_chroma > 0:
        yield 17, mb.cb_dc, "cdc"
        yield 18, mb.cr_dc, "cdc"
        if cbp_chroma == 2:
            for c in range(2):
                for k in range(4):
                    yield 19 + c * 4 + k, mb.chroma_ac[c][k], "chroma"


def _tail_chunk_class(donor_grid: list) -> int:
    """Smallest TAIL_CHUNK_CLASSES entry covering every residual tail."""
    need = 1
    for row in donor_grid:
        for mb in row:
            if mb is mbt.SKIP:
                continue
            if mb.kind == "ipcm":
                need = max(need, -(-96 // N_BLOCKS))  # 96 sample chunks
                continue
            for _bid, blk, _k in _emission_blocks(mb):
                if blk is not None and blk.tail:
                    need = max(need, (len(blk.tail) + 31) // 32)
    return next((c for c in TAIL_CHUNK_CLASSES if need <= c), TAIL_CHUNKS)


def _map_donor_refs(mb: mbt.Macroblock, ref_map: tuple,
                    num_ref_idx_l0: int) -> mbt.Macroblock:
    """Re-target a donor inter MB's reference indices into the composite
    slice's list (h264_scroll_encoder_tpu models/splice._map_donor_refs):
    `ref_map[donor_ref]` names the composite slot; P_8x8ref0 becomes
    P_8x8 when the mapped ref is nonzero."""
    if mb.kind != "inter":
        return mb
    if mb.mb_type == 4 and ref_map[0] != 0:
        return dataclasses.replace(mb, mb_type=3, ref_idx=(ref_map[0],) * 4)
    if num_ref_idx_l0 <= 1:
        return dataclasses.replace(mb, ref_idx=())
    if mb.mb_type == 4:
        return mb
    n_parts = 1 if mb.mb_type == 0 else (2 if mb.mb_type <= 2 else 4)
    refs = (tuple(ref_map[r] for r in mb.ref_idx) if mb.ref_idx
            else (ref_map[0],) * n_parts)
    return dataclasses.replace(mb, ref_idx=refs)


def prepare_donor_symbols(donor_grid: list, num_ref_idx_l0: int,
                          donor_ref_map: tuple = (0,)) -> DonorSymbols:
    """Flatten a parsed donor MB grid into per-slot symbol arrays."""
    rows, cols = len(donor_grid), len(donor_grid[0])
    m_total = rows * cols
    tail_chunks = _tail_chunk_class(donor_grid)
    ds = DonorSymbols(
        pre_patterns=np.zeros((m_total, PRE_SLOTS), np.uint32),
        pre_nbits=np.zeros((m_total, PRE_SLOTS), np.int32),
        tail_patterns=np.zeros((m_total, N_BLOCKS, tail_chunks), np.uint32),
        tail_nbits=np.zeros((m_total, N_BLOCKS, tail_chunks), np.int32),
        tok_tc=np.zeros((m_total, N_BLOCKS), np.int32),
        tok_t1=np.zeros((m_total, N_BLOCKS), np.int32),
        tok_present=np.zeros((m_total, N_BLOCKS), bool),
        tok_block_id=np.zeros((m_total, N_BLOCKS), np.int32),
        luma_tc=np.zeros((m_total, 16), np.int32),
        chroma_tc=np.zeros((m_total, 2, 4), np.int32),
        coded=np.zeros(m_total, bool),
        ipcm=np.zeros(m_total, bool),
    )
    for r in range(rows):
        for c in range(cols):
            m = r * cols + c
            mb = donor_grid[r][c]
            if mb is mbt.SKIP:
                continue
            mb = _map_donor_refs(mbt.retype_for_p(mb), donor_ref_map,
                                 num_ref_idx_l0)
            ds.coded[m] = True
            w = _SlotWriter(PRE_SLOTS)
            w.put_ue(mb.mb_type)
            if mb.kind == "ipcm":
                # mb_type, then pcm_alignment_zero_bits as an ALIGN slot,
                # then the 384 sample bytes as 96 chunks spread over the
                # tail slots.  Neighbours see nN = 16 (spec 9.2.1).
                ds.ipcm[m] = True
                ds.luma_tc[m] = 16
                ds.chroma_tc[m] = 16
                w.put(0, ALIGN_SENTINEL)
                ds.pre_patterns[m] = w.patterns
                ds.pre_nbits[m] = w.nbits
                b = np.frombuffer(mb.ipcm_samples, np.uint8).reshape(96, 4)
                vals = ((b[:, 0].astype(np.uint32) << 24)
                        | (b[:, 1].astype(np.uint32) << 16)
                        | (b[:, 2].astype(np.uint32) << 8)
                        | b[:, 3].astype(np.uint32))
                for k, v in enumerate(vals):
                    ds.tail_patterns[m, k // tail_chunks, k % tail_chunks] = v
                    ds.tail_nbits[m, k // tail_chunks, k % tail_chunks] = 32
                continue
            if mb.kind == "inter":
                if mb.mb_type >= 3:
                    for s in mb.sub_mb_types:
                        w.put_ue(s)
                if num_ref_idx_l0 > 1 and mb.mb_type != 4 and mb.ref_idx:
                    for ref in mb.ref_idx:
                        if num_ref_idx_l0 == 2:
                            w.put(1 - (ref & 1), 1)
                        else:
                            w.put_ue(ref)
                for mvd_x, mvd_y in mb.mvds:
                    w.put_se(mvd_x)
                    w.put_se(mvd_y)
                w.put_ue(T.CBP_INTER_INV[mb.cbp])
                if mb.cbp > 0:
                    w.put_se(mb.qp_delta)
            elif mb.kind == "i4x4":
                w.put_bits_str(mb.pred_mode_bits)
                w.put_ue(mb.chroma_pred)
                w.put_ue(T.CBP_INTRA_INV[mb.cbp])
                if mb.cbp > 0:
                    w.put_se(mb.qp_delta)
            elif mb.kind == "i16x16":
                w.put_ue(mb.chroma_pred)
                w.put_se(mb.qp_delta)
            ds.pre_patterns[m] = w.patterns
            ds.pre_nbits[m] = w.nbits
            for pos, (block_id, blk, _kind) in enumerate(
                    _emission_blocks(mb)):
                ds.tok_present[m, pos] = True
                ds.tok_block_id[m, pos] = block_id
                ds.tok_tc[m, pos] = blk.total_coeff
                ds.tok_t1[m, pos] = blk.trailing_ones
                for k, (p, n) in enumerate(_bits_of_str(blk.tail)):
                    ds.tail_patterns[m, pos, k] = p
                    ds.tail_nbits[m, pos, k] = n
            ds.luma_tc[m] = [b.total_coeff for b in mb.luma]
            ds.chroma_tc[m] = [[b.total_coeff for b in plane]
                               for plane in mb.chroma_ac]
    return ds


# Per-MB dense chunk budget classes: 104 covers I_PCM (mb_type + align +
# 96 sample chunks), 352 the worst legal CAVLC macroblock (~11k bits).
MB_CHUNK_CLASSES = (4, 8, 12, 16, 24, 32, 48, 64, 104, 352)


def _host_nc(tc_grid: np.ndarray, at_left: bool, at_top: bool) -> np.ndarray:
    """Composite-geometry nC stencil over one [rows, cols] block grid:
    blocks outside the rect are coded with zero coefficients (available)
    except past the frame's left / top edge."""
    ga = np.pad(tc_grid, ((1, 0), (1, 0)))
    nA, nB = ga[1:, :-1], ga[:-1, 1:]
    col = np.broadcast_to(np.arange(tc_grid.shape[1])[None, :], tc_grid.shape)
    row = np.broadcast_to(np.arange(tc_grid.shape[0])[:, None], tc_grid.shape)
    avail_a = ~(at_left & (col == 0))
    avail_b = ~(at_top & (row == 0))
    return np.where(avail_a & avail_b, (nA + nB + 1) >> 1,
                    np.where(avail_a, nA, np.where(avail_b, nB, 0)))


def _host_luma_nc(luma_tc: np.ndarray, at_left: bool, at_top: bool
                  ) -> np.ndarray:
    """Composite-geometry luma nC: [R, C, 16] -> [R, C, 16]."""
    R, C = luma_tc.shape[:2]
    g = luma_tc.reshape(R, C, 4, 4).transpose(0, 2, 1, 3).reshape(R * 4,
                                                                  C * 4)
    nc = _host_nc(g, at_left, at_top)
    return nc.reshape(R, 4, C, 4).transpose(0, 2, 1, 3).reshape(R, C, 16)


def _host_chroma_nc(chroma_tc: np.ndarray, at_left: bool, at_top: bool
                    ) -> np.ndarray:
    """Composite-geometry chroma AC nC: [R, C, 2, 4] -> [R, C, 2, 4]."""
    R, C = chroma_tc.shape[:2]
    out = []
    for plane in range(2):
        g = chroma_tc[:, :, plane].reshape(R, C, 2, 2)
        g = g.transpose(0, 2, 1, 3).reshape(R * 2, C * 2)
        nc = _host_nc(g, at_left, at_top)
        out.append(nc.reshape(R, 2, C, 2).transpose(0, 2, 1, 3)
                   .reshape(R, C, 4))
    return np.stack(out, axis=2)


@dataclasses.dataclass
class DonorDense:
    """Per-MB dense donor arrays: each donor MB's final bits as <= 32-bit
    chunks (nbits may be ALIGN_SENTINEL), and the MB's composite-decoded
    4x4 edge motion when acting as a left (a_*: top-right 4x4), above /
    above-right (b_*: bottom-left 4x4) or above-left (d_*: bottom-right
    4x4) prediction neighbour."""
    patterns: np.ndarray          # u32 [M, S]
    nbits: np.ndarray             # i32 [M, S]
    coded: np.ndarray             # bool [M]
    a_ref: np.ndarray             # i32 [M]
    a_mvx: np.ndarray
    a_mvy: np.ndarray
    b_ref: np.ndarray
    b_mvx: np.ndarray
    b_mvy: np.ndarray
    d_ref: np.ndarray
    d_mvx: np.ndarray
    d_mvy: np.ndarray
    donor_bits: int               # exact payload bits (align counted as 7)
    has_align: bool               # any ALIGN sentinel (I_PCM MBs)


class _ChunkFuser:
    """Accumulate (pattern, nbits) symbols into dense 32-bit chunks."""

    def __init__(self):
        self.chunks: list = []
        self._acc = 0
        self._n = 0

    def put(self, pattern: int, nbits: int) -> None:
        if nbits == ALIGN_SENTINEL:
            self.flush()
            self.chunks.append((0, ALIGN_SENTINEL))
            return
        if nbits <= 0:
            return
        self._acc = (self._acc << nbits) | (pattern & ((1 << nbits) - 1))
        self._n += nbits
        while self._n >= 32:
            self.chunks.append(((self._acc >> (self._n - 32)) & 0xFFFFFFFF,
                                32))
            self._n -= 32
            self._acc &= (1 << self._n) - 1

    def flush(self) -> None:
        if self._n > 0:
            self.chunks.append((self._acc, self._n))
            self._acc = 0
            self._n = 0


# Row-contiguous layout: classes of the per-row fused chunk count.
ROW_CHUNK_CLASSES = (16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512,
                     768, 1024, 1536, 2048)


def row_chunk_class(need: int) -> int:
    """Smallest ROW_CHUNK_CLASSES entry >= need; OverflowError past the
    largest."""
    s_row = next((x for x in ROW_CHUNK_CLASSES if need <= x),
                 ROW_CHUNK_CLASSES[-1])
    if need > s_row:
        raise OverflowError(
            f"donor row needs {need} chunk slots > max class {s_row}")
    return s_row


def flat_chunk_class(need: int) -> int:
    """Flat-wire total-chunk class: next multiple of 64 (min 64)."""
    return max(64, -(-int(need) // 64) * 64)


def exc_class(need: int) -> int:
    """Flat-wire nbits-exception class: next multiple of 16 (min 16)."""
    return max(16, -(-int(need) // 16) * 16)


@dataclasses.dataclass
class DonorRows:
    """Row-contiguous donor layout: each rect row's coded MBs fused into
    one chunk stream with the row-interior mb_skip_run symbols encoded in
    place; the device emits only the run before each row's first coded MB
    (at rect column first_c, -1 for an all-skip row)."""
    row_patterns: np.ndarray      # u32 [R, S_row]
    row_nbits: np.ndarray         # i32 [R, S_row] (ALIGN_SENTINEL kept)
    first_c: np.ndarray           # i32 [R]
    coded: np.ndarray             # bool [M]
    a_ref: np.ndarray
    a_mvx: np.ndarray
    a_mvy: np.ndarray
    b_ref: np.ndarray
    b_mvx: np.ndarray
    b_mvy: np.ndarray
    d_ref: np.ndarray
    d_mvx: np.ndarray
    d_mvy: np.ndarray
    donor_bits: int               # static bits incl. fused interior runs
    has_align: bool


def _ue_bits(v: int) -> tuple:
    """(pattern, nbits) of ue(v)."""
    n = (v + 1).bit_length()
    return v + 1, 2 * n - 1


def pack_donor_rows(dd: DonorDense, R: int, C: int, *,
                    min_class: int = 0) -> DonorRows:
    """Repack per-MB chunk arrays into the row-contiguous layout.
    `min_class` pins at least that many row slots, so donors of varying
    density share one step."""
    coded = np.asarray(dd.coded, bool).reshape(R, C)
    S = dd.patterns.shape[1]
    rows = []
    first_c = np.full(R, -1, np.int32)
    donor_bits = 0
    has_align = False
    for r in range(R):
        f = _ChunkFuser()
        last = None
        for c in range(C):
            if not coded[r, c]:
                continue
            if last is None:
                first_c[r] = c
            else:
                pat, n = _ue_bits(c - last - 1)
                f.put(pat, n)
                donor_bits += n
            last = c
            m = r * C + c
            for k in range(S):
                n = int(dd.nbits[m, k])
                if n == 0:
                    break
                if n == ALIGN_SENTINEL:
                    has_align = True
                    donor_bits += 7
                f.put(int(dd.patterns[m, k]), n)
                if n > 0:
                    donor_bits += n
        f.flush()
        rows.append(f.chunks)

    s_row = row_chunk_class(max(max((len(ch) for ch in rows), default=1),
                                min_class))
    patterns = np.zeros((R, s_row), np.uint32)
    nbits = np.zeros((R, s_row), np.int32)
    for r, chunks in enumerate(rows):
        for k, (pat, n) in enumerate(chunks):
            patterns[r, k] = pat
            nbits[r, k] = n
    return DonorRows(patterns, nbits, first_c, np.asarray(dd.coded, bool),
                     *(getattr(dd, f) for f in ROLE_FIELDS),
                     donor_bits, has_align)


def _check_roles_fit_int16(wire: dict) -> None:
    """Refuse a donor whose edge-role values overflow the int16 wire
    (in-budget MVs are far inside: 496 px = 1984 qpel)."""
    for k, v in wire.items():
        a = np.abs(np.asarray(v).astype(np.int64))
        if a.size == 0 or (a <= 32767).all():
            continue
        over = (a.reshape(a.shape[0], -1) if a.ndim > 1
                else a.reshape(1, -1)).max(axis=-1) > 32767
        raise ValueError(
            f"donor edge-role field '{k}' exceeds the int16 wire range "
            f"(|v| > 32767 qpel) for donor rows "
            f"{np.flatnonzero(over)[:8].tolist()} — rejecting the donor")


def _edge_roles_wire(roles: dict, R: int, C: int) -> dict:
    """Full [.., R*C] role arrays -> the edge vectors composite prediction
    reads: 'a' on the rect's right column; 'b' on its bottom row (bb) and
    left column (lb); 'd' on its right column and bottom row (db).  Arrays
    may carry a leading batch axis."""
    def rs(a):
        return np.asarray(a).reshape(np.shape(a)[:-1] + (R, C))

    out = {}
    for f in ("ref", "mvx", "mvy"):
        out[f"edge_a_{f}"] = rs(roles[f"a_{f}"])[..., :, C - 1]
        out[f"edge_bb_{f}"] = rs(roles[f"b_{f}"])[..., R - 1, :]
        out[f"edge_lb_{f}"] = rs(roles[f"b_{f}"])[..., :, 0]
        out[f"edge_d_{f}"] = rs(roles[f"d_{f}"])[..., :, C - 1]
        out[f"edge_db_{f}"] = rs(roles[f"d_{f}"])[..., R - 1, :]
    return out


def rows_wire(dr: DonorRows) -> dict:
    """DonorRows -> the padded rows wire as numpy arrays (the JAX
    package's rows_device_arrays): row chunks, first_c, coded and int16
    edge roles."""
    R = dr.row_patterns.shape[0]
    C = dr.coded.size // R
    out = {"row_patterns": np.asarray(dr.row_patterns, np.uint32),
           "row_nbits": np.asarray(dr.row_nbits, np.int32),
           "first_c": np.asarray(dr.first_c, np.int32),
           "coded": np.asarray(dr.coded, bool)}
    edge = _edge_roles_wire({f: getattr(dr, f) for f in ROLE_FIELDS}, R, C)
    _check_roles_fit_int16(edge)
    out.update({k: np.asarray(v).astype(np.int16) for k, v in edge.items()})
    return out


def donor_arrays_from_numpy(dn: dict, device="cuda") -> dict:
    """A donor wire dict of numpy arrays (this module's, or the JAX
    package's `dn` after np.asarray) -> torch tensors on `device`.
    uint32 arrays become int64 holding the same values; other dtypes keep
    theirs.  Leading dimensions are kept as they are."""
    dev = _kernels.resolve_device(device)
    out = {}
    for k, v in dn.items():
        a = np.asarray(v)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return out


def rows_device_arrays(dr: DonorRows, device="cuda") -> dict:
    """DonorRows -> the rows wire as tensors on `device` (no batch dim)."""
    return donor_arrays_from_numpy(rows_wire(dr), device)


DENSE_FIELDS = ("patterns", "nbits", "coded") + ROLE_FIELDS


def dense_device_arrays(dd: DonorDense, device="cuda") -> dict:
    """DonorDense -> the dense wire as tensors on `device` (no batch dim):
    chunks u32 -> int64 [M, S], nbits int32 [M, S], coded bool [M] and the
    int32 edge roles [M] (the JAX package's dense_device_arrays keys)."""
    return donor_arrays_from_numpy({k: getattr(dd, k) for k in DENSE_FIELDS},
                                   device)


def rows_flat_wire(pat: np.ndarray, nb: np.ndarray, *,
                   s_flat: int | None = None, s_exc: int | None = None):
    """Compact padded [N, R, s_row] donor row chunks into the flat wire:

      flat_patterns u32[N, s_flat] — the row chunk streams, concatenated
      row_len       i16[N, R]      — chunks per row (0 = all-skip row)
      row_tail      i8 [N, R]      — nbits of each row's last chunk
      exc_idx/exc_val i32/i8[N, E] — nbits overrides at flat positions
                                     (ALIGN sentinels, partial chunks)

    All chunks but each row's last and the rare exceptions are full 32-bit
    words.  Returns (wire dict, s_flat, s_exc); callers pin both classes
    so every donor of a geometry shares one step."""
    N, R, s_row = pat.shape
    nbi = np.asarray(nb, np.int32)
    nz = nbi != 0
    any_nz = nz.any(-1)
    row_len = np.where(any_nz, s_row - np.argmax(nz[:, :, ::-1], axis=-1),
                       0).astype(np.int64)
    total = row_len.sum(-1)
    need = int(total.max()) if N else 0
    if s_flat is None:
        s_flat = flat_chunk_class(max(need, 1))
    elif need > s_flat:
        raise OverflowError(
            f"donor needs {need} total chunks > flat class {s_flat}")

    j = np.arange(s_row)
    in_row = j[None, None, :] < row_len[:, :, None]
    last = np.maximum(row_len - 1, 0)[:, :, None]
    row_tail = (np.take_along_axis(nbi, last, axis=2)[:, :, 0]
                * any_nz).astype(np.int8)
    expected = np.where(in_row, 32, 0)
    np.put_along_axis(
        expected, last,
        np.where(any_nz[:, :, None], row_tail[:, :, None].astype(np.int64),
                 0), axis=2)
    row_start = np.zeros((N, R), np.int64)
    row_start[:, 1:] = np.cumsum(row_len, -1)[:, :-1]
    flat_pos = row_start[:, :, None] + j[None, None, :]

    flat_p = np.zeros((N, s_flat), np.uint32)
    exc = []
    for i in range(N):
        v = in_row[i]
        flat_p[i, : int(total[i])] = np.asarray(pat[i], np.uint32)[v]
        mm = v & (nbi[i] != expected[i])
        exc.append((flat_pos[i][mm], nbi[i][mm]))
    e_need = max((len(a) for a, _ in exc), default=0)
    if s_exc is None:
        s_exc = exc_class(e_need)
    elif e_need > s_exc:
        raise OverflowError(
            f"donor needs {e_need} nbits exceptions > class {s_exc}")
    exc_idx = np.full((N, s_exc), -1, np.int32)
    exc_val = np.zeros((N, s_exc), np.int8)
    for i, (a, vv) in enumerate(exc):
        exc_idx[i, : len(a)] = a
        exc_val[i, : len(a)] = vv
    wire = {"flat_patterns": flat_p, "row_len": row_len.astype(np.int16),
            "row_tail": row_tail, "exc_idx": exc_idx, "exc_val": exc_val}
    return wire, s_flat, s_exc


# Single-blob serving wire: every per-donor field in ONE uint32 record,
# little-endian within each word (host packer and device decoder agree).
_EDGE_WIRE_FIELDS = (
    ("edge_a_ref", "R"), ("edge_a_mvx", "R"), ("edge_a_mvy", "R"),
    ("edge_bb_ref", "C"), ("edge_bb_mvx", "C"), ("edge_bb_mvy", "C"),
    ("edge_lb_ref", "R"), ("edge_lb_mvx", "R"), ("edge_lb_mvy", "R"),
    ("edge_d_ref", "R"), ("edge_d_mvx", "R"), ("edge_d_mvy", "R"),
    ("edge_db_ref", "C"), ("edge_db_mvx", "C"), ("edge_db_mvy", "C"),
)
_PER_WORD = {"u32": 1, "i32": 1, "i16": 2, "i8": 4, "u8": 4, "u1": 32}


def flat_wire_layout(R: int, C: int, s_flat: int, s_exc: int):
    """Static field layout of the blob wire: ([(name, kind, count,
    word_offset)], stride in uint32 words)."""
    fields = [
        ("flat_patterns", "u32", s_flat),
        ("row_len", "i16", R),
        ("row_tail", "i8", R),
        ("exc_idx", "i16", s_exc),
        ("exc_val", "i8", s_exc),
        ("first_c", "i16", R),
        ("coded", "u1", R * C),
    ]
    fields += [(name, "i16", R if dim == "R" else C)
               for name, dim in _EDGE_WIRE_FIELDS]
    laid, off = [], 0
    for name, kind, count in fields:
        laid.append((name, kind, count, off))
        off += -(-count // _PER_WORD[kind])
    return laid, off


def pack_rows_blob(wire: dict, R: int, C: int, s_flat: int,
                   s_exc: int) -> np.ndarray:
    """Host: dict of per-field [N, ...] arrays -> uint32 blob [N, stride]."""
    layout, stride = flat_wire_layout(R, C, s_flat, s_exc)
    N = np.asarray(wire["flat_patterns"]).shape[0]
    blob = np.zeros((N, stride), "<u4")
    u8 = blob.view(np.uint8).reshape(N, stride * 4)
    for name, kind, count, off in layout:
        v = np.asarray(wire[name])
        b = off * 4
        if kind == "u32":
            blob[:, off: off + count] = v.astype("<u4")
        elif kind == "i32":
            blob[:, off: off + count] = v.astype("<i4").view("<u4")
        elif kind == "i16":
            if v.size and (v.min() < -32768 or v.max() > 32767):
                raise ValueError(f"{name} exceeds the int16 wire range")
            u8[:, b: b + 2 * count] = (
                v.astype("<i2").view(np.uint8).reshape(N, 2 * count))
        elif kind == "u1":
            bits = np.packbits(v.astype(bool).reshape(N, count), axis=-1,
                               bitorder="little")
            u8[:, b: b + bits.shape[1]] = bits
        else:                                   # i8 / u8
            u8[:, b: b + count] = (
                v.astype(np.int8 if kind == "i8" else np.uint8)
                .view(np.uint8).reshape(N, count))
    return blob


def donor_edge_motion(donor_grid: list, *, left_ring=None, top_ring=None,
                      right_ring=None, rect_at_left_edge=False,
                      rect_at_top_edge=False, rect_at_right_edge=False):
    """Exact composite-context 4x4 edge motion per donor MB: the donor MV
    field decoded (models/mv_field) inside a border of composite
    neighbour values.  Rings hold MB-level (ref, mvx_qpel, mvy_qpel)
    tuples or None (unavailable):

      top_ring:   C+2 entries, row r0-1, cols c0-1 .. c0+C
      left_ring:  R entries, col c0-1, rows r0 .. r0+R-1
      right_ring: R-1 entries, col c0+C, rows r0 .. r0+R-2

    Defaults model a static background (P_Skip, ref 0, MV 0) minus
    frame-edge unavailability.  Returns ((a_ref, a_mvx, a_mvy), (b_...),
    (d_...)), each [M] over row-major donor MBs."""
    from .mv_field import MVField, decode_p_slice_mv_field

    rows, cols = len(donor_grid), len(donor_grid[0])
    dl, dt, drr = _default_rings(rows, cols, rect_at_left_edge,
                                 rect_at_top_edge, rect_at_right_edge)
    top_ring = dt if top_ring is None else top_ring
    left_ring = dl if left_ring is None else left_ring
    right_ring = drr if right_ring is None else right_ring

    field = MVField(cols + 2, rows + 1)

    def _fill(mb_x, mb_y, entry):
        if entry is not None:
            field.fill(mb_x * 4, mb_y * 4, 4, 4, *entry)

    for c in range(cols + 2):
        _fill(c, 0, top_ring[c])
    for r in range(rows):
        _fill(0, 1 + r, left_ring[r])

    # The composite MB right of donor row r decodes after that row (it is
    # the above-right neighbour of row r+1 only), so fill it per row.
    def _post_row(r):
        if r < rows - 1:
            _fill(cols + 1, 1 + r, right_ring[r])

    decode_p_slice_mv_field(donor_grid, cols, rows, field=field,
                            origin=(1, 1), post_row=_post_row)

    m = rows * cols
    roles = [tuple(np.zeros(m, np.int32) for _ in range(3))
             for _ in range(3)]
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            by, bx = (1 + r) * 4, (1 + c) * 4
            for (dst_r, dst_x, dst_y), (yy, xx) in zip(
                    roles, ((by, bx + 3), (by + 3, bx), (by + 3, bx + 3))):
                dst_r[i] = field.ref[yy, xx]
                dst_x[i] = field.mvx[yy, xx]
                dst_y[i] = field.mvy[yy, xx]
    return tuple(roles)


def prepare_donor_dense(donor_grid: list, num_ref_idx_l0: int,
                        donor_ref_map: tuple = (0,), *,
                        rect_at_left_edge: bool = False,
                        rect_at_top_edge: bool = False,
                        rect_at_right_edge: bool = False,
                        left_ring=None, top_ring=None, right_ring=None
                        ) -> DonorDense:
    """Python engine: a parsed donor grid -> dense per-MB chunk arrays,
    with coeff_tokens resolved against the composite-geometry nC."""
    rows, cols = len(donor_grid), len(donor_grid[0])
    m_total = rows * cols
    if donor_ref_map[0] != 0 and any(
            mb is mbt.SKIP for row in donor_grid for mb in row):
        raise NotImplementedError(
            "donor_ref_map[0] != 0 with donor P_Skips: skips keep "
            "composite ref 0 — use the native engine with retarget_mvs")
    ds = prepare_donor_symbols(donor_grid, num_ref_idx_l0, donor_ref_map)
    luma_nc = _host_luma_nc(ds.luma_tc.reshape(rows, cols, 16),
                            rect_at_left_edge, rect_at_top_edge
                            ).reshape(m_total, 16)
    chroma_nc = _host_chroma_nc(ds.chroma_tc.reshape(rows, cols, 2, 4),
                                rect_at_left_edge, rect_at_top_edge
                                ).reshape(m_total, 8)
    pat_tab, len_tab = token_tables()

    fused = []
    tail_chunks = ds.tail_patterns.shape[2]
    for m in range(m_total):
        f = _ChunkFuser()
        if ds.coded[m]:
            for k in range(PRE_SLOTS):
                n = int(ds.pre_nbits[m, k])
                if n == 0 and int(ds.pre_patterns[m, k]) == 0:
                    break                   # pre slots fill front to back
                f.put(int(ds.pre_patterns[m, k]), n)
            for pos in range(N_BLOCKS):
                if ds.tok_present[m, pos]:
                    bid = int(ds.tok_block_id[m, pos])
                    if bid in (17, 18):
                        cls = CLASS_CHROMA
                    else:
                        nc = (chroma_nc[m, bid - 19] if bid >= 19
                              else luma_nc[m, 0 if bid == 0 else bid - 1])
                        cls = (CLASS_NC0 if nc < 2 else CLASS_NC2 if nc < 4
                               else CLASS_NC4 if nc < 8 else CLASS_FLC)
                    tc = int(ds.tok_tc[m, pos])
                    t1 = int(ds.tok_t1[m, pos])
                    f.put(int(pat_tab[cls, tc, t1]),
                          int(len_tab[cls, tc, t1]))
                elif not ds.ipcm[m]:
                    continue
                for k in range(tail_chunks):
                    n = int(ds.tail_nbits[m, pos, k])
                    if n == 0:
                        break
                    f.put(int(ds.tail_patterns[m, pos, k]), n)
        f.flush()
        fused.append(f.chunks)

    need = max((len(ch) for ch in fused), default=1)
    s_class = next((s for s in MB_CHUNK_CLASSES if need <= s),
                   MB_CHUNK_CLASSES[-1])
    if need > s_class:
        raise OverflowError(
            f"donor MB needs {need} chunk slots > max class {s_class}")
    patterns = np.zeros((m_total, s_class), np.uint32)
    nbits = np.zeros((m_total, s_class), np.int32)
    donor_bits = 0
    has_align = False
    for m, chunks in enumerate(fused):
        for k, (p, n) in enumerate(chunks):
            patterns[m, k] = p
            nbits[m, k] = n
            if n == ALIGN_SENTINEL:
                has_align = True
                donor_bits += 7
            else:
                donor_bits += n

    # Edge motion is decoded over the composite-mapped grid (refs
    # re-targeted, intra retyped), else role refs would be donor-local.
    mapped = [[mb if mb is mbt.SKIP else
               _map_donor_refs(mbt.retype_for_p(mb), donor_ref_map,
                               num_ref_idx_l0)
               for mb in row] for row in donor_grid]
    a, b, d = donor_edge_motion(
        mapped, left_ring=left_ring, top_ring=top_ring,
        right_ring=right_ring, rect_at_left_edge=rect_at_left_edge,
        rect_at_top_edge=rect_at_top_edge,
        rect_at_right_edge=rect_at_right_edge)
    return DonorDense(patterns, nbits, np.asarray(ds.coded), *a, *b, *d,
                      donor_bits, has_align)


def _default_rings(R: int, C: int, rect_at_left_edge: bool,
                   rect_at_top_edge: bool, rect_at_right_edge: bool):
    """Static-background rings: P_Skip (0, 0, 0) cells, None past the
    frame's edges."""
    top = [None if rect_at_top_edge else (0, 0, 0) for _ in range(C + 2)]
    if rect_at_left_edge:
        top[0] = None
    if rect_at_right_edge:
        top[-1] = None
    left = [None if rect_at_left_edge else (0, 0, 0) for _ in range(R)]
    right = [None if rect_at_right_edge else (0, 0, 0)
             for _ in range(R - 1)]
    return left, top, right


def _check_engine(engine: str) -> None:
    if engine not in ("native", "python"):
        raise ValueError(f"engine must be 'native' or 'python', not "
                         f"{engine!r}")


def prepare_donor_dense_from_slice(rbsp: bytes, start_bit: int, C: int,
                                   R: int, donor_num_refs: int,
                                   num_ref_idx_l0: int,
                                   donor_ref_map: tuple = (0,), *,
                                   rect_at_left_edge: bool = False,
                                   rect_at_top_edge: bool = False,
                                   rect_at_right_edge: bool = False,
                                   left_ring=None, top_ring=None,
                                   right_ring=None,
                                   engine: str = "native",
                                   retarget_mvs: bool = False) -> DonorDense:
    """Donor P-slice payload bytes -> DonorDense.

    engine "native" runs parse, composite-nC token resolution, chunk
    fusing and the composite MV edge decode in the C++ engine (built on
    first use; raises if it cannot be built).  "python" parses with
    models/mb_transcode and goes through prepare_donor_dense.
    `retarget_mvs` (successive donors: rewrite mvds so the donor's decoded
    motion survives the composite context) needs the native engine."""
    _check_engine(engine)
    dl, dt, drr = _default_rings(R, C, rect_at_left_edge, rect_at_top_edge,
                                 rect_at_right_edge)
    left_ring = dl if left_ring is None else left_ring
    top_ring = dt if top_ring is None else top_ring
    right_ring = drr if right_ring is None else right_ring

    if engine == "native":
        from .. import native_bridge as nb
        recs, _ = nb.parse_slice_raw(rbsp, start_bit, C, R, True,
                                     donor_num_refs)
        if retarget_mvs:
            nb.retarget_recs_raw(recs, C, R, num_ref_idx_l0, donor_ref_map,
                                 left_ring, top_ring, right_ring)
        patterns, nbits, coded, donor_bits, has_align = nb.prepare_dense_raw(
            recs, C, R, rbsp, num_ref_idx_l0, donor_ref_map,
            rect_at_left_edge, rect_at_top_edge)
        roles = nb.mv_edge_roles_raw(recs, C, R, num_ref_idx_l0,
                                     donor_ref_map, left_ring, top_ring,
                                     right_ring)
        return DonorDense(patterns, nbits, coded,
                          *(r[:, k].copy() for r in roles for k in range(3)),
                          donor_bits, has_align)

    if retarget_mvs:
        raise NotImplementedError("retarget_mvs needs engine='native'")
    from ..ops.bitio import BitReader
    br = BitReader(rbsp)
    br.skip_bits(start_bit)
    grid = mbt.parse_p_slice_mbs(br, C, R, donor_num_refs)
    return prepare_donor_dense(
        grid, num_ref_idx_l0, donor_ref_map,
        rect_at_left_edge=rect_at_left_edge,
        rect_at_top_edge=rect_at_top_edge,
        rect_at_right_edge=rect_at_right_edge,
        left_ring=left_ring, top_ring=top_ring, right_ring=right_ring)


def rings_from_bg(bg_ref, bg_mvx, bg_mvy, rect_mb_x: int, rect_mb_y: int,
                  R: int, C: int):
    """The donor-decode border rings from [H, W] MB-level background
    fields (skip cells holding their decode-true derived values); cells
    past the frame's edges become None."""
    H, W = bg_ref.shape
    r0, c0 = rect_mb_y, rect_mb_x

    def cell(r, c):
        if r < 0 or c < 0 or r >= H or c >= W:
            return None
        return (int(bg_ref[r, c]), int(bg_mvx[r, c]), int(bg_mvy[r, c]))

    top = [cell(r0 - 1, c) for c in range(c0 - 1, c0 + C + 1)]
    left = [cell(r, c0 - 1) for r in range(r0, r0 + R)]
    right = [cell(r, c0 + C) for r in range(r0, r0 + R - 1)]
    return left, top, right


def splice_rbsp_budget(cfg: ComposerConfig, m_donor: int, donor_bits: int,
                       *, quantum: int = 8192,
                       bg_bits_per_mb: int | None = None) -> int:
    """RBSP byte budget of a spliced frame: background MBs at the
    per-MB budget + the donor's exact payload bits + per-donor-MB
    skip-run slack, rounded up to `quantum` bytes.  Overflow is detected,
    never truncated."""
    bg_bits = (cfg.total_mbs - m_donor) * (bg_bits_per_mb
                                           or cfg.rbsp_bits_per_mb)
    total = (bg_bits + donor_bits + m_donor * 32 + 2048) // 8
    return (total + quantum - 1) // quantum * quantum


def splice_rows_rbsp_budget(cfg: ComposerConfig, m_donor: int, rows: int,
                            donor_bits: int, *,
                            bg_bits_per_mb: int | None = None,
                            static_bg: bool = False,
                            quantum: int = 2048) -> int:
    """RBSP byte budget for the row-contiguous layout: one dynamic
    skip-run slot per rect row (rows*32 bits of slack), a finer quantum,
    and no background allowance for the bg_static_skip program."""
    bg_bits = 0 if static_bg else (cfg.total_mbs - m_donor) * (
        bg_bits_per_mb or cfg.rbsp_bits_per_mb)
    total = (bg_bits + donor_bits + rows * 32 + 2048) // 8
    return (total + quantum - 1) // quantum * quantum


def prepare_donor_rows_wire(payloads, start_bits, R: int, C: int,
                            donor_num_refs: int, num_ref_idx_l0: int,
                            donor_ref_map: tuple = (0,), *,
                            s_row: int,
                            rect_at_left_edge: bool = False,
                            rect_at_top_edge: bool = False,
                            rect_at_right_edge: bool = False,
                            left_ring=None, top_ring=None, right_ring=None,
                            rings_per_donor: bool = False,
                            n_threads: int = 0,
                            retarget_mvs: bool = False,
                            flat_wire: bool = False,
                            blob_wire: bool = False,
                            s_flat: int | None = None,
                            s_exc: int | None = None,
                            engine: str = "native"):
    """prepare_donor_rows_serving up to the device transfer: (wire dict of
    numpy arrays with a leading donor axis, (donor_bits i64[N],
    has_align bool[N]))."""
    _check_engine(engine)
    edges = dict(rect_at_left_edge=rect_at_left_edge,
                 rect_at_top_edge=rect_at_top_edge,
                 rect_at_right_edge=rect_at_right_edge)
    rings = dict(left_ring=left_ring, top_ring=top_ring,
                 right_ring=right_ring)
    if engine == "native":
        from .. import native_bridge as nb
        native_kw = dict(at_left_edge=rect_at_left_edge,
                         at_top_edge=rect_at_top_edge,
                         at_right_edge=rect_at_right_edge,
                         rings_per_donor=rings_per_donor,
                         n_threads=n_threads, retarget_mvs=retarget_mvs,
                         **rings)
        if blob_wire and s_flat is not None and s_exc is not None:
            # The whole wire record is compacted in C.
            blob, donor_bits, has_align = nb.prepare_rows_blob_batch(
                payloads, start_bits, R, C, donor_num_refs, num_ref_idx_l0,
                donor_ref_map, s_row, s_flat, s_exc, **native_kw)
            return {"blob": blob}, (donor_bits, has_align)
        out = nb.prepare_rows_batch(
            payloads, start_bits, R, C, donor_num_refs, num_ref_idx_l0,
            donor_ref_map, s_row, **native_kw)
    else:
        if retarget_mvs or rings_per_donor:
            raise NotImplementedError(
                "retarget_mvs / rings_per_donor need engine='native'")
        drs = []
        for payload, sb in zip(payloads, start_bits):
            dd = prepare_donor_dense_from_slice(
                payload, sb, C, R, donor_num_refs, num_ref_idx_l0,
                donor_ref_map, engine="python", **edges, **rings)
            dr = pack_donor_rows(dd, R, C, min_class=s_row)
            if dr.row_patterns.shape[1] != s_row:
                raise OverflowError(
                    f"donor needs {dr.row_patterns.shape[1]} row slots, "
                    f"class is {s_row}")
            drs.append(dr)
        out = {f: np.stack([getattr(d, f) for d in drs])
               for f in ("row_patterns", "row_nbits", "first_c", "coded",
                         *ROLE_FIELDS)}
        out["donor_bits"] = np.asarray([d.donor_bits for d in drs])
        out["has_align"] = np.asarray([d.has_align for d in drs])

    meta = (out.pop("donor_bits"), out.pop("has_align"))
    roles = {k: out.pop(k) for k in ROLE_FIELDS}
    host = {}
    if flat_wire or blob_wire:
        fw, s_flat, s_exc = rows_flat_wire(out.pop("row_patterns"),
                                           out.pop("row_nbits"),
                                           s_flat=s_flat, s_exc=s_exc)
        host.update(fw)
    for k, v in out.items():
        host[k] = v.astype(np.int8) if k == "row_nbits" else v
    edge = _edge_roles_wire(roles, R, C)
    _check_roles_fit_int16(edge)
    for k, v in edge.items():
        host[k] = np.ascontiguousarray(v).astype(np.int16)
    host["first_c"] = np.asarray(host["first_c"], np.int32)
    if blob_wire:
        return {"blob": pack_rows_blob(host, R, C, s_flat, s_exc)}, meta
    return host, meta


def prepare_donor_rows_serving(payloads, start_bits, R: int, C: int,
                               donor_num_refs: int, num_ref_idx_l0: int,
                               donor_ref_map: tuple = (0,), *,
                               s_row: int, device="cuda", **kw):
    """Serving ingest for a batch of fresh donor payloads -> (dn, meta).

    Each payload is parsed, its tokens resolved against the composite nC,
    its rows packed at the pinned `s_row` class and its composite MV edge
    roles decoded (one threaded native call with engine="native", the
    default; engine="python" runs the Python engine per donor).  `dn` is
    a dict of tensors on `device` with a leading donor axis — the donor
    input of make_batched_splice_step_rows, so each session can carry a
    different donor.  meta = (donor_bits i64[N], has_align bool[N]).
    Keyword options: those of prepare_donor_rows_wire (edges, rings,
    flat_wire, blob_wire, s_flat, s_exc, retarget_mvs, engine ...)."""
    host, meta = prepare_donor_rows_wire(
        payloads, start_bits, R, C, donor_num_refs, num_ref_idx_l0,
        donor_ref_map, s_row=s_row, **kw)
    return donor_arrays_from_numpy(host, device), meta


# ===========================================================================
# Device half (torch, leading session dimension).
# ===========================================================================

def edge_roles_to_full(dn: dict, R: int, C: int) -> dict:
    """Full-rect [B, R*C] role tensors from the edge vectors (zeros at
    interior positions, whose predictions are never read)."""
    lead = dn["edge_a_ref"].shape[:-1]
    zero = torch.zeros(lead + (R, C), dtype=torch.int64,
                       device=dn["edge_a_ref"].device)

    def grid(right=None, left=None, bottom=None):
        g = zero.clone()
        if right is not None:
            g[..., :, C - 1] = right.to(torch.int64)
        if left is not None:
            g[..., :, 0] = left.to(torch.int64)
        if bottom is not None:
            g[..., R - 1, :] = bottom.to(torch.int64)
        return g.reshape(lead + (R * C,))

    out = {}
    for f in ("ref", "mvx", "mvy"):
        out["a_" + f] = grid(right=dn["edge_a_" + f])
        out["b_" + f] = grid(left=dn["edge_lb_" + f],
                             bottom=dn["edge_bb_" + f])
        out["d_" + f] = grid(right=dn["edge_d_" + f],
                             bottom=dn["edge_db_" + f])
    return out


def _unblob(blob, R: int, C: int, s_flat: int, s_exc: int) -> dict:
    """Device inverse of pack_rows_blob over blob[B, stride] (int64
    tensor of uint32 values): int64 fields, bool coded."""
    layout, stride = flat_wire_layout(R, C, s_flat, s_exc)
    if blob.shape[-1] != stride:
        raise ValueError(f"blob stride {blob.shape[-1]} != layout {stride}")
    blob = blob.to(torch.int64) & U32
    lead = blob.shape[:-1]
    dev = blob.device
    out = {}
    for name, kind, count, off in layout:
        w = blob[..., off: off - (-count // _PER_WORD[kind])]
        if kind == "u32":
            out[name] = w
            continue
        if kind == "i32":
            out[name] = torch.where(w >= 1 << 31, w - (1 << 32), w)
            continue
        bits = 32 // _PER_WORD[kind]
        shifts = torch.arange(0, 32, bits, device=dev)
        v = ((w[..., None] >> shifts) & ((1 << bits) - 1))
        v = v.reshape(lead + (-1,))[..., :count]
        if kind == "u1":
            v = v.to(torch.bool)
        elif kind in ("i16", "i8"):
            sign = 1 << (bits - 1)
            v = (v ^ sign) - sign
        out[name] = v
    return out


def _rows_from_flat(dn: dict, R: int, s_row: int):
    """Device inverse of rows_flat_wire: flat wire [B, ...] -> ([B, R,
    s_row] patterns, nbits), exact.  On a GPU this is a gather of each
    row's chunks from its start in the flat stream; nbits are 32 inside a
    row, the row's tail width on its last chunk, and the sparse
    exceptions scattered on top."""
    flat_p = dn["flat_patterns"].to(torch.int64)
    B, S = flat_p.shape
    dev = flat_p.device
    row_len = dn["row_len"].to(torch.int64)
    row_tail = dn["row_tail"].to(torch.int64)
    row_start = torch.cumsum(row_len, dim=1) - row_len

    j = torch.arange(s_row, device=dev)
    in_row = j[None, None, :] < row_len[:, :, None]
    src = (row_start[:, :, None] + j).clamp(max=max(S - 1, 0))
    pat = torch.gather(flat_p, 1, src.reshape(B, -1)).reshape(B, R, s_row)
    pat = torch.where(in_row, pat, 0)

    nbits = torch.where(in_row, 32, 0)
    nbits = torch.where(in_row & (j == row_len[:, :, None] - 1),
                        row_tail[:, :, None], nbits)
    # Each flat exception index -> (row, col): row = #starts <= i beyond
    # the first, col = i - row_start[row]; -1 pads drop.
    exc_idx = dn["exc_idx"].to(torch.int64)
    e_row = (exc_idx[:, :, None] >= row_start[:, None, 1:]).sum(dim=2)
    e_col = exc_idx - torch.gather(row_start, 1, e_row)
    P = R * s_row
    e_flat = e_row * s_row + e_col
    e_flat = torch.where((exc_idx >= 0) & (e_flat >= 0) & (e_flat < P),
                         e_flat, P)
    nb = torch.cat([nbits.reshape(B, P),
                    torch.zeros((B, 1), dtype=torch.int64, device=dev)], 1)
    nb.scatter_(1, e_flat, dn["exc_val"].to(torch.int64))
    return pat, nb[:, :P].reshape(B, R, s_row)


def _rect_mask(H, W, r0, c0, R, C, device):
    m = torch.zeros((H, W), dtype=torch.bool, device=device)
    m[r0:r0 + R, c0:c0 + C] = True
    return m


def _dense_prologue(cfg, r0, c0, R, C, num_refs,
                    bg_ref, bg_mv_x, bg_mv_y, bg_coded, dn):
    """Composite-grid stage: role scatter, exact MV prediction, composite
    skip runs and the background symbol slots, over [B, H, W] grids.
    Donor fields may arrive in compact wire dtypes; all math is int64."""
    H, W = cfg.mb_height, cfg.mb_width
    B = bg_ref.shape[0]
    dev = bg_ref.device
    bg_ref, bg_mv_x, bg_mv_y = (g.to(torch.int64)
                                for g in (bg_ref, bg_mv_x, bg_mv_y))
    bg_coded = bg_coded.to(torch.bool)
    donor_coded = dn["coded"].to(torch.bool).reshape(B, R, C)
    in_rect = _rect_mask(H, W, r0, c0, R, C, dev)

    def scatter(bg, vals):
        g = bg.clone()
        g[:, r0:r0 + R, c0:c0 + C] = vals.to(torch.int64).reshape(B, R, C)
        return g

    refA, mvxA, mvyA = (scatter(g, dn[k]) for g, k in (
        (bg_ref, "a_ref"), (bg_mv_x, "a_mvx"), (bg_mv_y, "a_mvy")))
    refB, mvxB, mvyB = (scatter(g, dn[k]) for g, k in (
        (bg_ref, "b_ref"), (bg_mv_x, "b_mvx"), (bg_mv_y, "b_mvy")))
    refD, mvxD, mvyD = (scatter(g, dn[k]) for g, k in (
        (bg_ref, "d_ref"), (bg_mv_x, "d_mvx"), (bg_mv_y, "d_mvy")))

    coded = bg_coded & ~in_rect
    coded[:, r0:r0 + R, c0:c0 + C] = donor_coded

    pred_x, pred_y = scroll_model.mv_pred_grid_roles(
        refA, refA, mvxA, mvyA, refB, mvxB, mvyB, refD, mvxD, mvyD)
    mvd_x = bg_mv_x - pred_x
    mvd_y = bg_mv_y - pred_y

    # Composite skip runs.  The merged A slot (skip_run||mb_type||ref)
    # fits 32 bits only up to 4,095 MBs; larger frames use the wide
    # layout with the skip run in its own slot.
    n_mbs = H * W
    wide = n_mbs > 4095
    if n_mbs > 65535:
        raise ValueError(f"splice: {n_mbs} MBs > 65535 — ue(skip_run) "
                         "would exceed 32 bits; use slice bands")
    coded_f = coded.reshape(B, n_mbs)
    idx = torch.arange(n_mbs, device=dev).expand(B, n_mbs)
    last_incl = torch.cummax(torch.where(coded_f, idx, -1), dim=1).values
    last_before = torch.cat([torch.full_like(last_incl[:, :1], -1),
                             last_incl[:, :-1]], dim=1)
    sr_pat, sr_n = expgolomb.ue(idx - last_before - 1)

    zeros = torch.zeros((B, n_mbs), dtype=torch.int64, device=dev)
    mbt_pat, mbt_n = expgolomb.ue(zeros)
    ref_pat, ref_n = expgolomb.te(bg_ref.reshape(B, n_mbs), num_refs)
    mvx_pat, mvx_n = expgolomb.se(mvd_x.reshape(B, n_mbs))
    mvy_pat, mvy_n = expgolomb.se(mvd_y.reshape(B, n_mbs))
    cbp_pat, cbp_n = expgolomb.ue(zeros)
    merge = bitpack.merge_symbol_pairs
    if wide:
        a_pat, a_n = merge(mbt_pat, mbt_n, ref_pat, ref_n)
    else:
        a_pat, a_n = merge(sr_pat, sr_n, mbt_pat, mbt_n)
        a_pat, a_n = merge(a_pat, a_n, ref_pat, ref_n)
    c_pat, c_n = merge(mvy_pat, mvy_n, cbp_pat, cbp_n)

    return {
        "a_pat": a_pat, "a_n": a_n,
        "mvx_pat": mvx_pat, "mvx_n": mvx_n,
        "c_pat": c_pat, "c_n": c_n,
        "bg_active": coded_f & ~in_rect.reshape(1, n_mbs),
        "sr_pat": sr_pat, "sr_n": sr_n,
        "coded_f": coded_f, "last_incl": last_incl,
        "donor_coded": donor_coded,
        "wide": wide,
    }


def _bg3(pro, H, W):
    """Generic background symbol grids [B, H, W, S_bg] (S_bg = 3, or 4 in
    the wide layout, whose skip run has its own slot)."""
    active = pro["bg_active"]
    cols = [(pro["a_pat"], pro["a_n"]), (pro["mvx_pat"], pro["mvx_n"]),
            (pro["c_pat"], pro["c_n"])]
    if pro["wide"]:
        cols = [(pro["sr_pat"], pro["sr_n"])] + cols
    B = active.shape[0]
    bg_p = torch.stack([torch.where(active, p, 0) for p, _ in cols], dim=2)
    bg_n = torch.stack([torch.where(active, n, 0) for _, n in cols], dim=2)
    return bg_p.reshape(B, H, W, len(cols)), bg_n.reshape(B, H, W, len(cols))


def _compact_bg_rows(pat, nb, budget: int):
    """Per-row stable compaction of nonzero-width symbol lanes into at
    most `budget` lanes: pat/nb [B, rows, width] -> (pat, nb [B, rows,
    bud], overflowed bool[B]) with bud = min(budget, width).  A cumsum
    gives each live lane its destination and one scatter moves it; lanes
    past the budget drop, and their rows flag the session (the generic
    program is the retry).  Dropping zero-width lanes never changes the
    packed bits."""
    B, rows, width = pat.shape
    bud = min(budget, width)
    if width <= bud or rows == 0:
        return pat, nb, torch.zeros(B, dtype=torch.bool, device=pat.device)
    live = nb != 0
    dest = torch.cumsum(live.to(torch.int64), dim=2) - 1
    over = (dest[:, :, -1] + 1 > bud).any(dim=1)
    dest = torch.where(live & (dest < bud), dest, bud)
    out_p = pat.new_zeros((B, rows, bud + 1))
    out_n = nb.new_zeros((B, rows, bud + 1))
    out_p.scatter_(2, dest, torch.where(live, pat, 0))
    out_n.scatter_(2, dest, torch.where(live, nb, 0))
    return out_p[:, :, :bud], out_n[:, :, :bud], over


def _donor_rows(dn, R, C, s_row, s_flat, s_exc):
    """Decode the donor wire (padded rows, flat or blob) into int64 row
    chunks [B, R, s_row] plus the other fields."""
    dn = dict(dn)
    if "blob" in dn:
        if None in (s_row, s_flat, s_exc):
            raise ValueError("the blob wire needs static s_row, s_flat and "
                             "s_exc")
        dn = _unblob(dn["blob"], R, C, s_flat, s_exc)
    if "flat_patterns" in dn:
        if s_row is None:
            raise ValueError("the flat donor wire needs a static s_row")
        dn["row_patterns"], dn["row_nbits"] = _rows_from_flat(dn, R, s_row)
    dn["row_patterns"] = dn["row_patterns"].to(torch.int64) & U32
    dn["row_nbits"] = dn["row_nbits"].to(torch.int64)
    dn["first_c"] = dn["first_c"].to(torch.int64)
    return dn


def rows_splice_symbols(cfg: ComposerConfig, rect_mb_x: int,
                        rect_mb_y: int, R: int, C: int, num_refs,
                        header_patterns, header_nbits,
                        bg_ref, bg_mv_x, bg_mv_y, bg_coded,
                        dn: dict, *,
                        donor_bits: int | None = None,
                        n_rbsp: int | None = None,
                        compact_x: bool = False,
                        s_row: int | None = None,
                        s_flat: int | None = None,
                        s_exc: int | None = None,
                        bg_static_skip: bool = False,
                        bg_budget: int | None = None):
    """Symbol layout of the rows splice for a batch of sessions: returns
    (patterns int64[B, n], nbits int64[B, n], n_rbsp) for _finish_splice.

    Per session: header symbols [B, nh]; background fields [B, H, W]
    (ref, mv qpel, coded); the donor wire `dn` with a leading [B] axis —
    padded rows (rows_wire), flat (rows_flat_wire: needs s_row) or blob
    (pack_rows_blob: needs s_row, s_flat, s_exc).  Each rect row carries
    one dynamic skip-run slot (the run before its first coded donor MB,
    gathered at rect column first_c) followed by its fused chunk stream.

    Modes: `compact_x` packs background MBs into 2 slots (valid when
    every background mv_x is zero; the donor-adjacent ring keeps 3);
    `bg_budget` = L also compacts each background row segment to L lanes
    (rows over L flag overflow through a 1 << 22 trailing-bit sentinel);
    `bg_static_skip` is the static-chrome program (every background MB
    P_Skip with zero motion: no background symbols at all).  Frames over
    4,095 MBs use the wide background layout.  `donor_bits` sizes the
    default budget when n_rbsp is None."""
    H, W = cfg.mb_height, cfg.mb_width
    r0, c0 = rect_mb_y, rect_mb_x
    if r0 + R > H or c0 + C > W:
        raise ValueError("the donor rect does not fit the frame")
    M = R * C
    dn = _donor_rows(dn, R, C, s_row, s_flat, s_exc)
    hp = header_patterns.to(torch.int64)
    hn = header_nbits.to(torch.int64)
    B = hp.shape[0]
    dev = hp.device
    n_mbs = H * W
    first_c = dn["first_c"]
    valid = first_c >= 0
    row_flat0 = (r0 + torch.arange(R, device=dev)) * W + c0

    if bg_static_skip:
        # Static chrome: the caller guarantees an all-skip, zero-motion
        # background, so only the donor rows emit symbols and the skip
        # runs reduce to R-lane arithmetic over the donor coded mask.
        coded = dn["coded"].to(torch.bool).reshape(B, R, C)
        cols = torch.arange(C, device=dev)
        last_c = torch.where(coded, cols, -1).max(dim=2).values
        first_flat = row_flat0 + first_c.clamp(min=0)
        last_flat = torch.where(last_c >= 0, row_flat0 + last_c, -1)
        run_max = torch.cummax(last_flat, dim=1).values
        prev_flat = torch.cat([torch.full_like(run_max[:, :1], -1),
                               run_max[:, :-1]], dim=1)
        sr_pat, sr_n = expgolomb.ue((first_flat - prev_flat - 1).clamp(min=0))
        dyn_p = torch.where(valid, sr_pat, 0)[:, :, None]
        dyn_n = torch.where(valid, sr_n, 0)[:, :, None]
        ts_pat, ts_n = _tail_skips(n_mbs, run_max[:, -1])
        patterns = torch.cat(
            [hp, torch.cat([dyn_p, dn["row_patterns"]], 2).flatten(1),
             ts_pat[:, None]], dim=1)
        nbits = torch.cat(
            [hn, torch.cat([dyn_n, dn["row_nbits"]], 2).flatten(1),
             ts_n[:, None]], dim=1)
        if n_rbsp is None:
            if donor_bits is None:
                donor_bits = R * dn["row_patterns"].shape[2] * 32
            n_rbsp = splice_rows_rbsp_budget(cfg, M, R, donor_bits,
                                             static_bg=True)
        return patterns, nbits, n_rbsp

    if "edge_a_ref" in dn:
        dn.update(edge_roles_to_full(dn, R, C))
    pro = _dense_prologue(cfg, r0, c0, R, C, num_refs,
                          bg_ref, bg_mv_x, bg_mv_y, bg_coded, dn)
    bg_p, bg_n = _bg3(pro, H, W)

    # Dynamic first-run slots: the composite skip run at each row's first
    # coded donor MB.
    flat_idx = row_flat0 + first_c.clamp(min=0)
    dyn_p = torch.where(valid, torch.gather(pro["sr_pat"], 1, flat_idx),
                        0)[:, :, None]
    dyn_n = torch.where(valid, torch.gather(pro["sr_n"], 1, flat_idx),
                        0)[:, :, None]
    ts_pat, ts_n = _tail_skips(n_mbs, pro["last_incl"][:, -1])
    rows_p, rows_n = dn["row_patterns"], dn["row_nbits"]

    def flat(x):
        return x.flatten(1)

    if not compact_x:
        def rect_rows(bg, dyn, rows):
            return flat(torch.cat([bg[:, r0:r0 + R, :c0].flatten(2), dyn,
                                   rows, bg[:, r0:r0 + R, c0 + C:].flatten(2)],
                                  dim=2))

        patterns = torch.cat(
            [hp, flat(bg_p[:, :r0]), rect_rows(bg_p, dyn_p, rows_p),
             flat(bg_p[:, r0 + R:]), ts_pat[:, None]], dim=1)
        nbits = torch.cat(
            [hn, flat(bg_n[:, :r0]), rect_rows(bg_n, dyn_n, rows_n),
             flat(bg_n[:, r0 + R:]), ts_n[:, None]], dim=1)
    else:
        if pro["wide"]:
            raise ValueError("compact_x needs <= 4095 MBs (the merged "
                             "skip-run slot); use compact_x=False")
        # Compact background: 2 slots per MB (A||mvd_x, mvd_y||cbp),
        # except the "wide" ring whose prediction sees donor neighbours
        # (the column right of the rect, the column left of it below the
        # rect's top row, the row under it): it keeps the 3-slot form.
        active = pro["bg_active"]
        a2_pat, a2_n = bitpack.merge_symbol_pairs(
            pro["a_pat"], pro["a_n"], pro["mvx_pat"], pro["mvx_n"])
        bg2_p = torch.stack([torch.where(active, a2_pat, 0),
                             torch.where(active, pro["c_pat"], 0)],
                            dim=2).reshape(B, H, W, 2)
        bg2_n = torch.stack([torch.where(active, a2_n, 0),
                             torch.where(active, pro["c_n"], 0)],
                            dim=2).reshape(B, H, W, 2)
        overs = []

        def seg(rows, cols):
            """Compact-form background segment [B, rows, 2 * cols]."""
            p = bg2_p[:, rows, cols].flatten(2)
            n = bg2_n[:, rows, cols].flatten(2)
            if bg_budget is None:
                return p, n
            p, n, ov = _compact_bg_rows(p, n, bg_budget)
            overs.append(ov)
            return p, n

        have_left = c0 >= 1
        have_right = c0 + C < W
        segs_p, segs_n = [hp], [hn]

        def add(p, n):
            segs_p.append(flat(p))
            segs_n.append(flat(n))

        add(*seg(slice(0, r0), slice(None)))
        # Rect row r0 (no left wide column: its above-right is background).
        row = slice(r0, r0 + 1)
        add(*seg(row, slice(0, c0)))
        add(dyn_p[:, 0], dyn_n[:, 0])
        add(rows_p[:, 0], rows_n[:, 0])
        if have_right:
            add(bg_p[:, r0, c0 + C], bg_n[:, r0, c0 + C])
        add(*seg(row, slice(c0 + C + 1, None)))
        # Rect rows r0+1 .. r0+R-1, where the left wide column appears.
        if R > 1:
            rs = slice(r0 + 1, r0 + R)
            lc = c0 - 1 if have_left else 0
            parts = [seg(rs, slice(0, lc))]
            if have_left:
                parts.append((bg_p[:, rs, c0 - 1], bg_n[:, rs, c0 - 1]))
            parts += [(dyn_p[:, 1:], dyn_n[:, 1:]),
                      (rows_p[:, 1:], rows_n[:, 1:])]
            if have_right:
                parts.append((bg_p[:, rs, c0 + C], bg_n[:, rs, c0 + C]))
            parts.append(seg(rs, slice(c0 + C + 1, None)))
            add(torch.cat([p for p, _ in parts], dim=2),
                torch.cat([n for _, n in parts], dim=2))
        # Row under the rect: wide across the rect's footprint.
        if r0 + R < H:
            row = slice(r0 + R, r0 + R + 1)
            lw = c0 - 1 if have_left else 0
            rw = min(c0 + C, W - 1)
            add(*seg(row, slice(0, lw)))
            add(bg_p[:, r0 + R, lw:rw + 1], bg_n[:, r0 + R, lw:rw + 1])
            add(*seg(row, slice(rw + 1, None)))
        add(*seg(slice(r0 + R + 1, None), slice(None)))
        if overs:
            over = torch.stack(overs).any(dim=0)
            ts_n = ts_n + torch.where(over, 1 << 22, 0)
        patterns = torch.cat(segs_p + [ts_pat[:, None]], dim=1)
        nbits = torch.cat(segs_n + [ts_n[:, None]], dim=1)

    if n_rbsp is None:
        if donor_bits is None:
            donor_bits = R * rows_p.shape[2] * 32
        n_rbsp = splice_rbsp_budget(cfg, M, donor_bits)
    return patterns, nbits, n_rbsp


def _tail_skips(n_mbs: int, last_coded):
    """ue(trailing skip run) after the last coded MB, absent when 0."""
    tail = n_mbs - 1 - last_coded
    pat, n = expgolomb.ue(tail)
    return pat, torch.where(tail > 0, n, 0)


def dense_splice_symbols(cfg: ComposerConfig, rect_mb_x: int,
                         rect_mb_y: int, R: int, C: int, num_refs,
                         header_patterns, header_nbits,
                         bg_ref, bg_mv_x, bg_mv_y, bg_coded,
                         dn: dict, *, n_rbsp: int | None = None):
    """Symbol layout of the dense splice for a batch of sessions: returns
    (patterns int64[B, n], nbits int64[B, n], n_rbsp) for _finish_splice.

    Per session: header symbols [B, nh], background fields [B, H, W] and
    the dense donor arrays `dn` (dense_device_arrays, with a leading [B]
    axis): each donor MB's final bits as S chunks (patterns, nbits), its
    coded flag and its composite edge roles.  The frame's symbols are the
    header, the background slots above the rect, the rect rows (background
    slots left of the rect, each donor MB as [composite skip run | S
    chunks], background slots right of it), the slots below and the tail
    skip run.  The default n_rbsp is the donor chunk class's budget,
    splice_rbsp_budget(cfg, R * C, R * C * S * 32), as in the JAX package;
    serving callers pass the honest one (dd.donor_bits)."""
    H, W = cfg.mb_height, cfg.mb_width
    r0, c0 = rect_mb_y, rect_mb_x
    if r0 + R > H or c0 + C > W:
        raise ValueError("the donor rect does not fit the frame")
    M = R * C
    hp = header_patterns.to(torch.int64)
    hn = header_nbits.to(torch.int64)
    B = hp.shape[0]
    S = dn["patterns"].shape[-1]

    pro = _dense_prologue(cfg, r0, c0, R, C, num_refs,
                          bg_ref, bg_mv_x, bg_mv_y, bg_coded, dn)
    bg_p, bg_n = _bg3(pro, H, W)
    donor_coded = pro["donor_coded"]

    # Donor MB slots: [composite skip run | S dense chunks].
    def rect(x):
        return x.reshape(B, H, W)[:, r0:r0 + R, c0:c0 + C, None]

    sr_p = torch.where(donor_coded[..., None], rect(pro["sr_pat"]), 0)
    sr_n = torch.where(donor_coded[..., None], rect(pro["sr_n"]), 0)
    chunks_p = dn["patterns"].to(torch.int64).reshape(B, R, C, S) & U32
    chunks_n = torch.where(donor_coded[..., None],
                           dn["nbits"].to(torch.int64).reshape(B, R, C, S), 0)
    donor_p = torch.cat([sr_p, chunks_p], dim=3)
    donor_n = torch.cat([sr_n, chunks_n], dim=3)

    def rows(bg, donor):
        """Rect rows in raster order, flattened per session."""
        return torch.cat([bg[:, r0:r0 + R, :c0].flatten(2),
                          donor.flatten(2),
                          bg[:, r0:r0 + R, c0 + C:].flatten(2)],
                         dim=2).flatten(1)

    ts_pat, ts_n = _tail_skips(H * W, pro["last_incl"][:, -1])
    patterns = torch.cat([hp, bg_p[:, :r0].flatten(1), rows(bg_p, donor_p),
                          bg_p[:, r0 + R:].flatten(1), ts_pat[:, None]], dim=1)
    nbits = torch.cat([hn, bg_n[:, :r0].flatten(1), rows(bg_n, donor_n),
                       bg_n[:, r0 + R:].flatten(1), ts_n[:, None]], dim=1)
    if n_rbsp is None:
        n_rbsp = splice_rbsp_budget(cfg, M, M * S * 32)
    return patterns, nbits, n_rbsp


def emit_spliced_frame_dense(cfg: ComposerConfig, rect_mb_x: int,
                             rect_mb_y: int, R: int, C: int, num_refs,
                             header_patterns, header_nbits,
                             bg_ref, bg_mv_x, bg_mv_y, bg_coded,
                             dn: dict, nal_ref_idc=0, *,
                             has_align: bool = False,
                             n_rbsp: int | None = None,
                             ebsp_exact: bool = False):
    """Dense splice of one frame per session: dense_splice_symbols, then
    _finish_splice (K1, or K2 plus exact EBSP for `ebsp_exact`).
    Byte-identical to emit_spliced_frame_rows on the same donor.  Returns
    (nal u8[B, n_nal], nal_len i32[B], rbsp_bits i32[B], overflow
    bool[B])."""
    patterns, nbits, n_rbsp = dense_splice_symbols(
        cfg, rect_mb_x, rect_mb_y, R, C, num_refs, header_patterns,
        header_nbits, bg_ref, bg_mv_x, bg_mv_y, bg_coded, dn, n_rbsp=n_rbsp)
    return _finish_splice(patterns, nbits, n_rbsp, nal_ref_idc,
                          has_align=has_align, ebsp_exact=ebsp_exact)


def _finish_splice(patterns, nbits, n_rbsp: int, nal_ref_idc, *,
                   has_align: bool, ebsp_exact: bool):
    """Back end of the splice: I_PCM alignment, trailing bits, pack,
    emulation prevention, framing — models/scroll.finish_slice (K1, or K2
    plus exact EBSP for the retry)."""
    return scroll_model.finish_slice(patterns, nbits, n_rbsp, nal_ref_idc,
                                     ebsp_exact=ebsp_exact,
                                     has_align=has_align)


def emit_spliced_frame_rows(cfg: ComposerConfig, rect_mb_x: int,
                            rect_mb_y: int, R: int, C: int, num_refs,
                            header_patterns, header_nbits,
                            bg_ref, bg_mv_x, bg_mv_y, bg_coded,
                            dn: dict, nal_ref_idc=0, *,
                            donor_bits: int | None = None,
                            has_align: bool = False,
                            n_rbsp: int | None = None,
                            ebsp_exact: bool = False,
                            compact_x: bool = False,
                            s_row: int | None = None,
                            s_flat: int | None = None,
                            s_exc: int | None = None,
                            bg_static_skip: bool = False,
                            bg_budget: int | None = None):
    """Rows splice of one frame per session: rows_splice_symbols, then
    _finish_splice.  Returns (nal u8[B, n_nal], nal_len i32[B],
    rbsp_bits i32[B], overflow bool[B])."""
    patterns, nbits, n_rbsp = rows_splice_symbols(
        cfg, rect_mb_x, rect_mb_y, R, C, num_refs, header_patterns,
        header_nbits, bg_ref, bg_mv_x, bg_mv_y, bg_coded, dn,
        donor_bits=donor_bits, n_rbsp=n_rbsp, compact_x=compact_x,
        s_row=s_row, s_flat=s_flat, s_exc=s_exc,
        bg_static_skip=bg_static_skip, bg_budget=bg_budget)
    return _finish_splice(patterns, nbits, n_rbsp, nal_ref_idc,
                          has_align=has_align, ebsp_exact=ebsp_exact)
