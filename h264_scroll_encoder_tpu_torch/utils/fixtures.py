"""Synthetic CAVLC stream generation for tests and benchmarks.

Copied unchanged from h264_scroll_encoder_tpu/utils/fixtures.py (it has
no framework dependency), so the port runs where jax is absent.

There is no external encoder (x264/ffmpeg) in this environment, so donor
streams with *real residual data* are synthesized: random but grammar-valid
macroblocks whose residual blocks are produced by our CAVLC encoder
(ops/cavlc.encode_residual_block).  The reference trans_resizer binary then
serves as a differential oracle: it must parse our streams and its output
must match our transcoder's byte-for-byte.

Randomness respects the CAVLC constraints: trailing ones are the trailing
+-1 coefficients (max 3); if fewer than 3, the first non-T1 level has
|level| >= 2; total_zeros <= maxNumCoeff - totalCoeff; runs consistent
with zeros-left.
"""

from __future__ import annotations

import numpy as np

from ..config import ComposerConfig
from ..models import mb_transcode as mbt
from ..ops import cavlc
from ..ops.bitio import BitWriter
from ..syntax.nal import AnnexBWriter
from ..syntax.params import generate_pps, generate_sps
from ..ops.cavlc_tables import CBP_INTER_INV, CBP_INTRA_INV  # noqa: F401


def random_residual_block(rng: np.random.Generator, max_coeff: int,
                          *, density: float = 0.5) -> cavlc.ResidualBlock:
    """Random grammar-valid residual block (possibly empty)."""
    if rng.random() > density:
        return cavlc.EMPTY_BLOCK
    tc = int(rng.integers(1, max_coeff + 1))
    # Trailing ones: how many of the leading (highest-frequency) levels
    # are +-1.
    t1 = int(rng.integers(0, min(3, tc) + 1))
    levels = [int(rng.choice([-1, 1])) for _ in range(t1)]
    for i in range(tc - t1):
        lo = 2 if (i == 0 and t1 < 3) else 1
        mag = int(rng.integers(lo, lo + 40))
        levels.append(mag if rng.random() < 0.5 else -mag)
    total_zeros = int(rng.integers(0, max_coeff - tc + 1))
    runs = []
    zeros_left = total_zeros
    for _ in range(tc - 1):
        if zeros_left <= 0:
            break
        run = int(rng.integers(0, min(zeros_left, 14) + 1))
        runs.append(run)
        zeros_left -= run
    return cavlc.encode_residual_block(levels, total_zeros, runs,
                                       max_coeff, 0)


def _random_chroma(rng, mb, cbp_chroma):
    if cbp_chroma > 0:
        mb.cb_dc = random_residual_block(rng, 4, density=0.8)
        mb.cr_dc = random_residual_block(rng, 4, density=0.8)
        if cbp_chroma == 2:
            mb.chroma_ac = tuple(
                tuple(random_residual_block(rng, 15) for _ in range(4))
                for _ in range(2))


def random_i4x4_mb(rng: np.random.Generator, *,
                   in_p_slice: bool = False,
                   free_intra: bool = True) -> mbt.Macroblock:
    """free_intra=False restricts the MB to always-available prediction
    (prev_intra4x4_pred_mode_flag=1 everywhere + chroma DC), which a
    frame-edge MB needs to stay decoder-conformant: modes such as
    Intra_4x4_Vertical require neighbor samples the frame boundary
    removes (H.264 8.3.1.2), and a real decoder rejects them there."""
    bits = []
    for _ in range(16):
        if not free_intra or rng.random() < 0.5:
            bits.append("1")
        else:
            bits.append("0" + format(int(rng.integers(0, 8)), "03b"))
    cbp = int(rng.choice(list(CBP_INTRA_INV)))
    mb = mbt.Macroblock(kind="i4x4", mb_type=5 if in_p_slice else 0,
                        pred_mode_bits="".join(bits),
                        chroma_pred=(int(rng.integers(0, 4))
                                     if free_intra else 0), cbp=cbp)
    if cbp > 0:
        mb.qp_delta = int(rng.integers(-3, 4))
        luma = [cavlc.EMPTY_BLOCK] * 16
        for i8x8 in range(4):
            if cbp & (1 << i8x8):
                from ..ops.cavlc_tables import SCAN_TO_RASTER
                for i4x4 in range(4):
                    raster = SCAN_TO_RASTER[i8x8 * 4 + i4x4]
                    luma[raster] = random_residual_block(rng, 16)
        mb.luma = tuple(luma)
        _random_chroma(rng, mb, (cbp >> 4) & 0x3)
    return mb


def random_i16x16_mb(rng: np.random.Generator, *,
                     in_p_slice: bool = False,
                     free_intra: bool = True) -> mbt.Macroblock:
    idx = int(rng.integers(0, 24))
    if not free_intra:
        idx = (idx // 4) * 4 + 2     # force Intra_16x16_DC (see i4x4 note)
    cbp_luma = 15 if idx // 12 else 0
    cbp_chroma = (idx // 4) % 3
    mb = mbt.Macroblock(
        kind="i16x16", mb_type=(6 if in_p_slice else 1) + idx, i16_idx=idx,
        chroma_pred=(int(rng.integers(0, 4)) if free_intra else 0),
        cbp=(cbp_chroma << 4) | cbp_luma,
        qp_delta=int(rng.integers(-3, 4)))
    mb.luma_dc = random_residual_block(rng, 16, density=0.9)
    luma = [cavlc.EMPTY_BLOCK] * 16
    if cbp_luma:
        from ..ops.cavlc_tables import SCAN_TO_RASTER
        for s in range(16):
            luma[SCAN_TO_RASTER[s]] = random_residual_block(rng, 15)
    mb.luma = tuple(luma)
    _random_chroma(rng, mb, cbp_chroma)
    return mb


def random_ipcm_mb(rng: np.random.Generator, *,
                   in_p_slice: bool = False) -> mbt.Macroblock:
    samples = rng.integers(0, 256, 384).astype(np.uint8).tobytes()
    return mbt.Macroblock(kind="ipcm", mb_type=30 if in_p_slice else 25,
                          ipcm_samples=samples)


def random_inter_mb(rng: np.random.Generator,
                    num_ref_idx_l0: int) -> mbt.Macroblock:
    mb_type = int(rng.choice([0, 0, 0, 1, 2, 3, 4]))
    if mb_type == 0:
        n_parts, n_refs = 1, 1
    elif mb_type <= 2:
        n_parts, n_refs = 2, 2
    else:
        n_parts, n_refs = 4, 4
    sub_mb_types = ()
    mv_count = n_parts
    if mb_type >= 3:
        sub_mb_types = tuple(int(rng.integers(0, 4)) for _ in range(4))
        mv_count = sum(mbt.SUB_MB_MVS[s] for s in sub_mb_types)
    ref_idx = ()
    if num_ref_idx_l0 > 1 and mb_type != 4:
        ref_idx = tuple(int(rng.integers(0, num_ref_idx_l0))
                        for _ in range(n_refs))
    mvds = tuple((int(rng.integers(-64, 65)), int(rng.integers(-64, 65)))
                 for _ in range(mv_count))
    cbp = int(rng.choice(list(CBP_INTER_INV)))
    mb = mbt.Macroblock(kind="inter", mb_type=mb_type,
                        sub_mb_types=sub_mb_types, ref_idx=ref_idx,
                        mvds=mvds, cbp=cbp)
    if cbp > 0:
        mb.qp_delta = int(rng.integers(-3, 4))
        luma = [cavlc.EMPTY_BLOCK] * 16
        from ..ops.cavlc_tables import SCAN_TO_RASTER
        for i8x8 in range(4):
            if cbp & (1 << i8x8):
                for i4x4 in range(4):
                    raster = SCAN_TO_RASTER[i8x8 * 4 + i4x4]
                    luma[raster] = random_residual_block(rng, 16)
        mb.luma = tuple(luma)
        _random_chroma(rng, mb, (cbp >> 4) & 0x3)
    return mb


def random_i_slice_grid(rng, mb_width, mb_height, *, in_p_slice=False):
    kinds = ["i4x4", "i16x16", "ipcm"]
    grid = []
    for y in range(mb_height):
        row = []
        for x in range(mb_width):
            free = x > 0 and y > 0   # frame-edge MBs: DC-only (conformance)
            k = rng.choice(kinds, p=[0.4, 0.5, 0.1])
            if k == "i4x4":
                row.append(random_i4x4_mb(rng, in_p_slice=in_p_slice,
                                          free_intra=free))
            elif k == "i16x16":
                row.append(random_i16x16_mb(rng, in_p_slice=in_p_slice,
                                            free_intra=free))
            else:
                row.append(random_ipcm_mb(rng, in_p_slice=in_p_slice))
        grid.append(row)
    return grid


def random_p_slice_grid(rng, mb_width, mb_height, num_ref_idx_l0):
    grid = []
    for y in range(mb_height):
        row = []
        for x in range(mb_width):
            free = x > 0 and y > 0   # frame-edge MBs: DC-only (conformance)
            r = rng.random()
            if r < 0.35:
                row.append(mbt.SKIP)
            elif r < 0.85:
                row.append(random_inter_mb(rng, num_ref_idx_l0))
            elif r < 0.93:
                row.append(random_i16x16_mb(rng, in_p_slice=True,
                                            free_intra=free))
            else:
                row.append(random_i4x4_mb(rng, in_p_slice=True,
                                          free_intra=free))
        grid.append(row)
    # The slice must not end all-skip-free ambiguity: grammar handles any mix.
    return grid


def synthetic_cavlc_stream(width: int, height: int, n_p_frames: int = 2,
                           seed: int = 0, num_ref_idx_l0: int = 1,
                           i_grid=None, p_grids=None,
                           bug_compat: bool = False) -> bytes:
    """SPS + PPS + random IDR I-slice + N random P-slices.

    Grammar-valid and (by default) decoder-conformant, though not
    visually meaningful — transcoders never look at pixel semantics.
    i_grid / p_grids (list of grids, cycled over n_p_frames) override the
    random macroblock content — the hook adversarial donor families use.
    bug_compat=True emits I_PCM nC contexts under the C reference's
    zeroed rule (mb_transcode.ipcm_context) so the stream parses in the
    trans_resizer binary for byte-parity tests.
    """
    rng = np.random.default_rng(seed)
    cfg = ComposerConfig(width, height)
    out = AnnexBWriter()
    out.write_nal_unit(
        generate_sps(width, height, level_idc=30,
                     max_num_ref_frames=num_ref_idx_l0), 3, 7)
    out.write_nal_unit(
        generate_pps(num_ref_idx_l0_default_active_minus1=num_ref_idx_l0 - 1),
        3, 8)

    # IDR I-slice.
    bw = BitWriter()
    bw.write_ue(0)           # first_mb_in_slice
    bw.write_ue(7)           # slice_type I_ALL
    bw.write_ue(0)           # pps_id
    bw.write_bits(0, 4)      # frame_num
    bw.write_ue(0)           # idr_pic_id
    bw.write_bit(0)          # no_output_of_prior_pics_flag
    bw.write_bit(0)          # long_term_reference_flag
    bw.write_se(0)           # slice_qp_delta
    bw.write_ue(1)           # disable deblocking
    grid = (i_grid if i_grid is not None
            else random_i_slice_grid(rng, cfg.mb_width, cfg.mb_height))
    mbt.emit_i_slice_mbs(bw, grid, bug_compat=bug_compat)
    bw.write_trailing_bits()
    out.write_nal_unit(bw.getvalue(), 3, 5)

    for n in range(n_p_frames):
        bw = BitWriter()
        bw.write_ue(0)
        bw.write_ue(5)       # slice_type P_ALL
        bw.write_ue(0)
        bw.write_bits(n + 1, 4)
        if num_ref_idx_l0 > 1:
            bw.write_bit(1)
            bw.write_ue(num_ref_idx_l0 - 1)
        else:
            bw.write_bit(0)  # num_ref_idx_active_override_flag
        bw.write_bit(0)      # ref_pic_list_modification_flag_l0
        bw.write_bit(0)      # sliding window (ref picture)
        bw.write_se(0)
        bw.write_ue(1)
        pgrid = (p_grids[n % len(p_grids)] if p_grids
                 else random_p_slice_grid(rng, cfg.mb_width, cfg.mb_height,
                                          num_ref_idx_l0))
        mbt.emit_p_slice_mbs(bw, pgrid, num_ref_idx_l0,
                             bug_compat=bug_compat)
        bw.write_trailing_bits()
        out.write_nal_unit(bw.getvalue(), 2, 1)

    return out.getvalue()


def representative_inter_mb(rng: np.random.Generator,
                            num_ref_idx_l0: int) -> mbt.Macroblock:
    """A donor MB modeling a real encoder's moderate-QP dynamic content:
    P_L0_16x16, small MVs, sparse small-level residuals (the BASELINE
    'dynamic-rect splice' representative class)."""
    mvds = ((int(rng.integers(-16, 17)), int(rng.integers(-16, 17))),)
    cbp = int(rng.choice([0, 1, 2, 4, 8, 15, 16 + 15, 32 + 3]))
    mb = mbt.Macroblock(kind="inter", mb_type=0,
                        ref_idx=(0,) if num_ref_idx_l0 > 1 else (),
                        mvds=mvds, cbp=cbp)
    if cbp > 0:
        mb.qp_delta = int(rng.integers(-2, 3))
        from ..ops.cavlc_tables import SCAN_TO_RASTER
        luma = [cavlc.EMPTY_BLOCK] * 16
        for i8x8 in range(4):
            if cbp & (1 << i8x8):
                for i4x4 in range(4):
                    if rng.random() < 0.5:
                        continue
                    raster = SCAN_TO_RASTER[i8x8 * 4 + i4x4]
                    tc = int(rng.integers(1, 5))
                    t1 = min(tc, int(rng.integers(0, 4)))
                    levels = [int(rng.choice([-1, 1])) for _ in range(t1)]
                    for i in range(tc - t1):
                        lo = 2 if (i == 0 and t1 < 3) else 1
                        mag = int(rng.integers(lo, lo + 4))
                        levels.append(mag if rng.random() < 0.5 else -mag)
                    total_zeros = int(rng.integers(0, 16 - tc + 1))
                    runs = []
                    zeros_left = total_zeros
                    for _ in range(tc - 1):
                        if zeros_left <= 0:
                            break
                        run = int(rng.integers(0, min(zeros_left, 7) + 1))
                        runs.append(run)
                        zeros_left -= run
                    luma[raster] = cavlc.encode_residual_block(
                        levels, total_zeros, runs, 16, 0)
        mb.luma = tuple(luma)
        if (cbp >> 4) & 3:
            mb.cb_dc = random_residual_block(rng, 4, density=0.6)
            mb.cr_dc = random_residual_block(rng, 4, density=0.6)
    return mb


def representative_donor_grid(rng, mb_width, mb_height,
                              num_ref_idx_l0: int = 1):
    """~25% P_Skip + representative inter MBs (see representative_inter_mb)."""
    return [[mbt.SKIP if rng.random() < 0.25
             else representative_inter_mb(rng, num_ref_idx_l0)
             for _ in range(mb_width)] for _ in range(mb_height)]


def dense_donor_grid(rng, mb_width, mb_height, num_ref_idx_l0: int = 1):
    """Worst-case dense random CAVLC donor (no I_PCM): the adversarial
    residual-density class the splice bench's 'dense' config times."""
    grid = random_p_slice_grid(rng, mb_width, mb_height, num_ref_idx_l0)
    for row in grid:
        for i, mb in enumerate(row):
            if mb is not mbt.SKIP and mb.kind == "ipcm":
                row[i] = random_inter_mb(rng, num_ref_idx_l0)
    return grid
