"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: a CUDA kernel has no CPU mode, so these tests skip where
there is no NVIDIA GPU.  This file imports no jax; run it on the card
(where jax is not installed, so without tests/conftest.py) with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: exact equality — every output is an integer or a byte.
"""

import json

import numpy as np
import pytest
import torch

from h264_scroll_encoder_tpu_torch import _kernels, cases
from h264_scroll_encoder_tpu_torch.config import ComposerConfig, MAX_WAYPOINTS
from h264_scroll_encoder_tpu_torch.models import scroll
from h264_scroll_encoder_tpu_torch.ops import bitpack_flat, ebsp_flat, emit_fused
from h264_scroll_encoder_tpu_torch.parallel import batch
from h264_scroll_encoder_tpu_torch.syntax import slice_headers

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _cu(a, dev, int32=False):
    a = cases.int32_bits(a) if int32 else np.asarray(a).astype(np.int64)
    return torch.as_tensor(a, device=dev)


def _same(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("append_tb", [False, True])
def test_emit_kernel_byte_and_align_cases(dev, align, append_tb):
    for pat, nb in (cases.byte_stream_cases(), cases.align_cases()):
        args = (_cu(pat, dev), _cu(nb, dev), 2, cases.N_RBSP, cases.CAP)
        kw = dict(align=align, append_tb=append_tb)
        before = _kernels.EMIT_FUSED.launches
        got = emit_fused.emit_nal_fused_batch(*args, **kw)
        assert _kernels.EMIT_FUSED.launches == before + 1
        _same(got, emit_fused.emit_nal_fused_plain(*args, **kw))


def test_emit_kernel_window_sweep_and_overflow(dev):
    pat, nb, _ = cases.window_sweep_cases()
    args = (_cu(pat, dev), _cu(nb, dev), 0, cases.N_RBSP, 64)
    _same(emit_fused.emit_nal_fused_batch(*args),
          emit_fused.emit_nal_fused_plain(*args))
    pat, nb = cases.overflow_case()
    got = emit_fused.emit_nal_fused_batch(_cu(pat[None], dev),
                                          _cu(nb[None], dev), 0,
                                          cases.N_RBSP, cases.CAP)
    assert bool(got[3][0])


@pytest.mark.parametrize("n,num_words", [(1024, 300), (64, 80), (200, 64),
                                         (8483, 1490), (100, 300)])
def test_pack_kernel(dev, n, num_words):
    pat, nb = cases.pack_cases(n, 8, n, num_words)
    args = (_cu(pat, dev), _cu(nb, dev), num_words)
    _same(bitpack_flat.pack_words_place_batch(*args),
          bitpack_flat.pack_words_place_plain(*args))


def test_golden_digests_on_card(dev):
    assert cases.port_golden(dev) == json.loads(cases.GOLDEN_PATH.read_text())


@pytest.mark.parametrize("n,num_words", [(100, 10), (257, 30), (5, 1),
                                         (1000, 1000), (8483, 1490)])
def test_pack_words_kernel(dev, n, num_words):
    """K4 at widths of 0 and 32, lane counts that are not powers of two,
    and streams cut at num_words."""
    pat, nb = cases.pack_edge_case(n, n, num_words)
    args = (_cu(pat[None], dev), _cu(nb[None], dev), num_words)
    before = _kernels.PACK_WORDS.launches
    got = bitpack_flat.pack_words_batch(*args)
    assert _kernels.PACK_WORDS.launches == before + 1
    _same(got, bitpack_flat.pack_words_place_plain(*args))


def _i64(a, dev):
    return torch.as_tensor(np.asarray(a).astype(np.int64), device=dev)


@pytest.mark.parametrize("cap", [cases.CAP, 1000])
def test_ebsp_kernel(dev, cap):
    """K3 on the byte-stream, saturation and boundary cases
    (cases.ebsp_boundary_cases at each of its NAL sizes), with int64 [B]
    and 0-dim lengths, header bytes of every nal_ref_idc and past 255, rows
    read through a row stride other than their length, and int32 bytes."""
    rbsp, lens, hdr = cases.ebsp_cases()
    args = (torch.as_tensor(rbsp, device=dev), _i64(lens, dev), int(hdr[3]),
            cases.EBSP_N_NAL, cap)
    before = _kernels.EBSP_NAL.launches
    got = ebsp_flat.rbsp_to_nal_batch(*args)
    assert _kernels.EBSP_NAL.launches == before + 1
    _same(got, ebsp_flat.rbsp_to_nal_plain(*args))
    rb, n = cases.ebsp_saturation_case()
    args = (torch.as_tensor(rb[None], device=dev), _i64([n], dev), 0x41,
            rb.size, cap)
    got = ebsp_flat.rbsp_to_nal_batch(*args)
    _same(got, ebsp_flat.rbsp_to_nal_plain(*args))
    assert int(got[1][0]) > cap or cap > 100
    rbsp, lens, hdr = cases.ebsp_boundary_cases()
    rb = torch.as_tensor(rbsp, device=dev)
    wide = torch.zeros((rb.shape[0], rb.shape[1] + 5), dtype=torch.uint8,
                       device=dev)
    wide[:, 3:-2] = rb
    inputs = [(rb, _i64(lens, dev), int(h)) for h in np.unique(hdr)]
    inputs += [(wide[:, 3:-2], _i64(lens, dev), 0x41),
               (rb.to(torch.int32), torch.tensor(5000, device=dev), 1)]
    for n_nal in cases.EBSP_BOUNDARY_N_NALS:
        for rows, n, h in inputs:
            args = (rows, n, h, n_nal, cap)
            _same(ebsp_flat.rbsp_to_nal_batch(*args),
                  ebsp_flat.rbsp_to_nal_plain(*args))


def test_ebsp_items_per_thread_is_the_kernels(dev):
    """cases.ebsp_boundary_cases aims at the runs that
    ebsp_flat.items_per_thread gives; the built K3 must use the same."""
    for valid in range(2 * ebsp_flat.padded_len(8224) + 1):
        assert (ebsp_flat.items_per_thread(valid)
                == _kernels.ebsp_items_per_thread(valid)), valid


def test_ebsp_kernel_over_shared_memory_raises(dev):
    """A launch whose block needs more shared memory than any plan gives —
    K1 staging past its 24 symbols per thread, which no wrapper passes —
    raises, launches nothing and leaves no error for the next launch: K3 at
    a NAL buffer past a block's shared memory, which takes its global plan
    and equals its plain version."""
    p = torch.zeros((2, 64), dtype=torch.int64, device=dev)
    out = torch.empty((2, 4096), dtype=torch.uint8, device=dev)
    meta = torch.empty((3, 2), dtype=torch.int32, device=dev)
    before = _kernels.EMIT_FUSED.launches
    with pytest.raises(RuntimeError, match="h264t_emit_fused"):
        _kernels.EMIT_FUSED.launch(
            p.data_ptr(), p.data_ptr(), 8, 64, 64, None, 0, 0, 2, 64, 64,
            4096, 4000, cases.CAP, 0, 1, None, 1, out.data_ptr(),
            meta[0].data_ptr(), meta[1].data_ptr(), meta[2].data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    assert _kernels.EMIT_FUSED.launches == before
    rb = torch.zeros((2, 64), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        assert _kernels.ebsp_nal_in_global(300_000)
    before = _kernels.EBSP_NAL.launches
    args = (rb, _i64([64, 60], dev), 0x41, 300_000, cases.CAP)
    _same(ebsp_flat.rbsp_to_nal_batch(*args), ebsp_flat.rbsp_to_nal_plain(*args))
    assert _kernels.EBSP_NAL.launches == before + 1


@pytest.mark.parametrize("cap", [cases.CAP, 1000])
@pytest.mark.parametrize("n_nal", cases.EBSP_LARGE_N_NALS)
def test_ebsp_kernel_past_shared_memory(dev, n_nal, cap):
    """K3 at NAL buffers past a block's shared memory (rows read from
    global memory, the NAL built in place), on rows read in place and
    through a row stride, against its plain version."""
    rbsp, lens = cases.ebsp_large_cases(n_nal)
    with torch.cuda.device(dev):
        assert _kernels.ebsp_nal_in_global(n_nal)
    rb = torch.as_tensor(rbsp, device=dev)
    wide = torch.zeros((rb.shape[0], rb.shape[1] + 7), dtype=torch.uint8,
                       device=dev)
    wide[:, 3:-4] = rb
    for rows in (rb, wide[:, 3:-4]):
        args = (rows, _i64(lens, dev), 0x61, n_nal, cap)
        got = ebsp_flat.rbsp_to_nal_batch(*args)
        _same(got, ebsp_flat.rbsp_to_nal_plain(*args))
    assert int(got[1][0]) <= 1000 < int(got[1][1])


@pytest.mark.parametrize("program", ["compact", "static", "ebsp_exact"])
def test_small_splice_step_matches_cpu(dev, program):
    """The 720p rows splice step on the card (K1, or K2 for ebsp_exact)
    against the same step on CPU tensors (the plain versions), two
    representative donors from the Python engine."""
    cfg = ComposerConfig(1280, 720)
    pays = [cases.splice_donor_payload(k) for k in range(2)]
    outs = []
    for device in ("cpu", dev):
        dn, bits, align = cases.prepare_splice_donors(pays, engine="python",
                                                      device=device)
        step = cases.splice_steps(cfg, int(bits.max()), bool(align.any()))[program]
        outs.append(step(*cases.splice_session_inputs(cfg, 2, device), dn))
    torch.cuda.synchronize()
    for c, g in zip(*outs):
        assert torch.equal(g.cpu(), c)
    assert not bool(outs[0][3].any())


def test_splice_golden_digests_on_card(dev):
    want = json.loads(cases.SPLICE_GOLDEN_PATH.read_text())
    assert cases.port_splice_golden(dev) == want


@pytest.mark.parametrize("int32", [False, True], ids=["int64", "int32"])
@pytest.mark.parametrize("n", cases.PACK_BOUNDARY_LENGTHS)
def test_kernels_on_pack_boundaries(dev, n, int32):
    """K1, K2 and K4 on the run and chunk boundaries of their pack
    (cases.pack_boundary_cases), reading int64 and int32 symbols."""
    pat, nb, n_rbsp = cases.pack_boundary_cases(n)
    args = (_cu(pat, dev, int32), _cu(nb, dev, int32), 1, n_rbsp, cases.CAP)
    for align in (False, True):
        kw = dict(align=align, append_tb=True)
        _same(emit_fused.emit_nal_fused_batch(*args, **kw),
              emit_fused.emit_nal_fused_plain(*args, **kw))
    pat, nb, n_rbsp = cases.pack_boundary_cases(n, sentinels=False)
    for num_words in (n_rbsp // 4, n_rbsp // 8):  # in budget, then cut
        args = (_cu(pat, dev, int32), _cu(nb, dev, int32), num_words)
        want = bitpack_flat.pack_words_place_plain(*args)
        _same(bitpack_flat.pack_words_place_batch(*args), want)
        _same(bitpack_flat.pack_words_batch(*args), want)


@pytest.mark.parametrize("int32", [False, True], ids=["int64", "int32"])
def test_emit_kernel_chunk_zero_runs(dev, int32):
    pat, nb, _runs, n_rbsp = cases.chunk_zero_run_cases()
    args = (_cu(pat, dev, int32), _cu(nb, dev, int32), 0, n_rbsp, 64)
    got = emit_fused.emit_nal_fused_batch(*args)
    _same(got, emit_fused.emit_nal_fused_plain(*args))
    assert bool(got[3].any()) and not bool(got[3].all())


def test_wrappers_launch_only_their_kernel(dev):
    """On int64 symbols the K1 and K2/K4 wrappers, and on uint8 bytes with
    int64 lengths and an int header the K3 wrapper, run no tensor op but
    allocations and views before and after their one kernel launch."""
    pat, nb, n_rbsp = cases.pack_boundary_cases(9728)
    p, n = _cu(pat, dev), _cu(nb, dev)
    rbsp, lens, _ = cases.ebsp_boundary_cases()
    rb = torch.as_tensor(rbsp, device=dev)
    rb_len = torch.as_tensor(lens.astype(np.int64), device=dev)
    for fn in (lambda: emit_fused.emit_nal_fused_batch(p, n, 0, n_rbsp, cases.CAP,
                                                       align=True, append_tb=True),
               lambda: bitpack_flat.pack_words_place_batch(p, n, n_rbsp // 4),
               lambda: bitpack_flat.pack_words_batch(p, n, n_rbsp // 4),
               lambda: ebsp_flat.rbsp_to_nal_batch(rb, rb_len, 0x01, 8224,
                                                   cases.CAP)):
        assert cases.compute_ops(fn) == []


# ---------------------------------------------------------------------------
# The session slice's shapes: partitioned frames, sliced bands, large frames.
# ---------------------------------------------------------------------------

def _registry_zeros(B, dev):
    z = torch.zeros((B, MAX_WAYPOINTS), dtype=torch.int64, device=dev)
    return z, z, z.bool(), torch.zeros(B, dtype=torch.int64, device=dev)


def _k1_same(pat, nb, idc, n_rbsp):
    args = (pat, nb, idc, n_rbsp, cases.CAP)
    before = _kernels.EMIT_FUSED.launches
    got = emit_fused.emit_nal_fused_batch(*args, append_tb=True)
    assert _kernels.EMIT_FUSED.launches == before + 1
    _same(got, emit_fused.emit_nal_fused_plain(*args, append_tb=True))
    return got


@pytest.mark.parametrize("waypoint", [False, True])
def test_emit_kernel_on_partitioned_720p(dev, waypoint):
    """K1 on 720p partitioned symbols (4 slots per MB: 14,436 symbols, two
    12,288-symbol chunks), the 16x8 seam rows of offsets 9, 40 and 71 in
    the second chunk."""
    cfg = ComposerConfig(1280, 720)
    offs = torch.as_tensor(cases.SESSION_POLICY_OFFSETS[:8], device=dev)
    wp = torch.full((8,), waypoint, device=dev)
    pat, nb, n_rbsp, idc = scroll.unified_frame_symbols(
        cfg, torch.full((8,), 7, device=dev), offs, *_registry_zeros(8, dev),
        wp, boundary_policy="partitioned")
    assert pat.shape[1] > 12288
    assert not bool(_k1_same(pat, nb, idc, n_rbsp)[3].any())


@pytest.mark.parametrize("rows", [3, 9, 15])
def test_emit_kernel_on_sliced_bands(dev, rows):
    """K1 on one 720p sliced frame per session: all bands of 4 sessions in
    one launch, equal to the plain version, and the frame function equal
    to its CPU run."""
    cfg = ComposerConfig(1280, 720)
    offs = [100, 348, 496, 7]
    outs = []
    for device in ("cpu", dev):
        args = (torch.arange(4, device=device) + 2,
                torch.as_tensor(offs, device=device),
                *_registry_zeros(4, device))
        pat, nb, n_rbsp = scroll.sliced_frame_symbols(cfg, *args,
                                                      rows_per_slice=rows)
        if device != "cpu":
            assert pat.shape[0] == 4 * 45 // rows
            _k1_same(pat, nb, 0, n_rbsp)
        before = _kernels.EMIT_FUSED.launches
        outs.append(scroll.scroll_frame_sliced(cfg, *args, rows_per_slice=rows))
    assert _kernels.EMIT_FUSED.launches == before + 1
    torch.cuda.synchronize()
    for c, g in zip(*outs):
        assert torch.equal(g.cpu(), c)


def _hint_symbols(cfg, dev, specs):
    from h264_scroll_encoder_tpu_torch.models import hints, splice
    ref, mvx, mvy = hints.hint_fields(cfg, splice.FrameHints(
        motion_regions=tuple(splice.MotionRegion(*s) for s in specs)), dev)
    hp, hn = slice_headers.p_slice_header_symbols(
        cfg, torch.tensor([3], device=dev), torch.tensor([6], device=dev),
        False, -1, 0, *_registry_zeros(1, dev)[1:3])
    return scroll.p_frame_symbols(cfg, hp, hn, ref[None], mvx[None],
                                  mvy[None], 2, enable_pskip=True)


_LARGE_PLANS = {"hint_1080p": (False, False), "scroll_4k": (False, False),
                "hint_4k": (True, False), "hint_4k_64": (True, True),
                "hint_5120x3200": (True, True)}


@pytest.mark.parametrize("frame", ["hint_1080p", "scroll_4k", "hint_4k",
                                   "hint_4k_64", "hint_5120x3200",
                                   "exact_4k", "exact_4096x2160"])
def test_kernels_on_large_frames(dev, frame):
    """K1 and K2 on the large buffers against their plain versions: the
    1080p hint frame (n_rbsp 32,736 B) and the 4K scroll fast path
    (64,896 B) keep words and NAL in shared memory, the 4K generic budget
    (129,696 B: 259,456 B of shared memory by the in-block plan) takes
    K1's global words; at 64 bits per MB (NAL buffer 259,328 B) and at
    5120x3200 (256,128 B) the NAL is built in global memory too; K2 on the
    4K exact retry (129,696 B, in shared memory with 4,256 B to spare) and
    at 4096x2160 (138,336 B, global)."""
    w, h = {"hint_1080p": (1920, 1088), "exact_4096x2160": (4096, 2160),
            "hint_5120x3200": (5120, 3200)}.get(frame, (3840, 2160))
    cfg = ComposerConfig(w, h, rbsp_bits_per_mb=64 if frame == "hint_4k_64"
                         else 32)
    if frame.startswith("hint"):
        pat, nb, n_rbsp = _hint_symbols(cfg, dev, [
            (0, 0, cfg.mb_width, 12, 0, 0, 40), (20, 40, 60, 60, 1, 3, -16)])
    else:
        pat, nb, n_rbsp, _ = scroll.unified_frame_symbols(
            cfg, torch.tensor([2], device=dev), torch.tensor([48], device=dev),
            *_registry_zeros(1, dev), torch.tensor([False], device=dev),
            enable_pskip=True)
        if frame.startswith("exact"):
            n_rbsp = (cfg.total_mbs * cfg.rbsp_bits_per_mb // 8 + 96 + 3) // 4 * 4
    k = emit_fused.items_per_thread(pat.shape[1])
    with torch.cuda.device(dev):
        if frame.startswith("exact"):
            n_words = (n_rbsp + 3) // 4
            assert (_kernels.pack_words_in_global(8, k, n_words)
                    == (frame == "exact_4096x2160"))
            args = (pat, nb, n_words)
            _same(bitpack_flat.pack_words_place_batch(*args),
                  bitpack_flat.pack_words_place_plain(*args))
            return
        n_nal = emit_fused.nal_bytes(n_rbsp, cases.CAP)
        assert tuple(_kernels.emit_plan(8, k, n_nal)) == _LARGE_PLANS[frame]
    assert not bool(_k1_same(pat, nb, 0, n_rbsp)[3].any())


def test_splice_path_keeps_words_in_shared_memory(dev):
    """The 720p splice, scroll and partitioned paths are unchanged by the
    large-frame plans: their words and NAL stay in shared memory, and K3's
    720p buffers too."""
    with torch.cuda.device(dev):
        for sym_bytes, k, n_nal in ((8, 19, 8224), (8, 15, 7328),
                                    (8, 24, 14528), (4, 24, 14528)):
            assert tuple(_kernels.emit_plan(sym_bytes, k, n_nal)) == (False, False)
        assert not _kernels.pack_words_in_global(8, 19, 2048)
        for n_nal in cases.EBSP_BOUNDARY_N_NALS:
            assert not _kernels.ebsp_nal_in_global(n_nal)


@pytest.mark.parametrize("config", ["representative", "ipcm", "ipcm_exact"])
def test_dense_step_matches_cpu(dev, config):
    """The 720p dense splice step at B = 4 on the card (K1; K2 for the
    `ebsp_exact` retry) against the same step on CPU tensors; the I_PCM
    donors at the default budget take K1's global NAL (n_nal 237,600)."""
    cfg = ComposerConfig(1280, 720)
    name = config.split("_")[0]
    outs = []
    for device in ("cpu", dev):
        dn, bits, align = cases.prepare_dense_donors(name, engine="python",
                                                     device=device, n=4)
        step = cases.dense_step(cfg, name, bits, align,
                                ebsp_exact=config.endswith("exact"))
        before = (_kernels.EMIT_FUSED.launches, _kernels.PACK_PLACE.launches)
        outs.append(step(*cases.splice_session_inputs(cfg, 4, device), dn))
    exact = config.endswith("exact")
    assert (_kernels.EMIT_FUSED.launches - before[0],
            _kernels.PACK_PLACE.launches - before[1]) == (
                (0, 1) if exact else (1, 0))
    torch.cuda.synchronize()
    for c, g in zip(*outs):
        assert torch.equal(g.cpu(), c)
    assert not bool(outs[0][3].any())
    if name == "ipcm":      # the exact path's buffer holds 1.5x the budget
        assert outs[0][0].shape[1] == (356_368 if exact else 237_600)


@pytest.mark.parametrize("config", ["ipcm"])
def test_emit_kernel_on_dense_ipcm_symbols(dev, config):
    """K1 against its plain version on the 720p dense frame of
    I_PCM-bearing donors at the chunk class's default budget (NAL buffer
    237,600 B: words and NAL in global memory)."""
    cfg = ComposerConfig(1280, 720)
    dn, bits, align = cases.prepare_dense_donors(config, engine="python",
                                                 device=dev, n=4)
    pat, nb, n_rbsp = cases.dense_symbols(cfg, config, dn, bits, dev)
    k = emit_fused.items_per_thread(pat.shape[1])
    n_nal = emit_fused.nal_bytes(n_rbsp, cases.CAP)
    assert n_nal == 237_600
    with torch.cuda.device(dev):
        assert tuple(_kernels.emit_plan(8, k, n_nal)) == (True, True)
    args = (pat, nb, 0, n_rbsp, cases.CAP)
    kw = dict(align=align, append_tb=True)
    got = emit_fused.emit_nal_fused_batch(*args, **kw)
    _same(got, emit_fused.emit_nal_fused_plain(*args, **kw))
    assert not bool(got[3].any())


def test_dense_golden_on_card(dev):
    want = json.loads(cases.DENSE_GOLDEN_PATH.read_text())
    assert cases.port_dense_golden(dev) == want


def test_large_frames_golden_on_card(dev):
    """The two large hint frames (NAL buffers past a block's shared
    memory) through ComposerSession on the card equal the JAX package's
    digests (golden/large_frames.json)."""
    want = json.loads(cases.LARGE_GOLDEN_PATH.read_text())
    assert cases.large_golden(cases.port_package(), device=dev) == want


def test_session_golden_on_card(dev, tmp_path):
    """Every session stream and the batched hint step on the card equal the
    JAX package's digests (golden/session_720p.json)."""
    want = json.loads(cases.SESSION_GOLDEN_PATH.read_text())
    assert cases.port_session_golden(dev, tmp_path) == want


def test_compact_batch_nal_on_card(dev):
    rng = np.random.default_rng(5)
    nal = rng.integers(0, 256, (40, 333), dtype=np.uint8)
    lens = rng.integers(0, 334, 40)
    for cap in (int(lens.sum()), int(lens.sum()) - 1, 64):
        got = batch.compact_batch_nal(torch.as_tensor(nal, device=dev),
                                      torch.as_tensor(lens, device=dev), cap)
        want = batch.compact_batch_nal(torch.as_tensor(nal),
                                       torch.as_tensor(lens), cap)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
