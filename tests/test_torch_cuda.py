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
import torch.utils._pytree as pytree

from h264_scroll_encoder_tpu_torch import _kernels, cases
from h264_scroll_encoder_tpu_torch.config import ComposerConfig, MAX_WAYPOINTS
from h264_scroll_encoder_tpu_torch.models import scroll
from h264_scroll_encoder_tpu_torch.ops import (bitpack, bitpack_flat, ebsp_flat,
                                               emit_fused, grid)
from h264_scroll_encoder_tpu_torch.parallel import batch
from h264_scroll_encoder_tpu_torch.syntax import slice_headers
from h264_scroll_encoder_tpu_torch.utils.trace import TRACER

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
    """K1 on the byte-stream and alignment cases, reading int64 and int32
    symbols: one launch, equal to the plain version."""
    for pat, nb in (cases.byte_stream_cases(), cases.align_cases()):
        for int32 in (False, True):
            args = (_cu(pat, dev, int32), _cu(nb, dev, int32), 2,
                    cases.N_RBSP, cases.CAP)
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
    """K2 and K4 on the pack cases, equal to the plain version."""
    pat, nb = cases.pack_cases(n, 8, n, num_words)
    args = (_cu(pat, dev), _cu(nb, dev), num_words)
    want = bitpack_flat.pack_words_place_plain(*args)
    _same(bitpack_flat.pack_words_place_batch(*args), want)
    _same(bitpack_flat.pack_words_batch(*args), want)


def _golden_twice(run, path):
    """run() on the card equals the golden file at `path`, and so does a
    second run, in which every graphed step replays a graph (the tracer
    counts replays and no capture)."""
    want = json.loads(path.read_text())
    assert run() == want
    counters = TRACER.counters
    captures, replays = counters["graphs.captures"], counters["graphs.replays"]
    with TRACER.recording():
        assert run() == want
    assert counters["graphs.captures"] == captures
    assert counters["graphs.replays"] > replays


def test_golden_digests_on_card(dev):
    """The scroll golden run on the card, then again on replays."""
    _golden_twice(lambda: cases.port_golden(dev), cases.GOLDEN_PATH)


@pytest.mark.parametrize("n,num_words", [(100, 10), (257, 30), (5, 1),
                                         (1000, 1000), (8483, 1490),
                                         (64, 3)])
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
            4096, 4000, cases.CAP, 0, 1, 1, out.data_ptr(),
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
    """The rows splice golden run on the card, then again on replays."""
    _golden_twice(lambda: cases.port_splice_golden(dev),
                  cases.SPLICE_GOLDEN_PATH)


@pytest.mark.parametrize("int32", [False, True], ids=["int64", "int32"])
@pytest.mark.parametrize("n", cases.PACK_BOUNDARY_LENGTHS)
def test_kernels_on_pack_boundaries(dev, n, int32):
    """K1, K2 and K4 on the run and chunk boundaries of their pack
    (cases.pack_boundary_cases), reading int64 and int32 symbols; K1 with
    a nal_ref_idc per session."""
    pat, nb, n_rbsp = cases.pack_boundary_cases(n)
    idc = torch.arange(len(pat), device=dev) % 4
    args = (_cu(pat, dev, int32), _cu(nb, dev, int32), idc, n_rbsp, cases.CAP)
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
    """On int32 symbols (the symbol stages' width) and on int64 ones the K1
    and K2/K4 wrappers, with an int32 [B] nal_ref_idc for K1, and on uint8
    bytes with int64 lengths and an int header the K3 wrapper, run no
    tensor op but allocations and views before and after their one kernel
    launch."""
    pat, nb, n_rbsp = cases.pack_boundary_cases(9728)
    idc = torch.zeros(len(pat), dtype=torch.int32, device=dev)
    rbsp, lens, _ = cases.ebsp_boundary_cases()
    rb = torch.as_tensor(rbsp, device=dev)
    rb_len = torch.as_tensor(lens.astype(np.int64), device=dev)
    for int32 in (True, False):
        p, n = _cu(pat, dev, int32), _cu(nb, dev, int32)
        for fn in (lambda: emit_fused.emit_nal_fused_batch(
                       p, n, idc, n_rbsp, cases.CAP, align=True, append_tb=True),
                   lambda: bitpack_flat.pack_words_place_batch(p, n, n_rbsp // 4),
                   lambda: bitpack_flat.pack_words_batch(p, n, n_rbsp // 4)):
            assert cases.compute_ops(fn) == []
    assert cases.compute_ops(lambda: ebsp_flat.rbsp_to_nal_batch(
        rb, rb_len, 0x01, 8224, cases.CAP)) == []


# ---------------------------------------------------------------------------
# The session slice's shapes: partitioned frames, sliced bands, large frames.
# ---------------------------------------------------------------------------

def _registry_zeros(B, dev):
    z = torch.zeros((B, MAX_WAYPOINTS), dtype=torch.int32, device=dev)
    return z, z, z.bool(), torch.zeros(B, dtype=torch.int32, device=dev)


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


# The blocks a session (1, or the cluster plan's C) of K1 at each large
# frame and of K2 at each exact retry, on an H100.
_LARGE_PLANS = {"hint_1080p": 1, "scroll_4k": 1, "hint_4k": 8,
                "hint_4k_64": 8, "hint_5120x3200": 16, "exact_4k": 1,
                "exact_4096x2160": 8, "exact_5120x3200": 16}


def _large_symbols(dev, frame):
    """(patterns, nbits, n_rbsp) of a large frame of _LARGE_PLANS."""
    w, h = {"hint_1080p": (1920, 1088), "exact_4096x2160": (4096, 2160),
            "hint_5120x3200": (5120, 3200),
            "exact_5120x3200": (5120, 3200)}.get(frame, (3840, 2160))
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
    return pat, nb, n_rbsp


@pytest.mark.parametrize("frame", list(_LARGE_PLANS))
def test_kernels_on_large_frames(dev, frame):
    """K1 and K2 on the large buffers against their plain versions, in one
    launch each: the 1080p hint frame (n_rbsp 32,736 B) and the 4K scroll
    fast path (64,896 B) keep one block a session; the 4K hint frames at
    32 and 64 bits per MB (NAL buffers 129,728 and 259,328 B: 129,640
    symbols) run on clusters of 8 blocks and the 5120x3200 one (256,128 B,
    256,040 symbols) on 16; K2 keeps one block on the 4K exact retry
    (129,696 B, with 4,256 B of shared memory to spare) and takes 8 at
    4096x2160 (138,336 B) and 16 at 5120x3200 (256,096 B)."""
    pat, nb, n_rbsp = _large_symbols(dev, frame)
    n = pat.shape[1]
    k = emit_fused.items_per_thread(n)
    with torch.cuda.device(dev):
        if frame.startswith("exact"):
            n_words = (n_rbsp + 3) // 4
            assert _kernels.pack_plan(8, n, k, n_words) == _LARGE_PLANS[frame]
            args = (pat, nb, n_words)
            before = _kernels.PACK_PLACE.launches
            _same(bitpack_flat.pack_words_place_batch(*args),
                  bitpack_flat.pack_words_place_plain(*args))
            assert _kernels.PACK_PLACE.launches == before + 1
            return
        n_nal = emit_fused.nal_bytes(n_rbsp, cases.CAP)
        assert _kernels.emit_plan(8, n, k, n_nal) == _LARGE_PLANS[frame]
    assert not bool(_k1_same(pat, nb, 0, n_rbsp)[3].any())


@pytest.mark.parametrize("cluster", [2, 4])
def test_kernels_on_a_cluster_of_several_chunks(dev, cluster):
    """The cluster plan's chunk loop: the 4K hint frame (129,640 symbols)
    forced onto 2 and 4 blocks, whose shares (64,820 and 32,410 symbols)
    each take several chunks of 16,896, K1 and K2 against their plain
    versions."""
    pat, nb, n_rbsp = _large_symbols(dev, "hint_4k")
    assert emit_fused.cluster_share(pat.shape[1], cluster) > (
        _kernels.PACK_THREADS * emit_fused.CLUSTER_MAX_ITEMS)
    args = (pat, nb, 0, n_rbsp, cases.CAP)
    _same(emit_fused.emit_nal_fused_batch(*args, append_tb=True,
                                          cluster=cluster),
          emit_fused.emit_nal_fused_plain(*args, append_tb=True))
    n_words = (n_rbsp + 3) // 4
    _same(bitpack_flat.pack_words_place_batch(pat, nb, n_words,
                                              cluster=cluster),
          bitpack_flat.pack_words_place_plain(pat, nb, n_words))


def test_splice_path_keeps_words_in_shared_memory(dev):
    """The 720p splice, scroll and partitioned paths are unchanged by the
    large-frame plans: one block a session holds their words and NAL in
    its shared memory, and K3's 720p buffers too."""
    with torch.cuda.device(dev):
        for sym_bytes, k, n_nal in ((8, 19, 8224), (8, 15, 7328),
                                    (8, 24, 14528), (4, 24, 14528)):
            assert _kernels.emit_plan(sym_bytes, _kernels.PACK_THREADS * k,
                                      k, n_nal) == 1
        assert _kernels.pack_plan(8, _kernels.PACK_THREADS * 19, 19, 2048) == 1
        for n_nal in cases.EBSP_BOUNDARY_N_NALS:
            assert not _kernels.ebsp_nal_in_global(n_nal)


def test_cluster_items_is_the_kernels(dev):
    """ops/emit_fused.cluster_items_per_thread, which the wrappers pass
    and the plain models use, is the library's (h264t_cluster_items)."""
    with torch.cuda.device(dev):
        for n in (0, 1, 511, 512, 9219, 64_798, 129_640, 256_040, 600_000):
            for c in emit_fused.CLUSTER_SIZES:
                assert (_kernels.cluster_items(n, c)
                        == emit_fused.cluster_items_per_thread(n, c)), (n, c)


def _forced_cases(dev):
    """{name: (patterns, nbits, nal_ref_idc, n_rbsp, K1 kwargs)} for the
    forced-cluster tests: the 720p compact splice and scroll shapes (B = 8)
    and the pack boundary cases."""
    cfg = ComposerConfig(1280, 720)
    pays = [cases.splice_donor_payload(k) for k in range(8)]
    dn, bits, align = cases.prepare_splice_donors(pays, engine="python",
                                                  device=dev)
    n_rbsp = cases.splice_budget(cfg, int(bits.max()), static_bg=False)
    pat, nb = cases.splice_symbols(cfg, dn, 8, n_rbsp, dev)
    out = {"splice": (pat, nb, 0, n_rbsp, dict(align=bool(align.any()),
                                               append_tb=True))}
    offs = torch.as_tensor(cases.SESSION_POLICY_OFFSETS[:8], device=dev)
    s_pat, s_nb, s_rbsp, idc = scroll.unified_frame_symbols(
        cfg, torch.full((8,), 7, device=dev), offs, *_registry_zeros(8, dev),
        torch.zeros(8, dtype=torch.bool, device=dev))
    out["scroll"] = (s_pat, s_nb, idc, s_rbsp, dict(append_tb=True))
    for n in cases.PACK_BOUNDARY_LENGTHS:
        b_pat, b_nb, b_rbsp = cases.pack_boundary_cases(n)
        out[f"boundary {n}"] = (_cu(b_pat, dev), _cu(b_nb, dev), 1, b_rbsp,
                                dict(align=True, append_tb=True))
    return out


@pytest.mark.parametrize("cluster", emit_fused.CLUSTER_SIZES)
def test_kernels_on_a_forced_cluster(dev, cluster):
    """K1 and K2 forced onto clusters of 2-16 blocks (the wrappers'
    test-only `cluster`) at the 720p splice and scroll shapes and the pack
    boundary cases: each one launch, equal to the plain versions."""
    for name, (pat, nb, idc, n_rbsp, kw) in _forced_cases(dev).items():
        before = _kernels.EMIT_FUSED.launches
        got = emit_fused.emit_nal_fused_batch(pat, nb, idc, n_rbsp, cases.CAP,
                                              cluster=cluster, **kw)
        assert _kernels.EMIT_FUSED.launches == before + 1, name
        _same(got, emit_fused.emit_nal_fused_plain(pat, nb, idc, n_rbsp,
                                                   cases.CAP, **kw))
        n_words = n_rbsp // 4
        p2, n2 = pat, nb.clamp(min=0)
        _same(bitpack_flat.pack_words_place_batch(p2, n2, n_words,
                                                  cluster=cluster),
              bitpack_flat.pack_words_place_plain(p2, n2, n_words))


@pytest.mark.parametrize("config", ["representative", "ipcm", "ipcm_exact"])
def test_dense_step_matches_cpu(dev, config):
    """The 720p dense splice step at B = 4 on the card (K1; K2 for the
    `ebsp_exact` retry) against the same step on CPU tensors; the I_PCM
    donors at the default budget take K1's cluster plan (n_nal 237,600)."""
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
    237,600 B, 64,798 symbols: clusters of 4 blocks)."""
    cfg = ComposerConfig(1280, 720)
    dn, bits, align = cases.prepare_dense_donors(config, engine="python",
                                                 device=dev, n=4)
    pat, nb, n_rbsp = cases.dense_symbols(cfg, config, dn, bits, dev)
    k = emit_fused.items_per_thread(pat.shape[1])
    n_nal = emit_fused.nal_bytes(n_rbsp, cases.CAP)
    assert n_nal == 237_600
    with torch.cuda.device(dev):
        assert _kernels.emit_plan(8, pat.shape[1], k, n_nal) == 4
    args = (pat, nb, 0, n_rbsp, cases.CAP)
    kw = dict(align=align, append_tb=True)
    got = emit_fused.emit_nal_fused_batch(*args, **kw)
    _same(got, emit_fused.emit_nal_fused_plain(*args, **kw))
    assert not bool(got[3].any())


def test_dense_golden_on_card(dev):
    """The dense splice golden run on the card, then again on replays."""
    _golden_twice(lambda: cases.port_dense_golden(dev),
                  cases.DENSE_GOLDEN_PATH)


def test_dense_ipcm_step_at_b256_on_card(dev):
    """The dense step of the 32 I_PCM-bearing donors tiled to B = 256: one
    K1 launch on clusters of 4 blocks (1,024 blocks), every session equal
    to its donor's golden digest (golden/splice_dense_720p.json)."""
    cfg, B = ComposerConfig(1280, 720), 256
    dn, bits, align = cases.prepare_dense_donors("ipcm", engine="native",
                                                 device=dev)
    step = cases.dense_step(cfg, "ipcm", bits, align)
    before = _kernels.EMIT_FUSED.launches
    nal, nal_len, _bits, ovf = step.eager(
        *cases.splice_session_inputs(cfg, B, dev), cases.tile_donors(dn, B))
    torch.cuda.synchronize()
    assert _kernels.EMIT_FUSED.launches == before + 1
    want = json.loads(cases.DENSE_GOLDEN_PATH.read_text())["ipcm"]
    got = cases.digest_step(nal.cpu().numpy(), nal_len.cpu().numpy(),
                            np.zeros(B, bool), ovf.cpu().numpy())
    assert got == [want[b % len(want)] for b in range(B)]


def test_large_frames_golden_on_card(dev):
    """The two large hint frames (NAL buffers past a block's shared
    memory) through ComposerSession on the card equal the JAX package's
    digests (golden/large_frames.json) and pass verify_stream; each frame
    is one K1 and one K6 launch."""
    from h264_scroll_encoder_tpu_torch.verify import verify_stream

    want = json.loads(cases.LARGE_GOLDEN_PATH.read_text())
    assert set(want) == set(cases.LARGE_FRAMES)
    for name in cases.LARGE_FRAMES:
        torch.cuda.synchronize()
        before = (_kernels.EMIT_FUSED.launches, _kernels.SCROLL_GRID.launches)
        data = cases.large_frame_stream(cases.port_package(), name, device=dev)
        torch.cuda.synchronize()
        assert (_kernels.EMIT_FUSED.launches - before[0],
                _kernels.SCROLL_GRID.launches - before[1]) == (1, 1)
        assert cases.stream_digest(data) == want[name]
        rep = verify_stream(data)
        assert rep.ok, (name, rep.errors[:3])


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


def _card_blocks(dev):
    """Every card, or two blocks on the one card."""
    n = torch.cuda.device_count()
    return ([torch.device("cuda", i) for i in range(n)] if n > 1
            else [dev, dev])


@pytest.mark.parametrize("B,steps", [(16, 4), (256, 16)])
def test_sharded_step_on_card(dev, B, steps):
    """make_sharded_step at 720p over `steps` steps of the benchmark's
    schedule, over the cards (two blocks on cuda:0 on one card): every
    output equals the unsharded step's on the card (and at B = 16 on the
    CPU), egress across the blocks equals compact_batch_nal, K1 launches
    once per block per step, and the final states are equal; a frame
    forced through the ebsp_exact retry on one shard launches K2 once and
    writes the bounded frame's bytes."""
    from h264_scroll_encoder_tpu_torch.parallel import dryrun

    cfg = ComposerConfig(1280, 720)
    devices = _card_blocks(dev)
    sched = torch.as_tensor(cases.bench_schedule(720, B, steps))
    sstep = batch.make_sharded_step(cfg, devices)
    ustep = batch.make_batched_step(cfg)
    blocks = batch.shard_batch(batch.SessionState.create(B, device=dev),
                               devices)
    card = batch.SessionState.create(B, device=dev)
    cpu = batch.SessionState.create(B, device="cpu") if B == 16 else None
    for offs in sched:
        _kernels.reset_launch_counts()
        blocks, outs = sstep(blocks, batch.shard_batch(offs, devices))
        torch.cuda.synchronize()
        assert _kernels.EMIT_FUSED.launches == len(devices)
        card, want = ustep(card, offs.to(dev))
        got = batch.gather_batch(outs, dev)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        if cpu is not None:
            cpu, want_cpu = ustep(cpu, offs)
            for g, c in zip(got, want_cpu):
                assert torch.equal(g.cpu(), c)
        cap = int(want[1].sum())
        packed = batch.compact_sharded_nal([o[0] for o in outs],
                                           [o[1] for o in outs], cap, dev)
        for g, w in zip(packed, batch.compact_batch_nal(want[0], want[1], cap)):
            assert torch.equal(g, w)
    final = batch.gather_batch(blocks, dev).to_numpy()
    for f, a in card.to_numpy().items():
        np.testing.assert_array_equal(final[f], a)
    st0 = blocks[0]
    offs0 = batch.shard_batch(sched[-1], devices)[0]
    before = _kernels.PACK_PLACE.launches
    with batch.on_device(devices[0]):
        frame_args = (cfg, st0.frame_num, offs0, st0.wp_offsets, st0.wp_ltidx,
                      st0.wp_valid, st0.wp_count)
        exact = scroll.scroll_frame(*frame_args, ebsp_exact=True)
        bounded = scroll.scroll_frame(*frame_args)
    torch.cuda.synchronize()
    assert _kernels.PACK_PLACE.launches == before + 1
    assert torch.equal(exact[1], bounded[1]) and not bool(bounded[3].any())
    n = min(exact[0].shape[1], bounded[0].shape[1])
    assert torch.equal(dryrun.valid_bytes(*exact[:2])[:, :n],
                       dryrun.valid_bytes(*bounded[:2])[:, :n])


def test_serving_state_restores_on_card(dev, tmp_path):
    """A state saved on the CPU and loaded onto the card continues
    byte for byte; and one saved on the card loads on the CPU.  A 720p
    ComposerSession on the card, saved with save_session and restored
    into a new one by restore_session, continues byte for byte through
    two more waypoints."""
    from h264_scroll_encoder_tpu_torch.utils import snapshot

    cfg = ComposerConfig(64, 1024)
    step = batch.make_batched_step(cfg)
    sched = torch.as_tensor([[0, 496, 992, 40], [496, 496, 992, 44],
                             [600, 700, 1000, 48], [992, 40, 8, 52]],
                            dtype=torch.int32)
    cpu = batch.SessionState.create(4, device="cpu")
    for offs in sched[:2]:
        cpu, _ = step(cpu, offs)
    snapshot.save_serving_state(tmp_path / "s.npz", cpu, {"step": 2})
    card, ctx = snapshot.load_serving_state(tmp_path / "s.npz", device=dev)
    assert ctx == {"step": 2} and card.frame_num.device == dev
    for offs in sched[2:]:
        cpu, want = step(cpu, offs)
        card, got = step(card, offs.to(dev))
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    snapshot.save_batch_state(card, tmp_path / "b.npz")
    back = snapshot.load_batch_state(tmp_path / "b.npz", device="cpu")
    assert back.to_numpy().keys() == cpu.to_numpy().keys()
    for f, a in back.to_numpy().items():
        np.testing.assert_array_equal(a, cpu.to_numpy()[f])
    from h264_scroll_encoder_tpu_torch.session import ComposerSession

    a = _striped_session(ComposerConfig(1280, 720), dev)
    for off in (0, 496, 496, 600):
        a.write_scroll_or_waypoint_frame(off)
    snapshot.save_session(a, tmp_path / "session.json")
    b = ComposerSession(ComposerConfig(1280, 720), device=dev)
    snapshot.restore_session(b, tmp_path / "session.json")
    for off in (700, 992, 992, 40):
        for s in (a, b):
            s.write_scroll_or_waypoint_frame(off)
        assert a.writer._chunks[-1] == b.writer._chunks[-1], off


def test_splice_serving_loop_evicts_and_restores_on_card(dev, tmp_path):
    """The splice serving loop at bench.py's geometry, B = 256: each step
    the 32 representative donors go through the native engine onto the
    blob wire and session b carries donor (b + 5 t) % 32.  Evicted after
    3 of 6 steps with save_serving_state and restored onto the card with
    load_serving_state, it writes every NAL of the uninterrupted run; K1
    and K5 launch once a step."""
    from h264_scroll_encoder_tpu_torch.parallel import dryrun
    from h264_scroll_encoder_tpu_torch.utils import snapshot

    cfg, B, T, evict = ComposerConfig(1280, 720), 256, 6, 3
    pays = [cases.splice_donor_payload(k) for k in range(32)]
    zero = torch.zeros((B, cfg.mb_height, cfg.mb_width), dtype=torch.int32,
                       device=dev)

    def serve(state, ctx, t0, t1):
        out = []
        for t in range(t0, t1):
            dn, bits, align = cases.prepare_splice_donors(
                pays, engine="native", device=dev)
            step = cases.splice_steps(cfg, int(bits.max()),
                                      bool(align.any()))["compact"]
            pick = (torch.arange(B, device=dev) + ctx["rotation"] * t) % 32
            fn = state.frame_num % (1 << cfg.log2_max_frame_num)
            hp, hn = slice_headers.p_slice_header_symbols(
                cfg, fn, fn * 2, False, -1, state.wp_count, state.wp_ltidx,
                state.wp_valid)
            nal, nal_len, _bits, ovf = step(hp, hn, zero, zero, zero,
                                            zero.bool(),
                                            {"blob": dn["blob"][pick]})
            assert not bool(ovf.any()), t
            out.append((nal_len, dryrun.valid_bytes(nal, nal_len)))
            state = batch.SessionState(state.frame_num + 1, state.wp_offsets,
                                       state.wp_ltidx, state.wp_valid,
                                       state.wp_count)
        return state, out

    def sessions():
        state = batch.SessionState.create(B, device=dev)
        state.frame_num += torch.arange(B, device=dev, dtype=torch.int32) % 5
        return state

    ctx0 = {"step": 0, "rotation": 5}
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    want = serve(sessions(), ctx0, 0, T)[1]
    state, got = serve(sessions(), ctx0, 0, evict)
    snapshot.save_serving_state(tmp_path / "serving.npz", state,
                                dict(ctx0, step=evict))
    del state
    state, ctx = snapshot.load_serving_state(tmp_path / "serving.npz",
                                             device=dev)
    assert ctx == dict(ctx0, step=evict) and state.frame_num.device == dev
    got += serve(state, ctx, ctx["step"], T)[1]
    for t, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1]), t
    torch.cuda.synchronize()
    assert (_kernels.EMIT_FUSED.launches,
            _kernels.COMPOSITE_GRID.launches) == (2 * T, 2 * T)


def test_dryrun_multigpu_on_card(dev):
    from h264_scroll_encoder_tpu_torch.parallel import dryrun

    report = dryrun.dryrun_multigpu(_card_blocks(dev))
    assert report["egress ring"] == 4 * 2 * len(_card_blocks(dev))


# ---------------------------------------------------------------------------
# The measurement probes (P1-P3, csrc/probe_kernels.cu) and the shared
# header they are built from (csrc/emit_device.cuh).
# ---------------------------------------------------------------------------

def _probe_shapes(dev):
    """P1's inputs: {name: (patterns, nbits, nal_ref_idc, n_rbsp, kwargs)}
    at the 720p splice (B = 256) and scroll shapes and on K1's cluster
    plan (the dense frame of I_PCM donors, B = 4)."""
    from h264_scroll_encoder_tpu_torch.scripts import _probe_common as common

    cfg = ComposerConfig(1280, 720)
    payloads = [cases.splice_donor_payload(k) for k in range(4)]
    dn, bits, align = cases.prepare_splice_donors(payloads, engine="python",
                                                  device=dev)
    n_rbsp = cases.splice_budget(cfg, int(bits.max()), static_bg=False)
    pat, nb = cases.splice_symbols(cfg, dn, 256, n_rbsp, dev)
    out = {"splice": (pat, nb, 0, n_rbsp, dict(align=bool(align.any()),
                                               append_tb=True))}
    s_pat, s_nb, idc, s_rbsp = common.scroll_symbols(cfg, 256, dev)
    out["scroll"] = (s_pat, s_nb, idc, s_rbsp, dict(append_tb=True))
    d_dn, d_bits, d_align = cases.prepare_dense_donors("ipcm", engine="python",
                                                       device=dev, n=4)
    d_pat, d_nb, d_rbsp = cases.dense_symbols(cfg, "ipcm", d_dn, d_bits, dev)
    out["dense_ipcm"] = (d_pat, d_nb, 0, d_rbsp, dict(align=d_align,
                                                      append_tb=True))
    return out


def test_emit_stage_kernel_at_every_stage(dev):
    """P1 at each stage equals its plain version on the 720p splice and
    scroll symbols and on K1's cluster plan (the dense I_PCM frame, 4
    blocks a session); `full` equals K1."""
    from h264_scroll_encoder_tpu_torch.ops import probes

    for name, (pat, nb, idc, n_rbsp, kw) in _probe_shapes(dev).items():
        with torch.cuda.device(dev):
            c = _kernels.emit_plan(pat.element_size(), pat.shape[1],
                                   emit_fused.items_per_thread(pat.shape[1]),
                                   emit_fused.nal_bytes(n_rbsp, cases.CAP))
        assert c == (4 if name == "dense_ipcm" else 1)
        for int32 in (False, True):
            p, n = ((cases.int32_bits(pat), cases.int32_bits(nb)) if int32
                    else (pat.to(torch.int64), nb.to(torch.int64)))
            for stage in probes.EMIT_STAGES:
                args = (stage, p, n, idc, n_rbsp, cases.CAP)
                got = probes.emit_stage_batch(*args, **kw)
                _same(got, probes.emit_stage_plain(*args, cluster=c, **kw))
            _same(probes.emit_stage_batch("full", p, n, idc, n_rbsp, cases.CAP,
                                          **kw),
                  emit_fused.emit_nal_fused_batch(p, n, idc, n_rbsp, cases.CAP,
                                                  **kw))


def test_pack_u16_kernel_on_the_exact_cases(dev):
    """P2 equals K2 and K2's plain version on the JAX probe's eight cases
    and on a session whose bits pass 65,536, and refuses 2,049 words."""
    from h264_scroll_encoder_tpu_torch.ops import probes
    from h264_scroll_encoder_tpu_torch.scripts import pack_u16_probe

    for pat, nb in pack_u16_probe.exact_cases():
        for int32 in (False, True):
            p, n = (_cu(pat, dev, int32), _cu(nb, dev, int32))
            want = bitpack_flat.pack_words_place_plain(p, n, 2048)
            _same(probes.pack_place_u16_batch(p, n, 2048), want)
            _same(bitpack_flat.pack_words_place_batch(p, n, 2048), want)
    p, n = (_cu(a, dev) for a in pack_u16_probe.hostile_case())
    assert int(probes.pack_place_u16_batch(p, n, 2048)[1][0]) > 65_536
    with torch.cuda.device(dev):
        assert _kernels.pack_u16_max_words() == probes.U16_MAX_WORDS
    launched = _kernels.PACK_PLACE_U16.launches
    with pytest.raises(ValueError):
        probes.pack_place_u16_batch(p, n, 2049)
    assert _kernels.PACK_PLACE_U16.launches == launched


@pytest.mark.parametrize("tile", [1, 2, 4, 8, 16])
def test_pack_tiled_kernel_at_every_tile(dev, tile):
    """P3 at each tile equals K2's plain version at B = 256 on the JAX
    probe's input and on its B = 16 check, and refuses B % T != 0."""
    from h264_scroll_encoder_tpu_torch.ops import probes
    from h264_scroll_encoder_tpu_torch.scripts import (_probe_common,
                                                       pack_tiled_probe)

    pat, nb = _probe_common.probe_symbols(256, dev)
    for p, n in ((pat.to(torch.int64), nb.to(torch.int64)),
                 (cases.int32_bits(pat), cases.int32_bits(nb)),
                 tuple(_cu(a, dev) for a in pack_tiled_probe.exact_case())):
        _same(probes.pack_place_tiled_batch(p, n, 2048, tile),
              bitpack_flat.pack_words_place_plain(p, n, 2048))
    if tile > 1:
        launched = _kernels.PACK_PLACE_TILED.launches
        with pytest.raises(ValueError):
            probes.pack_place_tiled_batch(pat[:tile + 1], nb[:tile + 1], 2048,
                                          tile)
        assert _kernels.PACK_PLACE_TILED.launches == launched


def _digest(outs) -> str:
    import hashlib

    h = hashlib.sha256()
    for o in outs:
        h.update(str(o.dtype).encode())
        h.update(o.to(torch.int64).cpu().numpy().tobytes())
    return h.hexdigest()


def test_production_kernels_unchanged_by_the_shared_header(dev):
    """K1-K4 on phase 3's byte, alignment, pack and EBSP cases give the
    digests their plain versions give on the CPU: moving their device
    code into csrc/emit_device.cuh changed no output."""
    pat, nb = cases.byte_stream_cases()
    a_pat, a_nb = cases.align_cases()
    b_pat, b_nb, b_rbsp = cases.pack_boundary_cases(19 * 512 + 1)
    rbsp, lens, _hdr = cases.ebsp_cases()
    runs = [
        (emit_fused.emit_nal_fused_batch, emit_fused.emit_nal_fused_plain,
         (pat, nb, 2, cases.N_RBSP, cases.CAP), dict(append_tb=True)),
        (emit_fused.emit_nal_fused_batch, emit_fused.emit_nal_fused_plain,
         (a_pat, a_nb, 3, cases.N_RBSP, cases.CAP),
         dict(align=True, append_tb=True)),
        (emit_fused.emit_nal_fused_batch, emit_fused.emit_nal_fused_plain,
         (b_pat, b_nb, 0, b_rbsp, cases.CAP), dict(align=True, append_tb=True)),
        (bitpack_flat.pack_words_place_batch, bitpack_flat.pack_words_place_plain,
         (b_pat.clip(min=0), b_nb.clip(min=0), b_rbsp // 4), {}),
        (bitpack_flat.pack_words_batch, bitpack_flat.pack_words_place_plain,
         (b_pat.clip(min=0), b_nb.clip(min=0), b_rbsp // 8), {}),
    ]
    for kernel, plain, (p, n, *rest), kw in runs:
        on_card = kernel(_cu(p, dev), _cu(n, dev), *rest, **kw)
        on_cpu = plain(torch.as_tensor(np.asarray(p).astype(np.int64)),
                       torch.as_tensor(np.asarray(n).astype(np.int64)), *rest,
                       **kw)
        assert _digest(on_card) == _digest(on_cpu)
    rb = torch.as_tensor(rbsp, device=dev)
    ln = torch.as_tensor(lens.astype(np.int64), device=dev)
    assert (_digest(ebsp_flat.rbsp_to_nal_batch(rb, ln, 0x41, cases.EBSP_N_NAL,
                                                cases.CAP))
            == _digest(ebsp_flat.rbsp_to_nal_plain(rb.cpu(), ln.cpu(), 0x41,
                                                   cases.EBSP_N_NAL, cases.CAP)))


# ---------------------------------------------------------------------------
# P4 (csrc/cavlc_lockstep.cu) and P5/P6 (h264t_ebsp_variant in
# csrc/probe_kernels.cu).
# ---------------------------------------------------------------------------

def test_cavlc_lockstep_kernel(dev):
    """P4 equals its plain version and the host truth on the probe's
    streams (64 lanes x 64 blocks, and 300 lanes: a partial block of
    lanes), on the hostile streams, on rows read through a row stride, and
    on corrupted streams that run off their rows (bytes past a row read
    as zeros in both)."""
    from h264_scroll_encoder_tpu_torch.ops import cavlc_lockstep as L
    from h264_scroll_encoder_tpu_torch.scripts import cavlc_device_probe

    luts = L.device_luts(dev)
    data, truth, _bits = L.probe_streams(64, 64, L.SEED)
    h_data, h_truth = cavlc_device_probe.hostile_streams(8)
    wide = np.tile(data, (5, 1))[:300]
    bad = data.copy()
    bad[:, ::7] ^= 0x5A
    for d, k, want in ((data, 64, truth), (h_data, h_truth.shape[1], h_truth),
                       (wide, 64, np.tile(truth, (5, 1, 1))[:300]),
                       (bad, 96, None)):
        x = torch.as_tensor(d, device=dev)
        before = _kernels.CAVLC_LOCKSTEP.launches
        got = L.decode_lockstep_batch(x, k, luts)
        assert _kernels.CAVLC_LOCKSTEP.launches == before + 1
        _same(got, L.decode_lockstep_plain(x, k, luts))
        if want is not None:
            np.testing.assert_array_equal(got[1].cpu().numpy(), want)
    x = torch.zeros((64, data.shape[1] + 3), dtype=torch.uint8, device=dev)
    x[:, 3:] = torch.as_tensor(data, device=dev)
    _same(L.decode_lockstep_batch(x[:, 3:], 64, luts),
          L.decode_lockstep_plain(x[:, 3:], 64, luts))


def _ebsp_variant_inputs(dev):
    """[(rows, lengths, n_nal)]: the fused probe's exact cases, the cumsum
    and fused probes' B = 256 payloads at their NAL sizes, hostile rows
    (all zeros, all 0x03, a row past the cap) and rows read through a
    stride."""
    from h264_scroll_encoder_tpu_torch.scripts import (ebsp_cumsum_probe,
                                                       ebsp_fused_probe,
                                                       ebsp_stage_probe)

    rows, lens = ebsp_fused_probe.exact_cases()
    out = [(torch.as_tensor(rows, device=dev), _i64(lens, dev),
            ebsp_fused_probe.n_nal_of(ebsp_fused_probe.EXACT_BYTES))]
    for n_rbsp in (5960, 16384):
        rb, ln = ebsp_stage_probe.payload(256, n_rbsp, dev)
        out.append((rb, ln, ebsp_fused_probe.n_nal_of(n_rbsp)))
        if n_rbsp == 5960:
            out.append((rb, ln, ebsp_cumsum_probe.n_nal_of(n_rbsp)))
    hostile, h_lens = ebsp_cumsum_probe.hostile_rows()
    wide = torch.zeros((3, 5967), dtype=torch.uint8, device=dev)
    wide[:, 5:-2] = torch.as_tensor(hostile, device=dev)
    for n_nal in (ebsp_cumsum_probe.n_nal_of(5960),
                  ebsp_fused_probe.n_nal_of(5960)):
        out.append((torch.as_tensor(hostile, device=dev), _i64(h_lens, dev),
                    n_nal))
        out.append((wide[:, 5:-2], _i64([5000, 64, 5960], dev), n_nal))
    return out


@pytest.mark.parametrize("variant", ["runs", "ballot", "shared", "direct",
                                     "lanes"])
def test_ebsp_variant_kernel(dev, variant):
    """Each P5/P6 variant equals K3 and K3's plain version (bytes and
    count, also past the cap) on every input, one launch a call."""
    from h264_scroll_encoder_tpu_torch.ops import probes

    over = 0
    for rows, lens, n_nal in _ebsp_variant_inputs(dev):
        args = (rows, lens, 0x41, n_nal, cases.CAP)
        counter = _kernels.EBSP_VARIANT[variant]
        before = counter.launches
        got = probes.ebsp_variant_batch(variant, *args)
        assert counter.launches == before + 1
        want = ebsp_flat.rbsp_to_nal_plain(*args)
        _same(got, want)
        _same(ebsp_flat.rbsp_to_nal_batch(*args), want)
        over += int((got[1] > cases.CAP).sum())
    assert over >= 6      # all zeros and the salted row, at each NAL size


# ---------------------------------------------------------------------------
# Compiled steps (utils/graphs): every graphed path at 720p, replayed over
# 8 calls with changing inputs against its eager run, byte for byte.
# ---------------------------------------------------------------------------

def _replays_run_k1(fn, calls=3, kernel="emit_fused_kernel"):
    """fn is one graph launch a call, whose replays each run the kernel."""
    from h264_scroll_encoder_tpu_torch.utils import timing

    got = timing.profile_step(fn, calls)
    assert got is not None, "torch.profiler saw no device time"
    assert got["api_by_kind"].get("cudaGraphLaunch") == 1
    runs = sum(n for k, n in got["kernel_counts"].items() if kernel in k)
    assert runs == calls, got["kernel_counts"]


def _splice_call(cfg, dn32, B, dev):
    """Call t of the rows or dense splice step: the header of frame 3 + t
    and the 32 donors rotated by t over B sessions."""
    def args_at(t, _outs):
        fn = torch.full((B,), 3 + t, dtype=torch.int32, device=dev)
        z = torch.zeros((B, MAX_WAYPOINTS), dtype=torch.int32, device=dev)
        hp, hn = slice_headers.p_slice_header_symbols(
            cfg, fn, 2 * fn, False, -1, 0, z, z.bool())
        zero = torch.zeros((B, cfg.mb_height, cfg.mb_width),
                           dtype=torch.int32, device=dev)
        rows = (torch.arange(B, device=dev) + t) % 32
        return (hp, hn, zero, zero, zero, zero.bool(),
                {k: v[rows] for k, v in dn32.items()})
    return args_at


def test_graphed_scroll_step_on_card(dev):
    """The B = 256 scroll step: 8 replays equal eager (NAL, lengths,
    bits, flags, next state), one capture, each replay one graph launch
    running K1 and counted once in K1's launches."""
    cfg, B = ComposerConfig(1280, 720), 256
    sched = torch.as_tensor(cases.bench_schedule(720, B, 8), device=dev)
    step = batch.make_batched_step(cfg)
    step.reset()
    state = batch.SessionState.create(B, device=dev)
    outs, captures = cases.graph_replays(
        step, lambda t, o: (state if o is None else o[0], sched[t]))
    assert captures == 1 and step.stats()[0]["pool_bytes"] > 0
    state = outs[0]
    _kernels.reset_launch_counts()
    step(state, sched[0])
    torch.cuda.synchronize()
    assert _kernels.EMIT_FUSED.launches == 1
    _replays_run_k1(lambda: step(state, sched[0]))


@pytest.mark.parametrize("program,B", [("compact", 256), ("compact", 1024),
                                       ("static", 256), ("static", 1024),
                                       ("ebsp_exact", 256)])
def test_graphed_rows_step_serves_fresh_donors_on_card(dev, program, B):
    """The rows splice programs at B = 256 and 1,024: fresh donors every
    call replay one graph (one capture), equal to eager; the exact retry
    runs K2."""
    cfg = ComposerConfig(1280, 720)
    dn, bits, align = _splice_donors(dev)
    step = cases.splice_steps(cfg, int(bits.max()), bool(align.any()))[program]
    step.reset()
    args_at = _splice_call(cfg, dn, B, dev)
    outs, captures = cases.graph_replays(step, args_at)
    assert captures == 1 and not bool(outs[3].any())
    _replays_run_k1(lambda: step(*args_at(0, None)),
                    kernel=("pack_place" if program == "ebsp_exact"
                            else "emit_fused_kernel"))


def test_graphed_dense_step_on_card(dev):
    cfg, B = ComposerConfig(1280, 720), 256
    dn, bits, align = cases.prepare_dense_donors("representative",
                                                 engine="native", device=dev)
    step = cases.dense_step(cfg, "representative", bits, align)
    step.reset()
    args_at = _splice_call(cfg, dn, B, dev)
    outs, captures = cases.graph_replays(step, args_at)
    assert captures == 1 and not bool(outs[3].any())
    _replays_run_k1(lambda: step(*args_at(1, None)))


def test_graphed_dense_ipcm_step_replays_the_cluster_launch(dev):
    """The dense step of I_PCM-bearing donors at B = 64 (K1 on clusters of
    4 blocks): replays equal eager, one capture, and each replay runs the
    cluster kernel once."""
    cfg, B = ComposerConfig(1280, 720), 64
    dn, bits, align = cases.prepare_dense_donors("ipcm", engine="native",
                                                 device=dev)
    step = cases.dense_step(cfg, "ipcm", bits, align)
    step.reset()
    args_at = _splice_call(cfg, dn, B, dev)
    outs, captures = cases.graph_replays(step, args_at)
    assert captures == 1 and not bool(outs[3].any())
    _replays_run_k1(lambda: step(*args_at(1, None)),
                    kernel="emit_fused_cluster_kernel")


def test_graphed_hint_step_on_card(dev):
    """The B = 256 hint step, its sessions rolled and frame numbers moved
    each call; the golden digest holds on a replay."""
    cfg = ComposerConfig(1280, 720)
    step = batch.make_batched_hint_step(cfg, compact_x=True, device=dev)
    step.reset()
    base = cases.hint_step_inputs()
    names = ("frame_num", "ref", "mv_x", "mv_y", "wp_count", "wp_ltidx",
             "wp_valid")

    def args_at(t, _outs):
        return tuple(torch.as_tensor(np.roll(base[k], t, axis=0) + (
            t if k == "frame_num" else 0), device=dev) for k in names)

    outs, captures = cases.graph_replays(step, args_at)
    assert captures == 1
    nal, nal_len, _bits, ovf = cases.run_hint_step(step, base)
    want = json.loads(cases.SESSION_GOLDEN_PATH.read_text())["hint_step"]
    assert cases.hint_step_digest(nal.cpu().numpy(), nal_len.cpu().numpy(),
                                  ovf.cpu().numpy()) == want
    _replays_run_k1(lambda: step(*args_at(2, None)))


@pytest.mark.parametrize("kind,exact", [("scroll_frame", False),
                                        ("scroll_frame", True),
                                        ("waypoint_frame", False),
                                        ("waypoint_frame", True)])
def test_graphed_session_frames_on_card(dev, kind, exact):
    """The session's frame graphs (and their ebsp_exact retries) over 8
    frames of one session's packed rows, offsets and registry changing."""
    from h264_scroll_encoder_tpu_torch import session

    cfg = ComposerConfig(1280, 720)
    fn = session.graphed_frame(kind, cfg, False, "floor", exact)
    fn.reset()
    s = session.ComposerSession(cfg, device=dev)
    offsets = (16, 496, 500, 700, 992, 1000, 1200, 1400)

    def args_at(t, _outs):
        s.frame_num = 2 + t
        if t in (2, 5):
            s.waypoints.register(496 * (t // 2))
        return (s._frame_row(offsets[t]),)

    outs, captures = cases.graph_replays(fn, args_at)
    assert captures == 1 and outs[0].shape[0] == 1
    row = s._frame_row(700)
    _replays_run_k1(lambda: fn(row),
                    kernel="pack_place" if exact else "emit_fused_kernel")


def test_graphed_session_sliced_and_hint_frames_on_card(dev):
    from h264_scroll_encoder_tpu_torch import session
    from h264_scroll_encoder_tpu_torch.models import hints
    from h264_scroll_encoder_tpu_torch.models.splice import (FrameHints,
                                                             MotionRegion)

    cfg = ComposerConfig(1280, 720)
    s = session.ComposerSession(cfg, device=dev)
    sliced = session.graphed_sliced_frame(cfg, False)
    sliced.reset()
    outs, captures = cases.graph_replays(
        sliced, lambda t, o: (s._frame_row(40 * t), 9))
    assert captures == 1 and outs[0].shape[:2] == (1, 5)
    hint = hints.graphed_hint_frame(cfg, True)
    hint.reset()

    def hint_row(t, _outs):
        regions = (MotionRegion(0, 2 * t, 80, 2 * t + 4, ref_idx=t % 2,
                                mv_y=-4 * t),)
        return (torch.as_tensor(hints.hint_frame_row(
            cfg, 2 + t, FrameHints(motion_regions=regions)), device=dev),)

    outs, captures = cases.graph_replays(hint, hint_row)
    assert captures == 1
    row = hint_row(3, None)[0]
    _replays_run_k1(lambda: hint(row))


def test_graphed_session_streams_equal_eager_on_card(dev, monkeypatch):
    """A ComposerSession on the frame graphs writes the stream that one
    on the eager frame functions writes: scroll and waypoint frames, a
    forced ebsp_exact retry, sliced and hint frames."""
    from h264_scroll_encoder_tpu_torch import session
    from h264_scroll_encoder_tpu_torch.models import hints
    from h264_scroll_encoder_tpu_torch.models.splice import (FrameHints,
                                                             MotionRegion)

    cfg = ComposerConfig(1280, 720)

    def drive(s):
        s.write_parameter_sets()
        s.write_test_atlases(striped=True)
        for off in (0, 64, 496, 500, 720, 992, 1100):
            s.write_scroll_or_waypoint_frame(off)
        s.write_scroll_frame_sliced(1200, 9)
        s.write_hint_frame(FrameHints(motion_regions=(
            MotionRegion(0, 4, 80, 20, ref_idx=1, mv_y=-32),)))
        fast = s._scroll_fn
        s._scroll_fn = lambda row: (*fast(row)[:3],
                                    torch.ones(1, dtype=torch.bool, device=dev))
        s.write_scroll_frame(1300)
        return s.getvalue()

    graphed = drive(session.ComposerSession(cfg, device=dev))
    for mod, name in ((session, "graphed_frame"),
                      (session, "graphed_sliced_frame"),
                      (hints, "graphed_hint_frame")):
        make = getattr(mod, name)
        monkeypatch.setattr(mod, name,
                            lambda *a, make=make, **k: make(*a, **k).eager)
    assert drive(session.ComposerSession(cfg, device=dev)) == graphed


def test_graphed_sharded_step_on_card(dev):
    """make_sharded_step's blocks replay one graph per device (two blocks
    on cuda:0 on one card share it) and equal its .eager."""
    cfg, B = ComposerConfig(1280, 720), 256
    devices = _card_blocks(dev)
    sched = torch.as_tensor(cases.bench_schedule(720, B, 8))
    sstep = batch.make_sharded_step(cfg, devices)
    blocks = batch.shard_batch(batch.SessionState.create(B, device=dev),
                               devices)
    for offs in sched:
        offs_b = batch.shard_batch(offs, devices)
        new, outs = sstep(blocks, offs_b)
        want_state, want = sstep.eager(blocks, offs_b)
        torch.cuda.synchronize()
        for g, w in zip(batch.gather_batch(outs, dev),
                        batch.gather_batch(want, dev)):
            assert torch.equal(g, w)
        for g, w in zip(batch.gather_batch(new, dev).to_numpy().values(),
                        batch.gather_batch(want_state, dev).to_numpy().values()):
            np.testing.assert_array_equal(g, w)
        blocks = new
    step = batch.make_batched_step(cfg)
    keys = {k for k in step.graphs
            if any(leaf[:2] == ("tensor", (B // len(devices),))
                   for leaf in k[1])}
    assert len(keys) == len({str(d) for d in devices})


def test_capture_failure_raises_without_eager_fallback(dev):
    """A step that reads a device value on the host (.item()) cannot be
    captured: every call raises GraphCaptureError naming the step, and no
    call returns an eager result; the card keeps working."""
    from h264_scroll_encoder_tpu_torch.utils import graphs

    g = graphs.graphed(lambda x: x * int(x.sum().item()), "item step")
    x = torch.ones(4, device=dev)
    for _ in range(2):
        with pytest.raises(graphs.GraphCaptureError, match="item step"):
            g(x)
    assert g.captures == 0 and not g.graphs
    assert torch.equal(x + 1, torch.full((4,), 2.0, device=dev))


# ---------------------------------------------------------------------------
# K5 and K6 (ops/grid): the symbol stages' grid kernels.
# ---------------------------------------------------------------------------

def _grid_same(got, want):
    """Kernel outputs on the card equal the plain version's (any device),
    None where the plain version has none."""
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize("name", [c[0] for c in cases.COMPOSITE_GRID_CASES])
def test_composite_grid_kernel(dev, name):
    rect, compact_x, nr_arg, _nr, bg, dn = cases.composite_grid_case(name)
    want = grid.composite_grid_plain(
        *rect, *cases.grid_args((nr_arg, *bg, dn), "cpu"), compact_x=compact_x)
    before = _kernels.COMPOSITE_GRID.launches
    got = grid.composite_grid_batch(
        *rect, *cases.grid_args((nr_arg, *bg, dn), dev), compact_x=compact_x)
    assert _kernels.COMPOSITE_GRID.launches == before + 1
    _grid_same(got, want)


@pytest.mark.parametrize("name", [c[0] for c in cases.SCROLL_GRID_CASES])
def test_scroll_grid_kernel(dev, name):
    pskip, compact_x, nr_arg, _nr, fields = cases.scroll_grid_case(name)
    kw = dict(enable_pskip=pskip, compact_x=compact_x)
    want = grid.scroll_grid_plain(*cases.grid_args((*fields, nr_arg), "cpu"),
                                  **kw)
    before = _kernels.SCROLL_GRID.launches
    got = grid.scroll_grid_batch(*cases.grid_args((*fields, nr_arg), dev),
                                 **kw)
    assert _kernels.SCROLL_GRID.launches == before + 1
    _grid_same(got, want)


@pytest.mark.parametrize("name,parts", [
    (c[0], p) for c in cases.COMPOSITE_GRID_CASES
    for p in grid.allowed_parts(*c[1])])
def test_composite_grid_kernel_forced_parts(dev, name, parts):
    """K5 with its session forced into each band plan the shape allows
    (one block, or a cluster of P blocks with the scan carried across)."""
    rect, compact_x, nr_arg, _nr, bg, dn = cases.composite_grid_case(name)
    want = grid.composite_grid_plain(
        *rect, *cases.grid_args((nr_arg, *bg, dn), "cpu"), compact_x=compact_x)
    before = _kernels.COMPOSITE_GRID.launches
    got = grid.composite_grid_batch(
        *rect, *cases.grid_args((nr_arg, *bg, dn), dev), compact_x=compact_x,
        parts=parts)
    assert _kernels.COMPOSITE_GRID.launches == before + 1
    _grid_same(got, want)


@pytest.mark.parametrize("name,parts", [
    (c[0], p) for c in cases.SCROLL_GRID_CASES
    for p in grid.allowed_parts(*c[1])])
def test_scroll_grid_kernel_forced_parts(dev, name, parts):
    """K6 likewise, at each band plan the shape allows."""
    pskip, compact_x, nr_arg, _nr, fields = cases.scroll_grid_case(name)
    kw = dict(enable_pskip=pskip, compact_x=compact_x)
    want = grid.scroll_grid_plain(*cases.grid_args((*fields, nr_arg), "cpu"),
                                  **kw)
    before = _kernels.SCROLL_GRID.launches
    got = grid.scroll_grid_batch(*cases.grid_args((*fields, nr_arg), dev),
                                 parts=parts, **kw)
    assert _kernels.SCROLL_GRID.launches == before + 1
    _grid_same(got, want)


def test_grid_plan_is_the_twins(dev):
    """The library's band plan equals ops/grid's rule over the library's
    capacities (blocks the card holds at once), and its band arithmetic
    (band edges, a thread's run, shared memory) equals ops/grid's; a
    session at B = 1 spreads over 16 blocks at 720p and 5120x3200."""
    shapes = ((45, 80), (68, 120), (135, 240), (200, 320), (8, 10), (65, 64),
              (6, 10), (1, 9), (7, 1))
    for kind in (grid.GRID_COMPOSITE, grid.GRID_SCROLL):
        for h, w in shapes:
            n = h * w
            cap = {p: _kernels.grid_capacity(n, w, p, kind)
                   for p in grid.PARTS if p <= h}
            for B in (1, 4, 64, 256, 1024):
                assert _kernels.grid_plan(n, w, B, kind) == \
                    grid.plan_from_capacity(B, h, w, cap), (kind, h, w, B)
            for p in grid.PARTS:
                edges = [_kernels.grid_arithmetic("band_row", h, p, r)
                         for r in range(p + 1)]
                assert list(zip(edges, edges[1:])) == grid.band_rows(h, p)
                assert _kernels.grid_arithmetic("items", n, w, p) == \
                    grid.grid_items_per_thread(h, w, p)
                assert _kernels.grid_arithmetic("smem", n, w, p, kind) == \
                    grid.grid_smem_bytes(kind, h, w, p)
                if p not in grid.allowed_parts(h, w):
                    assert cap.get(p, 0) == 0
        assert _kernels.grid_plan(3600, 80, 1, kind) == 16
        assert _kernels.grid_plan(64000, 320, 1, kind) == 16


def test_grid_refuses_a_shape_no_plan_fits(dev):
    """A frame whose one row passes a block (1 x 20,000 MBs: a band can
    only be that row) raises RuntimeError naming the shape, before any
    launch."""
    g = torch.zeros((1, 1, 20_000), dtype=torch.int32, device=dev)
    dn = {k: torch.zeros(1, dtype=torch.int32, device=dev)
          for k in grid.ROLE_FIELDS + ("coded",)}
    before = (_kernels.SCROLL_GRID.launches, _kernels.COMPOSITE_GRID.launches)
    with pytest.raises(RuntimeError, match="1x20000"):
        grid.scroll_grid_batch(g, g, g, 2, enable_pskip=True)
    with pytest.raises(RuntimeError, match="1x20000"):
        grid.composite_grid_batch(0, 0, 1, 1, 2, g, g, g, g, dn)
    assert (_kernels.SCROLL_GRID.launches,
            _kernels.COMPOSITE_GRID.launches) == before


def test_grid_kernels_read_inputs_in_place(dev):
    """Strided, sliced and broadcast inputs, int64 and int16 grids, uint8
    coded masks and a device num_refs read as they lie: equal to the
    plain version, and the wrappers run no tensor op around the launch."""
    rect, _c, _nr_arg, nr, bg, dn = cases.composite_grid_case("interior")
    ref, mvx, mvy, coded = cases.grid_args(bg, dev)
    wide = torch.zeros(ref.shape[:2] + (2 * ref.shape[2],),
                       dtype=torch.int16, device=dev)
    wide[:, :, ::2] = mvx.to(torch.int16)
    args = (rect[0], rect[1], rect[2], rect[3],
            torch.as_tensor(nr, device=dev)[:, None],
            ref.to(torch.int64), wide[:, :, ::2], mvy, coded.to(torch.uint8),
            {k: torch.as_tensor(np.stack([v, v], axis=-1), device=dev)[..., 0]
             if k.endswith("mvy") else torch.as_tensor(v, device=dev)
             for k, v in dn.items()})
    for compact_x in (False, True):
        _grid_same(grid.composite_grid_batch(*args, compact_x=compact_x),
                   grid.composite_grid_plain(*args, compact_x=compact_x))
        assert cases.compute_ops(lambda: grid.composite_grid_batch(
            *args, compact_x=compact_x)) == []
    pskip, compact_x, _nr_arg, nr, fields = cases.scroll_grid_case("pskip")
    ref, mvx, mvy = cases.grid_args(fields, dev)
    one = ref[:1].expand(4, -1, -1)                 # batch stride 0
    for f, nr_dev in (((ref.to(torch.int16), mvx, mvy.to(torch.int64)),
                       torch.as_tensor(nr, device=dev)),
                      ((one, mvx, mvy), 3)):
        kw = dict(enable_pskip=pskip, compact_x=compact_x)
        _grid_same(grid.scroll_grid_batch(*f, nr_dev, **kw),
                   grid.scroll_grid_plain(*f, nr_dev, **kw))
        assert cases.compute_ops(
            lambda: grid.scroll_grid_batch(*f, nr_dev, **kw)) == []


@pytest.mark.parametrize("path", ["rows", "dense"])
def test_composite_grid_kernel_on_the_splice_steps(dev, path):
    """K5 on the 720p splice steps' own inputs at B = 1, 64, 256 and 1,024
    (32 donors in turn): the rows wire (compact_x) and the dense wire;
    the wrapper runs no tensor op around its launch."""
    cfg = ComposerConfig(1280, 720)
    if path == "rows":
        dn, _bits, _align = _splice_donors(dev)
    else:
        dn, _bits, _align = cases.prepare_dense_donors(
            "representative", engine="native", device=dev)
    for B in (1, 64, 256, 1024):
        args, kw = cases.composite_grid_inputs(cfg, dn, B, dev,
                                               rows=path == "rows")
        _grid_same(grid.composite_grid_batch(*args, **kw),
                   grid.composite_grid_plain(*args, **kw))
        assert cases.compute_ops(
            lambda: grid.composite_grid_batch(*args, **kw)) == []


def test_scroll_grid_kernel_on_its_paths(dev):
    """K6 on the 720p scroll and hint steps' inputs at B = 256, a
    session's 720p frame and the 1920x1088, 3840x2160 and 5120x3200 hint
    frames (the wide layout); the wrapper runs no tensor op around its
    launch."""
    for name, (args, kw) in cases.scroll_grid_inputs(dev).items():
        _grid_same(grid.scroll_grid_batch(*args, **kw),
                   grid.scroll_grid_plain(*args, **kw))
        assert cases.compute_ops(
            lambda: grid.scroll_grid_batch(*args, **kw)) == [], name


def test_symbol_stages_launch_the_grid_kernels(dev):
    """On the card p_frame_symbols launches K6 once and _dense_prologue K5
    once, and neither runs its plain version."""
    from h264_scroll_encoder_tpu_torch.models import splice_device

    cfg = ComposerConfig(1280, 720)
    calls = []
    real = (grid.scroll_grid_plain, grid.composite_grid_plain)
    try:
        grid.scroll_grid_plain = lambda *a, **k: calls.append("K6")
        grid.composite_grid_plain = lambda *a, **k: calls.append("K5")
        (args, kw), = [v for k, v in cases.scroll_grid_inputs(dev).items()
                       if k == "hint_720p"]
        hp, hn = slice_headers.p_slice_header_symbols(
            cfg, torch.full((256,), 3, dtype=torch.int32, device=dev),
            torch.full((256,), 6, dtype=torch.int32, device=dev),
            False, -1, 0, *_registry_zeros(256, dev)[1:3])
        before = _kernels.SCROLL_GRID.launches
        scroll.p_frame_symbols(cfg, hp, hn, *args, **kw)
        assert _kernels.SCROLL_GRID.launches == before + 1
        dn, _b, _a = cases.prepare_dense_donors("representative",
                                                engine="native", device=dev)
        (r0, c0, R, C, nr, *bg, fields), _kw = cases.composite_grid_inputs(
            cfg, dn, 8, dev, rows=False)
        before = _kernels.COMPOSITE_GRID.launches
        splice_device._dense_prologue(cfg, r0, c0, R, C, nr, *bg, fields)
        assert _kernels.COMPOSITE_GRID.launches == before + 1
    finally:
        grid.scroll_grid_plain, grid.composite_grid_plain = real
    assert calls == []


# ---------------------------------------------------------------------------
# K7: the P slice header's symbol stream.
# ---------------------------------------------------------------------------

def _k7_same(cfg, qp, tensors):
    """K7 through p_slice_header_symbols: one launch (none at B = 0),
    equal slot for slot to the plain version on the same CUDA inputs."""
    B = tensors["frame_num"].shape[0]
    before = _kernels.P_SLICE_HEADER.launches
    got = slice_headers.p_slice_header_symbols(cfg, slice_qp_delta=qp,
                                               **tensors)
    assert _kernels.P_SLICE_HEADER.launches == before + (1 if B else 0)
    assert got[0].shape == (B, slice_headers.P_HEADER_SLOTS)
    _same(got, slice_headers.p_slice_header_symbols_plain(
        cfg, slice_qp_delta=qp, **tensors))
    return got


@pytest.mark.parametrize("B", cases.HEADER_BATCHES)
@pytest.mark.parametrize("k", range(len(cases.HEADER_CONFIGS)))
def test_p_slice_header_kernel_sweep(dev, k, B):
    """Every configuration of the sweep (log2_max_frame_num 4-16 with the
    frame number's wrap, POC types 0 and 2, deblocking on and off,
    slice_qp_delta -12/0/+12) at B = 0, 1, 256 and 1,024: the sweep with
    registry holes, the sliced rows' first_mb and every short-term lead
    equal to the plain version; the writer's sessions also bit for bit
    against write_p_slice_header and byte for byte after K1."""
    cfg, qp = cases.header_config(k)
    _k7_same(cfg, qp, cases.header_tensors(cases.header_case(B, 100 + k),
                                           dev))
    case = cases.header_case(B, k, writer=True)
    hp, hn = _k7_same(cfg, qp, cases.header_tensors(case, dev))
    if not B:
        return
    assert (cases.symbol_bits(hp.cpu(), hn.cpu())
            == cases.header_writer_bits(cfg, case, qp))
    nal, nal_len, _bits, ovf = emit_fused.emit_nal_fused_batch(
        hp, hn, 2, 256, cases.CAP, append_tb=True)
    assert not bool(ovf.any())
    nal, nal_len = nal.cpu().numpy(), nal_len.cpu().numpy()
    assert ([nal[b, :nal_len[b]].tobytes() for b in range(B)]
            == cases.header_writer_nals(cfg, case, qp))


@pytest.mark.parametrize("variant", ["int32", "int64", "narrow", "strided"])
def test_p_slice_header_kernel_reads_inputs_in_place(dev, variant):
    """int64, int16 and uint8, strided (every other element, registry
    columns of a wider array) inputs read as they lie: equal to the plain
    version, and the wrapper runs no tensor op around its launch."""
    cfg, qp = cases.header_config(4)
    t = cases.header_tensors(cases.header_case(256, 9), dev, variant)
    _k7_same(cfg, qp, t)
    assert cases.compute_ops(lambda: slice_headers.p_slice_header_symbols(
        cfg, slice_qp_delta=qp, **t)) == []


def test_p_slice_header_kernel_scalars_and_extremes(dev):
    """Python scalars and 0-dim tensors shared by every session equal [B]
    tensors of the same values; the ends of int32 (ue of 0xffffffff, the
    wraps of long_term_idx + 1 and prev_ref_abs_diff - 1) equal the plain
    version."""
    cfg, qp = cases.header_config(1)
    t = cases.header_tensors(cases.header_case(9, 3), dev)
    shared = dict(poc_lsb=6, is_reference=True, long_term_idx=4,
                  num_waypoints=3, first_mb=720, prev_ref_abs_diff=2)
    want = _k7_same(cfg, qp, {**t, **{
        k: torch.full((9,), v, dtype=torch.int32, device=dev)
        for k, v in shared.items()}})
    _same(_k7_same(cfg, qp, {**t, **shared}), want)
    zero_dim = {k: torch.tensor(v, device=dev) for k, v in shared.items()}
    _same(_k7_same(cfg, qp, {**t, **zero_dim}), want)
    assert cases.compute_ops(lambda: slice_headers.p_slice_header_symbols(
        cfg, slice_qp_delta=qp, **{**t, **shared})) == []
    for k in (0, 5):
        cfg, qp = cases.header_config(k)
        _k7_same(cfg, qp, cases.header_tensors(cases.header_extremes_case(),
                                               dev))


def test_p_slice_header_kernel_refuses_what_it_cannot_read(dev, monkeypatch):
    """An input on another device, of a float dtype, of another shape, a
    list, an int past int32 or a 0-dim frame_num raises before any launch,
    and the plain version never runs for CUDA tensors."""
    def plain(*_a, **_k):
        raise AssertionError("the plain version ran for CUDA tensors")

    monkeypatch.setattr(slice_headers, "p_slice_header_symbols_plain", plain)
    cfg, qp = cases.header_config(0)
    t = cases.header_tensors(cases.header_case(8, 1), dev)
    bad = [(TypeError, dict(poc_lsb=t["poc_lsb"].float())),
           (ValueError, dict(num_waypoints=t["num_waypoints"].cpu())),
           (ValueError, dict(long_term_idx=t["long_term_idx"][:, None])),
           (ValueError, dict(first_mb=t["first_mb"][:4])),
           (ValueError, dict(wp_valid=t["wp_valid"][:, :4])),
           (TypeError, dict(wp_long_term_idx=t["wp_long_term_idx"].tolist())),
           (TypeError, dict(is_reference=np.ones(8, bool))),
           (ValueError, dict(prev_ref_abs_diff=1 << 31)),
           (ValueError, dict(frame_num=t["frame_num"][0]))]
    before = _kernels.P_SLICE_HEADER.launches
    for err, change in bad:
        with pytest.raises(err):
            slice_headers.p_slice_header_symbols(cfg, slice_qp_delta=qp,
                                                 **{**t, **change})
    with pytest.raises(ValueError):
        slice_headers.p_slice_header_symbols(cfg, slice_qp_delta=1 << 31,
                                             **t)
    assert _kernels.P_SLICE_HEADER.launches == before
    slice_headers.p_slice_header_symbols(cfg, slice_qp_delta=qp, **t)
    assert _kernels.P_SLICE_HEADER.launches == before + 1


@pytest.mark.parametrize("path", ["scroll step B=256", "scroll_frame",
                                  "waypoint_frame", "sliced frame"])
def test_p_slice_header_kernel_in_the_graphs(dev, path):
    """The scroll step's and the session frames' graphs run K7 once a
    replay (counted once a replay), and hold fewer than 200 nodes."""
    from h264_scroll_encoder_tpu_torch import session

    cfg = ComposerConfig(1280, 720)
    s = session.ComposerSession(cfg, device=dev)
    s.frame_num = 5
    if path == "scroll step B=256":
        fn = batch.make_batched_step(cfg)
        sched = torch.as_tensor(cases.bench_schedule(720, 256, 2), device=dev)
        state = batch.SessionState.create(256, device=dev)
        args = (state, sched[1])
    elif path == "sliced frame":
        fn = session.graphed_sliced_frame(cfg, False)
        args = (s._frame_row(100), cases.SESSION_ROWS_PER_SLICE)
    else:
        fn = session.graphed_frame(path, cfg, False, "floor", False)
        args = (s._frame_row(496 if path == "waypoint_frame" else 500),)
    fn.reset()
    eager = fn.eager(*args)
    fn(*args)                                   # eager run, then capture
    (stats,) = fn.stats()
    assert stats["launches"]["h264t_p_slice_header"] == 1
    assert stats["nodes"] < 200, stats
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    for _ in range(3):
        out = fn(*args)
    torch.cuda.synchronize()
    assert _kernels.P_SLICE_HEADER.launches == 3

    def leaves(x):
        return [v for v in pytree.tree_leaves(x) if isinstance(v, torch.Tensor)]

    _same(leaves(out), leaves(eager))


# ---------------------------------------------------------------------------
# K8: egress compaction (parallel/batch.compact_batch_nal).
# ---------------------------------------------------------------------------

def _k8_same(nal, lens, cap):
    """K8 through compact_batch_nal: one launch and no tensor op besides
    its outputs' allocation, equal byte for byte, with total and overflow,
    to the plain version on the same CUDA inputs."""
    before = _kernels.COMPACT_NAL.launches
    got = batch.compact_batch_nal(nal, lens, cap)
    assert _kernels.COMPACT_NAL.launches == before + 1
    want = batch.compact_batch_nal_plain(nal, lens, cap)
    _same(got, want)
    assert got[0].shape == (cap,) and got[1].shape == got[2].shape == ()
    return got


@pytest.mark.parametrize("name", list(cases.COMPACT_CASES))
def test_compact_nal_kernel_sweep(dev, name):
    """Every case of the sweep (B = 1 to 4,096, empty rows and batches,
    widths not a multiple of 4 or 16, sessions and rows at every
    alignment, int32 and int64 lengths, strided rows and lengths) at every
    cap (above, at, one below and far below the total, 1 and 0): equal to
    the plain version and to numpy's concatenation, overflow truncating at
    the cap; no tensor op around the launch."""
    case = cases.compact_case(name)
    nal, lens = cases.compact_tensors(case, dev)
    for cap in case["caps"]:
        got = _k8_same(nal, lens, cap)
        want = cases.compact_reference(case["nal"], case["nal_len"], cap)
        assert got[0].cpu().numpy().tobytes() == want[0]
        assert (int(got[1]), bool(got[2])) == want[1:]
    assert cases.compute_ops(lambda: batch.compact_batch_nal(
        nal, lens, case["caps"][0])) == []


@pytest.mark.parametrize("name", ["b7_ragged", "b256_scroll", "b1024_pooled",
                                  "b4096_tiny", "strided_lengths"])
def test_compact_nal_kernel_in_a_graph(dev, name):
    """compact_batch_nal captured as a CUDA graph (utils/graphs) is one
    kernel node, K8, counted once a replay; each replay on new rows and
    lengths (caps above, at and below the total) equals the plain
    version."""
    from h264_scroll_encoder_tpu_torch.utils import graphs

    fn = graphs.graphed(batch.compact_batch_nal, "compact")
    case = cases.compact_case(name)
    nal, lens = cases.compact_tensors(case, dev)
    for cap in (case["caps"][0], case["total"], case["total"] // 3):
        fn.reset()
        fn(nal, lens, cap)                      # eager run, then capture
        (stats,) = fn.stats()
        assert stats["nodes"] == 1 and stats["launches"] == {
            "h264t_compact_nal": 1}, stats
        for seed in (1, 2, 3):
            other = cases.compact_case(name, seed)
            o_nal, o_lens = cases.compact_tensors(other, dev)
            torch.cuda.synchronize()
            before = _kernels.COMPACT_NAL.launches
            got = fn(o_nal, o_lens, cap)
            torch.cuda.synchronize()
            assert _kernels.COMPACT_NAL.launches == before + 1
            _same(got, batch.compact_batch_nal_plain(o_nal, o_lens, cap))


def test_compact_nal_kernel_refuses_what_it_cannot_read(dev, monkeypatch):
    """A dtype, shape or stride K8 cannot read, inputs on two devices, a cap
    outside [0, 2**31) raise before any launch, and the plain version never
    runs for CUDA tensors."""
    def plain(*_a, **_k):
        raise AssertionError("the plain version ran for CUDA tensors")

    monkeypatch.setattr(batch, "compact_batch_nal_plain", plain)
    nal, lens = cases.compact_tensors(cases.compact_case("b7_ragged"), dev)
    bad = [(TypeError, (nal.int(), lens, 64)),
           (TypeError, (nal, lens.short(), 64)),
           (TypeError, (nal, lens.tolist(), 64)),
           (ValueError, (nal, lens.cpu(), 64)),
           (ValueError, (nal.cpu(), lens, 64)),
           (ValueError, (nal, lens[:3], 64)),
           (ValueError, (nal[:0], lens[:0], 64)),
           (ValueError, (nal[:, ::2], lens, 64)),
           (ValueError, (nal, lens, -1)),
           (ValueError, (nal, lens, 1 << 31))]
    before = _kernels.COMPACT_NAL.launches
    for err, args in bad:
        with pytest.raises(err):
            batch.compact_batch_nal(*args)
    assert _kernels.COMPACT_NAL.launches == before
    batch.compact_batch_nal(nal, lens, 64)
    assert _kernels.COMPACT_NAL.launches == before + 1


def test_compact_nal_kernel_on_the_tracer(dev):
    """Under the composer's tracer each call is one `batch.compact` span
    (device-timed) and one K8 launch in launch_counts(); the caps count in
    `batch.compact_positions`."""
    case = cases.compact_case("b256_scroll")
    nal, lens = cases.compact_tensors(case, dev)
    cap = case["caps"][0]
    batch.compact_batch_nal(nal, lens, cap)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    TRACER.clear()
    with TRACER.recording():
        for _ in range(5):
            batch.compact_batch_nal(nal, lens, cap)
        report = TRACER.report()
    span = report["spans"]["batch.compact"]
    assert span["calls"] == 5 and span["device_ms"] > 0
    assert report["counters"]["batch.compact_positions"] == 5 * cap
    assert _kernels.launch_counts()["h264t_compact_nal"] == 5
    TRACER.clear()


# ---------------------------------------------------------------------------
# 4K scrolling sessions (the benchmark's configuration scroll2160p).
# ---------------------------------------------------------------------------

def _scroll_config(width, height):
    """The benchmark's 4K scroll configuration (scroll2160p) at width x
    height: (the port's ComposerConfig, the plain reference's Sps)."""
    from pathlib import Path

    from portbench import drive

    path = Path(__file__).resolve().parent.parent / "portbench" / "configs"
    config = {**json.loads((path / "scroll2160p.json").read_text()),
              "width": width, "height": height}
    return drive.composer_config(config), drive.sps_of(config)


def _striped_session(cfg, dev):
    from h264_scroll_encoder_tpu_torch import session

    s = session.ComposerSession(cfg, device=dev)
    s.write_parameter_sets()
    s.write_test_atlases(striped=True)
    return s


def test_4k_session_through_four_waypoints_equals_the_reference(dev):
    """A 3840x2160 session through its four waypoints on the card, its
    frames replayed from the scroll and waypoint graphs after their first
    call: every frame byte-equal to the plain reference
    (portbench/reference/scroll), none retried."""
    from portbench.reference import scroll as ref_scroll

    cfg, sps = _scroll_config(3840, 2160)
    s, ref = _striped_session(cfg, dev), ref_scroll.Session()
    retries = _kernels.PACK_PLACE.launches
    for off in (8, 488, 496, 504, 992, 1000, 1488, 1984, 2144, 1500, 8,
                1000):
        s.write_scroll_or_waypoint_frame(off)
        want, _waypoint = ref.step(sps, off)
        assert s.writer._chunks[-1] == want, off
    assert s.waypoints.offsets[:s.waypoints.count] == [496, 992, 1488, 1984]
    assert _kernels.PACK_PLACE.launches == retries


@pytest.mark.parametrize("size,chunks,wide", [((3840, 2160), 8, 1),
                                              ((1280, 720), 1, 0)],
                         ids=["4k", "720p"])
def test_plan_counters_of_session_frames(dev, size, chunks, wide):
    """Under the tracer each session frame counts the chunks K1 stages (8
    for a 4K frame on one block, 1 at 720p) and a wide K6 launch at 4K
    (none at 720p), eager and replayed alike; the registry's depth and the
    bounded NAL buffer fetched."""
    cfg, _sps = _scroll_config(*size)
    s = _striped_session(cfg, dev)
    offsets = (8, 496, 504, 512, 520, 8)
    TRACER.disable()
    TRACER.clear()
    try:
        with TRACER.recording():
            for off in offsets:
                s.write_scroll_or_waypoint_frame(off)
        c = TRACER.summary()["counters"]
    finally:
        TRACER.clear()
    n = len(offsets)
    assert c["session.frames"] == n and c["session.exact_retries"] == 0
    assert c["emit.chunks"] == chunks * n
    assert c["grid.wide_launches"] == wide * n
    assert c["session.waypoints"] == 0 + 0 + 1 + 1 + 1 + 1
    n_nal = emit_fused.nal_bytes(
        scroll._n_rbsp(cfg.total_mbs, scroll.SCROLL_FAST_RBSP_BITS_PER_MB),
        cases.CAP)
    assert c["session.fetch_bytes"] == n * (n_nal + 5)


# ---------------------------------------------------------------------------
# The main paths at their real shapes: the symbols K1-K4 are handed, the
# scroll and splice steps with egress, the session and its host tools.
# ---------------------------------------------------------------------------

def _splice_donors(dev):
    """The 32 representative donors on the blob wire (native engine)."""
    pays = [cases.splice_donor_payload(k) for k in range(32)]
    return cases.prepare_splice_donors(pays, engine="native", device=dev)


@pytest.mark.parametrize("path", ["scroll", "partitioned", "splice"])
def test_kernels_on_the_720p_main_path_symbols(dev, path):
    """K1 on the symbols the 720p main paths hand it at B = 256 (step 0 of
    the benchmark's scroll schedule, its partitioned frames, the compact
    splice of the 32 donors in turn; the splice also at 1,024): int32
    from the symbol stages, one block a session, equal to the plain
    version on them and widened to int64, no frame flagged, and no tensor
    op in the wrapper.  On the splice frames also K2 and K4 (the
    ebsp_exact input) and K3 (their RBSP bytes, int64 lengths, read in
    place and through a row stride), each equal to its plain version with
    no tensor op around it; K4 then K3 give K1's NAL on every frame."""
    cfg, B = ComposerConfig(1280, 720), 256
    if path == "splice":
        dn, bits, align = _splice_donors(dev)
        n_rbsp = cases.splice_budget(cfg, int(bits.max()), static_bg=False)
        pat, nb = cases.splice_symbols(cfg, dn, B, n_rbsp, dev)
        idc, kw = 0, dict(align=bool(align.any()), append_tb=True)
    else:
        state = batch.SessionState.create(B, device=dev)
        offs = torch.as_tensor(cases.bench_schedule(720, B, 1)[0], device=dev)
        needs = scroll.needs_waypoint(offs, state.wp_offsets, state.wp_valid,
                                      state.wp_count)
        pat, nb, n_rbsp, idc = scroll.unified_frame_symbols(
            cfg, state.frame_num, offs, state.wp_offsets, state.wp_ltidx,
            state.wp_valid, state.wp_count, needs,
            boundary_policy="floor" if path == "scroll" else path)
        assert idc.dtype == torch.int32
        kw = dict(append_tb=True)
    assert pat.dtype == nb.dtype == torch.int32
    n_nal = emit_fused.nal_bytes(n_rbsp, cases.CAP)
    with torch.cuda.device(dev):
        assert _kernels.emit_plan(4, pat.shape[1],
                                  emit_fused.items_per_thread(pat.shape[1]),
                                  n_nal) == 1
    for p, n in ((pat.to(torch.int64), nb.to(torch.int64)), (pat, nb)):
        args = (p, n, idc, n_rbsp, cases.CAP)
        k1 = emit_fused.emit_nal_fused_batch(*args, **kw)
        _same(k1, emit_fused.emit_nal_fused_plain(*args, **kw))
        assert not bool(k1[3].any())
    assert cases.compute_ops(lambda: emit_fused.emit_nal_fused_batch(
        pat, nb, idc, n_rbsp, cases.CAP, **kw)) == []
    if path != "splice":
        return
    args = (*cases.splice_symbols(cfg, dn, 1024, n_rbsp, dev), idc, n_rbsp,
            cases.CAP)
    _same(emit_fused.emit_nal_fused_batch(*args, **kw),
          emit_fused.emit_nal_fused_plain(*args, **kw))
    tb_pat, tb_nb = bitpack.trailing_bits_symbol(nb.sum(dim=1,
                                                        dtype=torch.int32))
    e_pat = torch.cat([pat, tb_pat[:, None]], dim=1)
    e_nb = torch.cat([nb, tb_nb[:, None]], dim=1)
    n_words = (n_rbsp + 3) // 4
    words, total = bitpack_flat.pack_words_place_plain(e_pat, e_nb, n_words)
    for fn in (bitpack_flat.pack_words_place_batch,
               bitpack_flat.pack_words_batch):
        _same(fn(e_pat, e_nb, n_words), (words, total))
        assert cases.compute_ops(lambda: fn(e_pat, e_nb, n_words)) == []
    rbsp = bitpack.words_to_bytes(words)[:, :n_rbsp].to(torch.uint8)
    rbsp_len = (total // 8).to(torch.int64)
    with torch.cuda.device(dev):
        assert not _kernels.ebsp_nal_in_global(n_nal)
    wide = torch.zeros((B, n_rbsp + 9), dtype=torch.uint8, device=dev)
    wide[:, 3:-6] = rbsp
    for rows in (rbsp, wide[:, 3:-6]):
        args = (rows, rbsp_len, 0x01, n_nal, cases.CAP)
        nal3, count3 = ebsp_flat.rbsp_to_nal_batch(*args)
        _same((nal3, count3), ebsp_flat.rbsp_to_nal_plain(*args))
        assert cases.compute_ops(lambda: ebsp_flat.rbsp_to_nal_batch(*args)) == []
    nal1, len1, _bits, ovf1 = k1
    len3 = 5 + total // 8 + count3
    both = ~ovf1 & (count3 <= cases.CAP)
    assert bool(both.all())
    for b in range(B):
        n = int(len1[b])
        assert int(len3[b]) == n and torch.equal(nal3[b, :n], nal1[b, :n]), b


def _egress_same(nal, nal_len):
    """A step's rows through egress as the benchmark sends them: K8 into
    the whole buffer (B * N), equal to its plain version."""
    cap = nal.numel()
    _same(batch.compact_batch_nal(nal, nal_len, cap),
          batch.compact_batch_nal_plain(nal, nal_len, cap))


def test_scroll_step_at_b256_on_card(dev):
    """The 720p scroll step at B = 256 over 16 steps of the benchmark's
    schedule: no frame flagged, each NAL in its row, each step's rows
    through egress equal to the plain version, and each step one launch
    each of K1, K6, K7 and (egress) K8, none of K2."""
    cfg, B, steps = ComposerConfig(1280, 720), 256, 16
    sched = torch.as_tensor(cases.bench_schedule(720, B, steps), device=dev)
    step = batch.make_batched_step(cfg)
    state = batch.SessionState.create(B, device=dev)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    for offs in sched:
        state, (nal, nal_len, _wp, _bits, ovf) = step(state, offs)
        assert not bool(ovf.any())
        assert bool(((nal_len > 5) & (nal_len <= nal.shape[1])).all())
        _egress_same(nal, nal_len)
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    assert {k: counts[k] for k in (
        "h264t_emit_fused", "h264t_scroll_grid", "h264t_p_slice_header",
        "h264t_compact_nal", "h264t_pack_place")} == {
            "h264t_emit_fused": steps, "h264t_scroll_grid": steps,
            "h264t_p_slice_header": steps, "h264t_compact_nal": steps,
            "h264t_pack_place": 0}


def test_rows_splice_steps_on_card(dev):
    """The rows splice programs at bench.py's geometry over the 32 donors
    tiled to B = 256 and 1,024 (the native engine's wire on the card
    equal to the Python engine's): compact and static-chrome, and the
    ebsp_exact retry at 256.  Every session equals its donor's golden
    digest, no frame is flagged, each step's rows go through egress equal
    to the plain version; K1 launches once a step (K2 in the retry in its
    place), K5 in the compact programs only, K8 once an egress."""
    cfg = ComposerConfig(1280, 720)
    dn, bits, align = _splice_donors(dev)
    dn_py, bits_py, _ = cases.prepare_splice_donors(
        [cases.splice_donor_payload(0)], engine="python", device="cpu")
    assert torch.equal(dn["blob"][0].cpu(), dn_py["blob"][0])
    assert int(bits_py[0]) == int(bits[0])
    golden = json.loads(cases.SPLICE_GOLDEN_PATH.read_text())
    steps = cases.splice_steps(cfg, int(bits.max()), bool(align.any()))
    runs = (("compact", 256), ("static", 256), ("ebsp_exact", 256),
            ("compact", 1024), ("static", 1024))
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    for name, B in runs:
        nal, nal_len, _bits, ovf = steps[name](
            *cases.splice_session_inputs(cfg, B, dev), cases.tile_donors(dn, B))
        assert not bool(ovf.any())
        _egress_same(nal, nal_len)
        idx = [b for b in range(B) if b % 32 < cases.SPLICE_GOLDEN_BATCH]
        got = cases.digest_step(nal[idx].cpu().numpy(),
                                nal_len[idx].cpu().numpy(),
                                np.zeros(len(idx), bool), ovf[idx].cpu().numpy())
        assert got == [golden[name][b % 32] for b in idx], (name, B)
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    assert {k: counts[k] for k in (
        "h264t_emit_fused", "h264t_pack_place", "h264t_composite_grid",
        "h264t_compact_nal")} == {
            "h264t_emit_fused": 4, "h264t_pack_place": 1,
            "h264t_composite_grid": 3, "h264t_compact_nal": 5}


@pytest.mark.parametrize("B", [256, 1024])
def test_dense_step_equals_the_rows_step_on_card(dev, B):
    """The dense splice step over the 32 representative donors tiled to B
    sessions: one K1 and one K5 launch, every session equal to its donor's
    golden digest and, byte for byte, to the rows step's frame of the same
    donor; at B = 256 also the forced ebsp_exact retry, one K2 launch,
    equal to the golden digests."""
    cfg = ComposerConfig(1280, 720)
    golden = json.loads(cases.DENSE_GOLDEN_PATH.read_text())["representative"]
    dn, bits, align = cases.prepare_dense_donors("representative",
                                                 engine="native", device=dev)
    inputs = cases.splice_session_inputs(cfg, B, dev)

    def check(out):
        nal, nal_len, _bits, ovf = out
        assert not bool(ovf.any())
        assert cases.digest_step(nal.cpu().numpy(), nal_len.cpu().numpy(),
                                 np.zeros(B, bool), ovf.cpu().numpy()) == [
            golden[b % cases.DENSE_DONORS] for b in range(B)]

    step = cases.dense_step(cfg, "representative", bits, align)
    torch.cuda.synchronize()
    before = (_kernels.EMIT_FUSED.launches, _kernels.COMPOSITE_GRID.launches)
    nal, nal_len, _bits, ovf = step(*inputs, cases.tile_donors(dn, B))
    torch.cuda.synchronize()
    assert (_kernels.EMIT_FUSED.launches - before[0],
            _kernels.COMPOSITE_GRID.launches - before[1]) == (1, 1)
    check((nal, nal_len, _bits, ovf))
    r_dn, r_bits, r_align = _splice_donors(dev)
    rows = cases.splice_steps(cfg, int(r_bits.max()),
                              bool(r_align.any()))["compact"]
    r_nal, r_len, _rb, r_ovf = rows(*inputs, cases.tile_donors(r_dn, B))
    assert not bool(r_ovf.any()) and torch.equal(r_len, nal_len)
    n = min(r_nal.shape[1], nal.shape[1])
    valid = torch.arange(n, device=dev)[None, :] < nal_len[:, None]
    assert torch.equal(torch.where(valid, r_nal[:, :n], 0),
                       torch.where(valid, nal[:, :n], 0))
    if B == 256:
        before = _kernels.PACK_PLACE.launches
        check(cases.dense_step(cfg, "representative", bits, align,
                               ebsp_exact=True)(*inputs,
                                                cases.tile_donors(dn, B)))
        torch.cuda.synchronize()
        assert _kernels.PACK_PLACE.launches == before + 1


def test_session_golden_on_card(dev, tmp_path):
    """Every golden session stream composed on the card (the main 720p
    session, the partitioned and nearest sessions, the scroll-encoder and
    composer CLIs, the 1920x1088 hint frame, the 3840x2160 scroll frame)
    equals the JAX package's digest (golden/session_720p.json; the hint
    step's: test_hint_step_and_its_compaction_on_card) and passes
    verify_stream, one K1 launch a device P-frame, K6 on the way.  On two
    of them the host tools: the trans-resizer's two engines agree on the
    composer CLI's stream, and the MP4 mux of the scroll-encoder CLI's
    stream is ftyp/moov/mdat with one sample a frame."""
    from h264_scroll_encoder_tpu_torch.models.splice import transcode_pad_stream
    from h264_scroll_encoder_tpu_torch.utils import mp4mux
    from h264_scroll_encoder_tpu_torch.verify import verify_stream

    golden = json.loads(cases.SESSION_GOLDEN_PATH.read_text())
    assert golden["config"] == cases.session_golden_config()
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    streams = cases.session_streams(cases.port_package(), tmp_path, device=dev)
    assert set(streams) == set(golden) - {"config", "hint_step"}
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    device_frames = -cases.SESSION_SPLICED_FRAMES   # spliced on the host
    for name, data in streams.items():
        assert cases.stream_digest(data) == golden[name], name
        rep = verify_stream(data)
        assert rep.ok, (name, rep.errors[:3])
        device_frames += rep.frame_count - 2        # all but the atlases
    assert counts["h264t_emit_fused"] == device_frames
    assert counts["h264t_scroll_grid"] > 0
    cfg = ComposerConfig(1280, 720)
    widened = {e: transcode_pad_stream(streams["composer_cli"],
                                       cfg.width + 16, cfg.height, engine=e)
               for e in ("native", "python")}
    assert widened["native"] == widened["python"]
    assert verify_stream(widened["native"]).ok
    stream = streams["scroll_encoder_cli"]
    mp4 = mp4mux.mux(stream)
    boxes, pos = [], 0
    while pos < len(mp4):
        boxes.append(mp4[pos + 4:pos + 8])
        pos += int.from_bytes(mp4[pos:pos + 4], "big")
    _sps, _pps, samples, sync = mp4mux.annexb_to_samples(stream)
    assert boxes == [b"ftyp", b"moov", b"mdat"] and pos == len(mp4)
    assert len(samples) == verify_stream(stream).frame_count and sync == [1]


def test_session_frames_launch_their_kernels_on_card(dev):
    """A 720p session's sliced frame is one K1 and one K6 launch; a frame
    forced through the ebsp_exact retry launches K1 and K2 once each and
    writes the bytes of the same frame unforced; the P slice header of a
    session frame runs no tensor op besides K7."""
    from h264_scroll_encoder_tpu_torch.session import ComposerSession

    cfg = ComposerConfig(1280, 720)
    s = _striped_session(cfg, dev)
    for off in (0, 496, 500):
        s.write_scroll_or_waypoint_frame(off)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    s.write_scroll_frame_sliced(60, cases.SESSION_ROWS_PER_SLICE)
    torch.cuda.synchronize()
    assert (_kernels.EMIT_FUSED.launches, _kernels.SCROLL_GRID.launches) == (1, 1)
    honest, forced = (ComposerSession(cfg, device=dev) for _ in range(2))
    fast = forced._scroll_fn

    def flagged(*args):
        nal, nal_len, bits, ovf = fast(*args)
        return nal, nal_len, bits, torch.ones_like(ovf)

    forced._scroll_fn = flagged
    honest.write_scroll_frame(100)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    forced.write_scroll_frame(100)
    torch.cuda.synchronize()
    assert (_kernels.EMIT_FUSED.launches, _kernels.PACK_PLACE.launches) == (1, 1)
    assert forced.getvalue() == honest.getvalue()
    frame_num, _off, _wp_off, wp_lt, wp_valid, count = s._frame_args(500)
    poc = frame_num * 2
    assert cases.compute_ops(lambda: slice_headers.p_slice_header_symbols(
        cfg, frame_num, poc, False, -1, count, wp_lt, wp_valid)) == []


def test_hint_step_and_its_compaction_on_card(dev):
    """The B = 256 hint step (compact_x): one K1 and one K6 launch and the
    golden digest; compact_batch_nal of its rows at their total gives the
    sessions' bytes end to end (the golden sha256), one byte short it
    flags the overflow."""
    import hashlib

    cfg = ComposerConfig(1280, 720)
    step = batch.make_batched_hint_step(cfg, compact_x=True, device=dev)
    inputs = {k: torch.as_tensor(v, device=dev)
              for k, v in cases.hint_step_inputs().items()}
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    nal, nal_len, _bits, ovf = cases.run_hint_step(step, inputs)
    torch.cuda.synchronize()
    assert (_kernels.EMIT_FUSED.launches, _kernels.SCROLL_GRID.launches) == (1, 1)
    want = json.loads(cases.SESSION_GOLDEN_PATH.read_text())["hint_step"]
    assert cases.hint_step_digest(nal.cpu().numpy(), nal_len.cpu().numpy(),
                                  ovf.cpu().numpy()) == want
    total = int(nal_len.sum())
    packed, tot, c_ovf = batch.compact_batch_nal(nal, nal_len, total)
    assert int(tot) == total and not bool(c_ovf)
    assert (hashlib.sha256(packed.cpu().numpy().tobytes()).digest()
            == bytes.fromhex(want["sha256"]))
    assert bool(batch.compact_batch_nal(nal, nal_len, total - 1)[2])


def test_pixel_oracle_on_a_card_session(dev):
    """A 720p session composed on the card at MB-aligned offsets decodes
    pixel-exact under the pixel oracle: luma against the intended scroll,
    chroma against the canvas."""
    from h264_scroll_encoder_tpu_torch import pixel_oracle as po

    cfg = ComposerConfig(1280, 720)
    s = _striped_session(cfg, dev)
    offsets = (0, 16, 48, 96)
    for off in offsets:
        s.write_scroll_frame(off)
    pics = po.decode_stream_pixels(s.getvalue())
    assert len(pics) == 2 + len(offsets)
    canvas = po.scroll_canvas(pics[0], pics[1])
    for pic, off in zip(pics[2:], offsets):
        assert po.luma_mismatch_rows(pic, po.intended_scroll_luma(
            canvas, off, cfg.height)).size == 0, off
        rows = slice(off // 2, off // 2 + cfg.height // 2)
        assert (pic.cb == canvas.cb[rows]).all(), off
        assert (pic.cr == canvas.cr[rows]).all(), off


def test_avref_on_card_streams(dev, tmp_path):
    """Where the system has libavcodec (avref builds): a 720p session on
    the card takes a fallback frame mid-stream, the stream decodes with no
    error, the fallback frame shows the standalone x264 encode of its
    pixels and the frames after it compose against it; the batched
    video-in-corner demo and netflix_scroll --demo run on the card."""
    from h264_scroll_encoder_tpu_torch import avref
    from h264_scroll_encoder_tpu_torch.examples import video_in_corner_demo
    from h264_scroll_encoder_tpu_torch.models.splice import (FrameHints,
                                                             MotionRegion)
    from h264_scroll_encoder_tpu_torch.scripts import netflix_scroll

    if avref.missing() is not None:
        pytest.skip(f"avref cannot build here: {avref.missing()}")
    cfg = ComposerConfig(1280, 720)
    W, H = cfg.width, cfg.height
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[:H, :W]
    target = (((xx * 255) // W + rng.integers(0, 24, (H, W))).astype(np.uint8),
              (128 + (yy[::2, ::2] * 60) // H).astype(np.uint8),
              (128 - (xx[::2, ::2] * 60) // W).astype(np.uint8))
    s = _striped_session(cfg, dev)
    full = (0, 0, W // 16, H // 16)
    took = [s.write_hint_frame_or_fallback(FrameHints(motion_regions=(
                MotionRegion(*full, ref_idx=1),))),
            s.write_hint_frame_or_fallback(FrameHints(motion_regions=(
                MotionRegion(*full, ref_idx=5),)), fallback_frame=target),
            s.write_hint_frame_or_fallback(FrameHints(motion_regions=())),
            s.write_hint_frame_or_fallback(FrameHints(motion_regions=(
                MotionRegion(0, 0, W // 16, 2, ref_idx=0, mv_x=0, mv_y=16),)))]
    assert took == [False, True, False, False]
    pics, nerrors = avref.decode_pictures(s.getvalue())
    assert nerrors == 0 and len(pics) == 6
    ref, _ = avref.decode_pictures(avref.encode_x264(
        [target], qp=20, keyint=1, refs=1,
        extra_params="psy=0:chroma-qp-offset=0"))
    fb = pics[3]
    for p in ("y", "cb", "cr"):
        assert (getattr(fb, p) == getattr(ref[0], p)).all(), p
        assert (getattr(pics[4], p) == getattr(fb, p)).all(), p
    assert (pics[5].y[:32] == fb.y[16:48]).all()
    assert (pics[5].y[32:] == fb.y[32:]).all()
    video_in_corner_demo.main_batched(str(tmp_path / "vic.h264"), device=dev,
                                      log=lambda *a, **k: None)
    assert netflix_scroll.main(["--demo", "-n", "60", "--device", str(dev),
                                "-o", str(tmp_path / "netflix.mp4"),
                                "--extract-frames"]) == 0


@pytest.mark.parametrize("example", ["serving_demo", "splice_serving_demo",
                                     "full_pipeline_demo", "generate_refs"])
def test_examples_on_card(dev, tmp_path, example):
    """The examples and generate_refs on the card, each checking its own
    output: serving_demo's streams (720p) verify and its state survives
    a snapshot round trip; splice_serving_demo's NALs equal its CPU run's;
    full_pipeline_demo's stream verifies and muxes; generate_refs writes
    two donors of one frame each that verify."""
    from h264_scroll_encoder_tpu_torch.verify import verify_stream

    quiet = lambda *a, **k: None  # noqa: E731
    if example == "serving_demo":
        from h264_scroll_encoder_tpu_torch.examples import serving_demo

        streams = serving_demo.run(dev, out_dir=tmp_path, log=quiet)
        assert len(streams) == 8 and all(verify_stream(x).ok for x in streams)
    elif example == "splice_serving_demo":
        from h264_scroll_encoder_tpu_torch.examples import splice_serving_demo

        assert (splice_serving_demo.run(dev, log=quiet)
                == splice_serving_demo.run("cpu", log=quiet))
    elif example == "full_pipeline_demo":
        from h264_scroll_encoder_tpu_torch.examples import full_pipeline_demo

        data, mp4 = full_pipeline_demo.run(tmp_path / "full.h264", dev,
                                           log=quiet)
        assert verify_stream(data).ok and mp4[4:8] == b"ftyp"
    else:
        from h264_scroll_encoder_tpu_torch.scripts import generate_refs

        assert generate_refs.main(["--out-dir", str(tmp_path),
                                   "--device", str(dev)]) == 0
        for name in ("ref_a.h264", "ref_b.h264"):
            rep = verify_stream((tmp_path / name).read_bytes())
            assert rep.ok and rep.frame_count == 1, (name, rep.errors[:3])


def test_run_e2e_on_card(dev, tmp_path):
    """run_e2e.sh on the card at 1280x720, 60 frames: both streams verify
    and the MP4 is its scroll stream's mux."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from h264_scroll_encoder_tpu_torch.utils import mp4mux

    script = (Path(__file__).resolve().parent.parent
              / "h264_scroll_encoder_tpu_torch" / "scripts" / "run_e2e.sh")
    env = dict(os.environ, OUT=str(tmp_path), W="1280", H="720", FRAMES="60",
               DEVICE=str(dev), PYTHON=sys.executable)
    r = subprocess.run(["bash", str(script)], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert r.stdout.count('"ok": true') == 2
    assert (tmp_path / "scroll.mp4").read_bytes() == mp4mux.mux(
        (tmp_path / "scroll.h264").read_bytes())


# Each measurement script at two steps a chain and one chain, B = 256 (its
# default); P4's extra row at 4,224 lanes, a block of 32 lanes on each of
# the H100's 132 SMs.
_CARD_SCRIPTS = (
    ("emit_stage_probe", []), ("emit_wrap_probe", []),
    ("pack_u16_probe", []), ("pack_tiled_probe", []),
    ("splice_stage_profile", []), ("splice_stage_profile", ["--static"]),
    ("symbols_stage_probe", []), ("step_xprof", []), ("step_cost", []),
    ("ebsp_stage_probe", []), ("ebsp_sizing_probe", []),
    ("gpu_parity_probe", []), ("cavlc_device_probe", ["--wide", "4224"]),
    ("ebsp_cumsum_probe", []), ("ebsp_fused_probe", []))


def test_measurement_scripts_on_card(dev, capsys):
    """Every measurement script's main on the card at a small depth: exit
    0 with its table as the last line; step_cost's census keeps int64
    under 15% of each step's aten bytes; every probe kernel (P1-P6), K5
    and K6 launch in the run."""
    import importlib

    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    for name, extra in _CARD_SCRIPTS:
        mod = importlib.import_module(
            f"h264_scroll_encoder_tpu_torch.scripts.{name}")
        assert mod.main(["--steps", "2", "--reps", "1", *extra]) == 0, name
        table = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert table["script"] == name and table["rows"], name
        if name == "step_cost":
            for step, r in table["rows"].items():
                assert r["int64_share"] <= 0.15, (step, r["int64_ops"])
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    for k in (*_kernels.PROBE_KERNELS, _kernels.COMPOSITE_GRID,
              _kernels.SCROLL_GRID):
        assert counts[k.name] > 0, k.name
