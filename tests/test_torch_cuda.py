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
from h264_scroll_encoder_tpu_torch.config import ComposerConfig
from h264_scroll_encoder_tpu_torch.ops import bitpack_flat, ebsp_flat, emit_fused

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


@pytest.mark.parametrize("cap", [cases.CAP, 1000])
def test_ebsp_kernel(dev, cap):
    """K3 on the byte-stream, saturation and boundary cases
    (cases.ebsp_boundary_cases at each of its NAL sizes), with int32 and
    int64 lengths, tensor and Python-int headers, 0-dim lengths, rows read
    through a row stride other than their length, and int32 bytes."""
    rbsp, lens, hdr = cases.ebsp_cases()
    args = (torch.as_tensor(rbsp, device=dev), torch.as_tensor(lens, device=dev),
            torch.as_tensor(hdr, device=dev), cases.EBSP_N_NAL, cap)
    before = _kernels.EBSP_NAL.launches
    got = ebsp_flat.rbsp_to_nal_batch(*args)
    assert _kernels.EBSP_NAL.launches == before + 1
    _same(got, ebsp_flat.rbsp_to_nal_plain(*args))
    rb, n = cases.ebsp_saturation_case()
    args = (torch.as_tensor(rb[None], device=dev), n, 0x41, rb.size, cap)
    got = ebsp_flat.rbsp_to_nal_batch(*args)
    _same(got, ebsp_flat.rbsp_to_nal_plain(*args))
    assert int(got[1][0]) > cap or cap > 100
    rbsp, lens, hdr = cases.ebsp_boundary_cases()
    rb = torch.as_tensor(rbsp, device=dev)
    wide = torch.zeros((rb.shape[0], rb.shape[1] + 5), dtype=torch.uint8,
                       device=dev)
    wide[:, 3:-2] = rb
    inputs = [(rb, torch.as_tensor(lens, device=dev), torch.as_tensor(hdr, device=dev)),
              (rb, torch.as_tensor(lens.astype(np.int64), device=dev), 0x165),
              (wide[:, 3:-2], torch.as_tensor(lens, device=dev), 0x41),
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
    """A NAL buffer too large for one block's shared memory raises from the
    launch, launches nothing, and leaves no error for the next launch."""
    rb = torch.zeros((2, 64), dtype=torch.uint8, device=dev)
    before = _kernels.EBSP_NAL.launches
    with pytest.raises(RuntimeError, match="h264t_ebsp_nal"):
        ebsp_flat.rbsp_to_nal_batch(rb, 64, 0x41, 300_000, cases.CAP)
    assert _kernels.EBSP_NAL.launches == before
    args = (rb, 64, 0x41, 384, cases.CAP)
    _same(ebsp_flat.rbsp_to_nal_batch(*args), ebsp_flat.rbsp_to_nal_plain(*args))


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
