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
from h264_scroll_encoder_tpu_torch.ops import bitpack_flat, emit_fused

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _cu(a, dev):
    return torch.as_tensor(np.asarray(a).astype(np.int64), device=dev)


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
