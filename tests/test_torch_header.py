"""The P slice header's symbol stream on the CPU: its plain version (K7's
contract, syntax/slice_headers.p_slice_header_symbols_plain) against the
host writer write_p_slice_header, bit for bit and, through K1's plain
version, byte for byte; against the JAX package over the sweep of
cases.header_case (waypoint holes, long-term marking, the short-term
lead, the sliced rows' first_mb, frame number wrap) and at the ends of
int32; in every input form K7 reads on the card.  CPU tensors never load
the kernel library.  Tolerance: exact equality (integers and bytes)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_scroll_encoder_tpu.config import ComposerConfig as JaxConfig
from h264_scroll_encoder_tpu.syntax import slice_headers as jheaders
from h264_scroll_encoder_tpu_torch import _kernels, cases
from h264_scroll_encoder_tpu_torch.ops import emit_fused
from h264_scroll_encoder_tpu_torch.syntax import slice_headers

torch.set_num_threads(1)

CONFIGS = range(len(cases.HEADER_CONFIGS))


def _plain(cfg, qp, tensors):
    return slice_headers.p_slice_header_symbols(cfg, slice_qp_delta=qp,
                                                **tensors)


def _jax(cfg, qp, case):
    jcfg = JaxConfig(cfg.width, cfg.height,
                     log2_max_frame_num=cfg.log2_max_frame_num,
                     pic_order_cnt_type=cfg.pic_order_cnt_type,
                     log2_max_pic_order_cnt_lsb=cfg.log2_max_pic_order_cnt_lsb,
                     deblocking_filter_control_present_flag=(
                         cfg.deblocking_filter_control_present_flag))
    f = jax.vmap(functools.partial(jheaders.p_slice_header_symbols, jcfg,
                                   slice_qp_delta=qp))
    i32 = {k: jnp.asarray(np.asarray(v).astype(
        bool if k in ("is_reference", "wp_valid") else np.int32))
        for k, v in case.items()}
    return f(i32["frame_num"], i32["poc_lsb"], i32["is_reference"],
             i32["long_term_idx"], i32["num_waypoints"],
             i32["wp_long_term_idx"], i32["wp_valid"], i32["first_mb"],
             prev_ref_abs_diff=i32["prev_ref_abs_diff"])


def _same(got, want):
    """Port outputs against JAX's (patterns uint32 there) or the port's."""
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        if isinstance(w, torch.Tensor):
            assert w.dtype == torch.int32 and torch.equal(g, w)
        else:
            np.testing.assert_array_equal(*cases.jax_width(g, w))


@pytest.mark.parametrize("k", CONFIGS)
def test_header_plain_equals_the_host_writer(k):
    """Bit for bit against write_p_slice_header, and byte for byte as a
    NAL unit through K1's plain version, at B = 256."""
    cfg, qp = cases.header_config(k)
    case = cases.header_case(256, k, writer=True)
    hp, hn = _plain(cfg, qp, cases.header_tensors(case, "cpu"))
    assert hp.shape == hn.shape == (256, slice_headers.P_HEADER_SLOTS)
    assert cases.symbol_bits(hp, hn) == cases.header_writer_bits(cfg, case, qp)
    nal, nal_len, _bits, ovf = emit_fused.emit_nal_fused_plain(
        hp, hn, 2, 256, cases.CAP, append_tb=True)
    assert not bool(ovf.any())
    got = [bytes(nal[b, :int(nal_len[b])].numpy()) for b in range(256)]
    assert got == cases.header_writer_nals(cfg, case, qp)


@pytest.mark.parametrize("k", CONFIGS)
def test_header_plain_equals_jax_over_the_sweep(k):
    """Registry holes and stray valid slots past the count, any POC LSB,
    the sliced rows' first_mb, absent and negative short-term leads."""
    cfg, qp = cases.header_config(k)
    case = cases.header_case(64, 100 + k)
    _same(_plain(cfg, qp, cases.header_tensors(case, "cpu")),
          _jax(cfg, qp, case))


def test_header_plain_equals_jax_at_the_ends_of_int32():
    case = cases.header_extremes_case()
    for k in (0, 1):
        cfg, qp = cases.header_config(k)
        got = _plain(cfg, qp, cases.header_tensors(case, "cpu"))
        _same(got, _jax(cfg, qp, case))
        assert int(got[1].min()) == -1          # ue(0xffffffff)


@pytest.mark.parametrize("variant", ["int64", "narrow", "strided"])
def test_header_plain_reads_every_input_form(variant):
    """The forms K7 reads in place give what int32 tensors of the same
    values give (narrow: the values as int16 holds them)."""
    cfg, qp = cases.header_config(2)
    case = cases.header_case(40, 5)
    if variant == "narrow":
        case = {k: v if v.dtype == bool else v.astype(np.int16)
                for k, v in case.items()}
    want = _plain(cfg, qp, cases.header_tensors(case, "cpu"))
    got = _plain(cfg, qp, cases.header_tensors(case, "cpu", variant))
    _same(got, want)


def test_header_plain_scalars_equal_tensors():
    """Python scalars and 0-dim tensors shared by every session give what
    [B] tensors of the same values give."""
    cfg, qp = cases.header_config(1)
    case = cases.header_case(9, 3)
    shared = dict(poc_lsb=6, is_reference=True, long_term_idx=4,
                  num_waypoints=3, first_mb=720, prev_ref_abs_diff=2)
    t = cases.header_tensors(case, "cpu")
    full = {**t, **{k: torch.full((9,), v, dtype=torch.int32)
                    for k, v in shared.items()}}
    want = _plain(cfg, qp, full)
    _same(_plain(cfg, qp, {**t, **shared}), want)
    _same(_plain(cfg, qp, {**t, **{k: torch.tensor(v)
                                   for k, v in shared.items()}}), want)


def test_header_plain_at_batch_zero():
    cfg, qp = cases.header_config(0)
    hp, hn = _plain(cfg, qp, cases.header_tensors(cases.header_case(0, 0),
                                                  "cpu"))
    assert hp.shape == hn.shape == (0, slice_headers.P_HEADER_SLOTS)


def test_header_on_cpu_tensors_never_loads_the_kernel_library(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the kernel library was loaded for CPU tensors")

    monkeypatch.setattr(_kernels, "_load", refuse)
    monkeypatch.setattr(_kernels.P_SLICE_HEADER, "launch", refuse)
    cfg, qp = cases.header_config(3)
    case = cases.header_case(16, 8)
    want = _jax(cfg, qp, case)
    _same(_plain(cfg, qp, cases.header_tensors(case, "cpu")), want)
    _same(slice_headers.p_slice_header_symbols_plain(
        cfg, slice_qp_delta=qp, **cases.header_tensors(case, "cpu")), want)
