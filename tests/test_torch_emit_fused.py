"""K1's plain version (ops/emit_fused) vs the JAX package's fused emit.

The JAX kernel runs in Pallas interpret mode here (as in
tests/test_emit_fused.py), and the JAX staged back end is the second
reference.  Tolerance: exact equality of NAL bytes, nal_len, total_bits
and overflow; bytes of flagged frames are unspecified, only their flag
(and, against the JAX kernel, nal_len and total_bits) must agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_scroll_encoder_tpu.models import scroll as jax_scroll
from h264_scroll_encoder_tpu.ops import bitpack as jbitpack
from h264_scroll_encoder_tpu.ops import ebsp as jebsp
from h264_scroll_encoder_tpu.ops import emit_fused as jemit
from h264_scroll_encoder_tpu_torch import _kernels, cases
from h264_scroll_encoder_tpu_torch.ops import ebsp, emit_fused

torch.set_num_threads(1)

N_RBSP, CAP = cases.N_RBSP, cases.CAP
N_NAL = emit_fused.nal_bytes(N_RBSP, CAP)


def _port(pat, nb, idc, cap=CAP, **kw):
    out = emit_fused.emit_nal_fused_batch(
        torch.as_tensor(pat.astype(np.int64)),
        torch.as_tensor(nb.astype(np.int64)), idc, N_RBSP, cap, **kw)
    return [x.numpy() for x in out]


def _jax_kernel(pat, nb, idc, align=False, append_tb=False, cap=CAP):
    """JAX K1 (interpret mode), batched through its custom vmap rule."""
    f = jax.jit(jax.vmap(lambda p, n: jemit.finish_nal_fused(
        p, n, N_RBSP, idc, max_insertions=cap, has_align=align,
        append_trailing=append_tb)))
    return [np.asarray(x) for x in f(jnp.asarray(pat.astype(np.uint32)),
                                      jnp.asarray(nb.astype(np.int32)))]


def _jax_staged(pat, nb, idc):
    """The JAX unfused bounded back end (pack -> windowed EBSP -> frame)."""
    def one(p, n):
        rbsp, total = jbitpack.pack_bytes_place(p, n, N_RBSP)
        rbsp_len = total // 8
        eb, el = jebsp.rbsp_to_ebsp_tree(rbsp, rbsp_len, N_NAL - 8,
                                         max_insertions=CAP)
        overflow = (total > N_RBSP * 8) | ((el - rbsp_len) > CAP)
        out = jnp.zeros((N_NAL,), jnp.uint8)
        out = jax.lax.dynamic_update_slice(out, eb, (5,))
        prefix = jnp.asarray([0, 0, 0, 1, ((idc & 3) << 5) | 1], jnp.uint8)
        out = jax.lax.dynamic_update_slice(out, prefix, (0,))
        return out, 5 + el, total, overflow
    f = jax.jit(jax.vmap(one))
    return [np.asarray(x) for x in f(jnp.asarray(pat.astype(np.uint32)),
                                      jnp.asarray(nb.astype(np.int32)))]


def _assert_agree(port, ref, *, lengths_when_flagged: bool,
                  compare_bytes: bool = True):
    """Flags equal everywhere; bytes, nal_len and total_bits equal on
    unflagged frames (and lengths on flagged ones when asked).  Returns
    the number of unflagged frames compared."""
    nal, nal_len, bits, ovf = port
    r_nal, r_len, r_bits, r_ovf = ref
    np.testing.assert_array_equal(ovf, r_ovf)
    ok = ~ovf
    if compare_bytes:
        np.testing.assert_array_equal(nal[ok], r_nal[ok])
    if lengths_when_flagged:
        ok = np.ones_like(ok)
    np.testing.assert_array_equal(nal_len[ok], r_len[ok])
    np.testing.assert_array_equal(bits[ok], r_bits[ok])
    return int((~ovf).sum())


def test_byte_streams_match_jax_kernel_and_staged():
    pat, nb = cases.byte_stream_cases(seed=0, trials=16)
    port = _port(pat, nb, 2)
    assert _assert_agree(port, _jax_kernel(pat, nb, 2),
                         lengths_when_flagged=True) >= 8
    _assert_agree(port, _jax_staged(pat, nb, 2), lengths_when_flagged=False)


def test_overflow_contract():
    pat, nb = cases.overflow_case()
    port = _port(pat[None], nb[None], 0)
    assert port[3][0]
    assert _jax_kernel(pat[None], nb[None], 0)[3][0]
    assert _jax_staged(pat[None], nb[None], 0)[3][0]


@pytest.mark.parametrize("append_tb", [False, True])
def test_align_sentinels_batched(append_tb):
    """I_PCM alignment sentinels resolved inside K1, with and without the
    trailing-bits symbol appended inside it."""
    pat, nb = cases.align_cases(seed=11, batch=12)
    assert (nb < 0).any()
    port = _port(pat, nb, 3, align=True, append_tb=append_tb)
    got = _jax_kernel(pat, nb, 3, align=True, append_tb=append_tb)
    assert _assert_agree(port, got, lengths_when_flagged=True) >= 8


def test_append_trailing_matches_jax_finish_slice():
    """Raw payload symbols + in-kernel trailing bits equal the JAX
    package's CPU finish_slice (its staged path) — the scroll back end."""
    pat, nb = cases.align_cases(seed=5, batch=6, with_sentinels=False)
    port = [x.numpy() for x in emit_fused.finish_nal_fused(
        torch.as_tensor(pat.astype(np.int64)),
        torch.as_tensor(nb.astype(np.int64)), N_RBSP, 2,
        max_insertions=CAP, append_trailing=True)]
    f = jax.jit(jax.vmap(lambda p, n: jax_scroll.finish_slice(p, n, N_RBSP,
                                                              2)))
    ref = [np.asarray(x) for x in f(jnp.asarray(pat), jnp.asarray(nb))]
    assert _assert_agree(port, ref, lengths_when_flagged=False) == 6


def test_window_boundary_sweep():
    """Zero runs of 60-72 bytes at all four byte phases: the flag, nal_len
    and total_bits equal interpret-mode K1's on every stream, so the port
    matches K1's 16-word window rule exactly (not the staged 64-byte
    one), and the sweep crosses the boundary.  The insertion cap is
    raised to 64 so that the window, not the ~36 insertions of a long
    zero run, decides the flag.  (The JAX kernel clamps byte shifts at
    26, so above that cap only its flag and lengths are meaningful; the
    bytes of unflagged streams are held against the exact numpy
    reference instead.)"""
    pat, nb, runs = cases.window_sweep_cases()
    port = _port(pat, nb, 0, cap=64)
    ref = _jax_kernel(pat, nb, 0, cap=64)
    _assert_agree(port, ref, lengths_when_flagged=True, compare_bytes=False)
    nal, nal_len, _bits, ovf = port
    assert ovf.any() and (~ovf).any()
    assert not ovf[runs < 64].any() and ovf[runs >= 68].all()
    for i in np.flatnonzero(~ovf):
        payload = pat[i][nb[i] == 8].astype(np.uint8)
        want = ebsp.rbsp_to_ebsp_np(payload)
        np.testing.assert_array_equal(nal[i, 5:nal_len[i]], want)


def test_sentinel_without_align_flags_overflow():
    """Deliberate deviation: without `align` a negative width is out of
    contract.  The JAX kernel packs it as a huge width and raises no flag;
    the port flags the frame."""
    pat, nb = cases.align_cases(seed=11, batch=12)
    has_sentinel = (nb < 0).any(axis=1)
    assert has_sentinel.any() and (~has_sentinel).any()
    ovf = _port(pat, nb, 0, append_tb=True)[3]
    np.testing.assert_array_equal(ovf, has_sentinel)


def test_wrapper_input_checks():
    """The wrapper takes [B, n] symbols on one CPU or CUDA device and
    raises on anything else (no silent fallback)."""
    z = torch.zeros((2, 8), dtype=torch.int64)
    with pytest.raises(ValueError):
        emit_fused.emit_nal_fused_batch(z, z[:, :7], 0, 64, CAP)
    with pytest.raises(ValueError):
        emit_fused.emit_nal_fused_batch(z.to("meta"), z.to("meta"), 0, 64, CAP)
    bits = torch.as_tensor([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1])
    got = _kernels.as_i32_bits(bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  bits.numpy().astype(np.uint32))
