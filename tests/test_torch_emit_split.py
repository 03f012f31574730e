"""The cluster plan's split, modelled on the CPU: ops/emit_fused.
emit_nal_split_plain (K1) and ops/bitpack_flat.pack_words_split_plain
(K2/K4) against the unsplit plain versions and the JAX package's K1 (in
Pallas interpret mode, as tests/test_torch_emit_fused.py runs it) and
scatter pack.

Where one block's shared memory cannot hold a session, K1 and K2/K4 run
it on a thread-block cluster of C blocks: C contiguous shares of the
symbols, each with its own position map and a scan across the shares for
its start bit, and C slices of the RBSP words, whose emulation
prevention carries the zero run and the insertions across the slices.
The split models compute the outputs by those rules, for C in {1, 2, 3,
8, 16}, on the pack boundary cases, zero runs and 00 00 03 patterns
across a slice boundary, I_PCM alignment sentinels at a share boundary,
a zero run that saturates the window in the last slice, and shares with
no symbols.

Tolerance: exact equality of NAL bytes, nal_len, total_bits and overflow
against the plain version on every frame; against the JAX kernel, flags,
nal_len and total_bits on every frame and the bytes of unflagged ones
(the JAX kernel clamps byte shifts past 26 insertions, so at cap 64 only
its flags and lengths are compared).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_scroll_encoder_tpu.ops import bitpack as jbitpack
from h264_scroll_encoder_tpu.ops import emit_fused as jemit
from h264_scroll_encoder_tpu_torch import cases
from h264_scroll_encoder_tpu_torch.ops import bitpack_flat, emit_fused

torch.set_num_threads(1)

PARTS = (1, 2, 3, 8, 16)
CAP = cases.CAP
# The crafted byte streams: payloads of up to PAYLOAD bytes, cap 64 so
# that the window, not the insertions of a long zero run, flags a frame.
PAYLOAD = 1200
STREAM_RBSP = (PAYLOAD + 64 + 3) // 4 * 4
STREAM_CAP = 64


def _t(a):
    """Symbols in the symbol stages' widths: int32 (patterns as bits)."""
    return torch.as_tensor(cases.int32_bits(a))


def _jax_kernel(pat, nb, idc, *, n_rbsp, cap, align=False, append_tb=False):
    """JAX K1 (interpret mode), batched through its custom vmap rule."""
    f = jax.jit(jax.vmap(lambda p, n: jemit.finish_nal_fused(
        p, n, n_rbsp, idc, max_insertions=cap, has_align=align,
        append_trailing=append_tb)))
    return [np.asarray(x) for x in f(jnp.asarray(pat.astype(np.uint32)),
                                      jnp.asarray(nb.astype(np.int32)))]


def _check(pat, nb, idc, *, n_rbsp, cap, parts, jax_ref=None,
           compare_bytes=True, **kw):
    """The split model equals the plain version on every output of every
    frame and, where given, the JAX kernel's outputs as the module
    docstring says.  Returns the split's outputs (numpy)."""
    args = (_t(pat), _t(nb), idc, n_rbsp, cap)
    got = emit_fused.emit_nal_split_plain(*args, parts=parts, **kw)
    want = emit_fused.emit_nal_fused_plain(*args, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    got = [x.numpy() for x in got]
    if jax_ref is not None:
        nal, nal_len, bits, ovf = got
        r_nal, r_len, r_bits, r_ovf = jax_ref
        np.testing.assert_array_equal(ovf, r_ovf)
        np.testing.assert_array_equal(nal_len, r_len)
        np.testing.assert_array_equal(bits, r_bits)
        if compare_bytes:
            np.testing.assert_array_equal(nal[~ovf], r_nal[~ovf])
    return got


@functools.lru_cache(maxsize=None)
def _jax_boundary(n):
    pat, nb, n_rbsp = cases.pack_boundary_cases(n)
    return _jax_kernel(pat, nb, 1, n_rbsp=n_rbsp, cap=CAP, align=True,
                       append_tb=True)


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("n", cases.PACK_BOUNDARY_LENGTHS)
def test_split_on_pack_boundaries(n, parts):
    """The CUDA pack's run and chunk boundaries (cases.pack_boundary_cases)
    split into `parts` shares, with sentinels resolved under `align` and
    the trailing bits appended, against the plain version and
    interpret-mode K1."""
    pat, nb, n_rbsp = cases.pack_boundary_cases(n)
    _check(pat, nb, 1, n_rbsp=n_rbsp, cap=CAP, parts=parts,
           jax_ref=_jax_boundary(n),
           align=True, append_tb=True)


def _byte_rows(rows):
    """Byte payloads -> 8-bit symbols of STREAM_RBSP room, the trailing
    byte after each payload (cases._bytes_to_symbols)."""
    n_sym = max(len(r) for r in rows) + 1
    out = [cases._bytes_to_symbols(np.asarray(r), n_sym) for r in rows]
    return np.stack([p for p, _ in out]), np.stack([n for _, n in out])


def _slice_bytes(parts):
    """Bytes of each block's RBSP slice for the crafted streams."""
    n_nal = emit_fused.nal_bytes(STREAM_RBSP, STREAM_CAP)
    return 4 * emit_fused.cluster_slice(n_nal // 4, parts)


@functools.lru_cache(maxsize=None)
def _straddling_streams():
    """Payloads whose zero runs end around a slice boundary of each C in
    PARTS (the first three boundaries of each), followed by a byte that
    takes an insertion (0x00-0x03): runs of 2, 3 and 5 zeros (00 00 03
    among them) ending 2 bytes before to 1 after the boundary, and runs
    of 64 and 68 at the 16-word window's edge.  The last row ends in a
    run that saturates the window in the last slice holding payload."""
    rng = np.random.default_rng(5)
    bounds = sorted({b for parts in PARTS[1:]
                     for b in range(_slice_bytes(parts), PAYLOAD - 80,
                                    _slice_bytes(parts))[:3]})
    rows = []
    for b in bounds:
        for run in (2, 3, 5, 64, 68):
            for d in (-2, -1, 0, 1):
                vals = rng.integers(16, 256, PAYLOAD)
                end = b + d
                vals[end - run:end] = 0
                vals[end] = rng.integers(0, 4)
                rows.append(vals)
    vals = rng.integers(16, 256, PAYLOAD)
    vals[PAYLOAD - 70:] = 0
    rows.append(vals)
    return _byte_rows(rows)


@functools.lru_cache(maxsize=None)
def _jax_streams():
    pat, nb = _straddling_streams()
    return _jax_kernel(pat, nb, 0, n_rbsp=STREAM_RBSP, cap=STREAM_CAP)


@pytest.mark.parametrize("parts", PARTS)
def test_split_zero_runs_across_slices(parts):
    """Zero runs and 00 00 03 patterns across each slice boundary carry
    their run and insertions into the next slice, and a run past the
    window saturates the last slice's frame: flags, lengths and bits equal
    interpret-mode K1's, every output equals the plain version's."""
    pat, nb = _straddling_streams()
    _, _, _, ovf = _check(pat, nb, 0, n_rbsp=STREAM_RBSP, cap=STREAM_CAP,
                          parts=parts, jax_ref=_jax_streams(),
                          compare_bytes=False)
    assert ovf[-1] and (~ovf).sum() >= len(ovf) // 2


@functools.lru_cache(maxsize=None)
def _align_at_shares(n=700):
    """Random 1-16 bit symbols with I_PCM alignment sentinels (nbits -1)
    on, just before or just after every share boundary of each C in
    PARTS: one session per (C, offset)."""
    rng = np.random.default_rng(40)
    rows = [(parts, d) for parts in PARTS[1:] for d in (-1, 0, 1)]
    nb = rng.integers(1, 17, (len(rows), n)).astype(np.int32)
    pat = (rng.integers(0, 2 ** 31, nb.shape).astype(np.uint32)
           & ((1 << nb) - 1).astype(np.uint32))
    for row, (parts, d) in enumerate(rows):
        share = emit_fused.cluster_share(n, parts)
        for b0 in range(share, n, share):
            nb[row, b0 + d] = -1
            pat[row, b0 + d] = 0
    return pat, nb, (int(np.where(nb < 0, 7, nb).sum(axis=1).max()) // 8
                     + 16) // 4 * 4


@functools.lru_cache(maxsize=None)
def _jax_align():
    pat, nb, n_rbsp = _align_at_shares()
    return _jax_kernel(pat, nb, 2, n_rbsp=n_rbsp, cap=CAP, align=True,
                       append_tb=True)


@pytest.mark.parametrize("parts", PARTS)
def test_split_alignment_at_share_boundaries(parts):
    """An I_PCM alignment sentinel on a share boundary resolves from the
    share's start bit as it would unsplit; without `align` the same
    sentinels flag every frame."""
    pat, nb, n_rbsp = _align_at_shares()
    _check(pat, nb, 2, n_rbsp=n_rbsp, cap=CAP, parts=parts,
           jax_ref=_jax_align(), align=True, append_tb=True)
    _, _, _, ovf = _check(pat, nb, 2, n_rbsp=n_rbsp, cap=CAP, parts=parts,
                          append_tb=True)
    assert ovf.all()


def _short(n):
    """The first n symbols of cases.pack_boundary_cases(100)."""
    pat, nb, n_rbsp = cases.pack_boundary_cases(100)
    return pat[:, :n], nb[:, :n], n_rbsp


@functools.lru_cache(maxsize=None)
def _jax_short(n):
    pat, nb, n_rbsp = _short(n)
    return _jax_kernel(pat, nb, 3, n_rbsp=n_rbsp, cap=CAP, align=True,
                       append_tb=True)


@pytest.mark.parametrize("parts", [8, 16])
@pytest.mark.parametrize("n", [1, 5, 17])
def test_split_with_empty_shares(n, parts):
    """Sessions of fewer symbols than blocks, or whose last shares are
    empty (ceil(n / C) * (C - 1) >= n), against the plain version and
    interpret-mode K1."""
    pat, nb, n_rbsp = _short(n)
    assert emit_fused.cluster_share(n, parts) * (parts - 1) >= n
    _check(pat, nb, 3, n_rbsp=n_rbsp, cap=CAP, parts=parts,
           jax_ref=_jax_short(n), align=True, append_tb=True)


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("n", cases.PACK_BOUNDARY_LENGTHS)
def test_pack_split_on_pack_boundaries(n, parts):
    """K2's split model on the boundary cases without sentinels (the pack
    alone takes none) equals K2's plain version, and the JAX package's
    scatter pack on two sessions."""
    pat, nb, n_rbsp = cases.pack_boundary_cases(n, sentinels=False)
    n_words = n_rbsp // 4
    args = (_t(pat), _t(nb), n_words)
    got = bitpack_flat.pack_words_split_plain(*args, parts)
    want = bitpack_flat.pack_words_place_plain(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    for b in range(min(2, len(pat))):
        jw, jt = jbitpack.pack_words(jnp.asarray(pat[b]), jnp.asarray(nb[b]),
                                     n_words)
        np.testing.assert_array_equal(*cases.jax_width(got[0][b], jw))
        assert int(got[1][b]) == int(jt)


def test_cluster_geometry():
    """The shares and slices cover a session exactly once, and a thread
    owns at most CLUSTER_MAX_ITEMS symbols of a chunk."""
    for n in (0, 1, 100, 9219, 64_798, 256_040):
        for parts in emit_fused.CLUSTER_SIZES:
            share = emit_fused.cluster_share(n, parts)
            assert share * parts >= n > (share - 1) * parts
            k = emit_fused.cluster_items_per_thread(n, parts)
            assert 1 <= k <= emit_fused.CLUSTER_MAX_ITEMS
            slice_ = emit_fused.cluster_slice(n // 4, parts)
            assert slice_ % 4 == 0 and slice_ * parts >= n // 4
