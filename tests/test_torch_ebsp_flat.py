"""K3's plain version (ops/ebsp_flat) vs the JAX package's flat EBSP +
framing: `rbsp_to_nal_flat` (pure jnp) and `rbsp_to_nal_pallas`
(interpret mode here).

Tolerance: exact equality of the insertion count always, and of the NAL
bytes for in-contract streams (count <= max_insertions) whose NAL fits
its buffer (5 + rbsp_len + count <= n_nal); over the bound the JAX
kernel's bytes are unspecified and the caller retries through the exact
path, and past the buffer they wrap (a deviation the port does not copy).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_scroll_encoder_tpu.ops import ebsp_flat as jflat
from h264_scroll_encoder_tpu_torch import cases
from h264_scroll_encoder_tpu_torch.ops import ebsp, ebsp_flat

torch.set_num_threads(1)

CAP = cases.CAP


def _n_nal(n: int) -> int:
    """The JAX tests' NAL buffer for an n-byte payload."""
    return max(128, -(-(5 + n * 3 // 2 + 11) // 128) * 128)


def _case(zero_heavy: bool, n: int, seed: int):
    rng = np.random.default_rng(seed)
    b = (rng.choice([0, 0, 0, 1, 2, 3, 255], n) if zero_heavy
         else rng.integers(0, 256, n)).astype(np.uint8)
    pad = np.zeros(_n_nal(n), np.uint8)
    pad[:n] = b
    return pad


def _assert_matches(got, tot, want, want_tot, cap):
    assert int(tot) == int(want_tot)
    if int(want_tot) <= cap:
        np.testing.assert_array_equal(got, np.asarray(want))


def _batch_by_header(rbsp, lens, hdr, n_nal, cap):
    """rbsp_to_nal_batch over rows with per-row header bytes: one call per
    header value (the wrapper takes one int header), int64 lengths."""
    nal = torch.zeros((len(lens), n_nal), dtype=torch.uint8)
    tot = torch.zeros(len(lens), dtype=torch.int32)
    for h in np.unique(hdr):
        rows = np.flatnonzero(hdr == h)
        nal[rows], tot[rows] = ebsp_flat.rbsp_to_nal_batch(
            torch.as_tensor(rbsp[rows]),
            torch.as_tensor(lens[rows].astype(np.int64)), int(h), n_nal, cap)
    return nal, tot


@pytest.mark.parametrize("cap", [CAP, 1000])
@pytest.mark.parametrize("zero_heavy", [False, True])
def test_plain_matches_jax_flat(zero_heavy, cap):
    for k, n in enumerate(cases.EBSP_LENGTHS):
        pad = _case(zero_heavy, n, 100 * k + zero_heavy)
        want, want_tot = jflat.rbsp_to_nal_flat(jnp.asarray(pad), n, 0x41,
                                                pad.size, cap)
        nal, tot = ebsp_flat.rbsp_to_nal_batch(torch.as_tensor(pad)[None],
                                               torch.tensor([n]), 0x41,
                                               pad.size, cap)
        assert nal.dtype == torch.uint8 and tot.dtype == torch.int32
        _assert_matches(nal[0].numpy(), tot[0], want, want_tot, cap)


@pytest.mark.parametrize("zero_heavy", [False, True])
def test_plain_matches_jax_pallas_interpret(zero_heavy):
    for k, n in enumerate((5, 127, 517)):
        pad = _case(zero_heavy, n, 7 * k + zero_heavy)
        want, want_tot = jflat.rbsp_to_nal_pallas(jnp.asarray(pad), n, 0x61,
                                                  pad.size, CAP)
        nal, tot = ebsp_flat.rbsp_to_nal_plain(torch.as_tensor(pad)[None], n,
                                               0x61, pad.size, CAP)
        _assert_matches(nal[0].numpy(), tot[0], want, want_tot, CAP)


@pytest.mark.parametrize("cap", [CAP, 1000])
def test_batch_of_sessions_matches_per_session_jax(cap):
    """[K, m] calls with per-session lengths (one call per header byte),
    against the JAX function per session (the input is cut or zero-padded
    to the next multiple of 128 bytes of n_nal, as the JAX wrapper does)."""
    rbsp, lens, hdr = cases.ebsp_cases()
    n_nal = cases.EBSP_N_NAL
    nal, tot = _batch_by_header(rbsp, lens, hdr, n_nal, cap)
    assert nal.shape == (len(lens), n_nal)
    for b in range(len(lens)):
        want, want_tot = jflat.rbsp_to_nal_flat(
            jnp.asarray(rbsp[b]), int(lens[b]), int(hdr[b]), n_nal, cap)
        _assert_matches(nal[b].numpy(), tot[b], want, want_tot, cap)


def test_saturation_bumps_the_count_like_jax():
    rb, n = cases.ebsp_saturation_case()
    want, want_tot = jflat.rbsp_to_nal_flat(jnp.asarray(rb), n, 0x41, rb.size,
                                            CAP)
    nal, tot = ebsp_flat.rbsp_to_nal_plain(torch.as_tensor(rb)[None], n, 0x41,
                                           rb.size, CAP)
    assert int(tot[0]) == int(want_tot) > CAP


def test_in_contract_streams_equal_exact_ebsp():
    """Where the count stays within the cap, the framed payload is the
    exact emulation-prevented stream."""
    rbsp, lens, hdr = cases.ebsp_cases(seed=5)
    nal, tot = ebsp_flat.rbsp_to_nal_plain(torch.as_tensor(rbsp),
                                           torch.as_tensor(lens),
                                           torch.as_tensor(hdr),
                                           cases.EBSP_N_NAL, CAP)
    checked = 0
    for b in range(len(lens)):
        if int(tot[b]) > CAP:
            continue
        want = ebsp.rbsp_to_ebsp_np(rbsp[b, :lens[b]])
        got = nal[b].numpy()
        assert list(got[:5]) == [0, 0, 0, 1, int(hdr[b])]
        np.testing.assert_array_equal(got[5:5 + want.size], want)
        assert int(tot[b]) == want.size - int(lens[b])
        assert not got[5 + want.size:].any()
        checked += 1
    assert checked >= len(lens) // 2


def _jax_rows(rbsp, lens, hdr, n_nal, cap, fn=jflat.rbsp_to_nal_flat):
    """The JAX function per session (one shape, so it compiles once)."""
    out = [fn(jnp.asarray(rbsp[b]), int(lens[b]), int(hdr[b]), n_nal, cap)
           for b in range(len(lens))]
    return (np.stack([np.asarray(nal) for nal, _ in out]),
            np.asarray([int(tot) for _, tot in out]))


def _assert_rows_match(nal, tot, want, want_tot, lens, n_nal, cap):
    """Counts always; bytes where the stream is in contract and its NAL
    fits the buffer.  Returns the number of rows whose bytes compared."""
    np.testing.assert_array_equal(np.asarray(tot), want_tot)
    fits = (want_tot <= cap) & (5 + lens.astype(np.int64) + want_tot <= n_nal)
    np.testing.assert_array_equal(np.asarray(nal)[fits], want[fits])
    return int(fits.sum())


@pytest.mark.parametrize("cap", [CAP, 1000])
@pytest.mark.parametrize("n_nal", cases.EBSP_BOUNDARY_N_NALS)
def test_boundary_cases_match_jax_flat(n_nal, cap):
    """The run and staging boundaries of the CUDA K3 at 720p lengths
    (cases.ebsp_boundary_cases), [K, m] calls with int64 lengths (one per
    header byte), against the JAX function per session."""
    rbsp, lens, hdr = cases.ebsp_boundary_cases()
    nal, tot = _batch_by_header(rbsp, lens, hdr, n_nal, cap)
    assert nal.shape == (len(lens), n_nal)
    want, want_tot = _jax_rows(rbsp, lens, hdr, n_nal, cap)
    compared = _assert_rows_match(nal, tot, want, want_tot, lens, n_nal, cap)
    assert compared >= (11 if cap > CAP else 6)


def test_boundary_cases_match_jax_pallas_interpret():
    rbsp, lens, hdr = cases.ebsp_boundary_cases()
    pick = [0, 2, 3, 4, 13, 16]
    rbsp, lens, hdr = rbsp[pick], lens[pick], hdr[pick]
    n_nal = cases.EBSP_BOUNDARY_N_NALS[0]
    nal, tot = ebsp_flat.rbsp_to_nal_plain(torch.as_tensor(rbsp),
                                           torch.as_tensor(lens),
                                           torch.as_tensor(hdr), n_nal, 1000)
    want, want_tot = _jax_rows(rbsp, lens, hdr, n_nal, 1000,
                               jflat.rbsp_to_nal_pallas)
    assert _assert_rows_match(nal, tot, want, want_tot, lens, n_nal, 1000) >= 4


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.int16])
def test_plain_casts_bytes_to_uint8_like_jax(dtype):
    """Wider bytes are taken mod 256 first, as the JAX wrapper's uint8
    cast takes them: 41 00 00 256 01 00 00 02 has two insertions, not
    one."""
    rng = np.random.default_rng(5)
    rows = np.zeros((4, 64), dtype)
    rows[0, :8] = [0x41, 0, 0, 256, 1, 0, 0, 2]
    rows[1] = rng.choice([0, 0, 1, 256, 511, -1, 255, 3], 64)
    rows[2] = rng.choice([0, 256, -256, 512, 2], 64)
    rows[3] = rng.integers(-300, 600, 64)
    lens = np.asarray([10, 64, 64, 50], np.int32)
    hdr = np.full(4, 0x41, np.int32)
    nal, tot = ebsp_flat.rbsp_to_nal_batch(
        torch.as_tensor(rows), torch.as_tensor(lens.astype(np.int64)), 0x41,
        128, 1000)
    want, want_tot = _jax_rows(rows, lens, hdr, 128, 1000)
    assert _assert_rows_match(nal, tot, want, want_tot, lens, 128, 1000) == 4
    assert int(tot[0]) == 2


def test_out_of_buffer_nal_is_the_large_buffer_prefix():
    """In contract but past the buffer (5 + rbsp_len + count > n_nal): the
    JAX kernel's cyclic rolls wrap the overflow to the front of the
    buffer, the port writes nothing past it (ROADMAP §3).  The counts
    agree, and the port's bytes are the first n_nal of the same stream
    framed into a buffer large enough."""
    rng = np.random.default_rng(9)
    row = rng.integers(4, 256, 256).astype(np.uint8)
    for k in range(10):
        row[20 * k + 7:20 * k + 9] = 0
        row[20 * k + 9] = 1
    n, n_nal = 250, 256
    nal, tot = ebsp_flat.rbsp_to_nal_plain(torch.as_tensor(row)[None], n,
                                           0x41, n_nal, CAP)
    want, want_tot = jflat.rbsp_to_nal_flat(jnp.asarray(row), n, 0x41, n_nal,
                                            CAP)
    big, big_tot = jflat.rbsp_to_nal_flat(jnp.asarray(row), n, 0x41, 384, CAP)
    assert int(tot[0]) == int(want_tot) == int(big_tot) == 10
    assert 5 + n + int(tot[0]) > n_nal
    np.testing.assert_array_equal(nal[0].numpy(), np.asarray(big)[:n_nal])
    assert not np.array_equal(nal[0].numpy(), np.asarray(want))


def test_session_ints_are_read_in_place():
    """The kernel's per-session lengths: int64 [B] and 0-dim tensors as
    views of their own storage (stride 0 for one value)."""
    B = 4
    rbsp = torch.zeros((B, 8), dtype=torch.uint8)
    for x in (torch.arange(B, dtype=torch.int64),
              torch.arange(2 * B, dtype=torch.int64)[::2],
              torch.tensor(7, dtype=torch.int64)):
        t = ebsp_flat.session_lengths(rbsp, x)
        assert t.data_ptr() == x.data_ptr() and t.dtype == torch.int64
        assert t.stride(0) == (x.stride(0) if x.dim() else 0)
        assert t.tolist() == x.expand(B).tolist()


@pytest.mark.parametrize("length,header", [
    (5, 0x41), (np.int64(5), 0x41), (torch.tensor([5], dtype=torch.int32), 0x41),
    (torch.tensor([5, 5], dtype=torch.int16), 0x41),
    (torch.tensor([5]), torch.tensor(0x41)), (torch.tensor([5]), 65.0)])
def test_wrapper_takes_only_int64_lengths_and_an_int_header(length, header):
    """The forms only tests handed K3 — Python-int and int32 lengths, tensor
    headers — raise; the plain version still takes them, as JAX does."""
    rbsp = torch.zeros((1, 16), dtype=torch.uint8)
    with pytest.raises(TypeError):
        ebsp_flat.rbsp_to_nal_batch(rbsp, length, header, 128, CAP)


def test_rejects_unbatched_input():
    with pytest.raises(ValueError):
        ebsp_flat.rbsp_to_nal_batch(torch.zeros(16, dtype=torch.uint8), 4, 1,
                                    128, CAP)
