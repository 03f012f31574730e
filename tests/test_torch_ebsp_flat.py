"""K3's plain version (ops/ebsp_flat) vs the JAX package's flat EBSP +
framing: `rbsp_to_nal_flat` (pure jnp) and `rbsp_to_nal_pallas`
(interpret mode here).

Tolerance: exact equality of the insertion count always, and of the NAL
bytes for in-contract streams (count <= max_insertions); over the bound
the JAX kernel's bytes are unspecified and the caller retries through the
exact path.
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


@pytest.mark.parametrize("cap", [CAP, 1000])
@pytest.mark.parametrize("zero_heavy", [False, True])
def test_plain_matches_jax_flat(zero_heavy, cap):
    for k, n in enumerate(cases.EBSP_LENGTHS):
        pad = _case(zero_heavy, n, 100 * k + zero_heavy)
        want, want_tot = jflat.rbsp_to_nal_flat(jnp.asarray(pad), n, 0x41,
                                                pad.size, cap)
        nal, tot = ebsp_flat.rbsp_to_nal_batch(torch.as_tensor(pad)[None], n,
                                               0x41, pad.size, cap)
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
    """One [K, m] call with per-session lengths and header bytes, against
    the JAX function per session (the input is cut or zero-padded to the
    next multiple of 128 bytes of n_nal, as the JAX wrapper does)."""
    rbsp, lens, hdr = cases.ebsp_cases()
    n_nal = cases.EBSP_N_NAL
    nal, tot = ebsp_flat.rbsp_to_nal_batch(torch.as_tensor(rbsp),
                                           torch.as_tensor(lens),
                                           torch.as_tensor(hdr), n_nal, cap)
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


def test_rejects_unbatched_input():
    with pytest.raises(ValueError):
        ebsp_flat.rbsp_to_nal_batch(torch.zeros(16, dtype=torch.uint8), 4, 1,
                                    128, CAP)
