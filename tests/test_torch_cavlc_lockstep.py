"""The lockstep CAVLC decoder's plain version (ops/cavlc_lockstep: P4) vs
the JAX probe's decoder and the host truth.

The reference is scripts/cavlc_device_probe.py's own `make_decoder` (a
lax.scan), loaded by path with its module's K set to 16 blocks, on B = 8
lanes; its persistent compile cache setup is left to the test
configuration.  Inputs are made with numpy from the probe's seed.
Tolerance: exact equality of every cursor and field.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_scroll_encoder_tpu.ops import cavlc as jcavlc
from h264_scroll_encoder_tpu_torch import _kernels
from h264_scroll_encoder_tpu_torch.ops import cavlc_lockstep as L
from h264_scroll_encoder_tpu_torch.ops.bitio import BitReader
from h264_scroll_encoder_tpu_torch.ops import cavlc
from h264_scroll_encoder_tpu_torch.scripts import cavlc_device_probe

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
K, B = 16, 8
WIDTH = 1024   # one row width for every decode, so the JAX decoder compiles once


@pytest.fixture(scope="module")
def jax_probe():
    from h264_scroll_encoder_tpu.utils import jaxcache

    mp = pytest.MonkeyPatch()
    mp.setattr(jaxcache, "enable", lambda *a, **k: None)
    spec = importlib.util.spec_from_file_location(
        "jax_cavlc_device_probe", REPO / "scripts" / "cavlc_device_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mp.undo()
    mod.K = K
    luts = (mod.build_ct_lut(), mod.build_tz_lut(), mod.build_rb_lut())
    return mod, mod.make_decoder(WIDTH, *luts)


def _widen(data):
    assert data.shape[1] <= WIDTH
    return np.pad(data, ((0, 0), (0, WIDTH - data.shape[1])))


def _jax_decode(jax_probe, data):
    _mod, decode = jax_probe
    end, outs = decode(jnp.asarray(_widen(data)))
    return np.asarray(end), np.stack([np.asarray(o).T for o in outs], axis=-1)


def _host_decode(stream: bytes, k: int):
    """ops/cavlc.read_residual_block's fields of the first k blocks (nC 0)."""
    br = BitReader(stream)
    out = []
    for _ in range(k):
        blk = cavlc.read_residual_block(br, 0, 16)
        out.append((blk.total_coeff, blk.trailing_ones, sum(blk.levels),
                    blk.total_zeros, sum(blk.runs)))
    return np.asarray(out, np.int32), br.bit_position


def test_luts_equal_the_jax_probes(jax_probe):
    mod, _ = jax_probe
    ct, tz, rb = L.build_luts()
    assert (ct.dtype, tz.dtype, rb.dtype) == (np.uint16, np.uint8, np.uint8)
    np.testing.assert_array_equal(ct, mod.build_ct_lut())
    np.testing.assert_array_equal(tz, mod.build_tz_lut())
    np.testing.assert_array_equal(rb, mod.build_rb_lut())


def test_streams_equal_the_jax_probes(jax_probe):
    """random_stream makes the JAX probe's bytes and truth from one seed
    (the JAX probe's on the JAX package's cavlc)."""
    mod, _ = jax_probe
    r_port, r_jax = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(B):
        assert L.random_stream(r_port, K) == mod.random_stream(r_jax, K)
    assert r_port.integers(0, 1 << 30) == r_jax.integers(0, 1 << 30)


def test_plain_equals_the_jax_decoder_and_the_host_truth(jax_probe):
    """decode_lockstep_plain (and the CPU wrapper) on the probe's B = 8 x
    K = 16 streams: the JAX decoder's cursors and fields, the truth of
    the synthesis and ops/cavlc.read_residual_block's decode."""
    data, truth, _bits = L.probe_streams(B, K, L.SEED)
    end, out = L.decode_lockstep_plain(torch.as_tensor(data), K, L.build_luts())
    j_end, j_out = _jax_decode(jax_probe, data)
    np.testing.assert_array_equal(out.numpy(), j_out)
    np.testing.assert_array_equal(end.numpy(), j_end)
    np.testing.assert_array_equal(out.numpy(), truth)
    for b in range(B):
        fields, bit_end = _host_decode(data[b].tobytes(), K)
        np.testing.assert_array_equal(fields, truth[b])
        assert bit_end == int(end[b])
    w_end, w_out = L.decode_lockstep_batch(
        torch.as_tensor(data), K, L.device_luts("cpu"))
    assert torch.equal(w_end, end) and torch.equal(w_out, out)
    assert end.dtype == out.dtype == torch.int32 and out.shape == (B, K, 5)


def test_hostile_streams(jax_probe):
    """tc = 16 (t1 = 3 and 0), level prefixes 14 and 15 at suffix length
    0, large levels at longer suffixes, zeros left >= 7 and empty blocks
    (14 a lane): the plain decoder equals the truth and
    read_residual_block's decode on them, and the JAX decoder over K = 16
    blocks, which runs past each stream's end into the zero padding."""
    data, truth = cavlc_device_probe.hostile_streams(B)
    k = truth.shape[1]
    assert k < K
    assert {int(t) for t in truth[0, :, 0]} >= {0, 1, 16}
    assert any(z >= 7 for _lv, z, runs in cavlc_device_probe.hostile_blocks()
               if runs)
    luts = L.build_luts()
    end, out = L.decode_lockstep_plain(torch.as_tensor(data), K, luts)
    np.testing.assert_array_equal(out.numpy()[:, :k], truth)
    j_end, j_out = _jax_decode(jax_probe, data)
    np.testing.assert_array_equal(out.numpy(), j_out)
    np.testing.assert_array_equal(end.numpy(), j_end)
    end_k, _ = L.decode_lockstep_plain(torch.as_tensor(data), k, luts)
    for b in range(B):
        fields, bit_end = _host_decode(data[b].tobytes(), k)
        np.testing.assert_array_equal(fields, truth[b])
        assert bit_end == int(end_k[b])


def test_hostile_blocks_reach_the_grammar_edges():
    """The hostile blocks really take the paths they name: level prefixes
    14 and 15 at suffix length 0 (read back from the tails), tc = 16 with
    no total_zeros, and run_before read at zeros left >= 7."""
    prefixes = set()
    for levels, zeros, runs in cavlc_device_probe.hostile_blocks():
        if not levels:
            continue
        blk = jcavlc.encode_residual_block(list(levels), zeros, list(runs),
                                           16, 0)
        tail = blk.tail[blk.trailing_ones:]
        prefixes.add(len(tail) - len(tail.lstrip("0")))
        assert cavlc.encode_residual_block(levels, zeros, runs, 16, 0).tail \
            == blk.tail
    assert {14, 15} <= prefixes


def test_peek_reads_zeros_past_the_row():
    """A lane that runs off its row reads zeros: an all-zero row decodes
    as a coeff_token of 16 zero bits without a code (the LUT's 0: length
    0, tc 0), so every block is empty and the cursor stays at 0."""
    data = np.zeros((2, 3), np.uint8)
    end, out = L.decode_lockstep_plain(torch.as_tensor(data), 4, L.build_luts())
    assert not end.any() and not out.any()


def test_refusals():
    """The wrapper refuses other dtypes, a negative block count and
    devices other than the CPU and CUDA, launching nothing."""
    data = torch.zeros((2, 16), dtype=torch.uint8)
    luts = L.device_luts("cpu")
    before = _kernels.launch_counts()
    with pytest.raises(ValueError, match="uint8"):
        L.decode_lockstep_batch(data.to(torch.int32), 2, luts)
    with pytest.raises(ValueError, match="k must be"):
        L.decode_lockstep_batch(data, -1, luts)
    with pytest.raises(ValueError, match="unsupported device"):
        L.decode_lockstep_batch(data.to("meta"), 2, luts)
    with pytest.raises(ValueError, match="ct table"):
        L.check_luts(tuple(t.to(torch.int32) for t in luts),
                     torch.device("cpu"))
    assert _kernels.launch_counts() == before
    assert "h264t_cavlc_lockstep" in before
