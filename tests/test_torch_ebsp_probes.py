"""The EBSP probes' plain path (ops/probes.ebsp_variant_*: P5/P6, which is
K3's plain version ops/ebsp_flat.rbsp_to_nal_plain) and ops/ebsp
.ebsp_to_rbsp vs the JAX package.

References: scripts/ebsp_cumsum_probe.py's `finish` with each of its
three insertion scans (loaded by path; its persistent compile cache setup
is left to the test configuration), ops/ebsp.rbsp_to_ebsp_tree plus the
Annex-B prefix (ebsp_fused_probe.py's own reference; that script races
when imported, so its cases are the port script's copy), and
ops/ebsp.ebsp_to_rbsp.  Inputs are made with numpy from the probes' seeds.
Tolerance: exact equality of every byte, length and checksum.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_scroll_encoder_tpu.ops import ebsp as jebsp
from h264_scroll_encoder_tpu_torch import _kernels
from h264_scroll_encoder_tpu_torch.ops import ebsp, probes
from h264_scroll_encoder_tpu_torch.scripts import (ebsp_cumsum_probe,
                                                   ebsp_fused_probe)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CAP = 16
HEADER = 0x41


@pytest.fixture(scope="module")
def cumsum_probe():
    from h264_scroll_encoder_tpu.utils import jaxcache

    mp = pytest.MonkeyPatch()
    mp.setattr(jaxcache, "enable", lambda *a, **k: None)
    spec = importlib.util.spec_from_file_location(
        "jax_ebsp_cumsum_probe", REPO / "scripts" / "ebsp_cumsum_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mp.undo()
    return mod


def _cumsum_rows(batch: int = 4, n_rbsp: int = 600):
    """The JAX probe's rows (seed 5, the last third zero), rows 1.. salted
    with zero runs before low bytes so that they insert (under the cap)."""
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 256, (batch, n_rbsp), dtype=np.uint8)
    rows[:, -n_rbsp // 3:] = 0
    for b in range(1, batch):
        for p in rng.integers(0, n_rbsp * 2 // 3 - 6, 6):
            rows[b, p:p + 3] = 0
            rows[b, p + 3] = rng.integers(0, 4)
    return rows, np.full(batch, n_rbsp * 2 // 3, np.int64)


@pytest.mark.parametrize("shifts", ["shifts_int32", "shifts_u8_scan",
                                    "shifts_u8_two_level"])
def test_plain_matches_the_cumsum_probes_finish(cumsum_probe, shifts):
    """K3's plain version, checksummed as `finish` checksums its NAL (the
    sum of the NAL's bytes plus the escaped length), equals `finish` with
    each insertion scan at n_rbsp 600, B = 4."""
    rows, lens = _cumsum_rows()
    n_rbsp = rows.shape[1]
    n_nal = ebsp_cumsum_probe.n_nal_of(n_rbsp)
    nal, count = probes.ebsp_variant_plain("runs", torch.as_tensor(rows),
                                           torch.as_tensor(lens), HEADER,
                                           n_nal, CAP)
    assert int(count.max()) > 0 and int(count.max()) <= CAP
    got = (nal.to(torch.int64).sum(dim=1) + torch.as_tensor(lens)
           + count).numpy() % (1 << 32)
    padded = np.zeros((rows.shape[0], n_nal - 8), np.uint8)
    padded[:, :n_rbsp] = rows
    fn = getattr(cumsum_probe, shifts)
    want = jax.jit(jax.vmap(lambda b, n: cumsum_probe.finish(b, n, n_nal, fn)))(
        jnp.asarray(padded), jnp.asarray(lens, jnp.int32))
    np.testing.assert_array_equal(got, np.asarray(want).astype(np.int64))


def test_plain_matches_the_tree_framing():
    """K3's plain version equals ops/ebsp.rbsp_to_ebsp_tree framed under
    the prefix on the fused probe's 24 salted cases and its all-zeros and
    all-3s streams: the length always, the bytes within the cap."""
    rows, lens = ebsp_fused_probe.exact_cases()
    assert rows.shape == (26, 4096)
    n_nal = ebsp_fused_probe.n_nal_of(ebsp_fused_probe.EXACT_BYTES)
    nal, count = probes.ebsp_variant_plain("shared", torch.as_tensor(rows),
                                           torch.as_tensor(lens), HEADER,
                                           n_nal, CAP)
    tree = jax.jit(lambda b, n: jebsp.rbsp_to_ebsp_tree(
        b, n, n_nal - 8, max_insertions=CAP))
    over = 0
    for i, (row, n) in enumerate(zip(rows, lens)):
        eb, el = tree(jnp.asarray(row), int(n))
        el = int(el)
        assert el == int(n) + int(count[i]), i
        if el - n > CAP:
            over += 1
            continue
        want = np.zeros(n_nal, np.uint8)
        want[5:5 + n_nal - 8] = np.asarray(eb)
        want[:5] = [0, 0, 0, 1, HEADER]
        want[5 + el:] = 0
        np.testing.assert_array_equal(nal[i].numpy(), want, err_msg=str(i))
    assert over == 1          # the all-zeros stream inserts past the cap


@pytest.mark.parametrize("variant", probes.EBSP_VARIANTS)
def test_variant_wrapper_runs_the_plain_version_on_the_cpu(variant):
    """On CPU tensors every variant's wrapper is K3's plain version, at
    the cumsum probe's and the fused probe's NAL sizes."""
    rows, lens = _cumsum_rows(3, 300)
    r, n = torch.as_tensor(rows), torch.as_tensor(lens)
    for n_nal in (ebsp_cumsum_probe.n_nal_of(300), ebsp_fused_probe.n_nal_of(300)):
        got = probes.ebsp_variant_batch(variant, r, n, HEADER, n_nal, CAP)
        want = probes.ebsp_variant_plain(variant, r, n, HEADER, n_nal, CAP)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


def test_variant_refusals():
    """An unknown variant, other length and header forms and devices
    other than the CPU and CUDA are refused, launching nothing."""
    r = torch.zeros((2, 64), dtype=torch.uint8)
    n = torch.tensor([64, 10])
    before = _kernels.launch_counts()
    with pytest.raises(ValueError, match="unknown variant"):
        probes.ebsp_variant_batch("cumsum", r, n, HEADER, 128, CAP)
    with pytest.raises(ValueError, match="unknown variant"):
        probes.ebsp_variant_plain("fused", r, n, HEADER, 128, CAP)
    with pytest.raises(TypeError, match="int64"):
        probes.ebsp_variant_batch("runs", r, n.to(torch.int32), HEADER, 128,
                                  CAP)
    with pytest.raises(TypeError, match="header_byte"):
        probes.ebsp_variant_batch("ballot", r, n, torch.tensor(1), 128, CAP)
    with pytest.raises(ValueError, match="unsupported device"):
        probes.ebsp_variant_batch("lanes", r.to("meta"), n.to("meta"), HEADER,
                                  128, CAP)
    assert _kernels.launch_counts() == before
    assert {f"h264t_ebsp_variant[{v}]" for v in probes.EBSP_VARIANTS} <= set(before)


@pytest.mark.parametrize("seed", [5, 6])
def test_ebsp_to_rbsp_equals_jax(seed):
    """ebsp_to_rbsp over a batch equals JAX ops/ebsp.ebsp_to_rbsp row by
    row (bytes and length, also where max_out cuts), and undoes
    rbsp_to_ebsp_np."""
    rng = np.random.default_rng(seed)
    size, max_out = 512, 1024
    alphabet = np.array([0, 0, 0, 1, 3, 0xFF], np.uint8)
    rows, lens = [], []
    for _ in range(10):
        n = int(rng.integers(0, size))
        row = np.zeros(size, np.uint8)
        row[:n] = rng.choice(alphabet, size=n)
        rows.append(row)
        lens.append(n)
    rows, lens = np.stack(rows), np.asarray(lens, np.int64)
    f = jax.jit(lambda b, n, m: jebsp.ebsp_to_rbsp(b, n, m), static_argnums=2)
    for cap in (max_out, 100):
        out, out_len = ebsp.ebsp_to_rbsp(torch.as_tensor(rows),
                                         torch.as_tensor(lens), cap)
        assert out.dtype == torch.uint8 and out.shape == (10, cap)
        for b in range(10):
            jo, jl = f(jnp.asarray(rows[b]), int(lens[b]), cap)
            assert int(out_len[b]) == int(jl)
            np.testing.assert_array_equal(out[b].numpy(), np.asarray(jo))
    for b in range(10):
        raw = rows[b, :lens[b]]
        esc = ebsp.rbsp_to_ebsp_np(raw)
        padded = np.zeros((1, esc.size + 7), np.uint8)
        padded[0, :esc.size] = esc
        out, out_len = ebsp.ebsp_to_rbsp(torch.as_tensor(padded),
                                         torch.tensor([esc.size]), esc.size)
        assert int(out_len[0]) == raw.size
        np.testing.assert_array_equal(out[0, :raw.size].numpy(), raw)
        np.testing.assert_array_equal(ebsp.ebsp_to_rbsp_np(esc), raw)
