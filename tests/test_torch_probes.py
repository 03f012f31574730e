"""The measurement probes' plain versions (ops/probes: P1-P3) vs the JAX
package, and the measurement scripts (h264_scroll_encoder_tpu_torch
.scripts) on the CPU.

Inputs are the JAX probes' own, made with numpy from their seeds.  The
JAX probe scripts run their races when imported, so the references are
the JAX package's functions they call: bitpack_flat's flat cumsum and
place rounds, pack_words_place_pallas and ops/emit_fused (Pallas in
interpret mode, as the JAX package's tests run it), and bitpack.pack_words.
Tolerance: exact equality of every word, count and byte.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_scroll_encoder_tpu.ops import bitpack as jbitpack
from h264_scroll_encoder_tpu.ops import bitpack_flat as jflat
from h264_scroll_encoder_tpu.ops import emit_fused as jemit
from h264_scroll_encoder_tpu_torch import _kernels, cases
from h264_scroll_encoder_tpu_torch.ops import emit_fused, probes
from h264_scroll_encoder_tpu_torch.scripts import (_probe_common,
                                                   pack_tiled_probe,
                                                   pack_u16_probe)

torch.set_num_threads(1)

CAP = cases.CAP


def _probe_input(batch: int, n: int = 8483, seed: int = 1):
    """Sessions of the JAX probes' symbols (widths 0-8): row 0 is the
    probes' own seed-1 row, the others vary it."""
    rng = np.random.default_rng(seed)
    nb = rng.integers(0, 9, size=(batch, n)).astype(np.int64)
    pat = rng.integers(0, 2 ** 31, size=(batch, n)).astype(np.int64) & (
        (1 << nb) - 1)
    p0, n0 = _probe_common.probe_symbols(1, "cpu", n=n, seed=seed)
    pat[0], nb[0] = p0[0].numpy(), n0[0].numpy()
    return pat, nb


def _flat3(a, n: int):
    """[B, n] -> [B, R, 128] padded as the JAX probes lay symbols out."""
    padded = -(-(n + 1) // 128) * 128
    a = np.pad(a, ((0, 0), (0, padded - n)))
    return a.reshape(a.shape[0], padded // 128, 128), padded


def test_scan_stage_matches_the_flat_cumsum():
    """P1's `scan` stage: the total bits and the XOR of every thread's
    start bit equal those read off bitpack_flat._flat_exclusive_cumsum3."""
    pat, nb = _probe_input(3)
    n = nb.shape[1]
    nb3, _ = _flat3(nb, n)
    offs = np.asarray(jax.jit(jflat._flat_exclusive_cumsum3)(
        jnp.asarray(nb3.astype(np.int32)))).reshape(3, -1)
    k = emit_fused.items_per_thread(n)
    firsts = np.concatenate([np.minimum(base + np.arange(512) * k, n)
                             for base in range(0, n, 512 * k)])
    want = np.bitwise_xor.reduce(offs[:, firsts].astype(np.int64), axis=1)
    (meta,) = probes.emit_stage_batch("scan", torch.as_tensor(pat),
                                      torch.as_tensor(nb), 0, 8192, CAP)
    np.testing.assert_array_equal(meta[:, 0].numpy(), nb.sum(axis=1))
    np.testing.assert_array_equal(meta[:, 1].numpy(), want)


def test_pack_stage_matches_the_place_rounds():
    """P1's `pack` stage: the words equal bitpack_flat._place_rounds3 over
    the probes' [B, R, 128] layout, and pack_words_place_pallas (interpret
    mode) per session."""
    pat, nb = _probe_input(2)
    n, n_rbsp = nb.shape[1], 8192
    nw = emit_fused.nal_bytes(n_rbsp, CAP) // 4
    pat3, padded = _flat3(pat, n)
    nb3, _ = _flat3(nb, n)
    jw = np.asarray(jax.jit(jflat._place_rounds3, static_argnums=2)(
        jnp.asarray(pat3.astype(np.uint32)), jnp.asarray(nb3.astype(np.int32)),
        padded)).reshape(2, -1)
    meta, words = probes.emit_stage_batch("pack", torch.as_tensor(pat),
                                          torch.as_tensor(nb), 0, n_rbsp, CAP)
    got = words.numpy().view(np.uint32)
    np.testing.assert_array_equal(got, jw[:, :nw])
    np.testing.assert_array_equal(meta[:, 0].numpy(), nb.sum(axis=1))
    pw, pt = jflat.pack_words_place_pallas(jnp.asarray(pat[1].astype(np.uint32)),
                                           jnp.asarray(nb[1].astype(np.int32)),
                                           nw)
    np.testing.assert_array_equal(got[1], np.asarray(pw))
    assert int(pt) == int(meta[1, 0])


@pytest.mark.parametrize("align", [False, True])
def test_full_and_ep_stages_match_jax_emit_fused(align):
    """P1's `full` stage equals the JAX fused emit (interpret mode); its
    `ep` stage's insertions, saturation and NAL XOR agree with the JAX
    NAL and length; `launch` writes zeros and `stage` the XOR of the
    staged words."""
    pat, nb = cases.align_cases() if align else cases.byte_stream_cases()
    pat = pat.astype(np.int64)
    nb = nb.astype(np.int64)
    p, n = torch.as_tensor(pat), torch.as_tensor(nb)
    kw = dict(align=align, append_tb=True)
    f = jax.jit(jax.vmap(lambda a, b: jemit.finish_nal_fused(
        a, b, cases.N_RBSP, 3, max_insertions=CAP, has_align=align,
        append_trailing=True)))
    jnal, jlen, jbits, jovf = (np.asarray(x) for x in f(
        jnp.asarray(pat.astype(np.uint32)), jnp.asarray(nb.astype(np.int32))))
    nal, nal_len, bits, ovf = probes.emit_stage_batch(
        "full", p, n, 3, cases.N_RBSP, CAP, **kw)
    keep = ~jovf
    np.testing.assert_array_equal(nal.numpy()[keep], jnal[keep])
    np.testing.assert_array_equal(nal_len.numpy(), jlen)
    np.testing.assert_array_equal(bits.numpy(), jbits)
    np.testing.assert_array_equal(ovf.numpy(), jovf)

    (ep,) = probes.emit_stage_batch("ep", p, n, 3, cases.N_RBSP, CAP, **kw)
    n_nal = emit_fused.nal_bytes(cases.N_RBSP, CAP)
    ins, sat = ep[:, 0].numpy(), ep[:, 1].numpy()
    np.testing.assert_array_equal(5 + (jbits >> 3) + ins + sat * (CAP + 1), jlen)
    for b in np.flatnonzero(keep):
        fill = min(5 + min(int(jbits[b]) >> 3, n_nal) + int(ins[b]), n_nal)
        le = jnal[b, :fill].astype(np.int64) << (8 * (np.arange(fill) & 3))
        assert np.bitwise_xor.reduce(le) == int(ep[b, 2]) & 0xFFFFFFFF
    (zero,) = probes.emit_stage_batch("launch", p, n, 3, cases.N_RBSP, CAP, **kw)
    assert not zero.any()
    (st,) = probes.emit_stage_batch("stage", p, n, 3, cases.N_RBSP, CAP, **kw)
    want = np.bitwise_xor.reduce((pat ^ nb) & 0xFFFFFFFF, axis=1)
    np.testing.assert_array_equal(st[:, 0].numpy().view(np.uint32), want)


def test_u16_plain_matches_jax_on_the_probe_cases():
    """P2's plain version against pack_words_place_pallas at 2,048 words on
    pack_u16_probe's eight cases, and against bitpack.pack_words on the
    session whose bits pass 65,536."""
    cases_ = pack_u16_probe.exact_cases()
    for pat, nb in cases_[:8]:
        words, total = probes.pack_place_u16_batch(torch.as_tensor(pat),
                                                   torch.as_tensor(nb), 2048)
        jw, jt = jflat.pack_words_place_pallas(
            jnp.asarray(pat[0].astype(np.uint32)),
            jnp.asarray(nb[0].astype(np.int32)), 2048)
        np.testing.assert_array_equal(*cases.jax_width(words[0], jw))
        assert int(total[0]) == int(jt)
    pat, nb = cases_[8]
    assert nb.sum() > 65_536
    words, total = probes.pack_place_u16_batch(torch.as_tensor(pat),
                                               torch.as_tensor(nb), 2048)
    jw, jt = jbitpack.pack_words(jnp.asarray(pat[0].astype(np.uint32)),
                                 jnp.asarray(nb[0].astype(np.int32)), 2048)
    np.testing.assert_array_equal(*cases.jax_width(words[0], jw))
    assert int(total[0]) == int(jt) == int(nb.sum())


@pytest.mark.parametrize("tile", [1, 4, 8])
def test_tiled_plain_matches_jax_vmap(tile):
    """P3's plain version against jax.vmap(bitpack.pack_words) on
    pack_tiled_probe's B = 16 case (zero-width and 32-bit symbols)."""
    pat, nb = pack_tiled_probe.exact_case()
    jw, jt = jax.jit(jax.vmap(lambda p, n: jbitpack.pack_words(p, n, 2048)))(
        jnp.asarray(pat.astype(np.uint32)), jnp.asarray(nb.astype(np.int32)))
    words, total = probes.pack_place_tiled_batch(torch.as_tensor(pat),
                                                 torch.as_tensor(nb), 2048, tile)
    np.testing.assert_array_equal(*cases.jax_width(words, jw))
    np.testing.assert_array_equal(*cases.jax_width(total, jt))


def test_refusals():
    """P2 refuses more than 2,048 words, P3 a batch its tile does not
    divide or a tile it has no kernel for, P1 an unknown stage; nothing
    launches first (the counters stay put)."""
    p, n = (torch.as_tensor(a) for a in _probe_input(12, n=300))
    before = _kernels.launch_counts()
    with pytest.raises(ValueError, match="2048 words"):
        probes.pack_place_u16_batch(p, n, 2049)
    with pytest.raises(ValueError, match="2048 words"):
        probes.pack_place_u16_plain(p, n, 2049)
    with pytest.raises(ValueError, match="multiple of tile"):
        probes.pack_place_tiled_batch(p, n, 64, 8)
    with pytest.raises(ValueError, match="multiple of tile"):
        probes.pack_place_tiled_plain(p, n, 64, 8)
    with pytest.raises(ValueError, match="tile must be"):
        probes.pack_place_tiled_batch(p, n, 64, 3)
    with pytest.raises(ValueError, match="unknown stage"):
        probes.emit_stage_batch("copy", p, n, 0, 2048, CAP)
    with pytest.raises(ValueError, match="unsupported device"):
        probes.pack_place_u16_batch(p.to("meta"), n.to("meta"), 64)
    assert _kernels.launch_counts() == before
    assert set(before) >= {f"h264t_emit_stage[{s}]" for s in probes.EMIT_STAGES}


_TINY = ["--device", "cpu", "--batch", "2", "--steps", "1", "--reps", "1"]
_DONORS = ["--engine", "python", "--donors", "2"]
SCRIPTS = {
    "emit_stage_probe": _TINY + _DONORS + ["--shapes", "probe,splice,scroll"],
    "emit_wrap_probe": ["--device", "cpu", "--batch", "2"],
    "pack_u16_probe": _TINY + _DONORS,
    "pack_tiled_probe": ["--device", "cpu", "--batch", "16", "--steps", "1",
                         "--reps", "1"],
    "splice_stage_profile": _TINY + ["--engine", "python", "--static"],
    "symbols_stage_probe": _TINY + _DONORS,
    "step_xprof": ["--device", "cpu", "--batch", "2", "--steps", "1"] + _DONORS,
    "step_cost": _TINY + _DONORS,
    "ebsp_stage_probe": _TINY,
    "ebsp_sizing_probe": _TINY,
    "gpu_parity_probe": _TINY + ["--engine", "python"],
    "cavlc_device_probe": _TINY + _DONORS + ["--blocks", "8", "--wide", "8"],
    "ebsp_cumsum_probe": _TINY,
    "ebsp_fused_probe": _TINY,
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_script_runs_on_the_cpu(script, capsys):
    """Each measurement script's main runs on the CPU at a tiny size and
    prints its table, naming its clock, as its last line."""
    import importlib

    mod = importlib.import_module(
        f"h264_scroll_encoder_tpu_torch.scripts.{script}")
    assert mod.main(SCRIPTS[script]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["script"] == script and last["device"] == "cpu"
    assert "not a device time" in last["clock"] and last["rows"]


def test_scripts_default_to_the_card():
    """Without --device a script runs on the card, and raises without one."""
    from h264_scroll_encoder_tpu_torch.scripts import ebsp_sizing_probe

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ebsp_sizing_probe.main(["--batch", "2"])
