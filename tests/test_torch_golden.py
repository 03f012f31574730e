"""Golden 720p digests: the JAX package's output, which the port must match.

h264_scroll_encoder_tpu_torch/golden/scroll_720p.json holds, per step and
session, the sha256 of the valid NAL bytes, nal_len, emitted_waypoint and
overflow for the batch-8, 12-step 1280x720 schedule of
`cases.golden_schedule`, plus one `ebsp_exact` scroll frame per session.
tests/test_torch_cuda.py holds the card's output against it without jax.

h264_scroll_encoder_tpu_torch/golden/splice_rows_720p.json holds the same
digests for the 720p rows splice (bench.py's geometry) of the seeded
representative donors of `cases.splice_donor_payload`: one frame per
session through the compact program, the static-chrome program and the
compact program's `ebsp_exact` retry.

h264_scroll_encoder_tpu_torch/golden/session_720p.json holds the sha256
and size of each stream of `cases.session_streams` — a 1280x720
ComposerSession over the scroll-encoder schedule, sliced, hint and spliced
frames; partitioned and nearest sessions; the scroll-encoder and composer
CLIs' files; a 1920x1088 hint frame and a 3840x2160 scroll frame — and the
digest of the batched hint step at B = 256 (`cases.hint_step_inputs`).
The partitioned, nearest and large-frame entries are held against the JAX
package in tests/test_torch_hints.py.

h264_scroll_encoder_tpu_torch/golden/splice_dense_720p.json holds the
digests of the 720p dense splice (the same geometry) of the 32 seeded
donors of `cases.dense_donor_payload`, representative at the honest
budget and I_PCM-bearing at the chunk class's default budget (NAL buffer
237,600 B); the port's side is tested in tests/test_torch_dense.py.

Regenerate all four files with `python tests/test_torch_golden.py` (the
tests fail whenever their contents differ from the JAX package's output).
"""

import contextlib
import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

import pytest

from h264_scroll_encoder_tpu import cli as jax_cli
from h264_scroll_encoder_tpu.config import ComposerConfig as JaxConfig
from h264_scroll_encoder_tpu.config import MAX_WAYPOINTS
from h264_scroll_encoder_tpu.models import ipcm as jax_ipcm
from h264_scroll_encoder_tpu.models import mb_transcode as jax_mbt
from h264_scroll_encoder_tpu.models import scroll as jax_scroll
from h264_scroll_encoder_tpu.models import splice_device as jax_sd
from h264_scroll_encoder_tpu.models.splice import FrameHints, MotionRegion
from h264_scroll_encoder_tpu.session import ComposerSession as JaxSession
from h264_scroll_encoder_tpu.ops.bitio import BitWriter as JaxBitWriter
from h264_scroll_encoder_tpu.parallel import batch as jax_batch
from h264_scroll_encoder_tpu.syntax.slice_headers import (
    p_slice_header_symbols as jax_header)
from h264_scroll_encoder_tpu.utils import fixtures as jax_fixtures
from h264_scroll_encoder_tpu_torch import cases

torch.set_num_threads(1)

JAX_PKG = types.SimpleNamespace(
    ComposerConfig=JaxConfig, ComposerSession=JaxSession,
    MotionRegion=MotionRegion, FrameHints=FrameHints, fixtures=jax_fixtures,
    ipcm=jax_ipcm, cli=jax_cli)


def jax_golden() -> dict:
    """The golden digests, computed by the JAX package (staged back end)."""
    cfg = JaxConfig(cases.GOLDEN_WIDTH, cases.GOLDEN_HEIGHT)
    step = jax_batch.make_batched_step(cfg)
    state = jax_batch.SessionState.create(cases.GOLDEN_BATCH)
    offsets = cases.golden_schedule()
    steps = []
    for offs in offsets:
        state, (nal, nal_len, wp, _bits, ovf) = step(
            state, jnp.asarray(offs, jnp.int32))
        steps.append(cases.digest_step(*map(np.asarray,
                                            (nal, nal_len, wp, ovf))))
    exact = jax.jit(jax.vmap(functools.partial(
        jax_scroll.scroll_frame, cfg, ebsp_exact=True)))
    nal, nal_len, _bits, ovf = exact(
        state.frame_num, jnp.asarray(offsets[-1]), state.wp_offsets,
        state.wp_ltidx, state.wp_valid, state.wp_count)
    no_wp = np.zeros(cases.GOLDEN_BATCH, bool)
    return {"config": cases.golden_config(), "steps": steps,
            "ebsp_exact": cases.digest_step(np.asarray(nal),
                                            np.asarray(nal_len), no_wp,
                                            np.asarray(ovf))}


def jax_splice_golden() -> dict:
    """The splice golden digests, computed by the JAX package (Python
    donor engine, padded rows wire, staged back end)."""
    cfg = JaxConfig(cases.GOLDEN_WIDTH, cases.GOLDEN_HEIGHT)
    R, C, B = cases.SPLICE_R, cases.SPLICE_C, cases.SPLICE_GOLDEN_BATCH
    drs = []
    for k in range(B):
        grid = jax_fixtures.representative_donor_grid(
            np.random.default_rng(cases.SPLICE_DONOR_SEED + k), C, R)
        bw = JaxBitWriter()
        jax_mbt.emit_p_slice_mbs(bw, grid, 1)
        bw.write_trailing_bits()
        dd = jax_sd.prepare_donor_dense_from_slice(
            bw.getvalue(), 0, C, R, 1, cases.SPLICE_NUM_REFS,
            engine="python")
        drs.append(jax_sd.pack_donor_rows(dd, R, C,
                                          min_class=cases.SPLICE_S_ROW))
    wires = [jax_sd.rows_device_arrays(dr) for dr in drs]
    dn = {k: jnp.stack([w[k] for w in wires]) for k in wires[0]}
    donor_bits = max(dr.donor_bits for dr in drs)
    has_align = any(dr.has_align for dr in drs)
    hp, hn = jax_header(
        cfg, jnp.int32(cases.SPLICE_FRAME_NUM),
        jnp.int32(2 * cases.SPLICE_FRAME_NUM), is_reference=False,
        long_term_idx=-1, num_waypoints=jnp.int32(0),
        wp_long_term_idx=jnp.zeros(MAX_WAYPOINTS, jnp.int32),
        wp_valid=jnp.zeros(MAX_WAYPOINTS, bool))
    zero = jnp.zeros((B, cfg.mb_height, cfg.mb_width), jnp.int32)
    args = (jnp.broadcast_to(hp, (B,) + hp.shape),
            jnp.broadcast_to(hn, (B,) + hn.shape), zero, zero, zero,
            zero.astype(bool), dn)

    def budget(static_bg):
        return jax_sd.splice_rows_rbsp_budget(
            cfg, R * C, R, donor_bits,
            bg_bits_per_mb=None if static_bg else 4, static_bg=static_bg)

    rect = (cfg, cases.SPLICE_C0, cases.SPLICE_R0, C, R)
    common = dict(num_refs=cases.SPLICE_NUM_REFS, has_align=has_align)
    programs = {
        "compact": dict(n_rbsp=budget(False), compact_x=True),
        "static": dict(n_rbsp=budget(True), bg_static_skip=True),
        "ebsp_exact": dict(n_rbsp=budget(False), compact_x=True,
                           ebsp_exact=True),
    }
    out = {"config": cases.splice_golden_config()}
    no_wp = np.zeros(B, bool)
    for name, kw in programs.items():
        step = jax_batch.make_batched_splice_step_rows(*rect, **common, **kw)
        nal, nal_len, _bits, ovf = step(*args)
        out[name] = cases.digest_step(np.asarray(nal), np.asarray(nal_len),
                                      no_wp, np.asarray(ovf))
    return out


def jax_dense_golden() -> dict:
    """The dense splice golden digests, computed by the JAX package (Python
    donor engine, the dense emitter per session, staged back end)."""
    jcfg = JaxConfig(cases.GOLDEN_WIDTH, cases.GOLDEN_HEIGHT)
    R, C = cases.SPLICE_R, cases.SPLICE_C
    hp, hn = jax_header(
        jcfg, jnp.int32(cases.SPLICE_FRAME_NUM),
        jnp.int32(2 * cases.SPLICE_FRAME_NUM), is_reference=False,
        long_term_idx=-1, num_waypoints=jnp.int32(0),
        wp_long_term_idx=jnp.zeros(MAX_WAYPOINTS, jnp.int32),
        wp_valid=jnp.zeros(MAX_WAYPOINTS, bool))
    zero = jnp.zeros((jcfg.mb_height, jcfg.mb_width), jnp.int32)
    out = {"config": cases.dense_golden_config()}
    no_wp = np.zeros(cases.DENSE_DONORS, bool)
    for config in cases.DENSE_CONFIGS:
        dds = [jax_sd.prepare_donor_dense_from_slice(
                   cases.dense_donor_payload(k, config == "ipcm"), 0, C, R, 1,
                   cases.SPLICE_NUM_REFS, engine="python")
               for k in range(cases.DENSE_DONORS)]
        wire = cases.stack_dense(dds)
        n_rbsp = (None if config == "ipcm" else jax_sd.splice_rbsp_budget(
            jcfg, R * C, max(dd.donor_bits for dd in dds)))
        emit = jax.jit(functools.partial(
            jax_sd.emit_spliced_frame_dense, jcfg, cases.SPLICE_C0,
            cases.SPLICE_R0, R, C, cases.SPLICE_NUM_REFS,
            has_align=any(dd.has_align for dd in dds), n_rbsp=n_rbsp))
        frames = [emit(hp, hn, zero, zero, zero, zero.astype(bool),
                       {k: jnp.asarray(v[b]) for k, v in wire.items()})
                  for b in range(cases.DENSE_DONORS)]
        nal, nal_len, _bits, ovf = (np.stack([np.asarray(f[i]) for f in frames])
                                    for i in range(4))
        out[config] = cases.digest_step(nal, nal_len, no_wp, ovf)
    return out


@contextlib.contextmanager
def _jitted_sliced_frames():
    """The JAX session calls scroll_frame_sliced without jit (~30 s a 720p
    frame on the CPU); for the generator, jit the same function (same
    bytes) while the session runs."""
    eager = jax_scroll.scroll_frame_sliced

    @functools.lru_cache(maxsize=None)
    def compiled(cfg, **kw):
        return jax.jit(functools.partial(eager, cfg, **kw))

    jax_scroll.scroll_frame_sliced = (
        lambda cfg, *args, **kw: compiled(cfg, **kw)(*args))
    try:
        yield
    finally:
        jax_scroll.scroll_frame_sliced = eager


def jax_session_golden(tmp_dir, names=cases.SESSION_STREAMS,
                       hint_step=True) -> dict:
    """The session golden digests (the `names` streams, and the batched
    hint step when `hint_step`), computed by the JAX package."""
    out = {"config": cases.session_golden_config()}
    with _jitted_sliced_frames():
        for name, data in cases.session_streams(JAX_PKG, tmp_dir,
                                                names).items():
            out[name] = cases.stream_digest(data)
    if hint_step:
        step = jax_batch.make_batched_hint_step(
            JaxConfig(cases.GOLDEN_WIDTH, cases.GOLDEN_HEIGHT), compact_x=True)
        nal, nal_len, _bits, ovf = cases.run_hint_step(
            step, cases.hint_step_inputs())
        out["hint_step"] = cases.hint_step_digest(
            np.asarray(nal), np.asarray(nal_len), np.asarray(ovf))
    return out


def test_golden_file_is_jax_output():
    committed = json.loads(cases.GOLDEN_PATH.read_text())
    assert committed == jax_golden()
    # The schedule must exercise waypoints and never overflow.
    flat = [d for step in committed["steps"] for d in step]
    assert any(d["emitted_waypoint"] for d in flat)
    assert not any(d["overflow"] for d in flat)


def test_port_matches_golden():
    committed = json.loads(cases.GOLDEN_PATH.read_text())
    assert cases.port_golden(device="cpu") == committed


def test_splice_golden_file_is_jax_output():
    committed = json.loads(cases.SPLICE_GOLDEN_PATH.read_text())
    assert committed == jax_splice_golden()
    for name in ("compact", "static", "ebsp_exact"):
        assert not any(d["overflow"] for d in committed[name])
    # The programs differ only in layout and back end: the bytes agree.
    assert committed["static"] == committed["compact"]
    assert committed["ebsp_exact"] == committed["compact"]


def test_dense_golden_file_is_jax_output():
    committed = json.loads(cases.DENSE_GOLDEN_PATH.read_text())
    assert committed == jax_dense_golden()


@pytest.mark.parametrize("name", sorted(cases.LARGE_FRAMES))
def test_large_golden_file_is_jax_output(name):
    committed = json.loads(cases.LARGE_GOLDEN_PATH.read_text())
    assert set(committed) == set(cases.LARGE_FRAMES)
    assert committed[name] == cases.large_golden(JAX_PKG, (name,))[name]


@pytest.mark.parametrize("name", sorted(cases.LARGE_FRAMES))
def test_port_matches_large_golden(name):
    """The port's session composes the large hint frames (on the card: K1
    on a thread-block cluster) as the JAX package does, here through the
    plain versions."""
    committed = json.loads(cases.LARGE_GOLDEN_PATH.read_text())
    got = cases.large_golden(cases.port_package(), (name,), device="cpu")
    assert got[name] == committed[name]


def test_port_matches_splice_golden():
    committed = json.loads(cases.SPLICE_GOLDEN_PATH.read_text())
    assert cases.port_splice_golden(device="cpu", engine="python") == committed


@pytest.mark.parametrize("names,hint_step", [
    (("session",), False), (("scroll_encoder_cli", "composer_cli"), False),
    ((), True)], ids=["session", "clis", "hint_step"])
def test_session_golden_file_is_jax_output(tmp_path, names, hint_step):
    """The main session's and the CLIs' stream digests and the batched
    hint step's digest (the other streams: tests/test_torch_hints.py)."""
    committed = json.loads(cases.SESSION_GOLDEN_PATH.read_text())
    got = jax_session_golden(tmp_path, names, hint_step)
    assert got == {k: committed[k] for k in got}
    assert set(committed) == {"config", "hint_step", *cases.SESSION_STREAMS}
    assert not committed["hint_step"]["overflow"]


def test_port_matches_session_golden(tmp_path):
    committed = json.loads(cases.SESSION_GOLDEN_PATH.read_text())
    assert cases.port_session_golden(device="cpu", workdir=tmp_path) == committed


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    cases.GOLDEN_PATH.parent.mkdir(parents=True, exist_ok=True)
    cases.GOLDEN_PATH.write_text(json.dumps(jax_golden(), indent=1) + "\n")
    print(f"wrote {cases.GOLDEN_PATH}")
    cases.SPLICE_GOLDEN_PATH.write_text(
        json.dumps(jax_splice_golden(), indent=1) + "\n")
    print(f"wrote {cases.SPLICE_GOLDEN_PATH}")
    cases.DENSE_GOLDEN_PATH.write_text(
        json.dumps(jax_dense_golden(), indent=1) + "\n")
    print(f"wrote {cases.DENSE_GOLDEN_PATH}")
    cases.LARGE_GOLDEN_PATH.write_text(
        json.dumps(cases.large_golden(JAX_PKG), indent=1) + "\n")
    print(f"wrote {cases.LARGE_GOLDEN_PATH}")
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        cases.SESSION_GOLDEN_PATH.write_text(
            json.dumps(jax_session_golden(tmp), indent=1) + "\n")
    print(f"wrote {cases.SESSION_GOLDEN_PATH}")
