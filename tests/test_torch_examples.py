"""Port vs JAX: the examples (h264_scroll_encoder_tpu_torch.examples), each
run in a subprocess with --device cpu, against the JAX package's example
on the same inputs.  Tolerance: exact equality of every output byte.

serving_demo runs at 64x720 (the JAX example's loop at that width: its
script is fixed at 1280x720, ~1 min on the CPU); splice_serving_demo,
full_pipeline_demo and video_in_corner_demo (host path and main_batched
at 320x240, B = 2) are compared with the JAX examples themselves.  The
video-in-corner demos need libavcodec and libx264 (avref) and skip where
the system lacks them."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


def _run_port(module: str, *args, timeout=300):
    """python -m h264_scroll_encoder_tpu_torch.examples.<module> args...,
    from the repository root; returns its stdout."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", f"h264_scroll_encoder_tpu_torch.examples.{module}",
         *map(str, args)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=timeout)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return r.stdout


def _jax_example(name: str, monkeypatch):
    """The JAX package's examples/<name>.py as a module; its persistent
    compile cache setup is left to the test configuration."""
    from h264_scroll_encoder_tpu.utils import jaxcache

    monkeypatch.setattr(jaxcache, "enable", lambda *a, **k: None)
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _needs_avref():
    from h264_scroll_encoder_tpu_torch import avref

    if not avref.available():
        pytest.skip(f"avref unavailable: {avref.missing()}")


def _jax_avref_loads():
    """Loads the JAX package's avref library afresh, before the JAX demo
    runs.  Its loader (h264_scroll_encoder_tpu/avref.load_library) is
    cached and builds native/libh264tpu_avref.so in place, so a pytest
    worker that loaded it while another worker wrote the file (every
    worker asks at collection, through tests/test_avref.py) keeps None,
    and the JAX demo then returns without writing its stream.  The system
    libraries are present here (_needs_avref), so the library must load."""
    from h264_scroll_encoder_tpu import avref as javref

    javref.load_library.cache_clear()
    assert javref.load_library() is not None, (
        "the JAX package's avref library did not load (make -C native avref)")


def _jax_stream(path: Path) -> bytes:
    assert path.exists(), f"the JAX demo wrote no {path.name}"
    return path.read_bytes()


def test_serving_demo_streams_equal_jax(tmp_path):
    out = _run_port("serving_demo", "--device", "cpu", "--width", 64,
                    "--out-dir", tmp_path)
    assert "all session streams verify OK" in out
    assert "snapshot/restore OK" in out

    # The JAX example's loop at 64x720: 8 sessions, 40 frames, each at its
    # own speed, bytes appended to each session's stream.
    from h264_scroll_encoder_tpu.config import ComposerConfig
    from h264_scroll_encoder_tpu.parallel import batch
    from h264_scroll_encoder_tpu.session import ComposerSession
    from h264_scroll_encoder_tpu.utils import snapshot

    cfg = ComposerConfig(64, 720)
    sessions = []
    for _ in range(8):
        s = ComposerSession(cfg)
        s.write_parameter_sets()
        s.write_test_atlases(striped=True)
        sessions.append(s)
    step = batch.make_batched_step(cfg)
    state = batch.SessionState.create(8)
    for t in range(40):
        offsets = np.array([(t * (2 + b)) % cfg.height for b in range(8)],
                           np.int32)
        state, (nal, nal_len, _wp, _bits, ovf) = step(state,
                                                      jnp.asarray(offsets))
        assert not bool(ovf.any())
        nal_np = np.asarray(nal)
        for b in range(8):
            sessions[b].writer.append_raw(nal_np[b][: int(nal_len[b])].tobytes())
    for b, s in enumerate(sessions):
        assert (tmp_path / f"session_{b}.h264").read_bytes() == s.getvalue(), b
    snapshot.save_batch_state(state, tmp_path / "jax_state.npz")
    assert (tmp_path / "serving_state.npz").read_bytes() == \
        (tmp_path / "jax_state.npz").read_bytes()


def test_splice_serving_demo_nals_equal_jax(tmp_path, monkeypatch):
    out = _run_port("splice_serving_demo", "--device", "cpu",
                    "--out-dir", tmp_path)
    assert "spliced stream verifies OK" in out

    from h264_scroll_encoder_tpu.parallel import batch as jbatch

    demo = _jax_example("splice_serving_demo", monkeypatch)
    captured = []
    make = jbatch.make_batched_splice_step_rows

    def recording(*a, **k):
        step = make(*a, **k)

        def run(*args):
            out = step(*args)
            captured.append(out)
            return out
        return run

    monkeypatch.setattr(jbatch, "make_batched_splice_step_rows", recording)
    demo.main()
    nal, nal_len = (np.asarray(x) for x in captured[-1][:2])
    assert len(nal_len) == 8
    for b in range(8):
        assert (tmp_path / f"nal_{b}.bin").read_bytes() == \
            nal[b, : nal_len[b]].tobytes(), b


def test_full_pipeline_demo_stream_and_mp4_equal_jax(tmp_path, monkeypatch):
    out = _run_port("full_pipeline_demo", tmp_path / "port.h264",
                    "--device", "cpu")
    assert "verifies OK" in out
    demo = _jax_example("full_pipeline_demo", monkeypatch)
    demo.main(str(tmp_path / "jax.h264"))
    for suffix in (".h264", ".mp4"):
        got = (tmp_path / f"port{suffix}").read_bytes()
        assert got == (tmp_path / f"jax{suffix}").read_bytes(), suffix
    assert (tmp_path / "port.mp4").read_bytes()[4:8] == b"ftyp"


def test_video_in_corner_batched_equals_jax(tmp_path, monkeypatch):
    """main_batched at 320x240, B = 2 (tests/test_avref.py's size): every
    session equals the host path (checked inside), and the stream equals
    the JAX example's."""
    _needs_avref()
    out = _run_port("video_in_corner_demo", "--batched", tmp_path / "port.h264",
                    "--batch", 2, "--width", 320, "--height", 240, "--rx", 12,
                    "--ry", 9, "--device", "cpu")
    assert "byte-identical to the host path, 0 decoder errors" in out
    _jax_avref_loads()
    demo = _jax_example("video_in_corner_demo", monkeypatch)
    demo.main_batched(str(tmp_path / "jax.h264"), batch=2, width=320,
                      height=240, rx=12, ry=9)
    assert (tmp_path / "port.h264").read_bytes() == \
        _jax_stream(tmp_path / "jax.h264")


def test_video_in_corner_host_path_equals_jax(tmp_path, monkeypatch):
    _needs_avref()
    out = _run_port("video_in_corner_demo", tmp_path / "port.h264",
                    "--device", "cpu")
    assert "0 decoder errors" in out
    _jax_avref_loads()
    demo = _jax_example("video_in_corner_demo", monkeypatch)
    demo.main(str(tmp_path / "jax.h264"))
    for suffix in (".h264", ".mp4"):
        assert (tmp_path / f"port{suffix}").read_bytes() == \
            _jax_stream(tmp_path / f"jax{suffix}"), suffix


def test_video_in_corner_without_avref_exits_nonzero(monkeypatch, capsys):
    """Where libavcodec is missing the demo says so and exits 1 (the JAX
    demo prints and returns 0)."""
    from h264_scroll_encoder_tpu_torch import avref
    from h264_scroll_encoder_tpu_torch.examples import video_in_corner_demo

    monkeypatch.setattr(avref, "missing",
                        lambda: "system libraries missing: libavcodec")
    assert video_in_corner_demo.cli(["--batched", "--device", "cpu"]) == 1
    assert "libavcodec" in capsys.readouterr().err


@pytest.mark.parametrize("module", ["serving_demo", "splice_serving_demo",
                                    "full_pipeline_demo"])
def test_examples_default_to_the_card(module, tmp_path, monkeypatch):
    """Without --device the examples run on the card, and raise where CUDA
    is missing instead of falling back to the CPU."""
    import importlib

    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    monkeypatch.chdir(tmp_path)
    example = importlib.import_module(
        f"h264_scroll_encoder_tpu_torch.examples.{module}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        example.main([])
