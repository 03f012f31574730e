"""Port vs JAX: the scripts (h264_scroll_encoder_tpu_torch.scripts), run
with --device cpu, against the JAX package's scripts on the same inputs.
Tolerance: exact equality of every output byte.

The x264 cases skip where the system lacks libavcodec and libx264
(avref); parity_sweep has tests/test_torch_parity_sweep.py."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")


def _run_port(module: str, *args, timeout=300):
    r = subprocess.run(
        [sys.executable, "-m", f"h264_scroll_encoder_tpu_torch.scripts.{module}",
         *map(str, args)], cwd=REPO, env=_env(), capture_output=True,
        text=True, timeout=timeout)
    return r


def _jax_script(name: str, monkeypatch, argv):
    """main() of the JAX package's scripts/<name>.py with `argv`; its
    persistent compile cache setup is left to the test configuration."""
    from h264_scroll_encoder_tpu.utils import jaxcache

    monkeypatch.setattr(jaxcache, "enable", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *map(str, argv)])
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main()


def _needs_avref():
    from h264_scroll_encoder_tpu_torch import avref

    if not avref.available():
        pytest.skip(f"avref unavailable: {avref.missing()}")


@pytest.mark.parametrize("x264", [False, True], ids=["ipcm", "x264"])
def test_generate_refs_equal_jax(tmp_path, monkeypatch, x264):
    if x264:
        _needs_avref()
    extra = ["--x264"] if x264 else []
    args = ["--width", 320, "--height", 240, "--color-a", "green", *extra]
    r = _run_port("generate_refs", *args, "--out-dir", tmp_path / "port",
                  "--device", "cpu")
    assert r.returncode == 0, r.stderr[-3000:]
    (tmp_path / "jax").mkdir()
    assert _jax_script("generate_refs", monkeypatch,
                       [*args, "--out-dir", tmp_path / "jax"]) == 0
    for name in ("ref_a.h264", "ref_b.h264"):
        got = (tmp_path / "port" / name).read_bytes()
        assert got == (tmp_path / "jax" / name).read_bytes(), name


def test_generate_refs_x264_without_avref_exits_nonzero(tmp_path, monkeypatch,
                                                        capsys):
    from h264_scroll_encoder_tpu_torch import avref
    from h264_scroll_encoder_tpu_torch.scripts import generate_refs

    monkeypatch.setattr(avref, "missing",
                        lambda: "system libraries missing: libavcodec")
    assert generate_refs.main(["--x264", "--out-dir", str(tmp_path),
                               "--device", "cpu"]) == 1
    assert "libavcodec" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())


def test_run_e2e_equals_jax(tmp_path):
    """run_e2e.sh at 64x48, 8 frames: every file equals what the JAX
    package's run_e2e.sh steps write (its scroll-encoder and composer CLIs,
    the I_PCM donors and the MP4 mux), computed here in-process."""
    env = dict(_env(), OUT=str(tmp_path / "port"), W="64", H="48",
               FRAMES="8", DEVICE="cpu", PYTHON=sys.executable)
    r = subprocess.run(
        ["bash", str(REPO / "h264_scroll_encoder_tpu_torch" / "scripts"
                     / "run_e2e.sh")],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert r.stdout.count('"ok": true') == 2

    from h264_scroll_encoder_tpu.cli import composer_main, scroll_encoder_main
    from h264_scroll_encoder_tpu.config import ComposerConfig
    from h264_scroll_encoder_tpu.models import ipcm
    from h264_scroll_encoder_tpu.session import ComposerSession
    from h264_scroll_encoder_tpu.utils import mp4mux

    jax_out = tmp_path / "jax"
    jax_out.mkdir()
    scroll_encoder_main(["-n", "8", "-S", "4", "-w", "64", "-H", "48",
                         "-o", str(jax_out / "scroll.h264")])
    for name, color in [("a", (81, 90, 240)), ("b", (41, 240, 110))]:
        cfg = ComposerConfig(64, 48)
        s = ComposerSession(cfg)
        s.write_parameter_sets()
        s.writer.append_raw(ipcm.idr_frame_color(cfg, *color))
        s.write_to_file(str(jax_out / f"donor_{name}.h264"))
    composer_main(["--ref-a", str(jax_out / "donor_a.h264"),
                   "--ref-b", str(jax_out / "donor_b.h264"), "-n", "8",
                   "-s", "4", "-o", str(jax_out / "composed.h264")])
    mp4mux.mux_cli([str(jax_out / "scroll.h264"), str(jax_out / "scroll.mp4")])
    for name in ("scroll.h264", "donor_a.h264", "donor_b.h264",
                 "composed.h264", "scroll.mp4"):
        got = (tmp_path / "port" / name).read_bytes()
        assert got == (jax_out / name).read_bytes(), name


def test_netflix_scroll_demo_equals_jax(tmp_path, monkeypatch):
    """--demo at 96x64, 12 frames: the MP4 equals the JAX script's (x264
    donor through each package's avref, the scroll-encoder CLI in donor
    mode, the mux), and libavcodec decodes the stream with 0 errors."""
    _needs_avref()
    args = ["--demo", "--demo-size", "96x64", "-n", 12, "-S", 2,
            "--extract-frames"]
    r = _run_port("netflix_scroll", *args, "-o", tmp_path / "port.mp4",
                  "--device", "cpu")
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert "SUCCESS (no errors)" in r.stdout
    assert _jax_script("netflix_scroll", monkeypatch,
                       [*args, "-o", tmp_path / "jax.mp4"]) == 0
    assert (tmp_path / "port.mp4").read_bytes() == \
        (tmp_path / "jax.mp4").read_bytes()
