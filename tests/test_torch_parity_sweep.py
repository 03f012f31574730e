"""Port vs JAX: the parity sweep (h264_scroll_encoder_tpu_torch.scripts.
parity_sweep).  The C reference binaries it compares against are absent
here, so its seeded geometries are checked port session against JAX
session; tolerance: exact equality of the stream bytes.

Every donor-mode case is compared with the JAX package.  Of the ten
test-mode cases two are (test 1 and test 7): the JAX session compiles a
new program for each geometry, 2-8 s each on the CPU (~45 s for the other
eight).  The other eight, like the two, are held to verify_stream and,
where avref builds, to a libavcodec decode with 0 errors.  Donor-mode
streams are not held to verify_stream: the sweep composes them in the C
reference's bit-compatible "splice" rewrite mode, whose atlas rewrite and
waypoint-free scroll the verifier rejects, in both packages alike
(docs/KNOWN_ISSUES_ANALYSIS.md)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from h264_scroll_encoder_tpu_torch.scripts import parity_sweep

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def test_parity_sweep_cases_are_the_jax_scripts_draws():
    """The JAX script draws its cases inline (seed 2026); the same draws,
    in its order."""
    rng = np.random.default_rng(2026)
    want = []
    for i in range(10):
        w = 16 * int(rng.integers(2, 24))
        h = 16 * int(rng.integers(3, 40 if i < 8 else 300))
        n = int(rng.integers(3, 60))
        speed = int(rng.choice([1, 2, 4, 8, 16, 31, 62, 124]))
        want.append(("test", i, w, h, n, speed))
    for i in range(6):
        w = 16 * int(rng.integers(2, 12))
        h = 16 * int(rng.integers(4, 80))
        n = int(rng.integers(3, 40))
        speed = int(rng.choice([1, 2, 4, 8, 124]))
        want.append(("comp", i, w, h, n, speed))
    assert parity_sweep.sweep_cases() == want


# The test-mode cases compared with the JAX package (its cheapest
# compiles); every donor-mode case is.
JAX_CHECKED = {("test", 1), ("test", 7)}


def _jax_sweep_stream(mode, w, h, n, speed, da=None, db=None):
    from h264_scroll_encoder_tpu.cli import triangle_offsets
    from h264_scroll_encoder_tpu.config import ComposerConfig
    from h264_scroll_encoder_tpu.session import (ComposerSession,
                                                 open_donor_session)

    if mode == "test":
        s = ComposerSession(ComposerConfig(w, h))
        s.write_parameter_sets()
        s.write_test_atlases(striped=True)
        for off in triangle_offsets(n, speed, h - 16, start_offset=496):
            s.write_scroll_or_waypoint_frame(off)
    else:
        s = open_donor_session(str(da), str(db))
        s.write_parameter_sets()
        s.write_donor_atlases(s._donor_a_rbsp, s._donor_b_rbsp,
                              rewrite_mode="splice")
        for off in triangle_offsets(n, speed, h):
            s.write_scroll_frame(off)
    return s.getvalue()


@pytest.mark.parametrize("case", parity_sweep.sweep_cases(),
                         ids=lambda c: f"{c[0]}{c[1]}-{c[2]}x{c[3]}")
def test_parity_sweep_geometry(tmp_path, case):
    from h264_scroll_encoder_tpu_torch import avref
    from h264_scroll_encoder_tpu_torch.verify import verify_stream

    mode, i, w, h, n, speed = case
    da = db = None
    if mode == "test":
        s = parity_sweep.test_mode_stream(w, h, n, speed, "cpu")
    else:
        da, db = tmp_path / "da.h264", tmp_path / "db.h264"
        parity_sweep.write_donors(w, h, da, db, "cpu")
        s = parity_sweep.donor_mode_stream(da, db, h, n, speed, "cpu")
    data = s.getvalue()
    if mode == "comp" or (mode, i) in JAX_CHECKED:
        assert data == _jax_sweep_stream(mode, w, h, n, speed, da, db)
    if mode == "test":
        rep = verify_stream(data)
        assert rep.ok, rep.errors[:3]
        assert rep.frame_count == 2 + n
        if avref.available():
            pics, nerrors = avref.decode_pictures(data)
            assert nerrors == 0 and len(pics) == rep.frame_count


def test_parity_sweep_without_reference_binaries_exits_nonzero(tmp_path):
    """Where the C reference binaries are missing the sweep says so and
    exits non-zero."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run(
        [sys.executable, "-m", "h264_scroll_encoder_tpu_torch.scripts."
         "parity_sweep", "--ref-dir", str(tmp_path), "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 2
    assert "C reference binaries missing" in r.stderr
