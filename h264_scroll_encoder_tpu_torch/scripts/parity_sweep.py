"""Seeded parity sweep of the port's sessions against the C reference
binaries.

Port of scripts/parity_sweep.py: the same seeded geometries (numpy seed
2026) — ten test-mode scroll streams (the last two tall) against the
reference `h264_scroll_encoder -t`, and six donor-mode streams against the
reference `composer` on I_PCM donors — each compared byte for byte, with a
NAL-by-NAL report on a mismatch.

    python -m h264_scroll_encoder_tpu_torch.scripts.parity_sweep \
        [--ref-dir DIR] [--work-dir DIR] [--device D]

--ref-dir holds the reference binaries, built out of tree as
tests/conftest.py builds them (default /tmp/refbuild).  Where they are
missing the sweep says so and exits 2; a mismatch exits 1.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

SEED = 2026
BINARIES = ("h264_scroll_encoder", "composer")


def sweep_cases(seed: int = SEED) -> list:
    """The sweep's seeded cases, drawn as the JAX package's script draws
    them: [(mode, i, width, height, frames, speed)] with mode "test" (ten)
    or "comp" (six)."""
    rng = np.random.default_rng(seed)
    cases = []
    for i in range(10):
        w = 16 * int(rng.integers(2, 24))
        h = 16 * int(rng.integers(3, 40 if i < 8 else 300))  # tall cases last
        n = int(rng.integers(3, 60))
        speed = int(rng.choice([1, 2, 4, 8, 16, 31, 62, 124]))
        cases.append(("test", i, w, h, n, speed))
    for i in range(6):
        w = 16 * int(rng.integers(2, 12))
        h = 16 * int(rng.integers(4, 80))
        n = int(rng.integers(3, 40))
        speed = int(rng.choice([1, 2, 4, 8, 124]))
        cases.append(("comp", i, w, h, n, speed))
    return cases


def test_mode_stream(w: int, h: int, n: int, speed: int, device="cuda"):
    """The port's test-mode stream (striped I_PCM atlases, waypoints from
    496 px): what `h264_scroll_encoder -t -n N -S SPEED -w W -H H`
    writes.  Returns the session."""
    from ..cli import triangle_offsets
    from ..config import ComposerConfig
    from ..session import ComposerSession

    s = ComposerSession(ComposerConfig(w, h), device=device)
    s.write_parameter_sets()
    s.write_test_atlases(striped=True)
    for off in triangle_offsets(n, speed, h - 16, start_offset=496):
        s.write_scroll_or_waypoint_frame(off)
    return s


def write_donors(w: int, h: int, da, db, device="cuda") -> None:
    """The two I_PCM donor files of a donor-mode case."""
    from ..config import ComposerConfig
    from ..models import ipcm
    from ..session import ComposerSession

    cfg = ComposerConfig(w, h)
    for path, color in ((da, (81, 90, 240)), (db, (41, 240, 110))):
        sd = ComposerSession(cfg, device=device)
        sd.write_parameter_sets()
        sd.writer.append_raw(ipcm.idr_frame_color(cfg, *color))
        sd.write_to_file(path)


def donor_mode_stream(da, db, h: int, n: int, speed: int, device="cuda"):
    """The port's donor-mode stream (bit-compatible 'splice' rewrite): what
    `composer --ref-a DA --ref-b DB -n N -s SPEED` writes.  Returns the
    session."""
    from ..cli import triangle_offsets
    from ..session import open_donor_session

    s = open_donor_session(da, db, device=device)
    s.write_parameter_sets()
    s.write_donor_atlases(s._donor_a_rbsp, s._donor_b_rbsp,
                          rewrite_mode="splice")
    for off in triangle_offsets(n, speed, h):
        s.write_scroll_frame(off)
    return s


def main(argv=None) -> int:
    from ..verify import nal_diff

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ref-dir", default="/tmp/refbuild")
    ap.add_argument("--work-dir")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ref = Path(args.ref_dir)
    absent = [b for b in BINARIES if not (ref / b).is_file()]
    if absent:
        print(f"parity_sweep: C reference binaries missing in {ref}: "
              f"{', '.join(absent)} (build them from the reference sources "
              f"as tests/conftest.py does)", file=sys.stderr)
        return 2

    fails = 0
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(args.work_dir or tmp)
        work.mkdir(parents=True, exist_ok=True)
        for mode, i, w, h, n, speed in sweep_cases():
            if mode == "test":
                out = work / f"sweep_ref_{i}.h264"
                cmd = [str(ref / "h264_scroll_encoder"), "-t", "-n", str(n),
                       "-S", str(speed), "-w", str(w), "-H", str(h),
                       "-o", str(out)]
            else:
                da, db = work / f"sweep_da_{i}.h264", work / f"sweep_db_{i}.h264"
                write_donors(w, h, da, db, args.device)
                out = work / f"sweep_comp_{i}.h264"
                cmd = [str(ref / "composer"), "--ref-a", str(da),
                       "--ref-b", str(db), "-n", str(n), "-s", str(speed),
                       "-o", str(out)]
            if subprocess.run(cmd, capture_output=True).returncode != 0:
                print(f"[{mode} {i}] reference failed for {w}x{h}")
                continue
            s = (test_mode_stream(w, h, n, speed, args.device)
                 if mode == "test" else
                 donor_mode_stream(da, db, h, n, speed, args.device))
            ours, want = s.getvalue(), out.read_bytes()
            if ours != want:
                fails += 1
                print(f"[{mode} {i}] MISMATCH {w}x{h} n={n} S={speed}")
                print(nal_diff(ours, want))
            else:
                print(f"[{mode} {i}] ok {w}x{h} n={n} S={speed} "
                      f"wp={s.waypoints.count}", flush=True)
    print("SWEEP DONE, fails =", fails)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
