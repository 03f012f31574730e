"""Multi-session serving demo: the production-shaped driver loop.

Port of examples/serving_demo.py.  Shows the deployment pattern:
  1. N UI sessions with device-resident state (frame_num + waypoint
     registries) batched per card;
  2. each step composes one P-frame per session on the device (waypoint
     reference frames emitted automatically when a session's scroll
     crosses a 496 px boundary);
  3. packed Annex-B bytes stream back per session for egress;
  4. session state snapshot/restore for eviction (checkpoint/resume).

    python -m h264_scroll_encoder_tpu_torch.examples.serving_demo \
        [--device cuda|cpu] [--out-dir DIR]

--out-dir keeps each session's stream (session_<b>.h264) and the
snapshot; without it they go to a temporary directory.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch


def run(device="cuda", *, width: int = 1280, height: int = 720,
        n_sessions: int = 8, n_frames: int = 40, out_dir=None,
        log=print) -> list:
    """Compose, verify and snapshot; returns every session's stream."""
    from ..config import ComposerConfig
    from ..parallel import batch
    from ..session import ComposerSession
    from ..utils import snapshot
    from ..utils.trace import StageTimer
    from ..verify import verify_stream

    cfg = ComposerConfig(width, height)

    # Per-session headers + atlases (host, once per session).
    host_sessions = []
    for _ in range(n_sessions):
        s = ComposerSession(cfg, device=device)
        s.write_parameter_sets()
        s.write_test_atlases(striped=True)
        host_sessions.append(s)

    # Device-resident batched stepping.
    step = batch.make_batched_step(cfg)
    state = batch.SessionState.create(n_sessions, device=device)
    timer = StageTimer()
    for t in range(n_frames):
        # Each session scrolls at its own speed (UI-driven in production).
        offsets = np.array([(t * (2 + b)) % cfg.height
                            for b in range(n_sessions)], np.int32)
        with timer.stage("compose"):
            state, (nal, nal_len, _was_wp, _bits, ovf) = step(
                state, torch.as_tensor(offsets))
            # One copy back per step (the stage closes on this fetch).
            nal_np, len_np, ovf_np = (x.cpu().numpy()
                                      for x in (nal, nal_len, ovf))
        if ovf_np.any():
            raise AssertionError(f"step {t}: a frame overflowed")
        for b in range(n_sessions):
            # A waypoint step consumed the offset for the reference frame;
            # production schedulers re-issue the offset (here the next tick
            # simply continues).
            host_sessions[b].writer.append_raw(
                nal_np[b][: len_np[b]].tobytes())
        timer.count("frames", n_sessions)
        timer.count("bytes", int(len_np.sum()))
    compose = timer.stages["compose"]
    log(f"composed {timer.counters['frames']} frames across {n_sessions} "
        f"sessions in {compose.total_s * 1e3:.0f} ms "
        f"({timer.counters['bytes']} B)")

    # Verify every session's full stream with the structural oracle.
    streams = [s.getvalue() for s in host_sessions]
    for b, data in enumerate(streams):
        rep = verify_stream(data)
        if not rep.ok:
            raise AssertionError(f"session {b}: {rep.errors[:2]}")
    log("all session streams verify OK")

    # Evict / restore round trip of the device state.
    with tempfile.TemporaryDirectory() as tmp:
        where = Path(out_dir or tmp)
        where.mkdir(parents=True, exist_ok=True)
        path = where / "serving_state.npz"
        snapshot.save_batch_state(state, path)
        restored = snapshot.load_batch_state(path, device=device)
        for f, a in state.to_numpy().items():
            if not np.array_equal(restored.to_numpy()[f], a):
                raise AssertionError(f"restored state: {f} differs")
        if out_dir:
            for b, data in enumerate(streams):
                (where / f"session_{b}.h264").write_bytes(data)
    log("device state snapshot/restore OK")
    return streams


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--sessions", type=int, default=8)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--out-dir")
    args = ap.parse_args(argv)
    run(args.device, width=args.width, height=args.height,
        n_sessions=args.sessions, n_frames=args.frames, out_dir=args.out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
