"""Session checkpoint / resume: evict a session set and restore it.

Port of h264_scroll_encoder_tpu/utils/snapshot.py.  The reference has no
checkpointing; its closest analog is the stream-internal persistent state
— long-term reference pictures immune to frame_num wraparound and the
waypoint registry (include/h264_writer.h:30-58).  That state is exactly
what must be saved to evict and restore sessions: frame_num + waypoint
registry (+ the already-emitted byte count for exactly-once egress
bookkeeping).

Two forms, with the JAX package's keys and dtypes, so either package
resumes what the other evicted:
  - host `ComposerSession`: a JSON dict (tiny, human-readable), key for key
    the JAX package's.
  - device `parallel.batch.SessionState`: a numpy .npz with the fields
    frame_num, wp_offsets, wp_ltidx (int32), wp_valid (bool), wp_count
    (int32), plus `host_context` (UTF-8 JSON bytes) for a serving set.
    Saving goes through SessionState.to_numpy, loading through
    SessionState.from_numpy onto `device` (the card unless the caller asks
    for the CPU).
"""

from __future__ import annotations

import json

import numpy as np


# -- host session -----------------------------------------------------------

def session_state_dict(session) -> dict:
    return {
        "frame_num": session.frame_num,
        "frames_written": session.frames_written,
        "waypoints": {
            "offsets": list(session.waypoints.offsets),
            "long_term_idx": list(session.waypoints.long_term_idx),
            "count": session.waypoints.count,
        },
        "bytes_emitted": session.writer.size,
        "enable_pskip": session.enable_pskip,
        "config": {
            "width": session.cfg.width,
            "height": session.cfg.height,
            "rbsp_bits_per_mb": session.cfg.rbsp_bits_per_mb,
        },
    }


def save_session(session, path) -> None:
    with open(path, "w") as f:
        json.dump(session_state_dict(session), f)


def restore_session(session, path) -> None:
    """Restore dynamic state into a freshly constructed session whose
    config matches the snapshot (the emitted stream prefix itself is the
    caller's to replay or keep — the state here resumes future frames)."""
    with open(path) as f:
        snap = json.load(f)
    if (snap["config"]["width"], snap["config"]["height"]) != (
            session.cfg.width, session.cfg.height):
        raise ValueError("snapshot geometry does not match session config")
    session.frame_num = snap["frame_num"]
    session.frames_written = snap["frames_written"]
    wp = snap["waypoints"]
    session.waypoints.offsets = list(wp["offsets"])
    session.waypoints.long_term_idx = list(wp["long_term_idx"])
    session.waypoints.count = wp["count"]


# -- serving (splice) state -------------------------------------------------

def save_serving_state(path, batch_state, host_context: dict) -> None:
    """Evict a batched splice-serving session set: the device SessionState
    plus the serving loop's host scheduling context (ref maps, per-session
    schedule cursors, prev-ref header state, donor-class pins — any
    JSON-able dict).

    The composite reference pictures live in the decoder's DPB (the
    emitted stream), not in host or device memory, so this snapshot plus
    the already-emitted byte prefix is the complete session."""
    ctx = json.dumps(host_context)
    np.savez(path, **batch_state.to_numpy(),
             host_context=np.frombuffer(ctx.encode(), np.uint8))


def load_serving_state(path, *, device="cuda"):
    """Inverse of save_serving_state -> (SessionState on `device`,
    host_context)."""
    from ..parallel.batch import SessionState

    with np.load(path) as z:
        state = SessionState.from_numpy(z, device=device)
        ctx = json.loads(z["host_context"].tobytes().decode())
    return state, ctx


# -- device batch state -----------------------------------------------------

def save_batch_state(state, path) -> None:
    np.savez(path, **state.to_numpy())


def load_batch_state(path, *, device="cuda"):
    """SessionState saved by save_batch_state (either package's) on
    `device`."""
    from ..parallel.batch import SessionState

    with np.load(path) as z:
        return SessionState.from_numpy(z, device=device)
