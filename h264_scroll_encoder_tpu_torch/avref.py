"""Independent third-party conformance oracle (libavcodec / libx264).

Port of h264_scroll_encoder_tpu/avref.py: the system libavcodec, wrapped
by csrc/avref.c (a copy of native/avref.c), gives

  decode_pictures(data)  -> ([Picture], n_decoder_errors)
  encode_x264(frames)    -> Annex-B bytes (baseline/CAVLC stream)

x264 is reached through libavcodec's libx264 encoder.  The decoder shares
no code with the emitters, so agreement is third-party conformance.

The port builds the shim itself, on first use and never at import: gcc
compiles csrc/avref.c against the system libavcodec and libavutil into
`_build/` (gitignored) under a file lock, into a temporary name that is
then renamed, as native_bridge builds the CAVLC engine; nothing is
written into the JAX package's native/.  `available()` is the gate: it
is False where the libraries, their headers or a C compiler are missing
(`missing()` says which), and tests that need the oracle skip.  Where
they are present a failed build raises; it never reads as unavailable.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from .pixel_oracle import Picture

_SOURCE = Path(__file__).resolve().parent / "csrc" / "avref.c"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
CC_FLAGS = ("-O2", "-Wall", "-Wextra", "-fPIC", "-shared")
LIBS = ("-lavcodec", "-lavutil")

_lock = threading.Lock()
_lib = None


def cc_path() -> str | None:
    for name in (os.environ.get("CC"), "gcc", "cc"):
        found = name and shutil.which(name)
        if found:
            return found
    return None


@functools.lru_cache(maxsize=1)
def missing() -> str | None:
    """Why the oracle cannot be built here (no C compiler, no system
    libavcodec / libavutil, or no libavcodec headers), or None."""
    cc = cc_path()
    if cc is None:
        return "no C compiler (gcc)"
    libs = [n for n in ("avcodec", "avutil") if ctypes.util.find_library(n) is None]
    if libs:
        return "system libraries missing: " + ", ".join(f"lib{n}" for n in libs)
    probe = subprocess.run([cc, "-E", "-x", "c", "-"], capture_output=True,
                           text=True, input="#include <libavcodec/avcodec.h>\n")
    if probe.returncode != 0:
        return "libavcodec headers missing (libavcodec/avcodec.h)"
    return None


def available() -> bool:
    """True where the oracle is built and loaded (building it on first
    use); False where the system libraries are missing.  A build that
    fails while they are present raises."""
    if missing() is not None:
        return False
    load_library()
    return True


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CC_FLAGS + LIBS).encode())
    h.update(_SOURCE.read_bytes())
    return _BUILD_DIR / f"libh264t_avref_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/avref.c (if the cached library is missing) and return
    its path.  Raises with the compiler's output when the build fails, and
    with missing()'s reason where the libraries are absent."""
    why = missing()
    if why is not None:
        raise RuntimeError(f"avref cannot be built: {why}")
    out = library_path()
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / ".avref.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():               # another process built it meanwhile
            return out
        with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
            so = Path(tmp) / out.name
            cmd = [cc_path(), *CC_FLAGS, str(_SOURCE), "-o", str(so), *LIBS]
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"avref build failed ({r.returncode}):\n"
                                   f"{r.stdout}\n{r.stderr}")
            os.replace(so, out)
    return out


def load_library():
    """Build (on first use) and load the shim; raises on any failure."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            ip = ctypes.POINTER(ctypes.c_int)
            lib.avref_decode.restype = ctypes.c_int
            lib.avref_decode.argtypes = [u8p, ctypes.c_long, u8p,
                                         ctypes.c_long, ip, ip, ip]
            lib.avref_encode_x264.restype = ctypes.c_long
            lib.avref_encode_x264.argtypes = [
                u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_char_p, u8p,
                ctypes.c_long]
            lib.avref_version.restype = ctypes.c_uint
            _lib = lib
        return _lib


def decode_yuv(data: bytes, max_frames: int = 4096):
    """Decode Annex-B bytes -> (yuv u8[nframes, w*h*3//2], w, h, nerrors).

    nerrors counts decoder-reported problems (send/receive failures and
    AV_LOG_ERROR messages) — 0 is the `ffmpeg -v error` clean-decode
    criterion.
    """
    lib = load_library()
    src = np.frombuffer(data, np.uint8)
    # Sized from the compressed input (64x expansion, at least 64 frames
    # of 720p) rather than max_frames; -4 (buffer too small) grows and
    # retries.
    cap = min(max(len(data) * 64, 64 * 1280 * 720 * 3 // 2),
              max_frames * 1280 * 720 * 3 // 2)
    while True:
        out = np.empty(cap, np.uint8)
        w, h, ne = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        n = lib.avref_decode(src.ctypes.data_as(u8p), len(data),
                             out.ctypes.data_as(u8p), cap, ctypes.byref(w),
                             ctypes.byref(h), ctypes.byref(ne))
        if n == -4 and cap < (1 << 33):
            cap = min(cap * 4, 1 << 33)
            continue
        break
    if n < 0:
        raise RuntimeError(f"avref_decode failed: {n}")
    fsz = w.value * h.value * 3 // 2
    return (out[: n * fsz].reshape(n, fsz).copy() if n else
            np.empty((0, 0), np.uint8)), w.value, h.value, ne.value


def decode_pictures(data: bytes):
    """Annex-B bytes -> ([pixel_oracle.Picture], n_decoder_errors)."""
    yuv, w, h, nerrors = decode_yuv(data)
    pics = []
    for row in yuv:
        y = row[: w * h].reshape(h, w)
        cb = row[w * h: w * h * 5 // 4].reshape(h // 2, w // 2)
        cr = row[w * h * 5 // 4:].reshape(h // 2, w // 2)
        pics.append(Picture(y, cb, cr))
    return pics, nerrors


def encode_x264(frames, qp: int = 20, keyint: int = 1, refs: int = 1,
                extra_params: str = "") -> bytes:
    """Encode Pictures / (y, cb, cr) uint8 plane triples with x264:
    baseline profile (CAVLC, no B-frames); keyint=1 makes every frame an
    IDR."""
    lib = load_library()
    planes = []
    for f in frames:
        y, cb, cr = ((f.y, f.cb, f.cr) if isinstance(f, Picture) else f)
        planes.append(np.concatenate(
            [np.asarray(p, np.uint8).ravel() for p in (y, cb, cr)]))
    h, w = (frames[0].y.shape if isinstance(frames[0], Picture)
            else np.asarray(frames[0][0]).shape)
    yuv = np.concatenate(planes)
    cap = max(1 << 20, yuv.size * 2)
    out = np.empty(cap, np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.avref_encode_x264(yuv.ctypes.data_as(u8p), w, h, len(frames), qp,
                              keyint, refs, extra_params.encode(),
                              out.ctypes.data_as(u8p), cap)
    if n <= 0:
        raise RuntimeError(f"avref_encode_x264 failed: {n}")
    return out[:n].tobytes()
