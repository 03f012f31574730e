"""Build, load and launch the hand-written CUDA kernels (csrc/*.cu).

On first CUDA use the sources are compiled with nvcc for sm_90a into a
shared library with a plain C interface, cached under `_build/` (listed
in .gitignore) by a hash of the sources and flags, and loaded with
ctypes.  Nothing is built or loaded at import time.

Each kernel is a `Kernel` whose `launches` counter goes up by one per
launch, so a run can show which kernels its main path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
# Threads per block of every kernel: compiled into the kernels, and read by
# the wrappers and the boundary cases (cases.pack_boundary_cases,
# cases.ebsp_boundary_cases).
PACK_THREADS = 512
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC",
              f"-DH264T_PACK_THREADS={PACK_THREADS}")

_lock = threading.Lock()
_lib = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_DIR / f"libh264t_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu (if the cached library is missing) and return its
    path.  Raises with nvcc's output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stdout}\n{r.stderr}")
        os.replace(tmp, out)      # atomic: concurrent builders race safely
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


class Kernel:
    """One extern "C" entry of the kernel library; `launches` counts the
    launches made through `launch`."""

    def __init__(self, symbol: str, argtypes):
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def launch(self, *args):
        if self._fn is None:
            fn = getattr(_load(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.symbol}: CUDA launch failed with cudaError_t {err}")
        self.launches += 1


# K1: (pat, nb, sym_bytes, pat_row, nb_row, idc, idc_row, idc_value, batch,
#      n, items_per_thread, n_nal, n_rbsp, cap, align, append_tb, nal_out,
#      len_out, bits_out, ovf_out, stream)
EMIT_FUSED = Kernel("h264t_emit_fused",
                    [_P, _P, _I, _L, _L, _P, _L, _I, _I, _I, _I, _I, _I, _I,
                     _I, _I, _P, _P, _P, _P, _P])
# K2: (pat, nb, sym_bytes, pat_row, nb_row, batch, n, items_per_thread,
#      n_words, words_out, total_out, stream)
_PACK_ARGS = [_P, _P, _I, _L, _L, _I, _I, _I, _I, _P, _P, _P]
PACK_PLACE = Kernel("h264t_pack_place", _PACK_ARGS)

# K3: (rbsp, rbsp_row, m, len, len_bytes, len_row, len_value, header,
#      header_bytes, header_row, header_value, batch, n_nal, max_ins,
#      nal_out, total_out, stream)
EBSP_NAL = Kernel("h264t_ebsp_nal", [_P, _L, _I, _P, _I, _L, _I, _P, _I, _L, _I,
                                     _I, _I, _I, _P, _P, _P])
# K4: K2's block behind its own entry point and counter.
PACK_WORDS = Kernel("h264t_pack_words", _PACK_ARGS)

KERNELS = (EMIT_FUSED, PACK_PLACE, EBSP_NAL, PACK_WORDS)


def ebsp_items_per_thread(valid: int) -> int:
    """K3's bytes per thread for a session of `valid` bytes, as the built
    kernel computes them (h264t_ebsp_items_per_thread; launches nothing)."""
    fn = _load().h264t_ebsp_items_per_thread
    fn.argtypes, fn.restype = [_I], ctypes.c_int
    return fn(valid)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; a CUDA device without a usable
    CUDA runtime raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            "device='cpu' to run on the CPU")
    return dev


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
