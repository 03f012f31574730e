"""Build, load and launch the hand-written CUDA kernels (csrc/*.cu).

On first CUDA use the sources are compiled with nvcc for sm_90a into a
shared library with a plain C interface, cached under `_build/` (listed
in .gitignore) by a hash of the sources, the headers they share
(csrc/*.cuh) and the flags, and loaded with ctypes.  Nothing is built or
loaded at import time.

Each kernel is a `Kernel` whose `launches` counter goes up by one per
launch, so a run can show which kernels its main path went through:
KERNELS are the production kernels K1-K6, PROBE_KERNELS the measurement
probes P1-P6 (ops/probes.py, ops/cavlc_lockstep.py; P1 one counter per
stage, P5/P6 one per variant).
"""

from __future__ import annotations

import ctypes
import functools
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
              "-Xcompiler", "-fPIC", f"-DH264T_PACK_THREADS={PACK_THREADS}")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources() + sorted(_CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_DIR / f"libh264t_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> None:
    """Runs the commands side by side; raises with the output of the
    first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    outs = [p.communicate() for p in procs]
    for c, p, (so, se) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}) on {c[-1]}:\n"
                               f"{so}\n{se}")


def build() -> Path:
    """Compile csrc/*.cu (if the cached library is missing) and return its
    path: one nvcc per source, all started together, then one link.
    Raises with nvcc's output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f"{src.stem}.o") for src in _sources()]
        _run_all([[nvcc_path(), *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                  for src, obj in zip(_sources(), objs)])
        lib = os.path.join(tmp, "lib.so")
        _run_all([[nvcc_path(), *LINK_FLAGS, "-o", lib, *objs]])
        os.replace(lib, out)      # atomic: concurrent builders race safely
    return out


def ptxas_report(source: str) -> str:
    """What `nvcc -Xptxas -v` says of csrc/<source> built as the library
    builds it (registers, stack, spills and shared memory of each
    kernel); compiles into a temporary file and keeps nothing."""
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-c",
                            "-o", os.path.join(tmp, "x.o"),
                            str(_CSRC / source)],
                           capture_output=True, text=True, check=True)
    return r.stdout + r.stderr


def _load():
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _capturing() -> bool:
    """Whether the current stream is being captured into a CUDA graph."""
    return torch.cuda.is_current_stream_capturing()


class Kernel:
    """One extern "C" entry of the kernel library; `launches` counts the
    launches of its kernel.  A launch made while a CUDA graph is captured
    runs nothing then: it counts in `captured`, and utils/graphs adds it
    to `launches` on each replay of that graph (count_replay).  `name`
    tells apart counters that share an entry (P1's stages); it defaults
    to the symbol."""

    def __init__(self, symbol: str, argtypes, name: str | None = None):
        self.symbol = symbol
        self.name = name or symbol
        self.argtypes = argtypes
        self.launches = 0
        self.captured = 0
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
        if _capturing():
            self.captured += 1
        else:
            self.launches += 1


# K1: (pat, nb, sym_bytes, pat_row, nb_row, idc, idc_row, idc_value, batch,
#      n, items_per_thread, n_nal, n_rbsp, cap, align, append_tb, cluster,
#      nal_out, len_out, bits_out, ovf_out, stream)
EMIT_FUSED = Kernel("h264t_emit_fused",
                    [_P, _P, _I, _L, _L, _P, _L, _I, _I, _I, _I, _I, _I, _I,
                     _I, _I, _I, _P, _P, _P, _P, _P])
# K2: (pat, nb, sym_bytes, pat_row, nb_row, batch, n, items_per_thread,
#      n_words, cluster, words_out, total_out, stream)
_PACK_ARGS = [_P, _P, _I, _L, _L, _I, _I, _I, _I, _I, _P, _P, _P]
PACK_PLACE = Kernel("h264t_pack_place", _PACK_ARGS)

# K3: (rbsp, rbsp_row, m, rbsp_len, len_row, header, batch, n_nal, max_ins,
#      in_global, nal_out, total_out, stream)
EBSP_NAL = Kernel("h264t_ebsp_nal", [_P, _L, _I, _P, _L, _I, _I, _I, _I, _I,
                                     _P, _P, _P])
# K4: K2's block behind its own entry point and counter.
PACK_WORDS = Kernel("h264t_pack_words", _PACK_ARGS)

# K5 (ops/grid.composite_grid_batch): (fields, batch, H, W, r0, c0, R, C,
#     nrefs_value, wide, compact_x, parts, bg_p, bg_n, bg2_p, bg2_n, sr_p,
#     sr_n, last, stream); fields a host array of 15 x 5 int64.
COMPOSITE_GRID = Kernel("h264t_composite_grid",
                        [_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _P, _P, _P, _P, _P, _P, _P, _P])
# K6 (ops/grid.scroll_grid_batch): (fields, batch, h, w, nrefs_value, wide,
#     compact_x, enable_pskip, parts, pat, nb, last, stream); fields 4 x 5
#     int64.
SCROLL_GRID = Kernel("h264t_scroll_grid",
                     [_P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P])

KERNELS = (EMIT_FUSED, PACK_PLACE, EBSP_NAL, PACK_WORDS, COMPOSITE_GRID,
           SCROLL_GRID)

# P1: (stage, then K1's arguments, probe_meta, probe_words, stream); one
# counter per stage, in csrc's order (0 launch ... 5 full).
EMIT_STAGES = ("launch", "stage", "scan", "pack", "ep", "full")
EMIT_STAGE = {st: Kernel("h264t_emit_stage",
                         [_I] + EMIT_FUSED.argtypes[:-1] + [_P, _P, _P],
                         name=f"h264t_emit_stage[{st}]")
              for st in EMIT_STAGES}
# P2: K2's arguments without the cluster.
_PACK_NARROW_ARGS = [_P, _P, _I, _L, _L, _I, _I, _I, _I, _P, _P, _P]
PACK_PLACE_U16 = Kernel("h264t_pack_place_u16", _PACK_NARROW_ARGS)
# P3: (tile, then P2's arguments); one counter for every tile.
PACK_PLACE_TILED = Kernel("h264t_pack_place_tiled", [_I] + _PACK_NARROW_ARGS)

# P4: (data, row, nbytes, batch, k, ct, tz, rb, end_out, out, stream).
CAVLC_LOCKSTEP = Kernel("h264t_cavlc_lockstep",
                        [_P, _L, _I, _I, _I, _P, _P, _P, _P, _P, _P])
# P5/P6: (stage, then K3's arguments); one counter per variant, in
# ops/probes.EBSP_VARIANTS' order; `shared` and `direct` run stage 0
# (K3's own), `direct` on K3's global plan.
EBSP_VARIANTS = ("runs", "ballot", "shared", "direct", "lanes")
EBSP_VARIANT = {v: Kernel("h264t_ebsp_variant", [_I] + EBSP_NAL.argtypes,
                          name=f"h264t_ebsp_variant[{v}]")
                for v in EBSP_VARIANTS}

PROBE_KERNELS = (*EMIT_STAGE.values(), PACK_PLACE_U16, PACK_PLACE_TILED,
                 CAVLC_LOCKSTEP, *EBSP_VARIANT.values())


@functools.lru_cache(maxsize=None)
def _plan(symbol: str, device: int, *args: int) -> int:
    fn = getattr(_load(), symbol)
    fn.argtypes, fn.restype = [_I] * len(args), ctypes.c_int
    answer = fn(*args)
    if answer < 0:
        raise RuntimeError(f"{symbol}{args}: the CUDA runtime did not report "
                           "the card's shared-memory limit or occupancy")
    return answer


def emit_plan(sym_bytes: int, n: int, k: int, n_nal: int) -> int:
    """K1's plan on the current device for sessions of n symbols (k a
    thread on one block) into n_nal NAL bytes, as the built kernel decides
    (h264t_emit_plan; launches nothing): the blocks a session, 1 where one
    block's shared memory holds it (every 720p shape), else the cluster
    plan's C in ops/emit_fused.CLUSTER_SIZES; 0 where nothing fits."""
    return _plan("h264t_emit_plan", torch.cuda.current_device(), sym_bytes,
                 n, k, n_nal)


def pack_plan(sym_bytes: int, n: int, k: int, n_words: int) -> int:
    """As emit_plan, for K2/K4 (h264t_pack_plan) at n_words words."""
    return _plan("h264t_pack_plan", torch.cuda.current_device(), sym_bytes,
                 n, k, n_words)


def cluster_items(n: int, c: int) -> int:
    """Symbols a thread of a cluster block owns per staged chunk, as the
    built kernels compute them (h264t_cluster_items; launches nothing)."""
    return _plan("h264t_cluster_items", torch.cuda.current_device(), n, c)


def grid_plan(n_mbs: int, w: int, batch: int, kind: int) -> int:
    """K5's (kind 0) or K6's (kind 1) band plan on the current device for
    `batch` sessions of n_mbs MBs, w a row, as the built kernels decide
    (h264t_grid_plan; launches nothing): the row bands a session, P in
    ops/grid.PARTS (P > 1: a thread-block cluster of P blocks); 0 where no
    band fits a block (_plan's cache keeps each device's answer per
    shape: the library asks the runtime ~20 times for it)."""
    return _plan("h264t_grid_plan", torch.cuda.current_device(), n_mbs, w,
                 batch, kind)


def grid_capacity(n_mbs: int, w: int, parts: int, kind: int) -> int:
    """Blocks of the plan of `parts` bands the current device holds at once
    (h264t_grid_capacity; 0 where a band does not fit a block): what
    grid_plan weighs."""
    return _plan("h264t_grid_capacity", torch.cuda.current_device(), n_mbs,
                 w, parts, kind)


def grid_arithmetic(name: str, *args: int) -> int:
    """The band arithmetic of the built kernels, for ops/grid's twin:
    `name` band_row (h, parts, r), items (n_mbs, w, parts) or smem (n_mbs,
    w, parts, kind), h264t_grid_<name>."""
    fn = getattr(_load(), f"h264t_grid_{name}")
    fn.argtypes, fn.restype = [_I] * len(args), ctypes.c_int
    return fn(*args)


def ebsp_nal_in_global(n_nal: int) -> bool:
    """Whether K3 at this NAL size reads its rows from global memory and
    builds the NAL in place, where the staged row and the NAL pass a
    block's shared memory (h264t_ebsp_nal_in_global)."""
    return bool(_plan("h264t_ebsp_nal_in_global",
                      torch.cuda.current_device(), n_nal))


def blocks_per_sm(symbol: str, *args: int) -> int:
    """Resident blocks per SM of a kernel at a launch's shared memory, as
    cudaOccupancyMaxActiveBlocksPerMultiprocessor gives them on the
    current device (launches nothing): `symbol` is one of
    h264t_emit_blocks_per_sm (sym_bytes, k, n_nal, cluster),
    h264t_pack_blocks_per_sm (sym_bytes, k, n_words, cluster),
    h264t_pack_u16_blocks_per_sm (sym_bytes, k, n_words) and
    h264t_pack_tiled_blocks_per_sm (tile, sym_bytes, k, n_words)."""
    return _plan(symbol, torch.cuda.current_device(), *args)


def pack_tiled_items(sym_bytes: int, tile: int, n: int, n_words: int,
                     max_items: int) -> int:
    """P3's symbols per thread at this tile: ceil(n / (threads / tile))
    capped at max_items and lowered until `tile` sessions' staging and
    words fit a block (h264t_pack_tiled_items); 0 where nothing fits."""
    return _plan("h264t_pack_tiled_items", torch.cuda.current_device(),
                 sym_bytes, tile, n, n_words, max_items)


def pack_u16_max_words() -> int:
    """The most words P2 keeps, as the built probe has it."""
    return _plan("h264t_pack_u16_max_words", torch.cuda.current_device())


def ebsp_items_per_thread(valid: int) -> int:
    """K3's bytes per thread for a session of `valid` bytes, as the built
    kernel computes them (h264t_ebsp_items_per_thread; launches nothing)."""
    fn = _load().h264t_ebsp_items_per_thread
    fn.argtypes, fn.restype = [_I], ctypes.c_int
    return fn(valid)


GRAPH_NODE_KINDS = ("kernel", "memcpy", "memset", "other")


def graph_nodes(raw_graph: int) -> dict:
    """{kind: nodes} of a captured, not yet instantiated CUDA graph (the
    address `torch.cuda.CUDAGraph(keep_graph=True).raw_cuda_graph()`
    gives), kinds GRAPH_NODE_KINDS, a child graph's nodes counted as its
    own (h264t_graph_nodes; launches nothing)."""
    fn = _load().h264t_graph_nodes
    fn.argtypes, fn.restype = [_P, _P], ctypes.c_int
    kinds = (_L * len(GRAPH_NODE_KINDS))()
    err = fn(raw_graph, kinds)
    if err != 0:
        raise RuntimeError(f"h264t_graph_nodes: cudaError_t {err}")
    return dict(zip(GRAPH_NODE_KINDS, kinds))


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
    for k in KERNELS + PROBE_KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    """{name: launches} of every kernel, production and probe, graph
    replays included."""
    return {k.name: k.launches for k in KERNELS + PROBE_KERNELS}


def captured_counts() -> dict:
    """{Kernel: launches recorded into CUDA graphs so far}; the difference
    across one capture is what each replay of that graph launches."""
    return {k: k.captured for k in KERNELS + PROBE_KERNELS}


def count_replay(launches: dict) -> None:
    """Adds one replay of a graph that launches {Kernel: n} to the
    counters."""
    for k, n in launches.items():
        k.launches += n
