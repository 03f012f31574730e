"""The benchmark's yardstick: the card's peak, the bytes each kernel must
move, the statistics of a window and the reduction of a profiler trace.

Nothing here reads the program: the byte counts are worked out from a
cell's configuration and traffic (frame and rect size, wire classes,
budget, batch), so a later change of the program's layout leaves them as
they are.  The rule is the one the port's bring-up used for its kernel
table: each input the cell's data needs read once, each output written
once, at the card's memory rate.  The shapes below are those of the
program when this benchmark was written; tests/test_portbench_harness.py
holds them to the program's tensors at a small batch.
"""

from __future__ import annotations

import dataclasses
import math

# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3 (at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12

# Symbols of the composer's P slice header (14 fixed slots, two per
# waypoint slot of 8, 7 for the MMCO marking, 2 for a short-term lead).
HEADER_SLOTS = 14 + 2 * 8 + 7 + 2
# Emulation-prevention insertions K1's bounded path allows a frame.
EBSP_CAP = 16
# RBSP bits per MB of the scroll step's working budget.
SCROLL_BITS_PER_MB = 16


def nal_bytes(n_rbsp: int, cap: int = EBSP_CAP) -> int:
    """A frame's NAL buffer: start code, header, RBSP budget and the
    insertions, in 4-byte words."""
    return (5 + n_rbsp + cap + 11) // 4 * 4


def k1_bytes(batch: int, n_sym: int, n_rbsp: int) -> int:
    """K1 (fused pack, emulation prevention and framing) per call: int32
    patterns and widths of every symbol read, a session's nal_ref_idc,
    its NAL buffer and 16 bytes of results (length, bits, flag)
    written."""
    return batch * (8 * n_sym + 4 + nal_bytes(n_rbsp) + 16)


def splice_rows_symbols(h: int, w: int, r0: int, c0: int, rows: int,
                        cols: int, s_row: int) -> int:
    """Symbols of the rows splice's compact program: the header, two
    slots a background MB, a third where its prediction sees the rect
    (the column right of it, the column left of it below its top row,
    the row under it), each rect row's skip-run slot and s_row chunks,
    and the tail skip run."""
    ring = 0
    if c0 + cols < w:
        ring += rows
    if c0 >= 1:
        ring += rows - 1
    if r0 + rows < h:
        ring += min(c0 + cols, w - 1) - (c0 - 1 if c0 >= 1 else 0) + 1
    return (HEADER_SLOTS + 2 * (h * w - rows * cols) + ring
            + rows * (1 + s_row) + 1)


def scroll_symbols(h: int, w: int) -> int:
    """Symbols of a scroll frame: the header, two slots an MB, the tail
    skip run."""
    return HEADER_SLOTS + 2 * h * w + 1


def scroll_rbsp(h: int, w: int) -> int:
    return (h * w * SCROLL_BITS_PER_MB // 8 + 96 + 3) // 4 * 4


def k5_bytes_all_skip(batch: int, h: int, w: int, rows: int,
                      cols: int) -> int:
    """K5 (the splice steps' composite grid) per call on an all-skip,
    zero-motion background: the background's coded mask outside the rect
    and the donor's inside it read (a byte an MB; no MB outside the rect
    is coded, so no MV or reference is needed), the background slots
    (3 + 2 compact, patterns and widths), the skip runs (patterns and
    widths) and the last coded MB written as int32."""
    reads = (h * w - rows * cols) + rows * cols
    writes = 4 * h * w * (2 * 3 + 2 * 2 + 2) + 4
    return batch * (reads + writes)


def k6_bytes(batch: int, h: int, w: int, slots: int = 2) -> int:
    """K6 (the scroll MB grid) per call: the int32 ref, mv_x and mv_y
    fields and a session's num_refs read, each MB's slots (patterns and
    widths) and the last coded MB written."""
    return batch * (3 * 4 * h * w + 4 + 2 * 4 * slots * h * w + 4)


# ---------------------------------------------------------------------------
# Statistics of a window.
# ---------------------------------------------------------------------------

def percentile(values, q: float) -> float:
    """The q-th percentile by linear interpolation between the order
    statistics (numpy's default), of a non-empty sequence."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


# ---------------------------------------------------------------------------
# A profiler trace, reduced.
# ---------------------------------------------------------------------------

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "portbench.traced"


@dataclasses.dataclass
class TraceSummary:
    """What the per-layer readers take from a traced window: its length,
    the seconds in which the device ran anything, each device op's
    (name, seconds) and the idle time by the host span it fell in (the
    spans do not nest; idle time outside them is "between_spans")."""
    window_s: float
    busy_s: float
    ops: list                 # [(name, seconds)] of each device op
    idle_by_span: dict        # {host span name: idle seconds}

    def kernel_mean_s(self, pattern: str):
        """Mean seconds of the ops whose name holds `pattern`, or None."""
        ds = [d for n, d in self.ops if pattern in n]
        return sum(ds) / len(ds) if ds else None

    def top_ops(self, n: int = 10) -> list:
        total: dict = {}
        for name, d in self.ops:
            total[name] = total.get(name, 0.0) + d
        return sorted(([k, v] for k, v in total.items()),
                      key=lambda kv: -kv[1])[:n]

    def top_gaps(self, n: int = 10) -> list:
        return sorted(([k, v] for k, v in self.idle_by_span.items()),
                      key=lambda kv: -kv[1])[:n]


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize_trace(events, span_names) -> TraceSummary | None:
    """Reduce chrome-trace events (torch.profiler's export) to a
    TraceSummary over the WINDOW_SPAN annotation, or None without it or
    without any device op in it.  Times in the trace are microseconds."""
    windows = [e for e in events if e.get("name") == WINDOW_SPAN
               and e.get("cat") == "user_annotation"]
    if not windows:
        return None
    w0 = windows[0]["ts"]
    w1 = w0 + windows[0]["dur"]
    ops, busy = [], []
    for e in events:
        if e.get("cat") not in DEVICE_CATEGORIES or "dur" not in e:
            continue
        a, b = e["ts"], e["ts"] + e["dur"]
        if b <= w0 or a >= w1:
            continue
        ops.append((e.get("name", "?"), e["dur"] * 1e-6))
        busy.append((max(a, w0), min(b, w1)))
    if not ops:
        return None
    merged = _merge(busy)
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name") in span_names)
    idle: dict = {}
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    j = 0
    for a, b in zip(edges[::2], edges[1::2]):
        while j < len(spans) and spans[j][1] <= a:
            j += 1
        covered = 0.0
        k = j
        while k < len(spans) and spans[k][0] < b:
            part = min(b, spans[k][1]) - max(a, spans[k][0])
            if part > 0:
                idle[spans[k][2]] = idle.get(spans[k][2], 0.0) + part * 1e-6
                covered += part
            k += 1
        if b - a - covered > 0:
            idle["between_spans"] = (idle.get("between_spans", 0.0)
                                     + (b - a - covered) * 1e-6)
    return TraceSummary(window_s=(w1 - w0) * 1e-6,
                        busy_s=sum(b - a for a, b in merged) * 1e-6,
                        ops=ops, idle_by_span=idle)


def roofline_pct(bytes_per_call, seconds_per_call):
    """Least time for the bytes at the card's rate as a share (%) of the
    measured time, or None where either is missing."""
    if not bytes_per_call or not seconds_per_call:
        return None
    return 100.0 * bytes_per_call / HBM_BYTES_PER_S / seconds_per_call
