"""The benchmark's traffic generator and its loops.

A cell names a configuration (`configs/<name>.json`: the deployment) and
a traffic mix (`traffic/<name>.json`: its parameters).  The mix's
"loop" picks one of the loops below, which make every input from the
run's seed and drive the program's served path one step at a time:

  splice_rows   the rows splice step over the blob wire, graphed, then
                egress (`compact_batch_nal`, the lengths and the packed
                bytes copied to the host); the donors, made from the seed
                and prepared once at set-up by the native donor prep,
                stay on the card and each step gathers each session's
                row there.
  scroll_batch  the graphed batched scroll step (`make_batched_step`),
                its session state carried step to step, then egress.
  scroll_session one `ComposerSession`, a frame a step through
                `write_scroll_or_waypoint_frame`, the bytes taken from
                the session's host buffer.

A step's frames all share its latency: from the hand-over of its inputs
to its bytes on the host.  `keep` holds the host bytes of the steps the
check samples; `check` compares them with the plain reference
(reference/) after the window.  A new mix of an existing loop is a new
data file; nothing here names a cell.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from . import yardstick
from .reference import donors
from .reference import h264 as ref_h264
from .reference import scroll as ref_scroll
from .reference import splice as ref_splice


def no_span(_name):
    return contextlib.nullcontext()


def sample_steps(seed: int) -> set:
    """Window steps whose output the check keeps: step 0 and one step in
    each [2**i, 2**(i+1)), placed by the seed (the loop adds the
    window's last step)."""
    rng = np.random.default_rng((seed, 1))
    return {0} | {(1 << i) + int(rng.integers(0, 1 << i))
                  for i in range(40)}


def sample_sessions(seed: int, t: int, batch: int, k: int) -> list:
    rng = np.random.default_rng((seed, 2, t))
    return sorted(int(b) for b in rng.choice(batch, size=min(k, batch),
                                             replace=False))


def sps_of(config: dict) -> ref_h264.Sps:
    return ref_h264.Sps(config["width"], config["height"],
                        **config.get("sps", {}))


def composer_config(config: dict):
    """The program's ComposerConfig for the deployment."""
    from h264_scroll_encoder_tpu_torch.config import ComposerConfig

    sps = config.get("sps", {})
    cfg = ComposerConfig(config["width"], config["height"])
    return cfg.with_sps_params(
        sps.get("log2_max_frame_num", cfg.log2_max_frame_num),
        sps.get("pic_order_cnt_type", cfg.pic_order_cnt_type),
        sps.get("log2_max_pic_order_cnt_lsb",
                cfg.log2_max_pic_order_cnt_lsb))


class Checks:
    """Numbers compared after the window, each with its limit: `maxima`
    may not be exceeded, `minima` must be reached."""

    def __init__(self):
        self.rows: list = []     # (name, value, limit, kind)

    def most(self, name: str, value: int, limit: int) -> None:
        self.rows.append((name, value, limit, "max"))

    def least(self, name: str, value: int, limit: int) -> None:
        self.rows.append((name, value, limit, "min"))

    @property
    def correct(self) -> bool:
        return all(v <= lim if kind == "max" else v >= lim
                   for _, v, lim, kind in self.rows)

    def as_dict(self) -> dict:
        return {n: {"value": v, "limit": lim} for n, v, lim, _ in self.rows}

    def lines(self) -> list:
        return [f"check {n}: {v} ({'at most' if k == 'max' else 'at least'} "
                f"{lim})" for n, v, lim, k in self.rows]


class Loop:
    """What the harness needs of a loop (see the module docstring)."""
    frames_per_step = 1

    def __init__(self, config: dict, traffic: dict, seed: int, device, *,
                 batch: int | None = None, control: bool = False):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.control = control
        self.check_cfg = traffic["check"]
        self.keep_steps = sample_steps(seed)
        self.kept: list = []
        self.failed = 0
        self.events: list = []   # (start, end) CUDA events of traced steps
        self.timed = False
        self.setup_parts_s: dict = {}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def event_pair(self):
        if not (self.timed and self.device.type == "cuda"):
            return None
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        self.events.append(pair)
        return pair

    def device_seconds(self) -> list:
        self.sync()
        return [a.elapsed_time(b) * 1e-3 for a, b in self.events]

    def finish(self) -> None:
        """Keeps what the check needs of the window's last step."""

    def close(self) -> None:
        """Frees the program's state before the reference runs."""


class _Egress:
    """compact_batch_nal into one packed buffer (a cap no step can pass),
    then the lengths and flags in one copy to the host and the packed
    bytes in a second, into a pinned host buffer."""

    def __init__(self, batch_mod, n_sessions: int, row_bytes: int, device):
        self.batch_mod = batch_mod
        self.cap = n_sessions * row_bytes
        pin = device.type == "cuda"
        self.host = torch.empty(self.cap, dtype=torch.uint8, pin_memory=pin)
        self.view = self.host.numpy()

    def __call__(self, nal, nal_len, overflow):
        """(lengths, overflow flags, bytes on the host)."""
        packed, _total, _over = self.batch_mod.compact_batch_nal(
            nal, nal_len, self.cap)
        meta = torch.cat([nal_len.to(torch.int32),
                          overflow.to(torch.int32)]).cpu().numpy()
        n = nal_len.shape[0]
        lens, ovf = meta[:n], meta[n:].astype(bool)
        total = int(lens.sum())
        self.host[:total].copy_(packed[:total])
        return lens, ovf, total


class _BatchLoop(Loop):
    """Shared by the batched loops: the step's outputs to the host,
    the kept steps and the frame sample."""

    egress = None

    def _deliver(self, t, out, span, retry=None):
        nal, nal_len, overflow = out[0], out[1], out[-1]
        if self.egress is None:     # a NAL row a session: no step passes it
            self.egress = _Egress(self.batch_mod, self.B, nal.shape[1],
                                  self.device)
        with span("egress"):
            lens, ovf, total = self.egress(nal, nal_len, overflow)
            if ovf.any() and retry is not None:
                self.retries += 1
                nal, nal_len, _bits, overflow = retry()
                lens, ovf, total = self.egress(nal, nal_len, overflow)
        self.failed += int(ovf.sum()) + int((lens <= 0).sum())
        self.last = (t, total, lens, ovf)
        if t - self.warm in self.keep_steps:
            self.kept.append((t, bytes(self.egress.view[:total]), lens, ovf))

    def finish(self) -> None:
        t, total, lens, ovf = self.last
        if not self.kept or self.kept[-1][0] != t:
            self.kept.append((t, bytes(self.egress.view[:total]), lens, ovf))

    def sampled_frames(self):
        """[(t, b, bytes)] of the sampled frames: check["frames"] spread
        over the kept steps, the sessions of each drawn from the seed."""
        out = []
        k = -(-self.check_cfg["frames"] // len(self.kept))
        for t, data, lens, _ovf in self.kept:
            ends = np.cumsum(lens)
            for b in sample_sessions(self.seed, t, self.B, k):
                out.append((t, b, data[ends[b] - lens[b]:ends[b]]))
        return out

    def close(self) -> None:
        for name in ("step_fn", "exact_fn", "state", "dn_pool", "hp", "hn",
                     "zero", "zero_b", "sched", "picks"):
            if hasattr(self, name):
                delattr(self, name)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class SpliceRows(_BatchLoop):
    """Rows splice serving: a donor rect into each session's all-skip
    frame from a pool of donors on the card (see the module docstring)."""

    def __init__(self, config, traffic, seed, device, **kw):
        super().__init__(config, traffic, seed, device, **kw)
        self.B = kw.get("batch") or traffic["batch"]
        self.frames_per_step = self.B
        rect = config["rect"]
        self.r0, self.c0 = rect["mb_y"], rect["mb_x"]
        self.R, self.C = rect["mb_h"], rect["mb_w"]
        self.pool_n = traffic["donor_pool"]
        self.stride = traffic["donor_stride"]
        self.retries = 0

    def donor(self, t: int, b: int) -> int:
        return (b + self.stride * t) % self.pool_n

    def frame_num(self, t: int) -> int:
        return ((self.config["frame_num_start"] + t)
                % (1 << sps_of(self.config).log2_max_frame_num))

    def bound_bytes(self) -> dict:
        c, w = self.config, self.config["wire"]
        h, wd = c["height"] // 16, c["width"] // 16
        n_sym = yardstick.splice_rows_symbols(h, wd, self.r0, self.c0,
                                              self.R, self.C, w["s_row"])
        return {"k1": yardstick.k1_bytes(self.B, n_sym,
                                         c["rbsp_budget_bytes"]),
                "k5": yardstick.k5_bytes_all_skip(self.B, h, wd, self.R,
                                                  self.C)}

    def setup(self, workers) -> None:
        from h264_scroll_encoder_tpu_torch.models import splice_device
        from h264_scroll_encoder_tpu_torch.parallel import batch
        from h264_scroll_encoder_tpu_torch.syntax.slice_headers import (
            p_slice_header_symbols)

        c, w, dev, B = self.config, self.config["wire"], self.device, self.B
        cfg = composer_config(c)
        t = time.perf_counter()
        payloads = workers.map(
            donors.make_payload,
            [(self.seed, k, self.C, self.R) for k in range(self.pool_n)])
        self.setup_parts_s["payloads"] = time.perf_counter() - t
        t_program = time.perf_counter()

        dn, (_bits, align) = splice_device.prepare_donor_rows_serving(
            payloads, [0] * self.pool_n, self.R, self.C,
            c["donor_num_refs"], c["num_refs"], s_row=w["s_row"],
            blob_wire=True, s_flat=w["s_flat"], s_exc=w["s_exc"],
            device=dev)
        if align.any():
            raise ValueError("a donor carries I_PCM alignment; the "
                             "configuration's step has none")
        self.dn_pool = dn["blob"]
        period = self.pool_n // np.gcd(self.stride, self.pool_n)
        t = torch.arange(period, device=dev)[:, None]
        self.picks = (torch.arange(B, device=dev)[None, :]
                      + self.stride * t) % self.pool_n

        kw = dict(num_refs=c["num_refs"], has_align=False,
                  n_rbsp=c["rbsp_budget_bytes"], compact_x=True,
                  s_row=w["s_row"], s_flat=w["s_flat"], s_exc=w["s_exc"])
        rect = (cfg, self.c0, self.r0, self.C, self.R)
        self.step_fn = batch.make_batched_splice_step_rows(*rect, **kw)
        self.exact_fn = batch.make_batched_splice_step_rows(
            *rect, ebsp_exact=True, **kw)
        n_fn = 1 << cfg.log2_max_frame_num
        fns = torch.arange(n_fn, dtype=torch.int32, device=dev)
        z = torch.zeros((n_fn, 8), dtype=torch.int32, device=dev)
        hp, hn = p_slice_header_symbols(cfg, fns, 2 * fns, False, -1, 0, z,
                                        z.bool())
        self.hp = hp[:, None].expand(-1, B, -1).contiguous()
        self.hn = hn[:, None].expand(-1, B, -1).contiguous()
        self.zero = torch.zeros((B, cfg.mb_height, cfg.mb_width),
                                dtype=torch.int32, device=dev)
        self.zero_b = self.zero.bool()
        self.batch_mod = batch
        # Warm-up: the step's capture on its first call, every eager op
        # around it, and the exact-EBSP retry's capture.
        self.warm = self.traffic["warm_steps"]
        args = self._args(0, no_span)
        self.step_fn(*args)
        self.exact_fn(*args)
        for i in range(self.warm):
            self.step(i, no_span)
        self.sync()
        self.setup_parts_s["program"] = time.perf_counter() - t_program
        self.failed = self.retries = 0

    def _args(self, t, span):
        with span("donor_pick"):
            dn = {"blob": self.dn_pool.index_select(
                0, self.picks[t % self.picks.shape[0]])}
        fn = self.frame_num(t)
        return (self.hp[fn], self.hn[fn], self.zero, self.zero, self.zero,
                self.zero_b, dn)

    def step(self, t, span) -> None:
        args = self._args(t, span)
        with span("step"):
            ev = self.event_pair()
            if ev:
                ev[0].record()
            out = self.step_fn(*args)
            if ev:
                ev[1].record()
        self._deliver(t, out, span, retry=lambda: self.exact_fn(*args))

    def check(self, workers, checks: Checks) -> None:
        sps, c = sps_of(self.config), self.config
        frames = self.sampled_frames()
        keys = sorted({(self.donor(t, b), self.frame_num(t))
                       for t, b, _ in frames})
        geo = (sps, self.c0, self.r0, self.R, self.C, c["num_refs"])
        want = dict(zip(keys, workers.map(
            ref_splice.reference_frame,
            [(self.seed, k, fn, *geo, True) for k, fn in keys])))
        if self.control:
            got = dict(zip(keys, workers.map(
                ref_splice.reference_frame,
                [(self.seed, k, fn, *geo, False) for k, fn in keys])))
            frames = [(t, b, got[(self.donor(t, b), self.frame_num(t))])
                      for t, b, _ in frames]
        differ = sum(data != want[(self.donor(t, b), self.frame_num(t))]
                     for t, b, data in frames)
        checks.most("frames_differing", differ, 0)
        checks.most("frames_missing", self.failed, 0)
        checks.least("frames_checked", len(frames),
                     self.check_cfg["min_frames"])


class ScrollBatch(_BatchLoop):
    """Batched scroll serving: B sessions on the triangle schedule, their
    state (frame_num, waypoints) carried on the card."""

    def __init__(self, config, traffic, seed, device, **kw):
        super().__init__(config, traffic, seed, device, **kw)
        self.B = kw.get("batch") or traffic["batch"]
        self.frames_per_step = self.B
        self.speed = traffic["speed"]
        self.max_offset = config["height"] - traffic["max_offset_below"]
        self.period = 2 * self.max_offset // self.speed
        rng = np.random.default_rng((seed, 3))
        self.t0 = int(rng.integers(0, self.period))

    def offset(self, t: int, b: int) -> int:
        return ref_scroll.triangle(
            t + self.t0, self.speed, self.max_offset,
            b * self.traffic["session_phase_px"])

    def bound_bytes(self) -> dict:
        h, w = self.config["height"] // 16, self.config["width"] // 16
        return {"k1": yardstick.k1_bytes(self.B, yardstick.scroll_symbols(
                    h, w), yardstick.scroll_rbsp(h, w)),
                "k6": yardstick.k6_bytes(self.B, h, w)}

    def setup(self, workers) -> None:
        from h264_scroll_encoder_tpu_torch.parallel import batch

        cfg = composer_config(self.config)
        self.step_fn = batch.make_batched_step(
            cfg, enable_pskip=self.control or self.config["enable_pskip"])
        self.state = batch.SessionState.create(self.B, device=self.device)
        sched = np.asarray([[self.offset(t, b) for b in range(self.B)]
                            for t in range(self.period)], np.int32)
        self.sched = torch.as_tensor(sched, device=self.device)
        self.batch_mod = batch
        self.warm = self.traffic["warm_steps"]
        for t in range(self.warm):
            self.step(t, no_span)
        self.sync()
        self.failed = 0

    def step(self, t, span) -> None:
        with span("step"):
            ev = self.event_pair()
            if ev:
                ev[0].record()
            self.state, out = self.step_fn(self.state,
                                           self.sched[t % self.period])
            if ev:
                ev[1].record()
        self._deliver(t, out, span)

    def check(self, workers, checks: Checks) -> None:
        frames = self.sampled_frames()
        by_session: dict = {}
        for t, b, _ in frames:
            by_session.setdefault(b, set()).add(t)
        jobs = [(self.config, self.traffic, self.t0, b, sorted(ts))
                for b, ts in sorted(by_session.items())]
        want = {}
        for (_c, _tr, _t0, b, ts), nals in zip(
                jobs, workers.map(scroll_reference, jobs)):
            want.update({(t, b): nal for t, nal in zip(ts, nals)})
        differ = sum(data != want[(t, b)] for t, b, data in frames)
        checks.most("frames_differing", differ, 0)
        checks.most("frames_missing", self.failed, 0)
        checks.least("frames_checked", len(frames),
                     self.check_cfg["min_frames"])


def scroll_reference(job) -> list:
    """Reference NALs of session b of a scroll_batch run at steps `ts`
    (sorted): the session replayed from step 0."""
    config, traffic, t0, b, ts = job
    sps = sps_of(config)
    max_offset = config["height"] - traffic["max_offset_below"]
    sess = ref_scroll.Session()
    out, want = [], set(ts)
    for t in range(ts[-1] + 1):
        off = ref_scroll.triangle(t + t0, traffic["speed"], max_offset,
                                  b * traffic["session_phase_px"])
        nal, _ = sess.step(sps, off, emit=t in want)
        if nal is not None:
            out.append(nal)
    return out


class ScrollSession(Loop):
    """One ComposerSession on the triangle schedule, a frame a step."""

    def __init__(self, config, traffic, seed, device, **kw):
        super().__init__(config, traffic, seed, device, **kw)
        self.speed = traffic["speed"]
        self.max_offset = config["height"] - traffic["max_offset_below"]
        period = 2 * self.max_offset // self.speed
        rng = np.random.default_rng((seed, 4))
        self.start = self.speed * int(rng.integers(0, period))

    def offset(self, i: int) -> int:
        return ref_scroll.triangle(i, self.speed, self.max_offset,
                                   self.start)

    def bound_bytes(self) -> dict:
        return {}

    def setup(self, workers) -> None:
        from h264_scroll_encoder_tpu_torch import session
        from h264_scroll_encoder_tpu_torch.syntax.nal import AnnexBWriter

        cfg = composer_config(self.config)
        pskip = self.control or self.config["enable_pskip"]
        frames = self.frames = []

        class Sink(AnnexBWriter):
            """The session's host buffer, each frame's bytes kept."""
            def append_raw(self, data) -> None:
                super().append_raw(data)
                frames.append(self._chunks[-1])

        def open_session():
            s = session.ComposerSession(cfg, enable_pskip=pskip,
                                        device=self.device)
            s.writer = Sink()
            s.write_parameter_sets()
            s.write_test_atlases(striped=True)
            return s

        # Warm-up on a session of its own: the scroll and the waypoint
        # frame graphs, which every session of the configuration shares.
        warm = open_session()
        for off in self.traffic["warm_offsets"]:
            warm.write_scroll_or_waypoint_frame(off)
        self.s = open_session()
        del frames[:]
        self.warm = 0
        self._timed_fns()

    def _timed_fns(self) -> None:
        """CUDA events around each frame's graph replay (traced runs)."""
        drv = self

        class Timed:
            def __init__(self, fn):
                self.fn = fn

            def __call__(self, *a):
                ev = drv.event_pair()
                if ev is None:
                    return self.fn(*a)
                ev[0].record()
                out = self.fn(*a)
                ev[1].record()
                return out

        self.s._scroll_fn = Timed(self.s._scroll_fn)
        self.s._waypoint_fn = Timed(self.s._waypoint_fn)

    def step(self, i, span) -> None:
        with span("session_frame"):
            self.s.write_scroll_or_waypoint_frame(self.offset(i))

    def close(self) -> None:
        del self.s
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, workers, checks: Checks) -> None:
        n = len(self.frames)
        rng = np.random.default_rng((self.seed, 5))
        k = min(self.check_cfg["frames"], n)
        picks = set(int(i) for i in rng.choice(n, size=k, replace=False))
        picks |= {0, n - 1}
        sps, sess = sps_of(self.config), ref_scroll.Session()
        differ = checked = 0
        for i in range(n):
            off = self.offset(i)
            emit = i in picks or sess.needs_waypoint(off)
            nal, _ = sess.step(sps, off, emit=emit)
            if emit:
                checked += 1
                differ += nal != self.frames[i]
        checks.most("frames_differing", differ, 0)
        checks.least("frames_checked", checked,
                     min(self.check_cfg["min_frames"], n))


LOOPS = {"splice_rows": SpliceRows, "scroll_batch": ScrollBatch,
           "scroll_session": ScrollSession}


def make(config: dict, traffic: dict, seed: int, device, **kw) -> Loop:
    return LOOPS[traffic["loop"]](config, traffic, seed, device, **kw)
