"""The benchmark's harness on the CPU: its manifest, its generators, its
reference against the program's plain path, its yardstick."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import drive, harness, yardstick
from portbench.reference import donors
from portbench_cases import BATCH_CELLS, CELLS, SEED, cpu_run

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _one_line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_manifest_names_units_and_files():
    m = _manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["command"][1] == "portbench/run.py"
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in m[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("portbench/")
        assert json.loads(path.read_text())["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
        assert _one_line(c["source"]) and _one_line(c["why"])
    used = {w["config"] for w in m["workloads"]}
    assert used == {c["name"] for c in m["configs"]}
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _one_line(w["why"])
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json"
                ).is_file()
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert 0 < e2e["setup_s"]["bound"] <= 0.25
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
        assert (ROOT / "portbench" / "metrics" / f"{x['name']}.py").is_file()
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25
        assert x["source"] in ("host_clock", "device_trace")
    perf = (ROOT / "PERF.md").read_text()
    cells = {w["name"] for w in m["workloads"]}
    for x in m["per_layer"]:
        assert x["moves"] in e2e and _one_line(x["layer"])
        assert f"**{x['layer']}**" in perf, x["layer"]
        assert set(x["workloads"]) <= cells
    for cell in cells:
        assert harness.cell_metrics(m, cell, "per_layer")
        assert len(harness.cell_metrics(m, cell, "end_to_end")) >= 2


@pytest.mark.parametrize("cell", CELLS)
def test_generator_is_deterministic_by_seed(cell):
    _, _, config, traffic = harness.load_cell(cell)

    def inputs(seed):
        drv = drive.make(config, traffic, seed, "cpu", batch=8)
        if traffic["loop"] == "splice_rows":
            return [donors.make_payload((seed, drv.donor(t, b), 23, 23))
                    for t, b in ((0, 0), (3, 5))], drv.frame_num(5)
        if traffic["loop"] == "scroll_batch":
            return [drv.offset(t, b) for t in range(0, 400, 7)
                    for b in range(8)]
        return [drv.offset(i) for i in range(400)]

    assert inputs(SEED) == inputs(SEED)
    assert inputs(SEED) != inputs(SEED + 1)
    assert drive.sample_steps(SEED) == drive.sample_steps(SEED)
    assert (drive.sample_sessions(SEED, 9, 256, 4)
            == drive.sample_sessions(SEED, 9, 256, 4))


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_programs_cpu_path(cell):
    result, code, lines = cpu_run(cell)
    assert code == 0 and result["correct"], lines
    assert result["failed"] == 0
    assert result["checks"]["frames_checked"]["value"] >= 4
    assert list(result)[-1] == "checks"


def _children() -> set:
    """Pids of the live processes whose parent is this one."""
    me, out = str(os.getpid()), set()
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            stat = open(f"/proc/{pid}/stat").read()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        if fields[1] == me and fields[0] != "Z":
            out.add(pid)
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_leaves_no_process(cell):
    before = _children()
    result, code, lines = cpu_run(cell, seconds=0.2)
    assert code == 0 and result["correct"], lines
    assert _children() - before == set()


def test_workers_keep_order_and_stop_on_a_fault():
    before = _children()
    assert harness.Workers().map(abs, range(-11, 0)) == list(range(11, 0, -1))
    assert harness.Workers().map(abs, []) == []
    with pytest.raises(RuntimeError):
        harness.Workers().map(os.abort, [(), ()])
    assert _children() - before == set()


def test_donor_generator_draws_as_the_programs_fixture():
    from h264_scroll_encoder_tpu_torch import cases

    for k in range(2):
        grid = donors.representative_grid(
            np.random.default_rng(cases.SPLICE_DONOR_SEED + k), 23, 23)
        assert donors.payload(grid) == cases.splice_donor_payload(k)


def test_roofline_byte_counts_follow_the_programs_shapes():
    from h264_scroll_encoder_tpu_torch import cases
    from h264_scroll_encoder_tpu_torch.models import scroll, splice_device
    from h264_scroll_encoder_tpu_torch.ops import grid
    from h264_scroll_encoder_tpu_torch.parallel import batch

    _, _, config, _ = harness.load_cell("splice_rows.pooled_b1024")
    w, B = config["wire"], 2
    cfg = drive.composer_config(config)
    h, wd = cfg.mb_height, cfg.mb_width
    payloads = [donors.make_payload((SEED, k, 23, 23)) for k in range(B)]
    dn, _ = splice_device.prepare_donor_rows_serving(
        payloads, [0] * B, 23, 23, 1, 2, s_row=w["s_row"], blob_wire=True,
        s_flat=w["s_flat"], s_exc=w["s_exc"], device="cpu")
    pat, _nb, _ = splice_device.rows_splice_symbols(
        cfg, 30, 10, 23, 23, 2, *cases.splice_session_inputs(cfg, B, "cpu"),
        dn, n_rbsp=config["rbsp_budget_bytes"], compact_x=True,
        s_row=w["s_row"], s_flat=w["s_flat"], s_exc=w["s_exc"])
    assert pat.shape[1] == yardstick.splice_rows_symbols(h, wd, 10, 30, 23,
                                                         23, w["s_row"])
    step = batch.make_batched_splice_step_rows(
        cfg, 30, 10, 23, 23, 2, n_rbsp=config["rbsp_budget_bytes"],
        compact_x=True, s_row=w["s_row"], s_flat=w["s_flat"],
        s_exc=w["s_exc"])
    nal = step(*cases.splice_session_inputs(cfg, B, "cpu"), dn)[0]
    assert nal.shape[1] == yardstick.nal_bytes(config["rbsp_budget_bytes"])

    # K5's bytes do not depend on the wire classes (cases' are 128/1536/32).
    dn_k5 = cases.prepare_splice_donors(payloads, engine="native",
                                        device="cpu")[0]
    args, kw = cases.composite_grid_inputs(cfg, dn_k5, B, "cpu", rows=True)
    out = grid.composite_grid_batch(*args, **kw)
    assert grid.composite_grid_bytes(*args, out) == \
        yardstick.k5_bytes_all_skip(B, h, wd, 23, 23)

    state = batch.SessionState.create(B, device="cpu")
    offs = torch.tensor([100, 600], dtype=torch.int32)
    needs = scroll.needs_waypoint(offs, state.wp_offsets, state.wp_valid,
                                  state.wp_count)
    pat, _nb, n_rbsp, _ = scroll.unified_frame_symbols(
        cfg, state.frame_num, offs, state.wp_offsets, state.wp_ltidx,
        state.wp_valid, state.wp_count, needs)
    assert pat.shape[1] == yardstick.scroll_symbols(h, wd)
    assert n_rbsp == yardstick.scroll_rbsp(h, wd)
    args, kw = cases.scroll_grid_inputs("cpu")["scroll_720p"]
    out = grid.scroll_grid_batch(*args, **kw)
    assert grid.scroll_grid_bytes(*args, out) == \
        yardstick.k6_bytes(args[0].shape[0], h, wd)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxfoo", object())
    monkeypatch.setitem(sys.modules, "h264_scroll_encoder_tpu_torch.x",
                        object())
    assert "jaxfoo" not in harness.forbidden_modules()
    assert not set(harness.forbidden_modules()) & {
        "h264_scroll_encoder_tpu_torch"}
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in harness.forbidden_modules()


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, 'portbench/tests'); "
            "from portbench_cases import cpu_run; "
            "from portbench import harness\n"
            "if __name__ == '__main__':\n"
            "    r, c, _ = cpu_run('splice_rows.pooled_b1024', seconds=0.2)\n"
            "    print(c, r['correct'], harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.stdout.strip().splitlines()[-1] == "0 True []", out.stderr


def test_run_exits_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "scroll.b256",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_trace_summary():
    ev = [{"cat": "user_annotation", "name": yardstick.WINDOW_SPAN,
           "ts": 0, "dur": 100},
          {"cat": "user_annotation", "name": "step", "ts": 0, "dur": 50},
          {"cat": "user_annotation", "name": "egress", "ts": 50, "dur": 40},
          {"cat": "kernel", "name": "emit_fused_kernel<int>", "ts": 10,
           "dur": 20},
          {"cat": "kernel", "name": "emit_fused_kernel<int>", "ts": 20,
           "dur": 20},
          {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 70, "dur": 10},
          {"cat": "kernel", "name": "outside", "ts": 200, "dur": 10}]
    t = yardstick.summarize_trace(ev, harness.SPANS)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(40e-6)
    assert t.kernel_mean_s("emit_fused") == pytest.approx(20e-6)
    assert t.kernel_mean_s("CompositeStage") is None
    assert dict(t.top_gaps()) == pytest.approx(
        {"step": 20e-6, "egress": 30e-6, "between_spans": 10e-6})
    assert yardstick.summarize_trace(ev[1:], harness.SPANS) is None


def test_percentile_and_roofline():
    xs = list(np.random.default_rng(0).random(101))
    assert yardstick.percentile(xs, 95) == pytest.approx(
        float(np.percentile(xs, 95)))
    assert yardstick.roofline_pct(3.35e9, 1e-3) == pytest.approx(100.0)
    assert yardstick.roofline_pct(3.35e9, None) is None


@pytest.mark.parametrize("cell", BATCH_CELLS)
def test_traced_run_reads_its_host_spans(cell):
    result, code, _ = cpu_run(cell, trace=True)
    assert code == 0 and result["correct"]
    egress = [v["value"] for k, v in result["metrics"].items()
              if k.startswith("egress_ms")]
    assert egress and egress[0] > 0
