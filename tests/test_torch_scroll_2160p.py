"""4K scrolling sessions: the port's ComposerSession against the
benchmark's plain reference (portbench/reference/scroll) on the CPU, at
the heights of the configuration `scroll2160p` (a 0..2,144 px page, four
waypoints at 496, 992, 1,488 and 1,984 px), and the benchmark's cell
`large.scroll_3840x2160_b1` as the harness loads it.

Three widths: 64 px (narrow symbol layout) through a whole triangle
period at 8 px a frame; 512 px (4,320 MBs, the smallest frame on K6's
wide layout) at the waypoints and their neighbours; 3,840 px itself at
ten offsets.  The port runs on the CPU (the kernels' plain versions).
Tolerance: none, every frame's bytes are compared.
"""

import json
from pathlib import Path

import pytest
import torch

from h264_scroll_encoder_tpu_torch.ops.grid import NARROW_MAX_MBS
from h264_scroll_encoder_tpu_torch.session import ComposerSession
from portbench import drive, harness
from portbench.reference import scroll as ref_scroll

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CELL = "large.scroll_3840x2160_b1"
CONFIG = json.loads((ROOT / "portbench/configs/scroll2160p.json").read_text())
WAYPOINTS = [496, 992, 1488, 1984]
SPEED, MAX_OFFSET = 8, 2144
# Ten 4K offsets: each waypoint, a neighbour of the first, the page's end.
OFFSETS_4K = [8, 488, 496, 504, 992, 1000, 1488, 1984, 2144, 1500]
# The waypoints, their neighbours at 8 px, the page's end, a way back.
OFFSETS_WIDE = sorted({o + d for o in WAYPOINTS for d in (-8, 0, 8)}
                      | {8, 2144}) + [1000, 8]


def _config(width):
    return {**CONFIG, "width": width}


def _compare(width, offsets):
    """Every frame of a port session and of the reference on `offsets`
    (in turn), at `width` x 2160; the port session's registry."""
    config = _config(width)
    s = ComposerSession(drive.composer_config(config), device="cpu")
    s.write_parameter_sets()
    s.write_test_atlases(striped=True)
    sps, ref = drive.sps_of(config), ref_scroll.Session()
    waypoint_frames = 0
    for off in offsets:
        s.write_scroll_or_waypoint_frame(off)
        want, waypoint = ref.step(sps, off)
        waypoint_frames += waypoint
        assert s.writer._chunks[-1] == want, (width, off)
    assert ref.waypoints == s.waypoints.offsets[:s.waypoints.count]
    return s, waypoint_frames


def test_narrow_session_through_a_whole_period():
    """64x2160 (540 MBs, the narrow layout) on every offset of a triangle
    period at 8 px a frame from 0: all four waypoints, each once."""
    assert 4 * 135 <= NARROW_MAX_MBS
    period = 2 * MAX_OFFSET // SPEED
    offsets = [ref_scroll.triangle(i, SPEED, MAX_OFFSET)
               for i in range(period + 1)]
    s, waypoint_frames = _compare(64, offsets)
    assert s.waypoints.offsets[:s.waypoints.count] == WAYPOINTS
    assert waypoint_frames == 4


def test_smallest_wide_frame_at_the_waypoints():
    """512x2160, 4,320 MBs: the wide layout, at every waypoint and its
    neighbours, then back up the page."""
    assert 32 * 135 > NARROW_MAX_MBS
    s, waypoint_frames = _compare(512, OFFSETS_WIDE)
    assert s.waypoints.offsets[:s.waypoints.count] == WAYPOINTS
    assert waypoint_frames == 4


def test_4k_session_at_ten_offsets():
    """3840x2160 itself, 32,400 MBs: ten offsets, the four waypoint frames
    among them."""
    s, waypoint_frames = _compare(CONFIG["width"], OFFSETS_4K)
    assert (CONFIG["width"], CONFIG["height"]) == (3840, 2160)
    assert s.waypoints.offsets[:s.waypoints.count] == WAYPOINTS
    assert waypoint_frames == 4


def test_the_cell_loads_as_the_harness_finds_it():
    manifest, cell, config, traffic = harness.load_cell(CELL)
    assert cell["config"] == "scroll2160p" and cell["chips"] == 1
    assert config == CONFIG and config["reduced"] == []
    assert traffic["loop"] == "scroll_session" and traffic["speed"] == SPEED
    assert config["height"] - traffic["max_offset_below"] == MAX_OFFSET
    assert CELL in {w for m in manifest["end_to_end"]
                    for w in m.get("workloads", [])}
    assert harness.cell_metrics(manifest, CELL, "per_layer")


@pytest.mark.parametrize("seed", [0, 2**31 + 77, 2**33 + 5])
def test_offsets_are_the_seeds_and_stay_on_the_page(seed):
    """The session's offsets over a period: the same from the same seed,
    multiples of 8 within 0..2,144, every waypoint among them; another
    seed starts elsewhere."""
    _, _, config, traffic = harness.load_cell(CELL)
    period = 2 * MAX_OFFSET // SPEED

    def offsets(s):
        drv = drive.make(config, traffic, s, "cpu")
        return [drv.offset(i) for i in range(period)]

    got = offsets(seed)
    assert got == offsets(seed)
    assert all(o % SPEED == 0 and 0 <= o <= MAX_OFFSET for o in got)
    assert set(WAYPOINTS) <= set(got) and {0, MAX_OFFSET} <= set(got)
    assert offsets(seed + 1) != got
