"""The PyTorch port must run where jax is not installed: importing every
module of h264_scroll_encoder_tpu_torch, and kernel_ab.py, loads neither
jax nor the JAX package."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import importlib, pkgutil, sys
import h264_scroll_encoder_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
for name in names:
    importlib.import_module(name)
import kernel_ab
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'h264_scroll_encoder_tpu'))
assert not bad, bad
print(' '.join(names))
print(len(names))
"""

# Modules of the later slices (utilities, the dry run, examples, scripts,
# the measurement probes P1-P6, the grid kernels' ops/grid): walk_packages
# must reach them, so their __init__ files must exist.
NEW_MODULES = (
    "utils.snapshot", "utils.trace", "utils.mp4mux", "parallel.dryrun",
    "examples.serving_demo", "examples.splice_serving_demo",
    "examples.full_pipeline_demo", "examples.video_in_corner_demo",
    "scripts.generate_refs", "scripts.parity_sweep", "scripts.netflix_scroll",
    "ops.probes", "scripts._probe_common", "scripts.emit_stage_probe",
    "scripts.emit_wrap_probe", "scripts.pack_u16_probe",
    "scripts.pack_tiled_probe", "scripts.splice_stage_profile",
    "scripts.symbols_stage_probe", "scripts.step_xprof", "scripts.step_cost",
    "scripts.ebsp_stage_probe", "scripts.ebsp_sizing_probe",
    "scripts.gpu_parity_probe", "ops.cavlc_lockstep",
    "scripts.cavlc_device_probe", "scripts.ebsp_cumsum_probe",
    "scripts.ebsp_fused_probe", "ops.grid")


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _CHECK], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 53     # every module was imported
    imported = set(r.stdout.split())
    for name in NEW_MODULES:
        assert f"h264_scroll_encoder_tpu_torch.{name}" in imported, name
