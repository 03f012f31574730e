"""Golden 720p digests: the JAX package's output, which the port must match.

h264_scroll_encoder_tpu_torch/golden/scroll_720p.json holds, per step and
session, the sha256 of the valid NAL bytes, nal_len, emitted_waypoint and
overflow for the batch-8, 12-step 1280x720 schedule of
`cases.golden_schedule`, plus one `ebsp_exact` scroll frame per session.
chip_smoke.py holds the card's output against it without jax.

Regenerate the file with `python tests/test_torch_golden.py` (the test
below fails whenever its contents differ from the JAX package's output).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from h264_scroll_encoder_tpu.config import ComposerConfig as JaxConfig
from h264_scroll_encoder_tpu.models import scroll as jax_scroll
from h264_scroll_encoder_tpu.parallel import batch as jax_batch
from h264_scroll_encoder_tpu_torch import cases

torch.set_num_threads(1)


def jax_golden() -> dict:
    """The golden digests, computed by the JAX package (staged back end)."""
    cfg = JaxConfig(cases.GOLDEN_WIDTH, cases.GOLDEN_HEIGHT)
    step = jax_batch.make_batched_step(cfg)
    state = jax_batch.SessionState.create(cases.GOLDEN_BATCH)
    offsets = cases.golden_schedule()
    steps = []
    for offs in offsets:
        state, (nal, nal_len, wp, _bits, ovf) = step(
            state, jnp.asarray(offs, jnp.int32))
        steps.append(cases.digest_step(*map(np.asarray,
                                            (nal, nal_len, wp, ovf))))
    exact = jax.jit(jax.vmap(functools.partial(
        jax_scroll.scroll_frame, cfg, ebsp_exact=True)))
    nal, nal_len, _bits, ovf = exact(
        state.frame_num, jnp.asarray(offsets[-1]), state.wp_offsets,
        state.wp_ltidx, state.wp_valid, state.wp_count)
    no_wp = np.zeros(cases.GOLDEN_BATCH, bool)
    return {"config": cases.golden_config(), "steps": steps,
            "ebsp_exact": cases.digest_step(np.asarray(nal),
                                            np.asarray(nal_len), no_wp,
                                            np.asarray(ovf))}


def test_golden_file_is_jax_output():
    committed = json.loads(cases.GOLDEN_PATH.read_text())
    assert committed == jax_golden()
    # The schedule must exercise waypoints and never overflow.
    flat = [d for step in committed["steps"] for d in step]
    assert any(d["emitted_waypoint"] for d in flat)
    assert not any(d["overflow"] for d in flat)


def test_port_matches_golden():
    committed = json.loads(cases.GOLDEN_PATH.read_text())
    assert cases.port_golden() == committed


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    cases.GOLDEN_PATH.parent.mkdir(parents=True, exist_ok=True)
    cases.GOLDEN_PATH.write_text(json.dumps(jax_golden(), indent=1) + "\n")
    print(f"wrote {cases.GOLDEN_PATH}")
