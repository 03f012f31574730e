#!/usr/bin/env bash
# End-to-end pipeline of the port: compose -> verify -> mux (the run.sh /
# test_encoder.sh equivalent; the verification oracle is the structural
# verifier, since no ffmpeg is needed).  Port of scripts/run_e2e.sh.
#
#   bash h264_scroll_encoder_tpu_torch/scripts/run_e2e.sh
#
# Environment: OUT (output directory), W, H, FRAMES, SPEED, DEVICE (cuda
# unless set; DEVICE=cpu runs the kernels' plain versions).
set -euo pipefail
cd "$(dirname "$0")/../.."

OUT=${OUT:-${TMPDIR:-/tmp}/h264t_e2e}
W=${W:-1280}
H=${H:-720}
FRAMES=${FRAMES:-300}
SPEED=${SPEED:-4}
DEVICE=${DEVICE:-cuda}
PY=${PYTHON:-python3}
mkdir -p "$OUT"

echo "== 1. test-mode stream (striped I_PCM atlases + scroll) =="
"$PY" -m h264_scroll_encoder_tpu_torch.cli scroll-encoder \
    -n "$FRAMES" -S "$SPEED" -w "$W" -H "$H" -o "$OUT/scroll.h264" \
    --device "$DEVICE"

echo "== 2. structural conformance verify =="
"$PY" -m h264_scroll_encoder_tpu_torch.verify "$OUT/scroll.h264"

echo "== 3. donor-mode composer on synthesized donors =="
"$PY" - <<PYEOF
from h264_scroll_encoder_tpu_torch.config import ComposerConfig
from h264_scroll_encoder_tpu_torch.session import ComposerSession
from h264_scroll_encoder_tpu_torch.models import ipcm
for name, color in [('a', (81, 90, 240)), ('b', (41, 240, 110))]:
    cfg = ComposerConfig($W, $H)
    s = ComposerSession(cfg, device='$DEVICE'); s.write_parameter_sets()
    s.writer.append_raw(ipcm.idr_frame_color(cfg, *color))
    s.write_to_file('$OUT/donor_' + name + '.h264')
PYEOF
"$PY" -m h264_scroll_encoder_tpu_torch.cli composer \
    --ref-a "$OUT/donor_a.h264" --ref-b "$OUT/donor_b.h264" \
    -n "$FRAMES" -s "$SPEED" -o "$OUT/composed.h264" --device "$DEVICE"
"$PY" -m h264_scroll_encoder_tpu_torch.verify "$OUT/composed.h264"

echo "== 4. mux to MP4 =="
"$PY" -m h264_scroll_encoder_tpu_torch.utils.mp4mux "$OUT/scroll.h264" \
    "$OUT/scroll.mp4"
echo "done: $OUT"
