"""Command-line scripts of the port, each the counterpart of one in the
repository's scripts/ directory:

    python -m h264_scroll_encoder_tpu_torch.scripts.generate_refs [--x264]
    python -m h264_scroll_encoder_tpu_torch.scripts.parity_sweep [--ref-dir D]
    python -m h264_scroll_encoder_tpu_torch.scripts.netflix_scroll --demo
    bash h264_scroll_encoder_tpu_torch/scripts/run_e2e.sh

Each runs on the card unless `--device cpu` is given (run_e2e.sh reads
DEVICE).  generate_refs --x264 and netflix_scroll need libavcodec and
libx264 (avref); where they are missing they print what is missing and
exit 1.  parity_sweep needs the C reference binaries and exits 2 without
them.
"""
