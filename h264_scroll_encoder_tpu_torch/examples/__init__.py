"""Runnable examples of the port, each the counterpart of a script in the
repository's examples/ directory:

    python -m h264_scroll_encoder_tpu_torch.examples.serving_demo
    python -m h264_scroll_encoder_tpu_torch.examples.splice_serving_demo
    python -m h264_scroll_encoder_tpu_torch.examples.full_pipeline_demo
    python -m h264_scroll_encoder_tpu_torch.examples.video_in_corner_demo \
        [--batched]

Each runs on the card unless `--device cpu` is given, and exits non-zero
when a check fails.  The video-in-corner demo needs libavcodec and
libx264 (avref); without them it prints what is missing and exits 1.
"""
