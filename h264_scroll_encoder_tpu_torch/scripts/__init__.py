"""Command-line scripts of the port, each the counterpart of one in the
repository's scripts/ directory:

    python -m h264_scroll_encoder_tpu_torch.scripts.generate_refs [--x264]
    python -m h264_scroll_encoder_tpu_torch.scripts.parity_sweep [--ref-dir D]
    python -m h264_scroll_encoder_tpu_torch.scripts.netflix_scroll --demo
    bash h264_scroll_encoder_tpu_torch/scripts/run_e2e.sh

and the measurement scripts (the JAX package's probes and stage
profiles), each printing its table as one JSON line last:

    emit_stage_probe      K1 cut after each stage (P1), at six shapes
    emit_wrap_probe       the host cost of each piece of K1's wrapper
    pack_u16_probe        P2 (narrow staging) against K2, blocks per SM
    pack_tiled_probe      P3 (T sessions a block) against K2
    splice_stage_profile  the rows splice step's stages [--dense] [--static]
    symbols_stage_probe   the symbol stage's pieces, with their launches
    step_xprof            the step's top device kernels and idle gaps
    step_cost             the bytes the step's ops move, its peak memory
    ebsp_stage_probe      K3 against the plain bounded EBSP
    ebsp_sizing_probe     K3 at the 1.5x and the rbsp + cap NAL sizes
    gpu_parity_probe      K1 == plain on the splice emit; K2's race
    cavlc_device_probe    lockstep CAVLC decode (P4) against host donor prep
    ebsp_cumsum_probe     K3's insertion scan: runs against ballots (P5)
    ebsp_fused_probe      K3's framing: shared NAL, lanes, in place (P6)

    python -m h264_scroll_encoder_tpu_torch.scripts.<name> [--device cpu]

Each runs on the card unless `--device cpu` is given (run_e2e.sh reads
DEVICE); on the CPU the measurement scripts run the plain versions and
time them by the host clock, which is no device time.  generate_refs
--x264 and netflix_scroll need libavcodec and libx264 (avref); where they
are missing they print what is missing and exit 1.  parity_sweep needs
the C reference binaries and exits 2 without them.
"""
