"""h264_scroll_encoder_tpu_torch — the scroll composer in PyTorch + CUDA.

A port of `h264_scroll_encoder_tpu` (the JAX package, which stays the
reference) to PyTorch, with every Pallas kernel on the ported path
rewritten by hand in CUDA C++ for Hopper (`csrc/`).  Same layout and
names as the JAX package, so every function has an obvious counterpart:

  ops/       — Exp-Golomb symbols, the scatter bit packer, emulation
               prevention, and the kernels' wrappers: `ops/emit_fused` (K1:
               pack + bounded EBSP + Annex-B framing), `ops/bitpack_flat`
               (K2/K4: batched bit pack), `ops/ebsp_flat` (K3).
  syntax/    — slice headers (device symbol streams, host writers), NAL
               framing, parameter sets, Annex-B parsing.
  models/    — scroll/waypoint (floor, nearest, partitioned), sliced and
               hint P-frames; the rows and dense splices; I_PCM atlases,
               the donor rewrite, the host splice path and the padding
               transcode (trans-resizer).
  parallel/  — `SessionState`, the batched scroll, splice (rows, dense)
               and hint steps, egress (`compact_batch_nal`).
  session.py — `ComposerSession`, one UI session's stream, with the
               conventional-encode fallback frame.
  cli.py     — the composer, scroll-encoder, splice-demo and trans-resizer
               CLIs.
  verify.py, pixel_oracle.py, avref.py — the structural stream oracle,
               the numpy pixel decoder (ops/transform, ops/deblock) and
               libavcodec / libx264 through csrc/avref.c.

Conventions: functions take tensors with an explicit leading session
dimension (the JAX package's `vmap` axis); the device comes from the
inputs.  Bit patterns are int64 tensors holding uint32 values, because
torch has no shifts on uint32 on the CPU.  A kernel wrapper runs its
plain PyTorch version for CPU tensors and launches the CUDA kernel for
CUDA tensors (or raises) — there is no silent fallback.
"""

__version__ = "0.1.0"
