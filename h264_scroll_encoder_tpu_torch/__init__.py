"""h264_scroll_encoder_tpu_torch — the scroll composer in PyTorch + CUDA.

A port of `h264_scroll_encoder_tpu` (the JAX package, which stays the
reference) to PyTorch, with every Pallas kernel on the ported path
rewritten by hand in CUDA C++ for Hopper (`csrc/`).  Same layout and
names as the JAX package, so every function has an obvious counterpart:

  ops/       — Exp-Golomb symbols, the scatter bit packer, emulation
               prevention, and the two kernels' wrappers:
               `ops/emit_fused` (K1: pack + bounded EBSP + Annex-B framing)
               and `ops/bitpack_flat` (K2: batched bit pack).
  syntax/    — P slice header symbol streams.
  models/    — the scroll/waypoint P-frame compose path.
  parallel/  — `SessionState` and the batched serving step.

Conventions: functions take tensors with an explicit leading session
dimension (the JAX package's `vmap` axis); the device comes from the
inputs.  Bit patterns are int64 tensors holding uint32 values, because
torch has no shifts on uint32 on the CPU.  A kernel wrapper runs its
plain PyTorch version for CPU tensors and launches the CUDA kernel for
CUDA tensors (or raises) — there is no silent fallback.
"""

__version__ = "0.1.0"
