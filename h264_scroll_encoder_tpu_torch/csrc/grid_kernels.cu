// Hand-written Hopper (sm_90a) kernels of the symbol stages' grid stage.
// Neither replaces a Pallas kernel: each replaces XLA code of the JAX
// package (on the TPU "many small XLA fusions"), which the port ran as
// generic aten kernels, ~400 a splice step and ~250 a scroll frame.
//
// K5  h264t_composite_grid — replaces h264_scroll_encoder_tpu/models/
//     splice_device.py `_dense_prologue` (:1321) and `_bg3` (:1406): for
//     a donor rect spliced into a background, the role scatter, the MV
//     prediction over the composite roles, the composite coded mask and
//     its skip-run scan (the associative_scan at :1370), and the
//     background MB slots (3 or, wide, 4; the compact 2-slot form too).
//     Its plain version and contract: ops/grid.composite_grid_plain.
// K6  h264t_scroll_grid — replaces the MB grid of h264_scroll_encoder_tpu/
//     models/scroll.py `emit_p_frame` (:328; `mv_pred_grid` :283,
//     `pskip_mv_grid` :296, the associative_scan at :377): prediction,
//     P_Skip test, skip runs and the per-MB slots of every scroll,
//     waypoint, hint and session frame.  Plain version:
//     ops/grid.scroll_grid_plain.
//
// What bounds them on an H100.  Per MB a session reads ~13 bytes (K6:
// three int32 fields; K5: three int32 background fields and a bool mask,
// the donor's roles once) and writes 16-48 bytes of int32 slots: at 720p
// and B = 256, ~19 MB for K6's compact scroll grid and ~57 MB for K5's
// outputs, 6-17 us at the card's 3.35 TB/s.  The work per MB is a few
// dozen integer operations, so the bytes bound it; what sets its time
// here is each session's chain of latencies.
//
// This design (the first; a simple kernel that is right):
//   - One block of kGridThreads = 512 threads a session, B blocks.  The
//     raster is walked in tiles of 512 MBs, one a thread (720p: 8 tiles;
//     5120x3200: 125).
//   - Each thread reads its MB's fields and its neighbours' straight
//     from global memory through the read-only cache, in their own
//     dtypes and strides (Field), and computes the prediction, the coded
//     flag and, for K5, the composite roles on the fly: a neighbour
//     inside the rect reads the donor's role field, outside the
//     background's.  A neighbour row is the previous tile's or this one's,
//     so its lines are in L1 or L2 when read again; nothing is staged in
//     shared memory.
//   - The skip run before each MB is one block exclusive max-scan a tile
//     (warp shuffles, then one warp over the 16 warps' maxima; two
//     barriers), carried across tiles in a register.
//   - The thread then writes its MB's slots (each MB's S consecutive
//     int32, so a warp writes 32 * S contiguous words).
// Outputs are allocated by the wrapper; the kernels launch on the
// caller's stream, so a CUDA graph captures them like any kernel.

#include "grid_device.cuh"

namespace {

constexpr int kFieldWords = 5;

Field field_of(const long long* d) {
  Field f;
  f.p = reinterpret_cast<const char*>(d[0]);
  f.sb = d[1];
  f.sr = d[2];
  f.sc = d[3];
  f.code = static_cast<int>(d[4]);
  return f;
}

bool valid_code(int code) {
  return code == 1 || code == -1 || code == 2 || code == 4 || code == 8;
}

// The fields of `d` (kFieldWords int64 each), checked: every one with an
// address and a known dtype code, but the last (num_refs) may have none.
bool read_fields(const long long* d, int count, Field* out) {
  if (d == nullptr) return false;
  for (int k = 0; k < count; ++k) {
    out[k] = field_of(d + kFieldWords * k);
    const bool optional = k == count - 1;
    if ((out[k].p == nullptr && !optional) || !valid_code(out[k].code)) return false;
  }
  return true;
}

}  // namespace

// K6.  fields: 4 x (address, batch, row and column strides in bytes,
// dtype code) for ref, mv_x, mv_y [batch, h, w] and num_refs (address 0:
// nrefs_value for every session).  Outputs: pat, nb int32[batch, h * w,
// S] with S = (compact_x ? 2 : 3) + wide, last int32[batch].
extern "C" int h264t_scroll_grid(const long long* fields, int batch, int h, int w,
                                 int nrefs_value, int wide, int compact_x, int enable_pskip,
                                 int32_t* pat, int32_t* nb, int32_t* last, void* stream) {
  Field f[4];
  if (batch < 0 || h < 1 || w < 1 || h * w > 65535 || !read_fields(fields, 4, f))
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  ScrollStage st;
  for (int k = 0; k < 3; ++k) st.g[k] = f[k];
  st.nrefs = f[3];
  st.nrefs_value = nrefs_value;
  st.h = h;
  st.w = w;
  st.wide = wide != 0;
  st.compact = compact_x != 0;
  st.pskip = enable_pskip != 0;
  st.pat = pat;
  st.nb = nb;
  st.last = last;
  grid_kernel<ScrollStage><<<batch, kGridThreads, 0, (cudaStream_t)stream>>>(st);
  return (int)cudaGetLastError();
}

// K5.  fields: 15 x (address, strides, code): the background's ref, mv_x,
// mv_y and coded [batch, H, W], the donor's nine role fields (ops/grid.
// ROLE_FIELDS order) and coded mask [batch, R, C], then num_refs as for
// K6.  The rect is rows [r0, r0 + R) and columns [c0, c0 + C).  Outputs:
// bg_p, bg_n int32[batch, H, W, wide ? 4 : 3]; with compact_x bg2_p,
// bg2_n int32[batch, H, W, 2] (else null); sr_p, sr_n int32[batch, H * W];
// last int32[batch].
extern "C" int h264t_composite_grid(const long long* fields, int batch, int h, int w, int r0,
                                    int c0, int rh, int rw, int nrefs_value, int wide,
                                    int compact_x, int32_t* bg_p, int32_t* bg_n, int32_t* bg2_p,
                                    int32_t* bg2_n, int32_t* sr_p, int32_t* sr_n, int32_t* last,
                                    void* stream) {
  Field f[15];
  if (batch < 0 || h < 1 || w < 1 || h * w > 65535 || r0 < 0 || c0 < 0 || rh < 1 || rw < 1 ||
      r0 + rh > h || c0 + rw > w || !read_fields(fields, 15, f) ||
      (compact_x && (bg2_p == nullptr || bg2_n == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  CompositeStage st;
  for (int k = 0; k < 4; ++k) st.bg[k] = f[k];
  for (int k = 0; k < 9; ++k) st.role[k] = f[4 + k];
  st.dcoded = f[13];
  st.nrefs = f[14];
  st.nrefs_value = nrefs_value;
  st.h = h;
  st.w = w;
  st.r0 = r0;
  st.c0 = c0;
  st.rh = rh;
  st.rw = rw;
  st.wide = wide != 0;
  st.compact = compact_x != 0;
  st.bg_p = bg_p;
  st.bg_n = bg_n;
  st.bg2_p = bg2_p;
  st.bg2_n = bg2_n;
  st.sr_p = sr_p;
  st.sr_n = sr_n;
  st.last = last;
  grid_kernel<CompositeStage><<<batch, kGridThreads, 0, (cudaStream_t)stream>>>(st);
  return (int)cudaGetLastError();
}
