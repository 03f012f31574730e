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
// What bounds them on an H100.  Per MB K6 reads its three fields (12
// bytes as int32) and K5 its coded masks (a byte an MB; MVs and refs only
// around a live MB, none on the splice steps' all-skip background), and
// each writes 16-48 bytes of int32 slots: at 720p and B = 256, ~26 MB for
// K6's compact scroll grid and ~45 MB for K5 (the rows compact inputs),
// 7.7 and 13.5 us at the card's 3.35 TB/s.  The work per MB is a few dozen
// integer operations, so the bytes bound them (ops/grid.scroll_grid_bytes,
// composite_grid_bytes, which count what the call's data needs); what kept
// the first design (one block a session walking 512-MB tiles) from them
// was each session's chain of latencies, and at B = 1 one SM of 132.
//
// This design (grid_device.cuh's note has the steps):
//   - A session is split into P bands of whole MB rows, one block of
//     kGridThreads = 512 threads a band; a session's P blocks are a
//     thread-block cluster (one cudaLaunchKernelEx, P in {2, 4, 8, 16}; 16
//     is the non-portable size), or P = 1 a plain launch.  The skip-run
//     scan crosses bands only through each band's last coded MB: a block
//     publishes it in shared memory, and after one cluster barrier reads
//     the lower ranks' through DSMEM.
//   - Each band's fields and the row above it are staged once into shared
//     memory as int32 (16-byte vector loads along the rows, four a thread
//     in flight, converted in registers; element loads for a strided
//     field); the stencil then reads shared memory only.  K5 stages its coded mask first and composes the three role
//     grids only where an MB of the band is live (coded, outside the
//     rect): on the splice steps' all-skip background none is, and the
//     kernel reads 1 byte an MB of the background instead of 13.
//   - A thread takes a run of k MBs (odd; grid_items) for the coded flags
//     and one block max-scan a band; the slots go out in chunks of 512 MBs
//     through shared buffers laid out as the outputs are, in 16-byte
//     stores (K5: all six arrays, the compact form merged from the same
//     codes).
//   - The plan (h264t_grid_plan, launches nothing) weighs the batch: P
//     costs ceil(B * P / capacity) waves of blocks of band_max_rows(h, P)
//     * w + kGridBlockMbs MBs (capacity: the blocks of that plan the card
//     holds at once, by the occupancy and cluster queries); the P of least
//     cost, the smallest of equals; none that fits raises in the wrapper.
//     A block's dynamic shared memory, in int32 words (grid_smem_words):
//     the staged fields (K5 9, K6 3) x round4((band rows + 1) * w), a word
//     an MB of the band, and the chunk buffers 2 x (512 * slots + 4) per
//     output array (K5 slots 4, 2, 1; K6 4).  At 720p: K6 P = 1 75,000 B
//     (3 blocks an SM at 40 registers: B = 256 in one wave, so P = 1), K5
//     P = 1 175,648 B (1 an SM) and P = 2 105,248 B (2 an SM at 64
//     registers: B = 256 and 1,024 take P = 2); B = 1 takes P = 16 (bands
//     of 2-3 rows), 5120x3200 P = 16 (13 rows, 86,816 B).
//   - Registers (nvcc -Xptxas -v on an H100, printed by kernel_ab.py --grid):
//     K6 40 (capped for three blocks an SM: 8-byte stack frame, 24 bytes
//     of spill stores and 4 of loads); K5 64 (capped for two) and no
//     spills.
// Outputs are allocated by the wrapper; the kernels launch on the
// caller's stream, so a CUDA graph captures them like any kernel.

#include "grid_device.cuh"

namespace {

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

const void* grid_kernel_of(int kind) {
  return kind == kGridComposite ? (const void*)grid_kernel<CompositeStage>
                                : (const void*)grid_kernel<ScrollStage>;
}

size_t grid_smem_bytes(int kind, int h, int w, int parts) {
  return 4 * (size_t)grid_smem_words(kind, h, w, parts);
}

// Whether `parts` bands of an h x w frame are a shape the kernels take:
// a cluster size, at least one row a band, a thread's run within a word.
bool valid_parts(int h, int w, int parts) {
  return valid_cluster(parts) && parts <= h && grid_items(h, w, parts) <= kGridMaxRun;
}

// Blocks of a band plan the current device holds at once: clusters of
// `parts` blocks (one block a session where parts is 1) at the plan's
// shared memory; 0 where a band does not fit a block, -1 where the
// runtime cannot say.
int grid_capacity(int kind, int h, int w, int parts) {
  if (!valid_parts(h, w, parts)) return 0;
  const void* kernel = grid_kernel_of(kind);
  const size_t smem = grid_smem_bytes(kind, h, w, parts);
  const size_t limit = dynamic_smem_limit(kernel);
  if (limit == 0) return -1;
  if (smem > limit) return 0;
  if (parts == 1) {
    int dev = 0, sms = 0;
    const int per_sm = blocks_per_sm(kernel, kGridThreads, smem);
    if (per_sm < 0 || cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      cudaGetLastError();
      return -1;
    }
    return per_sm * sms;
  }
  const int clusters = active_clusters(kernel, parts, kGridThreads, smem);
  return clusters < 0 ? -1 : clusters * parts;
}

// The plan (h264t_grid_plan).  Blocks past what the card holds at once
// wait for another wave, and a block costs its band's MBs plus a fixed
// kGridBlockMbs (staging latency, barriers, the cluster's), so P costs
// ceil(batch * P / capacity) * (band_max_rows(h, P) * w + kGridBlockMbs);
// the plan is the P of least cost, the smallest of equals.  0 where no
// band fits, -1 where the runtime cannot say.
int grid_plan(int kind, int h, int w, int batch) {
  int best = 0;
  long long best_cost = 0;
  for (int p = 1; p <= kMaxCluster && p <= h; p *= 2) {
    const int capacity = grid_capacity(kind, h, w, p);
    if (capacity < 0) return -1;
    if (capacity == 0) continue;
    const long long waves = ((long long)batch * p + capacity - 1) / capacity;
    const long long cost = waves * ((long long)band_max_rows(h, p) * w + kGridBlockMbs);
    if (best == 0 || cost < best_cost) {
      best = p;
      best_cost = cost;
    }
  }
  return best;
}

// One launch of a stage over `batch` sessions in `parts` bands: a plain
// launch for one band a session, else clusters of `parts` blocks.
template <class Stage>
cudaError_t launch_grid(const Stage& st, int batch, int parts, cudaStream_t stream) {
  if (!valid_parts(st.h, st.w, parts)) return cudaErrorInvalidValue;
  const int k = grid_items(st.h, st.w, parts);
  const size_t smem = grid_smem_bytes(Stage::kKind, st.h, st.w, parts);
  if (parts > 1) {
    return launch_clusters(grid_kernel<Stage>, batch, parts, kGridThreads, smem, stream, st, parts,
                           k);
  }
  const cudaError_t err = set_smem((const void*)grid_kernel<Stage>, smem);
  if (err != cudaSuccess) return err;
  grid_kernel<Stage><<<batch, kGridThreads, smem, stream>>>(st, 1, k);
  return cudaGetLastError();
}

}  // namespace

// K6.  fields: 4 x (address, batch, row and column strides in bytes,
// dtype code) for ref, mv_x, mv_y [batch, h, w] and num_refs (address 0:
// nrefs_value for every session).  parts: the row bands a session (1 or a
// cluster of 2, 4, 8 or 16 blocks; h264t_grid_plan's).  Outputs: pat, nb
// int32[batch, h * w, S] with S = (compact_x ? 2 : 3) + wide, last
// int32[batch].
extern "C" int h264t_scroll_grid(const long long* fields, int batch, int h, int w,
                                 int nrefs_value, int wide, int compact_x, int enable_pskip,
                                 int parts, int32_t* pat, int32_t* nb, int32_t* last,
                                 void* stream) {
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
  return (int)launch_grid(st, batch, parts, (cudaStream_t)stream);
}

// K5.  fields: 15 x (address, strides, code): the background's ref, mv_x,
// mv_y and coded [batch, H, W], the donor's nine role fields (ops/grid.
// ROLE_FIELDS order) and coded mask [batch, R, C], then num_refs as for
// K6.  The rect is rows [r0, r0 + R) and columns [c0, c0 + C); parts as
// for K6.  Outputs:
// bg_p, bg_n int32[batch, H, W, wide ? 4 : 3]; with compact_x bg2_p,
// bg2_n int32[batch, H, W, 2] (else null); sr_p, sr_n int32[batch, H * W];
// last int32[batch].
extern "C" int h264t_composite_grid(const long long* fields, int batch, int h, int w, int r0,
                                    int c0, int rh, int rw, int nrefs_value, int wide,
                                    int compact_x, int parts, int32_t* bg_p, int32_t* bg_n,
                                    int32_t* bg2_p, int32_t* bg2_n, int32_t* sr_p, int32_t* sr_n,
                                    int32_t* last, void* stream) {
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
  return (int)launch_grid(st, batch, parts, (cudaStream_t)stream);
}

// The band plan of a kernel (kind 0 K5, 1 K6) for sessions of n_mbs MBs,
// w a row, at this batch on the current device (grid_plan; launches
// nothing): the row bands a session, P in {1, 2, 4, 8, 16}; 0 where no
// band fits a block, -1 where the runtime cannot say.
extern "C" int h264t_grid_plan(int n_mbs, int w, int batch, int kind) {
  if (w < 1 || n_mbs < w || n_mbs % w != 0 || batch < 1 || (kind != 0 && kind != 1)) return 0;
  return grid_plan(kind, n_mbs / w, w, batch);
}

// Blocks of the plan of `parts` bands the device holds at once
// (grid_capacity): what h264t_grid_plan weighs, for ops/grid's model of it.
extern "C" int h264t_grid_capacity(int n_mbs, int w, int parts, int kind) {
  if (w < 1 || n_mbs < w || n_mbs % w != 0 || (kind != 0 && kind != 1)) return 0;
  return grid_capacity(kind, n_mbs / w, w, parts);
}

// The band arithmetic, for ops/grid's twin of it: the first row of band r,
// the MBs of a thread's run, the dynamic shared memory of a block.
extern "C" int h264t_grid_band_row(int h, int parts, int r) { return band_row(h, parts, r); }

extern "C" int h264t_grid_items(int n_mbs, int w, int parts) {
  return grid_items(n_mbs / w, w, parts);
}

extern "C" int h264t_grid_smem(int n_mbs, int w, int parts, int kind) {
  return (int)grid_smem_bytes(kind, n_mbs / w, w, parts);
}
