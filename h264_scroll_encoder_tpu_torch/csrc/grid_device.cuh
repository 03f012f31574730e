// Device code of the grid-stage kernels (grid_kernels.cu: K5 and K6): the
// per-MB work of the symbol stages over a frame's macroblock grid, a
// session in row bands on the blocks of a thread-block cluster.
// Everything here sits in an anonymous namespace.
//
// What a session computes, per MB in raster order (the port's plain
// versions in ops/grid.py are the same function in torch):
//   - the H.264 8.4.1.3.1 MV prediction from the left (A), above (B) and
//     above-right (C, or above-left D where C does not exist) neighbours,
//     each read from its role: a stage supplies role(k, MB) for k = A, B,
//     D (K6: one grid for all three; K5: the donor rect's role fields
//     inside the rect, the background outside);
//   - K6 with P_Skip: the 8.4.1.1 skip MV and whether the MB is skipped;
//   - the coded flag, then the skip run before each MB: an exclusive
//     max-scan of (coded ? index : -1) over the raster;
//   - the Exp-Golomb codes ue/se/te and the merged symbol slots.
//
// How a block does it (grid_kernel; grid_kernels.cu's note has the why):
//   1. Band.  Block r of a session's P blocks (its cluster rank) takes the
//      MB rows [band_row(h, P, r), band_row(h, P, r + 1)), whole rows, so
//      that the band is one contiguous range of the raster.
//   2. Stage.  The fields the band's stencil reads, over the band and the
//      row above it (the halo), are copied once into shared memory and
//      held there as int32: each field region a job, the round's jobs
//      numbered as one range of units (stage_band), each thread loading
//      kInFlight units before it converts any (stage_units: aligned
//      16-byte vectors along the rows of a contiguous region, elements of
//      a strided one; one dtype switch a unit, outside its element loop).
//      Staged index j = i + w for the band's MB i, so that an MB's
//      neighbours lie at j - 1 (A), j - w (B), j - w + 1 (C) and j - w - 1
//      (D).  K5 stages its coded mask first and the role grids only where
//      an MB of the band is live.
//   3. Runs.  Thread t takes the k MBs [t * k, (t + 1) * k) of the band (k
//      odd, so that neighbouring threads' shared-memory words fall in
//      different banks), computes their coded flags (a bit each in one
//      register) and the last coded MB of its run.
//   4. Scan.  One block exclusive max-scan of the runs' maxima (warp
//      shuffles, then one warp over the warps' maxima); with P > 1 each
//      block publishes its band's maximum in shared memory and, after one
//      cluster barrier, takes the maximum of the lower ranks' through
//      DSMEM as its carry.  Each thread then writes its MBs' skip runs
//      (and coded flags) to a word an MB in shared memory.
//   5. Slots.  The band is emitted in chunks of kGridThreads MBs, a thread
//      an MB: the prediction and codes from shared memory, the slots into
//      a shared buffer per output array, laid out as the array is in
//      global memory; then the block writes each array's chunk, a
//      contiguous range, with 16-byte stores.
//
// Arithmetic is the JAX package's 32-bit: values int32, patterns uint32
// (stored as int32 bits), unsigned wrap where the JAX package's uint32 or
// int32 arithmetic wraps.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "cluster.cuh"

namespace {

// Threads of a block (one band).
constexpr int kGridThreads = 512;
constexpr int kGridWarps = kGridThreads / 32;
constexpr unsigned kAllLanes = 0xffffffffu;
static_assert(kGridWarps <= 32, "one warp scans the warps' maxima");
// The most MBs a thread's run holds: their coded flags are one register's
// bits.  (The shared-memory limit refuses a band this long first.)
constexpr int kGridMaxRun = 31;

// What a block costs the plan besides its band's MBs, in MBs (staging
// latency, barriers, the cluster's): set so that on an H100 the plan takes
// the fastest P of kernel_ab.py --grid's sweep at 720p, B = 256 (one wave
// of whole sessions for K6, two bands a session for K5; PERF.md §6).
constexpr int kGridBlockMbs = 1024;

// The kernels, as h264t_grid_plan names them.
enum : int { kGridComposite = 0, kGridScroll = 1 };

// ---------------------------------------------------------------------------
// The band plan's arithmetic (ops/grid.py keeps the same formulas:
// band_rows, grid_items_per_thread, grid_smem_bytes).
// ---------------------------------------------------------------------------

// The first row of band r of `parts` over h MB rows; band r is rows
// [band_row(h, parts, r), band_row(h, parts, r + 1)), at least one row
// where parts <= h.
__host__ __device__ __forceinline__ int band_row(int h, int parts, int r) {
  return (int)((long long)r * h / parts);
}

__host__ __device__ __forceinline__ int band_max_rows(int h, int parts) {
  return (h + parts - 1) / parts;
}

// MBs of a thread's run: the longest band over the block's threads, odd.
__host__ __device__ __forceinline__ int grid_items(int h, int w, int parts) {
  return ((band_max_rows(h, parts) * w + kGridThreads - 1) / kGridThreads) | 1;
}

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// A chunk buffer of an output array with `slots` words an MB: one chunk's
// words and room to shift them to the array's address mod 16 bytes.
__host__ __device__ constexpr int chunk_words(int slots) { return kGridThreads * slots + 4; }

// One staged field: the longest band and its halo row, as int32.
__host__ __device__ __forceinline__ int staged_words(int h, int w, int parts) {
  return round4((band_max_rows(h, parts) + 1) * w);
}

// The fields a kernel stages: K5 the nine composite role grids, K6 ref,
// mv_x and mv_y.
__host__ __device__ __forceinline__ int staged_fields(int kind) {
  return kind == kGridComposite ? 9 : 3;
}

// A block's dynamic shared memory in int32 words: the staged fields, a
// word an MB of the band (coded flag, then skip run) and the chunk
// buffers, pattern and width of each output array (K5: 4, 2 and 1 slots;
// K6: up to 4).
__host__ __device__ __forceinline__ int grid_smem_words(int kind, int h, int w, int parts) {
  const int bufs = kind == kGridComposite
                       ? 2 * (chunk_words(4) + chunk_words(2) + chunk_words(1))
                       : 2 * chunk_words(4);
  return staged_fields(kind) * staged_words(h, w, parts) + round4(band_max_rows(h, parts) * w) +
         bufs;
}

// ---------------------------------------------------------------------------
// Inputs read in place.
// ---------------------------------------------------------------------------

// A tensor read in place: element (b, r, c) lies at p + b * sb + r * sr +
// c * sc bytes; `code` is its element size, negative for an unsigned byte
// (uint8, bool).  ops/grid.py's _field writes these.
struct Field {
  const char* p;
  long long sb, sr, sc;
  int code;
};

// The wrappers hand each Field over as kFieldWords int64: address, the
// three strides, dtype code (K5, K6 and K7 alike).
constexpr int kFieldWords = 5;

inline Field field_of(const long long* d) {
  Field f;
  f.p = reinterpret_cast<const char*>(d[0]);
  f.sb = d[1];
  f.sr = d[2];
  f.sc = d[3];
  f.code = static_cast<int>(d[4]);
  return f;
}

inline bool valid_code(int code) {
  return code == 1 || code == -1 || code == 2 || code == 4 || code == 8;
}

// A value as int32 (a wider one keeps its low 32 bits, as torch's
// .to(torch.int32) does) or as a flag (nonzero, as .to(torch.bool)).
struct AsInt {
  template <typename T>
  __device__ __forceinline__ int32_t operator()(T v) const {
    return static_cast<int32_t>(static_cast<uint32_t>(static_cast<unsigned long long>(v)));
  }
};

struct AsFlag {
  template <typename T>
  __device__ __forceinline__ int32_t operator()(T v) const {
    return v != 0;
  }
};

__device__ __forceinline__ int32_t load_i32(const Field& f, int b) {
  const char* a = f.p + f.sb * b;
  switch (f.code) {
    case 1:
      return AsInt()(__ldg(reinterpret_cast<const signed char*>(a)));
    case -1:
      return AsInt()(__ldg(reinterpret_cast<const unsigned char*>(a)));
    case 2:
      return AsInt()(__ldg(reinterpret_cast<const short*>(a)));
    case 4:
      return AsInt()(__ldg(reinterpret_cast<const int*>(a)));
    default:
      return AsInt()(__ldg(reinterpret_cast<const long long*>(a)));
  }
}

// num_refs of session b: a tensor read in place (stride 0 broadcasts one
// value), or the value passed where the field has no address.
__device__ __forceinline__ int32_t num_refs_of(const Field& f, int32_t value, int b) {
  return f.p == nullptr ? value : load_i32(f, b);
}

// ---------------------------------------------------------------------------
// Staging: a band's field regions (jobs) copied to shared memory as int32.
// Every thread loads kInFlight units before it converts any, so that a
// band's fields cost about one memory latency per kInFlight units a thread,
// not one a field: a unit is an aligned 16-byte vector of a contiguous
// region (coalesced along the rows), or one element of a strided one.
// (Six in flight made K6 spill on an H100 and run slower; PERF.md §6.)
// ---------------------------------------------------------------------------

constexpr int kInFlight = 4;

// A field region to stage: rows [ra, ra + rows) x columns [0, fw) of f
// (session b) into the shared words at base + dst, row pitch `pitch`, as
// int32 or (flag) as 0/1; not the region's elements in the hole, rows
// [h0, h1) x columns [hc0, hc1) of the region (K5: the background under
// the donor rect, which the donor's own jobs fill).  A stage makes its
// jobs with region() and hole(); plan_job fills in the rest.
struct StageJob {
  const char* src;  // the region's element 0
  long long sr, sc;
  int code, flag, rows, fw, dst, pitch;
  int h0, h1, hc0, hc1;
  int vec;    // the region is contiguous and element-aligned: units are vectors
  int dense;  // rows land back to back (pitch fw) and no hole: element e at dst + e
  int first;  // the units of the round's jobs before this one
};
constexpr int kMaxStageJobs = 18;

__device__ __forceinline__ StageJob region(const Field& f, int b, int ra, int rows, int fw,
                                           int dst, int pitch, int flag) {
  StageJob j;
  j.src = f.p + f.sb * b + f.sr * ra;
  j.sr = f.sr;
  j.sc = f.sc;
  j.code = f.code;
  j.flag = flag;
  j.rows = max(rows, 0);
  j.fw = fw;
  j.dst = dst;
  j.pitch = pitch;
  j.h0 = j.h1 = j.hc0 = j.hc1 = 0;
  return j;
}

__device__ __forceinline__ StageJob hole(StageJob j, int h0, int h1, int hc0, int hc1) {
  j.h0 = h0;
  j.h1 = h1;
  j.hc0 = hc0;
  j.hc1 = hc1;
  return j;
}

__device__ __forceinline__ int elem_size(int code) { return code < 0 ? 1 : code; }

// The job's units: the 16-byte vectors over its bytes where the region is
// one contiguous, element-aligned range, else its elements.
__device__ __forceinline__ int plan_job(StageJob& j) {
  const int size = elem_size(j.code);
  const long long n = (long long)j.rows * j.fw;
  const uintptr_t a = reinterpret_cast<uintptr_t>(j.src);
  j.vec = j.sc == size && (j.rows <= 1 || j.sr == (long long)j.fw * size) && a % size == 0;
  j.dense = j.pitch == j.fw && (j.h0 >= j.h1 || j.hc0 >= j.hc1);
  if (!j.vec) return (int)n;
  return n == 0 ? 0 : (int)((((a + n * size + 15) & ~uintptr_t{15}) - (a & ~uintptr_t{15})) >> 4);
}

// Unit u of job j, loaded: its 16 bytes, or its element's in the low ones.
__device__ __forceinline__ uint4 load_unit(const StageJob& j, int u) {
  if (j.vec) {
    const uintptr_t a = (reinterpret_cast<uintptr_t>(j.src) & ~uintptr_t{15}) + 16 * (uintptr_t)u;
    return __ldg(reinterpret_cast<const uint4*>(a));
  }
  const int r = u / j.fw;
  const char* a = j.src + j.sr * r + j.sc * (u - r * j.fw);
  uint4 v = {0u, 0u, 0u, 0u};
  switch (j.code) {
    case 1:
    case -1:
      v.x = __ldg(reinterpret_cast<const unsigned char*>(a));
      break;
    case 2:
      v.x = __ldg(reinterpret_cast<const unsigned short*>(a));
      break;
    case 4:
      v.x = __ldg(reinterpret_cast<const unsigned*>(a));
      break;
    default: {
      const unsigned long long x = __ldg(reinterpret_cast<const unsigned long long*>(a));
      v.x = (unsigned)x;
      v.y = (unsigned)(x >> 32);
    }
  }
  return v;
}

// Element e of the region, converted, into its staged word (not in the
// hole).
__device__ __forceinline__ void put_elem(const StageJob& j, int e, int32_t value, int32_t* base) {
  const int r = e / j.fw, c = e - r * j.fw;
  if (r >= j.h0 && r < j.h1 && c >= j.hc0 && c < j.hc1) return;
  base[j.dst + r * j.pitch + c] = value;
}

template <typename T>
__device__ __forceinline__ int32_t convert(T v, int flag) {
  return flag ? AsFlag()(v) : AsInt()(v);
}

// A loaded unit's elements, typed T, into their staged words: a dense
// int32 vector whose words are 16-byte aligned there in one store, other
// dense ones an element at a time, the rest by row and column (one
// division a unit).
template <typename T>
__device__ __forceinline__ void put_unit_typed(const StageJob& j, uint4 v, int u, int32_t* base) {
  constexpr int kPer = 16 / sizeof(T);
  union {
    uint4 v;
    T t[kPer];
  } x;
  x.v = v;
  if (!j.vec) {
    put_elem(j, u, convert(x.t[0], j.flag), base);
    return;
  }
  const uintptr_t a = reinterpret_cast<uintptr_t>(j.src);
  const int e0 = (int)(((long long)((a & ~uintptr_t{15}) + 16 * (uintptr_t)u) - (long long)a) /
                       (long long)sizeof(T));
  const int n = j.rows * j.fw;
  if (j.dense) {
    if (sizeof(T) == 4 && !j.flag && e0 >= 0 && e0 + kPer <= n && ((j.dst + e0) & 3) == 0) {
      *reinterpret_cast<uint4*>(base + j.dst + e0) = v;
      return;
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (e0 + k >= 0 && e0 + k < n) base[j.dst + e0 + k] = convert(x.t[k], j.flag);
    }
    return;
  }
  const int e = max(e0, 0);
  int r = e / j.fw, c = e - r * j.fw;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (e0 + k >= 0 && e0 + k < n) {
      if (!(r >= j.h0 && r < j.h1 && c >= j.hc0 && c < j.hc1)) {
        base[j.dst + r * j.pitch + c] = convert(x.t[k], j.flag);
      }
      if (++c == j.fw) {
        c = 0;
        ++r;
      }
    }
  }
}

__device__ __forceinline__ void put_unit(const StageJob& j, uint4 v, int u, int32_t* base) {
  switch (j.code) {
    case 1:
      return put_unit_typed<signed char>(j, v, u, base);
    case -1:
      return put_unit_typed<unsigned char>(j, v, u, base);
    case 2:
      return put_unit_typed<short>(j, v, u, base);
    case 4:
      return put_unit_typed<int>(j, v, u, base);
    default:
      return put_unit_typed<long long>(j, v, u, base);
  }
}

// Stages the `total` units of the round's jobs (numbered across the jobs
// in order, StageJob::first), kInFlight a thread loaded before any is
// converted.
__device__ __forceinline__ void stage_units(const StageJob* jobs, int n_jobs, int total,
                                            int32_t* base) {
  for (int u0 = 0; u0 < total; u0 += kGridThreads * kInFlight) {
    uint4 v[kInFlight];
    int at[kInFlight];
    int k = 0;
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) {
      const int u = u0 + q * kGridThreads + (int)threadIdx.x;
      at[q] = -1;
      if (u < total) {
        while (k + 1 < n_jobs && u >= jobs[k + 1].first) ++k;
        at[q] = k;
        v[q] = load_unit(jobs[k], u - jobs[k].first);
      }
    }
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) {
      if (at[q] >= 0) {
        const StageJob& j = jobs[at[q]];
        put_unit(j, v[q], u0 + q * kGridThreads + (int)threadIdx.x - j.first, base);
      }
    }
  }
}

// Division by w of band indices (< 2**16) by a multiply: m = ceil(2**32 /
// w) is exact for i * (w - 1) < 2**32.
struct DivW {
  uint32_t m;
  int w;
  __device__ __forceinline__ explicit DivW(int w_)
      : m(w_ > 1 ? 0xffffffffu / w_ + 1u : 0u), w(w_) {}
  __device__ __forceinline__ int operator()(int i) const {
    return w > 1 ? (int)__umulhi((uint32_t)i, m) : i;
  }
};

__device__ __forceinline__ int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

// ---------------------------------------------------------------------------
// Exp-Golomb codes as (pattern, nbits) (ops/expgolomb, ops/bitpack).
// ---------------------------------------------------------------------------

struct Code {
  uint32_t p;
  int32_t n;
};

// ue(0): mb_type P_L0_16x16 and coded_block_pattern 0.
__device__ __forceinline__ Code ue0() { return {1u, 1}; }

// ue(v) = the (2M + 1)-bit value v + 1, M = floor(log2(v + 1)); v + 1
// wraps to 0 at 2**32 - 1, whose width is then -1, as the JAX package's.
__device__ __forceinline__ Code ue(uint32_t v) {
  const uint32_t v1 = v + 1u;
  return {v1, 2 * (31 - __clz(static_cast<int>(v1))) + 1};
}

// se(v): v > 0 -> 2v - 1, else -2v (mod 2**32), then ue.
__device__ __forceinline__ Code se(int32_t v) {
  const uint32_t u = static_cast<uint32_t>(v);
  return ue(v > 0 ? 2u * u - 1u : 0u - 2u * u);
}

// te(v) for num possible values: no bits for one, one inverted bit for
// two, else ue(v).
__device__ __forceinline__ Code te(int32_t v, int32_t num) {
  const uint32_t u = static_cast<uint32_t>(v);
  const Code full = ue(u);
  return {num <= 2 ? 1u - (u & 1u) : full.p, num <= 1 ? 0 : num == 2 ? 1 : full.n};
}

// a || b in one slot (bitpack.merge_symbol_pairs): b's pattern is not
// masked, as the plain version's is not.
__device__ __forceinline__ Code merge(Code a, Code b) {
  const int s = min(max(b.n, 0), 31);
  return {(a.p << s) | b.p, a.n + b.n};
}

// Slot `at` of a chunk buffer pair: the code where the MB is live, else 0.
__device__ __forceinline__ void put(int32_t* pat, int32_t* nb, int at, Code code, bool live) {
  pat[at] = live ? static_cast<int32_t>(code.p) : 0;
  nb[at] = live ? code.n : 0;
}

// ---------------------------------------------------------------------------
// The MV prediction stencil (ops/grid._pred_stencil_roles), over staged
// indices.
// ---------------------------------------------------------------------------

struct Mv {
  int32_t ref, x, y;
};

enum : int { kRoleA = 0, kRoleB = 1, kRoleD = 2 };

// The neighbours a prediction reads; an unavailable one holds zeros, as
// the plain version's shifted grids do at the frame's edge.
struct Neighbours {
  Mv a, b, c;
  bool has_a, has_b, has_c;
};

// The neighbours of the MB at frame (r, c), staged index j, from
// role(k, staged index).
template <class Role>
__device__ __forceinline__ Neighbours neighbours(const Role& role, int j, int r, int c, int w) {
  Neighbours n;
  const Mv zero = {0, 0, 0};
  n.has_a = c > 0;
  n.has_b = r > 0;
  const bool use_cr = r > 0 && c + 1 < w;        // above-right exists
  const bool use_d = r > 0 && c > 0 && !use_cr;  // else above-left
  n.has_c = use_cr || use_d;
  n.a = n.has_a ? role(kRoleA, j - 1) : zero;
  n.b = n.has_b ? role(kRoleB, j - w) : zero;
  n.c = use_cr ? role(kRoleB, j - w + 1) : use_d ? role(kRoleD, j - w - 1) : zero;
  return n;
}

__device__ __forceinline__ int32_t median3(int32_t a, int32_t b, int32_t c) {
  return max(min(a, b), min(max(a, b), c));
}

// The predicted MV for reference `cur`: none available -> 0; only the left
// one -> it; exactly one neighbour on `cur` -> its MV; else the median.
__device__ __forceinline__ Mv predict(const Neighbours& n, int32_t cur) {
  const bool ma = n.has_a && n.a.ref == cur;
  const bool mb = n.has_b && n.b.ref == cur;
  const bool mc = n.has_c && n.c.ref == cur;
  if (!n.has_a && !n.has_b && !n.has_c) return {cur, 0, 0};
  if (n.has_a && !n.has_b && !n.has_c) return {cur, n.a.x, n.a.y};
  if (ma + mb + mc == 1) {
    const Mv& m = ma ? n.a : mb ? n.b : n.c;
    return {cur, m.x, m.y};
  }
  return {cur, median3(n.a.x, n.b.x, n.c.x), median3(n.a.y, n.b.y, n.c.y)};
}

// ---------------------------------------------------------------------------
// The skip-run scan and the band's word an MB.
// ---------------------------------------------------------------------------

struct ScanSmem {
  int32_t units;             // the units of the round's stage jobs
  int32_t warp[kGridWarps];  // each warp's inclusive maximum
  int32_t excl[kGridWarps];  // the maximum of the warps before each
  int32_t total;             // the block's maximum
  int32_t band_last;         // the band's last coded MB, read by higher ranks
  int32_t carry;             // the lower bands' last coded MB
};

__device__ __forceinline__ int32_t warp_max_scan(int32_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t o = __shfl_up_sync(kAllLanes, v, d);
    if (lane >= d) v = max(v, o);
  }
  return v;
}

// The maximum of v over the threads before this one (-1 for none), and in
// `total` over the block.  Two barriers.
__device__ __forceinline__ int32_t block_exclusive_max(int32_t v, ScanSmem& s, int32_t& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int32_t incl = warp_max_scan(v);
  if (lane == 31) s.warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int32_t t = warp_max_scan(lane < kGridWarps ? s.warp[lane] : -1);
    const int32_t before = __shfl_up_sync(kAllLanes, t, 1);
    if (lane < kGridWarps) s.excl[lane] = lane == 0 ? -1 : before;
    if (lane == 31) s.total = t;
  }
  __syncthreads();
  const int32_t up = __shfl_up_sync(kAllLanes, incl, 1);
  total = s.total;
  return lane == 0 ? s.excl[warp] : max(s.excl[warp], up);
}

// An MB's word after the scan: its skip run, and its coded flag in bit 31.
__device__ __forceinline__ bool word_coded(int32_t word) { return word < 0; }

__device__ __forceinline__ uint32_t word_run(int32_t word) {
  return static_cast<uint32_t>(word) & 0x7fffffffu;
}

// Copies `count` words of a chunk buffer to global memory; src lies at
// dst's address mod 16 bytes (src = buffer + word_shift(dst)), so the
// middle goes in 16-byte stores.
__device__ __forceinline__ int word_shift(const int32_t* dst) {
  return (int)((reinterpret_cast<uintptr_t>(dst) >> 2) & 3);
}

__device__ __forceinline__ void store_words(const int32_t* src, int32_t* dst, int count) {
  const int head = min((4 - word_shift(dst)) & 3, count);
  const int n4 = (count - head) >> 2;
  if ((int)threadIdx.x < head) dst[threadIdx.x] = src[threadIdx.x];
  for (int q = threadIdx.x; q < n4; q += kGridThreads) {
    reinterpret_cast<int4*>(dst + head)[q] = reinterpret_cast<const int4*>(src + head)[q];
  }
  for (int i = head + 4 * n4 + threadIdx.x; i < count; i += kGridThreads) dst[i] = src[i];
}

// Where a block's arrays lie in its dynamic shared memory, in words from
// its base: staged field f at f * staged, the band's words (a word an MB)
// at `words`, the chunk buffers from `bufs` on, in a stage's own order.
// Offsets, not pointers, so that they cost few registers.
struct Layout {
  int32_t* base;
  int staged, words, bufs;
  __device__ __forceinline__ int32_t* field(int f) const { return base + f * staged; }
  __device__ __forceinline__ int32_t* word() const { return base + words; }
  __device__ __forceinline__ int32_t* buf(int at) const { return base + bufs + at; }
};

__device__ __forceinline__ Layout grid_layout(int32_t* smem, int kind, int h, int w, int parts) {
  const int staged = staged_words(h, w, parts);
  const int words = staged_fields(kind) * staged;
  return {smem, staged, words, words + round4(band_max_rows(h, parts) * w)};
}

// Stages a band in the stage's rounds: lane l of warp 0 makes the round's
// job l (Stage::job, Stage::n_jobs of them) and plans it, a prefix sum
// numbers the units, and the block stages them (stage_units).  A stage
// may end after a round (Stage::done).
template <class Stage>
__device__ __forceinline__ void stage_band(const Stage& st, const Layout& L, StageJob* jobs,
                                           ScanSmem& scan, const DivW& divw, int b, int r_lo,
                                           int r_hi) {
  static_assert(kMaxStageJobs <= 32, "a job a lane of warp 0");
#pragma unroll 1
  for (int round = 0; round < Stage::kRounds; ++round) {
    const int n_jobs = st.n_jobs(round);
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      StageJob j;
      int units = 0;
      if (lane < n_jobs) {
        j = st.job(L, round, lane, b, r_lo, r_hi);
        units = plan_job(j);
      }
      int upto = units;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(kAllLanes, upto, o);
        if (lane >= o) upto += up;
      }
      if (lane < n_jobs) {
        j.first = upto - units;
        jobs[lane] = j;
      }
      if (lane == 31) scan.units = upto;
    }
    __syncthreads();
    stage_units(jobs, n_jobs, scan.units, L.base);
    __syncthreads();
    if (round + 1 < Stage::kRounds && st.done(L, divw, round, r_lo, r_hi)) break;
  }
}

// One session in `parts` row bands, a block (cluster rank) a band; k MBs a
// thread's run (grid_items).  Stage::job makes the field regions to stage
// (stage_band; K5's coded flags go into the band's words); Stage::coded
// gives an MB's coded flag; Stage::emit writes a chunk of the band's slots;
// the last coded MB of the session (or -1) goes to last[b].
// Stage::kMinBlocks caps the registers so that the plan's blocks an SM fit.
template <class Stage>
__global__ void __launch_bounds__(kGridThreads, Stage::kMinBlocks)
    grid_kernel(const __grid_constant__ Stage param, int parts, int k) {
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ ScanSmem scan;
  __shared__ StageJob jobs[kMaxStageJobs];
  // The stage's parameters (K5's are ~0.8 KB: fifteen fields) read once
  // into shared memory by the whole block, a word a thread, all at once,
  // rather than where the code needs them, one after another.
  __shared__ __align__(16) Stage st_s;
  static_assert(sizeof(Stage) % 4 == 0, "copied a word at a time");
  for (int i = threadIdx.x; i < (int)(sizeof(Stage) / 4); i += kGridThreads) {
    reinterpret_cast<uint32_t*>(&st_s)[i] = reinterpret_cast<const uint32_t*>(&param)[i];
  }
  __syncthreads();
  const Stage& st = st_s;
  const int b = blockIdx.x / parts, rank = blockIdx.x - b * parts;
  const int w = st.w;
  const int r_lo = band_row(st.h, parts, rank), r_hi = band_row(st.h, parts, rank + 1);
  const int i0 = r_lo * w, n = (r_hi - r_lo) * w;
  const int32_t nrefs = num_refs_of(st.nrefs, st.nrefs_value, b);
  const Layout L = grid_layout(smem, Stage::kKind, st.h, w, parts);
  const DivW divw(w);
  stage_band(st, L, jobs, scan, divw, b, r_lo, r_hi);

  // Runs: the coded flags of this thread's MBs, and its last coded MB.
  const int a = min((int)threadIdx.x * k, n), e = min(a + k, n);
  uint32_t mask = 0;
  int32_t last = -1;
  int r = r_lo + a / w, c = a - (r - r_lo) * w;
  for (int i = a; i < e; ++i) {
    if (st.coded(L, i, r, c)) {
      mask |= 1u << (i - a);
      last = i0 + i;
    }
    if (++c == w) {
      c = 0;
      ++r;
    }
  }

  // Scan: within the band, then the lower bands' carry over DSMEM.
  int32_t total;
  int32_t before = block_exclusive_max(last, scan, total);
  if (parts > 1) {
    if (threadIdx.x == 0) scan.band_last = total;
    cluster_sync();  // every band's maximum is published
    if (threadIdx.x < 32) {
      int32_t x = (int)threadIdx.x < rank
                      ? *cg::this_cluster().map_shared_rank(&scan.band_last, (int)threadIdx.x)
                      : -1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(kAllLanes, x, o));
      if (threadIdx.x == 0) scan.carry = x;
    }
    __syncthreads();
    cluster_arrive();  // this block reads no other block's memory any more
    before = max(before, scan.carry);
    total = max(total, scan.carry);
  }
  int32_t* words = L.word();
  for (int i = a; i < e; ++i) {
    const bool coded = (mask >> (i - a)) & 1u;
    words[i] = static_cast<int32_t>(static_cast<uint32_t>(i0 + i - before - 1) |
                                    (coded ? 0x80000000u : 0u));
    if (coded) before = i0 + i;
  }
  __syncthreads();

  // Slots, a chunk of kGridThreads MBs at a time.
  for (int c0 = 0; c0 < n; c0 += kGridThreads) {
    st.emit(L, divw, b, r_lo, i0, c0, min(kGridThreads, n - c0), nrefs);
    __syncthreads();  // the buffers are free for the next chunk
  }
  if (rank == parts - 1 && threadIdx.x == 0) st.last[b] = total;
  if (parts > 1) cluster_wait();  // no block leaves while another reads it
}

// ---------------------------------------------------------------------------
// K6: the MB grid of a scroll, waypoint, hint or session frame.
// ---------------------------------------------------------------------------

struct ScrollStage {
  static constexpr int kKind = kGridScroll;
  static constexpr int kMinBlocks = 3;  // 42 registers a thread
  // Chunk buffers (Layout::buf): patterns, then widths.
  static constexpr int kBufP = 0, kBufN = chunk_words(4);
  Field g[3];  // ref, mv_x, mv_y [B, h, w]
  Field nrefs;
  int32_t nrefs_value;
  int h, w, wide, compact, pskip;
  int32_t* pat;  // [B, h * w, S]
  int32_t* nb;
  int32_t* last;  // [B]

  __device__ __forceinline__ Mv at(const Layout& L, int j) const {
    return {L.field(0)[j], L.field(1)[j], L.field(2)[j]};
  }

  __device__ __forceinline__ Neighbours around(const Layout& L, int j, int r, int c) const {
    return neighbours([&](int, int jj) { return at(L, jj); }, j, r, c, w);
  }

  // One round: ref, mv_x and mv_y over the band and the row above it
  // (none above the frame's first row).
  static constexpr int kRounds = 1;
  __device__ __forceinline__ int n_jobs(int) const { return 3; }

  __device__ __forceinline__ StageJob job(const Layout& L, int, int f, int b, int r_lo,
                                          int r_hi) const {
    const int ra = max(r_lo - 1, 0);
    return region(g[f], b, ra, r_hi - ra, w, f * L.staged + (ra - r_lo + 1) * w, w, 0);
  }

  __device__ __forceinline__ bool done(const Layout&, const DivW&, int, int, int) const {
    return true;
  }

  // Coded unless P_Skip (8.4.1.1): the skip MV is zero where the left or
  // above MB is missing or is ref 0 with a zero MV, else the prediction
  // for ref 0.
  __device__ __forceinline__ bool coded(const Layout& L, int i, int r, int c) const {
    if (!pskip) return true;
    const int j = i + w;
    const Mv self = at(L, j);
    const Neighbours n = around(L, j, r, c);
    const bool zero_a = n.a.ref == 0 && n.a.x == 0 && n.a.y == 0;
    const bool zero_b = n.b.ref == 0 && n.b.x == 0 && n.b.y == 0;
    Mv skip = {0, 0, 0};
    if (n.has_a && n.has_b && !zero_a && !zero_b) skip = predict(n, 0);
    return !(self.ref == 0 && self.x == skip.x && self.y == skip.y);
  }

  __device__ __forceinline__ void emit(const Layout& L, const DivW& divw, int b, int r_lo, int i0,
                                       int c0, int count, int32_t nrefs) const {
    const int slots = (compact ? 2 : 3) + wide;
    const size_t at0 = (static_cast<size_t>(b) * h * w + i0 + c0) * slots;
    const int sp = kBufP + word_shift(pat + at0), sn = kBufN + word_shift(nb + at0);
    if ((int)threadIdx.x < count) {
      const int i = c0 + threadIdx.x, j = i + w;
      const int r = r_lo + divw(i), c = i - (r - r_lo) * w;
      const Mv self = at(L, j);
      const Mv pred = predict(around(L, j, r, c), self.ref);
      const int32_t word = L.word()[i];
      const bool live = word_coded(word);
      const Code sr = ue(word_run(word));
      const Code ref = te(self.ref, nrefs);
      const Code a = wide ? merge(ue0(), ref) : merge(merge(sr, ue0()), ref);
      const Code mx = se(sub32(self.x, pred.x));
      const Code cc = merge(se(sub32(self.y, pred.y)), ue0());
      int32_t* bp = L.buf(sp);
      int32_t* bn = L.buf(sn);
      int o = threadIdx.x * slots;
      if (wide) put(bp, bn, o++, sr, live);
      if (compact) {
        put(bp, bn, o++, merge(a, mx), live);
      } else {
        put(bp, bn, o++, a, live);
        put(bp, bn, o++, mx, live);
      }
      put(bp, bn, o, cc, live);
    }
    __syncthreads();
    store_words(L.buf(sp), pat + at0, count * slots);
    store_words(L.buf(sn), nb + at0, count * slots);
  }
};

// ---------------------------------------------------------------------------
// K5: the splice steps' composite grid.
// ---------------------------------------------------------------------------

struct CompositeStage {
  static constexpr int kKind = kGridComposite;
  static constexpr int kMinBlocks = 2;  // 64 registers a thread
  // Chunk buffers (Layout::buf): bg patterns and widths (4 slots an MB),
  // bg2's (2), sr's (1).
  static constexpr int kBufBgP = 0, kBufBgN = chunk_words(4), kBuf2P = 2 * chunk_words(4),
                       kBuf2N = kBuf2P + chunk_words(2), kBufSrP = kBuf2N + chunk_words(2),
                       kBufSrN = kBufSrP + chunk_words(1);
  Field bg[4];    // ref, mv_x, mv_y, coded [B, H, W]
  Field role[9];  // a_ref a_mvx a_mvy b_ref ... d_mvy [B, R, C]
  Field dcoded;   // [B, R, C]
  Field nrefs;
  int32_t nrefs_value;
  int h, w, r0, c0, rh, rw, wide, compact;
  int32_t *bg_p, *bg_n;    // [B, H, W, 3 or 4]
  int32_t *bg2_p, *bg2_n;  // [B, H, W, 2] with compact, else null
  int32_t *sr_p, *sr_n;    // [B, H * W]
  int32_t* last;           // [B]

  __device__ __forceinline__ bool inside(int r, int c) const {
    return r >= r0 && r < r0 + rh && c >= c0 && c < c0 + rw;
  }

  // Role k of the staged MB j: the staged fields are the nine role grids in
  // ROLE_FIELDS order.
  __device__ __forceinline__ Mv role_at(const Layout& L, int k, int j) const {
    return {L.field(3 * k)[j], L.field(3 * k + 1)[j], L.field(3 * k + 2)[j]};
  }

  // Two rounds.  First the composite coded mask of the band into its
  // words: the background's but under the rect, the donor's there.  An
  // MB's prediction is needed only where it is live (coded, outside the
  // rect): where no MB of the band is (the splice steps' all-skip
  // background), the band is staged.  Else the three composite role grids
  // over the band and its halo: the background's ref and MV in each role
  // but under the rect, the donor's role fields there.
  static constexpr int kRounds = 2;
  __device__ __forceinline__ int n_jobs(int round) const { return round == 0 ? 2 : 18; }

  __device__ __forceinline__ StageJob job(const Layout& L, int round, int x, int b, int r_lo,
                                          int r_hi) const {
    if (round == 0) {
      const int ca = max(r_lo, r0), cr = max(min(r_hi, r0 + rh), ca) - ca;  // rect rows in band
      return x == 0 ? hole(region(bg[3], b, r_lo, r_hi - r_lo, w, L.words, w, 1), r0 - r_lo,
                           r0 + rh - r_lo, c0, c0 + rw)
                    : region(dcoded, b, ca - r0, cr, rw, L.words + (ca - r_lo) * w + c0, w, 1);
    }
    const int ra = max(r_lo - 1, 0);
    if (x < 9) {  // staged field x = 3 * role + f: the background's field f
      return hole(region(bg[x % 3], b, ra, r_hi - ra, w, x * L.staged + (ra - r_lo + 1) * w, w, 0),
                  r0 - ra, r0 + rh - ra, c0, c0 + rw);
    }
    const int qa = max(ra, r0), qr = max(min(r_hi, r0 + rh), qa) - qa;  // ... in band and halo
    return region(role[x - 9], b, qa - r0, qr, rw, (x - 9) * L.staged + (qa - r_lo + 1) * w + c0,
                  w, 0);
  }

  // After round 0: done unless an MB of the band is live.
  __device__ __forceinline__ bool done(const Layout& L, const DivW& divw, int round, int r_lo,
                                       int r_hi) const {
    if (round > 0) return true;
    const int n = (r_hi - r_lo) * w;
    bool live = false;
    for (int i = threadIdx.x; i < n && !live; i += kGridThreads) {
      const int r = r_lo + divw(i), c = i - (r - r_lo) * w;
      live = L.word()[i] != 0 && !inside(r, c);
    }
    return !__syncthreads_or(live);
  }

  __device__ __forceinline__ bool coded(const Layout& L, int i, int, int) const {
    return L.word()[i] != 0;
  }

  // The MB predicts for its A-role reference; its mvd is against its own
  // MV, which outside the rect is the A role's (the background's); a rect
  // MB's background slots are never live.
  __device__ __forceinline__ void emit(const Layout& L, const DivW& divw, int b, int r_lo, int i0,
                                       int chunk0, int count, int32_t nrefs) const {
    const int S = wide ? 4 : 3;
    const size_t at = static_cast<size_t>(b) * h * w + i0 + chunk0;
    const int s_bp = kBufBgP + word_shift(bg_p + at * S);
    const int s_bn = kBufBgN + word_shift(bg_n + at * S);
    const int s_sp = kBufSrP + word_shift(sr_p + at);
    const int s_sn = kBufSrN + word_shift(sr_n + at);
    const int s_2p = compact ? kBuf2P + word_shift(bg2_p + at * 2) : 0;
    const int s_2n = compact ? kBuf2N + word_shift(bg2_n + at * 2) : 0;
    if ((int)threadIdx.x < count) {
      const int i = chunk0 + threadIdx.x, j = i + w;
      const int r = r_lo + divw(i), c = i - (r - r_lo) * w;
      const int32_t word = L.word()[i];
      const Code sr = ue(word_run(word));
      L.buf(s_sp)[threadIdx.x] = static_cast<int32_t>(sr.p);
      L.buf(s_sn)[threadIdx.x] = sr.n;
      // Only a live MB needs its prediction and codes (on the splice
      // steps' all-skip background, none outside the rect).
      const bool live = word_coded(word) && !inside(r, c);
      Code a = {0u, 0}, mx = {0u, 0}, cc = {0u, 0};
      if (live) {
        const Mv self = role_at(L, kRoleA, j);
        const Neighbours n =
            neighbours([&](int k, int jj) { return role_at(L, k, jj); }, j, r, c, w);
        const Mv pred = predict(n, self.ref);
        const Code ref = te(self.ref, nrefs);
        a = wide ? merge(ue0(), ref) : merge(merge(sr, ue0()), ref);
        mx = se(sub32(self.x, pred.x));
        cc = merge(se(sub32(self.y, pred.y)), ue0());
      }
      int32_t* bp = L.buf(s_bp);
      int32_t* bn = L.buf(s_bn);
      int o = threadIdx.x * S;
      if (wide) put(bp, bn, o++, sr, live);
      put(bp, bn, o++, a, live);
      put(bp, bn, o++, mx, live);
      put(bp, bn, o, cc, live);
      if (compact) {
        put(L.buf(s_2p), L.buf(s_2n), 2 * threadIdx.x, merge(a, mx), live);
        put(L.buf(s_2p), L.buf(s_2n), 2 * threadIdx.x + 1, cc, live);
      }
    }
    __syncthreads();
    store_words(L.buf(s_bp), bg_p + at * S, count * S);
    store_words(L.buf(s_bn), bg_n + at * S, count * S);
    store_words(L.buf(s_sp), sr_p + at, count);
    store_words(L.buf(s_sn), sr_n + at, count);
    if (compact) {
      store_words(L.buf(s_2p), bg2_p + at * 2, count * 2);
      store_words(L.buf(s_2n), bg2_n + at * 2, count * 2);
    }
  }
};

}  // namespace
