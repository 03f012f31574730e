// Device code of the grid-stage kernels (grid_kernels.cu: K5 and K6): the
// per-MB work of the symbol stages over a frame's macroblock grid, one
// block a session.  Everything here sits in an anonymous namespace.
//
// What a session computes, per MB in raster order (the port's plain
// versions in ops/grid.py are the same function in torch):
//   - the H.264 8.4.1.3.1 MV prediction from the left (A), above (B) and
//     above-right (C, or above-left D where C does not exist) neighbours,
//     each read from its role: a stage supplies role(k, r, c) for k = A,
//     B, D (K6: one grid for all three; K5: the donor rect's role fields
//     inside the rect, the background outside);
//   - K6 with P_Skip: the 8.4.1.1 skip MV and whether the MB is skipped;
//   - the coded flag, then the skip run before each MB: an exclusive
//     max-scan of (coded ? index : -1) over the raster, carried across
//     tiles;
//   - the Exp-Golomb codes ue/se/te and the merged symbol slots.
//
// Arithmetic is the JAX package's 32-bit: values int32, patterns uint32
// (stored as int32 bits), unsigned wrap where the JAX package's uint32 or
// int32 arithmetic wraps.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Threads of a block (one session); each owns one MB of a tile.
constexpr int kGridThreads = 512;
constexpr int kGridWarps = kGridThreads / 32;
constexpr unsigned kAllLanes = 0xffffffffu;
static_assert(kGridWarps <= 32, "one warp scans the warps' maxima");

// A tensor read in place: element (b, r, c) lies at p + b * sb + r * sr +
// c * sc bytes; `code` is its element size, negative for an unsigned byte
// (uint8, bool).  ops/grid.py's _field writes these.
struct Field {
  const char* p;
  long long sb, sr, sc;
  int code;
};

__device__ __forceinline__ long long load_raw(const Field& f, int b, int r, int c) {
  const char* a = f.p + f.sb * b + f.sr * r + f.sc * c;
  switch (f.code) {
    case 1:
      return __ldg(reinterpret_cast<const signed char*>(a));
    case -1:
      return __ldg(reinterpret_cast<const unsigned char*>(a));
    case 2:
      return __ldg(reinterpret_cast<const short*>(a));
    case 4:
      return __ldg(reinterpret_cast<const int*>(a));
    default:
      return __ldg(reinterpret_cast<const long long*>(a));
  }
}

// The value as int32 (a wider one keeps its low 32 bits, as torch's
// .to(torch.int32) does) and as a flag (nonzero, as .to(torch.bool)).
__device__ __forceinline__ int32_t load_i32(const Field& f, int b, int r, int c) {
  return static_cast<int32_t>(static_cast<uint32_t>(
      static_cast<unsigned long long>(load_raw(f, b, r, c))));
}

__device__ __forceinline__ bool load_flag(const Field& f, int b, int r, int c) {
  return load_raw(f, b, r, c) != 0;
}

// num_refs of session b: a tensor read in place (stride 0 broadcasts one
// value), or the value passed where the field has no address.
__device__ __forceinline__ int32_t num_refs_of(const Field& f, int32_t value, int b) {
  return f.p == nullptr ? value : load_i32(f, b, 0, 0);
}

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

__device__ __forceinline__ void put(int32_t* pat, int32_t* nb, size_t at, Code code, bool live) {
  pat[at] = live ? static_cast<int32_t>(code.p) : 0;
  nb[at] = live ? code.n : 0;
}

// ---------------------------------------------------------------------------
// The MV prediction stencil (ops/grid._pred_stencil_roles).
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

template <class Role>
__device__ __forceinline__ Neighbours neighbours(const Role& role, int r, int c, int w) {
  Neighbours n;
  const Mv zero = {0, 0, 0};
  n.has_a = c > 0;
  n.has_b = r > 0;
  const bool use_cr = r > 0 && c + 1 < w;        // above-right exists
  const bool use_d = r > 0 && c > 0 && !use_cr;  // else above-left
  n.has_c = use_cr || use_d;
  n.a = n.has_a ? role(kRoleA, r, c - 1) : zero;
  n.b = n.has_b ? role(kRoleB, r - 1, c) : zero;
  n.c = use_cr ? role(kRoleB, r - 1, c + 1) : use_d ? role(kRoleD, r - 1, c - 1) : zero;
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
// The skip-run scan.
// ---------------------------------------------------------------------------

struct ScanSmem {
  int32_t warp[kGridWarps];  // each warp's inclusive maximum
  int32_t excl[kGridWarps];  // the maximum of the warps before each
  int32_t total;             // the tile's maximum
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

// The maximum of v over the threads before this one in the tile and of
// `carry` (the earlier tiles'), for every thread of the block; `carry`
// becomes the maximum up to the tile's end.  Two barriers.  The shared
// words are written again only after the next call's first barrier, by
// which time every thread has read this call's.
__device__ __forceinline__ int32_t exclusive_max(int32_t v, int32_t& carry, ScanSmem& s) {
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
  const int32_t prefix = max(carry, s.excl[warp]);
  const int32_t up = __shfl_up_sync(kAllLanes, incl, 1);
  carry = max(carry, s.total);
  return lane == 0 ? prefix : max(prefix, up);
}

// One block a session: the raster in tiles of kGridThreads MBs, one a
// thread.  Stage::load computes an MB's per-MB values and returns its
// coded flag; Stage::store writes its outputs from them and the skip run
// before it.  The last coded MB (or -1) goes to last[b].
template <class Stage>
__global__ void __launch_bounds__(kGridThreads) grid_kernel(const Stage st) {
  __shared__ ScanSmem scan;
  const int b = blockIdx.x;
  const int n = st.h * st.w;
  int32_t carry = -1;
  for (int t0 = 0; t0 < n; t0 += kGridThreads) {
    const int i = t0 + threadIdx.x;
    typename Stage::Mb mb = {};
    const bool coded = i < n && st.load(b, i, mb);
    const int32_t before = exclusive_max(coded ? i : -1, carry, scan);
    if (i < n) st.store(b, i, mb, coded, i - before - 1);
  }
  if (threadIdx.x == 0) st.last[b] = carry;
}

// ---------------------------------------------------------------------------
// K6: the MB grid of a scroll, waypoint, hint or session frame.
// ---------------------------------------------------------------------------

struct ScrollStage {
  Field g[3];  // ref, mv_x, mv_y [B, h, w]
  Field nrefs;
  int32_t nrefs_value;
  int h, w, wide, compact, pskip;
  int32_t* pat;  // [B, h * w, S]
  int32_t* nb;
  int32_t* last;  // [B]

  struct Mb {
    int32_t ref, mvdx, mvdy;
  };

  __device__ __forceinline__ Mv at(int b, int r, int c) const {
    return {load_i32(g[0], b, r, c), load_i32(g[1], b, r, c), load_i32(g[2], b, r, c)};
  }

  __device__ __forceinline__ bool load(int b, int i, Mb& mb) const {
    const int r = i / w, c = i - r * w;
    const Mv self = at(b, r, c);
    const Neighbours n = neighbours([&](int, int rr, int cc) { return at(b, rr, cc); }, r, c, w);
    const Mv pred = predict(n, self.ref);
    mb = {self.ref, sub32(self.x, pred.x), sub32(self.y, pred.y)};
    if (!pskip) return true;
    // P_Skip (8.4.1.1): the skip MV is zero where the left or above MB is
    // missing or is ref 0 with a zero MV, else the prediction for ref 0.
    const bool zero_a = n.a.ref == 0 && n.a.x == 0 && n.a.y == 0;
    const bool zero_b = n.b.ref == 0 && n.b.x == 0 && n.b.y == 0;
    Mv skip = {0, 0, 0};
    if (n.has_a && n.has_b && !zero_a && !zero_b) skip = predict(n, 0);
    return !(self.ref == 0 && self.x == skip.x && self.y == skip.y);
  }

  __device__ __forceinline__ void store(int b, int i, const Mb& mb, bool coded, int32_t run) const {
    const Code sr = ue(static_cast<uint32_t>(run));
    const Code ref = te(mb.ref, num_refs_of(nrefs, nrefs_value, b));
    const Code a = wide ? merge(ue0(), ref) : merge(merge(sr, ue0()), ref);
    const Code mx = se(mb.mvdx);
    const Code cc = merge(se(mb.mvdy), ue0());
    const int slots = (compact ? 2 : 3) + wide;
    size_t o = (static_cast<size_t>(b) * h * w + i) * slots;
    if (wide) put(pat, nb, o++, sr, coded);
    if (compact) {
      put(pat, nb, o++, merge(a, mx), coded);
    } else {
      put(pat, nb, o++, a, coded);
      put(pat, nb, o++, mx, coded);
    }
    put(pat, nb, o, cc, coded);
  }
};

// ---------------------------------------------------------------------------
// K5: the splice steps' composite grid.
// ---------------------------------------------------------------------------

struct CompositeStage {
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

  struct Mb {
    int32_t ref, mvdx, mvdy;
    bool in_rect;
  };

  __device__ __forceinline__ bool inside(int r, int c) const {
    return r >= r0 && r < r0 + rh && c >= c0 && c < c0 + rw;
  }

  // Role k of the composite at (r, c): the donor's inside the rect, the
  // background outside.  The scattered grids are never written.
  __device__ __forceinline__ Mv role_at(int b, int k, int r, int c) const {
    if (inside(r, c)) {
      const int rr = r - r0, cc = c - c0;
      return {load_i32(role[3 * k], b, rr, cc), load_i32(role[3 * k + 1], b, rr, cc),
              load_i32(role[3 * k + 2], b, rr, cc)};
    }
    return {load_i32(bg[0], b, r, c), load_i32(bg[1], b, r, c), load_i32(bg[2], b, r, c)};
  }

  __device__ __forceinline__ bool load(int b, int i, Mb& mb) const {
    const int r = i / w, c = i - r * w;
    const bool in = inside(r, c);
    const Neighbours n = neighbours(
        [&](int k, int rr, int cc) { return role_at(b, k, rr, cc); }, r, c, w);
    // The MB predicts for its A-role reference; its mvd is against the
    // background's own MV (a rect MB's background slots are never live).
    const int32_t cur = in ? load_i32(role[0], b, r - r0, c - c0) : load_i32(bg[0], b, r, c);
    const Mv pred = predict(n, cur);
    mb = {load_i32(bg[0], b, r, c), sub32(load_i32(bg[1], b, r, c), pred.x),
          sub32(load_i32(bg[2], b, r, c), pred.y), in};
    return in ? load_flag(dcoded, b, r - r0, c - c0) : load_flag(bg[3], b, r, c);
  }

  __device__ __forceinline__ void store(int b, int i, const Mb& mb, bool coded, int32_t run) const {
    const size_t at = static_cast<size_t>(b) * h * w + i;
    const Code sr = ue(static_cast<uint32_t>(run));
    sr_p[at] = static_cast<int32_t>(sr.p);
    sr_n[at] = sr.n;
    const bool live = coded && !mb.in_rect;
    const Code ref = te(mb.ref, num_refs_of(nrefs, nrefs_value, b));
    const Code a = wide ? merge(ue0(), ref) : merge(merge(sr, ue0()), ref);
    const Code mx = se(mb.mvdx);
    const Code cc = merge(se(mb.mvdy), ue0());
    size_t o = at * (wide ? 4 : 3);
    if (wide) put(bg_p, bg_n, o++, sr, live);
    put(bg_p, bg_n, o++, a, live);
    put(bg_p, bg_n, o++, mx, live);
    put(bg_p, bg_n, o, cc, live);
    if (compact) {
      put(bg2_p, bg2_n, at * 2, merge(a, mx), live);
      put(bg2_p, bg2_n, at * 2 + 1, cc, live);
    }
  }
};

}  // namespace
