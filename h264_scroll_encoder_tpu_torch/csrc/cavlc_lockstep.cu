// Hand-written Hopper (sm_90a) probe P4: lockstep CAVLC residual-block
// decode of a batch of donor streams.
//
// P4  h264t_cavlc_lockstep — replaces scripts/cavlc_device_probe.py
//     `make_decoder` (a lax.scan whose step decodes one residual block per
//     donor lane with batched take_along_axis gathers; no Pallas kernel).
//     The contract is that decoder's output, level prefix clamped at 15
//     included (ops/cavlc_lockstep.decode_lockstep_plain is the plain
//     version): for each lane, k blocks of nc0 coeff_token, trailing-one
//     signs, levels (adaptive suffix), luma 4x4 total_zeros and run_before,
//     giving (total_coeff, trailing_ones, sum of levels, total_zeros, sum of
//     runs) a block and the lane's final bit cursor.
//
// What bounds it on an H100.  Not bytes: at the probe's shapes (256 lanes x
// 256 blocks, ~2.4 KB a stream) a call reads ~0.6 MB of streams and writes
// 1.3 MB of results.  A lane is one chain of dependent steps: every peek
// needs the cursor the step before it moved, so a block costs a chain of
// up to 1 (coeff_token) + 1 (signs) + 16 (levels) + 1 (total_zeros) + 15
// (run_before) = 34 dependent peeks, each a load from the lane's row
// followed by a table read and a few integer operations.  The batch is the
// only parallelism: one thread a lane, kLaneThreads = 32 lanes a block, so
// 256 lanes are 8 blocks on 8 of 132 SMs, one warp each.
//
// This design (a simple kernel that is right first):
//   - Tables.  coeff_token is 65,536 uint16 entries (len 5 bits | tc 5 |
//     t1 2): 128 KB, past a block's 48 KB of static shared memory and, with
//     the opt-in, the whole of an SM's shared memory for one block.  It
//     stays in global memory behind __ldg: its working set (the codes a
//     stream uses) stays in the L1 and L2 after the first blocks, and it
//     costs no per-block fill.  total_zeros (15 x 512) and run_before
//     (7 x 2048) are uint8 (len | value << 4), 21.5 KB together, copied
//     into shared memory once a block.
//   - Peek.  The 8 bytes at pos >> 3 of the lane's row, read with __ldg
//     one by one (rows are uncoalesced across lanes; bytes past the row
//     read as zero), assembled into 32 bits at pos & 7.
//   - The JAX body's unrolled `for i in range(16)` and `range(15)` loops
//     become loops that stop where the JAX body's activity masks go false
//     for good (i < tc - t1; i < tc - 1 and zeros left > 0), bounded at 16
//     and 15 as there.  A warp runs as long as its slowest lane.
//
// Plain C interface (bound with ctypes): the entry launches on the given
// stream, allocates nothing, and returns cudaGetLastError() of its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLaneThreads = 32;         // lanes a block
constexpr int kTzEntries = 15 * 512;     // ops/cavlc_lockstep.TZ_PEEK
constexpr int kRbEntries = 7 * 2048;     // ops/cavlc_lockstep.RB_PEEK
static_assert(kTzEntries % 4 == 0 && kRbEntries % 4 == 0, "copied as words");

// One lane's stream: n bytes from p, zeros past them.
struct Row {
  const uint8_t* __restrict__ p;
  int n;

  __device__ __forceinline__ uint32_t byte(int j) const { return j < n ? __ldg(p + j) : 0u; }

  // The 32 bits of the stream from bit `pos` on (MSB first).
  __device__ __forceinline__ uint32_t peek(int pos) const {
    const int j = pos >> 3;
    const uint32_t w0 = (byte(j) << 24) | (byte(j + 1) << 16) | (byte(j + 2) << 8) | byte(j + 3);
    const uint32_t w1 =
        (byte(j + 4) << 24) | (byte(j + 5) << 16) | (byte(j + 6) << 8) | byte(j + 7);
    const int s = pos & 7;
    return s ? (w0 << s) | (w1 >> (32 - s)) : w0;
  }
};

// n (>= 0) bits of pk from bit `off` on; 0 for n = 0 (a shift by 32 is
// undefined in C, which the JAX body's where(n > 0, ...) avoids too).
__device__ __forceinline__ uint32_t bits(uint32_t pk, int off, int n) {
  return n > 0 ? (pk << off) >> (32 - n) : 0u;
}

__global__ void __launch_bounds__(kLaneThreads)
    cavlc_lockstep_kernel(const uint8_t* __restrict__ data, long long row, int nbytes, int batch,
                          int k, const uint16_t* __restrict__ ct,
                          const uint32_t* __restrict__ tz_words,
                          const uint32_t* __restrict__ rb_words, int32_t* __restrict__ end_out,
                          int32_t* __restrict__ out) {
  __shared__ uint32_t tz_s[kTzEntries / 4];
  __shared__ uint32_t rb_s[kRbEntries / 4];
  for (int i = threadIdx.x; i < kTzEntries / 4; i += kLaneThreads) tz_s[i] = __ldg(tz_words + i);
  for (int i = threadIdx.x; i < kRbEntries / 4; i += kLaneThreads) rb_s[i] = __ldg(rb_words + i);
  __syncthreads();
  const uint8_t* tz = reinterpret_cast<const uint8_t*>(tz_s);
  const uint8_t* rb = reinterpret_cast<const uint8_t*>(rb_s);
  const int lane = blockIdx.x * kLaneThreads + threadIdx.x;
  if (lane >= batch) return;
  const Row r{data + lane * row, nbytes};
  int32_t* o = out + (size_t)lane * k * 5;
  int pos = 0;
  for (int blk = 0; blk < k; ++blk) {
    // coeff_token.
    uint32_t pk = r.peek(pos);
    const int rec = __ldg(ct + (pk >> 16));
    const int tc = (rec >> 5) & 31;
    const int t1 = (rec >> 10) & 3;
    pos += rec & 31;
    // Trailing-one signs.
    pk = r.peek(pos);
    int lsum = 0;
    for (int i = 0; i < t1; ++i) lsum += ((pk >> (31 - i)) & 1) ? -1 : 1;
    pos += t1;
    // Levels (adaptive suffix; the prefix clamped at 15, as the JAX body).
    int sl = (tc > 10 && t1 < 3) ? 1 : 0;
    const int n_levels = min(tc - t1, 16);
    for (int i = 0; i < n_levels; ++i) {
      pk = r.peek(pos);
      const int prefix = min(__clz((int)pk), 15);
      int lc = prefix << sl;
      int ssz = sl;
      if (prefix == 14 && sl == 0) ssz = 4;
      if (prefix == 15 && sl == 0) lc += 15;
      if (prefix == 15) ssz = 12;
      lc += (int)bits(pk, prefix + 1, ssz);
      if (i == 0 && t1 < 3) lc += 2;
      const int level = (lc & 1) == 0 ? lc / 2 + 1 : -((lc + 1) / 2);
      lsum += level;
      int sl_new = max(sl, 1);
      if (abs(level) > (3 << (sl_new - 1)) && sl_new < 6) ++sl_new;
      sl = sl_new;
      pos += prefix + 1 + ssz;
    }
    // total_zeros (none where tc is 0 or 16).
    pk = r.peek(pos);
    int zeros = 0;
    if (tc > 0 && tc < 16) {
      const int z = tz[(tc - 1) * 512 + (pk >> 23)];
      zeros = z >> 4;
      pos += z & 15;
    }
    // run_before (zeros left > 7 read class 7).
    int zl = zeros;
    int rsum = 0;
    const int n_runs = min(tc - 1, 15);
    for (int i = 0; i < n_runs && zl > 0; ++i) {
      pk = r.peek(pos);
      const int z = rb[(min(zl, 7) - 1) * 2048 + (pk >> 21)];
      const int run = z >> 4;
      pos += z & 15;
      zl -= run;
      rsum += run;
    }
    int32_t* ob = o + 5 * blk;
    ob[0] = tc;
    ob[1] = t1;
    ob[2] = lsum;
    ob[3] = zeros;
    ob[4] = rsum;
  }
  end_out[lane] = pos;
}

}  // namespace

// P4.  data: [batch, nbytes] stream bytes with unit column stride and row
// stride `row`; k blocks a lane; ct uint16[65,536], tz uint8[7,680] and rb
// uint8[14,336] (ops/cavlc_lockstep.build_luts), tz and rb 4-byte aligned.
// Outputs end_out i32[batch] and out i32[batch, k, 5].
extern "C" int h264t_cavlc_lockstep(const uint8_t* data, long long row, int nbytes, int batch,
                                    int k, const uint16_t* ct, const uint8_t* tz,
                                    const uint8_t* rb, int32_t* end_out, int32_t* out,
                                    void* stream) {
  if (nbytes < 0 || batch < 0 || k < 0 || ((uintptr_t)tz & 3) || ((uintptr_t)rb & 3))
    return (int)cudaErrorInvalidValue;
  const int blocks = (batch + kLaneThreads - 1) / kLaneThreads;
  if (blocks == 0) return (int)cudaSuccess;
  cavlc_lockstep_kernel<<<blocks, kLaneThreads, 0, (cudaStream_t)stream>>>(
      data, row, nbytes, batch, k, ct, reinterpret_cast<const uint32_t*>(tz),
      reinterpret_cast<const uint32_t*>(rb), end_out, out);
  return (int)cudaGetLastError();
}
