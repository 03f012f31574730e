// K8 h264t_compact_nal — a hand-written Hopper (sm_90a) kernel for egress:
// a batch's NAL rows compacted into one dense buffer.  It replaces no
// Pallas kernel: the JAX package computes
// h264_scroll_encoder_tpu/parallel/batch.py `compact_batch_nal` as XLA
// code (a TPU word funnel), which the port ran as about a dozen aten
// kernels a call (a cumsum, an arange and a searchsorted over every
// position of the cap, two gathers, clamps, a where and a cast), each
// streaming int32 arrays as long as the cap.  Its plain version and
// contract: parallel/batch.compact_batch_nal_plain.
//
// Contract: nal u8 rows (row stride `row` bytes, unit column stride), the
// lengths int32 or int64 [batch] (read in place: `len_stride` elements
// apart), a static cap.  packed[:min(total, cap)] is session 0's first
// nal_len[0] bytes, then session 1's, ...; every byte of packed past that
// is zero; total is the lengths' sum (int32), overflow total > cap.
// Lengths are read clamped to [0, n]: the plain version's contract has
// them there, and so no byte outside a row is ever read.
//
// What bounds it on an H100.  A ragged memcpy: the valid bytes read once
// and the cap written once.  At the pooled splice batch (B = 1,024 rows of
// ~10 KB, ~5.6 MB valid, a 10.5 MB cap) that is ~16 MB, ~4.8 us at the
// card's 3.35 TB/s; the lengths (4-8 KB) are noise.
//
// The design:
//   - One launch, nothing around it: the wrapper allocates the outputs
//     with torch.empty and launches on the caller's stream, so a CUDA
//     graph captures the call as one kernel node.
//   - Output-centric tiles.  Block g owns packed[g * tile, (g + 1) * tile)
//     (tile a multiple of 16 bytes, from the wrapper's plan: at least four
//     blocks an SM where the cap allows).  Its threads take the tile's
//     16-byte vectors in turn, so consecutive threads store consecutive
//     aligned vectors.
//   - The scan of the lengths happens in every block.  The lengths are
//     taken in chunks of kChunk sessions; a chunk is one block scan
//     (kScanItems a thread, warp shuffles, then one warp over the warps'
//     sums) whose inclusive offsets, plus the running total of the chunks
//     before, go to shared memory.  A block scans chunks until the running
//     total passes its tile (the last block scans them all, and writes
//     total and overflow), so any batch works.
//   - Each chunk's bytes that fall in the tile are written from that
//     chunk's offsets: a vector finds its first session by one binary
//     search over the chunk's inclusive offsets.  A vector inside one
//     session is built from the one or two aligned 16-byte loads of the
//     row that cover it, by a funnel shift (__funnelshift_r over the
//     words); a vector that crosses a session boundary is assembled byte
//     by byte and stored once; the bytes of a vector that a chunk boundary
//     or the cap cuts are stored singly.  A row may start at any address,
//     and its width need not be a multiple of 4 or 16.
//   - The bytes past total (to the tile's end) are zeroed with the same
//     vector stores.
// An aligned 16-byte load that covers a valid byte never leaves that
// byte's 16-byte granule, so it stays inside the row's allocation; the
// bytes of it past a session's length are discarded.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCompactThreads = 256;
constexpr int kScanItems = 4;                         // lengths a thread scans
constexpr int kChunk = kCompactThreads * kScanItems;  // sessions a chunk
constexpr int kWarps = kCompactThreads / 32;
constexpr int kVec = 16;                              // bytes a vector store

struct CompactArgs {
  const unsigned char* nal;
  long long row;         // row stride, bytes
  int n;                 // a row's width, bytes
  const void* lens;
  long long len_stride;  // elements
  int len_bytes;         // 4 or 8
  int batch;
  int cap;
  int tile;              // bytes a block, a multiple of kVec
  unsigned char* packed;
  int32_t* total;
  unsigned char* overflow;
};

__device__ __forceinline__ int session_length(const CompactArgs& a, int b) {
  long long v;
  if (a.len_bytes == 4) {
    v = __ldg(static_cast<const int32_t*>(a.lens) + a.len_stride * b);
  } else {
    v = __ldg(static_cast<const long long*>(a.lens) + a.len_stride * b);
  }
  return static_cast<int>(v < 0 ? 0 : (v > a.n ? a.n : v));
}

// The 16 bytes at src, from the aligned vector that holds src and, where
// src is not aligned, the next one.
__device__ __forceinline__ uint4 load16(const unsigned char* src) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src);
  const uint4* base = reinterpret_cast<const uint4*>(addr & ~uintptr_t(15));
  const int off = static_cast<int>(addr & 15);
  const uint4 x = __ldg(base);
  if (off == 0) return x;
  const uint4 y = __ldg(base + 1);
  // Words q .. q + 4 of x:y (q = off / 4), then a byte shift of off % 4.
  uint32_t w0 = x.x, w1 = x.y, w2 = x.z, w3 = x.w, w4 = y.x, w5 = y.y;
  if (off & 8) {
    w0 = x.z; w1 = x.w; w2 = y.x; w3 = y.y; w4 = y.z; w5 = y.w;
  }
  if (off & 4) {
    w0 = w1; w1 = w2; w2 = w3; w3 = w4; w4 = w5;
  }
  const int s = 8 * (off & 3);
  return make_uint4(__funnelshift_r(w0, w1, s), __funnelshift_r(w1, w2, s),
                    __funnelshift_r(w2, w3, s), __funnelshift_r(w3, w4, s));
}

// The first index i of incl[0, kChunk) with incl[i] > p (p below
// incl[kChunk - 1]).
__device__ __forceinline__ int upper_bound(const int* incl, int p) {
  int lo = 0, hi = kChunk - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (incl[mid] > p) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// The chunk's state in shared memory: the inclusive offsets of sessions
// c0 .. c0 + kChunk - 1 (past the batch: zero lengths) and the offset of
// session c0.
struct Chunk {
  const int* incl;
  int c0;
  int start;

  __device__ __forceinline__ int begin(int i) const { return i ? incl[i - 1] : start; }

  // The byte of output position pos, session i of the chunk at or before
  // it (advanced to pos's session).
  __device__ __forceinline__ unsigned char byte(const CompactArgs& a, int& i, int pos) const {
    while (incl[i] <= pos) ++i;
    const unsigned char* row = a.nal + a.row * static_cast<long long>(c0 + i);
    return __ldg(row + (pos - begin(i)));
  }
};

// packed[lo, hi): the chunk's sessions' bytes there.  Positions are
// counted in 64 bits, so that a cap near 2**31 cannot wrap them.
__device__ void copy_range(const CompactArgs& a, const Chunk& c, int lo, int hi) {
  for (long long p = (lo & ~(kVec - 1)) + threadIdx.x * kVec; p < hi;
       p += kCompactThreads * kVec) {
    const int q = static_cast<int>(p);
    if (p >= lo && p + kVec <= hi) {
      int i = upper_bound(c.incl, q);
      uint4 v;
      if (q + kVec <= c.incl[i]) {
        const unsigned char* row = a.nal + a.row * static_cast<long long>(c.c0 + i);
        v = load16(row + (q - c.begin(i)));
      } else {
        uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
        for (int k = 0; k < kVec; ++k) w[k >> 2] |= uint32_t(c.byte(a, i, q + k)) << (8 * (k & 3));
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
      *reinterpret_cast<uint4*>(a.packed + q) = v;
    } else {
      const int first = max(q, lo), last = static_cast<int>(min(p + kVec, (long long)hi));
      int i = upper_bound(c.incl, first);
      for (int pos = first; pos < last; ++pos) a.packed[pos] = c.byte(a, i, pos);
    }
  }
}

// packed[lo, hi) = 0.
__device__ void zero_range(const CompactArgs& a, int lo, int hi) {
  for (long long p = (lo & ~(kVec - 1)) + threadIdx.x * kVec; p < hi;
       p += kCompactThreads * kVec) {
    if (p >= lo && p + kVec <= hi) {
      *reinterpret_cast<uint4*>(a.packed + p) = make_uint4(0, 0, 0, 0);
    } else {
      const int last = static_cast<int>(min(p + kVec, (long long)hi));
      for (int pos = max(static_cast<int>(p), lo); pos < last; ++pos) a.packed[pos] = 0;
    }
  }
}

__global__ void __launch_bounds__(kCompactThreads) compact_nal_kernel(const CompactArgs a) {
  __shared__ int s_incl[kChunk];
  __shared__ int s_warp[kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long tile_lo = static_cast<long long>(blockIdx.x) * a.tile;
  const int lo = static_cast<int>(tile_lo);
  const int hi = static_cast<int>(min(tile_lo + a.tile, static_cast<long long>(a.cap)));
  const bool last_block = blockIdx.x == gridDim.x - 1;

  int carry = 0;  // the offset of the chunk's first session
  for (int c0 = 0; c0 < a.batch && (last_block || carry < hi); c0 += kChunk) {
    int pre[kScanItems];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int b = c0 + t * kScanItems + k;
      sum += b < a.batch ? session_length(a, b) : 0;
      pre[k] = sum;
    }
    int x = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
      for (int o = 1; o < kWarps; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      if (lane < kWarps) s_warp[lane] = w;
    }
    __syncthreads();
    const int base = carry + x - sum + (warp ? s_warp[warp - 1] : 0);
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) s_incl[t * kScanItems + k] = base + pre[k];
    __syncthreads();
    const int end = s_incl[kChunk - 1];
    const int from = max(lo, carry), to = min(hi, end);
    if (from < to) copy_range(a, Chunk{s_incl, c0, carry}, from, to);
    carry = end;
    __syncthreads();  // s_incl and s_warp are the next chunk's
  }
  // Here carry >= hi, or carry is the total.
  if (carry < hi) zero_range(a, max(lo, carry), hi);
  if (last_block && t == 0) {
    *a.total = carry;
    *a.overflow = carry > a.cap;
  }
}

}  // namespace

// K8.  nal: batch rows of n bytes, `row` bytes apart (unit column stride);
// lens: int32 (len_bytes 4) or int64 (8) lengths, len_stride elements
// apart; cap >= 0 bytes of packed (16-byte aligned); tile: bytes a block,
// a positive multiple of 16 (parallel/batch.compact_tile); total: int32,
// overflow: one byte.  batch >= 1 and batch * n < 2**31, so that no sum of
// lengths passes int32.  One launch on `stream`.
extern "C" int h264t_compact_nal(const void* nal, long long row, int n, const void* lens,
                                 long long len_stride, int len_bytes, int batch, int cap,
                                 int tile, void* packed, void* total, void* overflow,
                                 void* stream) {
  if (batch < 1 || n < 0 || cap < 0 || (len_bytes != 4 && len_bytes != 8) || lens == nullptr ||
      (n > 0 && nal == nullptr) || static_cast<long long>(batch) * n > INT32_MAX ||
      tile <= 0 || tile % kVec != 0 || total == nullptr || overflow == nullptr ||
      (cap > 0 && (packed == nullptr || reinterpret_cast<uintptr_t>(packed) % kVec != 0)) ||
      reinterpret_cast<uintptr_t>(total) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  CompactArgs a;
  a.nal = static_cast<const unsigned char*>(nal);
  a.row = row;
  a.n = n;
  a.lens = lens;
  a.len_stride = len_stride;
  a.len_bytes = len_bytes;
  a.batch = batch;
  a.cap = cap;
  a.tile = tile;
  a.packed = static_cast<unsigned char*>(packed);
  a.total = static_cast<int32_t*>(total);
  a.overflow = static_cast<unsigned char*>(overflow);
  const long long blocks = cap == 0 ? 1 : (static_cast<long long>(cap) + tile - 1) / tile;
  compact_nal_kernel<<<static_cast<unsigned>(blocks), kCompactThreads, 0,
                       (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
