// Hand-written Hopper (sm_90a) kernels of the scroll composer's emit back end.
//
// K1  h264t_emit_fused  — replaces h264_scroll_encoder_tpu/ops/emit_fused.py
//     `_emit_kernel` (launched by `emit_nal_fused_batch`): I_PCM alignment
//     resolution, rbsp_trailing_bits, MSB-first bit pack, bounded emulation
//     prevention and Annex-B framing of one slice per session.
// K2  h264t_pack_place  — replaces h264_scroll_encoder_tpu/ops/bitpack_flat.py
//     `_pack_kernel3` / `_place_kernel` (behind `pack_words_place_pallas`):
//     the bit pack alone, for the staged exact-EBSP retry path.
// K3  h264t_ebsp_nal    — replaces h264_scroll_encoder_tpu/ops/ebsp_flat.py
//     `_ebsp_kernel` (behind `rbsp_to_nal_pallas`): bounded emulation
//     prevention with a 64-byte zero-run window and Annex-B framing of
//     RBSP bytes.
// K4  h264t_pack_words  — replaces h264_scroll_encoder_tpu/ops/bitpack_flat.py
//     `_pack_kernel` (behind `pack_words_pallas`, a merge-tree pack with
//     K2's output): the same block as K2 behind its own entry point and
//     launch counter.
//
// What bounds K1 and K2/K4 on an H100.  At 720p a session reads 9,219
// (pattern, nbits) symbols — 147 KB as the symbol stage hands them (int64),
// 74 KB as int32 — and writes an 8 KB NAL (K1) or 16 KB of int64 words
// (K2/K4); everything in between stays in shared memory.  With one block
// per session and B = 256 the grid is one wave on 132 SMs, so a session's
// time is a chain of latencies: global-load round trips and block-wide
// barriers.  The first design walked the session in tiles of 1,024 (load ->
// block scan -> place with one shared atomic per symbol), then the bytes in
// tiles of 1,024 with two block scans each: 10 serial load round trips and
// ~50 barriers per session, and its wrappers converted the int64 symbols to
// int32 in a pass of their own first.
//
// This design (kPackThreads = 512 threads per session, two blocks per SM;
// the build sets it from _kernels.PACK_THREADS):
//   - Staging.  The session's symbols, k per thread as the wrapper chooses
//     (ops/emit_fused.items_per_thread: ceil(n / 512), at most 24, so 12,288
//     per chunk; one chunk at 720p), are copied into shared memory
//     by 4-byte cp.async copies issued all at once: the low word of each
//     int64 or int32 element, so the kernel reads the symbol stage's int64
//     tensors in place and nothing converts them first.  One wait, one
//     barrier.
//   - Pack.  Each thread owns a contiguous run of k = ceil(n / 512) symbols
//     (19 at 720p; odd k reads shared memory without bank conflicts).  It
//     composes its run's position map serially; one block scan (one
//     barrier) gives each run its start bit; the thread packs its run in a
//     64-bit register window and stores the words that lie wholly inside
//     its run with plain shared stores, OR-ing atomically only the <= 2
//     words it shares with its neighbours.
//   - Emulation prevention (K1).  Each thread owns a contiguous run of RBSP
//     words: its last nonzero byte, one block max-scan, a serial insertion
//     count, one block sum-scan, then a serial scatter into the NAL, which
//     is assembled in shared memory over the dead staging area and written
//     out with 16-byte stores.
// Six barriers per 720p session for K1, three for K2/K4.  K3 keeps the
// first design.  Measured as device time at 720p splice shapes, B = 256
// (PERF.md): K1 runs at ~1.8x the time its int64 bytes need at the card's
// memory rate and within 7% of K2 (the pack alone), so the pack stage sets
// its time; int32 symbols instead of int64 save 6-8% (K1) and 26-27% (K2).
// The rest is the staging wait, scan, pack and copy-out of one wave of
// blocks in a row, with nothing to overlap them but the other block on the
// same SM.  One call on an idle card takes several times longer: the
// host's time to issue it, not the kernel, bounds that.
//
// Plain C interface (bound with ctypes): each entry launches on the given
// stream, allocates nothing, and returns cudaGetLastError() of its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// Zero-run window of K1's bounded emulation prevention, in 4-byte words.
constexpr int kWindowWords = 16;

// Threads per block of K1 and K2/K4, set by the build (_kernels.py holds
// the one value); the wrappers pass the symbols per thread, k.
#ifndef H264T_PACK_THREADS
#error "build with -DH264T_PACK_THREADS=<threads> (h264_scroll_encoder_tpu_torch/_kernels.py)"
#endif
constexpr int kPackThreads = H264T_PACK_THREADS;
static_assert(kPackThreads % 32 == 0 && kPackThreads <= 1024, "whole warps, one block");
constexpr int kPackWarps = kPackThreads / 32;

// The position map of a run of symbols, pos -> has ? ceil8(pos + a) + b
// : pos + a.  A symbol of width w is (0, w, 0); an I_PCM alignment
// sentinel (negative width under `align`) rounds the position up to a byte
// boundary and is (1, 0, 0).  The family is closed under composition, so
// one block scan gives every symbol's bit position with the alignment
// slots resolved to (-pos) mod 8 bits.
struct PosMap {
  int has;
  int a;
  int b;
};

__device__ __forceinline__ int ceil8(int x) { return (x + 7) & ~7; }

__device__ __forceinline__ int apply_map(PosMap f, int pos) {
  return f.has ? ceil8(pos + f.a) + f.b : pos + f.a;
}

struct ComposeOp {  // f first, then g
  __device__ __forceinline__ PosMap operator()(PosMap f, PosMap g) const {
    if (!g.has) return f.has ? PosMap{1, f.a, f.b + g.a} : PosMap{0, f.a + g.a, 0};
    if (!f.has) return PosMap{1, f.a + g.a, g.b};
    return PosMap{1, f.a, ceil8(f.b + g.a) + g.b};
  }
};

struct SumOp {
  __device__ __forceinline__ int operator()(int x, int y) const { return x + y; }
};

struct MaxOp {
  __device__ __forceinline__ int operator()(int x, int y) const { return x > y ? x : y; }
};

__device__ __forceinline__ int shfl_up(int x, int o) { return __shfl_up_sync(kFull, x, o); }

__device__ __forceinline__ PosMap shfl_up(PosMap x, int o) {
  return PosMap{__shfl_up_sync(kFull, x.has, o), __shfl_up_sync(kFull, x.a, o),
                __shfl_up_sync(kFull, x.b, o)};
}

// Block-wide scan of one value per thread: inclusive and exclusive prefixes
// in thread order and the block total.  Every thread of the block must call
// it; `tmp` holds 32 elements of shared memory.
template <typename T, typename Op>
__device__ void block_scan(T v, T ident, Op op, T* tmp, T& excl, T& incl, T& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    T u = shfl_up(x, o);
    if (lane >= o) x = op(u, x);
  }
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = lane < n_warps ? tmp[lane] : ident;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      T u = shfl_up(w, o);
      if (lane >= o) w = op(u, w);
    }
    tmp[lane] = w;
  }
  __syncthreads();
  const T warp_prefix = warp > 0 ? tmp[warp - 1] : ident;
  T xe = shfl_up(x, 1);
  if (lane == 0) xe = ident;
  incl = op(warp_prefix, x);
  excl = op(warp_prefix, xe);
  total = tmp[n_warps - 1];
  __syncthreads();  // tmp is reused by the next scan
}

__device__ __forceinline__ int shfl_idx(int x, int src) { return __shfl_sync(kFull, x, src); }

__device__ __forceinline__ PosMap shfl_idx(PosMap x, int src) {
  return PosMap{__shfl_sync(kFull, x.has, src), __shfl_sync(kFull, x.a, src),
                __shfl_sync(kFull, x.b, src)};
}

// Exclusive block scan of one value per thread of a kPackThreads block,
// with one barrier: every warp scans the warp totals itself.  `tmp` holds
// kPackWarps elements and serves one scan between two other barriers.
template <typename T, typename Op>
__device__ __forceinline__ void scan_once(T v, T ident, Op op, T* tmp, T& excl, T& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    T u = shfl_up(x, o);
    if (lane >= o) x = op(u, x);
  }
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  T w = lane < kPackWarps ? tmp[lane] : ident;
#pragma unroll
  for (int o = 1; o < kPackWarps; o <<= 1) {
    T u = shfl_up(w, o);
    if (lane >= o) w = op(u, w);
  }
  const T before = shfl_idx(w, warp > 0 ? warp - 1 : 0);
  total = shfl_idx(w, kPackWarps - 1);
  T xe = shfl_up(x, 1);
  if (lane == 0) xe = ident;
  excl = warp > 0 ? op(before, xe) : xe;
}

// 4-byte asynchronous copy from global to shared memory (sm_80+).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ PosMap symbol_map(int w, bool align, int& bad) {
  if (w >= 0) return PosMap{0, w, 0};
  if (align) return PosMap{1, 0, 0};
  bad = 1;  // a sentinel without `align` is out of contract: zero bits, flagged
  return PosMap{0, 0, 0};
}

// One packed word of a run whose bits are [lo, hi): a plain store when the
// word lies wholly inside the run, an atomic OR when a neighbour shares it.
// The words start zeroed, so zero words are skipped; bits past n_words drop.
__device__ __forceinline__ void put_word(uint32_t* words, int n_words, int k, uint32_t v, int lo,
                                         int hi) {
  if (v == 0 || k >= n_words) return;
  if ((k << 5) >= lo && (k << 5) + 32 <= hi) {
    words[k] = v;
  } else {
    atomicOr(&words[k], v);
  }
}

// Packs one thread's run of k staged symbols, MSB first, into the words;
// the run's bits are [pos, end).  Mirrors ops/bitpack.pack_words symbol for
// symbol: the low min(w, 32) bits of each pattern, an alignment sentinel
// as (-pos) mod 8 bits of its pattern under `align` and as none without.
__device__ void place_run(const uint32_t* sp, const int32_t* sn, int k, bool align, int pos,
                          int end, uint32_t* words, int n_words) {
  const int lo = pos;
  int wi = pos >> 5;
  uint64_t win = 0;  // words wi and wi + 1
  for (int j = 0; j < k; ++j) {
    const int w = sn[j];
    const int next = w >= 0 ? pos + w : (align ? ceil8(pos) : pos);
    const int width = min(next - pos, 32);
    if (width > 0) {
      while ((pos >> 5) > wi) {
        put_word(words, n_words, wi, (uint32_t)(win >> 32), lo, end);
        win <<= 32;
        ++wi;
      }
      uint32_t p = sp[j];
      if (width < 32) p &= (1u << width) - 1u;
      win |= (uint64_t)p << (64 - (pos - (wi << 5)) - width);
    }
    pos = next;
  }
  put_word(words, n_words, wi, (uint32_t)(win >> 32), lo, end);
  put_word(words, n_words, wi + 1, (uint32_t)win, lo, end);
}

// Bytes of the staging area (and, for K1, of the NAL that reuses it).
__host__ __device__ __forceinline__ int staging_bytes(int k, int n_nal) {
  const int stage = 8 * kPackThreads * k;
  const int nal = (n_nal + 15) & ~15;
  return stage > nal ? stage : nal;
}

// Packs one session's row of n symbols (int32 or int64 elements, of which
// the low 32 bits are read) into the zeroed shared words and returns the
// total bit count; `bad` is set where a sentinel arrives without `align`.
// Chunks of kPackThreads * k symbols are staged in turn (one at 720p).
template <typename Sym>
__device__ int pack_session(const Sym* __restrict__ pat, const Sym* __restrict__ nb, int n, int k,
                            bool align, uint32_t* spat, int32_t* snb, uint32_t* words,
                            int n_words, PosMap* tmp, int& bad) {
  const int chunk = kPackThreads * k;
  const int r0 = threadIdx.x * k;
  int carry = 0;
  for (int base = 0; base < n; base += chunk) {
    if (base > 0) __syncthreads();  // the previous chunk is placed
    for (int j = 0; j < k; ++j) {
      const int c = j * kPackThreads + threadIdx.x;  // coalesced
      if (base + c < n) {
        cp_async4(&spat[c], &pat[base + c]);
        cp_async4(&snb[c], &nb[base + c]);
      } else {
        spat[c] = 0;
        snb[c] = 0;
      }
    }
    cp_async_wait_all();
    __syncthreads();
    PosMap m{0, 0, 0};
    for (int j = 0; j < k; ++j) m = ComposeOp()(m, symbol_map(snb[r0 + j], align, bad));
    PosMap excl, total;
    scan_once(m, PosMap{0, 0, 0}, ComposeOp(), tmp, excl, total);
    const int start = apply_map(excl, carry);
    place_run(spat + r0, snb + r0, k, align, start, apply_map(m, start), words, n_words);
    carry = apply_map(total, carry);
  }
  if (n <= 0) __syncthreads();  // the words are zeroed before anything is placed
  return carry;
}

__device__ __forceinline__ int rbsp_byte(const uint32_t* words, int i) {
  return (int)((words[i >> 2] >> (24 - 8 * (i & 3))) & 0xffu);
}

template <typename Sym>
__global__ void __launch_bounds__(kPackThreads, 2)
    emit_fused_kernel(const Sym* __restrict__ pat, const Sym* __restrict__ nb, long long pat_row,
                      long long nb_row, const int64_t* __restrict__ idc, long long idc_row,
                      int idc_value, int n, int k, int n_nal, int n_rbsp, int cap, int align,
                      int append_tb, uint8_t* __restrict__ nal_out, int32_t* __restrict__ len_out,
                      int32_t* __restrict__ bits_out, uint8_t* __restrict__ ovf_out) {
  extern __shared__ uint4 pack_smem[];  // 16-byte aligned
  uint8_t* smem = reinterpret_cast<uint8_t*>(pack_smem);
  __shared__ PosMap tmp_map[kPackWarps];
  __shared__ int tmp_max[kPackWarps];
  __shared__ int tmp_sum[kPackWarps];
  const int s = blockIdx.x;
  const int n_words = n_nal >> 2;  // the RBSP buffer holds n_nal bytes
  uint32_t* spat = reinterpret_cast<uint32_t*>(smem);
  int32_t* snb = reinterpret_cast<int32_t*>(smem + 4 * kPackThreads * k);
  uint8_t* nal = smem;  // reuses the staging area once the words are packed
  uint32_t* words = reinterpret_cast<uint32_t*>(smem + staging_bytes(k, n_nal));

  for (int i = threadIdx.x; i < n_words; i += kPackThreads) words[i] = 0;
  int bad = 0;
  int total_bits = pack_session(pat + s * pat_row, nb + s * nb_row, n, k, align != 0, spat, snb,
                                words, n_words, tmp_map, bad);
  if (append_tb) {  // rbsp_trailing_bits: a stop bit, zeros to the byte
    const int w = 1 + ((8 - ((total_bits + 1) & 7)) & 7);
    const int w0 = total_bits >> 5;
    const uint64_t v = (uint64_t)(1u << (w - 1)) << (64 - (total_bits & 31) - w);
    if (threadIdx.x == 0 && w0 < n_words) atomicOr(&words[w0], (uint32_t)(v >> 32));
    if (threadIdx.x == 0 && (uint32_t)v && w0 + 1 < n_words) atomicOr(&words[w0 + 1], (uint32_t)v);
    total_bits += w;
  }
  bad = __syncthreads_or(bad);  // the words are packed; the staging area is free

  uint4* nal4 = reinterpret_cast<uint4*>(nal);
  for (int i = threadIdx.x; i < (n_nal + 15) >> 4; i += kPackThreads) nal4[i] = make_uint4(0, 0, 0, 0);
  if (threadIdx.x == 0) {
    const int64_t h = idc ? idc[s * idc_row] : idc_value;
    nal[3] = 1;
    nal[4] = (uint8_t)(((h & 3) << 5) | 1);
  }

  // Emulation prevention + framing over this thread's whole words of the
  // stream: byte i lands at 5 + i + (insertions up to and including i),
  // and an inserting byte leaves 0x03 in the hole before it.  t, the zero
  // run before byte i, is i - 1 - (last nonzero index before i).
  const int rbsp_len = total_bits >> 3;
  const int valid = min(rbsp_len, n_nal);
  const int per = 4 * ((((valid + 3) >> 2) + kPackThreads - 1) / kPackThreads);
  const int b0 = min((int)threadIdx.x * per, valid);
  const int b1 = min(b0 + per, valid);
  int last = -1;
  for (int i = b1 - 1; i >= b0; --i) {
    if (rbsp_byte(words, i)) {
      last = i;
      break;
    }
  }
  int before, unused;
  scan_once(last, -1, MaxOp(), tmp_max, before, unused);
  int count = 0;
  int sat = 0;
  last = before;
  for (int i = b0; i < b1; ++i) {
    const int byte = rbsp_byte(words, i);
    const int t = i - 1 - last;
    const bool unresolved = (i >> 2) > kWindowWords && t >= 4 * kWindowWords + (i & 3);
    count += byte <= 3 && t >= 2 && (t & 1) == 0 && !unresolved;
    sat |= unresolved;
    if (byte) last = i;
  }
  int ins_before, ins_total;
  scan_once(count, 0, SumOp(), tmp_sum, ins_before, ins_total);
  last = before;
  int dst = 5 + b0 + ins_before;
  for (int i = b0; i < b1; ++i, ++dst) {
    const int byte = rbsp_byte(words, i);
    const int t = i - 1 - last;
    const bool unresolved = (i >> 2) > kWindowWords && t >= 4 * kWindowWords + (i & 3);
    if (byte <= 3 && t >= 2 && (t & 1) == 0 && !unresolved) {
      if (dst < n_nal) nal[dst] = 3;
      ++dst;
    }
    if (byte) {
      if (dst < n_nal) nal[dst] = (uint8_t)byte;
      last = i;
    }
  }
  sat = __syncthreads_or(sat);  // also orders the NAL bytes before the copy-out

  uint8_t* out = nal_out + (size_t)s * n_nal;
  if ((n_nal & 15) == 0) {
    uint4* out4 = reinterpret_cast<uint4*>(out);
    for (int i = threadIdx.x; i < n_nal >> 4; i += kPackThreads) out4[i] = nal4[i];
  } else {
    uint32_t* out1 = reinterpret_cast<uint32_t*>(out);
    const uint32_t* nal1 = reinterpret_cast<const uint32_t*>(nal);
    for (int i = threadIdx.x; i < n_words; i += kPackThreads) out1[i] = nal1[i];
  }
  if (threadIdx.x == 0) {
    const int ins_eff = ins_total + (sat ? cap + 1 : 0);
    len_out[s] = 5 + rbsp_len + ins_eff;
    bits_out[s] = total_bits;
    ovf_out[s] = (total_bits > n_rbsp * 8 || ins_eff > cap || bad) ? 1 : 0;
  }
}

template <typename Sym>
__global__ void __launch_bounds__(kPackThreads, 2)
    pack_place_kernel(const Sym* __restrict__ pat, const Sym* __restrict__ nb, long long pat_row,
                      long long nb_row, int n, int k, int n_words,
                      int64_t* __restrict__ words_out, int64_t* __restrict__ total_out) {
  extern __shared__ uint4 pack_smem[];  // 16-byte aligned
  uint8_t* smem = reinterpret_cast<uint8_t*>(pack_smem);
  __shared__ PosMap tmp_map[kPackWarps];
  const int s = blockIdx.x;
  uint32_t* spat = reinterpret_cast<uint32_t*>(smem);
  int32_t* snb = reinterpret_cast<int32_t*>(smem + 4 * kPackThreads * k);
  uint32_t* words = reinterpret_cast<uint32_t*>(smem + staging_bytes(k, 0));
  for (int i = threadIdx.x; i < n_words; i += kPackThreads) words[i] = 0;
  int bad = 0;
  const int total_bits = pack_session(pat + s * pat_row, nb + s * nb_row, n, k, false, spat,
                                      snb, words, n_words, tmp_map, bad);
  __syncthreads();
  int64_t* out = words_out + (size_t)s * n_words;
  for (int i = threadIdx.x; i < n_words; i += kPackThreads) out[i] = (int64_t)words[i];
  if (threadIdx.x == 0) total_out[s] = total_bits;
}

__device__ __forceinline__ void zero_words(uint32_t* words, int n_words) {
  for (int k = threadIdx.x; k < n_words; k += blockDim.x) words[k] = 0;
  __syncthreads();
}

// K3's zero-run window in bytes (h264_scroll_encoder_tpu ops/ebsp
// ZERO_RUN_WINDOW): a byte whose last nonzero predecessor lies further
// back is unresolved.
constexpr int kZeroRunWindow = 64;

// One session's RBSP bytes (the first `padded` of them are read; bytes at
// or past rbsp_len count as zero) -> framed NAL bytes and the insertion
// count.  Byte i lands at 5 + i + (insertions up to and including i); an
// inserting byte leaves 0x03 in the hole before it.  t, the zero run before
// byte i, comes from an exact max-scan of the last nonzero index; where
// that index lies more than kZeroRunWindow back (or there is none) the
// window rule applies: t = min(i, 255), and past byte kZeroRunWindow such a
// byte marks the stream saturated, which adds max_ins + 1 to the count.
// Positions from the last byte up to 5 + rbsp_len + count hold 0x03 and
// the rest zeros, exactly as the TPU kernel's expansion leaves them.
__global__ void __launch_bounds__(kThreads)
    ebsp_nal_kernel(const uint8_t* __restrict__ rbsp, const int32_t* __restrict__ rbsp_len,
                    const int32_t* __restrict__ header, int padded, int n_nal, int max_ins,
                    uint8_t* __restrict__ nal_out, int32_t* __restrict__ total_out) {
  extern __shared__ uint32_t smem[];
  __shared__ int tmp_int[32];
  const int s = blockIdx.x;
  uint8_t* nal = reinterpret_cast<uint8_t*>(smem);
  zero_words(smem, (n_nal + 3) >> 2);
  const uint8_t* in = rbsp + (size_t)s * padded;
  const int len = rbsp_len[s];
  const int valid_len = max(min(len, padded), 0);
  int last_nz = -1;
  int ins_carry = 0;
  int sat = 0;
  for (int base = 0; base < valid_len; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const bool valid = i < valid_len;
    const int byte = valid ? (int)in[i] : 0;
    int excl, incl, total;
    block_scan((valid && byte != 0) ? i : -1, -1, MaxOp(), tmp_int, excl, incl, total);
    const int last = max(excl, last_nz);
    last_nz = max(total, last_nz);
    const bool found = last >= 0 && i - last <= kZeroRunWindow;
    const int t = found ? i - last - 1 : min(i, 255);
    sat |= valid && !found && i > kZeroRunWindow;
    const int ins = valid && byte <= 3 && t >= 2 && (t & 1) == 0;
    block_scan(ins, 0, SumOp(), tmp_int, excl, incl, total);
    const int dst = 5 + i + ins_carry + incl;
    if (valid && dst < n_nal) nal[dst] = (uint8_t)byte;
    if (ins && dst - 1 < n_nal) nal[dst - 1] = 3;
    ins_carry += total;
  }
  sat = __syncthreads_or(sat);
  const int count = ins_carry + (sat ? max_ins + 1 : 0);
  const int end = min(5 + len + count, n_nal);
  for (int k = 5 + valid_len + ins_carry + threadIdx.x; k < end; k += blockDim.x) nal[k] = 3;
  if (threadIdx.x < min(5, n_nal)) {
    const uint8_t prefix[4] = {0, 0, 0, 1};
    nal[threadIdx.x] = threadIdx.x < 4 ? prefix[threadIdx.x] : (uint8_t)header[s];
  }
  __syncthreads();
  uint8_t* out = nal_out + (size_t)s * n_nal;
  for (int k = threadIdx.x; k < n_nal; k += blockDim.x) out[k] = nal[k];
  if (threadIdx.x == 0) total_out[s] = count;
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}


template <typename Sym>
cudaError_t launch_emit(const void* pat, const void* nb, long long pat_row, long long nb_row,
                        const int64_t* idc, long long idc_row, int idc_value, int batch, int n,
                        int k, int n_nal, int n_rbsp, int cap, int align, int append_tb,
                        uint8_t* nal_out, int32_t* len_out, int32_t* bits_out,
                        uint8_t* ovf_out, cudaStream_t stream) {
  const size_t smem = (size_t)staging_bytes(k, n_nal) + (size_t)n_nal;  // + RBSP words
  cudaError_t err = set_smem((const void*)emit_fused_kernel<Sym>, smem);
  if (err != cudaSuccess) return err;
  emit_fused_kernel<Sym><<<batch, kPackThreads, smem, stream>>>(
      static_cast<const Sym*>(pat), static_cast<const Sym*>(nb), pat_row, nb_row, idc, idc_row,
      idc_value, n, k, n_nal, n_rbsp, cap, align, append_tb, nal_out, len_out, bits_out, ovf_out);
  return cudaGetLastError();
}

template <typename Sym>
cudaError_t launch_pack(const void* pat, const void* nb, long long pat_row, long long nb_row,
                        int batch, int n, int k, int n_words, int64_t* words_out,
                        int64_t* total_out, cudaStream_t stream) {
  const size_t smem = (size_t)staging_bytes(k, 0) + 4 * (size_t)n_words;
  cudaError_t err = set_smem((const void*)pack_place_kernel<Sym>, smem);
  if (err != cudaSuccess) return err;
  pack_place_kernel<Sym><<<batch, kPackThreads, smem, stream>>>(
      static_cast<const Sym*>(pat), static_cast<const Sym*>(nb), pat_row, nb_row, n, k, n_words,
      words_out, total_out);
  return cudaGetLastError();
}

}  // namespace

// K1.  pat, nb: [batch, n] rows of int32 (sym_bytes 4) or int64 (8)
// elements with unit column stride and the given row strides, staged k per
// thread (k >= 1); nal_ref_idc is idc[s * idc_row] (int64) or, where idc
// is null, idc_value.  Outputs: nal_out u8[batch, n_nal], len_out,
// bits_out i32[batch], ovf_out bool[batch].  A block that needs more shared
// memory than the card allows fails with the attribute call's error.
extern "C" int h264t_emit_fused(const void* pat, const void* nb, int sym_bytes,
                                long long pat_row, long long nb_row, const int64_t* idc,
                                long long idc_row, int idc_value, int batch, int n, int k,
                                int n_nal, int n_rbsp, int cap, int align, int append_tb,
                                uint8_t* nal_out, int32_t* len_out, int32_t* bits_out,
                                uint8_t* ovf_out, void* stream) {
  if (n_nal < 16 || n_nal % 4 != 0 || k < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (sym_bytes == 8)
    return (int)launch_emit<int64_t>(pat, nb, pat_row, nb_row, idc, idc_row, idc_value, batch, n,
                                     k, n_nal, n_rbsp, cap, align, append_tb, nal_out, len_out,
                                     bits_out, ovf_out, st);
  if (sym_bytes == 4)
    return (int)launch_emit<int32_t>(pat, nb, pat_row, nb_row, idc, idc_row, idc_value, batch, n,
                                     k, n_nal, n_rbsp, cap, align, append_tb, nal_out, len_out,
                                     bits_out, ovf_out, st);
  return (int)cudaErrorInvalidValue;
}

// K2.  pat, nb and k as for K1; outputs words_out i64[batch, n_words]
// (uint32 values) and total_out i64[batch].
extern "C" int h264t_pack_place(const void* pat, const void* nb, int sym_bytes, long long pat_row,
                                long long nb_row, int batch, int n, int k, int n_words,
                                int64_t* words_out, int64_t* total_out, void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (sym_bytes == 8)
    return (int)launch_pack<int64_t>(pat, nb, pat_row, nb_row, batch, n, k, n_words,
                                     words_out, total_out, st);
  if (sym_bytes == 4)
    return (int)launch_pack<int32_t>(pat, nb, pat_row, nb_row, batch, n, k, n_words,
                                     words_out, total_out, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int h264t_ebsp_nal(const uint8_t* rbsp, const int32_t* rbsp_len, const int32_t* header,
                              int batch, int padded, int n_nal, int max_ins, uint8_t* nal_out,
                              int32_t* total_out, void* stream) {
  const size_t smem = 4 * (size_t)((n_nal + 3) / 4);
  cudaError_t err = set_smem((const void*)ebsp_nal_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ebsp_nal_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      rbsp, rbsp_len, header, padded, n_nal, max_ins, nal_out, total_out);
  return (int)cudaGetLastError();
}

extern "C" int h264t_pack_words(const void* pat, const void* nb, int sym_bytes, long long pat_row,
                                long long nb_row, int batch, int n, int k, int n_words,
                                int64_t* words_out, int64_t* total_out, void* stream) {
  return h264t_pack_place(pat, nb, sym_bytes, pat_row, nb_row, batch, n, k, n_words, words_out,
                          total_out, stream);
}
