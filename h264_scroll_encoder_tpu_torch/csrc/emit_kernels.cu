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
//   - Emulation prevention (K1).  `emulation_prevention` below, over the
//     packed words: the NAL is assembled in shared memory over the dead
//     staging area and written out with 16-byte stores.
// Six barriers per 720p session for K1, three for K2/K4.  Measured as
// device time at 720p splice shapes, B = 256 (PERF.md): K1 runs at ~1.8x
// the time its int64 bytes need at the card's memory rate and within 7% of
// K2 (the pack alone), so the pack stage sets its time; int32 symbols
// instead of int64 save 6-8% (K1) and 26-27% (K2).  The rest is the
// staging wait, scan, pack and copy-out of one wave of blocks in a row,
// with nothing to overlap them but the other block on the same SM.  One
// call on an idle card takes several times longer: the host's time to
// issue it, not the kernel, bounds that.
//
// What bounds K3.  At 720p a session reads its valid RBSP bytes (5,602 of
// an 8,192-byte budget on average) and writes an 8,224-byte NAL: ~3.5 MB
// a call at B = 256, ~1.1 us at the card's memory rate (chip_smoke.py
// counts it from each run's lengths).  Its work per byte is a few integer
// operations, and
// B = 256 blocks are one wave, so again a session's time is a chain of
// latencies: load round trips and barriers.
//
// This design (kPackThreads threads per session, like K1):
//   - Staging.  The session's min(rbsp_len, row bytes, padded) bytes are
//     copied into shared memory at once: 16-byte cp.async copies where the
//     row and the staging area share their alignment (the staging area is
//     offset by the row start's address mod 16, so rows of any stride
//     qualify), single bytes for the head and tail.  One wait, one barrier.
//     The row is read in place with its stride (the wrapper copies
//     nothing); bytes past the row up to rbsp_len read as zeros, as the
//     JAX wrapper's zero pad makes them.
//   - Emulation prevention, shared with K1: `emulation_prevention`, a
//     template over the byte accessor (K1: MSB-first packed words; K3:
//     staged bytes) and the window rule (K1: 16 words; K3: 64 bytes).
//     Each thread owns a contiguous run of bytes, ceil(valid / threads)
//     made odd (11 at 720p) so that neighbouring threads' runs fall into
//     different shared-memory banks.  Its last nonzero byte, one block
//     max-scan, a serial insertion count, one block sum-scan, a serial
//     scatter into the NAL in shared memory.  Every NAL position from 5 up
//     to the escaped payload's end is written once, so nothing is zeroed
//     first.
//   - Copy-out.  The prefix, the payload, then K3's 0x03 fill and the zeros
//     after it are derived in the store loop: 16-byte stores where n_nal is
//     a multiple of 16, 4-byte where it is a multiple of 4, else bytes.
// Four barriers per session, ~17 KB of shared memory at 720p (several
// blocks per SM).  Measured (PERF.md): 1.8x less device time than the
// first design at 720p, B = 256, and still ~8x the time its bytes need:
// one session alone takes two thirds of a B = 256 call, so the chain
// (the length read, then the staged copy it sizes, four barriers, three
// serial passes) sets the time, not the bytes.
//
// Plain C interface (bound with ctypes): each entry launches on the given
// stream, allocates nothing, and returns cudaGetLastError() of its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// Zero-run window of K1's bounded emulation prevention, in 4-byte words.
constexpr int kWindowWords = 16;

// Threads per block of all the kernels, set by the build (_kernels.py
// holds the one value); the K1 and K2/K4 wrappers pass the symbols per
// thread, k.
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

// 16-byte asynchronous copy from global to shared memory; both addresses
// 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
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

// Byte i of the RBSP, for the emulation-prevention stage.  K1 reads its
// MSB-first packed words; K3 its staged bytes, zero from byte n on.
struct PackedBytes {
  const uint32_t* words;
  __device__ __forceinline__ int operator()(int i) const {
    return (int)((words[i >> 2] >> (24 - 8 * (i & 3))) & 0xffu);
  }
};

struct StagedBytes {
  const uint8_t* bytes;
  int n;
  __device__ __forceinline__ int operator()(int i) const { return i < n ? bytes[i] : 0; }
};

// The window rules of the stage: whether byte i (of value `byte`, with the
// last nonzero byte before it at `last`, -1 if none) takes a 0x03 before
// it; `sat` is set where the rule cannot resolve its zero run.
//
// K1's 16-word window: byte i is unresolved iff (i >> 2) > 16 and its zero
// run t >= 64 + (i & 3); an unresolved byte never inserts and saturates
// the stream.
struct WordWindow {
  __device__ __forceinline__ bool operator()(int i, int last, int byte, int& sat) const {
    const int t = i - 1 - last;
    const bool unresolved = (i >> 2) > kWindowWords && t >= 4 * kWindowWords + (i & 3);
    sat |= unresolved;
    return byte <= 3 && t >= 2 && (t & 1) == 0 && !unresolved;
  }
};

// K3's zero-run window in bytes (h264_scroll_encoder_tpu ops/ebsp
// ZERO_RUN_WINDOW): byte i is resolved iff a nonzero byte lies before it
// at most 64 back; otherwise t = min(i, 255), the insertion test still
// applies with that t, and the stream saturates where i > 64.
constexpr int kZeroRunWindow = 64;

struct ByteWindow {
  __device__ __forceinline__ bool operator()(int i, int last, int byte, int& sat) const {
    const bool found = last >= 0 && i - last <= kZeroRunWindow;
    const int t = found ? i - 1 - last : min(i, 255);
    sat |= !found && i > kZeroRunWindow;
    return byte <= 3 && t >= 2 && (t & 1) == 0;
  }
};

// The emulation-prevention stage of K1 and K3 over one session's `valid`
// RBSP bytes, `per` to a thread (a contiguous run each).  Byte i lands in
// the NAL at 5 + i + (insertions up to and including i), and an inserting
// byte leaves 0x03 in the hole before it, so every position from 5 up to
// min(5 + valid + insertions, n_nal) is written exactly once.  Returns the
// insertion count; `sat` gets the block's OR of the rule's flag.  Ends on a
// barrier, so the NAL in shared memory is complete on return.
template <typename ByteAt, typename Rule>
__device__ int emulation_prevention(ByteAt at, Rule rule, int valid, int per, uint8_t* nal,
                                    int n_nal, int* tmp_max, int* tmp_sum, int& sat) {
  const int b0 = min((int)threadIdx.x * per, valid);
  const int b1 = min(b0 + per, valid);
  int last = -1;
  for (int i = b1 - 1; i >= b0; --i) {
    if (at(i)) {
      last = i;
      break;
    }
  }
  int before, unused;
  scan_once(last, -1, MaxOp(), tmp_max, before, unused);
  int count = 0;
  int run_sat = 0;
  last = before;
  for (int i = b0; i < b1; ++i) {
    const int byte = at(i);
    count += rule(i, last, byte, run_sat);
    if (byte) last = i;
  }
  int ins_before, ins_total;
  scan_once(count, 0, SumOp(), tmp_sum, ins_before, ins_total);
  last = before;
  int dst = 5 + b0 + ins_before;
  for (int i = b0; i < b1; ++i, ++dst) {
    const int byte = at(i);
    int ignored = 0;
    if (rule(i, last, byte, ignored)) {
      if (dst < n_nal) nal[dst] = 3;
      ++dst;
    }
    if (dst < n_nal) nal[dst] = (uint8_t)byte;
    if (byte) last = i;
  }
  sat = __syncthreads_or(run_sat);
  return ins_total;
}

// Writes one session's n_nal NAL bytes: positions below `fill` from the
// NAL in shared memory, then 0x03 below `end`, then zeros, in stores of
// V.  `nal` is 16-byte aligned and `out` aligned to V.
template <typename V>
__device__ void store_nal(const uint8_t* nal, int fill, int end, int n_nal, uint8_t* out) {
  constexpr int W = sizeof(V);
  for (int c = threadIdx.x; c < n_nal / W; c += kPackThreads) {
    const int k0 = c * W;
    union {
      V v;
      uint8_t b[W];
    } u;
    if (k0 + W <= fill) {
      u.v = reinterpret_cast<const V*>(nal)[c];
    } else {
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const int k = k0 + j;
        u.b[j] = k < fill ? nal[k] : (k < end ? 3 : 0);
      }
    }
    reinterpret_cast<V*>(out)[c] = u.v;
  }
}

// Row s of an output of n_nal-byte rows: 16-byte stores where n_nal is a
// multiple of 16, 4-byte where it is a multiple of 4, single bytes else.
__device__ __forceinline__ void copy_out(const uint8_t* nal, int fill, int end, int n_nal,
                                         uint8_t* nal_out, int s) {
  uint8_t* out = nal_out + (size_t)s * n_nal;
  if ((n_nal & 15) == 0) {
    store_nal<uint4>(nal, fill, end, n_nal, out);
  } else if ((n_nal & 3) == 0) {
    store_nal<uint32_t>(nal, fill, end, n_nal, out);
  } else {
    store_nal<uint8_t>(nal, fill, end, n_nal, out);
  }
}

__device__ __forceinline__ void write_prefix(uint8_t* nal, int n_nal, uint8_t header) {
  const uint8_t prefix[5] = {0, 0, 0, 1, header};
  for (int k = 0; k < min(5, n_nal); ++k) nal[k] = prefix[k];
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

  if (threadIdx.x == 0) {
    const int64_t h = idc ? idc[s * idc_row] : idc_value;
    write_prefix(nal, n_nal, (uint8_t)(((h & 3) << 5) | 1));
  }
  // Whole words of the stream per thread.
  const int rbsp_len = total_bits >> 3;
  const int valid = min(rbsp_len, n_nal);
  const int per = 4 * ((((valid + 3) >> 2) + kPackThreads - 1) / kPackThreads);
  int sat;
  const int ins_total = emulation_prevention(PackedBytes{words}, WordWindow(), valid, per, nal,
                                             n_nal, tmp_max, tmp_sum, sat);
  const int fill = min(5 + valid + ins_total, n_nal);
  copy_out(nal, fill, fill, n_nal, nal_out, s);
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

// A per-session int argument of K3: element s * row of an int32 (bytes 4)
// or int64 (bytes 8) array, row 0 broadcasting one element, or `value`
// where p is null.  Read as int32, as the JAX wrapper casts it.
struct SessionInt {
  const void* p;
  long long row;
  int bytes;
  int value;
  __device__ __forceinline__ int at(int s) const {
    if (p == nullptr) return value;
    return bytes == 8 ? (int)static_cast<const int64_t*>(p)[s * row]
                      : static_cast<const int32_t*>(p)[s * row];
  }
};

// Bytes of K3's shared memory: the staging area (padded bytes plus up to
// 15 of alignment offset), then the NAL.
__host__ __device__ __forceinline__ int ebsp_stage_bytes(int padded) { return padded + 16; }

// Bytes each thread of K3 owns for a session of `valid` bytes: ceil(valid /
// threads), made odd so that neighbouring threads' runs fall into different
// shared-memory banks.  Exported as h264t_ebsp_items_per_thread.
__host__ __device__ __forceinline__ int ebsp_items_per_thread(int valid) {
  return ((valid + kPackThreads - 1) / kPackThreads) | 1;
}

// K3.  Session s reads row s of `rbsp` (m bytes, `rbsp_row` apart), its
// valid length and NAL header byte, and writes n_nal framed NAL bytes and
// the insertion count: `padded` positions of the stream are considered
// (n_nal rounded up to 128, as the JAX wrapper pads or cuts), those below
// rbsp_len valid, those past the row zero.  The count is the insertions,
// plus max_ins + 1 where the stream saturated; positions from the escaped
// payload's end up to 5 + rbsp_len + count hold 0x03, zeros after, as the
// TPU kernel's expansion leaves them.
__global__ void __launch_bounds__(kPackThreads, 2)
    ebsp_nal_kernel(const uint8_t* __restrict__ rbsp, long long rbsp_row, int m,
                    SessionInt len_arg, SessionInt header_arg, int padded, int n_nal, int max_ins,
                    uint8_t* __restrict__ nal_out, int32_t* __restrict__ total_out) {
  extern __shared__ uint4 pack_smem[];  // 16-byte aligned
  uint8_t* stage = reinterpret_cast<uint8_t*>(pack_smem);
  uint8_t* nal = stage + ebsp_stage_bytes(padded);
  __shared__ int tmp_max[kPackWarps];
  __shared__ int tmp_sum[kPackWarps];
  const int s = blockIdx.x;
  const int t = threadIdx.x;
  const uint8_t* src = rbsp + s * rbsp_row;
  const int len = len_arg.at(s);
  const int valid = max(min(len, padded), 0);
  const int n_load = min(valid, m);

  // Byte i goes to stage[off + i]: the row and the staging area then share
  // their alignment mod 16, and the aligned middle moves in 16-byte copies.
  const int off = (int)(reinterpret_cast<uintptr_t>(src) & 15);
  const int head = min((16 - off) & 15, n_load);
  const int n16 = (n_load - head) >> 4;
  const int tail = head + (n16 << 4);
  for (int c = t; c < n16; c += kPackThreads) {
    cp_async16(stage + off + head + 16 * c, src + head + 16 * c);
  }
  if (t < head) stage[off + t] = src[t];
  if (t < n_load - tail) stage[off + tail + t] = src[tail + t];
  if (t == 0) write_prefix(nal, n_nal, (uint8_t)header_arg.at(s));
  cp_async_wait_all();
  __syncthreads();

  int sat;
  const int ins = emulation_prevention(StagedBytes{stage + off, n_load}, ByteWindow(), valid,
                                       ebsp_items_per_thread(valid), nal, n_nal, tmp_max,
                                       tmp_sum, sat);
  const int count = ins + (sat ? max_ins + 1 : 0);
  const int fill = min(5 + valid + ins, n_nal);
  const int end = (int)min(5LL + len + count, (long long)n_nal);
  copy_out(nal, fill, end, n_nal, nal_out, s);
  if (t == 0) total_out[s] = count;
}

// Opts the kernel in to `bytes` of dynamic shared memory.  A refusal is
// returned and cleared, so that the next launch's cudaGetLastError()
// reports that launch's own error.
cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
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

// K3.  rbsp: [batch, m] bytes with unit column stride and row stride
// rbsp_row; rbsp_len and header as SessionInt (len, len_bytes, len_row,
// len_value, and the same for the header).  Outputs nal_out u8[batch,
// n_nal] and total_out i32[batch].
extern "C" int h264t_ebsp_nal(const uint8_t* rbsp, long long rbsp_row, int m, const void* len,
                              int len_bytes, long long len_row, int len_value, const void* header,
                              int header_bytes, long long header_row, int header_value, int batch,
                              int n_nal, int max_ins, uint8_t* nal_out, int32_t* total_out,
                              void* stream) {
  const bool len_ok = len == nullptr || len_bytes == 4 || len_bytes == 8;
  const bool header_ok = header == nullptr || header_bytes == 4 || header_bytes == 8;
  if (n_nal < 0 || m < 0 || !len_ok || !header_ok) return (int)cudaErrorInvalidValue;
  const int padded = (n_nal + 127) / 128 * 128;  // ops/ebsp_flat.padded_len
  const size_t smem = (size_t)ebsp_stage_bytes(padded) + (size_t)((n_nal + 15) & ~15);
  cudaError_t err = set_smem((const void*)ebsp_nal_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ebsp_nal_kernel<<<batch, kPackThreads, smem, (cudaStream_t)stream>>>(
      rbsp, rbsp_row, m, SessionInt{len, len_row, len_bytes, len_value},
      SessionInt{header, header_row, header_bytes, header_value}, padded, n_nal, max_ins, nal_out,
      total_out);
  return (int)cudaGetLastError();
}

// K3's bytes per thread for a session of `valid` bytes, as the kernel
// computes them (ops/ebsp_flat.items_per_thread is held to this on the card).
extern "C" int h264t_ebsp_items_per_thread(int valid) { return ebsp_items_per_thread(valid); }

extern "C" int h264t_pack_words(const void* pat, const void* nb, int sym_bytes, long long pat_row,
                                long long nb_row, int batch, int n, int k, int n_words,
                                int64_t* words_out, int64_t* total_out, void* stream) {
  return h264t_pack_place(pat, nb, sym_bytes, pat_row, nb_row, batch, n, k, n_words, words_out,
                          total_out, stream);
}
