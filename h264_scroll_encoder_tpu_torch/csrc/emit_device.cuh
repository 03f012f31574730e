// Device code shared by the production kernels (emit_kernels.cu: K1-K4)
// and the measurement probes (probe_kernels.cu: P1-P3, P5/P6), so that a
// probe runs K1's, K2's and K3's own code and not a copy of it.
// Everything here sits in an anonymous namespace: each translation unit
// that includes it gets its own instances.
//
// Five compile-time parameters let a probe cut or reshape that code
// without changing what K1-K4 compile to (their instances take the
// defaults, under which every `if constexpr` branch below drops out):
//   Stage  how far K1's chain runs (emit_session, pack_session): a stage
//          ends in a write that consumes everything computed so far.
//   Group  the threads that serve one session (scan_once, pack_session):
//          the whole block (K1-K4, BlockGroup) or a slice of it with its
//          own named barrier (P3, TileGroup).
//   W      the staged width type of place_run: int32 (K1, K2) or uint8
//          (P2's narrow staging).
//   Variant  K3's emulation-prevention stage (ebsp_session): per-thread
//          runs (K3, kEpRuns), warp ballots (P5, kEpBallot) or the first
//          pass's 16-bit lanes reread (P6, kEpLanes).
//   Lanes  whether emulation_prevention keeps those lanes (false: K1, K3).

#pragma once

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

// How far K1's chain runs (P1, h264t_emit_stage; ops/probes.EMIT_STAGES).
// K1-K4 run kStageFull.
enum : int {
  kStageLaunch = 0,  // nothing: K1's grid and shared memory only
  kStageStage = 1,   // + the cp.async staging of the symbols
  kStageScan = 2,    // + the position scan
  kStagePack = 3,    // + place_run into the words
  kStageEp = 4,      // + trailing bits, prefix, emulation prevention
  kStageFull = 5,    // + copy-out and results: K1
};

// The threads that serve one session: the whole block.
struct BlockGroup {
  static constexpr int kThreads = kPackThreads;
  static constexpr int kWarps = kPackWarps;
  __device__ __forceinline__ int rank() const { return threadIdx.x; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

// Group `id` of kThreads consecutive threads of a block that serves
// kPackThreads / kThreads sessions (P3): its own barrier, `bar.sync` with
// an id and a count (ids 1.. so that id 0 stays __syncthreads'), or the
// warp's where the group is one warp.
template <int Threads>
struct TileGroup {
  static_assert(Threads % 32 == 0 && kPackThreads % Threads == 0, "whole warps");
  static_assert(kPackThreads / Threads <= 15 || Threads == 32, "named barriers 1..15");
  static constexpr int kThreads = Threads;
  static constexpr int kWarps = Threads / 32;
  int id;
  __device__ __forceinline__ int rank() const { return threadIdx.x - id * Threads; }
  __device__ __forceinline__ void sync() const {
    if constexpr (Threads == 32) {
      __syncwarp();
    } else {
      asm volatile("bar.sync %0, %1;\n" ::"r"(id + 1), "r"(Threads) : "memory");
    }
  }
};

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

struct XorOp {
  __device__ __forceinline__ int operator()(int x, int y) const { return x ^ y; }
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

// Exclusive scan of one value per thread of a group (by default the whole
// kPackThreads block), with one barrier: every warp scans the warp totals
// itself.  `tmp` holds G::kWarps elements and serves one scan between two
// other barriers.
template <typename T, typename Op, typename G = BlockGroup>
__device__ __forceinline__ void scan_once(T v, T ident, Op op, T* tmp, T& excl, T& total,
                                          G g = G()) {
  const int lane = g.rank() & 31;
  const int warp = g.rank() >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    T u = shfl_up(x, o);
    if (lane >= o) x = op(u, x);
  }
  if (lane == 31) tmp[warp] = x;
  g.sync();
  T w = lane < G::kWarps ? tmp[lane] : ident;
#pragma unroll
  for (int o = 1; o < G::kWarps; o <<= 1) {
    T u = shfl_up(w, o);
    if (lane >= o) w = op(u, w);
  }
  const T before = shfl_idx(w, warp > 0 ? warp - 1 : 0);
  total = shfl_idx(w, G::kWarps - 1);
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
template <typename W>
__device__ void place_run(const uint32_t* sp, const W* sn, int k, bool align, int pos, int end,
                          uint32_t* words, int n_words) {
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
// Chunks of G::kThreads * k symbols are staged in turn (one at 720p).
// Before kStagePack (P1) nothing is placed: kStageStage XORs each
// thread's staged words into *probe and returns 0, kStageScan XORs each
// thread's start bit into *probe and returns the total.
template <int Stage = kStageFull, typename G = BlockGroup, typename Sym>
__device__ int pack_session(const Sym* __restrict__ pat, const Sym* __restrict__ nb, int n, int k,
                            bool align, uint32_t* spat, int32_t* snb, uint32_t* words,
                            int n_words, PosMap* tmp, int& bad, uint32_t* probe = nullptr,
                            G g = G()) {
  const int chunk = G::kThreads * k;
  const int r0 = g.rank() * k;
  int carry = 0;
  for (int base = 0; base < n; base += chunk) {
    if (base > 0) g.sync();  // the previous chunk is placed
    for (int j = 0; j < k; ++j) {
      const int c = j * G::kThreads + g.rank();  // coalesced
      if (base + c < n) {
        cp_async4(&spat[c], &pat[base + c]);
        cp_async4(&snb[c], &nb[base + c]);
      } else {
        spat[c] = 0;
        snb[c] = 0;
      }
    }
    cp_async_wait_all();
    g.sync();
    if constexpr (Stage == kStageStage) {
      for (int j = 0; j < k; ++j) *probe ^= spat[r0 + j] ^ (uint32_t)snb[r0 + j];
      continue;
    }
    PosMap m{0, 0, 0};
    for (int j = 0; j < k; ++j) m = ComposeOp()(m, symbol_map(snb[r0 + j], align, bad));
    PosMap excl, total;
    scan_once(m, PosMap{0, 0, 0}, ComposeOp(), tmp, excl, total, g);
    const int start = apply_map(excl, carry);
    if constexpr (Stage == kStageScan) {
      *probe ^= (uint32_t)start;
    } else {
      place_run(spat + r0, snb + r0, k, align, start, apply_map(m, start), words, n_words);
    }
    carry = apply_map(total, carry);
  }
  if (n <= 0) g.sync();  // the words are zeroed before anything is placed
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

// K3's row read straight from global memory (its plan past a block's
// shared memory), zero from byte n on.
struct GlobalBytes {
  const uint8_t* __restrict__ bytes;
  int n;
  __device__ __forceinline__ int operator()(int i) const { return i < n ? __ldg(bytes + i) : 0; }
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
//
// Lanes (P6's `lanes`; K1 and K3 take the default, false): the counting
// pass also stores byte | insert << 8 of each byte as a 16-bit lane in
// `lanes` (shared, `valid` entries), and the scatter pass reads the lanes
// instead of reading the byte and evaluating the rule again.
template <typename ByteAt, typename Rule, bool Lanes = false>
__device__ int emulation_prevention(ByteAt at, Rule rule, int valid, int per, uint8_t* nal,
                                    int n_nal, int* tmp_max, int* tmp_sum, int& sat,
                                    uint16_t* lanes = nullptr) {
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
    if constexpr (Lanes) {
      const int insert = rule(i, last, byte, run_sat);
      lanes[i] = (uint16_t)(byte | (insert << 8));
      count += insert;
    } else {
      count += rule(i, last, byte, run_sat);
    }
    if (byte) last = i;
  }
  int ins_before, ins_total;
  scan_once(count, 0, SumOp(), tmp_sum, ins_before, ins_total);
  last = before;
  int dst = 5 + b0 + ins_before;
  for (int i = b0; i < b1; ++i, ++dst) {
    if constexpr (Lanes) {
      const int lane = lanes[i];
      if (lane >> 8) {
        if (dst < n_nal) nal[dst] = 3;
        ++dst;
      }
      if (dst < n_nal) nal[dst] = (uint8_t)lane;
    } else {
      const int byte = at(i);
      int ignored = 0;
      if (rule(i, last, byte, ignored)) {
        if (dst < n_nal) nal[dst] = 3;
        ++dst;
      }
      if (dst < n_nal) nal[dst] = (uint8_t)byte;
      if (byte) last = i;
    }
  }
  sat = __syncthreads_or(run_sat);
  return ins_total;
}

// P5's `ballot` stage: emulation_prevention's contract (K3's rule) with a
// warp, not a thread, as the unit: warp w owns the contiguous segment of
// `steps` 32-byte steps from w * 32 * steps and takes 32 consecutive bytes
// a step, one a lane, so its shared-memory reads are consecutive bytes.
// The last nonzero byte before lane l comes from __ballot_sync of the
// nonzero bytes below it and __clz, carried across steps; the insertions
// from a ballot of the rule, __popc of the lanes below, and one carry scan
// across the warps (the TPU probe's [R, 128] two-level scan in the card's
// idiom).  Each step's insertion mask is kept in `masks` (shared,
// kPackWarps * steps words), so the scatter pass evaluates nothing again.
// Three passes: the segment's last nonzero byte from its end, the count,
// the scatter; two block scans between them, as in emulation_prevention.
template <typename ByteAt, typename Rule>
__device__ int emulation_prevention_ballot(ByteAt at, Rule rule, int valid, uint8_t* nal,
                                           int n_nal, uint32_t* masks, int* tmp_max,
                                           int* tmp_sum, int& sat) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int steps = (valid + 32 * kPackWarps - 1) / (32 * kPackWarps);
  const int w0 = warp * 32 * steps;
  uint32_t* wmasks = masks + warp * steps;
  int last = -1;  // the segment's last nonzero byte (the same in every lane)
  for (int s = steps - 1; s >= 0 && last < 0; --s) {
    const int i = w0 + 32 * s + lane;
    const unsigned nz = __ballot_sync(kFull, i < valid && at(i) != 0);
    if (nz) last = w0 + 32 * s + 31 - __clz((int)nz);
  }
  // Lane 31 alone carries the warp's value, so every lane's exclusive scan
  // covers exactly the warps before its own.
  int before, unused;
  scan_once(lane == 31 ? last : -1, -1, MaxOp(), tmp_max, before, unused);
  int cur = before;  // the last nonzero byte before the current step
  int count = 0;
  int run_sat = 0;
  for (int s = 0; s < steps; ++s) {
    const int base = w0 + 32 * s;
    const int i = base + lane;
    const bool in = i < valid;
    const int byte = in ? at(i) : 0;
    const unsigned nz = __ballot_sync(kFull, byte != 0);
    const unsigned prev = nz & below;
    const int last_i = prev ? base + 31 - __clz((int)prev) : cur;
    const unsigned im = __ballot_sync(kFull, in && rule(i, last_i, byte, run_sat));
    if (lane == 0) wmasks[s] = im;
    count += __popc(im);
    if (nz) cur = base + 31 - __clz((int)nz);
  }
  int ins_before, ins_total;  // the barrier inside also publishes the masks
  scan_once(lane == 31 ? count : 0, 0, SumOp(), tmp_sum, ins_before, ins_total);
  int done = ins_before;  // insertions before the current step
  for (int s = 0; s < steps; ++s) {
    const int i = w0 + 32 * s + lane;
    const unsigned im = wmasks[s];
    if (i < valid) {
      const int insert = (im >> lane) & 1;
      const int dst = 5 + i + done + __popc(im & below) + insert;
      if (insert && dst - 1 < n_nal) nal[dst - 1] = 3;
      if (dst < n_nal) nal[dst] = (uint8_t)at(i);
    }
    done += __popc(im);
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

// The bytes of an output row after the payload where the NAL was built in
// place: [fill, n_nal) as 0x03 below `end`, zeros after; 16-byte stores
// over the row's aligned middle.
__device__ void fill_tail(uint8_t* out, int fill, int end, int n_nal) {
  const int mis = (int)(reinterpret_cast<uintptr_t>(out) & 15);
  const int lo = min(fill + ((16 - ((mis + fill) & 15)) & 15), n_nal);
  const int hi = max(lo, n_nal - ((mis + n_nal) & 15));
  for (int k = fill + threadIdx.x; k < lo; k += kPackThreads) out[k] = k < end ? 3 : 0;
  for (int k = hi + threadIdx.x; k < n_nal; k += kPackThreads) out[k] = k < end ? 3 : 0;
  for (int c = threadIdx.x; c < (hi - lo) >> 4; c += kPackThreads) {
    const int k0 = lo + 16 * c;
    union {
      uint4 v;
      uint8_t b[16];
    } u;
#pragma unroll
    for (int j = 0; j < 16; ++j) u.b[j] = k0 + j < end ? 3 : 0;
    reinterpret_cast<uint4*>(out + k0)[0] = u.v;
  }
}

__device__ __forceinline__ void write_prefix(uint8_t* nal, int n_nal, uint8_t header) {
  const uint8_t prefix[5] = {0, 0, 0, 1, header};
  for (int k = 0; k < min(5, n_nal); ++k) nal[k] = prefix[k];
}

// Bytes of K3's staging area: the padded bytes plus up to 15 of alignment
// offset.  Where the row is staged, K3's shared memory is the staging area,
// then the NAL (ebsp_smem).
__host__ __device__ __forceinline__ int ebsp_stage_bytes(int padded) { return padded + 16; }

__host__ __device__ __forceinline__ int ebsp_padded(int n_nal) {
  return (n_nal + 127) / 128 * 128;  // ops/ebsp_flat.padded_len
}

__host__ __device__ __forceinline__ size_t ebsp_smem(int n_nal) {
  return (size_t)ebsp_stage_bytes(ebsp_padded(n_nal)) + (size_t)((n_nal + 15) & ~15);
}

// Bytes each thread of K3 owns for a session of `valid` bytes: ceil(valid /
// threads), made odd so that neighbouring threads' runs fall into different
// shared-memory banks.  Exported as h264t_ebsp_items_per_thread.
__host__ __device__ __forceinline__ int ebsp_items_per_thread(int valid) {
  return ((valid + kPackThreads - 1) / kPackThreads) | 1;
}

// K3's emulation-prevention stage and P5/P6's variants of it
// (h264t_ebsp_variant).  K3 runs kEpRuns.
enum : int {
  kEpRuns = 0,    // emulation_prevention: a contiguous run of bytes a thread
  kEpBallot = 1,  // emulation_prevention_ballot: 32 consecutive bytes a warp step
  kEpLanes = 2,   // emulation_prevention<Lanes>: the first pass's 16-bit lanes reread
};

// Shared memory of a staged session (ebsp_smem) past the NAL, by variant:
// the ballot masks (a word per warp step) or the 16-bit lanes.
__host__ __device__ __forceinline__ size_t ebsp_extra_smem(int variant, int padded) {
  return variant == kEpBallot ? 4 * ((size_t)padded / 32 + kPackWarps)
         : variant == kEpLanes ? 2 * (size_t)padded
                               : 0;
}

// One session of K3 (block s).  It reads row s of `rbsp` (m bytes,
// `rbsp_row` apart), its valid length (int64, element s * len_row) and
// writes n_nal framed NAL bytes under `header` and the insertion count:
// `padded` positions of the stream are considered (n_nal rounded up to
// 128, as the JAX wrapper pads or cuts), those below rbsp_len valid, those
// past the row zero.  The count is the insertions, plus max_ins + 1 where
// the stream saturated; positions from the escaped payload's end up to
// 5 + rbsp_len + count hold 0x03, zeros after, as the TPU kernel's
// expansion leaves them.  `in_global`: the row is read from global memory
// and the NAL built in place (no dynamic shared memory; kEpRuns only).
// Variant: the emulation-prevention stage of a staged session (kEpRuns for
// K3; the others only for P5/P6, whose scratch follows the NAL).
template <int Variant = kEpRuns>
__device__ __forceinline__ void ebsp_session(const uint8_t* __restrict__ rbsp, long long rbsp_row,
                                             int m, const int64_t* __restrict__ rbsp_len,
                                             long long len_row, int header, int padded, int n_nal,
                                             int max_ins, int in_global,
                                             uint8_t* __restrict__ nal_out,
                                             int32_t* __restrict__ total_out) {
  extern __shared__ uint4 pack_smem[];  // 16-byte aligned
  uint8_t* stage = reinterpret_cast<uint8_t*>(pack_smem);
  __shared__ int tmp_max[kPackWarps];
  __shared__ int tmp_sum[kPackWarps];
  const int s = blockIdx.x;
  const int t = threadIdx.x;
  const uint8_t* src = rbsp + s * rbsp_row;
  uint8_t* out_row = nal_out + (size_t)s * n_nal;
  uint8_t* nal = in_global ? out_row : stage + ebsp_stage_bytes(padded);
  const int len = (int)rbsp_len[s * len_row];  // read as int32, as the JAX wrapper casts it
  const int valid = max(min(len, padded), 0);
  const int n_load = min(valid, m);
  if (t == 0) write_prefix(nal, n_nal, (uint8_t)header);

  int sat, ins;
  if (in_global) {
    ins = emulation_prevention(GlobalBytes{src, n_load}, ByteWindow(), valid,
                               ebsp_items_per_thread(valid), nal, n_nal, tmp_max, tmp_sum, sat);
  } else {
    // Byte i goes to stage[off + i]: the row and the staging area then
    // share their alignment mod 16, and the aligned middle moves in 16-byte
    // copies.
    const int off = (int)(reinterpret_cast<uintptr_t>(src) & 15);
    const int head = min((16 - off) & 15, n_load);
    const int n16 = (n_load - head) >> 4;
    const int tail = head + (n16 << 4);
    for (int c = t; c < n16; c += kPackThreads) {
      cp_async16(stage + off + head + 16 * c, src + head + 16 * c);
    }
    if (t < head) stage[off + t] = src[t];
    if (t < n_load - tail) stage[off + tail + t] = src[tail + t];
    cp_async_wait_all();
    __syncthreads();
    if constexpr (Variant == kEpBallot) {
      ins = emulation_prevention_ballot(StagedBytes{stage + off, n_load}, ByteWindow(), valid,
                                        nal, n_nal,
                                        reinterpret_cast<uint32_t*>(nal + ((n_nal + 15) & ~15)),
                                        tmp_max, tmp_sum, sat);
    } else if constexpr (Variant == kEpLanes) {
      ins = emulation_prevention<StagedBytes, ByteWindow, true>(
          StagedBytes{stage + off, n_load}, ByteWindow(), valid, ebsp_items_per_thread(valid),
          nal, n_nal, tmp_max, tmp_sum, sat,
          reinterpret_cast<uint16_t*>(nal + ((n_nal + 15) & ~15)));
    } else {
      ins = emulation_prevention(StagedBytes{stage + off, n_load}, ByteWindow(), valid,
                                 ebsp_items_per_thread(valid), nal, n_nal, tmp_max, tmp_sum, sat);
    }
  }
  const int count = ins + (sat ? max_ins + 1 : 0);
  const int fill = min(5 + valid + ins, n_nal);
  const int end = (int)min(5LL + len + count, (long long)n_nal);
  if (in_global) {
    fill_tail(out_row, fill, end, n_nal);
  } else {
    copy_out(nal, fill, end, n_nal, nal_out, s);
  }
  if (t == 0) total_out[s] = count;
}

// One session of K1 (block s), cut after `Stage` for P1.  K1 runs it at
// kStageFull and writes nal_out, len_out, bits_out, ovf_out; the cut
// stages write probe_meta i32[batch, 4] instead (and kStagePack the words,
// probe_words i32[batch, n_nal / 4]), each a value that depends on every
// step before the cut, so nothing computed is dead:
//   kStageLaunch  zeros
//   kStageStage   the XOR of the session's staged words (patterns, widths)
//   kStageScan    total bits, the XOR of the threads' start bits
//   kStagePack    total bits before the trailing bits, and the words
//   kStageEp      insertions, the saturation flag, the XOR of the NAL's
//                 first min(5 + valid + insertions, n_nal) bytes as
//                 little-endian 32-bit words (no copy-out)
template <int Stage, typename Sym>
__device__ __forceinline__ void emit_session(
    const Sym* __restrict__ pat, const Sym* __restrict__ nb, long long pat_row, long long nb_row,
    const int64_t* __restrict__ idc, long long idc_row, int idc_value, int n, int k, int n_nal,
    int n_rbsp, int cap, int align, int append_tb, uint32_t* __restrict__ words_gmem,
    int nal_in_global, uint8_t* __restrict__ nal_out, int32_t* __restrict__ len_out,
    int32_t* __restrict__ bits_out, uint8_t* __restrict__ ovf_out,
    int32_t* __restrict__ probe_meta, int32_t* __restrict__ probe_words) {
  extern __shared__ uint4 pack_smem[];  // 16-byte aligned
  uint8_t* smem = reinterpret_cast<uint8_t*>(pack_smem);
  __shared__ PosMap tmp_map[kPackWarps];
  __shared__ int tmp_max[kPackWarps];
  __shared__ int tmp_sum[kPackWarps];
  const int s = blockIdx.x;
  if constexpr (Stage == kStageLaunch) {
    if (threadIdx.x < 4) probe_meta[4 * s + threadIdx.x] = 0;
    return;
  }
  const int n_words = n_nal >> 2;  // the RBSP buffer holds n_nal bytes
  uint32_t* spat = reinterpret_cast<uint32_t*>(smem);
  int32_t* snb = reinterpret_cast<int32_t*>(smem + 4 * kPackThreads * k);
  uint8_t* out_row = nal_out + (size_t)s * n_nal;
  // The NAL reuses the staging area once the words are packed, or is built
  // in place in the output row.
  uint8_t* nal = nal_in_global ? out_row : smem;
  uint32_t* words = words_gmem ? words_gmem + (size_t)s * n_words
                               : reinterpret_cast<uint32_t*>(
                                     smem + staging_bytes(k, nal_in_global ? 0 : n_nal));

  if constexpr (Stage >= kStagePack) {
    for (int i = threadIdx.x; i < n_words; i += kPackThreads) words[i] = 0;
  }
  int bad = 0;
  uint32_t probe = 0;
  int total_bits = pack_session<Stage>(pat + s * pat_row, nb + s * nb_row, n, k, align != 0,
                                       spat, snb, words, n_words, tmp_map, bad, &probe);
  if constexpr (Stage == kStageStage || Stage == kStageScan) {
    int x_excl, x_total;
    scan_once((int)probe, 0, XorOp(), tmp_sum, x_excl, x_total);
    if (threadIdx.x == 0) {
      int32_t* m = probe_meta + 4 * s;
      m[0] = Stage == kStageStage ? x_total : total_bits;
      m[1] = Stage == kStageStage ? 0 : x_total;
      m[2] = 0;
      m[3] = 0;
    }
    return;
  }
  if constexpr (Stage == kStagePack) {
    __syncthreads();
    int32_t* out = probe_words + (size_t)s * n_words;
    for (int i = threadIdx.x; i < n_words; i += kPackThreads) out[i] = (int32_t)words[i];
    if (threadIdx.x == 0) {
      int32_t* m = probe_meta + 4 * s;
      m[0] = total_bits;
      m[1] = 0;
      m[2] = 0;
      m[3] = 0;
    }
    return;
  }
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
  if constexpr (Stage == kStageEp) {
    uint32_t x = 0;
    for (int c = threadIdx.x; c < (fill + 3) >> 2; c += kPackThreads) {
      for (int j = 0; j < 4; ++j) {
        if (4 * c + j < fill) x ^= (uint32_t)nal[4 * c + j] << (8 * j);
      }
    }
    int x_excl, x_total;
    scan_once((int)x, 0, XorOp(), tmp_sum, x_excl, x_total);
    if (threadIdx.x == 0) {
      int32_t* m = probe_meta + 4 * s;
      m[0] = ins_total;
      m[1] = sat ? 1 : 0;
      m[2] = x_total;
      m[3] = 0;
    }
    return;
  }
  if (nal_in_global) {
    fill_tail(out_row, fill, fill, n_nal);
  } else {
    copy_out(nal, fill, fill, n_nal, nal_out, s);
  }
  if (threadIdx.x == 0) {
    const int ins_eff = ins_total + (sat ? cap + 1 : 0);
    len_out[s] = 5 + rbsp_len + ins_eff;
    bits_out[s] = total_bits;
    ovf_out[s] = (total_bits > n_rbsp * 8 || ins_eff > cap || bad) ? 1 : 0;
  }
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

// Bytes of shared memory a block of `kernel` may use besides its static
// arrays, on the current device; 0 where the runtime cannot say.
size_t dynamic_smem_limit(const void* kernel) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return (size_t)optin > attr.sharedSizeBytes ? (size_t)optin - attr.sharedSizeBytes : 0;
}

// Resident blocks per SM of `kernel` with kPackThreads threads and `smem`
// bytes of dynamic shared memory on the current device (after the opt-in
// the launch would make); -1 where the runtime cannot say.
int blocks_per_sm(const void* kernel, size_t smem) {
  int blocks = 0;
  if (set_smem(kernel, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kPackThreads, smem) !=
          cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return blocks;
}

// K1's plan bits (h264t_emit_plan): the RBSP words, and the NAL, in global
// memory.
constexpr int kWordsInGlobal = 1;
constexpr int kNalInGlobal = 2;

// K1's and K2's dynamic shared memory: the staging area (K1: reused for the
// NAL unless that is built in place), plus the RBSP words unless they live
// in global memory.
size_t emit_smem(int k, int n_nal, int plan) {
  return (size_t)staging_bytes(k, (plan & kNalInGlobal) ? 0 : n_nal) +
         ((plan & kWordsInGlobal) ? 0 : (size_t)n_nal);
}

size_t pack_smem_bytes(int k, int n_words, bool words_in_global) {
  return (size_t)staging_bytes(k, 0) + (words_in_global ? 0 : 4 * (size_t)n_words);
}

}  // namespace
