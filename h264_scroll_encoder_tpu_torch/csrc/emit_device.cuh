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

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "cluster.cuh"

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

// Where place_run puts its words: a block's own words in its shared memory
// (one block a session).  The cluster plan's sink is ClusterWords.
struct SharedWords {
  uint32_t* words;
  int n_words;
  __device__ __forceinline__ void put(int k, uint32_t v, int lo, int hi) const {
    put_word(words, n_words, k, v, lo, hi);
  }
};

// Packs one thread's run of k staged symbols, MSB first, into the words;
// the run's bits are [pos, end).  Mirrors ops/bitpack.pack_words symbol for
// symbol: the low min(w, 32) bits of each pattern, an alignment sentinel
// as (-pos) mod 8 bits of its pattern under `align` and as none without.
template <typename W, typename Sink>
__device__ void place_run(const uint32_t* sp, const W* sn, int k, bool align, int pos, int end,
                          Sink sink) {
  const int lo = pos;
  int wi = pos >> 5;
  uint64_t win = 0;  // words wi and wi + 1
  for (int j = 0; j < k; ++j) {
    const int w = sn[j];
    const int next = w >= 0 ? pos + w : (align ? ceil8(pos) : pos);
    const int width = min(next - pos, 32);
    if (width > 0) {
      while ((pos >> 5) > wi) {
        sink.put(wi, (uint32_t)(win >> 32), lo, end);
        win <<= 32;
        ++wi;
      }
      uint32_t p = sp[j];
      if (width < 32) p &= (1u << width) - 1u;
      win |= (uint64_t)p << (64 - (pos - (wi << 5)) - width);
    }
    pos = next;
  }
  sink.put(wi, (uint32_t)(win >> 32), lo, end);
  sink.put(wi + 1, (uint32_t)win, lo, end);
}

template <typename W>
__device__ __forceinline__ void place_run(const uint32_t* sp, const W* sn, int k, bool align,
                                          int pos, int end, uint32_t* words, int n_words) {
  place_run(sp, sn, k, align, pos, end, SharedWords{words, n_words});
}

// Bytes of the staging area (and, for K1, of the NAL that reuses it).
__host__ __device__ __forceinline__ int staging_bytes(int k, int n_nal) {
  const int stage = 8 * kPackThreads * k;
  const int nal = (n_nal + 15) & ~15;
  return stage > nal ? stage : nal;
}

// Stages a chunk of G::kThreads * k symbols (the low 32 bits of each
// element; zeros past `left`) into shared memory by cp.async, coalesced,
// and waits for it.
template <typename G, typename Sym>
__device__ __forceinline__ void stage_chunk(const Sym* __restrict__ pat,
                                            const Sym* __restrict__ nb, int left, int k,
                                            uint32_t* spat, int32_t* snb, G g) {
  for (int j = 0; j < k; ++j) {
    const int c = j * G::kThreads + g.rank();  // coalesced
    if (c < left) {
      cp_async4(&spat[c], &pat[c]);
      cp_async4(&snb[c], &nb[c]);
    } else {
      spat[c] = 0;
      snb[c] = 0;
    }
  }
  cp_async_wait_all();
  g.sync();
}

// The position map of one thread's run of k staged widths.
__device__ __forceinline__ PosMap run_map(const int32_t* sn, int k, bool align, int& bad) {
  PosMap m{0, 0, 0};
  for (int j = 0; j < k; ++j) m = ComposeOp()(m, symbol_map(sn[j], align, bad));
  return m;
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
    stage_chunk(pat + base, nb + base, n - base, k, spat, snb, g);
    if constexpr (Stage == kStageStage) {
      for (int j = 0; j < k; ++j) *probe ^= spat[r0 + j] ^ (uint32_t)snb[r0 + j];
      continue;
    }
    const PosMap m = run_map(snb + r0, k, align, bad);
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
// over the row's aligned middle.  Thread t of the nt that share the row
// (a block, or a cluster's blocks) takes every nt-th store.
__device__ void fill_tail(uint8_t* out, int fill, int end, int n_nal, int t, int nt) {
  const int mis = (int)(reinterpret_cast<uintptr_t>(out) & 15);
  const int lo = min(fill + ((16 - ((mis + fill) & 15)) & 15), n_nal);
  const int hi = max(lo, n_nal - ((mis + n_nal) & 15));
  for (int k = fill + t; k < lo; k += nt) out[k] = k < end ? 3 : 0;
  for (int k = hi + t; k < n_nal; k += nt) out[k] = k < end ? 3 : 0;
  for (int c = t; c < (hi - lo) >> 4; c += nt) {
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
    fill_tail(out_row, fill, end, n_nal, t, kPackThreads);
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
    const int32_t* __restrict__ idc, long long idc_row, int idc_value, int n, int k, int n_nal,
    int n_rbsp, int cap, int align, int append_tb, uint8_t* __restrict__ nal_out,
    int32_t* __restrict__ len_out, int32_t* __restrict__ bits_out, uint8_t* __restrict__ ovf_out,
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
  // The NAL reuses the staging area once the words are packed.
  uint8_t* nal = smem;
  uint32_t* words = reinterpret_cast<uint32_t*>(smem + staging_bytes(k, n_nal));

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
    const int h = idc ? idc[s * idc_row] : idc_value;
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
  copy_out(nal, fill, fill, n_nal, nal_out, s);
  if (threadIdx.x == 0) {
    const int ins_eff = ins_total + (sat ? cap + 1 : 0);
    len_out[s] = 5 + rbsp_len + ins_eff;
    bits_out[s] = total_bits;
    ovf_out[s] = (total_bits > n_rbsp * 8 || ins_eff > cap || bad) ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// The cluster plan of K1 and K2/K4 (emit_kernels.cu): one session over the
// C blocks of a thread-block cluster, C in {2, 4, 8, 16}, where one block's
// shared memory cannot hold it.  Block r (its rank in the cluster) stages
// the share [r * share, (r + 1) * share) of the session's symbols and
// holds the slice [r * slice, (r + 1) * slice) of its RBSP words; the
// blocks reach each other's shared memory (DSMEM) through
// cluster_group::map_shared_rank.  ops/emit_fused.py keeps the same
// formulas (cluster_share, cluster_slice, cluster_items_per_thread) and a
// plain model of the split (emit_nal_split_plain).

// The most symbols a thread of a cluster block owns per staged chunk of its
// share (ops/emit_fused.CLUSTER_MAX_ITEMS): 132 KB of staging a block.
// Odd, as every count a thread takes on the cluster plan, so that the
// threads' runs (k words apart) fall into different shared-memory banks.
constexpr int kClusterMaxItems = 33;

__host__ __device__ __forceinline__ int cluster_share(int n, int c) { return (n + c - 1) / c; }

__host__ __device__ __forceinline__ int cluster_slice(int n_words, int c) {
  return ((n_words + c - 1) / c + 3) & ~3;
}

__host__ __device__ __forceinline__ int cluster_items(int n, int c) {
  const int k = ((cluster_share(n, c) + kPackThreads - 1) / kPackThreads) | 1;
  return k > kClusterMaxItems ? kClusterMaxItems : k;
}

// A cluster block's staging area, which holds its staged symbols and then
// its piece of the NAL: the escaped bytes of a slice of `slice` words (at
// most 1.5x plus one) and up to 15 bytes of alignment offset.
__host__ __device__ __forceinline__ int cluster_stage_bytes(int k, int slice) {
  const int stage = staging_bytes(k, 0);
  const int piece = (6 * slice + 47) & ~15;
  return stage > piece ? stage : piece;
}

// A cluster block's dynamic shared memory: its staging area, then its
// slice of the words (16-byte aligned).
__host__ __device__ __forceinline__ size_t cluster_smem(int k, int n_words, int c) {
  const int slice = cluster_slice(n_words, c);
  return (size_t)cluster_stage_bytes(k, slice) + 4 * (size_t)slice;
}

// Copies len bytes from src (shared memory) to dst (global memory), which
// share their address mod 16: 16-byte stores over the aligned middle.
__device__ void store_aligned(const uint8_t* src, uint8_t* dst, int len) {
  const int head = min((int)((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15), max(len, 0));
  const int n16 = max(len - head, 0) >> 4;
  const int tail = head + (n16 << 4);
  for (int i = threadIdx.x; i < head; i += kPackThreads) dst[i] = src[i];
  for (int c = threadIdx.x; c < n16; c += kPackThreads) {
    reinterpret_cast<uint4*>(dst + head)[c] = reinterpret_cast<const uint4*>(src + head)[c];
  }
  for (int i = tail + threadIdx.x; i < len; i += kPackThreads) dst[i] = src[i];
}

// What a block publishes to the other blocks of its cluster: each field is
// written once, before the cluster barrier after which the others read it.
struct ClusterSlot {
  PosMap map;  // the position map of its share
  int bad;     // a sentinel without `align` in its share
  int last;    // the last nonzero RBSP byte of its slice, -1 if none
  int ins;     // the insertions of its slice
  int sat;     // a zero run in its slice that the window cannot resolve
  int probe;   // P1: the XOR of its cut stage
};

// A block's shared state on the cluster plan: its slot, and warp 0's
// scans of the cluster's slots for the whole block, field by field (the
// exclusive scan before this block, and the total), each written once.
struct ClusterBlock {
  ClusterSlot slot;
  ClusterSlot excl;
  ClusterSlot total;
};

struct OrOp {
  __device__ __forceinline__ int operator()(int x, int y) const { return x | y; }
};

// The exclusive scan in rank order, and the total, of one field of the
// cluster's slots, published before a cluster barrier.  Warp 0 reads the
// C <= 16 slots over DSMEM, one a lane, and scans them; the block reads
// the result from `cb` after one block barrier.  (Every warp reading the
// slots itself, 16x the DSMEM reads and all on the same words, left the
// 5120x3200 hint frame ~20% slower on an H100: PERF.md.)
template <typename T, typename Op>
__device__ __forceinline__ void cluster_scan(ClusterBlock* cb, T ClusterSlot::*field, T ident,
                                             Op op, T& excl, T& total) {
  if (threadIdx.x < 32) {
    cg::cluster_group cl = cg::this_cluster();
    const int c = (int)cl.dim_blocks().x;
    const int r = (int)cl.block_rank();
    const int lane = threadIdx.x;
    T x = lane < c ? cl.map_shared_rank(&cb->slot, lane)->*field : ident;
#pragma unroll
    for (int o = 1; o < kMaxCluster; o <<= 1) {
      T u = shfl_up(x, o);
      if (lane >= o) x = op(u, x);
    }
    const T prev = shfl_idx(x, r > 0 ? r - 1 : 0);
    const T last = shfl_idx(x, c - 1);
    if (lane == 0) {
      cb->excl.*field = r > 0 ? prev : ident;
      cb->total.*field = last;
    }
  }
  __syncthreads();
  excl = cb->excl.*field;
  total = cb->total.*field;
}

// place_run's sink on the cluster plan: word k of the session lies in the
// slice of block k / slice, at k % slice, in this block's shared memory or
// (through DSMEM) another's.  A word wholly inside a run is stored, one
// that runs share is ORed atomically, as in put_word.
struct ClusterWords {
  uint32_t* local;  // this block's slice
  int slice;
  int n_words;
  __device__ __forceinline__ uint32_t* at(int k) const {
    const int r = k / slice;
    return cg::this_cluster().map_shared_rank(local, r) + (k - r * slice);
  }
  __device__ __forceinline__ void put(int k, uint32_t v, int lo, int hi) const {
    if (v == 0 || k >= n_words) return;
    if ((k << 5) >= lo && (k << 5) + 32 <= hi) {
      *at(k) = v;
    } else {
      atomicOr(at(k), v);
    }
  }
};

// Byte i of the RBSP on the cluster plan, from this block's word slice,
// which starts at byte `base`.
struct SliceBytes {
  const uint32_t* words;
  int base;
  __device__ __forceinline__ int operator()(int i) const {
    return (int)((words[(i - base) >> 2] >> (24 - 8 * (i & 3))) & 0xffu);
  }
};

// The cluster plan's pack: this block's share of the session (n_share
// symbols from pat, nb) placed through `sink` into the words of the whole
// cluster, which every block has zeroed in its slice.  Pass 1 composes the
// share's position map chunk by chunk (one chunk wherever the plan picks
// C < 16); the block publishes it, and an exclusive scan across the
// cluster gives the share's start bit.  Pass 2 places each thread's run
// from there: the one chunk is still staged, more chunks are staged again.
// Returns the session's total bits, with `bad` the cluster's OR.  Cut for
// P1 as pack_session: kStageStage XORs each thread's staged words into
// *probe and returns 0 before any cluster barrier; kStageScan XORs each
// thread's start bit into *probe instead of placing.
template <int Stage, typename Sym>
__device__ int cluster_pack(const Sym* __restrict__ pat, const Sym* __restrict__ nb, int n_share,
                            int k, bool align, uint32_t* spat, int32_t* snb, ClusterWords sink,
                            PosMap* tmp, ClusterBlock* cb, int& bad, uint32_t* probe) {
  const BlockGroup g{};
  const int chunk = kPackThreads * k;
  const int r0 = threadIdx.x * k;
  PosMap m{0, 0, 0}, excl{0, 0, 0}, share{0, 0, 0};
  for (int base = 0; base < n_share; base += chunk) {
    if (base > 0) __syncthreads();  // the previous chunk's widths are read
    stage_chunk(pat + base, nb + base, n_share - base, k, spat, snb, g);
    if constexpr (Stage == kStageStage) {
      for (int j = 0; j < k; ++j) *probe ^= spat[r0 + j] ^ (uint32_t)snb[r0 + j];
      continue;
    }
    m = run_map(snb + r0, k, align, bad);
    PosMap total;
    scan_once(m, PosMap{0, 0, 0}, ComposeOp(), tmp, excl, total);
    share = ComposeOp()(share, total);
  }
  if constexpr (Stage == kStageStage) return 0;
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) {
    cb->slot.map = share;
    cb->slot.bad = bad;
  }
  cluster_sync();  // every slice is zeroed and every share's map published
  PosMap before, all;
  cluster_scan(cb, &ClusterSlot::map, PosMap{0, 0, 0}, ComposeOp(), before, all);
  int unused;
  cluster_scan(cb, &ClusterSlot::bad, 0, OrOp(), unused, bad);
  int carry = apply_map(before, 0);
  for (int base = 0; base < n_share; base += chunk) {
    if (n_share > chunk) {  // more than one chunk: stage this one again
      __syncthreads();      // the previous chunk is placed
      stage_chunk(pat + base, nb + base, n_share - base, k, spat, snb, g);
      int ignored = 0;
      m = run_map(snb + r0, k, align, ignored);
      PosMap total;
      scan_once(m, PosMap{0, 0, 0}, ComposeOp(), tmp, excl, total);
      share = total;
    }
    const int start = apply_map(excl, carry);
    if constexpr (Stage == kStageScan) {
      *probe ^= (uint32_t)start;
    } else {
      place_run(spat + r0, snb + r0, k, align, start, apply_map(m, start), sink);
    }
    carry = apply_map(share, carry);
  }
  return apply_map(all, 0);
}

// K1's emulation-prevention stage on the cluster plan, over this block's
// RBSP bytes [b_lo, b_hi) (those of its word slice, `per` a thread, read
// through `at`).  The zero run into the block comes from an exclusive max
// across the cluster of each block's last nonzero byte, the NAL position
// of its first byte from an exclusive sum of each block's insertions.
// The block's escaped bytes, NAL positions [d_lo, d_hi) below n_nal, go to
// `piece` in shared memory at offset mis + (position - d_lo), mis being
// the position's address mod 16 in the output row `out`, so that they
// leave in 16-byte stores (store_aligned).  Returns the cluster's
// insertions, with `sat` the cluster's flag.  The other blocks' slots are
// read after the cluster barriers inside: the caller arrives after the
// call and waits before it exits.  Ends on a barrier.
template <typename ByteAt, typename Rule>
__device__ int emulation_prevention_cluster(ByteAt at, Rule rule, int b_lo, int b_hi, int per,
                                            const uint8_t* out, uint8_t* piece, int n_nal,
                                            int* tmp_max, int* tmp_sum, ClusterBlock* cb,
                                            int& sat, int& d_lo, int& d_hi, int& mis) {
  const int b0 = min(b_lo + (int)threadIdx.x * per, b_hi);
  const int b1 = min(b0 + per, b_hi);
  int last = -1;
  for (int i = b1 - 1; i >= b0; --i) {
    if (at(i)) {
      last = i;
      break;
    }
  }
  int before, block_last;
  scan_once(last, -1, MaxOp(), tmp_max, before, block_last);
  if (threadIdx.x == 0) cb->slot.last = block_last;
  cluster_sync();
  int into, unused;
  cluster_scan(cb, &ClusterSlot::last, -1, MaxOp(), into, unused);
  before = max(before, into);
  int count = 0;
  int run_sat = 0;
  last = before;
  for (int i = b0; i < b1; ++i) {
    const int byte = at(i);
    count += rule(i, last, byte, run_sat);
    if (byte) last = i;
  }
  int ins_before, block_ins;
  scan_once(count, 0, SumOp(), tmp_sum, ins_before, block_ins);
  const int block_sat = __syncthreads_or(run_sat);
  if (threadIdx.x == 0) {
    cb->slot.ins = block_ins;
    cb->slot.sat = block_sat;
  }
  cluster_sync();
  int ins_into, ins_total;
  cluster_scan(cb, &ClusterSlot::ins, 0, SumOp(), ins_into, ins_total);
  cluster_scan(cb, &ClusterSlot::sat, 0, OrOp(), unused, sat);
  d_lo = 5 + b_lo + ins_into;
  d_hi = 5 + b_hi + ins_into + block_ins;
  mis = (int)((reinterpret_cast<uintptr_t>(out) + d_lo) & 15);
  uint8_t* nal = piece + mis;  // NAL position p at nal[p - d_lo]
  last = before;
  int dst = 5 + b0 + ins_into + ins_before;
  for (int i = b0; i < b1; ++i, ++dst) {
    const int byte = at(i);
    int ignored = 0;
    if (rule(i, last, byte, ignored)) {
      if (dst < n_nal) nal[dst - d_lo] = 3;
      ++dst;
    }
    if (dst < n_nal) nal[dst - d_lo] = (uint8_t)byte;
    if (byte) last = i;
  }
  __syncthreads();
  return ins_total;
}

// One session of K1 on the cluster plan (the C blocks of cluster
// blockIdx.x / C), cut after `Stage` for P1 with emit_session's outputs.
// The NAL is escaped straight into its output row: the prefix by block 0,
// each block's payload at its offset, the zeros after the payload by every
// block in turn; block 0 writes the session's results.
template <int Stage, typename Sym>
__device__ __forceinline__ void emit_cluster_session(
    const Sym* __restrict__ pat, const Sym* __restrict__ nb, long long pat_row, long long nb_row,
    const int32_t* __restrict__ idc, long long idc_row, int idc_value, int n, int k, int n_nal,
    int n_rbsp, int cap, int align, int append_tb, uint8_t* __restrict__ nal_out,
    int32_t* __restrict__ len_out, int32_t* __restrict__ bits_out, uint8_t* __restrict__ ovf_out,
    int32_t* __restrict__ probe_meta, int32_t* __restrict__ probe_words) {
  extern __shared__ uint4 pack_smem[];  // 16-byte aligned
  uint8_t* smem = reinterpret_cast<uint8_t*>(pack_smem);
  __shared__ PosMap tmp_map[kPackWarps];
  __shared__ int tmp_max[kPackWarps];
  __shared__ int tmp_sum[kPackWarps];
  __shared__ ClusterBlock cb;
  cg::cluster_group cl = cg::this_cluster();
  const int c = (int)cl.dim_blocks().x;
  const int r = (int)cl.block_rank();
  const int s = blockIdx.x / c;
  const int t = threadIdx.x;
  int32_t* meta = probe_meta + 4 * s;
  if constexpr (Stage == kStageLaunch) {
    if (r == 0 && t < 4) meta[t] = 0;
    return;
  }
  const int n_words = n_nal >> 2;
  const int slice = cluster_slice(n_words, c);
  const int w_lo = min(r * slice, n_words);
  const int w_hi = min(w_lo + slice, n_words);
  const int share = cluster_share(n, c);
  const int i_lo = min(r * share, n);
  const int i_hi = min(i_lo + share, n);
  uint32_t* spat = reinterpret_cast<uint32_t*>(smem);
  int32_t* snb = reinterpret_cast<int32_t*>(smem + 4 * kPackThreads * k);
  uint32_t* words = reinterpret_cast<uint32_t*>(smem + cluster_stage_bytes(k, slice));
  const ClusterWords sink{words, slice, n_words};
  uint8_t* out_row = nal_out + (size_t)s * n_nal;

  if constexpr (Stage >= kStagePack) {
    for (int i = t; i < slice; i += kPackThreads) words[i] = 0;
  }
  int bad = 0;
  uint32_t probe = 0;
  int total_bits = cluster_pack<Stage>(pat + s * pat_row + i_lo, nb + s * nb_row + i_lo,
                                       i_hi - i_lo, k, align != 0, spat, snb, sink, tmp_map, &cb,
                                       bad, &probe);
  if constexpr (Stage == kStageStage || Stage == kStageScan) {
    int x_excl, x_total;
    scan_once((int)probe, 0, XorOp(), tmp_sum, x_excl, x_total);
    if (t == 0) cb.slot.probe = x_total;
    cluster_sync();
    cluster_scan(&cb, &ClusterSlot::probe, 0, XorOp(), x_excl, x_total);
    if (r == 0 && t == 0) {
      meta[0] = Stage == kStageStage ? x_total : total_bits;
      meta[1] = Stage == kStageStage ? 0 : x_total;
      meta[2] = 0;
      meta[3] = 0;
    }
    cluster_sync();  // no block leaves while another reads its slot
    return;
  }
  if constexpr (Stage == kStagePack) {
    cluster_sync();  // every run is placed
    int32_t* out = probe_words + (size_t)s * n_words;
    for (int i = w_lo + t; i < w_hi; i += kPackThreads) out[i] = (int32_t)words[i - w_lo];
    if (r == 0 && t == 0) {
      meta[0] = total_bits;
      meta[1] = 0;
      meta[2] = 0;
      meta[3] = 0;
    }
    return;
  }
  if (append_tb) {  // rbsp_trailing_bits where the payload ends, ORed in
    const int w = 1 + ((8 - ((total_bits + 1) & 7)) & 7);
    if (r == 0 && t == 0) {
      const uint64_t v = (uint64_t)(1u << (w - 1)) << (64 - (total_bits & 31) - w);
      sink.put(total_bits >> 5, (uint32_t)(v >> 32), 0, 0);
      sink.put((total_bits >> 5) + 1, (uint32_t)v, 0, 0);
    }
    total_bits += w;
  }
  cluster_sync();  // the words are complete
  if (r == 0 && t == 0) {
    const int h = idc ? idc[s * idc_row] : idc_value;
    write_prefix(out_row, n_nal, (uint8_t)(((h & 3) << 5) | 1));
  }
  const int rbsp_len = total_bits >> 3;
  const int valid = min(rbsp_len, n_nal);
  const int b_lo = min(4 * w_lo, valid);
  const int b_hi = min(4 * w_hi, valid);
  // Whole words a thread, an odd number of them (different banks).
  const int per = 4 * (((((b_hi - b_lo + 3) >> 2) + kPackThreads - 1) / kPackThreads) | 1);
  int sat, d_lo, d_hi, mis;
  const int ins_total = emulation_prevention_cluster(
      SliceBytes{words, 4 * w_lo}, WordWindow(), b_lo, b_hi, per, out_row, smem, n_nal, tmp_max,
      tmp_sum, &cb, sat, d_lo, d_hi, mis);
  const int fill = min(5 + valid + ins_total, n_nal);
  const int end = min(d_hi, fill);  // this block's NAL bytes are [d_lo, end)
  if constexpr (Stage == kStageEp) {
    uint32_t x = 0;
    for (int p = d_lo + t; p < end; p += kPackThreads) {
      x ^= (uint32_t)smem[mis + p - d_lo] << (8 * (p & 3));
    }
    if (r == 0 && t < min(5, fill)) x ^= (uint32_t)out_row[t] << (8 * (t & 3));
    int x_excl, x_total;
    scan_once((int)x, 0, XorOp(), tmp_sum, x_excl, x_total);
    if (t == 0) cb.slot.probe = x_total;
    cluster_sync();
    cluster_scan(&cb, &ClusterSlot::probe, 0, XorOp(), x_excl, x_total);
    if (r == 0 && t == 0) {
      meta[0] = ins_total;
      meta[1] = sat ? 1 : 0;
      meta[2] = x_total;
      meta[3] = 0;
    }
    cluster_sync();  // no block leaves while another reads its slot
    return;
  }
  cluster_arrive();
  store_aligned(smem + mis, out_row + d_lo, end - d_lo);
  fill_tail(out_row, fill, fill, n_nal, r * kPackThreads + t, c * kPackThreads);
  if (r == 0 && t == 0) {
    const int ins_eff = ins_total + (sat ? cap + 1 : 0);
    len_out[s] = 5 + rbsp_len + ins_eff;
    bits_out[s] = total_bits;
    ovf_out[s] = (total_bits > n_rbsp * 8 || ins_eff > cap || bad) ? 1 : 0;
  }
  cluster_wait();
}

// K1's and K2/K4's dynamic shared memory with one block a session: the
// staging area (K1: reused for the NAL) plus the RBSP words.
size_t emit_smem(int k, int n_nal) { return (size_t)staging_bytes(k, n_nal) + (size_t)n_nal; }

size_t pack_smem_bytes(int k, int n_words) {
  return (size_t)staging_bytes(k, 0) + 4 * (size_t)n_words;
}

// The plan of K1 or K2/K4 for sessions of n symbols and n_words words
// (h264t_emit_plan, h264t_pack_plan): 1 where one block of `one` holds the
// session in `one_smem` bytes; else the smallest C in {2, 4, 8, 16} for
// which a block of `cluster` stages its share in one chunk beside its word
// slice and the device holds such a cluster (C = 16 also where the share
// takes several chunks); 0 where none fits, -1 where the runtime cannot say.
int session_plan(const void* one, size_t one_smem, const void* cluster, int n, int n_words) {
  const size_t limit = dynamic_smem_limit(one);
  const size_t cluster_limit = dynamic_smem_limit(cluster);
  if (limit == 0 || cluster_limit == 0) return -1;
  if (one_smem <= limit) return 1;
  for (int c = 2; c <= kMaxCluster; c *= 2) {
    const int k = cluster_items(n, c);
    const size_t smem = cluster_smem(k, n_words, c);
    if ((cluster_share(n, c) > kPackThreads * k && c < kMaxCluster) || smem > cluster_limit) {
      continue;
    }
    const int active = active_clusters(cluster, c, kPackThreads, smem);
    if (active < 0) return -1;
    if (active > 0) return c;
  }
  return 0;
}

}  // namespace
