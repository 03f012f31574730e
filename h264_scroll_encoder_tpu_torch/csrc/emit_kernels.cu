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
// What bounds them on an H100: memory traffic, not arithmetic.  At 720p a
// session reads ~58 KB of (pattern, nbits) symbols and writes a ~7.3 KB NAL;
// everything in between (the packed words, the byte stream, the zero-run and
// insertion scans) stays in shared memory.  Design: one thread block per
// session (grid = B), 1,024 threads walking the session in tiles of 1,024
// elements with a carried block scan.  Symbols are read once, coalesced;
// each symbol ORs its <= 2 word contributions into shared words with
// shared-memory atomics; the NAL is assembled in shared memory and written
// out once as 32-bit words.  The TPU kernel's rolls, SWAR byte marks and
// monotone or-moves are not needed: Hopper has scatter and block scans.
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

// ORs one symbol's <= 2 word contributions into the big-endian words.
// Mirrors ops/bitpack.pack_words lane for lane (bits past n_words drop).
__device__ __forceinline__ void place_symbol(uint32_t* words, int n_words, int pos, int w,
                                             uint32_t p) {
  if (w <= 0) return;
  p &= w >= 32 ? 0xffffffffu : ((1u << w) - 1u);
  const int bit = pos & 31;
  const int w0 = pos >> 5;
  const int n0 = min(w, 32 - bit);
  const int n1 = w - n0;
  const int k = min(n1, 31);
  const uint32_t c0 = (uint32_t)((uint64_t)(p >> k) << (32 - bit - n0));
  if (w0 < n_words) atomicOr(&words[w0], c0);
  if (n1 > 0 && w0 + 1 < n_words) {
    const uint32_t c1 = (uint32_t)((uint64_t)(p & ((1u << k) - 1u)) << max(32 - n1, 1));
    atomicOr(&words[w0 + 1], c1);
  }
}

// Packs one session's symbols into zeroed shared words and returns the total
// bit count.  `align`: negative widths are I_PCM alignment sentinels; without
// it they are out of contract, packed as zero bits and reported in *bad.
// `append_tb`: the rbsp_trailing_bits symbol follows the last symbol.
__device__ int pack_session(const int32_t* pat, const int32_t* nb, int n, bool align,
                            bool append_tb, uint32_t* words, int n_words, PosMap* tmp,
                            int* bad) {
  int carry = 0;
  int any_bad = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    int w = 0;
    uint32_t p = 0;
    if (i < n) {
      w = nb[i];
      p = (uint32_t)pat[i];
    }
    bool sentinel = w < 0;
    if (sentinel && !align) {
      any_bad = 1;
      sentinel = false;
      w = 0;
    }
    const PosMap m = sentinel ? PosMap{1, 0, 0} : PosMap{0, w, 0};
    PosMap excl, incl, total;
    block_scan(m, PosMap{0, 0, 0}, ComposeOp(), tmp, excl, incl, total);
    const int before = apply_map(excl, carry);
    place_symbol(words, n_words, before, apply_map(incl, carry) - before, p);
    carry = apply_map(total, carry);
  }
  if (append_tb) {
    const int w = 1 + ((8 - ((carry + 1) & 7)) & 7);
    if (threadIdx.x == 0) place_symbol(words, n_words, carry, w, 1u << (w - 1));
    carry += w;
  }
  *bad = __syncthreads_or(any_bad);
  return carry;
}

__device__ __forceinline__ void zero_words(uint32_t* words, int n_words) {
  for (int k = threadIdx.x; k < n_words; k += blockDim.x) words[k] = 0;
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    emit_fused_kernel(const int32_t* __restrict__ pat, const int32_t* __restrict__ nb,
                      const int32_t* __restrict__ nal_ref_idc, int n, int n_nal, int n_rbsp,
                      int cap, int align, int append_tb, uint8_t* __restrict__ nal_out,
                      int32_t* __restrict__ meta) {
  extern __shared__ uint32_t smem[];
  __shared__ PosMap tmp_map[32];
  __shared__ int tmp_int[32];
  const int s = blockIdx.x;
  const int n_words = n_nal >> 2;  // the RBSP buffer holds n_nal bytes
  uint32_t* words = smem;
  uint32_t* nal_words = smem + n_words;
  uint8_t* nal = reinterpret_cast<uint8_t*>(nal_words);

  zero_words(smem, 2 * n_words);
  int bad;
  const int total_bits = pack_session(pat + (size_t)s * n, nb + (size_t)s * n, n, align != 0,
                                      append_tb != 0, words, n_words, tmp_map, &bad);
  if (threadIdx.x == 0) {
    nal[0] = 0;
    nal[1] = 0;
    nal[2] = 0;
    nal[3] = 1;
    nal[4] = (uint8_t)(((nal_ref_idc[s] & 3) << 5) | 1);
  }
  __syncthreads();  // packed words complete

  // Emulation prevention + framing: byte i lands at 5 + i + (insertions up
  // to and including i); an inserting byte leaves a 0x03 in the hole before
  // it.  t, the zero run before byte i, is i - 1 - (last nonzero index
  // before i), a max-scan carried across tiles.
  const int rbsp_len = total_bits >> 3;
  const int valid_len = min(rbsp_len, n_nal);
  int last_nz = -1;
  int ins_carry = 0;
  int sat = 0;
  for (int base = 0; base < valid_len; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const bool valid = i < valid_len;
    const int byte = valid ? (int)((words[i >> 2] >> (24 - 8 * (i & 3))) & 0xffu) : 0;
    int excl, incl, total;
    block_scan((valid && byte != 0) ? i : -1, -1, MaxOp(), tmp_int, excl, incl, total);
    const int t = i - 1 - max(excl, last_nz);
    last_nz = max(total, last_nz);
    const bool unresolved = valid && (i >> 2) > kWindowWords && t >= 4 * kWindowWords + (i & 3);
    const int ins = valid && byte <= 3 && t >= 2 && (t & 1) == 0 && !unresolved;
    sat |= unresolved;
    block_scan(ins, 0, SumOp(), tmp_int, excl, incl, total);
    const int dst = 5 + i + ins_carry + incl;
    if (valid && dst < n_nal) nal[dst] = (uint8_t)byte;
    if (ins && dst - 1 < n_nal) nal[dst - 1] = 3;
    ins_carry += total;
  }
  sat = __syncthreads_or(sat);  // also orders the byte writes before the copy-out

  uint32_t* out = reinterpret_cast<uint32_t*>(nal_out + (size_t)s * n_nal);
  for (int k = threadIdx.x; k < n_words; k += blockDim.x) out[k] = nal_words[k];
  if (threadIdx.x == 0) {
    const int ins_eff = ins_carry + (sat ? cap + 1 : 0);
    const bool overflow = total_bits > n_rbsp * 8 || ins_eff > cap || bad;
    meta[4 * s + 0] = total_bits;
    meta[4 * s + 1] = ins_eff;
    meta[4 * s + 2] = 5 + rbsp_len + ins_eff;
    meta[4 * s + 3] = overflow ? 1 : 0;
  }
}

__global__ void __launch_bounds__(kThreads)
    pack_place_kernel(const int32_t* __restrict__ pat, const int32_t* __restrict__ nb, int n,
                      int n_words, int32_t* __restrict__ words_out,
                      int32_t* __restrict__ total_out) {
  extern __shared__ uint32_t smem[];
  __shared__ PosMap tmp_map[32];
  const int s = blockIdx.x;
  zero_words(smem, n_words);
  int bad;
  const int total_bits = pack_session(pat + (size_t)s * n, nb + (size_t)s * n, n, false, false,
                                      smem, n_words, tmp_map, &bad);
  uint32_t* out = reinterpret_cast<uint32_t*>(words_out + (size_t)s * n_words);
  for (int k = threadIdx.x; k < n_words; k += blockDim.x) out[k] = smem[k];
  if (threadIdx.x == 0) total_out[s] = total_bits;
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

}  // namespace

extern "C" int h264t_emit_fused(const int32_t* pat, const int32_t* nb, const int32_t* nal_ref_idc,
                                int batch, int n, int n_nal, int n_rbsp, int cap, int align,
                                int append_tb, uint8_t* nal_out, int32_t* meta, void* stream) {
  const size_t smem = 2 * (size_t)n_nal;  // RBSP words + NAL bytes
  cudaError_t err = set_smem((const void*)emit_fused_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  emit_fused_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      pat, nb, nal_ref_idc, n, n_nal, n_rbsp, cap, align, append_tb, nal_out, meta);
  return (int)cudaGetLastError();
}

extern "C" int h264t_pack_place(const int32_t* pat, const int32_t* nb, int batch, int n,
                                int n_words, int32_t* words_out, int32_t* total_out,
                                void* stream) {
  const size_t smem = 4 * (size_t)n_words;
  cudaError_t err = set_smem((const void*)pack_place_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  pack_place_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(pat, nb, n, n_words,
                                                                     words_out, total_out);
  return (int)cudaGetLastError();
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

extern "C" int h264t_pack_words(const int32_t* pat, const int32_t* nb, int batch, int n,
                                int n_words, int32_t* words_out, int32_t* total_out,
                                void* stream) {
  return h264t_pack_place(pat, nb, batch, n, n_words, words_out, total_out, stream);
}
