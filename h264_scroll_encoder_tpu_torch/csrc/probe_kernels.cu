// Hand-written Hopper (sm_90a) measurement probes of K1, K2 and K3: the
// counterparts of the JAX package's Pallas probes (P1-P3) and of two of its
// XLA races (P5/P6), built from K1's, K2's and K3's own code
// (emit_device.cuh), not from a copy of it.
//
// P1  h264t_emit_stage       — replaces scripts/emit_stage_probe.py
//     `_stage_kernel` (stages copy, cumsum, place, scan; `full` is
//     ops/emit_fused.py `_emit_kernel`): K1 cut off after each stage of its
//     Hopper chain (emit_session's Stage: launch, stage, scan, pack, ep,
//     full), on K1's block, __launch_bounds__, plan and dynamic shared
//     memory, so that the difference between two stages is the cost of the
//     later one.  Each cut ends in a write that depends on everything
//     before it (emit_device.cuh), so the compiler drops nothing.  `full`
//     is K1's session itself under another entry point and counter.
// P2  h264t_pack_place_u16   — replaces scripts/pack_u16_probe.py
//     `_place_kernel_u16` (`_place_rounds_u16`): K2 with the widths staged
//     as 8 bits (5 staged bytes a symbol instead of 8: ~57 KB a block
//     instead of ~86 KB at the 720p compact splice shapes, k = 19) and the
//     position scan on one 32-bit sum a thread instead of K2's three-field
//     PosMap.  The kept stream is at most 2,048 words = 65,536 bits, so a
//     bit position's low 16 bits address it and the bits above are the
//     scan's carry-out: a run that starts past the kept bits is skipped
//     whole and a run that crosses them drops its words past n_words
//     (put_word), so nothing aliases into the kept words, and the total is
//     the full 32-bit sum (K2's).  __launch_bounds__(threads, 3): the
//     narrower staging is the experiment behind K1's occupancy question
//     (ROADMAP.md §2), so the build lets three blocks share an SM.
// P3  h264t_pack_place_tiled — replaces scripts/pack_tiled_probe.py
//     `_pack_kernel3` over [T, R, 128] blocks: K2 with T in {1, 2, 4, 8,
//     16} sessions a block, each on kPackThreads / T threads that stage,
//     scan and place with K2's pack_session under their own barrier
//     (TileGroup: bar.sync with an id and a count, __syncwarp for one
//     warp).  k is chosen per T so that T sessions' staging and words fit
//     a block (h264t_pack_tiled_items).  The TPU reason for tiling (a
//     program instance's fixed ~1.6 us) has no Hopper counterpart: blocks
//     are scheduled in hardware.  The probe measures what tiling costs
//     here instead: more chunks per session and fewer resident blocks.
//
// P5/P6 h264t_ebsp_variant — stand for the XLA scans that
//     scripts/ebsp_cumsum_probe.py and scripts/ebsp_fused_probe.py race
//     inside the bounded EBSP stage (no Pallas kernel): K3's session
//     (ebsp_session) with its emulation-prevention stage swapped, K3's
//     contract and outputs.  Variants (ops/probes.EBSP_VARIANTS):
//       runs / shared  K3 itself: a contiguous run of bytes a thread, a
//                      max-scan for the last nonzero byte, a sum-scan of
//                      the insertions, the NAL in shared memory, then
//                      store_nal's 16-byte stores (the JAX probes'
//                      int32-cumsum and 3-array forms);
//       ballot         a warp takes 32 consecutive bytes a step: the last
//                      nonzero byte from __ballot_sync and __clz carried
//                      across steps, the insertions from a ballot of the
//                      rule and __popc, one carry scan across warps (the
//                      u8 two-level [R, 128] scan);
//       direct         K3's in_global plan forced on where K3 would stage:
//                      the row read from global memory and the NAL built
//                      in place in its output row with the prefix, no
//                      shared-memory NAL (the fused framing);
//       lanes          the counting pass stores byte | insert << 8 as a
//                      16-bit lane in shared memory, and the scatter pass
//                      rereads the lanes instead of the rule (the fused
//                      u16 lane).
//     Every variant computes K3's function (ops/ebsp_flat
//     rbsp_to_nal_plain is the plain version of all of them).
//
// What bounds them: as K1, K2 and K3 (emit_kernels.cu) — one session's
// chain of load round trips and barriers, not its bytes.
//
// Plain C interface (bound with ctypes): each entry launches on the given
// stream, allocates nothing, and returns cudaGetLastError() of its launch.

#include "emit_device.cuh"

namespace {

// P1: K1's session cut after Stage, one block a session or (the cluster
// kernel) on K1's cluster plan.
template <int Stage, typename Sym>
__global__ void __launch_bounds__(kPackThreads, 2)
    emit_stage_kernel(const Sym* __restrict__ pat, const Sym* __restrict__ nb, long long pat_row,
                      long long nb_row, const int32_t* __restrict__ idc, long long idc_row,
                      int idc_value, int n, int k, int n_nal, int n_rbsp, int cap, int align,
                      int append_tb, uint8_t* __restrict__ nal_out, int32_t* __restrict__ len_out,
                      int32_t* __restrict__ bits_out, uint8_t* __restrict__ ovf_out,
                      int32_t* __restrict__ probe_meta, int32_t* __restrict__ probe_words) {
  emit_session<Stage>(pat, nb, pat_row, nb_row, idc, idc_row, idc_value, n, k, n_nal, n_rbsp, cap,
                      align, append_tb, nal_out, len_out, bits_out, ovf_out, probe_meta,
                      probe_words);
}

template <int Stage, typename Sym>
__global__ void __launch_bounds__(kPackThreads, 1)
    emit_stage_cluster_kernel(const Sym* __restrict__ pat, const Sym* __restrict__ nb,
                              long long pat_row, long long nb_row,
                              const int32_t* __restrict__ idc, long long idc_row, int idc_value,
                              int n, int k, int n_nal, int n_rbsp, int cap, int align,
                              int append_tb, uint8_t* __restrict__ nal_out,
                              int32_t* __restrict__ len_out, int32_t* __restrict__ bits_out,
                              uint8_t* __restrict__ ovf_out, int32_t* __restrict__ probe_meta,
                              int32_t* __restrict__ probe_words) {
  emit_cluster_session<Stage>(pat, nb, pat_row, nb_row, idc, idc_row, idc_value, n, k, n_nal,
                              n_rbsp, cap, align, append_tb, nal_out, len_out, bits_out, ovf_out,
                              probe_meta, probe_words);
}

template <int Stage, typename Sym>
cudaError_t launch_stage(int cluster, const void* pat, const void* nb, long long pat_row,
                         long long nb_row, const int32_t* idc, long long idc_row, int idc_value,
                         int batch, int n, int k, int n_nal, int n_rbsp, int cap, int align,
                         int append_tb, uint8_t* nal_out, int32_t* len_out, int32_t* bits_out,
                         uint8_t* ovf_out, int32_t* probe_meta, int32_t* probe_words,
                         cudaStream_t stream) {
  const Sym* p = static_cast<const Sym*>(pat);
  const Sym* q = static_cast<const Sym*>(nb);
  if (cluster > 1) {
    return launch_clusters(emit_stage_cluster_kernel<Stage, Sym>, batch, cluster, kPackThreads,
                           cluster_smem(k, n_nal >> 2, cluster), stream, p, q, pat_row, nb_row,
                           idc, idc_row, idc_value, n, k, n_nal, n_rbsp, cap, align, append_tb,
                           nal_out, len_out, bits_out, ovf_out, probe_meta, probe_words);
  }
  const size_t smem = emit_smem(k, n_nal);
  const cudaError_t err = set_smem((const void*)emit_stage_kernel<Stage, Sym>, smem);
  if (err != cudaSuccess) return err;
  emit_stage_kernel<Stage, Sym><<<batch, kPackThreads, smem, stream>>>(
      p, q, pat_row, nb_row, idc, idc_row, idc_value, n, k, n_nal, n_rbsp, cap, align, append_tb,
      nal_out, len_out, bits_out, ovf_out, probe_meta, probe_words);
  return cudaGetLastError();
}

template <typename Sym>
cudaError_t launch_stage_of(int stage, int cluster, const void* pat, const void* nb,
                            long long pat_row, long long nb_row, const int32_t* idc,
                            long long idc_row, int idc_value, int batch, int n, int k, int n_nal,
                            int n_rbsp, int cap, int align, int append_tb, uint8_t* nal_out,
                            int32_t* len_out, int32_t* bits_out, uint8_t* ovf_out,
                            int32_t* probe_meta, int32_t* probe_words, cudaStream_t stream) {
#define H264T_STAGE_CASE(S)                                                                       \
  case S:                                                                                         \
    return launch_stage<S, Sym>(cluster, pat, nb, pat_row, nb_row, idc, idc_row, idc_value,       \
                                batch, n, k, n_nal, n_rbsp, cap, align, append_tb, nal_out,       \
                                len_out, bits_out, ovf_out, probe_meta, probe_words, stream);
  switch (stage) {
    H264T_STAGE_CASE(kStageLaunch)
    H264T_STAGE_CASE(kStageStage)
    H264T_STAGE_CASE(kStageScan)
    H264T_STAGE_CASE(kStagePack)
    H264T_STAGE_CASE(kStageEp)
    H264T_STAGE_CASE(kStageFull)
    default:
      return cudaErrorInvalidValue;
  }
#undef H264T_STAGE_CASE
}

// P2: the largest kept stream, in words (65,536 bits).
constexpr int kU16MaxWords = 2048;

// P2's staging area: 4 bytes of pattern and 1 of width a symbol.
__host__ __device__ __forceinline__ int u16_staging_bytes(int k) {
  return (5 * kPackThreads * k + 15) & ~15;
}

size_t u16_smem_bytes(int k, int n_words) {
  return (size_t)u16_staging_bytes(k) + 4 * (size_t)n_words;
}

template <typename Sym>
__global__ void __launch_bounds__(kPackThreads, 3)
    pack_u16_kernel(const Sym* __restrict__ pat, const Sym* __restrict__ nb, long long pat_row,
                    long long nb_row, int n, int k, int n_words, uint32_t* __restrict__ words_out,
                    int32_t* __restrict__ total_out) {
  extern __shared__ uint4 pack_smem[];  // 16-byte aligned
  uint8_t* smem = reinterpret_cast<uint8_t*>(pack_smem);
  __shared__ int tmp_sum[kPackWarps];
  const int s = blockIdx.x;
  uint32_t* spat = reinterpret_cast<uint32_t*>(smem);
  uint8_t* snb = smem + 4 * kPackThreads * k;
  uint32_t* words = reinterpret_cast<uint32_t*>(smem + u16_staging_bytes(k));
  for (int i = threadIdx.x; i < n_words; i += kPackThreads) words[i] = 0;
  const Sym* p = pat + s * pat_row;
  const Sym* w = nb + s * nb_row;
  const int chunk = kPackThreads * k;
  const int r0 = threadIdx.x * k;
  const uint32_t kept = (uint32_t)n_words << 5;
  uint32_t carry = 0;  // low 16 bits: position in the kept stream; above: carry-out
  for (int base = 0; base < n; base += chunk) {
    if (base > 0) __syncthreads();  // the previous chunk is placed
    for (int j = 0; j < k; ++j) {
      const int c = j * kPackThreads + threadIdx.x;  // coalesced
      if (base + c < n) {
        cp_async4(&spat[c], &p[base + c]);
        const int v = (int)w[base + c];
        snb[c] = (uint8_t)(v < 0 ? 0 : v);  // K2 packs a negative width as none
      } else {
        spat[c] = 0;
        snb[c] = 0;
      }
    }
    cp_async_wait_all();
    __syncthreads();
    int run = 0;
    for (int j = 0; j < k; ++j) run += snb[r0 + j];
    int excl, total;
    scan_once(run, 0, SumOp(), tmp_sum, excl, total);
    const uint32_t start = carry + (uint32_t)excl;
    if (start < kept) {
      place_run(spat + r0, snb + r0, k, false, (int)start, (int)start + run, words, n_words);
    }
    carry += (uint32_t)total;
  }
  __syncthreads();
  uint32_t* out = words_out + (size_t)s * n_words;
  for (int i = threadIdx.x; i < n_words; i += kPackThreads) out[i] = words[i];
  if (threadIdx.x == 0) total_out[s] = (int32_t)carry;
}

template <typename Sym>
const void* u16_kernel_of() {
  return (const void*)pack_u16_kernel<Sym>;
}

const void* u16_kernel_of(int sym_bytes) {
  return sym_bytes == 8 ? u16_kernel_of<int64_t>()
                        : sym_bytes == 4 ? u16_kernel_of<int32_t>() : nullptr;
}

// P3: one session's staging area and words in the block, 16-byte aligned.
__host__ __device__ __forceinline__ size_t tiled_group_bytes(int threads, int k, int n_words) {
  return (size_t)8 * threads * k + (((size_t)4 * n_words + 15) & ~(size_t)15);
}

template <int T, typename Sym>
__global__ void __launch_bounds__(kPackThreads, 2)
    pack_tiled_kernel(const Sym* __restrict__ pat, const Sym* __restrict__ nb, long long pat_row,
                      long long nb_row, int n, int k, int n_words,
                      uint32_t* __restrict__ words_out, int32_t* __restrict__ total_out) {
  constexpr int G = kPackThreads / T;
  extern __shared__ uint4 pack_smem[];  // 16-byte aligned
  __shared__ PosMap tmp_map[T][G / 32];
  const int grp = threadIdx.x / G;
  const TileGroup<G> g{grp};
  const int s = blockIdx.x * T + grp;
  uint8_t* smem = reinterpret_cast<uint8_t*>(pack_smem) + grp * tiled_group_bytes(G, k, n_words);
  uint32_t* spat = reinterpret_cast<uint32_t*>(smem);
  int32_t* snb = reinterpret_cast<int32_t*>(smem + 4 * G * k);
  uint32_t* words = reinterpret_cast<uint32_t*>(smem + 8 * G * k);
  for (int i = g.rank(); i < n_words; i += G) words[i] = 0;
  int bad = 0;
  const int total_bits =
      pack_session<kStageFull>(pat + s * pat_row, nb + s * nb_row, n, k, false, spat, snb, words,
                               n_words, tmp_map[grp], bad, nullptr, g);
  g.sync();
  uint32_t* out = words_out + (size_t)s * n_words;
  for (int i = g.rank(); i < n_words; i += G) out[i] = words[i];
  if (g.rank() == 0) total_out[s] = total_bits;
}

template <typename Sym>
const void* tiled_kernel_of(int tile) {
  switch (tile) {
    case 1: return (const void*)pack_tiled_kernel<1, Sym>;
    case 2: return (const void*)pack_tiled_kernel<2, Sym>;
    case 4: return (const void*)pack_tiled_kernel<4, Sym>;
    case 8: return (const void*)pack_tiled_kernel<8, Sym>;
    case 16: return (const void*)pack_tiled_kernel<16, Sym>;
    default: return nullptr;
  }
}

const void* tiled_kernel_of(int tile, int sym_bytes) {
  return sym_bytes == 8 ? tiled_kernel_of<int64_t>(tile)
                        : sym_bytes == 4 ? tiled_kernel_of<int32_t>(tile) : nullptr;
}

size_t tiled_smem_bytes(int tile, int k, int n_words) {
  return (size_t)tile * tiled_group_bytes(kPackThreads / tile, k, n_words);
}

template <int T, typename Sym>
void launch_tiled(const void* pat, const void* nb, long long pat_row, long long nb_row, int batch,
                  int n, int k, int n_words, uint32_t* words_out, int32_t* total_out, size_t smem,
                  cudaStream_t stream) {
  pack_tiled_kernel<T, Sym><<<batch / T, kPackThreads, smem, stream>>>(
      static_cast<const Sym*>(pat), static_cast<const Sym*>(nb), pat_row, nb_row, n, k, n_words,
      words_out, total_out);
}

template <typename Sym>
void launch_tiled_of(int tile, const void* pat, const void* nb, long long pat_row,
                     long long nb_row, int batch, int n, int k, int n_words, uint32_t* words_out,
                     int32_t* total_out, size_t smem, cudaStream_t stream) {
  switch (tile) {
    case 1: launch_tiled<1, Sym>(pat, nb, pat_row, nb_row, batch, n, k, n_words, words_out, total_out, smem, stream); break;
    case 2: launch_tiled<2, Sym>(pat, nb, pat_row, nb_row, batch, n, k, n_words, words_out, total_out, smem, stream); break;
    case 4: launch_tiled<4, Sym>(pat, nb, pat_row, nb_row, batch, n, k, n_words, words_out, total_out, smem, stream); break;
    case 8: launch_tiled<8, Sym>(pat, nb, pat_row, nb_row, batch, n, k, n_words, words_out, total_out, smem, stream); break;
    case 16: launch_tiled<16, Sym>(pat, nb, pat_row, nb_row, batch, n, k, n_words, words_out, total_out, smem, stream); break;
  }
}

// P5/P6: K3's session with the emulation-prevention stage `Variant`.
template <int Variant>
__global__ void __launch_bounds__(kPackThreads, 2)
    ebsp_variant_kernel(const uint8_t* __restrict__ rbsp, long long rbsp_row, int m,
                        const int64_t* __restrict__ rbsp_len, long long len_row, int header,
                        int padded, int n_nal, int max_ins, int in_global,
                        uint8_t* __restrict__ nal_out, int32_t* __restrict__ total_out) {
  ebsp_session<Variant>(rbsp, rbsp_row, m, rbsp_len, len_row, header, padded, n_nal, max_ins,
                        in_global, nal_out, total_out);
}

const void* ebsp_variant_of(int variant) {
  switch (variant) {
    case kEpRuns: return (const void*)ebsp_variant_kernel<kEpRuns>;
    case kEpBallot: return (const void*)ebsp_variant_kernel<kEpBallot>;
    case kEpLanes: return (const void*)ebsp_variant_kernel<kEpLanes>;
    default: return nullptr;
  }
}

}  // namespace

// P1.  K1's arguments (h264t_emit_fused, with the cluster K1's wrapper
// takes), the stage (0 launch, 1 stage, 2 scan, 3 pack, 4 ep, 5 full), and
// the cut stages' outputs: probe_meta i32[batch, 4] and, for `pack`,
// probe_words i32[batch, n_nal / 4] (the uint32 words).  `full` writes
// K1's outputs; `ep` on the cluster plan builds its NAL in nal_out.
extern "C" int h264t_emit_stage(int stage, const void* pat, const void* nb, int sym_bytes,
                                long long pat_row, long long nb_row, const int32_t* idc,
                                long long idc_row, int idc_value, int batch, int n, int k,
                                int n_nal, int n_rbsp, int cap, int align, int append_tb,
                                int cluster, uint8_t* nal_out, int32_t* len_out,
                                int32_t* bits_out, uint8_t* ovf_out, int32_t* probe_meta,
                                int32_t* probe_words, void* stream) {
  if (stage < kStageLaunch || stage > kStageFull || (sym_bytes != 4 && sym_bytes != 8) ||
      n_nal < 16 || n_nal % 4 != 0 || k < 1 || !valid_cluster(cluster))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (sym_bytes == 8) {
    return (int)launch_stage_of<int64_t>(stage, cluster, pat, nb, pat_row, nb_row, idc, idc_row,
                                         idc_value, batch, n, k, n_nal, n_rbsp, cap, align,
                                         append_tb, nal_out, len_out, bits_out, ovf_out,
                                         probe_meta, probe_words, st);
  }
  return (int)launch_stage_of<int32_t>(stage, cluster, pat, nb, pat_row, nb_row, idc, idc_row,
                                       idc_value, batch, n, k, n_nal, n_rbsp, cap, align,
                                       append_tb, nal_out, len_out, bits_out, ovf_out, probe_meta,
                                       probe_words, st);
}

// P2.  K2's arguments without the cluster: n_words <= 2,048
// (else cudaErrorInvalidValue, launching nothing); outputs words_out
// u32[batch, n_words] and total_out i32[batch], as K2's.
extern "C" int h264t_pack_place_u16(const void* pat, const void* nb, int sym_bytes,
                                    long long pat_row, long long nb_row, int batch, int n, int k,
                                    int n_words, uint32_t* words_out, int32_t* total_out,
                                    void* stream) {
  const void* kernel = u16_kernel_of(sym_bytes);
  if (kernel == nullptr || k < 1 || n_words < 0 || n_words > kU16MaxWords)
    return (int)cudaErrorInvalidValue;
  const size_t smem = u16_smem_bytes(k, n_words);
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  if (sym_bytes == 8) {
    pack_u16_kernel<int64_t><<<batch, kPackThreads, smem, st>>>(
        static_cast<const int64_t*>(pat), static_cast<const int64_t*>(nb), pat_row, nb_row, n, k,
        n_words, words_out, total_out);
  } else {
    pack_u16_kernel<int32_t><<<batch, kPackThreads, smem, st>>>(
        static_cast<const int32_t*>(pat), static_cast<const int32_t*>(nb), pat_row, nb_row, n, k,
        n_words, words_out, total_out);
  }
  return (int)cudaGetLastError();
}

// The largest words P2 keeps (its wrapper refuses more).
extern "C" int h264t_pack_u16_max_words() { return kU16MaxWords; }

// P3.  K2's arguments without the cluster, the tile T (1, 2, 4,
// 8 or 16; batch % T == 0) and k as h264t_pack_tiled_items gives it.
extern "C" int h264t_pack_place_tiled(int tile, const void* pat, const void* nb, int sym_bytes,
                                      long long pat_row, long long nb_row, int batch, int n,
                                      int k, int n_words, uint32_t* words_out, int32_t* total_out,
                                      void* stream) {
  const void* kernel = tiled_kernel_of(tile, sym_bytes);
  if (kernel == nullptr || k < 1 || n_words < 0 || batch % tile != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = tiled_smem_bytes(tile, k, n_words);
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  if (sym_bytes == 8) {
    launch_tiled_of<int64_t>(tile, pat, nb, pat_row, nb_row, batch, n, k, n_words, words_out,
                             total_out, smem, st);
  } else {
    launch_tiled_of<int32_t>(tile, pat, nb, pat_row, nb_row, batch, n, k, n_words, words_out,
                             total_out, smem, st);
  }
  return (int)cudaGetLastError();
}

// P3's symbols per thread for n symbols a session: ceil(n / (threads / T))
// capped at max_items, then lowered until T sessions' staging and words fit
// a block on the current device; 0 where not even k = 1 fits, -1 if the
// runtime cannot say.  Launches nothing.
extern "C" int h264t_pack_tiled_items(int sym_bytes, int tile, int n, int n_words,
                                      int max_items) {
  const void* kernel = tiled_kernel_of(tile, sym_bytes);
  if (kernel == nullptr) return -1;
  const size_t limit = dynamic_smem_limit(kernel);
  if (limit == 0) return -1;
  const int threads = kPackThreads / tile;
  int k = (n + threads - 1) / threads;
  k = k < 1 ? 1 : (k > max_items ? max_items : k);
  while (k >= 1 && tiled_smem_bytes(tile, k, n_words) > limit) --k;
  return k;
}

// Resident blocks per SM on the current device (-1 if the runtime cannot
// say; launches nothing): P2 at (sym_bytes, k, n_words); P3 at a tile.
extern "C" int h264t_pack_u16_blocks_per_sm(int sym_bytes, int k, int n_words) {
  const void* kernel = u16_kernel_of(sym_bytes);
  return kernel ? blocks_per_sm(kernel, kPackThreads, u16_smem_bytes(k, n_words)) : -1;
}

extern "C" int h264t_pack_tiled_blocks_per_sm(int tile, int sym_bytes, int k, int n_words) {
  const void* kernel = tiled_kernel_of(tile, sym_bytes);
  return kernel ? blocks_per_sm(kernel, kPackThreads, tiled_smem_bytes(tile, k, n_words)) : -1;
}

// P5/P6.  K3's arguments (h264t_ebsp_nal) after the stage: 0 runs (K3's
// own, also P6's `shared` and, with in_global 1, `direct`), 1 ballot, 2
// lanes.  in_global 1 is taken by the runs stage only (else
// cudaErrorInvalidValue, launching nothing); a staged session of ballot or
// lanes also holds its masks or lanes after the NAL (ebsp_extra_smem), and
// a block that cannot fail with the attribute call's error.
extern "C" int h264t_ebsp_variant(int variant, const uint8_t* rbsp, long long rbsp_row, int m,
                                  const int64_t* rbsp_len, long long len_row, int header,
                                  int batch, int n_nal, int max_ins, int in_global,
                                  uint8_t* nal_out, int32_t* total_out, void* stream) {
  const void* kernel = ebsp_variant_of(variant);
  if (kernel == nullptr || n_nal < 0 || m < 0 || rbsp_len == nullptr ||
      (in_global && variant != kEpRuns))
    return (int)cudaErrorInvalidValue;
  const int padded = ebsp_padded(n_nal);
  const size_t smem = in_global ? 0 : ebsp_smem(n_nal) + ebsp_extra_smem(variant, padded);
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
#define H264T_VARIANT_CASE(V)                                                                 \
  case V:                                                                                     \
    ebsp_variant_kernel<V><<<batch, kPackThreads, smem, st>>>(rbsp, rbsp_row, m, rbsp_len,    \
                                                              len_row, header, padded, n_nal, \
                                                              max_ins, in_global != 0,        \
                                                              nal_out, total_out);            \
    break;
  switch (variant) {
    H264T_VARIANT_CASE(kEpRuns)
    H264T_VARIANT_CASE(kEpBallot)
    H264T_VARIANT_CASE(kEpLanes)
  }
#undef H264T_VARIANT_CASE
  return (int)cudaGetLastError();
}
