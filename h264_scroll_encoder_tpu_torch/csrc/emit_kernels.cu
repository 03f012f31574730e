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
// (pattern, nbits) symbols — 74 KB as the symbol stage hands them (int32,
// the JAX package's widths), 147 KB as int64 — and writes an 8 KB NAL (K1)
// or 8 KB of 32-bit words (K2/K4); everything in between stays in shared
// memory.  With one block
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
//     int32 or int64 element, so the kernel reads the symbol stage's int32
//     tensors in place and nothing converts them first.  One wait, one
//     barrier.
//   - Pack.  Each thread owns a contiguous run of k = ceil(n / 512) symbols
//     (19 at 720p; odd k reads shared memory without bank conflicts).  It
//     composes its run's position map serially; one block scan (one
//     barrier) gives each run its start bit; the thread packs its run in a
//     64-bit register window and stores the words that lie wholly inside
//     its run with plain shared stores, OR-ing atomically only the <= 2
//     words it shares with its neighbours.
//   - Emulation prevention (K1).  `emulation_prevention` (emit_device.cuh),
//     over the packed words: the NAL is assembled in shared memory over
//     the dead staging area and written out with 16-byte stores.
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
// a call at B = 256, ~1.1 us at the card's memory rate (counted from a
// run's lengths).  Its work per byte is a few integer
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
//   - Emulation prevention, shared with K1: `emulation_prevention`
//     (emit_device.cuh), a template over the byte accessor (K1:
//     MSB-first packed words; K3: staged bytes) and the window rule (K1:
//     16 words; K3: 64 bytes).
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
// Large frames: the cluster plan.  K1 keeps the staging area (reused for
// the NAL) and the packed RBSP words in shared memory: max(8 * kPackThreads
// * k, n_nal) + n_nal bytes, 232,448 at most on an H100 (every 720p path
// fits).  Past that (4K and 5K hint frames, 129,728-259,328 NAL bytes; the
// 720p dense frame of I_PCM donors, 237,600) one block a session would hold
// the session on one SM of 132 and keep its words in global memory, as the
// earlier global-memory plans did: 0.16 ms for the 5120x3200 hint frame,
// 233x its bound (PERF.md).  Instead the session runs on a cluster of C
// blocks (emit_cluster_session and cluster_pack in emit_device.cuh), C the
// smallest of 2, 4, 8 and 16 for which each block stages its share of
// ceil(n / C) symbols in one chunk of at most 33 a thread (132 KB; an odd
// count, so that the threads' runs fall into different banks) beside its
// slice of ceil(n_words / C) words:
//   - Pack.  Each block composes its share's position map; the blocks
//     publish them in shared memory, and after one cluster barrier every
//     warp scans the C maps over DSMEM for its block's start bit.  Each
//     thread places its run wherever its bits fall, into its own block's
//     slice or another's through DSMEM, storing whole words and ORing
//     shared ones atomically, as within one block.  Bits fall very
//     unevenly (a 5120x3200 hint frame has 6,182 bits in 256,040 symbols),
//     so a block's symbols and its slice are not the same range.
//   - Emulation prevention (K1).  Each block runs the rule over its own
//     slice's bytes; the last nonzero byte before the block and the
//     insertions before it are exclusive scans across the cluster (two
//     more cluster barriers).  Each block escapes its bytes into its
//     piece of the NAL in the dead staging area, offset to the output
//     row's alignment, and stores the piece at its offset in the row in
//     16-byte stores; the zeros after the payload are shared out over all
//     the cluster's threads.
// The cluster is one launch (cudaLaunchKernelEx), so launch counters and
// graphed steps see one launch per call; K2/K4 take the same plan past one
// block's words (past about 33,500 MBs for the exact retry).
// `h264t_emit_plan` and `h264t_pack_plan` answer the wrappers with C, so
// the formulas live here (and in ops/emit_fused.py's plain model).  K3
// stages the padded row and then the NAL (~2 * n_nal): past a block's
// limit (n_nal over ~116 KB) it reads the row from global memory and
// builds the NAL in place in its output row (`h264t_ebsp_nal_in_global`).
//
// The device code the kernels share (staging, scans, pack, emulation
// prevention, copy-out, K1's and K3's sessions) lives in emit_device.cuh,
// which the measurement probes (probe_kernels.cu) include too.
//
// Plain C interface (bound with ctypes): each entry launches on the given
// stream, allocates nothing, and returns cudaGetLastError() of its launch.

#include "emit_device.cuh"

namespace {

// K1: one session per block (emit_session in emit_device.cuh, all of it).
template <typename Sym>
__global__ void __launch_bounds__(kPackThreads, 2)
    emit_fused_kernel(const Sym* __restrict__ pat, const Sym* __restrict__ nb, long long pat_row,
                      long long nb_row, const int32_t* __restrict__ idc, long long idc_row,
                      int idc_value, int n, int k, int n_nal, int n_rbsp, int cap, int align,
                      int append_tb, uint8_t* __restrict__ nal_out, int32_t* __restrict__ len_out,
                      int32_t* __restrict__ bits_out, uint8_t* __restrict__ ovf_out) {
  emit_session<kStageFull>(pat, nb, pat_row, nb_row, idc, idc_row, idc_value, n, k, n_nal, n_rbsp,
                           cap, align, append_tb, nal_out, len_out, bits_out, ovf_out, nullptr,
                           nullptr);
}

// K1 on the cluster plan: one session per cluster (emit_cluster_session).
template <typename Sym>
__global__ void __launch_bounds__(kPackThreads, 1)
    emit_fused_cluster_kernel(const Sym* __restrict__ pat, const Sym* __restrict__ nb,
                              long long pat_row, long long nb_row,
                              const int32_t* __restrict__ idc, long long idc_row, int idc_value,
                              int n, int k, int n_nal, int n_rbsp, int cap, int align,
                              int append_tb, uint8_t* __restrict__ nal_out,
                              int32_t* __restrict__ len_out, int32_t* __restrict__ bits_out,
                              uint8_t* __restrict__ ovf_out) {
  emit_cluster_session<kStageFull>(pat, nb, pat_row, nb_row, idc, idc_row, idc_value, n, k, n_nal,
                                   n_rbsp, cap, align, append_tb, nal_out, len_out, bits_out,
                                   ovf_out, nullptr, nullptr);
}

template <typename Sym>
__global__ void __launch_bounds__(kPackThreads, 2)
    pack_place_kernel(const Sym* __restrict__ pat, const Sym* __restrict__ nb, long long pat_row,
                      long long nb_row, int n, int k, int n_words,
                      uint32_t* __restrict__ words_out, int32_t* __restrict__ total_out) {
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
  uint32_t* out = words_out + (size_t)s * n_words;
  for (int i = threadIdx.x; i < n_words; i += kPackThreads) out[i] = words[i];
  if (threadIdx.x == 0) total_out[s] = total_bits;
}

// K2/K4 on the cluster plan: one session per cluster (cluster_pack in
// emit_device.cuh); each block writes its slice of the words once the
// cluster has placed them all.
template <typename Sym>
__global__ void __launch_bounds__(kPackThreads, 1)
    pack_place_cluster_kernel(const Sym* __restrict__ pat, const Sym* __restrict__ nb,
                              long long pat_row, long long nb_row, int n, int k, int n_words,
                              uint32_t* __restrict__ words_out, int32_t* __restrict__ total_out) {
  extern __shared__ uint4 pack_smem[];  // 16-byte aligned
  uint8_t* smem = reinterpret_cast<uint8_t*>(pack_smem);
  __shared__ PosMap tmp_map[kPackWarps];
  __shared__ ClusterBlock cb;
  cg::cluster_group cl = cg::this_cluster();
  const int c = (int)cl.dim_blocks().x;
  const int r = (int)cl.block_rank();
  const int s = blockIdx.x / c;
  const int slice = cluster_slice(n_words, c);
  const int w_lo = min(r * slice, n_words);
  const int w_hi = min(w_lo + slice, n_words);
  const int share = cluster_share(n, c);
  const int i_lo = min(r * share, n);
  const int i_hi = min(i_lo + share, n);
  uint32_t* spat = reinterpret_cast<uint32_t*>(smem);
  int32_t* snb = reinterpret_cast<int32_t*>(smem + 4 * kPackThreads * k);
  uint32_t* words = reinterpret_cast<uint32_t*>(smem + cluster_stage_bytes(k, slice));
  for (int i = threadIdx.x; i < slice; i += kPackThreads) words[i] = 0;
  int bad = 0;
  const int total_bits = cluster_pack<kStageFull>(
      pat + s * pat_row + i_lo, nb + s * nb_row + i_lo, i_hi - i_lo, k, false, spat, snb,
      ClusterWords{words, slice, n_words}, tmp_map, &cb, bad, nullptr);
  cluster_sync();  // every run is placed; no block reads another's memory after this
  uint32_t* out = words_out + (size_t)s * n_words;
  for (int i = w_lo + threadIdx.x; i < w_hi; i += kPackThreads) out[i] = words[i - w_lo];
  if (r == 0 && threadIdx.x == 0) total_out[s] = total_bits;
}

// K3: one session per block (ebsp_session in emit_device.cuh, its default
// stage).
__global__ void __launch_bounds__(kPackThreads, 2)
    ebsp_nal_kernel(const uint8_t* __restrict__ rbsp, long long rbsp_row, int m,
                    const int64_t* __restrict__ rbsp_len, long long len_row, int header,
                    int padded, int n_nal, int max_ins, int in_global,
                    uint8_t* __restrict__ nal_out, int32_t* __restrict__ total_out) {
  ebsp_session(rbsp, rbsp_row, m, rbsp_len, len_row, header, padded, n_nal, max_ins, in_global,
               nal_out, total_out);
}

const void* emit_kernel_of(int sym_bytes, int cluster) {
  if (cluster > 1) {
    return sym_bytes == 8 ? (const void*)emit_fused_cluster_kernel<int64_t>
                          : (const void*)emit_fused_cluster_kernel<int32_t>;
  }
  return sym_bytes == 8 ? (const void*)emit_fused_kernel<int64_t>
                        : (const void*)emit_fused_kernel<int32_t>;
}

const void* pack_kernel_of(int sym_bytes, int cluster) {
  if (cluster > 1) {
    return sym_bytes == 8 ? (const void*)pack_place_cluster_kernel<int64_t>
                          : (const void*)pack_place_cluster_kernel<int32_t>;
  }
  return sym_bytes == 8 ? (const void*)pack_place_kernel<int64_t>
                        : (const void*)pack_place_kernel<int32_t>;
}

// K1's and K2/K4's dynamic shared memory a block on `cluster` blocks a
// session (1: one block).
size_t emit_smem_of(int k, int n_nal, int cluster) {
  return cluster > 1 ? cluster_smem(k, n_nal >> 2, cluster) : emit_smem(k, n_nal);
}

size_t pack_smem_of(int k, int n_words, int cluster) {
  return cluster > 1 ? cluster_smem(k, n_words, cluster) : pack_smem_bytes(k, n_words);
}

template <typename Sym>
cudaError_t launch_emit(const void* pat, const void* nb, long long pat_row, long long nb_row,
                        const int32_t* idc, long long idc_row, int idc_value, int batch, int n,
                        int k, int n_nal, int n_rbsp, int cap, int align, int append_tb,
                        int cluster, uint8_t* nal_out, int32_t* len_out, int32_t* bits_out,
                        uint8_t* ovf_out, cudaStream_t stream) {
  const Sym* p = static_cast<const Sym*>(pat);
  const Sym* q = static_cast<const Sym*>(nb);
  const size_t smem = emit_smem_of(k, n_nal, cluster);
  if (cluster > 1) {
    return launch_clusters(emit_fused_cluster_kernel<Sym>, batch, cluster, kPackThreads, smem,
                           stream, p, q, pat_row, nb_row, idc, idc_row, idc_value, n, k, n_nal,
                           n_rbsp, cap, align, append_tb, nal_out, len_out, bits_out, ovf_out);
  }
  cudaError_t err = set_smem((const void*)emit_fused_kernel<Sym>, smem);
  if (err != cudaSuccess) return err;
  emit_fused_kernel<Sym><<<batch, kPackThreads, smem, stream>>>(
      p, q, pat_row, nb_row, idc, idc_row, idc_value, n, k, n_nal, n_rbsp, cap, align, append_tb,
      nal_out, len_out, bits_out, ovf_out);
  return cudaGetLastError();
}

template <typename Sym>
cudaError_t launch_pack(const void* pat, const void* nb, long long pat_row, long long nb_row,
                        int batch, int n, int k, int n_words, int cluster, uint32_t* words_out,
                        int32_t* total_out, cudaStream_t stream) {
  const Sym* p = static_cast<const Sym*>(pat);
  const Sym* q = static_cast<const Sym*>(nb);
  const size_t smem = pack_smem_of(k, n_words, cluster);
  if (cluster > 1) {
    return launch_clusters(pack_place_cluster_kernel<Sym>, batch, cluster, kPackThreads, smem,
                           stream, p, q, pat_row, nb_row, n, k, n_words, words_out, total_out);
  }
  cudaError_t err = set_smem((const void*)pack_place_kernel<Sym>, smem);
  if (err != cudaSuccess) return err;
  pack_place_kernel<Sym><<<batch, kPackThreads, smem, stream>>>(p, q, pat_row, nb_row, n, k,
                                                                n_words, words_out, total_out);
  return cudaGetLastError();
}

}  // namespace

// K1.  pat, nb: [batch, n] rows of int32 (sym_bytes 4) or int64 (8)
// elements with unit column stride and the given row strides, staged k per
// thread (k >= 1); nal_ref_idc is idc[s * idc_row] (int32) or, where idc
// is null, idc_value.  cluster: the blocks a session, 1 (one block) or
// the cluster plan's C in {2, 4, 8, 16}, as h264t_emit_plan says (k then
// as h264t_cluster_items).  Outputs: nal_out u8[batch, n_nal], len_out,
// bits_out i32[batch], ovf_out bool[batch].  A block that needs more
// shared memory than the card allows, or a cluster the card cannot hold,
// fails with the runtime's error.
extern "C" int h264t_emit_fused(const void* pat, const void* nb, int sym_bytes,
                                long long pat_row, long long nb_row, const int32_t* idc,
                                long long idc_row, int idc_value, int batch, int n, int k,
                                int n_nal, int n_rbsp, int cap, int align, int append_tb,
                                int cluster, uint8_t* nal_out, int32_t* len_out,
                                int32_t* bits_out, uint8_t* ovf_out, void* stream) {
  if (n_nal < 16 || n_nal % 4 != 0 || k < 1 || !valid_cluster(cluster))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (sym_bytes == 8)
    return (int)launch_emit<int64_t>(pat, nb, pat_row, nb_row, idc, idc_row, idc_value, batch, n,
                                     k, n_nal, n_rbsp, cap, align, append_tb, cluster, nal_out,
                                     len_out, bits_out, ovf_out, st);
  if (sym_bytes == 4)
    return (int)launch_emit<int32_t>(pat, nb, pat_row, nb_row, idc, idc_row, idc_value, batch, n,
                                     k, n_nal, n_rbsp, cap, align, append_tb, cluster, nal_out,
                                     len_out, bits_out, ovf_out, st);
  return (int)cudaErrorInvalidValue;
}

// K1's plan for sessions of n symbols (k a thread with one block) into
// n_nal NAL bytes on the current device: the blocks a session, 1 or the
// cluster plan's C (session_plan in emit_device.cuh); 0 where nothing
// fits, -1 if the runtime cannot say.  Launches nothing.
extern "C" int h264t_emit_plan(int sym_bytes, int n, int k, int n_nal) {
  if (sym_bytes != 4 && sym_bytes != 8) return -1;
  return session_plan(emit_kernel_of(sym_bytes, 1), emit_smem(k, n_nal),
                      emit_kernel_of(sym_bytes, kMaxCluster), n, n_nal >> 2);
}

// K2.  pat, nb, k and cluster as for K1 (h264t_pack_plan gives the
// cluster); outputs words_out u32[batch, n_words] (the JAX package's uint32
// words; an int32 tensor holds their bits) and total_out i32[batch].
extern "C" int h264t_pack_place(const void* pat, const void* nb, int sym_bytes, long long pat_row,
                                long long nb_row, int batch, int n, int k, int n_words,
                                int cluster, uint32_t* words_out, int32_t* total_out,
                                void* stream) {
  if (k < 1 || !valid_cluster(cluster)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (sym_bytes == 8)
    return (int)launch_pack<int64_t>(pat, nb, pat_row, nb_row, batch, n, k, n_words, cluster,
                                     words_out, total_out, st);
  if (sym_bytes == 4)
    return (int)launch_pack<int32_t>(pat, nb, pat_row, nb_row, batch, n, k, n_words, cluster,
                                     words_out, total_out, st);
  return (int)cudaErrorInvalidValue;
}

// As h264t_emit_plan, for K2/K4 at (sym_bytes, n, k, n_words).
extern "C" int h264t_pack_plan(int sym_bytes, int n, int k, int n_words) {
  if (sym_bytes != 4 && sym_bytes != 8) return -1;
  return session_plan(pack_kernel_of(sym_bytes, 1), pack_smem_bytes(k, n_words),
                      pack_kernel_of(sym_bytes, kMaxCluster), n, n_words);
}

// Symbols a thread of a cluster block owns per staged chunk, for sessions
// of n symbols on clusters of c blocks (ops/emit_fused.
// cluster_items_per_thread is held to this on the card).
extern "C" int h264t_cluster_items(int n, int c) { return cluster_items(n, c); }

// K3.  rbsp: [batch, m] bytes with unit column stride and row stride
// rbsp_row; rbsp_len: int64, session s's at s * len_row (0 broadcasts one);
// header: the NAL header byte; in_global as h264t_ebsp_nal_in_global says.
// Outputs nal_out u8[batch, n_nal] and total_out i32[batch].
extern "C" int h264t_ebsp_nal(const uint8_t* rbsp, long long rbsp_row, int m,
                              const int64_t* rbsp_len, long long len_row, int header, int batch,
                              int n_nal, int max_ins, int in_global, uint8_t* nal_out,
                              int32_t* total_out, void* stream) {
  if (n_nal < 0 || m < 0 || rbsp_len == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = in_global ? 0 : ebsp_smem(n_nal);
  cudaError_t err = set_smem((const void*)ebsp_nal_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ebsp_nal_kernel<<<batch, kPackThreads, smem, (cudaStream_t)stream>>>(
      rbsp, rbsp_row, m, rbsp_len, len_row, header, ebsp_padded(n_nal), n_nal, max_ins,
      in_global != 0, nal_out, total_out);
  return (int)cudaGetLastError();
}

// 1 where K3 at n_nal reads its rows from global memory and builds the NAL
// in place on the current device (the staged row and the NAL exceed a
// block's shared memory), 0 where both stay in shared memory, -1 if the
// runtime cannot say.  Launches nothing.
extern "C" int h264t_ebsp_nal_in_global(int n_nal) {
  const size_t limit = dynamic_smem_limit((const void*)ebsp_nal_kernel);
  return limit == 0 ? -1 : ebsp_smem(n_nal) > limit ? 1 : 0;
}

// K3's bytes per thread for a session of `valid` bytes, as the kernel
// computes them (ops/ebsp_flat.items_per_thread is held to this on the card).
extern "C" int h264t_ebsp_items_per_thread(int valid) { return ebsp_items_per_thread(valid); }

extern "C" int h264t_pack_words(const void* pat, const void* nb, int sym_bytes, long long pat_row,
                                long long nb_row, int batch, int n, int k, int n_words,
                                int cluster, uint32_t* words_out, int32_t* total_out,
                                void* stream) {
  return h264t_pack_place(pat, nb, sym_bytes, pat_row, nb_row, batch, n, k, n_words, cluster,
                          words_out, total_out, stream);
}

// Resident blocks per SM of K1 at (sym_bytes, k, n_nal) on `cluster`
// blocks a session, and of K2/K4 at (sym_bytes, k, n_words), on the
// current device; -1 if the runtime cannot say.  Launches nothing.
extern "C" int h264t_emit_blocks_per_sm(int sym_bytes, int k, int n_nal, int cluster) {
  if ((sym_bytes != 4 && sym_bytes != 8) || !valid_cluster(cluster)) return -1;
  return blocks_per_sm(emit_kernel_of(sym_bytes, cluster), kPackThreads,
                       emit_smem_of(k, n_nal, cluster));
}

extern "C" int h264t_pack_blocks_per_sm(int sym_bytes, int k, int n_words, int cluster) {
  if ((sym_bytes != 4 && sym_bytes != 8) || !valid_cluster(cluster)) return -1;
  return blocks_per_sm(pack_kernel_of(sym_bytes, cluster), kPackThreads,
                       pack_smem_of(k, n_words, cluster));
}
