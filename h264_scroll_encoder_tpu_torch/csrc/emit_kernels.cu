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
// Large frames.  K1 keeps the staging area (reused for the NAL) and the
// packed RBSP words in shared memory: max(8 * kPackThreads * k, n_nal) +
// n_nal bytes, 232,448 at most on an H100.  Its plans, tried in turn:
//   0  words and NAL in shared memory (every 720p path);
//   1  words in a global scratch buffer (`words_gmem`, n_words per
//      session) the wrapper allocates, NAL in shared memory: 3840x2160 at
//      the generic 32 bits per MB (n_nal 129,728, 259,456 bytes by plan 0);
//   3  words in the scratch and the NAL built in place in its output row,
//      so the block holds the staging area and the scan temporaries only
//      (98,304 bytes at most): n_nal past ~134,000 bytes, e.g. 3840x2160
//      at 64 bits per MB (259,328) or 5120x3200 at 32 (256,128).
// K2/K4 keep the words in a scratch past about 33,500 MBs (its exact
// retry).  K3 stages the padded row and then the NAL (~2 * n_nal): past a
// block's limit (n_nal over ~116 KB) it reads the row from global memory
// and builds the NAL in place in its output row.  The code is the same in
// every plan, through generic pointers, at global-memory latency for what
// left shared memory; where the NAL is built in place the copy-out writes
// only the bytes after the payload.  `h264t_emit_plan`,
// `h264t_pack_words_in_global` and `h264t_ebsp_nal_in_global` answer the
// wrappers from the shared-memory plan and the card's limit, so the
// formulas live here only.
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
                      long long nb_row, const int64_t* __restrict__ idc, long long idc_row,
                      int idc_value, int n, int k, int n_nal, int n_rbsp, int cap, int align,
                      int append_tb, uint32_t* __restrict__ words_gmem, int nal_in_global,
                      uint8_t* __restrict__ nal_out, int32_t* __restrict__ len_out,
                      int32_t* __restrict__ bits_out, uint8_t* __restrict__ ovf_out) {
  emit_session<kStageFull>(pat, nb, pat_row, nb_row, idc, idc_row, idc_value, n, k, n_nal, n_rbsp,
                           cap, align, append_tb, words_gmem, nal_in_global, nal_out, len_out,
                           bits_out, ovf_out, nullptr, nullptr);
}

template <typename Sym>
__global__ void __launch_bounds__(kPackThreads, 2)
    pack_place_kernel(const Sym* __restrict__ pat, const Sym* __restrict__ nb, long long pat_row,
                      long long nb_row, int n, int k, int n_words,
                      uint32_t* __restrict__ words_gmem, int64_t* __restrict__ words_out,
                      int64_t* __restrict__ total_out) {
  extern __shared__ uint4 pack_smem[];  // 16-byte aligned
  uint8_t* smem = reinterpret_cast<uint8_t*>(pack_smem);
  __shared__ PosMap tmp_map[kPackWarps];
  const int s = blockIdx.x;
  uint32_t* spat = reinterpret_cast<uint32_t*>(smem);
  int32_t* snb = reinterpret_cast<int32_t*>(smem + 4 * kPackThreads * k);
  uint32_t* words = words_gmem ? words_gmem + (size_t)s * n_words
                               : reinterpret_cast<uint32_t*>(smem + staging_bytes(k, 0));
  for (int i = threadIdx.x; i < n_words; i += kPackThreads) words[i] = 0;
  int bad = 0;
  const int total_bits = pack_session(pat + s * pat_row, nb + s * nb_row, n, k, false, spat,
                                      snb, words, n_words, tmp_map, bad);
  __syncthreads();
  int64_t* out = words_out + (size_t)s * n_words;
  for (int i = threadIdx.x; i < n_words; i += kPackThreads) out[i] = (int64_t)words[i];
  if (threadIdx.x == 0) total_out[s] = total_bits;
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

const void* emit_kernel_of(int sym_bytes) {
  return sym_bytes == 8 ? (const void*)emit_fused_kernel<int64_t>
                        : (const void*)emit_fused_kernel<int32_t>;
}

const void* pack_kernel_of(int sym_bytes) {
  return sym_bytes == 8 ? (const void*)pack_place_kernel<int64_t>
                        : (const void*)pack_place_kernel<int32_t>;
}

template <typename Sym>
cudaError_t launch_emit(const void* pat, const void* nb, long long pat_row, long long nb_row,
                        const int64_t* idc, long long idc_row, int idc_value, int batch, int n,
                        int k, int n_nal, int n_rbsp, int cap, int align, int append_tb,
                        uint32_t* words_gmem, int nal_in_global, uint8_t* nal_out,
                        int32_t* len_out, int32_t* bits_out, uint8_t* ovf_out,
                        cudaStream_t stream) {
  const int plan = (words_gmem ? kWordsInGlobal : 0) | (nal_in_global ? kNalInGlobal : 0);
  const size_t smem = emit_smem(k, n_nal, plan);
  cudaError_t err = set_smem((const void*)emit_fused_kernel<Sym>, smem);
  if (err != cudaSuccess) return err;
  emit_fused_kernel<Sym><<<batch, kPackThreads, smem, stream>>>(
      static_cast<const Sym*>(pat), static_cast<const Sym*>(nb), pat_row, nb_row, idc, idc_row,
      idc_value, n, k, n_nal, n_rbsp, cap, align, append_tb, words_gmem, nal_in_global != 0,
      nal_out, len_out, bits_out, ovf_out);
  return cudaGetLastError();
}

template <typename Sym>
cudaError_t launch_pack(const void* pat, const void* nb, long long pat_row, long long nb_row,
                        int batch, int n, int k, int n_words, uint32_t* words_gmem,
                        int64_t* words_out, int64_t* total_out, cudaStream_t stream) {
  const size_t smem = pack_smem_bytes(k, n_words, words_gmem != nullptr);
  cudaError_t err = set_smem((const void*)pack_place_kernel<Sym>, smem);
  if (err != cudaSuccess) return err;
  pack_place_kernel<Sym><<<batch, kPackThreads, smem, stream>>>(
      static_cast<const Sym*>(pat), static_cast<const Sym*>(nb), pat_row, nb_row, n, k, n_words,
      words_gmem, words_out, total_out);
  return cudaGetLastError();
}

}  // namespace

// K1.  pat, nb: [batch, n] rows of int32 (sym_bytes 4) or int64 (8)
// elements with unit column stride and the given row strides, staged k per
// thread (k >= 1); nal_ref_idc is idc[s * idc_row] (int64) or, where idc
// is null, idc_value.  words_gmem: null, or u32[batch, n_nal / 4] scratch,
// and nal_in_global 0 or 1, as h264t_emit_plan says.  Outputs: nal_out
// u8[batch, n_nal], len_out, bits_out i32[batch], ovf_out bool[batch].  A
// block that needs more shared memory than the card allows fails with the
// attribute call's error.
extern "C" int h264t_emit_fused(const void* pat, const void* nb, int sym_bytes,
                                long long pat_row, long long nb_row, const int64_t* idc,
                                long long idc_row, int idc_value, int batch, int n, int k,
                                int n_nal, int n_rbsp, int cap, int align, int append_tb,
                                uint32_t* words_gmem, int nal_in_global, uint8_t* nal_out,
                                int32_t* len_out, int32_t* bits_out, uint8_t* ovf_out,
                                void* stream) {
  if (n_nal < 16 || n_nal % 4 != 0 || k < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (sym_bytes == 8)
    return (int)launch_emit<int64_t>(pat, nb, pat_row, nb_row, idc, idc_row, idc_value, batch, n,
                                     k, n_nal, n_rbsp, cap, align, append_tb, words_gmem,
                                     nal_in_global, nal_out, len_out, bits_out, ovf_out, st);
  if (sym_bytes == 4)
    return (int)launch_emit<int32_t>(pat, nb, pat_row, nb_row, idc, idc_row, idc_value, batch, n,
                                     k, n_nal, n_rbsp, cap, align, append_tb, words_gmem,
                                     nal_in_global, nal_out, len_out, bits_out, ovf_out, st);
  return (int)cudaErrorInvalidValue;
}

// K1's plan at (sym_bytes, k, n_nal) on the current device: the first of 0
// (words and NAL in shared memory), 1 (words in global memory) and 3 (words
// and NAL in global memory) whose shared memory fits a block, as bits
// kWordsInGlobal | kNalInGlobal; 3 where none fits (the launch then fails),
// -1 if the runtime cannot say.  Launches nothing.
extern "C" int h264t_emit_plan(int sym_bytes, int k, int n_nal) {
  if (sym_bytes != 4 && sym_bytes != 8) return -1;
  const size_t limit = dynamic_smem_limit(emit_kernel_of(sym_bytes));
  if (limit == 0) return -1;
  const int plans[] = {0, kWordsInGlobal, kWordsInGlobal | kNalInGlobal};
  for (int plan : plans) {
    if (emit_smem(k, n_nal, plan) <= limit) return plan;
  }
  return kWordsInGlobal | kNalInGlobal;
}

// K2.  pat, nb and k as for K1; words_gmem null, or u32[batch, n_words]
// scratch where h264t_pack_words_in_global says so; outputs words_out
// i64[batch, n_words] (uint32 values) and total_out i64[batch].
extern "C" int h264t_pack_place(const void* pat, const void* nb, int sym_bytes, long long pat_row,
                                long long nb_row, int batch, int n, int k, int n_words,
                                uint32_t* words_gmem, int64_t* words_out, int64_t* total_out,
                                void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (sym_bytes == 8)
    return (int)launch_pack<int64_t>(pat, nb, pat_row, nb_row, batch, n, k, n_words, words_gmem,
                                     words_out, total_out, st);
  if (sym_bytes == 4)
    return (int)launch_pack<int32_t>(pat, nb, pat_row, nb_row, batch, n, k, n_words, words_gmem,
                                     words_out, total_out, st);
  return (int)cudaErrorInvalidValue;
}

// As h264t_emit_words_in_global, for K2/K4 at (sym_bytes, k, n_words).
extern "C" int h264t_pack_words_in_global(int sym_bytes, int k, int n_words) {
  if (sym_bytes != 4 && sym_bytes != 8) return -1;
  const size_t limit = dynamic_smem_limit(pack_kernel_of(sym_bytes));
  return limit == 0 ? -1 : pack_smem_bytes(k, n_words, false) > limit ? 1 : 0;
}

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
                                uint32_t* words_gmem, int64_t* words_out, int64_t* total_out,
                                void* stream) {
  return h264t_pack_place(pat, nb, sym_bytes, pat_row, nb_row, batch, n, k, n_words, words_gmem,
                          words_out, total_out, stream);
}

// Resident blocks per SM of K1 at (sym_bytes, k, n_nal) on plan `plan`
// (h264t_emit_plan's bits), and of K2/K4 at (sym_bytes, k, n_words), on
// the current device; -1 if the runtime cannot say.  Launches nothing.
extern "C" int h264t_emit_blocks_per_sm(int sym_bytes, int k, int n_nal, int plan) {
  if (sym_bytes != 4 && sym_bytes != 8) return -1;
  return blocks_per_sm(emit_kernel_of(sym_bytes), emit_smem(k, n_nal, plan));
}

extern "C" int h264t_pack_blocks_per_sm(int sym_bytes, int k, int n_words, int words_in_global) {
  if (sym_bytes != 4 && sym_bytes != 8) return -1;
  return blocks_per_sm(pack_kernel_of(sym_bytes), pack_smem_bytes(k, n_words, words_in_global));
}
