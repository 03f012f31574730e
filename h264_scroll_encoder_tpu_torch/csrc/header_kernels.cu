// K7 h264t_p_slice_header — a hand-written Hopper (sm_90a) kernel for the
// P slice header's symbol stream.  It replaces no Pallas kernel: the JAX
// package computes h264_scroll_encoder_tpu/syntax/slice_headers.py
// `p_slice_header_symbols` as XLA code, which the port ran as ~1,040 aten
// kernels a call (34 ue codes of ~27 tensor ops each, the fills of the
// constants and the stacks), the largest block of the scroll step's and
// the session frame's graphs.  Its plain version and contract:
// syntax/slice_headers.p_slice_header_symbols_plain.
//
// What bounds it on an H100.  A session's header is 39 (pattern, nbits)
// slots, 312 bytes written, from under 90 bytes of inputs: at B = 256,
// ~80 KB, 0.03 us at the card's 3.35 TB/s.  The work a slot is a handful
// of integer operations (ue: a count of leading zeros).  So a call is one
// launch's latency at every batch the port runs; the design keeps it one
// launch with no work around it.
//
// The design:
//   - One thread a session (header row), kHeaderThreads rows a block, one
//     launch a call whatever the batch (none at B = 0).
//   - Each per-session input is read in place, in its own dtype and
//     strides (the grid kernels' Field: address, batch, row and column
//     strides in bytes, dtype code), or taken by value where every session
//     shares it (address 0): nothing is filled, cast or stacked first.
//     The static values of the configuration come by value.
//   - A thread writes its row's 39 slots into shared memory (row pitch 39,
//     odd, so a warp's stores fall in 32 banks); then the block writes its
//     rows' [rows, 39] patterns and nbits, each one contiguous range of the
//     outputs, with consecutive threads on consecutive words.
// Arithmetic is the JAX package's 32-bit: values int32, patterns uint32
// (stored as int32 bits), v + 1 wrapping, floor(log2(0)) = -1 (so ue of
// 0xffffffff has nbits -1, as there).  Outputs are allocated by the
// wrapper; the kernel launches on the caller's stream, so a CUDA graph
// captures it as one node.

#include "grid_device.cuh"

namespace {

constexpr int kHeaderSlots = 39;     // syntax/slice_headers.P_HEADER_SLOTS
constexpr int kMaxWaypoints = 8;     // config.MAX_WAYPOINTS
constexpr int kHeaderThreads = 128;  // header rows a block

// The inputs, in the order of the wrapper's descriptors.  The last two are
// [batch, kMaxWaypoints] (column stride sc); the others one value a session.
enum HeaderInput : int {
  kFrameNum,
  kPocLsb,
  kIsReference,
  kLongTermIdx,
  kNumWaypoints,
  kPrevRefAbsDiff,
  kFirstMb,
  kWpLongTermIdx,
  kWpValid,
  kHeaderInputs
};

struct HeaderArgs {
  Field in[kHeaderInputs];
  int32_t value[kHeaderInputs];  // an input's value where in[k].p is null
  int batch;
  int fn_bits;       // log2_max_frame_num
  int poc_bits;      // log2_max_pic_order_cnt_lsb under POC type 0, else 0
  int deblock;       // deblocking_filter_control_present_flag
  uint32_t slice_type;
  uint32_t qp_ue;    // the se(v)-mapped slice_qp_delta
  int32_t* pat;
  int32_t* nb;
};

static_assert(sizeof(HeaderArgs) <= 4096, "kernel parameters");

// Element (b, i) of an input, converted as the plain version converts it:
// Conv is AsInt (.to(torch.int32)) or AsFlag (.to(torch.bool)).
template <class Conv>
__device__ __forceinline__ int32_t input(const HeaderArgs& a, int k, int b, int i = 0) {
  const Field& f = a.in[k];
  if (f.p == nullptr) return a.value[k];
  const char* p = f.p + f.sb * b + f.sc * i;
  switch (f.code) {
    case 1:
      return Conv()(__ldg(reinterpret_cast<const signed char*>(p)));
    case -1:
      return Conv()(__ldg(reinterpret_cast<const unsigned char*>(p)));
    case 2:
      return Conv()(__ldg(reinterpret_cast<const short*>(p)));
    case 4:
      return Conv()(__ldg(reinterpret_cast<const int*>(p)));
    default:
      return Conv()(__ldg(reinterpret_cast<const long long*>(p)));
  }
}

// A header row being written: slot k of the row's shared words.
struct Row {
  int32_t* pat;
  int32_t* nb;
  int k;

  __device__ __forceinline__ void sym(uint32_t pattern, int32_t nbits) {
    pat[k] = static_cast<int32_t>(pattern);
    nb[k] = nbits;
    ++k;
  }
  // ue(v): pattern v + 1 (mod 2^32), nbits 2 floor(log2(v + 1)) + 1, or 0
  // where the field is absent (the pattern is written all the same).
  __device__ __forceinline__ void ue(uint32_t v, bool present = true) {
    const uint32_t vp1 = v + 1u;
    sym(vp1, present ? 2 * (31 - __clz(static_cast<int>(vp1))) + 1 : 0);
  }
};

__device__ __forceinline__ uint32_t low_bits(uint32_t x, int bits) {
  return bits >= 32 ? x : x & ((1u << bits) - 1u);
}

// The slots of session b's header, in P_HEADER_SLOTS order.
__device__ void header_row(const HeaderArgs& a, int b, Row& r) {
  const uint32_t frame_num = input<AsInt>(a, kFrameNum, b);
  const uint32_t poc_lsb = input<AsInt>(a, kPocLsb, b);
  const bool is_reference = input<AsFlag>(a, kIsReference, b) != 0;
  const int32_t long_term_idx = input<AsInt>(a, kLongTermIdx, b);
  const int32_t num_waypoints = input<AsInt>(a, kNumWaypoints, b);
  const int32_t prev = input<AsInt>(a, kPrevRefAbsDiff, b);
  const bool st_lead = prev > 0;

  r.ue(input<AsInt>(a, kFirstMb, b));  // first_mb_in_slice
  r.ue(a.slice_type);
  r.ue(0);                             // pps_id
  r.sym(low_bits(frame_num, a.fn_bits), a.fn_bits);
  r.sym(low_bits(poc_lsb, a.poc_bits), a.poc_bits);
  r.sym(1, 1);                         // num_ref_idx_active_override_flag
  r.ue(static_cast<uint32_t>(num_waypoints) + 1u + st_lead);
  r.sym(1, 1);                         // ref_pic_list_modification_flag_l0
  r.ue(0, st_lead);                    // idc 0: short-term, pic_num down
  const int32_t diff = static_cast<int32_t>(static_cast<uint32_t>(prev) - 1u);
  r.ue(diff < 0 ? 0 : diff, st_lead);
  r.ue(2);
  r.ue(0);                             // long_term_pic_num 0 (atlas A)
  r.ue(2);
  r.ue(1);                             // long_term_pic_num 1 (atlas B)
#pragma unroll
  for (int i = 0; i < kMaxWaypoints; ++i) {
    const bool present = i < num_waypoints && input<AsFlag>(a, kWpValid, b, i) != 0;
    r.ue(2, present);
    r.ue(input<AsInt>(a, kWpLongTermIdx, b, i), present);
  }
  r.ue(3);                             // end of modification

  // dec_ref_pic_marking: MMCO 4/6/0 where a reference frame is marked
  // long-term, else the sliding window (the adaptive flag 0).
  const bool mmco = is_reference && long_term_idx >= 0;
  const uint32_t lt = long_term_idx < 0 ? 0u : static_cast<uint32_t>(long_term_idx);
  r.sym(mmco, is_reference);
  r.ue(4, mmco);
  r.ue(lt + 1u, mmco);                 // max_long_term_frame_idx_plus1
  r.ue(6, mmco);
  r.ue(lt, mmco);                      // long_term_frame_idx
  r.ue(0, mmco);                       // end

  r.ue(a.qp_ue);                       // slice_qp_delta
  if (a.deblock) {
    r.ue(1);                           // disable_deblocking_filter_idc = 1
  } else {
    r.sym(0, 0);
  }
}

__global__ void __launch_bounds__(kHeaderThreads) p_slice_header_kernel(const HeaderArgs a) {
  __shared__ int32_t s_pat[kHeaderThreads * kHeaderSlots];
  __shared__ int32_t s_nb[kHeaderThreads * kHeaderSlots];
  const int b0 = blockIdx.x * kHeaderThreads;
  const int rows = min(kHeaderThreads, a.batch - b0);
  const int t = threadIdx.x;
  if (t < rows) {
    Row r{s_pat + t * kHeaderSlots, s_nb + t * kHeaderSlots, 0};
    header_row(a, b0 + t, r);
  }
  __syncthreads();
  const long long base = (long long)b0 * kHeaderSlots;
  for (int j = t; j < rows * kHeaderSlots; j += kHeaderThreads) {
    a.pat[base + j] = s_pat[j];
    a.nb[base + j] = s_nb[j];
  }
}

}  // namespace

// K7.  fields: kHeaderInputs x (address, batch, row and column strides in
// bytes, dtype code) in HeaderInput's order (the row stride unused;
// address 0: values[k] for every session, not allowed for frame_num and
// the two registry arrays); values: kHeaderInputs int32.  slots and
// max_waypoints must be the kernel's (the wrapper's P_HEADER_SLOTS and
// MAX_WAYPOINTS).  Outputs: pat, nb int32[batch, slots], contiguous.
extern "C" int h264t_p_slice_header(const long long* fields, const int* values, int batch,
                                    int fn_bits, int poc_bits, int deblock, int slice_type,
                                    int qp_ue, int slots, int max_waypoints, int32_t* pat,
                                    int32_t* nb, void* stream) {
  if (fields == nullptr || values == nullptr || batch < 0 || slots != kHeaderSlots ||
      max_waypoints != kMaxWaypoints || fn_bits < 0 || fn_bits > 32 || poc_bits < 0 ||
      poc_bits > 32)
    return (int)cudaErrorInvalidValue;
  HeaderArgs a;
  for (int k = 0; k < kHeaderInputs; ++k) {
    a.in[k] = field_of(fields + kFieldWords * k);
    a.value[k] = values[k];
    const bool needs_address = k == kFrameNum || k == kWpLongTermIdx || k == kWpValid;
    if ((needs_address && a.in[k].p == nullptr) || !valid_code(a.in[k].code))
      return (int)cudaErrorInvalidValue;
  }
  if (batch == 0) return 0;
  if (pat == nullptr || nb == nullptr) return (int)cudaErrorInvalidValue;
  a.batch = batch;
  a.fn_bits = fn_bits;
  a.poc_bits = poc_bits;
  a.deblock = deblock;
  a.slice_type = static_cast<uint32_t>(slice_type);
  a.qp_ue = static_cast<uint32_t>(qp_ue);
  a.pat = pat;
  a.nb = nb;
  const int blocks = (batch + kHeaderThreads - 1) / kHeaderThreads;
  p_slice_header_kernel<<<blocks, kHeaderThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
