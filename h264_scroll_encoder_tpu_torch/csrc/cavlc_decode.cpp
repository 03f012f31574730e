// Native CAVLC engine for donor ingest (host code, no GPU).
//
// Copy of native/cavlc_decode.cpp, the JAX package's engine, for the
// PyTorch port: native_bridge.py writes cavlc_tables.inc from the port's
// own ops/cavlc_tables.py and builds this file with g++ into _build/, so
// the port needs neither jax nor native/gen_tables.py.  The code below the
// includes is unchanged; keep it in step with the original (the
// cavlc_abi_version() check in native_bridge.py guards the interface).
//
// Variable-length CAVLC decode is bit-serial within a slice, so donor
// macroblock ingest runs as native code on the host.  Behaviour mirrors
// the Python reference (models/mb_transcode.py).  Residual-block payloads
// after coeff_token are nC-independent, so each block is recorded as
// (total_coeff, trailing_ones, total_zeros, tail-bit span) — re-emission
// re-encodes coeff_token for the output geometry's nC and copies the span
// verbatim.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "cavlc_tables.inc"

namespace {

constexpr int kErrBits = -1;
constexpr int kErrToken = -2;
constexpr int kErrTotalZeros = -3;
constexpr int kErrRunBefore = -4;
constexpr int kErrMbType = -5;
constexpr int kErrChromaPred = -6;
constexpr int kErrLevel = -7;
constexpr int kErrEof = -8;

class BitReader {
 public:
  BitReader(const uint8_t* data, long nbytes, long start_bit)
      : data_(data), nbytes_(nbytes), nbits_(nbytes * 8), pos_(start_bit) {}

  long pos() const { return pos_; }
  void seek(long p) { pos_ = p; }

  // 64-bit big-endian window whose MSB is the bit at pos_.  Bits past
  // the buffer read as zero ("EOF reads 0" — identical to the old
  // bit-serial reader's semantics).  After the phase shift, >=57 bits
  // are genuine; every consumer below needs at most 39.
  uint64_t window() const {
    long byte = pos_ >> 3;
    uint64_t v;
    if (byte >= 0 && byte + 8 <= nbytes_) {
      std::memcpy(&v, data_ + byte, 8);
      v = __builtin_bswap64(v);
    } else {
      v = 0;
      for (int i = 0; i < 8; ++i) {
        long b = byte + i;
        v = (v << 8) | (b >= 0 && b < nbytes_ ? data_[b] : 0);
      }
    }
    return v << (pos_ & 7);
  }

  int bit() {
    if (pos_ >= nbits_) { ++pos_; return 0; }  // EOF reads 0
    int b = (data_[pos_ >> 3] >> (7 - (pos_ & 7))) & 1;
    ++pos_;
    return b;
  }

  uint32_t bits(int n) {
    if (n <= 0) return 0;
    uint32_t v = (uint32_t)(window() >> (64 - n));
    pos_ += n;
    return v;
  }

  uint32_t peek(int n) {
    if (n <= 0) return 0;
    return (uint32_t)(window() >> (64 - n));
  }

  // Consume leading zeros up to `maxz`, plus the terminating bit.
  // Returns min(zero_count, maxz); consumes maxz+1 bits when capped —
  // exactly what the old per-bit loops consumed on their error paths.
  int zeros_then_one(int maxz) {
    uint64_t w = window();
    int lz = w ? __builtin_clzll(w) : 64;
    if (lz >= maxz) { pos_ += maxz + 1; return maxz; }
    pos_ += lz + 1;
    return lz;
  }

  uint32_t ue() {
    // 32+ leading zeros cannot encode a value that is legal anywhere in
    // this grammar (and 1u<<32 is UB); return an out-of-range sentinel
    // that every caller's range check rejects.
    int lz = zeros_then_one(32);
    if (lz >= 32) return 0xFFFFFFFFu;
    if (lz == 0) return 0;
    return (1u << lz) - 1 + bits(lz);
  }

  int32_t se() {
    uint32_t v = ue();
    return (v & 1) ? (int32_t)((v + 1) / 2) : -(int32_t)(v / 2);
  }

  void align() { pos_ = (pos_ + 7) & ~7L; }

  // True once any read (or seek) has gone past the buffer end; the
  // recorded bit spans would then reference memory outside the RBSP.
  bool past_end() const { return pos_ > nbits_; }

 private:
  const uint8_t* data_;
  long nbytes_;
  long nbits_;
  long pos_;
};

struct BlockRec {
  int16_t tc, t1, total_zeros;
  int32_t tail_start, tail_len;
};

struct MBRec {
  int32_t kind;  // 0=skip 1=inter 2=i4x4 3=i16x16 4=ipcm
  int32_t mb_type;
  int32_t cbp;
  int32_t qp_delta;  // INT32_MIN when absent
  int32_t chroma_pred;
  int32_t i16_idx;
  int32_t pred_bits_start, pred_bits_len;
  int64_t ipcm_byte_start;
  int32_t sub_mb_types[4];
  int32_t ref_idx[4];
  int32_t n_ref;
  int32_t mvds[16][2];
  int32_t n_mvds;
  BlockRec blocks[27];  // [0] luma DC, [1..16] luma raster, [17] cbDC,
                        // [18] crDC, [19..26] chroma AC (cb0..3 cr0..3)
};

constexpr int32_t kNoQp = INT32_MIN;

struct CoeffCtx {
  int8_t luma[16];
  int8_t chroma[2][4];
};


// ---------------------------------------------------------------------------
// 16-bit-peek LUTs for the VLC decoders (built once at load): direct
// index instead of a linear scan over table rows.  len==0 marks an
// invalid prefix (decode error).
// ---------------------------------------------------------------------------

struct TokLutEnt { int8_t tc, t1, len; };

// Classes: 0 = nC<2, 1 = nC<4, 2 = nC<8, 3 = chroma DC (nC>=8 decodes
// as fixed 6-bit, no LUT needed).
static TokLutEnt g_tok_lut[4][1 << 16];
// decode_vlc_row LUT: value+1 in low byte (0 = invalid), len in high.
static uint16_t g_tz4_lut[15][1 << 11];
static uint16_t g_tzc_lut[3][1 << 11];
static uint16_t g_rb_lut[7][1 << 11];

static void fill_tok(TokLutEnt* lut, const CoeffTokenRow* table, int n) {
  for (int i = 0; i < n; ++i) {
    int L = table[i].len;
    uint32_t base = table[i].code << (16 - L);
    uint32_t span = 1u << (16 - L);
    for (uint32_t w = 0; w < span; ++w)
      lut[base + w] = {table[i].tc, table[i].t1, (int8_t)L};
  }
}

// Level-code LUT: 16-bit peek -> (consumed bits, next suffix_length).
// read_block needs only each level's bit LENGTH and the suffix-length
// adaptation (level values live in the verbatim tail span), so one
// lookup replaces the clz + suffix-bits + arithmetic chain per level.
// Indexed [first][suffix_length] where first = (i == 0 && t1 < 3) (the
// +2 level_code bias changes the adaptation threshold crossing).
// len == 0 marks codes longer than 16 bits (prefix 14 at s=0, prefix
// 15, or oversized prefixes): fall back to the arithmetic path.
struct LevLutEnt { uint8_t len, next_s; };
static LevLutEnt g_lev_lut[2][7][1 << 16];

static void fill_lev() {
  for (int first = 0; first < 2; ++first)
    for (int s = 0; s < 7; ++s)
      for (int p = 0; p <= 14; ++p) {
        if (p == 14 && s == 0) continue;           // 4-bit suffix, L=19
        int L = p + 1 + s;
        if (L > 16) continue;
        for (int v = 0; v < (1 << s); ++v) {
          int level_code = (p << s) + v + (first ? 2 : 0);
          int abs_level = level_code / 2 + 1;      // |level| either sign
          int s2 = s == 0 ? 1 : s;
          if (abs_level > (3 << (s2 - 1)) && s2 < 6) ++s2;
          uint32_t code = (1u << s) | (uint32_t)v;  // zeros,1,suffix
          uint32_t base = code << (16 - L);
          uint32_t span = 1u << (16 - L);
          for (uint32_t w = 0; w < span; ++w)
            g_lev_lut[first][s][base + w] = {(uint8_t)L, (uint8_t)s2};
        }
      }
}

static void fill_vlc(uint16_t* lut, const VlcRow* row) {
  for (int v = 0; v < 18; ++v) {
    int L = row[v].len;
    if (L == 0) continue;
    uint32_t base = row[v].code << (11 - L);
    uint32_t span = 1u << (11 - L);
    for (uint32_t w = 0; w < span; ++w)
      lut[base + w] = (uint16_t)(((v + 1) & 0xFF) | (L << 8));
  }
}

struct LutInit {
  LutInit() {
    fill_tok(g_tok_lut[0], kCoeffTokenNc0, kCoeffTokenNc0_len);
    fill_tok(g_tok_lut[1], kCoeffTokenNc2, kCoeffTokenNc2_len);
    fill_tok(g_tok_lut[2], kCoeffTokenNc4, kCoeffTokenNc4_len);
    fill_tok(g_tok_lut[3], kCoeffTokenChromaDc, kCoeffTokenChromaDc_len);
    for (int i = 0; i < 15; ++i) fill_vlc(g_tz4_lut[i], kTotalZeros4x4[i]);
    for (int i = 0; i < 3; ++i)
      fill_vlc(g_tzc_lut[i], kTotalZerosChromaDc[i]);
    for (int i = 0; i < 7; ++i) fill_vlc(g_rb_lut[i], kRunBefore[i]);
    fill_lev();
  }
};
static LutInit g_lut_init;

int decode_coeff_token(BitReader& br, int nC, int* tc, int* t1) {
  int cls;
  if (nC == -1) cls = 3;
  else if (nC < 2) cls = 0;
  else if (nC < 4) cls = 1;
  else if (nC < 8) cls = 2;
  else {
    uint32_t code = br.bits(6);
    if (code == 3) { *tc = 0; *t1 = 0; }
    else { *tc = (int)(code >> 2) + 1; *t1 = (int)(code & 3); }
    return 0;
  }
  const TokLutEnt& e = g_tok_lut[cls][br.peek(16)];
  if (e.len == 0) return kErrToken;
  br.seek(br.pos() + e.len);
  *tc = e.tc;
  *t1 = e.t1;
  return 0;
}

int decode_vlc_lut(BitReader& br, const uint16_t* lut, int max_value) {
  uint16_t e = lut[br.peek(11)];  // longest total_zeros/run_before: 11
  int v = (e & 0xFF) - 1;
  if (v < 0 || v > max_value) return -1;
  br.seek(br.pos() + (e >> 8));
  return v;
}

int read_block(BitReader& br, int nC, int max_coeff, BlockRec* out) {
  int tc = 0, t1 = 0;
  int err = decode_coeff_token(br, nC, &tc, &t1);
  if (err) return err;
  out->tc = (int16_t)tc;
  out->t1 = (int16_t)t1;
  out->tail_start = (int32_t)br.pos();
  out->total_zeros = 0;
  out->tail_len = 0;
  if (tc == 0) return 0;

  br.bits(t1);  // trailing-one signs (copied verbatim later)

  int suffix_length = (tc > 10 && t1 < 3) ? 1 : 0;
  for (int i = 0; i < tc - t1; ++i) {
    const LevLutEnt& le =
        g_lev_lut[i == 0 && t1 < 3][suffix_length][br.peek(16)];
    if (le.len) {
      br.seek(br.pos() + le.len);
      suffix_length = le.next_s;
      continue;
    }
    int prefix = br.zeros_then_one(16);
    if (prefix > 15) return kErrLevel;
    int level_code = prefix << suffix_length;
    int suffix_size = suffix_length;
    if (prefix == 14 && suffix_length == 0) suffix_size = 4;
    else if (prefix == 15) {
      suffix_size = 12;
      if (suffix_length == 0) level_code += 15;
    }
    if (suffix_size) level_code += (int)br.bits(suffix_size);
    if (i == 0 && t1 < 3) level_code += 2;
    int level = (level_code % 2 == 0) ? level_code / 2 + 1
                                      : -((level_code + 1) / 2);
    if (suffix_length == 0) suffix_length = 1;
    int abs_level = level < 0 ? -level : level;
    if (abs_level > (3 << (suffix_length - 1)) && suffix_length < 6)
      ++suffix_length;
  }

  int total_zeros = 0;
  if (tc < max_coeff) {
    const uint16_t* lut;
    int max_tz;
    if (max_coeff == 4) { lut = g_tzc_lut[tc - 1]; max_tz = 4 - tc; }
    else { lut = g_tz4_lut[tc - 1]; max_tz = max_coeff - tc; }
    total_zeros = decode_vlc_lut(br, lut, max_tz);
    if (total_zeros < 0) return kErrTotalZeros;
  }
  out->total_zeros = (int16_t)total_zeros;

  int zeros_left = total_zeros;
  for (int i = 0; i < tc - 1 && zeros_left > 0; ++i) {
    int key = zeros_left < 7 ? zeros_left : 7;
    int max_run = zeros_left < 14 ? zeros_left : 14;
    int run = decode_vlc_lut(br, g_rb_lut[key - 1], max_run);
    if (run < 0) return kErrRunBefore;
    zeros_left -= run;
  }
  out->tail_len = (int32_t)(br.pos() - out->tail_start);
  // The recorded tail span is copied verbatim from the source buffer at
  // emit time; a span past the RBSP end would leak adjacent memory.
  if (br.past_end()) return kErrEof;
  return 0;
}

int luma_nc(int raster, const CoeffCtx* cur, const CoeffCtx* left,
            const CoeffCtx* top) {
  int row = raster / 4, col = raster % 4;
  int nA = -1, nB = -1;
  if (col > 0) nA = cur->luma[raster - 1];
  else if (left) nA = left->luma[row * 4 + 3];
  if (row > 0) nB = cur->luma[raster - 4];
  else if (top) nB = top->luma[12 + col];
  if (nA >= 0 && nB >= 0) return (nA + nB + 1) >> 1;
  if (nA >= 0) return nA;
  if (nB >= 0) return nB;
  return 0;
}

int chroma_nc(int plane, int blk, const CoeffCtx* cur, const CoeffCtx* left,
              const CoeffCtx* top) {
  int row = blk / 2, col = blk % 2;
  int nA = -1, nB = -1;
  if (col > 0) nA = cur->chroma[plane][blk - 1];
  else if (left) nA = left->chroma[plane][row * 2 + 1];
  if (row > 0) nB = cur->chroma[plane][blk - 2];
  else if (top) nB = top->chroma[plane][2 + col];
  if (nA >= 0 && nB >= 0) return (nA + nB + 1) >> 1;
  if (nA >= 0) return nA;
  if (nB >= 0) return nB;
  return 0;
}

int parse_luma_inter(BitReader& br, int cbp_luma, CoeffCtx* ctx,
                     const CoeffCtx* left, const CoeffCtx* top, MBRec* mb,
                     int max_coeff) {
  for (int i8 = 0; i8 < 4; ++i8) {
    if (!(cbp_luma & (1 << i8))) continue;
    for (int i4 = 0; i4 < 4; ++i4) {
      int raster = kScanToRaster[i8 * 4 + i4];
      int nC = luma_nc(raster, ctx, left, top);
      int err = read_block(br, nC, max_coeff, &mb->blocks[1 + raster]);
      if (err) return err;
      ctx->luma[raster] = (int8_t)mb->blocks[1 + raster].tc;
    }
  }
  return 0;
}

int parse_chroma(BitReader& br, int cbp_chroma, CoeffCtx* ctx,
                 const CoeffCtx* left, const CoeffCtx* top, MBRec* mb) {
  if (cbp_chroma <= 0) return 0;
  int err = read_block(br, -1, 4, &mb->blocks[17]);
  if (err) return err;
  err = read_block(br, -1, 4, &mb->blocks[18]);
  if (err) return err;
  if (cbp_chroma == 2) {
    for (int c = 0; c < 2; ++c) {
      for (int i = 0; i < 4; ++i) {
        int nC = chroma_nc(c, i, ctx, left, top);
        err = read_block(br, nC, 15, &mb->blocks[19 + c * 4 + i]);
        if (err) return err;
        ctx->chroma[c][i] = (int8_t)mb->blocks[19 + c * 4 + i].tc;
      }
    }
  }
  return 0;
}

struct Tracker {
  int width;
  CoeffCtx* top;   // width entries (previous row)
  CoeffCtx* cur;   // width entries (current row)
  bool* top_set;
  bool* cur_set;
  CoeffCtx left;
  bool left_set = false;
  int8_t ipcm_nc = 16;  // nC an I_PCM MB presents (0 = bug_compat)

  const CoeffCtx* left_of(int col) const {
    return (col > 0 && left_set) ? &left : nullptr;
  }
  const CoeffCtx* top_of(int col) const {
    return top_set[col] ? &top[col] : nullptr;
  }
  void push(int col, const CoeffCtx& c) {
    cur[col] = c;
    cur_set[col] = true;
    left = c;
    left_set = true;
  }
  void end_row() {
    std::memcpy(top, cur, sizeof(CoeffCtx) * width);
    std::memcpy(top_set, cur_set, sizeof(bool) * width);
    std::memset(cur_set, 0, sizeof(bool) * width);
    left_set = false;
  }
};

void init_mb(MBRec* mb) {
  std::memset(mb, 0, sizeof(*mb));
  mb->qp_delta = kNoQp;
  mb->i16_idx = -1;
  mb->ipcm_byte_start = -1;
}

int parse_i4x4(BitReader& br, MBRec* mb, Tracker& trk, int col) {
  const CoeffCtx* left = trk.left_of(col);
  const CoeffCtx* top = trk.top_of(col);
  CoeffCtx ctx;
  std::memset(&ctx, 0, sizeof(ctx));
  mb->kind = 2;
  mb->pred_bits_start = (int32_t)br.pos();
  for (int b = 0; b < 16; ++b) {
    if (!br.bit()) br.bits(3);
  }
  mb->pred_bits_len = (int32_t)(br.pos() - mb->pred_bits_start);
  uint32_t chroma_pred = br.ue();
  if (chroma_pred > 3) return kErrChromaPred;
  mb->chroma_pred = (int32_t)chroma_pred;
  uint32_t cbp_code = br.ue();
  int cbp = cbp_code < 48 ? kCbpIntra[cbp_code] : 0;
  mb->cbp = cbp;
  if (cbp > 0) {
    mb->qp_delta = br.se();
    int err = parse_luma_inter(br, cbp & 0xF, &ctx, left, top, mb, 16);
    if (err) return err;
    err = parse_chroma(br, (cbp >> 4) & 3, &ctx, left, top, mb);
    if (err) return err;
  }
  trk.push(col, ctx);
  return 0;
}

int parse_i16x16(BitReader& br, MBRec* mb, int idx, Tracker& trk, int col) {
  const CoeffCtx* left = trk.left_of(col);
  const CoeffCtx* top = trk.top_of(col);
  CoeffCtx ctx;
  std::memset(&ctx, 0, sizeof(ctx));
  mb->kind = 3;
  mb->i16_idx = idx;
  int cbp_luma = (idx / 12) ? 15 : 0;
  int cbp_chroma = (idx / 4) % 3;
  mb->cbp = (cbp_chroma << 4) | cbp_luma;
  uint32_t chroma_pred = br.ue();
  if (chroma_pred > 3) return kErrChromaPred;
  mb->chroma_pred = (int32_t)chroma_pred;
  mb->qp_delta = br.se();
  int dc_nc = luma_nc(0, &ctx, left, top);
  int err = read_block(br, dc_nc, 16, &mb->blocks[0]);
  if (err) return err;
  for (int i8 = 0; i8 < 4; ++i8) {
    for (int i4 = 0; i4 < 4; ++i4) {
      int raster = kScanToRaster[i8 * 4 + i4];
      if (cbp_luma & (1 << i8)) {
        int nC = luma_nc(raster, &ctx, left, top);
        err = read_block(br, nC, 15, &mb->blocks[1 + raster]);
        if (err) return err;
        ctx.luma[raster] = (int8_t)mb->blocks[1 + raster].tc;
      }
    }
  }
  err = parse_chroma(br, cbp_chroma, &ctx, left, top, mb);
  if (err) return err;
  trk.push(col, ctx);
  return 0;
}

// nC context an I_PCM MB presents to neighbors.  Spec 9.2.1: nN = 16.
// The C reference zeroes it instead (trans_resizer.c:1241-1243 — its
// defect #5); callers pass bug_compat=1 per call to reproduce that for
// byte parity (the flag rides in Tracker — no process-global state).
static void ipcm_ctx(CoeffCtx* c, int8_t nc) {
  std::memset(c, nc, sizeof(*c));
}

int parse_ipcm(BitReader& br, MBRec* mb, Tracker& trk, int col) {
  mb->kind = 4;
  br.align();
  mb->ipcm_byte_start = br.pos() / 8;
  br.seek(br.pos() + 384 * 8);
  if (br.past_end()) return kErrEof;  // payload would read past the RBSP
  CoeffCtx ctx;
  ipcm_ctx(&ctx, trk.ipcm_nc);
  trk.push(col, ctx);
  return 0;
}

int parse_inter(BitReader& br, MBRec* mb, int mb_type, int num_ref,
                Tracker& trk, int col) {
  const CoeffCtx* left = trk.left_of(col);
  const CoeffCtx* top = trk.top_of(col);
  CoeffCtx ctx;
  std::memset(&ctx, 0, sizeof(ctx));
  mb->kind = 1;
  static const int sub_mvs[4] = {1, 2, 2, 4};
  int n_parts = mb_type == 0 ? 1 : (mb_type <= 2 ? 2 : 4);
  int total_mvs = n_parts;
  if (mb_type >= 3) {
    total_mvs = 0;
    for (int i = 0; i < 4; ++i) {
      // P-slice sub_mb_type is 0..3 (Table 7-17); range-check as uint32
      // before the int32 store — a hostile donor can encode >= 2^31,
      // which would otherwise index sub_mvs[] out of bounds.
      uint32_t smt = br.ue();
      if (smt > 3) return kErrMbType;
      mb->sub_mb_types[i] = (int32_t)smt;
      total_mvs += sub_mvs[smt];
    }
  }
  if (total_mvs > 16) return kErrMbType;  // mvds[16] capacity invariant
  // Record the source ref-field span (pred_bits_* is unused for inter
  // records): the span-verbatim ingest fast path copies around it when
  // donor and composite active-ref counts differ (te(v) width changes).
  mb->pred_bits_start = (int32_t)br.pos();
  if (num_ref > 1 && mb_type != 4) {
    int n_refs = mb_type == 3 ? 4 : n_parts;
    mb->n_ref = n_refs;
    for (int i = 0; i < n_refs; ++i) {
      mb->ref_idx[i] = (num_ref == 2) ? (1 - br.bit()) : (int32_t)br.ue();
    }
  }
  mb->pred_bits_len = (int32_t)(br.pos() - mb->pred_bits_start);
  mb->n_mvds = total_mvs;
  for (int i = 0; i < total_mvs; ++i) {
    mb->mvds[i][0] = br.se();
    mb->mvds[i][1] = br.se();
  }
  uint32_t cbp_code = br.ue();
  int cbp = cbp_code < 48 ? kCbpInter[cbp_code] : 0;
  mb->cbp = cbp;
  if (cbp > 0) {
    mb->qp_delta = br.se();
    int err = parse_luma_inter(br, cbp & 0xF, &ctx, left, top, mb, 16);
    if (err) return err;
    err = parse_chroma(br, (cbp >> 4) & 3, &ctx, left, top, mb);
    if (err) return err;
  }
  trk.push(col, ctx);
  return 0;
}

}  // namespace

// ---------------------------------------------------------------------------
// Emission: re-emit MBRec grids at (possibly new) geometry with nC repair.
// Mirrors models/mb_transcode.emit_* (Python reference implementation).
// ---------------------------------------------------------------------------

class BitWriter {
 public:
  BitWriter(uint8_t* out, long capacity)
      : out_(out), cap_bits_(capacity * 8), pos_(0) {}

  long pos() const { return pos_; }
  bool overflowed() const { return pos_ > cap_bits_; }

  void bit(int b) {
    if (pos_ < cap_bits_) {
      long byte = pos_ >> 3;
      int sh = 7 - (pos_ & 7);
      out_[byte] = (uint8_t)((out_[byte] & ~(1 << sh)) | ((b & 1) << sh));
    }
    ++pos_;
  }

  void bits(uint32_t v, int n) {
    for (int i = n - 1; i >= 0; --i) bit((v >> i) & 1);
  }

  void ue(uint32_t v) {
    uint64_t vp1 = (uint64_t)v + 1;
    int m = 0;
    while ((vp1 >> (m + 1)) != 0) ++m;
    for (int i = 0; i < m; ++i) bit(0);
    bits((uint32_t)vp1, m + 1);
  }

  void se(int32_t v) { ue(v > 0 ? 2 * (uint32_t)v - 1 : (uint32_t)(-2 * v)); }

  void align_zero() { while (pos_ & 7) bit(0); }

  void copy_bits(const uint8_t* src, long src_start_bit, long nbits) {
    for (long i = 0; i < nbits; ++i) {
      long p = src_start_bit + i;
      bit((src[p >> 3] >> (7 - (p & 7))) & 1);
    }
  }

  void copy_bytes(const uint8_t* src, long n) {
    // caller guarantees alignment
    for (long i = 0; i < n; ++i) bits(src[i], 8);
  }

 private:
  uint8_t* out_;
  long cap_bits_;
  long pos_;
};

namespace {

int token_class(int nC) {
  if (nC == -1) return 4;
  if (nC < 2) return 0;
  if (nC < 4) return 1;
  if (nC < 8) return 2;
  return 3;
}

void emit_token(BitWriter& bw, int nC, int tc, int t1) {
  const VlcRow& r = kCoeffTokenEnc[token_class(nC)][tc][t1];
  bw.bits(r.code, r.len);
}

void emit_block(BitWriter& bw, const BlockRec& blk, int nC,
                const uint8_t* src) {
  emit_token(bw, nC, blk.tc, blk.t1);
  if (blk.tc > 0) bw.copy_bits(src, blk.tail_start, blk.tail_len);
}

void emit_luma_inter(BitWriter& bw, const MBRec* mb, CoeffCtx* ctx,
                     const CoeffCtx* left, const CoeffCtx* top,
                     const uint8_t* src) {
  int cbp_luma = mb->cbp & 0xF;
  for (int i8 = 0; i8 < 4; ++i8) {
    if (!(cbp_luma & (1 << i8))) continue;
    for (int i4 = 0; i4 < 4; ++i4) {
      int raster = kScanToRaster[i8 * 4 + i4];
      int nC = luma_nc(raster, ctx, left, top);
      emit_block(bw, mb->blocks[1 + raster], nC, src);
      ctx->luma[raster] = (int8_t)mb->blocks[1 + raster].tc;
    }
  }
}

void emit_chroma(BitWriter& bw, const MBRec* mb, CoeffCtx* ctx,
                 const CoeffCtx* left, const CoeffCtx* top,
                 const uint8_t* src) {
  int cbp_chroma = (mb->cbp >> 4) & 3;
  if (cbp_chroma <= 0) return;
  emit_block(bw, mb->blocks[17], -1, src);
  emit_block(bw, mb->blocks[18], -1, src);
  if (cbp_chroma == 2) {
    for (int c = 0; c < 2; ++c) {
      for (int i = 0; i < 4; ++i) {
        int nC = chroma_nc(c, i, ctx, left, top);
        emit_block(bw, mb->blocks[19 + c * 4 + i], nC, src);
        ctx->chroma[c][i] = (int8_t)mb->blocks[19 + c * 4 + i].tc;
      }
    }
  }
}

void emit_mb(BitWriter& bw, const MBRec* mb, Tracker& trk, int col,
             int num_ref, const uint8_t* src, const uint8_t* aux) {
  const CoeffCtx* left = trk.left_of(col);
  const CoeffCtx* top = trk.top_of(col);
  CoeffCtx ctx;
  std::memset(&ctx, 0, sizeof(ctx));
  bw.ue((uint32_t)mb->mb_type);

  if (mb->kind == 4) {  // I_PCM
    bw.align_zero();
    if (mb->ipcm_byte_start >= 0) {
      bw.copy_bytes(src + mb->ipcm_byte_start, 384);
    } else {
      bw.copy_bytes(aux + (-(mb->ipcm_byte_start) - 1), 384);
    }
    ipcm_ctx(&ctx, trk.ipcm_nc);
    trk.push(col, ctx);
    return;
  }

  if (mb->kind == 1) {  // inter
    if (mb->mb_type >= 3) {
      for (int i = 0; i < 4; ++i) bw.ue((uint32_t)mb->sub_mb_types[i]);
    }
    if (num_ref > 1 && mb->mb_type != 4 && mb->n_ref > 0) {
      for (int i = 0; i < mb->n_ref; ++i) {
        if (num_ref == 2) bw.bit(1 - (mb->ref_idx[i] & 1));
        else bw.ue((uint32_t)mb->ref_idx[i]);
      }
    }
    for (int i = 0; i < mb->n_mvds; ++i) {
      bw.se(mb->mvds[i][0]);
      bw.se(mb->mvds[i][1]);
    }
    bw.ue(kCbpInterInv[mb->cbp]);
    if (mb->cbp > 0) {
      bw.se(mb->qp_delta);
      emit_luma_inter(bw, mb, &ctx, left, top, src);
      emit_chroma(bw, mb, &ctx, left, top, src);
    }
    trk.push(col, ctx);
    return;
  }

  if (mb->kind == 2) {  // I_4x4
    bw.copy_bits(src, mb->pred_bits_start, mb->pred_bits_len);
    bw.ue((uint32_t)mb->chroma_pred);
    bw.ue(kCbpIntraInv[mb->cbp]);
    if (mb->cbp > 0) {
      bw.se(mb->qp_delta);
      emit_luma_inter(bw, mb, &ctx, left, top, src);
      emit_chroma(bw, mb, &ctx, left, top, src);
    }
    trk.push(col, ctx);
    return;
  }

  // kind == 3: I_16x16
  int cbp_luma = (mb->i16_idx / 12) ? 15 : 0;
  bw.ue((uint32_t)mb->chroma_pred);
  bw.se(mb->qp_delta);
  int dc_nc = luma_nc(0, &ctx, left, top);
  emit_block(bw, mb->blocks[0], dc_nc, src);
  for (int i8 = 0; i8 < 4; ++i8) {
    for (int i4 = 0; i4 < 4; ++i4) {
      int raster = kScanToRaster[i8 * 4 + i4];
      if (cbp_luma & (1 << i8)) {
        int nC = luma_nc(raster, &ctx, left, top);
        emit_block(bw, mb->blocks[1 + raster], nC, src);
        ctx.luma[raster] = (int8_t)mb->blocks[1 + raster].tc;
      }
    }
  }
  emit_chroma(bw, mb, &ctx, left, top, src);
  trk.push(col, ctx);
}

}  // namespace

extern "C" {

// 1 -> reproduce the reference's zeroed I_PCM nC context (defect #5);
// 0 (default) -> spec rule nN = 16 (H.264 9.2.1).
// Bumped whenever the extern "C" surface changes; the Python bridge
// checks it and rebuilds a stale library instead of calling through a
// mismatched ABI.
long cavlc_abi_version(void) { return 7; }

// Emit an MBRec grid (mb_width x mb_height, row-major) as slice MB data.
// kind==0 records are P_Skip.  src supplies tail/pred/ipcm spans recorded
// by cavlc_parse_slice; aux supplies synthesized I_PCM payloads for
// records with ipcm_byte_start < 0 (offset -(v+1)).  start_phase is the
// bit position (mod 8) at which the payload will sit in the final stream
// — I_PCM pcm_alignment_zero_bits depend on it; the first start_phase
// bits of `out` are left zero and included in *out_bits.  Returns 0 on
// success, -100 on output overflow.
int cavlc_emit_slice(const MBRec* mbs, int mb_width, int mb_height,
                     int is_p, int num_ref_idx_l0, const uint8_t* src,
                     const uint8_t* aux, int duplicate_final_skip,
                     long start_phase, uint8_t* out, long out_capacity,
                     long* out_bits, int bug_compat) {
  BitWriter bw(out, out_capacity);
  for (long i = 0; i < start_phase; ++i) bw.bit(0);
  CoeffCtx* top = new CoeffCtx[mb_width];
  CoeffCtx* cur = new CoeffCtx[mb_width];
  bool* top_set = new bool[mb_width]();
  bool* cur_set = new bool[mb_width]();
  Tracker trk{mb_width, top, cur, top_set, cur_set};
  trk.ipcm_nc = bug_compat ? 0 : 16;
  long pending = 0;

  for (int row = 0; row < mb_height; ++row) {
    for (int col = 0; col < mb_width; ++col) {
      const MBRec* mb = &mbs[row * mb_width + col];
      if (mb->kind == 0) {
        ++pending;
        CoeffCtx z;
        std::memset(&z, 0, sizeof(z));
        trk.push(col, z);
        continue;
      }
      if (is_p) {
        bw.ue((uint32_t)pending);
        pending = 0;
      }
      emit_mb(bw, mb, trk, col, num_ref_idx_l0, src, aux);
    }
    trk.end_row();
  }
  if (is_p && pending > 0) {
    bw.ue((uint32_t)pending);
    if (duplicate_final_skip) bw.ue((uint32_t)pending);
  }

  delete[] top;
  delete[] cur;
  delete[] top_set;
  delete[] cur_set;
  *out_bits = bw.pos();
  return bw.overflowed() ? -100 : 0;
}

// Returns 0 on success, negative error code otherwise.  `end_bit`
// receives the bit position after the last macroblock.
int cavlc_parse_slice(const uint8_t* rbsp, long nbytes, long start_bit,
                      int mb_width, int mb_height, int is_p,
                      int num_ref_idx_l0, MBRec* out, long* end_bit,
                      int bug_compat) {
  BitReader br(rbsp, nbytes, start_bit);
  CoeffCtx* top = new CoeffCtx[mb_width];
  CoeffCtx* cur = new CoeffCtx[mb_width];
  bool* top_set = new bool[mb_width]();
  bool* cur_set = new bool[mb_width]();
  Tracker trk{mb_width, top, cur, top_set, cur_set};
  trk.ipcm_nc = bug_compat ? 0 : 16;
  int total = mb_width * mb_height;
  int count = 0;
  int err = 0;

  auto cleanup = [&]() {
    delete[] top;
    delete[] cur;
    delete[] top_set;
    delete[] cur_set;
  };

  if (!is_p) {
    for (int i = 0; i < total; ++i) init_mb(&out[i]);
    for (int row = 0; row < mb_height && !err; ++row) {
      for (int col = 0; col < mb_width && !err; ++col) {
        MBRec* mb = &out[row * mb_width + col];
        uint32_t t = br.ue();
        mb->mb_type = (int32_t)t;
        if (t == 0) err = parse_i4x4(br, mb, trk, col);
        else if (t <= 24) err = parse_i16x16(br, mb, (int)t - 1, trk, col);
        else if (t == 25) err = parse_ipcm(br, mb, trk, col);
        else err = kErrMbType;
        if (!err && br.past_end()) err = kErrEof;
      }
      trk.end_row();
    }
  } else {
    for (int i = 0; i < total; ++i) { init_mb(&out[i]); }
    while (count < total && !err) {
      uint32_t skip_run = br.ue();
      for (uint32_t s = 0; s < skip_run && count < total; ++s) {
        int row = count / mb_width, col = count % mb_width;
        (void)row;
        if (col == 0 && count) trk.end_row();
        CoeffCtx z;
        std::memset(&z, 0, sizeof(z));
        trk.push(col, z);
        out[count].kind = 0;  // skip
        ++count;
      }
      if (count >= total) break;
      int row = count / mb_width, col = count % mb_width;
      (void)row;
      if (col == 0 && count) trk.end_row();
      MBRec* mb = &out[count];
      uint32_t t = br.ue();
      mb->mb_type = (int32_t)t;
      if (t <= 4) err = parse_inter(br, mb, (int)t, num_ref_idx_l0, trk, col);
      else if (t == 5) err = parse_i4x4(br, mb, trk, col);
      else if (t <= 29) err = parse_i16x16(br, mb, (int)t - 6, trk, col);
      else if (t == 30) err = parse_ipcm(br, mb, trk, col);
      else err = kErrMbType;
      if (!err && br.past_end()) err = kErrEof;
      ++count;
    }
  }

  if (end_bit) *end_bit = br.pos();
  cleanup();
  return err;
}

long cavlc_mbrec_size() { return (long)sizeof(MBRec); }

}  // extern "C"

// ---------------------------------------------------------------------------
// Dense donor prep: per-MB composite-context bits as 32-bit chunk arrays.
//
// Serving fast path for the TPU dynamic-rect splice kernel
// (h264_scroll_encoder_tpu/models/splice_device.py, dense path): each donor
// macroblock's final bitstream — refs re-targeted into the composite
// reference list, coeff_tokens re-encoded under composite-geometry nC
// (outside-rect neighbors are coded-with-zero-residual, i.e. available
// with tc=0, except past frame edges) — is packed into <=32-bit chunks
// with I_PCM pcm_alignment_zero_bits left as ALIGN sentinels (nbits = -1)
// for the device phase scan.  Mirrors the Python
// splice_device.prepare_donor_dense byte-for-byte (differential-tested).
// ---------------------------------------------------------------------------

namespace {

constexpr int32_t kAlignSentinel = -1;

inline uint32_t read_bits_span(const uint8_t* src, long src_len_bytes,
                               long pos, int n) {
  // n <= 32; 64-bit windowed big-endian load (fast path one memcpy +
  // bswap; clamped byte loop only near the buffer end).
  long byte = pos >> 3;
  uint64_t v;
  if (byte >= 0 && byte + 8 <= src_len_bytes) {
    std::memcpy(&v, src + byte, 8);
    v = __builtin_bswap64(v);
  } else {
    v = 0;
    for (int i = 0; i < 8; ++i) {
      long b = byte + i;
      v = (v << 8) | (b >= 0 && b < src_len_bytes ? src[b] : 0);
    }
  }
  v <<= (pos & 7);
  return (uint32_t)(v >> (64 - n));
}

class ChunkWriter {
 public:
  ChunkWriter(uint32_t* pat, int32_t* nb, int cap)
      : pat_(pat), nb_(nb), cap_(cap) {}

  void put(uint32_t v, int n) {
    if (n <= 0) return;
    uint32_t masked = (n >= 32) ? v : (v & ((1u << n) - 1));
    acc_ = (acc_ << n) | (uint64_t)masked;
    accn_ += n;
    bits_ += n;
    while (accn_ >= 32) {
      emit((uint32_t)(acc_ >> (accn_ - 32)), 32);
      accn_ -= 32;
      acc_ &= accn_ ? ((1ULL << accn_) - 1) : 0ULL;
    }
  }

  void ue(uint32_t v) {
    uint64_t vp1 = (uint64_t)v + 1;
    int m = 0;
    while ((vp1 >> (m + 1)) != 0) ++m;
    put(0, m);
    put((uint32_t)vp1, m + 1);
  }

  void se(int32_t v) {
    ue(v > 0 ? 2 * (uint32_t)v - 1 : (uint32_t)(-2 * v));
  }

  void copy_bits(const uint8_t* src, long src_len_bytes, long start,
                 long n) {
    long i = 0;
    while (i < n) {
      int take = (int)((n - i) < 32 ? (n - i) : 32);
      put(read_bits_span(src, src_len_bytes, start + i, take), take);
      i += take;
    }
  }

  void align_sentinel() {
    flush();
    if (n_ < cap_) {
      pat_[n_] = 0;
      nb_[n_] = kAlignSentinel;
    }
    ++n_;
    bits_ += 7;  // worst-case pad, resolved on device
    has_align_ = true;
  }

  void flush() {
    if (accn_ > 0) {
      emit((uint32_t)acc_, accn_);
      acc_ = 0;
      accn_ = 0;
    }
  }

  int chunks() const { return n_; }
  long bits() const { return bits_; }
  bool has_align() const { return has_align_; }

  // Zero-terminate the slot list so readers that scan until nbits==0
  // are safe on reused (dirty) scratch buffers.
  void terminate() {
    if (n_ < cap_) nb_[n_] = 0;
  }

 private:
  void emit(uint32_t v, int n) {
    if (n_ < cap_) {
      pat_[n_] = v;
      nb_[n_] = n;
    }
    ++n_;
  }

  uint32_t* pat_;
  int32_t* nb_;
  int cap_;
  int n_ = 0;
  uint64_t acc_ = 0;
  int accn_ = 0;
  long bits_ = 0;
  bool has_align_ = false;
};

void cw_emit_token(ChunkWriter& cw, int nC, int tc, int t1) {
  const VlcRow& r = kCoeffTokenEnc[token_class(nC)][tc][t1];
  cw.put(r.code, r.len);
}

void cw_emit_block(ChunkWriter& cw, const BlockRec& blk, int nC,
                   const uint8_t* src, long src_len) {
  cw_emit_token(cw, nC, blk.tc, blk.t1);
  if (blk.tc > 0) cw.copy_bits(src, src_len, blk.tail_start, blk.tail_len);
}

void cw_emit_luma_inter(ChunkWriter& cw, const MBRec* mb, CoeffCtx* ctx,
                        const CoeffCtx* left, const CoeffCtx* top,
                        const uint8_t* src, long src_len) {
  int cbp_luma = mb->cbp & 0xF;
  for (int i8 = 0; i8 < 4; ++i8) {
    if (!(cbp_luma & (1 << i8))) continue;
    for (int i4 = 0; i4 < 4; ++i4) {
      int raster = kScanToRaster[i8 * 4 + i4];
      int nC = luma_nc(raster, ctx, left, top);
      cw_emit_block(cw, mb->blocks[1 + raster], nC, src, src_len);
      ctx->luma[raster] = (int8_t)mb->blocks[1 + raster].tc;
    }
  }
}

void cw_emit_chroma(ChunkWriter& cw, const MBRec* mb, CoeffCtx* ctx,
                    const CoeffCtx* left, const CoeffCtx* top,
                    const uint8_t* src, long src_len) {
  int cbp_chroma = (mb->cbp >> 4) & 3;
  if (cbp_chroma <= 0) return;
  cw_emit_block(cw, mb->blocks[17], -1, src, src_len);
  cw_emit_block(cw, mb->blocks[18], -1, src, src_len);
  if (cbp_chroma == 2) {
    for (int c = 0; c < 2; ++c) {
      for (int i = 0; i < 4; ++i) {
        int nC = chroma_nc(c, i, ctx, left, top);
        cw_emit_block(cw, mb->blocks[19 + c * 4 + i], nC, src, src_len);
        ctx->chroma[c][i] = (int8_t)mb->blocks[19 + c * 4 + i].tc;
      }
    }
  }
}

// Re-target a donor inter MB's refs into the composite list (mirror of
// models/splice._map_donor_refs).  Returns mapped mb_type; fills
// refs_out/n_ref_out (refs to WRITE; 0 = none).  ref_map entries index
// the composite list.  Returns -1 on an unmappable ref.
int map_refs(const MBRec* mb, int num_ref_comp, const int32_t* ref_map,
             int ref_map_len, int* refs_out, int* n_ref_out) {
  int mb_type = mb->mb_type;
  *n_ref_out = 0;
  if (mb->kind != 1) return mb_type;
  int n_parts = mb_type == 0 ? 1 : (mb_type <= 2 ? 2 : 4);
  if (mb_type == 4 && ref_map[0] != 0) {
    // P_8x8ref0 hardwires ref 0; rewrite to P_8x8 with explicit refs.
    mb_type = 3;
    n_parts = 4;
    if (num_ref_comp > 1) {
      *n_ref_out = 4;
      for (int i = 0; i < 4; ++i) refs_out[i] = ref_map[0];
    }
    return mb_type;
  }
  if (num_ref_comp <= 1 || mb_type == 4) return mb_type;
  *n_ref_out = n_parts;
  for (int i = 0; i < n_parts; ++i) {
    int donor_ref = (mb->n_ref > 0) ? mb->ref_idx[i] : 0;
    if (donor_ref < 0 || donor_ref >= ref_map_len) return -1;
    refs_out[i] = ref_map[donor_ref];
  }
  return mb_type;
}

// One coded macroblock's dense-chunk emission (composite-nC token
// re-resolution + verbatim spans) — shared by cavlc_prepare_dense and
// the fused row ingest.  Returns 0 or -102 (unmappable donor ref).
// Caller flushes/terminates the writer and pushes nothing afterward —
// trk is updated here.
int emit_dense_mb(ChunkWriter& cw, const MBRec* mb, Tracker& trk,
                  int col, int row, int num_ref_composite,
                  const int32_t* ref_map, int ref_map_len,
                  int at_left_edge, int at_top_edge,
                  const uint8_t* src, long src_len) {
  static const CoeffCtx kZeroCtx = {};
  const CoeffCtx* left = trk.left_of(col);
  if (!left && !at_left_edge) left = &kZeroCtx;
  const CoeffCtx* topc = trk.top_of(col);
  if (!topc && row == 0 && !at_top_edge) topc = &kZeroCtx;
  CoeffCtx ctx;
  std::memset(&ctx, 0, sizeof(ctx));

  int refs[4];
  int n_ref_out = 0;
  int mb_type = map_refs(mb, num_ref_composite, ref_map, ref_map_len,
                         refs, &n_ref_out);
  if (mb_type < 0) return -102;
  cw.ue((uint32_t)mb_type);

  if (mb->kind == 4) {  // I_PCM
    cw.align_sentinel();
    if (mb->ipcm_byte_start >= 0) {
      cw.copy_bits(src, src_len, mb->ipcm_byte_start * 8, 384 * 8);
    }
    ipcm_ctx(&ctx, trk.ipcm_nc);
    trk.push(col, ctx);
  } else if (mb->kind == 1) {  // inter
    if (mb_type >= 3) {
      for (int i = 0; i < 4; ++i)
        cw.ue((uint32_t)mb->sub_mb_types[i]);
    }
    for (int i = 0; i < n_ref_out; ++i) {
      if (num_ref_composite == 2) cw.put(1 - (refs[i] & 1), 1);
      else cw.ue((uint32_t)refs[i]);
    }
    for (int i = 0; i < mb->n_mvds; ++i) {
      cw.se(mb->mvds[i][0]);
      cw.se(mb->mvds[i][1]);
    }
    cw.ue(kCbpInterInv[mb->cbp]);
    if (mb->cbp > 0) {
      cw.se(mb->qp_delta);
      cw_emit_luma_inter(cw, mb, &ctx, left, topc, src, src_len);
      cw_emit_chroma(cw, mb, &ctx, left, topc, src, src_len);
    }
    trk.push(col, ctx);
  } else if (mb->kind == 2) {  // I_4x4 (in P taxonomy)
    cw.copy_bits(src, src_len, mb->pred_bits_start, mb->pred_bits_len);
    cw.ue((uint32_t)mb->chroma_pred);
    cw.ue(kCbpIntraInv[mb->cbp]);
    if (mb->cbp > 0) {
      cw.se(mb->qp_delta);
      cw_emit_luma_inter(cw, mb, &ctx, left, topc, src, src_len);
      cw_emit_chroma(cw, mb, &ctx, left, topc, src, src_len);
    }
    trk.push(col, ctx);
  } else {  // kind == 3: I_16x16
    int cbp_luma = (mb->i16_idx / 12) ? 15 : 0;
    cw.ue((uint32_t)mb->chroma_pred);
    cw.se(mb->qp_delta);
    int dc_nc = luma_nc(0, &ctx, left, topc);
    cw_emit_block(cw, mb->blocks[0], dc_nc, src, src_len);
    for (int i8 = 0; i8 < 4; ++i8) {
      for (int i4 = 0; i4 < 4; ++i4) {
        int raster = kScanToRaster[i8 * 4 + i4];
        if (cbp_luma & (1 << i8)) {
          int nC = luma_nc(raster, &ctx, left, topc);
          cw_emit_block(cw, mb->blocks[1 + raster], nC, src, src_len);
          ctx.luma[raster] = (int8_t)mb->blocks[1 + raster].tc;
        }
      }
    }
    cw_emit_chroma(cw, mb, &ctx, left, topc, src, src_len);
    trk.push(col, ctx);
  }
  return 0;
}

}  // namespace

extern "C" {

// Returns 0 on success; -101 when some MB needs more than s_class chunk
// slots (*out_needed then holds the required count, nothing written is
// trusted); -102 on a donor ref outside ref_map.  out_pat/out_nb are
// [R*C, s_class]; out_coded is [R*C].
int cavlc_prepare_dense(const MBRec* mbs, int R, int C,
                        int num_ref_composite, const int32_t* ref_map,
                        int ref_map_len, int at_left_edge, int at_top_edge,
                        const uint8_t* src, long src_len,
                        uint32_t* out_pat, int32_t* out_nb, int s_class,
                        uint8_t* out_coded, long* out_donor_bits,
                        int* out_has_align, int* out_needed,
                        int bug_compat) {
  CoeffCtx* top = new CoeffCtx[C];
  CoeffCtx* cur = new CoeffCtx[C];
  bool* top_set = new bool[C]();
  bool* cur_set = new bool[C]();
  Tracker trk{C, top, cur, top_set, cur_set, {}, false,
              (int8_t)(bug_compat ? 0 : 16)};
  long donor_bits = 0;
  int has_align = 0;
  int needed = 0;
  int err = 0;

  for (int row = 0; row < R && !err; ++row) {
    for (int col = 0; col < C && !err; ++col) {
      int m = row * C + col;
      const MBRec* mb = &mbs[m];
      ChunkWriter cw(out_pat + (long)m * s_class,
                     out_nb + (long)m * s_class, s_class);
      if (mb->kind == 0) {
        // P_Skip hardwires composite ref 0; with a moved map the skip
        // would reference the wrong picture (the host path converts
        // skips to explicit MBs; the retarget ingest does too).
        if (ref_map[0] != 0) { err = -103; break; }
        out_coded[m] = 0;
        cw.terminate();
        CoeffCtx z;
        std::memset(&z, 0, sizeof(z));
        trk.push(col, z);
        continue;
      }
      out_coded[m] = 1;
      err = emit_dense_mb(cw, mb, trk, col, row, num_ref_composite,
                          ref_map, ref_map_len, at_left_edge,
                          at_top_edge, src, src_len);
      if (err) break;

      cw.flush();
      cw.terminate();
      if (cw.chunks() > needed) needed = cw.chunks();
      donor_bits += cw.bits();
      if (cw.has_align()) has_align = 1;
    }
    trk.end_row();
  }

  delete[] top;
  delete[] cur;
  delete[] top_set;
  delete[] cur_set;
  *out_needed = needed;
  *out_donor_bits = donor_bits;
  *out_has_align = has_align;
  if (err) return err;
  return (needed > s_class) ? -101 : 0;
}

// Row-contiguous repack of per-MB chunk arrays (the C++ twin of
// models/splice_device.pack_donor_rows): fuse each rect row's coded
// donor MBs into one chunk stream with the row-interior skip runs
// (static gaps between coded MBs) encoded in place.  ALIGN sentinel
// slots (nbits == -1, I_PCM pcm_alignment_zero_bits) flush the fuse
// accumulator and pass through unchanged.
extern "C" int cavlc_pack_rows(const uint32_t* patterns,
                               const int32_t* nbits, const uint8_t* coded,
                               int R, int C, int S, int s_row,
                               uint32_t* out_pat, int32_t* out_nb,
                               int32_t* out_first_c, long* out_donor_bits,
                               int* out_needed) {
  long donor_bits = 0;
  int needed = 0;
  int err = 0;
  for (int r = 0; r < R; ++r) {
    uint32_t* op = out_pat + (long)r * s_row;
    int32_t* on = out_nb + (long)r * s_row;
    int k = 0;
    unsigned long long acc = 0;
    int accn = 0;
    out_first_c[r] = -1;
    int last = -1;

    auto put = [&](uint32_t pat, int n) {
      acc = (acc << n) | (pat & ((n >= 32) ? 0xFFFFFFFFu
                                           : ((1u << n) - 1u)));
      accn += n;
      while (accn >= 32) {
        if (k < s_row) {
          op[k] = (uint32_t)(acc >> (accn - 32));
          on[k] = 32;
        }
        ++k;
        accn -= 32;
        acc &= (accn ? ((1ULL << accn) - 1) : 0);
      }
    };
    auto flush = [&]() {
      if (accn > 0) {
        if (k < s_row) {
          op[k] = (uint32_t)acc;
          on[k] = accn;
        }
        ++k;
        acc = 0;
        accn = 0;
      }
    };

    for (int c = 0; c < C; ++c) {
      if (!coded[r * C + c]) continue;
      if (last < 0) {
        out_first_c[r] = c;
      } else {
        // ue(run): [zeros][binary(run+1)].
        uint32_t v = (uint32_t)(c - last);  // run + 1
        int bl = 32 - __builtin_clz(v);
        put(v, 2 * bl - 1);
        donor_bits += 2 * bl - 1;
      }
      last = c;
      const uint32_t* mp = patterns + ((long)r * C + c) * S;
      const int32_t* mn = nbits + ((long)r * C + c) * S;
      for (int i = 0; i < S; ++i) {
        int n = mn[i];
        if (n == 0) break;
        if (n == -1) {                    // ALIGN sentinel
          flush();
          if (k < s_row) { op[k] = 0; on[k] = -1; }
          ++k;
          donor_bits += 7;
        } else {
          put(mp[i], n);
          donor_bits += n;
        }
      }
    }
    flush();
    if (k > needed) needed = k;
    if (k > s_row) err = -101;
  }
  *out_donor_bits = donor_bits;
  *out_needed = needed;
  return err;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Composite-context MV edge roles (port of models/mv_field.py restricted
// to parsed P-grids, with injected border rings — see
// splice_device.donor_edge_motion for the ring layout/semantics).
// ---------------------------------------------------------------------------

namespace {

constexpr int32_t kIntraRef = -2;

struct MVField {
  int w4, h4;
  int32_t* ref;
  int32_t* mvx;
  int32_t* mvy;
  uint8_t* filled;

  bool cell(int bx, int by, int32_t* r, int32_t* x, int32_t* y) const {
    if (bx < 0 || by < 0 || bx >= w4 || by >= h4) return false;
    long i = (long)by * w4 + bx;
    if (!filled[i]) return false;
    *r = ref[i];
    *x = mvx[i];
    *y = mvy[i];
    return true;
  }

  void fill(int bx, int by, int w, int h, int32_t r, int32_t x, int32_t y) {
    for (int j = 0; j < h; ++j)
      for (int i = 0; i < w; ++i) {
        long k = (long)(by + j) * w4 + (bx + i);
        ref[k] = r;
        mvx[k] = x;
        mvy[k] = y;
        filled[k] = 1;
      }
  }
};

struct Nbr {
  int32_t r, x, y;
  bool av;
};

inline int32_t med3(int32_t a, int32_t b, int32_t c) {
  int32_t mn = a < b ? a : b, mx = a < b ? b : a;
  return mx < c ? mx : (mn > c ? mn : c);
}

void mvf_neighbors(const MVField& f, int bx, int by, int w4, Nbr* a,
                   Nbr* b, Nbr* c) {
  a->av = f.cell(bx - 1, by, &a->r, &a->x, &a->y);
  b->av = f.cell(bx, by - 1, &b->r, &b->x, &b->y);
  c->av = f.cell(bx + w4, by - 1, &c->r, &c->x, &c->y);
  if (!c->av) c->av = f.cell(bx - 1, by - 1, &c->r, &c->x, &c->y);
}

void mvf_predict(const MVField& f, int bx, int by, int w4, int32_t ref_idx,
                 const Nbr* an, const Nbr* bn, const Nbr* cn,
                 int32_t* px, int32_t* py) {
  Nbr a, b, c;
  if (!an) {
    mvf_neighbors(f, bx, by, w4, &a, &b, &c);
    an = &a; bn = &b; cn = &c;
  }
  bool m_a = an->av && an->r == ref_idx;
  bool m_b = bn->av && bn->r == ref_idx;
  bool m_c = cn->av && cn->r == ref_idx;
  int n_avail = an->av + bn->av + cn->av;
  int n_match = m_a + m_b + m_c;
  if (n_avail == 0) { *px = 0; *py = 0; return; }
  if (an->av && !bn->av && !cn->av) { *px = an->x; *py = an->y; return; }
  if (n_match == 1) {
    const Nbr* w = m_a ? an : (m_b ? bn : cn);
    *px = w->x; *py = w->y; return;
  }
  *px = med3(an->av ? an->x : 0, bn->av ? bn->x : 0, cn->av ? cn->x : 0);
  *py = med3(an->av ? an->y : 0, bn->av ? bn->y : 0, cn->av ? cn->y : 0);
}

void mvf_skip(const MVField& f, int bx, int by, int32_t* px, int32_t* py) {
  Nbr a, b;
  a.av = f.cell(bx - 1, by, &a.r, &a.x, &a.y);
  b.av = f.cell(bx, by - 1, &b.r, &b.x, &b.y);
  if (!a.av || !b.av || (a.r == 0 && a.x == 0 && a.y == 0) ||
      (b.r == 0 && b.x == 0 && b.y == 0)) {
    *px = 0; *py = 0; return;
  }
  mvf_predict(f, bx, by, 4, 0, nullptr, nullptr, nullptr, px, py);
}

// Sub-partition geometry per sub_mb_type (H.264 Table 7-18): {w4, h4}.
constexpr int kSubGeom[4][2] = {{2, 2}, {2, 1}, {1, 2}, {1, 1}};

}  // namespace

extern "C" {

// Rings: top_ring [(C+2)*3] covering composite (r0-1, c0-1..c0+C);
// left_ring [R*3] (col c0-1, rows r0..); right_ring [(R-1)*3] (col c0+C,
// rows r0..r0+R-2); *_valid flag each entry.  Outputs a/b/d role arrays
// [R*C * 3] = the MB's top-right / bottom-left / bottom-right 4x4 field
// values.  Returns 0, or -102 on an unmappable donor ref.
int cavlc_mv_edge_roles(const MBRec* mbs, int R, int C,
                        int num_ref_composite, const int32_t* ref_map,
                        int ref_map_len,
                        const int32_t* top_ring, const uint8_t* top_valid,
                        const int32_t* left_ring, const uint8_t* left_valid,
                        const int32_t* right_ring,
                        const uint8_t* right_valid,
                        int32_t* out_a, int32_t* out_b, int32_t* out_d) {
  int w4 = (C + 2) * 4, h4 = (R + 1) * 4;
  long cells = (long)w4 * h4;
  int32_t* ref = new int32_t[cells];
  int32_t* mvx = new int32_t[cells]();
  int32_t* mvy = new int32_t[cells]();
  uint8_t* filled = new uint8_t[cells]();
  for (long i = 0; i < cells; ++i) ref[i] = -9;
  MVField f{w4, h4, ref, mvx, mvy, filled};
  int err = 0;

  for (int c = 0; c < C + 2; ++c)
    if (top_valid[c])
      f.fill(c * 4, 0, 4, 4, top_ring[c * 3], top_ring[c * 3 + 1],
             top_ring[c * 3 + 2]);
  for (int r = 0; r < R; ++r)
    if (left_valid[r])
      f.fill(0, (1 + r) * 4, 4, 4, left_ring[r * 3], left_ring[r * 3 + 1],
             left_ring[r * 3 + 2]);
  // Right-ring cells fill LAZILY after each donor row: the composite MB
  // right of row r decodes after that row in raster order, so it may
  // serve row r+1's above-right prediction but must not be visible to
  // row r's own sub-partition prediction.

  for (int mb_y = 0; mb_y < R && !err; ++mb_y) {
    if (mb_y > 0 && mb_y - 1 < R - 1 && right_valid[mb_y - 1])
      f.fill((C + 1) * 4, mb_y * 4, 4, 4, right_ring[(mb_y - 1) * 3],
             right_ring[(mb_y - 1) * 3 + 1],
             right_ring[(mb_y - 1) * 3 + 2]);
    for (int mb_x = 0; mb_x < C && !err; ++mb_x) {
      const MBRec* mb = &mbs[mb_y * C + mb_x];
      int bx = (1 + mb_x) * 4, by = (1 + mb_y) * 4;
      if (mb->kind == 0) {
        int32_t px, py;
        mvf_skip(f, bx, by, &px, &py);
        // Donor P_Skip is composite ref 0 (the dense prep keeps skips
        // only when ref_map[0] == 0 — same contract as the host path).
        f.fill(bx, by, 4, 4, 0, px, py);
        continue;
      }
      if (mb->kind != 1) {  // intra: unavailable-for-match, zero MV
        f.fill(bx, by, 4, 4, kIntraRef, 0, 0);
        continue;
      }
      int refs[4];
      int n_ref_out = 0;
      int mb_type = map_refs(mb, num_ref_composite, ref_map, ref_map_len,
                             refs, &n_ref_out);
      if (mb_type < 0) { err = -102; break; }
      // Resolve each partition's ref in the composite list: map_refs
      // only fills refs it will WRITE; prediction needs them always.
      int pref[4];
      int n_parts = mb_type == 0 ? 1 : (mb_type <= 2 ? 2 : 4);
      for (int i = 0; i < n_parts; ++i) {
        int donor_ref = (mb->mb_type == 4) ? 0
                        : (mb->n_ref > 0 ? mb->ref_idx[i] : 0);
        if (donor_ref < 0 || donor_ref >= ref_map_len) { err = -102; break; }
        pref[i] = ref_map[donor_ref];
      }
      if (err) break;

      if (mb_type == 0) {
        int32_t px, py;
        mvf_predict(f, bx, by, 4, pref[0], nullptr, nullptr, nullptr,
                    &px, &py);
        f.fill(bx, by, 4, 4, pref[0], px + mb->mvds[0][0],
               py + mb->mvds[0][1]);
      } else if (mb_type == 1) {  // 16x8
        for (int part = 0; part < 2; ++part) {
          int pby = by + part * 2;
          int32_t r = pref[part];
          Nbr a, b, c;
          mvf_neighbors(f, bx, pby, 4, &a, &b, &c);
          int32_t px, py;
          if (part == 0 && b.av && b.r == r) { px = b.x; py = b.y; }
          else if (part == 1 && a.av && a.r == r) { px = a.x; py = a.y; }
          else mvf_predict(f, bx, pby, 4, r, &a, &b, &c, &px, &py);
          f.fill(bx, pby, 4, 2, r, px + mb->mvds[part][0],
                 py + mb->mvds[part][1]);
        }
      } else if (mb_type == 2) {  // 8x16
        for (int part = 0; part < 2; ++part) {
          int pbx = bx + part * 2;
          int32_t r = pref[part];
          Nbr a, b, c;
          mvf_neighbors(f, pbx, by, 2, &a, &b, &c);
          int32_t px, py;
          if (part == 0 && a.av && a.r == r) { px = a.x; py = a.y; }
          else if (part == 1 && c.av && c.r == r) { px = c.x; py = c.y; }
          else mvf_predict(f, pbx, by, 2, r, &a, &b, &c, &px, &py);
          f.fill(pbx, by, 2, 4, r, px + mb->mvds[part][0],
                 py + mb->mvds[part][1]);
        }
      } else {  // P_8x8 / P_8x8ref0
        int mv_i = 0;
        for (int sub = 0; sub < 4; ++sub) {
          int sbx = bx + (sub % 2) * 2;
          int sby = by + (sub / 2) * 2;
          int32_t r = pref[sub];
          int smt = mb->sub_mb_types[sub];
          int sw = kSubGeom[smt][0], sh = kSubGeom[smt][1];
          int n_w = 2 / sw, n_h = 2 / sh;
          for (int j = 0; j < n_h; ++j)
            for (int i = 0; i < n_w; ++i) {
              int pbx = sbx + i * sw, pby = sby + j * sh;
              int32_t px, py;
              mvf_predict(f, pbx, pby, sw, r, nullptr, nullptr, nullptr,
                          &px, &py);
              f.fill(pbx, pby, sw, sh, r, px + mb->mvds[mv_i][0],
                     py + mb->mvds[mv_i][1]);
              ++mv_i;
            }
        }
      }
    }
  }

  if (!err) {
    for (int r = 0; r < R; ++r)
      for (int c = 0; c < C; ++c) {
        int m = r * C + c;
        int by = (1 + r) * 4, bx = (1 + c) * 4;
        long ia = (long)(by + 0) * w4 + (bx + 3);
        long ib = (long)(by + 3) * w4 + (bx + 0);
        long id = (long)(by + 3) * w4 + (bx + 3);
        out_a[m * 3] = ref[ia]; out_a[m * 3 + 1] = mvx[ia];
        out_a[m * 3 + 2] = mvy[ia];
        out_b[m * 3] = ref[ib]; out_b[m * 3 + 1] = mvx[ib];
        out_b[m * 3 + 2] = mvy[ib];
        out_d[m * 3] = ref[id]; out_d[m * 3 + 1] = mvx[id];
        out_d[m * 3 + 2] = mvy[id];
      }
  }

  delete[] ref;
  delete[] mvx;
  delete[] mvy;
  delete[] filled;
  return err;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused serving prep, threaded across donors (round-3 fresh-donor path).
// ---------------------------------------------------------------------------

extern "C" {

// Defined below (successive-donor section); used by the batch prep.
int cavlc_retarget_recs(MBRec* mbs, int R, int C, int num_ref_composite,
                        const int32_t* ref_map, int ref_map_len,
                        const int32_t* top_ring, const uint8_t* top_valid,
                        const int32_t* left_ring, const uint8_t* left_valid,
                        const int32_t* right_ring,
                        const uint8_t* right_valid);

// Defined below (single-pass ingest); used by the batch prep.
int cavlc_ingest_slice_rows(
    const uint8_t* rbsp, long nbytes, long start_bit, int R, int C,
    int num_ref_donor, int num_ref_composite, const int32_t* ref_map,
    int ref_map_len, int at_left_edge, int at_top_edge,
    const int32_t* top_ring, const uint8_t* top_valid,
    const int32_t* left_ring, const uint8_t* left_valid,
    const int32_t* right_ring, const uint8_t* right_valid, int s_row,
    uint32_t* out_pat, int32_t* out_nb, int32_t* out_first_c,
    uint8_t* out_coded, int32_t* out_a, int32_t* out_b, int32_t* out_d,
    long* out_donor_bits, int* out_has_align, int* out_needed,
    int bug_compat);

// Defined below (fused row ingest); used by the batch prep.
int cavlc_ingest_rows(const MBRec* mbs, int R, int C,
                      int num_ref_composite, const int32_t* ref_map,
                      int ref_map_len, int at_left_edge, int at_top_edge,
                      const uint8_t* src, long src_len,
                      const int32_t* top_ring, const uint8_t* top_valid,
                      const int32_t* left_ring, const uint8_t* left_valid,
                      const int32_t* right_ring,
                      const uint8_t* right_valid, int s_row,
                      uint32_t* out_pat, int32_t* out_nb,
                      int32_t* out_first_c, uint8_t* out_coded,
                      int32_t* out_a, int32_t* out_b, int32_t* out_d,
                      long* out_donor_bits, int* out_has_align,
                      int* out_needed, int bug_compat);

// For each of n donor P-slice payloads: parse -> composite-nC dense
// chunks (thread-local scratch) -> row-contiguous pack -> composite MV
// edge roles, in ONE call, fanned out over n_threads std::threads
// (<=0: hardware_concurrency).  This is the serving ingest hot path:
// one invocation preps a whole batch step's fresh donors with no
// per-stage FFI round trips.
//
// payloads: concatenated bytes; offsets [n+1]; start_bits [n] (bit
// position of the first MB within each payload).  Ring arrays are the
// SHARED composite border (cavlc_mv_edge_roles layout) — the static-
// chrome serving background.  Outputs (leading donor axis):
//   out_pat [n,R,s_row], out_nb [n,R,s_row], out_first_c [n,R],
//   out_coded [n,R*C], out_a/out_b/out_d [n,R*C,3],
//   out_donor_bits [n], out_has_align [n], out_err [n].
// rings_per_donor == 1: the ring arrays carry a leading donor axis
// (top [n,(C+2),3] / [n,(C+2)] etc.) — sessions with different
// composite backgrounds; 0: one shared ring set.
// Per-donor err: parse/prep error codes, or -101 when the donor needs
// more than s_row row slots (caller retries with a bigger class).
// Returns 0 (per-donor status is in out_err).
int cavlc_prepare_rows_batch(
    const uint8_t* payloads, const long* offsets, const long* start_bits,
    int n, int R, int C, int num_ref_donor, int num_ref_composite,
    const int32_t* ref_map, int ref_map_len,
    int at_left_edge, int at_top_edge,
    const int32_t* top_ring, const uint8_t* top_valid,
    const int32_t* left_ring, const uint8_t* left_valid,
    const int32_t* right_ring, const uint8_t* right_valid,
    int s_row,
    uint32_t* out_pat, int32_t* out_nb, int32_t* out_first_c,
    uint8_t* out_coded, int32_t* out_a, int32_t* out_b, int32_t* out_d,
    long* out_donor_bits, int32_t* out_has_align, int32_t* out_err,
    int n_threads, int bug_compat, int retarget_mvs,
    int rings_per_donor) {
  const long M = (long)R * C;
  if (n_threads <= 0) {
    unsigned hw = std::thread::hardware_concurrency();
    n_threads = hw ? (int)hw : 1;
  }
  if (n_threads > n) n_threads = n > 0 ? n : 1;

  std::atomic<int> next{0};
  auto work = [&]() {
    // The record grid is only needed by the two-pass retarget mode; the
    // single-pass ingest walks the bitstream directly.
    MBRec* recs = retarget_mvs ? new MBRec[M] : nullptr;
    int i;
    while ((i = next.fetch_add(1)) < n) {
      const uint8_t* p = payloads + offsets[i];
      long nbytes = offsets[i + 1] - offsets[i];
      const int32_t* tr = top_ring;
      const uint8_t* tv = top_valid;
      const int32_t* lr = left_ring;
      const uint8_t* lv = left_valid;
      const int32_t* rr = right_ring;
      const uint8_t* rv = right_valid;
      if (rings_per_donor) {
        long tn = C + 2, ln = R, rn = R > 1 ? R - 1 : 0;
        tr += (long)i * tn * 3; tv += (long)i * tn;
        lr += (long)i * ln * 3; lv += (long)i * ln;
        rr += (long)i * rn * 3; rv += (long)i * rn;
      }
      long row_bits = 0;
      int has_align = 0, needed = 0;
      int err;
      if (!retarget_mvs) {
        // True single pass: parse + composite re-emit + MV field in one
        // bitstream walk (no MBRec array round trip).
        err = cavlc_ingest_slice_rows(
            p, nbytes, start_bits[i], R, C, num_ref_donor,
            num_ref_composite, ref_map, ref_map_len, at_left_edge,
            at_top_edge, tr, tv, lr, lv, rr, rv, s_row,
            out_pat + (long)i * R * s_row,
            out_nb + (long)i * R * s_row,
            out_first_c + (long)i * R, out_coded + (long)i * M,
            out_a + (long)i * M * 3, out_b + (long)i * M * 3,
            out_d + (long)i * M * 3, &row_bits, &has_align, &needed,
            bug_compat);
      } else {
        // Successive-donor mode: the in-place retarget needs the full
        // record grid (two passes), then the fused record walk.
        long end_bit = 0;
        err = cavlc_parse_slice(p, nbytes, start_bits[i], C, R, 1,
                                num_ref_donor, recs, &end_bit,
                                bug_compat);
        if (!err)
          err = cavlc_retarget_recs(recs, R, C, num_ref_composite,
                                    ref_map, ref_map_len, tr, tv, lr,
                                    lv, rr, rv);
        if (!err)
          err = cavlc_ingest_rows(recs, R, C, num_ref_composite, ref_map,
                                  ref_map_len, at_left_edge, at_top_edge,
                                  p, nbytes, tr, tv, lr, lv, rr, rv,
                                  s_row, out_pat + (long)i * R * s_row,
                                  out_nb + (long)i * R * s_row,
                                  out_first_c + (long)i * R,
                                  out_coded + (long)i * M,
                                  out_a + (long)i * M * 3,
                                  out_b + (long)i * M * 3,
                                  out_d + (long)i * M * 3,
                                  &row_bits, &has_align, &needed,
                                  bug_compat);
      }
      out_donor_bits[i] = row_bits;
      out_has_align[i] = has_align;
      out_err[i] = err;
    }
    delete[] recs;
  };

  if (n_threads <= 1) {
    work();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(work);
    for (auto& th : pool) th.join();
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Successive-donor MV retargeting (round-3 device path for the
// MASTER_DESIGN dynamic-encoder contract): preserve each donor MB's
// DECODED motion exactly across the donor->composite context change by
// rewriting mvds in place, so the standard prepare/pack/roles pipeline
// then serves successive donors unchanged.  Host twin:
// models/splice.donor_mv_targets_from_grid + splice_p_frame(hint_mv=...)
// + finalize's composite resolution.
// ---------------------------------------------------------------------------

namespace {

// Shared decode/rewrite walk.  Record mode (targets == null): decode the
// grid in the field's context, storing each partition's decoded MV into
// rec_targets[m][mv_i] (skip MBs: derived skip MV in slot 0).  Rewrite
// mode (targets != null): resolve refs through ref_map, set each rec's
// mvds[mv_i] = target - prediction, fill the field with the target; skip
// records become explicit P_L0_16x16 pinned to their target.
// One macroblock's motion decode/rewrite step (see mvf_walk_grid).
// map_record: in record mode, resolve refs through ref_map (composite
// roles walk) instead of donor-identity (retarget pass 1);
// rec_targets may be null when the caller only needs the field filled.
int mvf_step_mb(MBRec* mb, int m, int bx, int by, MVField& f,
                const int32_t* ref_map, int ref_map_len,
                const int32_t (*targets)[16][2],
                int32_t (*rec_targets)[16][2], bool map_record) {
  const bool rewrite = targets != nullptr;
  {
    {
      if (mb->kind == 0) {
        if (!rewrite) {
          int32_t px, py;
          mvf_skip(f, bx, by, &px, &py);
          if (rec_targets) {
            rec_targets[m][0][0] = px;
            rec_targets[m][0][1] = py;
          }
          f.fill(bx, by, 4, 4, 0, px, py);
        } else {
          // Convert to explicit P_L0_16x16 pinned to the donor-context
          // skip MV (splice_p_frame's tgt-for-skip rule).
          int32_t r = ref_map[0];
          int32_t px, py;
          mvf_predict(f, bx, by, 4, r, nullptr, nullptr, nullptr,
                      &px, &py);
          mb->kind = 1;
          mb->mb_type = 0;
          mb->n_ref = 1;
          mb->ref_idx[0] = 0;
          mb->n_mvds = 1;
          mb->mvds[0][0] = targets[m][0][0] - px;
          mb->mvds[0][1] = targets[m][0][1] - py;
          mb->cbp = 0;
          f.fill(bx, by, 4, 4, r, targets[m][0][0], targets[m][0][1]);
        }
        return 0;
      }
      if (mb->kind != 1) {  // intra: no motion
        f.fill(bx, by, 4, 4, kIntraRef, 0, 0);
        return 0;
      }
      int pref[4];
      int n_parts = mb->mb_type == 0 ? 1 : (mb->mb_type <= 2 ? 2 : 4);
      for (int i = 0; i < n_parts; ++i) {
        int donor_ref = (mb->mb_type == 4) ? 0
                        : (mb->n_ref > 0 ? mb->ref_idx[i] : 0);
        if (rewrite || map_record) {
          if (donor_ref < 0 || donor_ref >= ref_map_len) return -102;
          pref[i] = ref_map[donor_ref];
        } else {
          pref[i] = donor_ref;
        }
      }

      auto handle = [&](int part, int mv_i, int pbx, int pby, int pw4,
                        int ph4, int32_t px, int32_t py) {
        if (!rewrite) {
          int32_t tx = px + mb->mvds[mv_i][0];
          int32_t ty = py + mb->mvds[mv_i][1];
          if (rec_targets) {
            rec_targets[m][mv_i][0] = tx;
            rec_targets[m][mv_i][1] = ty;
          }
          f.fill(pbx, pby, pw4, ph4, pref[part], tx, ty);
        } else {
          mb->mvds[mv_i][0] = targets[m][mv_i][0] - px;
          mb->mvds[mv_i][1] = targets[m][mv_i][1] - py;
          f.fill(pbx, pby, pw4, ph4, pref[part],
                 targets[m][mv_i][0], targets[m][mv_i][1]);
        }
      };

      if (mb->mb_type == 0) {
        int32_t px, py;
        mvf_predict(f, bx, by, 4, pref[0], nullptr, nullptr, nullptr,
                    &px, &py);
        handle(0, 0, bx, by, 4, 4, px, py);
      } else if (mb->mb_type == 1) {  // 16x8
        for (int part = 0; part < 2; ++part) {
          int pby = by + part * 2;
          int32_t r = pref[part];
          Nbr a, b, c;
          mvf_neighbors(f, bx, pby, 4, &a, &b, &c);
          int32_t px, py;
          if (part == 0 && b.av && b.r == r) { px = b.x; py = b.y; }
          else if (part == 1 && a.av && a.r == r) { px = a.x; py = a.y; }
          else mvf_predict(f, bx, pby, 4, r, &a, &b, &c, &px, &py);
          handle(part, part, bx, pby, 4, 2, px, py);
        }
      } else if (mb->mb_type == 2) {  // 8x16
        for (int part = 0; part < 2; ++part) {
          int pbx = bx + part * 2;
          int32_t r = pref[part];
          Nbr a, b, c;
          mvf_neighbors(f, pbx, by, 2, &a, &b, &c);
          int32_t px, py;
          if (part == 0 && a.av && a.r == r) { px = a.x; py = a.y; }
          else if (part == 1 && c.av && c.r == r) { px = c.x; py = c.y; }
          else mvf_predict(f, pbx, by, 2, r, &a, &b, &c, &px, &py);
          handle(part, part, pbx, by, 2, 4, px, py);
        }
      } else {  // P_8x8 / P_8x8ref0
        int mv_i = 0;
        for (int sub = 0; sub < 4; ++sub) {
          int sbx = bx + (sub % 2) * 2;
          int sby = by + (sub / 2) * 2;
          int smt = mb->sub_mb_types[sub];
          int sw = kSubGeom[smt][0], sh = kSubGeom[smt][1];
          int n_w = 2 / sw, n_h = 2 / sh;
          for (int j = 0; j < n_h; ++j)
            for (int i = 0; i < n_w; ++i) {
              int pbx = sbx + i * sw, pby = sby + j * sh;
              int32_t px, py;
              mvf_predict(f, pbx, pby, sw, pref[sub], nullptr, nullptr,
                          nullptr, &px, &py);
              handle(sub, mv_i, pbx, pby, sw, sh, px, py);
              ++mv_i;
            }
        }
      }
    }
  }
  return 0;
}

int mvf_walk_grid(MBRec* mbs, int R, int C, MVField& f, int ox4, int oy4,
                  const int32_t* ref_map, int ref_map_len,
                  const int32_t (*targets)[16][2],
                  int32_t (*rec_targets)[16][2],
                  const int32_t* right_ring = nullptr,
                  const uint8_t* right_valid = nullptr) {
  for (int mb_y = 0; mb_y < R; ++mb_y) {
    // Lazy right-ring fill (see cavlc_mv_edge_roles comment).
    if (right_ring && mb_y > 0 && mb_y - 1 < R - 1 &&
        right_valid[mb_y - 1])
      f.fill(ox4 + C * 4, oy4 + (mb_y - 1) * 4, 4, 4,
             right_ring[(mb_y - 1) * 3], right_ring[(mb_y - 1) * 3 + 1],
             right_ring[(mb_y - 1) * 3 + 2]);
    for (int mb_x = 0; mb_x < C; ++mb_x) {
      int m = mb_y * C + mb_x;
      int err = mvf_step_mb(&mbs[m], m, ox4 + mb_x * 4, oy4 + mb_y * 4,
                            f, ref_map, ref_map_len, targets,
                            rec_targets, false);
      if (err) return err;
    }
  }
  return 0;
}

struct FieldBuf {
  int32_t *ref, *mvx, *mvy;
  uint8_t* filled;
  MVField f;
  FieldBuf(int w4, int h4) {
    long cells = (long)w4 * h4;
    ref = new int32_t[cells];
    mvx = new int32_t[cells]();
    mvy = new int32_t[cells]();
    filled = new uint8_t[cells]();
    for (long i = 0; i < cells; ++i) ref[i] = -9;
    f = MVField{w4, h4, ref, mvx, mvy, filled};
  }
  ~FieldBuf() {
    delete[] ref;
    delete[] mvx;
    delete[] mvy;
    delete[] filled;
  }
};

}  // namespace

extern "C" {

// In-place successive-donor retarget of a parsed MBRec grid (see header
// comment above).  Rings: composite border, cavlc_mv_edge_roles layout.
// Returns 0, or -102 on an unmappable donor ref.
int cavlc_retarget_recs(MBRec* mbs, int R, int C, int num_ref_composite,
                        const int32_t* ref_map, int ref_map_len,
                        const int32_t* top_ring, const uint8_t* top_valid,
                        const int32_t* left_ring, const uint8_t* left_valid,
                        const int32_t* right_ring,
                        const uint8_t* right_valid) {
  long m_total = (long)R * C;
  int32_t(*targets)[16][2] = new int32_t[m_total][16][2]();

  {  // Pass 1: donor-context decode (frame edges, donor ref indices).
    FieldBuf donor_f(C * 4, R * 4);
    int err = mvf_walk_grid(mbs, R, C, donor_f.f, 0, 0, nullptr, 0,
                            nullptr, targets);
    if (err) { delete[] targets; return err; }
  }

  // Pass 2: composite-context rewrite inside the rings.
  FieldBuf comp_f((C + 2) * 4, (R + 1) * 4);
  for (int c = 0; c < C + 2; ++c)
    if (top_valid[c])
      comp_f.f.fill(c * 4, 0, 4, 4, top_ring[c * 3], top_ring[c * 3 + 1],
                    top_ring[c * 3 + 2]);
  for (int r = 0; r < R; ++r)
    if (left_valid[r])
      comp_f.f.fill(0, (1 + r) * 4, 4, 4, left_ring[r * 3],
                    left_ring[r * 3 + 1], left_ring[r * 3 + 2]);
  (void)num_ref_composite;
  int err = mvf_walk_grid(mbs, R, C, comp_f.f, 4, 4,
                          ref_map, ref_map_len, targets, nullptr,
                          right_ring, right_valid);
  delete[] targets;
  return err;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused row ingest: one walk emits the row-contiguous chunk stream AND
// decodes the composite MV field (edge roles) — replacing the
// prepare_dense -> pack_rows -> mv_edge_roles three-pass pipeline in the
// batch serving path (identical outputs; one pass over the records, no
// intermediate per-MB chunk arrays).
// ---------------------------------------------------------------------------

extern "C" {

int cavlc_ingest_rows(const MBRec* mbs, int R, int C,
                      int num_ref_composite, const int32_t* ref_map,
                      int ref_map_len, int at_left_edge, int at_top_edge,
                      const uint8_t* src, long src_len,
                      const int32_t* top_ring, const uint8_t* top_valid,
                      const int32_t* left_ring, const uint8_t* left_valid,
                      const int32_t* right_ring,
                      const uint8_t* right_valid, int s_row,
                      uint32_t* out_pat, int32_t* out_nb,
                      int32_t* out_first_c, uint8_t* out_coded,
                      int32_t* out_a, int32_t* out_b, int32_t* out_d,
                      long* out_donor_bits, int* out_has_align,
                      int* out_needed, int bug_compat) {
  // Composite nC tracker.
  CoeffCtx* top = new CoeffCtx[C];
  CoeffCtx* cur = new CoeffCtx[C];
  bool* top_set = new bool[C]();
  bool* cur_set = new bool[C]();
  Tracker trk{C, top, cur, top_set, cur_set, {}, false,
              (int8_t)(bug_compat ? 0 : 16)};
  auto cleanup = [&]() {
    delete[] top;
    delete[] cur;
    delete[] top_set;
    delete[] cur_set;
  };

  // Composite MV field with the border rings (right ring fills lazily).
  FieldBuf fb((C + 2) * 4, (R + 1) * 4);
  for (int c = 0; c < C + 2; ++c)
    if (top_valid[c])
      fb.f.fill(c * 4, 0, 4, 4, top_ring[c * 3], top_ring[c * 3 + 1],
                top_ring[c * 3 + 2]);
  for (int r = 0; r < R; ++r)
    if (left_valid[r])
      fb.f.fill(0, (1 + r) * 4, 4, 4, left_ring[r * 3],
                left_ring[r * 3 + 1], left_ring[r * 3 + 2]);

  long donor_bits = 0;
  int has_align = 0;
  int needed = 0;
  int err = 0;

  for (int row = 0; row < R && !err; ++row) {
    if (row > 0 && row - 1 < R - 1 && right_valid[row - 1])
      fb.f.fill((C + 1) * 4, row * 4, 4, 4, right_ring[(row - 1) * 3],
                right_ring[(row - 1) * 3 + 1],
                right_ring[(row - 1) * 3 + 2]);
    ChunkWriter cw(out_pat + (long)row * s_row,
                   out_nb + (long)row * s_row, s_row);
    int last = -1;
    out_first_c[row] = -1;
    for (int col = 0; col < C && !err; ++col) {
      int m = row * C + col;
      MBRec* mb = const_cast<MBRec*>(&mbs[m]);
      int bx = 4 + col * 4, by = 4 + row * 4;
      if (mb->kind == 0) {
        if (ref_map[0] != 0) { err = -103; break; }  // see prepare_dense
        out_coded[m] = 0;
        CoeffCtx z;
        std::memset(&z, 0, sizeof(z));
        trk.push(col, z);
        err = mvf_step_mb(mb, m, bx, by, fb.f, ref_map, ref_map_len,
                          nullptr, nullptr, true);
        continue;
      }
      out_coded[m] = 1;
      if (last < 0) {
        out_first_c[row] = col;
      } else {
        cw.ue((uint32_t)(col - last - 1));
      }
      last = col;
      err = emit_dense_mb(cw, mb, trk, col, row, num_ref_composite,
                          ref_map, ref_map_len, at_left_edge,
                          at_top_edge, src, src_len);
      if (!err)
        err = mvf_step_mb(mb, m, bx, by, fb.f, ref_map, ref_map_len,
                          nullptr, nullptr, true);
    }
    cw.flush();
    cw.terminate();
    if (cw.chunks() > needed) needed = cw.chunks();
    donor_bits += cw.bits();
    if (cw.has_align()) has_align = 1;
    trk.end_row();
  }

  if (!err) {
    for (int r = 0; r < R; ++r)
      for (int c = 0; c < C; ++c) {
        int m = r * C + c;
        int by = (1 + r) * 4, bx = (1 + c) * 4;
        long ia = (long)(by + 0) * fb.f.w4 + (bx + 3);
        long ib = (long)(by + 3) * fb.f.w4 + (bx + 0);
        long id = (long)(by + 3) * fb.f.w4 + (bx + 3);
        out_a[m * 3] = fb.ref[ia];
        out_a[m * 3 + 1] = fb.mvx[ia];
        out_a[m * 3 + 2] = fb.mvy[ia];
        out_b[m * 3] = fb.ref[ib];
        out_b[m * 3 + 1] = fb.mvx[ib];
        out_b[m * 3 + 2] = fb.mvy[ib];
        out_d[m * 3] = fb.ref[id];
        out_d[m * 3 + 1] = fb.mvx[id];
        out_d[m * 3 + 2] = fb.mvy[id];
      }
  }

  cleanup();
  *out_needed = needed;
  *out_donor_bits = donor_bits;
  *out_has_align = has_align;
  if (err) return err;
  return (needed > s_row) ? -101 : 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// True single-pass ingest (fresh-donor serving): walk the donor P-slice
// bitstream ONCE, and for each macroblock immediately (a) re-emit its
// composite-context chunk stream into the row layout and (b) step the
// composite MV field — no intermediate MBRec array, no second walk.
// Semantics identical to cavlc_parse_slice + cavlc_ingest_rows
// (differential-tested through the batch wrapper).  Retarget mode still
// needs the two-pass record structure and keeps the array path.
// ---------------------------------------------------------------------------

extern "C" {

int cavlc_ingest_slice_rows(
    const uint8_t* rbsp, long nbytes, long start_bit, int R, int C,
    int num_ref_donor, int num_ref_composite, const int32_t* ref_map,
    int ref_map_len, int at_left_edge, int at_top_edge,
    const int32_t* top_ring, const uint8_t* top_valid,
    const int32_t* left_ring, const uint8_t* left_valid,
    const int32_t* right_ring, const uint8_t* right_valid, int s_row,
    uint32_t* out_pat, int32_t* out_nb, int32_t* out_first_c,
    uint8_t* out_coded, int32_t* out_a, int32_t* out_b, int32_t* out_d,
    long* out_donor_bits, int* out_has_align, int* out_needed,
    int bug_compat) {
  BitReader br(rbsp, nbytes, start_bit);
  // Donor-context tracker (drives DECODE nC) and composite-context
  // tracker (drives re-encoded token nC) advance together.
  CoeffCtx* ptop = new CoeffCtx[C];
  CoeffCtx* pcur = new CoeffCtx[C];
  bool* ptop_set = new bool[C]();
  bool* pcur_set = new bool[C]();
  Tracker ptrk{C, ptop, pcur, ptop_set, pcur_set};
  ptrk.ipcm_nc = bug_compat ? 0 : 16;
  CoeffCtx* etop = new CoeffCtx[C];
  CoeffCtx* ecur = new CoeffCtx[C];
  bool* etop_set = new bool[C]();
  bool* ecur_set = new bool[C]();
  Tracker etrk{C, etop, ecur, etop_set, ecur_set};
  etrk.ipcm_nc = bug_compat ? 0 : 16;
  auto cleanup = [&]() {
    delete[] ptop; delete[] pcur; delete[] ptop_set; delete[] pcur_set;
    delete[] etop; delete[] ecur; delete[] etop_set; delete[] ecur_set;
  };

  FieldBuf fb((C + 2) * 4, (R + 1) * 4);
  for (int c = 0; c < C + 2; ++c)
    if (top_valid[c])
      fb.f.fill(c * 4, 0, 4, 4, top_ring[c * 3], top_ring[c * 3 + 1],
                top_ring[c * 3 + 2]);
  for (int r = 0; r < R; ++r)
    if (left_valid[r])
      fb.f.fill(0, (1 + r) * 4, 4, 4, left_ring[r * 3],
                left_ring[r * 3 + 1], left_ring[r * 3 + 2]);

  long donor_bits = 0;
  int has_align = 0;
  int needed = 0;
  int err = 0;
  int total = R * C;
  int count = 0;
  int cur_row = -1;
  int last_col = -1;
  ChunkWriter cw(out_pat, out_nb, s_row);  // rebound per row below
  MBRec rec;

  // Span-verbatim fast path precondition: with an identity ref map the
  // emitted values equal the source values, and an interior MB
  // (col > 0 AND row > 0) sees identical neighbor nC in donor and
  // composite contexts — so its re-encoded bits equal its source bits,
  // except the ref_idx te(v) fields when the active-ref counts differ.
  bool ident_map = ref_map_len >= num_ref_donor;
  for (int i = 0; i < num_ref_donor && ident_map; ++i)
    ident_map = ref_map[i] == i;

  auto begin_row = [&](int row) {
    if (cur_row >= 0) {
      cw.flush();
      cw.terminate();
      if (cw.chunks() > needed) needed = cw.chunks();
      donor_bits += cw.bits();
      if (cw.has_align()) has_align = 1;
      ptrk.end_row();
      etrk.end_row();
    }
    cur_row = row;
    last_col = -1;
    out_first_c[row] = -1;
    cw = ChunkWriter(out_pat + (long)row * s_row,
                     out_nb + (long)row * s_row, s_row);
    if (row > 0 && row - 1 < R - 1 && right_valid[row - 1])
      fb.f.fill((C + 1) * 4, row * 4, 4, 4, right_ring[(row - 1) * 3],
                right_ring[(row - 1) * 3 + 1],
                right_ring[(row - 1) * 3 + 2]);
  };

  while (count < total && !err) {
    uint32_t skip_run = br.ue();
    if (skip_run > 0 && ref_map[0] != 0) { err = -103; break; }
    for (uint32_t sk = 0; sk < skip_run && count < total; ++sk) {
      int row = count / C, col = count % C;
      if (col == 0) begin_row(row);
      CoeffCtx z;
      std::memset(&z, 0, sizeof(z));
      ptrk.push(col, z);
      etrk.push(col, z);
      out_coded[count] = 0;
      rec.kind = 0;
      err = mvf_step_mb(&rec, count, 4 + col * 4, 4 + row * 4, fb.f,
                        ref_map, ref_map_len, nullptr, nullptr, true);
      ++count;
      if (err) break;
    }
    if (count >= total || err) break;
    int row = count / C, col = count % C;
    if (col == 0) begin_row(row);

    long mb_start = br.pos();
    init_mb(&rec);
    uint32_t t = br.ue();
    rec.mb_type = (int32_t)t;
    if (t <= 4) err = parse_inter(br, &rec, (int)t, num_ref_donor,
                                  ptrk, col);
    else if (t == 5) err = parse_i4x4(br, &rec, ptrk, col);
    else if (t <= 29) err = parse_i16x16(br, &rec, (int)t - 6, ptrk, col);
    else if (t == 30) err = parse_ipcm(br, &rec, ptrk, col);
    else err = kErrMbType;
    if (!err && br.past_end()) err = kErrEof;
    if (err) break;

    out_coded[count] = 1;
    if (last_col < 0) {
      out_first_c[row] = col;
    } else {
      cw.ue((uint32_t)(col - last_col - 1));
    }
    last_col = col;
    if (ident_map && row > 0 && col > 0 && rec.kind != 4) {
      // Span-verbatim: copy the MB's source bits (splitting around the
      // ref fields when te(v) widths differ); tracker context comes
      // from the parse side — identical by construction.
      long mb_end = br.pos();
      if (rec.kind != 1 || num_ref_donor == num_ref_composite) {
        cw.copy_bits(rbsp, nbytes, mb_start, mb_end - mb_start);
      } else {
        long rs = rec.pred_bits_start, rl = rec.pred_bits_len;
        cw.copy_bits(rbsp, nbytes, mb_start, rs - mb_start);
        if (num_ref_composite > 1 && rec.mb_type != 4) {
          int n_parts = rec.mb_type == 0 ? 1
                        : (rec.mb_type <= 2 ? 2 : 4);
          int n_refs = rec.mb_type == 3 ? 4 : n_parts;
          for (int i = 0; i < n_refs && !err; ++i) {
            int ref = (rec.n_ref > 0) ? rec.ref_idx[i] : 0;
            if (ref >= num_ref_composite) { err = -102; break; }
            if (num_ref_composite == 2) cw.put(1 - (ref & 1), 1);
            else cw.ue((uint32_t)ref);
          }
        } else if (rec.n_ref > 0) {
          // Composite list has one entry: every donor ref must be 0.
          for (int i = 0; i < rec.n_ref && !err; ++i)
            if (rec.ref_idx[i] != 0) err = -102;
        }
        if (!err)
          cw.copy_bits(rbsp, nbytes, rs + rl, mb_end - rs - rl);
      }
      if (!err) etrk.push(col, pcur[col]);
    } else {
      err = emit_dense_mb(cw, &rec, etrk, col, row, num_ref_composite,
                          ref_map, ref_map_len, at_left_edge,
                          at_top_edge, rbsp, nbytes);
    }
    if (!err)
      err = mvf_step_mb(&rec, count, 4 + col * 4, 4 + row * 4, fb.f,
                        ref_map, ref_map_len, nullptr, nullptr, true);
    ++count;
  }
  if (!err && cur_row >= 0) {
    cw.flush();
    cw.terminate();
    if (cw.chunks() > needed) needed = cw.chunks();
    donor_bits += cw.bits();
    if (cw.has_align()) has_align = 1;
  }
  // Rows never reached (trailing all-skip rows ended the stream early,
  // or the loop exited at a row boundary): mark them all-skipped.
  if (!err) {
    for (int row = (count + C - 1) / C; row < R; ++row)
      out_first_c[row] = -1;
  }

  if (!err) {
    for (int r = 0; r < R; ++r)
      for (int c = 0; c < C; ++c) {
        int m = r * C + c;
        int by = (1 + r) * 4, bx = (1 + c) * 4;
        long ia = (long)(by + 0) * fb.f.w4 + (bx + 3);
        long ib = (long)(by + 3) * fb.f.w4 + (bx + 0);
        long id = (long)(by + 3) * fb.f.w4 + (bx + 3);
        out_a[m * 3] = fb.ref[ia];
        out_a[m * 3 + 1] = fb.mvx[ia];
        out_a[m * 3 + 2] = fb.mvy[ia];
        out_b[m * 3] = fb.ref[ib];
        out_b[m * 3 + 1] = fb.mvx[ib];
        out_b[m * 3 + 2] = fb.mvy[ib];
        out_d[m * 3] = fb.ref[id];
        out_d[m * 3 + 1] = fb.mvx[id];
        out_d[m * 3 + 2] = fb.mvy[id];
      }
  }

  cleanup();
  *out_needed = needed;
  *out_donor_bits = donor_bits;
  *out_has_align = has_align;
  if (err) return err;
  return (needed > s_row) ? -101 : 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Blob serving wire: one uint32 record per donor carrying every field of
// the flat wire (models/splice_device.flat_wire_layout) — flat chunk
// stream + per-row len/tail + sparse nbits exceptions + first_c/coded +
// int16 edge read-set roles.  Emitting it natively removes the numpy
// compaction + pack from the serving hot loop, and the single record
// means ONE host->device transfer per batch step.
// Word packing is little-endian within each word on both sides.
// ---------------------------------------------------------------------------

namespace {

constexpr int kErrRoleRange = -104;   // edge role exceeds int16
constexpr int kErrExcOverflow = -105; // nbits exceptions exceed s_exc

inline long words_of(long bytes) { return (bytes + 3) >> 2; }

// Mirrors splice_device.flat_wire_layout: sequential fields, each
// starting at a word boundary.
struct BlobLayout {
  long flat, row_len, row_tail, exc_idx, exc_val, first_c, coded;
  long edge[15];  // a_ref,a_mvx,a_mvy, bb_*, lb_*, d_*, db_*
  long stride;
};

BlobLayout blob_layout(int R, int C, int s_flat, int s_exc) {
  BlobLayout L;
  long off = 0;
  L.flat = off; off += s_flat;
  L.row_len = off; off += words_of(2L * R);
  L.row_tail = off; off += words_of(R);
  L.exc_idx = off; off += words_of(2L * s_exc);
  L.exc_val = off; off += words_of(s_exc);
  L.first_c = off; off += words_of(2L * R);
  L.coded = off; off += ((long)R * C + 31) >> 5;   // 1 bit per MB
  const int edge_is_c[15] = {0, 0, 0, 1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 1, 1};
  for (int k = 0; k < 15; ++k) {
    L.edge[k] = off;
    off += words_of(2L * (edge_is_c[k] ? C : R));
  }
  L.stride = off;
  return L;
}

inline int put_i16(uint8_t* base, long word_off, long idx, int32_t v) {
  if (v < -32768 || v > 32767) return kErrRoleRange;
  int16_t x = (int16_t)v;
  std::memcpy(base + word_off * 4 + idx * 2, &x, 2);
  return 0;
}

// Compact one donor's padded row arrays into its blob record.
int blobify_donor(const uint32_t* pat, const int32_t* nb,
                  const int32_t* first_c, const uint8_t* coded,
                  const int32_t* a, const int32_t* b, const int32_t* d,
                  int R, int C, int s_row, int s_flat, int s_exc,
                  uint32_t* blob, const BlobLayout& L, int* needed_flat) {
  uint8_t* u8 = (uint8_t*)blob;
  std::memset(blob, 0, (size_t)L.stride * 4);
  long total = 0;
  int n_exc = 0;
  int err = 0;
  for (int r = 0; r < R; ++r) {
    const uint32_t* rp = pat + (long)r * s_row;
    const int32_t* rn = nb + (long)r * s_row;
    int len = s_row;
    while (len > 0 && rn[len - 1] == 0) --len;
    if (total + len > s_flat) {
      // Keep scanning to report the true need, but stop writing.
      total += len;
      continue;
    }
    for (int j = 0; j < len; ++j) {
      blob[L.flat + total + j] = rp[j];
      int32_t expect = (j == len - 1) ? rn[len - 1] : 32;
      if (rn[j] != expect && j != len - 1) {
        if (n_exc < s_exc) {
          err |= put_i16(u8, L.exc_idx, n_exc, (int32_t)(total + j));
          ((int8_t*)u8)[L.exc_val * 4 + n_exc] = (int8_t)rn[j];
        }
        ++n_exc;
      }
    }
    err |= put_i16(u8, L.row_len, r, len);
    ((int8_t*)u8)[L.row_tail * 4 + r] = (int8_t)(len ? rn[len - 1] : 0);
    total += len;
  }
  *needed_flat = (int)total;
  if (total > s_flat) return -101;
  if (n_exc > s_exc) return kErrExcOverflow;
  for (int e = n_exc; e < s_exc; ++e)
    put_i16(u8, L.exc_idx, e, -1);
  for (int r = 0; r < R; ++r)
    err |= put_i16(u8, L.first_c, r, first_c[r]);
  for (long m = 0; m < (long)R * C; ++m)
    if (coded[m]) blob[L.coded + (m >> 5)] |= 1u << (m & 31);
  // Edge read-set roles (order = _EDGE_WIRE_FIELDS).
  for (int comp = 0; comp < 3; ++comp) {
    for (int r = 0; r < R; ++r) {
      err |= put_i16(u8, L.edge[0 + comp], r,
                     a[((long)r * C + C - 1) * 3 + comp]);      // a: right col
      err |= put_i16(u8, L.edge[6 + comp], r,
                     b[((long)r * C + 0) * 3 + comp]);          // lb: left col
      err |= put_i16(u8, L.edge[9 + comp], r,
                     d[((long)r * C + C - 1) * 3 + comp]);      // d: right col
    }
    for (int c = 0; c < C; ++c) {
      err |= put_i16(u8, L.edge[3 + comp], c,
                     b[((long)(R - 1) * C + c) * 3 + comp]);    // bb: bottom
      err |= put_i16(u8, L.edge[12 + comp], c,
                     d[((long)(R - 1) * C + c) * 3 + comp]);    // db: bottom
    }
  }
  return err ? kErrRoleRange : 0;
}

}  // namespace

extern "C" {

long cavlc_blob_stride(int R, int C, int s_flat, int s_exc) {
  return blob_layout(R, C, s_flat, s_exc).stride;
}

// prepare_rows_batch with native blob emission: identical ingest, but
// each donor's outputs land in thread-local scratch and are compacted
// straight into out_blob[i * stride].
int cavlc_prepare_rows_blob_batch(
    const uint8_t* payloads, const long* offsets, const long* start_bits,
    int n, int R, int C, int num_ref_donor, int num_ref_composite,
    const int32_t* ref_map, int ref_map_len,
    int at_left_edge, int at_top_edge,
    const int32_t* top_ring, const uint8_t* top_valid,
    const int32_t* left_ring, const uint8_t* left_valid,
    const int32_t* right_ring, const uint8_t* right_valid,
    int s_row, int s_flat, int s_exc,
    uint32_t* out_blob, long* out_donor_bits, int32_t* out_has_align,
    int32_t* out_needed, int32_t* out_err,
    int n_threads, int bug_compat, int retarget_mvs,
    int rings_per_donor) {
  const long M = (long)R * C;
  const BlobLayout L = blob_layout(R, C, s_flat, s_exc);
  if (n_threads <= 0) {
    unsigned hw = std::thread::hardware_concurrency();
    n_threads = hw ? (int)hw : 1;
  }
  if (n_threads > n) n_threads = n > 0 ? n : 1;

  std::atomic<int> next{0};
  auto work = [&]() {
    MBRec* recs = retarget_mvs ? new MBRec[M] : nullptr;
    std::vector<uint32_t> pat((long)R * s_row);
    std::vector<int32_t> nb((long)R * s_row);
    std::vector<int32_t> first_c(R);
    std::vector<uint8_t> coded(M);
    std::vector<int32_t> va(M * 3), vb(M * 3), vd(M * 3);
    int i;
    while ((i = next.fetch_add(1)) < n) {
      const uint8_t* p = payloads + offsets[i];
      long nbytes = offsets[i + 1] - offsets[i];
      const int32_t* tr = top_ring;
      const uint8_t* tv = top_valid;
      const int32_t* lr = left_ring;
      const uint8_t* lv = left_valid;
      const int32_t* rr = right_ring;
      const uint8_t* rv = right_valid;
      if (rings_per_donor) {
        long tn = C + 2, ln = R, rn = R > 1 ? R - 1 : 0;
        tr += (long)i * tn * 3; tv += (long)i * tn;
        lr += (long)i * ln * 3; lv += (long)i * ln;
        rr += (long)i * rn * 3; rv += (long)i * rn;
      }
      std::memset(nb.data(), 0, sizeof(int32_t) * (size_t)R * s_row);
      long row_bits = 0;
      int has_align = 0, needed = 0;
      int err;
      if (!retarget_mvs) {
        err = cavlc_ingest_slice_rows(
            p, nbytes, start_bits[i], R, C, num_ref_donor,
            num_ref_composite, ref_map, ref_map_len, at_left_edge,
            at_top_edge, tr, tv, lr, lv, rr, rv, s_row,
            pat.data(), nb.data(), first_c.data(), coded.data(),
            va.data(), vb.data(), vd.data(), &row_bits, &has_align,
            &needed, bug_compat);
      } else {
        long end_bit = 0;
        err = cavlc_parse_slice(p, nbytes, start_bits[i], C, R, 1,
                                num_ref_donor, recs, &end_bit,
                                bug_compat);
        if (!err)
          err = cavlc_retarget_recs(recs, R, C, num_ref_composite,
                                    ref_map, ref_map_len, tr, tv, lr,
                                    lv, rr, rv);
        if (!err)
          err = cavlc_ingest_rows(recs, R, C, num_ref_composite, ref_map,
                                  ref_map_len, at_left_edge, at_top_edge,
                                  p, nbytes, tr, tv, lr, lv, rr, rv,
                                  s_row, pat.data(), nb.data(),
                                  first_c.data(), coded.data(),
                                  va.data(), vb.data(), vd.data(),
                                  &row_bits, &has_align, &needed,
                                  bug_compat);
      }
      int needed_flat = 0;
      if (!err)
        err = blobify_donor(pat.data(), nb.data(), first_c.data(),
                            coded.data(), va.data(), vb.data(), vd.data(),
                            R, C, s_row, s_flat, s_exc,
                            out_blob + (long)i * L.stride, L,
                            &needed_flat);
      out_donor_bits[i] = row_bits;
      out_has_align[i] = has_align;
      out_needed[i] = needed_flat > needed ? needed_flat : needed;
      out_err[i] = err;
    }
    delete[] recs;
  };

  if (n_threads <= 1) {
    work();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(work);
    for (auto& th : pool) th.join();
  }
  return 0;
}

}  // extern "C"
