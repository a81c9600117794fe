// Native CABAC residual-coding core.
//
// Bit-exact port of the verified Python engines (hm16_2_tpu/bitstream/
// cabac.py) and residual syntax (decode/ctu_dec.py::_parse_residual,
// encode/ctu_enc.py::_enc_residual), which themselves mirror the HEVC
// reference (TDecSbac.cpp:1142-1599, TEncSbac.cpp:1172-1529).
//
// The Python layer drives CU-level syntax and hands each TU's residual to
// these functions, passing engine + context state in and out.  State
// tables are injected once via set_tables().

#include <cstdint>
#include <cstring>

extern "C" {

static const uint8_t *g_lps = nullptr;      // [64][4]
static const uint8_t *g_renorm = nullptr;   // [32]
static const uint8_t *g_next_mps = nullptr; // [128]
static const uint8_t *g_next_lps = nullptr; // [128]

void set_tables(const uint8_t *lps, const uint8_t *renorm,
                const uint8_t *next_mps, const uint8_t *next_lps) {
  g_lps = lps; g_renorm = renorm; g_next_mps = next_mps; g_next_lps = next_lps;
}

// ---------------------------------------------------------------------------
// Engine state blocks (mirrors Python object fields)
// ---------------------------------------------------------------------------

struct DecState {
  const uint8_t *buf;
  int64_t pos;
  int64_t len;
  int32_t range_;
  int64_t value;
  int32_t bits_needed;
};

struct EncState {
  uint8_t *out;      // output byte buffer (caller-allocated, large enough)
  int64_t n;         // bytes written
  uint32_t low;
  int32_t range_;
  int32_t bits_left;
  int32_t num_buffered;
  int32_t buffered_byte;
  int32_t counting;     // 1 = bit-estimation mode (TEncBinCABACCounter)
  int32_t _pad;
  int64_t frac_bits;    // accumulated 15-bit fractional bits when counting
  int64_t bins;         // total bins coded (cabac_zero_words accounting)
};

static inline int read_byte(DecState *s) {
  if (s->pos >= s->len) return 0;
  return s->buf[s->pos++];
}

static inline int dec_bin(DecState *s, uint8_t *ctx, int idx) {
  int st = ctx[idx];
  int lps = g_lps[(st >> 1) * 4 + ((s->range_ >> 6) - 4)];
  s->range_ -= lps;
  int64_t scaled = (int64_t)s->range_ << 7;
  int binv;
  if (s->value < scaled) {
    binv = st & 1;
    ctx[idx] = g_next_mps[st];
    if (scaled < (256 << 7)) {
      s->range_ = (int32_t)(scaled >> 6);
      s->value += s->value;
      if (++s->bits_needed == 0) { s->bits_needed = -8; s->value += read_byte(s); }
    }
  } else {
    binv = 1 - (st & 1);
    int nbits = g_renorm[lps >> 3];
    s->value = (s->value - scaled) << nbits;
    s->range_ = lps << nbits;
    ctx[idx] = g_next_lps[st];
    s->bits_needed += nbits;
    if (s->bits_needed >= 0) {
      s->value += (int64_t)read_byte(s) << s->bits_needed;
      s->bits_needed -= 8;
    }
  }
  return binv;
}

static inline int dec_bin_ep(DecState *s) {
  s->value += s->value;
  if (++s->bits_needed >= 0) { s->bits_needed = -8; s->value += read_byte(s); }
  int64_t scaled = (int64_t)s->range_ << 7;
  if (s->value >= scaled) { s->value -= scaled; return 1; }
  return 0;
}

static int dec_aligned_bins_ep(DecState *s, int num) {
  int64_t bins = 0;
  int remaining = num;
  while (remaining > 0) {
    int to_read = remaining < 8 ? remaining : 8;
    int mask = (1 << to_read) - 1;
    int64_t nb = (s->value >> (15 - to_read)) & mask;
    bins = (bins << to_read) | nb;
    s->value = (s->value << to_read) & 0x7FFF;
    remaining -= to_read;
    s->bits_needed += to_read;
    if (s->bits_needed >= 0) {
      s->value |= (int64_t)read_byte(s) << s->bits_needed;
      s->bits_needed -= 8;
    }
  }
  return (int)bins;
}

static int64_t dec_bins_ep(DecState *s, int num) {
  if (num == 0) return 0;
  if (s->range_ == 256) return dec_aligned_bins_ep(s, num);
  int64_t bins = 0;
  while (num > 8) {
    s->value = (s->value << 8) + ((int64_t)read_byte(s) << (8 + s->bits_needed));
    int64_t scaled = (int64_t)s->range_ << 15;
    for (int i = 0; i < 8; i++) {
      bins += bins; scaled >>= 1;
      if (s->value >= scaled) { bins++; s->value -= scaled; }
    }
    num -= 8;
  }
  s->bits_needed += num;
  s->value <<= num;
  if (s->bits_needed >= 0) {
    s->value += (int64_t)read_byte(s) << s->bits_needed;
    s->bits_needed -= 8;
  }
  int64_t scaled = (int64_t)s->range_ << (num + 7);
  for (int i = 0; i < num; i++) {
    bins += bins; scaled >>= 1;
    if (s->value >= scaled) { bins++; s->value -= scaled; }
  }
  return bins;
}

static inline int dec_ep1(DecState *s) {
  if (s->range_ == 256) return dec_aligned_bins_ep(s, 1);
  return dec_bin_ep(s);
}

// ---------------------------------------------------------------------------
// Encoder engine
// ---------------------------------------------------------------------------

static inline void enc_write_out(EncState *s) {
  uint32_t lead = s->low >> (24 - s->bits_left);
  s->bits_left += 8;
  s->low &= 0xFFFFFFFFu >> s->bits_left;
  if (lead == 0xFF) {
    s->num_buffered++;
  } else if (s->num_buffered > 0) {
    uint32_t carry = lead >> 8;
    s->out[s->n++] = (uint8_t)(s->buffered_byte + carry);
    s->buffered_byte = lead & 0xFF;
    uint8_t fill = (uint8_t)(0xFF + carry);
    while (s->num_buffered > 1) { s->out[s->n++] = fill; s->num_buffered--; }
  } else {
    s->num_buffered = 1;
    s->buffered_byte = lead;
  }
}

static inline void enc_test_write(EncState *s) {
  if (s->bits_left < 12) enc_write_out(s);
}

static const int64_t *g_entropy_bits = 0;

extern "C" void set_entropy_table(const void *eb) {
  g_entropy_bits = (const int64_t *)eb;
}

static inline void enc_bin(EncState *s, uint8_t *ctx, int idx, int binv) {
  s->bins++;
  int st = ctx[idx];
  if (s->counting) {
    s->frac_bits += g_entropy_bits[st ^ binv];
    ctx[idx] = (binv == (st & 1)) ? g_next_mps[st] : g_next_lps[st];
    return;
  }
  int lps = g_lps[(st >> 1) * 4 + ((s->range_ >> 6) & 3)];
  s->range_ -= lps;
  if (binv != (st & 1)) {
    int nbits = g_renorm[lps >> 3];
    s->low = (s->low + s->range_) << nbits;
    s->range_ = lps << nbits;
    ctx[idx] = g_next_lps[st];
    s->bits_left -= nbits;
    enc_test_write(s);
  } else {
    ctx[idx] = g_next_mps[st];
    if (s->range_ < 256) {
      s->low <<= 1; s->range_ <<= 1; s->bits_left--;
      enc_test_write(s);
    }
  }
}

static void enc_aligned_bins_ep(EncState *s, int64_t value, int num) {
  s->bins += num;
  if (s->counting) { s->frac_bits += 32768LL * num; return; }
  int remaining = num;
  while (remaining > 0) {
    int to_code = remaining < 8 ? remaining : 8;
    int mask = (1 << to_code) - 1;
    int nb = (int)((value >> (remaining - to_code)) & mask);
    s->low = (s->low << to_code) + ((uint32_t)nb << 8);
    remaining -= to_code;
    s->bits_left -= to_code;
    enc_test_write(s);
  }
}

static void enc_bins_ep(EncState *s, int64_t value, int num) {
  if (num == 0) return;
  if (s->counting) { s->bins += num; s->frac_bits += 32768LL * num; return; }
  if (s->range_ == 256) { enc_aligned_bins_ep(s, value, num); return; }
  s->bins += num;
  while (num > 8) {
    num -= 8;
    int64_t pattern = value >> num;
    s->low = (s->low << 8) + (uint32_t)(s->range_ * pattern);
    value -= pattern << num;
    s->bits_left -= 8;
    enc_test_write(s);
  }
  s->low = (s->low << num) + (uint32_t)(s->range_ * value);
  s->bits_left -= num;
  enc_test_write(s);
}

static inline void enc_ep1(EncState *s, int binv) {
  if (s->counting) { s->bins++; s->frac_bits += 32768; return; }
  if (s->range_ == 256) { enc_aligned_bins_ep(s, binv, 1); return; }
  s->bins++;
  s->low <<= 1;
  if (binv) s->low += s->range_;
  s->bits_left--;
  enc_test_write(s);
}

// ---------------------------------------------------------------------------
// Residual coding parameters (shared decode/encode)
// ---------------------------------------------------------------------------

struct ResParams {
  int32_t width;            // square block size (component samples)
  int32_t chan;             // 0 luma, 1 chroma
  int32_t scan_type;        // 0 diag 1 hor 2 ver
  int32_t first_sig_ctx;
  int32_t single_ctx;       // transform-skip single-context mode
  int32_t be_valid;         // sign data hiding active
  int32_t use_rice_adaptation;
  int32_t align_bypass;
  int32_t use_limited_prefix;
  int32_t max_tr_dynamic_range;
  int32_t rice_stat_idx;
  // flat context base indices in the shared state array
  int32_t ctx_last_x;       // base of last (incl. channel offset)
  int32_t ctx_last_y;
  int32_t ctx_sig_cg;       // base + channel*2
  int32_t ctx_sig;          // channel base
  int32_t ctx_one;          // array base (set offset added per-subset)
  int32_t ctx_abs;
  int32_t ctx_set_start;    // CTX_SET_START[chan]
  // last-significant context geometry
  int32_t off_x, off_y, shift_x, shift_y;
};

static const int CTX_IND_MAP_4x4[16] = {0,1,4,5,2,3,4,5,6,6,8,8,7,7,8,8};
static const int GROUP_IDX[32] = {0,1,2,3,4,4,5,5,6,6,6,6,7,7,7,7,
                                  8,8,8,8,8,8,8,8,9,9,9,9,9,9,9,9};
static const int MIN_IN_GROUP[10] = {0,1,2,3,4,6,8,12,16,24};
static const int NOT_FIRST_GROUP_OFF[2] = {3, 0};

static inline int sig_ctx(int pattern, int raster, int log2w, int chan,
                          int first_ctx, int single_ctx_v) {
  if (single_ctx_v) return first_ctx;  // caller passes start already
  int pos_y = raster >> log2w;
  int pos_x = raster - (pos_y << log2w);
  if (pos_x + pos_y == 0) return 0;
  int offset;
  if (log2w == 2) {
    offset = CTX_IND_MAP_4x4[4 * pos_y + pos_x];
  } else {
    int cnt;
    switch (pattern) {
      case 0: { int t = (pos_x & 3) + (pos_y & 3);
                cnt = (t >= 3) ? 0 : (t >= 1 ? 1 : 2); } break;
      case 1: { int py = pos_y & 3; cnt = (py >= 2) ? 0 : (py >= 1 ? 1 : 2); } break;
      case 2: { int px = pos_x & 3; cnt = (px >= 2) ? 0 : (px >= 1 ? 1 : 2); } break;
      default: cnt = 2; break;
    }
    int not_first = ((pos_x >> 2) + (pos_y >> 2)) > 0;
    offset = (not_first ? NOT_FIRST_GROUP_OFF[chan] : 0) + cnt;
  }
  return first_ctx + offset;
}

// ---------------------------------------------------------------------------
// decode_residual: full parseCoeffNxN for one square TU.
//   scan:     w*w raster positions in scan order
//   scan_cg:  (w/4)^2 group positions in scan order
//   coeffs:   out, w*w int32 raster
//   rice_stats: int64[4]
// Returns 0 on success.
// ---------------------------------------------------------------------------

int decode_residual(DecState *s, uint8_t *ctx, const ResParams *p,
                    const int32_t *scan, const int32_t *scan_cg,
                    int32_t *coeffs, int64_t *rice_stats) {
  const int w = p->width;
  const int log2w = 31 - __builtin_clz(w);
  const int wg = w >> 2, hg = w >> 2;
  const int chan = p->chan;

  // last significant x/y
  int last_x = 0, last_y = 0;
  {
    int gw = GROUP_IDX[w - 1];
    while (last_x < gw && dec_bin(s, ctx, p->ctx_last_x + p->off_x + (last_x >> p->shift_x)))
      last_x++;
    while (last_y < gw && dec_bin(s, ctx, p->ctx_last_y + p->off_y + (last_y >> p->shift_y)))
      last_y++;
    if (last_x > 3) {
      int count = (last_x - 2) >> 1;
      int tmp = 0;
      for (int i = count - 1; i >= 0; i--) tmp += dec_ep1(s) << i;
      last_x = MIN_IN_GROUP[last_x] + tmp;
    }
    if (last_y > 3) {
      int count = (last_y - 2) >> 1;
      int tmp = 0;
      for (int i = count - 1; i >= 0; i--) tmp += dec_ep1(s) << i;
      last_y = MIN_IN_GROUP[last_y] + tmp;
    }
    if (p->scan_type == 2) { int t = last_x; last_x = last_y; last_y = t; }
  }
  int blk_pos_last = last_x + (last_y << log2w);

  memset(coeffs, 0, sizeof(int32_t) * w * w);
  int scan_pos_last = 0;
  for (int i = 0; i < w * w; i++) {
    if (scan[i] == blk_pos_last) { scan_pos_last = i; break; }
  }

  uint8_t sig_cg_flags[64];
  memset(sig_cg_flags, 0, sizeof(sig_cg_flags));
  const int last_scan_set = scan_pos_last >> 4;
  int c1 = 1;
  int scan_pos_sig = scan_pos_last;

  for (int subset = last_scan_set; subset >= 0; subset--) {
    const int sub_pos = subset << 4;
    int go_rice = p->use_rice_adaptation ? (int)(rice_stats[p->rice_stat_idx] / 4) : 0;
    int update_rice = p->use_rice_adaptation;
    int num_nonzero = 0;
    int last_nz = -1, first_nz = 16;
    int escape_present = 0;
    int pos[16];
    int abs_coeff[16];

    if (scan_pos_sig == scan_pos_last) {
      last_nz = first_nz = scan_pos_sig;
      scan_pos_sig--;
      pos[0] = blk_pos_last;
      num_nonzero = 1;
    }

    const int cg_blk = scan_cg[subset];
    const int cg_y = cg_blk / wg, cg_x = cg_blk - cg_y * wg;
    if (subset == last_scan_set || subset == 0) {
      sig_cg_flags[cg_blk] = 1;
    } else {
      int right = (cg_x < wg - 1) ? (sig_cg_flags[cg_y * wg + cg_x + 1] != 0) : 0;
      int lower = (cg_y < hg - 1) ? (sig_cg_flags[(cg_y + 1) * wg + cg_x] != 0) : 0;
      int ctx_s = (right + lower) ? 1 : 0;
      sig_cg_flags[cg_blk] =
          (uint8_t)dec_bin(s, ctx, p->ctx_sig_cg + ctx_s);
    }

    int pattern = 0;
    if (wg > 1 || hg > 1) {
      int right = (cg_x < wg - 1) ? (sig_cg_flags[cg_y * wg + cg_x + 1] != 0) : 0;
      int lower = (cg_y < hg - 1) ? (sig_cg_flags[(cg_y + 1) * wg + cg_x] != 0) : 0;
      pattern = right + (lower << 1);
    }

    for (; scan_pos_sig >= sub_pos; scan_pos_sig--) {
      int blk = scan[scan_pos_sig];
      int sig = 0;
      if (sig_cg_flags[cg_blk]) {
        if (scan_pos_sig > sub_pos || subset == 0 || num_nonzero) {
          int cix = p->single_ctx
                        ? p->first_sig_ctx
                        : sig_ctx(pattern, blk, log2w, chan, p->first_sig_ctx, 0);
          sig = dec_bin(s, ctx, p->ctx_sig + cix);
        } else {
          sig = 1;
        }
      }
      if (sig) {
        pos[num_nonzero] = blk;
        num_nonzero++;
        if (last_nz == -1) last_nz = scan_pos_sig;
        first_nz = scan_pos_sig;
      }
    }

    if (num_nonzero <= 0) continue;
    int sign_hidden = (last_nz - first_nz) >= 4;
    int ctx_set = p->ctx_set_start + ((chan == 0 && subset > 0) ? 2 : 0) +
                  (c1 == 0 ? 1 : 0);
    c1 = 1;
    for (int i = 0; i < num_nonzero; i++) abs_coeff[i] = 1;
    int num_c1 = num_nonzero < 8 ? num_nonzero : 8;
    int first_c2 = -1;
    for (int idx = 0; idx < num_c1; idx++) {
      int b = dec_bin(s, ctx, p->ctx_one + 4 * ctx_set + c1);
      if (b) {
        c1 = 0;
        if (first_c2 == -1) first_c2 = idx; else escape_present = 1;
      } else if (c1 > 0 && c1 < 3) c1++;
      abs_coeff[idx] = b + 1;
    }
    if (c1 == 0 && first_c2 != -1) {
      int b = dec_bin(s, ctx, p->ctx_abs + ctx_set);
      abs_coeff[first_c2] = b + 2;
      if (b) escape_present = 1;
    }
    if (num_nonzero > 8) escape_present = 1;

    if (escape_present && p->align_bypass) s->range_ = 256;

    int64_t signs;
    int n_signs;
    if (sign_hidden && p->be_valid) {
      n_signs = num_nonzero - 1;
      signs = dec_bins_ep(s, n_signs);
    } else {
      n_signs = num_nonzero;
      signs = dec_bins_ep(s, n_signs);
    }

    int first_coeff2 = 1;
    if (escape_present) {
      for (int idx = 0; idx < num_nonzero; idx++) {
        int base_level = (idx < 8) ? (2 + first_coeff2) : 1;
        if (abs_coeff[idx] == base_level) {
          // read coef remain
          int prefix = 0, code = 1;
          int level;
          if (p->use_limited_prefix) {
            int longest = (32 - (3 + p->max_tr_dynamic_range)) + 3;
            while (code && prefix < longest) { prefix++; code = dec_ep1(s); }
          } else {
            while (code) { prefix++; code = dec_ep1(s); }
          }
          code = 1 - code;
          prefix -= code;
          if (prefix < 3) {
            int suffix = go_rice ? (int)dec_bins_ep(s, go_rice) : 0;
            level = (prefix << go_rice) + suffix;
          } else if (p->use_limited_prefix) {
            int max_pl = 32 - (3 + p->max_tr_dynamic_range);
            int pl = prefix - 3;
            int sl = (pl == max_pl) ? (p->max_tr_dynamic_range - go_rice) : pl;
            int64_t cw = dec_bins_ep(s, sl + go_rice);
            level = (int)(cw + ((((int64_t)1 << pl) - 1 + 3) << go_rice));
          } else {
            int64_t cw = dec_bins_ep(s, prefix - 3 + go_rice);
            level = (int)(((((int64_t)1 << (prefix - 3)) + 3 - 1) << go_rice) + cw);
          }
          abs_coeff[idx] = level + base_level;
          if (abs_coeff[idx] > (3 << go_rice))
            go_rice = p->use_rice_adaptation ? go_rice + 1
                                             : (go_rice + 1 < 4 ? go_rice + 1 : 4);
          if (update_rice) {
            int init_rice = (int)(rice_stats[p->rice_stat_idx] / 4);
            if (level >= (3 << init_rice)) rice_stats[p->rice_stat_idx]++;
            else if (2 * level < (1 << init_rice) &&
                     rice_stats[p->rice_stat_idx] > 0)
              rice_stats[p->rice_stat_idx]--;
            update_rice = 0;
          }
        }
        if (abs_coeff[idx] >= 2) first_coeff2 = 0;
      }
    }

    int64_t abs_sum = 0;
    for (int i = 0; i < num_nonzero; i++) abs_sum += abs_coeff[i];
    int sign_bit_pos = n_signs - 1;
    for (int idx = 0; idx < num_nonzero; idx++) {
      int v = abs_coeff[idx];
      if (idx == num_nonzero - 1 && sign_hidden && p->be_valid) {
        if (abs_sum & 1) v = -v;
      } else {
        if ((signs >> sign_bit_pos) & 1) v = -v;
        sign_bit_pos--;
      }
      coeffs[pos[idx]] = v;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// encode_residual: dual of decode_residual; coeffs in raster order.
// ---------------------------------------------------------------------------

int encode_residual(EncState *s, uint8_t *ctx, const ResParams *p,
                    const int32_t *scan, const int32_t *scan_cg,
                    const int32_t *coeffs, int64_t *rice_stats) {
  const int w = p->width;
  const int log2w = 31 - __builtin_clz(w);
  const int wg = w >> 2, hg = w >> 2;
  const int chan = p->chan;
  const int total = w * w;

  int scan_pos_last = -1;
  for (int i = total - 1; i >= 0; i--) {
    if (coeffs[scan[i]]) { scan_pos_last = i; break; }
  }
  if (scan_pos_last < 0) return -1;
  const int blk_pos_last = scan[scan_pos_last];
  int last_x = blk_pos_last & (w - 1);
  int last_y = blk_pos_last >> log2w;

  // last xy
  {
    int lx = last_x, ly = last_y, ww = w, hh = w;
    if (p->scan_type == 2) { int t = lx; lx = ly; ly = t; }
    int gx = GROUP_IDX[lx], gy = GROUP_IDX[ly];
    for (int i = 0; i < gx; i++)
      enc_bin(s, ctx, p->ctx_last_x + p->off_x + (i >> p->shift_x), 1);
    if (gx < GROUP_IDX[ww - 1])
      enc_bin(s, ctx, p->ctx_last_x + p->off_x + (gx >> p->shift_x), 0);
    for (int i = 0; i < gy; i++)
      enc_bin(s, ctx, p->ctx_last_y + p->off_y + (i >> p->shift_y), 1);
    if (gy < GROUP_IDX[hh - 1])
      enc_bin(s, ctx, p->ctx_last_y + p->off_y + (gy >> p->shift_y), 0);
    if (gx > 3) {
      int count = (gx - 2) >> 1;
      int suffix = lx - MIN_IN_GROUP[gx];
      for (int i = count - 1; i >= 0; i--) enc_ep1(s, (suffix >> i) & 1);
    }
    if (gy > 3) {
      int count = (gy - 2) >> 1;
      int suffix = ly - MIN_IN_GROUP[gy];
      for (int i = count - 1; i >= 0; i--) enc_ep1(s, (suffix >> i) & 1);
    }
  }

  uint8_t sig_cg_flags[64];
  memset(sig_cg_flags, 0, sizeof(sig_cg_flags));
  const int last_scan_set = scan_pos_last >> 4;
  for (int subset = last_scan_set; subset >= 0; subset--) {
    int lo = subset << 4;
    int hi = scan_pos_last < lo + 15 ? scan_pos_last : lo + 15;
    for (int i = lo; i <= hi; i++) {
      if (coeffs[scan[i]]) { sig_cg_flags[scan_cg[subset]] = 1; break; }
    }
  }
  sig_cg_flags[scan_cg[last_scan_set]] = 1;
  sig_cg_flags[scan_cg[0]] = 1;

  int c1 = 1;
  int scan_pos_sig = scan_pos_last;
  for (int subset = last_scan_set; subset >= 0; subset--) {
    const int sub_pos = subset << 4;
    int go_rice = p->use_rice_adaptation ? (int)(rice_stats[p->rice_stat_idx] / 4) : 0;
    int update_rice = p->use_rice_adaptation;
    int num_nonzero = 0;
    int last_nz = -1, first_nz = 16;
    int escape_present = 0;
    int pos[16];
    int vals[16];

    if (scan_pos_sig == scan_pos_last) {
      last_nz = first_nz = scan_pos_sig;
      pos[0] = blk_pos_last;
      vals[0] = coeffs[blk_pos_last];
      num_nonzero = 1;
      scan_pos_sig--;
    }

    const int cg_blk = scan_cg[subset];
    const int cg_y = cg_blk / wg, cg_x = cg_blk - cg_y * wg;
    if (subset != last_scan_set && subset != 0) {
      int right = (cg_x < wg - 1) ? (sig_cg_flags[cg_y * wg + cg_x + 1] != 0) : 0;
      int lower = (cg_y < hg - 1) ? (sig_cg_flags[(cg_y + 1) * wg + cg_x] != 0) : 0;
      int ctx_s = (right + lower) ? 1 : 0;
      enc_bin(s, ctx, p->ctx_sig_cg + ctx_s, sig_cg_flags[cg_blk]);
    }
    int pattern = 0;
    if (wg > 1 || hg > 1) {
      int right = (cg_x < wg - 1) ? (sig_cg_flags[cg_y * wg + cg_x + 1] != 0) : 0;
      int lower = (cg_y < hg - 1) ? (sig_cg_flags[(cg_y + 1) * wg + cg_x] != 0) : 0;
      pattern = right + (lower << 1);
    }

    for (; scan_pos_sig >= sub_pos; scan_pos_sig--) {
      int blk = scan[scan_pos_sig];
      int sig = coeffs[blk] != 0;
      if (sig_cg_flags[cg_blk]) {
        if (scan_pos_sig > sub_pos || subset == 0 || num_nonzero) {
          int cix = p->single_ctx
                        ? p->first_sig_ctx
                        : sig_ctx(pattern, blk, log2w, chan, p->first_sig_ctx, 0);
          enc_bin(s, ctx, p->ctx_sig + cix, sig);
        }
      }
      if (sig) {
        pos[num_nonzero] = blk;
        vals[num_nonzero] = coeffs[blk];
        num_nonzero++;
        if (last_nz == -1) last_nz = scan_pos_sig;
        first_nz = scan_pos_sig;
      }
    }

    if (num_nonzero <= 0) continue;
    int sign_hidden = (last_nz - first_nz) >= 4;
    int ctx_set = p->ctx_set_start + ((chan == 0 && subset > 0) ? 2 : 0) +
                  (c1 == 0 ? 1 : 0);
    c1 = 1;
    int abs_vals[16];
    for (int i = 0; i < num_nonzero; i++)
      abs_vals[i] = vals[i] < 0 ? -vals[i] : vals[i];
    int num_c1 = num_nonzero < 8 ? num_nonzero : 8;
    int first_c2 = -1;
    for (int idx = 0; idx < num_c1; idx++) {
      int b = abs_vals[idx] > 1;
      enc_bin(s, ctx, p->ctx_one + 4 * ctx_set + c1, b);
      if (b) {
        c1 = 0;
        if (first_c2 == -1) first_c2 = idx; else escape_present = 1;
      } else if (c1 > 0 && c1 < 3) c1++;
    }
    if (c1 == 0 && first_c2 != -1) {
      int b = abs_vals[first_c2] > 2;
      enc_bin(s, ctx, p->ctx_abs + ctx_set, b);
      if (b) escape_present = 1;
    }
    if (num_nonzero > 8) escape_present = 1;

    if (escape_present && p->align_bypass) s->range_ = 256;

    int n_signs = (sign_hidden && p->be_valid) ? num_nonzero - 1 : num_nonzero;
    int64_t signs = 0;
    for (int idx = 0; idx < n_signs; idx++)
      signs = (signs << 1) | (vals[idx] < 0 ? 1 : 0);
    enc_bins_ep(s, signs, n_signs);

    int first_coeff2 = 1;
    if (escape_present) {
      for (int idx = 0; idx < num_nonzero; idx++) {
        int base_level = (idx < 8) ? (2 + first_coeff2) : 1;
        if (abs_vals[idx] >= base_level) {
          int level = abs_vals[idx] - base_level;
          // write coef remain
          int64_t code_number = level;
          if (code_number < ((int64_t)3 << go_rice)) {
            int length = (int)(code_number >> go_rice);
            enc_bins_ep(s, ((int64_t)1 << (length + 1)) - 2, length + 1);
            enc_bins_ep(s, code_number & (((int64_t)1 << go_rice) - 1), go_rice);
          } else if (p->use_limited_prefix) {
            int max_pl = 32 - (3 + p->max_tr_dynamic_range);
            int pl = 0;
            int64_t code_value = (code_number >> go_rice) - 3;
            while (pl < max_pl && code_value > (((int64_t)2 << pl) - 2)) pl++;
            int sl = (pl == max_pl) ? (p->max_tr_dynamic_range - go_rice) : pl;
            int64_t suffix =
                code_number - ((((int64_t)1 << pl) - 1 + 3) << go_rice);
            int total_prefix = 3 + pl + 1;
            enc_bins_ep(s, ((int64_t)1 << total_prefix) - 2, total_prefix);
            enc_bins_ep(s, suffix, sl + go_rice);
          } else {
            int length = go_rice;
            code_number -= (int64_t)3 << go_rice;
            while (code_number >= ((int64_t)1 << length)) {
              code_number -= (int64_t)1 << length;
              length++;
            }
            int prefix_ones = 3 + length + 1 - go_rice;
            enc_bins_ep(s, ((int64_t)1 << prefix_ones) - 2, prefix_ones);
            enc_bins_ep(s, code_number, length);
          }
          if (abs_vals[idx] > (3 << go_rice))
            go_rice = p->use_rice_adaptation ? go_rice + 1
                                             : (go_rice + 1 < 4 ? go_rice + 1 : 4);
          if (update_rice) {
            int init_rice = (int)(rice_stats[p->rice_stat_idx] / 4);
            if (level >= (3 << init_rice)) rice_stats[p->rice_stat_idx]++;
            else if (2 * level < (1 << init_rice) &&
                     rice_stats[p->rice_stat_idx] > 0)
              rice_stats[p->rice_stat_idx]--;
            update_rice = 0;
          }
        }
        if (abs_vals[idx] >= 2) first_coeff2 = 0;
      }
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Native pass-2 CTU syntax emitter (final bitstream pass for planned intra
// slices).  Exact dual of encode/ctu_enc.py::encode_ctu for the supported
// configuration: I slice, intra-only, 4:0:0/4:2:0, no transquant bypass,
// no transform skip, no PCM use (pcm_flag 0 emitted when enabled).  The
// Python layer keeps substream/WPP orchestration and syncs the arithmetic
// engine + shared context state around each call.
// Mirrors TEncSbac.cpp:423-1716 / TEncCu::xEncodeCU (TEncCu.cpp:1185).
// ---------------------------------------------------------------------------

struct CtuEncCtx {
  int32_t pic_w, pic_h, parts_w, ctb_log2, num_comps, chroma_fmt;
  int32_t log2_min_cb, log2_min_tb, log2_max_tb, max_tr_depth_intra;
  int32_t pcm_enabled, log2_min_pcm, log2_max_pcm;
  int32_t size_2nx2n, mode_intra, dm_chroma_idx;
  // flat context base indices (ContextSet CTX_OFFSET values)
  int32_t ctx_split, ctx_part_size, ctx_intra_mode, ctx_chroma_mode,
          ctx_subdiv, ctx_qt_cbf;
  int32_t pad_;
  const uint8_t *coded;
  const int8_t *depth;
  const int8_t *part_size;
  const int8_t *pred_mode;
  const int16_t *intra_luma;
  const int16_t *intra_chroma;
  const uint8_t *cbf[3];
  const int8_t *tr_idx;
  const int32_t *coeff[3];
  int64_t coeff_stride[3];
  // [chan][log2w-2][scan] (component-sample block width)
  const ResParams *res_params[24];
  const int32_t *scan[12];
  const int32_t *scan_cg[12];
  int64_t *rice_stats;
};

static inline void enc_bin_trm(EncState *s, int binv) {
  s->bins++;
  if (s->counting) { s->frac_bits += g_entropy_bits[126 ^ binv]; return; }
  s->range_ -= 2;
  if (binv) {
    s->low += (uint32_t)s->range_;
    s->low <<= 7;
    s->range_ = 2 << 7;
    s->bits_left -= 7;
  } else if (s->range_ >= 256) {
    return;
  } else {
    s->low <<= 1;
    s->range_ <<= 1;
    s->bits_left--;
  }
  enc_test_write(s);
}

static inline int ce_cbf_at(const CtuEncCtx *C, int comp, int px, int py,
                            int td) {
  if (td < 0) return 1;
  return (C->cbf[comp][py * C->parts_w + px] >> td) & 1;
}

static int ce_min_tu_log2(const CtuEncCtx *C, int cu_log2, int nxn) {
  int intra_split = nxn ? 1 : 0;
  if (cu_log2 < C->log2_min_tb + C->max_tr_depth_intra - 1 + intra_split)
    return C->log2_min_tb;
  int v = cu_log2 - (C->max_tr_depth_intra - 1 + intra_split);
  return v < C->log2_max_tb ? v : C->log2_max_tb;
}

// getIntraDirPredictor (decode/ctu_dec._intra_mpm; above must not cross CTU)
static void ce_mpm(const CtuEncCtx *C, int px, int py, int out[3]) {
  const int DC = 1, PLANAR = 0, VER = 26;
  int left = DC, above = DC;
  int W = C->parts_w;
  if (px > 0 && C->coded[py * W + px - 1] &&
      C->pred_mode[py * W + px - 1] == C->mode_intra)
    left = C->intra_luma[py * W + px - 1];
  int parts = 1 << (C->ctb_log2 - 2);
  if (py % parts != 0 && py > 0 && C->coded[(py - 1) * W + px] &&
      C->pred_mode[(py - 1) * W + px] == C->mode_intra)
    above = C->intra_luma[(py - 1) * W + px];
  if (left == above) {
    if (left > 1) {
      out[0] = left;
      out[1] = ((left + 29) % 32) + 2;
      out[2] = ((left - 1) % 32) + 2;
    } else {
      out[0] = PLANAR; out[1] = DC; out[2] = VER;
    }
  } else {
    out[0] = left;
    out[1] = above;
    out[2] = (left && above) ? PLANAR : (left + above < 2 ? VER : DC);
  }
}

// getCoefScanIdx (MDCS) for intra TUs
static int ce_scan_type(const CtuEncCtx *C, int px, int py, int log2,
                        int comp) {
  int sx = comp ? 1 : 0;   // 4:2:0 only (enforced by the Python gate)
  int w = comp ? ((1 << log2) >> sx) : (1 << log2);
  int max_w = comp ? 4 : 8;
  if (w > max_w) return 0;
  int mode;
  if (comp == 0) {
    mode = C->intra_luma[py * C->parts_w + px];
  } else {
    mode = C->intra_chroma[py * C->parts_w + px];
    if (mode == C->dm_chroma_idx) mode = C->intra_luma[py * C->parts_w + px];
  }
  int dv = mode - 26; if (dv < 0) dv = -dv;
  if (dv <= 4) return 1;
  int dh = mode - 10; if (dh < 0) dh = -dh;
  if (dh <= 4) return 2;
  return 0;
}

static int ce_residual(EncState *s, uint8_t *ctx, const CtuEncCtx *C,
                       int px, int py, int log2, int comp) {
  int sx = comp ? 1 : 0;
  int w, x0, y0;
  if (comp == 0) { w = 1 << log2; x0 = px * 4; y0 = py * 4; }
  else { w = (1 << log2) >> sx; x0 = (px * 4) >> sx; y0 = (py * 4) >> sx; }
  int log2w = 31 - __builtin_clz((unsigned)w);
  int scan_type = ce_scan_type(C, px, py, log2, comp);
  int chan = comp ? 1 : 0;
  int ti = (log2w - 2) * 3 + scan_type;
  const ResParams *p = C->res_params[chan * 12 + ti];
  const int32_t *scan = C->scan[ti], *scan_cg = C->scan_cg[ti];
  if (!p || !scan) return -1;
  int32_t buf[32 * 32];
  const int32_t *src = C->coeff[comp] + y0 * C->coeff_stride[comp] + x0;
  for (int y = 0; y < w; y++)
    memcpy(buf + y * w, src + y * C->coeff_stride[comp],
           sizeof(int32_t) * w);
  return encode_residual(s, ctx, p, scan, scan_cg, buf, C->rice_stats);
}

static int ce_tu_tree(EncState *s, uint8_t *ctx, const CtuEncCtx *C,
                      int cu_log2, int nxn, int px, int py, int log2,
                      int td) {
  const int W = C->parts_w;
  int chroma_ok = C->num_comps > 1;
  int chroma_here = chroma_ok && (log2 > 2 || C->chroma_fmt == 3);
  int min_tu = ce_min_tu_log2(C, cu_log2, nxn);
  int subdiv = C->tr_idx[py * W + px] > td;
  if (nxn && td == 0) { /* inferred 1 */ }
  else if (log2 > C->log2_max_tb) { /* inferred 1 */ }
  else if (log2 == C->log2_min_tb) { /* inferred 0 */ }
  else if (log2 == min_tu) { /* inferred 0 */ }
  else enc_bin(s, ctx, C->ctx_subdiv + (5 - log2), subdiv);

  if (chroma_here) {
    for (int comp = 1; comp <= 2; comp++) {
      int parent = td ? ce_cbf_at(C, comp, px, py, td - 1) : 1;
      if (parent)
        enc_bin(s, ctx, C->ctx_qt_cbf + 5 + td,
                ce_cbf_at(C, comp, px, py, td));
    }
  }
  if (subdiv) {
    int half = 1 << (log2 - 3);
    for (int sub = 0; sub < 4; sub++)
      if (ce_tu_tree(s, ctx, C, cu_log2, nxn, px + (sub & 1) * half,
                     py + (sub >> 1) * half, log2 - 1, td + 1) < 0)
        return -1;
    return 0;
  }
  int cbf_y = ce_cbf_at(C, 0, px, py, td);
  // intra: luma cbf always coded
  enc_bin(s, ctx, C->ctx_qt_cbf + (td == 0 ? 1 : 0), cbf_y);

  int cbf_cb = 0, cbf_cr = 0;
  if (chroma_ok) {
    if (log2 == 2 && !chroma_here) {
      cbf_cb = ce_cbf_at(C, 1, px & ~1, py & ~1, td - 1);
      cbf_cr = ce_cbf_at(C, 2, px & ~1, py & ~1, td - 1);
    } else {
      cbf_cb = ce_cbf_at(C, 1, px, py, td);
      cbf_cr = ce_cbf_at(C, 2, px, py, td);
    }
  }
  int holder = chroma_here ||
               (chroma_ok && log2 == 2 && (px & 1) && (py & 1));
  if (cbf_y || cbf_cb || cbf_cr) {
    if (cbf_y && ce_residual(s, ctx, C, px, py, log2, 0) < 0) return -1;
    if (chroma_ok) {
      if (chroma_here) {
        if (cbf_cb && ce_residual(s, ctx, C, px, py, log2, 1) < 0)
          return -1;
        if (cbf_cr && ce_residual(s, ctx, C, px, py, log2, 2) < 0)
          return -1;
      } else if (log2 == 2 && holder) {
        if (cbf_cb && ce_residual(s, ctx, C, px - 1, py - 1, 3, 1) < 0)
          return -1;
        if (cbf_cr && ce_residual(s, ctx, C, px - 1, py - 1, 3, 2) < 0)
          return -1;
      }
    }
  }
  return 0;
}

static void ce_intra_dirs(EncState *s, uint8_t *ctx, const CtuEncCtx *C,
                          int px, int py, int log2, int nxn) {
  const int W = C->parts_w;
  int half = 1 << (log2 - 3);
  int n = nxn ? 4 : 1;
  int offs[4][2] = {{0, 0}, {half, 0}, {0, half}, {half, half}};
  int preds[4][3], flags[4], modes[4];
  for (int j = 0; j < n; j++) {
    int ox = offs[j][0], oy = offs[j][1];
    ce_mpm(C, px + ox, py + oy, preds[j]);
    modes[j] = C->intra_luma[(py + oy) * W + px + ox];
    flags[j] = (modes[j] == preds[j][0] || modes[j] == preds[j][1] ||
                modes[j] == preds[j][2]);
    enc_bin(s, ctx, C->ctx_intra_mode, flags[j]);
  }
  for (int j = 0; j < n; j++) {
    int mode = modes[j];
    if (flags[j]) {
      int idx = (mode == preds[j][0]) ? 0 : (mode == preds[j][1] ? 1 : 2);
      if (idx == 0) enc_ep1(s, 0);
      else { enc_ep1(s, 1); enc_ep1(s, idx - 1); }
    } else {
      int a = preds[j][0], b = preds[j][1], c2 = preds[j][2];
      int t;
      if (a < b) { t = a; a = b; b = t; }
      if (a < c2) { t = a; a = c2; c2 = t; }
      if (b < c2) { t = b; b = c2; c2 = t; }
      int rem = mode;
      if (rem > a) rem--;
      if (rem > b) rem--;
      if (rem > c2) rem--;
      enc_bins_ep(s, rem, 5);
    }
  }
  int stored = C->intra_chroma[py * W + px];
  if (stored == C->dm_chroma_idx) {
    enc_bin(s, ctx, C->ctx_chroma_mode, 0);
  } else {
    enc_bin(s, ctx, C->ctx_chroma_mode, 1);
    int allowed[5] = {0, 26, 10, 1, C->dm_chroma_idx};
    int luma0 = modes[0];
    for (int i = 0; i < 4; i++)
      if (luma0 == allowed[i]) { allowed[i] = 34; break; }
    int idx = 0;
    for (int i = 0; i < 5; i++)
      if (allowed[i] == stored) { idx = i; break; }
    enc_bins_ep(s, idx, 2);
  }
}

static int ce_cu(EncState *s, uint8_t *ctx, const CtuEncCtx *C, int px,
                 int py, int log2, int cu_depth) {
  const int W = C->parts_w;
  int x0 = px * 4, y0 = py * 4, size = 1 << log2;
  int boundary = !(x0 + size <= C->pic_w && y0 + size <= C->pic_h);
  int split = C->depth[py * W + px] > cu_depth;
  if (!boundary) {
    if (log2 > C->log2_min_cb) {
      int cinc = 0;
      if (px > 0 && C->coded[py * W + px - 1])
        cinc += C->depth[py * W + px - 1] > cu_depth;
      if (py > 0 && C->coded[(py - 1) * W + px])
        cinc += C->depth[(py - 1) * W + px] > cu_depth;
      enc_bin(s, ctx, C->ctx_split + cinc, split);
    } else {
      split = 0;
    }
  }
  if (split || boundary) {
    int half = 1 << (log2 - 3);
    for (int sub = 0; sub < 4; sub++) {
      int sx2 = px + (sub & 1) * half, sy2 = py + (sub >> 1) * half;
      if (sx2 * 4 < C->pic_w && sy2 * 4 < C->pic_h)
        if (ce_cu(s, ctx, C, sx2, sy2, log2 - 1, cu_depth + 1) < 0)
          return -1;
    }
    return 0;
  }
  // I slice: pred mode implicit intra
  int nxn = C->part_size[py * W + px] != C->size_2nx2n;
  if (log2 == C->log2_min_cb)
    enc_bin(s, ctx, C->ctx_part_size, nxn ? 0 : 1);
  if (C->pcm_enabled && !nxn && log2 >= C->log2_min_pcm &&
      log2 <= C->log2_max_pcm)
    enc_bin_trm(s, 0);   // pcm_flag: this encoder never uses PCM
  ce_intra_dirs(s, ctx, C, px, py, log2, nxn);
  return ce_tu_tree(s, ctx, C, log2, nxn, px, py, log2, 0);
}

int encode_ctu_syntax(EncState *s, uint8_t *ctx, const CtuEncCtx *C,
                      int cx, int cy, int last_in_slice) {
  int parts = 1 << (C->ctb_log2 - 2);
  if (ce_cu(s, ctx, C, cx * parts, cy * parts, C->ctb_log2, 0) < 0)
    return -1;
  enc_bin_trm(s, last_in_slice ? 1 : 0);
  return 0;
}

}  // extern "C"
