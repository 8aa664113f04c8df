// Host image codec: the sequential byte work of PNG and baseline JPEG,
// built with g++ by utils/native.py and called through ctypes from
// utils/image_io.py, which parses the containers and does the vectorisable
// parts (zlib, chroma upsampling, colour conversion, the forward DCT) in
// numpy. The numpy fallbacks in image_io.py compute the same bits.
//
//   png_unfilter      undo PNG's per-row filters (None, Sub, Up, Average,
//                     Paeth), each row depending on its left byte and the
//                     row above;
//   jpeg_decode_scan  Huffman-decode one baseline scan into quantised
//                     coefficients in natural order, restart markers and
//                     byte stuffing included;
//   jpeg_idct_islow   dequantise and inverse-DCT blocks into 8-bit samples
//                     with libjpeg's integer "islow" arithmetic (jidctint.c),
//                     the default of cv2.imread;
//   jpeg_encode_scan  Huffman-encode quantised blocks into one baseline
//                     scan with byte stuffing.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// PNG
// ---------------------------------------------------------------------------

// raw: h rows of (1 + stride) bytes, each led by its filter type; out: h
// rows of stride bytes. Returns 0, or -1 on an unknown filter type.
int png_unfilter(const uint8_t* raw, int h, long stride, int bpp,
                 uint8_t* out) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* f = raw + (long)y * (stride + 1);
    const uint8_t ft = f[0];
    const uint8_t* src = f + 1;
    uint8_t* dst = out + (long)y * stride;
    const uint8_t* up = y > 0 ? dst - stride : nullptr;
    switch (ft) {
      case 0:
        std::memcpy(dst, src, stride);
        break;
      case 1:
        for (long i = 0; i < stride; ++i)
          dst[i] = (uint8_t)(src[i] + (i >= bpp ? dst[i - bpp] : 0));
        break;
      case 2:
        for (long i = 0; i < stride; ++i)
          dst[i] = (uint8_t)(src[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (long i = 0; i < stride; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          dst[i] = (uint8_t)(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (long i = 0; i < stride; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          dst[i] = (uint8_t)(src[i] + pred);
        }
        break;
      default:
        return -1;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// JPEG: Huffman decoding
// ---------------------------------------------------------------------------

static const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// A canonical Huffman table from its 16 code-length counts and values
// (JPEG Annex C), with a 9-bit lookup for the short codes. The counts come
// from the file: a table with more than 256 values, or with more codes of a
// length than that length holds (oversubscribed), is refused before any
// entry is written; so is one that uses an all-ones code, as libjpeg's
// jdhuff.c refuses it.
struct HuffDec {
  int32_t maxcode[18];
  int32_t valoff[17];
  uint8_t vals[256];
  int16_t look[512];  // (length << 8) | value, or -1
};

static int build_dec(const uint8_t* bits, const uint8_t* vals, HuffDec* t) {
  int code = 0, k = 0, total = 0;
  for (int l = 0; l < 16; ++l) total += bits[l];
  if (total > 256) return -1;
  std::memset(t->look, 0xff, sizeof(t->look));
  for (int l = 1; l <= 16; ++l) {
    const int n = bits[l - 1];
    t->valoff[l] = k - code;
    for (int i = 0; i < n; ++i, ++k, ++code) {
      if (code >= (1 << l)) return -1;
      t->vals[k] = vals[k];
      if (l <= 9) {
        const int base = code << (9 - l);
        for (int j = 0; j < (1 << (9 - l)); ++j)
          t->look[base + j] = (int16_t)((l << 8) | vals[k]);
      }
    }
    t->maxcode[l] = n ? code - 1 : -1;
    if (code >= (1 << l)) return -1;  // no code may be all ones
    code <<= 1;
  }
  t->maxcode[17] = 0x7fffffff;
  return 0;
}

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf;
  int nbits;
  bool marker;  // a marker (or the end) was reached: feed zeros
};

static inline void fill(BitReader* br) {
  while (br->nbits <= 56) {
    int byte = 0;
    if (!br->marker && br->p < br->end) {
      byte = *br->p;
      if (byte == 0xFF) {
        const int nxt = br->p + 1 < br->end ? br->p[1] : -1;
        if (nxt == 0x00) {
          br->p += 2;
        } else {
          br->marker = true;
          byte = 0;
        }
      } else {
        br->p += 1;
      }
    } else {
      br->marker = true;
    }
    br->buf |= (uint64_t)byte << (56 - br->nbits);
    br->nbits += 8;
  }
}

static inline int get_bits(BitReader* br, int n) {
  if (n == 0) return 0;
  if (br->nbits < n) fill(br);
  const int v = (int)(br->buf >> (64 - n));
  br->buf <<= n;
  br->nbits -= n;
  return v;
}

static inline int decode_sym(BitReader* br, const HuffDec* t) {
  if (br->nbits < 16) fill(br);
  const int peek = (int)(br->buf >> (64 - 9));
  const int e = t->look[peek];
  if (e >= 0) {
    const int l = e >> 8;
    br->buf <<= l;
    br->nbits -= l;
    return e & 0xff;
  }
  int code = 0;
  for (int l = 1; l <= 16; ++l) {
    code = (code << 1) | (int)(br->buf >> 63);
    br->buf <<= 1;
    br->nbits -= 1;
    if (code <= t->maxcode[l]) return t->vals[t->valoff[l] + code];
  }
  return -1;  // no such code
}

static inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// Decode one baseline scan. data/len: the entropy-coded segment that follows
// the SOS header (up to the file's end; decoding stops at the first marker
// other than RSTn). The scan holds n_units units (MCUs, or blocks of a
// one-component scan) of units_blocks blocks each; block b of a unit
// belongs to scan component block_comp[b]. tables: per scan component, 544
// bytes: DC bits[16], DC values[256], AC bits[16], AC values[256]. out:
// n_units * units_blocks blocks of 64 int16 in natural order. Returns the
// bytes consumed, or a negative code on corrupt data.
long jpeg_decode_scan(const uint8_t* data, long len, long n_units,
                      int units_blocks, const uint8_t* block_comp,
                      int n_comp, const uint8_t* tables, int restart,
                      int16_t* out) {
  HuffDec* dc = (HuffDec*)std::malloc(sizeof(HuffDec) * 2 * n_comp);
  if (!dc) return -10;
  HuffDec* ac = dc + n_comp;
  for (int c = 0; c < n_comp; ++c) {
    const uint8_t* tb = tables + 544 * c;
    if (build_dec(tb, tb + 16, dc + c) || build_dec(tb + 272, tb + 288,
                                                    ac + c)) {
      std::free(dc);
      return -2;
    }
  }
  int pred[4] = {0, 0, 0, 0};
  BitReader br{data, data + len, 0, 0, false};
  long rc = 0;
  int16_t* blk = out;
  for (long u = 0; u < n_units && rc == 0; ++u) {
    if (restart > 0 && u > 0 && u % restart == 0) {
      // byte-align, then expect an RSTn marker
      br.buf = 0;
      br.nbits = 0;
      br.marker = false;
      while (br.p + 1 < br.end && !(br.p[0] == 0xFF && br.p[1] >= 0xD0 &&
                                   br.p[1] <= 0xD7))
        ++br.p;
      if (br.p + 1 >= br.end) {
        rc = -3;
        break;
      }
      br.p += 2;
      pred[0] = pred[1] = pred[2] = pred[3] = 0;
    }
    for (int b = 0; b < units_blocks; ++b, blk += 64) {
      const int c = block_comp[b];
      std::memset(blk, 0, 64 * sizeof(int16_t));
      const int t = decode_sym(&br, dc + c);
      if (t < 0 || t > 11) {
        rc = -4;
        break;
      }
      pred[c] += t ? extend(get_bits(&br, t), t) : 0;
      blk[0] = (int16_t)pred[c];
      for (int k = 1; k < 64;) {
        const int rs = decode_sym(&br, ac + c);
        if (rs < 0) {
          rc = -5;
          break;
        }
        const int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          if (k > 63) {
            rc = -6;
            break;
          }
          blk[kZigzag[k]] = (int16_t)extend(get_bits(&br, s), s);
          ++k;
        } else if (r == 15) {
          k += 16;
        } else {
          break;
        }
      }
      if (rc) break;
    }
  }
  std::free(dc);
  if (rc) return rc;
  // bytes consumed: bits still buffered belong to bytes already read
  return (long)(br.p - data);
}

// ---------------------------------------------------------------------------
// JPEG: libjpeg's islow inverse DCT (jidctint.c)
// ---------------------------------------------------------------------------

#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 ((int64_t)2446)
#define FIX_0_390180644 ((int64_t)3196)
#define FIX_0_541196100 ((int64_t)4433)
#define FIX_0_765366865 ((int64_t)6270)
#define FIX_0_899976223 ((int64_t)7373)
#define FIX_1_175875602 ((int64_t)9633)
#define FIX_1_501321110 ((int64_t)12299)
#define FIX_1_847759065 ((int64_t)15137)
#define FIX_1_961570560 ((int64_t)16069)
#define FIX_2_053119869 ((int64_t)16819)
#define FIX_2_562915447 ((int64_t)20995)
#define FIX_3_072711026 ((int64_t)25172)
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n) - 1))) >> (n))

static inline uint8_t clamp_sample(int64_t v) {
  v += 128;
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// coefs: n_blocks blocks of 64 int16 in natural order; q: the 64 quantiser
// values in natural order; out: n_blocks blocks of 8x8 samples.
void jpeg_idct_islow(const int16_t* coefs, long n_blocks, const uint16_t* q,
                     uint8_t* out) {
  int64_t ws[64];
  for (long n = 0; n < n_blocks; ++n) {
    const int16_t* in = coefs + 64 * n;
    uint8_t* o = out + 64 * n;
    // pass 1: columns
    for (int c = 0; c < 8; ++c) {
      const int16_t* ip = in + c;
      const uint16_t* qp = q + c;
      int64_t* w = ws + c;
      if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
          !ip[56]) {
        const int64_t dc = ((int64_t)ip[0] * qp[0]) * (1 << PASS1_BITS);
        for (int r = 0; r < 8; ++r) w[8 * r] = dc;
        continue;
      }
      int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
      int64_t z1 = (z2 + z3) * FIX_0_541196100;
      int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
      int64_t tmp3 = z1 + z2 * FIX_0_765366865;
      z2 = (int64_t)ip[0] * qp[0];
      z3 = (int64_t)ip[32] * qp[32];
      int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
      int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
      const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = (int64_t)ip[56] * qp[56];
      tmp1 = (int64_t)ip[40] * qp[40];
      tmp2 = (int64_t)ip[24] * qp[24];
      tmp3 = (int64_t)ip[8] * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      const int64_t z5 = (z3 + z4) * FIX_1_175875602;
      tmp0 *= FIX_0_298631336;
      tmp1 *= FIX_2_053119869;
      tmp2 *= FIX_3_072711026;
      tmp3 *= FIX_1_501321110;
      z1 *= -FIX_0_899976223;
      z2 *= -FIX_2_562915447;
      z3 *= -FIX_1_961570560;
      z4 *= -FIX_0_390180644;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int s = CONST_BITS - PASS1_BITS;
      w[0] = DESCALE(tmp10 + tmp3, s);
      w[56] = DESCALE(tmp10 - tmp3, s);
      w[8] = DESCALE(tmp11 + tmp2, s);
      w[48] = DESCALE(tmp11 - tmp2, s);
      w[16] = DESCALE(tmp12 + tmp1, s);
      w[40] = DESCALE(tmp12 - tmp1, s);
      w[24] = DESCALE(tmp13 + tmp0, s);
      w[32] = DESCALE(tmp13 - tmp0, s);
    }
    // pass 2: rows
    for (int r = 0; r < 8; ++r) {
      const int64_t* w = ws + 8 * r;
      uint8_t* op = o + 8 * r;
      int64_t z2 = w[2], z3 = w[6];
      int64_t z1 = (z2 + z3) * FIX_0_541196100;
      int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
      int64_t tmp3 = z1 + z2 * FIX_0_765366865;
      int64_t tmp0 = (w[0] + w[4]) * (1 << CONST_BITS);
      int64_t tmp1 = (w[0] - w[4]) * (1 << CONST_BITS);
      const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = w[7];
      tmp1 = w[5];
      tmp2 = w[3];
      tmp3 = w[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      const int64_t z5 = (z3 + z4) * FIX_1_175875602;
      tmp0 *= FIX_0_298631336;
      tmp1 *= FIX_2_053119869;
      tmp2 *= FIX_3_072711026;
      tmp3 *= FIX_1_501321110;
      z1 *= -FIX_0_899976223;
      z2 *= -FIX_2_562915447;
      z3 *= -FIX_1_961570560;
      z4 *= -FIX_0_390180644;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int s = CONST_BITS + PASS1_BITS + 3;
      op[0] = clamp_sample(DESCALE(tmp10 + tmp3, s));
      op[7] = clamp_sample(DESCALE(tmp10 - tmp3, s));
      op[1] = clamp_sample(DESCALE(tmp11 + tmp2, s));
      op[6] = clamp_sample(DESCALE(tmp11 - tmp2, s));
      op[2] = clamp_sample(DESCALE(tmp12 + tmp1, s));
      op[5] = clamp_sample(DESCALE(tmp12 - tmp1, s));
      op[3] = clamp_sample(DESCALE(tmp13 + tmp0, s));
      op[4] = clamp_sample(DESCALE(tmp13 - tmp0, s));
    }
  }
}

// ---------------------------------------------------------------------------
// JPEG: Huffman encoding
// ---------------------------------------------------------------------------

struct HuffEnc {
  uint32_t code[256];
  uint8_t size[256];
};

static void build_enc(const uint8_t* bits, const uint8_t* vals, HuffEnc* t) {
  std::memset(t->size, 0, sizeof(t->size));
  uint32_t code = 0;
  int k = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l - 1]; ++i, ++k, ++code) {
      t->code[vals[k]] = code;
      t->size[vals[k]] = (uint8_t)l;
    }
    code <<= 1;
  }
}

struct BitWriter {
  uint8_t* p;
  uint8_t* end;
  uint64_t acc;
  int n;
  bool overflow;
};

static inline void put_byte(BitWriter* bw, uint8_t b) {
  if (bw->p + 2 > bw->end) {
    bw->overflow = true;
    return;
  }
  *bw->p++ = b;
  if (b == 0xFF) *bw->p++ = 0x00;
}

static inline void put_bits(BitWriter* bw, uint32_t v, int n) {
  if (n == 0) return;
  bw->acc = (bw->acc << n) | (v & ((1u << n) - 1));
  bw->n += n;
  while (bw->n >= 8) {
    bw->n -= 8;
    put_byte(bw, (uint8_t)(bw->acc >> bw->n));
  }
}

static inline int nbits_of(int v) {
  v = v < 0 ? -v : v;
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

// blocks: n_units * units_blocks blocks of 64 quantised int16 in natural
// order, in scan order; block b of a unit belongs to scan component
// block_comp[b]; tables as in jpeg_decode_scan. Writes the entropy-coded
// segment (padded with 1-bits, byte-stuffed) to out and returns its length,
// or -1 if cap bytes do not hold it.
long jpeg_encode_scan(const int16_t* blocks, long n_units, int units_blocks,
                      const uint8_t* block_comp, int n_comp,
                      const uint8_t* tables, uint8_t* out, long cap) {
  HuffEnc dc[4], ac[4];
  for (int c = 0; c < n_comp && c < 4; ++c) {
    const uint8_t* tb = tables + 544 * c;
    build_enc(tb, tb + 16, dc + c);
    build_enc(tb + 272, tb + 288, ac + c);
  }
  BitWriter bw{out, out + cap, 0, 0, false};
  int pred[4] = {0, 0, 0, 0};
  const int16_t* blk = blocks;
  for (long u = 0; u < n_units; ++u) {
    for (int b = 0; b < units_blocks; ++b, blk += 64) {
      const int c = block_comp[b];
      const int diff = blk[0] - pred[c];
      pred[c] = blk[0];
      int s = nbits_of(diff);
      put_bits(&bw, dc[c].code[s], dc[c].size[s]);
      put_bits(&bw, (uint32_t)(diff < 0 ? diff - 1 : diff), s);
      int run = 0;
      for (int k = 1; k < 64; ++k) {
        const int v = blk[kZigzag[k]];
        if (v == 0) {
          ++run;
          continue;
        }
        while (run > 15) {
          put_bits(&bw, ac[c].code[0xF0], ac[c].size[0xF0]);
          run -= 16;
        }
        s = nbits_of(v);
        const int rs = (run << 4) | s;
        put_bits(&bw, ac[c].code[rs], ac[c].size[rs]);
        put_bits(&bw, (uint32_t)(v < 0 ? v - 1 : v), s);
        run = 0;
      }
      if (run > 0) put_bits(&bw, ac[c].code[0], ac[c].size[0]);
      if (bw.overflow) return -1;
    }
  }
  if (bw.n > 0) put_bits(&bw, 0x7F, 8 - bw.n);  // pad with 1-bits
  if (bw.overflow) return -1;
  return (long)(bw.p - out);
}

}  // extern "C"
