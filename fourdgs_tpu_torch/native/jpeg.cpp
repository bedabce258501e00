// JPEG decoder for the port's loaders: host C++, no libjpeg.
//
// The JAX package decodes JPEG frames with Pillow (libjpeg-turbo); the
// port depends on no Pillow, imageio, torchvision or libjpeg, so it keeps this
// decoder (utils/jpeg.py builds it with g++ at first use and loads it with
// ctypes). It follows libjpeg-turbo 3.1's default decompression path step
// for step, so that its output equals Pillow's:
//
// - sequential DCT (SOF0 baseline, SOF1 extended, SOF9 arithmetic) and
//   progressive DCT (SOF2, SOF10 arithmetic), 8-bit samples, 1, 3 or 4
//   components, sampling factors 1 to 4 in each direction whose ratios to
//   the largest are whole, interleaved or one scan per component, 8- or
//   16-bit quantization tables, tables redefined between scans, restart
//   intervals (DRI / RSTn), any width and height. A component's
//   quantization table is latched at its first scan (jdinput.c);
// - Huffman-coded scans (jdhuff.c, jdphuff.c) and arithmetic-coded ones
//   (jdarith.c: the QM coder of T.81 Annex D, its statistics bins, DAC
//   conditioning, zeros fed past a marker): progressive scans decode into
//   a whole-image coefficient buffer, DC first and refine scans
//   (interleaved or not), AC first and refine scans of one component over
//   its own blocks, with spectral selection, successive approximation and
//   end-of-band runs (EOBRUN, reset at each RSTn);
// - block smoothing of a progressive file whose scans leave a
//   low-frequency coefficient unrefined (jdcoefct.c, smoothing_ok and
//   decompress_smooth_data of libjpeg-turbo 2.1 and later): the first nine
//   AC coefficients of a block still zero are estimated from the DC values
//   of its 5x5 neighbourhood, and its DC too when no AC coefficient has
//   been seen; from each coefficient's final bit position, as the whole
//   file is read before output;
// - the "islow" integer IDCT (jidctint.c) with libjpeg's post-IDCT range
//   limit table (jdmaster.c);
// - upsampling as jdsample.c picks it: the "fancy" triangle filters for a
//   ratio of 2 horizontally (h2v1), vertically (h1v2) or both (h2v2), with
//   libjpeg's edge rules (context rows clamped to the component's real
//   rows; plain replication where a 2h component is at most 2 samples
//   wide), and replication for any other whole ratio (int_upsample);
// - lossless JPEG (SOF3, jdlossls.c, jddiffct.c, jdlhuff.c, jdpred.c) at
//   8-bit precision: predictors 1 to 7, the point transform, restart
//   intervals of whole MCU rows; its components are upsampled by
//   replication only (no fancy filters without a DCT);
// - colour as jdapimin.c reads the markers and jdcolor.c converts: three
//   components are YCbCr (the fixed-point tables) under a JFIF marker, RGB
//   under an Adobe marker of transform 0, else YCbCr; without either
//   marker, component ids 'R', 'G', 'B' mean RGB, and so do any ids in a
//   lossless file but 1, 2, 3 in a DCT one. Four components are CMYK
//   (Adobe transform 0, or no Adobe marker) or YCCK (any other transform,
//   ycck_cmyk_convert), written inverted as Pillow's "CMYK;I" raw mode
//   gives them.
//
// Outside that scope it fails with kind 2 (utils/jpeg.py raises
// NotImplementedError naming the feature): hierarchical files (SOF5-SOF7,
// SOF13-SOF15), arithmetic-coded lossless files (SOF11), samples of other
// than 8 bits (12-bit DCT, 16-bit lossless), a height set by a DNL marker,
// 2-component files, sampling factors whose ratios are not whole, a
// lossless restart interval of part of an MCU row, and a YCbCr-to-RGB or
// YCCK conversion of a lossless file (libjpeg refuses each). A truncated or
// corrupt file fails with kind 1 (ValueError): no missing data is filled
// in; so does an image of more pixels than Pillow opens, a Huffman table
// whose codes do not fit their lengths, a sampling factor outside 1-4 and
// an interleaved scan of more than 10 blocks per MCU.
//
// C interface:
//   int jd_info(const uint8_t* data, size_t n, int* w, int* h, int* c,
//               char* err, int err_len);
//   int jd_decode(const uint8_t* data, size_t n, uint8_t* out,
//                 char* err, int err_len);
// Each returns 0, or 1 (corrupt / truncated) or 2 (not supported) with a
// message in err. jd_decode writes h*w*c bytes (c = 1 grey, 3 RGB,
// 4 inverted CMYK).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <new>
#include <string>
#include <vector>

namespace {

struct Failure {
  int kind;
  std::string msg;
};

[[noreturn]] void corrupt(const std::string& m) { throw Failure{1, m}; }
[[noreturn]] void unsupported(const std::string& m) { throw Failure{2, m}; }

// Pillow's Image.open refuses an image of more pixels than this
// (2 * Image.MAX_IMAGE_PIXELS, DecompressionBombError); so does the decoder,
// before it allocates anything of the image's size
const int64_t kMaxPixels = 2 * int64_t(1024 * 1024 * 1024 / 4 / 3);

// zigzag index -> natural (row-major) index
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// The QM coder's probability estimation (T.81 Table D.2), packed as
// jaricom.c packs it: Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7 |
// Next_Index_LPS. State 113 is the fixed probability 0.5 of sign and
// refinement bits.
#define Q(qe, nmps, nlps, sw) ((uint32_t(qe) << 16) | ((nmps) << 8) | ((sw) << 7) | (nlps))
const uint32_t kQM[114] = {
    Q(0x5a1d,   1,   1, 1), Q(0x2586,   2,  14, 0), Q(0x1114,   3,  16, 0), Q(0x080b,   4,  18, 0),
    Q(0x03d8,   5,  20, 0), Q(0x01da,   6,  23, 0), Q(0x00e5,   7,  25, 0), Q(0x006f,   8,  28, 0),
    Q(0x0036,   9,  30, 0), Q(0x001a,  10,  33, 0), Q(0x000d,  11,  35, 0), Q(0x0006,  12,   9, 0),
    Q(0x0003,  13,  10, 0), Q(0x0001,  13,  12, 0), Q(0x5a7f,  15,  15, 1), Q(0x3f25,  16,  36, 0),
    Q(0x2cf2,  17,  38, 0), Q(0x207c,  18,  39, 0), Q(0x17b9,  19,  40, 0), Q(0x1182,  20,  42, 0),
    Q(0x0cef,  21,  43, 0), Q(0x09a1,  22,  45, 0), Q(0x072f,  23,  46, 0), Q(0x055c,  24,  48, 0),
    Q(0x0406,  25,  49, 0), Q(0x0303,  26,  51, 0), Q(0x0240,  27,  52, 0), Q(0x01b1,  28,  54, 0),
    Q(0x0144,  29,  56, 0), Q(0x00f5,  30,  57, 0), Q(0x00b7,  31,  59, 0), Q(0x008a,  32,  60, 0),
    Q(0x0068,  33,  62, 0), Q(0x004e,  34,  63, 0), Q(0x003b,  35,  32, 0), Q(0x002c,   9,  33, 0),
    Q(0x5ae1,  37,  37, 1), Q(0x484c,  38,  64, 0), Q(0x3a0d,  39,  65, 0), Q(0x2ef1,  40,  67, 0),
    Q(0x261f,  41,  68, 0), Q(0x1f33,  42,  69, 0), Q(0x19a8,  43,  70, 0), Q(0x1518,  44,  72, 0),
    Q(0x1177,  45,  73, 0), Q(0x0e74,  46,  74, 0), Q(0x0bfb,  47,  75, 0), Q(0x09f8,  48,  77, 0),
    Q(0x0861,  49,  78, 0), Q(0x0706,  50,  79, 0), Q(0x05cd,  51,  48, 0), Q(0x04de,  52,  50, 0),
    Q(0x040f,  53,  50, 0), Q(0x0363,  54,  51, 0), Q(0x02d4,  55,  52, 0), Q(0x025c,  56,  53, 0),
    Q(0x01f8,  57,  54, 0), Q(0x01a4,  58,  55, 0), Q(0x0160,  59,  56, 0), Q(0x0125,  60,  57, 0),
    Q(0x00f6,  61,  58, 0), Q(0x00cb,  62,  59, 0), Q(0x00ab,  63,  61, 0), Q(0x008f,  32,  61, 0),
    Q(0x5b12,  65,  65, 1), Q(0x4d04,  66,  80, 0), Q(0x412c,  67,  81, 0), Q(0x37d8,  68,  82, 0),
    Q(0x2fe8,  69,  83, 0), Q(0x293c,  70,  84, 0), Q(0x2379,  71,  86, 0), Q(0x1edf,  72,  87, 0),
    Q(0x1aa9,  73,  87, 0), Q(0x174e,  74,  72, 0), Q(0x1424,  75,  72, 0), Q(0x119c,  76,  74, 0),
    Q(0x0f6b,  77,  74, 0), Q(0x0d51,  78,  75, 0), Q(0x0bb6,  79,  77, 0), Q(0x0a40,  48,  77, 0),
    Q(0x5832,  81,  80, 1), Q(0x4d1c,  82,  88, 0), Q(0x438e,  83,  89, 0), Q(0x3bdd,  84,  90, 0),
    Q(0x34ee,  85,  91, 0), Q(0x2eae,  86,  92, 0), Q(0x299a,  87,  93, 0), Q(0x2516,  71,  86, 0),
    Q(0x5570,  89,  88, 1), Q(0x4ca9,  90,  95, 0), Q(0x44d9,  91,  96, 0), Q(0x3e22,  92,  97, 0),
    Q(0x3824,  93,  99, 0), Q(0x32b4,  94,  99, 0), Q(0x2e17,  86,  93, 0), Q(0x56a8,  96,  95, 1),
    Q(0x4f46,  97, 101, 0), Q(0x47e5,  98, 102, 0), Q(0x41cf,  99, 103, 0), Q(0x3c3d, 100, 104, 0),
    Q(0x375e,  93,  99, 0), Q(0x5231, 102, 105, 0), Q(0x4c0f, 103, 106, 0), Q(0x4639, 104, 107, 0),
    Q(0x415e,  99, 103, 0), Q(0x5627, 106, 105, 1), Q(0x50e7, 107, 108, 0), Q(0x4b85, 103, 109, 0),
    Q(0x5597, 109, 110, 0), Q(0x504f, 107, 111, 0), Q(0x5a10, 111, 110, 1), Q(0x5522, 109, 112, 0),
    Q(0x59eb, 111, 112, 1), Q(0x5a1d, 113, 113, 0),
};
#undef Q

const int kArithTables = 16;               // arithmetic conditioning tables 0..15 (jpeglib.h)
const int kDcBins = 64, kAcBins = 256;     // statistics bins of a DC / AC table (jdarith.c)
const int kMaxBlocksInMcu = 10;            // D_MAX_BLOCKS_IN_MCU

struct Huffman {
  bool present = false;
  int maxcode[18];    // largest code of each length, -1 if none
  int valoffset[17];  // index of a length's first code's value, minus that code
  uint8_t vals[256];
  uint16_t look[512];  // 9-bit lookahead: (length << 8) | value, 0 if longer

  // Canonical codes from the counts of each length. A table whose codes do
  // not fit their lengths is rejected before any is stored, as libjpeg
  // rejects it (jdhuff.c): the codes of a length, after those of the shorter
  // ones, must leave the all-ones code of that length unused. So every code
  // of length len is below 1 << len, and its lookahead entries stay inside
  // `look`.
  void build(const uint8_t* bits, const uint8_t* values, int count) {
    std::memcpy(vals, values, count);
    int code = 0, k = 0;
    std::memset(look, 0, sizeof(look));
    for (int len = 1; len <= 16; ++len) {
      valoffset[len] = k - code;
      if (code + bits[len - 1] >= (1 << len)) corrupt("bad Huffman table");
      if (bits[len - 1]) {
        for (int i = 0; i < bits[len - 1]; ++i, ++k, ++code) {
          if (len <= 9) {
            int shift = 9 - len;
            for (int j = 0; j < (1 << shift); ++j)
              look[(code << shift) | j] = uint16_t((len << 8) | vals[k]);
          }
        }
        maxcode[len] = code - 1;
      } else {
        maxcode[len] = -1;
      }
      code <<= 1;
    }
    maxcode[17] = 0x7FFFFFFF;
    present = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int v_file = 1;       // the frame header's v (h and v are set to 1 in a grey file)
  int td = 0, ta = 0;   // entropy tables of the current scan
  int bw = 0, bh = 0;   // DCT: blocks per row / column, padded to whole MCUs
  int dw = 0, dh = 0;   // downsampled width / height in samples
  int pred = 0;         // DC predictor (arithmetic: modulo 2^16)
  int dc_context = 0;   // arithmetic DC conditioning (jdarith.c)
  bool scanned = false;
  bool latched = false;  // q copied from its table at the first scan
  uint16_t q[64];        // natural order
  int coef_bits[64];     // progressive: each coefficient's last Al, -1 before its first scan
  std::vector<int16_t> coef;   // DCT: bh * bw blocks of 64, natural order
  std::vector<uint16_t> undiff;  // lossless: dh rows of dw undifferenced samples
  std::vector<uint8_t> plane;  // output samples, `stride` per row
  int stride = 0;
};

enum class Up { kFull, kH2V1Fancy, kH1V2Fancy, kH2V2Fancy, kReplicate };

struct Decoder {
  const uint8_t* p;
  size_t n, pos = 0;
  uint16_t qt[4][64];  // natural order
  bool qset[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int width = 0, height = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int vmax_file = 1;  // the largest v of the frame header (also in a grey file)
  int restart_interval = 0;
  bool frame = false, progressive = false, arithmetic = false, lossless = false;
  bool jfif = false, adobe = false;
  int ss = 0, se = 63, ah = 0, al = 0;  // the current scan's band and bit positions
  int eobrun = 0;                       // progressive AC: blocks left in an end-of-band run
  int adobe_transform = -1;
  std::vector<Component> comps;

  // bit reader (Huffman): the next bits at the top of `buf`; `pad` trailing
  // bits of the `cnt` valid ones are zeros put in past a marker or the end
  // of data
  uint64_t buf = 0;
  int cnt = 0, pad = 0;
  bool at_marker = false;

  // arithmetic decoder (jdarith.c): C, A and the bit counter CT; its
  // statistics bins and conditioning (DAC; L = 0, U = 1, Kx = 5 by default)
  int64_t ar_c = 0, ar_a = 0;
  int ar_ct = -16;
  uint8_t dc_stats[kArithTables][kDcBins], ac_stats[kArithTables][kAcBins];
  uint8_t fixed_bin = 113;
  uint8_t dc_l[kArithTables], dc_u[kArithTables], ac_k[kArithTables];

  Decoder(const uint8_t* data, size_t len) : p(data), n(len) {
    std::fill(dc_l, dc_l + kArithTables, 0);
    std::fill(dc_u, dc_u + kArithTables, 1);
    std::fill(ac_k, ac_k + kArithTables, 5);
  }

  int byte() {
    if (pos >= n) corrupt("truncated file (the data ends inside a marker segment)");
    return p[pos++];
  }
  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  void fill() {
    while (cnt <= 56) {
      int b = 0;
      if (at_marker || pos >= n) {
        pad += 8;
      } else if (p[pos] == 0xFF) {
        if (pos + 1 >= n) {
          pos = n;
          pad += 8;
        } else if (p[pos + 1] == 0x00) {
          b = 0xFF;
          pos += 2;
        } else {
          at_marker = true;  // pos stays on the marker
          pad += 8;
        }
      } else {
        b = p[pos++];
      }
      buf |= uint64_t(b) << (56 - cnt);
      cnt += 8;
    }
  }

  void consumed() {
    if (cnt < pad) {
      if (pos >= n) corrupt("truncated file (the data ends inside a scan)");
      corrupt("corrupt data: a scan's entropy-coded segment ends early");
    }
  }

  int bits(int k) {
    if (k == 0) return 0;
    if (cnt < k) fill();
    int v = int(buf >> (64 - k));
    buf <<= k;
    cnt -= k;
    consumed();
    return v;
  }

  int decode(const Huffman& t) {
    if (cnt < 16) fill();
    int e = t.look[buf >> 55];
    if (e) {
      int len = e >> 8;
      buf <<= len;
      cnt -= len;
      consumed();
      return e & 0xFF;
    }
    int len = 10;
    int code = int(buf >> 54);
    while (len <= 16 && code > t.maxcode[len]) {
      ++len;
      code = int(buf >> (64 - len));
    }
    if (len > 16) corrupt("corrupt data: no Huffman code matches");
    buf <<= len;
    cnt -= len;
    consumed();
    return t.vals[t.valoffset[len] + code];
  }

  static int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }

  void reset_bits() {
    buf = 0;
    cnt = pad = 0;
    at_marker = false;
  }

  // -- the arithmetic decoder (jdarith.c) ---------------------------------
  // the next byte of the entropy-coded segment: a stuffed 0xFF 0x00 is
  // 0xFF; at a marker, zeros from then on (pos stays on the marker), as
  // T.81 has the decoder do; the end of the file is a truncation
  int arith_byte() {
    if (at_marker) return 0;
    if (pos >= n) corrupt("truncated file (the data ends inside a scan)");
    int d = p[pos];
    if (d != 0xFF) {
      ++pos;
      return d;
    }
    size_t q = pos + 1;
    while (q < n && p[q] == 0xFF) ++q;  // fill bytes
    if (q >= n) corrupt("truncated file (the data ends inside a scan)");
    if (p[q] == 0x00) {
      pos = q + 1;
      return 0xFF;
    }
    pos = q - 1;
    at_marker = true;
    return 0;
  }

  void arith_reset() {
    ar_c = ar_a = 0;
    ar_ct = -16;  // read two bytes into C first
    at_marker = false;
  }

  // one binary decision with the statistics bin *st (T.81 D.2, as jdarith.c
  // arith_decode keeps C's base and its input bits in one register)
  int arith_decode(uint8_t* st) {
    while (ar_a < 0x8000) {
      if (--ar_ct < 0) {
        ar_c = (ar_c << 8) | arith_byte();
        if ((ar_ct += 8) < 0 && ++ar_ct == 0) ar_a = 0x8000;  // two initial bytes read
      }
      ar_a <<= 1;
    }
    int sv = *st;
    uint32_t qe = kQM[sv & 0x7F];
    int nl = qe & 0xFF;
    qe >>= 8;
    int nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = ar_a - qe;
    ar_a = temp;
    temp <<= ar_ct;
    if (ar_c >= temp) {
      ar_c -= temp;
      if (ar_a < int64_t(qe)) {  // conditional LPS exchange
        ar_a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        ar_a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (ar_a < 0x8000) {  // conditional MPS exchange
      if (ar_a < int64_t(qe)) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // F.2.4.1: a DC difference with its component's conditioning
  int arith_dc_diff(Component& c) {
    uint8_t* stats = dc_stats[c.td];
    uint8_t* st = stats + c.dc_context;
    if (arith_decode(st) == 0) {
      c.dc_context = 0;
      return 0;
    }
    int sign = arith_decode(st + 1);
    st += 2 + sign;
    int m = arith_decode(st);
    if (m) {
      st = stats + 20;  // X1
      while (arith_decode(st)) {
        if ((m <<= 1) == 0x8000) corrupt("corrupt data: an arithmetic-coded magnitude overflows");
        ++st;
      }
    }
    if (m < ((1 << dc_l[c.td]) >> 1)) c.dc_context = 0;
    else if (m > ((1 << dc_u[c.td]) >> 1)) c.dc_context = 12 + sign * 4;
    else c.dc_context = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (arith_decode(st)) v |= m;
    v += 1;
    return sign ? -v : v;
  }

  // F.2.4.2: a nonzero AC value at zigzag index k whose sign and category
  // bins follow `st` (S0 + 3 * (k - 1) + 1 already decided "nonzero")
  int arith_ac_value(const Component& c, uint8_t* st, int k) {
    int sign = arith_decode(&fixed_bin);
    st += 2;
    int m = arith_decode(st);
    if (m && arith_decode(st)) {
      m <<= 1;
      st = ac_stats[c.ta] + (k <= ac_k[c.ta] ? 189 : 217);
      while (arith_decode(st)) {
        if ((m <<= 1) == 0x8000) corrupt("corrupt data: an arithmetic-coded magnitude overflows");
        ++st;
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (arith_decode(st)) v |= m;
    v += 1;
    return sign ? -v : v;
  }

  // the AC coefficients k0..k1 of a block (F.2.4.2): EOB decisions, zero
  // runs, values; each written as int16(v << al)
  void arith_ac_band(Component& c, int16_t* blk, int k0, int k1) {
    uint8_t* stats = ac_stats[c.ta];
    for (int k = k0; k <= k1; ++k) {
      uint8_t* st = stats + 3 * (k - 1);
      if (arith_decode(st)) break;  // EOB
      while (arith_decode(st + 1) == 0) {
        st += 3;
        if (++k > k1) corrupt("corrupt data: an arithmetic-coded zero run passes the band's end");
      }
      blk[kNatural[k]] = int16_t(unsigned(arith_ac_value(c, st, k)) << al);
    }
  }

  void arith_block(Component& c, int16_t* blk) {  // sequential (SOF9)
    c.pred = (c.pred + arith_dc_diff(c)) & 0xFFFF;
    blk[0] = int16_t(c.pred);
    arith_ac_band(c, blk, 1, 63);
  }

  void arith_dc_first(Component& c, int16_t* blk) {
    c.pred = (c.pred + arith_dc_diff(c)) & 0xFFFF;
    blk[0] = int16_t(unsigned(c.pred) << al);
  }

  void arith_dc_refine(Component&, int16_t* blk) {
    if (arith_decode(&fixed_bin)) blk[0] = int16_t(blk[0] | (1 << al));
  }

  void arith_ac_first(Component& c, int16_t* blk) { arith_ac_band(c, blk, ss, se); }

  void arith_ac_refine(Component& c, int16_t* blk) {  // G.1.3.3
    const int p1 = 1 << al, m1 = -(1 << al);
    int kex = se;  // the previous stage's end of band
    for (; kex > 0; --kex)
      if (blk[kNatural[kex]]) break;
    uint8_t* stats = ac_stats[c.ta];
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = stats + 3 * (k - 1);
      if (k > kex && arith_decode(st)) break;  // EOB
      for (;;) {
        int16_t& coef = blk[kNatural[k]];
        if (coef) {  // previously nonzero: a correction bit
          if (arith_decode(st + 2)) coef = int16_t(coef + (coef < 0 ? m1 : p1));
          break;
        }
        if (arith_decode(st + 1)) {  // newly nonzero
          coef = int16_t(arith_decode(&fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) corrupt("corrupt data: an arithmetic-coded zero run passes the band's end");
      }
    }
  }

  // the statistics a scan (and each of its restart intervals) starts from
  // (jdarith.c start_pass, process_restart)
  void arith_start(const std::vector<Component*>& sc) {
    for (auto* c : sc) {
      if (!progressive || (ss == 0 && ah == 0)) {
        std::memset(dc_stats[c->td], 0, kDcBins);
        c->pred = 0;
        c->dc_context = 0;
      }
      if (!progressive || ss) std::memset(ac_stats[c->ta], 0, kAcBins);
    }
    arith_reset();
  }

  // -- marker segments ---------------------------------------------------
  void read_dqt() {
    int len = u16() - 2;
    while (len > 0) {
      int pq_tq = byte();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) corrupt("bad DQT segment");
      for (int i = 0; i < 64; ++i) qt[tq][kNatural[i]] = uint16_t(pq ? u16() : byte());
      qset[tq] = true;
      len -= 1 + 64 * (pq + 1);
    }
    if (len != 0) corrupt("bad DQT segment length");
  }

  void read_dht() {
    int len = u16() - 2;
    while (len > 0) {
      int tc_th = byte();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) corrupt("bad DHT segment");
      uint8_t counts[16], values[256];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i] = uint8_t(byte());
      if (total > 256) corrupt("bad DHT segment");
      for (int i = 0; i < total; ++i) values[i] = uint8_t(byte());
      (tc ? ac : dc)[th].build(counts, values, total);
      len -= 17 + total;
    }
    if (len != 0) corrupt("bad DHT segment length");
  }

  void read_dac() {  // jdmarker.c get_dac
    int len = u16() - 2;
    while (len > 0) {
      int index = byte(), val = byte();
      len -= 2;
      if (index >= 2 * kArithTables) corrupt("bad DAC segment (table index)");
      if (index >= kArithTables) {
        ac_k[index - kArithTables] = uint8_t(val);
      } else {
        dc_l[index] = uint8_t(val & 15);
        dc_u[index] = uint8_t(val >> 4);
        if (dc_l[index] > dc_u[index]) corrupt("bad DAC segment (L above U)");
      }
    }
    if (len != 0) corrupt("bad DAC segment length");
  }

  void read_sof(bool is_progressive, bool is_lossless, bool is_arithmetic) {
    if (frame) corrupt("more than one frame header");
    progressive = is_progressive;
    lossless = is_lossless;
    arithmetic = is_arithmetic;
    int len = u16();
    int precision = byte();
    if (precision != 8)
      unsupported(std::to_string(precision) + "-bit samples (8-bit only)");
    height = u16();
    width = u16();
    int nc = byte();
    if (len != 8 + 3 * nc) corrupt("bad SOF segment length");
    if (height == 0) unsupported("a height set by a DNL marker");
    if (width == 0) corrupt("zero width");
    if (int64_t(width) * height > kMaxPixels)
      corrupt("image too large: " + std::to_string(width) + "x" + std::to_string(height) +
              " pixels, above Pillow's decompression-bomb limit of " +
              std::to_string(kMaxPixels));
    if (nc != 1 && nc != 3 && nc != 4)
      unsupported(std::to_string(nc) + "-component files (1, 3 or 4 only)");
    comps.resize(nc);
    for (auto& c : comps) {
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = c.v_file = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)  // jdinput.c, JERR_BAD_SAMPLING
        corrupt("bad sampling factors " + std::to_string(c.h) + "x" + std::to_string(c.v) +
                " (1 to 4 in each direction)");
      if (c.tq > 3) corrupt("bad SOF component");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    vmax_file = vmax;
    if (nc == 1) hmax = vmax = comps[0].h = comps[0].v = 1;  // full size, as libjpeg
    for (auto& c : comps)
      if (hmax % c.h || vmax % c.v)  // jdsample.c, JERR_FRACT_SAMPLE_NOTIMPL
        unsupported("sampling factors " + std::to_string(c.h) + "x" + std::to_string(c.v) +
                    " of a frame whose largest are " + std::to_string(hmax) + "x" +
                    std::to_string(vmax) + " (upsampling by a fraction; libjpeg refuses it)");
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (width * c.h + hmax - 1) / hmax;
      c.dh = (height * c.v + vmax - 1) / vmax;
    }
    frame = true;
  }

  // the coefficient or sample planes, allocated only to decode (jd_info
  // reads headers)
  void allocate() {
    for (auto& c : comps) {
      if (lossless) {
        c.undiff.assign(size_t(c.dw) * c.dh, 0);
        c.stride = c.dw;
        c.plane.assign(size_t(c.dw) * c.dh, 0);
      } else {
        c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
      }
    }
  }

  void read_app(int marker) {
    int len = u16() - 2;
    if (len < 0 || pos + len > n) corrupt("truncated file (the data ends inside a marker segment)");
    const uint8_t* d = p + pos;
    if (marker == 0xE0 && len >= 5 && std::memcmp(d, "JFIF\0", 5) == 0) jfif = true;
    if (marker == 0xEE && len >= 12 && std::memcmp(d, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = d[11];
    }
    pos += len;
  }

  void skip_segment() {
    int len = u16() - 2;
    if (len < 0 || pos + len > n) corrupt("truncated file (the data ends inside a marker segment)");
    pos += len;
  }

  // the next marker's code, -1 at the end of the data; fill bytes (0xFF)
  // before it and bytes that are no marker (a stuffed 0xFF 0x00) are skipped
  int next_marker() {
    for (;;) {
      while (pos < n && p[pos] != 0xFF) ++pos;
      while (pos < n && p[pos] == 0xFF) ++pos;
      if (pos >= n) return -1;
      int code = p[pos++];
      if (code != 0x00) return code;
    }
  }

  // the restart marker RSTn expected next in a scan
  void expect_restart(int next_rst) {
    int code = next_marker();
    if (code < 0) corrupt("truncated file (the data ends inside a scan)");
    if (code != 0xD0 + next_rst) corrupt("corrupt data: a restart marker is missing");
  }

  // -- a Huffman-coded scan ----------------------------------------------
  void decode_block(Component& c, int16_t* blk) {
    const Huffman& hd = dc[c.td];
    const Huffman& ha = ac[c.ta];
    int s = decode(hd);
    if (s > 16) corrupt("corrupt data: bad DC magnitude");
    int diff = s ? extend(bits(s), s) : 0;
    c.pred += diff;
    blk[0] = int16_t(c.pred);
    for (int k = 1; k < 64;) {
      int rs = decode(ha);
      int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        if (k > 63) corrupt("corrupt data: AC run past the block's end");
        blk[kNatural[k]] = int16_t(extend(bits(sz), sz));
        ++k;
      } else {
        if (r != 15) break;  // EOB
        k += 16;
      }
    }
  }

  // -- progressive Huffman scans (jdphuff.c) --------------------------------
  void decode_dc_first(Component& c, int16_t* blk) {
    int s = decode(dc[c.td]);
    if (s > 16) corrupt("corrupt data: bad DC magnitude");
    int diff = s ? extend(bits(s), s) : 0;
    c.pred += diff;
    blk[0] = int16_t(c.pred * (1 << al));
  }

  void decode_dc_refine(Component&, int16_t* blk) {
    if (bits(1)) blk[0] = int16_t(blk[0] | (1 << al));
  }

  void decode_ac_first(Component& c, int16_t* blk) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    const Huffman& ha = ac[c.ta];
    for (int k = ss; k <= se; ++k) {
      int rs = decode(ha);
      int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        if (k > se) corrupt("corrupt data: AC run past the band's end");
        blk[kNatural[k]] = int16_t(extend(bits(sz), sz) * (1 << al));
      } else if (r == 15) {
        k += 15;  // ZRL
      } else {
        eobrun = 1 << r;
        if (r) eobrun += bits(r);
        --eobrun;  // this block ends the band
        break;
      }
    }
  }

  // a nonzero coefficient's correction bit: its magnitude gains p1
  void refine(int16_t& coef, int p1) {
    if (bits(1) && (coef & p1) == 0) coef = int16_t(coef >= 0 ? coef + p1 : coef - p1);
  }

  void decode_ac_refine(Component& c, int16_t* blk) {
    const int p1 = 1 << al;
    int k = ss;
    if (eobrun == 0) {
      const Huffman& ha = ac[c.ta];
      for (; k <= se; ++k) {
        int rs = decode(ha);
        int r = rs >> 4, sz = rs & 15;
        int value = 0;
        if (sz) {  // a newly nonzero coefficient, +-p1 (libjpeg takes any size as 1)
          value = bits(1) ? p1 : -p1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += bits(r);
          break;
        }
        // skip r zero coefficients, refining the nonzero ones on the way
        for (; k <= se; ++k) {
          int16_t& coef = blk[kNatural[k]];
          if (coef != 0) {
            refine(coef, p1);
          } else if (--r < 0) {
            break;
          }
        }
        if (value) {
          if (k > se) corrupt("corrupt data: AC run past the band's end");
          blk[kNatural[k]] = int16_t(value);
        }
      }
    }
    if (eobrun > 0) {  // the rest of the band refines its nonzero coefficients
      for (; k <= se; ++k) {
        int16_t& coef = blk[kNatural[k]];
        if (coef != 0) refine(coef, p1);
      }
      --eobrun;
    }
  }

  // the scan header's band for a progressive frame, checked as libjpeg
  // checks it (jdphuff.c, start_pass_phuff_decoder; jdarith.c, start_pass),
  // and each coefficient's bit position recorded
  void start_progressive_scan(const std::vector<Component*>& sc) {
    bool dc_band = ss == 0;
    bool bad = dc_band ? se != 0 : (ss > se || se > 63 || sc.size() != 1);
    if (ah != 0 && al != ah - 1) bad = true;
    if (al > 13) bad = true;
    if (bad) corrupt("bad progression parameters in a scan header");
    for (auto* c : sc) {
      for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
      if (!arithmetic && (dc_band ? ah == 0 && !dc[c->td].present : !ac[c->ta].present))
        corrupt("a scan uses an undefined Huffman table");
    }
  }

  void read_sos() {
    if (!frame) corrupt("a scan before the frame header");
    int len = u16();
    int ns = byte();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) corrupt("bad SOS segment");
    std::vector<Component*> sc;
    int blocks = 0;
    for (int i = 0; i < ns; ++i) {
      int id = byte(), t = byte();
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == id) found = &c;
      if (!found) corrupt("a scan names an unknown component");
      found->td = t >> 4;
      found->ta = t & 15;
      if (!arithmetic && (found->td > 3 || found->ta > 3)) corrupt("bad SOS table ids");
      if (!arithmetic && !progressive &&
          (!dc[found->td].present || (!lossless && !ac[found->ta].present)))
        corrupt("a scan uses an undefined Huffman table");
      if (!lossless && !qset[found->tq])
        corrupt("a component uses an undefined quantization table");
      blocks += found->h * found->v;
      sc.push_back(found);
    }
    if (ns > 1 && blocks > kMaxBlocksInMcu)  // jdinput.c, JERR_BAD_MCU_SIZE
      corrupt("sampling factors too large for an interleaved scan (" + std::to_string(blocks) +
              " blocks per MCU, at most " + std::to_string(kMaxBlocksInMcu) + ")");
    ss = byte();
    se = byte();
    int ahal = byte();
    ah = ahal >> 4;
    al = ahal & 15;
    if (lossless) {  // jdlossls.c: Ss the predictor, Al the point transform
      if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= 8)
        corrupt("bad lossless parameters in a scan header");
    } else if (progressive) {
      start_progressive_scan(sc);
    } else if (ss != 0 || se != 63 || ahal != 0) {
      corrupt("bad spectral selection for a sequential scan");
    }
    for (auto* c : sc) {
      c->pred = 0;
      c->scanned = true;
      if (!lossless && !c->latched) std::memcpy(c->q, qt[c->tq], sizeof(c->q));
      c->latched = true;
    }
    reset_bits();
    eobrun = 0;
    if (lossless) {
      lossless_scan(sc);
    } else if (arithmetic) {
      arith_start(sc);
      auto restart = [this, &sc](int next_rst) {
        expect_restart(next_rst);
        arith_start(sc);
      };
#define JD_SCAN(fn) scan_blocks(sc, [this](Component& c, int16_t* blk) { fn(c, blk); }, restart)
      if (!progressive) JD_SCAN(arith_block);
      else if (ss == 0 && ah == 0) JD_SCAN(arith_dc_first);
      else if (ss == 0) JD_SCAN(arith_dc_refine);
      else if (ah == 0) JD_SCAN(arith_ac_first);
      else JD_SCAN(arith_ac_refine);
#undef JD_SCAN
    } else {
      auto restart = [this, &sc](int next_rst) {
        reset_bits();
        expect_restart(next_rst);
        for (auto* c : sc) c->pred = 0;
        eobrun = 0;
      };
#define JD_SCAN(fn) scan_blocks(sc, [this](Component& c, int16_t* blk) { fn(c, blk); }, restart)
      if (!progressive) JD_SCAN(decode_block);
      else if (ss == 0 && ah == 0) JD_SCAN(decode_dc_first);
      else if (ss == 0) JD_SCAN(decode_dc_refine);
      else if (ah == 0) JD_SCAN(decode_ac_first);
      else JD_SCAN(decode_ac_refine);
#undef JD_SCAN
    }
    reset_bits();
  }

  // the scan's MCUs in order, each block decoded by `block_fn` (a lambda,
  // so each block decoder gets a loop of its own), with `restart(n)`
  // between intervals
  template <typename BlockFn, typename RestartFn>
  void scan_blocks(const std::vector<Component*>& sc, BlockFn block_fn, RestartFn restart) {
    const int ns = int(sc.size());
    int units_x, units_y;
    if (ns == 1) {  // non-interleaved: one block per MCU over the real blocks
      units_x = (sc[0]->dw + 7) / 8;
      units_y = (sc[0]->dh + 7) / 8;
    } else {
      units_x = mcux;
      units_y = mcuy;
    }
    int total = units_x * units_y, next_rst = 0;
    for (int m = 0; m < total; ++m) {
      if (restart_interval && m > 0 && m % restart_interval == 0) {
        restart(next_rst);
        next_rst = (next_rst + 1) & 7;
      }
      int my = m / units_x, mx = m % units_x;
      if (ns == 1) {
        Component& c = *sc[0];
        block_fn(c, &c.coef[(size_t(my) * c.bw + mx) * 64]);
      } else {
        for (auto* cp : sc) {
          Component& c = *cp;
          for (int v = 0; v < c.v; ++v)
            for (int h = 0; h < c.h; ++h) {
              size_t by = size_t(my) * c.v + v, bx = size_t(mx) * c.h + h;
              block_fn(c, &c.coef[(by * c.bw + bx) * 64]);
            }
        }
      }
    }
  }

  // -- a lossless scan (jddiffct.c, jdlhuff.c, jdpred.c) --------------------
  // A sample difference (H.2.2): category 16 is 32768 with no extra bits.
  int lossless_diff(const Huffman& t) {
    int s = decode(t);
    if (s > 16) corrupt("corrupt data: bad lossless difference category");
    if (s == 16) return 32768;
    return s ? extend(bits(s), s) : 0;
  }

  // Each iMCU row's MCU rows are decoded (a restart marker before each
  // whole interval of MCU rows), then its sample rows undifferenced, as
  // jddiffct.c does: a restart resets every component to the first-row
  // predictor, and that reset reaches the rows of the iMCU row decoded
  // before it.
  void lossless_scan(const std::vector<Component*>& sc) {
    const int ns = int(sc.size());
    int mcus_per_row, total_imcu = (height + vmax_file - 1) / vmax_file;
    if (ns == 1) mcus_per_row = sc[0]->dw;
    else mcus_per_row = (width + hmax - 1) / hmax;
    if (restart_interval % mcus_per_row)  // jddiffct.c, JERR_BAD_RESTART
      unsupported("a lossless restart interval of " + std::to_string(restart_interval) +
                  " MCUs, not whole MCU rows of " + std::to_string(mcus_per_row) +
                  " (libjpeg refuses it)");
    const int restart_rows = restart_interval / mcus_per_row;
    int rows_to_go = restart_rows, next_rst = 0;
    // the differences of one iMCU row per component: v rows of the MCU row's width
    std::vector<std::vector<int>> diff(ns);
    std::vector<int> rows_in_imcu(ns), pad_w(ns);
    for (int i = 0; i < ns; ++i) {
      const Component& c = *sc[i];
      int v = ns == 1 ? c.v_file : c.v;
      rows_in_imcu[i] = v;
      pad_w[i] = ns == 1 ? c.dw : mcus_per_row * c.h;
      diff[i].assign(size_t(v) * pad_w[i], 0);
    }
    std::vector<bool> first_row(ns, true);
    for (int r = 0; r < total_imcu; ++r) {
      const bool last = r == total_imcu - 1;
      int mcu_rows = 1;
      if (ns == 1) {
        int v = rows_in_imcu[0], left = sc[0]->dh - r * v;
        mcu_rows = std::min(v, left);
      }
      for (int y = 0; y < mcu_rows; ++y) {
        if (restart_interval) {
          if (rows_to_go == 0) {
            reset_bits();
            expect_restart(next_rst);
            next_rst = (next_rst + 1) & 7;
            std::fill(first_row.begin(), first_row.end(), true);
            rows_to_go = restart_rows;
          }
          --rows_to_go;
        }
        for (int mx = 0; mx < mcus_per_row; ++mx) {
          if (ns == 1) {
            diff[0][size_t(y) * pad_w[0] + mx] = lossless_diff(dc[sc[0]->td]);
            continue;
          }
          for (int i = 0; i < ns; ++i) {
            const Component& c = *sc[i];
            for (int vv = 0; vv < c.v; ++vv)
              for (int hh = 0; hh < c.h; ++hh)
                diff[i][size_t(vv) * pad_w[i] + mx * c.h + hh] = lossless_diff(dc[c.td]);
          }
        }
      }
      for (int i = 0; i < ns; ++i) {
        Component& c = *sc[i];
        int v = rows_in_imcu[i];
        int rows = last ? c.dh - r * v : v;
        for (int y = 0; y < rows; ++y) {
          undifference(c, r * v + y, &diff[i][size_t(y) * pad_w[i]], first_row[i]);
          first_row[i] = false;
        }
      }
    }
  }

  // jdpred.c: sample row `y` of c from its differences, modulo 2^16; the
  // first row of a scan or restart interval predicts from the left
  // (2^(P - Pt - 1) for its first sample), any other row's first sample from
  // above and the rest by the scan's predictor. The output samples are
  // the row shifted left by the point transform, modulo 2^8 (jdlossls.c)
  void undifference(Component& c, int y, const int* d, bool first) {
    uint16_t* out = &c.undiff[size_t(y) * c.dw];
    const int w = c.dw;
    if (first) {
      int ra = (d[0] + (1 << (8 - al - 1))) & 0xFFFF;
      out[0] = uint16_t(ra);
      for (int x = 1; x < w; ++x) out[x] = uint16_t(ra = (d[x] + ra) & 0xFFFF);
    } else {
      predict_row(out, out - c.dw, d, w);
    }
    uint8_t* o = &c.plane[size_t(y) * c.stride];
    for (int x = 0; x < w; ++x) o[x] = uint8_t(out[x] << al);
  }

  void predict_row(uint16_t* out, const uint16_t* up, const int* d, int w) const {
    int rb = up[0];
    int ra = (d[0] + rb) & 0xFFFF;
    out[0] = uint16_t(ra);
    for (int x = 1; x < w; ++x) {
      int rc = rb;
      rb = up[x];
      int pr;
      switch (ss) {
        case 1: pr = ra; break;
        case 2: pr = rb; break;
        case 3: pr = rc; break;
        case 4: pr = ra + rb - rc; break;
        case 5: pr = ra + ((rb - rc) >> 1); break;
        case 6: pr = rb + ((ra - rc) >> 1); break;
        default: pr = (ra + rb) >> 1; break;
      }
      out[x] = uint16_t(ra = (d[x] + pr) & 0xFFFF);
    }
  }

  void parse(bool headers_only) {
    if (n < 2 || p[0] != 0xFF || p[1] != 0xD8) corrupt("not a JPEG file (no SOI marker)");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m < 0) {
        if (headers_only && frame) return;
        corrupt(frame ? "truncated file (no EOI marker)" : "truncated file (no frame header)");
      }
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
        case 0xC3:
        case 0xC9:
        case 0xCA:
          read_sof(m == 0xC2 || m == 0xCA, m == 0xC3, m >= 0xC9);
          if (headers_only) return;
          allocate();
          break;
        case 0xC5:
        case 0xC6:
        case 0xC7:
        case 0xCD:
        case 0xCE:
        case 0xCF: unsupported("hierarchical (differential) JPEG (SOF5-SOF7, SOF13-SOF15)");
        case 0xCB: unsupported("arithmetic-coded lossless JPEG (SOF11)");
        case 0xC8: unsupported("the JPG extension marker");
        case 0xC4: read_dht(); break;
        case 0xCC: read_dac(); break;
        case 0xDB: read_dqt(); break;
        case 0xDD:
          if (u16() != 4) corrupt("bad DRI segment");
          restart_interval = u16();
          break;
        case 0xDA:
          read_sos();
          break;
        case 0xD9: {
          if (!frame) corrupt("no frame header before EOI");
          for (auto& c : comps)
            if (!c.scanned) corrupt("truncated file (a component has no scan)");
          return;
        }
        case 0xD8: corrupt("a second SOI marker");
        case 0xDC: unsupported("a height set by a DNL marker");
        default:
          if (m >= 0xD0 && m <= 0xD7) break;  // a stray RSTn: no segment
          if (m >= 0xE0 && m <= 0xEF) {
            read_app(m);
          } else if (m == 0x01) {
            break;  // TEM: no segment
          } else {
            skip_segment();
          }
      }
    }
  }

  // jdcoefct.c's smoothing_ok (libjpeg-turbo 3, SAVED_COEFS 10): whether
  // libjpeg's output pass smooths the blocks
  bool would_smooth() const {
    static const int kSaved[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};  // Q00, Q01, Q10, ...
    bool useful = false;
    for (const auto& c : comps) {
      for (int pos : kSaved)
        if (c.q[pos] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  // -- reconstruction -------------------------------------------------------
  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride,
                         const uint8_t* range) {
    // jidctint.c: CONST_BITS 13, PASS1_BITS 2
    const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069,
                  F2053 = 16819, F2562 = 20995, F3072 = 25172;
    int ws[64];
    for (int c = 0; c < 8; ++c) {
      const int16_t* ip = in + c;
      const uint16_t* qp = q + c;
      if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
        int dcval = int(int64_t(ip[0]) * qp[0] * 4);  // << PASS1_BITS
        for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dcval;
        continue;
      }
      int64_t z2 = int64_t(ip[16]) * qp[16], z3 = int64_t(ip[48]) * qp[48];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
      z2 = int64_t(ip[0]) * qp[0];
      z3 = int64_t(ip[32]) * qp[32];
      int64_t tmp0 = (z2 + z3) * 8192, tmp1 = (z2 - z3) * 8192;
      int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
      tmp0 = int64_t(ip[56]) * qp[56];
      tmp1 = int64_t(ip[40]) * qp[40];
      tmp2 = int64_t(ip[24]) * qp[24];
      tmp3 = int64_t(ip[8]) * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3, z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = 11, rnd = 1 << 10;  // CONST_BITS - PASS1_BITS
      ws[0 * 8 + c] = int((t10 + tmp3 + rnd) >> sh);
      ws[7 * 8 + c] = int((t10 - tmp3 + rnd) >> sh);
      ws[1 * 8 + c] = int((t11 + tmp2 + rnd) >> sh);
      ws[6 * 8 + c] = int((t11 - tmp2 + rnd) >> sh);
      ws[2 * 8 + c] = int((t12 + tmp1 + rnd) >> sh);
      ws[5 * 8 + c] = int((t12 - tmp1 + rnd) >> sh);
      ws[3 * 8 + c] = int((t13 + tmp0 + rnd) >> sh);
      ws[4 * 8 + c] = int((t13 - tmp0 + rnd) >> sh);
    }
    for (int r = 0; r < 8; ++r) {
      const int* w = ws + r * 8;
      uint8_t* o = out + size_t(r) * stride;
      if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
        uint8_t v = range[((w[0] + 16) >> 5) & 1023];  // PASS1_BITS + 3
        for (int c = 0; c < 8; ++c) o[c] = v;
        continue;
      }
      int64_t z2 = w[2], z3 = w[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = (int64_t(w[0]) + w[4]) * 8192, tmp1 = (int64_t(w[0]) - w[4]) * 8192;
      int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
      tmp0 = w[7];
      tmp1 = w[5];
      tmp2 = w[3];
      tmp3 = w[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3, z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = 18;
      const int64_t rnd = int64_t(1) << 17;  // CONST_BITS + PASS1_BITS + 3
      o[0] = range[int((t10 + tmp3 + rnd) >> sh) & 1023];
      o[7] = range[int((t10 - tmp3 + rnd) >> sh) & 1023];
      o[1] = range[int((t11 + tmp2 + rnd) >> sh) & 1023];
      o[6] = range[int((t11 - tmp2 + rnd) >> sh) & 1023];
      o[2] = range[int((t12 + tmp1 + rnd) >> sh) & 1023];
      o[5] = range[int((t12 - tmp1 + rnd) >> sh) & 1023];
      o[3] = range[int((t13 + tmp0 + rnd) >> sh) & 1023];
      o[4] = range[int((t13 - tmp0 + rnd) >> sh) & 1023];
    }
  }

  // an estimate of a still-zero coefficient from num = Q00 * (a sum of DC
  // values), limited to the bits its scans left unsent (jdcoefct.c)
  static int16_t smooth_pred(int64_t num, int64_t qk, int al_k) {
    int64_t pred = ((qk << 7) + (num >= 0 ? num : -num)) / (qk << 8);
    if (al_k > 0 && pred >= (int64_t(1) << al_k)) pred = (int64_t(1) << al_k) - 1;
    return int16_t(num >= 0 ? pred : -pred);
  }

  // jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1 and later): each
  // real block's first nine AC coefficients, where still zero and not known
  // exactly, estimated from the DC values of the 5x5 blocks around it (its
  // DC too when no AC coefficient has been seen), then the IDCT. Rows are
  // walked by iMCU rows as libjpeg walks them, with its neighbour choice
  // at the image's top and bottom, which counts the rows of the last iMCU
  // row as if every iMCU row had as many; columns are clamped to the real
  // blocks.
  void smooth_component(Component& c, const uint8_t* range) {
    const int* cb = c.coef_bits;
    bool change_dc = true;
    for (int k = 1; k < 10; ++k)
      if (cb[k] != -1) change_dc = false;
    const uint16_t* qv = c.q;
    const int64_t Q00 = qv[0], Q01 = qv[1], Q10 = qv[8], Q20 = qv[16], Q11 = qv[9], Q02 = qv[2],
                  Q03 = qv[3], Q12 = qv[10], Q21 = qv[17], Q30 = qv[24];
    const int wib = (c.dw + 7) / 8, hib = (c.dh + 7) / 8, v = c.v_file;
    const int total = (height + 8 * vmax_file - 1) / (8 * vmax_file);
    auto dc_at = [&](int row, int col) -> int {
      if (row >= c.bh) return 0;  // a grey file's rows past its own padding: never decoded
      col = std::min(std::max(col, 0), wib - 1);
      return c.coef[(size_t(row) * c.bw + col) * 64];
    };
    int16_t ws[64];
    for (int r = 0; r < total; ++r) {
      int block_rows = r < total - 1 ? v : (hib % v ? hib % v : v);
      int image_block_rows = block_rows * total;
      for (int br = 0; br < block_rows; ++br) {
        const int row = r * v + br, ibr = r * block_rows + br;
        const int rm1 = ibr > 0 ? row - 1 : row, rm2 = ibr > 1 ? row - 2 : rm1;
        const int rp1 = ibr < image_block_rows - 1 ? row + 1 : row;
        const int rp2 = ibr < image_block_rows - 2 ? row + 2 : rp1;
        const int rows5[5] = {rm2, rm1, row, rp1, rp2};
        for (int col = 0; col < wib; ++col) {
          int d[26];  // DC01..DC25 of jdcoefct.c: rows top to bottom, columns left to right
          for (int i = 0; i < 5; ++i)
            for (int j = 0; j < 5; ++j) d[1 + i * 5 + j] = dc_at(rows5[i], col - 2 + j);
          const int16_t* blk = &c.coef[(size_t(row) * c.bw + col) * 64];
          std::memcpy(ws, blk, sizeof(ws));
#define DC(i) int64_t(d[i])
          if (cb[1] != 0 && ws[1] == 0) {  // AC01
            int64_t s = change_dc
                ? -DC(1) - DC(2) + DC(4) + DC(5) - 3 * DC(6) + 13 * DC(7) - 13 * DC(9) +
                      3 * DC(10) - 3 * DC(11) + 38 * DC(12) - 38 * DC(14) + 3 * DC(15) -
                      3 * DC(16) + 13 * DC(17) - 13 * DC(19) + 3 * DC(20) - DC(21) - DC(22) +
                      DC(24) + DC(25)
                : -7 * DC(11) + 50 * DC(12) - 50 * DC(14) + 7 * DC(15);
            ws[1] = smooth_pred(Q00 * s, Q01, cb[1]);
          }
          if (cb[2] != 0 && ws[8] == 0) {  // AC10
            int64_t s = change_dc
                ? -DC(1) - 3 * DC(2) - 3 * DC(3) - 3 * DC(4) - DC(5) - DC(6) + 13 * DC(7) +
                      38 * DC(8) + 13 * DC(9) - DC(10) + DC(16) - 13 * DC(17) - 38 * DC(18) -
                      13 * DC(19) + DC(20) + DC(21) + 3 * DC(22) + 3 * DC(23) + 3 * DC(24) +
                      DC(25)
                : -7 * DC(3) + 50 * DC(8) - 50 * DC(18) + 7 * DC(23);
            ws[8] = smooth_pred(Q00 * s, Q10, cb[2]);
          }
          if (cb[3] != 0 && ws[16] == 0) {  // AC20
            int64_t s = change_dc
                ? DC(3) + 2 * DC(7) + 7 * DC(8) + 2 * DC(9) - 5 * DC(12) - 14 * DC(13) -
                      5 * DC(14) + 2 * DC(17) + 7 * DC(18) + 2 * DC(19) + DC(23)
                : -DC(3) + 13 * DC(8) - 24 * DC(13) + 13 * DC(18) - DC(23);
            ws[16] = smooth_pred(Q00 * s, Q20, cb[3]);
          }
          if (cb[4] != 0 && ws[9] == 0) {  // AC11
            int64_t s = change_dc
                ? -DC(1) + DC(5) + 9 * DC(7) - 9 * DC(9) - 9 * DC(17) + 9 * DC(19) + DC(21) -
                      DC(25)
                : DC(10) + DC(16) - 10 * DC(17) + 10 * DC(19) - DC(2) - DC(20) + DC(22) -
                      DC(24) + DC(4) - DC(6) + 10 * DC(7) - 10 * DC(9);
            ws[9] = smooth_pred(Q00 * s, Q11, cb[4]);
          }
          if (cb[5] != 0 && ws[2] == 0) {  // AC02
            int64_t s = change_dc
                ? 2 * DC(7) - 5 * DC(8) + 2 * DC(9) + DC(11) + 7 * DC(12) - 14 * DC(13) +
                      7 * DC(14) + DC(15) + 2 * DC(17) - 5 * DC(18) + 2 * DC(19)
                : -DC(11) + 13 * DC(12) - 24 * DC(13) + 13 * DC(14) - DC(15);
            ws[2] = smooth_pred(Q00 * s, Q02, cb[5]);
          }
          if (change_dc) {
            if (cb[6] != 0 && ws[3] == 0)  // AC03
              ws[3] = smooth_pred(
                  Q00 * (DC(7) - DC(9) + 2 * DC(12) - 2 * DC(14) + DC(17) - DC(19)), Q03, cb[6]);
            if (cb[7] != 0 && ws[10] == 0)  // AC12
              ws[10] = smooth_pred(
                  Q00 * (DC(7) - 3 * DC(8) + DC(9) - DC(17) + 3 * DC(18) - DC(19)), Q12, cb[7]);
            if (cb[8] != 0 && ws[17] == 0)  // AC21
              ws[17] = smooth_pred(
                  Q00 * (DC(7) - DC(9) - 3 * DC(12) + 3 * DC(14) + DC(17) - DC(19)), Q21, cb[8]);
            if (cb[9] != 0 && ws[24] == 0)  // AC30
              ws[24] = smooth_pred(
                  Q00 * (DC(7) + 2 * DC(8) + DC(9) - DC(17) - 2 * DC(18) - DC(19)), Q30, cb[9]);
            // the DC itself, from its neighbours (no bit limit)
            ws[0] = smooth_pred(
                Q00 * (-2 * DC(1) - 6 * DC(2) - 8 * DC(3) - 6 * DC(4) - 2 * DC(5) -
                       6 * DC(6) + 6 * DC(7) + 42 * DC(8) + 6 * DC(9) - 6 * DC(10) -
                       8 * DC(11) + 42 * DC(12) + 152 * DC(13) + 42 * DC(14) - 8 * DC(15) -
                       6 * DC(16) + 6 * DC(17) + 42 * DC(18) + 6 * DC(19) - 6 * DC(20) -
                       2 * DC(21) - 6 * DC(22) - 8 * DC(23) - 6 * DC(24) - 2 * DC(25)),
                Q00, 0);
          }
#undef DC
          idct_islow(ws, qv, &c.plane[size_t(row) * 8 * c.stride + col * 8], c.stride, range);
        }
      }
    }
  }

  // jdsample.c's choice for component c: a whole ratio of 2 gets its fancy
  // filter where libjpeg applies one (not in a lossless file), any other
  // whole ratio replication
  Up method(const Component& c) const {
    const int hf = hmax / c.h, vf = vmax / c.v;
    const bool fancy = !lossless;
    if (hf == 1 && vf == 1) return Up::kFull;
    if (hf == 2 && vf == 1 && fancy && c.dw > 2) return Up::kH2V1Fancy;
    if (hf == 1 && vf == 2 && fancy) return Up::kH1V2Fancy;
    if (hf == 2 && vf == 2 && fancy && c.dw > 2) return Up::kH2V2Fancy;
    return Up::kReplicate;
  }

  // component c upsampled to the image's width for output row y; `o` holds
  // 2 * c.dw ints
  void upsample_row(const Component& c, Up how, int y, int* out, int* o) const {
    const int stride = c.stride;
    const int hf = hmax / c.h, vf = vmax / c.v;
    if (how == Up::kFull || how == Up::kReplicate) {
      const uint8_t* r0 = &c.plane[size_t(y / vf) * stride];
      for (int x = 0; x < width; ++x) out[x] = r0[x / hf];
      return;
    }
    const uint8_t* r0 = &c.plane[size_t(y / vf) * stride];
    const uint8_t* r1 = nullptr;
    int bias = 0;
    if (how != Up::kH2V1Fancy) {  // context rows, clamped to the real ones
      int in = y >> 1, other = (y & 1) ? in + 1 : in - 1;
      if (other < 0) other = 0;
      if (other > c.dh - 1) other = c.dh - 1;
      r1 = &c.plane[size_t(other) * stride];
      bias = (y & 1) ? 2 : 1;
    }
    if (how == Up::kH1V2Fancy) {
      for (int x = 0; x < width; ++x) out[x] = (r0[x] * 3 + r1[x] + bias) >> 2;
      return;
    }
    const int dw = c.dw;
    if (how == Up::kH2V2Fancy) {  // column sums 3 * nearer row + further row
      int last = r0[0] * 3 + r1[0], cur = last, next = r0[1] * 3 + r1[1];
      o[0] = (cur * 4 + 8) >> 4;
      o[1] = (cur * 3 + next + 7) >> 4;
      last = cur;
      cur = next;
      for (int i = 1; i < dw - 1; ++i) {
        next = r0[i + 1] * 3 + r1[i + 1];
        o[2 * i] = (cur * 3 + last + 8) >> 4;
        o[2 * i + 1] = (cur * 3 + next + 7) >> 4;
        last = cur;
        cur = next;
      }
      o[2 * dw - 2] = (cur * 3 + last + 8) >> 4;
      o[2 * dw - 1] = (cur * 4 + 7) >> 4;
    } else {  // h2v1 fancy
      o[0] = r0[0];
      o[1] = (r0[0] * 3 + r0[1] + 2) >> 2;
      for (int i = 1; i < dw - 1; ++i) {
        o[2 * i] = (r0[i] * 3 + r0[i - 1] + 1) >> 2;
        o[2 * i + 1] = (r0[i] * 3 + r0[i + 1] + 2) >> 2;
      }
      o[2 * dw - 2] = (r0[dw - 1] * 3 + r0[dw - 2] + 1) >> 2;
      o[2 * dw - 1] = r0[dw - 1];
    }
    for (int x = 0; x < width; ++x) out[x] = o[x];
  }

  // jdapimin.c default_decompress_parms: whether three components are RGB
  bool three_are_rgb() const {
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    const int a = comps[0].id, b = comps[1].id, c = comps[2].id;
    if (a == 1 && b == 2 && c == 3) return lossless;
    if (a == 'R' && b == 'G' && c == 'B') return true;
    return lossless;
  }

  // the output samples of each DCT component's plane: the IDCT of its
  // blocks, smoothed where libjpeg smooths
  void fill_planes(const uint8_t* range) {
    const bool smooth = progressive && would_smooth();
    for (auto& c : comps) {
      if (lossless) continue;  // written by the scans
      c.stride = c.bw * 8;
      c.plane.assign(size_t(c.stride) * c.bh * 8, 0);
      if (smooth) {
        smooth_component(c, range);
        continue;
      }
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct_islow(&c.coef[(size_t(by) * c.bw + bx) * 64], c.q,
                     &c.plane[size_t(by) * 8 * c.stride + bx * 8], c.stride, range);
    }
  }

  void reconstruct(uint8_t* out) {
    // jdmaster.c's sample_range_limit: the simple table at [256, 768) and
    // the post-IDCT table from 384 (CENTERJSAMPLE past the simple one)
    std::vector<uint8_t> table(5 * 256 + 128, 0);
    uint8_t* simple = table.data() + 256;
    for (int i = 0; i < 256; ++i) simple[i] = uint8_t(i);
    uint8_t* post = simple + 128;
    for (int i = 128; i < 512; ++i) post[i] = 255;
    std::memcpy(post + 1024 - 128, simple, 128);
    const int nc = int(comps.size());
    // the colour space (jdapimin.c), checked before any work as jdcolor.c
    // checks it: libjpeg converts no lossless file's colour
    bool ycc = false;
    if (nc == 3) ycc = !three_are_rgb();
    if (nc == 4) ycc = adobe && adobe_transform != 0;
    if (lossless && ycc)
      unsupported(std::string("the ") + (nc == 3 ? "YCbCr-to-RGB" : "YCCK-to-CMYK") +
                  " conversion of a lossless JPEG (libjpeg refuses it)");
    fill_planes(post);
    std::vector<int> scratch(2 * size_t(width) + 16);
    std::vector<std::vector<int>> rows(nc, std::vector<int>(width));
    std::vector<Up> how(nc);
    for (int i = 0; i < nc; ++i) how[i] = method(comps[i]);
    // jdcolor.c: SCALEBITS 16, FIX(x) = x * 65536 + 0.5
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    const int64_t one_half = int64_t(1) << 15;
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = int((int64_t(91881) * x + one_half) >> 16);   // 1.40200
      cb_b[i] = int((int64_t(116130) * x + one_half) >> 16);  // 1.77200
      cr_g[i] = -int64_t(46802) * x;                          // 0.71414
      cb_g[i] = -int64_t(22554) * x + one_half;               // 0.34414
    }
    for (int y = 0; y < height; ++y) {
      for (int i = 0; i < nc; ++i)
        upsample_row(comps[i], how[i], y, rows[i].data(), scratch.data());
      uint8_t* o = out + size_t(y) * width * nc;
      const int* r0 = rows[0].data();
      if (nc == 1) {
        for (int x = 0; x < width; ++x) o[x] = uint8_t(r0[x]);
        continue;
      }
      const int* r1 = rows[1].data();
      const int* r2 = rows[2].data();
      if (nc == 3) {
        for (int x = 0; x < width; ++x, o += 3) {
          if (!ycc) {
            o[0] = uint8_t(r0[x]);
            o[1] = uint8_t(r1[x]);
            o[2] = uint8_t(r2[x]);
            continue;
          }
          int Y = r0[x], cb = r1[x], cr = r2[x];
          o[0] = simple[Y + cr_r[cr]];
          o[1] = simple[Y + int((cb_g[cb] + cr_g[cr]) >> 16)];
          o[2] = simple[Y + cb_b[cb]];
        }
        continue;
      }
      // CMYK, or YCCK by ycck_cmyk_convert; inverted ("CMYK;I")
      const int* r3 = rows[3].data();
      for (int x = 0; x < width; ++x, o += 4) {
        if (!ycc) {
          o[0] = uint8_t(255 - r0[x]);
          o[1] = uint8_t(255 - r1[x]);
          o[2] = uint8_t(255 - r2[x]);
        } else {
          int Y = r0[x], cb = r1[x], cr = r2[x];
          o[0] = uint8_t(255 - simple[255 - (Y + cr_r[cr])]);
          o[1] = uint8_t(255 - simple[255 - (Y + int((cb_g[cb] + cr_g[cr]) >> 16))]);
          o[2] = uint8_t(255 - simple[255 - (Y + cb_b[cb])]);
        }
        o[3] = uint8_t(255 - r3[x]);
      }
    }
  }
};

int report(const Failure& f, char* err, int err_len) {
  if (err && err_len > 0) std::snprintf(err, size_t(err_len), "%s", f.msg.c_str());
  return f.kind;
}

}  // namespace

extern "C" int jd_info(const uint8_t* data, size_t n, int* w, int* h, int* c, char* err,
                       int err_len) {
  try {
    Decoder d(data, n);
    d.parse(true);
    if (!d.frame) corrupt("no frame header");
    *w = d.width;
    *h = d.height;
    *c = int(d.comps.size());
    return 0;
  } catch (const Failure& f) {
    return report(f, err, err_len);
  } catch (const std::exception& e) {
    return report(Failure{1, std::string("decoder error: ") + e.what()}, err, err_len);
  }
}

extern "C" int jd_decode(const uint8_t* data, size_t n, uint8_t* out, char* err, int err_len) {
  try {
    Decoder d(data, n);
    d.parse(false);
    d.reconstruct(out);
    return 0;
  } catch (const Failure& f) {
    return report(f, err, err_len);
  } catch (const std::bad_alloc&) {
    return report(Failure{1, "out of memory"}, err, err_len);
  } catch (const std::exception& e) {
    return report(Failure{1, std::string("decoder error: ") + e.what()}, err, err_len);
  }
}
