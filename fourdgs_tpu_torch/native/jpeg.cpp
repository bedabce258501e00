// Baseline JPEG decoder for the port's loaders: host C++, no libjpeg.
//
// The JAX package decodes JPEG frames with Pillow (libjpeg-turbo); the
// port depends on no Pillow, imageio, torchvision or libjpeg, so it keeps this
// decoder (utils/jpeg.py builds it with g++ at first use and loads it with
// ctypes). It follows libjpeg's default decompression path step for step,
// so that its output equals Pillow's:
//
// - Huffman-coded sequential DCT (SOF0 baseline, SOF1 extended), 8-bit
//   samples, 1 or 3 components, sampling factors 1 or 2 in each direction
//   (4:4:4, 4:2:2, 4:2:0, 4:4:0), interleaved or one scan per component,
//   8- or 16-bit quantization tables, restart intervals (DRI / RSTn), any
//   width and height;
// - the "islow" integer IDCT (jidctint.c) with libjpeg's post-IDCT range
//   limit table (jdmaster.c);
// - "fancy" chroma upsampling (jdsample.c): the triangle filter for 2h2v
//   (h2v2), 2h1v and 1h2v, with libjpeg's edge rules (context rows clamped
//   to the component's real rows; plain replication where a 2h component is
//   at most 2 samples wide);
// - the fixed-point YCbCr -> RGB tables (jdcolor.c); a JFIF file is YCbCr,
//   an Adobe file with transform 0 (or component ids 'R', 'G', 'B') RGB.
//
// Outside that scope it fails with kind 2 (utils/jpeg.py raises
// NotImplementedError naming the feature): progressive, lossless,
// hierarchical and arithmetic-coded files, 12-bit samples, 2 or 4
// components, sampling factors above 2. A truncated or corrupt file fails
// with kind 1 (ValueError): no missing data is filled in; so does an image
// of more pixels than Pillow opens, and a Huffman table whose codes do not
// fit their lengths.
//
// C interface:
//   int jd_info(const uint8_t* data, size_t n, int* w, int* h, int* c,
//               char* err, int err_len);
//   int jd_decode(const uint8_t* data, size_t n, uint8_t* out,
//                 char* err, int err_len);
// Each returns 0, or 1 (corrupt / truncated) or 2 (not supported) with a
// message in err. jd_decode writes h*w*c bytes (c = 1 grey, 3 RGB).

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
  int td = 0, ta = 0;   // Huffman tables of the current scan
  int bw = 0, bh = 0;   // blocks per row / column, padded to whole MCUs
  int dw = 0, dh = 0;   // downsampled width / height in samples
  int pred = 0;         // DC predictor
  bool scanned = false;
  std::vector<int16_t> coef;   // bh * bw blocks of 64, natural order
  std::vector<uint8_t> plane;  // (bh * 8) rows of (bw * 8) samples
};

struct Decoder {
  const uint8_t* p;
  size_t n, pos = 0;
  uint16_t qt[4][64];  // natural order
  bool qset[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int width = 0, height = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  bool frame = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  std::vector<Component> comps;

  // bit reader: the next bits at the top of `buf`; `pad` trailing bits of
  // the `cnt` valid ones are zeros put in past a marker or the end of data
  uint64_t buf = 0;
  int cnt = 0, pad = 0;
  bool at_marker = false;

  Decoder(const uint8_t* data, size_t len) : p(data), n(len) {}

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

  void read_sof() {
    if (frame) corrupt("more than one frame header");
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
    if (nc == 4) unsupported("4-component (CMYK / YCCK) files");
    if (nc != 1 && nc != 3)
      unsupported(std::to_string(nc) + "-component files (1 or 3 only)");
    comps.resize(nc);
    for (auto& c : comps) {
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.v < 1 || c.tq > 3) corrupt("bad SOF component");
      if (c.h > 2 || c.v > 2)
        unsupported("sampling factor " + std::to_string(c.h) + "x" + std::to_string(c.v) +
                    " (1 or 2 in each direction only)");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    if (nc == 1) hmax = vmax = comps[0].h = comps[0].v = 1;  // as libjpeg
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (width * c.h + hmax - 1) / hmax;
      c.dh = (height * c.v + vmax - 1) / vmax;
    }
    frame = true;
  }

  // the coefficient planes, allocated only to decode (jd_info reads headers)
  void allocate() {
    for (auto& c : comps) c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
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

  // -- a scan ------------------------------------------------------------
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

  void read_sos() {
    if (!frame) corrupt("a scan before the frame header");
    int len = u16();
    int ns = byte();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) corrupt("bad SOS segment");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      int id = byte(), t = byte();
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == id) found = &c;
      if (!found) corrupt("a scan names an unknown component");
      found->td = t >> 4;
      found->ta = t & 15;
      if (found->td > 3 || found->ta > 3) corrupt("bad SOS table ids");
      if (!dc[found->td].present || !ac[found->ta].present)
        corrupt("a scan uses an undefined Huffman table");
      if (!qset[found->tq]) corrupt("a component uses an undefined quantization table");
      sc.push_back(found);
    }
    int ss = byte(), se = byte(), ahal = byte();
    if (ss != 0 || se != 63 || ahal != 0) corrupt("bad spectral selection for a sequential scan");
    for (auto* c : sc) {
      c->pred = 0;
      c->scanned = true;
    }
    reset_bits();

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
        reset_bits();
        int code = next_marker();
        if (code < 0) corrupt("truncated file (the data ends inside a scan)");
        if (code != 0xD0 + next_rst) corrupt("corrupt data: a restart marker is missing");
        next_rst = (next_rst + 1) & 7;
        for (auto* c : sc) c->pred = 0;
      }
      int my = m / units_x, mx = m % units_x;
      if (ns == 1) {
        Component& c = *sc[0];
        decode_block(c, &c.coef[(size_t(my) * c.bw + mx) * 64]);
      } else {
        for (auto* cp : sc) {
          Component& c = *cp;
          for (int v = 0; v < c.v; ++v)
            for (int h = 0; h < c.h; ++h) {
              size_t by = size_t(my) * c.v + v, bx = size_t(mx) * c.h + h;
              decode_block(c, &c.coef[(by * c.bw + bx) * 64]);
            }
        }
      }
    }
    reset_bits();
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
          read_sof();
          if (headers_only) return;
          allocate();
          break;
        case 0xC2: unsupported("progressive JPEG (SOF2)");
        case 0xC3: unsupported("lossless JPEG (SOF3)");
        case 0xC5:
        case 0xC6:
        case 0xC7: unsupported("hierarchical (differential) JPEG (SOF5-SOF7)");
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
        case 0xCC: unsupported("arithmetic-coded JPEG");
        case 0xC8: unsupported("the JPG extension marker");
        case 0xC4: read_dht(); break;
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

  // component c upsampled to the image's width for output row y; `o` holds
  // 2 * c.dw ints
  void upsample_row(const Component& c, int y, int* out, int* o) const {
    const int stride = c.bw * 8;
    const int hf = hmax / c.h, vf = vmax / c.v;
    const bool fancy_h = hf == 2 && c.dw > 2;
    const uint8_t* r0;
    const uint8_t* r1 = nullptr;
    int bias = 0;
    if (vf == 2 && (hf == 1 || fancy_h)) {  // context rows, clamped to the real ones
      int in = y >> 1, other = (y & 1) ? in + 1 : in - 1;
      if (other < 0) other = 0;
      if (other > c.dh - 1) other = c.dh - 1;
      r0 = &c.plane[size_t(in) * stride];
      r1 = &c.plane[size_t(other) * stride];
      bias = (y & 1) ? 2 : 1;
    } else {
      r0 = &c.plane[size_t(y / vf) * stride];
    }
    if (hf == 1) {
      if (r1) {  // h1v2 fancy
        for (int x = 0; x < width; ++x) out[x] = (r0[x] * 3 + r1[x] + bias) >> 2;
      } else {
        for (int x = 0; x < width; ++x) out[x] = r0[x];
      }
      return;
    }
    if (!fancy_h) {  // plain replication
      for (int x = 0; x < width; ++x) out[x] = r0[x >> 1];
      return;
    }
    const int dw = c.dw;
    if (r1) {  // h2v2 fancy: column sums 3 * nearer row + further row
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

  void reconstruct(uint8_t* out) {
    // jdmaster.c's sample_range_limit: the simple table at [256, 768) and
    // the post-IDCT table from 384 (CENTERJSAMPLE past the simple one)
    std::vector<uint8_t> table(5 * 256 + 128, 0);
    uint8_t* simple = table.data() + 256;
    for (int i = 0; i < 256; ++i) simple[i] = uint8_t(i);
    uint8_t* post = simple + 128;
    for (int i = 128; i < 512; ++i) post[i] = 255;
    std::memcpy(post + 1024 - 128, simple, 128);
    for (auto& c : comps) {
      const int stride = c.bw * 8;
      c.plane.assign(size_t(stride) * c.bh * 8, 0);
      const uint16_t* q = qt[c.tq];
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct_islow(&c.coef[(size_t(by) * c.bw + bx) * 64], q,
                     &c.plane[size_t(by) * 8 * stride + bx * 8], stride, post);
    }
    const int nc = int(comps.size());
    std::vector<int> scratch(size_t(width) + 2);
    if (nc == 1) {
      std::vector<int> row(width);
      for (int y = 0; y < height; ++y) {
        upsample_row(comps[0], y, row.data(), scratch.data());
        for (int x = 0; x < width; ++x) out[size_t(y) * width + x] = uint8_t(row[x]);
      }
      return;
    }
    bool rgb;
    if (jfif) rgb = false;
    else if (adobe) rgb = adobe_transform == 0;
    else rgb = comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
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
    std::vector<int> r0(width), r1(width), r2(width);
    for (int y = 0; y < height; ++y) {
      upsample_row(comps[0], y, r0.data(), scratch.data());
      upsample_row(comps[1], y, r1.data(), scratch.data());
      upsample_row(comps[2], y, r2.data(), scratch.data());
      uint8_t* o = out + size_t(y) * width * 3;
      for (int x = 0; x < width; ++x, o += 3) {
        if (rgb) {
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
