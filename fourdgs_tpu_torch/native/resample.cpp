// Pillow-exact image resample for the port's loaders: host C++, no Pillow.
//
// The JAX package resizes frames and masks with Pillow's Image.resize
// (data/dynerf.py::ImageRef LANCZOS, data/blender.py BICUBIC on RGBA, the
// covisible masks BILINEAR in mode L). The port depends on no Pillow, so it
// keeps this copy of Pillow's 8-bit two-pass convolution (libImaging/
// Resample.c, ImagingResampleInner), step for step, so that its output
// equals Pillow's:
//
// - per axis, scale = in / out and the filter's support widened by the
//   scale when it is above 1 (a downscale); output pixel i's window is
//   centred at (i + 0.5) * scale, its taps [int(c - s + 0.5),
//   int(c + s + 0.5)) clipped to the image;
// - the weights are normalised in double, then rounded to fixed point with
//   22 fractional bits (PRECISION_BITS = 32 - 8 - 2), away from zero;
// - each sum starts at 1 << 21 and is clipped to 8 bits (clip8);
// - the horizontal pass runs first, over the rows the vertical pass reads
//   only, and is clipped to uint8 before the vertical pass; a pass whose
//   axis keeps its size is skipped;
// - BICUBIC is Keys' cubic with a = -0.5, LANCZOS the sinc windowed to 3
//   lobes, BILINEAR the triangle;
// - RGBA is resampled premultiplied (Image.resize converts RGBA to RGBa and
//   back), with Pillow's conversions: c * a / 255 rounded (MULDIV255), and
//   back 255 * c / a truncated and clipped, where a is neither 0 nor 255.
//
// Channels are independent, so 1 (L), 3 (RGB) and 4 (RGBA) channels share
// one loop. The integer sums are associative, so the vertical pass may
// walk rows in any order and still equal Pillow's bit for bit.
//
// C interface:
//   int rs_resize(const uint8_t* in, int w, int h, int c, uint8_t* out,
//                 int ow, int oh, int filter, char* err, int err_len);
// filter: 0 bilinear, 1 bicubic, 2 lanczos. Returns 0, or 1 with a message
// in err. `out` holds oh * ow * c bytes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <exception>
#include <new>
#include <string>
#include <vector>

namespace {

const int kPrecisionBits = 32 - 8 - 2;

double bilinear(double x) {
  if (x < 0.0) x = -x;
  if (x < 1.0) return 1.0 - x;
  return 0.0;
}

double bicubic(double x) {
  const double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

double sinc(double x) {
  if (x == 0.0) return 1.0;
  x = x * M_PI;
  return sin(x) / x;
}

double lanczos(double x) {
  if (-3.0 <= x && x < 3.0) return sinc(x) * sinc(x / 3);
  return 0.0;
}

struct Filter {
  double (*fn)(double);
  double support;
};

const Filter kFilters[3] = {{bilinear, 1.0}, {bicubic, 2.0}, {lanczos, 3.0}};

// One axis's taps: output i reads inputs [lo[i], lo[i] + n[i]) with the
// fixed-point weights k[i * ksize ...] (precompute_coeffs and
// normalize_coeffs_8bpc).
struct Coeffs {
  int ksize;
  std::vector<int> lo, n;
  std::vector<int32_t> k;
};

Coeffs precompute(int in_size, int out_size, const Filter& f) {
  double scale = double(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = f.support * filterscale;
  Coeffs c;
  c.ksize = int(std::ceil(support)) * 2 + 1;
  c.lo.resize(out_size);
  c.n.resize(out_size);
  c.k.assign(size_t(out_size) * c.ksize, 0);
  std::vector<double> w(c.ksize);
  for (int xx = 0; xx < out_size; xx++) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = int(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = int(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    for (int x = 0; x < xmax; x++) {
      double v = f.fn((x + xmin - center + 0.5) * ss);
      w[x] = v;
      ww += v;
    }
    for (int x = 0; x < xmax; x++) {
      if (ww != 0.0) w[x] /= ww;
      double p = w[x];
      c.k[size_t(xx) * c.ksize + x] = p < 0 ? int(-0.5 + p * (1 << kPrecisionBits))
                                            : int(0.5 + p * (1 << kPrecisionBits));
    }
    c.lo[xx] = xmin;
    c.n[xx] = xmax;
  }
  return c;
}

inline uint8_t clip8(int32_t v) {
  v >>= kPrecisionBits;
  return v < 0 ? 0 : v > 255 ? 255 : uint8_t(v);
}

// Horizontal pass over rows [row0, row0 + rows) of `in` (w wide) into `out`
// (ow wide, `rows` rows); C channels a pixel.
template <int C>
void horizontal(const uint8_t* in, int w, int row0, int rows, const Coeffs& k, int ow,
                uint8_t* out) {
  for (int yy = 0; yy < rows; yy++) {
    const uint8_t* src = in + size_t(row0 + yy) * w * C;
    uint8_t* dst = out + size_t(yy) * ow * C;
    for (int xx = 0; xx < ow; xx++) {
      const int32_t* kx = &k.k[size_t(xx) * k.ksize];
      const uint8_t* s = src + size_t(k.lo[xx]) * C;
      int32_t acc[C];
      for (int ch = 0; ch < C; ch++) acc[ch] = 1 << (kPrecisionBits - 1);
      for (int x = 0; x < k.n[xx]; x++)
        for (int ch = 0; ch < C; ch++) acc[ch] += int32_t(s[x * C + ch]) * kx[x];
      for (int ch = 0; ch < C; ch++) dst[xx * C + ch] = clip8(acc[ch]);
    }
  }
}

// Vertical pass: output row yy sums input rows lo[yy] - row0 ... of `in`
// (rowlen bytes a row) into `out`.
void vertical(const uint8_t* in, size_t rowlen, int row0, const Coeffs& k, int oh,
              uint8_t* out) {
  std::vector<int32_t> acc(rowlen);
  for (int yy = 0; yy < oh; yy++) {
    const int32_t* ky = &k.k[size_t(yy) * k.ksize];
    std::fill(acc.begin(), acc.end(), int32_t(1) << (kPrecisionBits - 1));
    for (int y = 0; y < k.n[yy]; y++) {
      const uint8_t* src = in + size_t(k.lo[yy] - row0 + y) * rowlen;
      int32_t wy = ky[y];
      for (size_t i = 0; i < rowlen; i++) acc[i] += int32_t(src[i]) * wy;
    }
    uint8_t* dst = out + size_t(yy) * rowlen;
    for (size_t i = 0; i < rowlen; i++) dst[i] = clip8(acc[i]);
  }
}

// RGBA -> RGBa (Convert.c rgbA2rgba): c * a / 255, rounded
void premultiply(uint8_t* p, size_t pixels) {
  for (size_t i = 0; i < pixels; i++, p += 4) {
    uint32_t a = p[3];
    for (int ch = 0; ch < 3; ch++) {
      uint32_t t = p[ch] * a + 128;
      p[ch] = uint8_t(((t >> 8) + t) >> 8);
    }
  }
}

// RGBa -> RGBA (Convert.c rgba2rgbA): 255 * c / a, truncated and clipped
void unpremultiply(uint8_t* p, size_t pixels) {
  for (size_t i = 0; i < pixels; i++, p += 4) {
    uint32_t a = p[3];
    if (a == 0 || a == 255) continue;
    for (int ch = 0; ch < 3; ch++) {
      uint32_t v = 255 * uint32_t(p[ch]) / a;
      p[ch] = uint8_t(v > 255 ? 255 : v);
    }
  }
}

void resize(const uint8_t* in, int w, int h, int c, uint8_t* out, int ow, int oh,
            const Filter& f) {
  if (ow == w && oh == h) {  // Image.resize returns a copy, unconverted
    std::copy(in, in + size_t(w) * h * c, out);
    return;
  }
  std::vector<uint8_t> pre;
  if (c == 4) {
    pre.assign(in, in + size_t(w) * h * 4);
    premultiply(pre.data(), size_t(w) * h);
    in = pre.data();
  }
  bool need_h = ow != w, need_v = oh != h;
  Coeffs kh = precompute(w, ow, f);
  Coeffs kv = precompute(h, oh, f);
  // first and one past the last source row the vertical pass reads
  int row0 = kv.lo[0];
  int row1 = kv.lo[oh - 1] + kv.n[oh - 1];
  std::vector<uint8_t> tmp;
  const uint8_t* src = in;
  int src_row0 = 0;
  if (need_h) {
    int rows = need_v ? row1 - row0 : h;
    int first = need_v ? row0 : 0;
    uint8_t* dst = out;
    if (need_v) {
      tmp.resize(size_t(rows) * ow * c);
      dst = tmp.data();
    }
    if (c == 1) horizontal<1>(in, w, first, rows, kh, ow, dst);
    if (c == 3) horizontal<3>(in, w, first, rows, kh, ow, dst);
    if (c == 4) horizontal<4>(in, w, first, rows, kh, ow, dst);
    src = dst;
    src_row0 = first;
  }
  if (need_v) vertical(src, size_t(ow) * c, src_row0, kv, oh, out);
  if (c == 4) unpremultiply(out, size_t(ow) * oh);
}

void set_err(char* err, int err_len, const std::string& m) {
  if (err && err_len > 0) std::snprintf(err, size_t(err_len), "%s", m.c_str());
}

}  // namespace

extern "C" int rs_resize(const uint8_t* in, int w, int h, int c, uint8_t* out, int ow,
                         int oh, int filter, char* err, int err_len) {
  if (w <= 0 || h <= 0 || ow <= 0 || oh <= 0) {
    set_err(err, err_len, "sizes must be positive");
    return 1;
  }
  if (c != 1 && c != 3 && c != 4) {
    set_err(err, err_len, "1 (L), 3 (RGB) or 4 (RGBA) channels");
    return 1;
  }
  if (filter < 0 || filter > 2) {
    set_err(err, err_len, "filter must be 0 (bilinear), 1 (bicubic) or 2 (lanczos)");
    return 1;
  }
  try {
    resize(in, w, h, c, out, ow, oh, kFilters[filter]);
  } catch (const std::bad_alloc&) {
    set_err(err, err_len, "out of memory");
    return 1;
  } catch (const std::exception& e) {
    set_err(err, err_len, e.what());
    return 1;
  }
  return 0;
}
