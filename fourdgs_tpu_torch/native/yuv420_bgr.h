// The conversion of 8-bit 4:2:0 planes to RGB or BGR as cv2's libswscale
// makes it for a frame of the coded width (its unscaled yuv420p path),
// shared by the port's video decoders (h264.cpp, mpeg4.cpp).
//
// Each chroma sample serves its 2x2 luma block; R = F(Y) + floor((V - 128)
// * rv / 8192) and so on, with F(Y) = floor((Y - 16) * 255 / 219) (limited
// range) or Y (full range), clipped to 0..255, the coefficients of the
// stream's matrix_coefficients (1 BT.709, 4 FCC, 7 SMPTE 240M, else
// BT.601) and its range, read off libswscale 9.5 in cv2 5.0 (its x86 SIMD
// path; its C path rounds otherwise).

#pragma once

#include <cstddef>
#include <cstdint>

namespace native {

// (rv, gu, gv, bu) / 8192 of libswscale's YUV->RGB by (matrix, full range)
struct Coefs {
  int rv, gu, gv, bu;
};
constexpr Coefs kBt601[2] = {{13075, -3209, -6660, 16525}, {11485, -2820, -5851, 14516}};
constexpr Coefs kBt709[2] = {{14686, -1747, -4369, 17305}, {12901, -1535, -3835, 15201}};
constexpr Coefs kFcc[2] = {{13056, -3096, -6639, 16600}, {11469, -2730, -5831, 14582}};
constexpr Coefs kSmpte240[2] = {{14695, -2114, -4447, 17029}, {12911, -1856, -3904, 14957}};

// the w x h frame whose top-left luma sample is y[0] (stride ys) and whose
// chroma samples u[0], v[0] (stride cs) serve its first 2x2 block, into out
// (uint8 [h, w, 3], RGB or with bgr BGR)
inline void yuv420_to_rgb(const uint8_t* y, ptrdiff_t ys, const uint8_t* u, const uint8_t* v,
                          ptrdiff_t cs, int w, int h, int matrix, bool full_range,
                          uint8_t* out, bool bgr) {
  int full = full_range ? 1 : 0;
  const Coefs& k = matrix == 1 ? kBt709[full] : matrix == 4 ? kFcc[full]
                 : matrix == 7 ? kSmpte240[full] : kBt601[full];
  // F(Y) and the chroma terms; clip[v + 512] = v clipped to 0..255
  int F[256], RV[256], GUV_U[256], GV[256], BU[256];
  uint8_t clip[1536];
  auto fl = [](int a, int b) { return a >= 0 ? a / b : -((-a + b - 1) / b); };
  for (int i = 0; i < 256; i++) {
    F[i] = full ? i : fl((i - 16) * 255, 219);
    RV[i] = ((i - 128) * k.rv) >> 13;
    GUV_U[i] = ((i - 128) * k.gu) >> 13;
    GV[i] = ((i - 128) * k.gv) >> 13;
    BU[i] = ((i - 128) * k.bu) >> 13;
  }
  for (int c = 0; c < 1536; c++) clip[c] = uint8_t(c < 512 ? 0 : (c > 767 ? 255 : c - 512));
  const uint8_t* cl = clip + 512;
  int r_at = bgr ? 2 : 0, b_at = bgr ? 0 : 2;
  for (int r = 0; r < h; r++) {
    const uint8_t* Y = y + r * ys;
    const uint8_t* U = u + (r / 2) * cs;
    const uint8_t* V = v + (r / 2) * cs;
    uint8_t* o = out + size_t(r) * w * 3;
    for (int x = 0; x < w; x++) {
      int cu = U[x >> 1], cv = V[x >> 1], f = F[Y[x]];
      o[3 * x + r_at] = cl[f + RV[cv]];
      o[3 * x + 1] = cl[f + GUV_U[cu] + GV[cv]];
      o[3 * x + b_at] = cl[f + BU[cu]];
    }
  }
}

}  // namespace native
