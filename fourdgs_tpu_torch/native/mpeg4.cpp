// MPEG-4 Part 2 (ISO/IEC 14496-2, "mp4v") video decoder for the port's
// DyNeRF loader: host C++, no libavcodec.
//
// cv2.VideoWriter writes MPEG-4 Part 2 into an .mp4 for the fourccs mp4v,
// FMP4, XVID and DIVX (FFmpeg's mpeg4 encoder: I and P VOPs, no B-VOPs, an
// I-VOP every 12, "Lavc" user data), and the JAX package reads such a
// camera with cv2.VideoCapture (FFmpeg's libavformat, libavcodec and
// libswscale). The port depends on no cv2 or FFmpeg, so it keeps this
// decoder (utils/video.py builds it with g++ at first use and loads it with
// ctypes, as it does native/h264.cpp). Its frames equal cv2's bit for bit:
//
// - containers: an MP4 file's first video track with an 'mp4v' sample
//   entry whose esds gives objectTypeIndication 0x20 (mp4.h), the
//   DecoderSpecificInfo's headers first, each sample's first VOP (headers
//   may also come in band);
// - MPEG-4 Visual 8-bit 4:2:0, rectangular, progressive: visual object
//   sequence, visual object (video_signal_type) and video object layer
//   headers (vop_time_increment_resolution and its bit width, a fixed VOP
//   rate, quant_type 0 (H.263) and 1 (MPEG, default and loaded matrices),
//   resync markers), GOV headers and user data; I- and P-VOPs
//   (vop_rounding_type, intra_dc_vlc_thr, fcode 1-7), vop_coded 0 (N-VOP);
//   MCBPC / CBPY / DQUANT, not_coded macroblocks, intra macroblocks in
//   P-VOPs, inter4v (4MV), intra DC VLCs and DC as a coefficient, DC and AC
//   prediction (AC prediction's QP scaling), the intra and inter TCOEF VLCs
//   with the three escape modes, the zigzag and both alternate scans, motion
//   vector VLCs with median prediction and modulo decoding, unrestricted
//   vectors (edge extension), half-sample luma and chroma prediction with
//   either rounding, the 1MV and 4MV chroma vectors, video packets with
//   header_extension_code and their prediction resets;
// - where libavcodec departs from the standard, libavcodec's way (read off
//   cv2 5.0's libavcodec 62.28 on x86-64 with tests/mpeg4_writer.py's
//   random streams; tests/test_torch_mpeg4.py holds each):
//   * intra_dc_vlc_thr compares the QP before the macroblock's DQUANT;
//   * an intra DC level (differential plus predictor) below 0 is an error
//     (its DC decoder returns the level where errors are negative);
//   * the 4MV chroma vector is the four vectors' sum rounded by sixteenths
//     as h263_chroma_roundtab has it: 0-2 to the sample, 3-13 to the half,
//     14-15 to the next sample;
//   * put_no_rnd's horizontal and vertical halves of an 8-wide block (the
//     chroma blocks, the 4MV luma blocks) are libavcodec's x86 ones outside
//     AV_CODEC_FLAG_BITEXACT: pavgb of the other sample and one less the
//     left (or odd-row) sample, saturated at 0; 16-wide blocks are exact;
//   * the IDCT is FFmpeg's simple integer IDCT (idct_algo auto picks it
//     for a stream not named Xvid), which libavcodec's x86 one matched on
//     every block the tests write (quantised DCTs of pixel blocks); blocks
//     of random large coefficients, whose IDCT stages leave 16 bits (no
//     8-bit picture's DCT makes one), came out otherwise there, and the
//     port decodes them as the C IDCT;
//   * MPEG quantisation applies no saturation, and mismatch control only to
//     inter blocks (intra blocks get none outside AV_CODEC_FLAG_BITEXACT);
//     H.263 quantisation saturates escape-3 levels to -2048..2047 only;
//     every coefficient is stored in 16 bits;
//   * AC prediction's QP scaling rounds with ROUNDED_DIV and does not
//     rescale from a macroblock in the first row or column or from a
//     block of the same macroblock; a stored DC is clipped to 0..2047;
//   * the reference is extended beyond the macroblock-aligned picture, not
//     the VOL's width and height, but a 4MV macroblock's 8x8 luma blocks
//     and its chroma block clip their position to the visible picture
//     (-16..width, -8..width / 2; the same vertically) and drop the
//     half-sample offset of a position clipped to its right or bottom end;
//   * a video packet header's QP 0 keeps the running QP, and its header
//     extension's intra_dc_vlc_thr and vop_coding_type are ignored;
//   * output: each coded VOP's frame in decoding order; an N-VOP outputs no
//     frame, but a stream whose last VOP is an N-VOP outputs its last
//     decoded frame again at its end with low_delay 1 (with low_delay 0,
//     one frame a coded VOP);
// - the conversion to RGB as cv2's libswscale makes it (yuv420_bgr.h), the
//   visual object's matrix_coefficients and video_range read as libavcodec
//   reads them.
//
// Outside that scope it fails with kind 2 (utils/video.py raises
// NotImplementedError naming the feature): B-VOPs, S(GMC)-VOPs and
// sprites, quarter-sample motion, interlaced VOLs, data partitioning and
// reversible VLC, non-rectangular shape, short_video_header (H.263 in
// MP4), reduced-resolution VOPs, NEWPRED, scalability, complexity
// estimation headers, bit depths other than 8 (studio profiles), chroma
// other than 4:2:0, an odd width or height (cv2's libswscale converts such
// frames by another path), a matrix_coefficients cv2 does not convert (8
// and above), a stream whose user data names an encoder build for which
// libavcodec applies a workaround or switches IDCT (Xvid, DivX, Lavc /
// FFmpeg builds up to 4712 and those its FF_BUG_IEDGE names), a P-VOP
// before any I-VOP, an 'mp4v' entry without an esds, and any other
// objectTypeIndication in an 'mp4v' entry (named by codec: 0x6C MJPEG,
// 0x60-0x65 MPEG-2, 0x6A MPEG-1). A truncated or corrupt stream fails with
// kind 1 (ValueError).

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "mp4.h"
#include "yuv420_bgr.h"

namespace {

using native::corrupt;
using native::Failure;
using native::refuse;
using native::Span;

// ------------------------------------------------------------------ tables

// Tables B-16 and B-17: the intra and inter TCOEF codes as (code, length),
// escape last; by index the run and level, last = 1 from kIntraLast /
// kInterLast on
const uint16_t kIntraVlc[103][2] = {
    {0x2, 2},   {0x6, 3},   {0xf, 4},   {0xd, 5},   {0xc, 5},   {0x15, 6},  {0x13, 6},
    {0x12, 6},  {0x17, 7},  {0x1f, 8},  {0x1e, 8},  {0x1d, 8},  {0x25, 9},  {0x24, 9},
    {0x23, 9},  {0x21, 9},  {0x21, 10}, {0x20, 10}, {0xf, 10},  {0xe, 10},  {0x7, 11},
    {0x6, 11},  {0x20, 11}, {0x21, 11}, {0x50, 12}, {0x51, 12}, {0x52, 12}, {0xe, 4},
    {0x14, 6},  {0x16, 7},  {0x1c, 8},  {0x20, 9},  {0x1f, 9},  {0xd, 10},  {0x22, 11},
    {0x53, 12}, {0x55, 12}, {0xb, 5},   {0x15, 7},  {0x1e, 9},  {0xc, 10},  {0x56, 12},
    {0x11, 6},  {0x1b, 8},  {0x1d, 9},  {0xb, 10},  {0x10, 6},  {0x22, 9},  {0xa, 10},
    {0xd, 6},   {0x1c, 9},  {0x8, 10},  {0x12, 7},  {0x1b, 9},  {0x54, 12}, {0x14, 7},
    {0x1a, 9},  {0x57, 12}, {0x19, 8},  {0x9, 10},  {0x18, 8},  {0x23, 11}, {0x17, 8},
    {0x19, 9},  {0x18, 9},  {0x7, 10},  {0x58, 12}, {0x7, 4},   {0xc, 6},   {0x16, 8},
    {0x17, 9},  {0x6, 10},  {0x5, 11},  {0x4, 11},  {0x59, 12}, {0xf, 6},   {0x16, 9},
    {0x5, 10},  {0xe, 6},   {0x4, 10},  {0x11, 7},  {0x24, 11}, {0x10, 7},  {0x25, 11},
    {0x13, 7},  {0x5a, 12}, {0x15, 8},  {0x5b, 12}, {0x14, 8},  {0x13, 8},  {0x1a, 8},
    {0x15, 9},  {0x14, 9},  {0x13, 9},  {0x12, 9},  {0x11, 9},  {0x26, 11}, {0x27, 11},
    {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7}};
const uint8_t kIntraRun[102] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  0,  0,  0,
    0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3,  3,  3,  4,  4,  4,  5,  5,  5,
    6, 6, 6, 7, 7, 7, 8, 8, 9, 9, 10, 11, 12, 13, 14, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1,
    2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20};
const uint8_t kIntraLevel[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26,
    27, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 1, 2, 3, 4, 5, 1, 2, 3, 4, 1, 2, 3, 1, 2, 3,
    1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3,
    1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
const uint16_t kInterVlc[103][2] = {
    {0x2, 2},   {0xf, 4},   {0x15, 6},  {0x17, 7},  {0x1f, 8},  {0x25, 9},  {0x24, 9},
    {0x21, 10}, {0x20, 10}, {0x7, 11},  {0x6, 11},  {0x20, 11}, {0x6, 3},   {0x14, 6},
    {0x1e, 8},  {0xf, 10},  {0x21, 11}, {0x50, 12}, {0xe, 4},   {0x1d, 8},  {0xe, 10},
    {0x51, 12}, {0xd, 5},   {0x23, 9},  {0xd, 10},  {0xc, 5},   {0x22, 9},  {0x52, 12},
    {0xb, 5},   {0xc, 10},  {0x53, 12}, {0x13, 6},  {0xb, 10},  {0x54, 12}, {0x12, 6},
    {0xa, 10},  {0x11, 6},  {0x9, 10},  {0x10, 6},  {0x8, 10},  {0x16, 7},  {0x55, 12},
    {0x15, 7},  {0x14, 7},  {0x1c, 8},  {0x1b, 8},  {0x21, 9},  {0x20, 9},  {0x1f, 9},
    {0x1e, 9},  {0x1d, 9},  {0x1c, 9},  {0x1b, 9},  {0x1a, 9},  {0x22, 11}, {0x23, 11},
    {0x56, 12}, {0x57, 12}, {0x7, 4},   {0x19, 9},  {0x5, 11},  {0xf, 6},   {0x4, 11},
    {0xe, 6},   {0xd, 6},   {0xc, 6},   {0x13, 7},  {0x12, 7},  {0x11, 7},  {0x10, 7},
    {0x1a, 8},  {0x19, 8},  {0x18, 8},  {0x17, 8},  {0x16, 8},  {0x15, 8},  {0x14, 8},
    {0x13, 8},  {0x18, 9},  {0x17, 9},  {0x16, 9},  {0x15, 9},  {0x14, 9},  {0x13, 9},
    {0x12, 9},  {0x11, 9},  {0x7, 10},  {0x6, 10},  {0x5, 10},  {0x4, 10},  {0x24, 11},
    {0x25, 11}, {0x26, 11}, {0x27, 11}, {0x58, 12}, {0x59, 12}, {0x5a, 12}, {0x5b, 12},
    {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7}};
const uint8_t kInterRun[102] = {
    0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  1,  1,  1,  1,  1,  1,  2,  2,  2,
    2,  3,  3,  3,  4,  4,  4,  5,  5,  5,  6,  6,  6,  7,  7,  8,  8,  9,  9,  10, 10,
    11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 0,  0,  0,  1,  1,
    2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
    23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40};
const uint8_t kInterLevel[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 1, 2, 3, 1,
    2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 2, 3, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
constexpr int kIntraLast = 67, kInterLast = 58, kEscape = 102;

// Table B-7 (P-VOPs): MCBPC by (code, length); index bit 2 intra, bit 3
// DQUANT, bit 4 inter4v, index 20 stuffing (24-27, inter4v with DQUANT,
// are H.263's and read as libavcodec reads them)
const uint8_t kInterMcbpc[28][2] = {
    {1, 1}, {3, 4}, {2, 4}, {5, 6}, {3, 5}, {4, 8}, {3, 8}, {3, 7}, {3, 3}, {7, 7},
    {6, 7}, {5, 9}, {4, 6}, {4, 9}, {3, 9}, {2, 9}, {2, 3}, {5, 7}, {4, 7}, {5, 8},
    {1, 9}, {0, 0}, {0, 0}, {0, 0}, {2, 11}, {12, 13}, {14, 13}, {15, 13}};
// Table B-6 (I-VOPs): index bit 2 DQUANT, index 8 stuffing
const uint8_t kIntraMcbpc[9][2] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4},
                                   {1, 6}, {2, 6}, {3, 6}, {1, 9}};
// Table B-8: CBPY (of an intra macroblock; inter ones invert it)
const uint8_t kCbpy[16][2] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4}, {2, 6}, {11, 4},
                              {2, 5}, {3, 6}, {5, 4}, {10, 4}, {4, 4}, {8, 4}, {6, 4}, {3, 2}};
// Table B-12: motion_code magnitude 0..32, a sign bit after all but 0
const uint8_t kMv[33][2] = {{1, 1},   {1, 2},   {1, 3},   {1, 4},   {3, 6},   {5, 7},   {4, 7},
                            {3, 7},   {11, 9},  {10, 9},  {9, 9},   {17, 10}, {16, 10}, {15, 10},
                            {14, 10}, {13, 10}, {12, 10}, {11, 10}, {10, 10}, {9, 10},  {8, 10},
                            {7, 10},  {6, 10},  {5, 10},  {4, 10},  {7, 11},  {6, 11},  {5, 11},
                            {4, 11},  {3, 11},  {2, 11},  {3, 12},  {2, 12}};
// Tables B-13 and B-14: dct_dc_size of luma and chroma
const uint8_t kDcLum[13][2] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3},  {1, 4}, {1, 5},
                               {1, 6}, {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}};
const uint8_t kDcChrom[13][2] = {{3, 2}, {2, 2}, {1, 2}, {1, 3},  {1, 4},  {1, 5}, {1, 6},
                                 {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}, {1, 12}};
const uint8_t kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                             12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                             35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                             58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
const uint8_t kAltHorizontal[64] = {
    0,  1,  2,  3,  8,  9,  16, 17, 10, 11, 4,  5,  6,  7,  15, 14, 13, 12, 19, 18, 24, 25,
    32, 33, 26, 27, 20, 21, 22, 23, 28, 29, 30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37,
    38, 39, 44, 45, 46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
const uint8_t kAltVertical[64] = {
    0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48, 56, 57, 49, 41, 33, 26, 18, 3,  11,
    4,  12, 19, 27, 34, 42, 50, 58, 35, 43, 51, 59, 20, 28, 5,  13, 6,  14, 21, 29, 36, 44,
    52, 60, 37, 45, 53, 61, 22, 30, 7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};
// the default MPEG quantisation matrices (raster order)
const uint8_t kDefaultIntra[64] = {
    8,  17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27, 28, 20, 21, 22, 23, 24, 26,
    28, 30, 21, 22, 23, 24, 26, 28, 30, 32, 22, 23, 24, 26, 28, 30, 32, 35, 23, 24, 26, 28,
    30, 32, 35, 38, 25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32, 35, 38, 41, 45};
const uint8_t kDefaultInter[64] = {
    16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23, 24, 18, 19, 20, 21, 22, 23,
    24, 25, 19, 20, 21, 22, 23, 24, 26, 27, 20, 21, 22, 23, 25, 26, 27, 28, 21, 22, 23, 24,
    26, 27, 28, 30, 22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 27, 28, 30, 31, 33};
// intra_dc_vlc_thr: the DC VLCs serve a macroblock whose QP is below this
const int kDcThreshold[8] = {99, 13, 15, 17, 19, 21, 23, 0};

inline int luma_dc_scale(int q) { return q < 5 ? 8 : q < 9 ? 2 * q : q < 25 ? q + 8 : 2 * q - 16; }
inline int chroma_dc_scale(int q) { return q < 5 ? 8 : q < 25 ? (q + 13) / 2 : q - 6; }
inline int median3(int a, int b, int c) {
  return std::max(std::min(a, b), std::min(std::max(a, b), c));
}
inline uint8_t clip_pixel(int v) { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// ------------------------------------------------------------------ bits

// MSB-first reader over a buffer padded with kPad zero bytes
constexpr size_t kPad = 64;
struct Bits {
  const uint8_t* d = nullptr;
  size_t nbits = 0, pos = 0;
  uint32_t show32() const {
    const uint8_t* p = d + (pos >> 3);
    uint64_t v = uint64_t(p[0]) << 56 | uint64_t(p[1]) << 48 | uint64_t(p[2]) << 40 |
                 uint64_t(p[3]) << 32 | uint64_t(p[4]) << 24;
    return uint32_t((v << (pos & 7)) >> 32);
  }
  // the next 1 <= k <= 32 bits, not consumed
  uint32_t show(int k) const { return show32() >> (32 - k); }
  void skip(int k) { pos += size_t(k); }
  uint32_t u(int k) {
    if (!k) return 0;
    uint32_t v = show(k);
    pos += size_t(k);
    return v;
  }
  uint32_t bit() { return u(1); }
  int left() const { return int(nbits) - int(pos); }
  void check() const {
    if (pos > nbits) corrupt("truncated VOP");
  }
  void align() { pos = (pos + 7) & ~size_t(7); }
  void marker(const char* what) {
    if (!bit()) corrupt(std::string("marker bit missing ") + what);
  }
};

// a prefix code read through a table on its longest code's length: each
// entry (length << 8) | symbol, 0 where no code starts with those bits
struct Vlc {
  int bits = 0;
  std::vector<uint16_t> tab;
  template <typename T>
  Vlc(const T (*codes)[2], int n) {
    for (int i = 0; i < n; i++) bits = std::max(bits, int(codes[i][1]));
    tab.assign(size_t(1) << bits, 0);
    for (int i = 0; i < n; i++) {
      if (!codes[i][1]) continue;
      size_t shift = size_t(bits - codes[i][1]);
      for (size_t k = 0; k < (size_t(1) << shift); k++)
        tab[(size_t(codes[i][0]) << shift) | k] = uint16_t(codes[i][1] << 8 | i);
    }
  }
  int read(Bits& b, const char* what) const {
    uint16_t e = tab[b.show(bits)];
    if (!(e >> 8)) corrupt(std::string("invalid ") + what + " code");
    b.skip(e >> 8);
    return e & 255;
  }
};

// a TCOEF table: its VLC, run and level by index, the index where last = 1
// begins, and the escape modes' LMAX (by last, run) and RMAX (by last,
// level)
struct RunLevel {
  Vlc vlc;
  const uint8_t* run;
  const uint8_t* level;
  int last;
  uint8_t max_level[2][64] = {}, max_run[2][64] = {};
  RunLevel(const uint16_t (*codes)[2], const uint8_t* r, const uint8_t* l, int la)
      : vlc(codes, 103), run(r), level(l), last(la) {
    for (int i = 0; i < 102; i++) {
      int ls = i >= last;
      max_level[ls][run[i]] = std::max(max_level[ls][run[i]], level[i]);
      max_run[ls][level[i]] = std::max(max_run[ls][level[i]], run[i]);
    }
  }
};

struct Tables {
  RunLevel intra{kIntraVlc, kIntraRun, kIntraLevel, kIntraLast};
  RunLevel inter{kInterVlc, kInterRun, kInterLevel, kInterLast};
  Vlc inter_mcbpc{kInterMcbpc, 28}, intra_mcbpc{kIntraMcbpc, 9}, cbpy{kCbpy, 16}, mv{kMv, 33},
      dc_lum{kDcLum, 13}, dc_chrom{kDcChrom, 13};
};
const Tables& tables() {
  static const Tables t;
  return t;
}

// ------------------------------------------------------------------ IDCT

// FFmpeg's simple IDCT (simple_idct_template.c, 8 bits): rows then
// columns, each row that holds only its DC taking the shortcut
constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867,
              W7 = 4520;
constexpr int ROW_SHIFT = 11, COL_SHIFT = 20;

inline void idct_row(int16_t* row) {
  uint64_t lo, hi;
  memcpy(&lo, row, 8);
  memcpy(&hi, row + 4, 8);
  if (!(lo & ~uint64_t(0xffff)) && !hi) {
    int16_t t = int16_t(uint16_t(row[0] * 8));
    for (int i = 0; i < 8; i++) row[i] = t;
    return;
  }
  unsigned a0 = unsigned(W4 * row[0]) + (1u << (ROW_SHIFT - 1));
  unsigned a1 = a0, a2 = a0, a3 = a0;
  a0 += unsigned(W2 * row[2]);
  a1 += unsigned(W6 * row[2]);
  a2 -= unsigned(W6 * row[2]);
  a3 -= unsigned(W2 * row[2]);
  unsigned b0 = unsigned(W1 * row[1]) + unsigned(W3 * row[3]);
  unsigned b1 = unsigned(W3 * row[1]) - unsigned(W7 * row[3]);
  unsigned b2 = unsigned(W5 * row[1]) - unsigned(W1 * row[3]);
  unsigned b3 = unsigned(W7 * row[1]) - unsigned(W5 * row[3]);
  if (hi) {
    a0 += unsigned(W4 * row[4] + W6 * row[6]);
    a1 += unsigned(-W4 * row[4] - W2 * row[6]);
    a2 += unsigned(-W4 * row[4] + W2 * row[6]);
    a3 += unsigned(W4 * row[4] - W6 * row[6]);
    b0 += unsigned(W5 * row[5]) + unsigned(W7 * row[7]);
    b1 += unsigned(-W1 * row[5]) + unsigned(-W5 * row[7]);
    b2 += unsigned(W7 * row[5]) + unsigned(W3 * row[7]);
    b3 += unsigned(W3 * row[5]) + unsigned(-W1 * row[7]);
  }
  row[0] = int16_t(int(a0 + b0) >> ROW_SHIFT);
  row[7] = int16_t(int(a0 - b0) >> ROW_SHIFT);
  row[1] = int16_t(int(a1 + b1) >> ROW_SHIFT);
  row[6] = int16_t(int(a1 - b1) >> ROW_SHIFT);
  row[2] = int16_t(int(a2 + b2) >> ROW_SHIFT);
  row[5] = int16_t(int(a2 - b2) >> ROW_SHIFT);
  row[3] = int16_t(int(a3 + b3) >> ROW_SHIFT);
  row[4] = int16_t(int(a3 - b3) >> ROW_SHIFT);
}

// column i of the block: out[k] for rows k = 0..7
inline void idct_col(const int16_t* col, int* out) {
  unsigned a0 = unsigned(W4 * (col[0] + ((1 << (COL_SHIFT - 1)) / W4)));
  unsigned a1 = a0, a2 = a0, a3 = a0;
  a0 += unsigned(W2 * col[16]);
  a1 += unsigned(W6 * col[16]);
  a2 += unsigned(-W6 * col[16]);
  a3 += unsigned(-W2 * col[16]);
  unsigned b0 = unsigned(W1 * col[8]) + unsigned(W3 * col[24]);
  unsigned b1 = unsigned(W3 * col[8]) + unsigned(-W7 * col[24]);
  unsigned b2 = unsigned(W5 * col[8]) + unsigned(-W1 * col[24]);
  unsigned b3 = unsigned(W7 * col[8]) + unsigned(-W5 * col[24]);
  if (col[32]) {
    a0 += unsigned(W4 * col[32]);
    a1 += unsigned(-W4 * col[32]);
    a2 += unsigned(-W4 * col[32]);
    a3 += unsigned(W4 * col[32]);
  }
  if (col[40]) {
    b0 += unsigned(W5 * col[40]);
    b1 += unsigned(-W1 * col[40]);
    b2 += unsigned(W7 * col[40]);
    b3 += unsigned(W3 * col[40]);
  }
  if (col[48]) {
    a0 += unsigned(W6 * col[48]);
    a1 += unsigned(-W2 * col[48]);
    a2 += unsigned(W2 * col[48]);
    a3 += unsigned(-W6 * col[48]);
  }
  if (col[56]) {
    b0 += unsigned(W7 * col[56]);
    b1 += unsigned(-W5 * col[56]);
    b2 += unsigned(W3 * col[56]);
    b3 += unsigned(-W1 * col[56]);
  }
  out[0] = int(a0 + b0) >> COL_SHIFT;
  out[1] = int(a1 + b1) >> COL_SHIFT;
  out[2] = int(a2 + b2) >> COL_SHIFT;
  out[3] = int(a3 + b3) >> COL_SHIFT;
  out[4] = int(a3 - b3) >> COL_SHIFT;
  out[5] = int(a2 - b2) >> COL_SHIFT;
  out[6] = int(a1 - b1) >> COL_SHIFT;
  out[7] = int(a0 - b0) >> COL_SHIFT;
}

// the IDCT of block (raster order, transformed in place) put into or added
// to the 8x8 samples at dst
void idct(int16_t* block, uint8_t* dst, ptrdiff_t stride, bool add) {
  for (int i = 0; i < 8; i++) idct_row(block + 8 * i);
  int out[8];
  for (int i = 0; i < 8; i++) {
    idct_col(block + i, out);
    for (int k = 0; k < 8; k++) {
      uint8_t& p = dst[k * stride + i];
      p = clip_pixel(add ? p + out[k] : out[k]);
    }
  }
}

// ------------------------------------------------------------------ pictures

struct Frame {
  int mbw = 0, mbh = 0, width = 0, height = 0;
  std::vector<uint8_t> y, u, v;  // luma stride mbw * 16, chroma mbw * 8
  char kind = 'I';
  double ms = 0;
  int matrix = 2;
  bool full_range = false;
  void alloc(int w, int h) {
    width = w;
    height = h;
    mbw = (w + 15) / 16;
    mbh = (h + 15) / 16;
    y.assign(size_t(mbw) * 16 * mbh * 16, 0);
    u.assign(size_t(mbw) * 8 * mbh * 8, 0);
    v.assign(size_t(mbw) * 8 * mbh * 8, 0);
  }
};
using FramePtr = std::shared_ptr<Frame>;

// the w x h block of ref (plane of pw x ph samples, stride pw) at (x, y)
// and its half-sample neighbours as put_pixels / put_no_rnd_pixels form
// them (dxy: bit 0 horizontal, bit 1 vertical half), samples outside the
// plane clamped to its edge
void predict(const uint8_t* ref, int pw, int ph, int x, int y, int dxy, bool no_rnd, int w,
             int h, uint8_t* dst, ptrdiff_t ds) {
  uint8_t tmp[17 * 17];
  const uint8_t* src;
  ptrdiff_t ss;
  int need_w = w + (dxy & 1), need_h = h + (dxy >> 1);
  if (x >= 0 && y >= 0 && x + need_w <= pw && y + need_h <= ph) {
    src = ref + ptrdiff_t(y) * pw + x;
    ss = pw;
  } else {
    for (int r = 0; r < need_h; r++) {
      int yy = std::min(std::max(y + r, 0), ph - 1);
      for (int c = 0; c < need_w; c++) {
        int xx = std::min(std::max(x + c, 0), pw - 1);
        tmp[r * 17 + c] = ref[ptrdiff_t(yy) * pw + xx];
      }
    }
    src = tmp;
    ss = 17;
  }
  // put_no_rnd's horizontal and vertical halves of an 8-wide block as
  // libavcodec's x86 code forms them outside AV_CODEC_FLAG_BITEXACT: pavgb
  // of the other sample and one less the left (or odd-row) sample,
  // saturated at 0 (its 16-wide ones are exact)
  int rnd = no_rnd ? 0 : 1;
  bool approx = no_rnd && w == 8;
  switch (dxy) {
    case 0:
      for (int r = 0; r < h; r++) memcpy(dst + r * ds, src + r * ss, size_t(w));
      break;
    case 1:
      for (int r = 0; r < h; r++)
        for (int c = 0; c < w; c++) {
          int a = src[r * ss + c], b = src[r * ss + c + 1];
          if (approx) a = a ? a - 1 : 0;
          dst[r * ds + c] = uint8_t((a + b + rnd + approx) >> 1);
        }
      break;
    case 2:
      for (int r = 0; r < h; r++)
        for (int c = 0; c < w; c++) {
          int a = src[r * ss + c], b = src[(r + 1) * ss + c];
          if (approx) {
            int& odd = r & 1 ? a : b;
            odd = odd ? odd - 1 : 0;
          }
          dst[r * ds + c] = uint8_t((a + b + rnd + approx) >> 1);
        }
      break;
    default:
      for (int r = 0; r < h; r++)
        for (int c = 0; c < w; c++)
          dst[r * ds + c] = uint8_t((src[r * ss + c] + src[r * ss + c + 1] + src[(r + 1) * ss + c] +
                                     src[(r + 1) * ss + c + 1] + 1 + rnd) >> 2);
  }
}

// ------------------------------------------------------------------ decoder

struct Decoder {
  // visual object sequence / visual object
  int matrix = 2;
  bool full_range = false;
  // video object layer
  bool have_vol = false;
  int vo_type = 0, vol_control = 0, low_delay = 1;
  int width = 0, height = 0, mbw = 0, mbh = 0, mb_num = 0;
  int time_bits = 1, quant_precision = 5;
  bool mpeg_quant = false, resync_marker = false;
  uint8_t intra_matrix[64], inter_matrix[64];
  // user data
  int lavc_build = -1, xvid_build = -1, divx_version = -1;
  int pictures = 0;
  // VOP
  int pict_type = 1;  // 1 I, 2 P
  bool no_rounding = false;
  int dc_thr = 99, qscale = 1, f_code = 1;
  // macroblock state
  int mb_x = 0, mb_y = 0, resync_x = 0, resync_y = 0;
  bool first_slice_line = true;
  // predictors, libavcodec's layout: luma blocks on a grid of stride
  // 2 * mbw + 1, chroma macroblocks of stride mbw + 1, each with a row and
  // a column (the last of the row above) that stay at their initial value
  int ls = 0, cs = 0;
  std::vector<int16_t> dc_base, ac_base, mv_base;  // dc: Y, Cb, Cr; ac: 16 a block
  int16_t *dc_y = nullptr, *dc_c[2] = {nullptr, nullptr};
  int16_t *ac_y = nullptr, *ac_c[2] = {nullptr, nullptr};
  int16_t* mv = nullptr;  // [block][2] on the luma grid
  std::vector<int8_t> qtab;  // per macroblock (stride mbw + 1)
  FramePtr cur, ref;
  bool skipped_last = false;

  void set_qscale(int q) { qscale = std::min(std::max(q, 1), 31); }

  void alloc_state() {
    mbw = (width + 15) / 16;
    mbh = (height + 15) / 16;
    mb_num = mbw * mbh;
    ls = 2 * mbw + 1;
    cs = mbw + 1;
    size_t ysz = size_t(ls) * (2 * mbh + 1) + 1, csz = size_t(cs) * (mbh + 1) + 1;
    dc_base.assign(ysz + 2 * csz, 1024);
    ac_base.assign((ysz + 2 * csz) * 16, 0);
    mv_base.assign(ysz * 2, 0);
    dc_y = dc_base.data() + ls + 1;
    dc_c[0] = dc_base.data() + ysz + cs + 1;
    dc_c[1] = dc_c[0] + csz;
    ac_y = ac_base.data() + (ls + 1) * 16;
    ac_c[0] = ac_base.data() + (ysz + cs + 1) * 16;
    ac_c[1] = ac_c[0] + csz * 16;
    mv = mv_base.data() + (ls + 1) * 2;
    qtab.assign(size_t(cs) * mbh, 0);
    ref.reset();
  }

  // ---------------------------------------------------------- headers

  void user_data(Bits& b) {
    char buf[256];
    int i = 0;
    for (; i < 255 && b.pos < b.nbits; i++) {
      if (b.left() >= 23 && b.show(23) == 0) break;
      if (b.left() < 8) break;
      buf[i] = char(b.u(8));
    }
    buf[i] = 0;
    int ver = 0, ver2 = 0, ver3 = 0, build = 0;
    char last = 0;
    int e = sscanf(buf, "DivX%dBuild%d%c", &ver, &build, &last);
    if (e < 2) e = sscanf(buf, "DivX%db%d%c", &ver, &build, &last);
    if (e >= 2) divx_version = ver;
    e = sscanf(buf, "FFmpe%*[^b]b%d", &build) + 3;
    if (e != 4) e = sscanf(buf, "FFmpeg v%d.%d.%d / libavcodec build: %d", &ver, &ver2, &ver3, &build);
    if (e != 4) {
      e = sscanf(buf, "Lavc%d.%d.%d", &ver, &ver2, &ver3) + 1;
      if (e > 1) build = ((ver & 0xFF) << 16) + ((ver2 & 0xFF) << 8) + (ver3 & 0xFF);
    }
    if (e != 4 && strcmp(buf, "ffmpeg") == 0) lavc_build = 4600;
    if (e == 4) lavc_build = build;
    if (sscanf(buf, "XviD%d", &build) == 1) xvid_build = build;
  }

  void visual_object(Bits& b) {
    if (b.bit()) b.skip(7);  // is_visual_object_identifier: verid, priority
    int type = int(b.u(4));
    if (type == 1 || type == 2) {  // video, still texture
      if (b.bit()) {               // video_signal_type
        b.skip(3);                 // video_format
        full_range = b.bit();
        if (b.bit()) {  // colour_description
          b.skip(16);   // colour_primaries, transfer_characteristics
          matrix = int(b.u(8));
          if (matrix >= 8)
            refuse("matrix_coefficients " + std::to_string(matrix) +
                   " (a colour matrix cv2 does not convert)");
        }
      }
    }
  }

  void vol_header(Bits& b) {
    b.skip(1);  // random_accessible_vol
    vo_type = int(b.u(8));
    if (vo_type == 0x0E || vo_type == 0x0F) refuse("a studio profile VOL (bit depths other than 8)");
    int verid = 1;
    if (b.bit()) {
      verid = int(b.u(4));
      b.skip(3);
    }
    if (b.u(4) == 15) b.skip(16);  // extended PAR
    if ((vol_control = int(b.bit()))) {
      if (b.u(2) != 1) refuse("chroma other than 4:2:0");
      low_delay = int(b.bit());
      if (b.bit()) {  // vbv_parameters
        b.skip(15);
        b.marker("in the VBV parameters");
        b.skip(15);
        b.marker("in the VBV parameters");
        b.skip(15);
        b.marker("in the VBV parameters");
        b.skip(3 + 11);
        b.marker("in the VBV parameters");
        b.skip(15);
        b.marker("in the VBV parameters");
      }
    } else if (pictures == 0) {
      low_delay = vo_type == 1 || vo_type == 17 || vo_type == 0 ? 1 : 0;
    }
    int shape = int(b.u(2));
    if (shape != 0) refuse("non-rectangular shape (video_object_layer_shape " +
                           std::to_string(shape) + ")");
    b.marker("before vop_time_increment_resolution");
    int res = int(b.u(16));
    if (!res) corrupt("vop_time_increment_resolution 0");
    time_bits = 1;
    while ((1 << time_bits) < res) time_bits++;
    b.marker("before fixed_vop_rate");
    if (b.bit()) b.skip(time_bits);  // fixed_vop_time_increment
    b.marker("before the VOL width");
    int w = int(b.u(13));
    b.marker("before the VOL height");
    int h = int(b.u(13));
    b.marker("after the VOL height");
    if (b.bit()) refuse("an interlaced VOL");
    b.skip(1);  // obmc_disable (libavcodec decodes as if it were set)
    int sprite = int(verid == 1 ? b.bit() : b.u(2));
    if (sprite) refuse("sprites (static or GMC, sprite_enable " + std::to_string(sprite) + ")");
    quant_precision = 5;
    if (b.bit()) {  // not_8_bit
      int qp = int(b.u(4)), bpp = int(b.u(4));
      if (bpp != 8) refuse("bit depth " + std::to_string(bpp) + " (bit depths other than 8)");
      quant_precision = qp < 3 || qp > 9 ? 5 : qp;
    }
    mpeg_quant = b.bit();
    memcpy(intra_matrix, kDefaultIntra, 64);
    memcpy(inter_matrix, kDefaultInter, 64);
    if (mpeg_quant) {
      for (uint8_t* m : {intra_matrix, inter_matrix}) {
        if (!b.bit()) continue;  // load_*_quant_mat
        int i = 0, last = 0;
        for (; i < 64; i++) {
          if (b.left() < 8) corrupt("truncated quantisation matrix");
          int v = int(b.u(8));
          if (!v) break;
          last = v;
          m[kZigzag[i]] = uint8_t(v);
        }
        for (; i < 64; i++) m[kZigzag[i]] = uint8_t(last);
      }
    }
    if (verid != 1 && b.bit()) refuse("quarter-sample motion");
    if (!b.bit()) refuse("a complexity estimation header");
    resync_marker = !b.bit();
    if (b.bit()) {
      bool rvlc = b.bit();
      refuse(std::string("data partitioning") + (rvlc ? " with reversible VLC" : ""));
    }
    if (verid != 1) {
      if (b.bit()) refuse("NEWPRED");
      if (b.bit()) refuse("reduced-resolution VOPs");
    }
    if (b.bit()) refuse("scalability");
    b.check();
    if (w <= 0 || h <= 0) corrupt("VOL of size 0");
    // cv2's libswscale converts a frame of odd width or height by another
    // path than the one yuv420_bgr.h reproduces (cv2's own writer rounds
    // such sizes down to even)
    if ((w | h) & 1)
      refuse("an odd VOL width or height (" + std::to_string(w) + "x" + std::to_string(h) + ")");
    if (!have_vol || w != width || h != height) {
      width = w;
      height = h;
      alloc_state();
    }
    have_vol = true;
  }

  // libavcodec's workarounds by the encoder its user data names
  void check_encoder() const {
    if (xvid_build >= 0) refuse("an Xvid stream (user data XviD" + std::to_string(xvid_build) + ")");
    if (divx_version >= 0) refuse("a DivX stream (user data DivX" + std::to_string(divx_version) + ")");
    unsigned b = unsigned(lavc_build);
    if (lavc_build >= 0 && (b <= 4712 || ((b & 0xFF) >= 100 && b > 3621476 && b < 3752552 &&
                                          (b < 3752037 || b > 3752191))))
      refuse("a Lavc / FFmpeg build libavcodec works around (build " + std::to_string(b) + ")");
  }

  // the start codes of d (a header block or a sample) up to and into its
  // first VOP: true with b at the VOP header's first bit, false if there is
  // none
  bool headers(Bits& b) {
    b.align();
    uint32_t sc = 0xff;
    bool vol = false;
    while (b.pos + 8 <= b.nbits) {
      sc = (sc << 8 | b.u(8)) & 0xffffffff;
      if ((sc & 0xFFFFFF00) != 0x100) continue;
      if (sc >= 0x120 && sc <= 0x12F) {
        if (!vol) vol_header(b);
        vol = true;
      } else if (sc == 0x1B2) {
        user_data(b);
      } else if (sc == 0x1B0) {  // visual_object_sequence: profile_and_level_indication
        int profile = int(b.u(4)), level = int(b.u(4));
        if (profile == 14 && level > 0 && level < 9)
          refuse("the simple studio profile (bit depths other than 8)");
      } else if (sc == 0x1B5) {
        visual_object(b);
      } else if (sc == 0x1B6) {
        return true;
      }
      b.align();
      sc = 0xff;
    }
    return false;
  }

  // ---------------------------------------------------------- VOP

  // a VOP's header after its start code; false for an N-VOP
  bool vop_header(Bits& b) {
    if (!have_vol) corrupt("a VOP before any VOL header");
    int type = int(b.u(2));
    if (type == 2) refuse("B-VOPs");
    if (type == 3) refuse("S(GMC)-VOPs");
    pict_type = type + 1;
    while (b.bit()) {
      if (b.left() <= 0) corrupt("truncated VOP header");
    }
    b.marker("before vop_time_increment");
    b.skip(time_bits);
    b.marker("before vop_coded");
    if (!b.bit()) {
      b.check();
      return false;
    }
    no_rounding = pict_type == 2 ? b.bit() : false;
    dc_thr = kDcThreshold[b.u(3)];
    int q = int(b.u(quant_precision));
    if (!q) corrupt("vop_quant 0");
    set_qscale(q);
    f_code = 1;
    if (pict_type == 2) {
      f_code = int(b.u(3));
      if (!f_code) corrupt("vop_fcode_forward 0");
    }
    b.check();
    return true;
  }

  // libavcodec's ff_mpeg4_get_video_packet_prefix_length
  int resync_len() const { return pict_type == 1 ? 16 : f_code + 15; }

  // after a macroblock: whether a video packet starts next (its stuffing,
  // then a resync marker), as mpeg4_is_resync reads it
  bool at_resync(Bits& b) {
    while (b.left() >= 16) {
      uint32_t v = b.show(16);
      if (v > 0xFF || (v >> (8 - pict_type)) != 1) break;
      b.skip(8 + pict_type);  // macroblock stuffing
    }
    if (b.left() < 16 + 8) return false;
    static const uint16_t kPrefix[8] = {0x7F00, 0x7E00, 0x7C00, 0x7800,
                                        0x7000, 0x6000, 0x4000, 0x0000};
    if (b.show(16) != kPrefix[b.pos & 7]) return false;
    Bits t = b;
    t.skip(1);
    t.align();
    int len = 0;
    while (len < 32 && !t.bit()) len++;
    return len >= resync_len();
  }

  // the video packet header after the stuffing: returns the packet's first
  // macroblock
  int packet_header(Bits& b) {
    b.skip(1);
    b.align();
    int len = 0;
    while (len < 32 && !b.bit()) len++;
    if (len != resync_len()) corrupt("resync marker does not match vop_fcode");
    int bits = 1;
    while ((1 << bits) < mb_num) bits++;
    int mb = int(b.u(bits));
    if (mb <= 0 || mb >= mb_num) corrupt("video packet's macroblock_number out of range");
    int q = int(b.u(quant_precision));
    if (q) set_qscale(q);
    if (b.bit()) {  // header_extension_code
      while (b.bit()) {
        if (b.left() <= 0) corrupt("truncated video packet header");
      }
      b.marker("before the packet's vop_time_increment");
      b.skip(time_bits);
      b.marker("after the packet's vop_time_increment");
      b.skip(2 + 3);  // vop_coding_type, intra_dc_vlc_thr (ignored)
      if (pict_type == 2 && !b.u(3)) corrupt("video packet's vop_fcode_forward 0");
    }
    b.check();
    return mb;
  }

  // libavcodec's ff_mpeg4_clean_buffers at a video packet's start
  void clean_buffers() {
    int l_xy = (2 * mb_y - 1) * ls + 2 * mb_x - 1;
    std::fill(ac_y + l_xy * 16, ac_y + (l_xy + 2 * ls + 1) * 16, int16_t(0));
    int c_xy = (mb_y - 1) * cs + mb_x - 1;
    for (int c = 0; c < 2; c++)
      std::fill(ac_c[c] + c_xy * 16, ac_c[c] + (c_xy + cs + 1) * 16, int16_t(0));
  }

  // ---------------------------------------------------------- blocks

  // the DC predictor of block n (0-3 luma, 4-5 chroma) of the current MB,
  // libavcodec's ff_mpeg4_pred_dc: stores the block's DC (level * scale,
  // clipped to 0..2047) and returns level + predictor; *dir 1 from above,
  // 0 from the left
  int pred_dc(int n, int level, int* dir) {
    int scale = n < 4 ? luma_dc_scale(qscale) : chroma_dc_scale(qscale);
    int16_t* dc;
    int wrap;
    if (n < 4) {
      dc = dc_y + (2 * mb_y + (n >> 1)) * ls + 2 * mb_x + (n & 1);
      wrap = ls;
    } else {
      dc = dc_c[n - 4] + mb_y * cs + mb_x;
      wrap = cs;
    }
    int a = dc[-1], bb = dc[-1 - wrap], c = dc[-wrap];
    if (first_slice_line && n != 3) {
      if (n != 2) bb = c = 1024;
      if (n != 1 && mb_x == resync_x) bb = a = 1024;
    }
    if (mb_x == resync_x && mb_y == resync_y + 1 && (n == 0 || n == 4 || n == 5)) bb = 1024;
    int pred;
    if (std::abs(a - bb) < std::abs(bb - c)) {
      pred = c;
      *dir = 1;
    } else {
      pred = a;
      *dir = 0;
    }
    pred = (pred + (scale >> 1)) / scale;
    level += pred;
    int stored = level * scale;
    if (stored & ~2047) stored = stored < 0 ? 0 : 2047;
    dc[0] = int16_t(stored);
    return level;
  }

  // libavcodec's ff_mpeg4_pred_ac: adds the predicted first row or column
  // (ac_pred) and stores the block's own
  void pred_ac(int16_t* block, int n, int dir, bool ac_pred) {
    int16_t* ac;
    int wrap;
    if (n < 4) {
      ac = ac_y + ((2 * mb_y + (n >> 1)) * ls + 2 * mb_x + (n & 1)) * 16;
      wrap = ls;
    } else {
      ac = ac_c[n - 4] + (mb_y * cs + mb_x) * 16;
      wrap = cs;
    }
    if (ac_pred) {
      if (dir == 0) {
        const int16_t* p = ac - 16;
        int q = mb_x > 0 ? qtab[size_t(mb_y * cs + mb_x - 1)] : 0;
        if (mb_x == 0 || qscale == q || n == 1 || n == 3) {
          for (int i = 1; i < 8; i++) block[i * 8] = int16_t(block[i * 8] + p[i]);
        } else {
          for (int i = 1; i < 8; i++) block[i * 8] = int16_t(block[i * 8] + rounded_div(p[i] * q));
        }
      } else {
        const int16_t* p = ac - 16 * wrap;
        int q = mb_y > 0 ? qtab[size_t((mb_y - 1) * cs + mb_x)] : 0;
        if (mb_y == 0 || qscale == q || n == 2 || n == 3) {
          for (int i = 1; i < 8; i++) block[i] = int16_t(block[i] + p[i + 8]);
        } else {
          for (int i = 1; i < 8; i++) block[i] = int16_t(block[i] + rounded_div(p[i + 8] * q));
        }
      }
    }
    for (int i = 1; i < 8; i++) ac[i] = block[i * 8];
    for (int i = 1; i < 8; i++) ac[8 + i] = block[i];
  }
  int rounded_div(int a) const {
    return (a >= 0 ? a + (qscale >> 1) : a - (qscale >> 1)) / qscale;
  }

  // one block's coefficients (mpeg4_decode_block): into block (raster
  // order, zeroed), returns the last coefficient's scan index (-1 none);
  // inter blocks under H.263 quantisation come out dequantised
  int decode_block(Bits& b, int16_t* block, int n, bool coded, bool intra, bool dc_vlc,
                   bool ac_pred, int* dc_dir) {
    const Tables& T = tables();
    int i, qmul = 1, qadd = 0;
    const uint8_t* scan = kZigzag;
    const RunLevel* rl;
    if (intra) {
      if (dc_vlc) {
        int size = (n < 4 ? T.dc_lum : T.dc_chrom).read(b, "dct_dc_size");
        if (size > 9) corrupt("dct_dc_size above 9");
        int level = 0;
        if (size) {
          uint32_t v = b.u(size);
          level = (v >> (size - 1)) ? int(v) : int(v) - ((1 << size) - 1);
          if (size > 8) b.marker("after dct_dc_differential");
        }
        level = pred_dc(n, level, dc_dir);
        // libavcodec takes a negative DC level for an error code
        if (level < 0) corrupt("a negative intra DC level");
        block[0] = int16_t(level);
        i = 0;
      } else {
        i = -1;
        pred_dc(n, 0, dc_dir);
      }
      rl = &T.intra;
      if (ac_pred) scan = *dc_dir == 0 ? kAltVertical : kAltHorizontal;
    } else {
      i = -1;
      rl = &T.inter;
      if (!mpeg_quant) {
        qmul = qscale << 1;
        qadd = (qscale - 1) | 1;
      }
    }
    if (coded) {
      for (;;) {
        int sym = rl->vlc.read(b, "TCOEF");
        int run, level, last;
        if (sym != kEscape) {
          run = rl->run[sym];
          last = sym >= rl->last;
          level = rl->level[sym] * qmul + qadd;
          if (b.bit()) level = -level;
        } else if (!b.bit()) {  // escape 1: level + LMAX
          sym = rl->vlc.read(b, "TCOEF");
          if (sym == kEscape) corrupt("escape within an escape");
          run = rl->run[sym];
          last = sym >= rl->last;
          level = rl->level[sym] * qmul + qadd + rl->max_level[last][run] * qmul;
          if (b.bit()) level = -level;
        } else if (!b.bit()) {  // escape 2: run + RMAX + 1
          sym = rl->vlc.read(b, "TCOEF");
          if (sym == kEscape) corrupt("escape within an escape");
          last = sym >= rl->last;
          run = rl->run[sym] + rl->max_run[last][rl->level[sym]] + 1;
          level = rl->level[sym] * qmul + qadd;
          if (b.bit()) level = -level;
        } else {  // escape 3: fixed-length last, run and level
          last = int(b.bit());
          run = int(b.u(6));
          b.marker("before an escaped level");
          level = int(int32_t(b.u(12) << 20) >> 20);
          b.marker("after an escaped level");
          level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
          if (level < -2048) level = -2048;
          if (level > 2047) level = 2047;
        }
        i += run + 1;
        if (i > 63) corrupt("TCOEF run beyond the block");
        block[scan[i]] = int16_t(level);
        if (b.pos > b.nbits) corrupt("truncated VOP");
        if (last) break;
        if (i == 63) corrupt("TCOEF at the block's end without last");
      }
    }
    if (intra) {
      if (!dc_vlc) {
        block[0] = int16_t(pred_dc(n, block[0], dc_dir));
        if (i < 0) i = 0;
      }
      pred_ac(block, n, *dc_dir, ac_pred);
      if (ac_pred) i = 63;
    }
    return i;
  }

  // libavcodec's dequantisation of an intra block (dct_unquantize_*_intra)
  void unquant_intra(int16_t* block, int n, int last, bool ac_pred) {
    int scale = n < 4 ? luma_dc_scale(qscale) : chroma_dc_scale(qscale);
    block[0] = int16_t(block[0] * scale);
    if (mpeg_quant) {
      int q2 = qscale << 1;
      for (int k = 1; k <= last; k++) {
        int j = kZigzag[k], level = block[j];
        if (!level) continue;
        int a = (std::abs(level) * q2 * intra_matrix[j]) >> 4;
        block[j] = int16_t(level < 0 ? -a : a);
      }
    } else {
      int qmul = qscale << 1, qadd = (qscale - 1) | 1;
      int end = ac_pred ? 63 : last;
      for (int k = 1; k <= end; k++) {
        int j = ac_pred ? k : kZigzag[k], level = block[j];
        if (!level) continue;
        block[j] = int16_t(level < 0 ? level * qmul - qadd : level * qmul + qadd);
      }
    }
  }

  // of an inter block under MPEG quantisation (dct_unquantize_mpeg2_inter,
  // with its mismatch control)
  void unquant_inter_mpeg(int16_t* block, int last) {
    int q2 = qscale << 1, sum = -1;
    for (int k = 0; k <= last; k++) {
      int j = kZigzag[k], level = block[j];
      if (!level) continue;
      int a = (((std::abs(level) << 1) + 1) * q2 * inter_matrix[j]) >> 5;
      level = level < 0 ? -a : a;
      block[j] = int16_t(level);
      sum += level;
    }
    block[63] = int16_t(block[63] ^ (sum & 1));
  }

  // ---------------------------------------------------------- motion

  // libavcodec's ff_h263_pred_motion of luma block `blk` of the current MB
  void pred_motion(int blk, int* px, int* py) {
    static const int off[4] = {2, 1, 1, -1};
    int16_t* mv0 = mv + ((2 * mb_y + (blk >> 1)) * ls + 2 * mb_x + (blk & 1)) * 2;
    int16_t* A = mv0 - 2;
    if (first_slice_line && blk < 3) {
      if (blk == 0) {
        if (mb_x == resync_x) {
          *px = *py = 0;
        } else if (mb_x + 1 == resync_x) {
          const int16_t* C = mv0 + (off[blk] - ls) * 2;
          if (mb_x == 0) {
            *px = C[0];
            *py = C[1];
          } else {
            *px = median3(A[0], 0, C[0]);
            *py = median3(A[1], 0, C[1]);
          }
        } else {
          *px = A[0];
          *py = A[1];
        }
      } else if (blk == 1) {
        if (mb_x + 1 == resync_x) {
          const int16_t* C = mv0 + (off[blk] - ls) * 2;
          *px = median3(A[0], 0, C[0]);
          *py = median3(A[1], 0, C[1]);
        } else {
          *px = A[0];
          *py = A[1];
        }
      } else {
        const int16_t* B = mv0 - ls * 2;
        const int16_t* C = mv0 + (off[blk] - ls) * 2;
        if (mb_x == resync_x) A[0] = A[1] = 0;
        *px = median3(A[0], B[0], C[0]);
        *py = median3(A[1], B[1], C[1]);
      }
    } else {
      const int16_t* B = mv0 - ls * 2;
      const int16_t* C = mv0 + (off[blk] - ls) * 2;
      *px = median3(A[0], B[0], C[0]);
      *py = median3(A[1], B[1], C[1]);
    }
  }

  int decode_motion(Bits& b, int pred) {
    int code = tables().mv.read(b, "motion_code");
    if (code == 0) return pred;
    bool sign = b.bit();
    int shift = f_code - 1, val = code;
    if (shift) {
      val = (val - 1) << shift;
      val |= int(b.u(shift));
      val++;
    }
    if (sign) val = -val;
    val += pred;
    int bits = 5 + f_code;  // modulo: sign-extend to 5 + f_code bits
    return int(unsigned(val) << (32 - bits)) >> (32 - bits);
  }

  // the prediction of the current MB into cur from ref: one vector
  // (mvs[0]) or four (4MV)
  void motion(const int (*mvs)[2], bool four) {
    Frame& R = *ref;
    Frame& C = *cur;
    int pw = mbw * 16, ph = mbh * 16, cw = mbw * 8, ch = mbh * 8;
    uint8_t* dy = &C.y[size_t(mb_y * 16) * pw + mb_x * 16];
    size_t coff = size_t(mb_y * 8) * cw + mb_x * 8;
    if (!four) {
      int mx = mvs[0][0], my = mvs[0][1];
      int dxy = ((my & 1) << 1) | (mx & 1);
      int sx = mb_x * 16 + (mx >> 1), sy = mb_y * 16 + (my >> 1);
      predict(R.y.data(), pw, ph, sx, sy, dxy, no_rounding, 16, 16, dy, pw);
      int uvdxy = dxy | (my & 2) | ((mx & 2) >> 1);
      int ux = sx >> 1, uy = sy >> 1;
      predict(R.u.data(), cw, ch, ux, uy, uvdxy, no_rounding, 8, 8, &C.u[coff], cw);
      predict(R.v.data(), cw, ch, ux, uy, uvdxy, no_rounding, 8, 8, &C.v[coff], cw);
      return;
    }
    int sum_x = 0, sum_y = 0;
    for (int i = 0; i < 4; i++) {
      int mx = mvs[i][0], my = mvs[i][1];
      int sx = mb_x * 16 + (i & 1) * 8 + (mx >> 1), sy = mb_y * 16 + (i >> 1) * 8 + (my >> 1);
      int dxy = 0;
      sx = std::min(std::max(sx, -16), width);
      if (sx != width) dxy |= mx & 1;
      sy = std::min(std::max(sy, -16), height);
      if (sy != height) dxy |= (my & 1) << 1;
      predict(R.y.data(), pw, ph, sx, sy, dxy, no_rounding, 8, 8,
              dy + (i >> 1) * 8 * pw + (i & 1) * 8, pw);
      sum_x += mx;
      sum_y += my;
    }
    static const uint8_t kRound[16] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2};
    int mx = kRound[sum_x & 15] + ((sum_x >> 3) & ~1);
    int my = kRound[sum_y & 15] + ((sum_y >> 3) & ~1);
    int dxy = ((my & 1) << 1) | (mx & 1);
    int sx = mb_x * 8 + (mx >> 1), sy = mb_y * 8 + (my >> 1);
    sx = std::min(std::max(sx, -8), width >> 1);
    if (sx == (width >> 1)) dxy &= ~1;
    sy = std::min(std::max(sy, -8), height >> 1);
    if (sy == (height >> 1)) dxy &= ~2;
    predict(R.u.data(), cw, ch, sx, sy, dxy, no_rounding, 8, 8, &C.u[coff], cw);
    predict(R.v.data(), cw, ch, sx, sy, dxy, no_rounding, 8, 8, &C.v[coff], cw);
  }

  // ---------------------------------------------------------- macroblocks

  uint8_t* block_dst(int n, ptrdiff_t* stride) {
    Frame& C = *cur;
    if (n < 4) {
      *stride = mbw * 16;
      return &C.y[size_t(mb_y * 16 + (n >> 1) * 8) * (mbw * 16) + mb_x * 16 + (n & 1) * 8];
    }
    *stride = mbw * 8;
    return &(n == 4 ? C.u : C.v)[size_t(mb_y * 8) * (mbw * 8) + mb_x * 8];
  }

  void clean_intra_entries() {
    int xy = 2 * mb_y * ls + 2 * mb_x;
    for (int r = 0; r < 2; r++) {
      dc_y[xy + r * ls] = dc_y[xy + r * ls + 1] = 1024;
      std::fill(ac_y + (xy + r * ls) * 16, ac_y + (xy + r * ls + 2) * 16, int16_t(0));
    }
    int c = mb_y * cs + mb_x;
    for (int k = 0; k < 2; k++) {
      dc_c[k][c] = 1024;
      std::fill(ac_c[k] + c * 16, ac_c[k] + (c + 1) * 16, int16_t(0));
    }
  }

  void set_mvs(int x, int y) {
    int16_t* m = mv + (2 * mb_y * ls + 2 * mb_x) * 2;
    for (int r = 0; r < 2; r++)
      for (int c = 0; c < 2; c++) {
        m[(r * ls + c) * 2] = int16_t(x);
        m[(r * ls + c) * 2 + 1] = int16_t(y);
      }
  }

  void macroblock(Bits& b) {
    const Tables& T = tables();
    static const int kDquant[4] = {-1, -2, 1, 2};
    alignas(16) int16_t blocks[6][64];
    int cbpc;
    bool intra, dquant;
    if (pict_type == 2) {
      do {
        if (b.bit()) {  // not_coded
          clean_intra_entries();
          set_mvs(0, 0);
          qtab[size_t(mb_y * cs + mb_x)] = int8_t(qscale);
          const int zero[1][2] = {{0, 0}};
          motion(zero, false);
          return;
        }
        cbpc = T.inter_mcbpc.read(b, "MCBPC");
      } while (cbpc == 20);
      intra = cbpc & 4;
      dquant = cbpc & 8;
    } else {
      do cbpc = T.intra_mcbpc.read(b, "MCBPC");
      while (cbpc == 8);
      intra = true;
      dquant = cbpc & 4;
    }
    if (intra) {
      bool ac_pred = b.bit();
      int cbpy = T.cbpy.read(b, "CBPY");
      int cbp = (cbpc & 3) | (cbpy << 2);
      bool dc_vlc = qscale < dc_thr;  // the QP before DQUANT
      if (dquant) set_qscale(qscale + kDquant[b.u(2)]);
      memset(blocks, 0, sizeof(blocks));
      int last[6];
      for (int n = 0; n < 6; n++) {
        int dir;
        last[n] = decode_block(b, blocks[n], n, cbp & 32, true, dc_vlc, ac_pred, &dir);
        cbp += cbp;
      }
      b.check();
      set_mvs(0, 0);
      qtab[size_t(mb_y * cs + mb_x)] = int8_t(qscale);
      for (int n = 0; n < 6; n++) {
        unquant_intra(blocks[n], n, last[n], ac_pred);
        ptrdiff_t stride;
        uint8_t* dst = block_dst(n, &stride);
        idct(blocks[n], dst, stride, false);
      }
      return;
    }
    bool four = cbpc & 16;
    int cbpy = T.cbpy.read(b, "CBPY") ^ 0xF;
    int cbp = (cbpc & 3) | (cbpy << 2);
    if (dquant) set_qscale(qscale + kDquant[b.u(2)]);
    int mvs[4][2];
    if (!four) {
      int px, py;
      pred_motion(0, &px, &py);
      mvs[0][0] = decode_motion(b, px);
      mvs[0][1] = decode_motion(b, py);
      set_mvs(mvs[0][0], mvs[0][1]);
    } else {
      for (int i = 0; i < 4; i++) {
        int px, py;
        pred_motion(i, &px, &py);
        mvs[i][0] = decode_motion(b, px);
        mvs[i][1] = decode_motion(b, py);
        int16_t* m = mv + ((2 * mb_y + (i >> 1)) * ls + 2 * mb_x + (i & 1)) * 2;
        m[0] = int16_t(mvs[i][0]);
        m[1] = int16_t(mvs[i][1]);
      }
    }
    memset(blocks, 0, sizeof(blocks));
    int last[6];
    for (int n = 0; n < 6; n++) {
      int dir;
      last[n] = decode_block(b, blocks[n], n, cbp & 32, false, false, false, &dir);
      cbp += cbp;
    }
    b.check();
    clean_intra_entries();
    qtab[size_t(mb_y * cs + mb_x)] = int8_t(qscale);
    motion(mvs, four);
    for (int n = 0; n < 6; n++) {
      if (last[n] < 0) continue;
      if (mpeg_quant) unquant_inter_mpeg(blocks[n], last[n]);
      ptrdiff_t stride;
      uint8_t* dst = block_dst(n, &stride);
      idct(blocks[n], dst, stride, true);
    }
  }

  // a VOP from its header's first bit: the decoded frame, or null for an
  // N-VOP
  FramePtr vop(Bits& b) {
    auto t0 = std::chrono::steady_clock::now();
    check_encoder();
    if (!vop_header(b)) {
      pictures++;
      skipped_last = true;
      return nullptr;
    }
    skipped_last = false;
    if (pict_type == 2 && !ref) refuse("a P-VOP before any I-VOP");
    cur = std::make_shared<Frame>();
    cur->alloc(width, height);
    cur->kind = pict_type == 1 ? 'I' : 'P';
    cur->matrix = matrix;
    cur->full_range = full_range;
    mb_x = mb_y = 0;
    resync_x = resync_y = 0;
    first_slice_line = true;
    for (int mb = 0; mb < mb_num;) {
      mb_x = mb % mbw;
      mb_y = mb / mbw;
      if (mb_x == resync_x && mb_y == resync_y + 1) first_slice_line = false;
      macroblock(b);
      mb++;
      if (mb < mb_num && at_resync(b)) {
        int next = packet_header(b);
        if (next != mb) corrupt("video packet does not start at the next macroblock");
        mb_x = mb % mbw;
        mb_y = mb / mbw;
        clean_buffers();
        resync_x = mb_x;
        resync_y = mb_y;
        first_slice_line = true;
      }
    }
    pictures++;
    ref = cur;
    cur->ms = std::chrono::duration<double, std::milli>(std::chrono::steady_clock::now() - t0)
                  .count();
    return ref;
  }
};

// ------------------------------------------------------------------ stream

// a sample (or header block) copied with zero padding for the bit reader
struct Padded {
  std::vector<uint8_t> buf;
  Bits bits(const uint8_t* d, size_t n) {
    buf.assign(n + kPad, 0);
    if (n) memcpy(buf.data(), d, n);
    Bits b;
    b.d = buf.data();
    b.nbits = n * 8;
    return b;
  }
};

std::string oti_name(int oti) {
  char hex[8];
  snprintf(hex, sizeof(hex), "0x%02X", oti);
  std::string name = oti == 0x6C ? "MJPEG"
                     : oti >= 0x60 && oti <= 0x65 ? "MPEG-2 video"
                     : oti == 0x6A ? "MPEG-1 video"
                     : oti == 0x21 ? "H.264"
                     : oti == 0x23 ? "HEVC"
                     : oti == 0x6B ? "MPEG-1 audio"
                     : oti == 0x40 ? "AAC" : "an unknown codec";
  return name + " (objectTypeIndication " + hex + " in an mp4v sample entry)";
}

struct Stream {
  std::vector<uint8_t> data;
  std::vector<Span> samples;
  size_t next = 0;
  Decoder dec;
  Padded pad;
  FramePtr frame;        // the next frame out
  FramePtr last_out;     // the last frame out
  char kind = 'I';       // frame's VOP type as output
  double ms = 0;
  bool done = false;

  void open(const uint8_t* d, size_t n) {
    data.assign(d, d + n);
    if (!native::is_mp4(data.data(), n)) corrupt("not an MP4 file");
    native::Track t = native::demux_mp4(data.data(), n);
    if (t.entry != native::fourcc("mp4v"))
      refuse("video codec '" + native::fourcc_name(t.entry) + "' (not MPEG-4 Part 2)");
    if (t.oti < 0)
      refuse("video codec 'mp4v' without an esds box (codecs other than H.264 and MPEG-4 Part 2 "
             "with an objectTypeIndication)");
    if (t.oti != 0x20) refuse(oti_name(t.oti));
    samples = t.samples;
    if (t.config.second) {
      Bits b = pad.bits(t.config.first, t.config.second);
      if (dec.headers(b)) corrupt("a VOP in the DecoderSpecificInfo");
    }
  }

  // decodes until a frame is out; false at the end of the stream
  bool advance() {
    while (!done) {
      if (next >= samples.size()) {
        done = true;
        // libavcodec outputs its last frame again when the stream ends
        // with an N-VOP (low_delay 1)
        if (dec.skipped_last && dec.low_delay && last_out) {
          frame = last_out;
          kind = 'N';
          ms = 0;
          return true;
        }
        return false;
      }
      Span s = samples[next++];
      if (s.second >= 3 && s.first[0] == 0 && s.first[1] == 0 && (s.first[2] & 0xFC) == 0x80)
        refuse("short_video_header (H.263 in MP4)");
      Bits b = pad.bits(s.first, s.second);
      if (!dec.headers(b)) corrupt("a sample without a VOP");
      FramePtr f = dec.vop(b);
      if (!f) continue;
      frame = last_out = f;
      kind = f->kind;
      ms = f->ms;
      return true;
    }
    return false;
  }
};

}  // namespace

// ------------------------------------------------------------------ C API
// The same shape as h264.cpp's hv_* functions.
// mv_open: a stream over a copy of the file's bytes, or null with *rc set
// (-1 corrupt, -2 not supported) and a message in err.
extern "C" void* mv_open(const uint8_t* data, size_t n, int* rc, char* err, int err_len) {
  Stream* s = nullptr;
  try {
    s = new Stream();
    s->open(data, n);
    *rc = 0;
    return s;
  } catch (const Failure& f) {
    *rc = native::report(f, err, err_len);
  } catch (const std::bad_alloc&) {
    *rc = native::report(Failure{1, "out of memory"}, err, err_len);
  } catch (const std::exception& e) {
    *rc = native::report(Failure{1, std::string("decoder error: ") + e.what()}, err, err_len);
  }
  delete s;
  return nullptr;
}

// mv_next: decodes until the next frame is out; 1 with its size, 0 at the
// end of the stream, -1 / -2 on failure.
extern "C" int mv_next(void* h, int* w, int* hgt, char* err, int err_len) {
  Stream* s = static_cast<Stream*>(h);
  try {
    if (!s->advance()) return 0;
    *w = s->frame->width;
    *hgt = s->frame->height;
    return 1;
  } catch (const Failure& f) {
    return native::report(f, err, err_len);
  } catch (const std::bad_alloc&) {
    return native::report(Failure{1, "out of memory"}, err, err_len);
  } catch (const std::exception& e) {
    return native::report(Failure{1, std::string("decoder error: ") + e.what()}, err, err_len);
  }
}

// mv_take: the frame mv_next announced, as RGB (or BGR) uint8 [h, w, 3].
extern "C" void mv_take(void* h, uint8_t* out, int bgr) {
  Stream* s = static_cast<Stream*>(h);
  const Frame& f = *s->frame;
  native::yuv420_to_rgb(f.y.data(), f.mbw * 16, f.u.data(), f.v.data(), f.mbw * 8, f.width,
                        f.height, f.matrix, f.full_range, out, bgr != 0);
  s->frame.reset();
}

// mv_take_yuv: the frame mv_next announced as its visible planes: luma
// [h, w], then each chroma plane [h / 2, w / 2].
extern "C" void mv_take_yuv(void* h, uint8_t* y, uint8_t* u, uint8_t* v) {
  Stream* s = static_cast<Stream*>(h);
  const Frame& f = *s->frame;
  int w = f.width, hh = f.height, cw = w / 2, ch = hh / 2;
  for (int r = 0; r < hh; r++) memcpy(y + size_t(r) * w, &f.y[size_t(r) * f.mbw * 16], size_t(w));
  for (int r = 0; r < ch; r++) {
    memcpy(u + size_t(r) * cw, &f.u[size_t(r) * f.mbw * 8], size_t(cw));
    memcpy(v + size_t(r) * cw, &f.v[size_t(r) * f.mbw * 8], size_t(cw));
  }
  s->frame.reset();
}

// mv_info: of the frame mv_next announced, 1, and in kinds[0] and ms[0] its
// VOP's type ('I' or 'P'; 'N' for the frame an N-VOP at the end repeats)
// and the ms its decoding took (before the RGB conversion).
extern "C" int mv_info(void* h, char* kinds, double* ms) {
  Stream* s = static_cast<Stream*>(h);
  kinds[0] = s->kind;
  ms[0] = s->ms;
  return 1;
}

extern "C" void mv_close(void* h) { delete static_cast<Stream*>(h); }
