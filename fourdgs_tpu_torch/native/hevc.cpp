// HEVC (ITU-T H.265, Main profile) video decoder for the port's DyNeRF
// loader: host C++, no libavcodec.
//
// Phones (iPhones since iOS 11), GoPro and DJI cameras and x265 write HEVC
// into an .mp4, and the JAX package reads such a camera with
// cv2.VideoCapture (FFmpeg's libavformat, libavcodec and libswscale). The
// port depends on no cv2 or FFmpeg, so it keeps this decoder
// (utils/video.py builds it with g++ at first use and loads it with ctypes,
// as it does native/h264.cpp and native/mpeg4.cpp). Its frames equal cv2's
// in order, in number and bit for bit:
//
// - containers: an MP4 file's first video track with an 'hvc1' or 'hev1'
//   sample entry (mp4.h): the hvcC box's lengthSizeMinusOne (1-, 2- or
//   4-byte NAL lengths) and its VPS/SPS/PPS/SEI arrays, parameter sets in
//   band too; an edit list that starts at the first composition time, as
//   FFmpeg's muxer writes for B-frames, drops nothing;
// - NAL units: the 2-byte header; layers above the base skipped as
//   libavcodec skips them; VPS, SEI, AUD, filler and reserved types
//   ignored; EOS and EOB end the coded video sequence;
// - ITU-T H.265 Main, Main Still Picture and Main 10 at 8 bits, 4:2:0,
//   progressive: the SPS (profile_tier_level with sub-layers, the
//   conformance window, log2_max_pic_order_cnt_lsb, the buffering and
//   reorder counts of the highest sub-layer, CTB of 16 to 64, CB, TB sizes
//   and depths, AMP, SAO, strong intra smoothing, scaling lists (default,
//   explicit and predicted), short-term RPS sets with inter-RPS prediction,
//   long-term pictures, temporal MVP, the VUI with its HRD parameters and
//   colour description); the PPS (sign data hiding, cabac_init_present,
//   init_qp, constrained intra prediction, transform skip, cu_qp_delta and
//   its depth, the Cb/Cr QP offsets and their slice-level ones, weighted
//   prediction and bi-prediction, WPP, the deblocking control and offsets,
//   lists_modification_present, log2_parallel_merge_level,
//   num_extra_slice_header_bits, output_flag_present, slice header
//   extensions);
// - slice headers, POC, the RPS, the reference lists (num_ref_idx wrap,
//   ref_pic_lists_modification), IDR, CRA and BLA pictures, RASL and RADL
//   pictures, pic_output_flag, sub-layers, and the output order of
//   libavcodec's reorder buffer;
// - I, P and B slices with CABAC: SAO syntax with merge left and up, the
//   coding quadtree, skip, merge (spatial, temporal from the collocated
//   picture's motion kept at 16x16, combined bi-predictive, zero) and AMVP
//   (scaled spatial and temporal candidates) prediction units of every
//   partition (AMP too), the 8x4 and 4x8 bi-to-uni rule, intra luma modes
//   through the most probable modes, intra chroma modes (mode 4 too), the
//   transform tree, cu_qp_delta with QP prediction, residual coding (sign
//   data hiding, coeff_abs_level_remaining with its Rice parameter),
//   scaling, the 4x4 DST, the 4- to 32-point DCT with 16-bit clipping
//   between stages, transform skip; intra prediction (reference
//   substitution, constrained intra, the [1 2 1] and strong filters,
//   planar, DC and the 33 angular modes with their edge filters); luma
//   8-tap and chroma 4-tap interpolation at 14 bits, default and explicit
//   weighted prediction; deblocking, then SAO (band and edge offsets);
//   WPP substreams (contexts after each row's second CTB);
// - where libavcodec departs from the standard, libavcodec's way (read off
//   cv2 5.0's libavcodec 62.28 on x86-64 with tests/hevc_writer.py's
//   random streams; tests/test_torch_hevc.py holds each):
//   * the POC's most significant bits come from the previous TemporalId-0
//   picture and restart at 0 for BLA pictures only (a CRA picture after
//   EOS keeps them);
//   * the RASL pictures of the first CRA or BLA picture after the start or
//   an EOS are not decoded; those of a later CRA are;
//   * a CRA picture after an EOS drops the pictures still awaiting output;
//   * a picture leaves the reorder buffer when more pictures await output
//   than sps_max_num_reorder_pics of the highest sub-layer, or when any
//   awaits it and the buffer holds sps_max_dec_pic_buffering of them (a
//   reorder count above the buffering raises the buffering);
//   sps_max_latency_increase is not read;
//   * an RPS entry absent from the buffer takes a slot there when the
//   picture does not use it (libavcodec generates the picture);
//   * the deblocking filter's tc and beta offsets are one variable through
//   a CTB's edges (deblock_ctb), and a slice whose header disables its
//   deblocking keeps the offsets of the slice header read before it, which
//   its neighbours' edges read. With frame threads each thread keeps its
//   own last header, so cv2's frames of such a stream depend on its thread
//   count: the decoder follows libavcodec on one thread;
//   * with constrained intra prediction, a block shorter than the minimum
//   prediction block (luma 4x4 where CBs are 16 and up, chroma 4x4 where
//   they are 32 and up) on the left edge of one takes none of its left and
//   bottom-left references;
//   * motion is compared by the reference's POC in the boundary strength;
//   * SAO leaves a sample whose neighbour lies in another slice when the
//   sample's own slice does not filter across slices;
//   * the default display window is not applied.
//
// Cropping follows the standard: cv2 differs where a left crop is not a
// multiple of 64 luma samples (FFmpeg keeps the frame's alignment, leaves
// part of the crop in and cv2 rescales the frame to the stream's width).
// The conversion to RGB or BGR is cv2's (yuv420_bgr.h), by the VUI's
// matrix_coefficients and video_full_range_flag.
//
// Outside that scope it fails with kind 2 (utils/video.py raises
// NotImplementedError naming the feature): tiles, PCM, the transquant
// bypass, dependent slice segments, bit depths above 8, chroma other than
// 4:2:0 (monochrome too), separate colour planes, the range, multilayer,
// 3D and SCC extensions, field_seq_flag 1 (fields coded as pictures), a
// reference the picture uses missing from the buffer, a change of picture
// size, a colour matrix cv2 does not convert, and an edit list that drops
// samples. A truncated or corrupt stream fails with kind 1 (ValueError).

#include <algorithm>
#include <array>
#include <chrono>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <string>
#include <vector>

#include "mp4.h"
#include "yuv420_bgr.h"

namespace {

using native::corrupt;
using native::Failure;
using native::refuse;

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : (v > hi ? hi : v); }
inline uint8_t clip1(int v) { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); }
inline int sign(int v) { return (v > 0) - (v < 0); }

// ------------------------------------------------------------------ tables

// Table 9-52: rangeTabLps[pStateIdx][qRangeIdx]; Table 9-53: transIdxLps
const uint8_t kRangeLps[64][4] = {
    {128, 176, 208, 240}, {128, 167, 197, 227}, {128, 158, 187, 216}, {123, 150, 178, 205},
    {116, 142, 169, 195}, {111, 135, 160, 185}, {105, 128, 152, 175}, {100, 122, 144, 166},
    {95, 116, 137, 158},  {90, 110, 130, 150},  {85, 104, 123, 142},  {81, 99, 117, 135},
    {77, 94, 111, 128},   {73, 89, 105, 122},   {69, 85, 100, 116},   {66, 80, 95, 110},
    {62, 76, 90, 104},    {59, 72, 86, 99},     {56, 69, 81, 94},     {53, 65, 77, 89},
    {51, 62, 73, 85},     {48, 59, 69, 80},     {46, 56, 66, 76},     {43, 53, 63, 72},
    {41, 50, 59, 69},     {39, 48, 56, 65},     {37, 45, 54, 62},     {35, 43, 51, 59},
    {33, 41, 48, 56},     {32, 39, 46, 53},     {30, 37, 43, 50},     {29, 35, 41, 48},
    {27, 33, 39, 45},     {26, 31, 37, 43},     {24, 30, 35, 41},     {23, 28, 33, 39},
    {22, 27, 32, 37},     {21, 26, 30, 35},     {20, 24, 29, 33},     {19, 23, 27, 31},
    {18, 22, 26, 30},     {17, 21, 25, 28},     {16, 20, 23, 27},     {15, 19, 22, 25},
    {14, 18, 21, 24},     {14, 17, 20, 23},     {13, 16, 19, 22},     {12, 15, 18, 21},
    {12, 14, 17, 20},     {11, 14, 16, 19},     {11, 13, 15, 18},     {10, 12, 15, 17},
    {10, 12, 14, 16},     {9, 11, 13, 15},      {9, 11, 12, 14},      {8, 10, 12, 14},
    {8, 9, 11, 13},       {7, 9, 11, 12},       {7, 9, 10, 12},       {7, 8, 10, 11},
    {6, 8, 9, 11},        {6, 7, 9, 10},        {6, 7, 8, 9},         {2, 2, 2, 2}};
const uint8_t kTransLps[64] = {0,  0,  1,  2,  2,  4,  4,  5,  6,  7,  8,  9,  9,  11, 11, 12,
                               13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24,
                               24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
                               33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63};

// the context variables of each syntax element: its first ctxIdx
enum Ctx {
  SAO_MERGE = 0, SAO_TYPE = 1, SPLIT_CU = 2, TQ_BYPASS = 5, SKIP = 6, PRED_MODE = 9,
  PART_MODE = 10, PREV_INTRA = 14, CHROMA_MODE = 15, RQT_ROOT_CBF = 16, MERGE_FLAG = 17,
  MERGE_IDX = 18, INTER_PRED = 19, REF_IDX = 24, MVD_GT0 = 26, MVD_GT1 = 27, MVP_FLAG = 28,
  SPLIT_TRANSFORM = 29, CBF_LUMA = 32, CBF_CHROMA = 34, QP_DELTA = 38, TRANSFORM_SKIP = 40,
  LAST_X = 42, LAST_Y = 60, CSBF = 78, SIG = 82, GT1 = 124, GT2 = 148, NUM_CTX = 154
};

// Tables 9-5 to 9-37: initValue of each context by initType (0: I slices;
// 1 and 2: P and B slices, swapped by cabac_init_flag), in Ctx's order;
// 154 where a context of the element is unused at that initType
const uint8_t kCabacInit[3][NUM_CTX] = {
    {153, 200, 139, 141, 157, 154, 154, 154, 154, 154, 184, 154, 154, 154, 184, 63, 154, 154,
     154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 153, 138, 138, 111, 141, 94, 138,
     182, 154, 154, 154, 139, 139, 110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143,
     127, 111, 79, 108, 123, 63, 110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143,
     127, 111, 79, 108, 123, 63, 91, 171, 134, 141, 111, 111, 125, 110, 110, 94, 124, 108,
     124, 107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153,
     125, 140, 139, 182, 182, 152, 136, 152, 136, 153, 136, 139, 111, 136, 139, 111, 140, 92,
     137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139, 107, 122, 152, 140, 179, 166, 182,
     140, 227, 122, 197, 138, 153, 136, 167, 152, 152},
    {153, 185, 107, 139, 126, 154, 197, 185, 201, 149, 154, 139, 154, 154, 154, 152, 79, 110,
     122, 95, 79, 63, 31, 31, 153, 153, 140, 198, 168, 124, 138, 94, 153, 111, 149, 107, 167,
     154, 154, 154, 139, 139, 125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95,
     94, 108, 123, 108, 125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94,
     108, 123, 108, 121, 140, 61, 154, 155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183,
     140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 170, 153,
     123, 123, 107, 121, 107, 121, 167, 151, 183, 140, 151, 183, 140, 154, 196, 196, 167, 154,
     152, 167, 182, 182, 134, 149, 136, 153, 121, 136, 137, 169, 194, 166, 167, 154, 167, 137,
     182, 107, 167, 91, 122, 107, 167},
    {153, 160, 107, 139, 126, 154, 197, 185, 201, 134, 154, 139, 154, 154, 183, 152, 79, 154,
     137, 95, 79, 63, 31, 31, 153, 153, 169, 198, 168, 224, 167, 122, 153, 111, 149, 92, 167,
     154, 154, 154, 139, 139, 125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111,
     111, 79, 108, 123, 93, 125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111,
     79, 108, 123, 93, 121, 140, 61, 154, 170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183,
     140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 170, 153,
     138, 138, 122, 121, 122, 121, 167, 151, 183, 140, 151, 183, 140, 154, 196, 167, 167, 154,
     152, 167, 182, 182, 134, 149, 136, 153, 121, 136, 122, 169, 208, 166, 167, 154, 152, 167,
     182, 107, 167, 91, 107, 107, 167}};

// 8.4.4.2.6: intraPredAngle of modes 2..34 and invAngle of modes 11..25
const int kIntraAngle[35] = {0,   0,   32,  26,  21,  17,  13,  9,  5,  2,  0,  -2,
                             -5,  -9,  -13, -17, -21, -26, -32, -26, -21, -17, -13, -9,
                             -5,  -2,  0,   2,   5,   9,   13,  17,  21,  26,  32};
const int kInvAngle[15] = {-4096, -1638, -910, -630, -482, -390, -315, -256,
                           -315,  -390,  -482, -630, -910, -1638, -4096};

// 8.7.2.5.3: β' and tc' (Table 8-12)
const uint8_t kBeta[52] = {0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  6,  7,
                           8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32,
                           34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64};
const uint8_t kTc[54] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  0,  0,  0,
                         1, 1, 1, 1, 1, 1, 1, 1, 1, 2,  2,  2,  2,  3,  3,  3,  3,  4,
                         4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24};
// Table 8-10: QpC of qPi 30..43 (4:2:0)
const uint8_t kQpC[14] = {29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37};
const int kLevelScale[6] = {40, 45, 51, 57, 64, 72};

// Table 7-6: the default 8x8 scaling lists (intra, inter), in up-right
// diagonal order
const uint8_t kDefaultScaling[2][64] = {
    {16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 17, 16, 17, 16, 17, 18, 17, 18, 18, 17, 18, 21,
     19, 20, 21, 20, 19, 21, 24, 22, 22, 24, 24, 22, 22, 24, 25, 25, 27, 30, 27, 25, 25, 29,
     31, 35, 35, 31, 29, 36, 41, 44, 41, 36, 47, 54, 54, 47, 65, 70, 65, 88, 88, 115},
    {16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 17, 17, 17, 17, 17, 18, 18, 18, 18, 18, 18, 20,
     20, 20, 20, 20, 20, 20, 24, 24, 24, 24, 24, 24, 24, 24, 25, 25, 25, 25, 25, 25, 25, 28,
     28, 28, 28, 28, 28, 33, 33, 33, 33, 33, 41, 41, 41, 41, 54, 54, 54, 71, 71, 91}};

// 6.5.3-6.5.5: the up-right diagonal, horizontal and vertical scans of a
// blk x blk block (blk 2, 4, 8): scan[log2blk - 1][scanIdx][i] = x | y << 4
struct Scans {
  uint8_t pos[3][3][64];
  Scans() {
    for (int l = 1; l <= 3; l++) {
      int blk = 1 << l, i = 0, x = 0, y = 0;
      while (i < blk * blk) {
        while (y >= 0) {
          if (x < blk && y < blk) pos[l - 1][0][i++] = uint8_t(x | y << 4);
          y--;
          x++;
        }
        y = x;
        x = 0;
      }
      i = 0;
      for (y = 0; y < blk; y++)
        for (x = 0; x < blk; x++) pos[l - 1][1][i++] = uint8_t(x | y << 4);
      i = 0;
      for (x = 0; x < blk; x++)
        for (y = 0; y < blk; y++) pos[l - 1][2][i++] = uint8_t(x | y << 4);
    }
  }
};
const Scans kScans;

// 8.6.4.2: transMatrix of the 32-point DCT, coefficient m's basis at
// sample n; the 4-, 8- and 16-point ones are its rows 0, 32/N, ...
struct Dct {
  int8_t m[32][32];
  Dct() {
    // cos(k pi / 64) for k = 0..32 as the standard's integers
    static const int c[33] = {64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67, 64,
                              61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9,  4,  0};
    for (int k = 0; k < 32; k++)
      for (int n = 0; n < 32; n++) {
        int a = (k * (2 * n + 1)) % 128, v;
        if (a <= 32) v = c[a];
        else if (a <= 64) v = -c[64 - a];
        else if (a <= 96) v = -c[a - 64];
        else v = c[128 - a];
        m[k][n] = int8_t(v);
      }
  }
};
const Dct kDct;
const int kDst[4][4] = {{29, 55, 74, 84}, {74, 74, 0, -74}, {84, -29, -74, 55}, {55, -84, 74, -29}};

// ------------------------------------------------------------------ bits

// MSB-first reader of an RBSP (emulation prevention removed)
struct Bits {
  const uint8_t* d = nullptr;
  size_t n = 0, pos = 0;  // pos in bits
  Bits() = default;
  Bits(const uint8_t* d_, size_t n_) : d(d_), n(n_) {}
  uint32_t bit() {
    if (pos >= n * 8) corrupt("truncated NAL unit");
    uint32_t b = (d[pos >> 3] >> (7 - (pos & 7))) & 1;
    pos++;
    return b;
  }
  uint32_t u(int k) {
    uint32_t v = 0;
    for (int i = 0; i < k; i++) v = (v << 1) | bit();
    return v;
  }
  uint32_t ue() {
    int zeros = 0;
    while (!bit()) {
      if (++zeros > 31) corrupt("Exp-Golomb code too long");
    }
    if (zeros == 0) return 0;
    return ((1u << zeros) - 1) + u(zeros);
  }
  int32_t se() {
    uint32_t k = ue();
    return (k & 1) ? int32_t((k + 1) / 2) : -int32_t(k / 2);
  }
  // ue(v) that must not exceed hi
  int ue_max(uint32_t hi, const char* what) {
    uint32_t v = ue();
    if (v > hi) corrupt(std::string(what) + " out of range");
    return int(v);
  }
  int se_in(int lo, int hi, const char* what) {
    int v = se();
    if (v < lo || v > hi) corrupt(std::string(what) + " out of range");
    return v;
  }
};

// the RBSP of a NAL unit's payload (after its 2-byte header): emulation
// prevention bytes removed
std::vector<uint8_t> rbsp_of(const uint8_t* p, size_t n) {
  std::vector<uint8_t> out;
  out.reserve(n);
  int zeros = 0;
  for (size_t i = 0; i < n; i++) {
    if (zeros >= 2 && p[i] == 3) {
      zeros = 0;
      continue;
    }
    out.push_back(p[i]);
    zeros = p[i] == 0 ? zeros + 1 : 0;
  }
  return out;
}

// ------------------------------------------------------------------ CABAC

// 9.3.4.3: the arithmetic decoding engine over an RBSP
struct Cabac {
  const uint8_t* d = nullptr;
  size_t n = 0, next = 0;  // the data, its size and the next byte to cache
  uint64_t cache = 0;
  int nbits = 0;  // bits left in the cache
  uint32_t range = 0, offset = 0;
  uint8_t state[NUM_CTX], mps[NUM_CTX];
  void refill() {
    // past the end reads zeros, as a decoder's padded buffer does
    cache = 0;
    for (int k = 0; k < 8; k++, next++) cache = (cache << 8) | (next < n ? d[next] : 0);
    nbits = 64;
  }
  inline uint32_t bits(int k) {  // k <= 9
    if (nbits < k) {
      uint32_t hi = uint32_t(cache & ((uint64_t(1) << nbits) - 1));
      int rest = k - nbits;
      refill();
      nbits -= rest;
      return (hi << rest) | (uint32_t(cache >> nbits) & ((1u << rest) - 1));
    }
    nbits -= k;
    return uint32_t(cache >> nbits) & ((1u << k) - 1);
  }
  size_t pos() const { return next * 8 - size_t(nbits); }
  // the engine started at byte `at` of data
  void start(const uint8_t* data, size_t size, size_t at) {
    d = data;
    n = size;
    if (at >= size) corrupt("truncated slice data");
    next = at;
    refill();
    range = 510;
    offset = bits(9);
    if (offset >= 510) corrupt("CABAC offset out of range");
  }
  // the next substream: the byte after the one that holds the bit the
  // engine read last (end_of_subset_one_bit's flush ends in its own byte)
  void restart() { start(d, n, (pos() + 7) / 8); }
  void init_contexts(int init_type, int qp) {
    const uint8_t* iv = kCabacInit[init_type];
    for (int i = 0; i < NUM_CTX; i++) {
      int m = (iv[i] >> 4) * 5 - 45, nn = ((iv[i] & 15) << 3) - 16;
      int pre = clip3(1, 126, ((m * clip3(0, 51, qp)) >> 4) + nn);
      if (pre <= 63) {
        state[i] = uint8_t(63 - pre);
        mps[i] = 0;
      } else {
        state[i] = uint8_t(pre - 64);
        mps[i] = 1;
      }
    }
  }
  inline int decision(int ctx) {
    int s = state[ctx];
    uint32_t lps = kRangeLps[s][(range >> 6) & 3];
    range -= lps;
    int b;
    if (offset >= range) {
      b = !mps[ctx];
      offset -= range;
      range = lps;
      if (s == 0) mps[ctx] = uint8_t(1 - mps[ctx]);
      state[ctx] = kTransLps[s];
    } else {
      b = mps[ctx];
      if (s < 62) state[ctx] = uint8_t(s + 1);
    }
    if (range < 256) {
      int shift = __builtin_clz(range) - 23;
      range <<= shift;
      offset = (offset << shift) | bits(shift);
    }
    return b;
  }
  inline int bypass() {
    offset = (offset << 1) | bits(1);
    if (offset >= range) {
      offset -= range;
      return 1;
    }
    return 0;
  }
  inline int bypass_bits(int k) {
    int v = 0;
    while (k--) v = (v << 1) | bypass();
    return v;
  }
  int terminate() {
    range -= 2;
    if (offset >= range) return 1;
    if (range < 256) {
      int shift = __builtin_clz(range) - 23;
      range <<= shift;
      offset = (offset << shift) | bits(shift);
    }
    return 0;
  }
};

// ---------------------------------------------------------- parameter sets

// a short-term reference picture set: DeltaPocS0 (num_neg, closest first)
// then DeltaPocS1 (num_pos), and whether each is used by the picture
struct Rps {
  int num_neg = 0, num_pos = 0;
  int delta[32] = {};
  bool used[32] = {};
  int total() const { return num_neg + num_pos; }
};

// 7.3.7: st_ref_pic_set(idx) of `sets` (the SPS's, of which idx may be the
// slice header's own, idx == sets.size())
Rps parse_rps(Bits& b, const std::vector<Rps>& sets, size_t idx, bool in_slice) {
  Rps r;
  bool inter = idx != 0 && b.u(1);
  if (inter) {
    size_t delta_idx = 1;
    if (in_slice) delta_idx += size_t(b.ue_max(uint32_t(idx - 1), "delta_idx_minus1"));
    if (delta_idx > idx) corrupt("delta_idx_minus1 out of range");
    const Rps& ref = sets[idx - delta_idx];
    int sgn = int(b.u(1));
    int abs_d = b.ue_max(32767, "abs_delta_rps_minus1") + 1;
    int delta_rps = sgn ? -abs_d : abs_d;
    int nref = ref.total();
    bool used[33], use_delta[33];
    for (int j = 0; j <= nref; j++) {
      used[j] = b.u(1);
      use_delta[j] = used[j] ? true : bool(b.u(1));
    }
    // (7-61), (7-62): the reference set's pictures moved by deltaRps
    int i = 0;
    auto put = [&](int d, bool u) {
      if (i >= 32) corrupt("too many pictures in a short-term RPS");
      r.delta[i] = d;
      r.used[i++] = u;
    };
    for (int j = ref.num_pos - 1; j >= 0; j--) {
      int d = ref.delta[ref.num_neg + j] + delta_rps;
      if (d < 0 && use_delta[ref.num_neg + j]) put(d, used[ref.num_neg + j]);
    }
    if (delta_rps < 0 && use_delta[nref]) put(delta_rps, used[nref]);
    for (int j = 0; j < ref.num_neg; j++) {
      int d = ref.delta[j] + delta_rps;
      if (d < 0 && use_delta[j]) put(d, used[j]);
    }
    r.num_neg = i;
    for (int j = ref.num_neg - 1; j >= 0; j--) {
      int d = ref.delta[j] + delta_rps;
      if (d > 0 && use_delta[j]) put(d, used[j]);
    }
    if (delta_rps > 0 && use_delta[nref]) put(delta_rps, used[nref]);
    for (int j = 0; j < ref.num_pos; j++) {
      int d = ref.delta[ref.num_neg + j] + delta_rps;
      if (d > 0 && use_delta[ref.num_neg + j]) put(d, used[ref.num_neg + j]);
    }
    r.num_pos = i - r.num_neg;
  } else {
    r.num_neg = b.ue_max(16, "num_negative_pics");
    r.num_pos = b.ue_max(16, "num_positive_pics");
    if (r.total() > 16) corrupt("too many pictures in a short-term RPS");
    int poc = 0;
    for (int i = 0; i < r.num_neg; i++) {
      poc -= b.ue_max(32767, "delta_poc_s0_minus1") + 1;
      r.delta[i] = poc;
      r.used[i] = b.u(1);
    }
    poc = 0;
    for (int i = 0; i < r.num_pos; i++) {
      poc += b.ue_max(32767, "delta_poc_s1_minus1") + 1;
      r.delta[r.num_neg + i] = poc;
      r.used[r.num_neg + i] = b.u(1);
    }
  }
  return r;
}

// scaling lists: list[sizeId][matrixId][i] in up-right diagonal order
// (16 entries for sizeId 0, 64 else) and the DC of sizeIds 2 and 3
struct ScalingList {
  uint8_t list[4][6][64];
  uint8_t dc[4][6];
  void set_default() {
    for (int s = 0; s < 4; s++)
      for (int m = 0; m < 6; m++) {
        for (int i = 0; i < 64; i++) list[s][m][i] = s == 0 ? 16 : kDefaultScaling[m >= 3][i];
        dc[s][m] = 16;
      }
  }
  // 7.3.4: scaling_list_data()
  void parse(Bits& b) {
    set_default();
    for (int s = 0; s < 4; s++)
      for (int m = 0; m < 6; m += s == 3 ? 3 : 1) {
        int n = s == 0 ? 16 : 64;
        if (!b.u(1)) {  // scaling_list_pred_mode_flag 0: a copy
          int delta = b.ue_max(uint32_t(m / (s == 3 ? 3 : 1)), "scaling_list_pred_matrix_id_delta");
          if (delta) {
            int ref = m - delta * (s == 3 ? 3 : 1);
            memcpy(list[s][m], list[s][ref], 64);
            dc[s][m] = dc[s][ref];
          } else {
            for (int i = 0; i < 64; i++) list[s][m][i] = s == 0 ? 16 : kDefaultScaling[m >= 3][i];
            dc[s][m] = 16;
          }
        } else {
          int next = 8;
          if (s > 1) {
            next = b.se_in(-7, 247, "scaling_list_dc_coef_minus8") + 8;
            dc[s][m] = uint8_t(next);
          }
          for (int i = 0; i < n; i++) {
            next = (next + b.se_in(-128, 127, "scaling_list_delta_coef") + 256) % 256;
            list[s][m][i] = uint8_t(next);
          }
          if (s <= 1) dc[s][m] = list[s][m][0];
        }
      }
    // 4:2:0 has no 32x32 chroma lists; keep theirs from the 16x16 ones
    for (int m : {1, 2, 4, 5}) {
      memcpy(list[3][m], list[2][m], 64);
      dc[3][m] = dc[2][m];
    }
  }
  // 7.4.5: ScalingFactor of an nTbS = 1 << log2 block, [y][x] at f[y * n + x]
  void factors(int log2, int m, uint8_t* f) const {
    int s = log2 - 2, n = 1 << log2;
    if (s == 0) {
      for (int i = 0; i < 16; i++) {
        int p = kScans.pos[1][0][i];
        f[(p >> 4) * 4 + (p & 15)] = list[0][m][i];
      }
      return;
    }
    int rep = n / 8;
    for (int i = 0; i < 64; i++) {
      int p = kScans.pos[2][0][i], x = p & 15, y = p >> 4;
      for (int j = 0; j < rep; j++)
        for (int k = 0; k < rep; k++) f[(y * rep + j) * n + x * rep + k] = list[s][m][i];
    }
    if (s >= 2) f[0] = dc[s][m];
  }
};

struct Sps {
  bool valid = false;
  int width = 0, height = 0;                    // pic_width/height_in_luma_samples
  int crop_l = 0, crop_r = 0, crop_t = 0, crop_b = 0;  // in luma samples
  int log2_max_poc_lsb = 4;
  int max_dec = 1, num_reorder = 0;             // of the highest sub-layer
  int log2_min_cb = 3, log2_ctb = 4, log2_min_tb = 2, log2_max_tb = 4;
  int depth_inter = 0, depth_intra = 0;
  bool scaling = false, amp = false, sao = false, tmvp = false, strong_smoothing = false;
  ScalingList sl;
  std::vector<Rps> rps;
  bool lt_present = false;
  int num_lt_sps = 0;
  int lt_lsb_sps[33] = {};
  bool lt_used_sps[33] = {};
  int matrix = 2, full_range = 0;
  int ctb_w = 0, ctb_h = 0;                     // in CTBs
};

struct Pps {
  bool valid = false;
  int sps_id = 0;
  bool dependent_slices = false, output_flag_present = false, sign_hiding = false;
  bool cabac_init_present = false, constrained_intra = false, transform_skip = false;
  bool cu_qp_delta = false, slice_chroma_qp_offsets = false, weighted_pred = false;
  bool weighted_bipred = false, wpp = false, loop_filter_across_slices = false;
  bool deblock_override = false, deblock_disabled = false, lists_modification = false;
  bool slice_header_ext = false, has_scaling = false;
  int extra_bits = 0, num_ref_default[2] = {1, 1}, init_qp = 26, diff_cu_qp_delta_depth = 0;
  int cb_qp_offset = 0, cr_qp_offset = 0, beta_offset = 0, tc_offset = 0;  // offsets * 2
  int log2_par_mrg = 2;
  ScalingList sl;
};

// 7.3.3: profile_tier_level(1, max_sub_layers_minus1)
void skip_ptl(Bits& b, int max_sub_layers_minus1) {
  b.u(8);   // general_profile_space, tier_flag, profile_idc
  b.u(32);  // general_profile_compatibility_flags
  b.u(32);  // progressive/interlaced/non_packed/frame_only and 28 constraint bits
  b.u(16);  // the remaining constraint bits and general_inbld_flag
  b.u(8);   // general_level_idc
  bool prof[8], level[8];
  for (int i = 0; i < max_sub_layers_minus1; i++) {
    prof[i] = b.u(1);
    level[i] = b.u(1);
  }
  if (max_sub_layers_minus1 > 0)
    for (int i = max_sub_layers_minus1; i < 8; i++) b.u(2);
  for (int i = 0; i < max_sub_layers_minus1; i++) {
    if (prof[i]) {
      b.u(8);
      b.u(32);
      b.u(32);
      b.u(16);
    }
    if (level[i]) b.u(8);
  }
}

// E.2.2: hrd_parameters(1, max_sub_layers_minus1), skipped
void skip_hrd(Bits& b, int max_sub_layers_minus1) {
  bool nal = b.u(1), vcl = b.u(1), sub_pic = false;
  if (nal || vcl) {
    sub_pic = b.u(1);
    if (sub_pic) b.u(8 + 5 + 1 + 5);
    b.u(8);  // bit_rate_scale, cpb_size_scale
    if (sub_pic) b.u(4);
    b.u(15);
  }
  for (int i = 0; i <= max_sub_layers_minus1; i++) {
    bool fixed_general = b.u(1), fixed_cvs = true, low_delay = false;
    if (!fixed_general) fixed_cvs = b.u(1);
    if (fixed_cvs) b.ue();
    else low_delay = b.u(1);
    int cpb_cnt = 1;
    if (!low_delay) cpb_cnt = b.ue_max(31, "cpb_cnt_minus1") + 1;
    for (int k = 0; k < int(nal) + int(vcl); k++)
      for (int j = 0; j < cpb_cnt; j++) {
        b.ue();
        b.ue();
        if (sub_pic) {
          b.ue();
          b.ue();
        }
        b.u(1);
      }
  }
}

void parse_sps(Bits& b, Sps* table) {
  Sps s;
  b.u(4);  // sps_video_parameter_set_id
  int max_sub_layers_minus1 = int(b.u(3));
  if (max_sub_layers_minus1 > 6) corrupt("sps_max_sub_layers_minus1 out of range");
  b.u(1);
  skip_ptl(b, max_sub_layers_minus1);
  int id = b.ue_max(15, "sps_seq_parameter_set_id");
  int chroma = b.ue_max(3, "chroma_format_idc");
  if (chroma == 3 && b.u(1)) refuse("separate_colour_plane_flag (colour planes coded apart)");
  if (chroma != 1)
    refuse(chroma == 0 ? "monochrome (chroma other than 4:2:0)" : "chroma other than 4:2:0");
  s.width = b.ue_max(16888, "pic_width_in_luma_samples");
  s.height = b.ue_max(16888, "pic_height_in_luma_samples");
  if (b.u(1)) {  // conformance_window_flag, in chroma units
    s.crop_l = 2 * b.ue_max(8444, "conf_win_left_offset");
    s.crop_r = 2 * b.ue_max(8444, "conf_win_right_offset");
    s.crop_t = 2 * b.ue_max(8444, "conf_win_top_offset");
    s.crop_b = 2 * b.ue_max(8444, "conf_win_bottom_offset");
  }
  int bd_luma = b.ue_max(8, "bit_depth_luma_minus8"), bd_chroma = b.ue_max(8, "bit_depth_chroma_minus8");
  if (bd_luma || bd_chroma) refuse("bit depths above 8");
  s.log2_max_poc_lsb = b.ue_max(12, "log2_max_pic_order_cnt_lsb_minus4") + 4;
  bool ordering = b.u(1);
  for (int i = ordering ? 0 : max_sub_layers_minus1; i <= max_sub_layers_minus1; i++) {
    s.max_dec = b.ue_max(15, "sps_max_dec_pic_buffering_minus1") + 1;
    s.num_reorder = b.ue_max(15, "sps_max_num_reorder_pics");
    b.ue();  // sps_max_latency_increase_plus1
  }
  // as libavcodec: a reorder count above the buffering raises the buffering
  if (s.num_reorder > s.max_dec - 1) s.max_dec = s.num_reorder + 1;
  s.log2_min_cb = b.ue_max(3, "log2_min_luma_coding_block_size_minus3") + 3;
  s.log2_ctb = s.log2_min_cb + b.ue_max(3, "log2_diff_max_min_luma_coding_block_size");
  s.log2_min_tb = b.ue_max(3, "log2_min_luma_transform_block_size_minus2") + 2;
  s.log2_max_tb = s.log2_min_tb + b.ue_max(3, "log2_diff_max_min_luma_transform_block_size");
  if (s.log2_ctb < 4 || s.log2_ctb > 6 || s.log2_min_tb >= s.log2_min_cb ||
      s.log2_max_tb > std::min(s.log2_ctb, 5))
    corrupt("coding or transform block sizes out of range");
  s.depth_inter = b.ue_max(uint32_t(s.log2_ctb - s.log2_min_tb), "max_transform_hierarchy_depth_inter");
  s.depth_intra = b.ue_max(uint32_t(s.log2_ctb - s.log2_min_tb), "max_transform_hierarchy_depth_intra");
  s.scaling = b.u(1);
  if (s.scaling) {
    if (b.u(1)) s.sl.parse(b);
    else s.sl.set_default();
  }
  s.amp = b.u(1);
  s.sao = b.u(1);
  if (b.u(1)) refuse("PCM (pcm_enabled_flag)");
  int nsets = b.ue_max(64, "num_short_term_ref_pic_sets");
  for (int i = 0; i < nsets; i++) s.rps.push_back(parse_rps(b, s.rps, size_t(i), false));
  s.lt_present = b.u(1);
  if (s.lt_present) {
    s.num_lt_sps = b.ue_max(32, "num_long_term_ref_pics_sps");
    for (int i = 0; i < s.num_lt_sps; i++) {
      s.lt_lsb_sps[i] = int(b.u(s.log2_max_poc_lsb));
      s.lt_used_sps[i] = b.u(1);
    }
  }
  s.tmvp = b.u(1);
  s.strong_smoothing = b.u(1);
  if (b.u(1)) {  // vui_parameters_present_flag
    if (b.u(1) && b.u(8) == 255) b.u(32);  // aspect ratio
    if (b.u(1)) b.u(1);                      // overscan
    if (b.u(1)) {                            // video_signal_type_present_flag
      b.u(3);
      s.full_range = int(b.u(1));
      if (b.u(1)) {
        b.u(16);
        s.matrix = int(b.u(8));
      }
    }
    if (b.u(1)) {  // chroma_loc_info_present_flag
      b.ue();
      b.ue();
    }
    b.u(1);  // neutral_chroma_indication_flag
    if (b.u(1)) refuse("field_seq_flag 1 (fields coded as pictures)");
    b.u(1);  // frame_field_info_present_flag
    if (b.u(1)) {  // default_display_window_flag: libavcodec does not apply it
      b.ue();
      b.ue();
      b.ue();
      b.ue();
    }
    if (b.u(1)) {  // vui_timing_info_present_flag
      b.u(32);
      b.u(32);
      if (b.u(1)) b.ue();
      if (b.u(1)) skip_hrd(b, max_sub_layers_minus1);
    }
    if (b.u(1)) {  // bitstream_restriction_flag
      b.u(3);
      for (int i = 0; i < 5; i++) b.ue();
    }
  }
  if (b.u(1)) {  // sps_extension_present_flag
    int flags = int(b.u(8));
    if (flags & 0x80) refuse("the range extension (sps_range_extension_flag)");
    if (flags & 0x40) refuse("the multilayer extension (sps_multilayer_extension_flag)");
    if (flags & 0x20) refuse("the 3D extension (sps_3d_extension_flag)");
    if (flags & 0x10) refuse("the SCC extension (sps_scc_extension_flag)");
  }
  if (s.matrix >= 8)
    refuse("matrix_coefficients " + std::to_string(s.matrix) +
           " (a colour matrix cv2 does not convert)");
  int min_cb = 1 << s.log2_min_cb;
  if (s.width == 0 || s.height == 0 || s.width % min_cb || s.height % min_cb)
    corrupt("picture size not a multiple of the minimum coding block");
  if (s.crop_l + s.crop_r >= s.width || s.crop_t + s.crop_b >= s.height)
    corrupt("conformance window out of range");
  s.ctb_w = (s.width + (1 << s.log2_ctb) - 1) >> s.log2_ctb;
  s.ctb_h = (s.height + (1 << s.log2_ctb) - 1) >> s.log2_ctb;
  s.valid = true;
  table[id] = s;
}

void parse_pps(Bits& b, Pps* table, const Sps* spss) {
  Pps p;
  int id = b.ue_max(63, "pps_pic_parameter_set_id");
  p.sps_id = b.ue_max(15, "pps_seq_parameter_set_id");
  p.dependent_slices = b.u(1);
  p.output_flag_present = b.u(1);
  p.extra_bits = int(b.u(3));
  p.sign_hiding = b.u(1);
  p.cabac_init_present = b.u(1);
  p.num_ref_default[0] = b.ue_max(14, "num_ref_idx_l0_default_active_minus1") + 1;
  p.num_ref_default[1] = b.ue_max(14, "num_ref_idx_l1_default_active_minus1") + 1;
  p.init_qp = 26 + b.se_in(-26, 25, "init_qp_minus26");
  p.constrained_intra = b.u(1);
  p.transform_skip = b.u(1);
  p.cu_qp_delta = b.u(1);
  if (p.cu_qp_delta) p.diff_cu_qp_delta_depth = b.ue_max(3, "diff_cu_qp_delta_depth");
  p.cb_qp_offset = b.se_in(-12, 12, "pps_cb_qp_offset");
  p.cr_qp_offset = b.se_in(-12, 12, "pps_cr_qp_offset");
  p.slice_chroma_qp_offsets = b.u(1);
  p.weighted_pred = b.u(1);
  p.weighted_bipred = b.u(1);
  if (b.u(1)) refuse("transquant_bypass (transquant_bypass_enabled_flag)");
  if (b.u(1)) refuse("tiles (tiles_enabled_flag)");
  p.wpp = b.u(1);
  p.loop_filter_across_slices = b.u(1);
  if (b.u(1)) {  // deblocking_filter_control_present_flag
    p.deblock_override = b.u(1);
    p.deblock_disabled = b.u(1);
    if (!p.deblock_disabled) {
      p.beta_offset = 2 * b.se_in(-6, 6, "pps_beta_offset_div2");
      p.tc_offset = 2 * b.se_in(-6, 6, "pps_tc_offset_div2");
    }
  }
  p.has_scaling = b.u(1);
  if (p.has_scaling) p.sl.parse(b);
  p.lists_modification = b.u(1);
  p.log2_par_mrg = b.ue_max(4, "log2_parallel_merge_level_minus2") + 2;
  p.slice_header_ext = b.u(1);
  if (b.u(1)) {  // pps_extension_present_flag
    int flags = int(b.u(8));
    if (flags & 0x80) refuse("the range extension (pps_range_extension_flag)");
    if (flags & 0x40) refuse("the multilayer extension (pps_multilayer_extension_flag)");
    if (flags & 0x20) refuse("the 3D extension (pps_3d_extension_flag)");
    if (flags & 0x10) refuse("the SCC extension (pps_scc_extension_flag)");
  }
  const Sps& s = spss[p.sps_id];
  if (s.valid && p.log2_par_mrg > s.log2_ctb) corrupt("log2_parallel_merge_level out of range");
  if (s.valid && p.diff_cu_qp_delta_depth > s.log2_ctb - s.log2_min_cb)
    corrupt("diff_cu_qp_delta_depth out of range");
  p.valid = true;
  table[id] = p;
}

// ------------------------------------------------------------- pictures

// a 4x4 luma block's motion: its vectors, reference indices and (for
// deblocking and the collocated vectors of later pictures) the POC of each
// reference and whether it was long-term when the picture was decoded
struct MvField {
  int16_t mv[2][2];
  int8_t ref_idx[2];
  uint8_t pred;  // bit 0: list 0 used, bit 1: list 1; 0: intra (or none)
  uint8_t lt[2];
  int32_t ref_poc[2];
};

struct Picture {
  int poc = 0;
  bool short_ref = false, long_ref = false, output = false, phantom = false;
  int w = 0, h = 0;  // coded size
  std::vector<uint8_t> y, u, v;
  std::vector<MvField> mvf;  // by 4x4 block
  int crop_l = 0, crop_r = 0, crop_t = 0, crop_b = 0, matrix = 2, full_range = 0;
  char kind = 'I';
  double ms = 0;
  bool ref() const { return short_ref || long_ref; }
};
using PicPtr = std::shared_ptr<Picture>;

struct PredWeight {
  int luma_w, luma_o, chroma_w[2], chroma_o[2];
};

struct SliceHeader {
  bool first_in_pic = false, no_output_of_prior = false, dependent = false;
  int pps_id = 0, address = 0, type = 2;  // 0 B, 1 P, 2 I
  bool pic_output = true;
  int poc_lsb = 0;
  Rps st;
  const Rps* st_rps = nullptr;
  int num_lt = 0;
  int lt_poc[33] = {};
  bool lt_used[33] = {}, lt_msb[33] = {};
  bool tmvp = false, sao_luma = false, sao_chroma = false;
  int num_ref[2] = {0, 0};
  bool mod_flag[2] = {false, false};
  int list_entry[2][16];
  bool mvd_l1_zero = false, cabac_init = false, col_from_l0 = true;
  int col_ref_idx = 0;
  int luma_log2_wd = 0, chroma_log2_wd = 0;
  PredWeight pw[2][16];
  int max_merge = 5, qp = 26, cb_qp_offset = 0, cr_qp_offset = 0;
  bool deblock_disabled = false, loop_filter_across = false;
  int beta_offset = 0, tc_offset = 0;
  size_t data_byte = 0;  // the slice data's first byte in the RBSP
};

// the picture's per-CTB state that outlives its slices (in-loop filters)
struct CtbInfo {
  int slice_addr;  // SliceAddrRs of the CTB's slice (-1: not decoded)
  int8_t beta_offset, tc_offset;
  bool across;  // loop filters across slices
  uint8_t sao_type[3], sao_band[3], sao_eo[3];
  int8_t sao_off[3][4];
};

enum PartMode { PART_2Nx2N, PART_2NxN, PART_Nx2N, PART_NxN, PART_2NxnU, PART_2NxnD, PART_nLx2N,
                PART_nRx2N };
enum { PRED_L0 = 0, PRED_L1 = 1, PRED_BI = 2 };

inline int ceil_log2(int v) {
  int k = 0;
  while ((1 << k) < v) k++;
  return k;
}

struct Decoder {
  Sps spss[16];
  Pps ppss[64];
  const Sps* sps = nullptr;
  const Pps* pps = nullptr;
  SliceHeader sh;
  std::vector<PicPtr> dpb;  // the decoded picture buffer (the current picture too)
  PicPtr cur;               // the picture being decoded
  std::deque<PicPtr> out;   // pictures output, in output order
  bool cur_skipped = false; // the current picture is a RASL picture not decoded
  std::chrono::steady_clock::time_point t0;

  // 8.3.1 and libavcodec's handling of leading pictures and EOS
  int poc = 0, poc_tid0 = 0, max_ra = INT32_MAX;
  bool last_eos = false, no_rasl_output = false, first_picture = true;
  int nut = 0, temporal_id = 0;

  // the current slice's reference lists: each entry's picture, POC and
  // whether it is long-term
  Picture* rpl[2][16];
  int rpl_poc[2][16];
  uint8_t rpl_lt[2][16];
  bool no_backward_pred = true;

  // picture geometry and per-4x4 state of the current picture
  int W = 0, H = 0, w4 = 0, log2ctb = 4, ctb_size = 16, zstride = 0;
  std::vector<uint16_t> zidx;  // z-order of each min TB inside a CTB
  std::vector<uint8_t> ctd, skipf, intra, ipm, nzf, bs_v, bs_h;
  std::vector<int8_t> qpm;
  std::vector<CtbInfo> ctbs;
  std::vector<uint8_t> wpp_state, wpp_mps;  // contexts after each row's 2nd CTB

  // the slice being decoded
  Cabac cb;
  std::vector<uint8_t> rbsp;
  int slice_addr = 0, ctb_addr = 0;
  int qp_y = 26, qpy_pred = 26, cu_qp_delta = 0;
  bool is_cu_qp_delta_coded = false, first_qp_group = true;

  // the coding unit being decoded
  int cu_x = 0, cu_y = 0, cu_log2 = 3, cu_depth = 0, part = PART_2Nx2N, chroma_mode = 0;
  bool cu_intra = false, cu_merge = false, intra_split = false;
  int max_trafo_depth = 0;

  // residual scratch
  int32_t coeff[32 * 32];
  int16_t res[32 * 32];
  uint8_t sf[32 * 32];

  // ------------------------------------------------------------- NALs

  // decodes one access unit's NAL units; a picture ends with the unit
  void decode_au(const uint8_t* d, size_t n, int length_size) {
    size_t p = 0;
    while (p < n) {
      if (p + size_t(length_size) > n) corrupt("truncated NAL unit length");
      size_t len = 0;
      for (int i = 0; i < length_size; i++) len = len << 8 | d[p + i];
      p += size_t(length_size);
      if (len > n - p) corrupt("NAL unit overruns its sample");
      nal(d + p, len);
      p += len;
    }
    finish_picture();
  }

  void nal(const uint8_t* d, size_t n) {
    if (n < 2) corrupt("truncated NAL unit header");
    if (d[0] & 0x80) corrupt("forbidden_zero_bit set");
    int type = (d[0] >> 1) & 63, layer = ((d[0] & 1) << 5) | (d[1] >> 3), tid1 = d[1] & 7;
    if (tid1 == 0) corrupt("nuh_temporal_id_plus1 is 0");
    if (layer > 0) return;  // as libavcodec: layers above the base are skipped
    switch (type) {
      case 33: {
        auto r = rbsp_of(d + 2, n - 2);
        Bits b(r.data(), r.size());
        parse_sps(b, spss);
        return;
      }
      case 34: {
        auto r = rbsp_of(d + 2, n - 2);
        Bits b(r.data(), r.size());
        parse_pps(b, ppss, spss);
        return;
      }
      case 36:
      case 37:  // end of sequence or bitstream: the next picture starts anew
        finish_picture();
        last_eos = true;
        max_ra = INT32_MAX;
        return;
      default:
        break;
    }
    if ((type >= 10 && type <= 15) || type >= 22) return;  // reserved, VPS, AUD, SEI, FD
    nut = type;
    temporal_id = tid1 - 1;
    slice(d, n);
  }

  bool is_irap() const { return nut >= 16 && nut <= 23; }
  bool is_idr() const { return nut == 19 || nut == 20; }
  bool is_bla() const { return nut >= 16 && nut <= 18; }

  // ----------------------------------------------------- slice header

  void parse_slice_header(Bits& b) {
    SliceHeader& s = sh;
    bool first = b.u(1);
    if (!first && !cur && !cur_skipped) corrupt("a slice segment without the picture's first");
    s.first_in_pic = first;
    s.no_output_of_prior = is_irap() ? b.u(1) : false;
    s.pps_id = b.ue_max(63, "slice_pic_parameter_set_id");
    if (!ppss[s.pps_id].valid) corrupt("slice refers to a missing PPS");
    pps = &ppss[s.pps_id];
    if (!spss[pps->sps_id].valid) corrupt("PPS refers to a missing SPS");
    sps = &spss[pps->sps_id];
    int total = sps->ctb_w * sps->ctb_h;
    s.dependent = false;
    s.address = 0;
    if (!first) {
      if (pps->dependent_slices) s.dependent = b.u(1);
      s.address = int(b.u(ceil_log2(total)));
      if (s.address >= total) corrupt("slice_segment_address out of range");
    }
    if (s.dependent) refuse("dependent slice segments (dependent_slice_segment_flag)");
    b.u(pps->extra_bits);
    s.type = b.ue_max(2, "slice_type");
    s.pic_output = pps->output_flag_present ? bool(b.u(1)) : true;
    s.st_rps = nullptr;
    s.num_lt = 0;
    s.tmvp = false;
    s.poc_lsb = 0;
    if (!is_idr()) {
      s.poc_lsb = int(b.u(sps->log2_max_poc_lsb));
      if (!b.u(1)) {  // short_term_ref_pic_set_sps_flag
        s.st = parse_rps(b, sps->rps, sps->rps.size(), true);
        s.st_rps = &s.st;
      } else {
        if (sps->rps.empty()) corrupt("no short-term RPS in the SPS");
        int idx = sps->rps.size() > 1 ? int(b.u(ceil_log2(int(sps->rps.size())))) : 0;
        if (idx >= int(sps->rps.size())) corrupt("short_term_ref_pic_set_idx out of range");
        s.st_rps = &sps->rps[size_t(idx)];
      }
      if (sps->lt_present) {
        int n_sps = sps->num_lt_sps > 0 ? b.ue_max(uint32_t(sps->num_lt_sps), "num_long_term_sps") : 0;
        int n_pics = b.ue_max(uint32_t(32 - n_sps), "num_long_term_pics");
        s.num_lt = n_sps + n_pics;
        int max_lsb = 1 << sps->log2_max_poc_lsb, prev = 0;
        for (int i = 0; i < s.num_lt; i++) {
          int lsb;
          bool used;
          if (i < n_sps) {
            int idx = sps->num_lt_sps > 1 ? int(b.u(ceil_log2(sps->num_lt_sps))) : 0;
            if (idx >= sps->num_lt_sps) corrupt("lt_idx_sps out of range");
            lsb = sps->lt_lsb_sps[idx];
            used = sps->lt_used_sps[idx];
          } else {
            lsb = int(b.u(sps->log2_max_poc_lsb));
            used = b.u(1);
          }
          s.lt_msb[i] = b.u(1);
          s.lt_used[i] = used;
          s.lt_poc[i] = lsb;
          if (s.lt_msb[i]) {
            // (7-52) as libavcodec sums DeltaPocMsbCycleLt: from the last
            // entry that has one, restarting at entries 0 and num_long_term_sps
            int delta = b.ue_max(1u << 24, "delta_poc_msb_cycle_lt");
            if (i && i != n_sps) delta += prev;
            prev = delta;
            s.lt_poc[i] = lsb - delta * max_lsb;  // + PicOrderCntVal - slice lsb (8-5)
          }
        }
      }
      if (sps->tmvp) s.tmvp = b.u(1);
    }
    s.sao_luma = s.sao_chroma = false;
    if (sps->sao) {
      s.sao_luma = b.u(1);
      s.sao_chroma = b.u(1);
    }
    s.num_ref[0] = s.num_ref[1] = 0;
    s.mod_flag[0] = s.mod_flag[1] = false;
    s.mvd_l1_zero = s.cabac_init = false;
    s.col_from_l0 = true;
    s.col_ref_idx = 0;
    s.max_merge = 5;
    if (s.type != 2) {
      s.num_ref[0] = pps->num_ref_default[0];
      s.num_ref[1] = s.type == 0 ? pps->num_ref_default[1] : 0;
      if (b.u(1)) {
        s.num_ref[0] = b.ue_max(14, "num_ref_idx_l0_active_minus1") + 1;
        if (s.type == 0) s.num_ref[1] = b.ue_max(14, "num_ref_idx_l1_active_minus1") + 1;
      }
      int total_curr = num_pic_total_curr();
      if (pps->lists_modification && total_curr > 1) {
        int bits = ceil_log2(total_curr);
        for (int l = 0; l < (s.type == 0 ? 2 : 1); l++) {
          s.mod_flag[l] = b.u(1);
          if (s.mod_flag[l])
            for (int i = 0; i < s.num_ref[l]; i++) {
              s.list_entry[l][i] = int(b.u(bits));
              if (s.list_entry[l][i] >= total_curr) corrupt("list_entry out of range");
            }
        }
      }
      if (s.type == 0) s.mvd_l1_zero = b.u(1);
      if (pps->cabac_init_present) s.cabac_init = b.u(1);
      if (s.tmvp) {
        if (s.type == 0) s.col_from_l0 = b.u(1);
        int l = s.col_from_l0 ? 0 : 1;
        if (s.num_ref[l] > 1) s.col_ref_idx = b.ue_max(uint32_t(s.num_ref[l] - 1), "collocated_ref_idx");
      }
      if ((pps->weighted_pred && s.type == 1) || (pps->weighted_bipred && s.type == 0))
        pred_weight_table(b);
      s.max_merge = 5 - b.ue_max(4, "five_minus_max_num_merge_cand");
    }
    s.qp = pps->init_qp + b.se_in(-26 - pps->init_qp + 26, 25 - pps->init_qp + 26, "slice_qp_delta");
    if (s.qp < 0 || s.qp > 51) corrupt("slice QP out of range");
    s.cb_qp_offset = s.cr_qp_offset = 0;
    if (pps->slice_chroma_qp_offsets) {
      s.cb_qp_offset = b.se_in(-12, 12, "slice_cb_qp_offset");
      s.cr_qp_offset = b.se_in(-12, 12, "slice_cr_qp_offset");
      if (std::abs(s.cb_qp_offset + pps->cb_qp_offset) > 12 ||
          std::abs(s.cr_qp_offset + pps->cr_qp_offset) > 12)
        corrupt("chroma QP offsets out of range");
    }
    // as libavcodec: a slice that overrides the deblocking to disable it
    // keeps the offsets of the slice header read before it (they are read
    // at the edges it shares with a slice that deblocks)
    s.deblock_disabled = pps->deblock_disabled;
    if (pps->deblock_override && b.u(1)) {
      s.deblock_disabled = b.u(1);
      if (!s.deblock_disabled) {
        s.beta_offset = 2 * b.se_in(-6, 6, "slice_beta_offset_div2");
        s.tc_offset = 2 * b.se_in(-6, 6, "slice_tc_offset_div2");
      }
    } else {
      s.beta_offset = pps->beta_offset;
      s.tc_offset = pps->tc_offset;
    }
    s.loop_filter_across = pps->loop_filter_across_slices;
    if (pps->loop_filter_across_slices && (s.sao_luma || s.sao_chroma || !s.deblock_disabled))
      s.loop_filter_across = b.u(1);
    if (pps->wpp) {
      int entries = b.ue_max(uint32_t(sps->ctb_h - 1), "num_entry_point_offsets");
      if (entries > 0) {
        int len = b.ue_max(31, "offset_len_minus1") + 1;
        for (int i = 0; i < entries; i++) b.u(len);
      }
    }
    if (pps->slice_header_ext) {
      int len = b.ue_max(256, "slice_segment_header_extension_length");
      for (int i = 0; i < len; i++) b.u(8);
    }
    if (!b.u(1)) corrupt("slice header without its alignment bit");
    while (b.pos & 7)
      if (b.u(1)) corrupt("slice header alignment bits not zero");
    s.data_byte = b.pos / 8;
  }

  int num_pic_total_curr() const {
    int n = 0;
    if (sh.st_rps)
      for (int i = 0; i < sh.st_rps->total(); i++) n += sh.st_rps->used[i];
    for (int i = 0; i < sh.num_lt; i++) n += sh.lt_used[i];
    return n;
  }

  // 7.3.6.3: pred_weight_table()
  void pred_weight_table(Bits& b) {
    SliceHeader& s = sh;
    s.luma_log2_wd = b.ue_max(7, "luma_log2_weight_denom");
    s.chroma_log2_wd = s.luma_log2_wd + b.se_in(-s.luma_log2_wd, 7 - s.luma_log2_wd,
                                                "delta_chroma_log2_weight_denom");
    for (int l = 0; l < (s.type == 0 ? 2 : 1); l++) {
      bool lf[16], cf[16];
      for (int i = 0; i < s.num_ref[l]; i++) lf[i] = b.u(1);
      for (int i = 0; i < s.num_ref[l]; i++) cf[i] = b.u(1);
      for (int i = 0; i < s.num_ref[l]; i++) {
        PredWeight& w = s.pw[l][i];
        w.luma_w = 1 << s.luma_log2_wd;
        w.luma_o = 0;
        if (lf[i]) {
          w.luma_w += b.se_in(-128, 127, "delta_luma_weight");
          w.luma_o = b.se_in(-128, 127, "luma_offset");
        }
        for (int j = 0; j < 2; j++) {
          w.chroma_w[j] = 1 << s.chroma_log2_wd;
          w.chroma_o[j] = 0;
          if (cf[i]) {
            w.chroma_w[j] += b.se_in(-128, 127, "delta_chroma_weight");
            int d = b.se_in(-512, 511, "delta_chroma_offset");
            w.chroma_o[j] = clip3(-128, 127, (128 + d - ((128 * w.chroma_w[j]) >> s.chroma_log2_wd)));
          }
        }
      }
    }
  }

  // --------------------------------------------------- pictures: POC, RPS

  void slice(const uint8_t* d, size_t n) {
    rbsp = rbsp_of(d + 2, n - 2);
    Bits b(rbsp.data(), rbsp.size());
    bool first = b.bit();
    b.pos = 0;
    if (first) finish_picture();
    parse_slice_header(b);
    if (sh.first_in_pic) {
      if (!start_picture()) return;
    } else if (cur_skipped) {
      return;
    }
    if (!cur) return;
    build_lists();
    decode_slice();
  }

  // libavcodec's POC (its ff_hevc_compute_poc): the MSB from the previous
  // TemporalId-0 picture, 0 for BLA pictures only (a CRA's with
  // NoRaslOutputFlag is not reset)
  int compute_poc(int lsb) const {
    int max = 1 << sps->log2_max_poc_lsb;
    int prev_lsb = poc_tid0 % max, prev_msb = poc_tid0 - prev_lsb, msb;
    if (lsb < prev_lsb && prev_lsb - lsb >= max / 2) msb = prev_msb + max;
    else if (lsb > prev_lsb && lsb - prev_lsb > max / 2) msb = prev_msb - max;
    else msb = prev_msb;
    if (is_bla()) msb = 0;
    return msb + lsb;
  }

  // the first slice of a picture: POC, the RASL rule, the RPS, output;
  // false for a picture that is not decoded
  bool start_picture() {
    poc = is_idr() ? 0 : compute_poc(sh.poc_lsb);
    // libavcodec's handling of leading pictures: the RASL pictures of the
    // first CRA (or BLA) after a start or EOS are not decoded
    if (max_ra == INT32_MAX) {
      if (nut == 21 || is_bla()) max_ra = poc;
      else if (is_idr()) max_ra = INT32_MIN;
    }
    if ((nut == 8 || nut == 9) && poc <= max_ra) {
      cur_skipped = true;
      return false;
    }
    if (nut == 9 && poc > max_ra) max_ra = INT32_MIN;
    cur_skipped = false;
    if (is_irap()) no_rasl_output = is_idr() || is_bla() || first_picture || last_eos;
    bool no_output_of_prior = sh.no_output_of_prior;
    if (nut == 21 && last_eos) no_output_of_prior = true;
    if (temporal_id == 0 && !(nut <= 14 && nut % 2 == 0) && nut != 7 && nut != 9) poc_tid0 = poc;
    // an IRAP picture with NoRaslOutputFlag: every picture before it leaves
    // (or is dropped) first; an IDR one releases every reference
    if (is_irap() && no_rasl_output) {
      if (!first_picture) {
        while (bump(0, 0, no_output_of_prior)) {
        }
      }
      for (auto& p : dpb) p->short_ref = p->long_ref = false;
      release();
    }
    last_eos = false;
    first_picture = false;
    t0 = std::chrono::steady_clock::now();
    new_picture();
    apply_rps();
    int max_dec = sps->max_dec, reorder = sps->num_reorder;
    while (bump(reorder, max_dec, false)) {
    }
    return true;
  }

  // libavcodec's output (ff_hevc_output_frames): while more pictures await
  // output than max_output, or any awaits it and the buffer holds more than
  // max_dpb, the one of the smallest POC leaves (dropped with discard)
  bool bump(int max_output, int max_dpb, bool discard) {
    int nb_output = 0, nb_dpb = 0;
    Picture* best = nullptr;
    for (auto& p : dpb) {
      if (p->output) {
        nb_output++;
        if (!best || p->poc < best->poc) best = p.get();
      }
      nb_dpb += p->output || p->ref();
    }
    if (!(nb_output > max_output || (nb_output && nb_dpb > max_dpb))) return false;
    for (auto& p : dpb)
      if (p.get() == best) {
        best->output = false;
        if (!discard) out.push_back(p);
      }
    release();
    return true;
  }

  // drops the pictures neither awaiting output nor used for reference
  void release() {
    dpb.erase(std::remove_if(dpb.begin(), dpb.end(),
                             [&](const PicPtr& p) { return p != cur && !p->output && !p->ref(); }),
              dpb.end());
  }

  void new_picture() {
    W = sps->width;
    H = sps->height;
    log2ctb = sps->log2_ctb;
    ctb_size = 1 << log2ctb;
    for (auto& p : dpb)
      if (!p->phantom && (p->w != W || p->h != H)) refuse("a change of picture size");
    cur = std::make_shared<Picture>();
    Picture& c = *cur;
    c.poc = poc;
    c.w = W;
    c.h = H;
    c.y.assign(size_t(W) * H, 0);
    c.u.assign(size_t(W / 2) * (H / 2), 0);
    c.v.assign(size_t(W / 2) * (H / 2), 0);
    w4 = W / 4;
    size_t n4 = size_t(w4) * (H / 4);
    c.mvf.assign(n4, MvField{});
    c.crop_l = sps->crop_l;
    c.crop_r = sps->crop_r;
    c.crop_t = sps->crop_t;
    c.crop_b = sps->crop_b;
    c.matrix = sps->matrix;
    c.full_range = sps->full_range;
    c.kind = "BPI"[sh.type];
    c.output = sh.pic_output;
    c.short_ref = true;
    ctd.assign(n4, 0);
    skipf.assign(n4, 0);
    intra.assign(n4, 0);
    ipm.assign(n4, 1);
    nzf.assign(n4, 0);
    bs_v.assign(n4, 0);
    bs_h.assign(n4, 0);
    qpm.assign(n4, 0);
    ctbs.assign(size_t(sps->ctb_w) * sps->ctb_h, CtbInfo{});
    for (auto& ci : ctbs) ci.slice_addr = -1;
    int per = 1 << (log2ctb - sps->log2_min_tb);
    zstride = per;
    zidx.assign(size_t(per) * per, 0);
    for (int y = 0; y < per; y++)
      for (int x = 0; x < per; x++) {
        int z = 0;
        for (int bit = 0; bit < 6; bit++) z |= ((x >> bit) & 1) << (2 * bit) | ((y >> bit) & 1) << (2 * bit + 1);
        zidx[size_t(y) * per + x] = uint16_t(z);
      }
    wpp_state.assign(NUM_CTX, 0);
    wpp_mps.assign(NUM_CTX, 0);
    dpb.push_back(cur);
  }

  // 8.3.2: the reference picture set; pictures it does not name are no
  // longer references. A picture it names for later pictures only that is
  // not in the buffer takes a slot there for this picture, as libavcodec
  // generates one; one the current picture uses is refused.
  std::vector<Picture*> st_before, st_after, lt_curr;
  void apply_rps() {
    dpb.erase(std::remove_if(dpb.begin(), dpb.end(), [](const PicPtr& p) { return p->phantom; }),
              dpb.end());
    for (auto& p : dpb)
      if (p != cur) p->short_ref = p->long_ref = false;
    st_before.clear();
    st_after.clear();
    lt_curr.clear();
    std::vector<PicPtr> keep;
    auto find = [&](int want, bool full) -> PicPtr {
      int mask = full ? -1 : (1 << sps->log2_max_poc_lsb) - 1;
      for (auto& p : dpb)
        if (p != cur && (p->poc & mask) == want) return p;
      return nullptr;
    };
    auto missing = [&](int want, bool used) -> PicPtr {
      if (used) refuse("a reference missing from the DPB (POC " + std::to_string(want) + ")");
      auto ph = std::make_shared<Picture>();
      ph->phantom = true;
      ph->poc = want;
      dpb.push_back(ph);
      return ph;
    };
    if (sh.st_rps) {
      const Rps& r = *sh.st_rps;
      for (int i = 0; i < r.total(); i++) {
        int want = poc + r.delta[i];
        PicPtr p = find(want, true);
        if (!p) p = missing(want, r.used[i]);
        p->short_ref = true;
        if (r.used[i]) (i < r.num_neg ? st_before : st_after).push_back(p.get());
      }
    }
    int max_lsb = 1 << sps->log2_max_poc_lsb;
    for (int i = 0; i < sh.num_lt; i++) {
      int want = sh.lt_poc[i];
      if (sh.lt_msb[i]) want += poc - sh.poc_lsb;  // (8-5)
      PicPtr p = find(sh.lt_msb[i] ? want : want & (max_lsb - 1), sh.lt_msb[i]);
      if (!p) p = missing(want, sh.lt_used[i]);
      p->short_ref = false;
      p->long_ref = true;
      if (sh.lt_used[i]) lt_curr.push_back(p.get());
    }
    release();
  }

  // 8.3.4: RefPicList0 and RefPicList1 of the slice
  void build_lists() {
    no_backward_pred = true;
    if (sh.type == 2) return;
    int total = int(st_before.size() + st_after.size() + lt_curr.size());
    if (total == 0) corrupt("a P or B slice without references");
    for (int l = 0; l < (sh.type == 0 ? 2 : 1); l++) {
      std::vector<std::pair<Picture*, bool>> temp;
      int want = std::max(sh.num_ref[l], total);
      const auto& first = l == 0 ? st_before : st_after;
      const auto& second = l == 0 ? st_after : st_before;
      while (int(temp.size()) < want) {
        for (auto* p : first)
          if (int(temp.size()) < want) temp.push_back({p, false});
        for (auto* p : second)
          if (int(temp.size()) < want) temp.push_back({p, false});
        for (auto* p : lt_curr)
          if (int(temp.size()) < want) temp.push_back({p, true});
      }
      for (int i = 0; i < sh.num_ref[l]; i++) {
        auto e = temp[size_t(sh.mod_flag[l] ? sh.list_entry[l][i] : i)];
        if (e.first->phantom) refuse("a reference missing from the DPB");
        rpl[l][i] = e.first;
        rpl_poc[l][i] = e.first->poc;
        rpl_lt[l][i] = e.second;
        if (e.first->poc > poc) no_backward_pred = false;
      }
    }
  }

  // ------------------------------------------------------------ slice data

  inline size_t at4(int x, int y) const { return size_t(y >> 2) * size_t(w4) + size_t(x >> 2); }

  template <class T>
  void fill4(std::vector<T>& a, int x0, int y0, int w, int h, T v) {
    for (int y = y0 >> 2; y < (y0 + h) >> 2; y++)
      for (int x = x0 >> 2; x < (x0 + w) >> 2; x++) a[size_t(y) * w4 + x] = v;
  }

  // 6.4.1: the block at (xn, yn) is available to the one at (xc, yc): in
  // the picture, in the same slice, and before it in z-scan order
  inline bool zavail(int xc, int yc, int xn, int yn) const {
    if (xn < 0 || yn < 0 || xn >= W || yn >= H) return false;
    int cn = (yn >> log2ctb) * sps->ctb_w + (xn >> log2ctb);
    int cc = (yc >> log2ctb) * sps->ctb_w + (xc >> log2ctb);
    if (cn > cc || ctbs[size_t(cn)].slice_addr != slice_addr) return false;
    if (cn < cc) return true;
    int m = ctb_size - 1, s = sps->log2_min_tb;
    return zidx[size_t(((yn & m) >> s) * zstride + ((xn & m) >> s))] <=
           zidx[size_t(((yc & m) >> s) * zstride + ((xc & m) >> s))];
  }

  void decode_slice() {
    slice_addr = sh.address;
    ctb_addr = sh.address;
    cb.start(rbsp.data(), rbsp.size(), sh.data_byte);
    int init_type = sh.type == 2 ? 0 : sh.type == 1 ? (sh.cabac_init ? 2 : 1) : (sh.cabac_init ? 1 : 2);
    cb.init_contexts(init_type, sh.qp);
    qp_y = qpy_pred = sh.qp;
    first_qp_group = true;
    int cw = sps->ctb_w, total = cw * sps->ctb_h;
    for (;;) {
      int rx = ctb_addr % cw, ry = ctb_addr / cw;
      CtbInfo& ci = ctbs[size_t(ctb_addr)];
      if (ci.slice_addr != -1) corrupt("a CTB coded twice");
      ci.slice_addr = slice_addr;
      ci.beta_offset = int8_t(sh.beta_offset);
      ci.tc_offset = int8_t(sh.tc_offset);
      ci.across = sh.loop_filter_across;
      for (int c = 0; c < 3; c++) ci.sao_type[c] = 0;
      if (sh.sao_luma || sh.sao_chroma) parse_sao(rx, ry);
      coding_quadtree(rx << log2ctb, ry << log2ctb, log2ctb, 0);
      int end = cb.terminate();
      ctb_addr++;
      // WPP: the contexts after each row's second CTB start the next row
      if (pps->wpp && cw >= 2 && (ctb_addr - 1) % cw == 1) {
        memcpy(wpp_state.data(), cb.state, NUM_CTX);
        memcpy(wpp_mps.data(), cb.mps, NUM_CTX);
      }
      if (end) break;
      if (ctb_addr >= total) corrupt("slice data runs past the picture");
      if (pps->wpp && ctb_addr % cw == 0) {
        if (!cb.terminate()) corrupt("end_of_subset_one_bit is not 1");
        cb.restart();
        if (cw == 1) {
          cb.init_contexts(init_type, sh.qp);
        } else {
          memcpy(cb.state, wpp_state.data(), NUM_CTX);
          memcpy(cb.mps, wpp_mps.data(), NUM_CTX);
        }
        first_qp_group = true;
      }
    }
  }

  // 7.3.8.3: sao(rx, ry)
  void parse_sao(int rx, int ry) {
    CtbInfo& ci = ctbs[size_t(ctb_addr)];
    int cw = sps->ctb_w;
    bool merge_left = false, merge_up = false;
    if (rx > 0 && ctbs[size_t(ctb_addr - 1)].slice_addr == slice_addr) merge_left = cb.decision(SAO_MERGE);
    if (ry > 0 && !merge_left && ctbs[size_t(ctb_addr - cw)].slice_addr == slice_addr)
      merge_up = cb.decision(SAO_MERGE);
    if (merge_left || merge_up) {
      const CtbInfo& from = ctbs[size_t(merge_left ? ctb_addr - 1 : ctb_addr - cw)];
      memcpy(ci.sao_type, from.sao_type, 3);
      memcpy(ci.sao_band, from.sao_band, 3);
      memcpy(ci.sao_eo, from.sao_eo, 3);
      memcpy(ci.sao_off, from.sao_off, sizeof ci.sao_off);
      return;
    }
    for (int c = 0; c < 3; c++) {
      if ((c == 0 && !sh.sao_luma) || (c > 0 && !sh.sao_chroma)) {
        ci.sao_type[c] = 0;
        continue;
      }
      if (c == 2) {
        ci.sao_type[2] = ci.sao_type[1];
        ci.sao_eo[2] = ci.sao_eo[1];
      } else {
        ci.sao_type[c] = uint8_t(!cb.decision(SAO_TYPE) ? 0 : cb.bypass() ? 2 : 1);
      }
      if (!ci.sao_type[c]) continue;
      int abs_v[4];
      for (int i = 0; i < 4; i++) {
        int v = 0;
        while (v < 7 && cb.bypass()) v++;
        abs_v[i] = v;
      }
      if (ci.sao_type[c] == 1) {
        for (int i = 0; i < 4; i++) ci.sao_off[c][i] = int8_t(abs_v[i] && cb.bypass() ? -abs_v[i] : abs_v[i]);
        ci.sao_band[c] = uint8_t(cb.bypass_bits(5));
      } else {
        for (int i = 0; i < 4; i++) ci.sao_off[c][i] = int8_t(i < 2 ? abs_v[i] : -abs_v[i]);
        if (c < 2) ci.sao_eo[c] = uint8_t(cb.bypass_bits(2));
      }
    }
  }

  // 7.3.8.4: coding_quadtree(), with libavcodec's bookkeeping of the
  // previous quantization group's QP (qPY_PREV)
  void coding_quadtree(int x0, int y0, int log2, int depth) {
    int size = 1 << log2;
    bool split;
    if (x0 + size <= W && y0 + size <= H && log2 > sps->log2_min_cb) {
      int inc = (zavail(x0, y0, x0 - 1, y0) && ctd[at4(x0 - 1, y0)] > depth) +
                (zavail(x0, y0, x0, y0 - 1) && ctd[at4(x0, y0 - 1)] > depth);
      split = cb.decision(SPLIT_CU + inc);
    } else {
      split = log2 > sps->log2_min_cb;
    }
    int qg = 1 << (log2ctb - pps->diff_cu_qp_delta_depth);
    if (pps->cu_qp_delta && size >= qg) {
      is_cu_qp_delta_coded = false;
      cu_qp_delta = 0;
    }
    if (split) {
      int h = size >> 1, x1 = x0 + h, y1 = y0 + h;
      coding_quadtree(x0, y0, log2 - 1, depth + 1);
      if (x1 < W) coding_quadtree(x1, y0, log2 - 1, depth + 1);
      if (y1 < H) coding_quadtree(x0, y1, log2 - 1, depth + 1);
      if (x1 < W && y1 < H) coding_quadtree(x1, y1, log2 - 1, depth + 1);
      if (((x0 + size) & (qg - 1)) == 0 && ((y0 + size) & (qg - 1)) == 0) qpy_pred = qp_y;
    } else {
      coding_unit(x0, y0, log2, depth);
      if (((x0 + size) % qg == 0 || x0 + size >= W) && ((y0 + size) % qg == 0 || y0 + size >= H))
        qpy_pred = qp_y;
    }
  }

  // 8.6.1 as libavcodec derives QpY (its get_qPy_pred): qPY_PREV is the
  // slice QP until a QG codes cu_qp_delta after the slice's (or a WPP
  // row's) start
  void set_qpy(int xb, int yb) {
    int ctb_mask = ctb_size - 1, qg_mask = (1 << (log2ctb - pps->diff_cu_qp_delta_depth)) - 1;
    int xq = xb - (xb & qg_mask), yq = yb - (yb & qg_mask);
    bool avail_a = (xb & ctb_mask) && (xq & ctb_mask), avail_b = (yb & ctb_mask) && (yq & ctb_mask);
    int pred;
    if (first_qp_group || (!xq && !yq)) {
      first_qp_group = !is_cu_qp_delta_coded;
      pred = sh.qp;
    } else {
      pred = qpy_pred;
    }
    int a = avail_a ? qpm[at4(xq - 1, yq)] : pred;
    int b = avail_b ? qpm[at4(xq, yq - 1)] : pred;
    qp_y = (((a + b + 1) >> 1) + cu_qp_delta + 52) % 52;
  }

  // 7.3.8.5: coding_unit()
  void coding_unit(int x0, int y0, int log2, int depth) {
    int n = 1 << log2;
    cu_x = x0;
    cu_y = y0;
    cu_log2 = log2;
    cu_depth = depth;
    cu_intra = false;
    cu_merge = false;
    intra_split = false;
    part = PART_2Nx2N;
    fill4(ctd, x0, y0, n, n, uint8_t(depth));
    bool skip = false;
    if (sh.type != 2) {
      int inc = (zavail(x0, y0, x0 - 1, y0) && skipf[at4(x0 - 1, y0)]) +
                (zavail(x0, y0, x0, y0 - 1) && skipf[at4(x0, y0 - 1)]);
      skip = cb.decision(SKIP + inc);
    }
    if (skip) {
      fill4(skipf, x0, y0, n, n, uint8_t(1));
      prediction_unit(x0, y0, n, n, 0, true);
      if (!sh.deblock_disabled) boundary_strengths(x0, y0, log2);
    } else {
      cu_intra = sh.type == 2 ? true : bool(cb.decision(PRED_MODE));
      if (!cu_intra || log2 == sps->log2_min_cb) part = parse_part_mode(log2);
      if (cu_intra) {
        fill4(intra, x0, y0, n, n, uint8_t(1));
        intra_split = part == PART_NxN;
        parse_intra_modes(x0, y0, log2);
      } else {
        int h = n / 2, q = n / 4;
        switch (part) {
          case PART_2Nx2N: prediction_unit(x0, y0, n, n, 0, false); break;
          case PART_2NxN:
            prediction_unit(x0, y0, n, h, 0, false);
            prediction_unit(x0, y0 + h, n, h, 1, false);
            break;
          case PART_Nx2N:
            prediction_unit(x0, y0, h, n, 0, false);
            prediction_unit(x0 + h, y0, h, n, 1, false);
            break;
          case PART_2NxnU:
            prediction_unit(x0, y0, n, q, 0, false);
            prediction_unit(x0, y0 + q, n, n - q, 1, false);
            break;
          case PART_2NxnD:
            prediction_unit(x0, y0, n, n - q, 0, false);
            prediction_unit(x0, y0 + n - q, n, q, 1, false);
            break;
          case PART_nLx2N:
            prediction_unit(x0, y0, q, n, 0, false);
            prediction_unit(x0 + q, y0, n - q, n, 1, false);
            break;
          case PART_nRx2N:
            prediction_unit(x0, y0, n - q, n, 0, false);
            prediction_unit(x0 + n - q, y0, q, n, 1, false);
            break;
          default:  // PART_NxN
            prediction_unit(x0, y0, h, h, 0, false);
            prediction_unit(x0 + h, y0, h, h, 1, false);
            prediction_unit(x0, y0 + h, h, h, 2, false);
            prediction_unit(x0 + h, y0 + h, h, h, 3, false);
        }
      }
      bool rqt = true;
      if (!cu_intra && !(part == PART_2Nx2N && cu_merge)) rqt = cb.decision(RQT_ROOT_CBF);
      if (rqt) {
        max_trafo_depth = cu_intra ? sps->depth_intra + intra_split : sps->depth_inter;
        transform_tree(x0, y0, x0, y0, log2, 0, 0, false, false);
      } else if (!sh.deblock_disabled) {
        boundary_strengths(x0, y0, log2);
      }
    }
    if (pps->cu_qp_delta && !is_cu_qp_delta_coded) set_qpy(x0, y0);
    fill4(qpm, x0, y0, n, n, int8_t(qp_y));
  }

  // 9.3.3.7 as libavcodec reads part_mode (the AMP bin on context 3)
  int parse_part_mode(int log2) {
    if (cb.decision(PART_MODE)) return PART_2Nx2N;
    if (log2 == sps->log2_min_cb) {
      if (cu_intra) return PART_NxN;
      if (cb.decision(PART_MODE + 1)) return PART_2NxN;
      if (log2 == 3) return PART_Nx2N;
      return cb.decision(PART_MODE + 2) ? PART_Nx2N : PART_NxN;
    }
    if (!sps->amp) return cb.decision(PART_MODE + 1) ? PART_2NxN : PART_Nx2N;
    if (cb.decision(PART_MODE + 1)) {
      if (cb.decision(PART_MODE + 3)) return PART_2NxN;
      return cb.bypass() ? PART_2NxnD : PART_2NxnU;
    }
    if (cb.decision(PART_MODE + 3)) return PART_Nx2N;
    return cb.bypass() ? PART_nRx2N : PART_nLx2N;
  }

  // 8.4.2: the three most probable luma modes of the block at (x, y)
  void mpm(int x, int y, int* cand) {
    int a = 1, b = 1;
    if (zavail(x, y, x - 1, y) && intra[at4(x - 1, y)]) a = ipm[at4(x - 1, y)];
    if (y - 1 >= ((y >> log2ctb) << log2ctb) && zavail(x, y, x, y - 1) && intra[at4(x, y - 1)])
      b = ipm[at4(x, y - 1)];
    if (a == b) {
      if (a < 2) {
        cand[0] = 0;
        cand[1] = 1;
        cand[2] = 26;
      } else {
        cand[0] = a;
        cand[1] = 2 + ((a + 29) % 32);
        cand[2] = 2 + ((a - 2 + 1) % 32);
      }
    } else {
      cand[0] = a;
      cand[1] = b;
      cand[2] = (a && b) ? 0 : (a != 1 && b != 1) ? 1 : 26;
    }
  }

  void parse_intra_modes(int x0, int y0, int log2) {
    int n = 1 << log2, pb = intra_split ? n / 2 : n, cnt = intra_split ? 4 : 1;
    bool prev[4];
    for (int i = 0; i < cnt; i++) prev[i] = cb.decision(PREV_INTRA);
    for (int i = 0; i < cnt; i++) {
      int x = x0 + (i & 1) * pb, y = y0 + (i >> 1) * pb, cand[3], mode;
      mpm(x, y, cand);
      if (prev[i]) {
        mode = cand[cb.bypass() ? 1 + cb.bypass() : 0];
      } else {
        mode = cb.bypass_bits(5);
        std::sort(cand, cand + 3);
        for (int k = 0; k < 3; k++)
          if (mode >= cand[k]) mode++;
      }
      fill4(ipm, x, y, pb, pb, uint8_t(mode));
    }
    int c = cb.decision(CHROMA_MODE) ? cb.bypass_bits(2) : 4, luma = ipm[at4(x0, y0)];
    if (c == 4) {
      chroma_mode = luma;
    } else {
      static const int kModes[4] = {0, 26, 10, 1};
      chroma_mode = kModes[c] == luma ? 34 : kModes[c];
    }
  }

  // 7.3.8.6: prediction_unit(), its motion derived (8.5.3.2) and predicted
  void prediction_unit(int x, int y, int w, int h, int pidx, bool skip) {
    MvField mf{};
    bool merge = skip || cb.decision(MERGE_FLAG);
    if (pidx == 0) cu_merge = merge;
    if (merge) {
      int idx = 0;
      if (sh.max_merge > 1 && cb.decision(MERGE_IDX)) {
        idx = 1;
        while (idx < sh.max_merge - 1 && cb.bypass()) idx++;
      }
      mf = merge_cand(x, y, w, h, pidx, idx);
    } else {
      int idc = PRED_L0;
      if (sh.type == 0) {
        if (w + h != 12 && cb.decision(INTER_PRED + cu_depth)) idc = PRED_BI;
        else idc = cb.decision(INTER_PRED + 4) ? PRED_L1 : PRED_L0;
      }
      int mvd[2][2] = {{0, 0}, {0, 0}}, ref[2] = {-1, -1}, flag[2] = {0, 0};
      for (int l = 0; l < 2; l++) {
        if ((l == 0 && idc == PRED_L1) || (l == 1 && idc == PRED_L0)) continue;
        ref[l] = 0;
        if (sh.num_ref[l] > 1) {
          int max = sh.num_ref[l] - 1, i = 0;
          while (i < max && i < 2 && cb.decision(REF_IDX + i)) i++;
          if (i == 2)
            while (i < max && cb.bypass()) i++;
          ref[l] = i;
        }
        if (!(l == 1 && sh.mvd_l1_zero && idc == PRED_BI)) parse_mvd(mvd[l]);
        flag[l] = cb.decision(MVP_FLAG);
      }
      mf.pred = uint8_t(idc == PRED_BI ? 3 : idc == PRED_L0 ? 1 : 2);
      for (int l = 0; l < 2; l++) {
        mf.ref_idx[l] = int8_t(ref[l]);
        if (!(mf.pred >> l & 1)) continue;
        int mvp[2];
        amvp(x, y, w, h, pidx, l, ref[l], flag[l], mvp);
        for (int k = 0; k < 2; k++) mf.mv[l][k] = int16_t(uint16_t(mvp[k] + mvd[l][k]));
      }
    }
    for (int l = 0; l < 2; l++)
      if (mf.pred >> l & 1) {
        mf.ref_poc[l] = rpl_poc[l][mf.ref_idx[l]];
        mf.lt[l] = rpl_lt[l][mf.ref_idx[l]];
      } else {
        mf.ref_idx[l] = -1;
        mf.mv[l][0] = mf.mv[l][1] = 0;
      }
    for (int yy = y >> 2; yy < (y + h) >> 2; yy++)
      for (int xx = x >> 2; xx < (x + w) >> 2; xx++) cur->mvf[size_t(yy) * w4 + xx] = mf;
    motion_compensate(x, y, w, h, mf);
  }

  void parse_mvd(int* mvd) {
    int g0[2], g1[2] = {0, 0};
    g0[0] = cb.decision(MVD_GT0);
    g0[1] = cb.decision(MVD_GT0);
    for (int k = 0; k < 2; k++)
      if (g0[k]) g1[k] = cb.decision(MVD_GT1);
    for (int k = 0; k < 2; k++) {
      if (!g0[k]) {
        mvd[k] = 0;
        continue;
      }
      int v = 1;
      if (g1[k]) {  // abs_mvd_minus2, EG1
        int kk = 1;
        v = 2;
        while (cb.bypass()) {
          v += 1 << kk;
          if (++kk > 30) corrupt("abs_mvd_minus2 too long");
        }
        while (kk--) v += cb.bypass() << kk;
      }
      mvd[k] = cb.bypass() ? -v : v;
    }
  }

  // ------------------------------------------------------- motion vectors

  // 6.4.2: the prediction block at (xn, yn) is available to partition
  // pidx (w x h at (x, y)) of the current CU, and inter
  bool pb_avail(int x, int y, int w, int h, int pidx, int xn, int yn) const {
    int n = 1 << cu_log2;
    bool avail;
    if (cu_x <= xn && yn >= cu_y && cu_x + n > xn && cu_y + n > yn) {
      avail = !((w << 1) == n && (h << 1) == n && pidx == 1 && cu_y + h <= yn && cu_x + w > xn);
    } else {
      avail = zavail(x, y, xn, yn);
    }
    return avail && cur->mvf[at4(xn, yn)].pred != 0;
  }

  static bool same_motion(const MvField& a, const MvField& b) {
    if (a.pred != b.pred) return false;
    for (int l = 0; l < 2; l++)
      if ((a.pred >> l & 1) && (a.ref_idx[l] != b.ref_idx[l] || a.mv[l][0] != b.mv[l][0] ||
                                a.mv[l][1] != b.mv[l][1]))
        return false;
    return true;
  }

  static void scale_mv(int16_t* dst, const int16_t* src, int td, int tb) {
    td = clip3(-128, 127, td);
    tb = clip3(-128, 127, tb);
    int tx = (16384 + std::abs(td / 2)) / td;
    int f = clip3(-4096, 4095, (tb * tx + 32) >> 6);
    for (int k = 0; k < 2; k++) {
      int p = f * src[k];
      dst[k] = int16_t(clip3(-32768, 32767, (p + 127 + (p < 0)) >> 8));
    }
  }

  // 8.5.3.2.8: the collocated vector for list X and reference refIdx, from
  // the block covering (x, y) of the collocated picture
  bool colocated(int x, int y, int X, int ref_idx, int16_t* mv) const {
    const Picture* col = rpl[sh.col_from_l0 ? 0 : 1][sh.col_ref_idx];
    const MvField& c = col->mvf[at4((x >> 4) << 4, (y >> 4) << 4)];
    if (c.pred == 0) return false;
    int lc;
    if (!(c.pred & 1)) lc = 1;
    else if (c.pred == 1) lc = 0;
    else lc = no_backward_pred ? X : (sh.col_from_l0 ? 1 : 0);
    bool cur_lt = rpl_lt[X][ref_idx];
    if (cur_lt != bool(c.lt[lc])) return false;
    int col_diff = col->poc - c.ref_poc[lc], cur_diff = poc - rpl_poc[X][ref_idx];
    if (cur_lt || col_diff == cur_diff || !col_diff) {
      mv[0] = c.mv[lc][0];
      mv[1] = c.mv[lc][1];
    } else {
      scale_mv(mv, c.mv[lc], col_diff, cur_diff);
    }
    return true;
  }

  // 8.5.3.2.8: the temporal candidate: the bottom-right block (in the
  // CTB row) then the centre
  bool temporal(int x, int y, int w, int h, int X, int ref_idx, int16_t* mv) const {
    int xb = x + w, yb = y + h;
    if ((y >> log2ctb) == (yb >> log2ctb) && yb < H && xb < W && colocated(xb, yb, X, ref_idx, mv))
      return true;
    return colocated(x + (w >> 1), y + (h >> 1), X, ref_idx, mv);
  }

  // 8.5.3.2.2-8.5.3.2.5: the merge candidate merge_idx
  MvField merge_cand(int x, int y, int w, int h, int pidx, int merge_idx) {
    int ow = w, oh = h;
    if (pps->log2_par_mrg > 2 && cu_log2 == 3) {  // one list for the 8x8 CU
      x = cu_x;
      y = cu_y;
      w = h = 8;
      pidx = 0;
    }
    int pl = pps->log2_par_mrg;
    auto par_ok = [&](int xn, int yn) { return !((x >> pl) == (xn >> pl) && (y >> pl) == (yn >> pl)); };
    MvField cand[5];
    int n = 0;
    auto mvf = [&](int xn, int yn) -> const MvField& { return cur->mvf[at4(xn, yn)]; };
    bool vert2 = pidx == 1 && (part == PART_Nx2N || part == PART_nLx2N || part == PART_nRx2N);
    bool horz2 = pidx == 1 && (part == PART_2NxN || part == PART_2NxnU || part == PART_2NxnD);
    int xa1 = x - 1, ya1 = y + h - 1, xb1 = x + w - 1, yb1 = y - 1;
    bool a1 = !vert2 && par_ok(xa1, ya1) && pb_avail(x, y, w, h, pidx, xa1, ya1);
    if (a1) {
      cand[n++] = mvf(xa1, ya1);
      if (merge_idx < n) return finish_merge(cand[merge_idx], ow, oh);
    }
    bool b1 = !horz2 && par_ok(xb1, yb1) && pb_avail(x, y, w, h, pidx, xb1, yb1);
    if (b1 && !(a1 && same_motion(mvf(xb1, yb1), mvf(xa1, ya1)))) {
      cand[n++] = mvf(xb1, yb1);
      if (merge_idx < n) return finish_merge(cand[merge_idx], ow, oh);
    }
    int xb0 = x + w, yb0 = y - 1;
    bool b0 = par_ok(xb0, yb0) && pb_avail(x, y, w, h, pidx, xb0, yb0);
    if (b0 && !(b1 && same_motion(mvf(xb0, yb0), mvf(xb1, yb1)))) {
      cand[n++] = mvf(xb0, yb0);
      if (merge_idx < n) return finish_merge(cand[merge_idx], ow, oh);
    }
    int xa0 = x - 1, ya0 = y + h;
    bool a0 = par_ok(xa0, ya0) && pb_avail(x, y, w, h, pidx, xa0, ya0);
    if (a0 && !(a1 && same_motion(mvf(xa0, ya0), mvf(xa1, ya1)))) {
      cand[n++] = mvf(xa0, ya0);
      if (merge_idx < n) return finish_merge(cand[merge_idx], ow, oh);
    }
    int xb2 = x - 1, yb2 = y - 1;
    bool b2 = par_ok(xb2, yb2) && pb_avail(x, y, w, h, pidx, xb2, yb2);
    if (b2 && !(a1 && same_motion(mvf(xb2, yb2), mvf(xa1, ya1))) &&
        !(b1 && same_motion(mvf(xb2, yb2), mvf(xb1, yb1))) && n != 4) {
      cand[n++] = mvf(xb2, yb2);
      if (merge_idx < n) return finish_merge(cand[merge_idx], ow, oh);
    }
    std::vector<MvField> list(cand, cand + n);
    if (sh.tmvp && int(list.size()) < sh.max_merge) {
      MvField t{};
      if (temporal(x, y, w, h, 0, 0, t.mv[0])) {
        t.pred |= 1;
        t.ref_idx[0] = 0;
      }
      if (sh.type == 0 && temporal(x, y, w, h, 1, 0, t.mv[1])) {
        t.pred |= 2;
        t.ref_idx[1] = 0;
      }
      if (t.pred) {
        if (!(t.pred & 1)) t.ref_idx[0] = -1;
        if (!(t.pred & 2)) t.ref_idx[1] = -1;
        list.push_back(t);
        if (merge_idx < int(list.size())) return finish_merge(list[size_t(merge_idx)], ow, oh);
      }
    }
    // combined bi-predictive candidates (B slices)
    int orig = int(list.size());
    if (sh.type == 0 && orig > 1 && orig < sh.max_merge) {
      static const int l0i[12] = {0, 1, 0, 2, 1, 2, 0, 3, 1, 3, 2, 3};
      static const int l1i[12] = {1, 0, 2, 0, 2, 1, 3, 0, 3, 1, 3, 2};
      for (int k = 0; k < orig * (orig - 1) && int(list.size()) < sh.max_merge; k++) {
        const MvField& a = list[size_t(l0i[k])];
        const MvField& b = list[size_t(l1i[k])];
        if ((a.pred & 1) && (b.pred & 2) &&
            (rpl_poc[0][a.ref_idx[0]] != rpl_poc[1][b.ref_idx[1]] || a.mv[0][0] != b.mv[1][0] ||
             a.mv[0][1] != b.mv[1][1])) {
          MvField c{};
          c.pred = 3;
          c.ref_idx[0] = a.ref_idx[0];
          c.ref_idx[1] = b.ref_idx[1];
          c.mv[0][0] = a.mv[0][0];
          c.mv[0][1] = a.mv[0][1];
          c.mv[1][0] = b.mv[1][0];
          c.mv[1][1] = b.mv[1][1];
          list.push_back(c);
          if (merge_idx < int(list.size())) return finish_merge(list[size_t(merge_idx)], ow, oh);
        }
      }
    }
    // zero candidates
    int num_ref = sh.type == 1 ? sh.num_ref[0] : std::min(sh.num_ref[0], sh.num_ref[1]);
    for (int zero = 0; int(list.size()) <= merge_idx; zero++) {
      MvField c{};
      int r = zero < num_ref ? zero : 0;
      c.ref_idx[0] = int8_t(r);
      c.ref_idx[1] = int8_t(sh.type == 0 ? r : -1);
      c.pred = uint8_t(sh.type == 0 ? 3 : 1);
      list.push_back(c);
    }
    return finish_merge(list[size_t(merge_idx)], ow, oh);
  }

  // an 8x4 or 4x8 block predicts from list 0 only (8.5.3.2.2)
  static MvField finish_merge(MvField m, int w, int h) {
    if (m.pred == 3 && w + h == 12) {
      m.pred = 1;
      m.ref_idx[1] = -1;
    }
    return m;
  }

  // 8.5.3.2.6-8.5.3.2.7: the predictor mvp_flag of list X for refIdx
  void amvp(int x, int y, int w, int h, int pidx, int X, int ref_idx, int flag, int* out) {
    int Y = 1 - X, target = rpl_poc[X][ref_idx];
    bool target_lt = rpl_lt[X][ref_idx];
    auto mvf = [&](int xn, int yn) -> const MvField& { return cur->mvf[at4(xn, yn)]; };
    // the neighbour's vector of list l if it references the target picture
    auto same_pic = [&](const MvField& m, int l, int16_t* mv) {
      if ((m.pred >> l & 1) && rpl_poc[l][m.ref_idx[l]] == target) {
        mv[0] = m.mv[l][0];
        mv[1] = m.mv[l][1];
        return true;
      }
      return false;
    };
    // ... if its reference is long-term as the target is; scaled
    auto scaled = [&](const MvField& m, int l, int16_t* mv) {
      if ((m.pred >> l & 1) && bool(rpl_lt[l][m.ref_idx[l]]) == target_lt) {
        mv[0] = m.mv[l][0];
        mv[1] = m.mv[l][1];
        int ref = rpl_poc[l][m.ref_idx[l]];
        if (!target_lt && ref != target) {
          int d = poc - ref;
          scale_mv(mv, mv, d ? d : 1, poc - target);
        }
        return true;
      }
      return false;
    };
    int xs[2] = {x - 1, x - 1}, ys[2] = {y + h, y + h - 1};  // A0, A1
    bool av_a[2];
    for (int k = 0; k < 2; k++) av_a[k] = pb_avail(x, y, w, h, pidx, xs[k], ys[k]);
    bool is_scaled = av_a[0] || av_a[1];
    int16_t mva[2] = {0, 0}, mvb[2] = {0, 0};
    bool fa = false, fb = false;
    for (int k = 0; k < 2 && !fa; k++)
      if (av_a[k]) fa = same_pic(mvf(xs[k], ys[k]), X, mva) || same_pic(mvf(xs[k], ys[k]), Y, mva);
    for (int k = 0; k < 2 && !fa; k++)
      if (av_a[k]) fa = scaled(mvf(xs[k], ys[k]), X, mva) || scaled(mvf(xs[k], ys[k]), Y, mva);
    int xb[3] = {x + w, x + w - 1, x - 1}, yb[3] = {y - 1, y - 1, y - 1};  // B0, B1, B2
    bool av_b[3];
    for (int k = 0; k < 3; k++) av_b[k] = pb_avail(x, y, w, h, pidx, xb[k], yb[k]);
    for (int k = 0; k < 3 && !fb; k++)
      if (av_b[k]) fb = same_pic(mvf(xb[k], yb[k]), X, mvb) || same_pic(mvf(xb[k], yb[k]), Y, mvb);
    if (!is_scaled && fb) {
      fa = true;
      mva[0] = mvb[0];
      mva[1] = mvb[1];
    }
    if (!is_scaled) {
      fb = false;
      for (int k = 0; k < 3 && !fb; k++)
        if (av_b[k]) fb = scaled(mvf(xb[k], yb[k]), X, mvb) || scaled(mvf(xb[k], yb[k]), Y, mvb);
    }
    int16_t list[3][2];
    int n = 0;
    if (fa) {
      list[n][0] = mva[0];
      list[n++][1] = mva[1];
    }
    if (fb && !(fa && mva[0] == mvb[0] && mva[1] == mvb[1])) {
      list[n][0] = mvb[0];
      list[n++][1] = mvb[1];
    }
    if (n < 2 && sh.tmvp && flag == n) {
      int16_t t[2];
      if (temporal(x, y, w, h, X, ref_idx, t)) {
        list[n][0] = t[0];
        list[n++][1] = t[1];
      }
    }
    while (n < 2) {
      list[n][0] = 0;
      list[n++][1] = 0;
    }
    out[0] = list[flag][0];
    out[1] = list[flag][1];
  }

  // ----------------------------------------------------------- transforms

  // 7.3.8.8: transform_tree(); pcb, pcr: the parent's cbf_cb and cbf_cr
  void transform_tree(int x0, int y0, int xb, int yb, int log2, int depth, int blk, bool pcb,
                      bool pcr) {
    bool split;
    if (log2 <= sps->log2_max_tb && log2 > sps->log2_min_tb && depth < max_trafo_depth &&
        !(intra_split && depth == 0)) {
      split = cb.decision(SPLIT_TRANSFORM + 5 - log2);
    } else {
      bool inter_split = sps->depth_inter == 0 && !cu_intra && part != PART_2Nx2N && depth == 0;
      split = log2 > sps->log2_max_tb || (intra_split && depth == 0) || inter_split;
    }
    bool ccb = pcb, ccr = pcr;
    if (log2 > 2) {
      ccb = (depth == 0 || pcb) ? bool(cb.decision(CBF_CHROMA + depth)) : false;
      ccr = (depth == 0 || pcr) ? bool(cb.decision(CBF_CHROMA + depth)) : false;
    }
    if (split) {
      int h = 1 << (log2 - 1);
      transform_tree(x0, y0, x0, y0, log2 - 1, depth + 1, 0, ccb, ccr);
      transform_tree(x0 + h, y0, x0, y0, log2 - 1, depth + 1, 1, ccb, ccr);
      transform_tree(x0, y0 + h, x0, y0, log2 - 1, depth + 1, 2, ccb, ccr);
      transform_tree(x0 + h, y0 + h, x0, y0, log2 - 1, depth + 1, 3, ccb, ccr);
      return;
    }
    bool cl = true;
    if (cu_intra || depth != 0 || ccb || ccr) cl = cb.decision(CBF_LUMA + (depth == 0 ? 1 : 0));
    transform_unit(x0, y0, xb, yb, log2, blk, cl, ccb, ccr);
  }

  // 7.3.8.10: transform_unit(), each block predicted (intra) and its
  // residual added
  void transform_unit(int x0, int y0, int xb, int yb, int log2, int blk, bool cl, bool ccb,
                      bool ccr) {
    int n = 1 << log2;
    if (cl) fill4(nzf, x0, y0, n, n, uint8_t(1));
    if ((cl || ccb || ccr) && pps->cu_qp_delta && !is_cu_qp_delta_coded) {
      int v = 0;
      while (v < 5 && cb.decision(QP_DELTA + (v > 0))) v++;
      if (v == 5) {
        int k = 0;
        while (cb.bypass()) {
          v += 1 << k;
          if (++k == 7) corrupt("cu_qp_delta_abs too long");
        }
        while (k--) v += cb.bypass() << k;
      }
      if (v && cb.bypass()) v = -v;
      if (v < -26 || v > 25) corrupt("cu_qp_delta out of range");
      cu_qp_delta = v;
      is_cu_qp_delta_coded = true;
      set_qpy(cu_x, cu_y);
    }
    if (cu_intra) intra_pred(0, x0, y0, log2, ipm[at4(x0, y0)]);
    if (cl) residual(x0, y0, log2, 0);
    if (log2 > 2 || blk == 3) {
      int xc = (log2 > 2 ? x0 : xb) / 2, yc = (log2 > 2 ? y0 : yb) / 2, lc = log2 > 2 ? log2 - 1 : 2;
      for (int c = 1; c <= 2; c++) {
        if (cu_intra) intra_pred(c, xc, yc, lc, chroma_mode);
        if (c == 1 ? ccb : ccr) residual(xc, yc, lc, c);
      }
    }
    if (!sh.deblock_disabled) boundary_strengths(x0, y0, log2);
  }

  // 7.3.8.11: residual_coding(), then 8.6.2-8.6.4: scaling, the inverse
  // transform and the reconstruction of the block
  void residual(int x0, int y0, int log2, int c) {
    int n = 1 << log2;
    bool ts = pps->transform_skip && log2 == 2 && cb.decision(TRANSFORM_SKIP + (c ? 1 : 0));
    int last[2];
    for (int k = 0; k < 2; k++) {
      int base = k ? LAST_Y : LAST_X, off, shift;
      if (c == 0) {
        off = 3 * (log2 - 2) + ((log2 - 1) >> 2);
        shift = (log2 + 1) >> 2;
      } else {
        off = 15;
        shift = log2 - 2;
      }
      int max = (log2 << 1) - 1, i = 0;
      while (i < max && cb.decision(base + off + (i >> shift))) i++;
      last[k] = i;
    }
    for (int k = 0; k < 2; k++)
      if (last[k] > 3) {
        int len = (last[k] >> 1) - 1;
        last[k] = (1 << len) * (2 + (last[k] & 1)) + cb.bypass_bits(len);
      }
    int scan = 0;
    if (cu_intra && (log2 == 2 || (log2 == 3 && c == 0))) {
      int m = c ? chroma_mode : ipm[at4(x0, y0)];
      if (m >= 6 && m <= 14) scan = 2;
      else if (m >= 22 && m <= 30) scan = 1;
    }
    if (scan == 2) std::swap(last[0], last[1]);
    int lx = last[0], ly = last[1];
    if (lx >= n || ly >= n) corrupt("last significant coefficient outside the block");
    int lsb = log2 - 2, nsb = 1 << lsb;
    const uint8_t* sbscan = lsb ? kScans.pos[lsb - 1][scan] : kScans.pos[0][0];
    const uint8_t* scan4 = kScans.pos[1][scan];
    int last_sb = 0, last_pos = 0;
    for (int i = 0; i < nsb * nsb; i++)
      if ((sbscan[i] & 15) == (lx >> 2) && (sbscan[i] >> 4) == (ly >> 2)) last_sb = i;
    for (int i = 0; i < 16; i++)
      if ((scan4[i] & 15) == (lx & 3) && (scan4[i] >> 4) == (ly & 3)) last_pos = i;
    memset(coeff, 0, sizeof(int32_t) * size_t(n) * n);
    uint8_t csbf[8][8];
    memset(csbf, 0, sizeof csbf);
    static const uint8_t kCtxIdxMap[16] = {0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8};
    int greater1_ctx = 1, maxx = 0, maxy = 0;
    const int sig_base = SIG + (c ? 27 : 0), gt1_base = GT1 + (c ? 16 : 0), gt2_base = GT2 + (c ? 4 : 0);
    for (int i = last_sb; i >= 0; i--) {
      int xs = sbscan[i] & 15, ys = sbscan[i] >> 4;
      int right = xs + 1 < nsb ? csbf[ys][xs + 1] : 0, below = ys + 1 < nsb ? csbf[ys + 1][xs] : 0;
      bool infer_dc = false;
      if (i < last_sb && i > 0) {
        csbf[ys][xs] = uint8_t(cb.decision(CSBF + std::min(right + below, 1) + (c ? 2 : 0)));
        infer_dc = true;
      } else {
        csbf[ys][xs] = 1;
      }
      int prev = right | (below << 1);
      int ps[16], np = 0;
      int start = 15;
      if (i == last_sb) {
        ps[np++] = last_pos;
        start = last_pos - 1;
      }
      if (csbf[ys][xs]) {
        for (int p = start; p >= 0; p--) {
          int pos = scan4[p], xp = pos & 15, yp = pos >> 4, xc = (xs << 2) + xp, yc = (ys << 2) + yp;
          if (p > 0 || !infer_dc) {
            int sc;
            if (log2 == 2) {
              sc = kCtxIdxMap[(yc << 2) + xc];
            } else if (xc + yc == 0) {
              sc = 0;
            } else {
              if (prev == 0) sc = xp + yp == 0 ? 2 : xp + yp < 3 ? 1 : 0;
              else if (prev == 1) sc = yp == 0 ? 2 : yp == 1 ? 1 : 0;
              else if (prev == 2) sc = xp == 0 ? 2 : xp == 1 ? 1 : 0;
              else sc = 2;
              if (c == 0) {
                if (xs || ys) sc += 3;
                sc += log2 == 3 ? (scan == 0 ? 9 : 15) : 21;
              } else {
                sc += log2 == 3 ? 9 : 12;
              }
            }
            if (cb.decision(sig_base + sc)) {
              ps[np++] = p;
              infer_dc = false;
            }
          } else {
            ps[np++] = 0;  // the sub-block's DC, inferred
          }
        }
      }
      if (!np) continue;
      // 9.3.4.2.6-9.3.4.2.7: greater1 and greater2 flags
      int ctx_set = (i > 0 && c == 0) ? 2 : 0;
      if (i != last_sb && greater1_ctx == 0) ctx_set++;
      greater1_ctx = 1;
      int g1[16] = {0}, first_g1 = -1;
      for (int m = 0; m < std::min(np, 8); m++) {
        g1[m] = cb.decision(gt1_base + (ctx_set << 2) + greater1_ctx);
        if (g1[m]) {
          greater1_ctx = 0;
          if (first_g1 == -1) first_g1 = m;
        } else if (greater1_ctx > 0 && greater1_ctx < 3) {
          greater1_ctx++;
        }
      }
      if (first_g1 != -1) g1[first_g1] += cb.decision(gt2_base + ctx_set);
      bool hidden = pps->sign_hiding && ps[0] - ps[np - 1] > 3;
      int nsigns = hidden ? np - 1 : np;
      uint32_t signs = nsigns ? uint32_t(cb.bypass_bits(nsigns)) << (32 - nsigns) : 0;
      int rice = 0, sum = 0;
      for (int m = 0; m < np; m++) {
        int level = 1 + g1[m];
        if (m >= 8 || level == (m == first_g1 ? 3 : 2)) {
          if (m >= 8) level = 1;
          // 9.3.3.11: coeff_abs_level_remaining
          int prefix = 0;
          while (prefix < 32 && cb.bypass()) prefix++;
          int rem;
          if (prefix < 3) {
            rem = (prefix << rice) + cb.bypass_bits(rice);
          } else {
            int len = prefix - 3 + rice;
            if (prefix == 32 || len > 22) corrupt("coeff_abs_level_remaining too long");
            rem = (((1 << (prefix - 3)) + 3 - 1) << rice) + cb.bypass_bits(len);
          }
          level += rem;
          if (level > (3 << rice)) rice = std::min(rice + 1, 4);
        }
        if (hidden) {
          sum += level;
          if (m == np - 1 && (sum & 1)) level = -level;
        }
        if (signs >> 31) level = -level;
        signs <<= 1;
        int pos = scan4[ps[m]], xc = (xs << 2) + (pos & 15), yc = (ys << 2) + (pos >> 4);
        coeff[yc * n + xc] = level;
        maxx = std::max(maxx, xc);
        maxy = std::max(maxy, yc);
      }
    }
    reconstruct(x0, y0, log2, c, ts, maxx, maxy);
  }

  // scaling (8.6.2-8.6.3), the inverse transform (8.6.4) and the sum with
  // the prediction, clipped
  void reconstruct(int x0, int y0, int log2, int c, bool ts, int maxx, int maxy) {
    int n = 1 << log2;
    int qp;
    if (c == 0) {
      qp = qp_y;
    } else {
      int qpi = clip3(0, 57, qp_y + (c == 1 ? pps->cb_qp_offset + sh.cb_qp_offset
                                            : pps->cr_qp_offset + sh.cr_qp_offset));
      qp = qpi < 30 ? qpi : qpi > 43 ? qpi - 6 : kQpC[qpi - 30];
    }
    int shift = log2 + 3, scale = kLevelScale[qp % 6] << (qp / 6);
    int64_t add = int64_t(1) << (shift - 1);
    bool lists = sps->scaling;
    if (lists) {
      const ScalingList& sl = pps->has_scaling ? pps->sl : sps->sl;
      int m = (cu_intra ? 0 : 3) + (log2 == 5 ? 0 : c);
      sl.factors(log2, m, sf);
    }
    for (int y = 0; y <= maxy; y++)
      for (int x = 0; x <= maxx; x++) {
        int32_t& v = coeff[y * n + x];
        if (!v) continue;
        int64_t t = (int64_t(v) * scale * (lists ? sf[y * n + x] : 16) + add) >> shift;
        v = int32_t(t < -32768 ? -32768 : t > 32767 ? 32767 : t);
      }
    if (ts) {
      for (int i = 0; i < 16; i++) res[i] = int16_t((coeff[i] + 16) >> 5);
    } else if (c == 0 && cu_intra && log2 == 2) {
      int g[16];
      for (int x = 0; x < 4; x++)
        for (int y = 0; y < 4; y++) {
          int e = 0;
          for (int k = 0; k < 4; k++) e += kDst[k][y] * coeff[k * 4 + x];
          g[y * 4 + x] = clip3(-32768, 32767, (e + 64) >> 7);
        }
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) {
          int r = 0;
          for (int k = 0; k < 4; k++) r += kDst[k][x] * g[y * 4 + k];
          res[y * 4 + x] = int16_t(clip3(-32768, 32767, (r + 2048) >> 12));
        }
    } else {
      int step = 32 >> log2;
      static thread_local int g[32 * 32];
      for (int x = 0; x <= maxx; x++)
        for (int y = 0; y < n; y++) {
          int e = 0;
          for (int k = 0; k <= maxy; k++) e += kDct.m[k * step][y] * coeff[k * n + x];
          g[y * n + x] = clip3(-32768, 32767, (e + 64) >> 7);
        }
      for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++) {
          int r = 0;
          for (int k = 0; k <= maxx; k++) r += kDct.m[k * step][x] * g[y * n + k];
          res[y * n + x] = int16_t(clip3(-32768, 32767, (r + 2048) >> 12));
        }
    }
    uint8_t* plane = c == 0 ? cur->y.data() : c == 1 ? cur->u.data() : cur->v.data();
    int stride = c == 0 ? W : W / 2;
    for (int y = 0; y < n; y++) {
      uint8_t* row = plane + size_t(y0 + y) * stride + x0;
      for (int x = 0; x < n; x++) row[x] = clip1(row[x] + res[y * n + x]);
    }
  }

  // ------------------------------------------------------ intra prediction

  // 8.4.4.2: the prediction of the n x n block of component c at (x0, y0)
  // (in its samples) by mode, written into the picture
  void intra_pred(int c, int x0, int y0, int log2, int mode) {
    int n = 1 << log2, sub = c ? 1 : 0;
    uint8_t* plane = c == 0 ? cur->y.data() : c == 1 ? cur->u.data() : cur->v.data();
    int stride = W >> sub;
    int xl = x0 << sub, yl = y0 << sub;
    // the 4n + 1 references from p[-1][2n-1] up to p[-1][-1], then along
    // p[0..2n-1][-1]: their availability in units of a 4x4 luma block
    int ref[4 * 64 + 1];
    bool av[4 * 64 + 1];
    int unit = 4 >> sub, total = 4 * n + 1;
    auto avail_at = [&](int xc, int yc) {
      int xn = xc * (1 + sub), yn = yc * (1 + sub);  // -1 stays outside the picture
      if (!zavail(xl, yl, xn, yn)) return false;
      return !pps->constrained_intra || intra[at4(xn, yn)] != 0;
    };
    // libavcodec with constrained intra prediction: a block shorter than
    // the minimum prediction block (luma 4x4 beside CBs of 16 and up,
    // chroma 4x4 beside CBs of 32 and up) on such a block's left edge takes
    // none of its left and bottom-left references
    int log2_min_pu = sps->log2_min_cb - 1;
    bool no_left = pps->constrained_intra && ((n << sub) >> log2_min_pu) == 0 &&
                   (xl & ((1 << log2_min_pu) - 1)) == 0;
    bool any = false;
    for (int i = 0; i < 2 * n; i += unit) {  // left column, bottom first
      int yc = y0 + 2 * n - 1 - i;
      bool a = !no_left && avail_at(x0 - 1, yc);
      for (int k = 0; k < unit; k++) {
        av[i + k] = a;
        if (a) ref[i + k] = plane[size_t(yc - k) * stride + x0 - 1];
      }
      any |= a;
    }
    av[2 * n] = avail_at(x0 - 1, y0 - 1);
    if (av[2 * n]) ref[2 * n] = plane[size_t(y0 - 1) * stride + x0 - 1];
    any |= av[2 * n];
    for (int i = 0; i < 2 * n; i += unit) {
      bool a = avail_at(x0 + i, y0 - 1);
      for (int k = 0; k < unit; k++) {
        av[2 * n + 1 + i + k] = a;
        if (a) ref[2 * n + 1 + i + k] = plane[size_t(y0 - 1) * stride + x0 + i + k];
      }
      any |= a;
    }
    // 8.4.4.2.2: substitution
    if (!any) {
      for (int i = 0; i < total; i++) ref[i] = 128;
    } else {
      if (!av[0]) {
        int i = 1;
        while (!av[i]) i++;
        ref[0] = ref[i];
      }
      for (int i = 1; i < total; i++)
        if (!av[i]) ref[i] = ref[i - 1];
    }
    // 8.4.4.2.3: filtering of the luma references
    if (c == 0 && mode != 1 && n != 4) {
      int dist = std::min(std::abs(mode - 26), std::abs(mode - 10));
      int thres = n == 8 ? 7 : n == 16 ? 1 : 0;
      if (dist > thres) {
        int f[4 * 64 + 1];
        int corner = ref[2 * n], bottom = ref[0], right = ref[total - 1];
        if (sps->strong_smoothing && n == 32 && std::abs(corner + right - 2 * ref[2 * n + n]) < 8 &&
            std::abs(corner + bottom - 2 * ref[2 * n - n]) < 8) {
          f[2 * n] = corner;
          for (int y = 0; y < 63; y++) f[2 * n - 1 - y] = ((63 - y) * corner + (y + 1) * bottom + 32) >> 6;
          f[0] = bottom;
          for (int x = 0; x < 63; x++) f[2 * n + 1 + x] = ((63 - x) * corner + (x + 1) * right + 32) >> 6;
          f[total - 1] = right;
        } else {
          f[0] = ref[0];
          f[total - 1] = ref[total - 1];
          for (int i = 1; i < total - 1; i++) f[i] = (ref[i - 1] + 2 * ref[i] + ref[i + 1] + 2) >> 2;
        }
        memcpy(ref, f, sizeof(int) * size_t(total));
      }
    }
    // p[-1][y] = left(y), p[x][-1] = top(x), y, x in -1..2n-1
    auto left = [&](int y) { return ref[2 * n - 1 - y]; };
    auto top = [&](int x) { return ref[2 * n + 1 + x]; };
    uint8_t* dst = plane + size_t(y0) * stride + x0;
    if (mode == 0) {  // planar
      for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++)
          dst[size_t(y) * stride + x] = uint8_t(((n - 1 - x) * left(y) + (x + 1) * top(n) +
                                                 (n - 1 - y) * top(x) + (y + 1) * left(n) + n) >>
                                                (log2 + 1));
    } else if (mode == 1) {  // DC
      int sum = n;
      for (int k = 0; k < n; k++) sum += top(k) + left(k);
      int dc = sum >> (log2 + 1);
      for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++) dst[size_t(y) * stride + x] = uint8_t(dc);
      if (c == 0 && n < 32) {
        dst[0] = uint8_t((left(0) + 2 * dc + top(0) + 2) >> 2);
        for (int x = 1; x < n; x++) dst[x] = uint8_t((top(x) + 3 * dc + 2) >> 2);
        for (int y = 1; y < n; y++) dst[size_t(y) * stride] = uint8_t((left(y) + 3 * dc + 2) >> 2);
      }
    } else {  // angular
      int angle = kIntraAngle[mode];
      int r[3 * 64 + 1];
      int* rr = r + 64;  // rr[k] for k in -n..2n
      bool vert = mode >= 18;
      auto main_ref = [&](int k) { return vert ? top(k - 1) : left(k - 1); };    // k = 0 -> p[-1][-1]
      auto side_ref = [&](int k) { return vert ? left(k - 1) : top(k - 1); };
      for (int k = 0; k <= n; k++) rr[k] = main_ref(k);
      if (angle < 0) {
        int inv = kInvAngle[mode - 11];
        if (((n * angle) >> 5) < -1)
          for (int k = (n * angle) >> 5; k <= -1; k++) rr[k] = side_ref(((k * inv + 128) >> 8));
      } else {
        for (int k = n + 1; k <= 2 * n; k++) rr[k] = main_ref(k);
      }
      for (int j = 0; j < n; j++) {  // j: y for vertical modes, x for horizontal ones
        int pos = (j + 1) * angle, idx = pos >> 5, fact = pos & 31;
        for (int i = 0; i < n; i++) {
          int v = fact ? ((32 - fact) * rr[i + idx + 1] + fact * rr[i + idx + 2] + 16) >> 5
                       : rr[i + idx + 1];
          if (vert) dst[size_t(j) * stride + i] = uint8_t(v);
          else dst[size_t(i) * stride + j] = uint8_t(v);
        }
      }
      if (c == 0 && n < 32) {
        if (mode == 26)
          for (int y = 0; y < n; y++)
            dst[size_t(y) * stride] = clip1(top(0) + ((left(y) - left(-1)) >> 1));
        else if (mode == 10)
          for (int x = 0; x < n; x++) dst[x] = clip1(left(0) + ((top(x) - top(-1)) >> 1));
      }
    }
  }

  // ------------------------------------------------------ inter prediction

  // 8.5.3.3.3: the 14-bit prediction of a w x h block of component c of
  // ref at (x, y) (in its samples) displaced by mv (quarter luma samples)
  void predict(const Picture& ref, int c, int x, int y, int w, int h, const int16_t* mv,
               int16_t* dst) const {
    static const int kLuma[4][8] = {{0, 0, 0, 64, 0, 0, 0, 0},
                                    {-1, 4, -10, 58, 17, -5, 1, 0},
                                    {-1, 4, -11, 40, 40, -11, 4, -1},
                                    {0, 1, -5, 17, 58, -10, 4, -1}};
    static const int kChroma[8][4] = {{0, 64, 0, 0},    {-2, 58, 10, -2}, {-4, 54, 16, -2},
                                      {-6, 46, 28, -4}, {-4, 36, 36, -4}, {-4, 28, 46, -6},
                                      {-2, 16, 54, -4}, {-2, 10, 58, -2}};
    const uint8_t* plane = c == 0 ? ref.y.data() : c == 1 ? ref.u.data() : ref.v.data();
    int pw = c == 0 ? W : W / 2, ph = c == 0 ? H : H / 2;
    int taps = c == 0 ? 8 : 4, before = c == 0 ? 3 : 1;
    int fx, fy, xi, yi;
    const int* hf;
    const int* vf;
    if (c == 0) {
      fx = mv[0] & 3;
      fy = mv[1] & 3;
      xi = x + (mv[0] >> 2);
      yi = y + (mv[1] >> 2);
      hf = kLuma[fx];
      vf = kLuma[fy];
    } else {
      fx = mv[0] & 7;
      fy = mv[1] & 7;
      xi = x + (mv[0] >> 3);
      yi = y + (mv[1] >> 3);
      hf = kChroma[fx];
      vf = kChroma[fy];
    }
    // the reference samples, their coordinates clamped to the picture
    int sw = w + taps - 1, shh = h + taps - 1;
    static thread_local uint8_t src[(64 + 7) * (64 + 7)];
    int xs = xi - before, ys = yi - before;
    for (int r = 0; r < shh; r++) {
      const uint8_t* row = plane + size_t(clip3(0, ph - 1, ys + r)) * pw;
      uint8_t* d = src + r * sw;
      if (xs >= 0 && xs + sw <= pw) {
        memcpy(d, row + xs, size_t(sw));
      } else {
        for (int k = 0; k < sw; k++) d[k] = row[clip3(0, pw - 1, xs + k)];
      }
    }
    if (!fx && !fy) {
      for (int r = 0; r < h; r++)
        for (int k = 0; k < w; k++) dst[r * w + k] = int16_t(src[(r + before) * sw + k + before] << 6);
      return;
    }
    if (!fy) {
      for (int r = 0; r < h; r++) {
        const uint8_t* s = src + (r + before) * sw;
        for (int k = 0; k < w; k++) {
          int v = 0;
          for (int t = 0; t < taps; t++) v += hf[t] * s[k + t];
          dst[r * w + k] = int16_t(v);
        }
      }
      return;
    }
    if (!fx) {
      for (int r = 0; r < h; r++)
        for (int k = 0; k < w; k++) {
          int v = 0;
          for (int t = 0; t < taps; t++) v += vf[t] * src[(r + t) * sw + k + before];
          dst[r * w + k] = int16_t(v);
        }
      return;
    }
    static thread_local int tmp[(64 + 7) * 64];
    for (int r = 0; r < shh; r++) {
      const uint8_t* s = src + r * sw;
      for (int k = 0; k < w; k++) {
        int v = 0;
        for (int t = 0; t < taps; t++) v += hf[t] * s[k + t];
        tmp[r * w + k] = v;
      }
    }
    for (int r = 0; r < h; r++)
      for (int k = 0; k < w; k++) {
        int v = 0;
        for (int t = 0; t < taps; t++) v += vf[t] * tmp[(r + t) * w + k];
        dst[r * w + k] = int16_t(v >> 6);
      }
  }

  // 8.5.3.3.4: the weighted sample prediction of the PU into the picture
  void motion_compensate(int x, int y, int w, int h, const MvField& mf) {
    static thread_local int16_t p0[64 * 64], p1[64 * 64];
    bool weighted = (sh.type == 1 && pps->weighted_pred) || (sh.type == 0 && pps->weighted_bipred);
    for (int c = 0; c < 3; c++) {
      int sub = c ? 1 : 0, cx = x >> sub, cy = y >> sub, cw = w >> sub, ch = h >> sub;
      int stride = W >> sub;
      uint8_t* plane = c == 0 ? cur->y.data() : c == 1 ? cur->u.data() : cur->v.data();
      int16_t* pred[2] = {p0, p1};
      for (int l = 0; l < 2; l++)
        if (mf.pred >> l & 1) predict(*rpl[l][mf.ref_idx[l]], c, cx, cy, cw, ch, mf.mv[l], pred[l]);
      uint8_t* dst = plane + size_t(cy) * stride + cx;
      if (mf.pred == 3) {
        if (!weighted) {
          for (int r = 0; r < ch; r++)
            for (int k = 0; k < cw; k++)
              dst[size_t(r) * stride + k] = clip1((p0[r * cw + k] + p1[r * cw + k] + 64) >> 7);
        } else {
          const PredWeight& a = sh.pw[0][mf.ref_idx[0]];
          const PredWeight& b = sh.pw[1][mf.ref_idx[1]];
          int log2wd = (c ? sh.chroma_log2_wd : sh.luma_log2_wd) + 6;
          int w0 = c ? a.chroma_w[c - 1] : a.luma_w, w1 = c ? b.chroma_w[c - 1] : b.luma_w;
          int o0 = c ? a.chroma_o[c - 1] : a.luma_o, o1 = c ? b.chroma_o[c - 1] : b.luma_o;
          for (int r = 0; r < ch; r++)
            for (int k = 0; k < cw; k++)
              dst[size_t(r) * stride + k] =
                  clip1((p0[r * cw + k] * w0 + p1[r * cw + k] * w1 + (o0 + o1 + 1) * (1 << log2wd)) >>
                        (log2wd + 1));
        }
        continue;
      }
      int l = mf.pred == 1 ? 0 : 1;
      const int16_t* p = pred[l];
      if (!weighted) {
        for (int r = 0; r < ch; r++)
          for (int k = 0; k < cw; k++) dst[size_t(r) * stride + k] = clip1((p[r * cw + k] + 32) >> 6);
      } else {
        const PredWeight& a = sh.pw[l][mf.ref_idx[l]];
        int log2wd = (c ? sh.chroma_log2_wd : sh.luma_log2_wd) + 6;
        int w0 = c ? a.chroma_w[c - 1] : a.luma_w, o0 = c ? a.chroma_o[c - 1] : a.luma_o;
        for (int r = 0; r < ch; r++)
          for (int k = 0; k < cw; k++)
            dst[size_t(r) * stride + k] =
                clip1(((p[r * cw + k] * w0 + (1 << (log2wd - 1))) >> log2wd) + o0);
      }
    }
  }

  // ------------------------------------------------------ in-loop filters

  // libavcodec's boundary strength of two blocks' motion (its
  // boundary_strength): references compared by POC
  static int motion_bs(const MvField& q, const MvField& p) {
    auto far = [](const int16_t* a, const int16_t* b) {
      return std::abs(a[0] - b[0]) >= 4 || std::abs(a[1] - b[1]) >= 4;
    };
    if (q.pred == 3 && p.pred == 3) {
      if (q.ref_poc[0] == p.ref_poc[0] && q.ref_poc[0] == q.ref_poc[1] && p.ref_poc[0] == p.ref_poc[1])
        return ((far(p.mv[0], q.mv[0]) || far(p.mv[1], q.mv[1])) &&
                (far(p.mv[1], q.mv[0]) || far(p.mv[0], q.mv[1])))
                   ? 1
                   : 0;
      if (p.ref_poc[0] == q.ref_poc[0] && p.ref_poc[1] == q.ref_poc[1])
        return (far(p.mv[0], q.mv[0]) || far(p.mv[1], q.mv[1])) ? 1 : 0;
      if (p.ref_poc[1] == q.ref_poc[0] && p.ref_poc[0] == q.ref_poc[1])
        return (far(p.mv[1], q.mv[0]) || far(p.mv[0], q.mv[1])) ? 1 : 0;
      return 1;
    }
    if (q.pred != 3 && p.pred != 3) {
      int lq = q.pred & 1 ? 0 : 1, lp = p.pred & 1 ? 0 : 1;
      if (q.ref_poc[lq] == p.ref_poc[lp]) return far(q.mv[lq], p.mv[lp]) ? 1 : 0;
      return 1;
    }
    return 1;
  }

  // 8.7.2.4 as libavcodec computes it for each transform unit (or coding
  // unit without one): bS of its top and left edges on the 8x8 grid, unless
  // at the picture's edge or a slice's that is not filtered across, and of
  // the prediction-unit edges inside it
  void boundary_strengths(int x0, int y0, int log2) {
    int n = 1 << log2, ctb_mask = ctb_size - 1;
    int cw = sps->ctb_w, here = (y0 >> log2ctb) * cw + (x0 >> log2ctb);
    const std::vector<MvField>& mv = cur->mvf;
    if (y0 > 0 && !(y0 & 7)) {
      bool other = !(y0 & ctb_mask) && ctbs[size_t(here - cw)].slice_addr != slice_addr;
      if (!(other && !sh.loop_filter_across))
        for (int i = 0; i < n; i += 4) {
          size_t q = at4(x0 + i, y0), p = at4(x0 + i, y0 - 1);
          int bs = (!mv[q].pred || !mv[p].pred) ? 2 : (nzf[q] || nzf[p]) ? 1 : motion_bs(mv[q], mv[p]);
          bs_h[q] = uint8_t(bs);
        }
    }
    if (x0 > 0 && !(x0 & 7)) {
      bool other = !(x0 & ctb_mask) && ctbs[size_t(here - 1)].slice_addr != slice_addr;
      if (!(other && !sh.loop_filter_across))
        for (int i = 0; i < n; i += 4) {
          size_t q = at4(x0, y0 + i), p = at4(x0 - 1, y0 + i);
          int bs = (!mv[q].pred || !mv[p].pred) ? 2 : (nzf[q] || nzf[p]) ? 1 : motion_bs(mv[q], mv[p]);
          bs_v[q] = uint8_t(bs);
        }
    }
    if (log2 > sps->log2_min_cb - 1 && mv[at4(x0, y0)].pred) {
      for (int j = 8; j < n; j += 8)
        for (int i = 0; i < n; i += 4) {
          size_t q = at4(x0 + i, y0 + j), p = at4(x0 + i, y0 + j - 1);
          bs_h[q] = uint8_t(motion_bs(mv[q], mv[p]));
          q = at4(x0 + j, y0 + i);
          p = at4(x0 + j - 1, y0 + i);
          bs_v[q] = uint8_t(motion_bs(mv[q], mv[p]));
        }
    }
  }

  // 8.7.2.5.3-8.7.2.5.7: one 4-sample segment of a luma edge; p steps
  // across the edge (p0 at s[-step]), along steps along it
  static void filter_luma(uint8_t* s, ptrdiff_t step, ptrdiff_t along, int beta, int tc) {
    auto P = [&](int line, int i) -> uint8_t& { return s[line * along - (i + 1) * step]; };
    auto Q = [&](int line, int i) -> uint8_t& { return s[line * along + i * step]; };
    int dp0 = std::abs(P(0, 2) - 2 * P(0, 1) + P(0, 0)), dp3 = std::abs(P(3, 2) - 2 * P(3, 1) + P(3, 0));
    int dq0 = std::abs(Q(0, 2) - 2 * Q(0, 1) + Q(0, 0)), dq3 = std::abs(Q(3, 2) - 2 * Q(3, 1) + Q(3, 0));
    int dpq0 = dp0 + dq0, dpq3 = dp3 + dq3, dp = dp0 + dp3, dq = dq0 + dq3, d = dpq0 + dpq3;
    if (d >= beta) return;
    auto strong_line = [&](int line, int dpq) {
      return 2 * dpq < (beta >> 2) &&
             std::abs(P(line, 3) - P(line, 0)) + std::abs(Q(line, 0) - Q(line, 3)) < (beta >> 3) &&
             std::abs(P(line, 0) - Q(line, 0)) < ((5 * tc + 1) >> 1);
    };
    bool strong = strong_line(0, dpq0) && strong_line(3, dpq3);
    bool dep = dp < ((beta + (beta >> 1)) >> 3), deq = dq < ((beta + (beta >> 1)) >> 3);
    for (int k = 0; k < 4; k++) {
      int p0 = P(k, 0), p1 = P(k, 1), p2 = P(k, 2), p3 = P(k, 3);
      int q0 = Q(k, 0), q1 = Q(k, 1), q2 = Q(k, 2), q3 = Q(k, 3);
      if (strong) {
        int t2 = 2 * tc;
        P(k, 0) = uint8_t(clip3(p0 - t2, p0 + t2, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3));
        P(k, 1) = uint8_t(clip3(p1 - t2, p1 + t2, (p2 + p1 + p0 + q0 + 2) >> 2));
        P(k, 2) = uint8_t(clip3(p2 - t2, p2 + t2, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3));
        Q(k, 0) = uint8_t(clip3(q0 - t2, q0 + t2, (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3));
        Q(k, 1) = uint8_t(clip3(q1 - t2, q1 + t2, (p0 + q0 + q1 + q2 + 2) >> 2));
        Q(k, 2) = uint8_t(clip3(q2 - t2, q2 + t2, (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3));
        continue;
      }
      int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
      if (std::abs(delta) >= tc * 10) continue;
      delta = clip3(-tc, tc, delta);
      P(k, 0) = clip1(p0 + delta);
      Q(k, 0) = clip1(q0 - delta);
      if (dep) P(k, 1) = clip1(p1 + clip3(-(tc >> 1), tc >> 1, (((p2 + p0 + 1) >> 1) - p1 + delta) >> 1));
      if (deq) Q(k, 1) = clip1(q1 + clip3(-(tc >> 1), tc >> 1, (((q2 + q0 + 1) >> 1) - q1 - delta) >> 1));
    }
  }

  // libavcodec's chroma tc (its chroma_tc): the QP from the luma average
  // and the PPS's offset, clipped to 0..57
  int chroma_tc(int qp_avg, int c, int tc_off) const {
    int qpi = clip3(0, 57, qp_avg + (c == 1 ? pps->cb_qp_offset : pps->cr_qp_offset));
    int qpc = qpi < 30 ? qpi : qpi > 43 ? qpi - 6 : kQpC[qpi - 30];
    return kTc[clip3(0, 53, qpc + 2 + tc_off)];
  }

  static void filter_chroma(uint8_t* s, ptrdiff_t step, ptrdiff_t along, int tc) {
    for (int k = 0; k < 4; k++) {
      uint8_t* q = s + k * along;
      int p0 = q[-step], p1 = q[-2 * step], q0 = q[0], q1 = q[step];
      int delta = clip3(-tc, tc, ((((q0 - p0) * 4) + p1 - q1 + 4) >> 3));
      q[-step] = clip1(p0 + delta);
      q[0] = clip1(q0 - delta);
    }
  }

  inline int qp_at(int x, int y) const { return qpm[at4(x, y)]; }

  // 8.7.2 as libavcodec deblocks one CTB (its deblocking_filter_CTB): the
  // vertical edges inside it and the horizontal edges that lag 8 luma (16
  // for chroma) samples to the left, each with the slice offsets of the CTB
  // it lies in; but the tc and beta offsets are one variable. The luma
  // edges go 8 rows at a time, vertical then horizontal, and each
  // horizontal edge sets the variable to its CTB's offsets; then each
  // chroma plane goes 16 luma rows at a time, its vertical edges reading
  // the variable, then (below the picture's first row) its horizontal
  // edges setting it to the left CTB's first (of each edge's two 8-sample
  // halves, the first takes it, the second the CTB's own)
  void deblock_ctb(int xc, int yc) {
    int x0 = xc << log2ctb, y0 = yc << log2ctb, cw = sps->ctb_w;
    const CtbInfo& cur_ci = ctbs[size_t(yc * cw + xc)];
    int cur_tc = cur_ci.tc_offset, cur_beta = cur_ci.beta_offset, left_tc = 0, left_beta = 0;
    if (x0) {
      left_tc = ctbs[size_t(yc * cw + xc - 1)].tc_offset;
      left_beta = ctbs[size_t(yc * cw + xc - 1)].beta_offset;
    }
    int x_end = std::min(x0 + ctb_size, W), y_end = std::min(y0 + ctb_size, H);
    int tc_off = cur_tc, beta_off = cur_beta;
    int x_end2 = x_end == W ? x_end : x_end - 8;
    uint8_t* Y = cur->y.data();
    auto luma = [&](uint8_t* at, ptrdiff_t step, ptrdiff_t along, int bs0, int bs1, int qp) {
      int beta = kBeta[clip3(0, 51, qp + beta_off)];
      for (int k = 0; k < 2; k++) {
        int b = k ? bs1 : bs0;
        if (!b) continue;
        int tc = kTc[clip3(0, 53, qp + 2 * (b - 1) + tc_off)];
        filter_luma(at + k * 4 * along, step, along, beta, tc);
      }
    };
    for (int y = y0; y < y_end; y += 8) {
      for (int x = x0 ? x0 : 8; x < x_end; x += 8) {
        int bs0 = bs_v[at4(x, y)], bs1 = bs_v[at4(x, y + 4)];
        if (bs0 || bs1)
          luma(Y + size_t(y) * W + x, 1, W, bs0, bs1, (qp_at(x - 1, y) + qp_at(x, y) + 1) >> 1);
      }
      if (!y) continue;
      for (int x = x0 ? x0 - 8 : 0; x < x_end2; x += 8) {
        int bs0 = bs_h[at4(x, y)], bs1 = bs_h[at4(x + 4, y)];
        if (bs0 || bs1) {
          tc_off = x >= x0 ? cur_tc : left_tc;
          beta_off = x >= x0 ? cur_beta : left_beta;
          luma(Y + size_t(y) * W + x, W, 1, bs0, bs1, (qp_at(x, y - 1) + qp_at(x, y) + 1) >> 1);
        }
      }
    }
    int cwid = W / 2, x_end2c = x_end == W ? x_end : x_end - 16;
    for (int c = 1; c <= 2; c++) {
      uint8_t* P = c == 1 ? cur->u.data() : cur->v.data();
      for (int y = y0; y < y_end; y += 16) {
        for (int x = x0 ? x0 : 16; x < x_end; x += 16) {
          int bs0 = bs_v[at4(x, y)], bs1 = y + 8 < H ? bs_v[at4(x, y + 8)] : 0;
          if (bs0 != 2 && bs1 != 2) continue;
          for (int k = 0; k < 2; k++) {
            int yy = y + 8 * k;
            if ((k ? bs1 : bs0) != 2) continue;
            int qp = (qp_at(x - 1, yy) + qp_at(x, yy) + 1) >> 1;
            filter_chroma(P + size_t(yy / 2) * cwid + x / 2, 1, cwid, chroma_tc(qp, c, tc_off));
          }
        }
        if (!y) continue;
        tc_off = x0 ? left_tc : cur_tc;
        for (int x = x0 ? x0 - 16 : 0; x < x_end2c; x += 16) {
          int bs0 = bs_h[at4(x, y)], bs1 = x + 8 < W ? bs_h[at4(x + 8, y)] : 0;
          if (bs0 != 2 && bs1 != 2) continue;
          for (int k = 0; k < 2; k++) {
            int xx = x + 8 * k;
            if ((k ? bs1 : bs0) != 2) continue;
            int qp = (qp_at(xx, y - 1) + qp_at(xx, y) + 1) >> 1;
            filter_chroma(P + size_t(y / 2) * cwid + xx / 2, cwid, 1,
                          chroma_tc(qp, c, k ? cur_tc : tc_off));
          }
        }
      }
    }
  }

  // 8.7.3 as libavcodec applies SAO to one CTB (its sao_filter_CTB): the
  // CTB's deblocked samples, and its neighbours' as they stand when it is
  // filtered (those of a CTB already filtered as they were before that, as
  // libavcodec keeps them). A sample whose neighbour lies in another slice
  // is left as it is when the CTB's own slice does not filter across
  // slices (the standard takes the later slice's flag).
  std::vector<uint8_t> pre[3];      // each plane's samples before SAO
  std::vector<uint8_t> applied[3];  // each CTB's SAO applied, by component
  std::vector<uint8_t> sao_done;
  uint8_t sao_blk[66 * 66];         // a CTB and its ring of neighbours
  void sao_ctb(int xc, int yc) {
    int cw = sps->ctb_w, idx = yc * cw + xc;
    if (sao_done[size_t(idx)]) return;
    sao_done[size_t(idx)] = 1;
    const CtbInfo& ci = ctbs[size_t(idx)];
    for (int c = 0; c < 3; c++) {
      int type = ci.sao_type[c];
      if (!type) continue;
      int sub = c ? 1 : 0, pw = W >> sub, ph = H >> sub, cs = ctb_size >> sub;
      std::vector<uint8_t>& plane = c == 0 ? cur->y : c == 1 ? cur->u : cur->v;
      std::vector<uint8_t>& before = pre[c];
      int x0 = xc * cs, y0 = yc * cs, x1 = std::min(x0 + cs, pw), y1 = std::min(y0 + cs, ph);
      // the block and its ring, (x1 - x0 + 2) wide around (x0 - 1, y0 - 1):
      // the CTB's deblocked samples, and each neighbour's as it stands
      int bw = x1 - x0 + 2;
      uint8_t* blk = sao_blk + bw + 1;  // blk[(y - y0) * bw + x - x0]
      for (int y = y0; y < y1; y++)
        memcpy(blk + (y - y0) * bw, &plane[size_t(y) * pw + x0], size_t(x1 - x0));
      auto ring = [&](int x, int y) {
        if (x < 0 || y < 0 || x >= pw || y >= ph) return;
        const std::vector<uint8_t>& from = applied[c][size_t((y / cs) * cw + x / cs)] ? before
                                                                                          : plane;
        blk[(y - y0) * bw + x - x0] = from[size_t(y) * pw + x];
      };
      for (int x = x0 - 1; x <= x1; x++) {
        ring(x, y0 - 1);
        ring(x, y1);
      }
      for (int y = y0; y < y1; y++) {
        ring(x0 - 1, y);
        ring(x1, y);
      }
      for (int y = y0; y < y1; y++)
        memcpy(&before[size_t(y) * pw + x0], &plane[size_t(y) * pw + x0], size_t(x1 - x0));
      applied[c][size_t(idx)] = 1;
      if (type == 1) {
        int table[32] = {0};
        for (int k = 0; k < 4; k++) table[(k + ci.sao_band[c]) & 31] = ci.sao_off[c][k];
        for (int y = y0; y < y1; y++) {
          const uint8_t* b = blk + (y - y0) * bw - x0;
          uint8_t* row = &plane[size_t(y) * pw];
          for (int x = x0; x < x1; x++) row[x] = clip1(b[x] + table[b[x] >> 3]);
        }
        continue;
      }
      static const int kH[4][2] = {{-1, 1}, {0, 0}, {-1, 1}, {1, -1}};
      static const int kV[4][2] = {{0, 0}, {-1, 1}, {-1, 1}, {-1, 1}};
      static const int kEdgeIdx[5] = {1, 2, 0, 3, 4};
      int eo = ci.sao_eo[c];
      int off[5] = {0, ci.sao_off[c][0], ci.sao_off[c][1], ci.sao_off[c][2], ci.sao_off[c][3]};
      int da = kV[eo][0] * bw + kH[eo][0], db = kV[eo][1] * bw + kH[eo][1];
      for (int y = y0; y < y1; y++) {
        bool edge_row = y == y0 || y == y1 - 1;
        const uint8_t* b = blk + (y - y0) * bw - x0;
        uint8_t* row = &plane[size_t(y) * pw];
        for (int x = x0; x < x1; x++) {
          if (edge_row || x == x0 || x == x1 - 1) {
            // a neighbour outside the CTB: outside the picture, or in a
            // slice this one does not filter across
            int xa = x + kH[eo][0], ya = y + kV[eo][0], xb = x + kH[eo][1], yb = y + kV[eo][1];
            if (xa < 0 || ya < 0 || xb < 0 || yb < 0 || xa >= pw || xb >= pw || ya >= ph ||
                yb >= ph)
              continue;
            if (!ci.across && (ctbs[size_t((ya / cs) * cw + xa / cs)].slice_addr != ci.slice_addr ||
                               ctbs[size_t((yb / cs) * cw + xb / cs)].slice_addr != ci.slice_addr))
              continue;
          }
          int v = b[x];
          row[x] = clip1(v + off[kEdgeIdx[2 + sign(v - b[x + da]) + sign(v - b[x + db])]]);
        }
      }
    }
  }

  // libavcodec's in-loop filter schedule (its ff_hevc_hls_filters and
  // ff_hevc_hls_filter): after each CTB in raster order, the CTB up and to
  // the left of it is deblocked, then the one up and left of that is given
  // SAO (along the last column and row, the ones there); the last CTB's
  // call comes after the picture
  void hls_filter(int xc, int yc) {
    int cw = sps->ctb_w, ch = sps->ctb_h;
    bool x_end = xc == cw - 1, y_end = yc == ch - 1;
    deblock_ctb(xc, yc);
    if (!sps->sao) return;
    if (yc && xc) sao_ctb(xc - 1, yc - 1);
    if (xc && y_end) sao_ctb(xc - 1, yc);
    if (yc && x_end) {
      sao_ctb(xc, yc - 1);
      if (y_end) sao_ctb(xc, yc);
    }
  }

  void loop_filters() {
    int cw = sps->ctb_w, ch = sps->ctb_h;
    sao_done.assign(size_t(cw) * ch, 0);
    for (auto& a : applied) a.assign(size_t(cw) * ch, 0);
    if (sps->sao) {
      pre[0].assign(cur->y.size(), 0);
      pre[1].assign(cur->u.size(), 0);
      pre[2].assign(cur->v.size(), 0);
    }
    for (int yc = 0; yc < ch; yc++)
      for (int xc = 0; xc < cw; xc++) {
        bool x_end = xc == cw - 1, y_end = yc == ch - 1;
        if (yc && xc) hls_filter(xc - 1, yc - 1);
        if (yc && x_end) hls_filter(xc, yc - 1);
        if (xc && y_end) hls_filter(xc - 1, yc);
      }
    hls_filter(cw - 1, ch - 1);
    if (sps->sao)
      for (int yc = 0; yc < ch; yc++)
        for (int xc = 0; xc < cw; xc++) sao_ctb(xc, yc);
  }

  // the picture decoded: its in-loop filters, then it may be output
  void finish_picture() {
    if (!cur) {
      cur_skipped = false;
      return;
    }
    for (auto& ci : ctbs)
      if (ci.slice_addr == -1) corrupt("a picture with CTBs missing");
    loop_filters();
    cur->ms = std::chrono::duration<double, std::milli>(std::chrono::steady_clock::now() - t0).count();
    cur.reset();
    cur_skipped = false;
  }

  // the end of the stream: every picture awaiting output leaves
  void flush() {
    finish_picture();
    while (bump(0, 0, false)) {
    }
  }
};

// ---------------------------------------------------------------- streams

// an MP4 file's HEVC track: the hvcC box's parameter sets, then its
// samples one access unit at a time
struct Stream {
  std::vector<uint8_t> data;
  native::Track track;
  Decoder dec;
  int length_size = 4;
  size_t next = 0;
  bool flushed = false;
  PicPtr frame;

  void open(const uint8_t* d, size_t n) {
    data.assign(d, d + n);
    if (!native::is_mp4(data.data(), data.size())) refuse("HEVC outside an MP4 file");
    track = native::demux_mp4(data.data(), data.size());
    if (track.entry != native::fourcc("hvc1") && track.entry != native::fourcc("hev1"))
      refuse("codecs other than HEVC (sample entry '" + native::fourcc_name(track.entry) + "')");
    const uint8_t* c = track.config.first;
    size_t cn = track.config.second;
    if (cn < 23) corrupt("truncated hvcC");
    length_size = (c[21] & 3) + 1;
    if (length_size == 3) corrupt("hvcC lengthSizeMinusOne of 2");
    size_t p = 23;
    for (int a = 0; a < c[22]; a++) {
      if (p + 3 > cn) corrupt("truncated hvcC array");
      int count = c[p + 1] << 8 | c[p + 2];
      p += 3;
      for (int i = 0; i < count; i++) {
        if (p + 2 > cn) corrupt("truncated hvcC NAL unit");
        size_t len = size_t(c[p] << 8 | c[p + 1]);
        p += 2;
        if (p + len > cn) corrupt("truncated hvcC NAL unit");
        dec.nal(c + p, len);
        p += len;
      }
    }
  }

  // decodes until a frame is out; false at the end of the stream
  bool advance() {
    while (dec.out.empty()) {
      if (next < track.samples.size()) {
        auto s = track.samples[next++];
        dec.decode_au(s.first, s.second, length_size);
      } else if (!flushed) {
        dec.flush();
        flushed = true;
      } else {
        return false;
      }
    }
    frame = dec.out.front();
    dec.out.pop_front();
    return true;
  }
};

}  // namespace

// hc_open: a decoder of the MP4 file data[0..n) (copied); null on failure,
// with *rc -1 (corrupt) or -2 (not supported) and the message in err.
extern "C" void* hc_open(const uint8_t* data, size_t n, int* rc, char* err, int err_len) {
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

// hc_next: decodes until the next frame is out; 1 with its cropped size, 0
// at the end of the stream, -1 / -2 on failure.
extern "C" int hc_next(void* h, int* w, int* hgt, char* err, int err_len) {
  Stream* s = static_cast<Stream*>(h);
  try {
    if (!s->advance()) return 0;
    const Picture& f = *s->frame;
    *w = f.w - f.crop_l - f.crop_r;
    *hgt = f.h - f.crop_t - f.crop_b;
    return 1;
  } catch (const Failure& f) {
    return native::report(f, err, err_len);
  } catch (const std::bad_alloc&) {
    return native::report(Failure{1, "out of memory"}, err, err_len);
  } catch (const std::exception& e) {
    return native::report(Failure{1, std::string("decoder error: ") + e.what()}, err, err_len);
  }
}

// hc_take: the frame hc_next announced, as RGB (or BGR) uint8 [h, w, 3].
extern "C" void hc_take(void* h, uint8_t* out, int bgr) {
  Stream* s = static_cast<Stream*>(h);
  const Picture& f = *s->frame;
  int cw = f.w / 2;
  native::yuv420_to_rgb(f.y.data() + size_t(f.crop_t) * f.w + f.crop_l, f.w,
                        f.u.data() + size_t(f.crop_t / 2) * cw + f.crop_l / 2,
                        f.v.data() + size_t(f.crop_t / 2) * cw + f.crop_l / 2, cw,
                        f.w - f.crop_l - f.crop_r, f.h - f.crop_t - f.crop_b, f.matrix,
                        f.full_range != 0, out, bgr != 0);
  s->frame.reset();
}

// hc_take_yuv: the frame hc_next announced as its cropped planes: luma
// [h, w], then each chroma plane [h / 2, w / 2].
extern "C" void hc_take_yuv(void* h, uint8_t* y, uint8_t* u, uint8_t* v) {
  Stream* s = static_cast<Stream*>(h);
  const Picture& f = *s->frame;
  int w = f.w - f.crop_l - f.crop_r, hh = f.h - f.crop_t - f.crop_b, cw = w / 2, ch = hh / 2;
  for (int r = 0; r < hh; r++)
    memcpy(y + size_t(r) * w, &f.y[size_t(r + f.crop_t) * f.w + f.crop_l], size_t(w));
  for (int r = 0; r < ch; r++) {
    size_t at = size_t(r + f.crop_t / 2) * (f.w / 2) + f.crop_l / 2;
    memcpy(u + size_t(r) * cw, &f.u[at], size_t(cw));
    memcpy(v + size_t(r) * cw, &f.v[at], size_t(cw));
  }
  s->frame.reset();
}

// hc_info: of the frame hc_next announced, 1, and in kinds[0] and ms[0]
// its first slice's type ('I', 'P' or 'B') and the ms its decoding took
// (before the RGB conversion).
extern "C" int hc_info(void* h, char* kinds, double* ms) {
  Stream* s = static_cast<Stream*>(h);
  kinds[0] = s->frame->kind;
  ms[0] = s->frame->ms;
  return 1;
}

extern "C" void hc_close(void* h) { delete static_cast<Stream*>(h); }
