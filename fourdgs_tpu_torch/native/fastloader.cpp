// fastloader: multithreaded PNG decode + prefetch for training batches.
//
// The port's copy of fourdgs_tpu/native/fastloader.cpp: a pthread worker
// pool decodes 8-bit PNG frames (the DyNeRF loader's extracted video frames)
// straight into caller-provided RGB buffers, outside the Python GIL, while
// the training step runs on the card: the role of the reference's torch
// DataLoader workers (reference train.py:91-94). Exposed through a minimal C
// API consumed via ctypes (fourdgs_tpu_torch.data.fastloader).
//
// Scope: PNG color types 2 (RGB) / 6 (RGBA, alpha dropped), 8-bit depth, all
// five scanline filters, no interlacing, exactly the size the caller names.
// Anything else is rejected with a negative status, and the Python side
// sends the frame to its ref's own decoder and counts it.
//
// Build (data/fastloader.py, at first use):
//   g++ -O2 -shared -fPIC fastloader.cpp -o libfastloader-<hash>.so -lz -lpthread

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

struct PngImage {
  uint32_t width = 0;
  uint32_t height = 0;
  int channels = 0;  // 3 or 4 (source)
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Decode an 8-bit RGB/RGBA non-interlaced PNG into out (H*W*3, RGB).
// Returns 0 on success, negative error codes otherwise.
int decode_png_rgb(const uint8_t* data, size_t size, uint8_t* out,
                   uint32_t expect_w, uint32_t expect_h) {
  static const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (size < 8 || memcmp(data, kSig, 8) != 0) return -1;

  PngImage img;
  std::vector<uint8_t> idat;
  size_t pos = 8;
  int bit_depth = 0;
  while (pos + 12 <= size) {
    uint32_t len = be32(data + pos);
    const uint8_t* type = data + pos + 4;
    const uint8_t* payload = data + pos + 8;
    if (pos + 12 + len > size) return -2;
    if (memcmp(type, "IHDR", 4) == 0) {
      if (len < 13) return -3;
      img.width = be32(payload);
      img.height = be32(payload + 4);
      bit_depth = payload[8];
      int color_type = payload[9];
      int interlace = payload[12];
      if (bit_depth != 8 || interlace != 0) return -4;
      if (color_type == 2) img.channels = 3;
      else if (color_type == 6) img.channels = 4;
      else return -5;  // palette/gray: the ref's decoder
    } else if (memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), payload, payload + len);
    } else if (memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;
  }
  if (img.width == 0 || idat.empty()) return -6;
  if (expect_w && (img.width != expect_w || img.height != expect_h))
    return -7;  // caller wants exact size (no resize in native path)

  const int ch = img.channels;
  const size_t stride = size_t(img.width) * ch;
  std::vector<uint8_t> raw((stride + 1) * img.height);
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK)
    return -8;
  if (raw_len != raw.size()) return -9;

  // Unfilter scanlines in place, then emit RGB rows.
  std::vector<uint8_t> prev(stride, 0);
  std::vector<uint8_t> cur(stride);
  for (uint32_t y = 0; y < img.height; ++y) {
    const uint8_t* src = raw.data() + size_t(y) * (stride + 1);
    uint8_t filter = src[0];
    const uint8_t* line = src + 1;
    switch (filter) {
      case 0:
        memcpy(cur.data(), line, stride);
        break;
      case 1:
        for (size_t i = 0; i < stride; ++i) {
          uint8_t left = i >= size_t(ch) ? cur[i - ch] : 0;
          cur[i] = uint8_t(line[i] + left);
        }
        break;
      case 2:
        for (size_t i = 0; i < stride; ++i)
          cur[i] = uint8_t(line[i] + prev[i]);
        break;
      case 3:
        for (size_t i = 0; i < stride; ++i) {
          uint8_t left = i >= size_t(ch) ? cur[i - ch] : 0;
          cur[i] = uint8_t(line[i] + ((left + prev[i]) >> 1));
        }
        break;
      case 4:
        for (size_t i = 0; i < stride; ++i) {
          uint8_t left = i >= size_t(ch) ? cur[i - ch] : 0;
          uint8_t up = prev[i];
          uint8_t ul = i >= size_t(ch) ? prev[i - ch] : 0;
          cur[i] = uint8_t(line[i] + paeth(left, up, ul));
        }
        break;
      default:
        return -10;
    }
    uint8_t* dst = out + size_t(y) * img.width * 3;
    if (ch == 3) {
      memcpy(dst, cur.data(), stride);
    } else {
      for (uint32_t x = 0; x < img.width; ++x) {
        dst[x * 3 + 0] = cur[x * 4 + 0];
        dst[x * 3 + 1] = cur[x * 4 + 1];
        dst[x * 3 + 2] = cur[x * 4 + 2];
      }
    }
    std::swap(prev, cur);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Thread-pool prefetcher

struct Job {
  std::string path;
  uint8_t* out;       // H*W*3 caller buffer
  uint32_t w, h;
  std::atomic<int>* status;  // 0 pending, 1 ok, <0 error
};

class Pool {
 public:
  explicit Pool(int n_threads) : stop_(false) {
    for (int i = 0; i < n_threads; ++i)
      threads_.emplace_back([this] { worker(); });
  }
  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : threads_) t.join();
  }
  void submit(Job j) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      jobs_.push(std::move(j));
    }
    cv_.notify_one();
  }

 private:
  void worker() {
    for (;;) {
      Job j;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
        if (stop_ && jobs_.empty()) return;
        j = std::move(jobs_.front());
        jobs_.pop();
      }
      FILE* f = fopen(j.path.c_str(), "rb");
      if (!f) {
        j.status->store(-100);
        continue;
      }
      fseek(f, 0, SEEK_END);
      long sz = ftell(f);
      fseek(f, 0, SEEK_SET);
      std::vector<uint8_t> buf(sz > 0 ? size_t(sz) : 0);
      size_t rd = buf.empty() ? 0 : fread(buf.data(), 1, buf.size(), f);
      fclose(f);
      if (rd != buf.size()) {
        j.status->store(-101);
        continue;
      }
      int rc = decode_png_rgb(buf.data(), buf.size(), j.out, j.w, j.h);
      j.status->store(rc == 0 ? 1 : rc);
    }
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::queue<Job> jobs_;
  bool stop_;
  std::vector<std::thread> threads_;
};

}  // namespace

extern "C" {

void* fl_pool_create(int n_threads) { return new Pool(n_threads); }

void fl_pool_destroy(void* pool) { delete static_cast<Pool*>(pool); }

// Submit an async decode; *status transitions 0 → 1 (ok) or negative (error).
void fl_submit(void* pool, const char* path, uint8_t* out, uint32_t w,
               uint32_t h, int* status) {
  auto* st = reinterpret_cast<std::atomic<int>*>(status);
  st->store(0);
  static_cast<Pool*>(pool)->submit(
      Job{std::string(path), out, w, h, st});
}

}  // extern "C"
