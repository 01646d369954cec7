// Native data-loader core: threaded JPEG decode + bilinear resize to
// fixed-size uint8 RGB batches, and the JPEG encoder of the synthetic
// dataset generator.
//
// Built with -DENDO_BYTES_ONLY it needs no libjpeg: the worker threads
// only read the files and hand out their bytes with their indices
// (loader_next_bytes / loader_copy_bytes), for a decoder elsewhere (the
// card's, data/jpeg_card.py). The shuffle, the wrap-around batches, the
// bounded queue and the all-unreadable sentinel are the same code, so the
// same paths and seed give the same index stream as the libjpeg build.
//
// A copy of the JAX package's loader core: the decode, the resize, the
// Loader (its shuffle, queue and corrupt-file sentinel) and the four
// loader_* entry points are unchanged, so the same files and seed give the
// same pixels and the same index stream. jpeg_write_rgb is the one
// addition: libjpeg's compressor on RGB rows at a given quality, the
// counterpart of cv2.imwrite(..., [IMWRITE_JPEG_QUALITY, q]).
//
// A C++ thread pool streams decoded canonical-size images into a bounded
// queue; Python drains whole batches via ctypes. Shuffle semantics match
// the RandomSampler-with-recycling contract: reshuffled epochs,
// wrap-around fixed-size batches.
//
// Build (data/native_loader.py does it at first use, into build/native/):
//   g++ -O3 -shared -fPIC -std=c++17 loader.cpp -o libendoloader.so -ljpeg -lpthread
//   g++ -O3 -shared -fPIC -std=c++17 -DENDO_BYTES_ONLY loader.cpp -o libendoloader-bytes.so -lpthread

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#ifndef ENDO_BYTES_ONLY
#include <jpeglib.h>
#include <setjmp.h>
#endif

namespace {

#ifndef ENDO_BYTES_ONLY

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG byte buffer to RGB; returns empty on failure.
bool decode_jpeg(const uint8_t* data, size_t len, std::vector<uint8_t>& out,
                 int& w, int& h) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  w = cinfo.output_width;
  h = cinfo.output_height;
  out.resize(static_cast<size_t>(w) * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// Bilinear resize RGB uint8 (src h*w) -> dst (size*size).
void resize_bilinear(const uint8_t* src, int sw, int sh, uint8_t* dst, int size) {
  const float sx = static_cast<float>(sw) / size;
  const float sy = static_cast<float>(sh) / size;
  for (int y = 0; y < size; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = fy < 0 ? 0 : static_cast<int>(fy);
    if (y0 > sh - 2) y0 = sh - 2;
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    for (int x = 0; x < size; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = fx < 0 ? 0 : static_cast<int>(fx);
      if (x0 > sw - 2) x0 = sw - 2;
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      const uint8_t* p00 = src + (static_cast<size_t>(y0) * sw + x0) * 3;
      const uint8_t* p01 = p00 + 3;
      const uint8_t* p10 = p00 + static_cast<size_t>(sw) * 3;
      const uint8_t* p11 = p10 + 3;
      uint8_t* d = dst + (static_cast<size_t>(y) * size + x) * 3;
      for (int c = 0; c < 3; ++c) {
        float top = p00[c] * (1 - wx) + p01[c] * wx;
        float bot = p10[c] * (1 - wx) + p11[c] * wx;
        float v = top * (1 - wy) + bot * wy;
        d[c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}
#endif  // ENDO_BYTES_ONLY

struct Item {
  int64_t index;
  std::vector<uint8_t> pixels;  // size*size*3; the file's bytes in ENDO_BYTES_ONLY
};

class Loader {
 public:
  Loader(std::vector<std::string> paths, int size, int num_threads,
         int queue_depth, uint64_t seed, bool shuffle)
      : paths_(std::move(paths)), size_(size), queue_depth_(queue_depth),
        shuffle_(shuffle), rng_(seed), stop_(false) {
    order_.resize(paths_.size());
    for (size_t i = 0; i < order_.size(); ++i) order_[i] = i;
    reshuffle();
    for (int t = 0; t < num_threads; ++t)
      workers_.emplace_back([this] { worker(); });
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_not_full_.notify_all();
    cv_not_empty_.notify_all();
    for (auto& t : workers_) t.join();
  }

  // Unreadable/undecodable files skipped so far (never enqueued): the
  // stream stays fixed-shape, but callers can detect silent data loss.
  int64_t dropped() const { return dropped_.load(); }

  // Fill a batch: images (n*size*size*3 uint8), indices (n int64).
  void next(int n, uint8_t* images, int64_t* indices) {
    for (int i = 0; i < n; ++i) {
      Item item;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_not_empty_.wait(lk, [this] { return !queue_.empty() || stop_; });
        if (stop_ && queue_.empty()) return;
        item = std::move(queue_.front());
        queue_.pop_front();
      }
      cv_not_full_.notify_one();
      std::memcpy(images + static_cast<size_t>(i) * size_ * size_ * 3,
                  item.pixels.data(), item.pixels.size());
      indices[i] = item.index;
    }
  }

  // Take the next n items: their indices and byte counts; returns the
  // total byte count. loader_copy_bytes then copies their bytes, in order,
  // into one buffer. One consumer at a time.
  int64_t next_bytes(int n, int64_t* indices, int64_t* lengths) {
    taken_.clear();
    int64_t total = 0;
    for (int i = 0; i < n; ++i) {
      Item item;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_not_empty_.wait(lk, [this] { return !queue_.empty() || stop_; });
        if (stop_ && queue_.empty()) return total;
        item = std::move(queue_.front());
        queue_.pop_front();
      }
      cv_not_full_.notify_one();
      indices[i] = item.index;
      lengths[i] = static_cast<int64_t>(item.pixels.size());
      total += lengths[i];
      taken_.push_back(std::move(item));
    }
    return total;
  }

  void copy_bytes(uint8_t* out) {
    for (const Item& item : taken_) {
      if (!item.pixels.empty())
        std::memcpy(out, item.pixels.data(), item.pixels.size());
      out += item.pixels.size();
    }
    taken_.clear();
  }

 private:
  void reshuffle() {
    if (shuffle_) {
      for (size_t i = order_.size(); i > 1; --i) {
        size_t j = rng_() % i;
        std::swap(order_[i - 1], order_[j]);
      }
    }
    cursor_ = 0;
    // The all-corrupt sentinel means "a full pass decoded nothing", so the
    // failure streak must not straddle pass boundaries: with 1 good file of
    // N, the tail of pass k plus the head of pass k+1 can exceed N even
    // though every pass yields a valid item.
    consecutive_failures_ = 0;
  }

  int64_t next_index() {
    std::lock_guard<std::mutex> lk(order_mu_);
    if (cursor_ >= order_.size()) reshuffle();
    return order_[cursor_++];
  }

  void worker() {
    std::vector<uint8_t> raw;
#ifndef ENDO_BYTES_ONLY
    std::vector<uint8_t> decoded;
    int w = 0, h = 0;
#endif
    while (true) {
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_not_full_.wait(lk, [this] {
          return queue_.size() < static_cast<size_t>(queue_depth_) || stop_;
        });
        if (stop_) return;
      }
      int64_t idx = next_index();
      const std::string& path = paths_[idx];

      bool ok = false;
      FILE* f = std::fopen(path.c_str(), "rb");
      if (f) {
        std::fseek(f, 0, SEEK_END);
        long len = std::ftell(f);
        std::fseek(f, 0, SEEK_SET);
        raw.resize(len > 0 ? len : 0);
        size_t rd = len > 0 ? std::fread(raw.data(), 1, len, f) : 0;
        std::fclose(f);
        ok = len > 0 && rd == static_cast<size_t>(len);
#ifndef ENDO_BYTES_ONLY
        ok = ok && decode_jpeg(raw.data(), raw.size(), decoded, w, h);
#endif
      }
      if (!ok) {
        ++dropped_;
        // Safety valve: with every file undecodable the queue would never
        // fill and next() would block forever. After a full failed pass
        // over the dataset, enqueue a sentinel (index = -1) so the Python
        // side can raise instead of hanging.
        if (++consecutive_failures_ >= static_cast<int64_t>(paths_.size())) {
          consecutive_failures_ = 0;
          Item sentinel;
          sentinel.index = -1;
#ifndef ENDO_BYTES_ONLY
          sentinel.pixels.assign(
              static_cast<size_t>(size_) * size_ * 3, 0);
#endif
          {
            std::unique_lock<std::mutex> lk(mu_);
            cv_not_full_.wait(lk, [this] {
              return queue_.size() < static_cast<size_t>(queue_depth_) ||
                     stop_;
            });
            if (stop_) return;
            queue_.push_back(std::move(sentinel));
          }
          cv_not_empty_.notify_one();
        }
        continue;
      }
      consecutive_failures_ = 0;

      Item item;
      item.index = idx;
#ifdef ENDO_BYTES_ONLY
      item.pixels = std::move(raw);
      raw = std::vector<uint8_t>();
#else
      item.pixels.resize(static_cast<size_t>(size_) * size_ * 3);
      resize_bilinear(decoded.data(), w, h, item.pixels.data(), size_);
#endif

      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_not_full_.wait(lk, [this] {
          return queue_.size() < static_cast<size_t>(queue_depth_) || stop_;
        });
        if (stop_) return;
        queue_.push_back(std::move(item));
      }
      cv_not_empty_.notify_one();
    }
  }

  std::vector<std::string> paths_;
  int size_;
  int queue_depth_;
  bool shuffle_;
  std::mt19937_64 rng_;

  std::mutex order_mu_;
  std::vector<int64_t> order_;
  size_t cursor_ = 0;

  std::mutex mu_;
  std::condition_variable cv_not_empty_, cv_not_full_;
  std::deque<Item> queue_;
  std::vector<Item> taken_;  // next_bytes' items until copy_bytes
  std::vector<std::thread> workers_;
  std::atomic<int64_t> dropped_{0};
  std::atomic<int64_t> consecutive_failures_{0};
  bool stop_;
};

}  // namespace

extern "C" {

void* loader_create(const char** paths, int64_t n, int size, int num_threads,
                    int queue_depth, uint64_t seed, int shuffle) {
  std::vector<std::string> p(paths, paths + n);
  return new Loader(std::move(p), size, num_threads, queue_depth, seed,
                    shuffle != 0);
}

void loader_next(void* handle, int n, uint8_t* images, int64_t* indices) {
  static_cast<Loader*>(handle)->next(n, images, indices);
}

int64_t loader_dropped(void* handle) {
  return static_cast<Loader*>(handle)->dropped();
}

void loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

int64_t loader_next_bytes(void* handle, int n, int64_t* indices,
                          int64_t* lengths) {
  return static_cast<Loader*>(handle)->next_bytes(n, indices, lengths);
}

void loader_copy_bytes(void* handle, uint8_t* out) {
  static_cast<Loader*>(handle)->copy_bytes(out);
}

#ifndef ENDO_BYTES_ONLY
// Decode one JPEG byte buffer to RGB rows at its own size, with no
// resize: h*w*3 bytes into `out` when they fit in `capacity`. Sets *h and
// *w; returns 0 on success, 1 when libjpeg fails, 2 when `out` is too
// small (call again with h*w*3 bytes).
int jpeg_decode_rgb(const uint8_t* data, int64_t len, uint8_t* out,
                    int64_t capacity, int* h, int* w) {
  std::vector<uint8_t> decoded;
  if (!decode_jpeg(data, static_cast<size_t>(len), decoded, *w, *h)) return 1;
  if (static_cast<int64_t>(decoded.size()) > capacity) return 2;
  std::memcpy(out, decoded.data(), decoded.size());
  return 0;
}

// Encode h*w RGB uint8 rows (row-major, 3 bytes a pixel) to a baseline
// JPEG file at `quality` with libjpeg's defaults (4:2:0 chroma, the slow
// integer DCT). Returns 0 on success, 1 when the file cannot be opened,
// 2 on a libjpeg error, 3 when the file cannot be completely written.
int jpeg_write_rgb(const char* path, const uint8_t* pixels, int h, int w,
                   int quality) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  jpeg_compress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_compress(&cinfo);
    std::fclose(f);
    return 2;
  }
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, f);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(
        pixels + static_cast<size_t>(cinfo.next_scanline) * w * 3);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  return std::fclose(f) == 0 ? 0 : 3;
}
#endif  // ENDO_BYTES_ONLY

}  // extern "C"
