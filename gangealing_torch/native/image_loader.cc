// Multithreaded image-decoding prefetcher over an LMDB image dataset.
//
// The reference feeds training through torch DataLoader worker processes
// (datasets/__init__.py:20-41). This is the TPU-native runtime equivalent:
// worker threads read encoded images straight out of the mmap'd LMDB
// (native/lmdb_kv.cc), decode JPEG/PNG via libjpeg/libpng, normalize to
// float32 CHW in [-1, 1], and stage ready batches in a bounded ring buffer
// that the host consumes between device steps.
//
// C ABI (ctypes):
//   gt_loader_create(path, resolution, batch, threads, shuffle, seed, depth)
//   gt_loader_next(h, out_floats, out_indices) -> n or -1
//   gt_loader_set_epoch(h, seed)   (reshuffles; takes effect next epoch)
//   gt_loader_len(h)               (dataset length)
//   gt_loader_destroy(h)

#include <atomic>
#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <csetjmp>

extern "C" {
void* gt_lmdb_open(const char* path);
void gt_lmdb_close(void* h);
int64_t gt_lmdb_get(void* h, const uint8_t* key, size_t klen,
                    const uint8_t** val);
}

namespace {

struct JErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jerr_exit(j_common_ptr cinfo) {
  JErr* e = reinterpret_cast<JErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// Decode JPEG bytes -> RGB8 (returns false on failure).
bool decode_jpeg(const uint8_t* data, size_t len, std::vector<uint8_t>* rgb,
                 int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jerr_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  rgb->resize(size_t(*w) * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = rgb->data() + size_t(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

struct PngReadState {
  const uint8_t* data;
  size_t len;
  size_t pos;
};

void png_read_cb(png_structp png, png_bytep out, png_size_t n) {
  PngReadState* s = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (s->pos + n > s->len) {
    png_error(png, "read past end");
    return;
  }
  memcpy(out, s->data + s->pos, n);
  s->pos += n;
}

bool decode_png(const uint8_t* data, size_t len, std::vector<uint8_t>* rgb,
                int* w, int* h) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  PngReadState st{data, len, 0};
  png_set_read_fn(png, &st, png_read_cb);
  png_read_info(png, info);
  png_set_expand(png);          // palette/gray/low-depth -> 8-bit
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  *w = png_get_image_width(png, info);
  *h = png_get_image_height(png, info);
  rgb->resize(size_t(*w) * *h * 3);
  std::vector<png_bytep> rows(*h);
  for (int y = 0; y < *h; ++y)
    rows[y] = rgb->data() + size_t(y) * *w * 3;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

struct Batch {
  std::vector<float> data;      // (batch, 3, res, res)
  std::vector<int64_t> indices;
  int count = 0;
};

struct Loader {
  void* env = nullptr;
  int resolution = 256;
  int batch = 64;
  int num_threads = 4;
  bool shuffle = true;
  int64_t length = 0;
  // written by gt_loader_set_epoch while workers read it concurrently in
  // reshuffle(): atomic, or the epoch shuffle becomes nondeterministic
  std::atomic<uint64_t> seed{0};

  std::vector<int64_t> order;
  std::mutex order_mu;  // guards order + cursor + epoch_counter
  size_t cursor = 0;
  uint64_t epoch_counter = 0;
  std::atomic<bool> stop{false};

  std::mutex mu;
  std::condition_variable cv_full, cv_empty;
  // Ordered delivery: chunks carry a ticket; the consumer pops them in
  // dispense order, so the stream is deterministic for a given seed.
  std::map<uint64_t, Batch> ready;
  uint64_t next_ticket = 0;    // under order_mu
  uint64_t expected_out = 0;   // under mu
  size_t max_depth = 4;

  std::vector<std::thread> workers;

  void reshuffle(uint64_t s) {
    order.resize(length);
    for (int64_t i = 0; i < length; ++i) order[i] = i;
    if (shuffle) {
      std::mt19937_64 rng(s);
      std::shuffle(order.begin(), order.end(), rng);
    }
  }

  bool decode_index(int64_t idx, float* out) const {
    char key[64];
    int klen = snprintf(key, sizeof(key), "%d-%05lld", resolution,
                        static_cast<long long>(idx));
    const uint8_t* val = nullptr;
    int64_t n = gt_lmdb_get(env, reinterpret_cast<const uint8_t*>(key),
                            klen, &val);
    if (n < 0) return false;
    std::vector<uint8_t> rgb;
    int w = 0, h = 0;
    bool ok = false;
    if (n > 3 && val[0] == 0xFF && val[1] == 0xD8) {
      ok = decode_jpeg(val, size_t(n), &rgb, &w, &h);
    } else if (n > 8 && val[1] == 'P' && val[2] == 'N' && val[3] == 'G') {
      ok = decode_png(val, size_t(n), &rgb, &w, &h);
    } else {
      ok = decode_jpeg(val, size_t(n), &rgb, &w, &h) ||
           decode_png(val, size_t(n), &rgb, &w, &h);
    }
    if (!ok || w != resolution || h != resolution) return false;
    // HWC uint8 -> CHW float [-1, 1]
    const int res = resolution;
    for (int c = 0; c < 3; ++c) {
      float* dst = out + size_t(c) * res * res;
      const uint8_t* src = rgb.data() + c;
      for (int i = 0; i < res * res; ++i) {
        dst[i] = float(src[size_t(i) * 3]) * (2.0f / 255.0f) - 1.0f;
      }
    }
    return true;
  }

  void worker() {
    const size_t img_floats = size_t(3) * resolution * resolution;
    while (!stop.load()) {
      // Dispense a contiguous index chunk under a lock; reshuffles happen
      // only here, so no worker ever reads `order` while it mutates.
      std::vector<int64_t> idxs;
      uint64_t ticket;
      {
        std::lock_guard<std::mutex> lk(order_mu);
        if (cursor >= order.size()) {
          epoch_counter++;
          reshuffle(seed.load() + epoch_counter * 0x9e3779b97f4a7c15ULL);
          cursor = 0;
        }
        size_t start = cursor;
        size_t end = std::min(start + size_t(batch), order.size());
        cursor = end;
        idxs.assign(order.begin() + start, order.begin() + end);
        ticket = next_ticket++;
      }
      // NOTE: even an empty chunk must be delivered — skipping it would
      // leave a permanent hole in the ticket sequence and hang the
      // consumer (create() rejects length<=0, so this is defensive)
      Batch b;
      b.data.resize(size_t(batch) * img_floats, 0.0f);
      b.indices.resize(batch, -1);
      int out_i = 0;
      for (int64_t idx : idxs) {
        if (decode_index(idx, b.data.data() + size_t(out_i) * img_floats)) {
          b.indices[out_i] = idx;
          out_i++;
        }
      }
      b.count = out_i;  // may be 0 (all decodes failed); deliver anyway so
                        // the ticket sequence has no holes
      {
        std::unique_lock<std::mutex> lk(mu);
        // Window backpressure: admitting by ticket distance (not map size)
        // guarantees the consumer's next expected ticket can always enter,
        // so slow decoders cannot deadlock the ordered queue.
        cv_full.wait(lk, [&] {
          return ticket < expected_out + max_depth || stop.load();
        });
        if (stop.load()) return;
        ready.emplace(ticket, std::move(b));
      }
      cv_empty.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* gt_loader_create(const char* path, int resolution, int batch,
                       int num_threads, int shuffle, uint64_t seed,
                       int depth) {
  Loader* l = new Loader();
  l->env = gt_lmdb_open(path);
  if (!l->env) {
    delete l;
    return nullptr;
  }
  const uint8_t* val = nullptr;
  int64_t n = gt_lmdb_get(l->env, reinterpret_cast<const uint8_t*>("length"),
                          6, &val);
  if (n <= 0) {
    gt_lmdb_close(l->env);
    delete l;
    return nullptr;
  }
  l->length = atoll(std::string(reinterpret_cast<const char*>(val),
                                size_t(n)).c_str());
  if (l->length <= 0) {  // empty dataset: error now, not a consumer hang
    gt_lmdb_close(l->env);
    delete l;
    return nullptr;
  }
  l->resolution = resolution;
  l->batch = batch;
  l->num_threads = std::max(1, num_threads);
  l->shuffle = shuffle != 0;
  l->seed = seed;
  l->max_depth = depth > 0 ? size_t(depth) : 4;
  l->reshuffle(seed);
  for (int i = 0; i < l->num_threads; ++i)
    l->workers.emplace_back(&Loader::worker, l);
  return l;
}

int64_t gt_loader_len(void* h) {
  return static_cast<Loader*>(h)->length;
}

// Blocks until a batch is ready. out must hold batch*3*res*res floats and
// indices batch int64s. Returns the number of valid images, -1 if the
// loader was destroyed, or -2 if a full epoch's worth of consecutive
// chunks decoded ZERO images (wrong `resolution` key prefix or a corrupt
// dataset) — erroring beats blocking forever on a user mistake the
// pure-Python loader reports as a KeyError.
int gt_loader_next(void* h, float* out, int64_t* indices) {
  Loader* l = static_cast<Loader*>(h);
  const uint64_t chunks_per_epoch =
      (uint64_t(l->length) + l->batch - 1) / l->batch;
  uint64_t consecutive_empty = 0;
  for (;;) {
    Batch b;
    {
      std::unique_lock<std::mutex> lk(l->mu);
      l->cv_empty.wait(lk, [&] {
        return l->ready.count(l->expected_out) > 0 || l->stop.load();
      });
      if (l->stop.load()) return -1;
      auto it = l->ready.find(l->expected_out);
      b = std::move(it->second);
      l->ready.erase(it);
      l->expected_out++;
    }
    l->cv_full.notify_all();
    if (b.count == 0) {  // fully-failed chunk: skip transparently
      if (++consecutive_empty > chunks_per_epoch) return -2;
      continue;
    }
    memcpy(out, b.data.data(), b.data.size() * sizeof(float));
    memcpy(indices, b.indices.data(), b.indices.size() * sizeof(int64_t));
    return b.count;
  }
}

void gt_loader_set_epoch(void* h, uint64_t s) {
  static_cast<Loader*>(h)->seed = s;
}

void gt_loader_destroy(void* h) {
  Loader* l = static_cast<Loader*>(h);
  l->stop.store(true);
  l->cv_full.notify_all();
  l->cv_empty.notify_all();
  for (auto& t : l->workers) t.join();
  gt_lmdb_close(l->env);
  delete l;
}

}  // extern "C"
