// f2fio: the host I/O runtime of the streaming denoiser, a C ABI for ctypes
// (frame2frame_tpu_torch/io/native.py): the Middlebury .flo codec, PGM and
// PNG grayscale decode to float32 in [0, 255], and a multi-threaded prefetch
// ring that decodes frames (and their .flo flows) ahead of the consumer and
// delivers them in order.
//
// Built at first use by io/native.py with `g++ -O3 -std=c++17 -shared -fPIC`
// and `-lpthread`, plus `-lpng` where the host has libpng's header: without
// it the library reads PGM and .flo only, and says so (f2f_has_png).
//
// PGM: binary P5, 8 bits with maxval 255, `#` comments in the header, as
// io/image.py read_pgm; any other maxval is refused.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#if __has_include(<png.h>)
#include <png.h>
#define F2F_HAVE_PNG 1
#else
#define F2F_HAVE_PNG 0
#endif

namespace {

constexpr float kFloMagic = 202021.25f;

// return codes of the C entry points
constexpr int kOk = 0;
constexpr int kReadFailed = -1;   // missing, unreadable or malformed file
constexpr int kBadIndex = -2;     // a frame index outside the sequence
constexpr int kNoPng = -3;        // a .png path in a build without libpng
constexpr int kBadMaxval = -4;    // a PGM whose maxval is not 255
constexpr int kFlowShape = -5;    // a flow whose shape is not the frame's
constexpr int kClosed = -6;       // the ring was closed

// ---------------------------------------------------------------- .flo codec

int read_flo_file(const char* path, std::vector<float>* data, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return kReadFailed;
  float magic = 0.f;
  int32_t wi = 0, hi = 0;
  bool ok = fread(&magic, 4, 1, f) == 1 && magic == kFloMagic &&
            fread(&wi, 4, 1, f) == 1 && fread(&hi, 4, 1, f) == 1 && wi > 0 &&
            hi > 0;
  if (ok) {
    data->resize(static_cast<size_t>(wi) * hi * 2);
    ok = fread(data->data(), 4, data->size(), f) == data->size();
  }
  fclose(f);
  if (!ok) return kReadFailed;
  *w = wi;
  *h = hi;
  return kOk;
}

bool write_flo_file(const char* path, const float* data, int w, int h) {
  FILE* f = fopen(path, "wb");
  if (!f) return false;
  int32_t wi = w, hi = h;
  size_t n = static_cast<size_t>(w) * h * 2;
  bool ok = fwrite(&kFloMagic, 4, 1, f) == 1 && fwrite(&wi, 4, 1, f) == 1 &&
            fwrite(&hi, 4, 1, f) == 1 && fwrite(data, 4, n, f) == n;
  return fclose(f) == 0 && ok;
}

// -------------------------------------------------------------- image decode

#if F2F_HAVE_PNG
// Grayscale float32 in [0, 255]; RGB collapses with the rec.709 luma weights
// of io/image.py read_gray, 16-bit samples are stripped to 8 bits.
int read_png_gray(const char* path, std::vector<float>* out, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return kReadFailed;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return kReadFailed;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_uint_32 width = png_get_image_width(png, info);
  png_uint_32 height = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);
  int channels = png_get_channels(png, info);

  std::vector<uint8_t> row(static_cast<size_t>(width) * channels);
  out->resize(static_cast<size_t>(width) * height);
  for (png_uint_32 y = 0; y < height; ++y) {
    png_read_row(png, row.data(), nullptr);
    float* dst = out->data() + static_cast<size_t>(y) * width;
    if (channels == 1) {
      for (png_uint_32 x = 0; x < width; ++x) dst[x] = row[x];
    } else {
      for (png_uint_32 x = 0; x < width; ++x) {
        const uint8_t* p = &row[static_cast<size_t>(x) * channels];
        dst[x] = static_cast<float>(0.2125 * p[0] + 0.7154 * p[1] +
                                    0.0721 * p[2]);
      }
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(f);
  *w = static_cast<int>(width);
  *h = static_cast<int>(height);
  return kOk;
}
#endif

// The next header token of a PGM (skipping whitespace and # comments), as a
// non-negative integer, or -1.
int pgm_token(FILE* f) {
  int c = fgetc(f);
  for (;;) {
    while (c == ' ' || c == '\t' || c == '\n' || c == '\r') c = fgetc(f);
    if (c != '#') break;
    while (c != '\n' && c != EOF) c = fgetc(f);
  }
  if (c < '0' || c > '9') return -1;
  long v = 0;
  while (c >= '0' && c <= '9' && v < (1L << 30)) {
    v = v * 10 + (c - '0');
    c = fgetc(f);
  }
  return static_cast<int>(v);  // c, the one whitespace after it, is consumed
}

int read_pgm_gray(const char* path, std::vector<float>* out, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return kReadFailed;
  char magic[2] = {0, 0};
  int rc = kReadFailed;
  if (fread(magic, 1, 2, f) == 2 && magic[0] == 'P' && magic[1] == '5') {
    int wi = pgm_token(f), hi = pgm_token(f), maxval = pgm_token(f);
    if (wi > 0 && hi > 0 && maxval == 255) {
      std::vector<uint8_t> buf(static_cast<size_t>(wi) * hi);
      if (fread(buf.data(), 1, buf.size(), f) == buf.size()) {
        out->assign(buf.begin(), buf.end());
        *w = wi;
        *h = hi;
        rc = kOk;
      }
    } else if (wi > 0 && hi > 0 && maxval > 0) {
      rc = kBadMaxval;
    }
  }
  fclose(f);
  return rc;
}

bool has_suffix(const char* path, const char* lower) {
  size_t n = std::strlen(path), m = std::strlen(lower);
  if (n < m) return false;
  for (size_t i = 0; i < m; ++i) {
    char c = path[n - m + i];
    if (c >= 'A' && c <= 'Z') c = static_cast<char>(c - 'A' + 'a');
    if (c != lower[i]) return false;
  }
  return true;
}

int read_image_gray(const char* path, std::vector<float>* out, int* w, int* h) {
  if (has_suffix(path, ".pgm")) return read_pgm_gray(path, out, w, h);
#if F2F_HAVE_PNG
  return read_png_gray(path, out, w, h);
#else
  return kNoPng;
#endif
}

// ------------------------------------------------------------- prefetch ring

struct Frame {
  int w = 0, h = 0;
  std::vector<float> pixels;
  std::vector<float> flow;  // 2 w h, or empty
  int rc = kReadFailed;
};

struct Prefetcher {
  std::vector<std::string> frame_paths;
  std::vector<std::string> flow_paths;  // "" where a frame has no flow
  size_t capacity = 4;
  std::atomic<size_t> next_to_read{0};

  std::mutex mu;
  std::condition_variable cv_put, cv_get;
  std::vector<Frame> done;  // one slot a frame; emptied when delivered
  std::vector<uint8_t> ready;
  size_t next_to_deliver = 0;
  std::vector<std::thread> workers;
  bool stop = false;

  explicit Prefetcher(size_t n) : done(n), ready(n, 0) {}

  void worker() {
    for (;;) {
      size_t idx = next_to_read.fetch_add(1);
      if (idx >= frame_paths.size()) return;
      {
        // decode at most `capacity` frames ahead of the consumer
        std::unique_lock<std::mutex> lk(mu);
        cv_put.wait(lk, [&] { return stop || idx < next_to_deliver + capacity; });
        if (stop) return;
      }
      Frame fr;
      fr.rc = read_image_gray(frame_paths[idx].c_str(), &fr.pixels, &fr.w,
                              &fr.h);
      if (fr.rc == kOk && !flow_paths[idx].empty()) {
        int fw = 0, fh = 0;
        fr.rc = read_flo_file(flow_paths[idx].c_str(), &fr.flow, &fw, &fh);
        if (fr.rc == kOk && (fw != fr.w || fh != fr.h)) fr.rc = kFlowShape;
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        done[idx] = std::move(fr);
        ready[idx] = 1;
      }
      cv_get.notify_all();
    }
  }

  // Waits for frame idx; 0 and its slot, or a code. Asking for frame idx
  // lets the ring decode up to `capacity` frames from idx on, so that a
  // consumer never waits on a frame outside the window.
  int wait(size_t idx, Frame** out) {
    std::unique_lock<std::mutex> lk(mu);
    if (idx > next_to_deliver) {
      next_to_deliver = idx;
      cv_put.notify_all();
    }
    cv_get.wait(lk, [&] { return stop || ready[idx]; });
    if (!ready[idx]) return kClosed;
    *out = &done[idx];
    return kOk;
  }

  // Frees frame idx's slot and moves the window past it.
  void release(size_t idx) {
    {
      std::lock_guard<std::mutex> lk(mu);
      done[idx] = Frame();
      if (idx + 1 > next_to_deliver) next_to_deliver = idx + 1;
    }
    cv_put.notify_all();
  }
};

int copy_out(std::vector<float>& v, float** out) {
  *out = static_cast<float*>(std::malloc(v.size() * sizeof(float)));
  if (!*out) return kReadFailed;
  std::memcpy(*out, v.data(), v.size() * sizeof(float));
  return kOk;
}

}  // namespace

extern "C" {

int f2f_has_png() { return F2F_HAVE_PNG; }

void f2f_free(float* p) { std::free(p); }

// A .flo file: a malloc'd (h, w, 2) buffer in *out (f2f_free it) and 0, or
// a code.
int f2f_read_flo(const char* path, float** out, int* w, int* h) {
  std::vector<float> data;
  int rc = read_flo_file(path, &data, w, h);
  return rc == kOk ? copy_out(data, out) : rc;
}

int f2f_write_flo(const char* path, const float* data, int w, int h) {
  return write_flo_file(path, data, w, h) ? kOk : kReadFailed;
}

// A PGM or PNG frame as grayscale float32 in [0, 255]: a malloc'd (h, w)
// buffer in *out (f2f_free it) and 0, or a code.
int f2f_read_gray(const char* path, float** out, int* w, int* h) {
  std::vector<float> data;
  int rc = read_image_gray(path, &data, w, h);
  return rc == kOk ? copy_out(data, out) : rc;
}

void* f2f_prefetch_open(const char** frame_paths, const char** flow_paths,
                        int n, int capacity, int nthreads) {
  auto* p = new Prefetcher(static_cast<size_t>(n));
  p->capacity = capacity > 0 ? capacity : 4;
  for (int i = 0; i < n; ++i) {
    p->frame_paths.emplace_back(frame_paths[i]);
    p->flow_paths.emplace_back(flow_paths && flow_paths[i] ? flow_paths[i]
                                                           : "");
  }
  int nt = nthreads > 0 ? nthreads : 2;
  for (int i = 0; i < nt; ++i) p->workers.emplace_back([p] { p->worker(); });
  return p;
}

// Blocks until frame idx is decoded; its shape and whether it has a flow,
// and 0, or the code of its failure.
int f2f_prefetch_wait(void* handle, int idx, int* w, int* h, int* has_flow) {
  auto* p = static_cast<Prefetcher*>(handle);
  if (idx < 0 || idx >= static_cast<int>(p->done.size())) return kBadIndex;
  Frame* fr = nullptr;
  int rc = p->wait(static_cast<size_t>(idx), &fr);
  if (rc != kOk) return rc;
  if (fr->rc != kOk) {
    rc = fr->rc;
    p->release(static_cast<size_t>(idx));
    return rc;
  }
  *w = fr->w;
  *h = fr->h;
  *has_flow = fr->flow.empty() ? 0 : 1;
  return kOk;
}

// After f2f_prefetch_wait: copies frame idx's pixels (w h floats) and, where
// it has one, its flow (2 w h floats), then frees its slot and lets the
// ring decode further ahead.
int f2f_prefetch_take(void* handle, int idx, float* pixels, float* flow) {
  auto* p = static_cast<Prefetcher*>(handle);
  if (idx < 0 || idx >= static_cast<int>(p->done.size())) return kBadIndex;
  Frame* fr = nullptr;
  int rc = p->wait(static_cast<size_t>(idx), &fr);
  if (rc != kOk) return rc;
  if (fr->rc != kOk) return fr->rc;
  std::memcpy(pixels, fr->pixels.data(), fr->pixels.size() * sizeof(float));
  if (!fr->flow.empty())
    std::memcpy(flow, fr->flow.data(), fr->flow.size() * sizeof(float));
  p->release(static_cast<size_t>(idx));
  return kOk;
}

void f2f_prefetch_close(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop = true;
  }
  p->cv_put.notify_all();
  p->cv_get.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
