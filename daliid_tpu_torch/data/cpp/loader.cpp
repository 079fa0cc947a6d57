// Native threaded JPEG ingest: decode + bicubic resize to a fixed shape.
//
// The host side of the PyTorch port's input path (a copy of the JAX
// package's loader, which the port does not import): a std::thread pool
// decodes with libjpeg and resamples with a separable Keys bicubic
// (a = -0.5, support widened by the scale factor when minifying — the same
// strategy PIL's resize uses), writing straight into one preallocated uint8
// HWC batch buffer.
//
// C ABI for ctypes. Built at first use by data/native_loader.py:
//   g++ -O3 -march=native -funroll-loops -std=c++17 -shared -fPIC \
//       -o libloader-<host>-<hash>.so loader.cpp -ljpeg -lpthread

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Keys cubic kernel, a = -0.5 (PIL's BICUBIC filter).
inline double cubic(double x) {
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

// Precomputed filter windows for one axis (float weights, normalized).
struct AxisFilter {
  std::vector<int> starts;
  std::vector<int> counts;
  std::vector<int> offsets;
  std::vector<float> weights;
};

AxisFilter make_filter(int n_in, int n_out) {
  AxisFilter f;
  f.starts.resize(n_out);
  f.counts.resize(n_out);
  f.offsets.resize(n_out);
  const double scale = static_cast<double>(n_in) / n_out;
  const double filterscale = std::max(scale, 1.0);
  const double support = 2.0 * filterscale;
  for (int xx = 0; xx < n_out; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(std::max(0.0, std::floor(center - support)));
    int xmax = static_cast<int>(std::min<double>(n_in, std::ceil(center + support)));
    f.offsets[xx] = static_cast<int>(f.weights.size());
    double total = 0.0;
    std::vector<double> w(xmax - xmin);
    for (int x = xmin; x < xmax; ++x) {
      w[x - xmin] = cubic((x + 0.5 - center) / filterscale);
      total += w[x - xmin];
    }
    for (double v : w) f.weights.push_back(static_cast<float>(total != 0.0 ? v / total : v));
    f.starts[xx] = xmin;
    f.counts[xx] = xmax - xmin;
  }
  return f;
}

// Horizontal pass: raw uint8 HWC rows -> float rows at the output width.
// RGB is unrolled so the accumulators stay in registers.
void resample_rows_u8(const uint8_t* src, float* dst, int rows, int n_in,
                      int n_out, const AxisFilter& f) {
  for (int r = 0; r < rows; ++r) {
    const uint8_t* in_row = src + static_cast<size_t>(r) * n_in * 3;
    float* out_row = dst + static_cast<size_t>(r) * n_out * 3;
    for (int xx = 0; xx < n_out; ++xx) {
      const float* w = f.weights.data() + f.offsets[xx];
      const uint8_t* p = in_row + f.starts[xx] * 3;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f;
      for (int k = 0; k < f.counts[xx]; ++k, p += 3) {
        const float wk = w[k];
        a0 += wk * p[0];
        a1 += wk * p[1];
        a2 += wk * p[2];
      }
      out_row[xx * 3 + 0] = a0;
      out_row[xx * 3 + 1] = a1;
      out_row[xx * 3 + 2] = a2;
    }
  }
}

// Vertical pass + quantize: each output row is a weighted sum of contiguous
// input rows (SIMD-friendly AXPY over the full row) — no transposes.
void resample_cols_to_u8(const float* mid, uint8_t* out, int h_in, int h_out,
                         int row_elems, const AxisFilter& f,
                         std::vector<float>& acc) {
  acc.resize(row_elems);
  for (int yy = 0; yy < h_out; ++yy) {
    std::memset(acc.data(), 0, sizeof(float) * row_elems);
    const float* w = f.weights.data() + f.offsets[yy];
    for (int k = 0; k < f.counts[yy]; ++k) {
      const float wk = w[k];
      const float* src_row = mid + static_cast<size_t>(f.starts[yy] + k) * row_elems;
      float* a = acc.data();
      for (int i = 0; i < row_elems; ++i) a[i] += wk * src_row[i];
    }
    uint8_t* out_row = out + static_cast<size_t>(yy) * row_elems;
    for (int i = 0; i < row_elems; ++i) {
      const float v = acc[i];
      out_row[i] = static_cast<uint8_t>(v < 0.f ? 0.f : (v > 255.f ? 255.f : v + 0.5f));
    }
  }
}

// Per-thread scratch reused across images (raw decode buffer, mid rows,
// accumulator, and the filter cache keyed by source size).
struct Scratch {
  std::vector<uint8_t> raw;
  std::vector<float> mid;
  std::vector<float> acc;
  int fw_in = -1, fw_out = -1, fh_in = -1, fh_out = -1;
  AxisFilter fw, fh;
};

int decode_one(const char* path, int out_h, int out_w, uint8_t* out,
               Scratch& s) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;

  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return 2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);

  const int w = cinfo.output_width;
  const int h = cinfo.output_height;
  const int ch = cinfo.output_components;  // 3 after JCS_RGB
  s.raw.resize(static_cast<size_t>(w) * h * ch);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = s.raw.data() + static_cast<size_t>(cinfo.output_scanline) * w * ch;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);

  if (w == out_w && h == out_h) {
    std::memcpy(out, s.raw.data(), s.raw.size());
    return 0;
  }

  // separable Keys bicubic: horizontal pass (u8 -> f32 rows at out_w), then
  // vertical row-AXPY pass straight to the uint8 output; filters cached per
  // source size across images on the same thread
  if (s.fw_in != w || s.fw_out != out_w) {
    s.fw = make_filter(w, out_w);
    s.fw_in = w;
    s.fw_out = out_w;
  }
  if (s.fh_in != h || s.fh_out != out_h) {
    s.fh = make_filter(h, out_h);
    s.fh_in = h;
    s.fh_out = out_h;
  }
  s.mid.resize(static_cast<size_t>(h) * out_w * ch);
  resample_rows_u8(s.raw.data(), s.mid.data(), h, w, out_w, s.fw);
  resample_cols_to_u8(s.mid.data(), out, h, out_h, out_w * ch, s.fh, s.acc);
  return 0;
}

}  // namespace

extern "C" {

// paths: n null-terminated strings; out: n * out_h * out_w * 3 uint8 buffer;
// statuses: n ints (0 = ok). Returns count of failures.
int decode_resize_batch(const char** paths, int64_t n, int out_h, int out_w,
                        uint8_t* out, int* statuses, int num_threads) {
  std::atomic<int64_t> next{0};
  std::atomic<int> failures{0};
  const size_t img_bytes = static_cast<size_t>(out_h) * out_w * 3;

  auto work = [&]() {
    Scratch scratch;
    while (true) {
      const int64_t i = next.fetch_add(1);
      if (i >= n) break;
      const int rc = decode_one(paths[i], out_h, out_w, out + i * img_bytes, scratch);
      statuses[i] = rc;
      if (rc != 0) failures.fetch_add(1);
    }
  };

  const int t = std::max(1, num_threads);
  std::vector<std::thread> threads;
  threads.reserve(t);
  for (int k = 0; k < t; ++k) threads.emplace_back(work);
  for (auto& th : threads) th.join();
  return failures.load();
}

}  // extern "C"
