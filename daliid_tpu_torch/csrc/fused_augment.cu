// Fused train augmentation (kernel K1 of the port) for sm_90a.
//
// Replaces the Pallas kernel daliid_tpu/ops/fused_augment.py::_kernel
// (entry _augment_core). For each image b of a (B, H, W, 3) uint8 batch and
// its row of the (B, 16) f32 scalar table (oy, ox, flip, fb, fc, fs, ey, ex,
// eh, ew), the output pixel (y, x, c) is, in this order:
//   1. crop in output coordinates: img[y + oy - pad, x' + ox - pad], zero
//      outside the image, where x' = W - 1 - x if flip > 0.5 else x (2.);
//   3. times the f32 constant 1/255;
//   4. brightness: clip(v * fb, 0, 1);
//   5. mean_gray: mean over the whole cropped image of
//      0.299 R + 0.587 G + 0.114 B (zero border included);
//   6. contrast: clip(mean_gray + fc * (v - mean_gray), 0, 1);
//   7. saturation about the pixel's own gray of step 4:
//      clip(gray + fs * (v - gray), 0, 1);
//   8. erase [ey, ey + eh) x [ex, ex + ew) to 0;
//   9. (v - mean[c]) / std[c];
//  10. cast to f32 or bf16.
//
// Bound on the H100: the bytes. At the train shape (384, 256, 128, 3) the
// kernel must read 37.7 MB of uint8 and write 75.5 MB of bf16: 0.034 ms
// over 3.35 TB/s. The operations, about 30 f32 a pixel (three IEEE
// divisions among them), are of the same order at the f32 rate. This design
// reads each image once but stays at about 2.6x the bytes bound; cutting
// its arithmetic, its gray pass or its stores out, more CTAs an SM and
// other cluster sizes each left most of that time in place (PERF.md).
//
// Design: a cluster of kCluster CTAs per image, each owning a band of
// output rows. The crop is a shift and the flip a reversal within a row, so
// output row y reads exactly source row y + oy - pad: a band of output rows
// needs one contiguous band of source rows, with no halo.
//   1. Each CTA stages its band of source rows in shared memory once, with
//      16-byte cp.async copies where rows are 16-byte multiples (byte loads
//      otherwise, as for the ragged test shapes).
//   2. Pass 1 sums, from shared memory, the gray of the staged pixels that
//      lie inside the crop window, in double; a warp tree and the warps in
//      order give the band's sum. After a cluster barrier every CTA adds the
//      kCluster band sums in rank order through distributed shared memory.
//      No float atomics: the mean gray is the same bits on every run.
//   3. Pass 2 recomputes each pixel from shared memory and writes the
//      output. Where W is a multiple of 8, a thread writes 8 pixels (24
//      values) as 16-byte stores; the (row, group) walk steps by a constant,
//      with no per-pixel / or % by W. Each clip to [0, 1] is a saturate that
//      folds into the operation before it.
// A band larger than kStageBytes is taken in sub-bands of rows: then pass 1
// stages each sub-band and pass 2 stages it again (the only case that
// reads an image twice).
//
// Numerics: every step is one IEEE-rounded f32 operation in the order
// above (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn keep nvcc from
// contracting them into FMAs), so each pixel matches the plain PyTorch
// version bit for bit given the same mean_gray. mean_gray is summed in
// double, so it differs from the plain version's f32 sum only by that
// sum's own rounding.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 4;            // CTAs an image, one band of output rows each
constexpr int kThreads = 256;
constexpr int kStageBytes = 32 * 1024; // source rows a CTA stages at once, at most
constexpr int kScalars = 16;
constexpr int kGroup = 8;              // pixels a thread writes with 16-byte stores

__constant__ float kMean[3] = {0.485f, 0.456f, 0.406f};
__constant__ float kStd[3] = {0.229f, 0.224f, 0.225f};

struct Params {
  int oy, ox, ey, ex, eh, ew;
  bool flip;
  float fb, fc, fs;
};

__device__ __forceinline__ Params load_params(const float* scal, int b) {
  const float* s = scal + (size_t)b * kScalars;
  Params p;
  // astype(int32) truncates toward zero, as (int) does
  p.oy = (int)s[0];
  p.ox = (int)s[1];
  p.flip = s[2] > 0.5f;
  p.fb = s[3];
  p.fc = s[4];
  p.fs = s[5];
  p.ey = (int)s[6];
  p.ex = (int)s[7];
  p.eh = (int)s[8];
  p.ew = (int)s[9];
  return p;
}

// clip to [0, 1]; folds into the rounding operation before it (.sat)
__device__ __forceinline__ float clip01(float v) { return __saturatef(v); }

// Steps 3-4 for one source pixel (nullptr: the zero border): its three
// channels after brightness, and their gray.
__device__ __forceinline__ float brighten(const uint8_t* px, float fb, float v[3]) {
  const float inv255 = (float)(1.0 / 255.0);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float raw = px ? (float)px[c] : 0.0f;
    v[c] = clip01(__fmul_rn(__fmul_rn(raw, inv255), fb));
  }
  return __fadd_rn(__fadd_rn(__fmul_rn(v[0], 0.299f), __fmul_rn(v[1], 0.587f)),
                   __fmul_rn(v[2], 0.114f));
}

// Steps 1-9 for output pixel (y, x) of a row whose source row is staged at
// `srow` (nullptr if the source row is outside the image).
__device__ __forceinline__ void out_pixel(const uint8_t* srow, const Params& p, int W, int pad,
                                          float mg, int y, int x, float* o) {
  const int sx = (p.flip ? W - 1 - x : x) + p.ox - pad;
  const uint8_t* px = srow && sx >= 0 && sx < W ? srow + 3 * sx : nullptr;
  float v[3];
  const float gray = brighten(px, p.fb, v);
  const bool erased = y >= p.ey && y < p.ey + p.eh && x >= p.ex && x < p.ex + p.ew;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float t = clip01(__fadd_rn(mg, __fmul_rn(p.fc, __fsub_rn(v[c], mg))));
    t = clip01(__fadd_rn(gray, __fmul_rn(p.fs, __fsub_rn(t, gray))));
    if (erased) t = 0.0f;
    o[c] = __fdiv_rn(__fsub_rn(t, kMean[c]), kStd[c]);
  }
}

__device__ __forceinline__ void store1(float* out, size_t i, float v) { out[i] = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* out, size_t i, float v) {
  out[i] = __float2bfloat16_rn(v);
}

// 24 values to a 16-byte-aligned destination: 6 x 16 bytes of f32, 3 of bf16.
__device__ __forceinline__ void store24(float* dst, const float (&v)[3 * kGroup]) {
#pragma unroll
  for (int k = 0; k < 6; ++k)
    reinterpret_cast<float4*>(dst)[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2],
                                                    v[4 * k + 3]);
}
__device__ __forceinline__ void store24(__nv_bfloat16* dst, const float (&v)[3 * kGroup]) {
  uint32_t w[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)
    reinterpret_cast<uint4*>(dst)[k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2],
                                                  w[4 * k + 3]);
}

// Start copying source rows [r0, r1) of `img` into `buf`: 16-byte cp.async
// copies (one commit group) where rows are 16-byte multiples, else byte
// copies. The caller waits (cp_async_wait<0>) and syncs before reading.
__device__ __forceinline__ void copy_rows(uint8_t* buf, const uint8_t* img, int r0, int r1,
                                          int W3, bool aligned) {
  const int bytes = max(r1 - r0, 0) * W3;
  const uint8_t* src = img + (size_t)max(r0, 0) * W3;
  if (aligned) {
    for (int off = 16 * threadIdx.x; off < bytes; off += 16 * kThreads)
      mma::cp_async16(buf + off, src + off, min(16, bytes - off));
    mma::cp_async_commit();
  } else {
    for (int off = threadIdx.x; off < bytes; off += kThreads) buf[off] = src[off];
  }
}

__device__ __forceinline__ void wait_rows() {
  mma::cp_async_wait<0>();
  __syncthreads();
}

// A cluster of kCluster CTAs per image, each CTA a band of output rows,
// staged `sub` rows at a time (the whole band where it fits).
template <typename T>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    fused_augment_kernel(const uint8_t* __restrict__ images, const float* __restrict__ scal,
                         int H, int W, int pad, int sub, int aligned, int vec,
                         T* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t buf[];
  __shared__ double warp_sums[kThreads / 32];
  __shared__ double band_sum;
  cg::cluster_group cluster = cg::this_cluster();
  const int b = blockIdx.x / kCluster;
  const int W3 = 3 * W;
  const Params p = load_params(scal, b);
  const uint8_t* img = images + (size_t)b * H * W3;
  const int band = (H + kCluster - 1) / kCluster;
  const int y0 = min(H, (int)cluster.block_rank() * band), y1 = min(H, y0 + band);
  const int dy = p.oy - pad;  // output row y reads source row y + dy
  const int sx_lo = max(0, p.ox - pad), sx_hi = min(W, W + p.ox - pad);
  const int width = max(sx_hi - sx_lo, 0);
  const bool restage = y1 - y0 > sub;  // pass 2 stages each sub-band again
  auto stage = [&](int ys, int ye, int& r0) {
    r0 = max(ys + dy, 0);
    __syncthreads();  // nobody still reads the previous sub-band
    copy_rows(buf, img, r0, min(ye + dy, H), W3, aligned);
    wait_rows();
  };

  // pass 1: the band's gray sum over the source pixels inside the crop
  double acc = 0.0;
  int r0 = 0;
  for (int ys = y0; ys < y1; ys += sub) {
    const int ye = min(y1, ys + sub);
    stage(ys, ye, r0);
    if (width == 0) continue;
    const int n = max(min(ye + dy, H) - r0, 0) * width;
    const int step_r = kThreads / width, step_x = kThreads % width;
    int r = threadIdx.x / width, x = threadIdx.x % width;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      float v[3];
      acc += (double)brighten(buf + r * W3 + 3 * (sx_lo + x), p.fb, v);
      x += step_x;
      r += step_r;
      if (x >= width) {
        x -= width;
        ++r;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
    band_sum = s;
  }
  cluster.sync();  // every band's sum is in its CTA's shared memory
  double total = 0.0;
#pragma unroll
  for (int k = 0; k < kCluster; ++k) total += *cluster.map_shared_rank(&band_sum, k);
  const float mg = (float)(total / (double)((size_t)H * W));

  // pass 2: contrast, saturation, erase, normalize, store
  for (int ys = y0; ys < y1; ys += sub) {
    const int ye = min(y1, ys + sub);
    if (restage) stage(ys, ye, r0);
    // a row of the output starts at element (b * H + y) * W3
    T* dst = out + ((size_t)b * H + ys) * W3;
    if (vec) {
      const int gpr = W / kGroup, n = (ye - ys) * gpr;
      const int step_r = kThreads / gpr, step_g = kThreads % gpr;
      int r = threadIdx.x / gpr, g = threadIdx.x % gpr;
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int y = ys + r, sy = y + dy;
        const uint8_t* srow = sy >= 0 && sy < H ? buf + (sy - r0) * W3 : nullptr;
        float o[3 * kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k)
          out_pixel(srow, p, W, pad, mg, y, kGroup * g + k, o + 3 * k);
        store24(dst + (size_t)r * W3 + 3 * kGroup * g, o);
        g += step_g;
        r += step_r;
        if (g >= gpr) {
          g -= gpr;
          ++r;
        }
      }
    } else {
      const int n = (ye - ys) * W;
      const int step_r = kThreads / W, step_x = kThreads % W;
      int r = threadIdx.x / W, x = threadIdx.x % W;
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int y = ys + r, sy = y + dy;
        const uint8_t* srow = sy >= 0 && sy < H ? buf + (sy - r0) * W3 : nullptr;
        float o[3];
        out_pixel(srow, p, W, pad, mg, y, x, o);
#pragma unroll
        for (int c = 0; c < 3; ++c) store1(dst, (size_t)r * W3 + 3 * x + c, o[c]);
        x += step_x;
        r += step_r;
        if (x >= W) {
          x -= W;
          ++r;
        }
      }
    }
  }
  cluster.sync();  // no CTA leaves while another may still read its band_sum
}

template <typename T>
int launch(const uint8_t* images, const float* scal, int B, int H, int W, int pad, T* out,
           cudaStream_t s) {
  const int W3 = 3 * W;
  const int band = (H + kCluster - 1) / kCluster;
  const int sub = max(1, min(band, kStageBytes / W3));
  const size_t smem = ((size_t)sub * W3 + 15) / 16 * 16;
  const int aligned = W3 % 16 == 0 && (uintptr_t)images % 16 == 0;
  const int vec = W % kGroup == 0 && (uintptr_t)out % 16 == 0;
  if (smem > 32 * 1024) {  // with the static shared memory, above 48 KB needs the opt-in
    const cudaError_t err = cudaFuncSetAttribute(
        fused_augment_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fused_augment_kernel<T><<<B * kCluster, kThreads, smem, s>>>(images, scal, H, W, pad, sub,
                                                               aligned, vec, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch K1 over B images on `stream`; out_bf16 selects a bf16 output (else
// f32). Returns cudaGetLastError().
extern "C" int fused_augment(const void* images, const void* scal, int B, int H, int W,
                             int pad, int out_bf16, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaGetLastError();
  const uint8_t* img = static_cast<const uint8_t*>(images);
  const float* sc = static_cast<const float*>(scal);
  if (out_bf16) return launch(img, sc, B, H, W, pad, static_cast<__nv_bfloat16*>(out), s);
  return launch(img, sc, B, H, W, pad, static_cast<float*>(out), s);
}
