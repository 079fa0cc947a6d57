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
// Design (simple first): one block per image. Pass 1 recomputes steps 1-4
// per pixel and block-reduces the gray sum; pass 2 recomputes each pixel and
// applies steps 5-10. The uint8 image is read twice (the second time mostly
// from L2), which keeps the kernel right for any H x W: nothing is staged in
// shared memory. The TPU kernel's flip and gray-broadcast matmuls are index
// arithmetic here; its roll/mask crop and lane/sublane padding are not
// carried over.
//
// Numerics: every step is one IEEE-rounded f32 operation in the order
// above (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn keep nvcc from
// contracting them into FMAs), so each pixel matches the plain PyTorch
// version bit for bit given the same mean_gray. mean_gray is summed in
// double, so it differs from the plain version's f32 sum only by that
// sum's own rounding.
//
// Bound on the H100: the bytes. At the train shape (384, 256, 128, 3) the
// kernel reads 37.7 MB of uint8 and writes 75.5 MB of bf16: 0.034 ms over
// 3.35 TB/s. The operations (about 30 per pixel) are far below the f32 rate.
// This simple form reads the image twice and moves 3-byte pixels one thread
// at a time, so it stays above that bound (PERF.md has its time).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kScalars = 16;

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

__device__ __forceinline__ float clip01(float v) { return fminf(fmaxf(v, 0.0f), 1.0f); }

// Steps 1-4 for the pixel at output (y, x): its three channels after
// brightness, and their gray.
__device__ __forceinline__ void pixel(const uint8_t* img, int H, int W, int pad,
                                      const Params& p, int y, int x, float v[3],
                                      float& gray) {
  const float inv255 = (float)(1.0 / 255.0);
  const int xs = p.flip ? W - 1 - x : x;
  const int sy = y + p.oy - pad;
  const int sx = xs + p.ox - pad;
  const bool inside = sy >= 0 && sy < H && sx >= 0 && sx < W;
  const uint8_t* src = img + ((size_t)(inside ? sy : 0) * W + (inside ? sx : 0)) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float raw = inside ? (float)src[c] : 0.0f;
    v[c] = clip01(__fmul_rn(__fmul_rn(raw, inv255), p.fb));
  }
  gray = __fadd_rn(__fadd_rn(__fmul_rn(v[0], 0.299f), __fmul_rn(v[1], 0.587f)),
                   __fmul_rn(v[2], 0.114f));
}

__device__ __forceinline__ void store(float* out, size_t i, float v) { out[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* out, size_t i, float v) {
  out[i] = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_augment_kernel(const uint8_t* __restrict__ images, const float* __restrict__ scal,
                         int H, int W, int pad, T* __restrict__ out) {
  __shared__ double warp_sums[kThreads / 32];
  __shared__ float mean_gray_s;
  const int b = blockIdx.x;
  const int n_pix = H * W;
  const uint8_t* img = images + (size_t)b * n_pix * 3;
  const Params p = load_params(scal, b);

  // pass 1: the gray sum of the cropped, flipped, brightened image
  double acc = 0.0;
  for (int i = threadIdx.x; i < n_pix; i += kThreads) {
    float v[3], gray;
    pixel(img, H, W, pad, p, i / W, i % W, v, gray);
    acc += (double)gray;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    mean_gray_s = (float)(total / (double)n_pix);
  }
  __syncthreads();
  const float mg = mean_gray_s;

  // pass 2: contrast, saturation, erase, normalize, store
  T* dst = out + (size_t)b * n_pix * 3;
  for (int i = threadIdx.x; i < n_pix; i += kThreads) {
    const int y = i / W, x = i % W;
    float v[3], gray;
    pixel(img, H, W, pad, p, y, x, v, gray);
    const bool erased = y >= p.ey && y < p.ey + p.eh && x >= p.ex && x < p.ex + p.ew;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float t = clip01(__fadd_rn(mg, __fmul_rn(p.fc, __fsub_rn(v[c], mg))));
      t = clip01(__fadd_rn(gray, __fmul_rn(p.fs, __fsub_rn(t, gray))));
      if (erased) t = 0.0f;
      store(dst, (size_t)i * 3 + c, __fdiv_rn(__fsub_rn(t, kMean[c]), kStd[c]));
    }
  }
}

}  // namespace

// Launch K1 over B images on `stream`; out_bf16 selects a bf16 output (else
// f32). Returns cudaGetLastError().
extern "C" int fused_augment(const void* images, const void* scal, int B, int H, int W,
                             int pad, int out_bf16, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B > 0 && H > 0 && W > 0) {
    const uint8_t* img = static_cast<const uint8_t*>(images);
    const float* sc = static_cast<const float*>(scal);
    if (out_bf16) {
      fused_augment_kernel<__nv_bfloat16><<<B, kThreads, 0, s>>>(
          img, sc, H, W, pad, static_cast<__nv_bfloat16*>(out));
    } else {
      fused_augment_kernel<float><<<B, kThreads, 0, s>>>(img, sc, H, W, pad,
                                                         static_cast<float*>(out));
    }
  }
  return (int)cudaGetLastError();
}
