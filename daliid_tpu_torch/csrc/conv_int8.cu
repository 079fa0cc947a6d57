// Int8 convolution with exact int32 accumulation and a fused dequantize
// epilogue, for sm_90a: the port's kernel conv_int8.
//
// It has no Pallas counterpart. The JAX package runs every calibrated conv
// of its int8 extraction path as XLA's lax.conv_general_dilated on int8
// inputs with preferred_element_type=int32 (daliid_tpu/ops/quantize.py,
// make_quantized_interceptor, :278-290); PyTorch has no CUDA int8
// convolution, so the port writes its own.
//
//   out[b, oh, ow, o] = cast(float(acc) * (s_in * s_w[o]) (+ bias[o]))
//   acc = sum over (r, s, c) of x[b, oh*sh - ph + r, ow*sw - pw + s, c] *
//                                 w[o, r, s, c]          (int32, exact)
//
// x is int8 NHWC (a channels_last tensor), w int8 (O, kh, kw, C/groups),
// out NHWC in f32, bf16 or, for the checks, the raw int32 sum. Taps that
// fall in the padding read 0 (XLA pads the int8 input with zeros). The
// epilogue multiplies and adds with __fmul_rn / __fadd_rn: nvcc would
// otherwise contract a * b + c into one FMA, which rounds once where the
// JAX expression and the plain version round twice.
//
// Exactness: |acc| <= K * 127^2; the largest K of the model zoo is
// ResNet-50's layer4 3x3 at C = 512, K = 4,608, so |acc| < 7.5e7 < 2^31,
// and the int32 sum is exact in any order: the kernel's int32 equals the
// plain version's (daliid_tpu_torch/ops/conv_int8.py) bit for bit, and so
// does every output type.
//
// Bound on the H100: for a 3x3 conv the bytes (the int8 input, the weights
// and the output once each) over 3.35 TB/s; for the wide 1x1 and 3x3
// convs of ResNet-50's later stages the 2 * M * O * K operations over the
// int8 tensor cores' 1,979 TOP/s come close. This first design is simple:
//
//   groups == 1: an implicit GEMM, M = B * Ho * Wo output pixels by N = O
//     channels by K = kh * kw * C. A block of 8 warps owns a 128 x 64
//     output tile and walks K in stages of 64 bytes, through a ring of 4
//     shared-memory stages filled 3 ahead; each warp owns 32 x 32 outputs
//     on mma.sync m16n8k32 s8 x s8 -> s32 (the helpers of mma.cuh that
//     search_topk's SQ8 mode verified). A row of the A tile is the im2col
//     row of one output pixel, gathered from the input on the fly: with C a
//     multiple of 16 every 16-byte chunk of a row lies in one tap (r, s),
//     so it is one cp.async copy (zero-filled in the padding and past K);
//     otherwise (the 3-channel stems, C = 24 or 40) each byte is gathered
//     on its own. Nothing is written to device memory but the output.
//   depthwise (groups == C == O): one thread per output pixel and 4 (or,
//     when C is not a multiple of 4, 1) channels, summing the kh x kw taps
//     directly; a k32 tensor-core step would waste most of its lanes on
//     K = 9 or 25.
//
// Other group counts are refused by the wrapper; the zoo has none. TMA,
// wgmma and fusing the input's quantize into the loads are left for a later
// design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int BM = 128;        // output pixels per block
constexpr int BN = 64;         // output channels per block
constexpr int KS = 64;         // bytes of K per stage
constexpr int RSB = KS + 16;   // row stride of a stage in shared memory (bytes)
constexpr int STAGES = 4;
constexpr int STAGE_BYTES = (BM + BN) * RSB;
constexpr int kChunks = (BM + BN) * (KS / 16) / kThreads;  // 16-byte chunks a thread
static_assert(kChunks * kThreads == (BM + BN) * (KS / 16), "whole chunks a thread");
static_assert((BM * (KS / 16)) % kThreads == 0, "a thread's chunks are all A or all B");

struct Geometry {
  int B, H, W, C, O, kh, kw, sh, sw, ph, pw, Ho, Wo, K;
};

template <typename OutT>
__device__ __forceinline__ void store(OutT* out, size_t idx, int acc, float s_in,
                                      const float* __restrict__ s_w,
                                      const float* __restrict__ bias, int o) {
  if constexpr (std::is_same<OutT, int>::value) {
    out[idx] = acc;
  } else {
    float v = __fmul_rn(__int2float_rn(acc), __fmul_rn(s_in, s_w[o]));
    if (bias != nullptr) v = __fadd_rn(v, bias[o]);
    if constexpr (std::is_same<OutT, float>::value) {
      out[idx] = v;
    } else {
      out[idx] = __float2bfloat16_rn(v);
    }
  }
}

// The copies one thread makes into each stage: chunks tid + 256 * i of the
// stage's 768, rows 0-127 the A tile (output pixels), rows 128-191 the B
// tile (output channels). The rows stay the same for the whole block; only
// the stage's first byte of K moves.
struct Loader {
  int dst[kChunks], col[kChunks];
  const int8_t* base[kChunks];  // A: the pixel's image; B: the channel's weights; null: zero row
  int ih0[kChunks], iw0[kChunks];

  __device__ __forceinline__ void init(const int8_t* __restrict__ x,
                                       const int8_t* __restrict__ w, const Geometry& g,
                                       int m0, int n0) {
    const int M = g.B * g.Ho * g.Wo;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int e = threadIdx.x + kThreads * i, r = e / (KS / 16);
      col[i] = 16 * (e % (KS / 16));
      dst[i] = r * RSB + col[i];
      ih0[i] = iw0[i] = 0;
      if (r < BM) {
        const int m = m0 + r;
        if (m < M) {
          const int b = m / (g.Ho * g.Wo), p = m - b * (g.Ho * g.Wo);
          const int oh = p / g.Wo, ow = p - oh * g.Wo;
          ih0[i] = oh * g.sh - g.ph;
          iw0[i] = ow * g.sw - g.pw;
          base[i] = x + (size_t)b * g.H * g.W * g.C;
        } else {
          base[i] = nullptr;
        }
      } else {
        const int o = n0 + (r - BM);
        base[i] = o < g.O ? w + (size_t)o * g.K : nullptr;
      }
    }
  }

  // the input byte at K index k of A chunk i, 0 in the padding and past K
  __device__ __forceinline__ uint32_t a_byte(int i, int k, const Geometry& g) const {
    if (k >= g.K) return 0u;
    const int rs = k / g.C, c = k - rs * g.C;
    const int r = rs / g.kw, s = rs - r * g.kw;
    const int ih = ih0[i] + r, iw = iw0[i] + s;
    if (ih < 0 || ih >= g.H || iw < 0 || iw >= g.W) return 0u;
    return (uint8_t)base[i][((size_t)ih * g.W + iw) * g.C + c];
  }

  template <bool VEC>
  __device__ __forceinline__ void load(uint8_t* buf, const int8_t* __restrict__ any, int kb,
                                       const Geometry& g) const {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const bool is_a = dst[i] < BM * RSB;
      const int k0 = kb + col[i];
      if constexpr (VEC) {
        // C % 16 == 0, so K % 16 == 0 and a chunk is whole or empty
        const int8_t* src = any;
        int n = 0;
        if (base[i] != nullptr && k0 < g.K) {
          if (is_a) {
            const int rs = k0 / g.C, c = k0 - rs * g.C;
            const int r = rs / g.kw, s = rs - r * g.kw;
            const int ih = ih0[i] + r, iw = iw0[i] + s;
            if (ih >= 0 && ih < g.H && iw >= 0 && iw < g.W) {
              src = base[i] + ((size_t)ih * g.W + iw) * g.C + c;
              n = 16;
            }
          } else {
            src = base[i] + k0;
            n = 16;
          }
        }
        mma::cp_async16(buf + dst[i], src, n);
      } else {
        uint32_t v[4] = {0u, 0u, 0u, 0u};
        if (base[i] != nullptr) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int k = k0 + j;
            const uint32_t byte =
                is_a ? a_byte(i, k, g) : (k < g.K ? (uint32_t)(uint8_t)base[i][k] : 0u);
            v[j >> 2] |= byte << (8 * (j & 3));
          }
        }
        *reinterpret_cast<uint4*>(buf + dst[i]) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  }
};

template <typename OutT, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
    conv_igemm(const int8_t* __restrict__ x, const int8_t* __restrict__ w, Geometry g,
               float s_in, const float* __restrict__ s_w, const float* __restrict__ bias,
               OutT* __restrict__ out) {
  extern __shared__ float4 smem4[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem4);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;  // the warp's 32 pixels and 32 channels
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int n_ks = (g.K + KS - 1) / KS;

  int acc[2][4][4];  // [pixel m16 tile][channel n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  Loader loader;
  loader.init(x, w, g, m0, n0);
  int issued = 0;
  auto issue = [&]() {
    if (issued < n_ks)
      loader.load<VEC>(ring + (issued % STAGES) * STAGE_BYTES, x, issued * KS, g);
    ++issued;
    mma::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue();

  for (int it = 0; it < n_ks; ++it) {
    mma::cp_async_wait<STAGES - 2>();  // stage `it` has landed
    __syncthreads();                   // ... for every thread; stage it - 1 is consumed
    issue();

    const uint8_t* A = ring + (it % STAGES) * STAGE_BYTES;
    const uint8_t* Bt = A + BM * RSB;
#pragma unroll
    for (int kk = 0; kk < KS / 32; ++kk) {  // 32-byte k-steps
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        mma::ldmatrix_x4(a[i], A + (32 * wm + 16 * i + (lane & 7) + 8 * ((lane >> 3) & 1)) * RSB +
                                   32 * kk + 16 * (lane >> 4));
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t b[4];
        mma::ldmatrix_x4(b, Bt + (32 * wn + 16 * jp + (lane & 7) + 8 * (lane >> 4)) * RSB +
                                32 * kk + 16 * ((lane >> 3) & 1));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma::mma_s8(acc[i][2 * jp], a[i], b[0], b[1]);
          mma::mma_s8(acc[i][2 * jp + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  mma::cp_async_wait<0>();

  // thread (gq, t) holds rows gq and gq + 8, channels 2t and 2t + 1 of each
  // 16 x 8 tile
  const int M = g.B * g.Ho * g.Wo;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 32 * wm + 16 * i + gq + 8 * h;
        if (m >= M) continue;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int o = n0 + 32 * wn + 8 * j + 2 * t + c;
          if (o < g.O) store(out, (size_t)m * g.O + o, acc[i][j][2 * h + c], s_in, s_w, bias, o);
        }
      }
}

// Depthwise: thread (m, v) sums the taps of channels V*v .. V*v + V-1 of
// output pixel m.
template <typename OutT, int V>
__global__ void __launch_bounds__(kThreads)
    conv_depthwise(const int8_t* __restrict__ x, const int8_t* __restrict__ w, Geometry g,
                   float s_in, const float* __restrict__ s_w, const float* __restrict__ bias,
                   OutT* __restrict__ out) {
  const int groups_v = g.O / V;
  const size_t total = (size_t)g.B * g.Ho * g.Wo * groups_v;
  const int taps = g.kh * g.kw;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int o0 = (int)(e % groups_v) * V;
    const size_t m = e / groups_v;
    const int b = (int)(m / ((size_t)g.Ho * g.Wo));
    const int p = (int)(m - (size_t)b * g.Ho * g.Wo);
    const int oh = p / g.Wo, ow = p - oh * g.Wo;
    int acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0;
    for (int r = 0; r < g.kh; ++r) {
      const int ih = oh * g.sh - g.ph + r;
      if (ih < 0 || ih >= g.H) continue;
      for (int s = 0; s < g.kw; ++s) {
        const int iw = ow * g.sw - g.pw + s;
        if (iw < 0 || iw >= g.W) continue;
        const int8_t* px = x + (((size_t)b * g.H + ih) * g.W + iw) * g.C;
        if constexpr (V == 4) {  // C % 4 == 0: one 4-byte load
          const char4 xv = *reinterpret_cast<const char4*>(px + o0);
          const int8_t* wt = w + (size_t)o0 * taps + r * g.kw + s;
          acc[0] += (int)xv.x * (int)wt[0];
          acc[1] += (int)xv.y * (int)wt[taps];
          acc[2] += (int)xv.z * (int)wt[2 * taps];
          acc[3] += (int)xv.w * (int)wt[3 * taps];
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int o = o0 + v;
            acc[v] += (int)px[o] * (int)w[(size_t)o * taps + r * g.kw + s];
          }
        }
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) store(out, m * g.O + o0 + v, acc[v], s_in, s_w, bias, o0 + v);
  }
}

template <typename OutT>
cudaError_t launch(const int8_t* x, const int8_t* w, const Geometry& g, int groups, float s_in,
                   const float* s_w, const float* bias, OutT* out, cudaStream_t stream) {
  if (groups == 1) {
    const size_t M = (size_t)g.B * g.Ho * g.Wo;
    const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((g.O + BN - 1) / BN));
    constexpr int smem = STAGES * STAGE_BYTES;
    const bool vec = g.C % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0;
    auto kernel = vec ? conv_igemm<OutT, true> : conv_igemm<OutT, false>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(x, w, g, s_in, s_w, bias, out);
    return cudaGetLastError();
  }
  const bool vec4 = g.C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
  const size_t total = (size_t)g.B * g.Ho * g.Wo * (vec4 ? g.O / 4 : g.O);
  const unsigned blocks = (unsigned)std::min<size_t>((total + kThreads - 1) / kThreads, 1u << 20);
  if (vec4) {
    conv_depthwise<OutT, 4><<<blocks, kThreads, 0, stream>>>(x, w, g, s_in, s_w, bias, out);
  } else {
    conv_depthwise<OutT, 1><<<blocks, kThreads, 0, stream>>>(x, w, g, s_in, s_w, bias, out);
  }
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`. x: int8 (B, H, W, C); w: int8 (O, kh, kw, C / groups);
// s_w: f32 (O,); bias: f32 (O,) or null; out: (B, Ho, Wo, O) of out_kind
// 0 = int32 (the raw sum; s_in, s_w and bias unread), 1 = f32, 2 = bf16.
// groups is 1, or C == O (depthwise); the wrapper refuses the rest. Returns
// cudaGetLastError().
extern "C" int conv_int8(const void* x, const void* w, const void* s_w, const void* bias,
                         void* out, int B, int H, int W, int C, int O, int kh, int kw, int sh,
                         int sw, int ph, int pw, int groups, float s_in, int out_kind,
                         void* stream) {
  Geometry g;
  g.B = B;
  g.H = H;
  g.W = W;
  g.C = C;
  g.O = O;
  g.kh = kh;
  g.kw = kw;
  g.sh = sh;
  g.sw = sw;
  g.ph = ph;
  g.pw = pw;
  g.Ho = (H + 2 * ph - kh) / sh + 1;
  g.Wo = (W + 2 * pw - kw) / sw + 1;
  g.K = kh * kw * (C / groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xi = static_cast<const int8_t*>(x);
  const int8_t* wi = static_cast<const int8_t*>(w);
  const float* sw_f = static_cast<const float*>(s_w);
  const float* b_f = static_cast<const float*>(bias);
  cudaError_t err;
  if (out_kind == 0) {
    err = launch(xi, wi, g, groups, s_in, sw_f, b_f, static_cast<int*>(out), s);
  } else if (out_kind == 1) {
    err = launch(xi, wi, g, groups, s_in, sw_f, b_f, static_cast<float*>(out), s);
  } else {
    err = launch(xi, wi, g, groups, s_in, sw_f, b_f, static_cast<__nv_bfloat16*>(out), s);
  }
  return (int)err;
}
