// Fused multi-head attention (kernel K4 of the port) for sm_90a.
//
// Replaces the Pallas kernel daliid_tpu/ops/flash_attention.py::_attention_kernel
// (entry flash_attention, pallas_call in _fused_attention). For every batch
// row b and head h:
//     out[b, :, h, :] = softmax(q[b, :, h, :] . k[b, :, h, :]^T * scale) . v[b, :, h, :]
// with scale = D^-1/2, scores, softmax and the P.V sum in f32 whatever the
// input type, and the result written in the input type (f32 or bf16).
//
// Layout: q, k and v are (B, N, H, D) views with any batch, token and head
// strides and a unit stride on D, so the three column blocks of the ViT's
// fused qkv projection, (B, N, 3*H*D), go in as they are. The output is a
// contiguous (B, N, H, D) tensor, i.e. the (B, N, H*D) input of the output
// projection. The TPU kernel's transposes and its padding of N and D to
// multiples of 128 are Mosaic artefacts and are not carried over.
//
// Design (simple first, CUDA cores, f32): one block of 128 threads per
// (b, h, 64-query tile). The query tile is staged in shared memory as f32;
// the block then walks the keys in tiles of 64: it stages the K and V tile
// as f32, each thread computes a 4 x 8 register tile of scores (4 query
// rows x 8 keys, float4 loads along D), the block keeps a running row max and
// row sum (online softmax, each row's 8 threads reduce with warp shuffles),
// writes exp(s - max) to shared memory and adds P.V into a register tile of
// 4 rows x D/8 output columns, rescaled when the row max grows. The result is
// divided by the row sum at the end. Keys past N score -inf and their K and
// V rows are zero, so any N >= 1 works; a row always has a valid key in
// every tile it visits, because a tile starts below N.
//
// Bound on the H100 at the JPM trunk's shape (384, 211, 12, 64) in bf16:
// q, k, v read once and the output written once, 498 MB over 3.35 TB/s =
// 0.149 ms; the 4*B*H*N^2*D = 5.25e10 operations take 0.053 ms at the bf16
// tensor-core rate, so the bytes bound it. This kernel runs its products on
// the CUDA cores in f32 (67 TFLOP/s), which alone costs 0.78 ms at that
// shape, so it is compute-bound, far above the bytes; wgmma is the next step
// (PERF.md has the times).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int QT = 64;  // query rows per block
constexpr int KT = 64;  // keys per tile
constexpr int PT = KT + 4;  // row stride of the P tile (floats)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

struct View {
  long long sb, sn, sh;  // element strides of batch, token and head; D is unit-stride
};

// Rows [row0, row0 + 64) of one head of `src` → f32 tile `dst` with row
// stride D + 4; rows at or past N are zero.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, View s, int b,
                                      int h, int row0, int N) {
  constexpr int S = D + 4;
  const T* base = src + b * s.sb + h * s.sh;
  for (int e = threadIdx.x; e < 64 * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int n = row0 + r;
    dst[r * S + d] = n < N ? to_f32(base[(long long)n * s.sn + d]) : 0.0f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, View qs, View ks, View vs, int H, int N,
                     float scale, T* __restrict__ out) {
  constexpr int S = D + 4;   // row stride of the Q, K and V tiles (floats)
  constexpr int DC = D / 32; // float4 output chunks per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + QT * S;
  float* Vs = Ks + KT * S;
  float* Ps = Vs + KT * S;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * QT;
  const int tx = threadIdx.x % 8;  // key group (scores) / column group (output)
  const int ty = threadIdx.x / 8;  // 4-row group
  // the 8 threads of a row group are 8 consecutive lanes of one warp
  stage<T, D>(Qs, q, qs, b, h, q0, N);

  float m[4], l[4], o[4][DC * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DC * 4; ++j) o[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < N; k0 += KT) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    stage<T, D>(Ks, k, ks, b, h, k0, N);
    stage<T, D>(Vs, v, vs, b, h, k0, N);
    __syncthreads();

    // scores: rows ty*4 + i, keys tx + 8*j of this tile
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * S + d]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 8 * j) * S + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // online softmax over this tile, row by row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = k0 + tx + 8 * j < N ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);  // finite: key k0 is valid
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty * 4 + i) * PT + tx + 8 * j] = p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC * 4; ++j) o[i][j] *= alpha;
    }
    __syncthreads();

    // o[rows ty*4 + i][columns tx*4 + 32*c + e] += P . V over the tile's valid keys
    const int kn = min(KT, N - k0);
    for (int c0 = 0; c0 < kn; c0 += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(&Ps[(ty * 4 + i) * PT + c0]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = &Vs[(c0 + cc) * S + tx * 4];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + 32 * c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = cc == 0 ? p4[i].x : cc == 1 ? p4[i].y : cc == 2 ? p4[i].z : p4[i].w;
            o[i][c * 4 + 0] = fmaf(p, vv.x, o[i][c * 4 + 0]);
            o[i][c * 4 + 1] = fmaf(p, vv.y, o[i][c * 4 + 1]);
            o[i][c * 4 + 2] = fmaf(p, vv.z, o[i][c * 4 + 2]);
            o[i][c * 4 + 3] = fmaf(p, vv.w, o[i][c * 4 + 3]);
          }
        }
      }
    }
  }

  // out[b, n, h, :] = o / l, in the input type
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + ty * 4 + i;
    if (n >= N) continue;
    const float inv = 1.0f / l[i];
    T* row = out + (((long long)b * N + n) * H + h) * D + tx * 4;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) store(row + 32 * c + e, o[i][c * 4 + e] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, View qs, View ks, View vs,
                   int B, int N, int H, float scale, void* out, cudaStream_t stream) {
  constexpr int S = D + 4;
  constexpr size_t smem = sizeof(float) * (size_t)(QT * S + 2 * KT * S + QT * PT);
  auto kernel = attention_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (N + QT - 1) / QT);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), qs, ks, vs,
      H, N, scale, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v, View qs, View ks,
                     View vs, int B, int N, int H, float scale, void* out, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, qs, ks, vs, B, N, H, scale, out, s);
    case 64: return launch<T, 64>(q, k, v, qs, ks, vs, B, N, H, scale, out, s);
    case 96: return launch<T, 96>(q, k, v, qs, ks, vs, B, N, H, scale, out, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Attention over (B, N, H, D) views q, k, v (strides in elements, D
// unit-stride) into the contiguous (B, N, H, D) `out`, on `stream`.
// D in {32, 64, 96}; is_bf16 selects bf16 inputs and output, else f32.
// Returns cudaGetLastError() (or the error of the launch's set-up).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               long long q_sb, long long q_sn, long long q_sh,
                               long long k_sb, long long k_sn, long long k_sh,
                               long long v_sb, long long v_sn, long long v_sh, int B, int N,
                               int H, int D, float scale, int is_bf16, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const View qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh}, vs{v_sb, v_sn, v_sh};
  if (B <= 0 || N <= 0 || H <= 0) return (int)cudaGetLastError();
  cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(D, q, k, v, qs, ks, vs, B, N, H, scale, out, s)
              : dispatch<float>(D, q, k, v, qs, ks, vs, B, N, H, scale, out, s);
  return (int)err;
}
