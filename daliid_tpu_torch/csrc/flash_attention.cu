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
// Bound on the H100 at the JPM trunk's shape (384, 211, 12, 64) in bf16:
// q, k, v read once and the output written once, 498 MB over 3.35 TB/s =
// 0.149 ms; the 4*B*H*N^2*D = 5.25e10 operations take 0.053 ms at the bf16
// tensor-core rate, so the bytes bound it.
//
// bf16 (every timed and main path): products on the tensor cores.
//   - One block of NW warps per (b, h, 16 * NW-query tile): 8 warps where
//     128-row tiles pad N no more than 64-row ones (N = 211: two blocks a
//     head), else 4 (N = 53, N = 129). The blocks of one head are launched
//     together, so the head's K and V come from L2 after the first. Each warp
//     owns 16 query rows and keeps their Q fragments in registers
//     (ldmatrix); at D <= 64 the kernel is held to 128 registers, so two
//     blocks of 8 warps (or four of 4) share an SM.
//   - K and V walk in 64-key tiles, double-buffered in shared memory by
//     16-byte cp.async copies straight from the strided views; rows past N
//     are zero-filled by the copy (source size 0). Rows are padded to D + 8
//     elements so that ldmatrix reads hit distinct banks.
//   - S = Q . K^T on mma.sync m16n8k16 (bf16 in, f32 accumulate), times
//     scale * log2(e) (the softmax takes exp2); keys >= N score -inf at
//     8-key granularity, and key tiles past the last valid key are skipped,
//     so N = 211 computes 216 scores a row (224 keys in P.V), not 256.
//   - Online softmax over the key tiles with the scores in registers: row
//     max and row sum reduce over the 4 threads of a quad with shuffles; the
//     row sum l is taken from the f32 P. P never goes through shared memory:
//     its accumulator fragments are the A fragments of P . V.
//   - P . V with P split as P_hi = bf16(P), P_lo = bf16(P - P_hi), both on
//     mma.sync against V (ldmatrix.trans), so P enters with about 2^-17
//     relative error where one bf16 rounding (2^-9) would break the one-ulp
//     check under cancellation in V (PERF.md; tests/test_torch_attention.py
//     emulates both).
//   - The output is multiplied by 1/l, rounded to bf16 once, staged in the
//     warp's rows of the Q tile and written with 16-byte stores.
// The work at N = 211 is 332 mma.sync per warp (108 for S, 224 for the split
// P . V), 1.75e11 operations: 0.27 ms at two thirds of the bf16 peak, so the
// tensor-core work, not the bytes, sets this kernel's pace; the split gives
// it 1.5x the work of attention that rounds P once (PERF.md has the times).
//
// f32 (checks only: the K4-vs-SDPA route comparison and phase_k4's f32
// cases): products on the CUDA cores, exact f32. One block of 128 threads
// per (b, h, 64-query tile) stages Q and 64-key tiles of K and V in shared
// memory, computes a 4 x 8 register tile of scores with FMAs, keeps an
// online softmax and moves P through shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 128;  // threads of an f32 block
constexpr int QT = 64;  // query rows of an f32 block
constexpr int KT = 64;  // keys per tile
constexpr int PT = KT + 4;  // row stride of the f32 kernel's P tile (floats)

struct View {
  long long sb, sn, sh;  // element strides of batch, token and head; D is unit-stride
};

// ---------------------------------------------------------------- bf16, tensor cores

// Rows [row0, row0 + ROWS) of one head of `src` → bf16 tile `dst` with row
// stride D + 8, by 16-byte cp.async copies; rows at or past N are zero.
// The view's base and strides are 16-byte aligned (the wrapper ensures it).
template <int D, int ROWS>
__device__ __forceinline__ void stage_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                            View s, int b, int h, int row0, int N) {
  constexpr int RS = D + 8, CPR = D / 8;  // row stride; 16-byte chunks a row
  const __nv_bfloat16* base = src + b * s.sb + h * s.sh;
  for (int e = threadIdx.x; e < ROWS * CPR; e += blockDim.x) {
    const int r = e / CPR, c = e % CPR;
    const int n = row0 + r;
    mma::cp_async16(dst + r * RS + c * 8, base + (long long)min(n, N - 1) * s.sn + c * 8,
                    n < N ? 16 : 0);
  }
}

// NW warps, 16 query rows each; at most 128 registers a thread where D <= 64
// (two blocks of 8 warps, or four of 4, on an SM)
template <int D, int NW>
__global__ void __launch_bounds__(32 * NW, D <= 64 ? 16 / NW : 1)
    attention_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, View qs, View ks, View vs, int H, int N,
                  int n_qt, float scale, __nv_bfloat16* __restrict__ out) {
  constexpr int QR = 16 * NW;  // query rows per block
  constexpr int RS = D + 8;   // row stride of every tile (elements)
  constexpr int KC = D / 16;  // k16 chunks of S = Q . K^T
  constexpr int DT = D / 8;   // n8 tiles of the output
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* Ks = Qs + QR * RS;      // two buffers of KT rows
  __nv_bfloat16* Vs = Ks + 2 * KT * RS;  // two buffers of KT rows

  const int bh = blockIdx.x / n_qt;
  const int b = bh / H, h = bh % H;
  const int q0 = (blockIdx.x % n_qt) * QR;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool active = q0 + warp * 16 < N;  // warp-uniform

  stage_async<D, QR>(Qs, q, qs, b, h, q0, N);
  stage_async<D, KT>(Ks, k, ks, b, h, 0, N);
  stage_async<D, KT>(Vs, v, vs, b, h, 0, N);
  mma::cp_async_commit();

  uint32_t qf[KC][4];
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;  // rows g and g + 8

  const int n_tiles = (N + KT - 1) / KT;
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      stage_async<D, KT>(Ks + (buf ^ 1) * KT * RS, k, ks, b, h, (it + 1) * KT, N);
      stage_async<D, KT>(Vs + (buf ^ 1) * KT * RS, v, vs, b, h, (it + 1) * KT, N);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();  // this tile (and Q) have landed
    __syncthreads();

    if (active) {
      if (it == 0) {
#pragma unroll
        for (int c = 0; c < KC; ++c)
          mma::ldmatrix_x4(qf[c], Qs + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * RS +
                                      16 * c + 8 * (lane >> 4));
      }
      const __nv_bfloat16* Kt = Ks + buf * KT * RS;
      const __nv_bfloat16* Vt = Vs + buf * KT * RS;
      const int k0 = it * KT;
      const int kvalid = min(KT, N - k0);
      const int nt = (kvalid + 7) / 8;    // n8 key tiles holding a valid key
      const int kc = (kvalid + 15) / 16;  // k16 key chunks of P . V

      // S = Q . K^T: 16 rows x 64 keys, 8 n8 tiles of 4 f32 each
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        if (2 * jp < nt) {
#pragma unroll
          for (int c = 0; c < KC; ++c) {
            uint32_t kb[4];
            mma::ldmatrix_x4(kb, Kt + (16 * jp + (lane & 7) + 8 * (lane >> 4)) * RS + 16 * c +
                                     8 * ((lane >> 3) & 1));
            mma::mma_bf16(s[2 * jp], qf[c], kb[0], kb[1]);
            mma::mma_bf16(s[2 * jp + 1], qf[c], kb[2], kb[3]);
          }
        }
      }

      // scale (times log2 e: exp2 below), mask keys >= N, online softmax
      // (rows g: s[.][0..1], g + 8: s[.][2..3])
      float mx0 = -INFINITY, mx1 = -INFINITY;
      const bool ragged = kvalid < KT;  // only the last tile holds keys >= N
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          s[j][e] = ragged && key >= N ? -INFINITY : s[j][e] * scale;
        }
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: key k0 < N
      const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = exp2f(s[j][0] - mn0);
        s[j][1] = exp2f(s[j][1] - mn0);
        s[j][2] = exp2f(s[j][2] - mn1);
        s[j][3] = exp2f(s[j][3] - mn1);
        sum0 += s[j][0] + s[j][1];
        sum1 += s[j][2] + s[j][3];
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
      }
      l0 = l0 * a0 + sum0;
      l1 = l1 * a1 + sum1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        o[j][0] *= a0;
        o[j][1] *= a0;
        o[j][2] *= a1;
        o[j][3] *= a1;
      }

      // O += (P_hi + P_lo) . V; the S fragments of keys 16c .. 16c + 15 are
      // the A fragment of chunk c
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c < kc) {
          uint32_t ph[4], pl[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)  // rows g, g + 8; keys 2t, 2t + 8 of the chunk
            mma::split2_bf16(s[2 * c + (r >> 1)][2 * (r & 1)],
                             s[2 * c + (r >> 1)][2 * (r & 1) + 1], ph[r], pl[r]);
#pragma unroll
          for (int dp = 0; dp < DT / 2; ++dp) {
            uint32_t vb[4];
            mma::ldmatrix_x4_trans(vb, Vt + (16 * c + (lane & 7) + 8 * ((lane >> 3) & 1)) * RS +
                                           16 * dp + 8 * (lane >> 4));
            mma::mma_bf16(o[2 * dp], pl, vb[0], vb[1]);
            mma::mma_bf16(o[2 * dp], ph, vb[0], vb[1]);
            mma::mma_bf16(o[2 * dp + 1], pl, vb[2], vb[3]);
            mma::mma_bf16(o[2 * dp + 1], ph, vb[2], vb[3]);
          }
        }
      }
    }
    __syncthreads();  // this buffer is consumed before tile it + 2 refills it
  }

  if (!active) return;
  // out = O / l in bf16, through the warp's own 16 rows of the Q tile
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  __nv_bfloat16* rows = Qs + warp * 16 * RS;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    *reinterpret_cast<uint32_t*>(rows + g * RS + 8 * j + 2 * t) =
        mma::pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
    *reinterpret_cast<uint32_t*>(rows + (g + 8) * RS + 8 * j + 2 * t) =
        mma::pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
  }
  __syncwarp();
  constexpr int CPR = D / 8;  // 16-byte chunks a row
  for (int e = lane; e < 16 * CPR; e += 32) {
    const int r = e / CPR, c = e % CPR;
    const int n = q0 + warp * 16 + r;
    if (n < N)
      *reinterpret_cast<float4*>(out + (((long long)b * N + n) * H + h) * D + c * 8) =
          *reinterpret_cast<const float4*>(rows + r * RS + c * 8);
  }
}

template <int D, int NW>
cudaError_t launch_mma(const void* q, const void* k, const void* v, View qs, View ks, View vs,
                       int B, int N, int H, float scale, void* out, cudaStream_t stream) {
  constexpr int QR = 16 * NW;
  constexpr size_t smem = sizeof(__nv_bfloat16) * (size_t)(QR + 4 * KT) * (D + 8);
  auto kernel = attention_mma<D, NW>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (N + QR - 1) / QR;
  // one flat grid, the query tiles of a head next to each other (K and V
  // from L2 after the first); the scores are taken in log2 units
  kernel<<<(unsigned)(B * H) * n_qt, 32 * NW, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), qs, ks, vs, H, N, n_qt, scale * 1.4426950408889634f,
      static_cast<__nv_bfloat16*>(out));
  return cudaGetLastError();
}

// 128 query rows a block (K and V staged half as often) where that pads N
// no more than 64 rows do: N = 211 takes two blocks of 8 warps, N = 53 and
// N = 129 blocks of 4
template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, View qs, View ks, View vs,
                        int B, int N, int H, float scale, void* out, cudaStream_t s) {
  const bool wide = (N + 127) / 128 * 128 == (N + 63) / 64 * 64;
  return wide ? launch_mma<D, 8>(q, k, v, qs, ks, vs, B, N, H, scale, out, s)
              : launch_mma<D, 4>(q, k, v, qs, ks, vs, B, N, H, scale, out, s);
}

// ---------------------------------------------------------------- f32, CUDA cores

// Rows [row0, row0 + 64) of one head of `src` → f32 tile `dst` with row
// stride D + 4; rows at or past N are zero.
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, View s, int b,
                                      int h, int row0, int N) {
  constexpr int S = D + 4;
  const float* base = src + b * s.sb + h * s.sh;
  for (int e = threadIdx.x; e < 64 * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int n = row0 + r;
    dst[r * S + d] = n < N ? base[(long long)n * s.sn + d] : 0.0f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, View qs, View ks, View vs, int H, int N,
                  float scale, float* __restrict__ out) {
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
  stage<D>(Qs, q, qs, b, h, q0, N);

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
    stage<D>(Ks, k, ks, b, h, k0, N);
    stage<D>(Vs, v, vs, b, h, k0, N);
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

  // out[b, n, h, :] = o / l
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + ty * 4 + i;
    if (n >= N) continue;
    const float inv = 1.0f / l[i];
    float* row = out + (((long long)b * N + n) * H + h) * D + tx * 4;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) row[32 * c + e] = o[i][c * 4 + e] * inv;
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, View qs, View ks, View vs,
                       int B, int N, int H, float scale, void* out, cudaStream_t stream) {
  constexpr int S = D + 4;
  constexpr size_t smem = sizeof(float) * (size_t)(QT * S + 2 * KT * S + QT * PT);
  auto kernel = attention_f32<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (N + QT - 1) / QT);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      qs, ks, vs, H, N, scale, static_cast<float*>(out));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int is_bf16, const void* q, const void* k, const void* v, View qs, View ks,
                   View vs, int B, int N, int H, float scale, void* out, cudaStream_t s) {
  return is_bf16 ? launch_bf16<D>(q, k, v, qs, ks, vs, B, N, H, scale, out, s)
                 : launch_f32<D>(q, k, v, qs, ks, vs, B, N, H, scale, out, s);
}

// ---------------------------------------------------------------- bf16, additive bias
//
// Windowed attention with an additive bias (Swin's relative-position bias,
// plus its shift mask in shifted blocks); no TPU kernel counterpart (the JAX
// package has no such model). For batch row b (image * G + window) and head
// h:
//     out[b, :, h, :] = softmax(q . k^T * scale + bias[b % G, h]) . v
// with bias an f32 (G, H, N, N) tensor, G the windows of an image (1 where
// every window takes the same bias), N <= 64 (Swin's 7 x 7 windows: 49).
//
// Bound on the H100 at Swin-B's first stage, batch 384 (26,880 windows of
// 49 tokens, 4 heads of 32): q, k, v and the output once, 1.35 GB over
// 3.35 TB/s = 0.40 ms, against 0.03 ms of tensor-core work: the bytes bound
// it. The bias (at most 2.7 MB) is read from L2 by every block.
//
// One block of 4 warps per (b, h): the window's N <= 64 rows of Q, K and V
// come into shared memory once by 16-byte cp.async copies (rows past N
// zero), each warp keeps 16 query rows' Q fragments in registers, S = Q . K^T
// runs on mma.sync m16n8k16 (bf16 in, f32 accumulate) and stays in
// registers; the scores are scaled, the bias added from global memory (the
// fragment's own rows and keys), keys >= N masked, and one plain softmax
// taken over the single key tile (no online rescaling). P . V takes P split
// as P_hi + P_lo, as in attention_mma, so the result is within one bf16 ulp
// of the f32 plain version; it is rounded once, staged in the warp's rows of
// the Q tile and written with 16-byte stores.
template <int D>
__global__ void __launch_bounds__(128)
    wattn_bias_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, View qs, View ks, View vs,
                   const float* __restrict__ bias, int G, int H, int N, float scale,
                   __nv_bfloat16* __restrict__ out) {
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr int RS = D + 8;   // row stride of every tile (elements)
  constexpr int KC = D / 16;  // k16 chunks of S = Q . K^T
  constexpr int DT = D / 8;   // n8 tiles of the output
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* Ks = Qs + KT * RS;
  __nv_bfloat16* Vs = Ks + KT * RS;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  stage_async<D, KT>(Qs, q, qs, b, h, 0, N);
  stage_async<D, KT>(Ks, k, ks, b, h, 0, N);
  stage_async<D, KT>(Vs, v, vs, b, h, 0, N);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();
  if (warp * 16 >= N) return;  // warp-uniform; no barrier follows

  uint32_t qf[KC][4];
#pragma unroll
  for (int c = 0; c < KC; ++c)
    mma::ldmatrix_x4(qf[c], Qs + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * RS +
                                16 * c + 8 * (lane >> 4));
  const int nt = (N + 7) / 8;    // n8 key tiles holding a valid key
  const int kc = (N + 15) / 16;  // k16 key chunks of P . V

  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
  for (int jp = 0; jp < 4; ++jp) {
    if (2 * jp < nt) {
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        uint32_t kb[4];
        mma::ldmatrix_x4(kb, Ks + (16 * jp + (lane & 7) + 8 * (lane >> 4)) * RS + 16 * c +
                                 8 * ((lane >> 3) & 1));
        mma::mma_bf16(s[2 * jp], qf[c], kb[0], kb[1]);
        mma::mma_bf16(s[2 * jp + 1], qf[c], kb[2], kb[3]);
      }
    }
  }

  // scale, add the bias (log2 units: exp2 below), mask keys >= N; rows
  // r0 = g and r1 = g + 8 of the warp: s[.][0..1] and s[.][2..3]
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const float* bp = bias + ((long long)(b % G) * H + h) * N * N;
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * j + 2 * t + (e & 1);
      const int row = e < 2 ? r0 : r1;
      float add = 0.0f;
      if (key < N && row < N) add = __ldg(bp + row * N + key);
      s[j][e] = key < N ? fmaf(s[j][e], scale, add * kLog2e) : -INFINITY;
    }
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j][0] = exp2f(s[j][0] - mx0);
    s[j][1] = exp2f(s[j][1] - mx0);
    s[j][2] = exp2f(s[j][2] - mx1);
    s[j][3] = exp2f(s[j][3] - mx1);
    l0 += s[j][0] + s[j][1];
    l1 += s[j][2] + s[j][3];
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (c < kc) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)  // rows g, g + 8; keys 2t, 2t + 8 of the chunk
        mma::split2_bf16(s[2 * c + (r >> 1)][2 * (r & 1)], s[2 * c + (r >> 1)][2 * (r & 1) + 1],
                         ph[r], pl[r]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vb[4];
        mma::ldmatrix_x4_trans(vb, Vs + (16 * c + (lane & 7) + 8 * ((lane >> 3) & 1)) * RS +
                                       16 * dp + 8 * (lane >> 4));
        mma::mma_bf16(o[2 * dp], pl, vb[0], vb[1]);
        mma::mma_bf16(o[2 * dp], ph, vb[0], vb[1]);
        mma::mma_bf16(o[2 * dp + 1], pl, vb[2], vb[3]);
        mma::mma_bf16(o[2 * dp + 1], ph, vb[2], vb[3]);
      }
    }
  }

  // out = O / l in bf16, through the warp's own 16 rows of the Q tile
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  __nv_bfloat16* rows = Qs + warp * 16 * RS;
  __syncwarp();  // every lane's Q fragments are loaded before the rows are overwritten
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    *reinterpret_cast<uint32_t*>(rows + g * RS + 8 * j + 2 * t) =
        mma::pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
    *reinterpret_cast<uint32_t*>(rows + (g + 8) * RS + 8 * j + 2 * t) =
        mma::pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
  }
  __syncwarp();
  constexpr int CPR = D / 8;  // 16-byte chunks a row
  for (int e = lane; e < 16 * CPR; e += 32) {
    const int r = e / CPR, c = e % CPR;
    const int n = warp * 16 + r;
    if (n < N)
      *reinterpret_cast<float4*>(out + (((long long)b * N + n) * H + h) * D + c * 8) =
          *reinterpret_cast<const float4*>(rows + r * RS + c * 8);
  }
}

template <int D>
cudaError_t launch_bias(const void* q, const void* k, const void* v, View qs, View ks, View vs,
                        const float* bias, int B, int N, int H, int G, float scale, void* out,
                        cudaStream_t stream) {
  constexpr size_t smem = sizeof(__nv_bfloat16) * (size_t)(3 * KT) * (D + 8);
  auto kernel = wattn_bias_mma<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)(B * H), 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), qs, ks, vs, bias, G, H, N, scale * 1.4426950408889634f,
      static_cast<__nv_bfloat16*>(out));
  return cudaGetLastError();
}

}  // namespace

// Attention over (B, N, H, D) views q, k, v (strides in elements, D
// unit-stride) into the contiguous (B, N, H, D) `out`, on `stream`.
// D in {32, 64, 96}; is_bf16 selects bf16 inputs and output, else f32. In
// bf16 the three bases and every stride of a dimension longer than 1 are
// multiples of 16 bytes. Returns cudaGetLastError() (or the error of the
// launch's set-up).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               long long q_sb, long long q_sn, long long q_sh,
                               long long k_sb, long long k_sn, long long k_sh,
                               long long v_sb, long long v_sn, long long v_sh, int B, int N,
                               int H, int D, float scale, int is_bf16, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const View qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh}, vs{v_sb, v_sn, v_sh};
  if (B <= 0 || N <= 0 || H <= 0) return (int)cudaGetLastError();
  switch (D) {
    case 32: return (int)launch<32>(is_bf16, q, k, v, qs, ks, vs, B, N, H, scale, out, s);
    case 64: return (int)launch<64>(is_bf16, q, k, v, qs, ks, vs, B, N, H, scale, out, s);
    case 96: return (int)launch<96>(is_bf16, q, k, v, qs, ks, vs, B, N, H, scale, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Windowed attention with an additive bias over bf16 (B, N, H, D) views q,
// k, v (strides in elements, D unit-stride, bases and strides of dimensions
// longer than 1 multiples of 16 bytes) into the contiguous bf16 (B, N, H, D)
// `out`, on `stream`: bias is a contiguous f32 (G, H, N, N) tensor added to
// batch row b's scaled scores as bias[b % G]. D = 32 (Swin's heads), 1 <= N <= 64,
// G divides B. Returns cudaGetLastError() (or the error of the launch's
// set-up).
extern "C" int windowed_attention_bias(const void* q, const void* k, const void* v,
                                       long long q_sb, long long q_sn, long long q_sh,
                                       long long k_sb, long long k_sn, long long k_sh,
                                       long long v_sb, long long v_sn, long long v_sh,
                                       const void* bias, int B, int N, int H, int D, int G,
                                       float scale, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const View qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh}, vs{v_sb, v_sn, v_sh};
  if (B <= 0 || H <= 0) return (int)cudaGetLastError();
  if (N <= 0 || N > KT || G <= 0 || B % G != 0) return (int)cudaErrorInvalidValue;
  const float* bp = static_cast<const float*>(bias);
  switch (D) {
    case 32: return (int)launch_bias<32>(q, k, v, qs, ks, vs, bp, B, N, H, G, scale, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
