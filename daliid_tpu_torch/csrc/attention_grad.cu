// The backward of fused multi-head attention (kernel K4's gradient) for sm_90a.
//
// No TPU kernel counterpart: the JAX package's gradient of flash_attention is
// its custom VJP's _bwd (daliid_tpu/ops/flash_attention.py), which XLA runs
// outside any Pallas kernel. These kernels were added because the plain
// PyTorch version of that backward (ops/flash_attention.py::attention_backward)
// upcasts q, k, v and dO to f32, builds S, P, dP and dS as (B, H, N, N) f32
// tensors in device memory and runs its five products on f32 GEMMs off the
// tensor cores: the largest block of device time in a transformer training
// step. csrc/flash_attention.cu (the forwards) is left as it is; this file is
// a library of its own.
//
// For batch row b and head h, with s = q . k^T * scale (+ bias[b % G, h]),
// P = softmax(s) by rows and dO the output's gradient:
//     dV = P^T . dO,  dP = dO . V^T,  delta_i = sum_j P_ij dP_ij,
//     dS = P o (dP - delta),  dQ = dS . K * scale,  dK = dS^T . Q * scale,
// and with a bias dbias[g, h] = the sum of dS over the images of window g.
// The arithmetic is the plain version's at the configuration's precision,
// f32 accumulate:
//   - bf16 (every main path): S and dP are exact bf16 products with f32
//     sums on mma.sync m16n8k16; P and dS are f32 values that enter dV, dQ
//     and dK as two bf16 parts, hi = bf16(x) and lo = bf16(x - hi) (about
//     2^-17 relative, as the forward feeds P); delta is the f32 row sum of
//     P o dP; dq, dk and dv are rounded once, to bf16, at the store, and
//     dbias stays f32. So the gradients are within one bf16 ulp of the
//     plain version's.
//   - f32 (checks only, as the forward's attention_f32): exact f32 on the
//     CUDA cores.
// No float atomics anywhere: each output element is summed by one thread in
// a fixed order, and dbias is reduced across blocks through a partial buffer
// (the wrapper sums it over its first dimension), so two calls on the same
// inputs give the same bits. Keys and queries past N contribute exactly
// zero.
//
// Layout: q, k, v and dO are (B, N, H, D) views with any batch, token and
// head strides and a unit stride on D (the ViT's qkv column blocks go in as
// they are); dq, dk and dv are contiguous (B, N, H, D).
//
// Unbiased (k4_grad_dq, then k4_grad_dkv; bf16, D in {32, 64, 96}, any N):
//   - k4_grad_dq: a block of 4 warps per (b, h, 64-query tile), 16 query
//     rows a warp, their Q and dO fragments in registers; K and V walk in
//     64-key tiles, double-buffered by 16-byte cp.async copies (rows past N
//     zero-filled), twice. The first walk takes S and dP and keeps the row
//     max, the row sum and sum_j exp(s_j - max) dP_j online; it gives the
//     log-sum-exp and delta, which the block writes for k4_grad_dkv (2 f32 a
//     row). The second walk recomputes S and dP, forms P = exp2(s - lse) and
//     dS, and adds dS . K to registers (dS's accumulator fragments are the A
//     fragments, as P's are in the forward's P . V). Each query row's dQ is
//     one warp's: no reduction across blocks.
//   - k4_grad_dkv: a block of 4 warps per (b, h, 64-key tile), 16 keys a
//     warp; Q, dO and the rows' statistics walk in 64-query tiles,
//     double-buffered. S^T = K . Q^T and dP^T = V . dO^T give P^T and dS^T
//     for the warp's keys, and dV += P^T . dO, dK += dS^T . Q stay in
//     registers over the whole walk.
//   Work at the JPM trunk's (384, 211, 12, 64): S three times, dP three
//   times, and dQ, dK, dV twice each (the split): 12 products of 2 N^2 D a
//   row and head where the algorithm needs 5; the bytes (q, k, v, dO read
//   once and dq, dk, dv written once: 871 MB, 0.26 ms at 3.35 TB/s) still
//   bound the least time, the tensor-core work (8.0e11 operations with the
//   padding of N to 32-key halves) sets this kernel pair's pace.
//
// Biased (wattn_grad_mma; bf16, D = 32, N <= 64, a (G, H, N, N) f32 bias;
// Swin's windows): a block of 4 warps per (window g, head h, chunk of
// images) walks the chunk's windows b = image * G + g; each window's Q, K,
// V and dO (64 padded rows, about 5 KB each) come into shared memory by
// cp.async, the next window's while this one computes. Each warp takes 16
// query rows whole: S and dP over all 64 keys in registers, one plain
// softmax, delta, dS, dQ = dS . K (no reduction: the row is the warp's), and
// dS added to the block's dbias registers (the warp's own rows and keys).
// P and dS go to shared memory in f32; then each warp takes 16 keys: dV =
// P^T . dO and dK = dS^T . Q, reading their A fragments from shared memory
// and splitting them there. At the walk's end each block writes its dbias
// sum to a (chunks, G, H, N, N) f32 partial buffer. It serves G = 1 (one
// bias for every window: the unshifted blocks) and G = windows (shifted).
//   Bound at Swin-B's first stage, batch 384 (26,880 windows of 49 tokens, 4
//   heads of 32): q, k, v, dO read and dq, dk, dv written once in bf16, 2.36
//   GB over 3.35 TB/s = 0.70 ms; the bytes bound it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int TR = 64;  // rows of a staged tile
constexpr int PS = TR + 4;  // row stride of the biased kernel's f32 P and dS tiles

struct View {
  long long sb, sn, sh;  // element strides of batch, token and head; D is unit-stride
};

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- shared pieces

// Rows [row0, row0 + TR) of one head of `src` → bf16 tile `dst` with row
// stride D + 8, by 16-byte cp.async copies; rows at or past N are zero. (The
// forward's copy of it stays in flash_attention.cu: mma.cuh is hashed into
// every library, so moving it there would rebuild the forwards.)
template <int D>
__device__ __forceinline__ void stage_async(bf16* dst, const bf16* src, View s, int b, int h,
                                            int row0, int N) {
  constexpr int RS = D + 8, CPR = D / 8;  // row stride; 16-byte chunks a row
  const bf16* base = src + b * s.sb + h * s.sh;
  for (int e = threadIdx.x; e < TR * CPR; e += blockDim.x) {
    const int r = e / CPR, c = e % CPR;
    const int n = row0 + r;
    mma::cp_async16(dst + r * RS + c * 8, base + (long long)min(n, N - 1) * s.sn + c * 8,
                    n < N ? 16 : 0);
  }
}

// A fragments of rows [r0, r0 + 16), k16 chunk c, of a row-major tile
template <int RS>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int r0, int c,
                                       int lane) {
  mma::ldmatrix_x4(a, tile + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * RS + 16 * c +
                          8 * (lane >> 4));
}

// B fragments of two n8 tiles, the tile's rows [r0, r0 + 16) as columns of B,
// k16 chunk c of their elements (K in S = Q . K^T)
template <int RS>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile, int r0, int c,
                                       int lane) {
  mma::ldmatrix_x4(b, tile + (r0 + (lane & 7) + 8 * (lane >> 4)) * RS + 16 * c +
                          8 * ((lane >> 3) & 1));
}

// B fragments of two n8 tiles, columns [16 dp, 16 dp + 16) of the tile, with
// k the rows [r0, r0 + 16) (V in O = P . V: stored k-major)
template <int RS>
__device__ __forceinline__ void load_bt(uint32_t (&b)[4], const bf16* tile, int r0, int dp,
                                        int lane) {
  mma::ldmatrix_x4_trans(b, tile + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * RS + 16 * dp +
                                8 * (lane >> 4));
}

// acc (16 rows x 32 columns, 4 n8 tiles) += A . (rows [r0, r0 + 32) of tile)^T
// over D, for the first `pairs` 16-column halves; `a` the A fragments of D
template <int D>
__device__ __forceinline__ void dot_rows(float (&acc)[4][4], const uint32_t (&a)[D / 16][4],
                                         const bf16* tile, int r0, int pairs, int lane) {
#pragma unroll
  for (int jp = 0; jp < 2; ++jp) {
    if (jp < pairs) {
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        uint32_t b[4];
        load_b<D + 8>(b, tile, r0 + 16 * jp, c, lane);
        mma::mma_bf16(acc[2 * jp], a[c], b[0], b[1]);
        mma::mma_bf16(acc[2 * jp + 1], a[c], b[2], b[3]);
      }
    }
  }
}

// acc (16 rows x D) += (x_hi + x_lo) . (rows [r0, r0 + 32) of tile), x the f32
// 16 x 32 accumulator fragments (4 n8 tiles), over the first `chunks` k16
// chunks; the small part first
template <int D>
__device__ __forceinline__ void dot_split(float (&acc)[D / 8][4], const float (&x)[4][4],
                                          const bf16* tile, int r0, int chunks, int lane) {
#pragma unroll
  for (int cc = 0; cc < 2; ++cc) {
    if (cc < chunks) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)  // rows g, g + 8; columns 2t, 2t + 8 of the chunk
        mma::split2_bf16(x[2 * cc + (r >> 1)][2 * (r & 1)], x[2 * cc + (r >> 1)][2 * (r & 1) + 1],
                         hi[r], lo[r]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        load_bt<D + 8>(b, tile, r0 + 16 * cc, dp, lane);
        mma::mma_bf16(acc[2 * dp], lo, b[0], b[1]);
        mma::mma_bf16(acc[2 * dp], hi, b[0], b[1]);
        mma::mma_bf16(acc[2 * dp + 1], lo, b[2], b[3]);
        mma::mma_bf16(acc[2 * dp + 1], hi, b[2], b[3]);
      }
    }
  }
}

// acc (16 rows x D, the warp's rows of a tile) times `mul`, rounded to bf16,
// through the warp's rows of `stage` (row stride D + 8) into rows [n0, n0 +
// 16) of the contiguous (B, N, H, D) `out`, rows below N only
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], float mul, bf16* stage,
                                           bf16* out, int b, int h, int H, int N, int n0,
                                           int lane) {
  constexpr int RS = D + 8, CPR = D / 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(stage + g * RS + 8 * j + 2 * t) =
        mma::pack_bf16(acc[j][0] * mul, acc[j][1] * mul);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * RS + 8 * j + 2 * t) =
        mma::pack_bf16(acc[j][2] * mul, acc[j][3] * mul);
  }
  __syncwarp();
  for (int e = lane; e < 16 * CPR; e += 32) {
    const int r = e / CPR, c = e % CPR;
    const int n = n0 + r;
    if (n < N)
      *reinterpret_cast<float4*>(out + (((long long)b * N + n) * H + h) * D + c * 8) =
          *reinterpret_cast<const float4*>(stage + r * RS + c * 8);
  }
  __syncwarp();  // the rows are read before the next use overwrites them
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------- bf16, unbiased

// dQ and the rows' statistics: one block of 4 warps per (b, h, 64-query tile)
template <int D>
__global__ void __launch_bounds__(128)
    k4_grad_dq(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ go, View qs, View ks,
               View vs, View gs, int H, int N, int n_qt, float scale2, float scale,
               bf16* __restrict__ dq, float* __restrict__ lse, float* __restrict__ delta) {
  constexpr int RS = D + 8;   // row stride of every tile (elements)
  constexpr int KC = D / 16;  // k16 chunks of S = Q . K^T
  constexpr int DT = D / 8;   // n8 tiles of dQ
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* Gs = Qs + TR * RS;      // dO
  bf16* Ks = Gs + TR * RS;      // two buffers of TR rows
  bf16* Vs = Ks + 2 * TR * RS;  // two buffers of TR rows

  const int bh = blockIdx.x / n_qt;
  const int b = bh / H, h = bh % H;
  const int q0 = (blockIdx.x % n_qt) * TR;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const bool active = q0 + warp * 16 < N;  // warp-uniform

  stage_async<D>(Qs, q, qs, b, h, q0, N);
  stage_async<D>(Gs, go, gs, b, h, q0, N);
  stage_async<D>(Ks, k, ks, b, h, 0, N);
  stage_async<D>(Vs, v, vs, b, h, 0, N);
  mma::cp_async_commit();

  uint32_t qf[KC][4], gf[KC][4];
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  // rows g and g + 8: running max (log2 units), this thread's partial sums of
  // exp2(s - m) and of exp2(s - m) dP; after the first walk the log-sum-exp
  // and delta
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f, d0 = 0.0f, d1 = 0.0f;

  const int n_kt = (N + TR - 1) / TR;
  for (int it = 0; it < 2 * n_kt; ++it) {
    const int buf = it & 1;
    if (it + 1 < 2 * n_kt) {
      const int nk = ((it + 1) % n_kt) * TR;
      stage_async<D>(Ks + (buf ^ 1) * TR * RS, k, ks, b, h, nk, N);
      stage_async<D>(Vs + (buf ^ 1) * TR * RS, v, vs, b, h, nk, N);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();  // this tile (and Q, dO) have landed
    __syncthreads();

    if (active) {
      if (it == 0) {
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          load_a<RS>(qf[c], Qs, warp * 16, c, lane);
          load_a<RS>(gf[c], Gs, warp * 16, c, lane);
        }
      }
      const bool second = it >= n_kt;
      if (it == n_kt) {  // the first walk is over: the rows' statistics
        l0 = quad_sum(l0);
        l1 = quad_sum(l1);
        d0 = quad_sum(d0) / l0;
        d1 = quad_sum(d1) / l1;
        m0 += log2f(l0);
        m1 += log2f(l1);
        const int n = q0 + warp * 16 + (lane >> 2);
        const long long row = (long long)bh * N;
        if (t == 0 && n < N) {
          lse[row + n] = m0;
          delta[row + n] = d0;
        }
        if (t == 0 && n + 8 < N) {
          lse[row + n + 8] = m1;
          delta[row + n + 8] = d1;
        }
      }
      const bf16* Kt = Ks + buf * TR * RS;
      const bf16* Vt = Vs + buf * TR * RS;
      const int k0 = (it % n_kt) * TR;
      const int kvalid = min(TR, N - k0);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r0 = 32 * hh;
        if (r0 < kvalid) {  // block-uniform
          const int valid = kvalid - r0;
          const int pairs = valid > 16 ? 2 : 1;
          float s[4][4], dp[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
          dot_rows<D>(s, qf, Kt, r0, pairs, lane);
          dot_rows<D>(dp, gf, Vt, r0, pairs, lane);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = k0 + r0 + 8 * j + 2 * t + (e & 1);
              s[j][e] = key < N ? s[j][e] * scale2 : -INFINITY;
            }
          if (!second) {
            float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
              mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
            }
            const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
            const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
            l0 *= a0;
            d0 *= a0;
            l1 *= a1;
            d1 *= a1;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float e0 = exp2f(s[j][0] - mn0), e1 = exp2f(s[j][1] - mn0);
              const float e2 = exp2f(s[j][2] - mn1), e3 = exp2f(s[j][3] - mn1);
              l0 += e0 + e1;
              l1 += e2 + e3;
              d0 += e0 * dp[j][0] + e1 * dp[j][1];
              d1 += e2 * dp[j][2] + e3 * dp[j][3];
            }
            m0 = mn0;
            m1 = mn1;
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {  // dS = P (dP - delta), in place of S
              s[j][0] = exp2f(s[j][0] - m0) * (dp[j][0] - d0);
              s[j][1] = exp2f(s[j][1] - m0) * (dp[j][1] - d0);
              s[j][2] = exp2f(s[j][2] - m1) * (dp[j][2] - d1);
              s[j][3] = exp2f(s[j][3] - m1) * (dp[j][3] - d1);
            }
            dot_split<D>(acc, s, Kt, r0, (valid + 15) / 16, lane);
          }
        }
      }
    }
    __syncthreads();  // this buffer is consumed before tile it + 2 refills it
  }

  if (!active) return;
  // dq = acc * scale in bf16, through the warp's own 16 rows of the Q tile
  store_rows<D>(acc, scale, Qs + warp * 16 * RS, dq, b, h, H, N, q0 + warp * 16, lane);
}

// dK and dV: one block of 4 warps per (b, h, 64-key tile)
template <int D>
__global__ void __launch_bounds__(128)
    k4_grad_dkv(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ go, View qs, View ks,
                View vs, View gs, int H, int N, int n_kt, float scale2, float scale,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv) {
  constexpr int RS = D + 8;
  constexpr int KC = D / 16;
  constexpr int DT = D / 8;
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);
  bf16* Vs = Ks + TR * RS;
  bf16* Qs = Vs + TR * RS;      // two buffers of TR rows
  bf16* Gs = Qs + 2 * TR * RS;  // two buffers of TR rows (dO)
  float* Ls = reinterpret_cast<float*>(Gs + 2 * TR * RS);  // two buffers of TR log-sum-exps
  float* Ds = Ls + 2 * TR;                                  // two buffers of TR deltas

  const int bh = blockIdx.x / n_kt;
  const int b = bh / H, h = bh % H;
  const int k0 = (blockIdx.x % n_kt) * TR;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const bool active = k0 + warp * 16 < N;  // warp-uniform
  const long long row = (long long)bh * N;

  stage_async<D>(Ks, k, ks, b, h, k0, N);
  stage_async<D>(Vs, v, vs, b, h, k0, N);
  stage_async<D>(Qs, q, qs, b, h, 0, N);
  stage_async<D>(Gs, go, gs, b, h, 0, N);
  mma::cp_async_commit();
  // the rows' statistics; a row past N gives P = exp2(s - inf) = 0 and dS = 0
  if (threadIdx.x < TR) {
    const int n = threadIdx.x;
    Ls[n] = n < N ? lse[row + n] : INFINITY;
    Ds[n] = n < N ? delta[row + n] : 0.0f;
  }

  float ka[DT][4], va[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) ka[j][e] = va[j][e] = 0.0f;

  const int n_qt = (N + TR - 1) / TR;
  for (int it = 0; it < n_qt; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_qt) {
      const int nq = (it + 1) * TR;
      stage_async<D>(Qs + (buf ^ 1) * TR * RS, q, qs, b, h, nq, N);
      stage_async<D>(Gs + (buf ^ 1) * TR * RS, go, gs, b, h, nq, N);
      if (threadIdx.x < TR) {
        const int n = nq + threadIdx.x;
        Ls[(buf ^ 1) * TR + threadIdx.x] = n < N ? lse[row + n] : INFINITY;
        Ds[(buf ^ 1) * TR + threadIdx.x] = n < N ? delta[row + n] : 0.0f;
      }
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();

    if (active) {
      const bf16* Qt = Qs + buf * TR * RS;
      const bf16* Gt = Gs + buf * TR * RS;
      const float* L = Ls + buf * TR;
      const float* Dl = Ds + buf * TR;
      const int qvalid = min(TR, N - it * TR);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r0 = 32 * hh;
        if (r0 < qvalid) {  // block-uniform
          const int valid = qvalid - r0;
          const int pairs = valid > 16 ? 2 : 1;
          // S^T (the warp's 16 keys x 32 queries) and dP^T
          float s[4][4], dp[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
          for (int c = 0; c < KC; ++c) {
            uint32_t a[4];
            load_a<RS>(a, Ks, warp * 16, c, lane);
#pragma unroll
            for (int jp = 0; jp < 2; ++jp) {
              if (jp < pairs) {
                uint32_t bq[4];
                load_b<RS>(bq, Qt, r0 + 16 * jp, c, lane);
                mma::mma_bf16(s[2 * jp], a, bq[0], bq[1]);
                mma::mma_bf16(s[2 * jp + 1], a, bq[2], bq[3]);
              }
            }
            load_a<RS>(a, Vs, warp * 16, c, lane);
#pragma unroll
            for (int jp = 0; jp < 2; ++jp) {
              if (jp < pairs) {
                uint32_t bg[4];
                load_b<RS>(bg, Gt, r0 + 16 * jp, c, lane);
                mma::mma_bf16(dp[2 * jp], a, bg[0], bg[1]);
                mma::mma_bf16(dp[2 * jp + 1], a, bg[2], bg[3]);
              }
            }
          }
          // P^T in place of S^T, dS^T in place of dP^T; column = query
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = r0 + 8 * j + 2 * t + (e & 1);
              const float p = exp2f(s[j][e] * scale2 - L[col]);
              s[j][e] = p;
              dp[j][e] = p * (dp[j][e] - Dl[col]);
            }
          const int chunks = (valid + 15) / 16;
          dot_split<D>(va, s, Gt, r0, chunks, lane);
          dot_split<D>(ka, dp, Qt, r0, chunks, lane);
        }
      }
    }
    __syncthreads();
  }

  if (!active) return;
  // through the warp's own 16 rows of the K and V tiles
  store_rows<D>(ka, scale, Ks + warp * 16 * RS, dk, b, h, H, N, k0 + warp * 16, lane);
  store_rows<D>(va, 1.0f, Vs + warp * 16 * RS, dv, b, h, H, N, k0 + warp * 16, lane);
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* g, View qs,
                        View ks, View vs, View gs, int B, int N, int H, float scale, void* dq,
                        void* dk, void* dv, float* lse, float* delta, cudaStream_t stream) {
  constexpr int RS = D + 8;
  constexpr size_t smem_dq = sizeof(bf16) * (size_t)(6 * TR) * RS;
  constexpr size_t smem_dkv = smem_dq + sizeof(float) * 4 * TR;
  auto kq = k4_grad_dq<D>;
  auto kkv = k4_grad_dkv<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkv);
  if (err != cudaSuccess) return err;
  const int n_t = (N + TR - 1) / TR;
  const float scale2 = scale * kLog2e;  // the scores in log2 units (exp2 below)
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v), *gb = static_cast<const bf16*>(g);
  // the tiles of a head next to each other: its K and V (then Q and dO) come
  // from L2 after the first block
  kq<<<(unsigned)(B * H) * n_t, 128, smem_dq, stream>>>(qb, kb, vb, gb, qs, ks, vs, gs, H, N,
                                                          n_t, scale2, scale,
                                                          static_cast<bf16*>(dq), lse, delta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kkv<<<(unsigned)(B * H) * n_t, 128, smem_dkv, stream>>>(
      qb, kb, vb, gb, qs, ks, vs, gs, H, N, n_t, scale2, scale, lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv));
  return cudaGetLastError();
}

// ---------------------------------------------------------------- f32, CUDA cores

// sum over the warp of each lane's x, every lane gets the same bits
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int E>
__device__ __forceinline__ float row_dot(const float (&a)[E], const float* __restrict__ row,
                                         int lane) {
  float x = 0.0f;
#pragma unroll
  for (int e = 0; e < E; ++e) x = fmaf(a[e], row[lane + 32 * e], x);
  return warp_sum(x);
}

// dQ and the rows' statistics (natural units): one block of 4 warps per (b,
// h, query row); warp w takes the keys j = w (mod 4), each lane D / 32
// elements of a row; the warps' sums are combined in a fixed order
template <int D>
__global__ void __launch_bounds__(128)
    k4_grad_f32_rows(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ go, View qs,
                     View ks, View vs, View gs, int H, int N, float scale,
                     float* __restrict__ dq, float* __restrict__ lse,
                     float* __restrict__ delta) {
  constexpr int E = D / 32;
  __shared__ float red[4][3];
  __shared__ float part[4][D];
  const int n = blockIdx.x % N, bh = blockIdx.x / N;
  const int b = bh / H, h = bh % H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* qr = q + b * qs.sb + (long long)n * qs.sn + h * qs.sh;
  const float* gr = go + b * gs.sb + (long long)n * gs.sn + h * gs.sh;
  const float* kb = k + b * ks.sb + h * ks.sh;
  const float* vb = v + b * vs.sb + h * vs.sh;
  float qv[E], gv[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    qv[e] = qr[lane + 32 * e];
    gv[e] = gr[lane + 32 * e];
  }
  float m = -INFINITY, l = 0.0f, dd = 0.0f;
  for (int j = warp; j < N; j += 4) {
    const float s = row_dot<E>(qv, kb + (long long)j * ks.sn, lane) * scale;
    const float dp = row_dot<E>(gv, vb + (long long)j * vs.sn, lane);
    const float mn = fmaxf(m, s);
    const float a = expf(m - mn), p = expf(s - mn);
    l = l * a + p;
    dd = dd * a + p * dp;
    m = mn;
  }
  if (lane == 0) {
    red[warp][0] = m;
    red[warp][1] = l;
    red[warp][2] = dd;
  }
  __syncthreads();
  float mx = red[0][0];
  for (int w = 1; w < 4; ++w) mx = fmaxf(mx, red[w][0]);
  float lt = 0.0f, dt = 0.0f;
  for (int w = 0; w < 4; ++w) {  // a warp without keys has m = -inf, l = 0
    const float a = expf(red[w][0] - mx);
    lt += red[w][1] * a;
    dt += red[w][2] * a;
  }
  const float dl = dt / lt, ls = mx + logf(lt);
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.0f;
  for (int j = warp; j < N; j += 4) {
    const float* kr = kb + (long long)j * ks.sn;
    const float s = row_dot<E>(qv, kr, lane) * scale;
    const float dp = row_dot<E>(gv, vb + (long long)j * vs.sn, lane);
    const float ds = expf(s - ls) * (dp - dl);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = fmaf(ds, kr[lane + 32 * e], acc[e]);
  }
#pragma unroll
  for (int e = 0; e < E; ++e) part[warp][lane + 32 * e] = acc[e];
  __syncthreads();
  if (warp == 0) {
    float* out = dq + (((long long)b * N + n) * H + h) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = lane + 32 * e;
      out[d] = (part[0][d] + part[1][d] + part[2][d] + part[3][d]) * scale;
    }
    if (lane == 0) {
      lse[(long long)bh * N + n] = ls;
      delta[(long long)bh * N + n] = dl;
    }
  }
}

// dK and dV: one block of 4 warps per (b, h, key); warp w takes the query
// rows i = w (mod 4)
template <int D>
__global__ void __launch_bounds__(128)
    k4_grad_f32_cols(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ go, View qs,
                     View ks, View vs, View gs, int H, int N, float scale,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv) {
  constexpr int E = D / 32;
  __shared__ float part[2][4][D];
  const int n = blockIdx.x % N, bh = blockIdx.x / N;
  const int b = bh / H, h = bh % H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* kr = k + b * ks.sb + (long long)n * ks.sn + h * ks.sh;
  const float* vr = v + b * vs.sb + (long long)n * vs.sn + h * vs.sh;
  const float* qb = q + b * qs.sb + h * qs.sh;
  const float* gb = go + b * gs.sb + h * gs.sh;
  float kv[E], vv[E], ak[E], av[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    kv[e] = kr[lane + 32 * e];
    vv[e] = vr[lane + 32 * e];
    ak[e] = av[e] = 0.0f;
  }
  for (int i = warp; i < N; i += 4) {
    const float* qr = qb + (long long)i * qs.sn;
    const float* gr = gb + (long long)i * gs.sn;
    const float s = row_dot<E>(kv, qr, lane) * scale;
    const float dp = row_dot<E>(vv, gr, lane);
    const float p = expf(s - lse[(long long)bh * N + i]);
    const float ds = p * (dp - delta[(long long)bh * N + i]);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      ak[e] = fmaf(ds, qr[lane + 32 * e], ak[e]);
      av[e] = fmaf(p, gr[lane + 32 * e], av[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    part[0][warp][lane + 32 * e] = ak[e];
    part[1][warp][lane + 32 * e] = av[e];
  }
  __syncthreads();
  if (warp == 0) {
    const long long o = (((long long)b * N + n) * H + h) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = lane + 32 * e;
      dk[o + d] = (part[0][0][d] + part[0][1][d] + part[0][2][d] + part[0][3][d]) * scale;
      dv[o + d] = part[1][0][d] + part[1][1][d] + part[1][2][d] + part[1][3][d];
    }
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* g, View qs,
                       View ks, View vs, View gs, int B, int N, int H, float scale, void* dq,
                       void* dk, void* dv, float* lse, float* delta, cudaStream_t stream) {
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v), *gf = static_cast<const float*>(g);
  const unsigned grid = (unsigned)(B * H) * N;
  k4_grad_f32_rows<D><<<grid, 128, 0, stream>>>(qf, kf, vf, gf, qs, ks, vs, gs, H, N, scale,
                                                 static_cast<float*>(dq), lse, delta);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k4_grad_f32_cols<D><<<grid, 128, 0, stream>>>(qf, kf, vf, gf, qs, ks, vs, gs, H, N, scale,
                                                 lse, delta, static_cast<float*>(dk),
                                                 static_cast<float*>(dv));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int is_bf16, const void* q, const void* k, const void* v, const void* g,
                   View qs, View ks, View vs, View gs, int B, int N, int H, float scale,
                   void* dq, void* dk, void* dv, float* lse, float* delta, cudaStream_t s) {
  return is_bf16 ? launch_bf16<D>(q, k, v, g, qs, ks, vs, gs, B, N, H, scale, dq, dk, dv, lse,
                                  delta, s)
                 : launch_f32<D>(q, k, v, g, qs, ks, vs, gs, B, N, H, scale, dq, dk, dv, lse,
                                 delta, s);
}

// ---------------------------------------------------------------- bf16, additive bias

// One block of 4 warps per (window g, head h, chunk of `per` images); three
// blocks share an SM (shared memory 74 KB, at most 170 registers)
template <int D>
__global__ void __launch_bounds__(128, 3)
    wattn_grad_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ go, View qs, View ks,
                   View vs, View gs, const float* __restrict__ bias, int G, int H, int N,
                   int images, int per, int chunks, float scale2, float scale,
                   bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                   float* __restrict__ dbias) {
  constexpr int RS = D + 8;
  constexpr int KC = D / 16;
  constexpr int DT = D / 8;
  constexpr int TS = TR * RS;  // elements of a tile
  extern __shared__ float4 smem4[];
  bf16* tiles = reinterpret_cast<bf16*>(smem4);  // [2 buffers][Q, K, V, dO]
  float* Ps = reinterpret_cast<float*>(tiles + 8 * TS);  // P, [query][key]
  float* Ss = Ps + TR * PS;                              // dS, [query][key]

  const int gh = blockIdx.x / chunks, chunk = blockIdx.x % chunks;
  const int g = gh / H, h = gh % H;
  const int i0 = chunk * per, i1 = min(i0 + per, images);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int r0w = warp * 16 + (lane >> 2), r1w = r0w + 8;  // the thread's query rows
  const bool rows = warp * 16 < N;  // the warp's 16 rows (queries, then keys) hold one below N
  const float* bp = bias + ((long long)g * H + h) * N * N;

  if (i0 < i1) {
    const int b = i0 * G + g;
    stage_async<D>(tiles, q, qs, b, h, 0, N);
    stage_async<D>(tiles + TS, k, ks, b, h, 0, N);
    stage_async<D>(tiles + 2 * TS, v, vs, b, h, 0, N);
    stage_async<D>(tiles + 3 * TS, go, gs, b, h, 0, N);
  }
  mma::cp_async_commit();

  float db[2][4][4];  // the sum of dS over the images: rows r0w, r1w, the 64 keys
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) db[hh][j][e] = 0.0f;

  for (int i = i0; i < i1; ++i) {
    const int buf = (i - i0) & 1;
    if (i + 1 < i1) {
      const int nb = (i + 1) * G + g;
      bf16* nt = tiles + (buf ^ 1) * 4 * TS;
      stage_async<D>(nt, q, qs, nb, h, 0, N);
      stage_async<D>(nt + TS, k, ks, nb, h, 0, N);
      stage_async<D>(nt + 2 * TS, v, vs, nb, h, 0, N);
      stage_async<D>(nt + 3 * TS, go, gs, nb, h, 0, N);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();
    const int b = i * G + g;
    bf16* Qt = tiles + buf * 4 * TS;
    bf16* Kt = Qt + TS;
    bf16* Vt = Kt + TS;
    bf16* Gt = Vt + TS;

    float dqa[DT][4];
    if (rows) {  // the warp's 16 query rows over all keys
      uint32_t qf[KC][4], gf[KC][4];
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        load_a<RS>(qf[c], Qt, warp * 16, c, lane);
        load_a<RS>(gf[c], Gt, warp * 16, c, lane);
      }
      float s[2][4][4], dp[2][4][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[hh][j][e] = dp[hh][j][e] = 0.0f;
        if (32 * hh < N) {
          const int pairs = N - 32 * hh > 16 ? 2 : 1;
          dot_rows<D>(s[hh], qf, Kt, 32 * hh, pairs, lane);
          dot_rows<D>(dp[hh], gf, Vt, 32 * hh, pairs, lane);
        }
      }
      // scale, add the bias (log2 units), mask keys >= N; one softmax
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = 32 * hh + 8 * j + 2 * t + (e & 1);
            const int row = e < 2 ? r0w : r1w;
            float add = 0.0f;
            if (key < N && row < N) add = __ldg(bp + row * N + key);
            s[hh][j][e] = key < N ? fmaf(s[hh][j][e], scale2, add * kLog2e) : -INFINITY;
          }
          mx0 = fmaxf(mx0, fmaxf(s[hh][j][0], s[hh][j][1]));
          mx1 = fmaxf(mx1, fmaxf(s[hh][j][2], s[hh][j][3]));
        }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[hh][j][0] = exp2f(s[hh][j][0] - mx0);
          s[hh][j][1] = exp2f(s[hh][j][1] - mx0);
          s[hh][j][2] = exp2f(s[hh][j][2] - mx1);
          s[hh][j][3] = exp2f(s[hh][j][3] - mx1);
          l0 += s[hh][j][0] + s[hh][j][1];
          l1 += s[hh][j][2] + s[hh][j][3];
        }
      // 1 / l, and 0 for the rows past N: their P and dS are exactly zero
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
      const float inv0 = r0w < N ? 1.0f / l0 : 0.0f, inv1 = r1w < N ? 1.0f / l1 : 0.0f;
      float d0 = 0.0f, d1 = 0.0f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[hh][j][0] *= inv0;
          s[hh][j][1] *= inv0;
          s[hh][j][2] *= inv1;
          s[hh][j][3] *= inv1;
          d0 += s[hh][j][0] * dp[hh][j][0] + s[hh][j][1] * dp[hh][j][1];
          d1 += s[hh][j][2] * dp[hh][j][2] + s[hh][j][3] * dp[hh][j][3];
        }
      d0 = quad_sum(d0);
      d1 = quad_sum(d1);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // dS = P (dP - delta), in place of dP; P and dS to shared memory
          dp[hh][j][0] = s[hh][j][0] * (dp[hh][j][0] - d0);
          dp[hh][j][1] = s[hh][j][1] * (dp[hh][j][1] - d0);
          dp[hh][j][2] = s[hh][j][2] * (dp[hh][j][2] - d1);
          dp[hh][j][3] = s[hh][j][3] * (dp[hh][j][3] - d1);
#pragma unroll
          for (int e = 0; e < 4; ++e) db[hh][j][e] += dp[hh][j][e];
          const int col = 32 * hh + 8 * j + 2 * t;
          *reinterpret_cast<float2*>(Ps + r0w * PS + col) = make_float2(s[hh][j][0], s[hh][j][1]);
          *reinterpret_cast<float2*>(Ps + r1w * PS + col) = make_float2(s[hh][j][2], s[hh][j][3]);
          *reinterpret_cast<float2*>(Ss + r0w * PS + col) = make_float2(dp[hh][j][0], dp[hh][j][1]);
          *reinterpret_cast<float2*>(Ss + r1w * PS + col) = make_float2(dp[hh][j][2], dp[hh][j][3]);
        }
      // dQ = dS . K (times scale at the store)
#pragma unroll
      for (int j = 0; j < DT; ++j) dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.0f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        if (32 * hh < N) dot_split<D>(dqa, dp[hh], Kt, 32 * hh, (N - 32 * hh + 15) / 16, lane);
    }
    __syncthreads();  // P and dS are whole; K is read no more

    if (rows) {  // the warp's 16 keys over all queries
      store_rows<D>(dqa, scale, Kt + warp * 16 * RS, dq, b, h, H, N, warp * 16, lane);
      float ka[DT][4], va[DT][4];
#pragma unroll
      for (int j = 0; j < DT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ka[j][e] = va[j][e] = 0.0f;
      const int kc = (N + 15) / 16;
#pragma unroll
      for (int c = 0; c < TR / 16; ++c) {
        if (c < kc) {
          // A fragments of P^T and dS^T: rows the keys, columns the 16
          // queries of chunk c, read from [query][key] and split
          uint32_t ph[4], pl[4], sh[4], sl[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int key = warp * 16 + (lane >> 2) + 8 * (r & 1);
            const int qq = 16 * c + 2 * t + 8 * (r >> 1);
            mma::split2_bf16(Ps[qq * PS + key], Ps[(qq + 1) * PS + key], ph[r], pl[r]);
            mma::split2_bf16(Ss[qq * PS + key], Ss[(qq + 1) * PS + key], sh[r], sl[r]);
          }
#pragma unroll
          for (int dp2 = 0; dp2 < DT / 2; ++dp2) {
            uint32_t bo[4], bq[4];
            load_bt<RS>(bo, Gt, 16 * c, dp2, lane);
            mma::mma_bf16(va[2 * dp2], pl, bo[0], bo[1]);
            mma::mma_bf16(va[2 * dp2], ph, bo[0], bo[1]);
            mma::mma_bf16(va[2 * dp2 + 1], pl, bo[2], bo[3]);
            mma::mma_bf16(va[2 * dp2 + 1], ph, bo[2], bo[3]);
            load_bt<RS>(bq, Qt, 16 * c, dp2, lane);
            mma::mma_bf16(ka[2 * dp2], sl, bq[0], bq[1]);
            mma::mma_bf16(ka[2 * dp2], sh, bq[0], bq[1]);
            mma::mma_bf16(ka[2 * dp2 + 1], sl, bq[2], bq[3]);
            mma::mma_bf16(ka[2 * dp2 + 1], sh, bq[2], bq[3]);
          }
        }
      }
      store_rows<D>(ka, scale, Kt + warp * 16 * RS, dk, b, h, H, N, warp * 16, lane);
      store_rows<D>(va, 1.0f, Vt + warp * 16 * RS, dv, b, h, H, N, warp * 16, lane);
    }
    __syncthreads();  // this buffer, P and dS are consumed before the next window
  }

  if (!rows) return;
  // this block's dbias partial: dbias[chunk, g, h, row, key] for rows, keys < N
  float* out = dbias + (((long long)chunk * G + g) * H + h) * N * N;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 32 * hh + 8 * j + 2 * t + (e & 1);
        const int row = e < 2 ? r0w : r1w;
        if (key < N && row < N) out[row * N + key] = db[hh][j][e];
      }
}

template <int D>
cudaError_t launch_bias(const void* q, const void* k, const void* v, const void* g, View qs,
                        View ks, View vs, View gs, const float* bias, int B, int N, int H, int G,
                        int chunks, float scale, void* dq, void* dk, void* dv, float* dbias,
                        cudaStream_t stream) {
  constexpr size_t smem = sizeof(bf16) * (size_t)(8 * TR) * (D + 8) + sizeof(float) * 2 * TR * PS;
  auto kernel = wattn_grad_mma<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int images = B / G;
  const int per = (images + chunks - 1) / chunks;
  kernel<<<(unsigned)(G * H) * chunks, 128, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), qs, ks, vs, gs, bias, G, H, N, images, per, chunks,
      scale * kLog2e, scale, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), dbias);
  return cudaGetLastError();
}

}  // namespace

// The gradient of attention over (B, N, H, D) views q, k, v with the
// output's gradient g (strides in elements, D unit-stride) into the
// contiguous (B, N, H, D) dq, dk, dv, on `stream`; lse and delta are (B, H,
// N) f32 scratch. D in {32, 64, 96}; is_bf16 selects bf16 tensors (the bases
// and every stride of a dimension longer than 1 multiples of 16 bytes), else
// f32. Two launches. Returns cudaGetLastError() (or the error of the
// launches' set-up).
extern "C" int attention_grad(const void* q, const void* k, const void* v, const void* g,
                              long long q_sb, long long q_sn, long long q_sh, long long k_sb,
                              long long k_sn, long long k_sh, long long v_sb, long long v_sn,
                              long long v_sh, long long g_sb, long long g_sn, long long g_sh,
                              int B, int N, int H, int D, float scale, int is_bf16, void* dq,
                              void* dk, void* dv, void* lse, void* delta, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const View qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh}, vs{v_sb, v_sn, v_sh},
      gs{g_sb, g_sn, g_sh};
  if (B <= 0 || N <= 0 || H <= 0) return (int)cudaGetLastError();
  float *ls = static_cast<float*>(lse), *dl = static_cast<float*>(delta);
  switch (D) {
    case 32:
      return (int)launch<32>(is_bf16, q, k, v, g, qs, ks, vs, gs, B, N, H, scale, dq, dk, dv,
                             ls, dl, s);
    case 64:
      return (int)launch<64>(is_bf16, q, k, v, g, qs, ks, vs, gs, B, N, H, scale, dq, dk, dv,
                             ls, dl, s);
    case 96:
      return (int)launch<96>(is_bf16, q, k, v, g, qs, ks, vs, gs, B, N, H, scale, dq, dk, dv,
                             ls, dl, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The gradient of windowed attention with an additive bias (the forward's
// windowed_attention_bias) over bf16 (B, N, H, D) views q, k, v and the
// output's gradient g (strides as above) into the contiguous bf16 dq, dk,
// dv and the f32 (chunks, G, H, N, N) `dbias` partials, whose sum over the
// first dimension is the bias's gradient; bias is the contiguous f32 (G, H,
// N, N) tensor, G divides B, and each of the `chunks` blocks of a (window,
// head) walks ceil((B / G) / chunks) images (the last fewer; none empty).
// D = 32, 1 <= N <= 64. One launch. Returns cudaGetLastError() (or the
// error of the launch's set-up).
extern "C" int windowed_attention_bias_grad(
    const void* q, const void* k, const void* v, const void* g, long long q_sb, long long q_sn,
    long long q_sh, long long k_sb, long long k_sn, long long k_sh, long long v_sb,
    long long v_sn, long long v_sh, long long g_sb, long long g_sn, long long g_sh,
    const void* bias, int B, int N, int H, int D, int G, int chunks, float scale, void* dq,
    void* dk, void* dv, void* dbias, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const View qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh}, vs{v_sb, v_sn, v_sh},
      gs{g_sb, g_sn, g_sh};
  if (B <= 0 || H <= 0) return (int)cudaGetLastError();
  if (N <= 0 || N > TR || G <= 0 || B % G != 0 || chunks <= 0) return (int)cudaErrorInvalidValue;
  const int images = B / G, per = (images + chunks - 1) / chunks;
  if (chunks > images || (chunks - 1) * per >= images) return (int)cudaErrorInvalidValue;
  const float* bp = static_cast<const float*>(bias);
  switch (D) {
    case 32:
      return (int)launch_bias<32>(q, k, v, g, qs, ks, vs, gs, bp, B, N, H, G, chunks, scale, dq,
                                  dk, dv, static_cast<float*>(dbias), s);
    default: return (int)cudaErrorInvalidValue;
  }
}
