// Gallery search top-k (kernel K3 of the port) for sm_90a.
//
// Replaces the Pallas kernel daliid_tpu/ops/search_topk.py::_kernel
// (entries sq8_search_topk / f32_search_topk): for each probe, the top-k
// probe . gallery similarities over the first num_real gallery rows.
//   SQ8 mode: int8 x int8 -> int32 dot, then (float)acc * g_scale[row].
//   f32 mode: an f32 dot.
//
// Order: value descending, then gallery index ascending (the order the TPU
// kernel's first-lane argmax over [carry | chunk] gives). Indices are int32;
// slots without a candidate (k > num_real) come back as (-inf, -1).
//
// Bound on the H100: the gallery is read once per 64-probe tile, so at
// Q <= 64 the bytes are the gallery itself (G * D for int8, 4 * G * D for
// f32) over 3.35 TB/s: 0.64 ms for 2^20 int8 rows of 2048, 2.56 ms in f32.
// The products take less on the tensor cores: 2 * Q * G * D int8 operations
// over 1,979 TOP/s is 0.14 ms, and the six bf16 piece products of f32 mode,
// 6 * 2 * Q * G * D over 989 TFLOP/s, 1.67 ms (as much as 3xTF32 at 495
// TFLOP/s). So both modes are bound by the bytes, and the design streams
// the gallery.
//
// Design:
//   pass 1: one block of 8 warps per (gallery chunk, 64-probe tile), two
//     blocks an SM. The block walks its chunk in tiles of 128 gallery rows;
//     each tile's rows go through a ring of 4 shared-memory stages of 64
//     bytes a row, filled by 16-byte cp.async copies 3 stages ahead, so the
//     copies overlap the products (the probe tile streams beside it from L2,
//     as 128 KB of int8 probes at D = 2048 would not fit beside the ring).
//     Each thread copies the same three 16-byte chunks of every stage of a
//     tile, so a stage's copies cost one pointer add each. Rows whose start
//     is not 16-byte aligned (D * element size not a multiple of 16) are
//     copied with byte loads instead; ragged D and rows past the chunk's end
//     (or probes past Q) are zero-filled. Each warp owns 32 probes x 32 rows:
//       SQ8: mma.sync m16n8k32 s8 x s8 -> s32. The int32 sum is exact in any
//         order and the score stays one __fmul_rn(__int2float_rn(acc),
//         g_scale[row]), so SQ8 is bit-exact, indices included.
//       f32: each element split exactly into three bf16 pieces, x = x0 +
//         x1 + x2 (8 bits each, rounded by integer add and mask), and the
//         six piece products whose orders sum to at most 2 on mma.sync
//         m16n8k16 bf16 -> f32; the three dropped ones are below 2^-23 of
//         |x y|. 3xTF32 (two tf32 pieces, three products) was tried first:
//         its 2^-21 representation error failed the 1e-5 relative check on
//         scores near zero (PERF.md). Each stage sums its 16 elements in a
//         fresh accumulator, which is then added to the tile's with IEEE f32
//         adds, so the tensor core's truncating accumulation never runs over
//         more than 16 elements. The splits are made in registers by every
//         warp that reads an element (four times for a probe, twice for a
//         row), and the 128-register cap of two blocks an SM spills a few
//         hundred bytes: this mode is bound by issue, not by its bytes.
//     After the last stage of a tile the 64 x 128 scores go to shared memory
//     and are folded into per-probe sorted top-k lists. Each warp owns 8
//     probes; a list of up to 64 entries lives in the warp's registers
//     (lane l holds entries 2l and 2l+1), so an insertion is one ballot and
//     one shuffle. Rows are filtered against the list's k-th entry first, so
//     after the first tiles almost nothing is inserted. Candidates go to
//     (Q, n_chunks, k).
//   pass 2: one block per probe merges its n_chunks * k candidates with the
//     same warp lists: eight warp lists, then one.
//
// Exactness: the comparator is a strict total order on (value, index), so
// the selected set and its order do not depend on the order candidates
// arrive in; SQ8 results are bit-exact against the plain version in
// daliid_tpu_torch/ops/search_topk.py and the JAX kernel.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;        // probes per tile
constexpr int GT = 128;          // gallery rows per tile
constexpr int KS = 64;           // bytes of each row per stage
constexpr int RSB = KS + 16;     // row stride of a stage in shared memory (bytes)
constexpr int STAGES = 4;  // ring depth: two blocks an SM, 3 stages in flight each
constexpr int STAGE_BYTES = (kTile + GT) * RSB;
constexpr int ST = GT + 4;       // row stride of the score tile (floats)
constexpr int kMaxK = 64;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

// A sorted list of up to 64 (value, index) entries held by one warp:
// lane l holds entries 2l (v0, i0) and 2l + 1 (v1, i1). Empty entries are
// (-inf, INT_MAX), which no real candidate loses to.
struct WarpList {
  float v0, v1;
  int i0, i1;

  __device__ __forceinline__ void init() {
    v0 = v1 = -INFINITY;
    i0 = i1 = INT_MAX;
  }

  __device__ __forceinline__ void kth(int k, float& tv, int& ti) const {
    const int src = (k - 1) >> 1;
    const float a0 = __shfl_sync(kFull, v0, src);
    const float a1 = __shfl_sync(kFull, v1, src);
    const int b0 = __shfl_sync(kFull, i0, src);
    const int b1 = __shfl_sync(kFull, i1, src);
    const bool hi = (k - 1) & 1;
    tv = hi ? a1 : a0;
    ti = hi ? b1 : b0;
  }

  // Insert one candidate (warp-uniform arguments). Entries pushed past
  // slot 63 fall off the end.
  __device__ __forceinline__ void insert(float v, int i, int lane) {
    const int pos = __popc(__ballot_sync(kFull, better(v0, i0, v, i))) +
                    __popc(__ballot_sync(kFull, better(v1, i1, v, i)));
    const float pv = __shfl_up_sync(kFull, v1, 1);
    const int pi = __shfl_up_sync(kFull, i1, 1);
    const int j0 = 2 * lane, j1 = j0 + 1;
    const float nv1 = j1 < pos ? v1 : (j1 == pos ? v : v0);
    const int ni1 = j1 < pos ? i1 : (j1 == pos ? i : i0);
    const float nv0 = j0 < pos ? v0 : (j0 == pos ? v : pv);
    const int ni0 = j0 < pos ? i0 : (j0 == pos ? i : pi);
    v0 = nv0;
    i0 = ni0;
    v1 = nv1;
    i1 = ni1;
  }

  // Every lane offers one candidate; those that beat the k-th entry are
  // inserted one by one.
  __device__ __forceinline__ void offer(float v, int i, bool valid, int k,
                                        int lane) {
    float tv;
    int ti;
    kth(k, tv, ti);
    unsigned m = __ballot_sync(kFull, valid && better(v, i, tv, ti));
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      insert(__shfl_sync(kFull, v, src), __shfl_sync(kFull, i, src), lane);
    }
  }
};

// The copies one thread makes into each pipeline stage. A stage holds probes
// q0 .. q0 + 63 (stage rows 0-63) and gallery rows r0 .. r0 + 127 (stage
// rows 64-191), bytes kb .. kb + 63 of each, as 768 16-byte chunks; thread
// tid copies chunks tid, tid + 256 and tid + 512, the same rows and columns
// in every stage of a tile, so only kb moves from one stage to the next.
// Bytes past the row's end, probes past Q and rows past row_end are zero.
// `aligned`: every row starts on 16 bytes, so 16-byte cp.async copies
// (whole or empty); otherwise byte loads.
struct StageLoader {
  static constexpr int kChunks = (kTile + GT) * (KS / 16) / kThreads;
  const uint8_t* src[kChunks];  // the chunk's row plus its column; null: a zero row
  int dst[kChunks], col[kChunks];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int e = threadIdx.x + kThreads * i, r = e / (KS / 16);
      col[i] = 16 * (e % (KS / 16));
      dst[i] = r * RSB + col[i];
    }
  }

  // point the chunks at the probe tile and gallery rows r0 .. r0 + 127
  __device__ __forceinline__ void rows(const uint8_t* __restrict__ q,
                                       const uint8_t* __restrict__ g, int Q, int q0, int r0,
                                       int row_end, int row_bytes) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int r = dst[i] / RSB;
      const bool probe = r < kTile;
      const int row = probe ? q0 + r : r0 + (r - kTile);
      src[i] = (probe ? row < Q : row < row_end)
                   ? (probe ? q : g) + (size_t)row * row_bytes + col[i]
                   : nullptr;
    }
  }

  __device__ __forceinline__ void load(uint8_t* buf, const uint8_t* __restrict__ g, int kb,
                                       int row_bytes, bool aligned) const {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int n = src[i] ? max(0, min(16, row_bytes - kb - col[i])) : 0;
      if (aligned) {
        mma::cp_async16(buf + dst[i], n > 0 ? src[i] + kb : g, n);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (j < n) w[j >> 2] |= (uint32_t)src[i][kb + j] << (8 * (j & 3));
        *reinterpret_cast<uint4*>(buf + dst[i]) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
};
static_assert(StageLoader::kChunks * kThreads == (kTile + GT) * (KS / 16),
              "a stage is a whole number of chunks a thread");

template <bool Q8>
__global__ void __launch_bounds__(kThreads, 2)
    topk_pass1(const uint8_t* __restrict__ q, const uint8_t* __restrict__ g,
               const float* __restrict__ g_scale, int Q, int row_bytes, int num_real,
               int k, int rows_per_chunk, bool aligned, float* __restrict__ cand_v,
               int* __restrict__ cand_i) {
  using Acc = typename std::conditional<Q8, int, float>::type;
  extern __shared__ float4 smem4[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem4);
  float* S = reinterpret_cast<float*>(ring + STAGES * STAGE_BYTES);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;  // the warp's 32 probes and 32 rows
  const int chunk = blockIdx.x, n_chunks = gridDim.x;
  const int q0 = blockIdx.y * kTile;
  const int row_begin = chunk * rows_per_chunk;
  const int row_end = min(row_begin + rows_per_chunk, num_real);
  const int n_ks = (row_bytes + KS - 1) / KS;
  const int total = (row_end - row_begin + GT - 1) / GT * n_ks;

  WarpList lists[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) lists[p].init();
  Acc acc[2][4][4];  // [probe m16 tile][row n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  // the copies run STAGES - 1 stages ahead of the products
  StageLoader loader;
  loader.init();
  loader.rows(q, g, Q, q0, row_begin, row_end, row_bytes);
  int issued = 0, issue_ks = 0, issue_r0 = row_begin;
  auto issue = [&]() {
    if (issued < total) {
      loader.load(ring + (issued % STAGES) * STAGE_BYTES, g, issue_ks * KS, row_bytes, aligned);
      if (++issue_ks == n_ks) {
        issue_ks = 0;
        issue_r0 += GT;
        if (issue_r0 < row_end) loader.rows(q, g, Q, q0, issue_r0, row_end, row_bytes);
      }
    }
    ++issued;
    mma::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue();

  int ks = 0, r0 = row_begin;  // the stage being multiplied: its k-step and tile
  for (int it = 0; it < total; ++it) {
    mma::cp_async_wait<STAGES - 2>();  // stage `it` has landed
    __syncthreads();                   // ... for every thread; stage it - 1 is consumed
    issue();

    const uint8_t* stage = ring + (it % STAGES) * STAGE_BYTES;
    if constexpr (Q8) {
      const uint8_t* B = stage + kTile * RSB;
#pragma unroll
      for (int kk = 0; kk < KS / 32; ++kk) {  // 32-byte k-steps
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          mma::ldmatrix_x4(a[i], stage + (32 * wm + 16 * i + (lane & 7) +
                                          8 * ((lane >> 3) & 1)) * RSB +
                                     32 * kk + 16 * (lane >> 4));
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t b[4];
          mma::ldmatrix_x4(b, B + (32 * wn + 16 * jp + (lane & 7) + 8 * (lane >> 4)) * RSB +
                                  32 * kk + 16 * ((lane >> 3) & 1));
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma::mma_s8(acc[i][2 * jp], a[i], b[0], b[1]);
            mma::mma_s8(acc[i][2 * jp + 1], a[i], b[2], b[3]);
          }
        }
      }
    } else {
      // The stage's 16 f32 elements as one bf16 k16 step. ldmatrix on f32
      // rows hands thread (g, t) elements t, t + 4 of each 8-element block,
      // and the k order (2t, 2t + 1, 2t + 8, 2t + 9) <- (t, t + 4, 8 + t,
      // 12 + t) is the same permutation for A and B, so the products are the
      // dot's. Each element is three bf16 pieces (exact); the six products
      // of pieces whose orders sum to at most 2 go in, smallest first, into a
      // fresh sum that is added to the tile's in f32.
      static_assert(KS == 64, "f32 mode takes one k16 step of 16 elements a stage");
      const uint8_t* B = stage + kTile * RSB;
      uint32_t ap[2][3][4], bp[4][3][2];  // [tile][piece][register]
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t a[2][4], p[3];  // [8-element block][register]
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          mma::ldmatrix_x4(a[kk], stage + (32 * wm + 16 * i + (lane & 7) +
                                           8 * ((lane >> 3) & 1)) * RSB +
                                      32 * kk + 16 * (lane >> 4));
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // rows g (r even), g + 8; blocks 0 (r < 2), 1
          mma::split3_bf16(a[r >> 1][r & 1], a[r >> 1][(r & 1) + 2], p);
          ap[i][0][r] = p[0];
          ap[i][1][r] = p[1];
          ap[i][2][r] = p[2];
        }
      }
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t b[2][4], p[3];  // [8-element block][register]
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          mma::ldmatrix_x4(b[kk], B + (32 * wn + 16 * jp + (lane & 7) + 8 * (lane >> 4)) * RSB +
                                      32 * kk + 16 * ((lane >> 3) & 1));
#pragma unroll
        for (int h = 0; h < 2; ++h)  // the pair's two n8 tiles
#pragma unroll
          for (int r = 0; r < 2; ++r) {  // blocks 0, 1
            mma::split3_bf16(b[r][2 * h], b[r][2 * h + 1], p);
            bp[2 * jp + h][0][r] = p[0];
            bp[2 * jp + h][1][r] = p[1];
            bp[2 * jp + h][2][r] = p[2];
          }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mma::mma_bf16(part, ap[i][2], bp[j][0][0], bp[j][0][1]);
          mma::mma_bf16(part, ap[i][1], bp[j][1][0], bp[j][1][1]);
          mma::mma_bf16(part, ap[i][0], bp[j][2][0], bp[j][2][1]);
          mma::mma_bf16(part, ap[i][1], bp[j][0][0], bp[j][0][1]);
          mma::mma_bf16(part, ap[i][0], bp[j][1][0], bp[j][1][1]);
          mma::mma_bf16(part, ap[i][0], bp[j][0][0], bp[j][0][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = __fadd_rn(acc[i][j][e], part[e]);
        }
    }

    if (++ks < n_ks) continue;
    // the tile's last stage: scores to shared memory, then into the lists
    ks = 0;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = 32 * wm + 16 * i + gq + 8 * (e >> 1);
          const int n = 32 * wn + 8 * j + 2 * t + (e & 1);
          float s;
          if constexpr (Q8) {
            const int row = r0 + n;
            s = row < row_end ? __fmul_rn(__int2float_rn(acc[i][j][e]), g_scale[row]) : 0.f;
          } else {
            s = acc[i][j][e];
          }
          S[m * ST + n] = s;
          acc[i][j][e] = 0;
        }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int m = warp * 8 + p;
      if (q0 + m < Q) {  // warp-uniform
#pragma unroll
        for (int h = 0; h < GT / 32; ++h) {
          const int row = r0 + lane + 32 * h;
          lists[p].offer(S[m * ST + lane + 32 * h], row, row < row_end, k, lane);
        }
      }
    }
    // the next write of S follows at least one more __syncthreads
    r0 += GT;
  }
  mma::cp_async_wait<0>();

#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int qi = q0 + warp * 8 + p;
    if (qi < Q) {
      const size_t base = ((size_t)qi * n_chunks + chunk) * k;
      const int j0 = 2 * lane;
      if (j0 < k) {
        cand_v[base + j0] = lists[p].v0;
        cand_i[base + j0] = lists[p].i0;
      }
      if (j0 + 1 < k) {
        cand_v[base + j0 + 1] = lists[p].v1;
        cand_i[base + j0 + 1] = lists[p].i1;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    topk_pass2(const float* __restrict__ cand_v, const int* __restrict__ cand_i,
               int n_cand, int k, float* __restrict__ out_v,
               int* __restrict__ out_i) {
  __shared__ float sv[kThreads / 32][kMaxK];
  __shared__ int si[kThreads / 32][kMaxK];
  const int qi = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* cv = cand_v + (size_t)qi * n_cand;
  const int* ci = cand_i + (size_t)qi * n_cand;

  WarpList L;
  L.init();
  for (int base = warp * 32; base < n_cand; base += kThreads) {
    const int c = base + lane;
    const bool ok = c < n_cand;
    L.offer(ok ? cv[c] : -INFINITY, ok ? ci[c] : INT_MAX, ok, k, lane);
  }
  sv[warp][2 * lane] = L.v0;
  si[warp][2 * lane] = L.i0;
  sv[warp][2 * lane + 1] = L.v1;
  si[warp][2 * lane + 1] = L.i1;
  __syncthreads();
  if (warp != 0) return;

  WarpList M;
  M.init();
  for (int w = 0; w < kThreads / 32; ++w) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = h * 32 + lane;
      M.offer(sv[w][j], si[w][j], j < k, k, lane);
    }
  }
  const size_t base = (size_t)qi * k;
  const int j0 = 2 * lane;
  if (j0 < k) {
    out_v[base + j0] = M.i0 == INT_MAX ? -INFINITY : M.v0;
    out_i[base + j0] = M.i0 == INT_MAX ? -1 : M.i0;
  }
  if (j0 + 1 < k) {
    out_v[base + j0 + 1] = M.i1 == INT_MAX ? -INFINITY : M.v1;
    out_i[base + j0 + 1] = M.i1 == INT_MAX ? -1 : M.i1;
  }
}

template <bool Q8>
cudaError_t launch_pass1(dim3 grid, cudaStream_t s, const void* q, const void* g,
                         const void* g_scale, int Q, int row_bytes, int num_real, int k,
                         int rows_per_chunk, bool aligned, float* cv, int* ci) {
  constexpr int smem = STAGES * STAGE_BYTES + kTile * ST * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(topk_pass1<Q8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  topk_pass1<Q8><<<grid, kThreads, smem, s>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(g),
      static_cast<const float*>(g_scale), Q, row_bytes, num_real, k, rows_per_chunk, aligned,
      cv, ci);
  return cudaGetLastError();
}

}  // namespace

// Launch both passes on `stream`. g_scale is read in SQ8 mode only and may
// be null in f32 mode. Scratch cand_v / cand_i hold
// Q * n_chunks * k entries, n_chunks = ceil(num_real / rows_per_chunk);
// rows_per_chunk is a multiple of 128. Requires Q >= 1, 1 <= k <= 64,
// num_real >= 1. Returns cudaGetLastError().
extern "C" int search_topk(const void* q, const void* g, const void* g_scale,
                           int Q, int D, int num_real, int k,
                           int rows_per_chunk, int quantized, void* cand_v,
                           void* cand_i, void* out_v, void* out_i,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (num_real + rows_per_chunk - 1) / rows_per_chunk;
  const dim3 grid1(n_chunks, (Q + kTile - 1) / kTile);
  float* cv = static_cast<float*>(cand_v);
  int* ci = static_cast<int*>(cand_i);
  const int row_bytes = quantized ? D : 4 * D;
  const bool aligned = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(g) % 16 == 0;
  cudaError_t err =
      quantized ? launch_pass1<true>(grid1, s, q, g, g_scale, Q, row_bytes, num_real, k,
                                     rows_per_chunk, aligned, cv, ci)
                : launch_pass1<false>(grid1, s, q, g, g_scale, Q, row_bytes, num_real, k,
                                      rows_per_chunk, aligned, cv, ci);
  if (err != cudaSuccess) return (int)err;
  topk_pass2<<<Q, kThreads, 0, s>>>(cv, ci, n_chunks * k, k,
                                    static_cast<float*>(out_v),
                                    static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}
