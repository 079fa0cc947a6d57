// Gallery search top-k (kernel K3 of the port) for sm_90a.
//
// Replaces the Pallas kernel daliid_tpu/ops/search_topk.py::_kernel
// (entries sq8_search_topk / f32_search_topk): for each probe, the top-k
// probe . gallery similarities over the first num_real gallery rows.
//   SQ8 mode: int8 x int8 -> int32 dot, then (float)acc * g_scale[row].
//   f32 mode: a plain f32 dot.
//
// Order: value descending, then gallery index ascending (the order the TPU
// kernel's first-lane argmax over [carry | chunk] gives). Indices are int32;
// slots without a candidate (k > num_real) come back as (-inf, -1).
//
// Design (simple first):
//   pass 1: one block per (gallery chunk, 64-probe tile). The block walks
//     its chunk 64 rows at a time with a shared-memory tiled product (each
//     thread 4 probes x 4 rows; __dp4a on packed int8 words with an int32
//     accumulator in SQ8 mode, f32 FMAs in f32 mode), writes the 64 x 64
//     score tile to shared memory, and folds it into per-probe sorted top-k
//     lists. Each warp owns 8 probes; a list of up to 64 entries lives in
//     the warp's registers (lane l holds entries 2l and 2l+1), so an
//     insertion is one ballot and one shuffle. Rows are filtered against
//     the list's k-th entry first, so after the first tiles almost nothing
//     is inserted. Candidates go to (Q, n_chunks, k).
//   pass 2: one block per probe merges its n_chunks * k candidates with the
//     same warp lists: eight warp lists, then one.
//
// Bound on the H100: the gallery is read once per 64-probe tile, so at
// Q <= 64 the bytes are the gallery itself (G * D for int8, 4 * G * D for
// f32) over 3.35 TB/s: 0.64 ms for 2^20 int8 rows of 2048. For f32 at
// Q = 64 the products bound it instead (2 * Q * G * D over 67 TFLOP/s,
// 4.1 ms). The products run on the CUDA cores (dp4a / FMA), not the tensor
// cores, so this kernel is bound by instruction issue well above those
// bounds: wgmma is later work.
//
// Exactness: the SQ8 accumulator is an exact int32 and the score is one
// rounded f32 multiply, so SQ8 results are bit-exact against the plain
// version in daliid_tpu_torch/ops/search_topk.py and the JAX kernel. The
// comparator is a strict total order on (value, index), so the selected
// set and its order do not depend on the order candidates arrive in.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;        // probes per tile and gallery rows per tile
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

// One 32-bit word of row r, word w of an (nrows, D) matrix: an f32 element,
// or four int8 elements packed little-endian. Out-of-range words are 0.
template <bool Q8>
__device__ __forceinline__ typename std::conditional<Q8, int, float>::type
load_word(const void* __restrict__ base, int r, int nrows, int w, int D) {
  if constexpr (Q8) {
    if (r >= nrows) return 0;
    const int8_t* row = static_cast<const int8_t*>(base) + (size_t)r * D;
    const int b = 4 * w;
    if ((D & 3) == 0) {
      return b < D ? *reinterpret_cast<const int*>(row + b) : 0;
    }
    unsigned packed = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (b + t < D) packed |= (unsigned)(uint8_t)row[b + t] << (8 * t);
    }
    return (int)packed;
  } else {
    if (r >= nrows || w >= D) return 0.f;
    return static_cast<const float*>(base)[(size_t)r * D + w];
  }
}

template <bool Q8>
__global__ void __launch_bounds__(kThreads)
    topk_pass1(const void* __restrict__ q, const void* __restrict__ g,
               const float* __restrict__ g_scale, int Q, int D, int num_real,
               int k, int rows_per_chunk, float* __restrict__ cand_v,
               int* __restrict__ cand_i) {
  using Word = typename std::conditional<Q8, int, float>::type;
  constexpr int BK = Q8 ? 16 : 32;  // 32-bit words per k-step
  __shared__ Word As[BK][kTile + 1];
  __shared__ Word Bs[BK][kTile + 1];
  __shared__ float S[kTile][kTile + 1];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int chunk = blockIdx.x, n_chunks = gridDim.x;
  const int q0 = blockIdx.y * kTile;
  const int row_begin = chunk * rows_per_chunk;
  const int row_end = min(row_begin + rows_per_chunk, num_real);
  const int n_words = Q8 ? (D + 3) / 4 : D;

  WarpList lists[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) lists[p].init();

  for (int r0 = row_begin; r0 < row_end; r0 += kTile) {
    Word acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;

    for (int w0 = 0; w0 < n_words; w0 += BK) {
      for (int e = tid; e < kTile * BK; e += kThreads) {
        const int m = e / BK, kk = e % BK;
        As[kk][m] = load_word<Q8>(q, q0 + m, Q, w0 + kk, D);
        Bs[kk][m] = load_word<Q8>(g, r0 + m, row_end, w0 + kk, D);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        Word a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if constexpr (Q8) {
              acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
            } else {
              acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
            }
          }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tx + 16 * j, row = r0 + n;
        float s;
        if constexpr (Q8) {
          s = row < row_end ? __fmul_rn(__int2float_rn(acc[i][j]), g_scale[row])
                            : 0.f;
        } else {
          s = acc[i][j];
        }
        S[ty + 16 * i][n] = s;
      }
    __syncthreads();

#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int m = warp * 8 + p;
      if (q0 + m < Q) {  // warp-uniform
        const int ra = r0 + lane, rb = ra + 32;
        lists[p].offer(S[m][lane], ra, ra < row_end, k, lane);
        lists[p].offer(S[m][lane + 32], rb, rb < row_end, k, lane);
      }
    }
    __syncthreads();
  }

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

}  // namespace

// Launch both passes on `stream`. g_scale is read in SQ8 mode only and may
// be null in f32 mode. Scratch cand_v / cand_i hold
// Q * n_chunks * k entries, n_chunks = ceil(num_real / rows_per_chunk);
// rows_per_chunk is a multiple of 64. Requires Q >= 1, 1 <= k <= 64,
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
  if (quantized) {
    topk_pass1<true><<<grid1, kThreads, 0, s>>>(
        q, g, static_cast<const float*>(g_scale), Q, D, num_real, k,
        rows_per_chunk, cv, ci);
  } else {
    topk_pass1<false><<<grid1, kThreads, 0, s>>>(
        q, g, static_cast<const float*>(g_scale), Q, D, num_real, k,
        rows_per_chunk, cv, ci);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  topk_pass2<<<Q, kThreads, 0, s>>>(cv, ci, n_chunks * k, k,
                                    static_cast<float*>(out_v),
                                    static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}
