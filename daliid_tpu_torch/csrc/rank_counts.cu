// Positive rank counts (kernel K2 of the port) for sm_90a.
//
// Replaces the Pallas kernel daliid_tpu/ops/rank_counts.py::_kernel (entry
// positive_rank_counts). For each query q and positive slot p with
// threshold (t, pi) = (p_dist[q, p], p_idx[q, p]), count the gallery
// columns j whose junk-masked distance kd comes before the positive in the
// protocol's stable order:
//     kd[q, j] < t   or   (kd[q, j] == t and j < pi)
// Junk (same pid and same camid as the query) is +inf; ignore_camera turns
// the junk mask off. Slots with t == +inf are invalid and count 0.
//
// Design (simple first): one block per (16-query tile, 512-column gallery
// block). The block stages the distance tile in shared memory with the junk
// mask applied once. Each thread then owns groups of 4 positive slots of
// one query and counts over the block's columns; partial counts go into the
// zeroed (Q, P) output with atomicAdd. Integer addition does not depend on
// order, so the counts are exact whatever order blocks finish in.
//
// The tie rule is one compare per column: a column before pi counts when
// kd <= t, i.e. kd < nextafter(t, +inf); a column at or after pi when
// kd < t. Each thread picks the threshold by the column's side of pi.
// Groups whose slots are all invalid are skipped, so the work is what the
// valid positives need, not the padded P.
//
// Bound on the H100: the distmat is read once, 4 * Q * G bytes over
// 3.35 TB/s (0.065 ms at Market-1501's Q=3368, G=15913); the compares, G
// per valid positive (7.8e8 there), take 0.012 ms at the fp32 rate, so the
// bytes bound it. Every distance is read from device memory once, into
// shared memory; what costs time in this simple form is the idle threads of
// blocks whose queries have few valid slots (PERF.md has the times).
//
// Exactness: for finite t and any non-NaN kd, kd <= t is exactly
// kd < nextafterf(t, +inf), so the counts equal the plain version's and
// the JAX kernel's on every valid slot.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 16;    // queries per block
constexpr int BG = 512;   // gallery columns per block
constexpr int PPT = 4;    // positive slots per thread item

__global__ void __launch_bounds__(kThreads)
    rank_counts_kernel(const float* __restrict__ dist,
                       const float* __restrict__ p_dist,
                       const int* __restrict__ p_idx,
                       const int* __restrict__ q_pids,
                       const int* __restrict__ q_cams,
                       const int* __restrict__ g_pids,
                       const int* __restrict__ g_cams, int Q, int G, int P,
                       int ignore_camera, int* __restrict__ out) {
  __shared__ float S[BQ][BG + 1];
  const int q0 = blockIdx.x * BQ;
  const int j0 = blockIdx.y * BG;
  const int nq = min(BQ, Q - q0);
  const int ncols = min(BG, G - j0);

  for (int e = threadIdx.x; e < BQ * BG; e += kThreads) {
    const int r = e / BG, c = e % BG;
    if (r < nq && c < ncols) {
      const int qi = q0 + r, j = j0 + c;
      float d = dist[(size_t)qi * G + j];
      if (!ignore_camera && g_pids[j] == q_pids[qi] && g_cams[j] == q_cams[qi])
        d = INFINITY;
      S[r][c] = d;
    }
  }
  __syncthreads();

  const int groups = (P + PPT - 1) / PPT;
  for (int item = threadIdx.x; item < nq * groups; item += kThreads) {
    const int r = item / groups, p0 = (item % groups) * PPT;
    const int qi = q0 + r;
    float t_lt[PPT], t_le[PPT];
    int split[PPT];
    bool live[PPT];
    bool any = false;
#pragma unroll
    for (int u = 0; u < PPT; ++u) {
      const int p = p0 + u;
      const float t = p < P ? p_dist[(size_t)qi * P + p] : INFINITY;
      const int pi = p < P ? p_idx[(size_t)qi * P + p] : 0;
      live[u] = t < INFINITY;
      any |= live[u];
      t_lt[u] = t;
      t_le[u] = nextafterf(t, INFINITY);
      split[u] = min(max(pi - j0, 0), ncols);
    }
    if (!any) continue;

    const float* row = S[r];
    int cnt[PPT] = {0, 0, 0, 0};
    for (int c = 0; c < ncols; ++c) {
      const float d = row[c];
#pragma unroll
      for (int u = 0; u < PPT; ++u) cnt[u] += d < (c < split[u] ? t_le[u] : t_lt[u]);
    }
#pragma unroll
    for (int u = 0; u < PPT; ++u) {
      if (live[u] && cnt[u]) atomicAdd(&out[(size_t)qi * P + p0 + u], cnt[u]);
    }
  }
}

}  // namespace

// Zero `out` (Q, P) int32 and launch the counting kernel on `stream`.
// Returns cudaGetLastError().
extern "C" int rank_counts(const void* dist, const void* p_dist,
                           const void* p_idx, const void* q_pids,
                           const void* q_cams, const void* g_pids,
                           const void* g_cams, int Q, int G, int P,
                           int ignore_camera, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)Q * P * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (Q > 0 && G > 0 && P > 0) {
    const dim3 grid((Q + BQ - 1) / BQ, (G + BG - 1) / BG);
    rank_counts_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(dist), static_cast<const float*>(p_dist),
        static_cast<const int*>(p_idx), static_cast<const int*>(q_pids),
        static_cast<const int*>(q_cams), static_cast<const int*>(g_pids),
        static_cast<const int*>(g_cams), Q, G, P, ignore_camera,
        static_cast<int*>(out));
  }
  return (int)cudaGetLastError();
}
