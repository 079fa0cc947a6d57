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
// Bound on the H100: the bytes. The distmat is read once, 4 * Q * G bytes
// over 3.35 TB/s (0.065 ms at Market-1501's Q=3368, G=15913), beside which
// the (Q, P) tables are small once P is bounded by the queried pids. Binning
// 53.6 M columns costs instructions of the same order: on a uniform random
// distmat, where most columns come before a query's last positive, the
// shared-memory loads and atomics of the binning hold this design at about
// 3x the bytes bound; a trained model's columns mostly fall past the last
// positive and skip it (PERF.md has the times).
//
// Design: one block of kWarps warps per query. One warp's serial walk of a
// whole row sets the time when only ~25 rows share an SM, so the row is
// split across the block's warps.
//   1. The block writes 0 into every invalid slot of its row; warp 0
//      compacts up to kKeys valid slots into shared memory and sorts them
//      by counting: a key's place is the number of keys before it in (t,
//      pi, position) order, so duplicate keys get distinct places.
//   2. A lookup table splits [least key, largest key] into kBuckets buckets
//      of distance (a bucket is trunc((d - tmin) * scale), monotone in d).
//      For each bucket it holds the number of keys in lower buckets, the
//      number in the bucket itself and the distance of its first key, so a
//      column's bin mostly takes one 8-byte shared-memory load.
//   3. The warps stream the row with 16-byte loads in chunks of kChunk
//      columns, chunk c by warp c % kWarps, two buffers each: the next chunk
//      in flight while the current one is binned (a scalar head puts
//      row + head on a 16-byte boundary whatever G is; a scalar tail ends
//      the row). A column (d, j) at or before the largest key goes to bin b,
//      the number of sorted keys at or before it: the table's count below
//      its bucket, plus, without a branch, a compare with the one key its
//      bucket may hold (its index read only on an exact tie; a loop only
//      where a bucket holds several). It adds 1 to hist[b] (a shared-memory
//      integer atomic).
//   4. Junk columns were binned like the others; a block-wide scan of the
//      gallery pids finds them (same pid, then same camid) and takes them
//      back out of their bins, so the streaming loop tests no ids.
//   5. Sorted key k's count is hist[0] + ... + hist[k] (a warp scan), exact
//      in any order of the additions, written once into its slot. Nothing is
//      zeroed beforehand and no global atomic is used.
// A query with more than kKeys valid slots takes them kKeys at a time and
// walks its row again for each pass (mostly from L2): the count of a
// positive does not depend on the other keys it is sorted with.
//
// Exactness: every comparison is the protocol's own, d < t or (d == t and
// j < pi), in f32 and int32; the buckets only decide which keys a column is
// compared with, so the counts equal the plain version's and the JAX
// kernel's on every valid slot for any non-NaN distances.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;           // warps a block, one block a query
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 128;          // valid slots a block sorts and bins per pass
constexpr int kBuckets = 1024;      // lookup buckets between the least and largest key
constexpr int kVec = 2;             // 16-byte loads a lane has in flight per buffer
constexpr int kChunk = 128 * kVec;  // columns a warp loads at once
constexpr int kJunkLoads = 8;       // gallery pids a thread has in flight in the junk scan

struct Keys {
  float t[kKeys];      // sorted (t, pi) keys
  int pi[kKeys];
  int slot[kKeys];     // each sorted key's slot in the row of p_dist
  int hist[kKeys + 1];
  // bucket u + 1 (0: below the least key): x the distance of its first key
  // (bits), y the keys before it (low byte) and the keys in it (high byte)
  uint2 lut[kBuckets + 1];
};

// Column (d, j) is at or after key i: not (d, j) before (t_i, pi_i).
__device__ __forceinline__ bool at_or_after(const Keys& k, int i, float d, int j) {
  return !(d < k.t[i] || (d == k.t[i] && j < k.pi[i]));
}

// The bucket of a distance, +1; monotone in x, so a key-free bucket orders
// every distance in it against every key.
__device__ __forceinline__ int bucket(float x, float tmin, float scale) {
  const int u = __float2int_rz(__fmul_rn(__fsub_rn(x, tmin), scale));
  return min(max(u, -1), kBuckets - 1) + 1;
}

// Bin b of column (d, j): the number of sorted keys at or before it.
__device__ __forceinline__ int bin_of(const Keys& k, float d, int j, float tmin, float scale) {
  const unsigned e = k.lut[bucket(d, tmin, scale)].y;
  const int lo = e & 0xff, end = lo + (e >> 8);
  int b = lo;
  for (int i = lo; i < end; ++i) b += at_or_after(k, i, d, j);
  return b;
}

// Compact the next (up to kKeys) valid slots from slot `next` on into `k`,
// sorted by (t, pi, position); → how many.
__device__ int gather_keys(Keys& k, const float* pd, const int* pix, int P, int& next,
                           int lane) {
  constexpr int kPerLane = kKeys / 32;
  int n = 0;
  while (n < kKeys && next < P) {
    const int p = next + lane;
    const bool v = p < P && pd[p] < INFINITY;
    const unsigned ball = __ballot_sync(~0u, v);
    const int before = __popc(ball & ((1u << lane) - 1u));
    const int take = min(__popc(ball), kKeys - n);
    if (v && before < take) {
      k.t[n + before] = pd[p];
      k.pi[n + before] = pix[p];
      k.slot[n + before] = p;
    }
    const unsigned left = __ballot_sync(~0u, v && before == take);
    next += left ? __ffs(left) - 1 : 32;
    n += take;
  }
  __syncwarp();
  float mt[kPerLane];
  int mp[kPerLane], ms[kPerLane], rk[kPerLane];
#pragma unroll
  for (int m = 0; m < kPerLane; ++m) {
    const int i = lane + 32 * m;
    mt[m] = i < n ? k.t[i] : 0.0f;
    mp[m] = i < n ? k.pi[i] : 0;
    ms[m] = i < n ? k.slot[i] : 0;
    rk[m] = 0;
  }
  for (int i = 0; i < n; ++i) {
    const float t = k.t[i];
    const int pi = k.pi[i];
#pragma unroll
    for (int m = 0; m < kPerLane; ++m)
      rk[m] += t < mt[m] || (t == mt[m] && (pi < mp[m] || (pi == mp[m] && i < lane + 32 * m)));
  }
  __syncwarp();
#pragma unroll
  for (int m = 0; m < kPerLane; ++m) {
    if (lane + 32 * m < n) {
      k.t[rk[m]] = mt[m];
      k.pi[rk[m]] = mp[m];
      k.slot[rk[m]] = ms[m];
    }
  }
  __syncwarp();
  return n;
}

// The lookup table of the n sorted keys for bucket(., tmin, scale), built
// by the block's threads, kBuckets / kThreads buckets each.
__device__ void build_lut(Keys& k, int n, float tmin, float scale) {
  constexpr int kPer = kBuckets / kThreads;
  const int u0 = kPer * threadIdx.x;
  int p = 0, len = n;  // the first key of bucket >= u0
  while (len > 0) {
    const int half = len >> 1;
    if (bucket(k.t[p + half], tmin, scale) - 1 < u0) {
      p += half + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
#pragma unroll
  for (int u = u0; u < u0 + kPer; ++u) {
    const int lo = p;
    while (p < n && bucket(k.t[p], tmin, scale) - 1 == u) ++p;
    k.lut[u + 1] = make_uint2(__float_as_uint(k.t[min(lo, kKeys - 1)]), lo | (p - lo) << 8);
  }
  if (threadIdx.x == 0) k.lut[0] = make_uint2(0u, 0u);
}

__global__ void __launch_bounds__(kThreads)
    rank_counts_kernel(const float* __restrict__ dist,
                       const float* __restrict__ p_dist,
                       const int* __restrict__ p_idx,
                       const int* __restrict__ q_pids,
                       const int* __restrict__ q_cams,
                       const int* __restrict__ g_pids,
                       const int* __restrict__ g_cams, int Q, int G, int P,
                       int ignore_camera, int* __restrict__ out) {
  __shared__ Keys k;
  __shared__ int s_n;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, q = blockIdx.x;
  const float* pd = p_dist + (size_t)q * P;
  const int* pix = p_idx + (size_t)q * P;
  int* orow = out + (size_t)q * P;

  int n_valid = 0;
  for (int p0 = 0; p0 < P; p0 += kThreads) {
    const int p = p0 + tid;
    const bool v = p < P && pd[p] < INFINITY;
    if (p < P && !v) orow[p] = 0;
    n_valid += __syncthreads_count(v);
  }

  const int qp = q_pids[q], qc = q_cams[q];
  const float* row = dist + (size_t)q * G;
  // row + head is 16-byte aligned; the body is taken kChunk columns at a
  // time, chunk c by warp c % kWarps
  const int head = min(G, (int)(((16u - ((uint32_t)(uintptr_t)row & 15u)) & 15u) >> 2));
  const int n_chunks = (G - head + kChunk - 1) / kChunk;
  int next = 0;  // warp 0's place in the slots

  for (int done = 0; done < n_valid;) {
    if (warp == 0) {
      const int n = gather_keys(k, pd, pix, P, next, lane);
      if (lane == 0) s_n = n;
    }
    __syncthreads();
    const int n = s_n;
    done += n;
    const float tmin = k.t[0], tmax = k.t[n - 1];
    const float range = __fsub_rn(tmax, tmin);
    const float scale = range > 0.0f && range < INFINITY ? __fdiv_rn((float)kBuckets, range)
                                                         : 0.0f;
    build_lut(k, n, tmin, scale);
    for (int i = tid; i <= kKeys; i += kThreads) k.hist[i] = 0;
    __syncthreads();

    // every column at or before the largest key adds 1 to its bin, junk too
    auto count = [&](float d, int j) {
      const uint2 e = k.lut[bucket(d, tmin, scale)];
      const int lo = e.y & 0xff, cnt = e.y >> 8;
      const float t0 = __uint_as_float(e.x);
      // the common case, at most one key in the column's bucket, without a branch
      int b = lo + (cnt >= 1 && (d > t0 || (d == t0 && j >= k.pi[min(lo, kKeys - 1)])));
      if (cnt >= 2) b = bin_of(k, d, j, tmin, scale);
      if (d <= tmax) atomicAdd(&k.hist[b], 1);
    };
    auto load = [&](float4 (&v)[kVec], int ch) {
#pragma unroll
      for (int m = 0; m < kVec; ++m) {
        const int c = head + ch * kChunk + 4 * (lane + 32 * m);
        if (c + 3 < G) {
          v[m] = *reinterpret_cast<const float4*>(row + c);
        } else {
          v[m].x = c < G ? row[c] : INFINITY;
          v[m].y = c + 1 < G ? row[c + 1] : INFINITY;
          v[m].z = c + 2 < G ? row[c + 2] : INFINITY;
          v[m].w = INFINITY;
        }
      }
    };
    // columns past G are +inf, past the largest key: they add nothing
    auto consume = [&](const float4 (&v)[kVec], int ch) {
#pragma unroll
      for (int m = 0; m < kVec; ++m) {
        const int c = head + ch * kChunk + 4 * (lane + 32 * m);
        count(v[m].x, c);
        count(v[m].y, c + 1);
        count(v[m].z, c + 2);
        count(v[m].w, c + 3);
      }
    };
    if (tid < head) count(row[tid], tid);
    float4 a[kVec], b[kVec];
    if (warp < n_chunks) load(a, warp);
    for (int ch = warp; ch < n_chunks; ch += 2 * kWarps) {
      if (ch + kWarps < n_chunks) load(b, ch + kWarps);
      consume(a, ch);
      if (ch + kWarps < n_chunks) {
        if (ch + 2 * kWarps < n_chunks) load(a, ch + 2 * kWarps);
        consume(b, ch + kWarps);
      }
    }

    // take the junk columns (same pid and camid as the query) back out
    if (!ignore_camera) {
      for (int j0 = 0; j0 < G; j0 += kJunkLoads * kThreads) {
        int pid[kJunkLoads];
#pragma unroll
        for (int u = 0; u < kJunkLoads; ++u) {
          const int j = j0 + tid + kThreads * u;
          pid[u] = j < G ? g_pids[j] : 0;
        }
#pragma unroll
        for (int u = 0; u < kJunkLoads; ++u) {
          const int j = j0 + tid + kThreads * u;
          if (j < G && pid[u] == qp && g_cams[j] == qc) {
            const float d = row[j];
            if (d <= tmax) atomicSub(&k.hist[bin_of(k, d, j, tmin, scale)], 1);
          }
        }
      }
    }
    __syncthreads();

    // sorted key b's count: hist[0] + ... + hist[b]
    if (warp == 0) {
      constexpr int kPerLane = kKeys / 32;
      int h[kPerLane], sum = 0;
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) {
        const int bb = kPerLane * lane + u;
        h[u] = bb < n ? k.hist[bb] : 0;
        sum += h[u];
      }
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(~0u, incl, off);
        if (lane >= off) incl += t;
      }
      int run = incl - sum;
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) {
        const int bb = kPerLane * lane + u;
        run += h[u];
        if (bb < n) orow[k.slot[bb]] = run;
      }
    }
    __syncthreads();  // the next pass overwrites the keys
  }
}

}  // namespace

// Launch the counting kernel on `stream`: every (q, p) of `out` (Q, P)
// int32 is written once. Returns cudaGetLastError().
extern "C" int rank_counts(const void* dist, const void* p_dist,
                           const void* p_idx, const void* q_pids,
                           const void* q_cams, const void* g_pids,
                           const void* g_cams, int Q, int G, int P,
                           int ignore_camera, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q > 0 && P > 0) {
    rank_counts_kernel<<<Q, kThreads, 0, s>>>(
        static_cast<const float*>(dist), static_cast<const float*>(p_dist),
        static_cast<const int*>(p_idx), static_cast<const int*>(q_pids),
        static_cast<const int*>(q_cams), static_cast<const int*>(g_pids),
        static_cast<const int*>(g_cams), Q, G, P, ignore_camera,
        static_cast<int*>(out));
  }
  return (int)cudaGetLastError();
}
