// K6 range_dst_hist: range-partitioner destination -> per-shard
// histogram, in one pass over the key columns.
//
// Replaces dpark_tpu/backend/tpu/collectives.py:58 range_dst, :78
// lex_searchsorted and :103 range_dst_cols (the destination of a
// sortByKey / partitionBy(RangePartitioner) shuffle write), and the
// destination bincount of bucketize (:191).
//
// Per valid row: idx = bisect_left of the key row (nk <= 4 columns of one
// dtype, compared lexicographically like Python tuples) into the sorted
// bounds, by the reference's fixed-step binary search (bit_length(m)
// steps of a row-wise lexicographic compare); dst = idx (ascending) or
// r - 1 - idx (descending).  Padding rows go to n_dst.  m == 0 gives
// dst = 0 (or r - 1).
//
// Bound: bytes.  It reads 8 B per key column and writes 4 B a row; at
// N=8, cap=2^23, nk=1 that is 0.81 GB, 0.24 ms at 3.35 TB/s.  Design: the
// bounds (at most a few rows: r <= N) sit in shared memory, so the search
// costs no device-memory traffic; the histogram is reduced per block in
// shared memory (one atomic per warp and bucket, via __match_any_sync)
// and flushed with one global atomic per bucket per block, as in K1.
#include "common.cuh"

#define K6_MAX_KEYS 4

struct RangeKeys {
  const char* p[K6_MAX_KEYS];
  int n;
};

template <typename T>
static __global__ void k6_kernel(RangeKeys K, const T* bounds, int m,
                                 int steps, int ascending, int r, int n_dst,
                                 const int32_t* n, int64_t cap, int32_t* dst,
                                 int32_t* hist) {
  extern __shared__ int64_t k6_sm[];
  T* bsm = (T*)k6_sm;                           // m * nk bounds, row-major
  int* hsm = (int*)(k6_sm + (int64_t)m * K.n);  // n_dst + 1 counters
  const int s = blockIdx.y;
  for (int k = threadIdx.x; k < m * K.n; k += blockDim.x) bsm[k] = bounds[k];
  for (int k = threadIdx.x; k <= n_dst; k += blockDim.x) hsm[k] = 0;
  __syncthreads();
  const int64_t nv = n[s];
  const int64_t base = (int64_t)s * cap;
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i0 = (int64_t)blockIdx.x * blockDim.x; i0 < cap;
       i0 += stride) {
    const int64_t i = i0 + threadIdx.x;
    const bool live = i < cap;
    const unsigned act = __ballot_sync(DPK_FULL, live);
    if (!live) continue;
    int d = n_dst;
    if (i < nv) {
      T q[K6_MAX_KEYS];
      for (int c = 0; c < K.n; ++c) q[c] = ((const T*)K.p[c])[base + i];
      int lo = 0, hi = m;
      for (int st = 0; st < steps; ++st) {
        const bool active = lo < hi;
        const int mid = (lo + hi) >> 1;
        const int safe = mid < m - 1 ? mid : m - 1;
        bool lt = false, eq = true;  // bounds[safe] < q, lexicographically
        for (int c = 0; c < K.n; ++c) {
          const T a = bsm[safe * K.n + c];
          lt = lt || (eq && a < q[c]);
          eq = eq && (a == q[c]);
        }
        if (active && lt) lo = mid + 1;
        if (active && !lt) hi = mid;
      }
      d = ascending ? lo : r - 1 - lo;
    }
    dst[base + i] = d;
    const unsigned peers = __match_any_sync(act, d);
    if (lane == __ffs(peers) - 1) atomicAdd(&hsm[d], __popc(peers));
  }
  __syncthreads();
  for (int k = threadIdx.x; k <= n_dst; k += blockDim.x)
    if (hsm[k]) atomicAdd(&hist[(int64_t)s * (n_dst + 1) + k], hsm[k]);
}

// keys: nk pointers to (N, cap) columns of one dtype (kind 1 = int64,
// 2 = float64); bounds: (m, nk) of that dtype, sorted; n: (N,) valid rows;
// dst: (N, cap) int32 out; hist: (N, n_dst + 1) int32 zeroed by the caller.
extern "C" int dpk_range_dst_hist(const void* const* keys, int nk, int kind,
                                  const void* bounds, int m, int ascending,
                                  int r, int n_dst, const int32_t* n, int N,
                                  int64_t cap, int32_t* dst, int32_t* hist,
                                  void* stream) {
  if (nk < 1 || nk > K6_MAX_KEYS || m < 0 || N < 1 || n_dst < 1 ||
      (kind != 1 && kind != 2))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)m * nk * 8 + (size_t)(n_dst + 1) * 4;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  RangeKeys K;
  K.n = nk;
  for (int c = 0; c < K6_MAX_KEYS; ++c)
    K.p[c] = c < nk ? (const char*)keys[c] : nullptr;
  int steps = 0;
  for (int x = m; x > 0; x >>= 1) ++steps;  // m.bit_length()
  int64_t blocks = (cap + DPK_THREADS - 1) / DPK_THREADS;
  if (blocks > 1024) blocks = 1024;
  if (blocks < 1) blocks = 1;
  dim3 grid((unsigned)blocks, (unsigned)N);
  cudaStream_t st = (cudaStream_t)stream;
  if (kind == 1)
    k6_kernel<long long><<<grid, DPK_THREADS, smem, st>>>(
        K, (const long long*)bounds, m, steps, ascending, r, n_dst, n, cap,
        dst, hist);
  else
    k6_kernel<double><<<grid, DPK_THREADS, smem, st>>>(
        K, (const double*)bounds, m, steps, ascending, r, n_dst, n, cap, dst,
        hist);
  return (int)cudaGetLastError();
}
