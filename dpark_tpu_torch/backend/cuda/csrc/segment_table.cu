// K7 segment_table: the segment table of each shard's key-sorted rows —
// where each run of equal keys starts, how long it is, its power-of-two
// size class, the per-shard histogram of those classes, and the key of
// each run — in one boundary scan.
//
// Replaces dpark_tpu/backend/tpu/collectives.py:501 bucket_index, :515
// _segment_table, :539 segment_spans, :566 segment_sizes and :576
// bucket_histogram (the start-row scatter, the segment_sum of sizes and
// the bincount of size classes).
//
// A row starts a segment when it is valid (row < n[s]) and is row 0 or
// differs from the row before in ANY key column, compared with != in the
// column's type: -0.0 and +0.0 are one key, every NaN its own, as the
// reference's jnp != and the host's dict do.  Segment j of shard s gets
// start_rows[j], sizes[j] and bucket[j] = ceil(log2(size)) computed in
// integers (size 2^k lands in class k, never k+1); past n_seg[s] they
// hold 0, 0 and 32.  hist[s, b] counts the segments of class b.
//
// Bound: bytes.  It reads each key column once (8 B a row for int64)
// and writes start row, size and class (12 B) and each key to every slot
// of the (N, cap) outputs, padding included: at N=8, cap=2^23 and one
// int64 key, 537 MB read and 1.34 GB written, 0.56 ms at 3.35 TB/s.
// Three launches and one scan: per-block boundary
// counts (__syncthreads_count); one exclusive scan per shard over the
// blocks (common.cuh scan_rows_excl), whose total is n_seg; a pass that
// ranks each boundary inside its block (block_excl_scan) and writes its
// row and keys at that rank; a pass over segment ids that takes sizes
// from neighbouring start rows and counts classes in a shared 32-bin
// histogram flushed with one global atomic per bin and block.
#include "common.cuh"

#define DPK_SEG_KEYS 4
#define DPK_SIZE_CLASSES 32

struct SegKeys {
  const char* p[DPK_SEG_KEYS];
  char* out[DPK_SEG_KEYS];    // per-segment keys, or null
  int kind[DPK_SEG_KEYS];     // 0 int32, 1 int64, 2 float64
  int64_t fill[DPK_SEG_KEYS]; // bits stored past n_seg
  int n;
};

__device__ __forceinline__ bool key_differs(const char* p, int kind,
                                            int64_t a, int64_t b) {
  if (kind == 2) return ((const double*)p)[a] != ((const double*)p)[b];
  if (kind == 1) return ((const int64_t*)p)[a] != ((const int64_t*)p)[b];
  return ((const int32_t*)p)[a] != ((const int32_t*)p)[b];
}

__device__ __forceinline__ bool is_start(const SegKeys& K, int64_t base,
                                         int64_t i, int64_t nv) {
  if (i >= nv) return false;
  if (i == 0) return true;
  bool d = false;
#pragma unroll
  for (int c = 0; c < DPK_SEG_KEYS; ++c)
    if (c < K.n) d |= key_differs(K.p[c], K.kind[c], base + i, base + i - 1);
  return d;
}

// each key column's element at row `src` (its fill when src < 0) to
// output slot j
__device__ __forceinline__ void put_keys(const SegKeys& K, int64_t j,
                                         int64_t src) {
#pragma unroll
  for (int c = 0; c < DPK_SEG_KEYS; ++c) {
    if (c >= K.n || K.out[c] == nullptr) continue;
    if (K.kind[c] == 0)
      ((int32_t*)K.out[c])[j] =
          src < 0 ? (int32_t)K.fill[c] : ((const int32_t*)K.p[c])[src];
    else
      ((int64_t*)K.out[c])[j] =
          src < 0 ? K.fill[c] : ((const int64_t*)K.p[c])[src];
  }
}

__device__ __forceinline__ int size_class(int32_t sz) {
  return sz <= 1 ? 0 : 32 - __clz(sz - 1);
}

static __global__ void k7_count(SegKeys K, const int32_t* n, int64_t cap,
                                int nblk, int32_t* blockcnt) {
  const int s = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int c = __syncthreads_count(is_start(K, (int64_t)s * cap, i, n[s]));
  if (threadIdx.x == 0) blockcnt[(int64_t)s * nblk + blockIdx.x] = c;
}

static __global__ void k7_write(SegKeys K, const int32_t* n, int64_t cap,
                                int nblk, const int32_t* blockoff,
                                int32_t* start_rows) {
  __shared__ int sm[32];
  const int s = blockIdx.y;
  const int64_t base = (int64_t)s * cap;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool st = is_start(K, base, i, n[s]);
  int tot;
  const int rank = block_excl_scan(st ? 1 : 0, sm, &tot);
  if (!st) return;
  const int64_t j = base + blockoff[(int64_t)s * nblk + blockIdx.x] + rank;
  start_rows[j] = (int32_t)i;
  put_keys(K, j, base + i);
}

static __global__ void k7_sizes(SegKeys K, const int32_t* n, int64_t cap,
                                const int32_t* n_seg, int32_t* start_rows,
                                int32_t* sizes, int32_t* bucket,
                                int32_t* hist) {
  __shared__ int h_sm[DPK_SIZE_CLASSES];
  const int s = blockIdx.y;
  if (threadIdx.x < DPK_SIZE_CLASSES) h_sm[threadIdx.x] = 0;
  __syncthreads();
  const int64_t base = (int64_t)s * cap;
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t ns = n_seg[s];
  if (j < ns) {
    const int32_t st = start_rows[base + j];
    const int32_t nx = j + 1 < ns ? start_rows[base + j + 1] : n[s];
    const int32_t sz = nx - st;
    const int b = size_class(sz);
    sizes[base + j] = sz;
    bucket[base + j] = b;
    atomicAdd(&h_sm[b], 1);
  } else if (j < cap) {
    start_rows[base + j] = 0;
    sizes[base + j] = 0;
    bucket[base + j] = DPK_SIZE_CLASSES;
    put_keys(K, base + j, -1);
  }
  __syncthreads();
  if (threadIdx.x < DPK_SIZE_CLASSES && h_sm[threadIdx.x])
    atomicAdd(&hist[s * DPK_SIZE_CLASSES + threadIdx.x], h_sm[threadIdx.x]);
}

// keys: nk (N, cap) key columns of kinds[c]; keys_out: per-segment key
// columns (entries may be null), fills their bits past n_seg; n: (N,)
// valid rows.  Outputs (N, cap) int32 start_rows / sizes / bucket, (N,)
// int32 n_seg, (N, 32) int32 hist (zeroed by the caller); blockcnt:
// (N, ceil(cap/1024)) int32 scratch.
extern "C" int dpk_segment_table(const void* const* keys,
                                 void* const* keys_out, const int* kinds,
                                 const int64_t* fills, int nk,
                                 const int32_t* n, int N, int64_t cap,
                                 int32_t* start_rows, int32_t* sizes,
                                 int32_t* bucket, int32_t* n_seg,
                                 int32_t* hist, int32_t* blockcnt,
                                 void* stream) {
  if (nk < 1 || nk > DPK_SEG_KEYS || cap >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nblk = (int)((cap + DPK_THREADS - 1) / DPK_THREADS);
  if (nblk == 0) return (int)cudaGetLastError();
  SegKeys K;
  K.n = nk;
  for (int c = 0; c < DPK_SEG_KEYS; ++c) {
    K.p[c] = c < nk ? (const char*)keys[c] : nullptr;
    K.out[c] = c < nk ? (char*)keys_out[c] : nullptr;
    K.kind[c] = c < nk ? kinds[c] : 0;
    K.fill[c] = c < nk ? fills[c] : 0;
  }
  dim3 grid((unsigned)nblk, (unsigned)N);
  k7_count<<<grid, DPK_THREADS, 0, st>>>(K, n, cap, nblk, blockcnt);
  scan_rows_excl<<<N, DPK_THREADS, 0, st>>>(blockcnt, nblk, n_seg);
  k7_write<<<grid, DPK_THREADS, 0, st>>>(K, n, cap, nblk, blockcnt,
                                         start_rows);
  k7_sizes<<<grid, DPK_THREADS, 0, st>>>(K, n, cap, n_seg, start_rows, sizes,
                                         bucket, hist);
  return (int)cudaGetLastError();
}
