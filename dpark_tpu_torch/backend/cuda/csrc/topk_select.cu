// K18 topk_select: the per-shard top-n of a result batch.  Each shard's
// min(n, count) best valid rows in order, best first, by (key image, row):
// the key's order-preserving image (K5's image_bits, csrc/radix_sort.cu:
// -0.0 ties +0.0, every NaN is one NaN and sorts last), lexicographic
// over one or two key columns, ties by row index ascending.  Largest-
// first inverts every image but a NaN's, so NaN stays last both ways
// (the order of an ascending sort of -1-k for ints and -k for floats).
// Then the kept rows of every leaf are gathered.
//
// Replaces the pre-top of dpark_tpu/backend/tpu/executor.py:1746
// (_device_topk: one stable lexicographic sort of every row by
// (invalid flag, order key), then a slice of n rows), which the port ran
// as K5 over the reversed key and K2 by validity.
//
// Bound: bytes.  The key column(s) of the valid rows are read once, the
// kept rows of every leaf written once (and read once by the gather).
// Design (the k-selection of Johnson, Douze and Jegou, "Billion-scale
// similarity search with GPUs", 2017, with the queue in shared memory):
// 1. k18_tiles: one block a tile of K18_TILE rows of one shard.  Each
//    warp reads its rows with 16-byte loads (8 for int32: two rows a
//    lane), images them, and tests each against the block's threshold
//    (the n-th best (image, row) kept so far): a row that cannot enter
//    costs one compare.  Rows that pass go to a shared candidate buffer
//    (one atomic a warp).  Once it holds n rows with no threshold set, or
//    when it cannot take another chunk, a bitonic sort keeps its n best
//    and raises the threshold.  A tile is large (128 chunks) so that the
//    sorts, which cost the SM's instructions while the loads wait, stay
//    few a row.  The chunks
//    of a tile are read in bit-reversed order, each chunk one segment of
//    every 8192-row line of the tile, so that a tile sorted either way
//    (a sorted shard, a sawtooth of ascending runs) finds its best rows
//    in the first chunks and later chunks pass few rows.  Each warp
//    fetches the next chunk's rows before it tests this chunk's, so that
//    the loads overlap the tests and the barriers; a chunk that pushed
//    nothing costs one barrier.  The buffer holds the
//    second key's images only for two key columns (24 KB a block for
//    one, 40 KB for two).  The tile's n best, sorted, are its candidates.
// 2. k18_merge: one block a shard runs the same buffer over the shard's
//    tiles' candidates and writes the kept rows' indices.
// 3. k18_gather: one block a shard copies the kept rows of every leaf
//    (padding rows past min(n, count) are zero).
// Sorted input costs more flushes than random input; the result does not
// depend on the order the rows pass (the order is total: the row breaks
// every tie).
#include "common.cuh"

#define K18_THREADS 256
#define K18_SEG 64                 // rows a warp reads at once: 2 a lane
#define K18_SEGS 2                 // segments a warp reads a chunk
#define K18_CHUNK (K18_THREADS / 32 * K18_SEGS * K18_SEG)   // 1024 rows
#define K18_CHUNK_BITS 7
#define K18_CHUNKS (1 << K18_CHUNK_BITS)                    // chunks a tile
#define K18_TILE (K18_CHUNK * K18_CHUNKS)                   // 131072 rows
#define K18_MAX_N 1024
#define K18_BUF 2048               // >= K18_MAX_N + a chunk of either pass
#define K18_MERGE_THREADS 1024
#define K18_NONE 0x7fffffff        // the row of an empty candidate

// the order-preserving unsigned image of raw key bits (kind: 0 int32, 1
// int64, 2 float64), inverted for largest-first except a NaN's
__device__ __forceinline__ uint64_t k18_image(uint64_t b, int kind,
                                              int largest) {
  uint64_t img;
  bool nan = false;
  if (kind == 0) {
    img = (uint64_t)((uint32_t)b ^ 0x80000000u);
  } else if (kind == 1) {
    img = b ^ 0x8000000000000000ull;
  } else {
    const double x = __longlong_as_double((long long)b);
    if (x == 0.0) {
      b = 0;                      // -0.0 and +0.0 tie
    } else if (x != x) {
      b = 0x7FF8000000000000ull;  // every NaN: one positive quiet NaN
      nan = true;
    }
    img = (b >> 63) ? ~b : (b | 0x8000000000000000ull);
  }
  return (largest && !nan) ? ~img : img;
}

__device__ __forceinline__ bool k18_less(uint64_t a0, uint64_t a1, int ar,
                                         uint64_t b0, uint64_t b1, int br) {
  return a0 < b0 || (a0 == b0 && (a1 < b1 || (a1 == b1 && ar < br)));
}

// rows i and i + 1 of a key column (the second only when `both`); `vec`:
// one 16-byte (8-byte for int32) load, the caller having checked the
// alignment
__device__ __forceinline__ void k18_load2(const char* p, int kind, int64_t i,
                                          bool vec, bool both, uint64_t& a,
                                          uint64_t& b) {
  if (kind == 0) {
    const uint32_t* q = (const uint32_t*)p + i;
    if (vec && both) {
      const uint2 v = *(const uint2*)q;
      a = v.x;
      b = v.y;
    } else {
      a = q[0];
      b = both ? q[1] : 0;
    }
  } else {
    const unsigned long long* q = (const unsigned long long*)p + i;
    if (vec && both) {
      const ulonglong2 v = *(const ulonglong2*)q;
      a = v.x;
      b = v.y;
    } else {
      a = q[0];
      b = both ? q[1] : 0;
    }
  }
}

struct K18Keys {
  const char* col[2];
  int kind[2];
};

// the candidate buffer and its threshold: a candidate must be less than
// (t0, t1, trow) to matter (all ones and K18_NONE: anything enters).  The
// second key's images only with two key columns (NK = 2): with one, the
// buffer is 24 KB, not 40, and more blocks fit an SM.
template <int NK>
struct K18Buf {
  unsigned long long k0[K18_BUF];
  unsigned long long k1[NK > 1 ? K18_BUF : 1];
  int row[K18_BUF];
  unsigned long long t0, t1;
  int trow, count;
  __device__ __forceinline__ unsigned long long key1(int i) const {
    return NK > 1 ? k1[i] : 0ull;
  }
  __device__ __forceinline__ void set1(int i, unsigned long long v) {
    if (NK > 1) k1[i] = v;
  }
};

template <int NK>
__device__ __forceinline__ void k18_init(K18Buf<NK>& B) {
  if (threadIdx.x == 0) {
    B.count = 0;
    B.t0 = B.t1 = ~0ull;
    B.trow = K18_NONE;
  }
  __syncthreads();
}

// append this lane's candidate when `want`; every lane of the warp calls
template <int NK>
__device__ __forceinline__ void k18_push(K18Buf<NK>& B, bool want,
                                         uint64_t a, uint64_t b, int row) {
  const unsigned m = __ballot_sync(DPK_FULL, want);
  if (m == 0) return;
  const int lane = threadIdx.x & 31, leader = __ffs(m) - 1;
  int at = 0;
  if (lane == leader) at = atomicAdd(&B.count, __popc(m));
  at = __shfl_sync(DPK_FULL, at, leader);
  if (want) {
    at += __popc(m & ((1u << lane) - 1u));
    B.k0[at] = a;
    B.set1(at, b);
    B.row[at] = row;
  }
}

// Sort the buffer (bitonic, over the next power of two of its count),
// keep its n best and raise the threshold once n are kept.  Every thread
// of the block calls it, after a barrier that ends the pushes.
template <int NK>
__device__ void k18_flush(K18Buf<NK>& B, int n) {
  const int c = B.count;
  int L = 1;
  while (L < c) L <<= 1;
  for (int i = c + threadIdx.x; i < L; i += blockDim.x) {
    B.k0[i] = ~0ull;
    B.set1(i, ~0ull);
    B.row[i] = K18_NONE;
  }
  __syncthreads();
  for (int k = 2; k <= L; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < L; i += blockDim.x) {
        const int q = i ^ j;
        if (q > i) {
          const unsigned long long q0 = B.k0[q], q1 = B.key1(q);
          const unsigned long long i0 = B.k0[i], i1 = B.key1(i);
          const int qr = B.row[q], ir = B.row[i];
          // ascending where (i & k) == 0: swap when q's entry is less
          if (k18_less(q0, q1, qr, i0, i1, ir) == ((i & k) == 0)) {
            B.k0[i] = q0;
            B.set1(i, q1);
            B.row[i] = qr;
            B.k0[q] = i0;
            B.set1(q, i1);
            B.row[q] = ir;
          }
        }
      }
      __syncthreads();
    }
  }
  if (threadIdx.x == 0) {
    const int keep = c < n ? c : n;
    B.count = keep;
    if (keep == n) {
      B.t0 = B.k0[n - 1];
      B.t1 = B.key1(n - 1);
      B.trow = B.row[n - 1];
    }
  }
  __syncthreads();
}

// after a chunk's pushes (`pushed`: this thread pushed a row): flush when
// the buffer cannot take `chunk` more, or as soon as it holds n
// candidates and no threshold is set yet (one sort of the first chunk,
// not of two).  A chunk that pushed nothing leaves the buffer as it was:
// one barrier.
template <int NK>
__device__ __forceinline__ void k18_settle(K18Buf<NK>& B, int n, int chunk,
                                           bool pushed) {
  if (!__syncthreads_or(pushed)) return;
  const int c = B.count;
  const bool unset = B.trow == K18_NONE;
  __syncthreads();
  if (c > K18_BUF - chunk || (unset && c >= n)) k18_flush(B, n);
}

// rows r, r + 1 of a chunk segment, raw, of every key column
template <int NK>
__device__ __forceinline__ void k18_fetch(const K18Keys& K, int64_t at,
                                          bool vec, bool v0, bool v1,
                                          uint64_t* x) {
  x[0] = x[1] = x[2] = x[3] = 0;
  if (v0) {
    k18_load2(K.col[0], K.kind[0], at, vec, v1, x[0], x[1]);
    if (NK > 1) k18_load2(K.col[1], K.kind[1], at, vec, v1, x[2], x[3]);
  }
}

// Pass 1: grid (tiles, N).  A tile's n best (image, row) sorted, padded
// with (all ones, K18_NONE), at (s, tile) of the candidate arrays.
template <int NK>
static __global__ void __launch_bounds__(K18_THREADS)
    k18_tiles(K18Keys K, const int* __restrict__ counts, int64_t cap, int n,
              int largest, int vec, int64_t tiles,
              unsigned long long* __restrict__ c0,
              unsigned long long* __restrict__ c1, int* __restrict__ crow) {
  __shared__ K18Buf<NK> B;
  const int s = blockIdx.y;
  const int64_t cnt = counts[s];
  const int64_t t0 = (int64_t)blockIdx.x * K18_TILE;
  if (t0 >= cnt) return;  // k18_merge reads only tiles holding rows
  k18_init(B);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t base = (int64_t)s * cap;
  // chunk k reads segment bitrev(k) of each line of K18_CHUNKS segments
  auto row_of = [&](int k, int j) -> int64_t {
    const int off = (int)(__brev((unsigned)k) >> (32 - K18_CHUNK_BITS));
    return t0 + ((int64_t)(warp * K18_SEGS + j) * K18_CHUNKS + off) *
                    K18_SEG + lane * 2;
  };
  // the next chunk in flight while this one is tested
  uint64_t nxt[K18_SEGS][4];
#pragma unroll
  for (int j = 0; j < K18_SEGS; ++j) {
    const int64_t r = row_of(0, j);
    k18_fetch<NK>(K, base + r, vec, r < cnt, r + 1 < cnt, nxt[j]);
  }
  for (int k = 0; k < K18_CHUNKS; ++k) {
    uint64_t cur[K18_SEGS][4];
#pragma unroll
    for (int j = 0; j < K18_SEGS; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) cur[j][q] = nxt[j][q];
    if (k + 1 < K18_CHUNKS) {
#pragma unroll
      for (int j = 0; j < K18_SEGS; ++j) {
        const int64_t r = row_of(k + 1, j);
        k18_fetch<NK>(K, base + r, vec, r < cnt, r + 1 < cnt, nxt[j]);
      }
    }
    const uint64_t T0 = B.t0, T1 = B.t1;
    const int TR = B.trow;
    bool pushed = false;
#pragma unroll
    for (int j = 0; j < K18_SEGS; ++j) {
      const int64_t r = row_of(k, j);
      const bool v0 = r < cnt, v1 = r + 1 < cnt;
      const uint64_t a0 = k18_image(cur[j][0], K.kind[0], largest);
      const uint64_t a1 = k18_image(cur[j][1], K.kind[0], largest);
      const uint64_t b0 = NK > 1 ? k18_image(cur[j][2], K.kind[1], largest)
                                 : 0;
      const uint64_t b1 = NK > 1 ? k18_image(cur[j][3], K.kind[1], largest)
                                 : 0;
      const bool w0 = v0 && k18_less(a0, b0, (int)r, T0, T1, TR);
      const bool w1 = v1 && k18_less(a1, b1, (int)r + 1, T0, T1, TR);
      k18_push(B, w0, a0, b0, (int)r);
      k18_push(B, w1, a1, b1, (int)r + 1);
      pushed = pushed || w0 || w1;
    }
    k18_settle(B, n, K18_CHUNK, pushed);
  }
  k18_flush(B, n);
  const int64_t at = ((int64_t)s * tiles + blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool has = i < B.count;
    c0[at + i] = has ? B.k0[i] : ~0ull;
    if (NK > 1) c1[at + i] = has ? B.key1(i) : ~0ull;
    crow[at + i] = has ? B.row[i] : K18_NONE;
  }
}

// Pass 2: one block a shard.  The shard's n best over its tiles'
// candidates; rows[s, i] for i < min(n, count), best first.
template <int NK>
static __global__ void __launch_bounds__(K18_MERGE_THREADS)
    k18_merge(const int* __restrict__ counts, int n, int64_t tiles,
              const unsigned long long* __restrict__ c0,
              const unsigned long long* __restrict__ c1,
              const int* __restrict__ crow, int* __restrict__ rows) {
  __shared__ K18Buf<NK> B;
  const int s = blockIdx.x;
  const int64_t cnt = counts[s];
  const int64_t total = (cnt + K18_TILE - 1) / K18_TILE * n;
  const int64_t at = (int64_t)s * tiles * n;
  k18_init(B);
  for (int64_t q0 = 0; q0 < total; q0 += blockDim.x) {
    const uint64_t T0 = B.t0, T1 = B.t1;
    const int TR = B.trow;
    const int64_t q = q0 + threadIdx.x;
    uint64_t a = 0, b = 0;
    int r = K18_NONE;
    if (q < total) {
      r = crow[at + q];
      a = c0[at + q];
      b = NK > 1 ? c1[at + q] : 0;
    }
    const bool want = r != K18_NONE && k18_less(a, b, r, T0, T1, TR);
    k18_push(B, want, a, b, r);
    k18_settle(B, n, blockDim.x, want);
  }
  k18_flush(B, n);
  const int m = cnt < n ? (int)cnt : n;
  for (int i = threadIdx.x; i < m; i += blockDim.x)
    rows[(int64_t)s * n + i] = B.row[i];
}

// Pass 3: one block a shard copies the kept rows of a group of leaves
static __global__ void k18_gather(const int* __restrict__ rows,
                                  const int* __restrict__ counts, int n,
                                  int64_t cap, LeafSet L) {
  const int s = blockIdx.x;
  const int m = counts[s] < n ? counts[s] : n;
  for (int idx = threadIdx.x; idx < L.n * n; idx += blockDim.x) {
    const int leaf = idx / n, j = idx - leaf * n;
    const int64_t b = L.bytes[leaf];
    char* dst = L.dst[leaf] + ((int64_t)s * n + j) * b;
    if (j < m)
      copy_row(L.src[leaf] + ((int64_t)s * cap + rows[(int64_t)s * n + j]) * b,
               dst, b);
    else
      zero_row(dst, b);
  }
}

// keys: nk (1 or 2) (N, cap) key columns of kinds (0 int32, 1 int64, 2
// float64); counts: (N,) valid rows; n in [1, K18_MAX_N], at most cap;
// vec: every key column 16-byte aligned and cap even.  cand0 / cand1 /
// crow: (N, ceil(cap / K18_TILE), n) scratch (cand1 only for nk = 2);
// rows: (N, n) int32 scratch.  src / dst / bytes: the leaves (N, cap,
// ...) and their (N, n, ...) outputs, row bytes each.
extern "C" int dpk_topk_select(const void* const* keys, const int* kinds,
                               int nk, const int* counts, int N,
                               long long cap, int n, int largest, int vec,
                               unsigned long long* cand0,
                               unsigned long long* cand1, int* crow,
                               int* rows, const void* const* src,
                               void* const* dst, const long long* bytes,
                               int nleaves, void* stream) {
  if (nk < 1 || nk > 2 || N < 1 || N > 65535 || n < 1 || n > K18_MAX_N ||
      n > cap || cap >= K18_NONE || nleaves < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  K18Keys K;
  for (int i = 0; i < 2; ++i) {
    K.col[i] = i < nk ? (const char*)keys[i] : nullptr;
    K.kind[i] = i < nk ? kinds[i] : 0;
    if (K.kind[i] < 0 || K.kind[i] > 2) return (int)cudaErrorInvalidValue;
  }
  const int64_t tiles = (cap + K18_TILE - 1) / K18_TILE;
  const dim3 grid((unsigned)tiles, (unsigned)N);
  // the largest shared-memory carveout: the buffer bounds the blocks an
  // SM holds
  cudaError_t err;
  if (nk > 1) {
    err = cudaFuncSetAttribute(k18_tiles<2>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
    if (err != cudaSuccess) return (int)err;
    k18_tiles<2><<<grid, K18_THREADS, 0, st>>>(K, counts, cap, n, largest,
                                               vec, tiles, cand0, cand1,
                                               crow);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    k18_merge<2><<<N, K18_MERGE_THREADS, 0, st>>>(counts, n, tiles, cand0,
                                                  cand1, crow, rows);
  } else {
    err = cudaFuncSetAttribute(k18_tiles<1>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
    if (err != cudaSuccess) return (int)err;
    k18_tiles<1><<<grid, K18_THREADS, 0, st>>>(K, counts, cap, n, largest,
                                               vec, tiles, cand0, cand1,
                                               crow);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    k18_merge<1><<<N, K18_MERGE_THREADS, 0, st>>>(counts, n, tiles, cand0,
                                                  cand1, crow, rows);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int g = 0; g < nleaves; g += DPK_MAX_LEAVES) {
    const int m = nleaves - g < DPK_MAX_LEAVES ? nleaves - g : DPK_MAX_LEAVES;
    const LeafSet L =
        make_leafset(src + g, dst + g, (const int64_t*)bytes + g, m);
    k18_gather<<<N, 256, 0, st>>>(rows, counts, n, cap, L);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
