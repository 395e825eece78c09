// K15 column_ranges: B14's masked min/max.  For each of L int64 or int32
// scalar columns of shape (N, cap) and the shard counts n (N,), the min
// and max over each shard's valid prefix [0, n[s]) into out (L, N, 2)
// int64; a shard with no valid row keeps the column dtype's (max, min),
// which the caller writes before the launch.  The rows past n[s] hold the
// padding (the key sentinel on a key column) and are never read.
//
// Replaces dpark_tpu/backend/tpu/executor.py:960 (_compile_minmax, the
// exchange's per-device probe that _narrow_plan reads) and
// dpark_tpu/backend/tpu/layout.py:236 (_masked_minmax, read by the egest
// narrowing and executor._int_col_ranges).  The reference compiles one
// program a column; here all L columns (up to DPK_MAX_LEAVES) go in one
// launch.
//
// Bound: bytes.  Each valid row of each column is read once (8 B or 4 B);
// at 8 x 8,388,608 int64 rows that is 0.54 GB, 0.16 ms at 3.35 TB/s.
// Design: a grid over (chunk, shard, column); a block grid-strides over
// its shard's valid prefix with four independent loads in flight a
// thread, reduces with warp shuffles and then across its warps in shared
// memory, and does one 64-bit atomicMin and one atomicMax into the
// output.  Blocks that start past n[s] exit before loading anything.
#include "common.cuh"

struct ColSet {
  const char* ptr[DPK_MAX_LEAVES];
  int width[DPK_MAX_LEAVES];  // bytes a value: 8 or 4
};

__device__ __forceinline__ void fold(int64_t v, int64_t& lo, int64_t& hi) {
  lo = v < lo ? v : lo;
  hi = v > hi ? v : hi;
}

// lane 0 receives the warp's min of lo and max of hi
__device__ __forceinline__ void warp_minmax(int64_t& lo, int64_t& hi) {
  for (int d = 16; d > 0; d >>= 1) {
    const int64_t l2 = __shfl_down_sync(DPK_FULL, lo, d);
    const int64_t h2 = __shfl_down_sync(DPK_FULL, hi, d);
    lo = l2 < lo ? l2 : lo;
    hi = h2 > hi ? h2 : hi;
  }
}

static __global__ void k15_kernel(const ColSet cols, const int32_t* n,
                                  int64_t cap, int N, int64_t* out) {
  const int s = blockIdx.y, l = blockIdx.z;
  int64_t nv = n[s];
  if (nv > cap) nv = cap;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if ((int64_t)blockIdx.x * blockDim.x >= nv) return;  // uniform a block
  const int w = cols.width[l];
  const char* p = cols.ptr[l];
  const int64_t base = (int64_t)s * cap;
  int64_t lo = w == 8 ? INT64_MAX : (int64_t)INT32_MAX;
  int64_t hi = w == 8 ? INT64_MIN : (int64_t)INT32_MIN;
  for (; i + 3 * stride < nv; i += 4 * stride) {
    const int64_t a = load_key(p, w, base + i);
    const int64_t b = load_key(p, w, base + i + stride);
    const int64_t c = load_key(p, w, base + i + 2 * stride);
    const int64_t d = load_key(p, w, base + i + 3 * stride);
    fold(a, lo, hi);
    fold(b, lo, hi);
    fold(c, lo, hi);
    fold(d, lo, hi);
  }
  for (; i < nv; i += stride) fold(load_key(p, w, base + i), lo, hi);
  // lo and hi reduce apart: a lane with no row holds the identities,
  // and its lo must never reach another lane's hi
  warp_minmax(lo, hi);
  __shared__ int64_t s_lo[32], s_hi[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    if (lane < nw) {
      lo = s_lo[lane];
      hi = s_hi[lane];
    }
    warp_minmax(lo, hi);
    if (lane == 0) {
      long long* o = (long long*)out + ((int64_t)l * N + s) * 2;
      atomicMin(o, (long long)lo);
      atomicMax(o + 1, (long long)hi);
    }
  }
}

// cols: L column pointers, widths (8 or 4 bytes); n: (N,) valid rows;
// out: (L, N, 2) int64, initialised by the caller to each column dtype's
// (max, min).  L <= DPK_MAX_LEAVES.
extern "C" int dpk_column_ranges(const void* const* cols, const int* widths,
                                 int L, const int32_t* n, int N, int64_t cap,
                                 int64_t* out, void* stream) {
  if (L < 1 || L > DPK_MAX_LEAVES || N < 1 || N > 65535)
    return (int)cudaErrorInvalidValue;
  if (cap == 0) return (int)cudaGetLastError();
  ColSet cs;
  for (int k = 0; k < DPK_MAX_LEAVES; ++k) {
    cs.ptr[k] = k < L ? (const char*)cols[k] : nullptr;
    cs.width[k] = k < L ? widths[k] : 8;
    if (k < L && widths[k] != 8 && widths[k] != 4)
      return (int)cudaErrorInvalidValue;
  }
  const int threads = 256;
  int64_t gx = (cap + threads * 8 - 1) / (threads * 8);
  int64_t most = 4096 / ((int64_t)N * L);
  if (most < 1) most = 1;
  if (gx > most) gx = most;
  dim3 grid((unsigned)gx, (unsigned)N, (unsigned)L);
  k15_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(cs, n, cap, N, out);
  return (int)cudaGetLastError();
}
