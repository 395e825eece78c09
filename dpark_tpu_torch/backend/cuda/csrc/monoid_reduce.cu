// K17 monoid_reduce: B9, the masked per-shard monoid reductions.
//
// Replaces dpark_tpu/backend/tpu/executor.py:1799 (_monoid_reduce: the
// reduce action's per-device reduction with its min and max, which bound
// the integer add's overflow), :1827 (_distinct_key_counts: a bare
// groupByKey().count() over key-sorted rows), and the Pregel reductions
// of dpark_tpu/backend/tpu/bagel.py:41-56, 341-352, 390 (the aggregator
// and the active count) and bagel_obj.py:887 (the object Bagel's active
// count).  The reference masks each device's column with jnp.where and
// reduces three times; the plain PyTorch version does the same, about six
// passes over the column.
//
// monoid_reduce: for each shard s of an (N, cap, ...) column, over its
// first n[s] rows and every trailing lane, the monoid's reduction (add,
// min, max or mul) together with the min and the max.  Empty shards give
// the identities.  Types: int64, int32, bool (uint8; an add is a count),
// float64, float32.  Integers and bools accumulate in int64 (wrapping, as
// torch's int64 sum does), floats in double; min and max propagate NaN,
// as torch.amin and torch.amax do.  The reduction comes out as int64 for
// an integer or bool add or mul and in the column's type otherwise; the
// min and max in the column's type.
//
// Bound: bytes.  Each valid element is read once, the rows past n[s]
// never: at 8 x 8,388,608 int64 that is 537 MB, 0.160 ms at 3.35 TB/s.
// Design: a grid of (block, shard); a block grid-strides over its shard's
// valid elements with 16-byte loads, four in flight a thread, the
// unaligned head and tail elements on block 0; a warp-shuffle reduction
// and one across the block's warps write one partial (reduction, min,
// max) a block to an (N, blocks) scratch.  A second kernel, a warp a
// shard, folds the partials in a fixed order, so that a float sum is the
// same from run to run.  Validity comes from n on the device: no host
// read.
//
// distinct_key_counts: for each shard, the rows j < n[s] whose nk key
// columns differ from row j - 1 (row 0 counts): the distinct keys of a
// key-sorted shard.  Keys are int64, int32, float64 or float32 (compared
// as values: NaN differs from everything, -0.0 equals 0.0, as torch's !=).
// Bound: bytes (each valid key element read once; row j - 1 comes from
// the cache).  A grid-stride count a thread, a block reduction, one
// integer atomicAdd a block (order-free: the count is exact).
#include "common.cuh"

#include <math.h>

#include <type_traits>

enum { K17_ADD = 0, K17_MIN = 1, K17_MAX = 2, K17_MUL = 3 };
enum { K17_I64 = 0, K17_I32 = 1, K17_BOOL = 2, K17_F64 = 3, K17_F32 = 4 };

template <typename T> struct Acc { typedef int64_t type; };
template <> struct Acc<double> { typedef double type; };
template <> struct Acc<float> { typedef double type; };

template <typename T> __device__ __forceinline__ T type_max();
template <typename T> __device__ __forceinline__ T type_min();
template <> __device__ __forceinline__ int64_t type_max<int64_t>() {
  return INT64_MAX;
}
template <> __device__ __forceinline__ int64_t type_min<int64_t>() {
  return INT64_MIN;
}
template <> __device__ __forceinline__ int32_t type_max<int32_t>() {
  return INT32_MAX;
}
template <> __device__ __forceinline__ int32_t type_min<int32_t>() {
  return INT32_MIN;
}
template <> __device__ __forceinline__ uint8_t type_max<uint8_t>() {
  return 1;
}
template <> __device__ __forceinline__ uint8_t type_min<uint8_t>() {
  return 0;
}
template <> __device__ __forceinline__ double type_max<double>() {
  return HUGE_VAL;
}
template <> __device__ __forceinline__ double type_min<double>() {
  return -HUGE_VAL;
}
template <> __device__ __forceinline__ float type_max<float>() {
  return HUGE_VALF;
}
template <> __device__ __forceinline__ float type_min<float>() {
  return -HUGE_VALF;
}

// min and max that keep a NaN once one is seen (torch.amin / amax)
__device__ __forceinline__ int64_t lo_of(int64_t a, int64_t b) {
  return b < a ? b : a;
}
__device__ __forceinline__ int64_t hi_of(int64_t a, int64_t b) {
  return b > a ? b : a;
}
__device__ __forceinline__ double lo_of(double a, double b) {
  return (b < a || b != b) ? b : a;
}
__device__ __forceinline__ double hi_of(double a, double b) {
  return (b > a || b != b) ? b : a;
}

__device__ __forceinline__ int64_t combine(int op, int64_t a, int64_t b) {
  switch (op) {
    case K17_ADD: return (int64_t)((uint64_t)a + (uint64_t)b);
    case K17_MUL: return (int64_t)((uint64_t)a * (uint64_t)b);
    case K17_MIN: return lo_of(a, b);
    default: return hi_of(a, b);
  }
}
__device__ __forceinline__ double combine(int op, double a, double b) {
  switch (op) {
    case K17_ADD: return a + b;
    case K17_MUL: return a * b;
    case K17_MIN: return lo_of(a, b);
    default: return hi_of(a, b);
  }
}

template <typename A> struct Part {
  A red, lo, hi;
};

template <typename T, typename A>
__device__ __forceinline__ Part<A> identity_part(int op) {
  Part<A> p;
  p.red = op == K17_ADD ? (A)0
          : op == K17_MUL ? (A)1
          : op == K17_MIN ? (A)type_max<T>()
                          : (A)type_min<T>();
  p.lo = (A)type_max<T>();
  p.hi = (A)type_min<T>();
  return p;
}

template <typename A>
__device__ __forceinline__ void fold(int op, Part<A>& p, A x) {
  p.red = combine(op, p.red, x);
  p.lo = lo_of(p.lo, x);
  p.hi = hi_of(p.hi, x);
}

template <typename A>
__device__ __forceinline__ void merge(int op, Part<A>& p, const Part<A>& q) {
  p.red = combine(op, p.red, q.red);
  p.lo = lo_of(p.lo, q.lo);
  p.hi = hi_of(p.hi, q.hi);
}

template <typename A>
__device__ __forceinline__ Part<A> shfl_down(const Part<A>& p, int d) {
  Part<A> q;
  q.red = __shfl_down_sync(DPK_FULL, p.red, d);
  q.lo = __shfl_down_sync(DPK_FULL, p.lo, d);
  q.hi = __shfl_down_sync(DPK_FULL, p.hi, d);
  return q;
}

// lane 0 receives the warp's fold, in a fixed tree order
template <typename A>
__device__ __forceinline__ void warp_fold(int op, Part<A>& p) {
  for (int d = 16; d > 0; d >>= 1) {
    const Part<A> q = shfl_down(p, d);
    merge(op, p, q);
  }
}

template <typename T, int V> union Vec16 {
  uint4 raw;
  T v[V];
};

// One partial (reduction, min, max) a block over its share of shard s's
// valid elements: vectors v = b * threads + t, stepping by the grid.
template <typename T>
static __global__ void k17_partial(const T* col, const int32_t* n,
                                   int64_t cap, int64_t lanes, int op,
                                   Part<typename Acc<T>::type>* scratch) {
  typedef typename Acc<T>::type A;
  constexpr int V = 16 / sizeof(T);
  const int s = blockIdx.y, b = blockIdx.x, nb = gridDim.x;
  int64_t rows = n[s];
  if (rows > cap) rows = cap;
  if (rows < 0) rows = 0;
  const int64_t m = rows * lanes;
  const T* p = col + (int64_t)s * cap * lanes;
  // elements before the first 16-byte boundary, the vectors, the tail
  int64_t head = (int64_t)(((16 - ((uintptr_t)p & 15)) & 15) / sizeof(T));
  if (head > m) head = m;
  const int64_t nvec = (m - head) / V;
  const int64_t tail0 = head + nvec * V;
  const uint4* vp = (const uint4*)(p + head);
  Part<A> acc = identity_part<T, A>(op);
  const int64_t step = (int64_t)nb * blockDim.x;
  int64_t i = (int64_t)b * blockDim.x + threadIdx.x;
  for (; i + 3 * step < nvec; i += 4 * step) {
    Vec16<T, V> x0, x1, x2, x3;
    x0.raw = __ldg(vp + i);
    x1.raw = __ldg(vp + i + step);
    x2.raw = __ldg(vp + i + 2 * step);
    x3.raw = __ldg(vp + i + 3 * step);
#pragma unroll
    for (int k = 0; k < V; ++k) fold(op, acc, (A)x0.v[k]);
#pragma unroll
    for (int k = 0; k < V; ++k) fold(op, acc, (A)x1.v[k]);
#pragma unroll
    for (int k = 0; k < V; ++k) fold(op, acc, (A)x2.v[k]);
#pragma unroll
    for (int k = 0; k < V; ++k) fold(op, acc, (A)x3.v[k]);
  }
  for (; i < nvec; i += step) {
    Vec16<T, V> x;
    x.raw = __ldg(vp + i);
#pragma unroll
    for (int k = 0; k < V; ++k) fold(op, acc, (A)x.v[k]);
  }
  if (b == 0) {
    // head and tail: fewer than V elements each
    if (threadIdx.x < head) fold(op, acc, (A)p[threadIdx.x]);
    if (tail0 + threadIdx.x < m) fold(op, acc, (A)p[tail0 + threadIdx.x]);
  }
  warp_fold(op, acc);
  __shared__ Part<A> sm[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sm[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    acc = lane < nw ? sm[lane] : identity_part<T, A>(op);
    warp_fold(op, acc);
    if (lane == 0) scratch[(int64_t)s * nb + b] = acc;
  }
}

template <typename T, typename A>
__device__ __forceinline__ void put(void* out, int s, A v) {
  ((T*)out)[s] = (T)v;
}

// A warp a shard folds its nb partials in a fixed order and writes the
// results: red as int64 for an integer or bool add or mul, else as T;
// lo and hi as T.
template <typename T>
static __global__ void k17_fold(const Part<typename Acc<T>::type>* scratch,
                                int nb, int op, void* red, void* lo,
                                void* hi) {
  typedef typename Acc<T>::type A;
  const int s = blockIdx.x, lane = threadIdx.x;
  Part<A> acc = identity_part<T, A>(op);
  for (int k = lane; k < nb; k += 32)
    merge(op, acc, scratch[(int64_t)s * nb + k]);
  warp_fold(op, acc);
  if (lane != 0) return;
  if ((op == K17_ADD || op == K17_MUL) && std::is_integral<A>::value)
    put<int64_t, A>(red, s, acc.red);
  else
    put<T, A>(red, s, acc.red);
  put<T, A>(lo, s, acc.lo);
  put<T, A>(hi, s, acc.hi);
}

template <typename T>
static int launch_reduce(const void* col, int64_t lanes, const int32_t* n,
                         int N, int64_t cap, int op, void* red, void* lo,
                         void* hi, void* scratch, int blocks,
                         cudaStream_t st) {
  typedef Part<typename Acc<T>::type> P;
  dim3 grid((unsigned)blocks, (unsigned)N);
  k17_partial<T><<<grid, 256, 0, st>>>((const T*)col, n, cap, lanes, op,
                                       (P*)scratch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  k17_fold<T><<<N, 32, 0, st>>>((const P*)scratch, blocks, op, red, lo, hi);
  return (int)cudaGetLastError();
}

// col: contiguous (N, cap, lanes...) of `kind`; n: (N,) int32 valid rows;
// red, lo, hi: (N,) outputs (red int64 for an integer or bool add or
// mul, else the column's type; lo, hi the column's type); scratch: N *
// blocks partials of 24 bytes.
extern "C" int dpk_monoid_reduce(const void* col, int kind, int64_t lanes,
                                 const int32_t* n, int N, int64_t cap, int op,
                                 void* red, void* lo, void* hi, void* scratch,
                                 int blocks, void* stream) {
  if (N < 1 || N > 65535 || blocks < 1 || lanes < 0 || cap < 0 || op < 0 ||
      op > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case K17_I64:
      return launch_reduce<int64_t>(col, lanes, n, N, cap, op, red, lo, hi,
                                    scratch, blocks, st);
    case K17_I32:
      return launch_reduce<int32_t>(col, lanes, n, N, cap, op, red, lo, hi,
                                    scratch, blocks, st);
    case K17_BOOL:
      return launch_reduce<uint8_t>(col, lanes, n, N, cap, op, red, lo, hi,
                                    scratch, blocks, st);
    case K17_F64:
      return launch_reduce<double>(col, lanes, n, N, cap, op, red, lo, hi,
                                   scratch, blocks, st);
    case K17_F32:
      return launch_reduce<float>(col, lanes, n, N, cap, op, red, lo, hi,
                                  scratch, blocks, st);
  }
  return (int)cudaErrorInvalidValue;
}

struct KeySet {
  const char* ptr[DPK_MAX_KEYS];
  int kind[DPK_MAX_KEYS];  // 0 int64, 1 int32, 2 float64, 3 float32
};

__device__ __forceinline__ bool key_differs(const KeySet& ks, int nk,
                                            int64_t a, int64_t b) {
  bool d = false;
  for (int c = 0; c < nk; ++c) {
    const char* p = ks.ptr[c];
    switch (ks.kind[c]) {
      case 0: d |= ((const int64_t*)p)[a] != ((const int64_t*)p)[b]; break;
      case 1: d |= ((const int32_t*)p)[a] != ((const int32_t*)p)[b]; break;
      case 2: d |= ((const double*)p)[a] != ((const double*)p)[b]; break;
      default: d |= ((const float*)p)[a] != ((const float*)p)[b]; break;
    }
  }
  return d;
}

static __global__ void k17_distinct(const KeySet ks, int nk,
                                    const int32_t* n, int64_t cap,
                                    unsigned long long* out) {
  const int s = blockIdx.y;
  int64_t rows = n[s];
  if (rows > cap) rows = cap;
  if ((int64_t)blockIdx.x * blockDim.x >= rows) return;  // uniform a block
  const int64_t base = (int64_t)s * cap;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  unsigned long long c = 0;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < rows;
       j += step)
    c += (j == 0 || key_differs(ks, nk, base + j, base + j - 1)) ? 1 : 0;
  for (int d = 16; d > 0; d >>= 1) c += __shfl_down_sync(DPK_FULL, c, d);
  __shared__ unsigned long long sm[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sm[warp] = c;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    c = lane < nw ? sm[lane] : 0;
    for (int d = 16; d > 0; d >>= 1) c += __shfl_down_sync(DPK_FULL, c, d);
    if (lane == 0 && c) atomicAdd(out + s, c);
  }
}

// keys: nk (N, cap) key column pointers of kinds (0 int64, 1 int32, 2
// float64, 3 float32); n: (N,) int32; out: (N,) int64, zeroed by the
// caller.  nk <= DPK_MAX_KEYS.
extern "C" int dpk_distinct_key_counts(const void* const* keys,
                                       const int* kinds, int nk,
                                       const int32_t* n, int N, int64_t cap,
                                       int64_t* out, void* stream) {
  if (nk < 1 || nk > DPK_MAX_KEYS || N < 1 || N > 65535)
    return (int)cudaErrorInvalidValue;
  if (cap == 0) return (int)cudaGetLastError();
  KeySet ks;
  for (int c = 0; c < DPK_MAX_KEYS; ++c) {
    ks.ptr[c] = c < nk ? (const char*)keys[c] : nullptr;
    ks.kind[c] = c < nk ? kinds[c] : 0;
    if (c < nk && (kinds[c] < 0 || kinds[c] > 3))
      return (int)cudaErrorInvalidValue;
  }
  const int threads = 256;
  int64_t gx = (cap + threads * 8 - 1) / (threads * 8);
  int64_t most = 1056 / N;
  if (most < 1) most = 1;
  if (gx > most) gx = most;
  dim3 grid((unsigned)gx, (unsigned)N);
  k17_distinct<<<grid, threads, 0, (cudaStream_t)stream>>>(
      ks, nk, n, cap, (unsigned long long*)out);
  return (int)cudaGetLastError();
}
