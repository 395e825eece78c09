// K3 reduce_by_key_compact: over rows already sorted by their key
// columns, merge each run of equal keys into one row, pack the kept rows
// to the front in their order, and count them per shard and per
// destination.
//
// Replaces dpark_tpu/backend/tpu/collectives.py:359 _changed_adjacent,
// :367 _segment_merge, :293 _monoid_segment_totals, the re-pack sorts at
// :427 (_bucketize_combine_cols) and :476 (_segment_reduce_cols) and the
// per-destination bincount after them.  A run boundary is any key column
// changing (the destination column included, on the map side); rows at
// or past n[s] are padding.  The pack is a stable select (a block scan of
// keep flags), so no second sort runs.
//
// Values reduce with add / min / max / mul over int64 or float64
// (op "last" keeps the run's last row, any dtype: the tail of a traced
// segmented scan).  Inside a block a segmented warp-shuffle scan folds
// each run; a run wholly inside one block is stored once, a run crossing
// blocks is folded with one atomic per block into an identity-initialised
// slot.  Integer totals are exact; float sums change order with the
// block split (compare with a tolerance).
//
// Bound: bytes.  Per input row it reads every key column and value once
// and writes a 4 B segment id; per output row it writes keys and values.
// At N=8, cap=2^23, dst + one int64 key + one int64 value with 65,536
// keys that is about 1.35 GB, 0.40 ms at 3.35 TB/s.  The kernel reads the
// key columns twice (count pass and scatter pass) and writes and reads a
// segment id per row, about 2x the bound's bytes.
#include "common.cuh"

struct KeyCols {
  const char* p[DPK_MAX_KEYS];
  char* out[DPK_MAX_KEYS];
  int w[DPK_MAX_KEYS];
  int64_t fill[DPK_MAX_KEYS];
  int n;
};

enum { OP_ADD = 0, OP_MIN = 1, OP_MAX = 2, OP_MUL = 3, OP_LAST = 4 };

__device__ __forceinline__ bool row_start(const KeyCols& K, int64_t base,
                                          int64_t i) {
  if (i == 0) return true;
  for (int c = 0; c < K.n; ++c)
    if (load_key(K.p[c], K.w[c], base + i) !=
        load_key(K.p[c], K.w[c], base + i - 1))
      return true;
  return false;
}

static __global__ void k3_flags(KeyCols K, const int32_t* n, int64_t cap,
                                int nblk, int32_t* blockcnt) {
  const int s = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t base = (int64_t)s * cap;
  const int keep = (i < cap && i < n[s] && row_start(K, base, i)) ? 1 : 0;
  const int cnt = __syncthreads_count(keep);
  if (threadIdx.x == 0) blockcnt[(int64_t)s * nblk + blockIdx.x] = cnt;
}

static __global__ void k3_scatter(KeyCols K, const int32_t* n, int64_t cap,
                                  int nblk, const int32_t* blockoff,
                                  const int32_t* nuniq, int32_t* seg,
                                  int dst_col, int n_dst, int32_t* dcounts) {
  extern __shared__ int x_sm[];  // 32 scan slots + n_dst histogram
  int* hist = x_sm + 32;
  const int s = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t base = (int64_t)s * cap;
  if (dst_col >= 0) {
    for (int k = threadIdx.x; k < n_dst; k += blockDim.x) hist[k] = 0;
  }
  const bool valid = i < cap && i < n[s];
  const int keep = (valid && row_start(K, base, i)) ? 1 : 0;
  int tot;
  const int ex = block_excl_scan(keep, x_sm, &tot);
  const int64_t j = (int64_t)blockoff[(int64_t)s * nblk + blockIdx.x] + ex;
  if (keep) {
    for (int c = 0; c < K.n; ++c)
      store_key(K.out[c], K.w[c], base + j,
                load_key(K.p[c], K.w[c], base + i));
    if (dst_col >= 0)
      atomicAdd(&hist[load_key(K.p[dst_col], K.w[dst_col], base + i)], 1);
  }
  if (valid) seg[base + i] = (int32_t)(j + keep - 1);
  if (i < cap && i >= nuniq[s]) {
    for (int c = 0; c < K.n; ++c)
      store_key(K.out[c], K.w[c], base + i, K.fill[c]);
  }
  if (dst_col >= 0) {
    __syncthreads();
    for (int k = threadIdx.x; k < n_dst; k += blockDim.x)
      if (hist[k]) atomicAdd(&dcounts[(int64_t)s * n_dst + k], hist[k]);
  }
}

static __global__ void k3_offsets(const int32_t* dcounts, int N, int n_dst,
                                  int32_t* doffs) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= N) return;
  int32_t off = 0;
  for (int d = 0; d < n_dst; ++d) {
    doffs[(int64_t)s * n_dst + d] = off;
    off += dcounts[(int64_t)s * n_dst + d];
  }
}

template <typename T>
__device__ __forceinline__ T identity_of(int op);
template <>
__device__ __forceinline__ long long identity_of<long long>(int op) {
  return op == OP_ADD ? 0LL
         : op == OP_MUL ? 1LL
         : op == OP_MIN ? (long long)0x7fffffffffffffffLL
                        : (long long)(-0x7fffffffffffffffLL - 1);
}
template <>
__device__ __forceinline__ double identity_of<double>(int op) {
  return op == OP_ADD ? 0.0
         : op == OP_MUL ? 1.0
         : op == OP_MIN ? __longlong_as_double(0x7ff0000000000000LL)
                        : __longlong_as_double((long long)0xfff0000000000000ULL);
}

template <typename T, int OP>
__device__ __forceinline__ T combine(T a, T b);
#define DPK_COMB(T, OPV, EXPR)                                   \
  template <>                                                    \
  __device__ __forceinline__ T combine<T, OPV>(T a, T b) {       \
    return EXPR;                                                 \
  }
DPK_COMB(long long, OP_ADD,
         (long long)((unsigned long long)a + (unsigned long long)b))
DPK_COMB(long long, OP_MUL,
         (long long)((unsigned long long)a * (unsigned long long)b))
DPK_COMB(long long, OP_MIN, (b < a ? b : a))
DPK_COMB(long long, OP_MAX, (b > a ? b : a))
DPK_COMB(double, OP_ADD, a + b)
DPK_COMB(double, OP_MUL, a * b)
DPK_COMB(double, OP_MIN, (b < a ? b : a))
DPK_COMB(double, OP_MAX, (b > a ? b : a))

template <typename T, int OP>
__device__ __forceinline__ void atomic_fold(T* addr, T v) {
  unsigned long long* a = (unsigned long long*)addr;
  unsigned long long old = *a, assumed;
  do {
    assumed = old;
    T cur;
    memcpy(&cur, &assumed, sizeof(T));
    const T nv = combine<T, OP>(cur, v);
    unsigned long long nb;
    memcpy(&nb, &nv, sizeof(T));
    old = atomicCAS(a, assumed, nb);
  } while (old != assumed);
}
template <>
__device__ __forceinline__ void atomic_fold<long long, OP_ADD>(long long* a,
                                                             long long v) {
  atomicAdd((unsigned long long*)a, (unsigned long long)v);
}
template <>
__device__ __forceinline__ void atomic_fold<long long, OP_MIN>(long long* a,
                                                             long long v) {
  atomicMin(a, v);
}
template <>
__device__ __forceinline__ void atomic_fold<long long, OP_MAX>(long long* a,
                                                             long long v) {
  atomicMax(a, v);
}
template <>
__device__ __forceinline__ void atomic_fold<double, OP_ADD>(double* a,
                                                          double v) {
  atomicAdd(a, v);
}

// out[s, j, w] = identity for j < nuniq[s], else 0
template <typename T>
static __global__ void k3_init(T* out, int64_t cap, int64_t W,
                               const int32_t* nuniq, int op) {
  const int s = blockIdx.y;
  const int64_t total = cap * W;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t j = e / W;
    out[(int64_t)s * total + e] = j < nuniq[s] ? identity_of<T>(op) : (T)0;
  }
}

template <typename T, int OP>
static __global__ void k3_values(const T* v, T* out, int64_t W,
                                 const int32_t* seg, const int32_t* n,
                                 int64_t cap) {
  __shared__ T wv[32];
  __shared__ int wf[32];
  const int s = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int64_t i0 = (int64_t)blockIdx.x * blockDim.x;
  const int64_t i = i0 + threadIdx.x;
  const int64_t base = (int64_t)s * cap;
  const int64_t nv = n[s];
  const bool valid = i < nv && i < cap;
  const int sg = valid ? seg[base + i] : -1;
  const int start =
      valid ? ((i == 0 || seg[base + i - 1] != sg) ? 1 : 0) : 1;
  const bool tail = valid && (i + 1 >= nv || seg[base + i + 1] != sg);
  // did this row's run start inside this block?
  bool in_block = false;
  if (valid) {
    const int sg0 = seg[base + i0];
    const bool start0 = i0 == 0 || seg[base + i0 - 1] != sg0;
    in_block = sg != sg0 || start0;
  }
  const bool writer = valid && (tail || threadIdx.x == blockDim.x - 1);
  const T ident = identity_of<T>(OP);
  for (int64_t w = 0; w < W; ++w) {
    T val = valid ? v[(base + i) * W + w] : ident;
    int f = start;
    for (int d = 1; d < 32; d <<= 1) {
      const T ov = __shfl_up_sync(DPK_FULL, val, d);
      const int of = __shfl_up_sync(DPK_FULL, f, d);
      if (lane >= d) {
        if (!f) val = combine<T, OP>(ov, val);
        f |= of;
      }
    }
    if (lane == 31) {
      wv[warp] = val;
      wf[warp] = f;
    }
    __syncthreads();
    if (warp == 0) {
      T a = lane < nw ? wv[lane] : ident;
      int af = lane < nw ? wf[lane] : 1;
      for (int d = 1; d < 32; d <<= 1) {
        const T oa = __shfl_up_sync(DPK_FULL, a, d);
        const int oaf = __shfl_up_sync(DPK_FULL, af, d);
        if (lane >= d) {
          if (!af) a = combine<T, OP>(oa, a);
          af |= oaf;
        }
      }
      const T ca = __shfl_up_sync(DPK_FULL, a, 1);
      if (lane < nw) wv[lane] = lane > 0 ? ca : ident;
    }
    __syncthreads();
    if (warp > 0 && !f) val = combine<T, OP>(wv[warp], val);
    if (writer) {
      T* dst = out + (base + sg) * W + w;
      if (in_block && tail)
        *dst = val;
      else
        atomic_fold<T, OP>(dst, val);
    }
    __syncthreads();
  }
}

static __global__ void k3_last(const char* v, char* out, int64_t bytes,
                               const int32_t* seg, const int32_t* n,
                               int64_t cap) {
  const int s = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t base = (int64_t)s * cap;
  const int64_t nv = n[s];
  if (i >= nv || i >= cap) return;
  const int sg = seg[base + i];
  if (i + 1 < nv && seg[base + i + 1] == sg) return;
  copy_row(v + (base + i) * bytes, out + (base + sg) * bytes, bytes);
}

template <typename T, int OP>
static void launch_values(const void* v, void* out, int64_t W,
                          const int32_t* seg, const int32_t* n, int64_t cap,
                          dim3 grid, cudaStream_t st) {
  k3_values<T, OP><<<grid, DPK_THREADS, 0, st>>>(
      (const T*)v, (T*)out, W, seg, n, cap);
}

template <typename T>
static void launch_values_op(int op, const void* v, void* out, int64_t W,
                             const int32_t* seg, const int32_t* n,
                             int64_t cap, dim3 grid, cudaStream_t st) {
  switch (op) {
    case OP_ADD: launch_values<T, OP_ADD>(v, out, W, seg, n, cap, grid, st); break;
    case OP_MIN: launch_values<T, OP_MIN>(v, out, W, seg, n, cap, grid, st); break;
    case OP_MAX: launch_values<T, OP_MAX>(v, out, W, seg, n, cap, grid, st); break;
    default: launch_values<T, OP_MUL>(v, out, W, seg, n, cap, grid, st); break;
  }
}

// keys: nk pointers to sorted (N, cap) int32/int64 columns (widths w),
// key_out: nk packed outputs, fill: per-column tail value; dst_col: index
// of the destination column among the keys (or -1), n_dst its bucket
// count, dcounts/doffs: (N, n_dst) outputs (dcounts zeroed by the
// caller).  vals: nv pointers to (N, cap, W) value leaves, val_out their
// packed outputs, vbytes the row bytes, vkind 0 = int64, 1 = float64,
// 2 = any (op must be "last"), vw the lane count W.  n: (N,) valid rows;
// nuniq: (N,) out; seg: (N, cap) int32 scratch; blockcnt: (N,
// ceil(cap/1024)) int32 scratch.
extern "C" int dpk_reduce_by_key(
    const void* const* keys, void* const* key_out, const int* w,
    const int64_t* fill, int nk, int dst_col, int n_dst,
    const void* const* vals, void* const* val_out, const int64_t* vbytes,
    const int* vkind, const int64_t* vw, int nv, int op, const int32_t* n,
    int N, int64_t cap, int32_t* nuniq, int32_t* dcounts, int32_t* doffs,
    int32_t* seg, int32_t* blockcnt, void* stream) {
  if (nk < 1 || nk > DPK_MAX_KEYS || op < OP_ADD || op > OP_LAST ||
      (dst_col >= 0 && (n_dst < 1 || n_dst > 4096)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nblk = (int)((cap + DPK_THREADS - 1) / DPK_THREADS);
  if (nblk == 0) return (int)cudaGetLastError();
  KeyCols K;
  K.n = nk;
  for (int c = 0; c < DPK_MAX_KEYS; ++c) {
    K.p[c] = c < nk ? (const char*)keys[c] : nullptr;
    K.out[c] = c < nk ? (char*)key_out[c] : nullptr;
    K.w[c] = c < nk ? w[c] : 8;
    K.fill[c] = c < nk ? fill[c] : 0;
  }
  dim3 grid((unsigned)nblk, (unsigned)N);
  k3_flags<<<grid, DPK_THREADS, 0, st>>>(K, n, cap, nblk, blockcnt);
  scan_rows_excl<<<N, DPK_THREADS, 0, st>>>(blockcnt, nblk, nuniq);
  const size_t smem = (32 + (dst_col >= 0 ? n_dst : 0)) * sizeof(int);
  k3_scatter<<<grid, DPK_THREADS, smem, st>>>(K, n, cap, nblk, blockcnt,
                                              nuniq, seg, dst_col, n_dst,
                                              dcounts);
  if (dst_col >= 0)
    k3_offsets<<<(N + 127) / 128, 128, 0, st>>>(dcounts, N, n_dst, doffs);
  int64_t iblocks = (cap + DPK_THREADS - 1) / DPK_THREADS;
  if (iblocks > 1024) iblocks = 1024;
  dim3 igrid((unsigned)iblocks, (unsigned)N);
  for (int l = 0; l < nv; ++l) {
    if (op == OP_LAST) {
      cudaMemsetAsync(val_out[l], 0, (size_t)(N * cap * vbytes[l]), st);
      k3_last<<<grid, DPK_THREADS, 0, st>>>((const char*)vals[l],
                                            (char*)val_out[l], vbytes[l],
                                            seg, n, cap);
    } else if (vkind[l] == 0) {
      k3_init<long long><<<igrid, DPK_THREADS, 0, st>>>(
          (long long*)val_out[l], cap, vw[l], nuniq, op);
      launch_values_op<long long>(op, vals[l], val_out[l], vw[l], seg, n,
                                  cap, grid, st);
    } else if (vkind[l] == 1) {
      k3_init<double><<<igrid, DPK_THREADS, 0, st>>>(
          (double*)val_out[l], cap, vw[l], nuniq, op);
      launch_values_op<double>(op, vals[l], val_out[l], vw[l], seg, n, cap,
                               grid, st);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
