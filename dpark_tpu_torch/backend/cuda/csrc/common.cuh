// Shared helpers of the columnar shuffle kernels (sm_90a).
//
// Layout contract (see backend/cuda/layout.py): every column is a
// contiguous (N, cap[, W]) tensor, shard s holding rows
// [s*cap, (s+1)*cap).  A leaf row is `bytes` contiguous bytes
// (itemsize * W).  Kernels launch on the caller's stream, allocate
// nothing, and each C entry returns cudaGetLastError().
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define DPK_MAX_LEAVES 16
#define DPK_MAX_KEYS 6
#define DPK_FULL 0xffffffffu
#define DPK_THREADS 1024

// a set of row-copy leaves: src (N, cap_in, ...) -> dst (N, cap_out, ...)
struct LeafSet {
  const char* src[DPK_MAX_LEAVES];
  char* dst[DPK_MAX_LEAVES];
  int64_t bytes[DPK_MAX_LEAVES];
  int n;
};

static inline LeafSet make_leafset(const void* const* src, void* const* dst,
                                   const int64_t* bytes, int n) {
  LeafSet L;
  L.n = n;
  for (int i = 0; i < DPK_MAX_LEAVES; ++i) {
    L.src[i] = i < n ? (const char*)src[i] : nullptr;
    L.dst[i] = i < n ? (char*)dst[i] : nullptr;
    L.bytes[i] = i < n ? bytes[i] : 0;
  }
  return L;
}

__device__ __forceinline__ void copy_row(const char* s, char* d, int64_t b) {
  if ((b & 7) == 0) {
    const uint64_t* s8 = (const uint64_t*)s;
    uint64_t* d8 = (uint64_t*)d;
    for (int64_t k = 0; k < (b >> 3); ++k) d8[k] = s8[k];
  } else if ((b & 3) == 0) {
    const uint32_t* s4 = (const uint32_t*)s;
    uint32_t* d4 = (uint32_t*)d;
    for (int64_t k = 0; k < (b >> 2); ++k) d4[k] = s4[k];
  } else {
    for (int64_t k = 0; k < b; ++k) d[k] = s[k];
  }
}

__device__ __forceinline__ void zero_row(char* d, int64_t b) {
  if ((b & 7) == 0) {
    uint64_t* d8 = (uint64_t*)d;
    for (int64_t k = 0; k < (b >> 3); ++k) d8[k] = 0;
  } else if ((b & 3) == 0) {
    uint32_t* d4 = (uint32_t*)d;
    for (int64_t k = 0; k < (b >> 2); ++k) d4[k] = 0;
  } else {
    for (int64_t k = 0; k < b; ++k) d[k] = 0;
  }
}

// integer key column of width 4 or 8 bytes, read sign-extended
__device__ __forceinline__ int64_t load_key(const char* p, int w,
                                            int64_t idx) {
  return w == 8 ? ((const int64_t*)p)[idx]
                : (int64_t)((const int32_t*)p)[idx];
}

__device__ __forceinline__ void store_key(char* p, int w, int64_t idx,
                                          int64_t v) {
  if (w == 8)
    ((int64_t*)p)[idx] = v;
  else
    ((int32_t*)p)[idx] = (int32_t)v;
}

// the status words of a one-sweep pass's look-back (K2, K5, K7), read
// and written at the GPU's coherence point
__device__ __forceinline__ unsigned long long ld_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned ld_relaxed_u32(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_status(unsigned long long* p,
                                          unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// Exclusive scan of one int per thread over the whole block (blockDim.x
// a multiple of 32, <= 1024).  Every thread of the block must call it.
// `sm` holds >= 32 ints; *total receives the block sum.
__device__ __forceinline__ int block_excl_scan(int x, int* sm, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int v = x;
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(DPK_FULL, v, d);
    if (lane >= d) v += y;
  }
  if (lane == 31) sm[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? sm[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_up_sync(DPK_FULL, w, d);
      if (lane >= d) w += y;
    }
    sm[lane] = w;  // inclusive warp totals
  }
  __syncthreads();
  const int before = warp > 0 ? sm[warp - 1] : 0;
  *total = sm[nw - 1];
  __syncthreads();  // sm may be reused by the caller right after
  return before + v - x;
}

// Per-shard exclusive scan, in place, of rows a[s*L : (s+1)*L]; one block
// per shard.  totals[s] (optional) receives the row sum.
static __global__ void scan_rows_excl(int32_t* a, int64_t L, int32_t* totals) {
  __shared__ int sm[32];
  int32_t* row = a + (int64_t)blockIdx.x * L;
  int carry = 0;
  for (int64_t base = 0; base < L; base += blockDim.x) {
    const int64_t i = base + threadIdx.x;
    const int x = i < L ? row[i] : 0;
    int tot;
    const int ex = block_excl_scan(x, sm, &tot);
    if (i < L) row[i] = carry + ex;
    carry += tot;
  }
  if (totals != nullptr && threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// ---- the tile helpers of the one-sweep passes with fill items (K3, K7)

__device__ __forceinline__ void load16(const int32_t* p, int32_t* v) {
  const int4 x = *(const int4*)p;
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void load16(const long long* p, long long* v) {
  const longlong2 x = *(const longlong2*)p;
  v[0] = x.x;
  v[1] = x.y;
}

__device__ __forceinline__ void load16(const double* p, double* v) {
  const double2 x = *(const double2*)p;
  v[0] = x.x;
  v[1] = x.y;
}

// bit i: row row0 + i (< cap) differs in this column, compared in T,
// from the row before it (bit 0 clear for row 0)
template <typename T, int ITEMS>
__device__ __forceinline__ unsigned col_diffs(const char* col, int64_t base,
                                              int64_t row0, int64_t cap) {
  const T* p = (const T*)col + base + row0;
  constexpr int PER = 16 / sizeof(T);
  T v[ITEMS];
  if (row0 + ITEMS <= cap && ((uintptr_t)p & 15) == 0) {
#pragma unroll
    for (int q = 0; q < ITEMS; q += PER) load16(p + q, v + q);
  } else {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) v[i] = row0 + i < cap ? p[i] : (T)0;
  }
  const T h = row0 > 0 ? p[-1] : v[0];
  unsigned d = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i)
    d |= (unsigned)(v[i] != (i > 0 ? v[i - 1] : h)) << i;
  return d;
}

// v into p[lo, hi) by the nth threads from tid: 16-byte stores between a
// scalar head and tail (T of 1, 2, 4, 8 or 16 bytes)
template <typename T>
__device__ __forceinline__ void fill_span(T* p, int64_t lo, int64_t hi, T v,
                                          int tid, int nth) {
  if (lo >= hi) return;
  constexpr int PER = 16 / sizeof(T);
  int64_t head = (int64_t)((16 - ((uintptr_t)(p + lo) & 15)) & 15) /
                 (int64_t)sizeof(T);
  if (head > hi - lo) head = hi - lo;
  for (int64_t i = tid; i < head; i += nth) p[lo + i] = v;
  const int64_t vlo = lo + head;
  const int64_t nvec = (hi - vlo) / PER;
  union {
    T e[PER];
    uint4 u;
  } pat;
#pragma unroll
  for (int i = 0; i < PER; ++i) pat.e[i] = v;
  uint4* q = (uint4*)(p + vlo);
  for (int64_t k = tid; k < nvec; k += nth) q[k] = pat.u;
  for (int64_t i = vlo + nvec * PER + tid; i < hi; i += nth) p[i] = v;
}

// exclusive block scan of (starts: sum, last start row: max, -1 for
// none) over the threads, with the block's totals; every thread calls it
__device__ __forceinline__ void scan_starts(int c, int l, int* s_c, int* s_l,
                                            int* ex_c, int* ex_l,
                                            int* tot_c, int* tot_l) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int vc = c, vl = l;
  for (int d = 1; d < 32; d <<= 1) {
    const int yc = __shfl_up_sync(DPK_FULL, vc, d);
    const int yl = __shfl_up_sync(DPK_FULL, vl, d);
    if (lane >= d) {
      vc += yc;
      vl = max(vl, yl);
    }
  }
  if (lane == 31) {
    s_c[warp] = vc;
    s_l[warp] = vl;
  }
  __syncthreads();
  if (warp == 0) {
    int wc = lane < nw ? s_c[lane] : 0, wl = lane < nw ? s_l[lane] : -1;
    for (int d = 1; d < 32; d <<= 1) {
      const int yc = __shfl_up_sync(DPK_FULL, wc, d);
      const int yl = __shfl_up_sync(DPK_FULL, wl, d);
      if (lane >= d) {
        wc += yc;
        wl = max(wl, yl);
      }
    }
    s_c[lane] = wc;  // inclusive over warps
    s_l[lane] = wl;
  }
  __syncthreads();
  const int bl = warp > 0 ? s_l[warp - 1] : -1;
  const int pl = __shfl_up_sync(DPK_FULL, vl, 1);
  *ex_c = (warp > 0 ? s_c[warp - 1] : 0) + vc - c;
  *ex_l = max(bl, lane > 0 ? pl : -1);
  *tot_c = s_c[nw - 1];
  *tot_l = s_l[nw - 1];
  __syncthreads();
}

// work item g of a sweep (K3, K7): shard 0's tiles, then for p = 1 ..
// N-1 shard p's tiles with shard p-1's fill items spread evenly among
// them, then shard N-1's fill items; each shard's tiles in order.
// Returns (shard, tile or fill index, whether a fill item).
__device__ __forceinline__ bool sweep_item(int64_t g, int64_t ntiles,
                                           int64_t nfill, int N, int64_t* s,
                                           int64_t* t) {
  if (g < ntiles) {
    *s = 0;
    *t = g;
    return false;
  }
  const int64_t M = ntiles + nfill, h = g - ntiles;
  const int64_t p = h / M + 1, i = h - (p - 1) * M;
  if (p == N) {
    *s = N - 1;
    *t = i;
    return true;
  }
  const int64_t f0 = i * nfill / M, f1 = (i + 1) * nfill / M;
  *s = f1 > f0 ? p - 1 : p;
  *t = f1 > f0 ? f0 : i - f0;
  return f1 > f0;
}

