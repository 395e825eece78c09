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
