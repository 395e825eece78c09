// K1 hash_dst_hist: portable hash -> shuffle destination -> per-shard
// histogram, in one pass over the key columns.
//
// Replaces dpark_tpu/utils/phash.py:143 phash_device and :196
// phash_device_cols, dpark_tpu/backend/tpu/collectives.py:46
// hash_dst_cols, and the destination bincount of bucketize (:191).
//
// Per row: h = fmix32(lo32 ^ hi32) of the int64 key (int32 keys
// sign-extend); composite keys fold columns with the tuple recipe
// h = (h ^ hash(k)) * 0x9E3779B1 from seed 0x345678, then
// fmix32(h ^ ncols).  dst = h % r for valid rows, n_dst for padding.
//
// Bound: bytes.  It reads 8 B per key column and writes 4 B (dst) (+8 B
// when the raw hash is kept as a sort column) per row; at N=8, cap=2^23,
// one int64 key that is 805 MB, 0.24 ms at 3.35 TB/s.  Design: native
// uint32 arithmetic (torch has no uint32 shift/mod on the CPU, the plain
// version emulates it in int64), a grid-stride loop so each block
// reduces its histogram in shared memory and flushes it with one global
// atomic per bucket.
#include "common.cuh"

struct HashKeys {
  const char* p[DPK_MAX_KEYS];
  int w[DPK_MAX_KEYS];
  int n;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t phash64(int64_t x) {
  const uint64_t u = (uint64_t)x;
  return fmix32((uint32_t)u ^ (uint32_t)(u >> 32));
}

static __global__ void k1_kernel(HashKeys K, const int32_t* n, int64_t cap,
                                 uint32_t r, int n_dst, int32_t* dst,
                                 int64_t* hout, int32_t* hist) {
  extern __shared__ int h_sm[];
  const int s = blockIdx.y;
  if (hist != nullptr) {
    for (int k = threadIdx.x; k <= n_dst; k += blockDim.x) h_sm[k] = 0;
    __syncthreads();
  }
  const int64_t nv = n[s];
  const int64_t base = (int64_t)s * cap;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < cap;
       i += (int64_t)gridDim.x * blockDim.x) {
    int d = n_dst;
    uint32_t h = 0;
    if (i < nv) {
      if (K.n == 1) {
        h = phash64(load_key(K.p[0], K.w[0], base + i));
      } else {
        h = 0x345678u;
        for (int c = 0; c < K.n; ++c)
          h = (h ^ phash64(load_key(K.p[c], K.w[c], base + i))) *
              0x9E3779B1u;
        h = fmix32(h ^ (uint32_t)K.n);
      }
      d = (int)(h % r);
    }
    dst[base + i] = d;
    if (hout != nullptr) hout[base + i] = (int64_t)h;
    if (hist != nullptr) atomicAdd(&h_sm[d], 1);
  }
  if (hist != nullptr) {
    __syncthreads();
    for (int k = threadIdx.x; k <= n_dst; k += blockDim.x)
      if (h_sm[k]) atomicAdd(&hist[(int64_t)s * (n_dst + 1) + k], h_sm[k]);
  }
}

// keys: ncols pointers to (N, cap) int32/int64 columns (widths in w);
// n: (N,) valid rows; dst: (N, cap) int32 out; hout: (N, cap) int64 raw
// hash out or null; hist: (N, n_dst+1) int32, zeroed by the caller, or
// null.
extern "C" int dpk_hash_dst_hist(const void* const* keys, const int* w,
                                 int ncols, const int32_t* n, int N,
                                 int64_t cap, int r, int n_dst, int32_t* dst,
                                 int64_t* hout, int32_t* hist,
                                 void* stream) {
  if (ncols < 1 || ncols > DPK_MAX_KEYS || r < 1) return (int)cudaErrorInvalidValue;
  HashKeys K;
  K.n = ncols;
  for (int c = 0; c < DPK_MAX_KEYS; ++c) {
    K.p[c] = c < ncols ? (const char*)keys[c] : nullptr;
    K.w[c] = c < ncols ? w[c] : 8;
  }
  int64_t blocks = (cap + DPK_THREADS - 1) / DPK_THREADS;
  if (blocks > 1024) blocks = 1024;
  if (blocks < 1) blocks = 1;
  dim3 grid((unsigned)blocks, (unsigned)N);
  const size_t smem = hist != nullptr ? (size_t)(n_dst + 1) * sizeof(int) : 0;
  k1_kernel<<<grid, DPK_THREADS, smem, (cudaStream_t)stream>>>(
      K, n, cap, (uint32_t)r, n_dst, dst, hout, hist);
  return (int)cudaGetLastError();
}
