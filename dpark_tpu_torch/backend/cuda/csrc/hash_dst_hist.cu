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
// one int64 key that is 805 MB, 0.24 ms at 3.35 TB/s.
//
// Design.  A thread takes a quad (4 consecutive rows) at a time: one
// 16-byte load of each int32 key column (two of an int64 one), one
// 16-byte store of the 4 destinations (and two of the hashes).  A shard's
// quads are aligned on the flat row index, so that a shard starting
// inside a quad has a head quad (and one ending inside a quad a tail
// quad) of scalar rows; key columns not 16-byte aligned are read row by
// row.  Quads past the shard's count only store n_dst (and 0); the
// histogram's padding bin is cap - n, added once.  h % r is Lemire's
// multiply-high remainder (no division).  Histogram over r <= 16
// buckets: byte counters packed in two 64-bit registers a thread,
// flushed every K1_FLUSH steps (fewer than 256 rows) by one warp
// reduction a bucket into per-warp shared counters; one global atomic
// per bucket a block.  Over more buckets: shared-memory atomics (up to
// K1_SMEM_BINS; more are refused).  The grid is sized to the SMs (a
// block walks its shard's tiles of K1_THREADS x K1_QUADS quads).
#include "common.cuh"

#define K1_THREADS 512
#define K1_QUADS 2               // quads a thread a step
#define K1_BLOCKS_PER_SM 8       // the grid: blocks an SM (4 resident)
#define K1_REG_BINS 16
#define K1_SMEM_BINS 12288       // 48 KB of shared counters
#define K1_FLUSH (255 / (4 * K1_QUADS))
#define K1_TILE (K1_THREADS * K1_QUADS)   // quads a block a step

struct HashKeys {
  const char* p[DPK_MAX_KEYS];
  int w[DPK_MAX_KEYS];
  int n;
  int vec;  // every key column 16-byte aligned
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

// h % r by one 64-bit multiply and one high multiply (M = 2^64 / r,
// rounded up: Lemire, Kaser and Kurz, "Faster remainder by direct
// computation", 2019)
__device__ __forceinline__ uint32_t fast_mod(uint32_t h, uint64_t M,
                                             uint32_t r) {
  return (uint32_t)__umul64hi(M * h, r);
}

// the 4 keys of rows g .. g+3 of column c (all valid rows of a full
// quad); vector loads where the columns are aligned
__device__ __forceinline__ void quad_keys(const HashKeys& K, int c,
                                          int64_t g, int64_t* k) {
  const bool vec = K.vec;
  if (K.w[c] == 8) {
    const long long* p = (const long long*)K.p[c] + g;
    if (vec) {
      const longlong2 a = __ldg((const longlong2*)p);
      const longlong2 b = __ldg((const longlong2*)p + 1);
      k[0] = a.x;
      k[1] = a.y;
      k[2] = b.x;
      k[3] = b.y;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) k[i] = __ldg(p + i);
    }
  } else {
    const int* p = (const int*)K.p[c] + g;
    if (vec) {
      const int4 a = __ldg((const int4*)p);
      k[0] = a.x;
      k[1] = a.y;
      k[2] = a.z;
      k[3] = a.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) k[i] = __ldg(p + i);
    }
  }
}

__device__ __forceinline__ uint32_t row_hash(const HashKeys& K, int64_t g) {
  if (K.n == 1) return phash64(load_key(K.p[0], K.w[0], g));
  uint32_t h = 0x345678u;
#pragma unroll
  for (int c = 0; c < DPK_MAX_KEYS; ++c)
    if (c < K.n) h = (h ^ phash64(load_key(K.p[c], K.w[c], g))) * 0x9E3779B1u;
  return fmix32(h ^ (uint32_t)K.n);
}

// HIST: 0 none, 1 byte counters in registers (r <= 16), 2 shared
// atomics
template <int HIST>
static __global__ void __launch_bounds__(K1_THREADS)
    k1_kernel(const __grid_constant__ HashKeys K, const int32_t* n,
              int64_t cap, uint32_t r, uint64_t M, int n_dst, int32_t* dst,
              int64_t* hout, int32_t* hist) {
  extern __shared__ int h_sm[];
  const int s = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t* hrow = hist != nullptr ? hist + (int64_t)s * (n_dst + 1) : nullptr;
  if constexpr (HIST == 1) {
    for (int i = threadIdx.x; i < (K1_THREADS / 32) * K1_REG_BINS;
         i += K1_THREADS)
      h_sm[i] = 0;
  } else if constexpr (HIST == 2) {
    for (int i = threadIdx.x; i < (int)r; i += K1_THREADS) h_sm[i] = 0;
  }
  if constexpr (HIST != 0) __syncthreads();
  const int64_t nv = n[s];
  const int64_t g0 = (int64_t)s * cap, gv = g0 + nv, gend = g0 + cap;
  if (HIST != 0 && blockIdx.x == 0 && threadIdx.x == 0 && cap > nv)
    atomicAdd(&hrow[n_dst], (int)(cap - nv));
  // quad j covers flat rows [a + 4 (j - 1), a + 4 j) clipped to the
  // shard, a the first multiple of 4 at or after g0 (quad 0: the head)
  const int64_t a = (g0 + 3) & ~(int64_t)3;
  const int64_t nq = 1 + (gend > a ? (gend - a + 3) >> 2 : 0);
  uint64_t c_lo = 0, c_hi = 0;  // byte counters of buckets 0-7 and 8-15
  int steps = 0;
  auto count = [&](int d) {
    if constexpr (HIST == 1) {
      const uint64_t inc = 1ull << ((d & 7) << 3);
      if (d < 8)
        c_lo += inc;
      else
        c_hi += inc;
    } else if constexpr (HIST == 2) {
      atomicAdd(&h_sm[d], 1);
    }
  };
  auto flush = [&]() {
#pragma unroll
    for (int b = 0; b < K1_REG_BINS; ++b) {
      if (b < (int)r) {
        const unsigned v = (unsigned)(((b < 8 ? c_lo : c_hi) >> ((b & 7) * 8))
                                      & 0xff);
        const unsigned t = __reduce_add_sync(DPK_FULL, v);
        if (lane == 0) h_sm[warp * K1_REG_BINS + b] += (int)t;
      }
    }
    c_lo = c_hi = 0;
  };
  for (int64_t t0 = (int64_t)blockIdx.x * K1_TILE; t0 < nq;
       t0 += (int64_t)gridDim.x * K1_TILE) {
#pragma unroll
    for (int u = 0; u < K1_QUADS; ++u) {
      const int64_t j = t0 + u * K1_THREADS + threadIdx.x;
      if (j >= nq) continue;
      int64_t lo = a + 4 * (j - 1), hi = lo + 4;
      if (lo < g0) lo = g0;
      if (hi > gend) hi = gend;
      if (lo >= hi) continue;  // an empty head quad
      uint32_t h[4] = {0, 0, 0, 0};
      int d[4] = {n_dst, n_dst, n_dst, n_dst};
      if (hi - lo == 4 && hi <= gv) {  // a full quad of valid rows
        if (K.n == 1) {
          int64_t k[4];
          quad_keys(K, 0, lo, k);
#pragma unroll
          for (int i = 0; i < 4; ++i) h[i] = phash64(k[i]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) h[i] = 0x345678u;
#pragma unroll
          for (int c = 0; c < DPK_MAX_KEYS; ++c) {
            if (c < K.n) {
              int64_t k[4];
              quad_keys(K, c, lo, k);
#pragma unroll
              for (int i = 0; i < 4; ++i)
                h[i] = (h[i] ^ phash64(k[i])) * 0x9E3779B1u;
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) h[i] = fmix32(h[i] ^ (uint32_t)K.n);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          d[i] = (int)fast_mod(h[i], M, r);
          count(d[i]);
        }
      } else if (lo < gv) {  // a quad that ends past the count or the shard
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (lo + i < hi && lo + i < gv) {
            h[i] = row_hash(K, lo + i);
            d[i] = (int)fast_mod(h[i], M, r);
            count(d[i]);
          }
        }
      }
      if (hi - lo == 4) {
        *(int4*)(dst + lo) = make_int4(d[0], d[1], d[2], d[3]);
        if (hout != nullptr) {
          *(longlong2*)(hout + lo) = make_longlong2(h[0], h[1]);
          *(longlong2*)(hout + lo + 2) = make_longlong2(h[2], h[3]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i < hi - lo) {
            dst[lo + i] = d[i];
            if (hout != nullptr) hout[lo + i] = (int64_t)h[i];
          }
        }
      }
    }
    if constexpr (HIST == 1) {
      if (++steps == K1_FLUSH) {
        flush();
        steps = 0;
      }
    }
  }
  if constexpr (HIST == 1) {
    flush();
    __syncthreads();
    for (int b = threadIdx.x; b < (int)r; b += K1_THREADS) {
      int t = 0;
#pragma unroll
      for (int w = 0; w < K1_THREADS / 32; ++w) t += h_sm[w * K1_REG_BINS + b];
      if (t) atomicAdd(&hrow[b], t);
    }
  } else if constexpr (HIST == 2) {
    __syncthreads();
    for (int b = threadIdx.x; b < (int)r; b += K1_THREADS)
      if (h_sm[b]) atomicAdd(&hrow[b], h_sm[b]);
  }
}

// keys: ncols pointers to (N, cap) int32/int64 columns (widths in w);
// n: (N,) valid rows; dst: (N, cap) int32 out; hout: (N, cap) int64 raw
// hash out or null; hist: (N, n_dst+1) int32, zeroed by the caller (then
// r <= n_dst), or null.  dst and hout 16-byte aligned.
extern "C" int dpk_hash_dst_hist(const void* const* keys, const int* w,
                                 int ncols, const int32_t* n, int N,
                                 int64_t cap, int r, int n_dst, int32_t* dst,
                                 int64_t* hout, int32_t* hist,
                                 void* stream) {
  if (ncols < 1 || ncols > DPK_MAX_KEYS || r < 1 ||
      (hist != nullptr && (r > n_dst || r > K1_SMEM_BINS)) ||
      ((uintptr_t)dst & 15) != 0 ||
      ((uintptr_t)hout & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (N < 1 || cap < 1) return (int)cudaGetLastError();
  HashKeys K;
  K.n = ncols;
  K.vec = 1;
  for (int c = 0; c < DPK_MAX_KEYS; ++c) {
    K.p[c] = c < ncols ? (const char*)keys[c] : nullptr;
    K.w[c] = c < ncols ? w[c] : 8;
    if (c < ncols && ((uintptr_t)keys[c] & 15) != 0) K.vec = 0;
  }
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      return (int)cudaGetLastError();
  }
  const int64_t nq = cap / 4 + 2;
  int64_t bx = ((int64_t)sms * K1_BLOCKS_PER_SM + N - 1) / N;
  const int64_t need = (nq + K1_TILE - 1) / K1_TILE;
  if (bx > need) bx = need;
  if (bx < 1) bx = 1;
  const dim3 grid((unsigned)bx, (unsigned)N);
  const uint64_t M = ~0ull / (uint64_t)r + 1;
  cudaStream_t st = (cudaStream_t)stream;
  if (hist == nullptr)
    k1_kernel<0><<<grid, K1_THREADS, 0, st>>>(K, n, cap, (uint32_t)r, M,
                                              n_dst, dst, hout, hist);
  else if (r <= K1_REG_BINS)
    k1_kernel<1><<<grid, K1_THREADS,
                   (K1_THREADS / 32) * K1_REG_BINS * sizeof(int), st>>>(
        K, n, cap, (uint32_t)r, M, n_dst, dst, hout, hist);
  else
    k1_kernel<2><<<grid, K1_THREADS, (size_t)r * sizeof(int), st>>>(
        K, n, cap, (uint32_t)r, M, n_dst, dst, hout, hist);
  return (int)cudaGetLastError();
}
