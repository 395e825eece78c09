// K5 radix_sort: the stable sort permutation of each shard's row of one
// key column (int32, int64 or float64), optionally read through a prior
// permutation, so that successive key passes compose into one
// lexicographic order with no gather between them.
//
// Replaces the argsort passes of dpark_tpu/backend/tpu/collectives.py:123
// _lex_sort (and through it the key sorts of bucketize_combine_keys,
// segment_reduce_keys, the no-combine reduce side, SortOp and the
// per-shard top-n).  Output: perm[s, j] = src[s, p[s, j]] where p is the
// stable argsort of col[s, src[s, :]] (src = identity when null) -- bit
// for bit what torch.sort(..., stable=True) composes to.
//
// An LSD radix sort with 8-bit digits over the order-preserving unsigned
// image of the key: ints flip the sign bit; floats first turn -0.0 into
// +0.0 and every NaN into one positive quiet NaN (ties and NaN-last as
// torch.sort), then flip every bit of a negative and the sign bit of a
// non-negative.  One pass reads the keys once and builds every digit's
// per-shard histogram; a digit on which all of a shard's rows agree, in
// every shard, is skipped (the host reads one flag per digit).  Each
// remaining pass is a stable scatter of (key image, row index): per-block
// digit counts, one exclusive scan per (shard, digit value) over the
// blocks, then ranks inside a block as in K2 (block_stable_rank) with a
// running per-digit offset across the block's 8 sub-tiles.  The first
// pass reads the key column through src; the last writes only the index.
//
// Bound: bytes.  The histogram pass reads 8 B a row; each scatter pass
// reads and writes 8 B of key image and 4 B of index, 24 B a row.  At
// N=8, cap=2^23: bench.py's keys (< 2^16, two active digits) 3.76 GB,
// 1.12 ms at 3.35 TB/s; full-range random int64 (eight) 13.4 GB, 4.0 ms.
// The kernel also reads the key image once more per pass to count digits
// per block, and its scatter writes land in 256 runs per block, so they
// are not fully coalesced; a later kernel can stage a tile in shared
// memory and fuse the count into the previous scatter.
#include "common.cuh"

#define K5_RADIX 256
#define K5_ITEMS 8                        // sub-tiles of DPK_THREADS rows
#define K5_TILE (DPK_THREADS * K5_ITEMS)  // rows per block of a pass

// kind: 0 = int32, 1 = int64, 2 = float64
__device__ __forceinline__ uint64_t key_image(const char* col, int kind,
                                              int64_t idx) {
  if (kind == 0)
    return (uint64_t)((uint32_t)((const int32_t*)col)[idx] ^ 0x80000000u);
  if (kind == 1)
    return (uint64_t)((const int64_t*)col)[idx] ^ 0x8000000000000000ull;
  const double x = ((const double*)col)[idx];
  uint64_t b = (uint64_t)__double_as_longlong(x);
  if (x == 0.0)
    b = 0;                      // -0.0 and +0.0 tie
  else if (x != x)
    b = 0x7FF8000000000000ull;  // every NaN: one positive quiet NaN, last
  return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
}

// the key image of current row i of shard base: from the previous pass's
// buffer, or from the column through src (identity when null)
__device__ __forceinline__ uint64_t load_image(const uint64_t* kin,
                                               const char* col, int kind,
                                               const int32_t* src,
                                               int64_t base, int64_t i,
                                               int32_t* row) {
  if (kin != nullptr) return kin[base + i];
  const int64_t r = src != nullptr ? (int64_t)src[base + i] : i;
  *row = (int32_t)r;
  return key_image(col, kind, base + r);
}

// every digit's per-shard histogram, in one read of the keys
static __global__ void k5_hist(const char* col, int kind,
                               const int32_t* src, int64_t cap, int ndig,
                               int32_t* hist) {
  __shared__ int h_sm[8 * K5_RADIX];
  const int s = blockIdx.y;
  for (int k = threadIdx.x; k < ndig * K5_RADIX; k += blockDim.x) h_sm[k] = 0;
  __syncthreads();
  const int64_t base = (int64_t)s * cap;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i0 = (int64_t)blockIdx.x * blockDim.x; i0 < cap;
       i0 += stride) {
    const int64_t i = i0 + threadIdx.x;
    const bool live = i < cap;
    const unsigned act = __ballot_sync(DPK_FULL, live);
    if (live) {
      int32_t row;
      const uint64_t u = load_image(nullptr, col, kind, src, base, i, &row);
      for (int d = 0; d < ndig; ++d)
        warp_count(act, (int)((u >> (8 * d)) & 0xFF), h_sm + d * K5_RADIX);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < ndig * K5_RADIX; k += blockDim.x)
    if (h_sm[k]) atomicAdd(&hist[(int64_t)s * ndig * K5_RADIX + k], h_sm[k]);
}

// per (digit, shard): exclusive scan of the histogram (the start of each
// digit value's run) and whether the shard's rows take two or more values
static __global__ void k5_bases(const int32_t* hist, int ndig,
                                int32_t* bases, int32_t* active) {
  __shared__ int sm[32];
  const int d = blockIdx.x, s = blockIdx.y;
  const int64_t off = ((int64_t)s * ndig + d) * K5_RADIX;
  const int c = hist[off + threadIdx.x];
  int tot;
  bases[off + threadIdx.x] = block_excl_scan(c, sm, &tot);
  const int values = __syncthreads_count(c > 0);
  if (threadIdx.x == 0 && values > 1) atomicOr(&active[d], 1);
}

// per block of K5_TILE rows: the count of each digit value
static __global__ void k5_count(const uint64_t* kin, const char* col,
                                int kind, const int32_t* src, int64_t cap,
                                int shift, int nblk, int32_t* blockcnt) {
  __shared__ int c_sm[K5_RADIX];
  const int s = blockIdx.y;
  for (int k = threadIdx.x; k < K5_RADIX; k += blockDim.x) c_sm[k] = 0;
  __syncthreads();
  const int64_t base = (int64_t)s * cap;
  const int64_t t0 = (int64_t)blockIdx.x * K5_TILE;
  for (int it = 0; it < K5_ITEMS; ++it) {
    const int64_t i = t0 + (int64_t)it * DPK_THREADS + threadIdx.x;
    const bool live = i < cap;
    const unsigned act = __ballot_sync(DPK_FULL, live);
    if (live) {
      int32_t row;
      const uint64_t u = load_image(kin, col, kind, src, base, i, &row);
      warp_count(act, (int)((u >> shift) & 0xFF), c_sm);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K5_RADIX; k += blockDim.x)
    blockcnt[((int64_t)s * K5_RADIX + k) * nblk + blockIdx.x] = c_sm[k];
}

// the stable scatter of one digit: row i of the current order goes to
// bases[b] + blockoff[b][block] + (rows of b earlier in the block)
static __global__ void k5_scatter(const uint64_t* kin, const int32_t* iin,
                                  const char* col, int kind,
                                  const int32_t* src, int64_t cap, int shift,
                                  int nblk, const int32_t* blockoff,
                                  const int32_t* bases, int ndig, int d,
                                  uint64_t* kout, int32_t* iout) {
  __shared__ int w_sm[32 * K5_RADIX];
  __shared__ int run[K5_RADIX];
  const int s = blockIdx.y;
  const int64_t base = (int64_t)s * cap;
  for (int k = threadIdx.x; k < K5_RADIX; k += blockDim.x)
    run[k] = bases[((int64_t)s * ndig + d) * K5_RADIX + k] +
             blockoff[((int64_t)s * K5_RADIX + k) * nblk + blockIdx.x];
  // (block_stable_rank's first barrier orders run[] before its reads)
  const int64_t t0 = (int64_t)blockIdx.x * K5_TILE;
  for (int it = 0; it < K5_ITEMS; ++it) {
    const int64_t i = t0 + (int64_t)it * DPK_THREADS + threadIdx.x;
    const bool live = i < cap;
    uint64_t u = 0;
    int32_t row = 0;
    int b = 0;
    if (live) {
      u = load_image(kin, col, kind, src, base, i, &row);
      if (kin != nullptr) row = iin[base + i];
      b = (int)((u >> shift) & 0xFF);
    }
    const int rank = block_stable_rank(live, b, K5_RADIX, w_sm);
    if (live) {
      const int64_t pos = (int64_t)run[b] + rank;
      if (kout != nullptr) kout[base + pos] = u;
      iout[base + pos] = row;
    }
    __syncthreads();  // every read of run[] is done
    for (int k = threadIdx.x; k < K5_RADIX; k += blockDim.x) {
      int t = 0;
      for (int w = 0; w < 32; ++w) t += w_sm[w * K5_RADIX + k];
      run[k] += t;
    }
    __syncthreads();  // before the next sub-tile clears w_sm
  }
}

// col: (N, cap) key column of `kind`; src: (N, cap) int32 or null; ndig:
// 4 (int32) or 8; hist: (N, ndig, 256) int32 zeroed by the caller; bases:
// (N, ndig, 256) int32 out; active: (ndig,) int32 zeroed by the caller.
extern "C" int dpk_radix_sort_hist(const void* col, int kind,
                                   const int32_t* src, int N, int64_t cap,
                                   int ndig, int32_t* hist, int32_t* bases,
                                   int32_t* active, void* stream) {
  if (kind < 0 || kind > 2 || ndig < 1 || ndig > 8 || N < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int64_t blocks = (cap + DPK_THREADS - 1) / DPK_THREADS;
  if (blocks > 128) blocks = 128;
  if (blocks < 1) blocks = 1;
  k5_hist<<<dim3((unsigned)blocks, (unsigned)N), DPK_THREADS, 0, st>>>(
      (const char*)col, kind, src, cap, ndig, hist);
  k5_bases<<<dim3((unsigned)ndig, (unsigned)N), K5_RADIX, 0, st>>>(
      hist, ndig, bases, active);
  return (int)cudaGetLastError();
}

// One scatter pass over digit d.  The first pass reads the column through
// src (kin null); later passes read (kin, iin) from the previous pass.
// kout null on the last pass (only the index is written).  blockcnt:
// (N, 256, ceil(cap / 8192)) int32 scratch.
extern "C" int dpk_radix_sort_pass(const void* col, int kind,
                                   const int32_t* src, const uint64_t* kin,
                                   const int32_t* iin, int N, int64_t cap,
                                   int ndig, int d, const int32_t* bases,
                                   int32_t* blockcnt, uint64_t* kout,
                                   int32_t* iout, void* stream) {
  if (kind < 0 || kind > 2 || d < 0 || d >= ndig || N < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nblk = (int)((cap + K5_TILE - 1) / K5_TILE);
  if (nblk == 0) return (int)cudaGetLastError();
  const int shift = 8 * d;
  dim3 grid((unsigned)nblk, (unsigned)N);
  k5_count<<<grid, DPK_THREADS, 0, st>>>(kin, (const char*)col, kind, src,
                                         cap, shift, nblk, blockcnt);
  scan_rows_excl<<<N * K5_RADIX, DPK_THREADS, 0, st>>>(blockcnt, nblk,
                                                       nullptr);
  k5_scatter<<<grid, DPK_THREADS, 0, st>>>(kin, iin, (const char*)col, kind,
                                           src, cap, shift, nblk, blockcnt,
                                           bases, ndig, d, kout, iout);
  return (int)cudaGetLastError();
}
