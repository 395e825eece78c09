// K12 join_expand: the device join's match ranges and pair expansion.
//
// Replaces dpark_tpu/backend/tpu/executor.py:3116 device_join_batch: its
// _key_ranges (:3137, jnp.searchsorted left and right for one key
// column, collectives.lex_searchsorted for several), count_dev (:3157,
// the per-shard total of hi - lo) and expand_dev (:3176, each output slot
// finds its A row by a searchsorted of t into the inclusive offsets and
// gathers A's leaves at that row and B's value leaves at lo + j).
//
// Both sides arrive exchanged and key-sorted per shard (K4, then K5 by
// the radix key image): side A holds a_n[s] valid rows of nk key columns
// and its value leaves, side B b_n[s] rows.  Two entry points:
//
// dpk_join_ranges, three launches:
//   1. one thread per A row: lower and upper bound of its key among B's
//      valid prefix [0, b_n[s]) (lexicographic over nk <= 4 columns, in
//      K5's order: ints by value, float64 with -0.0 equal to +0.0 and
//      every NaN one value); writes lo and per = hi - lo (int64; 0 past
//      a_n[s]) and each CUDA block's sum of per;
//   2. one block per shard: exclusive scan of the block sums, and the
//      shard's total;
//   3. one thread per A row: the row's exclusive offset, a block scan of
//      per plus its block's base.
// The caller reads the largest total (the one host sync of a join) and
// sizes the output.
//
// dpk_join_expand, one launch, one thread per output slot t: i is the
// last A row with offs[i] <= t (a bisect over the shard's a_n[s] offsets),
// j = t - offs[i]; the slot takes every A leaf at row i and B's value
// leaves at row lo[i] + j.  Slot-parallel expansion spreads a hot key
// over as many threads as it has pairs.  Slots at t >= total are padding:
// key column 0 holds the sentinel, every other leaf zeros.
//
// The per-launch pointers live in a small int64 table in device memory,
// read into shared memory once per CUDA block (a parameter struct
// indexed by a loop variable costs every thread).
//
// Bound: bytes.  Each side's key columns and A's value leaves are read
// once, B's value leaves once per pair that reads them, every output row
// written once; the bisects re-read key columns and offsets, mostly from
// L2 (neighbouring threads probe neighbouring rows).  Offsets and totals
// are int64: a skewed shard may hold more than 2^31 pairs.
#include "common.cuh"

#define K12_TILE 1024
#define K12_EXPAND_THREADS 256
#define K12_MAX_KEYS 4

// K5's order-preserving unsigned image of one key value (radix_sort.cu,
// kernels.radix_key_image): kind 0 int32, 1 int64, 2 float64
__device__ __forceinline__ uint64_t k12_image(const char* p, int kind,
                                              int64_t idx) {
  if (kind == 0)
    return (uint64_t)((uint32_t)((const int32_t*)p)[idx] ^ 0x80000000u);
  if (kind == 1)
    return (uint64_t)((const int64_t*)p)[idx] ^ 0x8000000000000000ull;
  const double v = ((const double*)p)[idx];
  uint64_t bits = (uint64_t)__double_as_longlong(v);
  if (v == 0.0) bits = 0;                        // -0.0 ties +0.0
  if (v != v) bits = 0x7FF8000000000000ull;      // one NaN, last
  return (bits >> 63) ? ~bits : (bits ^ 0x8000000000000000ull);
}

// -1 / 0 / 1: B row m against the query images, lexicographically
__device__ __forceinline__ int k12_cmp(const int64_t* kd, int nk,
                                       int64_t row, const uint64_t* q) {
#pragma unroll
  for (int c = 0; c < K12_MAX_KEYS; ++c) {
    if (c < nk) {
      const uint64_t b = k12_image((const char*)kd[K12_MAX_KEYS + c],
                                   (int)kd[2 * K12_MAX_KEYS + c], row);
      if (b < q[c]) return -1;
      if (b > q[c]) return 1;
    }
  }
  return 0;
}

// Exclusive scan of one int64 per thread over the block (blockDim.x a
// multiple of 32); every thread must call it.  `sm` holds >= 32 values;
// *total receives the block sum.
__device__ __forceinline__ int64_t k12_block_scan(int64_t x, int64_t* sm,
                                                  int64_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int64_t v = x;
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t y = __shfl_up_sync(DPK_FULL, v, d);
    if (lane >= d) v += y;
  }
  if (lane == 31) sm[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int64_t w = lane < nw ? sm[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t y = __shfl_up_sync(DPK_FULL, w, d);
      if (lane >= d) w += y;
    }
    sm[lane] = w;  // inclusive warp totals
  }
  __syncthreads();
  const int64_t before = warp > 0 ? sm[warp - 1] : 0;
  *total = sm[nw - 1];
  __syncthreads();
  return before + v - x;
}

// key table: A key column pointers, B key column pointers, key kinds
// (K12_MAX_KEYS slots each)
static __global__ void k12_ranges(const int64_t* desc, int nk,
                                  int64_t cap_a, int64_t cap_b,
                                  const int32_t* a_n, const int32_t* b_n,
                                  int64_t* lo_out, int64_t* per_out,
                                  int64_t* part, int64_t nblk) {
  __shared__ int64_t kd[3 * K12_MAX_KEYS];
  __shared__ int64_t sm[32];
  if (threadIdx.x < 3 * K12_MAX_KEYS) kd[threadIdx.x] = desc[threadIdx.x];
  __syncthreads();
  const int64_t s = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * K12_TILE + threadIdx.x;
  int64_t lo = 0, per = 0;
  if (i < (int64_t)a_n[s]) {
    uint64_t q[K12_MAX_KEYS];
#pragma unroll
    for (int c = 0; c < K12_MAX_KEYS; ++c)
      q[c] = c < nk ? k12_image((const char*)kd[c],
                                (int)kd[2 * K12_MAX_KEYS + c],
                                s * cap_a + i)
                    : 0;
    const int64_t base = s * cap_b;
    int64_t l = 0, h = b_n[s];
    while (l < h) {  // first B row >= the key
      const int64_t m = (l + h) >> 1;
      if (k12_cmp(kd, nk, base + m, q) < 0)
        l = m + 1;
      else
        h = m;
    }
    lo = l;
    h = b_n[s];
    while (l < h) {  // first B row > the key
      const int64_t m = (l + h) >> 1;
      if (k12_cmp(kd, nk, base + m, q) <= 0)
        l = m + 1;
      else
        h = m;
    }
    per = l - lo;
  }
  if (i < cap_a) {
    lo_out[s * cap_a + i] = lo;
    per_out[s * cap_a + i] = per;
  }
  int64_t total;
  k12_block_scan(per, sm, &total);
  if (threadIdx.x == 0) part[s * nblk + blockIdx.x] = total;
}

// one block per shard: part[s, :] -> exclusive block bases; totals[s]
static __global__ void k12_scan(int64_t* part, int64_t nblk,
                                int64_t* totals) {
  __shared__ int64_t sm[32];
  int64_t* row = part + (int64_t)blockIdx.x * nblk;
  int64_t carry = 0;
  for (int64_t b0 = 0; b0 < nblk; b0 += blockDim.x) {
    const int64_t k = b0 + threadIdx.x;
    const int64_t x = k < nblk ? row[k] : 0;
    int64_t tot;
    const int64_t ex = k12_block_scan(x, sm, &tot);
    if (k < nblk) row[k] = carry + ex;
    carry += tot;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

static __global__ void k12_offsets(const int64_t* per, const int64_t* part,
                                   int64_t cap_a, int64_t nblk,
                                   int64_t* offs) {
  __shared__ int64_t sm[32];
  const int64_t s = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * K12_TILE + threadIdx.x;
  const int64_t x = i < cap_a ? per[s * cap_a + i] : 0;
  int64_t tot;
  const int64_t ex = k12_block_scan(x, sm, &tot);
  if (i < cap_a) offs[s * cap_a + i] = part[s * nblk + blockIdx.x] + ex;
}

// leaf table: nout source pointers (A's leaves first, then B's value
// leaves), nout output pointers, nout row bytes
static __global__ void k12_expand(const int64_t* desc, int na, int nout,
                                  int64_t cap_a, int64_t cap_b,
                                  int64_t cap_out, const int32_t* a_n,
                                  const int64_t* lo, const int64_t* offs,
                                  const int64_t* totals, uint64_t sent_bits,
                                  int sent_width) {
  __shared__ int64_t ld[3 * DPK_MAX_LEAVES];
  if (threadIdx.x < 3 * nout) ld[threadIdx.x] = desc[threadIdx.x];
  __syncthreads();
  const int64_t s = blockIdx.y;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= cap_out) return;
  const int64_t o = s * cap_out + t;
  if (t >= totals[s]) {  // padding: the sentinel in key column 0
    for (int l = 0; l < nout; ++l)
      zero_row((char*)ld[nout + l] + o * ld[2 * nout + l], ld[2 * nout + l]);
    if (sent_width == 8)
      ((uint64_t*)ld[nout])[o] = sent_bits;
    else
      ((uint32_t*)ld[nout])[o] = (uint32_t)sent_bits;
    return;
  }
  const int64_t* so = offs + s * cap_a;
  int64_t l = 0, h = a_n[s];
  while (l < h) {  // first A row whose offset exceeds t
    const int64_t m = (l + h) >> 1;
    if (so[m] <= t)
      l = m + 1;
    else
      h = m;
  }
  const int64_t i = l - 1;
  const int64_t bi = lo[s * cap_a + i] + (t - so[i]);
  for (int k = 0; k < nout; ++k) {
    const int64_t by = ld[2 * nout + k];
    const int64_t row = k < na ? s * cap_a + i : s * cap_b + bi;
    copy_row((const char*)ld[k] + row * by, (char*)ld[nout + k] + o * by,
             by);
  }
}

// desc: 3 * K12_MAX_KEYS int64 (A key ptrs, B key ptrs, kinds); a_n, b_n:
// (N,) int32; lo, per, offs: (N, cap_a) int64; part: (N, max(1, nblk))
// int64 scratch, nblk = ceil(cap_a / 1024); totals: (N,) int64.
extern "C" int dpk_join_ranges(const int64_t* desc, int nk, int N,
                               int64_t cap_a, int64_t cap_b,
                               const int32_t* a_n, const int32_t* b_n,
                               int64_t* lo, int64_t* per, int64_t* offs,
                               int64_t* part, int64_t* totals, void* stream) {
  if (nk < 1 || nk > K12_MAX_KEYS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (N == 0) return (int)cudaGetLastError();
  const int64_t nblk = (cap_a + K12_TILE - 1) / K12_TILE;
  if (nblk == 0) {
    cudaMemsetAsync(totals, 0, (size_t)N * sizeof(int64_t), st);
    return (int)cudaGetLastError();
  }
  const dim3 grid((unsigned)nblk, (unsigned)N);
  k12_ranges<<<grid, K12_TILE, 0, st>>>(desc, nk, cap_a, cap_b, a_n, b_n, lo,
                                        per, part, nblk);
  k12_scan<<<N, DPK_THREADS, 0, st>>>(part, nblk, totals);
  k12_offsets<<<grid, K12_TILE, 0, st>>>(per, part, cap_a, nblk, offs);
  return (int)cudaGetLastError();
}

// desc: 3 * nout int64 (source ptrs, A's na leaves first; output ptrs;
// row bytes); outputs (N, cap_out, ...); sent_bits / sent_width: key
// column 0's sentinel.
extern "C" int dpk_join_expand(const int64_t* desc, int na, int nout, int N,
                               int64_t cap_a, int64_t cap_b,
                               int64_t cap_out, const int32_t* a_n,
                               const int64_t* lo, const int64_t* offs,
                               const int64_t* totals, uint64_t sent_bits,
                               int sent_width, void* stream) {
  if (na < 1 || nout < na || nout > DPK_MAX_LEAVES ||
      (sent_width != 4 && sent_width != 8))
    return (int)cudaErrorInvalidValue;
  if (N == 0 || cap_out == 0) return (int)cudaGetLastError();
  const dim3 grid(
      (unsigned)((cap_out + K12_EXPAND_THREADS - 1) / K12_EXPAND_THREADS),
      (unsigned)N);
  k12_expand<<<grid, K12_EXPAND_THREADS, 0, (cudaStream_t)stream>>>(
      desc, na, nout, cap_a, cap_b, cap_out, a_n, lo, offs, totals,
      sent_bits, sent_width);
  return (int)cudaGetLastError();
}
