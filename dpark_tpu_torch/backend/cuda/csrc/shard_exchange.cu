// K4 shard_exchange: the ragged all-to-all among N logical shards that
// live on one card.  Destination shard d receives bucket d of every
// source shard, source-major (src 0's rows first), packed to the front;
// the key leaf's tail holds the key fill (the sentinel) and the other
// leaves' tails are zero.
//
// Replaces dpark_tpu/backend/tpu/collectives.py:197 exchange_round,
// :236 _grouped_all_to_all and :257 flatten_received, and
// dpark_tpu/backend/tpu/executor.py:2876 _exchange_all.  With every shard
// on one card there are no padded rounds: destination d's output is the
// concatenation of the spans (s, d), s = 0 .. N-1, each contiguous in its
// source and in the output, then the tail.
//
// Bound: bytes.  Every exchanged row is read once and written once, the
// padded tail written once.
//
// Design: a batched copy and fill of byte spans over the (src, dst)
// count matrix, as K16 copies a union's branches (span_copy.cuh holds the
// moves both use).  The output of each destination is cut into tiles of
// K4_ROWS rows; block (x, l) takes tile x (destination x / tiles, tile x
// % tiles) of leaf l.  It reads its destination's column of `counts` and
// `offsets` into shared memory, N threads at once, and takes their
// running sum with a block scan; a bisection over it finds the first
// source span that reaches the tile.  Each span piece in the tile is
// copied in 16-byte words (funnel shifts where the source and output
// offsets differ mod 16), then what lies past the destination's total is
// filled with 16-byte words of the key fill (or of zero).  The grid is
// sized by the output; the leaves and the fill reach the kernel by value
// as one __grid_constant__ parameter whose only run-time index is the
// block's leaf, and recv_counts is written on the card.
#include "common.cuh"
#include "span_copy.cuh"

#define K4_THREADS 256
#define K4_ROWS 2048             // output rows of a tile
#define K4_UNROLL 4              // 16-byte words a thread has in flight
#define K4_MAX_SHARDS 2048       // base[N + 1] and off[N] in 48 KB

struct K4Args {
  const char* src[DPK_MAX_LEAVES];  // (N, cap_in, ...) bucket-sorted
  char* dst[DPK_MAX_LEAVES];        // (N, cap_out, ...), 16-B aligned
  int64_t bytes[DPK_MAX_LEAVES];    // row bytes of each leaf
  uint4 fill;                       // the key fill over 16 bytes
  const int32_t* counts;            // (N, N) [src, dst]
  const int32_t* offsets;           // (N, N) [src, dst]
  int32_t* recv;                    // (N,) out
  int64_t cap_in, cap_out, tiles;   // tiles a destination
  int N, key_leaf;
};

static __global__ void __launch_bounds__(K4_THREADS)
    k4_exchange(const __grid_constant__ K4Args a) {
  extern __shared__ int64_t k4_sm[];  // base[N + 1], off[N]
  __shared__ int scan_sm[32];
  int64_t* base = k4_sm;
  int64_t* off = k4_sm + a.N + 1;
  const int l = blockIdx.y;
  const int64_t d = blockIdx.x / a.tiles, t = blockIdx.x - d * a.tiles;
  // the destination's column, K4_THREADS sources at once
  int64_t carry = 0;
  for (int s0 = 0; s0 < a.N; s0 += K4_THREADS) {
    const int s = s0 + threadIdx.x;
    int c = 0;
    if (s < a.N) {
      c = __ldg(a.counts + (int64_t)s * a.N + d);
      off[s] = __ldg(a.offsets + (int64_t)s * a.N + d);
    }
    int tot;
    const int ex = block_excl_scan(c, scan_sm, &tot);
    if (s < a.N) base[s] = carry + ex;
    carry += tot;
  }
  if (threadIdx.x == 0) base[a.N] = carry;
  __syncthreads();
  const int64_t total = carry;
  if (t == 0 && l == 0 && threadIdx.x == 0) a.recv[d] = (int32_t)total;
  const int64_t lo = t * K4_ROWS;
  const int64_t hi = lo + K4_ROWS < a.cap_out ? lo + K4_ROWS : a.cap_out;
  const int64_t by = a.bytes[l];
  char* out = a.dst[l] + d * a.cap_out * by;
  if (lo < total) {
    // the last source whose span starts at or before lo
    int s = 0, top = a.N - 1;
    while (s < top) {
      const int mid = (s + top + 1) >> 1;
      if (base[mid] <= lo)
        s = mid;
      else
        top = mid - 1;
    }
#pragma unroll 1
    for (; s < a.N && base[s] < hi; ++s) {
      const int64_t p0 = lo > base[s] ? lo : base[s];
      const int64_t p1 = hi < base[s + 1] ? hi : base[s + 1];
      if (p0 < p1)
        span_copy<K4_THREADS, K4_UNROLL>(
            a.src[l] + ((int64_t)s * a.cap_in + off[s] + p0 - base[s]) * by,
            out + p0 * by, (p1 - p0) * by);
    }
  }
  if (total < hi) {
    const int64_t f0 = lo > total ? lo : total;
    span_fill<K4_THREADS>(a.dst[l], out + f0 * by, (hi - f0) * by,
                          l == a.key_leaf ? a.fill : make_uint4(0, 0, 0, 0));
  }
}

// leaves: src (N, cap_in, ...) bucket-sorted send buffers -> dst (N,
// cap_out, ...) (16-byte aligned); counts/offsets: (N, N) int32 [src,
// dst] (device); key_leaf: the leaf whose tail takes key_fill (a 4- or
// 8-byte scalar column, key_fill its bits), or -1; recv_counts: (N,)
// out.  cap_out must hold the largest column sum of counts (the wrapper
// sizes it).  One launch.
extern "C" int dpk_shard_exchange(const void* const* src, void* const* dst,
                                  const int64_t* bytes, int nleaves,
                                  const int32_t* counts,
                                  const int32_t* offsets, int N,
                                  int64_t cap_in, int64_t cap_out,
                                  int key_leaf, int64_t key_fill,
                                  int32_t* recv_counts, void* stream) {
  if (nleaves < 1 || nleaves > DPK_MAX_LEAVES || N < 1 ||
      N > K4_MAX_SHARDS || key_leaf >= nleaves || cap_out < 1)
    return (int)cudaErrorInvalidValue;
  if (key_leaf >= 0 && bytes[key_leaf] != 8 && bytes[key_leaf] != 4)
    return (int)cudaErrorInvalidValue;
  K4Args a;
  for (int l = 0; l < DPK_MAX_LEAVES; ++l) {
    a.src[l] = l < nleaves ? (const char*)src[l] : nullptr;
    a.dst[l] = l < nleaves ? (char*)dst[l] : nullptr;
    a.bytes[l] = l < nleaves ? bytes[l] : 0;
    if (l < nleaves && ((uintptr_t)dst[l] & 15) != 0)
      return (int)cudaErrorInvalidValue;
  }
  a.fill = span_pattern((uint64_t)key_fill,
                        key_leaf >= 0 ? (int)bytes[key_leaf] : 8);
  a.counts = counts;
  a.offsets = offsets;
  a.recv = recv_counts;
  a.cap_in = cap_in;
  a.cap_out = cap_out;
  a.tiles = (cap_out + K4_ROWS - 1) / K4_ROWS;
  a.N = N;
  a.key_leaf = key_leaf;
  const int64_t grid = (int64_t)N * a.tiles;
  if (grid > (int64_t)INT32_MAX) return (int)cudaErrorInvalidValue;
  k4_exchange<<<dim3((unsigned)grid, (unsigned)nleaves), K4_THREADS,
                (2 * N + 1) * sizeof(int64_t), (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
