// K16 union_concat: the device union source's concatenation of its
// branch batches.
//
// Replaces dpark_tpu/backend/tpu/executor.py:2137-2170 (_compile_concat:
// per device, each branch's rows written one after another with
// dynamic_update_slice at the running sum of the earlier branches'
// counts, then sliced to cap_out), as driven by _concat_batches (:2119).
//
// Input: k branch batches with the same leaves; branch j's leaf l is a
// contiguous (N, cap_j, ...) tensor and its per-shard counts are known
// on the host (the wrapper's one read of all k count vectors sizes the
// output).  Output: (N, cap_out, ...) leaves where shard s holds branch
// 0's valid rows, then branch 1's, ..., and past the shard's total the
// key fill in the key leaf (the sentinel, as K4's exchange leaves its
// receive padding) and zeros in the others.  The reference leaves the
// branches' stale tail rows there instead.
//
// Bound: bytes.  Each valid row of every branch is read once and every
// output row (N * cap_out of each leaf, tails included) written once.
//
// Design: a batched copy and fill of byte spans, its table computed on
// the card.  The output of each shard is cut into tiles of K16_ROWS rows;
// block (x, l) takes tile x (shard x / tiles, tile x % tiles) of leaf l,
// reads its shard's k counts from the device into shared memory, k
// threads at once (the counts' running sum places each branch), and
// copies the pieces of the branches that fall
// in the tile -- each a contiguous byte span in its source and in the
// output -- then fills what lies past the shard's total.  So the grid is
// sized by the output, and the host builds no table: after its one read
// of the counts (which sizes cap_out) the wrapper only allocates and
// launches.  A span is written as whole 16-byte words between a head and
// a tail of fewer than 16 bytes; each word is loaded as 16 bytes, or,
// where the source and output offsets differ mod 16 (a branch starting
// at an odd row of 8 B, rows of 6 B), as the two aligned source words
// that cover it, shifted into place by funnel shifts.  The fill is
// 16-byte words of the key fill (or of zero); span_copy.cuh holds both
// moves, which K4 shares.  The branches' leaves and
// counts and the output leaves reach the kernel by value, as one
// __grid_constant__ parameter (nothing copied to the device).
#include "common.cuh"
#include "span_copy.cuh"

#define K16_THREADS 256
#define K16_ROWS 2048            // output rows of a tile
#define K16_UNROLL 4             // 16-byte words a thread has in flight
#define K16_MAX_BRANCHES 12      // kernels.MAX_UNION_BRANCHES

struct K16Args {
  const char* src[K16_MAX_BRANCHES][DPK_MAX_LEAVES];
  const int32_t* n[K16_MAX_BRANCHES];  // each branch's (N,) counts
  int64_t cap[K16_MAX_BRANCHES];       // each branch's rows a shard
  char* dst[DPK_MAX_LEAVES];           // (N, cap_out, ...), 16-B aligned
  int64_t bytes[DPK_MAX_LEAVES];       // row bytes of each leaf
  uint4 fill;                          // the key fill over 16 bytes
  int32_t* totals;                     // (N,) out
  int64_t cap_out, tiles;              // tiles a shard
  int k, key_leaf;
};

static __global__ void __launch_bounds__(K16_THREADS)
    k16_copy(const __grid_constant__ K16Args a) {
  const int l = blockIdx.y;
  const int64_t s = blockIdx.x / a.tiles, t = blockIdx.x - s * a.tiles;
  const int64_t lo = t * K16_ROWS;
  const int64_t hi = lo + K16_ROWS < a.cap_out ? lo + K16_ROWS : a.cap_out;
  const int64_t by = a.bytes[l];
  const char* base = a.dst[l];
  char* out = a.dst[l] + s * a.cap_out * by;
  // the shard's k counts, loaded at once (one load latency a block)
  __shared__ int cnt[K16_MAX_BRANCHES];
  if (threadIdx.x < a.k) cnt[threadIdx.x] = __ldg(a.n[threadIdx.x] + s);
  __syncthreads();
  int64_t at = 0;  // the shard's rows of the branches before j
#pragma unroll 1
  for (int j = 0; j < a.k; ++j) {
    const int64_t c = cnt[j];
    const int64_t p0 = lo > at ? lo : at;
    const int64_t p1 = hi < at + c ? hi : at + c;
    if (p0 < p1)
      span_copy<K16_THREADS, K16_UNROLL>(
          a.src[j][l] + (s * a.cap[j] + p0 - at) * by, out + p0 * by,
          (p1 - p0) * by);
    at += c;
  }
  if (t == 0 && l == 0 && threadIdx.x == 0) a.totals[s] = (int32_t)at;
  if (at < hi)
    span_fill<K16_THREADS>(base, out + (lo > at ? lo : at) * by,
                           (hi - (lo > at ? lo : at)) * by,
                           l == a.key_leaf ? a.fill : make_uint4(0, 0, 0, 0));
}

// k branches: src the k x nleaves source leaves (branch-major), n the k
// (N,) int32 count vectors (device), cap their rows a shard; the
// nleaves output leaves (N, cap_out, ...) (16-byte aligned) and their
// row bytes; key_leaf -1: no key fill; totals (N,) int32 out.  One
// launch.
extern "C" int dpk_union_concat(const void* const* src, int k,
                                const void* const* n, const int64_t* cap,
                                int N, int64_t cap_out, void* const* dst,
                                const int64_t* bytes, int nleaves,
                                int key_leaf, uint64_t key_fill,
                                int32_t* totals, void* stream) {
  if (nleaves < 1 || nleaves > DPK_MAX_LEAVES || k < 1 ||
      k > K16_MAX_BRANCHES || key_leaf >= nleaves || N < 0 || cap_out < 1)
    return (int)cudaErrorInvalidValue;
  K16Args a;
  a.k = k;
  a.key_leaf = key_leaf;
  a.totals = totals;
  a.cap_out = cap_out;
  a.tiles = (cap_out + K16_ROWS - 1) / K16_ROWS;
  for (int j = 0; j < K16_MAX_BRANCHES; ++j) {
    a.n[j] = j < k ? (const int32_t*)n[j] : nullptr;
    a.cap[j] = j < k ? cap[j] : 0;
  }
  for (int l = 0; l < DPK_MAX_LEAVES; ++l) {
    a.dst[l] = l < nleaves ? (char*)dst[l] : nullptr;
    a.bytes[l] = l < nleaves ? bytes[l] : 0;
    if (l < nleaves && ((uintptr_t)dst[l] & 15) != 0)
      return (int)cudaErrorInvalidValue;
    for (int j = 0; j < K16_MAX_BRANCHES; ++j)
      a.src[j][l] = j < k && l < nleaves
                        ? (const char*)src[(int64_t)j * nleaves + l]
                        : nullptr;
  }
  if (key_leaf >= 0 && bytes[key_leaf] != 8 && bytes[key_leaf] != 4)
    return (int)cudaErrorInvalidValue;
  a.fill = span_pattern(key_leaf >= 0 ? key_fill : 0,
                        key_leaf >= 0 ? (int)bytes[key_leaf] : 8);
  const int64_t grid = (int64_t)N * a.tiles;
  if (grid == 0) return (int)cudaGetLastError();
  if (grid > (int64_t)INT32_MAX) return (int)cudaErrorInvalidValue;
  k16_copy<<<dim3((unsigned)grid, (unsigned)nleaves), K16_THREADS, 0,
             (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
