// K11 obj_emit_pack: pack the messages one object-Bagel superstep emits.
//
// Replaces dpark_tpu/backend/tpu/bagel_obj.py:892-913
// (DeviceObjectPregel._p_step: each emission block's
// `where(gate[:, None], dst, SENT)` and reshape, the `concatenate` of the
// blocks, then `compact(..., dst != SENT)`), stopping before the
// bucketize-combine.  The output is bit-identical to that sequence.
//
// An emission block is one (degree class, mail / no-mail) trace of the
// user compute: a gate (N, cap) bool (the rows whose messages count),
// dst (N, cap, m) int64 targets and one (N, cap, m, ...) tensor per
// message leaf.  For each shard, the kept slots -- gate[s, i] and
// dst[s, i, j] != SENT -- are packed in (block, i, j) order to the front
// of (N, cap_out) outputs; the tail holds SENT (dst) and zeros (leaves).
//
// Bound: bytes.  Every gate (1 B a row) is read, and the dst slots (8 B)
// of the rows whose gate is set; each kept slot's leaf rows are read and
// its packed row (8 B + leaves) written once.
//
// Design.  A tile is 2,048 consecutive slots of one block and one shard
// (the slots of a block lie in (i, j) order in memory); a thread takes 8
// consecutive slots, finds their row with one 32-bit division, reads the
// gate once a row, and reads a pair of targets as one 16-byte word only
// where one of the pair's rows is open (a closed row's targets are never
// read).  Three launches and one host read a call:
// - k11_count: each tile's kept slots (tilecnt);
// - scan_rows_excl: each shard's tiles in (block, tile) order, in place
//   (exclusive offsets), with the shard totals (counts);
// - the wrapper reads the counts once, to size the outputs (cap_out, the
//   fine capacity class of the largest) and the tails;
// - k11_scatter: each tile again, the kept slots ranked by a block scan
//   of the threads' counts, each column (targets, then each leaf of 4, 8
//   or 16 B) staged in shared memory at its rank and written out as one
//   contiguous run (other widths are written row by row); the blocks past
//   the tiles fill each shard's tail from counts[s] on.
// The block descriptors come by value, as one __grid_constant__
// parameter of both kernels (no copy to the device, none after the host
// read); a CUDA block finds its emission block by a binary search over
// the first tiles.  The output leaves come by value too (a LeafSet read
// with compile-time indices).
#include "common.cuh"

#define K11_THREADS 256
#define K11_ITEMS 8                                // slots a thread
#define K11_TILE (K11_THREADS * K11_ITEMS)         // 2048 slots
// the most emission blocks a call (24 degree classes, mail and no-mail)
#define K11_MAX_BLOCKS 48

// the emission blocks of a call, passed by value (__grid_constant__: read
// in place, by a uniform index, never copied to local memory)
struct K11Desc {
  int64_t first[K11_MAX_BLOCKS + 1];  // first tile of each block; total
  const unsigned char* gate[K11_MAX_BLOCKS];
  const int64_t* dst[K11_MAX_BLOCKS];
  const char* leaf[K11_MAX_BLOCKS][DPK_MAX_LEAVES];
  int cap[K11_MAX_BLOCKS], m[K11_MAX_BLOCKS];
  int vec[K11_MAX_BLOCKS];  // cap * m even and dst 16-byte aligned
  int nblocks;
};

struct K11Block {
  const unsigned char* gate;
  const int64_t* dst;
  int cap, m;
  int64_t first;
  bool vec;
};

// the emission block of tile t: the last whose first tile is <= t
// (blocks with no tiles share their first tile with the next)
__device__ __forceinline__ int k11_find(const K11Desc& d, int64_t t) {
  int lo = 0, hi = d.nblocks;              // first[lo] <= t < first[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (d.first[mid] <= t)
      lo = mid;
    else
      hi = mid;
  }
  return lo;
}

__device__ __forceinline__ K11Block k11_block(const K11Desc& d, int b) {
  K11Block k;
  k.gate = d.gate[b];
  k.dst = d.dst[b];
  k.cap = d.cap[b];
  k.m = d.m[b];
  k.first = d.first[b];
  k.vec = d.vec[b] != 0;
  return k;
}

// the thread's 8 slots from k0 (block-local, shard s): bit i of the
// result set where slot k0 + i is kept; its target in v[i]
__device__ __forceinline__ unsigned k11_keep(const K11Block& b, int s,
                                             int k0, int64_t* v) {
  const int64_t slots = (int64_t)b.cap * b.m;
  const unsigned char* gate = b.gate + (int64_t)s * b.cap;
  const int64_t* dst = b.dst + (int64_t)s * slots;
  bool open[K11_ITEMS];
  int row = k0 / b.m, j = k0 - row * b.m;
  unsigned char g = row < b.cap ? __ldg(gate + row) : 0;
#pragma unroll
  for (int i = 0; i < K11_ITEMS; ++i) {
    if (i > 0 && ++j == b.m) {
      j = 0;
      ++row;
      g = row < b.cap ? __ldg(gate + row) : 0;
    }
    open[i] = g != 0 && k0 + i < slots;
  }
  unsigned keep = 0;
  if (b.vec && k0 + K11_ITEMS <= slots) {
#pragma unroll
    for (int p = 0; p < K11_ITEMS; p += 2) {
      if (open[p] || open[p + 1]) {
        const longlong2 w = __ldg((const longlong2*)(dst + k0 + p));
        v[p] = w.x;
        v[p + 1] = w.y;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < K11_ITEMS; ++i)
      if (open[i]) v[i] = __ldg(dst + k0 + i);
  }
#pragma unroll
  for (int i = 0; i < K11_ITEMS; ++i)
    keep |= (unsigned)(open[i] && v[i] != INT64_MAX) << i;
  return keep;
}

static __global__ void __launch_bounds__(K11_THREADS)
    k11_count(const __grid_constant__ K11Desc d, int64_t tiles,
              int32_t* tilecnt) {
  __shared__ int sm[K11_THREADS / 32];
  const int s = blockIdx.y;
  const int64_t t = blockIdx.x;
  const K11Block b = k11_block(d, k11_find(d, t));
  const int k0 = (int)(t - b.first) * K11_TILE + threadIdx.x * K11_ITEMS;
  int64_t v[K11_ITEMS];
  int c = __popc(k11_keep(b, s, k0, v));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(DPK_FULL, c, o);
  if ((threadIdx.x & 31) == 0) sm[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < K11_THREADS / 32; ++w) total += sm[w];
    tilecnt[(int64_t)s * tiles + t] = total;
  }
}

// a column of kept rows of T (4, 8 or 16 B): each kept slot's row at its
// rank in shared memory, then the tile's run written out whole
template <typename T>
__device__ __forceinline__ void k11_stage(const T* src, unsigned keep,
                                          int rank0, int total, T* out,
                                          char* stage) {
  T* sbuf = (T*)stage;
  int r = rank0;
#pragma unroll
  for (int i = 0; i < K11_ITEMS; ++i)
    if (keep >> i & 1) sbuf[r++] = __ldg(src + i);
  __syncthreads();
  for (int i = threadIdx.x; i < total; i += K11_THREADS) out[i] = sbuf[i];
  __syncthreads();
}

// v (8 or 16 B of zeros or a pattern) over p[lo, hi) by the block
template <typename T>
__device__ __forceinline__ void k11_fill(T* p, int64_t lo, int64_t hi, T v) {
  for (int64_t i = lo + threadIdx.x; i < hi; i += K11_THREADS) p[i] = v;
}

static __global__ void __launch_bounds__(K11_THREADS)
    k11_scatter(const __grid_constant__ K11Desc d, int64_t tiles,
                const int32_t* tileoff, const int32_t* counts,
                int64_t cap_out, int64_t* dst_out,
                const __grid_constant__ LeafSet O) {
  __shared__ int sm[32];
  __shared__ __align__(16) char stage[K11_TILE * 16];
  const int s = blockIdx.y;
  const int64_t t = blockIdx.x;
  const int64_t obase = (int64_t)s * cap_out;
  if (t >= tiles) {  // the tail: SENT targets, zero leaves
    const int64_t lo = (int64_t)counts[s] + (t - tiles) * K11_TILE;
    const int64_t hi = lo + K11_TILE < cap_out ? lo + K11_TILE : cap_out;
    if (lo >= hi) return;
    k11_fill<long long>((long long*)dst_out + obase, lo, hi, INT64_MAX);
#pragma unroll
    for (int l = 0; l < DPK_MAX_LEAVES; ++l)
      if (l < O.n) {
        const int64_t by = O.bytes[l];
        char* base = O.dst[l] + obase * by;
        if (by % 8 == 0)
          k11_fill<long long>((long long*)base, lo * (by / 8),
                              hi * (by / 8), 0);
        else
          k11_fill<char>(base, lo * by, hi * by, 0);
      }
    return;
  }
  const int bi = k11_find(d, t);
  const K11Block b = k11_block(d, bi);
  const int k0 = (int)(t - b.first) * K11_TILE + threadIdx.x * K11_ITEMS;
  int64_t v[K11_ITEMS];
  const unsigned keep = k11_keep(b, s, k0, v);
  int total;
  const int rank0 = block_excl_scan(__popc(keep), sm, &total);
  if (total == 0) return;
  const int64_t o = obase + tileoff[(int64_t)s * tiles + t];
  {  // the targets: the values k11_keep read
    long long* sbuf = (long long*)stage;
    int r = rank0;
#pragma unroll
    for (int i = 0; i < K11_ITEMS; ++i)
      if (keep >> i & 1) sbuf[r++] = v[i];
    __syncthreads();
    for (int i = threadIdx.x; i < total; i += K11_THREADS)
      dst_out[o + i] = sbuf[i];
    __syncthreads();
  }
  const int64_t slot0 = (int64_t)s * b.cap * b.m + k0;
#pragma unroll
  for (int l = 0; l < DPK_MAX_LEAVES; ++l) {
    if (l < O.n) {
      const int64_t by = O.bytes[l];
      const char* src = d.leaf[bi][l] + slot0 * by;
      char* out = O.dst[l] + o * by;
      if (by == 8)
        k11_stage<unsigned long long>((const unsigned long long*)src, keep,
                                      rank0, total,
                                      (unsigned long long*)out, stage);
      else if (by == 4)
        k11_stage<unsigned>((const unsigned*)src, keep, rank0, total,
                            (unsigned*)out, stage);
      else if (by == 16 && ((uintptr_t)src & 15) == 0 &&
               ((uintptr_t)O.dst[l] & 15) == 0)
        k11_stage<uint4>((const uint4*)src, keep, rank0, total,
                         (uint4*)out, stage);
      else {
        int r = rank0;
        for (int i = 0; i < K11_ITEMS; ++i)
          if (keep >> i & 1) copy_row(src + i * by, out + (r++) * by, by);
      }
    }
  }
}

// Fills the descriptor of nblocks emission blocks: gate (N, cap[b])
// bool and dst (N, cap[b], m[b]) int64 of block b, first[b] its first
// tile (first[nblocks]: the tiles of a shard), leaves[b * nleaves + l]
// its message leaf l.
static int k11_desc(K11Desc* d, int nblocks, const void* const* gates,
                    const void* const* dsts, const int64_t* caps,
                    const int64_t* ms, const int64_t* first,
                    const void* const* leaves, int nleaves) {
  if (nblocks < 1 || nblocks > K11_MAX_BLOCKS || nleaves < 0 ||
      nleaves > DPK_MAX_LEAVES)
    return (int)cudaErrorInvalidValue;
  d->nblocks = nblocks;
  for (int b = 0; b <= nblocks; ++b) d->first[b] = first[b];
  for (int b = 0; b < nblocks; ++b) {
    if (caps[b] * ms[b] > INT32_MAX - K11_TILE)
      return (int)cudaErrorInvalidValue;
    d->gate[b] = (const unsigned char*)gates[b];
    d->dst[b] = (const int64_t*)dsts[b];
    d->cap[b] = (int)caps[b];
    d->m[b] = (int)ms[b];
    d->vec[b] = (caps[b] * ms[b]) % 2 == 0 && ((uintptr_t)dsts[b] & 15) == 0;
    for (int l = 0; l < nleaves; ++l)
      d->leaf[b][l] = leaves != nullptr
                          ? (const char*)leaves[(int64_t)b * nleaves + l]
                          : nullptr;
  }
  return 0;
}

// tileoff: (N, first[nblocks]) int32 scratch (exclusive offsets on
// return); counts: (N,) int32 kept slots of each shard.
extern "C" int dpk_obj_emit_count(int nblocks, const void* const* gates,
                                  const void* const* dsts,
                                  const int64_t* caps, const int64_t* ms,
                                  const int64_t* first, int N,
                                  int32_t* tileoff, int32_t* counts,
                                  void* stream) {
  K11Desc d;
  const int rc = k11_desc(&d, nblocks, gates, dsts, caps, ms, first,
                          nullptr, 0);
  if (rc != 0 || N > 65535 || first[nblocks] > INT32_MAX)
    return rc != 0 ? rc : (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t tiles = first[nblocks];
  if (N == 0) return (int)cudaGetLastError();
  if (tiles == 0) {
    cudaMemsetAsync(counts, 0, (size_t)N * sizeof(int32_t), st);
    return (int)cudaGetLastError();
  }
  k11_count<<<dim3((unsigned)tiles, (unsigned)N), K11_THREADS, 0, st>>>(
      d, tiles, tileoff);
  scan_rows_excl<<<N, DPK_THREADS, 0, st>>>(tileoff, tiles, counts);
  return (int)cudaGetLastError();
}

// dst_out: (N, cap_out) int64; out: nleaves (N, cap_out, ...) leaves of
// bytes[l] a row; fill_tiles: blocks a shard for the tails (the longest
// tail over K11_TILE, rounded up).
extern "C" int dpk_obj_emit_scatter(
    int nblocks, const void* const* gates, const void* const* dsts,
    const int64_t* caps, const int64_t* ms, const int64_t* first,
    const void* const* leaves, int nleaves, int N, const int32_t* tileoff,
    const int32_t* counts, int64_t cap_out, int64_t fill_tiles,
    int64_t* dst_out, void* const* out, const int64_t* bytes,
    void* stream) {
  K11Desc d;
  const int rc = k11_desc(&d, nblocks, gates, dsts, caps, ms, first,
                          leaves, nleaves);
  if (rc != 0 || N > 65535) return rc != 0 ? rc : (int)cudaErrorInvalidValue;
  const int64_t tiles = first[nblocks];
  const int64_t grid = tiles + fill_tiles;
  if (N == 0 || grid == 0) return (int)cudaGetLastError();
  const LeafSet O = make_leafset(out, out, bytes, nleaves);
  k11_scatter<<<dim3((unsigned)grid, (unsigned)N), K11_THREADS, 0,
                (cudaStream_t)stream>>>(d, tiles, tileoff, counts, cap_out,
                                        dst_out, O);
  return (int)cudaGetLastError();
}
