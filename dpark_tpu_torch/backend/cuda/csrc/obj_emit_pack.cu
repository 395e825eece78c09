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
// Three launches, as K2's: per-(shard, tile) counts of kept slots, one
// exclusive scan per shard over the tiles in (block, tile) order (its row
// totals are the counts), then a scatter in which each kept slot takes
// its rank inside its tile from a block-wide scan of the keep flags.  The
// wrapper reads the counts between the second and third launch to size
// the outputs exactly (one host sync a superstep).  The scatter's extra
// tiles past the last block's fill each shard's tail.
//
// The block descriptors live in a small int64 table in device memory
// (read once per CUDA block into shared memory), not in a parameter
// struct indexed by a loop variable: a superstep has up to 2 x 24 blocks.
//
// Bound: bytes.  Every gate (1 B a row) is read, and the dst slots (8 B)
// of the rows whose gate is set (both passes read a slot's gate before
// its target); each kept slot's leaf rows are read and its packed row
// (8 B + leaves) written once.  The second pass rereads the gates and
// targets (L2 for small blocks); staging a tile in shared memory is
// later work.
#include "common.cuh"

#define K11_TILE 1024
// descriptor row of one block: gate, dst, cap, m, first tile, leaf ptrs
#define K11_FIXED 5

// Last block whose first tile is <= t (blocks with no tiles share their
// first tile with the next block and are skipped).
__device__ __forceinline__ int k11_block_of(const int64_t* desc, int nblocks,
                                            int W, int64_t t) {
  int b = 0;
  while (b + 1 < nblocks && desc[(int64_t)(b + 1) * W + 4] <= t) ++b;
  return b;
}

static __global__ void k11_count(const int64_t* desc, int nblocks, int W,
                                 int64_t tiles, int32_t* tilecnt) {
  __shared__ int64_t d[K11_FIXED];
  const int s = blockIdx.y;
  const int64_t t = blockIdx.x;
  if (threadIdx.x == 0) {
    const int b = k11_block_of(desc, nblocks, W, t);
    for (int k = 0; k < K11_FIXED; ++k) d[k] = desc[(int64_t)b * W + k];
  }
  __syncthreads();
  const int64_t cap = d[2], m = d[3];
  const int64_t k = (t - d[4]) * K11_TILE + threadIdx.x;
  bool keep = false;
  if (k < cap * m) {
    const bool* gate = (const bool*)d[0];
    const int64_t* dst = (const int64_t*)d[1];
    keep = gate[(int64_t)s * cap + k / m] &&
           dst[(int64_t)s * cap * m + k] != INT64_MAX;
  }
  const int c = __syncthreads_count(keep);
  if (threadIdx.x == 0) tilecnt[(int64_t)s * tiles + t] = c;
}

static __global__ void k11_scatter(const int64_t* desc, int nblocks, int W,
                                   int nleaves, int64_t tiles,
                                   const int32_t* tileoff,
                                   const int32_t* counts, int64_t cap_out,
                                   int64_t* dst_out) {
  __shared__ int64_t d[K11_FIXED + DPK_MAX_LEAVES];
  __shared__ int64_t lb[DPK_MAX_LEAVES];  // row bytes of each leaf
  __shared__ int64_t op[DPK_MAX_LEAVES];  // output leaf pointers
  __shared__ int sm[32];
  const int s = blockIdx.y;
  const int64_t t = blockIdx.x;
  const int64_t* tail = desc + (int64_t)nblocks * W;
  if (threadIdx.x < nleaves) {
    lb[threadIdx.x] = tail[threadIdx.x];
    op[threadIdx.x] = tail[nleaves + threadIdx.x];
  }
  if (t >= tiles) {  // fill the tail: SENT targets, zero leaves
    __syncthreads();
    const int64_t p = (t - tiles) * K11_TILE + threadIdx.x;
    if (p < cap_out && p >= (int64_t)counts[s]) {
      const int64_t o = (int64_t)s * cap_out + p;
      dst_out[o] = INT64_MAX;
      for (int l = 0; l < nleaves; ++l)
        zero_row((char*)op[l] + o * lb[l], lb[l]);
    }
    return;
  }
  if (threadIdx.x == 0) {
    const int b = k11_block_of(desc, nblocks, W, t);
    for (int k = 0; k < K11_FIXED + nleaves; ++k)
      d[k] = desc[(int64_t)b * W + k];
  }
  __syncthreads();
  const int64_t cap = d[2], m = d[3];
  const int64_t k = (t - d[4]) * K11_TILE + threadIdx.x;
  const int64_t src = (int64_t)s * cap * m + k;
  const int64_t* dst = (const int64_t*)d[1];
  bool keep = false;
  int64_t target = 0;
  // the gate first: a closed row's targets are never read
  if (k < cap * m && ((const bool*)d[0])[(int64_t)s * cap + k / m]) {
    target = dst[src];
    keep = target != INT64_MAX;
  }
  int total;
  const int rank = block_excl_scan(keep ? 1 : 0, sm, &total);
  if (!keep) return;
  const int64_t o =
      (int64_t)s * cap_out + (int64_t)tileoff[(int64_t)s * tiles + t] + rank;
  dst_out[o] = target;
  for (int l = 0; l < nleaves; ++l)
    copy_row((const char*)d[K11_FIXED + l] + src * lb[l],
             (char*)op[l] + o * lb[l], lb[l]);
}

// desc: nblocks rows of W = 5 + nleaves int64 (gate ptr, dst ptr, cap, m,
// first tile, nleaves leaf ptrs), then nleaves row bytes, then nleaves
// output leaf ptrs; tiles: the tiles of one shard over all blocks;
// tileoff: (N, tiles) int32 scratch (exclusive offsets on return);
// counts: (N,) int32 kept slots of each shard.
extern "C" int dpk_obj_emit_count(const int64_t* desc, int nblocks, int W,
                                  int N, int64_t tiles, int32_t* tileoff,
                                  int32_t* counts, void* stream) {
  if (nblocks < 1 || W < K11_FIXED || W > K11_FIXED + DPK_MAX_LEAVES)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (N == 0) return (int)cudaGetLastError();
  if (tiles == 0) {
    cudaMemsetAsync(counts, 0, (size_t)N * sizeof(int32_t), st);
    return (int)cudaGetLastError();
  }
  k11_count<<<dim3((unsigned)tiles, (unsigned)N), K11_TILE, 0, st>>>(
      desc, nblocks, W, tiles, tileoff);
  scan_rows_excl<<<N, DPK_THREADS, 0, st>>>(tileoff, tiles, counts);
  return (int)cudaGetLastError();
}

// dst_out: (N, cap_out) int64; the output leaves are named in desc.
extern "C" int dpk_obj_emit_scatter(const int64_t* desc, int nblocks, int W,
                                    int nleaves, int N, int64_t tiles,
                                    const int32_t* tileoff,
                                    const int32_t* counts, int64_t cap_out,
                                    int64_t* dst_out, void* stream) {
  if (nblocks < 1 || nleaves < 0 || nleaves > DPK_MAX_LEAVES ||
      W != K11_FIXED + nleaves)
    return (int)cudaErrorInvalidValue;
  const int64_t grid = tiles + (cap_out + K11_TILE - 1) / K11_TILE;
  if (N == 0 || grid == 0) return (int)cudaGetLastError();
  k11_scatter<<<dim3((unsigned)grid, (unsigned)N), K11_TILE, 0,
                (cudaStream_t)stream>>>(desc, nblocks, W, nleaves, tiles,
                                        tileoff, counts, cap_out, dst_out);
  return (int)cudaGetLastError();
}
