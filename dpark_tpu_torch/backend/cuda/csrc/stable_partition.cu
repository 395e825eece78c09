// K2 stable_partition: stable counting sort of each shard's rows by a
// small integer bucket (the shuffle destination, or a 0/1 keep flag),
// gathering every leaf into the new order.
//
// Replaces dpark_tpu/backend/tpu/collectives.py:156 _dst_order and :176
// bucketize (the destination pass of the map-side _lex_sort at :417, and
// compact at :149 as a two-bucket partition).  The output order is
// bit-identical to a stable argsort of the bucket column.
//
// Three launches: per-block bucket counts; one exclusive scan per shard
// over (bucket, block) in bucket-major order; a scatter in which every
// row finds its stable rank inside its block (warp peers by
// __match_any_sync, then the counts of earlier warps) and copies each
// leaf from its source row (optionally through a prior permutation,
// src_idx, so the sort passes compose without an extra gather).
//
// Bound: bytes.  Per row it reads the bucket (4 B), the optional source
// index (4 B) and each leaf once, and writes each leaf and the sorted
// bucket once; at N=8, cap=2^23 with one int64 key and one int64 value
// (the map side's last sort pass) that is 2.95 GB, 0.88 ms at 3.35 TB/s.
// The reads through src_idx are a gather and the writes a scatter into
// nb runs, so neither is fully coalesced; a later kernel can stage a
// tile in shared memory first.
#include "common.cuh"

static __global__ void k2_count(const int32_t* bucket, int64_t cap, int nb,
                                int nblk, int32_t* blockcnt) {
  extern __shared__ int c_sm[];
  const int s = blockIdx.y;
  for (int k = threadIdx.x; k < nb; k += blockDim.x) c_sm[k] = 0;
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < cap) atomicAdd(&c_sm[bucket[(int64_t)s * cap + i]], 1);
  __syncthreads();
  for (int k = threadIdx.x; k < nb; k += blockDim.x)
    blockcnt[((int64_t)s * nb + k) * nblk + blockIdx.x] = c_sm[k];
}

static __global__ void k2_counts_out(const int32_t* blockoff, int64_t cap,
                                     int nb, int nblk, int32_t* counts,
                                     int N) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= N * nb) return;
  const int s = t / nb, b = t % nb;
  const int32_t* row = blockoff + (int64_t)s * nb * nblk;
  const int64_t lo = row[(int64_t)b * nblk];
  const int64_t hi = b + 1 < nb ? row[(int64_t)(b + 1) * nblk] : cap;
  counts[t] = (int32_t)(hi - lo);
}

static __global__ void k2_scatter(const int32_t* bucket,
                                  const int32_t* src_idx, int64_t cap,
                                  int nb, int nblk, const int32_t* blockoff,
                                  LeafSet L, int32_t* bucket_out) {
  extern __shared__ int w_sm[];  // [32 warps][nb]
  const int s = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t base = (int64_t)s * cap;
  const bool live = i < cap;
  const int b = live ? bucket[base + i] : 0;
  const int rank = block_stable_rank(live, b, nb, w_sm);
  if (!live) return;
  const int64_t pos =
      (int64_t)blockoff[((int64_t)s * nb + b) * nblk + blockIdx.x] + rank;
  const int64_t src = src_idx != nullptr ? (int64_t)src_idx[base + i] : i;
  for (int l = 0; l < L.n; ++l) {
    const int64_t by = L.bytes[l];
    copy_row(L.src[l] + (base + src) * by, L.dst[l] + (base + pos) * by, by);
  }
  if (bucket_out != nullptr) bucket_out[base + pos] = b;
}

// bucket: (N, cap) int32 in [0, nb), in the CURRENT row order; src_idx:
// (N, cap) int32 source row of each current row, or null (identity);
// leaves: src (N, cap, ...) -> dst (N, cap, ...); counts: (N, nb) out;
// blockcnt: (N, nb, ceil(cap/1024)) int32 scratch; bucket_out: (N, cap)
// int32 sorted bucket column, or null.
extern "C" int dpk_stable_partition(const int32_t* bucket,
                                    const int32_t* src_idx, int N,
                                    int64_t cap, int nb,
                                    const void* const* src,
                                    void* const* dst, const int64_t* bytes,
                                    int nleaves, int32_t* counts,
                                    int32_t* blockcnt, int32_t* bucket_out,
                                    void* stream) {
  if (nleaves < 0 || nleaves > DPK_MAX_LEAVES || nb < 1 || nb > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nblk = (int)((cap + DPK_THREADS - 1) / DPK_THREADS);
  if (nblk == 0) return (int)cudaGetLastError();
  LeafSet L = make_leafset(src, dst, bytes, nleaves);
  dim3 grid((unsigned)nblk, (unsigned)N);
  k2_count<<<grid, DPK_THREADS, nb * sizeof(int), st>>>(bucket, cap, nb,
                                                        nblk, blockcnt);
  scan_rows_excl<<<N, DPK_THREADS, 0, st>>>(blockcnt, (int64_t)nb * nblk,
                                            nullptr);
  k2_counts_out<<<(N * nb + 255) / 256, 256, 0, st>>>(blockcnt, cap, nb,
                                                      nblk, counts, N);
  k2_scatter<<<grid, DPK_THREADS, 32 * nb * sizeof(int), st>>>(
      bucket, src_idx, cap, nb, nblk, blockcnt, L, bucket_out);
  return (int)cudaGetLastError();
}
