// K13 rid_fold: the spilled-run stream's fold of each row's logical
// partition (rid in [0, r), r above the shard count) onto a shard, in one
// pass: dev = rid % n_dst on valid rows and n_dst on padding, the rid
// widened to int64 with the key sentinel on padding (the leading sort and
// merge column of the spilled-run combine), and each shard's histogram
// of dev.
//
// Replaces dpark_tpu/backend/tpu/collectives.py:446-449 (the device and
// rid columns of bucketize_combine_rid) and the destination bincount of
// its bucketize (:191), and the no-merge fold of
// dpark_tpu/backend/tpu/executor.py:2471-2476 (_compile_stream_nocombine).
//
// Bound: bytes.  It reads 4 B (rid) and writes 4 B (dev) + 8 B (rid64) a
// row; at N=8, cap=2^23 that is 1.07 GB, 0.32 ms at 3.35 TB/s.  Design:
// a grid-stride loop whose trip count is uniform across the block, so
// every warp can aggregate its histogram updates with __match_any_sync
// (one shared atomic per distinct dev a warp, not per row); each block
// flushes its shared histogram with one global atomic per bucket.
#include "common.cuh"

static __global__ void k13_kernel(const int32_t* rid, const int32_t* n,
                                  int64_t cap, int nd, int32_t* dev,
                                  int64_t* rid64, int32_t* hist) {
  extern __shared__ int h_sm[];
  const int s = blockIdx.y;
  for (int k = threadIdx.x; k <= nd; k += blockDim.x) h_sm[k] = 0;
  __syncthreads();
  const int64_t nv = n[s];
  const int64_t base = (int64_t)s * cap;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  for (int64_t i0 = (int64_t)blockIdx.x * blockDim.x; i0 < cap;
       i0 += stride) {
    const int64_t i = i0 + threadIdx.x;
    const bool live = i < cap;
    const unsigned act = __ballot_sync(DPK_FULL, live);
    if (live) {
      int d = nd;
      int64_t r64 = 0x7FFFFFFFFFFFFFFFLL;  // the key sentinel
      if (i < nv) {
        const int32_t r = rid[base + i];
        d = r % nd;
        r64 = (int64_t)r;
      }
      dev[base + i] = d;
      rid64[base + i] = r64;
      const unsigned peers = __match_any_sync(act, d);
      if (lane == __ffs(peers) - 1) atomicAdd(&h_sm[d], __popc(peers));
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k <= nd; k += blockDim.x)
    if (h_sm[k]) atomicAdd(&hist[(int64_t)s * (nd + 1) + k], h_sm[k]);
}

// rid: (N, cap) int32 logical partitions (read on valid rows only); n:
// (N,) valid rows; dev: (N, cap) int32 out; rid64: (N, cap) int64 out;
// hist: (N, nd+1) int32, zeroed by the caller.
extern "C" int dpk_rid_fold(const int32_t* rid, const int32_t* n, int N,
                            int64_t cap, int nd, int32_t* dev,
                            int64_t* rid64, int32_t* hist, void* stream) {
  if (nd < 1 || N < 1) return (int)cudaErrorInvalidValue;
  if (cap == 0) return (int)cudaGetLastError();
  int64_t blocks = (cap + DPK_THREADS - 1) / DPK_THREADS;
  if (blocks > 1024) blocks = 1024;
  dim3 grid((unsigned)blocks, (unsigned)N);
  const size_t smem = (size_t)(nd + 1) * sizeof(int);
  k13_kernel<<<grid, DPK_THREADS, smem, (cudaStream_t)stream>>>(
      rid, n, cap, nd, dev, rid64, hist);
  return (int)cudaGetLastError();
}
