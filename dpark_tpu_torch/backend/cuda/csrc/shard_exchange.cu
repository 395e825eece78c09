// K4 shard_exchange: the ragged all-to-all among N logical shards that
// live on one card.  Destination shard d receives bucket d of every
// source shard, source-major (src 0's rows first), packed to the front;
// the key leaf's tail holds the sentinel and the other leaves' tails are
// zero.
//
// Replaces dpark_tpu/backend/tpu/collectives.py:197 exchange_round,
// :236 _grouped_all_to_all and :257 flatten_received, and
// dpark_tpu/backend/tpu/executor.py:2876 _exchange_all.  With every shard
// on one card there are no padded rounds: each output row finds its
// source from the (src, dst) count matrix and copies its leaves.
//
// Bound: bytes.  Every exchanged row is read once and written once (plus
// the padded tail written once); at N=8 with 65,536 keys per shard after
// the map-side combine, two int64 leaves, that is about 17 MB, 5 us at
// 3.35 TB/s, so the launch dominates.  Reads are coalesced runs (one run
// per source bucket), writes are contiguous.
#include "common.cuh"

static __global__ void k4_kernel(LeafSet L, const int32_t* counts,
                                 const int32_t* offsets, int N,
                                 int64_t cap_in, int64_t cap_out,
                                 int key_leaf, int64_t key_fill,
                                 int32_t* recv_counts) {
  extern __shared__ int64_t e_sm[];  // base[N + 1]
  const int d = blockIdx.y;
  if (threadIdx.x == 0) {
    int64_t acc = 0;
    for (int s = 0; s < N; ++s) {
      e_sm[s] = acc;
      acc += counts[(int64_t)s * N + d];
    }
    e_sm[N] = acc;
    if (blockIdx.x == 0) recv_counts[d] = (int32_t)acc;
  }
  __syncthreads();
  const int64_t total = e_sm[N];
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < cap_out; i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t drow = (int64_t)d * cap_out + i;
    if (i < total) {
      int lo = 0, hi = N - 1;  // last s with base[s] <= i
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (e_sm[mid] <= i) lo = mid; else hi = mid - 1;
      }
      const int s = lo;
      const int64_t srow = (int64_t)s * cap_in +
                           offsets[(int64_t)s * N + d] + (i - e_sm[s]);
      for (int l = 0; l < L.n; ++l) {
        const int64_t by = L.bytes[l];
        copy_row(L.src[l] + srow * by, L.dst[l] + drow * by, by);
      }
    } else {
      for (int l = 0; l < L.n; ++l) {
        const int64_t by = L.bytes[l];
        char* p = L.dst[l] + drow * by;
        if (l == key_leaf)
          store_key(p, (int)by, 0, key_fill);
        else
          zero_row(p, by);
      }
    }
  }
}

// leaves: src (N, cap_in, ...) bucket-sorted send buffers -> dst (N,
// cap_out, ...); counts/offsets: (N, N) int32 [src, dst]; key_leaf: the
// leaf whose tail takes key_fill (a 4- or 8-byte scalar column), or -1;
// recv_counts: (N,) out.  cap_out must hold the largest column sum of
// counts (the wrapper sizes it).
extern "C" int dpk_shard_exchange(const void* const* src, void* const* dst,
                                  const int64_t* bytes, int nleaves,
                                  const int32_t* counts,
                                  const int32_t* offsets, int N,
                                  int64_t cap_in, int64_t cap_out,
                                  int key_leaf, int64_t key_fill,
                                  int32_t* recv_counts, void* stream) {
  if (nleaves < 1 || nleaves > DPK_MAX_LEAVES || N < 1)
    return (int)cudaErrorInvalidValue;
  if (key_leaf >= 0 && bytes[key_leaf] != 8 && bytes[key_leaf] != 4)
    return (int)cudaErrorInvalidValue;
  LeafSet L = make_leafset(src, dst, bytes, nleaves);
  int64_t blocks = (cap_out + DPK_THREADS - 1) / DPK_THREADS;
  if (blocks > 4096) blocks = 4096;
  if (blocks < 1) blocks = 1;
  dim3 grid((unsigned)blocks, (unsigned)N);
  k4_kernel<<<grid, DPK_THREADS, (N + 1) * sizeof(int64_t),
              (cudaStream_t)stream>>>(L, counts, offsets, N, cap_in, cap_out,
                                      key_leaf, key_fill, recv_counts);
  return (int)cudaGetLastError();
}
