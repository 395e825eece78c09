// K2 stable_partition: stable counting sort of each shard's rows by a
// small integer bucket (the shuffle destination, or a 0/1 keep flag),
// gathering every leaf into the new order.
//
// Replaces dpark_tpu/backend/tpu/collectives.py:156 _dst_order and :176
// bucketize (the destination pass of the map-side _lex_sort at :417, and
// compact at :149 as a two-bucket partition).  The output order is
// bit-identical to a stable argsort of the bucket column.
//
// One histogram pass, then one one-sweep pass (the scheme of K5's digit
// passes, radix_sort.cu, with the bucket as the digit):
// 1. k2_hist reads the bucket once, 16 bytes a load, and counts each
//    shard's buckets (a warp's rows of one bucket take one shared atomic
//    from a leader), unless the caller already holds the counts (K1's
//    histogram).
// 2. k2_pass: a block takes the next tile of a shard from an atomic
//    counter (so a tile's predecessors are always running and the
//    look-back makes progress; the tiles in flight at a time share a
//    shard, so that a gather through src_idx stays within one shard's
//    columns: dealing the shards' tiles in turn made shape (a) 20%
//    slower); loads the tile's buckets and source rows
//    coalesced, and at once sends asynchronous copies (cp.async) of the
//    first leaf column's values at those rows into shared memory
//    (through src_idx a gather, whose latency passes under what
//    follows); scans the shard's counts into the start of every bucket's
//    run; ranks the rows stably by warp-level multi-split (one ballot a
//    bucket bit: one at nb = 2); publishes its per-bucket counts as
//    aggregates in per-(tile, bucket) status words; gives every row its
//    place in the tile's bucket order; looks back over the earlier
//    tiles' words for its prefix; then, column by column, moves the
//    landed values into bucket order in shared memory, sends the next
//    column's copies, and writes this column out coalesced, in runs a
//    bucket (sorted row j of the tile goes to base[b] + prefix[b] + (j -
//    tile_start[b])).  A leaf is split into columns of its widest
//    aligned unit (8, 4, 2 or 1 bytes: a bool leaf moves a byte a row, a
//    (N, cap, 3) float32 leaf three 4-byte columns).  Every row's state
//    between the phases lives in shared memory (k2_smem: 60 or 92 KB a
//    tile of 4,096 rows), so that no register array is held across the
//    look-back; the leaf table sits there too: no parameter struct is
//    indexed in the row loop.
//
// Bound: bytes.  Per row it reads the bucket (4 B), the optional source
// index (4 B) and each leaf once, and writes each leaf and, when asked,
// the sorted bucket once; at N=8, cap=2^23 with one int64 key and one
// int64 value through src_idx (the map side's last sort pass) that is
// 2.95 GB, 0.88 ms at 3.35 TB/s.  Through src_idx the leaf reads are a
// gather: each 8-byte read moves a 32-byte sector (1.8 ms at that shape).
// What stays above it: the histogram pass (4 B a row), the status words
// (8 B a tile and bucket), the partial sectors at the ends of each
// bucket's run in a tile, and the latency of a tile's phases.
#include "common.cuh"

#define K2_THREADS 512
#define K2_ITEMS 8
#define K2_TILE (K2_THREADS * K2_ITEMS)
#define K2_WARPS (K2_THREADS / 32)
#define K2_MAX_NB 256
#define K2_LOOKBACK 8                     // status words a look-back load
#define K2_HIST_THREADS 512
#define K2_HIST_VECS 4                    // 4-row groups in flight a thread
#define K2_HIST_BLOCKS 3                  // blocks an SM holds
#define K2_AGG 1u                         // status tags: a tile's count
#define K2_INC 2u                         // ... and its inclusive prefix
#define K2_MIN_BLOCKS 2                   // blocks an SM holds

// dynamic shared memory of a pass, for leaf columns of at most vb bytes
// (4 or 8): one leaf column in row order and in bucket order (the
// latter first holds the per-warp bucket counts: K2_WARPS * nb ints, at
// most 16 KB), each row's source row (int32) and place in the tile
// (uint16), each sorted row's bucket: 60 KB a tile of 4,096 rows with
// 4-byte columns, 92 KB with 8-byte ones
__host__ __device__ constexpr size_t k2_smem(int vb) {
  return (size_t)K2_TILE * (2 * vb + 4 + 2 + 1);
}

// the lanes of the warp whose bucket equals this lane's, by one ballot a
// bit of the bucket (nbits bits); a lane that is not live sees only the
// others that are not.  Every lane of the warp must call it.
__device__ __forceinline__ unsigned bucket_peers(bool live, int b,
                                                 int nbits) {
  unsigned peers = __ballot_sync(DPK_FULL, live);
  if (!live) peers = ~peers;
  for (int bit = 0; bit < nbits; ++bit) {
    const unsigned m = __ballot_sync(DPK_FULL, (b >> bit) & 1);
    peers &= ((b >> bit) & 1) ? m : ~m;
  }
  return peers;
}

// each shard's bucket counts into counts (zeroed by the caller); a
// thread reads K2_HIST_VECS groups of 4 rows, 16 bytes a load where vec
// (the column 16-byte aligned and cap a multiple of 4)
static __global__ void __launch_bounds__(K2_HIST_THREADS, K2_HIST_BLOCKS)
    k2_hist(const int32_t* bucket, int64_t cap, int nb, int nbits, int vec,
            int32_t* counts) {
  __shared__ int h_sm[K2_MAX_NB];
  const int s = blockIdx.y, lane = threadIdx.x & 31;
  for (int k = threadIdx.x; k < nb; k += blockDim.x) h_sm[k] = 0;
  __syncthreads();
  const int32_t* col = bucket + (int64_t)s * cap;
  const int64_t step = (int64_t)blockDim.x * 4 * K2_HIST_VECS;
  for (int64_t i0 = (int64_t)blockIdx.x * step; i0 < cap;
       i0 += (int64_t)gridDim.x * step) {
    int b[K2_HIST_VECS][4];
#pragma unroll
    for (int q = 0; q < K2_HIST_VECS; ++q) {
      const int64_t r = i0 + 4 * ((int64_t)q * blockDim.x + threadIdx.x);
      if (vec && r < cap) {
        const int4 x = *(const int4*)(col + r);
        b[q][0] = x.x;
        b[q][1] = x.y;
        b[q][2] = x.z;
        b[q][3] = x.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) b[q][c] = r + c < cap ? col[r + c] : 0;
      }
    }
#pragma unroll
    for (int q = 0; q < K2_HIST_VECS; ++q) {
      const int64_t r = i0 + 4 * ((int64_t)q * blockDim.x + threadIdx.x);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool live = r + c < cap;
        const unsigned peers = bucket_peers(live, b[q][c], nbits);
        if (live && lane == 31 - __clz(peers))
          atomicAdd(&h_sm[b[q][c]], __popc(peers));
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nb; k += blockDim.x)
    if (h_sm[k]) atomicAdd(&counts[(int64_t)s * nb + k], h_sm[k]);
}

struct K2Args {
  const int32_t* bucket;        // (N, cap) in the current order
  const int32_t* src;           // (N, cap) source rows, or null
  int64_t cap;
  int64_t ntiles;               // tiles a shard
  int nb, nbits;
  const int32_t* counts;        // (N, nb) per-shard bucket counts
  unsigned long long* status;   // (N * ntiles, nb), zeroed
  unsigned long long* counter;  // the tile counter, zeroed
  int32_t* bucket_out;          // (N, cap) sorted bucket, or null
  int vb;                       // bytes of a column in shared memory
  int nleaves;
  const char* lsrc[DPK_MAX_LEAVES];
  char* ldst[DPK_MAX_LEAVES];
  int lbytes[DPK_MAX_LEAVES];   // row bytes
  int lunit[DPK_MAX_LEAVES];    // copy unit: 8, 4, 2 or 1 bytes
};

// an asynchronous copy of B (4 or 8) bytes from device to shared memory
template <int B>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(sa), "l"(gmem), "n"(B) : "memory");
}

// column u (of `units` units of `unit` bytes a row) of a leaf at this
// thread's rows, into s_row in row order: a row's value from row
// s_sr[r] (through src_idx a gather), 4- and 8-byte units as
// asynchronous copies (committed as one group), narrower ones at once
__device__ __forceinline__ void gather_col(unsigned char* s_row,
                                           const int32_t* s_sr,
                                           const char* sp, int unit,
                                           int units, int u, int64_t base,
                                           int r0, int nvalid) {
#pragma unroll
  for (int k = 0; k < K2_ITEMS; ++k) {
    const int r = r0 + k * 32;
    if (r >= nvalid) continue;
    const int64_t e = (base + s_sr[r]) * units + u;
    if (unit == 8)
      cp_async<8>(s_row + (size_t)r * 8, sp + e * 8);
    else if (unit == 4)
      cp_async<4>(s_row + (size_t)r * 4, sp + e * 4);
    else if (unit == 2)
      ((uint16_t*)s_row)[r] = ((const uint16_t*)sp)[e];
    else
      s_row[r] = (unsigned char)sp[e];
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's rows from row order (s_row) to the tile's bucket order
// (s_sorted)
template <typename T>
__device__ __forceinline__ void move_col(const unsigned char* s_row,
                                         unsigned char* s_sorted,
                                         const uint16_t* s_tp, int r0,
                                         int nvalid) {
#pragma unroll
  for (int k = 0; k < K2_ITEMS; ++k) {
    const int r = r0 + k * 32;
    if (r < nvalid) ((T*)s_sorted)[s_tp[r]] = ((const T*)s_row)[r];
  }
}

// sorted row j of the tile to its place in the shard's output, in runs
// a bucket
template <typename T>
__device__ __forceinline__ void write_col(const unsigned char* s_sorted,
                                          const uint8_t* s_b,
                                          const int* s_gofs, char* dp,
                                          int units, int u, int64_t base,
                                          int nvalid) {
#pragma unroll
  for (int k = 0; k < K2_ITEMS; ++k) {
    const int j = k * K2_THREADS + threadIdx.x;
    if (j < nvalid)
      ((T*)dp)[(base + s_gofs[s_b[j]] + j) * units + u] =
          ((const T*)s_sorted)[j];
  }
}

// the one-sweep pass, a block a tile
static __global__ void __launch_bounds__(K2_THREADS, K2_MIN_BLOCKS)
    k2_pass(const K2Args a) {
  // dynamic (k2_smem): one leaf column in row order and in bucket order
  // (the latter first holds the per-warp bucket counts), each row's
  // source row and place in the tile, each sorted row's bucket
  extern __shared__ __align__(16) unsigned char k2_sm[];
  unsigned char* s_row = k2_sm;
  unsigned char* s_sorted = s_row + (size_t)K2_TILE * a.vb;
  int* s_wh = (int*)s_sorted;
  int32_t* s_sr = (int32_t*)(s_sorted + (size_t)K2_TILE * a.vb);
  uint16_t* s_tp = (uint16_t*)(s_sr + K2_TILE);
  uint8_t* s_b = (uint8_t*)(s_tp + K2_TILE);
  __shared__ int s_base[K2_MAX_NB], s_dstart[K2_MAX_NB], s_gofs[K2_MAX_NB];
  __shared__ int s_scan[32];
  __shared__ int s_tile;
  __shared__ const char* s_lsrc[DPK_MAX_LEAVES];
  __shared__ char* s_ldst[DPK_MAX_LEAVES];
  __shared__ int s_lbytes[DPK_MAX_LEAVES], s_lunit[DPK_MAX_LEAVES];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = a.nb;
  if (tid == 0) {
    s_tile = (int)atomicAdd(a.counter, 1ull);
#pragma unroll
    for (int l = 0; l < DPK_MAX_LEAVES; ++l) {
      s_lsrc[l] = a.lsrc[l];
      s_ldst[l] = a.ldst[l];
      s_lbytes[l] = a.lbytes[l];
      s_lunit[l] = a.lunit[l];
    }
  }
  for (int k = tid; k < K2_WARPS * nb; k += K2_THREADS) s_wh[k] = 0;
  __syncthreads();
  const int64_t g = s_tile;                 // global tile id, shard-major
  const int64_t s = g / a.ntiles, t = g - s * a.ntiles;
  const int64_t base = s * a.cap, t0 = t * K2_TILE;
  const int nvalid = a.cap - t0 < K2_TILE ? (int)(a.cap - t0) : K2_TILE;

  // load: warp w takes tile rows [w*32*ITEMS, +32*ITEMS), item k of lane
  // l is row k*32 + l of that run, so (warp, item, lane) is row order;
  // the first leaf column's reads go out at once, so that their latency
  // (a gather through src) passes under the ranking and the look-back
  const int r0 = warp * 32 * K2_ITEMS + lane;
  int bk[K2_ITEMS];
#pragma unroll
  for (int k = 0; k < K2_ITEMS; ++k) {
    const int r = r0 + k * 32;
    bk[k] = 0;
    if (r < nvalid) {
      bk[k] = a.bucket[base + t0 + r];
      s_sr[r] = a.src != nullptr ? a.src[base + t0 + r] : (int32_t)(t0 + r);
    }
  }
  if (a.nleaves > 0)
    gather_col(s_row, s_sr, s_lsrc[0], s_lunit[0],
               s_lbytes[0] / s_lunit[0], 0, base, r0, nvalid);

  // the start of every bucket's run in the shard's output
  int total;
  const int sb = block_excl_scan(tid < nb ? a.counts[s * nb + tid] : 0,
                                 s_scan, &total);
  if (tid < nb) s_base[tid] = sb;

  // rank: each row's place among the warp's earlier rows of its bucket
  int* wh = s_wh + warp * nb;
  int tp[K2_ITEMS];
#pragma unroll
  for (int k = 0; k < K2_ITEMS; ++k) {
    const bool live = r0 + k * 32 < nvalid;
    const unsigned peers = bucket_peers(live, bk[k], a.nbits);
    const int leader = 31 - __clz(peers);
    int old = 0;
    if (lane == leader && live) {
      old = wh[bk[k]];
      wh[bk[k]] = old + __popc(peers);
    }
    old = __shfl_sync(DPK_FULL, old, leader);
    tp[k] = old + __popc(peers & ((1u << lane) - 1u));
    __syncwarp();
  }
  __syncthreads();

  // per bucket: the counts of earlier warps, the tile's count, published
  // at once so that later tiles' look-backs can pass this one
  int cnt = 0;
  unsigned long long* my = a.status + g * nb + tid;
  if (tid < nb) {
    for (int w = 0; w < K2_WARPS; ++w) {
      const int c = s_wh[w * nb + tid];
      s_wh[w * nb + tid] = cnt;
      cnt += c;
    }
    st_status(my, ((unsigned long long)(t > 0 ? K2_AGG : K2_INC) << 32) |
                      (unsigned)cnt);
  }
  const int start = block_excl_scan(tid < nb ? cnt : 0, s_scan, &total);
  if (tid < nb) s_dstart[tid] = start;
  __syncthreads();

  // each row's place in the tile's bucket order
#pragma unroll
  for (int k = 0; k < K2_ITEMS; ++k) {
    const int r = r0 + k * 32;
    if (r < nvalid) {
      const int b = bk[k];
      const int p = tp[k] + s_dstart[b] + wh[b];
      s_tp[r] = (uint16_t)p;
      s_b[p] = (uint8_t)b;
    }
  }

  // look back over the shard's earlier tiles, K2_LOOKBACK status words a
  // round trip: sum the aggregates up to the nearest inclusive prefix
  if (tid < nb) {
    unsigned excl = 0;
    if (t > 0) {
      const unsigned long long* col = a.status + s * a.ntiles * nb + tid;
      unsigned polls = 0;
      for (int64_t p = t - 1; p >= 0;) {
        unsigned long long w[K2_LOOKBACK];
#pragma unroll
        for (int q = 0; q < K2_LOOKBACK; ++q)
          w[q] = p - q >= 0 ? ld_status(col + (p - q) * nb) : 0ull;
        int used = 0;
        bool found = false, stop = false;
#pragma unroll
        for (int q = 0; q < K2_LOOKBACK; ++q) {
          const unsigned tag = (unsigned)(w[q] >> 32);
          if (!stop && (tag == K2_AGG || tag == K2_INC)) {
            excl += (unsigned)w[q];
            ++used;
            found = tag == K2_INC;
            stop = found;
          } else {
            stop = true;  // not yet published: read it again
          }
        }
        if (found) break;
        p -= used;
        // an earlier tile's block is resident (it took its id first), so
        // its word comes within microseconds; a fault that lost it traps
        // (a launch error) instead of hanging the card
        if (used == 0 && ++polls == (1u << 26)) __trap();
      }
      st_status(my, ((unsigned long long)K2_INC << 32) |
                        (excl + (unsigned)cnt));
    }
    s_gofs[tid] = s_base[tid] + (int)excl - start;
  }
  __syncthreads();

  if (a.bucket_out != nullptr) {
#pragma unroll
    for (int k = 0; k < K2_ITEMS; ++k) {
      const int j = k * K2_THREADS + tid;
      if (j < nvalid) {
        const int b = s_b[j];
        a.bucket_out[base + s_gofs[b] + j] = b;
      }
    }
  }

  // every leaf column: once its reads have landed, moved into bucket
  // order in shared memory; the next column's reads go out; this column
  // is written out coalesced
  for (int l = 0; l < a.nleaves; ++l) {
    char* dp = s_ldst[l];
    const int unit = s_lunit[l], units = s_lbytes[l] / unit;
    for (int u = 0; u < units; ++u) {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();          // the column is in s_row, s_sorted free
      if (unit == 8)
        move_col<unsigned long long>(s_row, s_sorted, s_tp, r0, nvalid);
      else if (unit == 4)
        move_col<uint32_t>(s_row, s_sorted, s_tp, r0, nvalid);
      else if (unit == 2)
        move_col<uint16_t>(s_row, s_sorted, s_tp, r0, nvalid);
      else
        move_col<uint8_t>(s_row, s_sorted, s_tp, r0, nvalid);
      __syncthreads();          // s_sorted complete, s_row free
      const int l2 = u + 1 < units ? l : l + 1;
      const int u2 = u + 1 < units ? u + 1 : 0;
      if (l2 < a.nleaves)
        gather_col(s_row, s_sr, s_lsrc[l2], s_lunit[l2],
                   s_lbytes[l2] / s_lunit[l2], u2, base, r0, nvalid);
      if (unit == 8)
        write_col<unsigned long long>(s_sorted, s_b, s_gofs, dp, units, u,
                                      base, nvalid);
      else if (unit == 4)
        write_col<uint32_t>(s_sorted, s_b, s_gofs, dp, units, u, base,
                            nvalid);
      else if (unit == 2)
        write_col<uint16_t>(s_sorted, s_b, s_gofs, dp, units, u, base,
                            nvalid);
      else
        write_col<uint8_t>(s_sorted, s_b, s_gofs, dp, units, u, base,
                           nvalid);
    }
  }
}

// bucket: (N, cap) int32 in [0, nb), in the CURRENT row order; src_idx:
// (N, cap) int32 source row of each current row, or null (identity);
// leaves: src (N, cap, ...) -> dst (N, cap, ...), `bytes` a row; counts:
// (N, nb) int32, the per-shard bucket counts when have_counts, else
// zeroed by the caller and counted here; status: (N * ceil(cap /
// K2_TILE) * nb + 1) uint64 zeroed by the caller (the look-back's words,
// then the tile counter); bucket_out: (N, cap) int32 sorted bucket
// column, or null.
extern "C" int dpk_stable_partition(const int32_t* bucket,
                                    const int32_t* src_idx, int N,
                                    int64_t cap, int nb,
                                    const void* const* src,
                                    void* const* dst, const int64_t* bytes,
                                    int nleaves, int32_t* counts,
                                    int have_counts, void* status,
                                    int32_t* bucket_out, void* stream) {
  if (nleaves < 0 || nleaves > DPK_MAX_LEAVES || nb < 1 ||
      nb > K2_MAX_NB || N < 1 || cap >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < nleaves; ++l)
    if (bytes[l] < 1 || bytes[l] >= (1ll << 31))
      return (int)cudaErrorInvalidValue;
  if (cap == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int nbits = nb > 1 ? 32 - __builtin_clz((unsigned)(nb - 1)) : 0;
  if (!have_counts) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const int64_t step = (int64_t)K2_HIST_THREADS * 4 * K2_HIST_VECS;
    int64_t blocks = (cap + step - 1) / step;
    const int64_t most = ((int64_t)sms * K2_HIST_BLOCKS + N - 1) / N;
    if (blocks > most) blocks = most;
    const int vec = ((uintptr_t)bucket & 15) == 0 && cap % 4 == 0;
    k2_hist<<<dim3((unsigned)blocks, (unsigned)N), K2_HIST_THREADS, 0,
              st>>>(bucket, cap, nb, nbits, vec, counts);
  }
  K2Args a;
  a.bucket = bucket;
  a.src = src_idx;
  a.cap = cap;
  a.ntiles = (cap + K2_TILE - 1) / K2_TILE;
  a.nb = nb;
  a.nbits = nbits;
  a.counts = counts;
  a.status = (unsigned long long*)status;
  a.counter = a.status + (int64_t)N * a.ntiles * nb;
  a.bucket_out = bucket_out;
  a.nleaves = nleaves;
  for (int l = 0; l < DPK_MAX_LEAVES; ++l) {
    const bool on = l < nleaves;
    a.lsrc[l] = on ? (const char*)src[l] : nullptr;
    a.ldst[l] = on ? (char*)dst[l] : nullptr;
    a.lbytes[l] = on ? (int)bytes[l] : 1;
    // the widest unit that divides the row and both base addresses
    int unit = 8;
    while (on && unit > 1 &&
           (bytes[l] % unit || (uintptr_t)src[l] % unit ||
            (uintptr_t)dst[l] % unit))
      unit >>= 1;
    a.lunit[l] = on ? unit : 1;
  }
  a.vb = 4;
  for (int l = 0; l < nleaves; ++l) a.vb = a.lunit[l] > a.vb ? 8 : a.vb;
  static unsigned long long ready = 0;  // devices given the smem attribute
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!((ready >> dev) & 1ull)) {
    e = cudaFuncSetAttribute(k2_pass,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)k2_smem(8));
    if (e != cudaSuccess) return (int)e;
    ready |= 1ull << dev;
  }
  k2_pass<<<(unsigned)(N * a.ntiles), K2_THREADS, k2_smem(a.vb), st>>>(a);
  return (int)cudaGetLastError();
}
