// K7 segment_table: the segment table of each shard's key-sorted rows —
// where each run of equal keys starts, how long it is, its power-of-two
// size class, the per-shard histogram of those classes, and the key of
// each run — in one sweep over the keys.
//
// Replaces dpark_tpu/backend/tpu/collectives.py:501 bucket_index, :515
// _segment_table, :539 segment_spans, :566 segment_sizes and :576
// bucket_histogram (the start-row scatter, the segment_sum of sizes and
// the bincount of size classes).
//
// A row starts a segment when it is valid (row < n[s]) and is row 0 or
// differs from the row before in ANY key column, compared with != in the
// column's type: -0.0 and +0.0 are one key, every NaN its own, as the
// reference's jnp != and the host's dict do.  Segment j of shard s gets
// start_rows[j], sizes[j] and bucket[j] = ceil(log2(size)) computed in
// integers (size 2^k lands in class k, never k+1); past n_seg[s] they
// hold 0, 0 and 32.  hist[s, b] counts the segments of class b.
//
// Bound: bytes.  It reads each key column once (8 B a row for int64)
// and writes start row, size and class (12 B) and each key of every
// segment; the contract also fills every slot of the (N, cap) outputs
// past n_seg: at N=8, cap=2^23, one int64 key and 8,192 segments a
// shard, 537 MB read and 1.34 GB of fills written, 0.56 ms at 3.35 TB/s
// (0.16 ms without the fills).
//
// One one-sweep launch (the scheme of K5's passes, radix_sort.cu),
// k7_sweep: a block takes the next work item from an atomic counter
// (sweep_item, common.cuh: each shard's tiles in order, its fill items
// spread among the next shard's tiles), so that whatever an item waits
// for is already running and every wait makes progress.  A tile:
// each thread loads its 16 consecutive rows of every key column 16 bytes
// at a time, and the row before them, and marks its segment starts; a
// block scan gives each thread the starts before it in the tile and the
// last of them; the tile publishes (starts, last start row) in its
// status word and one warp looks back over the earlier tiles' words, 32
// a load, for the shard's starts and last start before the tile.  Each
// start writes its row and its keys at its rank, and the size and class
// of the segment before it: that segment's start comes from the thread,
// the tile or the carried prefix, so start_rows is never read back; the
// owner of the last valid row closes the last segment and writes n_seg.
// Classes count in a shared histogram flushed with one global atomic per
// class and block.  Slots past n[s] take their fills from the tiles that
// hold them; slots in [n_seg, n) from the shard's fill items, which read
// n_seg from the inclusive word of the tile holding the last valid row;
// their writes overlap the next shard's reads.  Every fill
// is 16-byte stores.
#include "common.cuh"

#define DPK_SEG_KEYS 4
#define DPK_SIZE_CLASSES 32
#define K7_THREADS 512
#define K7_ITEMS 16                       // consecutive rows a thread
#define K7_TILE (K7_THREADS * K7_ITEMS)
#define K7_MIN_BLOCKS 2                   // blocks an SM holds
#define K7_FILL_ROWS 16384                // slots a fill item
#define K7_AGG 1ull                       // status flags: a tile alone
#define K7_INC 2ull                       // ... and with all before it

struct SegKeys {
  const char* p[DPK_SEG_KEYS];
  char* out[DPK_SEG_KEYS];    // per-segment keys, or null
  int kind[DPK_SEG_KEYS];     // 0 int32, 1 int64, 2 float64
  int64_t fill[DPK_SEG_KEYS]; // bits stored past n_seg
  int n;
};

// each key column's element at row `src` to output slot j
__device__ __forceinline__ void put_keys(const SegKeys& K, int64_t j,
                                         int64_t src) {
#pragma unroll
  for (int c = 0; c < DPK_SEG_KEYS; ++c) {
    if (c >= K.n || K.out[c] == nullptr) continue;
    if (K.kind[c] == 0)
      ((int32_t*)K.out[c])[j] = ((const int32_t*)K.p[c])[src];
    else
      ((int64_t*)K.out[c])[j] = ((const int64_t*)K.p[c])[src];
  }
}

__device__ __forceinline__ int size_class(int32_t sz) {
  return sz <= 1 ? 0 : 32 - __clz(sz - 1);
}

// the fills of slots [lo, hi) of the shard at base, by the block
__device__ __forceinline__ void fill_slots(const SegKeys& K, int64_t base,
                                           int64_t lo, int64_t hi,
                                           int32_t* start_rows,
                                           int32_t* sizes, int32_t* bucket,
                                           int tid, int nth) {
  fill_span<int32_t>(start_rows + base, lo, hi, 0, tid, nth);
  fill_span<int32_t>(sizes + base, lo, hi, 0, tid, nth);
  fill_span<int32_t>(bucket + base, lo, hi, DPK_SIZE_CLASSES, tid, nth);
#pragma unroll
  for (int c = 0; c < DPK_SEG_KEYS; ++c) {
    if (c >= K.n || K.out[c] == nullptr) continue;
    if (K.kind[c] == 0)
      fill_span<int32_t>((int32_t*)K.out[c] + base, lo, hi,
                         (int32_t)K.fill[c], tid, nth);
    else
      fill_span<long long>((long long*)K.out[c] + base, lo, hi,
                           (long long)K.fill[c], tid, nth);
  }
}

// a status word: flag (2 bits), starts (31), last start row + 1 (31; 0
// for none)
__device__ __forceinline__ unsigned long long k7_word(unsigned long long f,
                                                      int starts, int last) {
  return f << 62 | (unsigned long long)(unsigned)starts << 31 |
         (unsigned)(last + 1);
}

// n_seg[s] for a fill item of shard s: the inclusive word of the tile
// that holds the shard's last valid row, once published (that tile took
// its id before this item, so it is running)
__device__ __forceinline__ int64_t wait_n_seg(
    const unsigned long long* stat, int64_t nvc, int* s_n) {
  if (threadIdx.x == 0) {
    int c = 0;
    if (nvc > 0) {
      const unsigned long long* w = stat + (nvc - 1) / K7_TILE;
      unsigned long long v = ld_status(w);
      for (unsigned polls = 0; (v >> 62) != K7_INC; v = ld_status(w)) {
        if (++polls == (1u << 26)) __trap();
      }
      c = (int)((v >> 31) & 0x7FFFFFFFull);
    }
    *s_n = c;
  }
  __syncthreads();
  return *s_n;
}

// one work item a block, from an atomic counter (sweep_item)
static __global__ void __launch_bounds__(K7_THREADS, K7_MIN_BLOCKS)
    k7_sweep(const SegKeys K, const int32_t* n, int N, int64_t cap,
             int64_t ntiles, int64_t nfill, int32_t* start_rows,
             int32_t* sizes, int32_t* bucket, int32_t* n_seg, int32_t* hist,
             unsigned long long* status, unsigned long long* counter) {
  __shared__ int s_item, s_pre_c, s_pre_l;
  __shared__ int s_c[32], s_l[32];
  __shared__ int h_sm[DPK_SIZE_CLASSES];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_item = (int)atomicAdd(counter, 1ull);
  if (tid < DPK_SIZE_CLASSES) h_sm[tid] = 0;
  __syncthreads();
  int64_t s, t;
  const bool fill = sweep_item(s_item, ntiles, nfill, N, &s, &t);
  const int64_t base = s * cap;
  const int64_t ns = n[s];
  const int64_t nvc = ns < 0 ? 0 : (ns < cap ? ns : cap);
  unsigned long long* stat = status + s * ntiles;
  if (fill) {                               // a fill item: [n_seg, n)
    const int64_t lo = t * K7_FILL_ROWS;
    const int64_t hi = lo + K7_FILL_ROWS < nvc ? lo + K7_FILL_ROWS : nvc;
    if (lo >= hi) return;
    const int64_t first = wait_n_seg(stat, nvc, &s_pre_c);
    fill_slots(K, base, lo > first ? lo : first, hi, start_rows, sizes,
               bucket, tid, K7_THREADS);
    return;
  }
  const int64_t t0 = t * K7_TILE;
  const int64_t tend = t0 + K7_TILE < cap ? t0 + K7_TILE : cap;
  if (t0 >= nvc) {                          // no valid row: fills alone
    fill_slots(K, base, t0, tend, start_rows, sizes, bucket, tid,
               K7_THREADS);
    if (t == 0 && tid == 0) n_seg[s] = 0;
    return;
  }
  if (nvc < tend)
    fill_slots(K, base, nvc, tend, start_rows, sizes, bucket, tid,
               K7_THREADS);

  // this thread's starts: bit i for row row0 + i
  const int64_t row0 = t0 + (int64_t)tid * K7_ITEMS;
  unsigned mask = 0;
  if (row0 < nvc) {
    unsigned d = row0 == 0 ? 1u : 0u;
#pragma unroll
    for (int c = 0; c < DPK_SEG_KEYS; ++c) {
      if (c >= K.n) continue;
      if (K.kind[c] == 0)
        d |= col_diffs<int32_t, K7_ITEMS>(K.p[c], base, row0, cap);
      else if (K.kind[c] == 1)
        d |= col_diffs<long long, K7_ITEMS>(K.p[c], base, row0, cap);
      else
        d |= col_diffs<double, K7_ITEMS>(K.p[c], base, row0, cap);
    }
    const int64_t left = nvc - row0;
    mask = left >= K7_ITEMS ? d : d & ((1u << left) - 1u);
  }
  const int cnt = __popc(mask);
  const int last = mask ? (int)(row0 + 31 - __clz(mask)) : -1;
  int ex_c, ex_l, tot_c, tot_l;
  scan_starts(cnt, last, s_c, s_l, &ex_c, &ex_l, &tot_c, &tot_l);

  // publish the tile's own word at once, then look back (one warp, 32
  // words a load) up to the nearest inclusive word
  if (tid == 0)
    st_status(stat + t, k7_word(t > 0 ? K7_AGG : K7_INC, tot_c, tot_l));
  if (warp == 0) {
    unsigned pc = 0;
    int pl = -1;
    if (t > 0) {
      unsigned polls = 0;
      for (int64_t p = t - 1;;) {
        const int64_t q = p - lane;
        const unsigned long long w =
            q >= 0 ? ld_status(stat + q) : K7_INC << 62;
        const unsigned flag = (unsigned)(w >> 62);
        const unsigned inc = __ballot_sync(DPK_FULL, flag == K7_INC);
        const unsigned zero = __ballot_sync(DPK_FULL, flag == 0);
        // the words up to the nearest inclusive one (all 32 if none)
        const unsigned upto = inc ? ((inc & (0u - inc)) << 1) - 1u
                                  : DPK_FULL;
        if (zero & upto) {
          // an earlier tile's block is resident (it took its id first),
          // so its word comes within microseconds; a fault that lost it
          // traps (a launch error) instead of hanging the card
          if (++polls == (1u << 26)) __trap();
          continue;
        }
        const bool take = (upto >> lane) & 1u;
        unsigned c = take ? (unsigned)((w >> 31) & 0x7FFFFFFFull) : 0u;
        int l = take ? (int)(w & 0x7FFFFFFFull) - 1 : -1;
        for (int o = 16; o > 0; o >>= 1) {
          c += __shfl_xor_sync(DPK_FULL, c, o);
          l = max(l, __shfl_xor_sync(DPK_FULL, l, o));
        }
        pc += c;
        pl = max(pl, l);
        if (inc) break;
        p -= 32;
      }
      if (lane == 0)
        st_status(stat + t, k7_word(K7_INC, (int)pc + tot_c,
                                    max(pl, tot_l)));
    }
    if (lane == 0) {
      s_pre_c = (int)pc;
      s_pre_l = pl;
    }
  }
  __syncthreads();

  // each start: its row and keys at its rank, and the size and class of
  // the segment before it
  int64_t j = (int64_t)s_pre_c + ex_c;
  int prev = max(s_pre_l, ex_l);
  for (unsigned m = mask; m; m &= m - 1) {
    const int row = (int)(row0 + __ffs(m) - 1);
    start_rows[base + j] = row;
    put_keys(K, base + j, base + row);
    if (prev >= 0) {
      const int32_t sz = row - prev;
      const int cl = size_class(sz);
      sizes[base + j - 1] = sz;
      bucket[base + j - 1] = cl;
      atomicAdd(&h_sm[cl], 1);
    }
    prev = row;
    ++j;
  }
  // the owner of the last valid row closes the last segment
  if (row0 <= nvc - 1 && nvc - 1 < row0 + K7_ITEMS) {
    const int32_t sz = (int32_t)(ns - prev);
    const int cl = size_class(sz);
    sizes[base + j - 1] = sz;
    bucket[base + j - 1] = cl;
    atomicAdd(&h_sm[cl], 1);
    n_seg[s] = (int32_t)j;
  }
  __syncthreads();
  if (tid < DPK_SIZE_CLASSES && h_sm[tid])
    atomicAdd(&hist[s * DPK_SIZE_CLASSES + tid], h_sm[tid]);
}

// keys: nk (N, cap) key columns of kinds[c]; keys_out: per-segment key
// columns (entries may be null), fills their bits past n_seg; n: (N,)
// valid rows.  Outputs (N, cap) int32 start_rows / sizes / bucket, (N,)
// int32 n_seg, (N, 32) int32 hist (zeroed by the caller); status:
// (N * ceil(cap / K7_TILE) + 1) uint64 zeroed by the caller (the
// look-back's words, then the tile counter).
extern "C" int dpk_segment_table(const void* const* keys,
                                 void* const* keys_out, const int* kinds,
                                 const int64_t* fills, int nk,
                                 const int32_t* n, int N, int64_t cap,
                                 int32_t* start_rows, int32_t* sizes,
                                 int32_t* bucket, int32_t* n_seg,
                                 int32_t* hist, void* status,
                                 void* stream) {
  if (nk < 1 || nk > DPK_SEG_KEYS || N < 1 || cap >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  for (int c = 0; c < nk; ++c)
    if (kinds[c] < 0 || kinds[c] > 2) return (int)cudaErrorInvalidValue;
  if (cap == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  SegKeys K;
  K.n = nk;
  for (int c = 0; c < DPK_SEG_KEYS; ++c) {
    K.p[c] = c < nk ? (const char*)keys[c] : nullptr;
    K.out[c] = c < nk ? (char*)keys_out[c] : nullptr;
    K.kind[c] = c < nk ? kinds[c] : 0;
    K.fill[c] = c < nk ? fills[c] : 0;
  }
  const int64_t ntiles = (cap + K7_TILE - 1) / K7_TILE;
  const int64_t nfill = (cap + K7_FILL_ROWS - 1) / K7_FILL_ROWS;
  unsigned long long* words = (unsigned long long*)status;
  k7_sweep<<<(unsigned)(N * (ntiles + nfill)), K7_THREADS, 0, st>>>(
      K, n, N, cap, ntiles, nfill, start_rows, sizes, bucket, n_seg, hist,
      words, words + N * ntiles);
  return (int)cudaGetLastError();
}
