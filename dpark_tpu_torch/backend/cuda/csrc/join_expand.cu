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
// and its value leaves, side B b_n[s] rows.  Keys compare
// lexicographically over nk <= 4 columns in K5's order (ints by value,
// float64 with -0.0 equal to +0.0 and every NaN one value).  Two entry
// points:
//
// dpk_join_ranges, one one-sweep launch (k12_ranges): the ranges as a
// merge of two sorted lists.  A block takes the next tile of K12_TILE
// consecutive A rows of one shard from an atomic counter (sweep_item,
// common.cuh: each shard's tiles in order), so that a tile's look-back
// only waits on tiles already running.  The tile's B window is the lower
// bound of its first valid key and the upper bound of its last, found by
// two warps at once, each a 32-way search over B's valid prefix [0,
// b_n[s]) in global memory (32 probes a round, about five rounds at 2^21
// B rows).  Where the window fits in shared memory (K12_WINDOW_BYTES of
// key images), the block stages its images with coalesced loads and each
// thread bisects the window for its first row's bounds, then walks its
// further K12_ITEMS - 1 rows forward: lo and hi only grow along sorted A,
// so a new key gallops from the previous hi, an equal key repeats the
// previous range.  A window past the shared capacity (a hot key, or a
// sparse A over a dense B) runs the same bisect and gallops over B's
// rows in global memory.  The tile's per sums scan across the block, and
// one warp looks back over the earlier tiles' status words, 32 a load,
// for the shard's pairs before the tile (K3's, K5's and K7's scheme):
// offs is per's exclusive prefix.  lo, per and offs are written once,
// through a shared stage in coalesced rows; past a_n[s], lo and per are
// 0 and offs the shard's total; the shard's last tile writes totals[s].
// The key columns come by value (__grid_constant__): no table is copied
// to the card.  The caller reads the largest total (the one host sync of
// a join) and sizes the output.
//
// dpk_join_expand, one launch, one thread per output slot t: i is the
// last A row with offs[i] <= t (a bisect over the shard's a_n[s] offsets),
// j = t - offs[i]; the slot takes every A leaf at row i and B's value
// leaves at row lo[i] + j.  Slot-parallel expansion spreads a hot key
// over as many threads as it has pairs.  Slots at t >= total are padding:
// key column 0 holds the sentinel, every other leaf zeros.  Its pointers
// live in a small int64 table in device memory, read into shared memory
// once per CUDA block.
//
// Bound: bytes.  The ranges read each side's valid key columns once and
// write lo, per and offs (24 B an A slot, most of the bytes at TPC-H's
// shapes); B's keys in a shared window are read about once (a tile of
// 2,048 lineitems spans about 512 orders), those of a window past the
// shared capacity once per probe, mostly from L2.  The expansion reads
// A's leaves once, B's value leaves once per pair that reads them, and
// writes every output row once; its bisects re-read the offsets, mostly
// from L2.  Offsets and totals are int64: a skewed shard may hold more
// than 2^31 pairs.
#include "common.cuh"

#define K12_THREADS 256
#define K12_ITEMS 8                        // consecutive A rows a thread
#define K12_TILE (K12_THREADS * K12_ITEMS)
#define K12_WINDOW_BYTES 32768             // B's key images in shared
#define K12_EXPAND_THREADS 256
#define K12_MAX_KEYS 4
#define K12_AGG 1ull                       // status flags: a tile alone
#define K12_INC 2ull                       // ... and with all before it
#define K12_VALUE ((1ull << 62) - 1)       // a status word's pair count

static_assert(K12_WINDOW_BYTES >= (K12_TILE + K12_TILE / 32) * 8,
              "the shared window doubles as the output stage");

// the key columns of both sides, by value
struct K12Keys {
  const char* a[K12_MAX_KEYS];
  const char* b[K12_MAX_KEYS];
  int kind[K12_MAX_KEYS];     // 0 int32, 1 int64, 2 float64
};

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

// B's rows [base, base + W): the shared window's images ([c * C + j]) or
// the key columns in global memory
template <int NK, bool SHARED>
struct K12Side {
  const K12Keys* k;
  const uint64_t* win;
  int64_t base;
  __device__ __forceinline__ uint64_t img(int c, int64_t j) const {
    constexpr int C = K12_WINDOW_BYTES / 8 / NK;
    if constexpr (SHARED)
      return win[c * C + j];
    else
      return k12_image(k->b[c], k->kind[c], base + j);
  }
  // row j lies before the bound of q: below it (lower bound) or at most
  // it (upper bound)
  __device__ __forceinline__ bool before(int64_t j, const uint64_t* q,
                                         bool upper) const {
#pragma unroll
    for (int c = 0; c < NK; ++c) {
      const uint64_t b = img(c, j);
      if (b != q[c]) return b < q[c];
    }
    return upper;
  }
  // the first row of [l, h) not before the bound, h if none
  __device__ __forceinline__ int64_t bisect(int64_t l, int64_t h,
                                            const uint64_t* q,
                                            bool upper) const {
    while (l < h) {
      const int64_t m = (l + h) >> 1;
      if (before(m, q, upper))
        l = m + 1;
      else
        h = m;
    }
    return l;
  }
  // the same over [from, h), galloping from `from`: the bound is near it
  // when A's keys are dense over B's
  __device__ __forceinline__ int64_t gallop(int64_t from, int64_t h,
                                            const uint64_t* q,
                                            bool upper) const {
    if (from >= h || !before(from, q, upper)) return from;
    int64_t l = from, step = 1;                  // before(l)
    while (l + step < h && before(l + step, q, upper)) {
      l += step;
      step <<= 1;
    }
    return bisect(l + 1, l + step < h ? l + step : h, q, upper);
  }
};

// one warp: the first row of B's [0, n) (at `base`) not before the bound
// of q, by 32 probes a round
template <int NK>
__device__ __forceinline__ int64_t k12_warp_bound(const K12Side<NK, false>& B,
                                                  int64_t n,
                                                  const uint64_t* q,
                                                  bool upper) {
  const int lane = threadIdx.x & 31;
  int64_t l = 0, h = n;                          // the bound is in [l, h]
  while (h - l > 32) {
    const int64_t len = h - l;
    const int64_t m = l + len * (lane + 1) / 33;  // increasing, < h
    const unsigned at = __ballot_sync(DPK_FULL, !B.before(m, q, upper));
    if (at == 0) {
      l = __shfl_sync(DPK_FULL, m, 31) + 1;
    } else {
      const int f = __ffs(at) - 1;
      const int64_t mf = __shfl_sync(DPK_FULL, m, f);
      const int64_t mp = __shfl_sync(DPK_FULL, m, f > 0 ? f - 1 : 0);
      if (f > 0) l = mp + 1;
      h = mf;
    }
  }
  const int64_t j = l + lane;
  const unsigned at =
      __ballot_sync(DPK_FULL, j < h && !B.before(j, q, upper));
  return at ? l + __ffs(at) - 1 : h;
}

// a thread's rows: lo (B row) and per of each, from its first row's
// bisect and forward gallops; returns the sum of per
template <int NK, bool SHARED>
__device__ __forceinline__ int64_t k12_rows(
    const K12Side<NK, SHARED>& B, int64_t W, int64_t wlo,
    uint64_t (*q)[NK], int nv, int64_t* lo, int64_t* per) {
  int64_t l = 0, h = 0, sum = 0;
#pragma unroll
  for (int i = 0; i < K12_ITEMS; ++i) {
    lo[i] = 0;
    per[i] = 0;
    if (i < nv) {
      bool same = i > 0;
#pragma unroll
      for (int c = 0; c < NK; ++c)
        if (i > 0 && q[i][c] != q[i - 1][c]) same = false;
      if (i == 0) {
        l = B.bisect(0, W, q[0], false);
        h = B.gallop(l, W, q[0], true);
      } else if (!same) {
        l = B.gallop(h, W, q[i], false);
        h = B.gallop(l, W, q[i], true);
      }
      lo[i] = wlo + l;
      per[i] = h - l;
      sum += h - l;
    }
  }
  return sum;
}

// a thread's K12_ITEMS values to out[0, nrow) of the tile, in coalesced
// rows through the stage (padded: one slot a 32)
__device__ __forceinline__ void k12_store(int64_t* stage, const int64_t* v,
                                          int64_t* out, int64_t nrow) {
  __syncthreads();                       // the stage's readers are done
#pragma unroll
  for (int i = 0; i < K12_ITEMS; ++i) {
    const int e = threadIdx.x * K12_ITEMS + i;
    stage[e + (e >> 5)] = v[i];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nrow; e += K12_THREADS)
    out[e] = stage[e + (e >> 5)];
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

// one tile a block, from an atomic counter (sweep_item)
template <int NK>
static __global__ void __launch_bounds__(K12_THREADS)
    k12_ranges(const __grid_constant__ K12Keys K, int N, int64_t cap_a,
               int64_t cap_b, int64_t ntiles, const int32_t* a_n,
               const int32_t* b_n, int64_t* lo_out, int64_t* per_out,
               int64_t* offs_out, int64_t* totals,
               unsigned long long* status, unsigned long long* counter) {
  constexpr int C = K12_WINDOW_BYTES / 8 / NK;   // window rows
  __shared__ uint64_t win[K12_WINDOW_BYTES / 8];
  __shared__ int64_t sm[32];
  __shared__ int64_t s_w[2];
  __shared__ int64_t s_pre;
  __shared__ int s_item;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_item = (int)atomicAdd(counter, 1ull);
  __syncthreads();
  int64_t s, t;
  sweep_item(s_item, ntiles, 0, N, &s, &t);
  const int64_t ns = a_n[s], ms = b_n[s];
  const int64_t na = ns < 0 ? 0 : (ns < cap_a ? ns : cap_a);
  const int64_t nb = ms < 0 ? 0 : (ms < cap_b ? ms : cap_b);
  const int64_t abase = s * cap_a, bbase = s * cap_b;
  const int64_t r0 = t * K12_TILE;
  const int64_t rv = r0 + K12_TILE < na ? r0 + K12_TILE : na;

  // 1. the tile's B window: warp 0 the lower bound of its first valid
  // key, warp 1 the upper bound of its last
  if (warp < 2) {
    int64_t w = 0;
    if (r0 < rv) {
      const int64_t row = abase + (warp == 0 ? r0 : rv - 1);
      uint64_t q[NK];
#pragma unroll
      for (int c = 0; c < NK; ++c) q[c] = k12_image(K.a[c], K.kind[c], row);
      const K12Side<NK, false> G{&K, nullptr, bbase};
      w = k12_warp_bound<NK>(G, nb, q, warp == 1);
    }
    if (lane == 0) s_w[warp] = w;
  }
  // 2. this thread's rows' key images (loads in flight during the search)
  const int64_t row0 = r0 + (int64_t)tid * K12_ITEMS;
  const int nv = row0 >= rv ? 0
                 : (rv - row0 < K12_ITEMS ? (int)(rv - row0) : K12_ITEMS);
  uint64_t q[K12_ITEMS][NK];
#pragma unroll
  for (int i = 0; i < K12_ITEMS; ++i)
#pragma unroll
    for (int c = 0; c < NK; ++c)
      q[i][c] = i < nv ? k12_image(K.a[c], K.kind[c], abase + row0 + i) : 0;
  __syncthreads();
  const int64_t wlo = s_w[0], W = s_w[1] - s_w[0];

  // 3. each row's bounds, in the shared window where it fits
  int64_t lo[K12_ITEMS], per[K12_ITEMS], sum;
  if (W <= C) {
    for (int64_t j = tid; j < W; j += K12_THREADS)
#pragma unroll
      for (int c = 0; c < NK; ++c)
        win[c * C + j] = k12_image(K.b[c], K.kind[c], bbase + wlo + j);
    __syncthreads();
    const K12Side<NK, true> S{&K, win, 0};
    sum = k12_rows<NK, true>(S, W, wlo, q, nv, lo, per);
  } else {
    const K12Side<NK, false> G{&K, nullptr, bbase + wlo};
    sum = k12_rows<NK, false>(G, W, wlo, q, nv, lo, per);
  }

  // 4. the tile's pairs: a block scan, its status word at once, then one
  // warp's look-back (32 words a load) up to the nearest inclusive word
  int64_t tot;
  const int64_t ex = k12_block_scan(sum, sm, &tot);
  unsigned long long* stat = status + s * ntiles;
  if (tid == 0)
    st_status(stat + t, (t > 0 ? K12_AGG : K12_INC) << 62 |
                            (unsigned long long)tot);
  if (warp == 0) {
    unsigned long long pc = 0;
    if (t > 0) {
      unsigned polls = 0;
      for (int64_t p = t - 1;;) {
        const int64_t w0 = p - lane;
        const unsigned long long w =
            w0 >= 0 ? ld_status(stat + w0) : K12_INC << 62;
        const unsigned flag = (unsigned)(w >> 62);
        const unsigned inc = __ballot_sync(DPK_FULL, flag == K12_INC);
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
        unsigned long long c = (upto >> lane) & 1u ? w & K12_VALUE : 0ull;
        for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(DPK_FULL, c, o);
        pc += c;
        if (inc) break;
        p -= 32;
      }
      if (lane == 0)
        st_status(stat + t, K12_INC << 62 | (pc + (unsigned long long)tot));
    }
    if (lane == 0) s_pre = (int64_t)pc;
  }
  __syncthreads();
  const int64_t pre = s_pre;
  if (t == ntiles - 1 && tid == 0) totals[s] = pre + tot;

  // 5. lo, per and offs, each once, in coalesced rows
  int64_t offs[K12_ITEMS];
  int64_t run = pre + ex;
#pragma unroll
  for (int i = 0; i < K12_ITEMS; ++i) {
    offs[i] = run;
    run += per[i];
  }
  const int64_t nrow = cap_a - r0 < K12_TILE ? cap_a - r0 : K12_TILE;
  int64_t* stage = (int64_t*)win;
  k12_store(stage, lo, lo_out + abase + r0, nrow);
  k12_store(stage, per, per_out + abase + r0, nrow);
  k12_store(stage, offs, offs_out + abase + r0, nrow);
}

template <int NK>
static int k12_launch(const K12Keys& K, int N, int64_t cap_a, int64_t cap_b,
                      const int32_t* a_n, const int32_t* b_n, int64_t* lo,
                      int64_t* per, int64_t* offs, int64_t* totals,
                      unsigned long long* status, cudaStream_t st) {
  const int64_t ntiles = (cap_a + K12_TILE - 1) / K12_TILE;
  cudaMemsetAsync(status, 0, (size_t)(N * ntiles + 1) * sizeof(*status), st);
  k12_ranges<NK><<<(unsigned)(N * ntiles), K12_THREADS, 0, st>>>(
      K, N, cap_a, cap_b, ntiles, a_n, b_n, lo, per, offs, totals, status,
      status + N * ntiles);
  return (int)cudaGetLastError();
}

// a_keys, b_keys: nk (N, cap_a) / (N, cap_b) key columns of kinds[c] (0
// int32, 1 int64, 2 float64); a_n, b_n: (N,) int32; lo, per, offs: (N,
// cap_a) int64; totals: (N,) int64; status: (N * ceil(cap_a / K12_TILE)
// + 1) uint64 scratch (the look-back's words, then the tile counter;
// zeroed here).
extern "C" int dpk_join_ranges(const void* const* a_keys,
                               const void* const* b_keys, const int* kinds,
                               int nk, int N, int64_t cap_a, int64_t cap_b,
                               const int32_t* a_n, const int32_t* b_n,
                               int64_t* lo, int64_t* per, int64_t* offs,
                               int64_t* totals, void* status, void* stream) {
  if (nk < 1 || nk > K12_MAX_KEYS || N < 0)
    return (int)cudaErrorInvalidValue;
  for (int c = 0; c < nk; ++c)
    if (kinds[c] < 0 || kinds[c] > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (N == 0) return (int)cudaGetLastError();
  if (cap_a == 0) {
    cudaMemsetAsync(totals, 0, (size_t)N * sizeof(int64_t), st);
    return (int)cudaGetLastError();
  }
  K12Keys K;
  for (int c = 0; c < K12_MAX_KEYS; ++c) {
    K.a[c] = c < nk ? (const char*)a_keys[c] : nullptr;
    K.b[c] = c < nk ? (const char*)b_keys[c] : nullptr;
    K.kind[c] = c < nk ? kinds[c] : 0;
  }
  unsigned long long* words = (unsigned long long*)status;
  switch (nk) {
    case 1:
      return k12_launch<1>(K, N, cap_a, cap_b, a_n, b_n, lo, per, offs,
                           totals, words, st);
    case 2:
      return k12_launch<2>(K, N, cap_a, cap_b, a_n, b_n, lo, per, offs,
                           totals, words, st);
    case 3:
      return k12_launch<3>(K, N, cap_a, cap_b, a_n, b_n, lo, per, offs,
                           totals, words, st);
    default:
      return k12_launch<4>(K, N, cap_a, cap_b, a_n, b_n, lo, per, offs,
                           totals, words, st);
  }
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
