// K3 reduce_by_key_compact: over rows already sorted by their key
// columns, merge each run of equal keys into one row, pack the kept rows
// to the front in their order, and count them per shard and per
// destination.
//
// Replaces dpark_tpu/backend/tpu/collectives.py:359 _changed_adjacent,
// :367 _segment_merge, :293 _monoid_segment_totals, the re-pack sorts at
// :427 (_bucketize_combine_cols) and :476 (_segment_reduce_cols) and the
// per-destination bincount after them.  A run boundary is any key column
// changing (the destination column included, on the map side); rows at
// or past n[s] are padding.  Slots past n_unique hold the key fills and
// zero values.
//
// Values reduce with add / min / max / mul over int64 or float64 (op
// "last" keeps the run's last row, any width: the tail of a traced
// segmented scan).  Float min and max propagate a NaN wherever it stands
// in a run, as the plain version's scatter_reduce and the reference's
// segment_min / segment_max do.  Float sums and products are taken in
// one fixed association (below): they repeat bit for bit from run to
// run, and differ from the plain version's order within a tolerance.
//
// Bound: bytes.  Each key column and value is read once; the contract
// writes every slot of the (N, cap) outputs, the kept rows' keys and
// values and the fills past n_unique.  At N=8, cap=2^23, dst + one int64
// key + one int64 value with 65,536 keys a shard: 1.34 GB read and 1.34
// GB written, 0.80 ms at 3.35 TB/s (0.40 ms counting the kept rows'
// writes alone).
//
// One one-sweep launch (the scheme of K7's, segment_table.cu), k3_sweep:
// a block takes the next work item from an atomic counter (sweep_item,
// common.cuh: each shard's tiles in order, its fill items spread among
// the next shard's tiles), so whatever an item waits for is running.  A
// tile of K3_TILE rows:
//  1. each thread loads its K3_ITEMS consecutive rows of every key column
//     16 bytes at a time, and the row before them, and marks its run
//     starts; a block scan gives the starts before it in the tile.  A row
//     is its run's tail if the next row starts a run or is past n[s].
//  2. the tile publishes its starts in its count word at once, and one
//     warp looks back over the earlier tiles' count words, 32 a load, for
//     the starts before the tile (up to the nearest inclusive word), then
//     publishes the inclusive count.
//  3. the starts write their keys at their ranks (the destination
//     histogram in shared memory, one atomic a destination and thread,
//     one global atomic a bin and tile).  For every value lane each
//     thread folds its rows, each tail of a run that starts in the tile
//     writing its value with one plain store, and a segmented block scan
//     gives each thread the fold of the run open before it; the last
//     thread stores the tile's aggregate, the fold from its last start (or
//     its first row) to its end ("last": each tail copies its row).  The
//     tile's value word (flag, whether it holds a start) follows its
//     aggregates, a fence between.  A tile of K3_DENSE to K3_STAGE runs
//     stages each key column and scalar value lane in shared memory and
//     writes it in 16-byte words: stored directly, its outputs would be
//     neighbouring threads' stores K3_ITEMS rows apart.
//  4. a tile whose first row continues a run from an earlier tile: one
//     warp looks back over the value words for the nearest tile that ends
//     the run's carry, one holding a start (its aggregate) or an inclusive
//     one (its inclusive value), folds the carry left to right through
//     the aggregates of the tiles between, writes the run's value where
//     its tail is in this tile, and, where the tile holds no start,
//     stores carry (+) aggregate as its inclusive value before its
//     inclusive word.  Every carry is thus the left fold of the aggregates
//     of its run's tiles from the one holding the start, whichever word
//     the look-back met first: the association is fixed, and no tile
//     waits for another's carry.
// Slots past n[s] take their fills from the tiles that hold them; slots
// in [n_unique, n) from the shard's fill items, which read n_unique from
// the inclusive word of the tile that holds the last valid row.  The last
// of a shard's tiles to finish (a counter) writes its destination
// offsets.  No atomic folds a value and no per-row scratch is written.
// The column and leaf structs are read at compile-time indices only
// (load_tables copies them so into shared memory), so no thread copies
// them to local memory.
#include "common.cuh"

#define K3_THREADS 384
#define K3_ITEMS 16                       // consecutive rows a thread
#define K3_CHUNK 8                        // of them in registers at once
#define K3_TILE (K3_THREADS * K3_ITEMS)
#define K3_MIN_BLOCKS 2                   // blocks an SM holds
#define K3_FILL_ROWS 8192                 // slots a fill item
#define K3_MAX_DST 4096
#define K3_DENSE 512                      // starts from which a tile stages
#define K3_STAGE 4096                     // its outputs in shared memory,
                                          // up to this many
#define K3_STAGE_BYTES (K3_STAGE * 8 + 16)
#define K3_AGG 1ull                       // status flags: a tile alone
#define K3_INC 2ull                       // ... and with all before it
#define K3_HAS_START (1ull << 61)         // value word: the tile holds a
                                          // run start
#define K3_COUNT 0x7FFFFFFFull            // its (inclusive) starts

enum { OP_ADD = 0, OP_MIN = 1, OP_MAX = 2, OP_MUL = 3, OP_LAST = 4 };

struct KeyCols {
  const char* p[DPK_MAX_KEYS];
  char* out[DPK_MAX_KEYS];
  int w[DPK_MAX_KEYS];                    // 4 (int32) or 8 (int64)
  int64_t fill[DPK_MAX_KEYS];
  int n;
};

struct ValLeaves {
  const char* p[DPK_MAX_LEAVES];
  char* out[DPK_MAX_LEAVES];
  int64_t bytes[DPK_MAX_LEAVES];          // row bytes
  int64_t lanes[DPK_MAX_LEAVES];          // W of an (N, cap, W) leaf
  int64_t lane0[DPK_MAX_LEAVES];          // its first aggregate lane
  int kind[DPK_MAX_LEAVES];               // 0 int64, 1 float64, 2 any
  int n;
};

// one key column or value leaf, as the block reads it from shared memory
struct KeyCol {
  const char* p;
  char* out;
  int64_t fill;
  int w;
};

struct Leaf {
  const char* p;
  char* out;
  int64_t bytes, lanes, lane0;
  int kind;
};

// the columns' and leaves' fields into shared memory, thread q reading
// entry q from the parameter structs at a compile-time index (an index
// known only at run time would copy the structs to each thread's local
// memory); the block then indexes the shared tables at run time
__device__ __forceinline__ void load_tables(const KeyCols& K,
                                            const ValLeaves& V,
                                            KeyCol* s_key, Leaf* s_leaf) {
#pragma unroll
  for (int q = 0; q < DPK_MAX_KEYS; ++q) {
    if (threadIdx.x == 32 + q && q < K.n) {
      s_key[q].p = K.p[q];
      s_key[q].out = K.out[q];
      s_key[q].fill = K.fill[q];
      s_key[q].w = K.w[q];
    }
  }
#pragma unroll
  for (int q = 0; q < DPK_MAX_LEAVES; ++q) {
    if (threadIdx.x == q && q < V.n) {
      s_leaf[q].p = V.p[q];
      s_leaf[q].out = V.out[q];
      s_leaf[q].bytes = V.bytes[q];
      s_leaf[q].lanes = V.lanes[q];
      s_leaf[q].lane0 = V.lane0[q];
      s_leaf[q].kind = V.kind[q];
    }
  }
}

template <typename T>
__device__ __forceinline__ T identity_of(int op);
template <>
__device__ __forceinline__ long long identity_of<long long>(int op) {
  return op == OP_ADD ? 0LL
         : op == OP_MUL ? 1LL
         : op == OP_MIN ? (long long)0x7fffffffffffffffLL
                        : (long long)(-0x7fffffffffffffffLL - 1);
}
template <>
__device__ __forceinline__ double identity_of<double>(int op) {
  return op == OP_ADD ? 0.0
         : op == OP_MUL ? 1.0
         : op == OP_MIN
             ? __longlong_as_double(0x7ff0000000000000LL)
             : __longlong_as_double((long long)0xfff0000000000000ULL);
}

// a (+) b, a the earlier rows; float min / max keep a NaN of either side
// and, between equal values (-0.0, 0.0), the earlier
template <typename T, int OP>
__device__ __forceinline__ T combine(T a, T b);
#define DPK_COMB(T, OPV, EXPR)                                   \
  template <>                                                    \
  __device__ __forceinline__ T combine<T, OPV>(T a, T b) {       \
    return EXPR;                                                 \
  }
DPK_COMB(long long, OP_ADD,
         (long long)((unsigned long long)a + (unsigned long long)b))
DPK_COMB(long long, OP_MUL,
         (long long)((unsigned long long)a * (unsigned long long)b))
DPK_COMB(long long, OP_MIN, (b < a ? b : a))
DPK_COMB(long long, OP_MAX, (b > a ? b : a))
DPK_COMB(double, OP_ADD, a + b)
DPK_COMB(double, OP_MUL, a * b)
DPK_COMB(double, OP_MIN, ((b < a || b != b) ? b : a))
DPK_COMB(double, OP_MAX, ((b > a || b != b) ? b : a))

__device__ __forceinline__ unsigned long long to_bits(long long v) {
  return (unsigned long long)v;
}
__device__ __forceinline__ unsigned long long to_bits(double v) {
  return (unsigned long long)__double_as_longlong(v);
}
template <typename T>
__device__ __forceinline__ T from_bits(unsigned long long u);
template <>
__device__ __forceinline__ long long from_bits<long long>(
    unsigned long long u) {
  return (long long)u;
}
template <>
__device__ __forceinline__ double from_bits<double>(unsigned long long u) {
  return __longlong_as_double((long long)u);
}

// a tile's count word: flag (2 bits), its starts (alone or with every
// tile before it)
__device__ __forceinline__ unsigned long long k3_word(unsigned long long f,
                                                      int64_t starts) {
  return f << 62 | ((unsigned long long)starts & K3_COUNT);
}

// whether row i differs from row i - 1 in any key column
__device__ __forceinline__ bool row_differs(const KeyCol* s_key, int nk,
                                            int64_t i) {
  bool d = false;
#pragma unroll 1
  for (int c = 0; c < nk; ++c)
    d |= load_key(s_key[c].p, s_key[c].w, i) !=
         load_key(s_key[c].p, s_key[c].w, i - 1);
  return d;
}

// zero bytes [lo, hi) of p by the nth threads from tid: 16-byte stores
// between a byte head and tail
__device__ __forceinline__ void zero_bytes(char* p, int64_t lo, int64_t hi,
                                           int tid, int nth) {
  if (lo >= hi) return;
  int64_t head = (int64_t)((16 - ((uintptr_t)(p + lo) & 15)) & 15);
  if (head > hi - lo) head = hi - lo;
  for (int64_t i = tid; i < head; i += nth) p[lo + i] = 0;
  const int64_t vlo = lo + head;
  const int64_t nvec = (hi - vlo) >> 4;
  uint4* q = (uint4*)(p + vlo);
  for (int64_t k = tid; k < nvec; k += nth) q[k] = make_uint4(0, 0, 0, 0);
  for (int64_t i = vlo + (nvec << 4) + tid; i < hi; i += nth) p[i] = 0;
}

// nbytes (a multiple of 4) from shared memory to g (4-byte aligned), by
// the block: stage holds byte k of the output at stage[(g & 15) + k], so
// the 16-byte words between a 4-byte head and tail are aligned on both
// sides
__device__ __forceinline__ void copy_out(const char* stage, char* g,
                                         int64_t nbytes) {
  const int tid = threadIdx.x;
  const char* src = stage + ((uintptr_t)g & 15);
  int64_t head = (int64_t)((16 - ((uintptr_t)g & 15)) & 15);
  if (head > nbytes) head = nbytes;
  for (int64_t k = 4 * tid; k < head; k += 4 * K3_THREADS)
    *(uint32_t*)(g + k) = *(const uint32_t*)(src + k);
  const int64_t nvec = (nbytes - head) >> 4;
  const uint4* sv = (const uint4*)(src + head);
  uint4* gv = (uint4*)(g + head);
  for (int64_t k = tid; k < nvec; k += K3_THREADS) gv[k] = sv[k];
  for (int64_t k = head + (nvec << 4) + 4 * tid; k < nbytes;
       k += 4 * K3_THREADS)
    *(uint32_t*)(g + k) = *(const uint32_t*)(src + k);
}

// the fills of output slots [lo, hi) of the shard at base, by the block:
// each key column's fill, zero values
__device__ __forceinline__ void fill_rows(const KeyCol* s_key, int nk,
                                          const Leaf* s_leaf, int nv,
                                          int64_t base, int64_t lo,
                                          int64_t hi) {
  if (lo >= hi) return;
#pragma unroll 1
  for (int c = 0; c < nk; ++c) {
    const KeyCol& k = s_key[c];
    if (k.w == 8)
      fill_span<long long>((long long*)k.out + base, lo, hi,
                           (long long)k.fill, threadIdx.x, K3_THREADS);
    else
      fill_span<int32_t>((int32_t*)k.out + base, lo, hi, (int32_t)k.fill,
                         threadIdx.x, K3_THREADS);
  }
#pragma unroll 1
  for (int l = 0; l < nv; ++l) {
    const Leaf& f = s_leaf[l];
    zero_bytes(f.out, (base + lo) * f.bytes, (base + hi) * f.bytes,
               threadIdx.x, K3_THREADS);
  }
}

// exclusive segmented scan over the block's threads of (f: the thread
// holds a start, a: the fold of its rows since its last start): *ef
// whether an earlier thread of the tile holds a start, *ea the fold of
// the earlier threads' rows since the last such start (or the tile's
// first row); every thread calls it
template <typename T, int OP>
__device__ __forceinline__ void block_seg_scan(int f, T a, T* s_v, int* s_f,
                                               int* ef, T* ea) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T ident = identity_of<T>(OP);
  T v = a;
  int g = f;
  for (int d = 1; d < 32; d <<= 1) {
    const T ov = __shfl_up_sync(DPK_FULL, v, d);
    const int og = __shfl_up_sync(DPK_FULL, g, d);
    if (lane >= d) {
      if (!g) v = combine<T, OP>(ov, v);
      g |= og;
    }
  }
  if (lane == 31) {
    s_v[warp] = v;
    s_f[warp] = g;
  }
  __syncthreads();
  if (warp == 0) {
    const bool in = lane < K3_THREADS / 32;
    T w = in ? s_v[lane] : ident;
    int wg = in ? s_f[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const T ow = __shfl_up_sync(DPK_FULL, w, d);
      const int og = __shfl_up_sync(DPK_FULL, wg, d);
      if (lane >= d) {
        if (!wg) w = combine<T, OP>(ow, w);
        wg |= og;
      }
    }
    const T pw = __shfl_up_sync(DPK_FULL, w, 1);
    const int pg = __shfl_up_sync(DPK_FULL, wg, 1);
    if (in) {
      s_v[lane] = lane > 0 ? pw : ident;   // exclusive over warps
      s_f[lane] = lane > 0 ? pg : 0;
    }
  }
  __syncthreads();
  const T pv = __shfl_up_sync(DPK_FULL, v, 1);
  const int pg = __shfl_up_sync(DPK_FULL, g, 1);
  const T lv = lane > 0 ? pv : ident;
  const int lg = lane > 0 ? pg : 0;
  *ef = s_f[warp] | lg;
  *ea = lg ? lv : combine<T, OP>(s_v[warp], lv);
  __syncthreads();
}

// K3_CHUNK values of lane w from row r (rows past cap read as 0)
template <typename T>
__device__ __forceinline__ void load_chunk(const T* p, int64_t base, int r,
                                           int cap, int W, int w, T* v) {
  const T* q = p + base + r;
  if (W == 1 && r + K3_CHUNK <= cap && ((uintptr_t)q & 15) == 0) {
#pragma unroll
    for (int i = 0; i < K3_CHUNK; i += 2) load16(q + i, v + i);
    return;
  }
#pragma unroll
  for (int i = 0; i < K3_CHUNK; ++i)
    v[i] = r + i < cap ? p[(base + r + i) * W + w] : (T)0;
}

// step 3 for a reduction: each lane's runs folded through the thread's
// rows, each tail of a run that started in the thread writing its value
// at output row j (j0: the row of the run open before the thread's
// rows); then a segmented block scan gives the fold of that open run in
// the tile before the thread.  The thread that holds its tail writes it,
// or, where the run began before the tile (no start before the thread),
// stores that partial fold at part[lane] for step 4 and sets *ctail.  The
// last thread stores the tile's aggregate, the fold from its last start
// (or its first row) to its end, at agg[lane].  The values live in
// registers 8 rows at a time, and only up to the scan.
template <typename T, int OP>
__device__ __forceinline__ void tile_values(
    const Leaf& f, int64_t base, int row0, int cap, unsigned vm,
    unsigned starts, unsigned tails, int j0, unsigned long long* agg,
    unsigned long long* part, int* ctail, T* s_v, int* s_f, char* stage,
    int pc, int nout) {
  const T ident = identity_of<T>(OP);
  const T* p = (const T*)f.p;
  T* out = (T*)f.out;
  const int W = (int)f.lanes;
  // a dense tile's scalar values go through shared memory: output row j
  // (>= pc) at st[j - pc], then out[pc, pc + nout) in 16-byte words
  T* st = nullptr;
  if (stage != nullptr && W == 1)
    st = (T*)(stage + ((uintptr_t)(out + base + pc) & 15));
  // the rows before the thread's first start, and the open run's tail
  const unsigned lead = starts ? (1u << (__ffs(starts) - 1)) - 1u : ~0u;
  const unsigned ptail = tails & lead;
#pragma unroll 1
  for (int w = 0; w < W; ++w) {
    T pre = ident, run = ident;
    int j = j0;
#pragma unroll 1
    for (int h = 0; h < K3_ITEMS && (vm >> h); h += K3_CHUNK) {
      T v[K3_CHUNK];
      load_chunk<T>(p, base, row0 + h, cap, W, w, v);
#pragma unroll
      for (int i = 0; i < K3_CHUNK; ++i) {
        const int b = h + i;
        if (!((vm >> b) & 1u)) continue;
        if ((starts >> b) & 1u) {
          run = v[i];
          ++j;
        } else if ((lead >> b) & 1u) {
          pre = combine<T, OP>(pre, v[i]);
        } else {
          run = combine<T, OP>(run, v[i]);
        }
        // (+) the identity: a float sum's -0.0 becomes 0.0, as the plain
        // version's fold from its identity gives
        if (((tails & ~lead) >> b) & 1u) {
          if (st != nullptr)
            st[j - pc] = combine<T, OP>(ident, run);
          else
            out[(base + j) * W + w] = combine<T, OP>(ident, run);
        }
      }
    }
    const T a = starts ? run : pre;
    int ef;
    T ea;
    block_seg_scan<T, OP>(starts != 0, a, s_v, s_f, &ef, &ea);
    if (ptail) {
      const T open = combine<T, OP>(ea, pre);
      if (ef) {
        if (st != nullptr)
          st[j0 - pc] = combine<T, OP>(ident, open);
        else
          out[(base + j0) * W + w] = combine<T, OP>(ident, open);
      } else {
        part[f.lane0 + w] = to_bits(open);
        *ctail = 1;
      }
    }
    if (threadIdx.x == K3_THREADS - 1)
      agg[f.lane0 + w] = to_bits(starts ? a : combine<T, OP>(ea, a));
    if (st != nullptr) {
      __syncthreads();
      copy_out(stage, (char*)(out + base + pc), (int64_t)nout * sizeof(T));
      __syncthreads();
    }
  }
}

// step 4, by one warp, for a tile whose first row continues a run: each
// lane's carry, the left fold of the value of tile vstop (its inclusive
// value when vinc, else its aggregate) and the aggregates of tiles
// vstop+1 .. t-1; with ctail the run's value, carry (+) part, at output
// row `row`; with store_inc (no start in the tile) carry (+) the tile's
// aggregate as its inclusive value.  agg/inc/part point at the shard's
// tile 0.
template <typename T, int OP>
__device__ __forceinline__ void finish_carry(
    const Leaf& f, const unsigned long long* agg, unsigned long long* inc,
    const unsigned long long* part, int64_t L, int t, int vstop, int vinc,
    bool ctail, bool store_inc, int64_t row) {
  const int lane = threadIdx.x & 31;
  const T ident = identity_of<T>(OP);
#pragma unroll 1
  for (int64_t w = 0; w < f.lanes; ++w) {
    const int64_t li = f.lane0 + w;
    T carry = from_bits<T>(ld_status((vinc ? inc : agg) + vstop * L + li));
    for (int qb = vstop + 1; qb < t; qb += 32) {
      const int q = qb + lane;
      const T x = q < t ? from_bits<T>(ld_status(agg + q * L + li)) : ident;
      const int m = t - qb < 32 ? t - qb : 32;
      for (int i = 0; i < m; ++i)
        carry = combine<T, OP>(carry, __shfl_sync(DPK_FULL, x, i));
    }
    if (lane == 0) {
      if (ctail)
        ((T*)f.out)[row * f.lanes + w] = combine<T, OP>(
            ident, combine<T, OP>(
                       carry, from_bits<T>(ld_status(part + t * L + li))));
      if (store_inc)
        inc[t * L + li] = to_bits(combine<T, OP>(
            carry, from_bits<T>(ld_status(agg + t * L + li))));
    }
  }
}

// step 4 for "last": each tail copies its row to its run's output row
__device__ __forceinline__ void tile_last(const Leaf& f, int64_t base,
                                          int row0, unsigned starts,
                                          unsigned tails, int j0) {
  int j = j0;
#pragma unroll
  for (int i = 0; i < K3_ITEMS; ++i) {
    if ((starts >> i) & 1u) ++j;
    if ((tails >> i) & 1u)
      copy_row(f.p + (base + row0 + i) * f.bytes,
               f.out + (base + j) * f.bytes, f.bytes);
  }
}

// n_unique of shard s for a fill item: the inclusive word of the tile
// that holds the shard's last valid row, once published (that tile took
// its id before this item, so it is running)
__device__ __forceinline__ int64_t wait_unique(
    const unsigned long long* stat, int64_t nvc, int* s_n) {
  if (threadIdx.x == 0) {
    int c = 0;
    if (nvc > 0) {
      const unsigned long long* w = stat + (nvc - 1) / K3_TILE;
      unsigned long long v = ld_status(w);
      for (unsigned polls = 0; (v >> 62) != K3_INC; v = ld_status(w)) {
        if (++polls == (1u << 26)) __trap();
      }
      c = (int)(v & K3_COUNT);
    }
    *s_n = c;
  }
  __syncthreads();
  return *s_n;
}

// a tile's histogram into the shard's counts; the last of the shard's
// tiles to arrive (done[s]) writes its exclusive offsets
__device__ __forceinline__ void arrive(int64_t s, int dst_col, int n_dst,
                                       int64_t ntiles, const int* h_sm,
                                       int32_t* dcounts, int32_t* doffs,
                                       unsigned* done, int* s_last,
                                       int* s_c) {
  if (dst_col < 0) return;
  const int tid = threadIdx.x;
  __syncthreads();
  for (int k = tid; k < n_dst; k += K3_THREADS)
    if (h_sm[k]) atomicAdd(&dcounts[s * n_dst + k], h_sm[k]);
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    *s_last = atomicAdd(done + s, 1u) == (unsigned)(ntiles - 1);
  }
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
  int carry = 0;
  for (int k0 = 0; k0 < n_dst; k0 += K3_THREADS) {
    const int k = k0 + tid;
    const int x = k < n_dst ? (int)ld_relaxed_u32(
                                  (const unsigned*)dcounts + s * n_dst + k)
                            : 0;
    int tot;
    const int ex = block_excl_scan(x, s_c, &tot);
    if (k < n_dst) doffs[s * n_dst + k] = carry + ex;
    carry += tot;
  }
}

// one work item a block, from an atomic counter (sweep_item).  stat and
// vstat: the tiles' count and value words; agg holds three planes of N *
// ntiles * L lanes: the tiles' aggregates, inclusive values and partial
// folds of the run they continue
template <int OP>
static __global__ void __launch_bounds__(K3_THREADS, K3_MIN_BLOCKS)
    k3_sweep(const KeyCols K, const ValLeaves V, const int32_t* n, int N,
             int64_t cap, int64_t ntiles, int64_t nfill, int dst_col,
             int n_dst, int64_t L, int32_t* nuniq, int32_t* dcounts,
             int32_t* doffs, unsigned long long* status,
             unsigned long long* vstatus, unsigned long long* counter,
             unsigned* done, unsigned long long* agg) {
  __shared__ int s_item, s_pre, s_last, s_ctail, s_lasttail;
  // dynamic: the staging buffer (K3_STAGE_BYTES), then n_dst counters
  extern __shared__ __align__(16) char s_stage[];
  int* h_sm = (int*)(s_stage + K3_STAGE_BYTES);
  __shared__ int s_c[32], s_l[32], s_f[32];
  __shared__ unsigned long long s_v[32];
  __shared__ unsigned s_mask[K3_THREADS];
  __shared__ KeyCol s_key[DPK_MAX_KEYS];
  __shared__ Leaf s_leaf[DPK_MAX_LEAVES];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    s_item = (int)atomicAdd(counter, 1ull);
    s_ctail = 0;
  }
  load_tables(K, V, s_key, s_leaf);
  if (dst_col >= 0)
    for (int k = tid; k < n_dst; k += K3_THREADS) h_sm[k] = 0;
  __syncthreads();
  int64_t s64, t64;
  const bool fill = sweep_item(s_item, ntiles, nfill, N, &s64, &t64);
  // rows and ranks in int (cap < 2^31 - K3_TILE), addresses from base
  const int s = (int)s64, t = (int)t64;
  const int64_t base = s64 * cap;
  const int ns = n[s];
  const int nvc = ns < 0 ? 0 : (ns < cap ? ns : (int)cap);
  unsigned long long* stat = status + s64 * ntiles;
  if (fill) {                               // a fill item: [n_unique, n)
    const int64_t lo = t * K3_FILL_ROWS;
    const int64_t hi = lo + K3_FILL_ROWS < nvc ? lo + K3_FILL_ROWS : nvc;
    if (lo >= hi) return;
    const int64_t first = wait_unique(stat, nvc, &s_pre);
    fill_rows(s_key, K.n, s_leaf, V.n, base, lo > first ? lo : first, hi);
    return;
  }
  const int t0 = t * K3_TILE;
  const int tend = t0 + K3_TILE < cap ? t0 + K3_TILE : (int)cap;
  if (t0 >= nvc) {                          // no valid row: fills alone
    fill_rows(s_key, K.n, s_leaf, V.n, base, t0, tend);
    if (t == 0 && tid == 0) nuniq[s] = 0;
    arrive(s, dst_col, n_dst, ntiles, h_sm, dcounts, doffs, done, &s_last,
           s_c);
    return;
  }
  if (nvc < tend) fill_rows(s_key, K.n, s_leaf, V.n, base, nvc, tend);

  // 1. this thread's run starts (bit i: row row0 + i) and tails
  const int row0 = t0 + tid * K3_ITEMS;
  unsigned vm = 0, starts = 0;
  if (row0 < nvc) {
    const int left = nvc - row0;
    vm = left >= K3_ITEMS ? (1u << K3_ITEMS) - 1u : (1u << left) - 1u;
    unsigned d = row0 == 0 ? 1u : 0u;
#pragma unroll 1
    for (int c = 0; c < K.n; ++c) {
      if (s_key[c].w == 8)
        d |= col_diffs<long long, K3_ITEMS>(s_key[c].p, base, row0, cap);
      else
        d |= col_diffs<int32_t, K3_ITEMS>(s_key[c].p, base, row0, cap);
    }
    starts = d & vm;
  }
  s_mask[tid] = starts;
  int ex_c, ex_l, tot_c, tot_l;
  scan_starts(__popc(starts),
              starts ? (int)(row0 + 31 - __clz(starts)) : -1, s_c, s_l,
              &ex_c, &ex_l, &tot_c, &tot_l);
  const bool lead = s_mask[0] & 1u;         // row t0 starts a run
  unsigned nxt;                             // row row0 + K3_ITEMS starts
  if (tid + 1 < K3_THREADS)
    nxt = s_mask[tid + 1] & 1u;
  else
    nxt = t0 + K3_TILE < nvc && row_differs(s_key, K.n, base + t0 + K3_TILE)
              ? 1u
              : 0u;
  const unsigned vmn = (vm >> 1) |
                       (row0 + K3_ITEMS < nvc ? 1u << (K3_ITEMS - 1) : 0u);
  const unsigned tails =
      vm & ((starts >> 1) | (nxt << (K3_ITEMS - 1)) | ~vmn);

  // 2. the tile's count word, then (one warp, 32 words a load) the
  // starts before the tile, up to the nearest inclusive word
  if (tid == 0)
    st_status(stat + t, k3_word(t > 0 ? K3_AGG : K3_INC, tot_c));
  if (warp == 0 && t > 0) {
    unsigned pc = 0, polls = 0;
    for (int p = t - 1;;) {
      const int q = p - lane;
      const unsigned long long w =
          q >= 0 ? ld_status(stat + q) : K3_INC << 62;
      const unsigned flag = (unsigned)(w >> 62);
      const unsigned inc = __ballot_sync(DPK_FULL, flag == K3_INC);
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
      unsigned c = (upto >> lane) & 1u ? (unsigned)(w & K3_COUNT) : 0u;
      for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(DPK_FULL, c, o);
      pc += c;
      if (inc) break;
      p -= 32;
    }
    if (lane == 0) {
      s_pre = (int)pc;
      st_status(stat + t, k3_word(K3_INC, pc + tot_c));
    }
  }
  if (t == 0 && tid == 0) s_pre = 0;
  {                                         // the tile's last valid row
    const int nl = (tend < nvc ? tend : nvc) - 1;
    if (row0 <= nl && nl < row0 + K3_ITEMS)
      s_lasttail = (tails >> (nl - row0)) & 1u;
  }
  __syncthreads();

  // 3. the starts' keys at their ranks and the destination histogram
  // (a dense tile stages each column in shared memory and writes it in
  // 16-byte words); the values (or "last" rows) at each tail
  const int pc = s_pre;
  const bool dense = tot_c >= K3_DENSE && tot_c <= K3_STAGE;
#pragma unroll 1
  for (int c = 0; c < K.n; ++c) {
    const KeyCol& k = s_key[c];
    char* g = k.out + (base + pc) * k.w;
    char* st = s_stage + ((uintptr_t)g & 15);
    int e = ex_c;
    int64_t dcur = -1;                      // the destination counted,
    int dn = 0;                             // starts of it not yet added
    for (unsigned m = starts; m; m &= m - 1) {
      const int64_t x = load_key(k.p, k.w, base + row0 + __ffs(m) - 1);
      if (dense)
        store_key(st, k.w, e, x);
      else
        store_key(g, k.w, e, x);
      if (c == dst_col && x != dcur) {
        if (dn && dcur >= 0 && dcur < n_dst) atomicAdd(&h_sm[dcur], dn);
        dcur = x;
        dn = 0;
      }
      ++dn;
      ++e;
    }
    if (c == dst_col && dn && dcur >= 0 && dcur < n_dst)
      atomicAdd(&h_sm[dcur], dn);
    if (dense) {
      __syncthreads();
      copy_out(s_stage, g, (int64_t)tot_c * k.w);
      __syncthreads();
    }
  }
  if (row0 <= nvc - 1 && nvc - 1 < row0 + K3_ITEMS)
    nuniq[s] = (int32_t)(pc + tot_c);
  const int j0 = pc + ex_c - 1;
  // the values of runs started in the tile: all but the last, whose tail
  // may lie in a later tile
  const int nout = tot_c - 1 + s_lasttail;
  const int64_t plane = (int64_t)N * ntiles * L;
  unsigned long long* sagg = agg + s64 * ntiles * L;  // the shard's tile 0
  unsigned long long* vstat = vstatus + s64 * ntiles;
#pragma unroll 1
  for (int l = 0; l < V.n; ++l) {
    const Leaf& f = s_leaf[l];
    if constexpr (OP == OP_LAST) {
      tile_last(f, base, row0, starts, tails, j0);
    } else if (f.kind == 0) {
      tile_values<long long, OP>(f, base, row0, cap, vm, starts, tails, j0,
                                 sagg + t * L, sagg + 2 * plane + t * L,
                                 &s_ctail, (long long*)s_v, s_f,
                                 dense ? s_stage : nullptr, pc, nout);
    } else {
      tile_values<double, OP>(f, base, row0, cap, vm, starts, tails, j0,
                              sagg + t * L, sagg + 2 * plane + t * L,
                              &s_ctail, (double*)s_v, s_f,
                              dense ? s_stage : nullptr, pc, nout);
    }
  }

  if constexpr (OP != OP_LAST) {
    // the tile's value word: its aggregates stored (inclusive for tile 0)
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      st_status(vstat + t, (t > 0 ? K3_AGG : K3_INC) << 62 |
                               (tot_c > 0 ? K3_HAS_START : 0ull));
    }
    // 4. a tile whose first row continues a run: one warp looks back
    // over the value words for the nearest tile that ends the run's
    // carry, one holding a start (its aggregate) or an inclusive one (its
    // inclusive value), and folds the carry left to right to finish the
    // run's value where its tail is here; a tile without a start then
    // stores its inclusive value before its inclusive word
    if (!lead && warp == 0) {               // here t > 0
      const bool store_inc = tot_c == 0;
      int vstop = -1, vinc = 0;
      unsigned polls = 0;
      for (int p = t - 1;;) {
        const int q = p - lane;
        const unsigned long long w =
            q >= 0 ? ld_status(vstat + q) : (K3_INC << 62 | K3_HAS_START);
        const unsigned flag = (unsigned)(w >> 62);
        const unsigned hs =
            __ballot_sync(DPK_FULL, flag != 0 && (w & K3_HAS_START) != 0);
        const unsigned stop = hs | __ballot_sync(DPK_FULL, flag == K3_INC);
        const unsigned zero = __ballot_sync(DPK_FULL, flag == 0);
        const unsigned upto = stop ? ((stop & (0u - stop)) << 1) - 1u
                                   : DPK_FULL;
        if (zero & upto) {
          if (++polls == (1u << 26)) __trap();
          continue;
        }
        if (stop) {
          const int b = __ffs(stop) - 1;
          vstop = p - b;
          vinc = !((hs >> b) & 1u);
          break;
        }
        p -= 32;
      }
      __threadfence();                      // the words before the values
      const int64_t row = base + pc - 1;    // the continued run's output
#pragma unroll 1
      for (int l = 0; l < V.n; ++l) {
        const Leaf& f = s_leaf[l];
        if (f.kind == 0)
          finish_carry<long long, OP>(f, sagg, sagg + plane,
                                      sagg + 2 * plane, L, t, vstop, vinc,
                                      s_ctail, store_inc, row);
        else
          finish_carry<double, OP>(f, sagg, sagg + plane, sagg + 2 * plane,
                                   L, t, vstop, vinc, s_ctail, store_inc,
                                   row);
      }
      if (lane == 0 && store_inc) {
        __threadfence();
        st_status(vstat + t, K3_INC << 62);
      }
    }
  }
  arrive(s, dst_col, n_dst, ntiles, h_sm, dcounts, doffs, done, &s_last,
         s_c);
}

// keys: nk pointers to sorted (N, cap) int32/int64 columns (widths w),
// key_out: nk packed outputs, fill: per-column tail value; dst_col: index
// of the destination column among the keys (or -1), n_dst its bucket
// count, dcounts/doffs: (N, n_dst) outputs (dcounts zeroed by the
// caller).  vals: nv pointers to (N, cap, W) value leaves, val_out their
// packed outputs, vbytes the row bytes, vkind 0 = int64, 1 = float64,
// 2 = any (op must be "last"), vw the lane count W.  n: (N,) valid rows;
// nuniq: (N,) out.  status: (2 * N * ceil(cap / K3_TILE) + 1 + N) uint64
// zeroed by the caller (the tiles' count and value words, the item
// counter, the shards' tile counters as uint32); agg: 3 * N *
// ceil(cap / K3_TILE) * L uint64, L the lanes of all leaves (unused by
// "last": may be null).
extern "C" int dpk_reduce_by_key(
    const void* const* keys, void* const* key_out, const int* w,
    const int64_t* fill, int nk, int dst_col, int n_dst,
    const void* const* vals, void* const* val_out, const int64_t* vbytes,
    const int* vkind, const int64_t* vw, int nv, int op, const int32_t* n,
    int N, int64_t cap, int32_t* nuniq, int32_t* dcounts, int32_t* doffs,
    void* status, void* agg, void* stream) {
  if (nk < 1 || nk > DPK_MAX_KEYS || nv < 0 || nv > DPK_MAX_LEAVES ||
      op < OP_ADD || op > OP_LAST || N < 1 || cap > (1ll << 31) - K3_TILE ||
      dst_col >= nk || (dst_col >= 0 && (n_dst < 1 || n_dst > K3_MAX_DST)))
    return (int)cudaErrorInvalidValue;
  KeyCols K;
  K.n = nk;
  for (int c = 0; c < DPK_MAX_KEYS; ++c) {
    if (c < nk && w[c] != 4 && w[c] != 8) return (int)cudaErrorInvalidValue;
    K.p[c] = c < nk ? (const char*)keys[c] : nullptr;
    K.out[c] = c < nk ? (char*)key_out[c] : nullptr;
    K.w[c] = c < nk ? w[c] : 8;
    K.fill[c] = c < nk ? fill[c] : 0;
  }
  ValLeaves V;
  V.n = nv;
  int64_t L = 0;
  for (int l = 0; l < DPK_MAX_LEAVES; ++l) {
    if (l < nv && op != OP_LAST && vkind[l] != 0 && vkind[l] != 1)
      return (int)cudaErrorInvalidValue;
    V.p[l] = l < nv ? (const char*)vals[l] : nullptr;
    V.out[l] = l < nv ? (char*)val_out[l] : nullptr;
    V.bytes[l] = l < nv ? vbytes[l] : 0;
    V.lanes[l] = l < nv ? vw[l] : 0;
    V.lane0[l] = L;
    V.kind[l] = l < nv ? vkind[l] : 0;
    if (l < nv && op != OP_LAST) L += vw[l];
  }
  if (cap == 0) return (int)cudaGetLastError();
  if (L > 0 && agg == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t ntiles = (cap + K3_TILE - 1) / K3_TILE;
  const int64_t nfill = (cap + K3_FILL_ROWS - 1) / K3_FILL_ROWS;
  unsigned long long* words = (unsigned long long*)status;
  unsigned long long* vwords = words + N * ntiles;
  unsigned long long* counter = vwords + N * ntiles;
  unsigned* done = (unsigned*)(counter + 1);
  unsigned long long* a = (unsigned long long*)agg;
  const unsigned grid = (unsigned)(N * (ntiles + nfill));
  const size_t smem = K3_STAGE_BYTES + 4 * (dst_col >= 0 ? n_dst : 0);
  switch (op) {
#define DPK_K3(OPV)                                                        \
  case OPV:                                                                \
    cudaFuncSetAttribute(k3_sweep<OPV>,                                    \
                         cudaFuncAttributeMaxDynamicSharedMemorySize,      \
                         K3_STAGE_BYTES + 4 * K3_MAX_DST);                 \
    k3_sweep<OPV><<<grid, K3_THREADS, smem, st>>>(                         \
        K, V, n, N, cap, ntiles, nfill, dst_col, n_dst, L, nuniq, dcounts, \
        doffs, words, vwords, counter, done, a);                           \
    break;
    DPK_K3(OP_ADD)
    DPK_K3(OP_MIN)
    DPK_K3(OP_MAX)
    DPK_K3(OP_MUL)
    DPK_K3(OP_LAST)
#undef DPK_K3
  }
  return (int)cudaGetLastError();
}
