// K5 radix_sort: the stable sort permutation of each shard's row of one
// key column (int32, int64 or float64), optionally read through a prior
// permutation, so that successive key passes compose into one
// lexicographic order with no gather between them.
//
// Replaces the argsort passes of dpark_tpu/backend/tpu/collectives.py:123
// _lex_sort (and through it the key sorts of bucketize_combine_keys,
// segment_reduce_keys, the no-combine reduce side, SortOp and the
// per-shard top-n).  Output: perm[s, j] = src[s, p[s, j]] where p is the
// stable argsort of col[s, src[s, :]] (src = identity when null) -- bit
// for bit what torch.sort(..., stable=True) composes to.
//
// An LSD radix sort with 8-bit digits over the order-preserving unsigned
// image of the key: ints flip the sign bit; floats first turn -0.0 into
// +0.0 and every NaN into one positive quiet NaN (ties and NaN-last as
// torch.sort), then flip every bit of a negative and the sign bit of a
// non-negative.
//
// 1. k5_hist reads the keys once and builds every digit's per-shard
//    histogram (one warp-wide AND/OR of the images finds the digits a
//    warp's rows share: those take one shared atomic from the leader);
//    k5_bases scans each into the start of every digit value's run and
//    flags the digits on which some shard's rows differ.  Through src,
//    k5_stage first gathers the image into row order (the one random
//    read) and finds each shard's least image; k5_hist then reads the
//    staged image in order and rewrites it less that least, so that a
//    narrow range of keys needs only its low digits even where it
//    straddles zero or a digit boundary (int32 keys in [-1000, 1000):
//    two passes, not four).
// 2. The host reads the flags (one small copy), allocates the pass
//    buffers, and one C call launches a one-sweep pass per active digit
//    (Adinets and Merrill, "Onesweep", 2022).  The image between passes
//    is 4 bytes when every active digit lies in the low four bytes (int32
//    keys, bench keys, vertex ids), else 8; the last pass writes only the
//    permutation.  A block takes the next tile of a shard from the pass's
//    atomic counter (so a tile's predecessors are always running and the
//    look-back makes progress), loads it coalesced into registers, ranks
//    it stably by warp-level multi-split (eight ballots give each row its
//    peers of the same digit; one counter row per warp in shared memory),
//    scans the warps x 256 counts, publishes its 256 digit counts as an
//    aggregate in a per-(tile, digit) status word (32-bit tag, 32-bit
//    count), exchanges the tile into digit order in shared memory, looks
//    back 16 earlier tiles' words a round trip up to the nearest
//    inclusive prefix, publishes its own, and writes the tile out
//    coalesced: sorted row j goes to base[digit] + prefix[digit] + (j -
//    tile_start[digit]), neighbouring threads to neighbouring addresses
//    in runs of tile / 256 rows on average.
//
// Bound: bytes.  The histogram pass reads the key once (through src:
// reads src and the key, writes the staged image, then reads and
// rewrites it); each pass reads and writes each row's image and index
// once: 16 B a row a pass with a 4-byte image, 24 B with an 8-byte one
// (the first pass reads the key column or the staged image; the last
// writes only the index).  At N=8, cap=2^23: bench.py's keys (two active
// digits, 4-byte image) 2.42 GB, 0.72 ms at 3.35 TB/s; full-range random
// int64 (eight digits, 8-byte image) 12.6 GB, 3.77 ms.  What stays above
// it: the status words (8 B a tile and digit), the latency of a tile's
// phases (load, rank, scan, look-back, write; hidden only by the other
// resident blocks), the partial 32-byte sectors at the ends of each
// digit's run in a tile, and through src the random gather of the key.
#include "common.cuh"

#define K5_RADIX 256
#define K5_HIST_ROWS 4                     // rows in flight a thread
#define K5_HIST_THREADS 512
#define K5_HIST_BLOCKS 3                   // blocks an SM holds
#define K5_STAGE_ROWS 4                    // gathers in flight a thread
#define K5_LOOKBACK 16                     // status words a look-back load

// the order-preserving image of raw key bits; kind: 0 = int32, 1 = int64,
// 2 = float64, 3 = already an image
__device__ __forceinline__ uint64_t image_bits(uint64_t b, int kind) {
  if (kind == 0) return (uint64_t)((uint32_t)b ^ 0x80000000u);
  if (kind == 1) return b ^ 0x8000000000000000ull;
  if (kind == 2) {
    const double x = __longlong_as_double((long long)b);
    if (x == 0.0)
      b = 0;                      // -0.0 and +0.0 tie
    else if (x != x)
      b = 0x7FF8000000000000ull;  // every NaN: one positive quiet NaN, last
    return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
  }
  return b;
}

template <int BYTES>
__device__ __forceinline__ uint64_t load_bits(const void* p, int64_t idx) {
  if (BYTES == 4) return ((const uint32_t*)p)[idx];
  return ((const unsigned long long*)p)[idx];
}

template <int B> struct Word;
template <> struct Word<4> { typedef uint32_t T; };
template <> struct Word<8> { typedef unsigned long long T; };

// through src: the gathered image in row order (BYTES: 4 for int32, else
// 8) and each shard's least image into lo (all ones on entry)
template <int BYTES>
static __global__ void __launch_bounds__(K5_HIST_THREADS, K5_HIST_BLOCKS)
    k5_stage(const void* col, int kind, const int32_t* src, int64_t cap,
             void* img, unsigned long long* lo) {
  typedef typename Word<BYTES>::T W;
  __shared__ unsigned long long s_lo;
  const int s = blockIdx.y;
  if (threadIdx.x == 0) s_lo = ~0ull;
  __syncthreads();
  const int64_t base = (int64_t)s * cap;
  const int64_t step = (int64_t)blockDim.x * K5_STAGE_ROWS;
  unsigned long long m = ~0ull;
  for (int64_t i0 = (int64_t)blockIdx.x * step; i0 < cap;
       i0 += (int64_t)gridDim.x * step) {
    W u[K5_STAGE_ROWS];
#pragma unroll
    for (int q = 0; q < K5_STAGE_ROWS; ++q) {
      const int64_t i = i0 + q * blockDim.x + threadIdx.x;
      if (i < cap)
        u[q] = (W)load_bits<BYTES>(col, base + src[base + i]);
    }
#pragma unroll
    for (int q = 0; q < K5_STAGE_ROWS; ++q) {
      const int64_t i = i0 + q * blockDim.x + threadIdx.x;
      if (i < cap) {
        const unsigned long long v = image_bits(u[q], kind);
        ((W*)img)[base + i] = (W)v;
        m = v < m ? v : m;
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long v = __shfl_xor_sync(DPK_FULL, m, o);
    m = v < m ? v : m;
  }
  if ((threadIdx.x & 31) == 0) atomicMin(&s_lo, m);
  __syncthreads();
  if (threadIdx.x == 0) atomicMin(&lo[s], s_lo);
}

// every digit's per-shard histogram, in one read of the keys (`bytes`
// wide); with lo, of the image less its shard's lo[s], written back in
// place (the staged image through src)
static __global__ void __launch_bounds__(K5_HIST_THREADS, K5_HIST_BLOCKS)
    k5_hist(void* col, int kind, int bytes, int64_t cap, int ndig,
            int32_t* hist, const unsigned long long* lo) {
  __shared__ int h_sm[8 * K5_RADIX];
  const int s = blockIdx.y;
  for (int k = threadIdx.x; k < ndig * K5_RADIX; k += blockDim.x) h_sm[k] = 0;
  __syncthreads();
  const int64_t base = (int64_t)s * cap;
  const int64_t step = (int64_t)blockDim.x * K5_HIST_ROWS;
  const uint64_t least = lo != nullptr ? lo[s] : 0;
  for (int64_t i0 = (int64_t)blockIdx.x * step; i0 < cap;
       i0 += (int64_t)gridDim.x * step) {
    uint64_t u[K5_HIST_ROWS];
#pragma unroll
    for (int q = 0; q < K5_HIST_ROWS; ++q) {
      const int64_t i = i0 + q * blockDim.x + threadIdx.x;
      if (i < cap)
        u[q] = image_bits(bytes == 4 ? load_bits<4>(col, base + i)
                                     : load_bits<8>(col, base + i),
                          kind) - least;
    }
#pragma unroll
    for (int q = 0; q < K5_HIST_ROWS; ++q) {
      const int64_t i = i0 + q * blockDim.x + threadIdx.x;
      const bool live = i < cap;
      const unsigned act = __ballot_sync(DPK_FULL, live);
      if (live) {
        if (lo != nullptr) {
          if (bytes == 4)
            ((uint32_t*)col)[base + i] = (uint32_t)u[q];
          else
            ((unsigned long long*)col)[base + i] = u[q];
        }
        // the bits on which the warp's live rows agree: a digit they all
        // share takes one atomic from the leader, others one a row
        const uint32_t lo32 = (uint32_t)u[q], hi32 = (uint32_t)(u[q] >> 32);
        const uint64_t same =
            ~((uint64_t)(__reduce_and_sync(act, hi32) ^
                         __reduce_or_sync(act, hi32)) << 32 |
              (__reduce_and_sync(act, lo32) ^ __reduce_or_sync(act, lo32)));
        const bool leader = (int)(threadIdx.x & 31) == __ffs(act) - 1;
        for (int d = 0; d < ndig; ++d) {
          const int b = (int)((u[q] >> (8 * d)) & 0xFF);
          if (((same >> (8 * d)) & 0xFF) != 0xFF)
            atomicAdd(&h_sm[d * K5_RADIX + b], 1);
          else if (leader)
            atomicAdd(&h_sm[d * K5_RADIX + b], __popc(act));
        }
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < ndig * K5_RADIX; k += blockDim.x)
    if (h_sm[k]) atomicAdd(&hist[(int64_t)s * ndig * K5_RADIX + k], h_sm[k]);
}

// per (digit, shard): exclusive scan of the histogram (the start of each
// digit value's run) and whether the shard's rows take two or more values
static __global__ void k5_bases(const int32_t* hist, int ndig,
                                int32_t* bases, int32_t* active) {
  __shared__ int sm[32];
  const int d = blockIdx.x, s = blockIdx.y;
  const int64_t off = ((int64_t)s * ndig + d) * K5_RADIX;
  const int c = hist[off + threadIdx.x];
  int tot;
  bases[off + threadIdx.x] = block_excl_scan(c, sm, &tot);
  const int values = __syncthreads_count(c > 0);
  if (threadIdx.x == 0 && values > 1) atomicOr(&active[d], 1);
}

// shared memory of a pass: sorted images, sorted indices, per-warp digit
// counts, per-digit tile starts and output offsets, sorted digits
template <int THREADS, int ITEMS, int OUT>
struct PassSmem {
  static constexpr int TILE = THREADS * ITEMS;
  static constexpr int WARPS = THREADS / 32;
  static constexpr size_t IDX = (size_t)TILE * OUT;
  static constexpr size_t WH = IDX + (size_t)TILE * 4;
  static constexpr size_t DSTART = WH + (size_t)WARPS * K5_RADIX * 4;
  static constexpr size_t GOFS = DSTART + K5_RADIX * 4;
  static constexpr size_t DIG = GOFS + K5_RADIX * 4;
  static constexpr size_t BYTES = DIG + TILE;
};

// one pass of a sort over one digit, as the host planned it from the
// histogram pass's flags
struct PassArgs {
  const void* kin;      // images (or the key column) of the current order
  int kind;             // image_bits kind of kin
  const int32_t* iin;   // source rows of the current order (null: i)
  int64_t cap;
  int64_t ntiles;       // tiles a shard
  int shift;            // 8 * digit
  const int32_t* base;  // (256,) per shard at stride bstride: run starts
  int64_t bstride;
  unsigned long long* status;   // (N * ntiles, 256)
  unsigned long long* counter;  // this pass's tile counter
  unsigned agg, inc;            // this pass's tags
  void* kout;                   // images in the new order (OUT > 0)
  int32_t* iout;                // source rows in the new order (the
                                // permutation on the last pass)
};

// one one-sweep pass over digit `shift / 8`: IN / OUT bytes of image read
// and written (OUT 0 on the last pass), a block a tile
template <int THREADS, int ITEMS, int MINB, int IN, int OUT>
static __global__ void __launch_bounds__(THREADS, MINB)
    k5_pass(const PassArgs a) {
  typedef PassSmem<THREADS, ITEMS, OUT> L;
  typedef typename Word<IN>::T K;
  constexpr int TILE = L::TILE, WARPS = L::WARPS;
  extern __shared__ __align__(16) unsigned char k5_sm[];
  int32_t* s_idx = (int32_t*)(k5_sm + L::IDX);
  int* s_wh = (int*)(k5_sm + L::WH);
  int* s_dstart = (int*)(k5_sm + L::DSTART);
  int* s_gofs = (int*)(k5_sm + L::GOFS);
  uint8_t* s_dig = k5_sm + L::DIG;
  __shared__ int s_tile;
  __shared__ int s_scan[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = (int)atomicAdd(a.counter, 1ull);
  for (int k = tid; k < WARPS * K5_RADIX; k += THREADS) s_wh[k] = 0;
  __syncthreads();
  const int64_t g = s_tile;                 // global tile id, shard-major
  const int64_t s = g / a.ntiles, t = g - s * a.ntiles;
  const int64_t base = s * a.cap, t0 = t * TILE;
  const int nvalid = a.cap - t0 < TILE ? (int)(a.cap - t0) : TILE;

  // load: warp w takes rows [t0 + w*32*ITEMS, +32*ITEMS), item k of lane
  // l is row k*32 + l of that run, so (warp, item, lane) is row order
  const int64_t seg = t0 + (int64_t)warp * 32 * ITEMS + lane;
  K key[ITEMS];
  int32_t idx[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int64_t i = seg + k * 32;
    key[k] = 0;
    idx[k] = 0;
    if (i < a.cap) {
      idx[k] = a.iin != nullptr ? a.iin[base + i] : (int32_t)i;
      key[k] = (K)image_bits(load_bits<IN>(a.kin, base + i), a.kind);
    }
  }

  // rank: each row's place among the warp's earlier rows of its digit
  int* wh = s_wh + warp * K5_RADIX;
  int pos[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const bool live = seg + k * 32 < a.cap;
    const int b = live ? (int)((key[k] >> a.shift) & 0xFF) : K5_RADIX;
    // multi-split by ballots: the lanes that agree on every bit (faster
    // on this card than __match_any_sync)
    unsigned peers = __ballot_sync(DPK_FULL, live);
    if (!live) peers = ~peers;
#pragma unroll
    for (int bit = 0; bit < 8; ++bit) {
      const unsigned m = __ballot_sync(DPK_FULL, (b >> bit) & 1);
      peers &= ((b >> bit) & 1) ? m : ~m;
    }
    const int leader = 31 - __clz(peers);
    int old = 0;
    if (lane == leader && live) {
      old = wh[b];
      wh[b] = old + __popc(peers);
    }
    old = __shfl_sync(DPK_FULL, old, leader);
    pos[k] = old + __popc(peers & ((1u << lane) - 1u));
    __syncwarp();
  }
  __syncthreads();

  // per digit: the counts of earlier warps, the tile's count, published
  // at once so that later tiles' look-backs can pass this one
  int cnt = 0;
  unsigned long long* my = a.status + g * K5_RADIX + tid;
  if (tid < K5_RADIX) {
    for (int w = 0; w < WARPS; ++w) {
      const int c = s_wh[w * K5_RADIX + tid];
      s_wh[w * K5_RADIX + tid] = cnt;
      cnt += c;
    }
    if (t > 0)
      st_status(my, ((unsigned long long)a.agg << 32) | (unsigned)cnt);
  }
  int total;
  const int start =
      block_excl_scan(tid < K5_RADIX ? cnt : 0, s_scan, &total);
  if (tid < K5_RADIX) s_dstart[tid] = start;
  __syncthreads();

  // exchange into digit order through shared memory (tile positions
  // only: the registers are free before the look-back)
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    if (seg + k * 32 < a.cap) {
      const int b = (int)((key[k] >> a.shift) & 0xFF);
      const int tp = s_dstart[b] + wh[b] + pos[k];
      if constexpr (OUT > 0)
        ((typename Word<OUT>::T*)k5_sm)[tp] =
            (typename Word<OUT>::T)key[k];
      s_idx[tp] = idx[k];
      s_dig[tp] = (uint8_t)b;
    }
  }

  // look back over the shard's earlier tiles, K5_LOOKBACK status words a
  // round trip: sum the aggregates up to the nearest inclusive prefix
  if (tid < K5_RADIX) {
    const unsigned long long* col =
        a.status + s * a.ntiles * K5_RADIX + tid;
    unsigned excl = 0, polls = 0;
    for (int64_t p = t - 1; p >= 0;) {
      unsigned long long w[K5_LOOKBACK];
#pragma unroll
      for (int q = 0; q < K5_LOOKBACK; ++q)
        w[q] = p - q >= 0 ? ld_status(col + (p - q) * K5_RADIX) : 0ull;
      int used = 0;
      bool found = false, stop = false;
#pragma unroll
      for (int q = 0; q < K5_LOOKBACK; ++q) {
        const unsigned tag = (unsigned)(w[q] >> 32);
        if (!stop && (tag == a.agg || tag == a.inc)) {
          excl += (unsigned)w[q];
          ++used;
          found = tag == a.inc;
          stop = found;
        } else {
          stop = true;    // not yet published: read it again
        }
      }
      if (found) break;
      p -= used;
      // an earlier tile's block is resident (it took its id first), so
      // its word comes within microseconds; a fault that lost it traps
      // (a launch error) instead of hanging the card
      if (used == 0 && ++polls == (1u << 26)) __trap();
    }
    st_status(my,
              ((unsigned long long)a.inc << 32) | (excl + (unsigned)cnt));
    s_gofs[tid] = a.base[s * a.bstride + tid] + (int)excl - start;
  }
  __syncthreads();

  // coalesced write-out: sorted row j of the tile
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int j = k * THREADS + tid;
    if (j < nvalid) {
      const int64_t gp = base + s_gofs[s_dig[j]] + j;
      if constexpr (OUT > 0)
        ((typename Word<OUT>::T*)a.kout)[gp] =
            ((const typename Word<OUT>::T*)k5_sm)[j];
      a.iout[gp] = s_idx[j];
    }
  }
}

// a pass's tile by the bytes of the image it reads: 512 threads (two
// blocks an SM, so 64 registers a thread) x 12 rows for 4-byte images,
// x 8 for 8-byte ones; the status words are tiled by the smaller
#define K5_THREADS 512
__host__ __device__ constexpr int k5_items(int in_bytes) {
  return in_bytes == 4 ? 12 : 8;
}
#define K5_MIN_TILE (K5_THREADS * 8)

template <int THREADS, int ITEMS, int MINB, int IN, int OUT>
static int launch_pass(const PassArgs& a, int N, cudaStream_t st) {
  typedef PassSmem<THREADS, ITEMS, OUT> L;
#define K5_PASS k5_pass<THREADS, ITEMS, MINB, IN, OUT>
  static unsigned long long ready = 0;  // devices given the smem attribute
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!((ready >> dev) & 1ull)) {
    e = cudaFuncSetAttribute(K5_PASS,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::BYTES);
    if (e != cudaSuccess) return (int)e;
    ready |= 1ull << dev;
  }
  const int64_t blocks = (int64_t)N * a.ntiles;
  if (blocks > 0) K5_PASS<<<(unsigned)blocks, THREADS, L::BYTES, st>>>(a);
  return (int)cudaGetLastError();
#undef K5_PASS
}

static int launch_role(const PassArgs& a, int in_bytes, int out_bytes,
                       int N, cudaStream_t st) {
#define K5_ROLE(I, O) \
  launch_pass<K5_THREADS, k5_items(I), 2, I, O>(a, N, st)
  if (in_bytes == 4 && out_bytes == 0) return K5_ROLE(4, 0);
  if (in_bytes == 4 && out_bytes == 4) return K5_ROLE(4, 4);
  if (in_bytes == 8 && out_bytes == 0) return K5_ROLE(8, 0);
  if (in_bytes == 8 && out_bytes == 4) return K5_ROLE(8, 4);
  if (in_bytes == 8 && out_bytes == 8) return K5_ROLE(8, 8);
#undef K5_ROLE
  return (int)cudaErrorInvalidValue;
}

// col: (N, cap) key column of `kind`; src: (N, cap) int32 or null; ndig:
// 4 (int32) or 8; hist: (N, ndig, 256) int32 zeroed by the caller; bases:
// (N, ndig, 256) int32 out; active: (ndig,) int32 zeroed by the caller;
// img, lo: given exactly when src is: (N, cap) out, the image in the
// order of src less its shard's least image (uint32 for int32, else
// uint64), which the first pass reads; (N,) uint64 set to all ones by the
// caller, the least images out.
extern "C" int dpk_radix_sort_hist(const void* col, int kind,
                                   const int32_t* src, int N, int64_t cap,
                                   int ndig, int32_t* hist, int32_t* bases,
                                   int32_t* active, void* img, void* lo,
                                   void* stream) {
  if (kind < 0 || kind > 2 || ndig < 1 || ndig > 8 || N < 1 ||
      (src != nullptr) != (img != nullptr) ||
      (src != nullptr) != (lo != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // one wave of blocks a shard, so that the blocks resident at a time
  // share a shard: a gather through src then finds its column in L2
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int64_t step = (int64_t)K5_HIST_THREADS * K5_HIST_ROWS;
  int64_t blocks = (cap + step - 1) / step;
  if (blocks > (int64_t)sms * K5_HIST_BLOCKS)
    blocks = (int64_t)sms * K5_HIST_BLOCKS;
  if (blocks < 1) blocks = 1;
  const dim3 grid((unsigned)blocks, (unsigned)N);
  unsigned long long* least = (unsigned long long*)lo;
  if (src != nullptr) {
    const int64_t sstep = (int64_t)K5_HIST_THREADS * K5_STAGE_ROWS;
    int64_t sblocks = (cap + sstep - 1) / sstep;
    if (sblocks > (int64_t)sms * K5_HIST_BLOCKS)
      sblocks = (int64_t)sms * K5_HIST_BLOCKS;
    if (sblocks < 1) sblocks = 1;
    const dim3 sgrid((unsigned)sblocks, (unsigned)N);
    if (kind == 0)
      k5_stage<4><<<sgrid, K5_HIST_THREADS, 0, st>>>(col, kind, src, cap,
                                                     img, least);
    else
      k5_stage<8><<<sgrid, K5_HIST_THREADS, 0, st>>>(col, kind, src, cap,
                                                     img, least);
    k5_hist<<<grid, K5_HIST_THREADS, 0, st>>>(img, 3, kind == 0 ? 4 : 8, cap,
                                              ndig, hist, least);
  } else {
    k5_hist<<<grid, K5_HIST_THREADS, 0, st>>>((void*)col, kind,
                                              kind == 0 ? 4 : 8, cap, ndig,
                                              hist, nullptr);
  }
  k5_bases<<<dim3((unsigned)ndig, (unsigned)N), K5_RADIX, 0, st>>>(
      hist, ndig, bases, active);
  return (int)cudaGetLastError();
}

// The digit passes of one sort, after dpk_radix_sort_hist and the host's
// read of its flags: one one-sweep kernel for each of the npass active
// digits in digits[], the image between passes `width` bytes (4 or the
// key's 8).  col, kind, src, N, cap, ndig, bases: as for the histogram;
// staged: its img (given exactly when src is); kbuf0/1: (N, cap) images
// of `width` bytes, used when npass > 1 and npass > 2 (kbuf1 may be
// staged); ibuf0/1: (N, cap) int32, used when npass > 1 (ibuf[(npass -
// 1) & 1] may be out); out: (N, cap) int32, the permutation; status:
// (N * ceil(cap / K5_MIN_TILE), 256) uint64, then npass or more uint64
// counters, zeroed by the caller (each pass tags its words with its
// number).
extern "C" int dpk_radix_sort_passes(const void* col, int kind,
                                     const int32_t* src, const void* staged,
                                     void* kbuf0, void* kbuf1,
                                     int32_t* ibuf0, int32_t* ibuf1,
                                     int32_t* out, const int32_t* digits,
                                     int npass, int width, int N,
                                     int64_t cap, int ndig,
                                     const int32_t* bases, void* status,
                                     void* stream) {
  const int nat = kind == 0 ? 4 : 8;
  if (kind < 0 || kind > 2 || ndig != nat || N < 1 || npass < 1 ||
      (src != nullptr) != (staged != nullptr) ||
      npass > ndig || (width != 4 && width != nat))
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < npass; ++j)
    if (digits[j] < 0 || digits[j] >= (width == 4 ? 4 : 8) ||
        (j > 0 && digits[j] <= digits[j - 1]))
      return (int)cudaErrorInvalidValue;
  if (cap == 0) return (int)cudaGetLastError();
  const int64_t words =
      (int64_t)N * ((cap + K5_MIN_TILE - 1) / K5_MIN_TILE) * K5_RADIX;
  unsigned long long* counters = (unsigned long long*)status + words;
  void* kbuf[2] = {kbuf0, kbuf1};
  int32_t* ibuf[2] = {ibuf0, ibuf1};
  cudaStream_t st = (cudaStream_t)stream;
  PassArgs a;
  a.cap = cap;
  a.bstride = (int64_t)ndig * K5_RADIX;
  a.status = (unsigned long long*)status;
  for (int j = 0; j < npass; ++j) {
    const int in_bytes = j == 0 ? nat : width;
    const int out_bytes = j == npass - 1 ? 0 : width;
    const int ptile = K5_THREADS * k5_items(in_bytes);
    if (j == 0) {
      a.kin = staged != nullptr ? staged : col;
      a.kind = staged != nullptr ? 3 : kind;
      a.iin = src;
    } else {
      a.kin = kbuf[(j - 1) & 1];
      a.kind = 3;
      a.iin = ibuf[(j - 1) & 1];
    }
    a.ntiles = (cap + ptile - 1) / ptile;
    a.shift = 8 * digits[j];
    a.base = bases + (int64_t)digits[j] * K5_RADIX;
    a.counter = counters + j;
    a.agg = 2u * (unsigned)j + 3u;
    a.inc = 2u * (unsigned)j + 4u;
    a.kout = out_bytes > 0 ? kbuf[j & 1] : nullptr;
    a.iout = out_bytes > 0 ? ibuf[j & 1] : out;
    const int e = launch_role(a, in_bytes, out_bytes, N, st);
    if (e != (int)cudaSuccess) return e;
  }
  return (int)cudaSuccess;
}
