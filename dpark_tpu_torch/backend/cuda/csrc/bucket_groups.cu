// K8 bucket_gather / bucket_scatter: the padded group matrix of one
// power-of-two size class, and the write-back of each group's result.
//
// Replaces dpark_tpu/backend/tpu/collectives.py:605 gather_bucket_groups
// (the (G, B) value matrix of the groups in one size class, padded to the
// class width) and the output scatter of SegMapOp.apply
// (dpark_tpu/backend/tpu/fuse.py:880-886: each group's result written at
// its segment id).
//
// The members of every class come from K2 (stable_partition of segment
// ids by K7's class column): shard s's class-b members are the segment
// ids members[s, boff[s] .. boff[s] + bcnt[s]), in segment order.  Lane
// (s, g) is valid when g < bcnt[s].
//
// Gather: one thread per (shard, group lane, column) writes
// out[s, g, o] = vals[s, start + o] for o < size; past the size, "zero"
// pads write 0 and "edge" pads repeat the group's last row; an invalid
// lane writes 0 everywhere.  Neighbouring threads read neighbouring rows
// of one group, so reads and writes coalesce except at group ends.
// Scatter (k8_scatter_classes): the results of every listed class in one
// launch.  A block serves K8X_THREADS x K8X_ITEMS consecutive member
// slots of one shard, its row of the class offsets and counts staged in
// shared memory (at most SIZE_CLASSES + 1 = 33 entries); a slot's class
// is the last whose offset is at or below it (a binary search there),
// its lane the slot less that offset.  A slot of a listed class copies
// its lane's result res[k][l][s, lane] of each leaf to out[l][s,
// members[s, slot]]; with `fill`, every other slot (the pad class
// SIZE_CLASSES, the slots past n_seg, and any unlisted class) writes 0
// there, so that one launch writes every (N, cap) output slot exactly
// once (members is a permutation of each shard's slots) and the caller
// allocates the outputs with torch.empty: the reference's zeros and
// .at[tgt].set (fuse.py:880-886) in one pass.  The pad class, the last
// table column, is most of the slots where groups are large; its slot j
// holds segment id j (bucket_members' stable partition keeps the ids
// past n_seg in order after every class), so it writes 0 at out[l][s, j]
// without reading members: 8 bytes a slot, as the zero fill it replaces.  Without `fill` (the
// single-class entry: one table column, boff/bcnt) the block covers that
// class's lanes alone and other slots are left as they are.  The
// classes' result pointers and G go by value (__grid_constant__); a
// layout past K8X_MAX_RESULTS (class, leaf) pointers is split by leaves
// over several launches by the wrapper.  It takes the place of one
// launch a class after a torch.zeros of every output, each launch with a
// column copy of offsets and counts.
//
// Bound: bytes.  The gather writes the padded (N, G, B) matrix once and
// reads each group's rows once (plus 12 B of member, start and size per
// lane); the scatter reads each member id of a real class and each
// lane's results once and writes every output slot once (with `fill`;
// without it, the class's lanes alone).
//
// State gather (bucket_gather_state), the state mode of the segmented
// apply (updateStateByKey's update(values, prev) over (k, (v, flag))
// rows: flag 1 is the carried state row, at most one a group, flag 0 a
// new value).  Replaces dpark_tpu/backend/tpu/fuse.py:803-835
// (SegMapOp._apply_bucket's masked sum and any(), _new_vals' argsort of
// ~new_mask, take_along_axis and re-fill) and :862-875 (the flag gather,
// pad slots pinned to flag 2).  One pass a class fills the padded (N, G,
// B) matrix of each group's NEW values compacted to the front in row
// order, the pad fill behind them ("zero": 0; "edge": the last new
// value, 0 when there is none), `prev` (N, G) (the flag-1 row's value,
// copied; 0 without one; the first flag-1 row where a group holds
// several, as the plain version's argmax) and `has_prev` (N, G).
// Classes up to K8S_NARROW (128) wide: T = B (at most 32) threads serve a
// lane, reading T rows of the group at a time, and a warp ballot of the
// flag-0 rows gives each new value its slot (the count of the group's
// earlier new values).  Wider classes hold few groups, most of their
// matrix padding (at a decayed-counter tick, classes 2^15 to 2^19 pad 8
// lanes a shard, one of them live, to 520 MB): the grid runs over (lane,
// chunk of K8S_CHUNK slots), so that its size follows the slots and not
// the lane count.  A lane of one chunk is one block (k8s_write alone).
// A lane of several takes two launches: k8s_count reads only the flags
// and records each chunk's count of new values, its last new row and its
// first flag-1 row; then k8s_write ranks each chunk's new values from
// the records of the lane's earlier chunks and its own block scan,
// copies them, fills its chunk of the output's slots past the lane's
// count with 16-byte stores ("edge": the value at the lane's last new
// row), and the lane's chunk 0 writes prev and has_prev.  Invalid lanes'
// chunks write zeros alone.  Bound: bytes -- each group's rows and flags
// read once, the matrix, prev and has_prev written once; the wide
// classes' padded matrix is most of it.
#include "common.cuh"

#define K8S_THREADS 256
#define K8S_CHUNK 4096                    // slots a block, wide classes
                                          // (at most 65,536: 16-bit ranks)
#define K8S_NARROW 128                    // the widest warp-form class
#define K8S_NONE 0x7fffffff               // no flag-1 row

static __global__ void k8_gather(const int32_t* start_rows,
                                 const int32_t* sizes,
                                 const int32_t* members,
                                 const int32_t* boff, const int32_t* bcnt,
                                 int64_t cap, int G, int B, const char* vals,
                                 int64_t vbytes, char* out, int edge,
                                 int64_t total) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int o = (int)(t % B);
  const int64_t sg = t / B;
  const int g = (int)(sg % G);
  const int s = (int)(sg / G);
  char* dst = out + t * vbytes;
  if (g >= bcnt[s]) {
    zero_row(dst, vbytes);
    return;
  }
  const int64_t base = (int64_t)s * cap;
  const int32_t seg = members[base + boff[s] + g];
  const int32_t st = start_rows[base + seg];
  const int32_t sz = sizes[base + seg];
  int64_t row;
  if (o < sz) {
    row = st + o;
  } else if (edge) {
    row = st + (sz > 0 ? sz - 1 : 0);
  } else {
    zero_row(dst, vbytes);
    return;
  }
  copy_row(vals + (base + row) * vbytes, dst, vbytes);
}

// start_rows, sizes, members: (N, cap) int32; boff, bcnt: (N,) int32;
// vals: (N, cap) of vbytes-wide elements; out: (N, G, B).
extern "C" int dpk_bucket_gather(const int32_t* start_rows,
                                 const int32_t* sizes,
                                 const int32_t* members, const int32_t* boff,
                                 const int32_t* bcnt, int N, int64_t cap,
                                 int G, int B, const void* vals,
                                 int64_t vbytes, void* out, int edge,
                                 void* stream) {
  if (G < 1 || B < 1 || vbytes < 1) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)N * G * B;
  if (total == 0) return (int)cudaGetLastError();
  const int threads = 256;
  k8_gather<<<(unsigned)((total + threads - 1) / threads), threads, 0,
              (cudaStream_t)stream>>>(start_rows, sizes, members, boff, bcnt,
                                      cap, G, B, (const char*)vals, vbytes,
                                      (char*)out, edge, total);
  return (int)cudaGetLastError();
}

#define K8X_THREADS 256
#define K8X_ITEMS 4                       // slots a thread, K8X_THREADS apart
#define K8X_TABLE 33                      // SIZE_CLASSES + 1: a shard's row
#define K8X_MAX_CLASSES 32
#define K8X_MAX_RESULTS 256               // (class, leaf) result pointers

struct ScatterClasses {
  const char* res[K8X_MAX_RESULTS];       // listed class k's leaf l: k * nl + l
  char* out[DPK_MAX_LEAVES];
  int64_t G[K8X_MAX_CLASSES];
  signed char slot[K8X_TABLE];            // table class -> listed k, or -1
  unsigned char bytes[DPK_MAX_LEAVES];    // 1, 2, 4 or 8
  int nl;                                 // leaves
  int nt;                                 // table entries a row
  int ostride;                            // row stride of off and cnt
  int fill;                               // 0 to every slot not listed
};

__device__ __forceinline__ void put_elem(const char* src, char* dst, int by) {
  switch (by) {
    case 8: *(uint64_t*)dst = src ? *(const uint64_t*)src : 0; break;
    case 4: *(uint32_t*)dst = src ? *(const uint32_t*)src : 0; break;
    case 2: *(uint16_t*)dst = src ? *(const uint16_t*)src : 0; break;
    default: *dst = src ? *src : 0; break;
  }
}

static __global__ void __launch_bounds__(K8X_THREADS)
k8_scatter_classes(const __grid_constant__ ScatterClasses S,
                   const int32_t* members, const int32_t* off,
                   const int32_t* cnt, int64_t cap) {
  __shared__ int64_t so[K8X_TABLE];
  __shared__ int64_t hi;
  const int s = blockIdx.y;
  const int64_t row = (int64_t)s * S.ostride;
  if (threadIdx.x < S.nt) so[threadIdx.x] = off[row + threadIdx.x];
  if (threadIdx.x == 0)
    hi = (int64_t)off[row + S.nt - 1] + cnt[row + S.nt - 1];
  __syncthreads();
  const int64_t base = (int64_t)s * cap;
  const int64_t t0 = so[0] + (int64_t)blockIdx.x * K8X_THREADS * K8X_ITEMS;
#pragma unroll
  for (int i = 0; i < K8X_ITEMS; ++i) {
    const int64_t j = t0 + i * K8X_THREADS + threadIdx.x;
    if (j >= hi) break;
    // the last class whose offset is at or below j (empty classes share
    // their successor's offset and lose to it)
    int c = 0;
#pragma unroll
    for (int w = 32; w; w >>= 1)
      if (c + w < S.nt && so[c + w] <= j) c += w;
    const int k = S.slot[c];
    const int64_t lane = j - so[c];
    const bool have = k >= 0 && lane < S.G[k];
    if (!have && !S.fill) continue;
    // the pad class's slot j holds segment id j (K2 keeps the ids past
    // n_seg in order at the end): no member read for most of the slots
    const int64_t seg = S.fill && c == S.nt - 1 ? j : members[base + j];
    for (int l = 0; l < S.nl; ++l) {
      const int by = S.bytes[l];
      put_elem(have ? S.res[k * S.nl + l] + ((int64_t)s * S.G[k] + lane) * by
                    : nullptr,
               S.out[l] + (base + seg) * by, by);
    }
  }
}

// members: (N, cap) int32, each shard's segment ids grouped by class;
// off, cnt: (N, ostride) int32 tables of which the first nt columns are
// the classes' offsets and counts in members; span: the most slots a
// shard's table covers (cap, or G for one class); classes[k] (k < nc)
// the table column of listed class k, G[k] its lanes; res: nc * nleaves
// (N, G[k]) results, class-major; out: nleaves (N, cap) leaves of
// bytes[l] (1, 2, 4 or 8) bytes an element; fill: write 0 at every slot
// not listed.
extern "C" int dpk_bucket_scatter_classes(
    const int32_t* members, const int32_t* off, const int32_t* cnt,
    int ostride, int nt, int N, int64_t cap, int64_t span, int nc,
    const int* classes, const int64_t* G, const void* const* res,
    int nleaves, void* const* out, const int64_t* bytes, int fill,
    void* stream) {
  if (nt < 1 || nt > K8X_TABLE || ostride < nt || nc < 0 ||
      nc > K8X_MAX_CLASSES || nleaves < 1 || nleaves > DPK_MAX_LEAVES ||
      nc * nleaves > K8X_MAX_RESULTS || N < 0 || N > 65535 || span < 0)
    return (int)cudaErrorInvalidValue;
  ScatterClasses S;
  S.nl = nleaves;
  S.nt = nt;
  S.ostride = ostride;
  S.fill = fill;
  for (int c = 0; c < K8X_TABLE; ++c) S.slot[c] = -1;
  for (int k = 0; k < K8X_MAX_CLASSES; ++k) S.G[k] = k < nc ? G[k] : 0;
  for (int k = 0; k < nc; ++k) {
    if (classes[k] < 0 || classes[k] >= nt || S.slot[classes[k]] != -1 ||
        G[k] < 0)
      return (int)cudaErrorInvalidValue;
    S.slot[classes[k]] = (signed char)k;
  }
  for (int i = 0; i < K8X_MAX_RESULTS; ++i)
    S.res[i] = i < nc * nleaves ? (const char*)res[i] : nullptr;
  for (int l = 0; l < DPK_MAX_LEAVES; ++l) {
    const int64_t b = l < nleaves ? bytes[l] : 1;
    if (b != 1 && b != 2 && b != 4 && b != 8)
      return (int)cudaErrorInvalidValue;
    S.out[l] = l < nleaves ? (char*)out[l] : nullptr;
    S.bytes[l] = (unsigned char)b;
  }
  const int64_t tile = (int64_t)K8X_THREADS * K8X_ITEMS;
  const int64_t gx = (span + tile - 1) / tile;
  if (N == 0 || gx == 0) return (int)cudaGetLastError();
  k8_scatter_classes<<<dim3((unsigned)gx, (unsigned)N), K8X_THREADS, 0,
                       (cudaStream_t)stream>>>(S, members, off, cnt, cap);
  return (int)cudaGetLastError();
}

static __global__ void k8_gather_state(const int32_t* start_rows,
                                       const int32_t* sizes,
                                       const int32_t* members,
                                       const int32_t* boff,
                                       const int32_t* bcnt, int64_t cap,
                                       int G, int B, int T, const char* vals,
                                       int64_t vbytes, const int64_t* flags,
                                       char* out, char* prev, bool* has_prev,
                                       int edge, int64_t nlanes) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t lane = t / T;
  const int sub = (int)(t % T);
  const bool in = lane < nlanes;
  int64_t base = 0;
  int32_t st = 0, sz = 0;
  if (in) {
    const int s = (int)(lane / G);
    const int g = (int)(lane % G);
    base = (int64_t)s * cap;
    if (g < bcnt[s]) {
      const int32_t seg = members[base + boff[s] + g];
      st = start_rows[base + seg];
      sz = sizes[base + seg];
    }
  }
  // the T threads of a lane are neighbours in one warp (T divides 32)
  const unsigned wl = threadIdx.x & 31u;
  const unsigned gmask =
      T == 32 ? DPK_FULL : (((1u << T) - 1u) << (wl & ~(unsigned)(T - 1)));
  const unsigned below = (1u << wl) - 1u;
  char* orow = out + (in ? lane : 0) * (int64_t)B * vbytes;
  int n_new = 0;
  bool has = false;
  for (int o0 = 0; o0 < B; o0 += T) {
    const int o = o0 + sub;
    int64_t fl = 2;                       // pad slots: neither kind
    if (o < sz) fl = flags[base + st + o];
    const unsigned bal_new = __ballot_sync(DPK_FULL, fl == 0) & gmask;
    const unsigned bal_old = __ballot_sync(DPK_FULL, fl == 1) & gmask;
    if (fl == 0) {
      const int slot = n_new + __popc(bal_new & below);
      copy_row(vals + (base + st + o) * vbytes, orow + slot * vbytes, vbytes);
    } else if (fl == 1) {
      copy_row(vals + (base + st + o) * vbytes, prev + lane * vbytes, vbytes);
    }
    n_new += __popc(bal_new);
    has = has || bal_old != 0;
  }
  __syncwarp();                           // the compacted rows are visible
  if (!in) return;
  for (int o = n_new + sub; o < B; o += T) {
    if (edge && n_new > 0)
      copy_row(orow + (int64_t)(n_new - 1) * vbytes, orow + o * vbytes,
               vbytes);
    else
      zero_row(orow + o * vbytes, vbytes);
  }
  if (sub == 0) {
    has_prev[lane] = has;
    if (!has) zero_row(prev + lane * vbytes, vbytes);
  }
}

// The wide classes' form: a lane spreads over blocks of K8S_CHUNK slots
// (min(B, K8S_CHUNK) a block, K8S_THREADS threads).  A block's rows are
// those of its chunk of the group, their flags read once, coalesced,
// into a shared byte a row (1: a new value, flag 0); the chunk's count
// and last new row come from a block reduction (scan_starts), its
// flag-1 row (the first) from a shared atomicMin.  To rank its new
// values, each thread counts a run of consecutive bytes, a block scan
// gives each run its first rank, and the thread writes the ranks of its
// run's rows; the copy then reads the values coalesced again.  The
// chunk of output slots a block fills is the same chunk of the lane's B
// columns.

// lane `lane` of a class: its group's base row, start and size (0 for
// an invalid lane)
__device__ __forceinline__ void k8s_lane(
    const int32_t* start_rows, const int32_t* sizes, const int32_t* members,
    const int32_t* boff, const int32_t* bcnt, int64_t cap, int G,
    int64_t lane, int64_t* base, int32_t* st, int32_t* sz) {
  const int s = (int)(lane / G);
  const int g = (int)(lane % G);
  *base = (int64_t)s * cap;
  *st = 0;
  *sz = 0;
  if (g < bcnt[s]) {
    const int32_t seg = members[*base + boff[s] + g];
    *st = start_rows[*base + seg];
    *sz = sizes[*base + seg];
  }
}

// the group's rows o0 + [0, n) of this chunk, each flag read once (the
// block's threads in turn): s_new[k] (when staged) is 1 for a new value;
// returns the thread's count of new values, *last its last new row (-1),
// *first1 the chunk's first flag-1 row (atomicMin)
template <bool STAGE>
__device__ __forceinline__ int k8s_load(const int64_t* fl, int64_t o0,
                                        int n, unsigned char* s_new,
                                        int* first1, int* last) {
  int cnt = 0;
  *last = -1;
#pragma unroll 4
  for (int k = threadIdx.x; k < n; k += K8S_THREADS) {
    const int64_t f = fl[o0 + k];
    if (STAGE) s_new[k] = f == 0;
    if (f == 0) {
      ++cnt;
      *last = (int)o0 + k;
    } else if (f == 1) {
      atomicMin(first1, (int)o0 + k);
    }
  }
  return cnt;
}

// the rows of chunk c of a group of sz rows
__device__ __forceinline__ int k8s_rows(int64_t c, int chunk, int32_t sz) {
  const int64_t n = sz - c * chunk;
  return n <= 0 ? 0 : (n < chunk ? (int)n : chunk);
}

// first pass of a lane of several chunks: each chunk's record (count of
// new values, last new row or -1, first flag-1 row or K8S_NONE)
static __global__ void __launch_bounds__(K8S_THREADS)
    k8s_count(const int32_t* start_rows, const int32_t* sizes,
              const int32_t* members, const int32_t* boff,
              const int32_t* bcnt, int64_t cap, int G, int chunk,
              int nchunks, const int64_t* flags, int4* rec) {
  __shared__ int s_c[32], s_l[32];
  __shared__ int s_first1;
  const int64_t lane = blockIdx.x / nchunks;
  const int64_t c = blockIdx.x % nchunks;
  int64_t base;
  int32_t st, sz;
  k8s_lane(start_rows, sizes, members, boff, bcnt, cap, G, lane, &base, &st,
           &sz);
  if (threadIdx.x == 0) s_first1 = K8S_NONE;
  __syncthreads();
  int last;
  const int cnt = k8s_load<false>(flags + base + st, c * chunk,
                                  k8s_rows(c, chunk, sz), nullptr,
                                  &s_first1, &last);
  int ex_c, ex_l, tot_c, tot_l;
  scan_starts(cnt, last, s_c, s_l, &ex_c, &ex_l, &tot_c, &tot_l);
  if (threadIdx.x == 0) rec[blockIdx.x] = make_int4(tot_c, tot_l, s_first1, 0);
}

// the lane's chunk c: its new values at their ranks, its part of the pad
// fill, and (chunk 0) prev and has_prev
template <typename T>
static __global__ void __launch_bounds__(K8S_THREADS)
    k8s_write(const int32_t* start_rows, const int32_t* sizes,
              const int32_t* members, const int32_t* boff,
              const int32_t* bcnt, int64_t cap, int G, int64_t B, int chunk,
              int nchunks, const T* vals, const int64_t* flags,
              const int4* rec, T* out, T* prev, bool* has_prev, int edge) {
  __shared__ unsigned char s_new[K8S_CHUNK];
  __shared__ unsigned short s_rank[K8S_CHUNK];
  __shared__ int s_c[32], s_l[32];
  __shared__ int s_first1, s_last, s_f1;
  __shared__ long long s_before, s_total;
  const int tid = threadIdx.x;
  const int64_t lane = blockIdx.x / nchunks;
  const int64_t c = blockIdx.x % nchunks;
  int64_t base;
  int32_t st, sz;
  k8s_lane(start_rows, sizes, members, boff, bcnt, cap, G, lane, &base, &st,
           &sz);
  if (tid == 0) s_first1 = K8S_NONE;
  __syncthreads();
  const int64_t o0 = c * chunk;
  const int n = k8s_rows(c, chunk, sz);
  int last;
  k8s_load<true>(flags + base + st, o0, n, s_new, &s_first1, &last);
  __syncthreads();
  // this thread's run of consecutive rows, counted in shared memory
  const int per = (chunk + K8S_THREADS - 1) / K8S_THREADS;
  const int r0 = tid * per < n ? tid * per : n;
  const int r1 = r0 + per < n ? r0 + per : n;
  int cnt = 0;
  for (int j = r0; j < r1; ++j) cnt += s_new[j];
  int ex_c, ex_l, tot_c, tot_l;
  scan_starts(cnt, last, s_c, s_l, &ex_c, &ex_l, &tot_c, &tot_l);
  for (int j = r0, r = ex_c; j < r1; ++j) {
    s_rank[j] = (unsigned short)r;
    r += s_new[j];
  }
  // the lane's new values before this chunk and in all, its last new row
  // and its flag-1 row: this chunk's own, or the records of all chunks
  long long before = 0, total = tot_c;
  int lastn = tot_l, f1 = s_first1;
  if (nchunks > 1 && tid < 32) {
    long long bf = 0, tt = 0;
    int ln = -1, fr = K8S_NONE;
    for (int k = tid; k < nchunks; k += 32) {
      const int4 r = rec[lane * nchunks + k];
      tt += r.x;
      if (k < c) bf += r.x;
      ln = max(ln, r.y);
      fr = min(fr, r.z);
    }
    for (int o = 16; o > 0; o >>= 1) {
      bf += __shfl_xor_sync(DPK_FULL, bf, o);
      tt += __shfl_xor_sync(DPK_FULL, tt, o);
      ln = max(ln, __shfl_xor_sync(DPK_FULL, ln, o));
      fr = min(fr, __shfl_xor_sync(DPK_FULL, fr, o));
    }
    if (tid == 0) {
      s_before = bf;
      s_total = tt;
      s_last = ln;
      s_f1 = fr;
    }
  }
  __syncthreads();                        // the ranks and the lane's totals
  if (nchunks > 1) {
    before = s_before;
    total = s_total;
    lastn = s_last;
    f1 = s_f1;
  }
  const T* v = vals + base + st + o0;
  T* orow = out + lane * B;
  for (int k = tid; k < n; k += K8S_THREADS)
    if (s_new[k]) orow[before + s_rank[k]] = v[k];
  T fill{};
  if (edge && total > 0) fill = vals[base + st + lastn];
  fill_span<T>(orow, total > o0 ? total : o0, o0 + chunk, fill, tid,
               K8S_THREADS);
  if (c == 0 && tid == 0) {
    const bool has = f1 != K8S_NONE;
    T p{};
    if (has) p = vals[base + st + f1];
    prev[lane] = p;
    has_prev[lane] = has;
  }
}

template <typename T>
static int k8s_launch(const int32_t* start_rows, const int32_t* sizes,
                      const int32_t* members, const int32_t* boff,
                      const int32_t* bcnt, int64_t nlanes, int64_t cap,
                      int G, int64_t B, const void* vals,
                      const int64_t* flags, void* out, void* prev,
                      bool* has_prev, int edge, void* scratch,
                      cudaStream_t st) {
  const int chunk = B < K8S_CHUNK ? (int)B : K8S_CHUNK;
  const int64_t nchunks = B / chunk;
  const int64_t nblocks = nlanes * nchunks;
  if (nblocks > 0x7fffffffLL || (nchunks > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (nchunks > 1)
    k8s_count<<<(unsigned)nblocks, K8S_THREADS, 0, st>>>(
        start_rows, sizes, members, boff, bcnt, cap, G, chunk, (int)nchunks,
        flags, (int4*)scratch);
  k8s_write<T><<<(unsigned)nblocks, K8S_THREADS, 0, st>>>(
      start_rows, sizes, members, boff, bcnt, cap, G, B, chunk, (int)nchunks,
      (const T*)vals, flags, (const int4*)scratch, (T*)out, (T*)prev,
      has_prev, edge);
  return (int)cudaGetLastError();
}

// start_rows, sizes, members: (N, cap) int32; boff, bcnt: (N,) int32;
// vals: (N, cap) of vbytes-wide elements; flags: (N, cap) int64; out:
// (N, G, B); prev: (N, G) of vbytes-wide elements; has_prev: (N, G) bool;
// scratch: for B > K8S_CHUNK, N * G * (B / K8S_CHUNK) int4 records.
extern "C" int dpk_bucket_gather_state(
    const int32_t* start_rows, const int32_t* sizes, const int32_t* members,
    const int32_t* boff, const int32_t* bcnt, int N, int64_t cap, int G,
    int B, const void* vals, int64_t vbytes, const int64_t* flags, void* out,
    void* prev, bool* has_prev, int edge, void* scratch, void* stream) {
  if (G < 1 || B < 1 || (B & (B - 1)) != 0 || vbytes < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t nlanes = (int64_t)N * G;
  if (nlanes == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (B > K8S_NARROW) {
    switch (vbytes) {
      case 1:
        return k8s_launch<uint8_t>(start_rows, sizes, members, boff, bcnt,
                                   nlanes, cap, G, B, vals, flags, out, prev,
                                   has_prev, edge, scratch, st);
      case 2:
        return k8s_launch<uint16_t>(start_rows, sizes, members, boff, bcnt,
                                    nlanes, cap, G, B, vals, flags, out,
                                    prev, has_prev, edge, scratch, st);
      case 4:
        return k8s_launch<uint32_t>(start_rows, sizes, members, boff, bcnt,
                                    nlanes, cap, G, B, vals, flags, out,
                                    prev, has_prev, edge, scratch, st);
      case 8:
        return k8s_launch<unsigned long long>(
            start_rows, sizes, members, boff, bcnt, nlanes, cap, G, B, vals,
            flags, out, prev, has_prev, edge, scratch, st);
      case 16:
        return k8s_launch<uint4>(start_rows, sizes, members, boff, bcnt,
                                 nlanes, cap, G, B, vals, flags, out, prev,
                                 has_prev, edge, scratch, st);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  const int T = B < 32 ? B : 32;
  const int64_t total = nlanes * T;
  const int threads = 256;
  k8_gather_state<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                    st>>>(start_rows, sizes, members, boff, bcnt, cap, G, B,
                          T, (const char*)vals, vbytes, flags, (char*)out,
                          (char*)prev, has_prev, edge, nlanes);
  return (int)cudaGetLastError();
}
