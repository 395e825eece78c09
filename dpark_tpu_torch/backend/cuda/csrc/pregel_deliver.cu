// K10 pregel_deliver: each vertex's combined inbound message.
//
// Replaces dpark_tpu/backend/tpu/bagel.py:364-370 (DevicePregel._p_step:
// `pos = clip(searchsorted(uk, ids))`, `has = (uk[pos] == ids) & valid_v
// & (ids != SENT)`, and each message leaf `where(has, u[pos], identity)`)
// over all N shards at once, and dpark_tpu/backend/tpu/bagel_obj.py:
// 856-869 (the same delivery into each degree class's slots) over every
// class at once.
//
// Shard s holds the combined messages that arrived for it: unique keys
// uk[s, :n_unique[s]] ascending, one row of each message leaf per key.
// A class holds its vertex ids vid[s, :vcnt[s]] in any order (padding
// holds the sentinel).  A vertex slot is valid when j < vcnt[s] and its
// id is not the sentinel.  It has mail when its id is among the shard's
// unique keys: then each message leaf's row is copied, else the leaf's
// fill (the monoid's identity) is written; a message to an id with no
// vertex is never read: dropped.
//
// Bound: bytes.  Per slot its 8 B id read and its 1 B flag written; per
// slot with mail each leaf's row read and written, per slot without the
// fill written.  The search's probes of the key column are extra reads.
//
// Design: a grid sized to the SMs, blockIdx.y the shard.  A block first
// stages a splitter table of its shard's keys in shared memory: every k-th
// key (k a power of two, the least that keeps the table within
// K10_SPLITTERS), so a search takes about log2(K10_SPLITTERS) probes in
// shared memory and log2(k) in a window of k keys (one to a few cache
// lines) of device memory, where a bisection over the whole column took
// log2(n_unique) dependent probes of device memory.  It holds for ids in
// any order, so the object Bagel's class tables take the same route. The
// block then loops over chunks of K10_THREADS x K10_ITEMS slots of its
// shard, over every class of the call (the table is built once a block,
// whatever the number of classes).  A thread carries K10_ITEMS consecutive
// slots: ids come in 16-byte loads, flags in one word, and each leaf's
// rows of 4, 8 or 16 bytes (the fill where no mail) are assembled in
// registers and stored two at a time (16 bytes for rows of 8).  The
// slots' searches run interleaved (the same probe count each, so the loads
// of all items are in flight together); slots past the valid count read no
// id.  Other row sizes move a row at a time in the widest word their
// alignment allows.  The classes, the leaves and their fills reach the
// kernel by value (one __grid_constant__ parameter); the leaf loop is
// unrolled, so every struct index but the class is a constant.
#include "common.cuh"
#include "span_copy.cuh"

#define K10_THREADS 256
#define K10_ITEMS 4              // consecutive slots a thread (even)
#define K10_SPLITTERS 2048       // most splitter keys a block (2^x)
#define K10_MIN_STRIDE 8         // least keys between splitters (2^x)
#define K10_BLOCKS 4             // blocks an SM
#define K10_MAX_CLASSES 32       // kernels.K10_MAX_CLASSES
#define K10_CHUNK (K10_THREADS * K10_ITEMS)

struct K10Args {
  const int64_t* vid[K10_MAX_CLASSES];   // (N, cap) ids, any order
  const int32_t* vcnt[K10_MAX_CLASSES];  // (N,) valid slots a shard
  int64_t cap[K10_MAX_CLASSES];          // slots a shard
  int64_t row0[K10_MAX_CLASSES];         // the class's first row in dst/has
  int64_t chunk0[K10_MAX_CLASSES + 1];   // a shard's first chunk a class
  const char* src[DPK_MAX_LEAVES];       // (N, cap_u, ...) message leaves
  char* dst[DPK_MAX_LEAVES];             // outputs, the classes' rows
  int64_t bytes[DPK_MAX_LEAVES];         // row bytes of each leaf
  uint4 fill[DPK_MAX_LEAVES];            // each leaf's fill over 16 bytes
  int align[DPK_MAX_LEAVES];  // 16, 8, 4, 2 or 1: divides src, dst, bytes
  const int64_t* uk;                     // (N, cap_u) unique keys
  const int32_t* n_unique;               // (N,)
  int64_t cap_u;
  bool* has;                             // flags, the classes' rows
  int nclasses, nleaves;
};

template <int BY>
struct K10Word;
template <>
struct K10Word<4> {
  typedef unsigned T;
};
template <>
struct K10Word<8> {
  typedef uint2 T;
};
template <>
struct K10Word<16> {
  typedef uint4 T;
};

__device__ __forceinline__ void k10_low(uint4 f, unsigned* w) { *w = f.x; }
__device__ __forceinline__ void k10_low(uint4 f, uint2* w) {
  *w = make_uint2(f.x, f.y);
}
__device__ __forceinline__ void k10_low(uint4 f, uint4* w) { *w = f; }

// two neighbouring rows as one 8-, 16- or 32-byte store
__device__ __forceinline__ void k10_pair(char* d, unsigned a, unsigned b) {
  *(uint2*)d = make_uint2(a, b);
}
__device__ __forceinline__ void k10_pair(char* d, uint2 a, uint2 b) {
  *(uint4*)d = make_uint4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void k10_pair(char* d, uint4 a, uint4 b) {
  ((uint4*)d)[0] = a;
  ((uint4*)d)[1] = b;
}

// a thread's K10_ITEMS consecutive rows of one leaf (rows of BY = 4, 8
// or 16 bytes, src and dst BY-aligned): gathered or filled in registers,
// then stored two rows at a time as one 8-, 16- or 32-byte word where
// all nh rows are in range and dst is aligned for it
template <int BY>
__device__ __forceinline__ void k10_rows(const char* src, char* dst,
                                         const int64_t* pos,
                                         const bool* found, int nh,
                                         uint4 fill) {
  typedef typename K10Word<BY>::T W;
  W f;
  k10_low(fill, &f);
  W e[K10_ITEMS];
#pragma unroll
  for (int i = 0; i < K10_ITEMS; ++i)
    e[i] = found[i] ? __ldg((const W*)(src + pos[i] * BY)) : f;
  if (nh == K10_ITEMS && ((uintptr_t)dst & (BY == 4 ? 7 : 15)) == 0) {
#pragma unroll
    for (int i = 0; i < K10_ITEMS; i += 2)
      k10_pair(dst + i * BY, e[i], e[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < K10_ITEMS; ++i)
      if (i < nh) ((W*)dst)[i] = e[i];
  }
}

// one row of `by` bytes, copied or filled in words of `al` (<= 8) bytes
__device__ __forceinline__ void k10_row(const char* s, char* d, int64_t by,
                                        int al, bool found, uint4 fill) {
  if (al >= 8) {
    const uint64_t f = (uint64_t)fill.x | ((uint64_t)fill.y << 32);
    for (int64_t k = 0; k < (by >> 3); ++k)
      ((uint64_t*)d)[k] = found ? ((const uint64_t*)s)[k] : f;
  } else if (al >= 4) {
    for (int64_t k = 0; k < (by >> 2); ++k)
      ((uint32_t*)d)[k] = found ? ((const uint32_t*)s)[k] : fill.x;
  } else if (al >= 2) {
    for (int64_t k = 0; k < (by >> 1); ++k)
      ((uint16_t*)d)[k] = found ? ((const uint16_t*)s)[k]
                                : (uint16_t)fill.x;
  } else {
    for (int64_t k = 0; k < by; ++k)
      d[k] = found ? s[k] : (char)fill.x;
  }
}

// the lower bound of each id[i] with want[i] among keys[0, nu) into
// pos[i], and whether the key there equals it into found[i]: the
// splitters below the id in shared memory (sp, 2^lm entries, every
// 2^lk-th key), then the last key below it in the window after the last
// such splitter, all items a probe at a time
__device__ __forceinline__ void k10_search(const int64_t* sp, int lm, int lk,
                                           const int64_t* keys, int64_t nu,
                                           const int64_t* id,
                                           const bool* want, int64_t* pos,
                                           bool* found) {
  int cc[K10_ITEMS];
#pragma unroll
  for (int i = 0; i < K10_ITEMS; ++i) cc[i] = 0;
  for (int st = (1 << lm) >> 1; st > 0; st >>= 1) {
#pragma unroll
    for (int i = 0; i < K10_ITEMS; ++i)
      if (want[i] && sp[cc[i] + st - 1] < id[i]) cc[i] += st;
  }
  // keys [(cc - 1) k, min(cc k, nu)) follow splitter cc - 1, below the id
  int64_t p[K10_ITEMS], e[K10_ITEMS];
#pragma unroll
  for (int i = 0; i < K10_ITEMS; ++i) {
    if (want[i]) cc[i] += sp[cc[i]] < id[i];
    p[i] = ((int64_t)cc[i] - 1) * (1LL << lk);
    e[i] = ((int64_t)cc[i] << lk) < nu ? ((int64_t)cc[i] << lk) : nu;
  }
  for (int64_t st = (1LL << lk) >> 1; st > 0; st >>= 1) {
#pragma unroll
    for (int i = 0; i < K10_ITEMS; ++i) {
      const int64_t q = p[i] + st;
      if (want[i] && cc[i] > 0 && q < e[i] && __ldg(keys + q) < id[i])
        p[i] = q;
    }
  }
#pragma unroll
  for (int i = 0; i < K10_ITEMS; ++i) {
    if (want[i]) {
      pos[i] = cc[i] > 0 ? p[i] + 1 : 0;
      found[i] = pos[i] < nu && __ldg(keys + pos[i]) == id[i];
    }
  }
}

static __global__ void __launch_bounds__(K10_THREADS)
    k10_deliver(const __grid_constant__ K10Args a) {
  __shared__ int64_t sp[K10_SPLITTERS];
  const int s = blockIdx.y;
  const int64_t nu = __ldg(a.n_unique + s);
  const int64_t* keys = a.uk + (int64_t)s * a.cap_u;
  // stride k = 2^lk: at least K10_MIN_STRIDE, at most K10_SPLITTERS
  // splitters; the table padded to M = 2^lm entries with INT64_MAX
  int lk = 0;
  while ((1 << lk) < K10_MIN_STRIDE ||
         ((int64_t)K10_SPLITTERS << lk) < nu)
    ++lk;
  const int64_t m = (nu + (1LL << lk) - 1) >> lk;
  int lm = 0;
  while ((1LL << lm) < m) ++lm;
  const int M = 1 << lm;  // >= 1
  {
    // every load of the thread in flight before the first store
    constexpr int R = (K10_SPLITTERS + K10_THREADS - 1) / K10_THREADS;
    int64_t v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = threadIdx.x + r * K10_THREADS;
      v[r] = i < m ? __ldg(keys + ((int64_t)i << lk)) : INT64_MAX;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = threadIdx.x + r * K10_THREADS;
      if (i < M) sp[i] = v[r];
    }
  }
  __syncthreads();
  const int64_t nchunks = a.chunk0[a.nclasses];
  int c = 0;
#pragma unroll 1
  for (int64_t g = blockIdx.x; g < nchunks; g += gridDim.x) {
    while (g >= a.chunk0[c + 1]) ++c;
    const int64_t cap = a.cap[c];
    const int64_t j0 =
        (g - a.chunk0[c]) * K10_CHUNK + (int64_t)threadIdx.x * K10_ITEMS;
    if (j0 >= cap) continue;
    const int nh = cap - j0 < K10_ITEMS ? (int)(cap - j0) : K10_ITEMS;
    const int64_t vc = __ldg(a.vcnt[c] + s);
    const int64_t row = a.row0[c] + (int64_t)s * cap + j0;
    const int64_t* ids = a.vid[c] + (int64_t)s * cap + j0;
    int64_t id[K10_ITEMS];
    if (j0 >= vc) {
      // past the valid slots: no id is read
#pragma unroll
      for (int i = 0; i < K10_ITEMS; ++i) id[i] = INT64_MAX;
    } else if (nh == K10_ITEMS && ((uintptr_t)ids & 15) == 0) {
#pragma unroll
      for (int q = 0; q < K10_ITEMS / 2; ++q) {
        const longlong2 x = __ldg((const longlong2*)ids + q);
        id[2 * q] = x.x;
        id[2 * q + 1] = x.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < K10_ITEMS; ++i)
        id[i] = i < nh ? __ldg(ids + i) : INT64_MAX;
    }
    bool valid[K10_ITEMS], found[K10_ITEMS];
    int64_t pos[K10_ITEMS];
    bool any = false;
#pragma unroll
    for (int i = 0; i < K10_ITEMS; ++i) {
      valid[i] = i < nh && j0 + i < vc && id[i] != INT64_MAX;
      any |= valid[i];
      found[i] = false;
      pos[i] = 0;
    }
    if (any) k10_search(sp, lm, lk, keys, nu, id, valid, pos, found);
    bool* hp = a.has + row;
    if (K10_ITEMS % 4 == 0 && nh == K10_ITEMS && ((uintptr_t)hp & 3) == 0) {
#pragma unroll
      for (int q = 0; q < K10_ITEMS / 4; ++q)
        ((unsigned*)hp)[q] = (unsigned)found[4 * q] |
                             ((unsigned)found[4 * q + 1] << 8) |
                             ((unsigned)found[4 * q + 2] << 16) |
                             ((unsigned)found[4 * q + 3] << 24);
    } else {
#pragma unroll
      for (int i = 0; i < K10_ITEMS; ++i)
        if (i < nh) hp[i] = found[i];
    }
#pragma unroll
    for (int l = 0; l < DPK_MAX_LEAVES; ++l) {
      if (l < a.nleaves) {
        const int64_t by = a.bytes[l];
        const char* src = a.src[l] + (int64_t)s * a.cap_u * by;
        char* dst = a.dst[l] + row * by;
        const int al = a.align[l];
        if (by == 8 && al >= 8) {
          k10_rows<8>(src, dst, pos, found, nh, a.fill[l]);
        } else if (by == 4 && al >= 4) {
          k10_rows<4>(src, dst, pos, found, nh, a.fill[l]);
        } else if (by == 16 && al >= 16) {
          k10_rows<16>(src, dst, pos, found, nh, a.fill[l]);
        } else {
#pragma unroll
          for (int i = 0; i < K10_ITEMS; ++i)
            if (i < nh)
              k10_row(src + pos[i] * by, dst + i * by, by, al < 8 ? al : 8,
                      found[i], a.fill[l]);
        }
      }
    }
  }
}

static int k10_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) ==
            cudaSuccess && n > 0)
      sms = n;
    else
      return 132;
  }
  return sms;
}

// nclasses classes: vid the (N, caps[c]) int64 id tables, vcnt their (N,)
// int32 valid counts, row0 each class's first row in dst and has (a
// multiple of 16; class c's shard s at rows row0[c] + s * caps[c]); uk:
// (N, cap_u) int64; n_unique: (N,) int32; src: nleaves (N, cap_u, ...)
// message leaves of bytes[l] a row; dst: nleaves outputs; ident_bits /
// widths: each leaf's fill (its bits, its element size 1, 2, 4 or 8); has:
// bool flags.  One launch.
extern "C" int dpk_pregel_deliver_classes(
    int nclasses, const void* const* vid, const void* const* vcnt,
    const int64_t* caps, const int64_t* row0, int N, const int64_t* uk,
    const int32_t* n_unique, int64_t cap_u, const void* const* src,
    void* const* dst, const int64_t* bytes, const uint64_t* ident_bits,
    const int* widths, int nleaves, void* has, void* stream) {
  if (nleaves < 0 || nleaves > DPK_MAX_LEAVES || cap_u < 1 ||
      nclasses < 1 || nclasses > K10_MAX_CLASSES || N < 0 || N > 65535)
    return (int)cudaErrorInvalidValue;
  K10Args a;
  a.nclasses = nclasses;
  a.nleaves = nleaves;
  a.uk = uk;
  a.n_unique = n_unique;
  a.cap_u = cap_u;
  a.has = (bool*)has;
  int64_t per_shard = 0;
  a.chunk0[0] = 0;
  for (int c = 0; c < K10_MAX_CLASSES; ++c) {
    const bool on = c < nclasses;
    if (on && (caps[c] < 0 || (row0[c] & 15) != 0))
      return (int)cudaErrorInvalidValue;
    a.vid[c] = on ? (const int64_t*)vid[c] : nullptr;
    a.vcnt[c] = on ? (const int32_t*)vcnt[c] : nullptr;
    a.cap[c] = on ? caps[c] : 0;
    a.row0[c] = on ? row0[c] : 0;
    if (on) per_shard += (caps[c] + K10_CHUNK - 1) / K10_CHUNK;
    a.chunk0[c + 1] = per_shard;
  }
  for (int l = 0; l < DPK_MAX_LEAVES; ++l) {
    const bool on = l < nleaves;
    if (on && widths[l] != 1 && widths[l] != 2 && widths[l] != 4 &&
        widths[l] != 8)
      return (int)cudaErrorInvalidValue;
    a.src[l] = on ? (const char*)src[l] : nullptr;
    a.dst[l] = on ? (char*)dst[l] : nullptr;
    a.bytes[l] = on ? bytes[l] : 0;
    a.fill[l] = on ? span_pattern(ident_bits[l], widths[l])
                   : make_uint4(0, 0, 0, 0);
    int al = 16;
    while (on && al > 1 &&
           (((uintptr_t)src[l] | (uintptr_t)dst[l] | (uintptr_t)bytes[l]) &
            (uintptr_t)(al - 1)))
      al >>= 1;
    a.align[l] = al;
  }
  if (N == 0 || per_shard == 0) return (int)cudaGetLastError();
  int64_t gx = ((int64_t)k10_sms() * K10_BLOCKS + N - 1) / N;
  if (gx > per_shard) gx = per_shard;
  if (gx < 1) gx = 1;
  k10_deliver<<<dim3((unsigned)gx, (unsigned)N), K10_THREADS, 0,
                (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// one class: vid (N, cap_v) int64; vcnt: (N,) int32; uk: (N, cap_u)
// int64; n_unique: (N,) int32; src: nleaves (N, cap_u, ...) message
// leaves of bytes[l] a row; dst: nleaves (N, cap_v, ...); ident_bits /
// widths: each leaf's fill; has: (N, cap_v) bool.
extern "C" int dpk_pregel_deliver(const int64_t* vid, const int32_t* vcnt,
                                  int N, int64_t cap_v, const int64_t* uk,
                                  const int32_t* n_unique, int64_t cap_u,
                                  const void* const* src, void* const* dst,
                                  const int64_t* bytes,
                                  const uint64_t* ident_bits,
                                  const int* widths, int nleaves, void* has,
                                  void* stream) {
  const void* v = vid;
  const void* n = vcnt;
  const int64_t zero = 0;
  return dpk_pregel_deliver_classes(1, &v, &n, &cap_v, &zero, N, uk,
                                    n_unique, cap_u, src, dst, bytes,
                                    ident_bits, widths, nleaves, has, stream);
}
