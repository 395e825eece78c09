// K9 edge_gather: the per-edge view of the vertex state, and the send
// gate.
//
// Replaces dpark_tpu/backend/tpu/bagel.py:285-295 (DevicePregel._p_gen:
// `sv = [v[slot] for v in vals]` and `sa = a[slot] & ev`, or the
// send_gate_leaf's leaf cast to bool in place of `a`), over all N shards
// at once.
//
// Edge slot e of shard s lives with its source vertex: e_slot[s, e] is
// that vertex's row in shard s's vertex table.  For every edge slot the
// kernel copies each vertex leaf's row e_slot[s, e] of shard s, and
// writes sa[s, e] = gate[s, e_slot[s, e]] && e < ecnt[s].  A padded slot
// (e >= ecnt[s]) gathers vertex row 0, as the reference does with its
// zero slots, without reading its e_slot, and writes false.
//
// Bound: bytes.  Per valid edge: the 4 B slot read, each leaf's row read
// (8 B for a float64 leaf) and written, the 1 B gate read and the 1 B
// flag written; a padded slot only writes.  The vertex reads are random
// (edges sit in input order) but mostly hit the 50 MB L2, one sector
// each; the outputs' writes take most of the time, the random reads the
// rest.
//
// Design (a grid of (tile, shard), 32-bit indices inside a shard):
// - one leaf of T (1, 2, 4, 8 or 16 B): k9_pack first writes a record
//   of 2 * sizeof(T) bytes a vertex, {the leaf's row, the gate as a T},
//   so that an edge costs one aligned random read of one sector, not
//   two; k9_gather_one then reads the records;
// - other leaf sets go through k9_edge_gather, whose copy is
//   specialised on each leaf's width (a generic byte loop for the rest)
//   and which reads the gate byte on its own;
// - a thread takes two groups of 4 consecutive edges, reads each group's
//   slots as one 16-byte word (streaming), and issues every random read
//   for its 8 edges before its first store;
// - k9_gather_one stages a tile's rows and flags in shared memory and
//   writes them out as whole 16-byte words, so that every store covers
//   whole sectors (on an H100, the Graph500 shape's 1.2 GB of outputs
//   went out at 2.2 TB/s with each thread storing its own 4 rows, at 2.9
//   staged); a tile wholly past ecnt[s] writes row 0's value and false
//   the same way, reading no slot; k9_edge_gather stores a group's 4
//   rows as 16-byte words where the width allows;
// - the CUDA blocks of a shard take its first- and second-half tiles in
//   turn, so that the padded tiles' writes run beside the live tiles'
//   random reads;
// - outputs go out as streaming stores (evict-first), so that they do
//   not push the vertex table out of L2.
// The leaf pointers of k9_edge_gather sit in a LeafSet passed by value,
// read only with compile-time indices (an unrolled loop with an `l < n`
// guard).
#include "common.cuh"

#define K9_THREADS 256
#define K9_GROUP 4                       // edges a 16-byte slot read
#define K9_GROUPS 2                      // groups a thread
#define K9_TILE (K9_THREADS * K9_GROUP * K9_GROUPS)   // 2048 edges
#define K9_ITEMS (K9_GROUP * K9_GROUPS)  // edges a thread
#define K9_PACK_THREADS 256

// a store of an output (GLOBAL: evict-first) or of shared memory
template <bool GLOBAL, typename W>
__device__ __forceinline__ void k9_st(W* p, W v) {
  if (GLOBAL)
    __stcs(p, v);
  else
    *p = v;
}

// the tile that CUDA block x of a shard's T tiles takes: its first and
// second half's in turn
__device__ __forceinline__ int k9_tile(int x, int T) {
  return x & 1 ? (T + 1) / 2 + (x >> 1) : x >> 1;
}

// edge i of the thread whose first edge is e0
__device__ __forceinline__ int k9_edge(int e0, int i) {
  return e0 + (i / K9_GROUP) * K9_THREADS * K9_GROUP + i % K9_GROUP;
}

// ---- the record of a vertex: 2 * sizeof(T) bytes, {row, gate as a T}

template <typename T>
__device__ __forceinline__ void rec_store(char* rec, int64_t i, T v, bool g) {
  if constexpr (sizeof(T) == 1) {
    ((unsigned short*)rec)[i] = (unsigned short)(v | (unsigned)g << 8);
  } else if constexpr (sizeof(T) == 2) {
    ((unsigned*)rec)[i] = (unsigned)v | (unsigned)g << 16;
  } else if constexpr (sizeof(T) == 4) {
    ((uint2*)rec)[i] = make_uint2(v, g);
  } else if constexpr (sizeof(T) == 8) {
    ((uint4*)rec)[i] = make_uint4((unsigned)v, (unsigned)(v >> 32), g, 0);
  } else {
    ((uint4*)rec)[2 * i] = v;
    ((uint4*)rec)[2 * i + 1] = make_uint4(g, 0, 0, 0);
  }
}

template <typename T>
__device__ __forceinline__ T rec_load(const char* rec, int i, bool* g) {
  if constexpr (sizeof(T) == 1) {
    const unsigned short u = __ldg((const unsigned short*)rec + i);
    *g = (u >> 8) != 0;
    return (T)u;
  } else if constexpr (sizeof(T) == 2) {
    const unsigned u = __ldg((const unsigned*)rec + i);
    *g = (u >> 16) != 0;
    return (T)u;
  } else if constexpr (sizeof(T) == 4) {
    const uint2 u = __ldg((const uint2*)rec + i);
    *g = u.y != 0;
    return (T)u.x;
  } else if constexpr (sizeof(T) == 8) {
    const uint4 u = __ldg((const uint4*)rec + i);
    *g = u.z != 0;
    return (T)u.x | (T)u.y << 32;
  } else {
    *g = __ldg((const unsigned*)((const uint4*)rec + 2 * (int64_t)i + 1)) != 0;
    return __ldg((const uint4*)rec + 2 * (int64_t)i);
  }
}

// rec (N, cap_v) records of the leaf and the gate, a vertex a thread
template <typename T>
static __global__ void __launch_bounds__(K9_PACK_THREADS)
    k9_pack(const T* __restrict__ leaf, const unsigned char* __restrict__ gate,
            char* rec, int cap_v) {
  const int v = blockIdx.x * K9_PACK_THREADS + threadIdx.x;
  if (v >= cap_v) return;
  const int64_t i = (int64_t)blockIdx.y * cap_v + v;
  rec_store<T>(rec, i, __ldcs(leaf + i), __ldcs(gate + i) != 0);
}

// the thread's rows (0 past n)
template <bool VEC>
__device__ __forceinline__ void k9_rows(const int32_t* slot, int e0, int n,
                                        int* row) {
#pragma unroll
  for (int g = 0; g < K9_GROUPS; ++g) {
    const int e = e0 + g * K9_THREADS * K9_GROUP;
    if (VEC && e + K9_GROUP <= n) {
      const int4 w = __ldcs((const int4*)(slot + e));
      row[g * 4 + 0] = w.x;
      row[g * 4 + 1] = w.y;
      row[g * 4 + 2] = w.z;
      row[g * 4 + 3] = w.w;
    } else {
#pragma unroll
      for (int j = 0; j < K9_GROUP; ++j)
        row[g * 4 + j] = e + j < n ? __ldcs(slot + e + j) : 0;
    }
  }
}

// the flags of a group (4 edges) as one 4-byte word, evict-first
__device__ __forceinline__ void k9_flags(bool* sa, const bool* f) {
  unsigned w = 0;
#pragma unroll
  for (int j = 0; j < K9_GROUP; ++j) w |= (unsigned)f[j] << (8 * j);
  k9_st<true>((unsigned*)sa, w);
}

// 4 rows of T into p[0..3] (16-byte aligned): an output, evict-first
// (GLOBAL), or shared memory
template <typename T, bool GLOBAL = true>
__device__ __forceinline__ void store4(T* p, const T* v) {
  if constexpr (sizeof(T) == 1) {
    const unsigned w = (unsigned)(unsigned char)v[0] |
                       (unsigned)(unsigned char)v[1] << 8 |
                       (unsigned)(unsigned char)v[2] << 16 |
                       (unsigned)(unsigned char)v[3] << 24;
    k9_st<GLOBAL>((unsigned*)p, w);
  } else if constexpr (sizeof(T) == 2) {
    uint2 w;
    w.x = (unsigned)(unsigned short)v[0] |
          (unsigned)(unsigned short)v[1] << 16;
    w.y = (unsigned)(unsigned short)v[2] |
          (unsigned)(unsigned short)v[3] << 16;
    k9_st<GLOBAL>((uint2*)p, w);
  } else if constexpr (sizeof(T) == 4) {
    k9_st<GLOBAL>((uint4*)p, make_uint4(v[0], v[1], v[2], v[3]));
  } else if constexpr (sizeof(T) == 8) {
    k9_st<GLOBAL>((uint4*)p,
                  make_uint4((unsigned)v[0], (unsigned)(v[0] >> 32),
                             (unsigned)v[1], (unsigned)(v[1] >> 32)));
    k9_st<GLOBAL>((uint4*)p + 1,
                  make_uint4((unsigned)v[2], (unsigned)(v[2] >> 32),
                             (unsigned)v[3], (unsigned)(v[3] >> 32)));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      k9_st<GLOBAL>((uint4*)p + j, *(const uint4*)&v[j]);
  }
}

// a row of T repeated over 16 bytes
template <typename T>
__device__ __forceinline__ uint4 k9_pattern(T v) {
  if constexpr (sizeof(T) == 16) {
    return v;
  } else if constexpr (sizeof(T) == 8) {
    return make_uint4((unsigned)v, (unsigned)(v >> 32), (unsigned)v,
                      (unsigned)(v >> 32));
  } else {
    const unsigned w = sizeof(T) == 4   ? (unsigned)v
                       : sizeof(T) == 2 ? (unsigned)v * 0x10001u
                                        : (unsigned)v * 0x1010101u;
    return make_uint4(w, w, w, w);
  }
}

// one leaf of rows T: the thread's 8 rows gathered, then stored; `pad`:
// every edge of the thread is padded, row 0 read once
template <typename T>
__device__ __forceinline__ void gather_leaf(const T* src, T* dst,
                                            const int* row, int e0,
                                            bool pad) {
  T v[K9_ITEMS];
  if (pad) {
    const T r0 = __ldg(src);
#pragma unroll
    for (int i = 0; i < K9_ITEMS; ++i) v[i] = r0;
  } else {
#pragma unroll
    for (int i = 0; i < K9_ITEMS; ++i) v[i] = __ldg(src + row[i]);
  }
#pragma unroll
  for (int g = 0; g < K9_GROUPS; ++g)
    store4<T>(dst + e0 + g * K9_THREADS * K9_GROUP, v + g * K9_GROUP);
}

// ---- one leaf of T (1, 2, 4, 8 or 16 B) through its records, cap_e %
// 16 == 0 and every pointer 16-byte aligned
template <typename T>
static __global__ void __launch_bounds__(K9_THREADS)
    k9_gather_one(const int32_t* __restrict__ e_slot,
                  const int32_t* __restrict__ ecnt, int cap_e, int cap_v,
                  const char* __restrict__ rec, T* __restrict__ out,
                  bool* __restrict__ sa) {
  const int s = blockIdx.y;
  const int n = ecnt[s];
  const int t0 = k9_tile(blockIdx.x, gridDim.x) * K9_TILE;
  if (t0 >= cap_e) return;
  // the tile's edges (a multiple of 16) and outputs
  const int cnt = cap_e - t0 < K9_TILE ? cap_e - t0 : K9_TILE;
  const int64_t ebase = (int64_t)s * cap_e;
  const char* r = rec + (int64_t)s * cap_v * (2 * sizeof(T));
  uint4* o = (uint4*)(out + ebase + t0);
  uint4* fl = (uint4*)(sa + ebase + t0);
  const int words = cnt * (int)sizeof(T) / 16;
  if (t0 >= n) {  // a padded tile: row 0's value, no flag
    bool g0;
    const uint4 pat = k9_pattern(rec_load<T>(r, 0, &g0));
    for (int k = threadIdx.x; k < words; k += K9_THREADS)
      k9_st<true>(o + k, pat);
    for (int k = threadIdx.x; k < cnt / 16; k += K9_THREADS)
      k9_st<true>(fl + k, make_uint4(0, 0, 0, 0));
    return;
  }
  const int e0 = t0 + threadIdx.x * K9_GROUP;
  T v[K9_ITEMS];
  bool f[K9_ITEMS];
  if (e0 >= n) {  // every edge of the thread padded: row 0, no flag
    bool g0;
    const T r0 = rec_load<T>(r, 0, &g0);
#pragma unroll
    for (int i = 0; i < K9_ITEMS; ++i) {
      v[i] = r0;
      f[i] = false;
    }
  } else {
    int row[K9_ITEMS];
    k9_rows<true>(e_slot + ebase, e0, n, row);
#pragma unroll
    for (int i = 0; i < K9_ITEMS; ++i) {
      bool g;
      v[i] = rec_load<T>(r, row[i], &g);
      f[i] = g && k9_edge(e0, i) < n;
    }
  }
  // the tile's rows and flags in shared memory, then out whole
  __shared__ __align__(16) T sv[K9_TILE];
  __shared__ __align__(16) bool sf[K9_TILE];
#pragma unroll
  for (int g = 0; g < K9_GROUPS; ++g) {
    const int j = threadIdx.x * K9_GROUP + g * K9_THREADS * K9_GROUP;
    store4<T, false>(sv + j, v + g * K9_GROUP);
    unsigned w = 0;
#pragma unroll
    for (int q = 0; q < K9_GROUP; ++q)
      w |= (unsigned)f[g * K9_GROUP + q] << (8 * q);
    *(unsigned*)(sf + j) = w;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < words; k += K9_THREADS)
    k9_st<true>(o + k, ((const uint4*)sv)[k]);
  for (int k = threadIdx.x; k < cnt / 16; k += K9_THREADS)
    k9_st<true>(fl + k, ((const uint4*)sf)[k]);
}

// ---- any leaf set (up to DPK_MAX_LEAVES leaves of any width)
__device__ __forceinline__ void gather_leaf_bytes(const char* src, char* dst,
                                                  int64_t by, const int* row,
                                                  int e0, int cap_e) {
#pragma unroll
  for (int i = 0; i < K9_ITEMS; ++i) {
    const int e = k9_edge(e0, i);
    if (e < cap_e)
      copy_row(src + (int64_t)row[i] * by, dst + (int64_t)e * by, by);
  }
}

// every group of the thread inside cap_e, the VEC shape
__device__ __forceinline__ void gather_any(const char* src, char* dst,
                                           int64_t by, const int* row,
                                           int e0, bool pad, int cap_e) {
  switch (by) {
    case 1:
      gather_leaf((const uint8_t*)src, (uint8_t*)dst, row, e0, pad);
      break;
    case 2:
      gather_leaf((const uint16_t*)src, (uint16_t*)dst, row, e0, pad);
      break;
    case 4:
      gather_leaf((const uint32_t*)src, (uint32_t*)dst, row, e0, pad);
      break;
    case 8:
      gather_leaf((const unsigned long long*)src, (unsigned long long*)dst,
                  row, e0, pad);
      break;
    case 16:
      if (((uintptr_t)src & 15) == 0) {
        gather_leaf((const uint4*)src, (uint4*)dst, row, e0, pad);
        break;
      }
      gather_leaf_bytes(src, dst, by, row, e0, cap_e);
      break;
    default: gather_leaf_bytes(src, dst, by, row, e0, cap_e);
  }
}

// VEC: cap_e % 4 == 0 and every pointer 16-byte aligned, so that a
// group's slots and its stores are whole 16-byte words
template <bool VEC>
static __global__ void __launch_bounds__(K9_THREADS)
    k9_edge_gather(const int32_t* __restrict__ e_slot,
                   const int32_t* __restrict__ ecnt, int cap_e, int cap_v,
                   LeafSet L, const unsigned char* __restrict__ gate,
                   bool* __restrict__ sa) {
  const int s = blockIdx.y;
  const int n = ecnt[s];
  // the thread's first edge; group g starts K9_THREADS * 4 * g after it
  const int e0 =
      k9_tile(blockIdx.x, gridDim.x) * K9_TILE + threadIdx.x * K9_GROUP;
  if (e0 >= cap_e) return;
  const int64_t vbase = (int64_t)s * cap_v;
  const int64_t ebase = (int64_t)s * cap_e;
  int row[K9_ITEMS];
  k9_rows<VEC>(e_slot + ebase, e0, n, row);
  const unsigned char* gt = gate + vbase;
  bool f[K9_ITEMS];
#pragma unroll
  for (int i = 0; i < K9_ITEMS; ++i)
    f[i] = k9_edge(e0, i) < n && __ldg(gt + row[i]) != 0;
  // every group inside cap_e (the last tile of a cap_e that is no
  // multiple of the tile may hold only some)
  const bool whole =
      VEC && e0 + (K9_GROUPS - 1) * K9_THREADS * K9_GROUP < cap_e;
#pragma unroll
  for (int l = 0; l < DPK_MAX_LEAVES; ++l) {
    if (l < L.n) {
      const int64_t by = L.bytes[l];
      const char* src = L.src[l] + vbase * by;
      char* dst = L.dst[l] + ebase * by;
      if (whole)
        gather_any(src, dst, by, row, e0, e0 >= n, cap_e);
      else
        gather_leaf_bytes(src, dst, by, row, e0, cap_e);
    }
  }
#pragma unroll
  for (int g = 0; g < K9_GROUPS; ++g) {
    const int e = e0 + g * K9_THREADS * K9_GROUP;
    if (VEC) {
      if (e < cap_e) k9_flags(sa + ebase + e, f + g * K9_GROUP);
    } else {
#pragma unroll
      for (int j = 0; j < K9_GROUP; ++j)
        if (e + j < cap_e) sa[ebase + e + j] = f[g * 4 + j];
    }
  }
}

template <typename T>
static void k9_launch_one(const int32_t* e_slot, const int32_t* ecnt, int N,
                          int cap_e, int cap_v, const void* leaf,
                          const void* gate, void* rec, void* out, void* sa,
                          cudaStream_t st) {
  const int per = K9_PACK_THREADS;
  k9_pack<T><<<dim3((unsigned)((cap_v + per - 1) / per), (unsigned)N),
               K9_PACK_THREADS, 0, st>>>(
      (const T*)leaf, (const unsigned char*)gate, (char*)rec, cap_v);
  k9_gather_one<T><<<dim3((unsigned)((cap_e + K9_TILE - 1) / K9_TILE),
                          (unsigned)N),
                     K9_THREADS, 0, st>>>(e_slot, ecnt, cap_e, cap_v,
                                          (const char*)rec, (T*)out,
                                          (bool*)sa);
}

// e_slot: (N, cap_e) int32; ecnt: (N,) int32; src: nleaves (N, cap_v, ...)
// vertex leaves of bytes[l] a row; dst: nleaves (N, cap_e, ...); gate:
// (N, cap_v) bool; sa: (N, cap_e) bool; rec: (N, cap_v) records of
// 2 * bytes[0] bytes, 32-byte aligned, for one leaf of 1, 2, 4, 8 or 16
// B (else null).
extern "C" int dpk_edge_gather(const int32_t* e_slot, const int32_t* ecnt,
                               int N, int64_t cap_e, int64_t cap_v,
                               const void* const* src, void* const* dst,
                               const int64_t* bytes, int nleaves,
                               const void* gate, void* sa, void* rec,
                               void* stream) {
  if (nleaves < 0 || nleaves > DPK_MAX_LEAVES || cap_v < 1 ||
      cap_v > INT32_MAX - K9_PACK_THREADS || cap_e > INT32_MAX - K9_TILE ||
      N > 65535)
    return (int)cudaErrorInvalidValue;
  if ((int64_t)N * cap_e == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int c = (int)cap_e, v = (int)cap_v;
  bool vec = cap_e % K9_GROUP == 0 && ((uintptr_t)e_slot & 15) == 0 &&
             ((uintptr_t)sa & 15) == 0;
  for (int l = 0; l < nleaves; ++l)
    vec = vec && ((uintptr_t)dst[l] & 15) == 0;
  if (vec && cap_e % 16 == 0 && nleaves == 1 && rec != nullptr &&
      ((uintptr_t)rec & 31) == 0) {
    switch (bytes[0]) {
      case 1:
        k9_launch_one<uint8_t>(e_slot, ecnt, N, c, v, src[0], gate, rec,
                               dst[0], sa, st);
        return (int)cudaGetLastError();
      case 2:
        k9_launch_one<uint16_t>(e_slot, ecnt, N, c, v, src[0], gate, rec,
                                dst[0], sa, st);
        return (int)cudaGetLastError();
      case 4:
        k9_launch_one<uint32_t>(e_slot, ecnt, N, c, v, src[0], gate, rec,
                                dst[0], sa, st);
        return (int)cudaGetLastError();
      case 8:
        k9_launch_one<unsigned long long>(e_slot, ecnt, N, c, v, src[0],
                                          gate, rec, dst[0], sa, st);
        return (int)cudaGetLastError();
      case 16:
        if (((uintptr_t)src[0] & 15) == 0) {
          k9_launch_one<uint4>(e_slot, ecnt, N, c, v, src[0], gate, rec,
                               dst[0], sa, st);
          return (int)cudaGetLastError();
        }
    }
  }
  LeafSet L = make_leafset(src, dst, bytes, nleaves);
  const dim3 grid((unsigned)((cap_e + K9_TILE - 1) / K9_TILE), (unsigned)N);
  if (vec)
    k9_edge_gather<true><<<grid, K9_THREADS, 0, st>>>(
        e_slot, ecnt, c, v, L, (const unsigned char*)gate, (bool*)sa);
  else
    k9_edge_gather<false><<<grid, K9_THREADS, 0, st>>>(
        e_slot, ecnt, c, v, L, (const unsigned char*)gate, (bool*)sa);
  return (int)cudaGetLastError();
}
