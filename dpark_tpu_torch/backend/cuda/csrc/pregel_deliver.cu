// K10 pregel_deliver: each vertex's combined inbound message.
//
// Replaces dpark_tpu/backend/tpu/bagel.py:364-370 (DevicePregel._p_step:
// `pos = clip(searchsorted(uk, ids))`, `has = (uk[pos] == ids) & valid_v
// & (ids != SENT)`, and each message leaf `where(has, u[pos], identity)`)
// over all N shards at once.
//
// Shard s holds its vertex ids vid[s, :vcnt[s]] ascending (padding holds
// the sentinel) and the combined messages that arrived for it: unique
// keys uk[s, :n_unique[s]] ascending, one row of each message leaf per
// key.  A vertex slot is valid when j < vcnt[s] and its id is not the
// sentinel.  It has mail when its id is among the shard's unique keys:
// then each message leaf's row is copied, else the monoid's identity is
// written (a message to an id with no vertex is never read: dropped).
//
// One thread per (shard, vertex slot): a binary search (lower bound) over
// the shard's first n_unique keys, not the padded width (uk comes out of
// the exchange's fine capacity).  The leaf loop is unrolled over a
// LeafSet with a `l < n` guard, so every struct index is a constant.
//
// Bound: bytes.  Per vertex: its 8 B id read, each leaf's row read and
// written (8 + 8 B for a float64 leaf) and the 1 B flag written; the
// log2(n_unique) probes of the search read the key column again, mostly
// from L2 (sorted ids make neighbouring threads probe neighbouring keys).
#include "common.cuh"

struct Idents {
  uint64_t bits[DPK_MAX_LEAVES];  // identity's bit pattern, element width
  int width[DPK_MAX_LEAVES];      // element size in bytes: 1, 2, 4 or 8
};

__device__ __forceinline__ void fill_row(char* d, int64_t b, int w,
                                         uint64_t bits) {
  if (w == 8) {
    for (int64_t k = 0; k < (b >> 3); ++k) ((uint64_t*)d)[k] = bits;
  } else if (w == 4) {
    for (int64_t k = 0; k < (b >> 2); ++k) ((uint32_t*)d)[k] = (uint32_t)bits;
  } else if (w == 2) {
    for (int64_t k = 0; k < (b >> 1); ++k) ((uint16_t*)d)[k] = (uint16_t)bits;
  } else {
    for (int64_t k = 0; k < b; ++k) ((uint8_t*)d)[k] = (uint8_t)bits;
  }
}

static __global__ void k10_deliver(const int64_t* vid, const int32_t* vcnt,
                                   int64_t cap_v, const int64_t* uk,
                                   const int32_t* n_unique, int64_t cap_u,
                                   LeafSet L, Idents I, bool* has,
                                   int64_t total) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int64_t s = t / cap_v;
  const int64_t j = t - s * cap_v;
  const int64_t id = vid[t];
  const int64_t* keys = uk + s * cap_u;
  bool found = false;
  int64_t pos = 0;
  if (j < (int64_t)vcnt[s] && id != INT64_MAX) {
    int64_t lo = 0, hi = n_unique[s];
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (keys[mid] < id)
        lo = mid + 1;
      else
        hi = mid;
    }
    pos = lo;
    found = lo < (int64_t)n_unique[s] && keys[lo] == id;
  }
  has[t] = found;
  const int64_t urow = s * cap_u + pos;
#pragma unroll
  for (int l = 0; l < DPK_MAX_LEAVES; ++l) {
    if (l < L.n) {
      const int64_t by = L.bytes[l];
      if (found)
        copy_row(L.src[l] + urow * by, L.dst[l] + t * by, by);
      else
        fill_row(L.dst[l] + t * by, by, I.width[l], I.bits[l]);
    }
  }
}

// vid: (N, cap_v) int64; vcnt: (N,) int32; uk: (N, cap_u) int64; n_unique:
// (N,) int32; src: nleaves (N, cap_u, ...) message leaves of bytes[l] a
// row; dst: nleaves (N, cap_v, ...); ident_bits / widths: each leaf's
// identity element; has: (N, cap_v) bool.
extern "C" int dpk_pregel_deliver(const int64_t* vid, const int32_t* vcnt,
                                  int N, int64_t cap_v, const int64_t* uk,
                                  const int32_t* n_unique, int64_t cap_u,
                                  const void* const* src, void* const* dst,
                                  const int64_t* bytes,
                                  const uint64_t* ident_bits,
                                  const int* widths, int nleaves, void* has,
                                  void* stream) {
  if (nleaves < 0 || nleaves > DPK_MAX_LEAVES || cap_u < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)N * cap_v;
  if (total == 0) return (int)cudaGetLastError();
  LeafSet L = make_leafset(src, dst, bytes, nleaves);
  Idents I;
  for (int i = 0; i < DPK_MAX_LEAVES; ++i) {
    I.bits[i] = i < nleaves ? ident_bits[i] : 0;
    I.width[i] = i < nleaves ? widths[i] : 1;
  }
  const int threads = 256;
  k10_deliver<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                (cudaStream_t)stream>>>(vid, vcnt, cap_v, uk, n_unique, cap_u,
                                        L, I, (bool*)has, total);
  return (int)cudaGetLastError();
}
