// K9 edge_gather: the per-edge view of the vertex state, and the send
// gate.
//
// Replaces dpark_tpu/backend/tpu/bagel.py:285-295 (DevicePregel._p_gen:
// `sv = [v[slot] for v in vals]` and `sa = a[slot] & ev`, or the
// send_gate_leaf's leaf cast to bool in place of `a`), over all N shards
// at once.
//
// Edge slot e of shard s lives with its source vertex: e_slot[s, e] is
// that vertex's row in shard s's vertex table.  For every edge slot (the
// padded ones too, whose e_slot is 0, as the reference gathers them) the
// kernel copies each vertex leaf's row e_slot[s, e] of shard s, and
// writes sa[s, e] = gate[s, e_slot[s, e]] && e < ecnt[s].
//
// One thread per (shard, edge slot).  The leaf pointers sit in a LeafSet
// passed by value; the leaf loop is unrolled with a `l < n` guard, so
// every index into the struct is a constant (a loop-indexed struct is
// copied to local memory in every thread: K7 went from 7.29 to 1.22 ms
// when that pattern went away).
//
// Bound: bytes.  Per edge: the 4 B slot read, each leaf's row read (8 B
// for a float64 leaf) and written, the 1 B gate read and the 1 B flag
// written: 22 B an edge for one float64 leaf.  The vertex reads are
// random but a vertex leaf of the full-width graph (4.19 M x 8 B) fits
// the 50 MB L2, so most of them hit it.
#include "common.cuh"

static __global__ void k9_edge_gather(const int32_t* e_slot,
                                      const int32_t* ecnt, int64_t cap_e,
                                      int64_t cap_v, LeafSet L,
                                      const bool* gate, bool* sa,
                                      int64_t total) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int64_t s = t / cap_e;
  const int64_t e = t - s * cap_e;
  const int64_t row = s * cap_v + e_slot[t];
#pragma unroll
  for (int l = 0; l < DPK_MAX_LEAVES; ++l) {
    if (l < L.n) {
      const int64_t by = L.bytes[l];
      copy_row(L.src[l] + row * by, L.dst[l] + t * by, by);
    }
  }
  sa[t] = gate[row] && e < (int64_t)ecnt[s];
}

// e_slot: (N, cap_e) int32; ecnt: (N,) int32; src: nleaves (N, cap_v, ...)
// vertex leaves of bytes[l] a row; dst: nleaves (N, cap_e, ...); gate:
// (N, cap_v) bool; sa: (N, cap_e) bool.
extern "C" int dpk_edge_gather(const int32_t* e_slot, const int32_t* ecnt,
                               int N, int64_t cap_e, int64_t cap_v,
                               const void* const* src, void* const* dst,
                               const int64_t* bytes, int nleaves,
                               const void* gate, void* sa, void* stream) {
  if (nleaves < 0 || nleaves > DPK_MAX_LEAVES || cap_v < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)N * cap_e;
  if (total == 0) return (int)cudaGetLastError();
  LeafSet L = make_leafset(src, dst, bytes, nleaves);
  const int threads = 256;
  k9_edge_gather<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                   (cudaStream_t)stream>>>(e_slot, ecnt, cap_e, cap_v, L,
                                           (const bool*)gate, (bool*)sa,
                                           total);
  return (int)cudaGetLastError();
}
