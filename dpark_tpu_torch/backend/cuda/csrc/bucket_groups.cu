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
// Scatter: one thread per (shard, group lane) copies each result leaf
// res[l][s, g] to out[l][s, segment id]; invalid lanes write nothing.
//
// Bound: bytes.  The gather writes the padded (N, G, B) matrix once and
// reads each group's rows once (plus 12 B of member, start and size per
// lane); the scatter reads (N, G) results and writes as many elements.
#include "common.cuh"

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

static __global__ void k8_scatter(const int32_t* members,
                                  const int32_t* boff, const int32_t* bcnt,
                                  int64_t cap, int G, LeafSet L,
                                  int64_t total) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int g = (int)(t % G);
  const int s = (int)(t / G);
  if (g >= bcnt[s]) return;
  const int64_t base = (int64_t)s * cap;
  const int64_t seg = members[base + boff[s] + g];
  for (int l = 0; l < L.n; ++l) {
    const int64_t by = L.bytes[l];
    copy_row(L.src[l] + t * by, L.dst[l] + (base + seg) * by, by);
  }
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

// res: nleaves (N, G) result leaves; out: nleaves (N, cap) leaves,
// updated in place at the members' segment ids.
extern "C" int dpk_bucket_scatter(const int32_t* members,
                                  const int32_t* boff, const int32_t* bcnt,
                                  int N, int64_t cap, int G,
                                  const void* const* res, void* const* out,
                                  const int64_t* bytes, int nleaves,
                                  void* stream) {
  if (nleaves < 1 || nleaves > DPK_MAX_LEAVES || G < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)N * G;
  if (total == 0) return (int)cudaGetLastError();
  LeafSet L = make_leafset(res, out, bytes, nleaves);
  const int threads = 256;
  k8_scatter<<<(unsigned)((total + threads - 1) / threads), threads, 0,
               (cudaStream_t)stream>>>(members, boff, bcnt, cap, G, L,
                                       total);
  return (int)cudaGetLastError();
}
