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
// copied; 0 without one) and `has_prev` (N, G).  Classes up to 128 wide:
// T = B (at most 32) threads serve a lane, reading T rows of the group at
// a time, and a warp ballot of the flag-0 rows gives each new value its
// slot (the count of the group's earlier new values).  Wider classes,
// which hold few groups: a block of min(B, 1024) threads serves a lane,
// a block-wide scan of the flags ranking each chunk.  Invalid lanes write
// zeros.  Bound: bytes -- each group's rows and flags read once, the
// matrix, prev and has_prev written once.
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

// The wide classes' form: block y serves lane y (shard y / G, lane
// y % G); its threads walk the group blockDim rows at a time.
static __global__ void k8_gather_state_block(
    const int32_t* start_rows, const int32_t* sizes, const int32_t* members,
    const int32_t* boff, const int32_t* bcnt, int64_t cap, int G, int B,
    const char* vals, int64_t vbytes, const int64_t* flags, char* out,
    char* prev, bool* has_prev, int edge) {
  __shared__ int sm[32];
  const int64_t lane = blockIdx.x;
  const int s = (int)(lane / G);
  const int g = (int)(lane % G);
  const int64_t base = (int64_t)s * cap;
  int32_t st = 0, sz = 0;
  if (g < bcnt[s]) {
    const int32_t seg = members[base + boff[s] + g];
    st = start_rows[base + seg];
    sz = sizes[base + seg];
  }
  char* orow = out + lane * (int64_t)B * vbytes;
  int n_new = 0;
  int has = 0;
  for (int o0 = 0; o0 < sz; o0 += blockDim.x) {
    const int o = o0 + threadIdx.x;
    int64_t fl = 2;
    if (o < sz) fl = flags[base + st + o];
    int tot;
    const int slot = block_excl_scan(fl == 0, sm, &tot);
    if (fl == 0)
      copy_row(vals + (base + st + o) * vbytes,
               orow + (int64_t)(n_new + slot) * vbytes, vbytes);
    else if (fl == 1)
      copy_row(vals + (base + st + o) * vbytes, prev + lane * vbytes,
               vbytes);
    n_new += tot;
    has |= __syncthreads_or(fl == 1);
  }
  __syncthreads();                        // the compacted rows are visible
  for (int o = n_new + threadIdx.x; o < B; o += blockDim.x) {
    if (edge && n_new > 0)
      copy_row(orow + (int64_t)(n_new - 1) * vbytes, orow + o * vbytes,
               vbytes);
    else
      zero_row(orow + o * vbytes, vbytes);
  }
  if (threadIdx.x == 0) {
    has_prev[lane] = has != 0;
    if (!has) zero_row(prev + lane * vbytes, vbytes);
  }
}

// start_rows, sizes, members: (N, cap) int32; boff, bcnt: (N,) int32;
// vals: (N, cap) of vbytes-wide elements; flags: (N, cap) int64; out:
// (N, G, B); prev: (N, G) of vbytes-wide elements; has_prev: (N, G) bool.
extern "C" int dpk_bucket_gather_state(
    const int32_t* start_rows, const int32_t* sizes, const int32_t* members,
    const int32_t* boff, const int32_t* bcnt, int N, int64_t cap, int G,
    int B, const void* vals, int64_t vbytes, const int64_t* flags, void* out,
    void* prev, bool* has_prev, int edge, void* stream) {
  if (G < 1 || B < 1 || (B & (B - 1)) != 0 || vbytes < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t nlanes = (int64_t)N * G;
  if (nlanes == 0) return (int)cudaGetLastError();
  if (B > 128) {
    if (nlanes > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    k8_gather_state_block<<<(unsigned)nlanes, B < 1024 ? B : 1024, 0,
                            (cudaStream_t)stream>>>(
        start_rows, sizes, members, boff, bcnt, cap, G, B,
        (const char*)vals, vbytes, flags, (char*)out, (char*)prev, has_prev,
        edge);
    return (int)cudaGetLastError();
  }
  const int T = B < 32 ? B : 32;
  const int64_t total = nlanes * T;
  const int threads = 256;
  k8_gather_state<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                    (cudaStream_t)stream>>>(
      start_rows, sizes, members, boff, bcnt, cap, G, B, T,
      (const char*)vals, vbytes, flags, (char*)out, (char*)prev, has_prev,
      edge, nlanes);
  return (int)cudaGetLastError();
}
