// K16 union_concat: the device union source's concatenation of its
// branch batches.
//
// Replaces dpark_tpu/backend/tpu/executor.py:2137-2170 (_compile_concat:
// per device, each branch's rows written one after another with
// dynamic_update_slice at the running sum of the earlier branches'
// counts, then sliced to cap_out), as driven by _concat_batches (:2119).
//
// Input: k branch batches with the same leaves; branch j's leaf l is a
// contiguous (N, cap_j, ...) tensor and its per-shard counts are known
// on the host (the wrapper's one read of all k count vectors sizes the
// output).  Output: (N, cap_out, ...) leaves where shard s holds branch
// 0's valid rows, then branch 1's, ..., and past the shard's total the
// key fill in the key leaf (the sentinel, as K4's exchange leaves its
// receive padding) and zeros in the others.  The reference leaves the
// branches' stale tail rows there instead.
//
// One launch for all leaves.  The host builds a descriptor table, one
// row per non-empty (branch, shard) range and one per shard tail:
// (branch or -1, first source row, first output row, rows).  Block
// (x, y) serves descriptor y; its threads walk the range a row each
// (grid-stride over x) and copy every leaf's row, so the threads of a
// warp read and write neighbouring rows of one leaf (coalesced).  The
// source leaf pointers of every branch live in a second small device
// table, indexed (branch, leaf).
//
// Bound: bytes.  Each valid row of every branch is read once and every
// output row (N * cap_out of each leaf, tails included) written once.
#include "common.cuh"

#define K16_DESC 4

struct K16Out {
  char* dst[DPK_MAX_LEAVES];
  int64_t bytes[DPK_MAX_LEAVES];
  int n;
  int key_leaf;       // -1: no key fill, zeros everywhere
  uint64_t key_fill;  // bit pattern at the key leaf's width
};

static __global__ void k16_pack(const int64_t* desc, const int64_t* srcp,
                                K16Out O) {
  const int64_t* d = desc + (int64_t)blockIdx.y * K16_DESC;
  const int64_t j = d[0], src0 = d[1], dst0 = d[2], rows = d[3];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       r < rows; r += stride) {
    for (int l = 0; l < O.n; ++l) {
      const int64_t b = O.bytes[l];
      char* out = O.dst[l] + (dst0 + r) * b;
      if (j >= 0) {
        const char* src = (const char*)srcp[j * O.n + l];
        copy_row(src + (src0 + r) * b, out, b);
      } else if (l == O.key_leaf) {
        if (b == 8)
          *(uint64_t*)out = O.key_fill;
        else
          *(uint32_t*)out = (uint32_t)O.key_fill;
      } else {
        zero_row(out, b);
      }
    }
  }
}

// desc: ndesc x 4 int64 rows (device); srcp: k x nleaves source leaf
// pointers (device); dst, bytes: nleaves output leaves and row bytes
// (host arrays); max_rows: the longest descriptor's row count.
extern "C" int dpk_union_concat(const int64_t* desc, int ndesc,
                                int64_t max_rows, const int64_t* srcp,
                                void* const* dst, const int64_t* bytes,
                                int nleaves, int key_leaf,
                                uint64_t key_fill, void* stream) {
  if (nleaves < 1 || nleaves > DPK_MAX_LEAVES || ndesc < 0 ||
      ndesc > 65535 || key_leaf >= nleaves)
    return (int)cudaErrorInvalidValue;
  if (ndesc == 0 || max_rows <= 0) return (int)cudaGetLastError();
  K16Out O;
  O.n = nleaves;
  O.key_leaf = key_leaf;
  O.key_fill = key_fill;
  for (int i = 0; i < DPK_MAX_LEAVES; ++i) {
    O.dst[i] = i < nleaves ? (char*)dst[i] : nullptr;
    O.bytes[i] = i < nleaves ? bytes[i] : 0;
  }
  if (key_leaf >= 0 && bytes[key_leaf] != 4 && bytes[key_leaf] != 8)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  int64_t bx = (max_rows + threads - 1) / threads;
  if (bx > 2048) bx = 2048;
  dim3 grid((unsigned)bx, (unsigned)ndesc);
  k16_pack<<<grid, threads, 0, (cudaStream_t)stream>>>(desc, srcp, O);
  return (int)cudaGetLastError();
}
