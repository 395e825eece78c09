"""The hand-written CUDA kernels of the columnar shuffle path, their
plain PyTorch versions, and the launch counters.

Kernels (sources under csrc/, one shared library each):

  K1 hash_dst_hist          csrc/hash_dst_hist.cu
  K2 stable_partition       csrc/stable_partition.cu
  K3 reduce_by_key_compact  csrc/reduce_by_key.cu
  K4 shard_exchange         csrc/shard_exchange.cu
  K5 radix_sort             csrc/radix_sort.cu
  K6 range_dst_hist         csrc/range_dst_hist.cu
  K7 segment_table          csrc/segment_table.cu
  K8 bucket_gather          csrc/bucket_groups.cu (with bucket_scatter
                            and bucket_scatter_classes, the results of
                            every size class in one launch)
  K9 edge_gather            csrc/edge_gather.cu
  K10 pregel_deliver        csrc/pregel_deliver.cu (with
                            pregel_deliver_classes, every class of the
                            object Bagel in one launch)
  K11 obj_emit_pack         csrc/obj_emit_pack.cu
  K12 join_ranges           csrc/join_expand.cu (with join_expand)
  K13 rid_fold              csrc/rid_fold.cu
  K14 segmented_merge       csrc/segmented_merge.cu and
                            segmented_merge_wide.cu (up to 6 and up to 16
                            slots: two libraries that build in parallel,
                            one device code, segmented_merge.cuh; a traced
                            merge's register program, merge_program.py)
  K15 column_ranges         csrc/column_ranges.cu
  K16 union_concat          csrc/union_concat.cu (its span copy and
                            fill, csrc/span_copy.cuh, shared with K4)
  K17 monoid_reduce         csrc/monoid_reduce.cu (with
                            distinct_key_counts, and active_count, the
                            bool count of every class in one launch)
  K18 topk_select           csrc/topk_select.cu

K8's library also holds bucket_gather_state, the state mode's gather of
the segmented apply (updateStateByKey's update(values, prev)).

Build: at first use, one `nvcc -gencode arch=compute_90a,code=sm_90a
-shared` per source, all started together, into
``build/dpark_tpu_torch_kernels/<hash of csrc/>/`` beside the package
(an edit to any source rebuilds); bound with ctypes, pointers as
c_void_p, launched on ``torch.cuda.current_stream()``.  Every C entry
returns cudaGetLastError(); the wrapper raises on a nonzero code.

Dispatch: a wrapper given CUDA tensors launches its kernel (or raises);
given CPU tensors it runs the plain version.  Nothing falls back from
the kernel to the plain version.  ``LAUNCHES[name]`` counts kernel
launches and nothing else.
"""

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import threading
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = {
    "hash_dst_hist": "hash_dst_hist.cu",
    "stable_partition": "stable_partition.cu",
    "reduce_by_key_compact": "reduce_by_key.cu",
    "shard_exchange": "shard_exchange.cu",
    "radix_sort": "radix_sort.cu",
    "range_dst_hist": "range_dst_hist.cu",
    "segment_table": "segment_table.cu",
    "bucket_groups": "bucket_groups.cu",
    "edge_gather": "edge_gather.cu",
    "pregel_deliver": "pregel_deliver.cu",
    "obj_emit_pack": "obj_emit_pack.cu",
    "join_expand": "join_expand.cu",
    "rid_fold": "rid_fold.cu",
    "segmented_merge": "segmented_merge.cu",
    "segmented_merge_wide": "segmented_merge_wide.cu",
    "column_ranges": "column_ranges.cu",
    "union_concat": "union_concat.cu",
    "monoid_reduce": "monoid_reduce.cu",
    "topk_select": "topk_select.cu",
}
# launch counters: one per kernel (K8's library holds three, K12's two,
# K17's three; K14's two libraries count as one; K8's scatter counts
# both its entries, as K10 does)
LAUNCHES = {name: 0 for name in SOURCES
            if name not in ("bucket_groups", "join_expand",
                            "segmented_merge_wide")}
LAUNCHES.update(bucket_gather=0, bucket_scatter=0, bucket_gather_state=0,
                join_ranges=0, join_expand=0, distinct_key_counts=0,
                active_count=0)
SIZE_CLASSES = 32
KEY_SENTINEL = 2 ** 63 - 1
OPS = {"add": 0, "min": 1, "max": 2, "mul": 3, "last": 4}
MAX_LEAVES = 16
MAX_KEYS = 6
# the reference's MAX_UNION_SOURCES (backend/tpu/fuse.py:1354)
MAX_UNION_BRANCHES = 12

_libs = {}
_build_lock = threading.Lock()
build_seconds = None
# libraries built with `-Xptxas -v`: their registers, shared memory and
# spills per kernel land in build_logs[name] once loaded
VERBOSE_PTXAS = ("radix_sort", "stable_partition", "segment_table",
                 "reduce_by_key_compact", "edge_gather", "obj_emit_pack",
                 "join_expand", "bucket_groups", "shard_exchange",
                 "pregel_deliver", "monoid_reduce")
build_logs = {}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build_root():
    """``build/dpark_tpu_torch_kernels`` beside the package (ignored by
    git): every library the port compiles lives under it."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    return os.path.join(pkg_root, "build", "dpark_tpu_torch_kernels")


def _build_dir():
    digest = hashlib.sha1()
    for fn in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, fn), "rb") as f:
            digest.update(fn.encode() + b"\0" + f.read())
    return os.path.join(build_root(), digest.hexdigest()[:16])


def _nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build():
    """Compile every kernel library not yet built (in parallel) and load
    them all; returns the seconds spent.  Raises on a failed build."""
    global build_seconds
    with _build_lock:
        if len(_libs) == len(SOURCES):
            return build_seconds
        t0 = time.perf_counter()
        out_dir = _build_dir()
        os.makedirs(out_dir, exist_ok=True)
        procs = []
        for name, src in SOURCES.items():
            so = os.path.join(out_dir, "lib%s.so" % name)
            if os.path.exists(so):
                continue
            tmp = "%s.%d.tmp" % (so, os.getpid())
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-I", CSRC, "-o", tmp, os.path.join(CSRC, src)]
            if name in VERBOSE_PTXAS:
                cmd[1:1] = ["-Xptxas", "-v"]
            procs.append((name, so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for name, so, tmp, p in procs:
            out, _ = p.communicate()
            out = out.decode(errors="replace")
            if p.returncode != 0:
                errors.append("%s:\n%s" % (name, out))
            else:
                with open(so[:-3] + ".log", "w") as f:
                    f.write(out)
                os.replace(tmp, so)
        if errors:
            raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
        for name in SOURCES:
            _libs[name] = _bind(name, ctypes.CDLL(
                os.path.join(out_dir, "lib%s.so" % name)))
            if name in VERBOSE_PTXAS:
                with open(os.path.join(out_dir, "lib%s.log" % name)) as f:
                    build_logs[name] = f.read()
        build_seconds = time.perf_counter() - t0
        return build_seconds


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64


def _bind(name, lib):
    if name == "hash_dst_hist":
        fn = lib.dpk_hash_dst_hist
        fn.argtypes = [_P, _P, _I, _P, _I, _L, _I, _I, _P, _P, _P, _P]
    elif name == "stable_partition":
        fn = lib.dpk_stable_partition
        fn.argtypes = [_P, _P, _I, _L, _I, _P, _P, _P, _I, _P, _I, _P, _P,
                       _P]
    elif name == "reduce_by_key_compact":
        fn = lib.dpk_reduce_by_key
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I,
                       _I, _P, _I, _L, _P, _P, _P, _P, _P, _P]
    elif name == "shard_exchange":
        fn = lib.dpk_shard_exchange
        fn.argtypes = [_P, _P, _P, _I, _P, _P, _I, _L, _L, _I, _L, _P, _P]
    elif name == "radix_sort":
        hist = lib.dpk_radix_sort_hist
        hist.argtypes = [_P, _I, _P, _I, _L, _I, _P, _P, _P, _P, _P, _P]
        hist.restype = ctypes.c_int
        fn = lib.dpk_radix_sort_passes
        fn.argtypes = [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                       _L, _I, _P, _P, _P]
        fn.restype = ctypes.c_int
        return hist, fn
    elif name == "segment_table":
        fn = lib.dpk_segment_table
        fn.argtypes = [_P, _P, _P, _P, _I, _P, _I, _L, _P, _P, _P, _P, _P,
                       _P, _P]
    elif name == "bucket_groups":
        gather = lib.dpk_bucket_gather
        gather.argtypes = [_P, _P, _P, _P, _P, _I, _L, _I, _I, _P, _L, _P,
                           _I, _P]
        gather.restype = ctypes.c_int
        scatter = lib.dpk_bucket_scatter_classes
        scatter.argtypes = [_P, _P, _P, _I, _I, _I, _L, _L, _I, _P, _P, _P,
                            _I, _P, _P, _I, _P]
        scatter.restype = ctypes.c_int
        state = lib.dpk_bucket_gather_state
        state.argtypes = [_P, _P, _P, _P, _P, _I, _L, _I, _I, _P, _L, _P,
                          _P, _P, _P, _I, _P, _P]
        state.restype = ctypes.c_int
        return gather, scatter, state
    elif name == "monoid_reduce":
        fn = lib.dpk_monoid_reduce
        fn.argtypes = [_P, _I, _L, _P, _I, _L, _I, _P, _P, _P, _P, _I, _P]
        fn.restype = ctypes.c_int
        distinct = lib.dpk_distinct_key_counts
        distinct.argtypes = [_P, _P, _I, _P, _I, _L, _P, _P]
        distinct.restype = ctypes.c_int
        count = lib.dpk_active_count
        count.argtypes = [_I, _P, _P, _P, _P, _I, _I, _P, _P]
        count.restype = ctypes.c_int
        bools = lib.dpk_bool_reduce
        bools.argtypes = [_P, _L, _P, _I, _L, _I, _P, _P, _P, _P, _P]
        bools.restype = ctypes.c_int
        return fn, distinct, count, bools
    elif name == "topk_select":
        fn = lib.dpk_topk_select
        fn.argtypes = [_P, _P, _I, _P, _I, _L, _I, _I, _I, _P, _P, _P, _P,
                       _P, _P, _P, _I, _P]
    elif name == "union_concat":
        fn = lib.dpk_union_concat
        fn.argtypes = [_P, _I, _P, _P, _I, _L, _P, _P, _I, _I,
                       ctypes.c_uint64, _P, _P]
    elif name == "edge_gather":
        fn = lib.dpk_edge_gather
        fn.argtypes = [_P, _P, _I, _L, _L, _P, _P, _P, _I, _P, _P, _P, _P]
    elif name == "pregel_deliver":
        fn = lib.dpk_pregel_deliver
        fn.argtypes = [_P, _P, _I, _L, _P, _P, _L, _P, _P, _P, _P, _P, _I,
                       _P, _P]
        fn.restype = ctypes.c_int
        classes = lib.dpk_pregel_deliver_classes
        classes.argtypes = [_I, _P, _P, _P, _P, _I, _P, _P, _L, _P, _P, _P,
                            _P, _P, _I, _P, _P]
        classes.restype = ctypes.c_int
        return fn, classes
    elif name == "obj_emit_pack":
        count = lib.dpk_obj_emit_count
        count.argtypes = [_I, _P, _P, _P, _P, _P, _I, _P, _P, _P]
        count.restype = ctypes.c_int
        scatter = lib.dpk_obj_emit_scatter
        scatter.argtypes = [_I, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _L,
                            _L, _P, _P, _P, _P]
        scatter.restype = ctypes.c_int
        return count, scatter
    elif name == "rid_fold":
        fn = lib.dpk_rid_fold
        fn.argtypes = [_P, _P, _I, _L, _I, _P, _P, _P, _P]
    elif name == "column_ranges":
        fn = lib.dpk_column_ranges
        fn.argtypes = [_P, _P, _I, _P, _I, _L, _P, _P]
    elif name in ("segmented_merge", "segmented_merge_wide"):
        fn = getattr(lib, "dpk_" + name)
        fn.argtypes = [_P, _P, _P, _P, _I, _P, _I, _P, _P, _P, _I, _L, _P,
                       _L, _P]
    elif name == "join_expand":
        ranges = lib.dpk_join_ranges
        ranges.argtypes = [_P, _P, _P, _I, _I, _L, _L, _P, _P, _P, _P, _P,
                           _P, _P, _P]
        ranges.restype = ctypes.c_int
        expand = lib.dpk_join_expand
        expand.argtypes = [_P, _I, _I, _I, _L, _L, _L, _P, _P, _P, _P,
                           ctypes.c_uint64, _I, _P]
        expand.restype = ctypes.c_int
        return ranges, expand
    else:
        fn = lib.dpk_range_dst_hist
        fn.argtypes = [_P, _I, _I, _P, _I, _I, _I, _I, _P, _I, _L, _P, _P,
                       _P]
    fn.restype = ctypes.c_int
    return fn


def _kernel(name):
    if name not in _libs:
        build()
    return _libs[name]


def _check(name, rc, count=True):
    if rc != 0:
        raise RuntimeError("CUDA kernel %s failed to launch: error %d"
                           % (name, rc))
    if count:
        LAUNCHES[name] += 1


def _on_cuda(tensors):
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError("tensors on several devices: %s" % devs)
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError("unsupported device %s" % dev)


def _ptrs(tensors):
    return (ctypes.c_void_p * max(1, len(tensors)))(
        *[t.data_ptr() for t in tensors])


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _lanes(t):
    return math.prod(t.shape[2:])


def _row_bytes(t):
    return t.element_size() * _lanes(t)


def _need(cond, msg):
    if not cond:
        raise ValueError(msg)


def _check_cols(cols, N, cap, what):
    for c in cols:
        _need(c.is_contiguous() and c.dim() >= 2
              and c.shape[0] == N and c.shape[1] == cap,
              "%s must be contiguous (N=%d, cap=%d, ...) tensors, got %s"
              % (what, N, cap, tuple(c.shape)))


def shard_rows(leaf, idx):
    """leaf[s, idx[s, j]] for a (N, cap, ...) leaf and (N, m) indices."""
    rows = torch.arange(leaf.shape[0], device=leaf.device)[:, None]
    return leaf[rows, idx.long()]


def shard_bincount(vals, nb):
    """(N, nb) int32 per-shard counts of a (N, m) int column in [0, nb)."""
    out = torch.zeros((vals.shape[0], nb), dtype=torch.int64,
                      device=vals.device)
    out.scatter_add_(1, vals.long(), torch.ones_like(vals, dtype=torch.int64))
    return out.to(torch.int32)


# ---------------------------------------------------------------------
# K1 hash_dst_hist
# ---------------------------------------------------------------------
def hash_dst_hist_plain(key_cols, n, r, n_dst, want_hist=True,
                        want_hash=False):
    from dpark_tpu_torch.utils.phash import phash_torch_cols
    h = phash_torch_cols(key_cols)
    cap = key_cols[0].shape[1]
    valid = torch.arange(cap, device=h.device)[None, :] < n[:, None].long()
    dst = torch.where(valid, h % r, n_dst).to(torch.int32)
    hist = shard_bincount(dst, n_dst + 1) if want_hist else None
    return dst, hist, (torch.where(valid, h, 0) if want_hash else None)


def hash_dst_hist(key_cols, n, r, n_dst, want_hist=True, want_hash=False):
    """Per-row shuffle destination (portable hash % r; n_dst on padding
    rows) of 1-6 int key columns (N, cap), with the per-shard destination
    histogram (N, n_dst + 1) and, on request, the raw uint32 hash as an
    int64 column (the composite-key sort column).  Returns (dst int32,
    hist or None, hash or None)."""
    key_cols = list(key_cols)
    N, cap = key_cols[0].shape[:2]
    _check_cols(key_cols, N, cap, "key columns")
    _need(1 <= len(key_cols) <= MAX_KEYS, "1..%d key columns" % MAX_KEYS)
    _need(all(c.dtype in (torch.int64, torch.int32) for c in key_cols),
          "key columns must be int32/int64")
    _need(n.dtype == torch.int32 and n.shape == (N,), "n must be (N,) int32")
    _need(r >= 1 and (not want_hist or r <= n_dst),
          "r must be >= 1, and <= n_dst with the histogram")
    if not _on_cuda(key_cols + [n]):
        return hash_dst_hist_plain(key_cols, n, r, n_dst, want_hist,
                                   want_hash)
    fn = _kernel("hash_dst_hist")
    dev = key_cols[0].device
    dst = torch.empty((N, cap), dtype=torch.int32, device=dev)
    hist = (torch.zeros((N, n_dst + 1), dtype=torch.int32, device=dev)
            if want_hist else None)
    hout = (torch.empty((N, cap), dtype=torch.int64, device=dev)
            if want_hash else None)
    widths = (ctypes.c_int * len(key_cols))(
        *[c.element_size() for c in key_cols])
    rc = fn(_ptrs(key_cols), widths, len(key_cols), n.data_ptr(), N, cap,
            int(r), int(n_dst), dst.data_ptr(),
            hout.data_ptr() if hout is not None else None,
            hist.data_ptr() if hist is not None else None, _stream())
    _check("hash_dst_hist", rc)
    return dst, hist, hout


# ---------------------------------------------------------------------
# K2 stable_partition
# ---------------------------------------------------------------------
_K2_TILE = 4096       # K2_TILE of csrc/stable_partition.cu: the rows of a
                      # tile, by which the look-back's status words go


def stable_partition_plain(bucket, nb, leaves, src_idx=None,
                           want_bucket=True, counts=None):
    order = torch.sort(bucket, dim=1, stable=True).indices
    idx = order if src_idx is None else torch.gather(src_idx.long(), 1,
                                                     order)
    out = [shard_rows(leaf, idx) for leaf in leaves]
    return out, shard_bincount(bucket, nb), (
        torch.gather(bucket, 1, order) if want_bucket else None)


def stable_partition(bucket, nb, leaves, src_idx=None, want_bucket=True,
                     counts=None):
    """Stable counting sort of each shard's rows by `bucket` ((N, cap)
    int32 in [0, nb), nb <= 256).  Row j of the current order reads its
    leaves from row src_idx[s, j] (identity when None), so a prior sort
    permutation composes without its own gather.  `counts`, when the
    caller already holds them (K1's histogram), are the (N, nb) int32
    per-shard bucket counts, which the kernel then reads instead of
    counting (the plain version counts).  Returns (sorted leaves, counts
    (N, nb) int32, sorted bucket column, or None unless want_bucket)."""
    leaves = list(leaves)
    N, cap = bucket.shape
    _need(bucket.dtype == torch.int32 and bucket.is_contiguous(),
          "bucket must be a contiguous int32 (N, cap) tensor")
    _check_cols(leaves, N, cap, "leaves")
    _need(len(leaves) <= MAX_LEAVES, "at most %d leaves" % MAX_LEAVES)
    _need(1 <= nb <= 256, "nb must be in [1, 256]")
    _need(cap < 2 ** 31, "row ids are int32: cap must be < 2**31")
    extra = [src_idx] if src_idx is not None else []
    if src_idx is not None:
        _need(src_idx.dtype == torch.int32 and src_idx.shape == (N, cap)
              and src_idx.is_contiguous(), "src_idx must be (N, cap) int32")
    if counts is not None:
        _need(counts.dtype == torch.int32 and counts.shape == (N, nb)
              and counts.is_contiguous(), "counts must be (N, nb) int32")
        extra.append(counts)
    if not _on_cuda([bucket] + leaves + extra):
        return stable_partition_plain(bucket, nb, leaves, src_idx,
                                      want_bucket)
    fn = _kernel("stable_partition")
    dev = bucket.device
    out = [torch.empty_like(leaf) for leaf in leaves]
    have = counts is not None
    if not have:
        counts = torch.zeros((N, nb), dtype=torch.int32, device=dev)
    bucket_out = torch.empty_like(bucket) if want_bucket else None
    if cap == 0:
        return out, counts, bucket_out
    status = torch.zeros((N * -(-cap // _K2_TILE) * nb + 1,),
                         dtype=torch.int64, device=dev)
    rc = fn(bucket.data_ptr(),
            src_idx.data_ptr() if src_idx is not None else None, N, cap,
            int(nb), _ptrs(leaves), _ptrs(out),
            (ctypes.c_int64 * max(1, len(leaves)))(
                *[_row_bytes(leaf) for leaf in leaves]),
            len(leaves), counts.data_ptr(), int(have), status.data_ptr(),
            bucket_out.data_ptr() if want_bucket else None, _stream())
    _check("stable_partition", rc)
    return out, counts, bucket_out


# ---------------------------------------------------------------------
# K3 reduce_by_key_compact
# ---------------------------------------------------------------------
_K3_TILE = 6144       # K3_TILE of csrc/reduce_by_key.cu (384 x 16): the
                      # rows of a tile, by which the look-back's words go
K3_MAX_DST = 4096     # K3_MAX_DST: the destination histogram's bins


def identity(op, dtype):
    """A monoid's identity for a torch dtype: 0 (add), 1 (mul), +inf /
    -inf (float min / max), the dtype's max / min (int min / max)."""
    if op == "add":
        return 0
    if op == "mul":
        return 1
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def reduce_by_key_compact_plain(key_cols, fills, val_leaves, n, op,
                                dst_col=None, n_dst=0):
    N, cap = key_cols[0].shape[:2]
    dev = key_cols[0].device
    idx = torch.arange(cap, device=dev)
    valid = idx[None, :] < n[:, None].long()
    start = torch.zeros((N, cap), dtype=torch.bool, device=dev)
    start[:, :1] = True
    for c in key_cols:
        start[:, 1:] |= c[:, 1:] != c[:, :-1]
    keep = start & valid
    seg = torch.cumsum(keep.to(torch.int64), 1) - 1
    n_unique = keep.sum(1).to(torch.int32)
    pos = (torch.arange(N, device=dev)[:, None] * cap + seg)
    tail_mask = idx[None, :] >= n_unique[:, None].long()
    key_out = []
    for c, fill in zip(key_cols, fills):
        o = torch.full_like(c, 0)
        o.view(-1)[pos[keep]] = c[keep]
        o[tail_mask] = fill
        key_out.append(o)
    val_out = []
    for v in val_leaves:
        flat_v = v.reshape((N * cap,) + tuple(v.shape[2:]))
        o = torch.zeros_like(flat_v)
        if op == "last":
            is_tail = valid.clone()
            is_tail[:, :-1] &= ~(valid[:, 1:] & ~start[:, 1:])
            o[pos[is_tail]] = flat_v[is_tail.view(-1)]
        else:
            o[pos[keep]] = torch.full((), identity(op, v.dtype),
                                      dtype=v.dtype, device=dev)
            red = {"add": "sum", "mul": "prod", "min": "amin",
                   "max": "amax"}[op]
            src = flat_v[valid.view(-1)]
            index = pos[valid]
            if src.dim() > 1:
                index = index.view((-1,) + (1,) * (src.dim() - 1)).expand(
                    src.shape)
            o.scatter_reduce_(0, index, src, red, include_self=True)
        val_out.append(o.view(v.shape))
    dcounts = doffs = None
    if dst_col is not None:
        d = key_out[dst_col]
        kept_d = torch.where(tail_mask, n_dst, d.long())
        dcounts = shard_bincount(kept_d, n_dst + 1)[:, :n_dst].contiguous()
        doffs = (torch.cumsum(dcounts, 1) - dcounts).to(torch.int32)
    return key_out, val_out, n_unique, dcounts, doffs


def reduce_by_key_compact(key_cols, fills, val_leaves, n, op, dst_col=None,
                          n_dst=0):
    """Over rows sorted by `key_cols` ((N, cap) int32/int64, the first n[s]
    rows of shard s valid): merge each run of rows equal in every key
    column with `op` ("add" | "min" | "max" | "mul" over int64/float64
    values, or "last": the run's last value, any dtype), pack one row per
    run to the front in order, fill key tails with `fills` and value
    tails with 0.  With `dst_col` (the index of the destination column
    among the keys) also count kept rows per destination.  Float min and
    max propagate NaN; the kernel's float sums and products repeat bit
    for bit from call to call (one fixed association, another than the
    plain version's).  Returns (key_out, val_out, n_unique (N,) int32,
    dcounts (N, n_dst) or None, doffs (N, n_dst) or None)."""
    key_cols, val_leaves = list(key_cols), list(val_leaves)
    N, cap = key_cols[0].shape[:2]
    _check_cols(key_cols, N, cap, "key columns")
    _check_cols(val_leaves, N, cap, "value leaves")
    _need(1 <= len(key_cols) <= MAX_KEYS and len(val_leaves) <= MAX_LEAVES,
          "too many key or value columns")
    _need(all(c.dim() == 2 and c.dtype in (torch.int64, torch.int32)
              for c in key_cols), "key columns must be int32/int64 (N, cap)")
    _need(op in OPS, "unknown op %r" % (op,))
    if op != "last":
        _need(all(v.dtype in (torch.int64, torch.float64)
                  for v in val_leaves),
              "op %s reduces int64/float64 values only" % op)
    _need(n.dtype == torch.int32 and n.shape == (N,), "n must be (N,) int32")
    _need(dst_col is None or (0 <= dst_col < len(key_cols)
                              and 1 <= n_dst <= K3_MAX_DST),
          "dst_col must index a key column and n_dst be in [1, %d]"
          % K3_MAX_DST)
    _need(cap <= 2 ** 31 - _K3_TILE,
          "row ids are int32: cap must be <= 2**31 - %d" % _K3_TILE)
    if not _on_cuda(key_cols + val_leaves + [n]):
        return reduce_by_key_compact_plain(key_cols, fills, val_leaves, n,
                                           op, dst_col, n_dst)
    fn = _kernel("reduce_by_key_compact")
    dev = key_cols[0].device
    key_out = [torch.empty_like(c) for c in key_cols]
    val_out = [torch.empty_like(v) for v in val_leaves]
    n_unique = torch.empty((N,), dtype=torch.int32, device=dev)
    has_dst = dst_col is not None
    dcounts = doffs = None
    if has_dst:
        # counted with atomics; the offsets written by each shard's last
        # tile
        dcounts = torch.zeros((N, n_dst), dtype=torch.int32, device=dev)
        doffs = torch.empty((N, n_dst), dtype=torch.int32, device=dev)
    if cap == 0:
        n_unique.zero_()
        if has_dst:
            doffs.zero_()
        return key_out, val_out, n_unique, dcounts, doffs
    ntiles = -(-cap // _K3_TILE)
    # the tiles' count and value words, the item counter and the shards'
    # tile counters; a reduction's tile aggregates, inclusive values and
    # partial folds, one of each a tile and value lane
    status = torch.zeros((2 * N * ntiles + 1 + N,), dtype=torch.int64,
                         device=dev)
    lanes = 0 if op == "last" else sum(_lanes(v) for v in val_leaves)
    agg = (torch.empty((3 * N * ntiles * lanes,), dtype=torch.int64,
                       device=dev) if lanes else None)
    nk, nv = len(key_cols), len(val_leaves)
    kinds = [0 if v.dtype == torch.int64 else
             1 if v.dtype == torch.float64 else 2 for v in val_leaves]
    rc = fn(_ptrs(key_cols), _ptrs(key_out),
            (ctypes.c_int * nk)(*[c.element_size() for c in key_cols]),
            (ctypes.c_int64 * nk)(*[int(f) for f in fills]), nk,
            dst_col if has_dst else -1, int(n_dst),
            _ptrs(val_leaves), _ptrs(val_out),
            (ctypes.c_int64 * max(1, nv))(
                *[_row_bytes(v) for v in val_leaves]),
            (ctypes.c_int * max(1, nv))(*kinds),
            (ctypes.c_int64 * max(1, nv))(
                *[_lanes(v) for v in val_leaves]),
            nv, OPS[op], n.data_ptr(), N, cap, n_unique.data_ptr(),
            dcounts.data_ptr() if has_dst else None,
            doffs.data_ptr() if has_dst else None, status.data_ptr(),
            agg.data_ptr() if agg is not None else None, _stream())
    _check("reduce_by_key_compact", rc)
    return key_out, val_out, n_unique, dcounts, doffs


# ---------------------------------------------------------------------
# K4 shard_exchange
# ---------------------------------------------------------------------
def shard_exchange_plain(leaves, counts, offsets, cap_out, key_leaf,
                         key_fill):
    N = counts.shape[0]
    dev = counts.device
    c = counts.long()
    recv = c.sum(0)
    incl = torch.cumsum(c, 0).t().contiguous()          # (dst, src)
    base = incl - c.t()
    i = torch.arange(cap_out, device=dev)
    src = torch.searchsorted(incl, i.expand(N, cap_out).contiguous(),
                             right=True).clamp_(max=N - 1)
    row = (torch.gather(offsets.long().t(), 1, src) + i[None, :]
           - torch.gather(base, 1, src))
    valid = i[None, :] < recv[:, None]
    row = torch.where(valid, row, 0)
    src = torch.where(valid, src, 0)
    out = []
    for li, leaf in enumerate(leaves):
        g = leaf[src, row]
        fill = key_fill if li == key_leaf else 0
        vmask = valid.view(valid.shape + (1,) * (g.dim() - 2))
        out.append(torch.where(vmask, g, torch.full((), fill,
                                                    dtype=g.dtype,
                                                    device=dev)))
    return out, recv.to(torch.int32)


def shard_exchange(leaves, counts, offsets, cap_out, key_leaf=0,
                   key_fill=KEY_SENTINEL):
    """Ragged all-to-all among the N shards of one device: destination d
    receives bucket d (rows offsets[s, d] .. + counts[s, d]) of every
    source s, source-major, packed to the front of a (N, cap_out) leaf;
    the key leaf's tail holds `key_fill`, other tails 0.  Returns
    (received leaves, recv_counts (N,) int32).  The kernel reads the
    counts on the card (no host read here) and writes recv_counts."""
    leaves = list(leaves)
    N, cap_in = leaves[0].shape[:2]
    _check_cols(leaves, N, cap_in, "leaves")
    _need(1 <= len(leaves) <= MAX_LEAVES, "1..%d leaves" % MAX_LEAVES)
    _need(key_leaf is None or leaves[key_leaf].dtype in (
              torch.int64, torch.int32, torch.float64),
          "the key leaf must be an int32/int64/float64 column")
    _need(counts.shape == (N, N) and offsets.shape == (N, N)
          and counts.dtype == torch.int32 and offsets.dtype == torch.int32
          and counts.is_contiguous() and offsets.is_contiguous(),
          "counts/offsets must be contiguous (N, N) int32")
    if not _on_cuda(leaves + [counts, offsets]):
        return shard_exchange_plain(leaves, counts, offsets, cap_out,
                                    key_leaf, key_fill)
    fn = _kernel("shard_exchange")
    dev = leaves[0].device
    out = [torch.empty((N, cap_out) + tuple(leaf.shape[2:]),
                       dtype=leaf.dtype, device=dev) for leaf in leaves]
    recv = torch.empty((N,), dtype=torch.int32, device=dev)
    fill_bits = 0
    if key_leaf is not None:
        # the kernel stores the fill's bit pattern at the leaf's width
        fill_bits = _fill_bits(key_fill, leaves[key_leaf].dtype)[0]
    rc = fn(_ptrs(leaves), _ptrs(out),
            (ctypes.c_int64 * len(leaves))(*[_row_bytes(l) for l in leaves]),
            len(leaves), counts.data_ptr(), offsets.data_ptr(), N, cap_in,
            int(cap_out), -1 if key_leaf is None else int(key_leaf),
            fill_bits, recv.data_ptr(), _stream())
    _check("shard_exchange", rc)
    return out, recv


# ---------------------------------------------------------------------
# K5 radix_sort
# ---------------------------------------------------------------------
_RADIX_KINDS = {torch.int32: 0, torch.int64: 1, torch.float64: 2}
_I64_MIN = -2 ** 63
_QNAN_BITS = 0x7FF8000000000000


def radix_key_image(col):
    """The order-preserving unsigned image of a key column, as int64 bit
    patterns, and its digit count: ints flip the sign bit; floats turn
    -0.0 into +0.0 and every NaN into one positive quiet NaN, then flip
    every bit of a negative and the sign bit of a non-negative."""
    if col.dtype == torch.int32:
        return (col.long() & 0xFFFFFFFF) ^ 0x80000000, 4
    if col.dtype == torch.int64:
        return col ^ _I64_MIN, 8
    bits = col.contiguous().view(torch.int64)
    bits = torch.where(col == 0, torch.zeros_like(bits), bits)
    bits = torch.where(torch.isnan(col), torch.full_like(bits, _QNAN_BITS),
                       bits)
    return torch.where(bits < 0, ~bits, bits ^ _I64_MIN), 8


def _digit(img, d):
    return (img >> (8 * d)) & 0xFF


_PLAIN_TILE = 64      # rows per tile of the plain version's counting pass


def _counting_pass(img, idx, d):
    """One stable counting pass by digit d, as K5 does it: per-tile digit
    counts, their exclusive scan in (digit, tile) order, and each row's
    rank among the earlier rows of its tile with the same digit.  One
    shard at a time bounds the (tiles, 64, 64) rank compare."""
    N, cap = img.shape
    dev = img.device
    B = _PLAIN_TILE
    T = -(-cap // B)
    # tail rows of the last tile take digit 256: they land past cap
    dig = torch.full((N, T * B), 256, dtype=torch.int64, device=dev)
    dig[:, :cap] = _digit(img, d)
    dig = dig.view(N, T, B)
    earlier = torch.ones((B, B), dtype=torch.bool, device=dev).tril(-1)
    tiles = torch.arange(T, device=dev)[:, None]
    out_img, out_idx = torch.empty_like(img), torch.empty_like(idx)
    for s in range(N):
        ds = dig[s]
        rank = ((ds[:, :, None] == ds[:, None, :]) & earlier).sum(2)
        counts = torch.zeros((T, 257), dtype=torch.int64, device=dev)
        counts = counts.scatter_add_(1, ds, torch.ones_like(ds)).t()
        tile_start = torch.cumsum(counts, 1) - counts
        totals = counts.sum(1)
        digit_start = torch.cumsum(totals, 0) - totals
        pos = (digit_start[ds] + tile_start[ds, tiles] + rank).view(-1)
        pos = pos[:cap]
        out_img[s].scatter_(0, pos, img[s])
        out_idx[s].scatter_(0, pos, idx[s])
    return out_img, out_idx


def radix_plan(flags):
    """K5's digit passes and the width in bytes of the key image it
    carries between them, from the per-digit flags (4 for an int32 key,
    else 8) that say whether some shard's rows differ in that digit: a
    digit on which every shard's rows agree is skipped, and the image is
    4 bytes when every remaining digit lies in its low four bytes (the
    high ones are then constant in each shard), else 8."""
    passes = [d for d, a in enumerate(flags) if a]
    return passes, 4 if not passes or passes[-1] < 4 else 8


def radix_sorted_image(keys, relative):
    """The image K5's digit passes sort, with its plan (radix_plan):
    radix_key_image's, less each shard's least image when `relative` (as
    K5 takes it through src_idx, so that a narrow range of keys needs only
    its low digits even where it straddles zero)."""
    img, ndig = radix_key_image(keys)
    if relative and img.shape[1]:
        # the least as unsigned: the signed least of the flipped patterns
        img = img - ((img ^ _I64_MIN).min(1, keepdim=True).values
                     ^ _I64_MIN)
    return img, radix_plan(
        [bool(((shard_bincount(_digit(img, d), 256) > 0).sum(1) > 1).any())
         for d in range(ndig)])


def radix_sort_plain(col, src_idx=None):
    """K5's arithmetic in PyTorch: the same key image (radix_sorted_image:
    relative to each shard's least through src_idx), digit skipping and
    image width (radix_plan), and one stable counting pass (per-tile digit
    counts, their scan, and ranks inside a tile) per active digit."""
    N, cap = col.shape
    dev = col.device
    if src_idx is None:
        idx = torch.arange(cap, dtype=torch.int32, device=dev).expand(
            N, cap).contiguous()
        keys = col
    else:
        idx = src_idx.clone()
        keys = torch.gather(col, 1, src_idx.long())
    img, (passes, width) = radix_sorted_image(keys, src_idx is not None)
    if width == 4:
        img = img & 0xFFFFFFFF
    for d in passes:
        img, idx = _counting_pass(img, idx, d)
    return idx


# the rows of csrc/radix_sort.cu's smallest tile (K5_MIN_TILE: 512
# threads x 8 rows), by which the look-back's status words are tiled
_K5_MIN_TILE = 4096


def radix_sort(col, src_idx=None):
    """The (N, cap) int32 permutation that stable-sorts each shard's row
    of `col` ((N, cap) int32, int64 or float64) read through `src_idx`
    ((N, cap) int32 source rows of the current order, identity when None),
    composed with src_idx: bit-identical to
    ``src_idx.gather(1, torch.sort(col.gather(1, src_idx), dim=1,
    stable=True).indices)``.  NaN sorts last and -0.0 ties +0.0.

    On the card: the histogram pass, one host read of its digit flags
    (radix_plan), then one one-sweep pass per active digit launched by
    one C call (csrc/radix_sort.cu)."""
    _need(col.dim() == 2 and col.is_contiguous()
          and col.dtype in _RADIX_KINDS,
          "radix_sort takes a contiguous (N, cap) int32/int64/float64 "
          "column, got %s %s" % (col.dtype, tuple(col.shape)))
    N, cap = col.shape
    _need(cap < 2 ** 31, "the permutation is int32: cap must be < 2**31")
    extra = []
    if src_idx is not None:
        _need(src_idx.dtype == torch.int32 and src_idx.shape == (N, cap)
              and src_idx.is_contiguous(), "src_idx must be (N, cap) int32")
        extra = [src_idx]
    if not _on_cuda([col] + extra):
        return radix_sort_plain(col, src_idx)
    hist_fn, passes_fn = _kernel("radix_sort")
    dev = col.device
    if N == 0 or cap == 0:
        return torch.empty((N, cap), dtype=torch.int32, device=dev)
    kind = _RADIX_KINDS[col.dtype]
    ndig = 4 if col.dtype == torch.int32 else 8
    kdt = torch.int32 if ndig == 4 else torch.int64
    src = src_idx.data_ptr() if src_idx is not None else None
    hist = torch.zeros((N, ndig, 256), dtype=torch.int32, device=dev)
    bases = torch.empty_like(hist)
    active = torch.zeros((ndig,), dtype=torch.int32, device=dev)
    # through src_idx the histogram pass writes the gathered image less
    # its shard's least (lo) in row order, which the first pass reads
    staged = lo = None
    if src_idx is not None:
        staged = torch.empty((N, cap), dtype=kdt, device=dev)
        lo = torch.full((N,), -1, dtype=torch.int64, device=dev)
    _check("radix_sort", hist_fn(
        col.data_ptr(), kind, src, N, cap, ndig, hist.data_ptr(),
        bases.data_ptr(), active.data_ptr(),
        None if staged is None else staged.data_ptr(),
        None if lo is None else lo.data_ptr(), _stream()), count=False)
    flags = torch.empty((ndig,), dtype=torch.int32, pin_memory=True)
    flags.copy_(active, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    # while the histogram pass runs: the look-back's status words, then
    # one tile counter a pass (zeroed once, tagged by pass), and the
    # permutation (0.5 + 4 B a row)
    status = torch.zeros((N * -(-cap // _K5_MIN_TILE) * 256 + ndig,),
                         dtype=torch.int64, device=dev)
    out = torch.empty((N, cap), dtype=torch.int32, device=dev)
    ready.synchronize()
    passes, width = radix_plan(flags.tolist())
    LAUNCHES["radix_sort"] += 1
    if not passes:
        if src_idx is not None:
            return src_idx.clone()
        return torch.arange(cap, dtype=torch.int32, device=dev).expand(
            N, cap).contiguous()
    npass = len(passes)
    # the last pass writes `out` and the earlier ones alternate between
    # it and one more index buffer, the images between two buffers of
    # `width` bytes, the staged image the second
    other = out if npass == 1 else torch.empty_like(out)
    ibuf = [other, out] if (npass - 1) % 2 else [out, other]
    wdt = torch.int32 if width == 4 else torch.int64
    kbuf = [torch.empty((N, cap), dtype=wdt, device=dev)
            if npass > 1 else None,
            staged if staged is not None or npass < 3
            else torch.empty((N, cap), dtype=wdt, device=dev)]
    _check("radix_sort", passes_fn(
        col.data_ptr(), kind, src,
        None if staged is None else staged.data_ptr(),
        *[None if b is None else b.data_ptr() for b in kbuf],
        ibuf[0].data_ptr(), ibuf[1].data_ptr(), out.data_ptr(),
        (ctypes.c_int * npass)(*passes), npass, width, N, cap, ndig,
        bases.data_ptr(), status.data_ptr(), _stream()), count=False)
    return out


# ---------------------------------------------------------------------
# K6 range_dst_hist
# ---------------------------------------------------------------------
def range_dst_hist_plain(key_cols, bounds, ascending, r, n_dst, n):
    from dpark_tpu_torch.backend.cuda.collectives import lex_searchsorted
    cap = key_cols[0].shape[1]
    idx = lex_searchsorted([bounds[:, c] for c in range(bounds.shape[1])],
                           key_cols)
    dst = idx if ascending else r - 1 - idx
    valid = torch.arange(cap, device=idx.device)[None, :] < n[:, None].long()
    dst = torch.where(valid, dst, n_dst).to(torch.int32)
    return dst, shard_bincount(dst, n_dst + 1)


def range_dst_hist(key_cols, bounds, ascending, r, n_dst, n):
    """Range-partitioner destination of each row: bisect_left of the key
    row (1..4 (N, cap) columns of one dtype, int64 or float64) into the
    sorted `bounds` ((m, nk), same dtype), compared lexicographically; idx
    when ascending, else r - 1 - idx; n_dst on padding rows.  Returns (dst
    (N, cap) int32, histogram (N, n_dst + 1) int32)."""
    key_cols = list(key_cols)
    N, cap = key_cols[0].shape[:2]
    nk = len(key_cols)
    _check_cols(key_cols, N, cap, "key columns")
    dt = key_cols[0].dtype
    _need(1 <= nk <= 4 and dt in (torch.int64, torch.float64)
          and all(c.dim() == 2 and c.dtype == dt for c in key_cols),
          "1..4 key columns of one dtype, int64 or float64")
    _need(bounds.dim() == 2 and bounds.shape[1] == nk and bounds.dtype == dt
          and bounds.is_contiguous(), "bounds must be contiguous (m, nk) "
          "of the key dtype")
    _need(n.dtype == torch.int32 and n.shape == (N,), "n must be (N,) int32")
    if not _on_cuda(key_cols + [bounds, n]):
        return range_dst_hist_plain(key_cols, bounds, ascending, r, n_dst, n)
    m = bounds.shape[0]
    _need(m * nk * 8 + (n_dst + 1) * 4 <= 48 * 1024,
          "bounds and histogram must fit 48 KB of shared memory")
    fn = _kernel("range_dst_hist")
    dev = key_cols[0].device
    dst = torch.empty((N, cap), dtype=torch.int32, device=dev)
    hist = torch.zeros((N, n_dst + 1), dtype=torch.int32, device=dev)
    rc = fn(_ptrs(key_cols), nk, 1 if dt == torch.int64 else 2,
            bounds.data_ptr() if m else None, m, int(bool(ascending)),
            int(r), int(n_dst), n.data_ptr(), N, cap, dst.data_ptr(),
            hist.data_ptr(), _stream())
    _check("range_dst_hist", rc)
    return dst, hist


# ---------------------------------------------------------------------
# K7 segment_table
# ---------------------------------------------------------------------
_SEG_KINDS = {torch.int32: 0, torch.int64: 1, torch.float64: 2}
_K7_TILE = 8192       # K7_TILE of csrc/segment_table.cu: the rows of a
                      # tile, by which the look-back's status words go


def size_class(sizes):
    """Per-segment power-of-two size class ceil(log2(size)) (sizes 0/1 ->
    0, 2 -> 1, 3..4 -> 2, ...), bit-twiddled in integers: float log2
    rounding must not shift a 2^k-sized group into the next class."""
    x = torch.clamp(sizes.long(), min=1) - 1
    bits = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for shift in (32, 16, 8, 4, 2, 1):
        big = x >= (1 << shift)
        bits = bits + torch.where(big, shift, 0).to(torch.int32)
        x = torch.where(big, x >> shift, x)
    return bits + (x > 0).to(torch.int32)


def _seg_fills(key_cols):
    """What the segment-key outputs hold past n_seg: the key dtype's max
    (inf for floats) in column 0, 0 in the others."""
    k0 = key_cols[0]
    return [float("inf") if k0.is_floating_point()
            else torch.iinfo(k0.dtype).max] + [0] * (len(key_cols) - 1)


def segment_table_plain(key_cols, n, want_keys=True):
    N, cap = key_cols[0].shape
    dev = key_cols[0].device
    idx = torch.arange(cap, device=dev)
    valid = idx[None, :] < n[:, None].long()
    start = torch.zeros((N, cap), dtype=torch.bool, device=dev)
    start[:, 0] = True
    for c in key_cols:
        start[:, 1:] |= c[:, 1:] != c[:, :-1]
    start &= valid
    n_seg = start.sum(1).to(torch.int32)
    rank = torch.cumsum(start.long(), 1) - 1
    pos = (torch.arange(N, device=dev)[:, None] * cap + rank)[start]
    rows = idx.expand(N, cap)[start]
    start_rows = torch.zeros((N, cap), dtype=torch.int32, device=dev)
    start_rows.view(-1)[pos] = rows.to(torch.int32)
    live = idx[None, :] < n_seg[:, None].long()
    nxt = torch.cat([start_rows[:, 1:], start_rows[:, :1]], 1)
    last = idx[None, :] == (n_seg[:, None].long() - 1)
    nxt = torch.where(last, n[:, None].to(torch.int32), nxt)
    sizes = torch.where(live, nxt - start_rows, 0).to(torch.int32)
    bucket = torch.where(live, size_class(sizes), SIZE_CLASSES).to(
        torch.int32)
    hist = shard_bincount(bucket, SIZE_CLASSES + 1)[:, :SIZE_CLASSES]
    keys = None
    if want_keys:
        keys = []
        for c, fill in zip(key_cols, _seg_fills(key_cols)):
            o = torch.full_like(c, fill)
            o.view(-1)[pos] = c[start]
            keys.append(o)
    return start_rows, sizes, bucket, n_seg, hist.contiguous(), keys


def segment_table(key_cols, n, want_keys=True):
    """The segment table of each shard's key-sorted rows ((N, cap) key
    columns, 1-4 of int32/int64/float64; the first n[s] rows valid): a
    segment starts at row 0 and wherever any key column differs (!=) from
    the row before.  Returns (start_rows, sizes, bucket, n_seg, hist,
    keys): (N, cap) int32 start row, size and size class of segment j
    (0, 0, SIZE_CLASSES past n_seg), (N,) int32 n_seg, (N, SIZE_CLASSES)
    int32 class histogram, and with want_keys the key columns at each
    start row (_seg_fills past n_seg), else None."""
    key_cols = list(key_cols)
    N, cap = key_cols[0].shape[:2]
    _check_cols(key_cols, N, cap, "key columns")
    _need(1 <= len(key_cols) <= 4 and all(
        c.dim() == 2 and c.dtype in _SEG_KINDS for c in key_cols),
        "1..4 (N, cap) key columns of int32/int64/float64")
    _need(cap < 2 ** 31, "row ids are int32: cap must be < 2**31")
    _need(n.dtype == torch.int32 and n.shape == (N,), "n must be (N,) int32")
    if not _on_cuda(key_cols + [n]):
        return segment_table_plain(key_cols, n, want_keys)
    fn = _kernel("segment_table")
    dev = key_cols[0].device
    start_rows = torch.empty((N, cap), dtype=torch.int32, device=dev)
    sizes = torch.empty_like(start_rows)
    bucket = torch.empty_like(start_rows)
    n_seg = torch.empty((N,), dtype=torch.int32, device=dev)
    hist = torch.zeros((N, SIZE_CLASSES), dtype=torch.int32, device=dev)
    keys = [torch.empty_like(c) for c in key_cols] if want_keys else None
    if cap == 0:
        n_seg.zero_()
        return start_rows, sizes, bucket, n_seg, hist, keys
    status = torch.zeros((N * -(-cap // _K7_TILE) + 1,), dtype=torch.int64,
                         device=dev)
    # each fill as the bit pattern of its column's dtype
    fill_bits = [int(torch.tensor(f, dtype=c.dtype).view(
        torch.int64 if c.element_size() == 8 else torch.int32))
        for f, c in zip(_seg_fills(key_cols), key_cols)]
    nk = len(key_cols)
    rc = fn(_ptrs(key_cols),
            _ptrs(keys) if want_keys else (ctypes.c_void_p * nk)(),
            (ctypes.c_int * nk)(*[_SEG_KINDS[c.dtype] for c in key_cols]),
            (ctypes.c_int64 * nk)(*fill_bits), nk, n.data_ptr(), N, cap,
            start_rows.data_ptr(), sizes.data_ptr(), bucket.data_ptr(),
            n_seg.data_ptr(), hist.data_ptr(), status.data_ptr(),
            _stream())
    _check("segment_table", rc)
    return start_rows, sizes, bucket, n_seg, hist, keys


# ---------------------------------------------------------------------
# K8 bucket_gather / bucket_scatter
# ---------------------------------------------------------------------
def _lanes_of(members, boff, bcnt, G):
    """(seg (N, G) int64 segment id of each lane, clipped; lane valid
    (N, G) bool)."""
    N, cap = members.shape
    g = torch.arange(G, device=members.device)
    valid = g[None, :] < bcnt[:, None].long()
    at = torch.clamp(boff[:, None].long() + g[None, :], max=max(cap - 1, 0))
    seg = torch.where(valid, torch.gather(members.long(), 1, at), 0)
    return seg, valid


def bucket_gather_plain(start_rows, sizes, members, boff, bcnt, G, B, vals,
                        pad):
    N, cap = vals.shape
    seg, valid = _lanes_of(members, boff, bcnt, G)
    st = torch.gather(start_rows.long(), 1, seg)
    sz = torch.gather(sizes.long(), 1, seg)
    o = torch.arange(B, device=vals.device)
    if pad == "edge":
        off = torch.minimum(o[None, None, :],
                            torch.clamp(sz, min=1)[:, :, None] - 1)
        keep = valid[:, :, None].expand(N, G, B)
    else:
        off = o[None, None, :].expand(N, G, B)
        keep = valid[:, :, None] & (o[None, None, :] < sz[:, :, None])
    rows = torch.clamp(st[:, :, None] + off, 0, max(cap - 1, 0))
    got = torch.gather(vals, 1, rows.reshape(N, G * B)).view(N, G, B)
    return torch.where(keep, got, torch.zeros((), dtype=vals.dtype,
                                              device=vals.device))


def bucket_gather(start_rows, sizes, members, boff, bcnt, G, B, vals, pad):
    """The padded (N, G, B) value matrix of one size class: lane g of
    shard s holds group members[s, boff[s] + g] (valid when g < bcnt[s]),
    its rows start_rows[seg] .. + sizes[seg] of `vals` ((N, cap)), padded
    to B columns with 0 ("zero") or the group's last row ("edge");
    invalid lanes are all 0."""
    N, cap = vals.shape[:2]
    _check_cols([start_rows, sizes, members, vals], N, cap,
                "segment table and values")
    _need(all(t.dtype == torch.int32 for t in
              (start_rows, sizes, members, boff, bcnt))
          and boff.shape == (N,) and bcnt.shape == (N,)
          and boff.is_contiguous() and bcnt.is_contiguous(),
          "segment table int32 (N, cap), boff/bcnt contiguous (N,) int32")
    _need(vals.dim() == 2, "vals must be a (N, cap) column")
    _need(pad in ("zero", "edge"), "pad must be 'zero' or 'edge'")
    _need(G >= 1 and B >= 1, "G and B must be positive")
    if not _on_cuda([start_rows, sizes, members, boff, bcnt, vals]):
        return bucket_gather_plain(start_rows, sizes, members, boff, bcnt,
                                   G, B, vals, pad)
    gather_fn = _kernel("bucket_groups")[0]
    out = torch.empty((N, G, B), dtype=vals.dtype, device=vals.device)
    rc = gather_fn(start_rows.data_ptr(), sizes.data_ptr(),
                   members.data_ptr(), boff.data_ptr(), bcnt.data_ptr(), N,
                   cap, int(G), int(B), vals.data_ptr(), vals.element_size(),
                   out.data_ptr(), int(pad == "edge"), _stream())
    _check("bucket_gather", rc)
    return out


def bucket_scatter_plain(outs, results, members, boff, bcnt):
    N, G = results[0].shape
    seg, valid = _lanes_of(members, boff, bcnt, G)
    rows = torch.arange(N, device=members.device)[:, None].expand(N, G)
    for o, r in zip(outs, results):
        o[rows[valid], seg[valid]] = r[valid].to(o.dtype)
    return outs


K8X_MAX_RESULTS = 256   # K8X_MAX_RESULTS of csrc/bucket_groups.cu: the
                        # (class, leaf) result pointers a launch takes


def _scatter_launch(members, off, cnt, nt, span, classes, results, outs,
                    fill):
    """One k8_scatter_classes launch a chunk of leaves that fits the
    parameter space (results[k] holds class k's leaves)."""
    fn = _kernel("bucket_groups")[1]
    N, cap = members.shape
    if N == 0 or span == 0:
        return
    per = max(1, min(MAX_LEAVES, K8X_MAX_RESULTS // max(1, len(classes))))
    for l0 in range(0, len(outs), per):
        ls = range(l0, min(len(outs), l0 + per))
        res = [results[k][l] for k in range(len(classes)) for l in ls]
        rc = fn(members.data_ptr(), off.data_ptr(), cnt.data_ptr(),
                off.shape[1] if off.dim() == 2 else 1, nt, N, cap, span,
                len(classes), (ctypes.c_int * max(1, len(classes)))(
                    *classes),
                (ctypes.c_int64 * max(1, len(classes)))(
                    *[r[0].shape[1] for r in results]),
                _ptrs(res), len(ls), _ptrs([outs[l] for l in ls]),
                (ctypes.c_int64 * len(ls))(
                    *[outs[l].element_size() for l in ls]),
                int(fill), _stream())
        _check("bucket_scatter", rc)


def bucket_scatter(outs, results, members, boff, bcnt):
    """Write each valid lane's results ((N, G) leaves) into `outs` ((N,
    cap) leaves of the same dtypes) at its segment id members[s, boff[s]
    + g], IN PLACE; invalid lanes write nothing.  Returns outs.  One
    launch of the batched scatter over this class's lanes alone."""
    outs, results = list(outs), list(results)
    N, cap = outs[0].shape[:2]
    G = results[0].shape[1]
    _check_cols(outs + [members], N, cap, "outputs and members")
    _check_cols(results, N, G, "results")
    _need(len(outs) == len(results) and 1 <= len(outs) <= MAX_LEAVES
          and all(o.dtype == r.dtype and o.dim() == 2
                  and o.element_size() in (1, 2, 4, 8)
                  for o, r in zip(outs, results)),
          "1..%d (N, cap) outputs matching the (N, G) results' dtypes"
          % MAX_LEAVES)
    _need(all(t.dtype == torch.int32 for t in (members, boff, bcnt))
          and boff.shape == (N,) and bcnt.shape == (N,)
          and boff.is_contiguous() and bcnt.is_contiguous(),
          "members int32 (N, cap), boff/bcnt contiguous (N,) int32")
    if not _on_cuda(outs + results + [members, boff, bcnt]):
        return bucket_scatter_plain(outs, results, members, boff, bcnt)
    _scatter_launch(members, boff, bcnt, 1, G, [0], [results], outs, False)
    return outs


def bucket_scatter_classes_plain(results_by_class, members, offsets, counts,
                                 classes, out_dtypes):
    N, cap = members.shape
    outs = [torch.zeros((N, cap), dtype=dt, device=members.device)
            for dt in out_dtypes]
    for b, res in zip(classes, results_by_class):
        bucket_scatter_plain(outs, res, members, offsets[:, b], counts[:, b])
    return outs


def bucket_scatter_classes(results_by_class, members, offsets, counts,
                           classes, out_dtypes):
    """Every size class's results written back in one launch: fresh (N,
    cap) output leaves of `out_dtypes` where each member slot of listed
    class classes[k] (members[s, offsets[s, b]:][:counts[s, b]], b =
    classes[k]) holds its lane's result results_by_class[k][l][s, lane]
    ((N, G_k) leaves of out_dtypes[l]) at its segment id, and every other
    slot (the pad class SIZE_CLASSES: the segment ids past n_seg) 0.
    members, offsets and counts as collectives.bucket_members returns
    them (offsets and counts (N, SIZE_CLASSES + 1) int32; each shard's
    members a permutation of its cap slots, the pad class's slot j
    holding segment id j, which the kernel writes without reading
    members).  Where the (class, leaf) pointers pass K8X_MAX_RESULTS, the
    leaves go in several launches."""
    classes = [int(b) for b in classes]
    results_by_class = [list(r) for r in results_by_class]
    out_dtypes = list(out_dtypes)
    N, cap = members.shape[:2]
    _check_cols([members], N, cap, "members")
    _need(members.dtype == torch.int32 and members.dim() == 2,
          "members must be (N, cap) int32")
    for t in (offsets, counts):
        _need(t.dtype == torch.int32 and t.is_contiguous()
              and t.shape == (N, SIZE_CLASSES + 1),
              "offsets and counts must be contiguous (N, %d) int32"
              % (SIZE_CLASSES + 1))
    _need(len(set(classes)) == len(classes)
          and all(0 <= b < SIZE_CLASSES for b in classes)
          and len(results_by_class) == len(classes),
          "distinct classes in [0, %d), one list of results each"
          % SIZE_CLASSES)
    _need(1 <= len(out_dtypes) <= MAX_LEAVES
          and all(torch.empty((), dtype=dt).element_size() in (1, 2, 4, 8)
                  for dt in out_dtypes),
          "1..%d output leaves of 1, 2, 4 or 8 bytes" % MAX_LEAVES)
    for res in results_by_class:
        _need(len(res) == len(out_dtypes)
              and all(r.dtype == dt for r, dt in zip(res, out_dtypes)),
              "each class's results must match out_dtypes")
        _check_cols(res, N, res[0].shape[1], "results")
        _need(all(r.dim() == 2 for r in res), "results must be (N, G)")
    flat = [r for res in results_by_class for r in res]
    if not _on_cuda([members, offsets, counts] + flat):
        return bucket_scatter_classes_plain(results_by_class, members,
                                            offsets, counts, classes,
                                            out_dtypes)
    outs = [torch.empty((N, cap), dtype=dt, device=members.device)
            for dt in out_dtypes]
    _scatter_launch(members, offsets, counts, SIZE_CLASSES + 1, cap,
                    classes, results_by_class, outs, True)
    return outs


_K8S_CHUNK = 4096     # K8S_CHUNK of csrc/bucket_groups.cu: the slots of a
                      # wide class's chunk; the wrapper sizes the chunk
                      # records by it


def bucket_gather_state_plain(start_rows, sizes, members, boff, bcnt, G,
                              B, vals, flags, pad):
    N, cap = vals.shape
    seg, valid = _lanes_of(members, boff, bcnt, G)
    st = torch.gather(start_rows.long(), 1, seg)
    sz = torch.gather(sizes.long(), 1, seg)
    o = torch.arange(B, device=vals.device)
    in_range = valid[:, :, None] & (o[None, None, :] < sz[:, :, None])
    rows = torch.clamp(st[:, :, None] + o[None, None, :], 0,
                       max(cap - 1, 0)).reshape(N, G * B)
    v = torch.gather(vals, 1, rows).view(N, G, B)
    fl = torch.where(in_range, torch.gather(flags, 1, rows).view(N, G, B),
                     2)
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    new = fl == 0
    # the new values to the front in row order: a stable sort of ~new
    order = torch.sort((~new).to(torch.int8), dim=2, stable=True).indices
    vs = torch.gather(torch.where(new, v, zero), 2, order)
    n_new = new.sum(2, keepdim=True)
    keep = o[None, None, :] < n_new
    if pad == "edge":
        last = torch.gather(vs, 2, torch.clamp(n_new - 1, min=0))
        fill = torch.where(n_new > 0, last, zero)
    else:
        fill = zero
    out = torch.where(keep, vs, fill)
    old = fl == 1
    has_prev = old.any(2)
    at = old.to(torch.int8).argmax(2, keepdim=True)
    prev = torch.where(has_prev, torch.gather(v, 2, at)[:, :, 0], zero)
    return out, prev, has_prev


def bucket_gather_state(start_rows, sizes, members, boff, bcnt, G, B, vals,
                        flags, pad):
    """The state mode's padded matrix of one size class: for lane g of
    shard s (group members[s, boff[s] + g], valid when g < bcnt[s]) over
    its rows start_rows[seg] .. + sizes[seg] of `vals` and `flags` ((N,
    cap); flags int64, 1 the carried state row, at most one a group, 0 a
    new value): the new values compacted to the front of B columns in
    row order, padded with 0 ("zero") or the last new value ("edge", 0
    without one); `prev`, the flag-1 row's value copied (0 without one);
    `has_prev`.  B must be a power of two.  Invalid lanes are all 0.
    Returns (out (N, G, B), prev (N, G), has_prev (N, G) bool).

    The reference takes prev as a masked sum of the group's row; the copy
    keeps a carried -0.0 as the host path's update sees it."""
    N, cap = vals.shape[:2]
    _check_cols([start_rows, sizes, members, vals, flags], N, cap,
                "segment table, values and flags")
    _need(all(t.dtype == torch.int32 for t in
              (start_rows, sizes, members, boff, bcnt))
          and boff.shape == (N,) and bcnt.shape == (N,)
          and boff.is_contiguous() and bcnt.is_contiguous(),
          "segment table int32 (N, cap), boff/bcnt contiguous (N,) int32")
    _need(vals.dim() == 2 and flags.dim() == 2
          and flags.dtype == torch.int64,
          "vals must be a (N, cap) column and flags (N, cap) int64")
    _need(pad in ("zero", "edge"), "pad must be 'zero' or 'edge'")
    _need(G >= 1 and B >= 1 and B & (B - 1) == 0,
          "G must be positive and B a power of two")
    if not _on_cuda([start_rows, sizes, members, boff, bcnt, vals, flags]):
        return bucket_gather_state_plain(start_rows, sizes, members, boff,
                                         bcnt, G, B, vals, flags, pad)
    state_fn = _kernel("bucket_groups")[2]
    dev = vals.device
    out = torch.empty((N, G, B), dtype=vals.dtype, device=dev)
    prev = torch.empty((N, G), dtype=vals.dtype, device=dev)
    has_prev = torch.empty((N, G), dtype=torch.bool, device=dev)
    # a record (4 int32) a chunk of the lanes that span several
    scratch = torch.empty((N * G * (B // _K8S_CHUNK), 4), dtype=torch.int32,
                          device=dev) if B > _K8S_CHUNK else None
    rc = state_fn(start_rows.data_ptr(), sizes.data_ptr(),
                  members.data_ptr(), boff.data_ptr(), bcnt.data_ptr(), N,
                  cap, int(G), int(B), vals.data_ptr(), vals.element_size(),
                  flags.data_ptr(), out.data_ptr(), prev.data_ptr(),
                  has_prev.data_ptr(), int(pad == "edge"),
                  None if scratch is None else scratch.data_ptr(),
                  _stream())
    _check("bucket_gather_state", rc)
    return out, prev, has_prev


# ---------------------------------------------------------------------
# K9 edge_gather
# ---------------------------------------------------------------------
def edge_gather_plain(e_slot, ecnt, leaves, gate):
    cap_e = e_slot.shape[1]
    live = torch.arange(cap_e, device=e_slot.device)[None, :] \
        < ecnt[:, None].long()
    idx = torch.where(live, e_slot.long(), 0)
    out = [shard_rows(leaf, idx) for leaf in leaves]
    return out, shard_rows(gate, idx) & live


def edge_gather(e_slot, ecnt, leaves, gate):
    """The vertex state seen from each edge slot: for every (shard, edge
    slot), each vertex leaf's row e_slot[s, e] of shard s ((N, cap_v, ...)
    leaves -> (N, cap_e, ...)), and the send flag sa[s, e] = gate[s,
    e_slot[s, e]] & (e < ecnt[s]).  `e_slot` is (N, cap_e) int32, `ecnt`
    (N,) int32, `gate` (N, cap_v) bool.  A padded slot (e >= ecnt[s])
    gathers vertex row 0 whatever its e_slot holds (the reference's
    padded slots hold 0) and its flag is False.  Returns (gathered
    leaves, sa)."""
    leaves = list(leaves)
    N, cap_e = e_slot.shape
    cap_v = gate.shape[1] if gate.dim() == 2 else -1
    _need(e_slot.dtype == torch.int32 and e_slot.is_contiguous(),
          "e_slot must be a contiguous (N, cap_e) int32 tensor")
    _need(ecnt.dtype == torch.int32 and ecnt.shape == (N,),
          "ecnt must be (N,) int32")
    _need(gate.dtype == torch.bool and gate.shape == (N, cap_v)
          and gate.is_contiguous() and cap_v >= 1,
          "gate must be a contiguous (N, cap_v) bool tensor")
    _check_cols(leaves, N, cap_v, "vertex leaves")
    _need(cap_e < 2 ** 31 - 4096 and cap_v < 2 ** 31 and N < 2 ** 16,
          "edge_gather takes cap_e, cap_v below 2**31 and N below 2**16")
    if not _on_cuda([e_slot, ecnt, gate] + leaves):
        return edge_gather_plain(e_slot, ecnt, leaves, gate)
    fn = _kernel("edge_gather")
    dev = e_slot.device
    out = [torch.empty((N, cap_e) + tuple(leaf.shape[2:]), dtype=leaf.dtype,
                       device=dev) for leaf in leaves]
    sa = torch.empty((N, cap_e), dtype=torch.bool, device=dev)
    # one launch per MAX_LEAVES leaves (each rewrites the same sa); one
    # leaf of 1, 2, 4, 8 or 16 B goes through a record table, {row, gate}
    # a vertex, so that an edge makes one random read
    for i in range(0, max(1, len(leaves)), MAX_LEAVES):
        part = leaves[i:i + MAX_LEAVES]
        rec = None
        if len(part) == 1 and _row_bytes(part[0]) in (1, 2, 4, 8, 16):
            rec = torch.empty((N, cap_v, 2 * _row_bytes(part[0])),
                              dtype=torch.uint8, device=dev)
        rc = fn(e_slot.data_ptr(), ecnt.data_ptr(), N, cap_e, cap_v,
                _ptrs(part), _ptrs(out[i:i + MAX_LEAVES]),
                (ctypes.c_int64 * max(1, len(part)))(
                    *[_row_bytes(leaf) for leaf in part]),
                len(part), gate.data_ptr(), sa.data_ptr(),
                None if rec is None else rec.data_ptr(), _stream())
        _check("edge_gather", rc)
    return out, sa


# ---------------------------------------------------------------------
# K10 pregel_deliver
# ---------------------------------------------------------------------
def _elem_bits(value, dtype):
    """(bit pattern as a non-negative int, element size) of one value."""
    t = torch.tensor(value, dtype=dtype).reshape(1)
    w = t.element_size()
    iv = t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                 8: torch.int64}[w])
    return int(iv.item()) & ((1 << (8 * w)) - 1), w


# the fills of K4, K10 and K16 (a sentinel, a monoid's identity) recur
# on every call: their bits are computed once a process
_fill_bits = functools.lru_cache(maxsize=256)(_elem_bits)


def _deliver_fills(leaves, combine, fills):
    """The value written where a slot has no mail, one per leaf: `fills`
    when given, else the combine monoid's identity."""
    if fills is None:
        return [identity(combine, u.dtype) for u in leaves]
    return list(fills)


def pregel_deliver_plain(vid, vcnt, uk, n_unique, leaves, combine,
                         fills=None):
    N, cap_v = vid.shape
    cap_u = uk.shape[1]
    dev = vid.device
    live_u = (torch.arange(cap_u, device=dev)[None, :]
              < n_unique[:, None].long())
    keys = torch.where(live_u, uk, KEY_SENTINEL)
    pos = torch.searchsorted(keys, vid).clamp_(0, cap_u - 1)
    valid = torch.arange(cap_v, device=dev)[None, :] < vcnt[:, None].long()
    has = (torch.gather(keys, 1, pos) == vid) & valid & (vid != KEY_SENTINEL)
    out = []
    for u, fill in zip(leaves, _deliver_fills(leaves, combine, fills)):
        got = shard_rows(u, pos)
        ident = torch.full((), fill, dtype=u.dtype, device=dev)
        out.append(torch.where(has.view(has.shape + (1,) * (got.dim() - 2)),
                               got, ident))
    return out, has


def pregel_deliver(vid, vcnt, uk, n_unique, leaves, combine, fills=None):
    """Each vertex slot's combined inbound message: bisect its id (`vid`,
    (N, cap_v) int64 in any order, the sentinel past vcnt[s]) into its
    shard's unique message keys uk[s, :n_unique[s]] ((N, cap_u) int64,
    ascending).  Where found (and the slot valid, its id not the
    sentinel) each message leaf's row ((N, cap_u, ...) -> (N, cap_v, ...))
    is copied, else the `combine` monoid's identity written, or with
    `fills` (one value per leaf; `combine` may then be None) that leaf's
    fill; a message to an id with no vertex is dropped.  Returns (message
    leaves, has (N, cap_v) bool)."""
    leaves = list(leaves)
    N, cap_v = vid.shape
    cap_u = uk.shape[1] if uk.dim() == 2 else 0
    if fills is None:
        _need(combine in ("add", "min", "max", "mul"),
              "unknown monoid %r" % (combine,))
    else:
        _need(len(fills) == len(leaves), "one fill per message leaf")
    _need(vid.dtype == torch.int64 and vid.is_contiguous()
          and uk.dtype == torch.int64 and uk.is_contiguous()
          and uk.shape == (N, cap_u) and cap_u >= 1,
          "vid (N, cap_v) and uk (N, cap_u) must be contiguous int64")
    _need(vcnt.dtype == torch.int32 and vcnt.shape == (N,)
          and n_unique.dtype == torch.int32 and n_unique.shape == (N,),
          "vcnt and n_unique must be (N,) int32")
    _check_cols(leaves, N, cap_u, "message leaves")
    if not _on_cuda([vid, vcnt, uk, n_unique] + leaves):
        return pregel_deliver_plain(vid, vcnt, uk, n_unique, leaves,
                                    combine, fills)
    fn = _kernel("pregel_deliver")[0]
    dev = vid.device
    out = [torch.empty((N, cap_v) + tuple(u.shape[2:]), dtype=u.dtype,
                       device=dev) for u in leaves]
    has = torch.empty((N, cap_v), dtype=torch.bool, device=dev)
    for part, dst, leaf_args in _deliver_groups(
            leaves, out, _deliver_fills(leaves, combine, fills)):
        rc = fn(vid.data_ptr(), vcnt.data_ptr(), N, cap_v, uk.data_ptr(),
                n_unique.data_ptr(), cap_u, *leaf_args, has.data_ptr(),
                _stream())
        _check("pregel_deliver", rc)
    return out, has


def _deliver_groups(leaves, out, fills):
    """(leaves, outputs, the C entry's leaf arguments) a launch: at most
    MAX_LEAVES leaves each (one launch with none where there are no
    leaves; each launch writes the same flags)."""
    for i in range(0, max(1, len(leaves)), MAX_LEAVES):
        part, dst = leaves[i:i + MAX_LEAVES], out[i:i + MAX_LEAVES]
        idents = [_fill_bits(f, u.dtype)
                  for f, u in zip(fills[i:i + MAX_LEAVES], part)]
        k = max(1, len(part))
        yield part, dst, (
            _ptrs(part), _ptrs(dst),
            (ctypes.c_int64 * k)(*[_row_bytes(u) for u in part]),
            (ctypes.c_uint64 * k)(*[b for b, _ in idents]),
            (ctypes.c_int * k)(*[w for _, w in idents]), len(part))


K10_MAX_CLASSES = 32       # K10_MAX_CLASSES of csrc/pregel_deliver.cu
# a class's rows in the batched outputs start at a multiple of this
_K10_ROW_ALIGN = 16


def pregel_deliver_classes_plain(classes, uk, n_unique, leaves, combine,
                                 fills=None):
    return [pregel_deliver_plain(vid, vcnt, uk, n_unique, leaves, combine,
                                 fills) for vid, vcnt in classes]


def pregel_deliver_classes(classes, uk, n_unique, leaves, combine,
                           fills=None):
    """pregel_deliver into several vertex tables at once (the object
    Bagel's degree classes): `classes` is a list of (vid (N, cap_c)
    int64 in any order, vcnt (N,) int32) sharing the shard's unique keys
    and message leaves.  Returns one (message leaves, has) per class,
    each equal to pregel_deliver's for that class.  On the card one
    launch serves up to K10_MAX_CLASSES classes and MAX_LEAVES leaves;
    the outputs of all classes share one allocation a leaf (each class's
    rows a contiguous view)."""
    classes = [(vid, vcnt) for vid, vcnt in classes]
    leaves = list(leaves)
    _need(len(classes) >= 1, "at least one class")
    N = uk.shape[0]
    cap_u = uk.shape[1] if uk.dim() == 2 else 0
    if fills is None:
        _need(combine in ("add", "min", "max", "mul"),
              "unknown monoid %r" % (combine,))
    else:
        _need(len(fills) == len(leaves), "one fill per message leaf")
    _need(uk.dtype == torch.int64 and uk.is_contiguous() and cap_u >= 1,
          "uk (N, cap_u) must be contiguous int64")
    _need(n_unique.dtype == torch.int32 and n_unique.shape == (N,),
          "n_unique must be (N,) int32")
    for vid, vcnt in classes:
        _need(vid.dtype == torch.int64 and vid.is_contiguous()
              and vid.dim() == 2 and vid.shape[0] == N,
              "each class's vid must be a contiguous (N, cap) int64")
        _need(vcnt.dtype == torch.int32 and vcnt.shape == (N,),
              "each class's vcnt must be (N,) int32")
    _check_cols(leaves, N, cap_u, "message leaves")
    tensors = [uk, n_unique] + leaves + [t for c in classes for t in c]
    if not _on_cuda(tensors):
        # the per-class wrapper, which runs its plain version here
        return [pregel_deliver(vid, vcnt, uk, n_unique, leaves, combine,
                               fills) for vid, vcnt in classes]
    fn = _kernel("pregel_deliver")[1]
    dev = uk.device
    caps = [vid.shape[1] for vid, _ in classes]
    row0, rows = [], 0
    for cap in caps:
        row0.append(rows)
        rows += -(-N * cap // _K10_ROW_ALIGN) * _K10_ROW_ALIGN
    flat = [torch.empty((rows,) + tuple(u.shape[2:]), dtype=u.dtype,
                        device=dev) for u in leaves]
    has = torch.empty((rows,), dtype=torch.bool, device=dev)
    all_fills = _deliver_fills(leaves, combine, fills)
    for c0 in range(0, len(classes), K10_MAX_CLASSES):
        part = classes[c0:c0 + K10_MAX_CLASSES]
        nc = len(part)
        cls = ((ctypes.c_void_p * nc)(*[v.data_ptr() for v, _ in part]),
               (ctypes.c_void_p * nc)(*[n.data_ptr() for _, n in part]),
               (ctypes.c_int64 * nc)(*caps[c0:c0 + nc]),
               (ctypes.c_int64 * nc)(*row0[c0:c0 + nc]))
        for _, _, leaf_args in _deliver_groups(leaves, flat, all_fills):
            rc = fn(nc, *cls, N, uk.data_ptr(), n_unique.data_ptr(), cap_u,
                    *leaf_args, has.data_ptr(), _stream())
            _check("pregel_deliver", rc)
    out = []
    for cap, r in zip(caps, row0):
        out.append(([x[r:r + N * cap].view((N, cap) + tuple(x.shape[1:]))
                     for x in flat], has[r:r + N * cap].view(N, cap)))
    return out


# ---------------------------------------------------------------------
# K11 obj_emit_pack
# ---------------------------------------------------------------------
K11_TILE = 2048            # K11_TILE of csrc/obj_emit_pack.cu
K11_MAX_BLOCKS = 48        # K11_MAX_BLOCKS: 24 classes, mail and no-mail


def _emit_width(counts):
    """The packed width of K11's outputs: the fine capacity class of the
    largest shard's count (read with one host sync)."""
    from dpark_tpu_torch.backend.cuda.layout import round_capacity_fine
    return round_capacity_fine(int(counts.max().item()))


def _emit_tail(dst, leaves, counts):
    """Past counts[s]: the sentinel in dst, zeros in the leaves."""
    cap_out = dst.shape[1]
    tail = torch.arange(cap_out, device=dst.device)[None, :] \
        >= counts[:, None].long()
    dst = torch.where(tail, KEY_SENTINEL, dst)
    out = []
    for leaf in leaves:
        t = tail.view(tail.shape + (1,) * (leaf.dim() - 2))
        out.append(torch.where(t, torch.zeros((), dtype=leaf.dtype,
                                               device=leaf.device), leaf))
    return dst, out


def obj_emit_pack_plain(blocks):
    N = blocks[0][0].shape[0]
    nl = len(blocks[0][2])
    dsts = [torch.where(gate[:, :, None], dst, KEY_SENTINEL).reshape(N, -1)
            for gate, dst, _ in blocks]
    vals = [torch.cat([lv[li].reshape((N, -1) + tuple(lv[li].shape[3:]))
                       for _, _, lv in blocks], 1) for li in range(nl)]
    dst_flat = torch.cat(dsts, 1)
    keep = dst_flat != KEY_SENTINEL
    # collectives.compact on the plain path: a two-bucket stable partition
    packed, _, _ = stable_partition_plain((~keep).to(torch.int32), 2,
                                          [dst_flat] + vals)
    counts = keep.sum(1).to(torch.int32)
    cap_out = _emit_width(counts)
    width = packed[0].shape[1]
    if cap_out > width:
        packed = [torch.cat([p, torch.zeros(
            (N, cap_out - width) + tuple(p.shape[2:]), dtype=p.dtype,
            device=p.device)], 1) for p in packed]
    packed = [p[:, :cap_out].contiguous() for p in packed]
    dst, leaves = _emit_tail(packed[0], packed[1:], counts)
    return dst, leaves, counts


def obj_emit_pack(blocks):
    """Pack one superstep's emitted messages.  `blocks` is a list of
    (gate (N, cap) bool, dst (N, cap, m) int64, [leaf (N, cap, m, ...)])
    emission blocks, in order; every block carries the same message
    leaves (dtypes and trailing shapes).  Each shard's slots with
    gate[s, i] and dst[s, i, j] != the sentinel are packed in (block, i,
    j) order to the front of (N, cap_out) outputs, cap_out the fine
    capacity class of the largest shard's count; the tails hold the
    sentinel (dst) and zeros (leaves).  Returns (dst, leaves, counts (N,)
    int32)."""
    blocks = [(g, d, list(lv)) for g, d, lv in blocks]
    _need(len(blocks) >= 1, "at least one emission block")
    N = blocks[0][0].shape[0]
    nl = len(blocks[0][2])
    _need(nl <= MAX_LEAVES, "at most %d message leaves" % MAX_LEAVES)
    spec = [(leaf.dtype, leaf.shape[3:]) for leaf in blocks[0][2]]
    # one pass over the blocks: the checks, and the kernels' arguments
    # (this wrapper's host time is most of a call's)
    devs, gates, dsts, caps, ms, src = set(), [], [], [], [], []
    for gate, dst, lv in blocks:
        gs, ds = gate.shape, dst.shape
        _need(gate.dtype == torch.bool and len(gs) == 2 and gs[0] == N
              and gate.is_contiguous(),
              "each gate must be a contiguous (N, cap) bool tensor")
        _need(dst.dtype == torch.int64 and len(ds) == 3 and ds[0] == N
              and ds[1] == gs[1] and dst.is_contiguous(),
              "each dst must be a contiguous (N, cap, m) int64 tensor")
        _need(len(lv) == nl and all(
            leaf.shape[:3] == ds and (leaf.dtype, leaf.shape[3:]) == sp
            and leaf.is_contiguous() for leaf, sp in zip(lv, spec)),
            "each block's message leaves must be contiguous (N, cap, m, "
            "...) tensors of the first block's dtypes and shapes")
        devs.update([gate.device, dst.device] + [x.device for x in lv])
        gates.append(gate.data_ptr())
        dsts.append(dst.data_ptr())
        caps.append(ds[1])
        ms.append(ds[2])
        src += [x.data_ptr() for x in lv]
    _need(len(devs) == 1, "tensors on several devices: %s" % devs)
    dev = devs.pop()
    if dev.type == "cpu":
        return obj_emit_pack_plain(blocks)
    _need(dev.type == "cuda", "unsupported device %s" % dev)
    nb = len(blocks)
    _need(nb <= K11_MAX_BLOCKS, "at most %d emission blocks" % K11_MAX_BLOCKS)
    count_fn, scatter_fn = _kernel("obj_emit_pack")
    first = [0]
    for cap, m in zip(caps, ms):
        _need(cap * m < 2 ** 31 - K11_TILE,
              "an emission block takes below 2**31 slots a shard")
        first.append(first[-1] + -(-cap * m // K11_TILE))
    tiles = first[-1]
    # the descriptors go to both kernels by value: nothing is copied to
    # the device, and nothing after the host read
    ptrs, i64 = ctypes.c_void_p * nb, ctypes.c_int64 * nb
    desc = (nb, ptrs(*gates), ptrs(*dsts), i64(*caps), i64(*ms),
            (ctypes.c_int64 * (nb + 1))(*first))
    # everything but the outputs is made before the host read, so that
    # the card waits for the host as little as it can
    src = (ctypes.c_void_p * max(1, len(src)))(*src)
    lb = (ctypes.c_int64 * max(1, nl))(*[
        leaf.element_size() * math.prod(leaf.shape[3:])
        for leaf in blocks[0][2]])
    tileoff = torch.empty((N, max(1, tiles)), dtype=torch.int32, device=dev)
    counts = torch.empty((N,), dtype=torch.int32, device=dev)
    _check("obj_emit_pack", count_fn(*desc, N, tileoff.data_ptr(),
                                     counts.data_ptr(), _stream()),
           count=False)
    host = counts.cpu()
    cap_out = _emit_width(host)
    fill_tiles = -(-(cap_out - int(host.min())) // K11_TILE)
    dst_out = torch.empty((N, cap_out), dtype=torch.int64, device=dev)
    leaves = [torch.empty((N, cap_out) + shp, dtype=dt, device=dev)
              for dt, shp in spec]
    rc = scatter_fn(*desc, src, nl, N, tileoff.data_ptr(),
                    counts.data_ptr(), cap_out, fill_tiles,
                    dst_out.data_ptr(), _ptrs(leaves), lb, _stream())
    _check("obj_emit_pack", rc)
    return dst_out, leaves, counts


# ---------------------------------------------------------------------
# K12 join_ranges / join_expand
# ---------------------------------------------------------------------
_JOIN_KEY_KINDS = {torch.int32: 0, torch.int64: 1, torch.float64: 2}
JOIN_MAX_KEYS = 4
_K12_TILE = 2048      # K12_TILE of csrc/join_expand.cu (256 x 8): the A
                      # rows of a tile; the wrapper sizes the status words
                      # by it


def _order_key(col):
    """A signed int64 column ordered as K5 orders `col` (its radix key
    image with the top bit flipped back): ints by value, float64 with
    -0.0 equal to +0.0 and every NaN one value past +inf."""
    return radix_key_image(col)[0] ^ _I64_MIN


def join_ranges_plain(a_keys, a_n, b_keys, b_n):
    from dpark_tpu_torch.backend.cuda.collectives import lex_searchsorted
    N, cap_a = a_keys[0].shape
    dev = a_keys[0].device
    qa = [_order_key(k) for k in a_keys]
    qb = [_order_key(k) for k in b_keys]
    lo = torch.zeros((N, cap_a), dtype=torch.int64, device=dev)
    hi = torch.zeros_like(lo)
    for s, nb in enumerate(b_n.tolist()):
        sorted_cols = [c[s, :nb] for c in qb]
        query = [c[s] for c in qa]
        lo[s] = lex_searchsorted(sorted_cols, query, "left")
        hi[s] = lex_searchsorted(sorted_cols, query, "right")
    valid = torch.arange(cap_a, device=dev)[None, :] < a_n[:, None].long()
    lo = torch.where(valid, lo, 0)
    per = torch.where(valid, hi - lo, 0)
    offs = torch.cumsum(per, 1) - per
    return lo, per, offs, per.sum(1)


def _check_join_keys(a_keys, a_n, b_keys, b_n):
    nk = len(a_keys)
    _need(1 <= nk <= JOIN_MAX_KEYS and len(b_keys) == nk,
          "1 to %d key columns on each side, the same count"
          % JOIN_MAX_KEYS)
    N, cap_a = a_keys[0].shape[:2]
    _need(b_keys[0].dim() == 2 and b_keys[0].shape[0] == N,
          "both sides need the same shard count")
    cap_b = b_keys[0].shape[1]
    _check_cols(a_keys, N, cap_a, "side A's key columns")
    _check_cols(b_keys, N, cap_b, "side B's key columns")
    _need(all(a.dim() == 2 and a.dtype in _JOIN_KEY_KINDS
              and a.dtype == b.dtype for a, b in zip(a_keys, b_keys)),
          "key columns must be (N, cap) int32/int64/float64, the same "
          "dtype on both sides")
    _need(a_n.dtype == torch.int32 and a_n.shape == (N,)
          and b_n.dtype == torch.int32 and b_n.shape == (N,),
          "a_n and b_n must be (N,) int32")
    return N, cap_a, cap_b


def join_ranges(a_keys, a_n, b_keys, b_n):
    """Each valid A row's range of equal keys among B's valid rows.  Both
    sides are key-sorted per shard in K5's order: a_keys / b_keys are the
    nk <= 4 key columns ((N, cap_a) / (N, cap_b), one dtype per column on
    both sides), a_n / b_n ((N,) int32) the valid rows.  Compared
    lexicographically in K5's order (-0.0 equals +0.0).  Returns (lo,
    per, offs (N, cap_a) int64: the first equal B row, the count of equal
    B rows, 0 past a_n[s], and per's exclusive prefix sum; totals (N,)
    int64: per's row sums)."""
    a_keys, b_keys = list(a_keys), list(b_keys)
    N, cap_a, cap_b = _check_join_keys(a_keys, a_n, b_keys, b_n)
    if not _on_cuda(a_keys + b_keys + [a_n, b_n]):
        return join_ranges_plain(a_keys, a_n, b_keys, b_n)
    ranges_fn, _ = _kernel("join_expand")
    dev = a_keys[0].device
    nk = len(a_keys)
    lo = torch.empty((N, cap_a), dtype=torch.int64, device=dev)
    per = torch.empty_like(lo)
    offs = torch.empty_like(lo)
    # totals, then the status words and the tile counter (zeroed by the
    # entry)
    scratch = torch.empty((N + N * -(-cap_a // _K12_TILE) + 1,),
                          dtype=torch.int64, device=dev)
    totals = scratch[:N]
    rc = ranges_fn(_ptrs(a_keys), _ptrs(b_keys), (ctypes.c_int * nk)(
        *[_JOIN_KEY_KINDS[k.dtype] for k in a_keys]), nk, N, cap_a, cap_b,
        a_n.data_ptr(), b_n.data_ptr(), lo.data_ptr(), per.data_ptr(),
        offs.data_ptr(), totals.data_ptr(), scratch[N:].data_ptr(),
        _stream())
    _check("join_ranges", rc)
    return lo, per, offs, totals


def _join_sentinel(dtype):
    return float("inf") if dtype.is_floating_point else \
        torch.iinfo(dtype).max


def join_expand_plain(a_leaves, b_vals, lo, per, offs, totals, a_n,
                      cap_out):
    N, cap_a = a_leaves[0].shape[:2]
    cap_b = b_vals[0].shape[1]
    dev = a_leaves[0].device
    t = torch.arange(cap_out, device=dev).expand(N, cap_out).contiguous()
    i = torch.searchsorted((offs + per).contiguous(), t, right=True)
    i = i.clamp_(max=cap_a - 1)
    j = t - torch.gather(offs, 1, i)
    bi = (torch.gather(lo, 1, i) + j).clamp_(0, cap_b - 1)
    pad = t >= totals[:, None]
    out = [shard_rows(x, i) for x in a_leaves] + \
        [shard_rows(x, bi) for x in b_vals]
    res = []
    for k, x in enumerate(out):
        fill = _join_sentinel(x.dtype) if k == 0 else 0
        p = pad.view(pad.shape + (1,) * (x.dim() - 2))
        res.append(torch.where(p, torch.full((), fill, dtype=x.dtype,
                                             device=dev), x).contiguous())
    return res


def join_expand(a_leaves, b_vals, lo, per, offs, totals, a_n, cap_out):
    """The joined rows of each shard, from join_ranges' (lo, per, offs,
    totals): output slot t < totals[s] of shard s takes every A leaf
    (a_leaves: key columns first, then A's values, (N, cap_a, ...)) at
    the A row i whose [offs[i], offs[i] + per[i]) holds t, and B's value
    leaves (b_vals, (N, cap_b, ...)) at row lo[i] + t - offs[i].  Slots
    past totals[s] hold the key sentinel in the first leaf (key column 0)
    and zeros in every other leaf.  Returns the (N, cap_out, ...) leaves,
    A's then B's values."""
    a_leaves, b_vals = list(a_leaves), list(b_vals)
    N, cap_a = a_leaves[0].shape[:2]
    _need(len(b_vals) >= 1 and len(a_leaves) + len(b_vals) <= MAX_LEAVES,
          "at least one B value leaf and at most %d leaves in all"
          % MAX_LEAVES)
    cap_b = b_vals[0].shape[1]
    _check_cols(a_leaves, N, cap_a, "side A's leaves")
    _check_cols(b_vals, N, cap_b, "side B's value leaves")
    _need(a_leaves[0].dim() == 2
          and a_leaves[0].dtype in _JOIN_KEY_KINDS,
          "the first A leaf is key column 0: (N, cap_a) int32/int64/"
          "float64")
    for x in (lo, per, offs):
        _need(x.dtype == torch.int64 and x.shape == (N, cap_a)
              and x.is_contiguous(), "lo, per and offs must be (N, cap_a) "
              "contiguous int64")
    _need(totals.dtype == torch.int64 and totals.shape == (N,)
          and a_n.dtype == torch.int32 and a_n.shape == (N,),
          "totals must be (N,) int64, a_n (N,) int32")
    _need(cap_out >= 1, "cap_out must be positive")
    if not _on_cuda(a_leaves + b_vals + [lo, per, offs, totals, a_n]):
        return join_expand_plain(a_leaves, b_vals, lo, per, offs, totals,
                                 a_n, cap_out)
    _, expand_fn = _kernel("join_expand")
    dev = a_leaves[0].device
    src = a_leaves + b_vals
    out = [torch.empty((N, cap_out) + tuple(x.shape[2:]), dtype=x.dtype,
                       device=dev) for x in src]
    desc = torch.tensor([x.data_ptr() for x in src]
                        + [x.data_ptr() for x in out]
                        + [_row_bytes(x) for x in src],
                        dtype=torch.int64).to(dev)
    bits, width = _elem_bits(_join_sentinel(a_leaves[0].dtype),
                             a_leaves[0].dtype)
    rc = expand_fn(desc.data_ptr(), len(a_leaves), len(src), N, cap_a,
                   cap_b, cap_out, a_n.data_ptr(), lo.data_ptr(),
                   offs.data_ptr(), totals.data_ptr(), bits, width,
                   _stream())
    _check("join_expand", rc)
    return out


# ---------------------------------------------------------------------
# K13 rid_fold
# ---------------------------------------------------------------------
def rid_fold_plain(rid, n, n_dst):
    cap = rid.shape[1]
    valid = torch.arange(cap, device=rid.device)[None, :] < n[:, None].long()
    dev = torch.where(valid, rid % n_dst, n_dst).to(torch.int32)
    rid64 = torch.where(valid, rid.long(),
                        torch.full((), KEY_SENTINEL, dtype=torch.int64,
                                   device=rid.device))
    return dev, rid64, shard_bincount(dev, n_dst + 1)


def rid_fold(rid, n, n_dst):
    """The spilled-run stream's fold of each row's logical partition
    (rid: (N, cap) int32 in [0, r) on the first n[s] rows of shard s)
    onto the n_dst shards.  Returns (dev (N, cap) int32: rid % n_dst,
    n_dst on padding; rid64 (N, cap) int64: rid, KEY_SENTINEL on
    padding; hist (N, n_dst + 1) int32: each shard's count of dev)."""
    N, cap = rid.shape
    _need(rid.dtype == torch.int32 and rid.is_contiguous(),
          "rid must be a contiguous (N, cap) int32 tensor")
    _need(n.dtype == torch.int32 and n.shape == (N,), "n must be (N,) int32")
    _need(n_dst >= 1, "n_dst must be positive")
    if not _on_cuda([rid, n]):
        return rid_fold_plain(rid, n, n_dst)
    fn = _kernel("rid_fold")
    dev_ = rid.device
    dev = torch.empty((N, cap), dtype=torch.int32, device=dev_)
    rid64 = torch.empty((N, cap), dtype=torch.int64, device=dev_)
    hist = torch.zeros((N, n_dst + 1), dtype=torch.int32, device=dev_)
    if cap == 0:
        return dev, rid64, hist
    rc = fn(rid.data_ptr(), n.data_ptr(), N, cap, int(n_dst),
            dev.data_ptr(), rid64.data_ptr(), hist.data_ptr(), _stream())
    _check("rid_fold", rc)
    return dev, rid64, hist


# ---------------------------------------------------------------------
# K14 segmented_merge
# ---------------------------------------------------------------------
K14_TILE = 8192               # K14_TILE of csrc/segmented_merge.cuh
K14_NARROW_SLOTS = 6          # the slots libsegmented_merge takes
_K14_TYPES = {torch.int64: 0, torch.int32: 1, torch.float64: 2,
              torch.float32: 3, torch.bool: 4}


def segmented_scan(starts, val_leaves, merge_leaves):
    """Inclusive segmented scan per shard: scanned[i] = the merge over its
    run's values from the run start through i, as log2(cap) Hillis-Steele
    steps of merge_leaves (leaf lists of rows -> merged leaf lists), each
    result cast to its leaf's dtype."""
    vals = list(val_leaves)
    N, cap = starts.shape
    idx = torch.arange(cap, device=starts.device)
    f = starts.clone()
    d = 1
    while d < cap:
        prev = [torch.cat([v[:, :d], v[:, :-d]], 1) for v in vals]
        flat = lambda xs: [x.reshape((N * cap,) + tuple(x.shape[2:]))
                           for x in xs]
        merged = merge_leaves(flat(prev), flat(vals))
        upd = (~f) & (idx[None, :] >= d)
        new = []
        for v, m in zip(vals, merged):
            m = m.reshape(v.shape).to(v.dtype)
            u = upd.view(upd.shape + (1,) * (v.dim() - 2))
            new.append(torch.where(u, m, v))
        vals = new
        fprev = torch.cat([f[:, :d], f[:, :-d]], 1)
        f = f | (fprev & (idx[None, :] >= d))
        d *= 2
    return vals


def segmented_merge_plain(starts, n, leaves, program):
    """The Hillis-Steele scan of segmented_scan with the program evaluated
    in torch in place of the user merge: every row holds its run's merge
    through it (rows >= n[s] included; nothing reads them)."""
    return segmented_scan(starts, leaves, program.merge_leaves)


def _k14_scratch_bytes(N, cap, S):
    """dpk_segmented_merge_scratch: each tile of K14_TILE rows holds 2S + 1
    int64 words (its last run's fold, its head run's fold and end row) and
    a flag byte (8-byte aligned)."""
    nt = N * -(-cap // K14_TILE)
    return nt * (2 * S + 1) * 8 + -(-nt // 8) * 8


def segmented_merge(starts, n, leaves, program):
    """K14: over key-sorted rows ((N, cap) bool run starts, row 0 always
    a start; the first n[s] rows of shard s valid) and the value leaves
    (N, cap, ...) that `program` (merge_program.Program) was lowered for,
    each run's last valid row of the returned leaves holds the run's
    values merged left to right in row order, in the leaf's dtype (the
    association fixed by the tiling: the same bits every run).  A
    lane-separable program (Program.separable_ops) folds each slot with
    its op; any other runs the interpreter, its registers in shared
    memory.  Other
    rows are unspecified (the plain version fills them with the running
    merge).  Returns the merged leaves."""
    leaves = list(leaves)
    N, cap = starts.shape
    _need(starts.dtype == torch.bool and starts.is_contiguous(),
          "starts must be a contiguous (N, cap) bool tensor")
    _check_cols(leaves, N, cap, "value leaves")
    _need(n.dtype == torch.int32 and n.shape == (N,), "n must be (N,) int32")
    _need([(v.dtype, tuple(v.shape[2:])) for v in leaves] == [
        (dt, tuple(shp)) for dt, shp in program.specs],
          "the leaves are not those the program was lowered for")
    if not _on_cuda([starts, n] + leaves):
        return segmented_merge_plain(starts, n, leaves, program)
    dev = starts.device
    outs = [torch.empty_like(v) for v in leaves]
    if cap == 0:
        return outs
    ins, ptrs, types, strides = [], [], [], []
    for v, o in zip(leaves, outs):
        w = _lanes(v)
        for k in range(w):
            ins.append(v.data_ptr() + k * v.element_size())
            ptrs.append(o.data_ptr() + k * o.element_size())
            types.append(_K14_TYPES[v.dtype])
            strides.append(w)
    S = len(ins)
    fn = _kernel("segmented_merge" if S <= K14_NARROW_SLOTS
                 else "segmented_merge_wide")
    sep = program.separable_ops()
    nbytes = _k14_scratch_bytes(N, cap, S)
    scratch = torch.empty((max(8, nbytes),), dtype=torch.uint8, device=dev)
    rc = fn((ctypes.c_void_p * S)(*ins), (ctypes.c_void_p * S)(*ptrs),
            (ctypes.c_int * S)(*types), (ctypes.c_int64 * S)(*strides), S,
            program.device_words(dev).data_ptr(), program.nregs,
            None if sep is None else (ctypes.c_int * (2 * S))(
                *[x for op in sep for x in op]),
            starts.data_ptr(), n.data_ptr(), N, cap,
            scratch.data_ptr(), nbytes, _stream())
    _check("segmented_merge", rc)
    return outs


# ---------------------------------------------------------------------
# K15 column_ranges
# ---------------------------------------------------------------------
_RANGE_TYPES = (torch.int64, torch.int32)


def _range_init(cols, N, device):
    """(L, N, 2) int64 holding each column dtype's (max, min): the
    result of a shard with no valid row."""
    out = torch.empty((len(cols), N, 2), dtype=torch.int64, device=device)
    for li, c in enumerate(cols):
        info = torch.iinfo(c.dtype)
        out[li, :, 0] = info.max
        out[li, :, 1] = info.min
    return out


def column_ranges_plain(cols, n):
    N = n.shape[0]
    out = _range_init(cols, N, n.device)
    for li, c in enumerate(cols):
        cap = c.shape[1]
        if not cap:
            continue
        info = torch.iinfo(c.dtype)
        valid = (torch.arange(cap, device=c.device)[None, :]
                 < n[:, None].long())
        out[li, :, 0] = torch.where(valid, c, info.max).amin(1)
        out[li, :, 1] = torch.where(valid, c, info.min).amax(1)
    return out


def column_ranges(cols, n):
    """B14's masked min/max: for each (N, cap) int64 or int32 column of
    `cols` (all of one shape), the (min, max) over each shard's valid rows
    [0, n[s]), as an (L, N, 2) int64 tensor; a shard with no valid row
    holds the dtype's (max, min).  Rows past n[s] (padding, the key
    sentinel) are never read.  One launch per MAX_LEAVES columns."""
    _need(len(cols) >= 1, "column_ranges needs at least one column")
    N, cap = cols[0].shape[:2]
    _check_cols(cols, N, cap, "columns")
    _need(all(c.dim() == 2 and c.dtype in _RANGE_TYPES for c in cols),
          "columns must be (N, cap) int64 or int32 tensors")
    _need(n.dtype == torch.int32 and n.shape == (N,), "n must be (N,) int32")
    if not _on_cuda(list(cols) + [n]):
        return column_ranges_plain(cols, n)
    fn = _kernel("column_ranges")
    out = _range_init(cols, N, n.device)
    if cap == 0:
        return out
    for g in range(0, len(cols), MAX_LEAVES):
        group = cols[g:g + MAX_LEAVES]
        widths = (ctypes.c_int * len(group))(
            *[c.element_size() for c in group])
        rc = fn(_ptrs(group), widths, len(group), n.data_ptr(), N, cap,
                out[g:].data_ptr(), _stream())
        _check("column_ranges", rc)
    return out


# ---------------------------------------------------------------------
# K16 union_concat
# ---------------------------------------------------------------------
def _union_sizes(counts):
    """(host (k, N) int64 counts, per-shard totals, cap_out) from ONE
    host read of all k count vectors."""
    from dpark_tpu_torch.backend.cuda.layout import round_capacity
    host = torch.stack([c.to(torch.int64) for c in counts]).cpu()
    totals = host.sum(0)
    return host, totals, round_capacity(int(totals.max().item()) or 1)


def union_concat_plain(branches, key_leaf=0, key_fill=KEY_SENTINEL):
    host, totals, cap_out = _union_sizes([n for _, n in branches])
    lv0 = branches[0][0]
    N = lv0[0].shape[0]
    dev = lv0[0].device
    counts = host.to(dev)
    caps = [lv[0].shape[1] for lv, _ in branches]
    # output row i of shard s reads branch j = #(branch ends <= i), row
    # i - start_j, at column base_j + that row of the branches side by side
    ends = torch.cumsum(counts, 0)                          # (k, N)
    starts = ends - counts
    base = torch.tensor([0] + caps[:-1], device=dev).cumsum(0)
    i = torch.arange(cap_out, device=dev)
    j = torch.searchsorted(ends.t().contiguous(),
                           i.expand(N, cap_out).contiguous(), right=True)
    valid = i[None, :] < totals.to(dev)[:, None]
    jc = torch.clamp(j, max=len(branches) - 1)
    col = (base[jc] + i[None, :]
           - torch.gather(starts.t(), 1, jc))
    col = torch.where(valid, col, 0)
    out = []
    for li in range(len(lv0)):
        fill = key_fill if li == key_leaf else 0
        side = torch.cat([lv[li] for lv, _ in branches], 1)
        idx = col.view(col.shape + (1,) * (side.dim() - 2)).expand(
            (N, cap_out) + tuple(side.shape[2:]))
        g = torch.gather(side, 1, idx)
        vmask = valid.view(valid.shape + (1,) * (g.dim() - 2))
        out.append(torch.where(vmask, g, torch.full(
            (), fill, dtype=g.dtype, device=dev)))
    return out, totals.to(torch.int32).to(dev)


def _union_cap_out(counts):
    """K16's one host read of all k count vectors: cap_out, the
    power-of-two class of the largest per-shard total."""
    from dpark_tpu_torch.backend.cuda.layout import round_capacity
    hc = torch.stack(counts).cpu().tolist()
    return round_capacity(max(map(sum, zip(*hc)), default=0) or 1)


def union_concat(branches, key_leaf=0, key_fill=KEY_SENTINEL):
    """The device union's concatenation.  `branches` is a list of k (<=
    MAX_UNION_BRANCHES) (leaves, n) pairs with the same leaves (dtypes and
    trailing shapes); each leaf is a contiguous (N, cap_j, ...) tensor and
    n the (N,) int32 counts.  Per shard, branch 0's first n rows, then
    branch 1's, ... are packed to the front of (N, cap_out, ...) leaves,
    cap_out the power-of-two class of the largest total (one host read of
    all k count vectors); past each shard's total the key leaf holds
    `key_fill` (the sentinel, as K4's receive padding; key_leaf None: no
    key leaf) and the other leaves 0.  Returns (leaves, totals (N,)
    int32)."""
    branches = [(list(lv), n) for lv, n in branches]
    _need(1 <= len(branches) <= MAX_UNION_BRANCHES,
          "1..%d union branches" % MAX_UNION_BRANCHES)
    lv0 = branches[0][0]
    N = lv0[0].shape[0]
    nl = len(lv0)
    _need(1 <= nl <= MAX_LEAVES, "1..%d leaves" % MAX_LEAVES)
    spec = [(leaf.dtype, leaf.shape[2:]) for leaf in lv0]
    dev = lv0[0].device
    # one pass over the branches (this wrapper's host time is most of a
    # small union's call)
    for lv, n in branches:
        _need(len(lv) == nl and all(
            leaf.dtype == dt and leaf.shape[2:] == shp
            for leaf, (dt, shp) in zip(lv, spec)),
            "every branch must carry the first branch's leaves")
        lead = (N, lv[0].shape[1])
        _need(all(leaf.shape[:2] == lead and leaf.is_contiguous()
                  for leaf in lv),
              "branch leaves must be contiguous (N, cap, ...) tensors")
        _need(n.dtype == torch.int32 and n.shape == (N,),
              "branch counts must be (N,) int32")
        _need(n.device == dev and all(leaf.device == dev for leaf in lv),
              "branch tensors on several devices")
    _need(key_leaf is None or (lv0[key_leaf].dim() == 2 and lv0[
        key_leaf].dtype in (torch.int64, torch.int32, torch.float64)),
          "the key leaf must be an int32/int64/float64 (N, cap) column")
    if dev.type == "cpu":
        return union_concat_plain(branches, key_leaf, key_fill)
    _need(dev.type == "cuda", "unsupported device %s" % dev)
    fn = _kernel("union_concat")
    # the launch's arguments but the outputs are made before the host
    # read, so that the card waits for the host as little as it can
    k = len(branches)
    counts = [n for _, n in branches]
    args = (_ptrs([leaf for lv, _ in branches for leaf in lv]), k,
            _ptrs(counts), (ctypes.c_int64 * k)(*[lv[0].shape[1]
                                                  for lv, _ in branches]),
            N)
    row_bytes = (ctypes.c_int64 * nl)(*[_row_bytes(x) for x in lv0])
    fill_bits = 0
    if key_leaf is not None:
        fill_bits = _fill_bits(key_fill, lv0[key_leaf].dtype)[0]
    totals = torch.empty((N,), dtype=torch.int32, device=dev)
    cap_out = _union_cap_out(counts)
    out = [torch.empty((N, cap_out) + shp, dtype=dt, device=dev)
           for dt, shp in spec]
    rc = fn(*args, cap_out, _ptrs(out), row_bytes, nl,
            -1 if key_leaf is None else int(key_leaf), fill_bits,
            totals.data_ptr(), _stream())
    _check("union_concat", rc)
    return out, totals


# ---------------------------------------------------------------------
# K17 monoid_reduce (with distinct_key_counts)
# ---------------------------------------------------------------------
_K17_KINDS = {torch.int64: 0, torch.int32: 1, torch.bool: 2,
              torch.float64: 3, torch.float32: 4}
_K17_KEY_KINDS = {torch.int64: 0, torch.int32: 1, torch.float64: 2,
                  torch.float32: 3}
# blocks in flight over all shards: 132 SMs x 8 blocks of 256 threads
_K17_BLOCKS = 1056
_K17_PART_BYTES = 24          # (reduction, min, max) a block, 8 B each
_REDUCE = {"add": torch.sum, "min": torch.amin, "max": torch.amax,
           "mul": torch.prod}


def monoid_out_dtype(op, dtype):
    """The reduction's dtype: int64 for an integer or bool add or mul (a
    bool add is a count), the column's otherwise (torch's promotion)."""
    if op in ("add", "mul") and not dtype.is_floating_point:
        return torch.int64
    return dtype


def monoid_identity_of(op, dtype):
    """identity() with bools: False (add, max), True (mul, min)."""
    if dtype == torch.bool:
        return op in ("mul", "min")
    return identity(op, dtype)


def monoid_reduce_plain(col, n, op):
    N, cap = col.shape[:2]
    valid = torch.arange(cap, device=col.device)[None, :] < n[:, None]
    valid = valid.view(valid.shape + (1,) * (col.dim() - 2))

    def masked(kind):
        m = torch.where(valid, col, monoid_identity_of(kind, col.dtype))
        return m.reshape(N, -1)
    if col[0].numel() == 0:
        return tuple(torch.full((N,), monoid_identity_of(k, col.dtype),
                                dtype=dt, device=col.device)
                     for k, dt in ((op, monoid_out_dtype(op, col.dtype)),
                                   ("min", col.dtype), ("max", col.dtype)))
    return (_REDUCE[op](masked(op), 1).to(monoid_out_dtype(op, col.dtype)),
            masked("min").amin(1), masked("max").amax(1))


def monoid_reduce(col, n, op):
    """B9's masked per-shard monoid reduction: for each shard s of a
    contiguous (N, cap, ...) column of int64, int32, bool, float64 or
    float32, over its first n[s] rows and every trailing lane, the
    reduction by `op` ("add", "min", "max" or "mul"), the min and the
    max; an empty shard gives the identities (bool: add and max False,
    mul and min True).  Returns (reduction, min, max), each (N,): the
    reduction int64 for an integer or bool add or mul (a bool add is a
    count), the column's dtype otherwise; min and max in the column's
    dtype.  Rows past n[s] are never read.  A bool column takes the count
    (k17_bool: one launch, the results from the count)."""
    _need(op in _REDUCE, "op must be add, min, max or mul, got %r" % (op,))
    _need(col.dim() >= 2 and col.is_contiguous()
          and col.dtype in _K17_KINDS,
          "the column must be a contiguous (N, cap, ...) int64, int32, "
          "bool, float64 or float32 tensor, got %s %s"
          % (col.dtype, tuple(col.shape)))
    N, cap = col.shape[:2]
    _need(n.dtype == torch.int32 and n.shape == (N,), "n must be (N,) int32")
    if not _on_cuda([col, n]):
        return monoid_reduce_plain(col, n, op)
    lanes = _lanes(col)
    dev = col.device
    red = torch.empty(N, dtype=monoid_out_dtype(op, col.dtype), device=dev)
    lo = torch.empty(N, dtype=col.dtype, device=dev)
    hi = torch.empty(N, dtype=col.dtype, device=dev)
    if col.dtype == torch.bool:
        part = torch.empty((N, 2), dtype=torch.int64, device=dev)
        rc = _kernel("monoid_reduce")[3](
            col.data_ptr(), lanes, n.data_ptr(), N, cap, OPS[op],
            red.data_ptr(), lo.data_ptr(), hi.data_ptr(), part.data_ptr(),
            _stream())
        _check("monoid_reduce", rc)
        return red, lo, hi
    fn = _kernel("monoid_reduce")[0]
    vecs = -(-cap * lanes * col.element_size() // 16)
    blocks = max(1, min(-(-vecs // (256 * 4)), _K17_BLOCKS // N))
    scratch = torch.empty(N * blocks * _K17_PART_BYTES, dtype=torch.uint8,
                          device=dev)
    rc = fn(col.data_ptr(), _K17_KINDS[col.dtype], lanes, n.data_ptr(), N,
            cap, OPS[op], red.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            scratch.data_ptr(), blocks, _stream())
    _check("monoid_reduce", rc)
    return red, lo, hi


K17C_MAX_CLASSES = 32     # K17C_MAX_CLASSES of csrc/monoid_reduce.cu


def active_count_plain(masks, ns):
    total = torch.zeros((), dtype=torch.int64, device=masks[0].device)
    for m, n in zip(masks, ns):
        total = total + monoid_reduce_plain(m, n, "add")[0].sum()
    return total


def active_count(masks, ns):
    """The True elements among each shard's first ns[c][s] rows of every
    (N, cap_c, ...) bool mask, summed over shards and masks: a 0-dim
    int64 tensor on the masks' device (the Pregel active count, and the
    object Bagel's over its degree classes).  One launch for up to
    K17C_MAX_CLASSES masks; more go in as many launches as they need."""
    masks, ns = list(masks), list(ns)
    _need(len(masks) >= 1 and len(ns) == len(masks),
          "one or more masks, each with its valid rows")
    N = masks[0].shape[0]
    for m, n in zip(masks, ns):
        _need(m.dtype == torch.bool and m.dim() >= 2 and m.is_contiguous()
              and m.shape[0] == N,
              "masks must be contiguous (N, cap, ...) bool tensors, got "
              "%s %s" % (m.dtype, tuple(m.shape)))
        _need(n.dtype == torch.int32 and n.shape == (N,),
              "n must be (N,) int32")
    if not _on_cuda(masks + ns):
        return active_count_plain(masks, ns)
    fn = _kernel("monoid_reduce")[2]
    out = torch.empty((), dtype=torch.int64, device=masks[0].device)
    for c0 in range(0, len(masks), K17C_MAX_CLASSES):
        ms = masks[c0:c0 + K17C_MAX_CLASSES]
        k = len(ms)
        rc = fn(k, _ptrs(ms), _ptrs(ns[c0:c0 + k]),
                (ctypes.c_int64 * k)(*[m.shape[1] for m in ms]),
                (ctypes.c_int64 * k)(*[_lanes(m) for m in ms]), N,
                int(c0 == 0), out.data_ptr(), _stream())
        _check("active_count", rc)
    return out


def distinct_key_counts_plain(key_cols, n):
    N, cap = key_cols[0].shape[:2]
    dev = key_cols[0].device
    start = torch.zeros((N, cap), dtype=torch.bool, device=dev)
    start[:, :1] = True
    for c in key_cols:
        start[:, 1:] |= c[:, 1:] != c[:, :-1]
    valid = torch.arange(cap, device=dev)[None, :] < n[:, None]
    return (start & valid).sum(1)


def distinct_key_counts(key_cols, n):
    """The distinct keys of each key-sorted shard: the rows j < n[s]
    where any of the (N, cap) key columns (int64, int32, float64 or
    float32; at most MAX_KEYS) differs from row j - 1, row 0 counting;
    (N,) int64."""
    _need(1 <= len(key_cols) <= MAX_KEYS, "1..%d key columns" % MAX_KEYS)
    N, cap = key_cols[0].shape[:2]
    _check_cols(key_cols, N, cap, "key columns")
    _need(all(c.dim() == 2 and c.dtype in _K17_KEY_KINDS
              for c in key_cols),
          "key columns must be (N, cap) int64, int32, float64 or float32")
    _need(n.dtype == torch.int32 and n.shape == (N,), "n must be (N,) int32")
    if not _on_cuda(list(key_cols) + [n]):
        return distinct_key_counts_plain(key_cols, n)
    fn = _kernel("monoid_reduce")[1]
    out = torch.zeros(N, dtype=torch.int64, device=n.device)
    kinds = (ctypes.c_int * len(key_cols))(
        *[_K17_KEY_KINDS[c.dtype] for c in key_cols])
    rc = fn(_ptrs(key_cols), kinds, len(key_cols), n.data_ptr(), N, cap,
            out.data_ptr(), _stream())
    _check("distinct_key_counts", rc)
    return out


# ---------------------------------------------------------------------
# K18 topk_select
# ---------------------------------------------------------------------
K18_TILE = 131_072            # K18_TILE of csrc/topk_select.cu
K18_MAX_N = 1024
K18_MAX_KEYS = 2
_K18_NONE = 2 ** 31 - 1       # the row of an empty candidate
_I64_MAX = 2 ** 63 - 1


def topk_route(key_cols, n):
    """"K18" when topk_select takes these key columns and n, else why the
    top-n keeps K5 + K2 (decided before any launch)."""
    if n > K18_MAX_N:
        return "n %d above K18's %d" % (n, K18_MAX_N)
    if len(key_cols) > K18_MAX_KEYS:
        return "%d key columns above K18's %d" % (len(key_cols),
                                                   K18_MAX_KEYS)
    bad = [c.dtype for c in key_cols if c.dtype not in _RADIX_KINDS]
    if bad:
        return "key dtype %s outside K18's" % bad[0]
    return "K18"


def topk_image(col, largest):
    """K18's image of a key column (int64 bit patterns of the unsigned
    image): radix_key_image's, every bit inverted for largest-first but a
    NaN's, so that NaN stays last both ways."""
    img, _ = radix_key_image(col)
    if not largest:
        return img
    if col.is_floating_point():
        return torch.where(torch.isnan(col), img, ~img)
    return ~img


def _lex_first(cols, m):
    """The first m of (..., L) rows by the lexicographic order of `cols`
    (int64 columns compared signed, the last one a row index that breaks
    every tie): stable sorts, last column first.  Returns the columns
    gathered, each (..., m)."""
    order = None
    for c in reversed(cols):
        c = c if order is None else torch.gather(c, -1, order)
        o = torch.sort(c, dim=-1, stable=True).indices
        order = o if order is None else torch.gather(order, -1, o)
    order = order[..., :m]
    return [torch.gather(c, -1, order) for c in cols]


def topk_select_plain(key_cols, counts, n, largest, leaves, tile=K18_TILE):
    """K18's arithmetic in torch: the images (topk_image, compared as
    unsigned: flipped to signed order here), each tile's n best (image,
    row) over its valid rows padded with (all ones, _K18_NONE), then each
    shard's n best over its tiles' candidates, and the gather.  `tile`:
    the rows of a tile (K18's; the result is the same for any)."""
    N, cap = key_cols[0].shape
    keep = min(n, cap)
    dev = key_cols[0].device
    tiles = max(1, -(-cap // tile))
    span = tiles * tile
    rows = torch.arange(span, device=dev).expand(N, span)
    valid = rows < counts.long()[:, None]
    keys = [topk_image(c, largest) ^ _I64_MIN for c in key_cols]
    if len(keys) == 1:
        keys.append(torch.full_like(keys[0], _I64_MIN))

    def tiled(c, fill):
        out = torch.full((N, span), fill, dtype=torch.int64, device=dev)
        out[:, :cap] = c
        return torch.where(valid, out, torch.full_like(out, fill))
    cols = [tiled(k, _I64_MAX).view(N, tiles, tile) for k in keys]
    cols.append(torch.where(valid, rows, torch.full_like(rows, _K18_NONE))
                .reshape(N, tiles, tile))
    cand = [c.reshape(N, tiles * keep) for c in _lex_first(cols, keep)]
    sel = _lex_first(cand, keep)[-1]
    m = torch.clamp(counts.long(), max=keep)
    live = torch.arange(keep, device=dev)[None, :] < m[:, None]
    sel = torch.where(live, sel, torch.zeros_like(sel))
    out = []
    for leaf in leaves:
        got = shard_rows(leaf, sel)
        mask = live.view(live.shape + (1,) * (leaf.dim() - 2))
        out.append(torch.where(mask, got, torch.zeros_like(got)))
    return out, torch.clamp(counts, max=n).to(torch.int32)


def topk_select(key_cols, counts, n, largest, leaves):
    """K18: each shard's min(n, count) best valid rows of every leaf, best
    first, with the new counts min(count, n).  Order: the key columns'
    images (K5's: -0.0 ties +0.0, NaN last), lexicographic, inverted for
    `largest` but NaN (still last), ties by row index: bit for bit the
    rows an ascending stable sort by (invalid flag, the key or its order
    reversal -1-k / -k) puts first.  Key columns: 1 or 2 contiguous (N,
    cap) int32 / int64 / float64 (topk_route); counts (N,) int32; n in
    [1, K18_MAX_N].  Returns ((N, min(n, cap), ...) leaves, their rows
    past the new count zero; counts (N,) int32)."""
    key_cols = [c.contiguous() for c in key_cols]
    leaves = list(leaves)
    N, cap = key_cols[0].shape
    _check_cols(key_cols, N, cap, "key columns")
    _check_cols(leaves, N, cap, "leaves")
    route = topk_route(key_cols, n)
    _need(route == "K18", route)
    _need(n >= 1, "n must be at least 1")
    _need(counts.dtype == torch.int32 and counts.shape == (N,),
          "counts must be (N,) int32")
    _need(cap < _K18_NONE, "cap must be < 2**31 - 1")
    if not _on_cuda(key_cols + [counts] + leaves):
        return topk_select_plain(key_cols, counts, n, largest, leaves)
    fn = _kernel("topk_select")
    dev = counts.device
    keep = min(n, cap)
    out = [torch.empty((N, keep) + tuple(v.shape[2:]), dtype=v.dtype,
                       device=dev) for v in leaves]
    new_n = torch.clamp(counts, max=n).to(torch.int32)
    if keep == 0 or N == 0:
        return out, new_n
    tiles = -(-cap // K18_TILE)
    two = len(key_cols) > 1
    cand0 = torch.empty((N, tiles, keep), dtype=torch.int64, device=dev)
    cand1 = torch.empty_like(cand0) if two else None
    crow = torch.empty((N, tiles, keep), dtype=torch.int32, device=dev)
    rows = torch.empty((N, keep), dtype=torch.int32, device=dev)
    vec = cap % 2 == 0 and all(c.data_ptr() % 16 == 0 for c in key_cols)
    rc = fn(_ptrs(key_cols),
            (ctypes.c_int * len(key_cols))(
                *[_RADIX_KINDS[c.dtype] for c in key_cols]),
            len(key_cols), counts.data_ptr(), N, cap, keep, int(largest),
            int(vec), cand0.data_ptr(),
            None if cand1 is None else cand1.data_ptr(), crow.data_ptr(),
            rows.data_ptr(), _ptrs(leaves), _ptrs(out),
            (ctypes.c_int64 * max(1, len(leaves)))(
                *[_row_bytes(v) for v in leaves]), len(leaves), _stream())
    _check("topk_select", rc)
    return out, new_n
