"""Where K16 (union_concat), K1 (hash_dst_hist), K12's ranges
(join_ranges), K8's state gather (bucket_gather_state), K4
(shard_exchange), K10 (pregel_deliver), K17's bool count (monoid_reduce
over bool, active_count), K8's scatter and K12's expansion (join_expand)
spend their time on the card, call by call where the smoke's paths run
them, and the checkout's kernels against another tree's in one process.

    python3 tools/union_hash_profile.py census [--old-csrc DIR] [--out FILE]
                                               [--paths union,window,...]
                                               [--kernels k4,k10,...]
    python3 tools/union_hash_profile.py compare [--old-csrc DIR]
                                                [--kernels k16,k1,k12,k8s,
                                                           k4,k10,k17,k8x]

census: drives chip_smoke.py's paths (union, window, reduce =
reduceByKey gpu:8, group = partitionBy/groupByKey/distinct gpu:8, sort =
sortByKey gpu:8, pregel, bagel, join, and segmap = groupByKey gpu:8
segmap and its power-law run; all but segmap by default) with the
launch counts set to 0 around each, as the smoke's check_launches does,
and records every call of the kernels named in --kernels (k16, k1, k12,
k8s, k4 and k10 by default; k17, k8x and k12e on request) on them: its
shape (K16: branches, rows, row bytes, cap_out;
K1: the key columns, N x cap, r, n_dst, whether the histogram and the
hash are kept; K12: nk, N, cap_a, cap_b and the valid rows of each side;
K8: the class width B, G, the live lanes and their rows; K4: N, cap_in,
cap_out, the rows moved and each leaf's row bytes; K10: the classes, N,
each class's cap_v, cap_u, the unique keys, the valid slots, whether the
ids are sorted, each leaf's row bytes; K17: op, dtype, the classes and
their caps, the valid elements; K8x: the classes scattered, their G,
the lanes; K12e: N,
cap_a, cap_out, the row bytes, the pairs), its bound (bytes over 3.35
TB/s), its time by CUDA events around the call, its host time, and the
call split by CUDA events into its stages (K16: the one host read of the
counts, the arguments, the kernel, the totals; K12: the host part before
the launch, with the earlier wrapper's pageable copy of the key table,
then the earlier kernel's three launches, ranges, scan and offsets, or
the checkout's one; K8: the host part, then the launch).  Prints one
line a path, kernel and shape (the mean, least and most ms), one a path
and kernel with their sums (calls, ms, host ms, bound ms), and writes
every call as a JSON line to --out (build/union_hash_profile/census.jsonl
by default; its first line the card's name and power limit).
With --old-csrc the paths run the other tree's kernels named in
--old-kernels (those of --kernels by default) in place of the
checkout's: K1, K16, K4 and K10 as the checkout's wrappers over the
other tree's library (its C interfaces must be the checkout's; the
object Bagel's batched K10 as one call a class of the single-class
entry), K12 and K8 with their first C interfaces (K12's key table
copied to the device and its three launches one at a time, through a
shim that includes the other tree's join_expand.cu; K8's state gather
without scratch).

compare: at the smoke's phase shapes (K16: union_phase_cases, K1:
hash_phase_cases, K12: join_phase_cases over TPC-H SF 10, K8:
state_gather_inputs, class by class; K4: the combined reduceByKey
output, the sort path's 8 x 8,388,608 rows and a PageRank superstep's
message exchange; K10: the PageRank superstep's delivery and the object
PageRank's class tables, the batched entry against one call a class;
K17: the bench shape's bool count through monoid_reduce, the Pregel and
object Bagel active counts after superstep 0, the earlier per-class
calls against active_count's one launch; K8x: the power-law table's and
a decayed-counter tick's classes, torch.zeros and one scatter a class
against bucket_scatter_classes' one launch, with Tensor.scatter_ of the
same values as the floor),
each call's CUDA-event time in the order old, new, new, old, its bound
(bytes over 3.35 TB/s), the torch composite or library call's time,
K1's and K4's floor (torch moving the same bytes), the K16 and K12
calls' stages, K4's, K10's and K12's device ms (the call replayed from
a CUDA graph), every output held against the plain version bit for bit
and two calls of the new kernel against each other; K8's class times
summed.  Without --old-csrc, the checkout's kernels alone.  Needs a
card; builds into build/union_hash_profile/.
"""

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke                                  # noqa: E402
from dpark_tpu_torch.backend.cuda import collectives as C   # noqa: E402
from dpark_tpu_torch.backend.cuda import kernels as K       # noqa: E402

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
N = smoke.N_SHARDS
OUT = os.path.join(ROOT, "build", "union_hash_profile", "census.jsonl")
# the checkout's wrappers (census patches K's with its recorders)
CHECKOUT = {name: getattr(K, name) for name in (
    "union_concat", "hash_dst_hist", "join_ranges", "bucket_gather_state",
    "shard_exchange", "pregel_deliver", "pregel_deliver_classes",
    "monoid_reduce", "join_expand", "active_count",
    "bucket_scatter_classes")}
# each kernel's library (the source named lib + ".cu")
LIBS = {"k1": "hash_dst_hist", "k16": "union_concat", "k12": "join_expand",
        "k8s": "bucket_groups", "k4": "shard_exchange",
        "k10": "pregel_deliver", "k17": "monoid_reduce",
        "k8x": "bucket_groups"}
ALL = "k16,k1,k12,k8s,k4,k10"
CARD = None              # nvidia-smi's name and power limit of the card
# the stages a report line prints (their mean device ms)
STAGES = ("read", "arguments", "launch", "totals", "setup", "host_setup",
          "ranges", "scan", "offsets")


# the earlier K12 ranges' three launches one at a time (ranges, scan,
# offsets: kernels static in the other tree's join_expand.cu)
K12_SHIM = r'''
#include "join_expand.cu"
extern "C" int dpk_k12_step(int step, const int64_t* desc, int nk, int N,
                            int64_t cap_a, int64_t cap_b, const int32_t* a_n,
                            const int32_t* b_n, int64_t* lo, int64_t* per,
                            int64_t* offs, int64_t* part, int64_t* totals,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t nblk = (cap_a + K12_TILE - 1) / K12_TILE;
  const dim3 grid((unsigned)nblk, (unsigned)N);
  if (step == 0)
    k12_ranges<<<grid, K12_TILE, 0, st>>>(desc, nk, cap_a, cap_b, a_n, b_n,
                                          lo, per, part, nblk);
  else if (step == 1)
    k12_scan<<<N, DPK_THREADS, 0, st>>>(part, nblk, totals);
  else
    k12_offsets<<<grid, K12_TILE, 0, st>>>(per, part, cap_a, nblk, offs);
  return (int)cudaGetLastError();
}
'''


def build_old(csrc, which):
    """The kernels `which` (of k1, k16, k12, k8s, k4, k10) of another tree
    as ctypes functions: K1, K4 and K10 with the checkout's C interfaces
    (K10's single-class entry), K16 with the earlier one (a device
    descriptor table and a device table of source pointers), K12 with
    its device key table (the whole entry and its three launches apart),
    K8 without scratch."""
    out = os.path.join(ROOT, "build", "union_hash_profile")
    os.makedirs(out, exist_ok=True)
    shim = os.path.join(out, "k12_old_shim.cu")
    with open(shim, "w") as f:
        f.write(K12_SHIM)
    procs = {}
    for name in (LIBS[k] for k in which):
        so = os.path.join(out, "lib%s_old.so" % name)
        src = shim if name == "join_expand" else \
            os.path.join(csrc, name + ".cu")
        procs[name] = (so, subprocess.Popen(
            [K._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-I",
             csrc, "-o", so, src]))
    libs = {}
    for name, (so, p) in procs.items():
        if p.wait() != 0:
            raise SystemExit("old %s failed to build" % name)
        libs[name] = ctypes.CDLL(so)
    old = {}
    if "k1" in which:
        old["k1"] = K._bind("hash_dst_hist", libs["hash_dst_hist"])
    if "k4" in which:
        old["k4"] = K._bind("shard_exchange", libs["shard_exchange"])
    if "k10" in which:
        # the single-class entry (the earlier tree has no batched one)
        one = libs["pregel_deliver"].dpk_pregel_deliver
        one.argtypes = [_P, _P, _I, _L, _P, _P, _L, _P, _P, _P, _P, _P, _I,
                        _P, _P]
        one.restype = ctypes.c_int
        old["k10"] = (one, None)
    if "k16" in which:
        old["k16"] = K._bind("union_concat", libs["union_concat"])
    if "k12" in which:
        old["k12"] = libs["join_expand"].dpk_join_ranges
        old["k12_step"] = libs["join_expand"].dpk_k12_step
        old["k12"].argtypes = [_P, _I, _I, _L, _L, _P, _P, _P, _P, _P, _P,
                               _P, _P]
        old["k12_step"].argtypes = [_I] + old["k12"].argtypes
        old["k12"].restype = old["k12_step"].restype = ctypes.c_int
    if "k17" in which:
        # the monoid reduction's entry, which took bools (k17_partial and
        # k17_fold) before the bool count
        old["k17"] = libs["monoid_reduce"].dpk_monoid_reduce
        old["k17"].argtypes = [_P, _I, _L, _P, _I, _L, _I, _P, _P, _P, _P,
                               _I, _P]
        old["k17"].restype = ctypes.c_int
    if "k8x" in which:
        # the scatter of one class (k8_scatter) before the batched one
        old["k8x"] = libs["bucket_groups"].dpk_bucket_scatter
        old["k8x"].argtypes = [_P, _P, _P, _I, _L, _I, _P, _P, _P, _I, _P]
        old["k8x"].restype = ctypes.c_int
    if "k8s" in which:
        old["k8s"] = libs["bucket_groups"].dpk_bucket_gather_state
        old["k8s"].argtypes = [_P, _P, _P, _P, _P, _I, _L, _I, _I, _P, _L,
                               _P, _P, _P, _P, _I, _P]
        old["k8s"].restype = ctypes.c_int
    return old


def _mark(marks, label):
    if marks is not None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((label, ev, time.perf_counter()))


@contextlib.contextmanager
def patched(obj, name, value):
    """obj.name (or obj[name] for a dict) set to value for the block."""
    get, put = ((obj.get, obj.__setitem__) if isinstance(obj, dict)
                else (lambda n: getattr(obj, n),
                      lambda n, v: setattr(obj, n, v)))
    before = get(name)
    put(name, value)
    try:
        yield
    finally:
        put(name, before)


def new_union_concat(branches, key_leaf=0, key_fill=K.KEY_SENTINEL,
                     marks=None, lib=None):
    """The checkout's K16 wrapper (over `lib`, another tree's library, if
    given), with a CUDA event after its host read of the counts
    (K._union_cap_out), its arguments and the kernel (the library's
    entry)."""
    fn = lib or K._kernel("union_concat")
    if marks is None:
        with patched(K._libs, "union_concat", fn):
            return CHECKOUT["union_concat"](branches, key_leaf, key_fill)
    read = K._union_cap_out

    def read_m(*a):
        res = read(*a)
        _mark(marks, "read")
        return res

    def fn_m(*a):
        _mark(marks, "arguments")
        rc = fn(*a)
        _mark(marks, "launch")
        return rc
    _mark(marks, "start")
    with patched(K, "_union_cap_out", read_m), \
            patched(K._libs, "union_concat", fn_m):
        res = CHECKOUT["union_concat"](branches, key_leaf, key_fill)
    _mark(marks, "totals")
    return res


def old_join_ranges(old, a_keys, a_n, b_keys, b_n, marks=None):
    """The earlier K12 ranges wrapper: its checks, the key table
    copied from a pageable host tensor, the scratch, then its entry (or,
    with `marks`, its three launches one at a time, a mark after each)."""
    _mark(marks, "start")
    a_keys, b_keys = list(a_keys), list(b_keys)
    N_, cap_a, cap_b = K._check_join_keys(a_keys, a_n, b_keys, b_n)
    K._on_cuda(a_keys + b_keys + [a_n, b_n])
    dev = a_keys[0].device
    nk = len(a_keys)
    pad = [0] * (K.JOIN_MAX_KEYS - nk)
    desc = torch.tensor(
        [k.data_ptr() for k in a_keys] + pad
        + [k.data_ptr() for k in b_keys] + pad
        + [K._JOIN_KEY_KINDS[k.dtype] for k in a_keys] + pad,
        dtype=torch.int64).to(dev)
    lo = torch.empty((N_, cap_a), dtype=torch.int64, device=dev)
    per = torch.empty_like(lo)
    offs = torch.empty_like(lo)
    part = torch.empty((N_, max(1, -(-cap_a // 1024))), dtype=torch.int64,
                       device=dev)
    totals = torch.empty((N_,), dtype=torch.int64, device=dev)
    _mark(marks, "setup")
    args = (desc.data_ptr(), nk, N_, cap_a, cap_b, a_n.data_ptr(),
            b_n.data_ptr(), lo.data_ptr(), per.data_ptr(), offs.data_ptr(),
            part.data_ptr(), totals.data_ptr(), K._stream())
    if marks is None:
        rc = old["k12"](*args)
    else:
        for step, label in enumerate(("ranges", "scan", "offsets")):
            rc = old["k12_step"](step, *args)
            if rc:
                break
            _mark(marks, label)
    if rc:
        raise RuntimeError("old K12 ranges failed to launch: %d" % rc)
    K.LAUNCHES["join_ranges"] += 1
    return lo, per, offs, totals


def marked_entry(lib, index, marks, before, after):
    """K._libs[lib] with entry `index` marking `before` ahead of the call
    and `after` behind it."""
    fns = K._kernel(lib)
    fns = list(fns) if isinstance(fns, tuple) else [fns]
    fn = fns[index]

    def call(*a):
        _mark(marks, before)
        rc = fn(*a)
        _mark(marks, after)
        return rc
    fns[index] = call
    return tuple(fns) if len(fns) > 1 else fns[0]


def new_join_ranges(a_keys, a_n, b_keys, b_n, marks=None):
    """The checkout's K12 ranges wrapper; with `marks`, a mark before
    its launch (the host part: checks, outputs and scratch) and after."""
    if marks is None:
        return CHECKOUT["join_ranges"](a_keys, a_n, b_keys, b_n)
    _mark(marks, "start")
    with patched(K._libs, "join_expand", marked_entry(
            "join_expand", 0, marks, "setup", "launch")):
        return CHECKOUT["join_ranges"](a_keys, a_n, b_keys, b_n)


def old_state_gather(old, start_rows, sizes, members, boff, bcnt, G, B,
                     vals, flags, pad, marks=None):
    """The earlier K8 state-gather wrapper: its checks and
    outputs, then its one launch."""
    _mark(marks, "start")
    N_, cap = vals.shape[:2]
    K._on_cuda([start_rows, sizes, members, boff, bcnt, vals, flags])
    dev = vals.device
    out = torch.empty((N_, G, B), dtype=vals.dtype, device=dev)
    prev = torch.empty((N_, G), dtype=vals.dtype, device=dev)
    has_prev = torch.empty((N_, G), dtype=torch.bool, device=dev)
    _mark(marks, "setup")
    rc = old["k8s"](start_rows.data_ptr(), sizes.data_ptr(),
                    members.data_ptr(), boff.data_ptr(), bcnt.data_ptr(),
                    N_, cap, int(G), int(B), vals.data_ptr(),
                    vals.element_size(), flags.data_ptr(), out.data_ptr(),
                    prev.data_ptr(), has_prev.data_ptr(),
                    int(pad == "edge"), K._stream())
    if rc:
        raise RuntimeError("old K8 state gather failed to launch: %d" % rc)
    _mark(marks, "launch")
    K.LAUNCHES["bucket_gather_state"] += 1
    return out, prev, has_prev


def new_state_gather(*args, marks=None):
    """The checkout's K8 state-gather wrapper; with `marks`, a mark
    before its launch and after."""
    if marks is None:
        return CHECKOUT["bucket_gather_state"](*args)
    _mark(marks, "start")
    with patched(K._libs, "bucket_groups", marked_entry(
            "bucket_groups", 2, marks, "setup", "launch")):
        return CHECKOUT["bucket_gather_state"](*args)


def old_monoid_reduce(old, col, n, op):
    """The earlier K17 wrapper over the other tree's entry: outputs and a
    scratch of partials, k17_partial and k17_fold (bools too)."""
    N_, cap = col.shape[:2]
    dev = col.device
    red = torch.empty(N_, dtype=K.monoid_out_dtype(op, col.dtype),
                      device=dev)
    lo = torch.empty(N_, dtype=col.dtype, device=dev)
    hi = torch.empty(N_, dtype=col.dtype, device=dev)
    lanes = K._lanes(col)
    vecs = -(-cap * lanes * col.element_size() // 16)
    blocks = max(1, min(-(-vecs // (256 * 4)), K._K17_BLOCKS // N_))
    scratch = torch.empty(N_ * blocks * K._K17_PART_BYTES, dtype=torch.uint8,
                          device=dev)
    rc = old["k17"](col.data_ptr(), K._K17_KINDS[col.dtype], lanes,
                    n.data_ptr(), N_, cap, K.OPS[op], red.data_ptr(),
                    lo.data_ptr(), hi.data_ptr(), scratch.data_ptr(), blocks,
                    K._stream())
    if rc:
        raise RuntimeError("old K17 failed to launch: %d" % rc)
    K.LAUNCHES["monoid_reduce"] += 1
    return red, lo, hi


def old_bucket_scatter(old, outs, results, members, boff, bcnt):
    """The earlier single-class K8 scatter over the other tree's entry:
    one thread a (shard, lane), in place."""
    N_, cap = outs[0].shape
    rc = old["k8x"](members.data_ptr(), boff.data_ptr(), bcnt.data_ptr(),
                    N_, cap, results[0].shape[1], K._ptrs(results),
                    K._ptrs(outs), (ctypes.c_int64 * len(outs))(
                        *[o.element_size() for o in outs]), len(outs),
                    K._stream())
    if rc:
        raise RuntimeError("old K8 scatter failed to launch: %d" % rc)
    K.LAUNCHES["bucket_scatter"] += 1
    return outs


def split_ms(marks):
    """{stage: device ms since the previous mark, "host_" + stage: host
    ms since it}, 'host' the call's host ms."""
    out = {}
    for (_, a, ha), (label, b, hb) in zip(marks, marks[1:]):
        out[label] = a.elapsed_time(b)
        out["host_" + label] = (hb - ha) * 1e3
    out["host"] = (marks[-1][2] - marks[0][2]) * 1e3
    return out


# ---------------------------------------------------------------------
# census: every K16 and K1 call on the smoke's paths
# ---------------------------------------------------------------------
class Census:
    def __init__(self, k16, k1_lib, k12, k8s, k4_lib, k10_lib):
        self.path = None
        self.calls = []
        self.k16_impl = k16
        self.k1_lib = k1_lib
        self.k1_impl = CHECKOUT["hash_dst_hist"]
        self.k12_impl = k12
        self.k8s_impl = k8s
        self.k4_lib = k4_lib
        # the other tree's K10 has no batched entry: one call a class
        self.k10_lib = k10_lib
        self.k10_old = k10_lib[1] is None

    def shard_exchange(self, leaves, counts, offsets, cap_out, key_leaf=0,
                       key_fill=K.KEY_SENTINEL):
        leaves = list(leaves)
        args = (leaves, counts, offsets, cap_out, key_leaf, key_fill)
        if not leaves[0].is_cuda:
            return CHECKOUT["shard_exchange"](*args)
        marks = []
        _mark(marks, "start")
        with patched(K._libs, "shard_exchange", self.k4_lib):
            out = CHECKOUT["shard_exchange"](*args)
        _mark(marks, "call")
        self.calls.append({
            "kernel": "K4", "path": self.path, "N": counts.shape[0],
            "cap_in": leaves[0].shape[1], "cap_out": int(cap_out),
            "row_bytes": [K._row_bytes(x) for x in leaves],
            "_rows": counts.sum(), "_marks": marks})
        return out

    def pregel_deliver(self, vid, vcnt, uk, n_unique, leaves, combine,
                       fills=None):
        args = (vid, vcnt, uk, n_unique, leaves, combine, fills)
        if not vid.is_cuda:
            return CHECKOUT["pregel_deliver"](*args)
        marks = []
        _mark(marks, "start")
        with patched(K._libs, "pregel_deliver", self.k10_lib):
            out = CHECKOUT["pregel_deliver"](*args)
        _mark(marks, "call")
        self._k10_record([(vid, vcnt)], uk, n_unique, leaves, marks)
        return out

    def pregel_deliver_classes(self, classes, uk, n_unique, leaves, combine,
                               fills=None):
        classes = list(classes)
        if not uk.is_cuda:
            return CHECKOUT["pregel_deliver_classes"](
                classes, uk, n_unique, leaves, combine, fills)
        marks = []
        _mark(marks, "start")
        with patched(K._libs, "pregel_deliver", self.k10_lib):
            if self.k10_old:
                out = [CHECKOUT["pregel_deliver"](vid, vcnt, uk, n_unique,
                                                  leaves, combine, fills)
                       for vid, vcnt in classes]
            else:
                out = CHECKOUT["pregel_deliver_classes"](
                    classes, uk, n_unique, leaves, combine, fills)
        _mark(marks, "call")
        self._k10_record(classes, uk, n_unique, leaves, marks)
        return out

    def _k10_record(self, classes, uk, n_unique, leaves, marks):
        self.calls.append({
            "kernel": "K10", "path": self.path, "classes": len(classes),
            "N": uk.shape[0], "caps": [v.shape[1] for v, _ in classes],
            "cap_u": uk.shape[1],
            "row_bytes": [K._row_bytes(x) for x in leaves],
            "_unique": n_unique.sum(),
            "_valid": sum(c.sum() for _, c in classes),
            "_sorted": torch.stack([(v[:, 1:] >= v[:, :-1]).all()
                                    for v, _ in classes]).all(),
            "_marks": marks})

    def monoid_reduce(self, col, n, op):
        if not col.is_cuda:
            return CHECKOUT["monoid_reduce"](col, n, op)
        marks = []
        _mark(marks, "start")
        out = CHECKOUT["monoid_reduce"](col, n, op)
        _mark(marks, "call")
        self._k17_record(op, [(col, n)], 3 * 8 * col.shape[0], marks)
        return out

    def active_count(self, masks, ns):
        masks, ns = list(masks), list(ns)
        if not masks[0].is_cuda:
            return CHECKOUT["active_count"](masks, ns)
        marks = []
        _mark(marks, "start")
        out = CHECKOUT["active_count"](masks, ns)
        _mark(marks, "call")
        self._k17_record("count", list(zip(masks, ns)), 8, marks)
        return out

    def _k17_record(self, op, pairs, out_bytes, marks):
        """K17: one column (monoid_reduce) or every class's mask
        (active_count); the valid elements counted on the card."""
        col = pairs[0][0]
        self.calls.append({
            "kernel": "K17", "path": self.path, "op": op,
            "dtype": str(col.dtype).replace("torch.", ""),
            "classes": len(pairs), "N": col.shape[0],
            "caps": [c.shape[1] for c, _ in pairs],
            "lanes": K._lanes(col), "elem": col.element_size(),
            "out_bytes": out_bytes,
            "_valid": sum((n.long().clamp(max=c.shape[1]) * K._lanes(c))
                          .sum() for c, n in pairs),
            "_marks": marks})

    def bucket_scatter_classes(self, results_by_class, members, offsets,
                               counts, classes, out_dtypes):
        args = (results_by_class, members, offsets, counts, classes,
                out_dtypes)
        if not members.is_cuda:
            return CHECKOUT["bucket_scatter_classes"](*args)
        marks = []
        _mark(marks, "start")
        out = CHECKOUT["bucket_scatter_classes"](*args)
        _mark(marks, "call")
        self._k8x_record(list(classes), [r[0].shape[1]
                                         for r in results_by_class],
                         out, [r[0] for r in results_by_class], members,
                         counts[:, list(classes)].sum(), marks)
        return out

    def _k8x_record(self, classes, Gs, outs, res, members, lanes, marks):
        """K8's scatter: the classes written and their G."""
        self.calls.append({
            "kernel": "K8x", "path": self.path, "classes": classes,
            "G": Gs, "N": members.shape[0], "cap": members.shape[1],
            "out_bytes": [o.element_size() for o in outs],
            "res_bytes": res[0].element_size() if res else 0,
            "_lanes": lanes, "_marks": marks})

    def join_expand(self, a_leaves, b_vals, lo, per, offs, totals, a_n,
                    cap_out):
        args = (a_leaves, b_vals, lo, per, offs, totals, a_n, cap_out)
        if not a_n.is_cuda:
            return CHECKOUT["join_expand"](*args)
        marks = []
        _mark(marks, "start")
        out = CHECKOUT["join_expand"](*args)
        _mark(marks, "call")
        self.calls.append({
            "kernel": "K12e", "path": self.path, "N": a_n.shape[0],
            "cap_a": lo.shape[1], "cap_out": int(cap_out),
            "a_bytes": sum(K._row_bytes(x) for x in a_leaves),
            "b_bytes": sum(K._row_bytes(x) for x in b_vals),
            "_pairs": totals.sum(), "_a_rows": a_n.sum(), "_marks": marks})
        return out

    def join_ranges(self, a_keys, a_n, b_keys, b_n):
        a_keys, b_keys = list(a_keys), list(b_keys)
        if not a_keys[0].is_cuda:
            return CHECKOUT["join_ranges"](a_keys, a_n, b_keys, b_n)
        marks = []
        out = self.k12_impl(a_keys, a_n, b_keys, b_n, marks=marks)
        self.calls.append({
            "kernel": "K12", "path": self.path, "nk": len(a_keys),
            "N": a_keys[0].shape[0], "cap_a": a_keys[0].shape[1],
            "cap_b": b_keys[0].shape[1], "_a_rows": a_n.sum(),
            "_b_rows": b_n.sum(), "_marks": marks})
        return out

    def bucket_gather_state(self, start_rows, sizes, members, boff, bcnt,
                            G, B, vals, flags, pad):
        args = (start_rows, sizes, members, boff, bcnt, G, B, vals, flags,
                pad)
        if not vals.is_cuda:
            return CHECKOUT["bucket_gather_state"](*args)
        marks = []
        out = self.k8s_impl(*args, marks=marks)
        rows = sizes.gather(1, members.long()).masked_fill(
            ~smoke.valid_lanes(members, boff, bcnt), 0).sum()
        self.calls.append({
            "kernel": "K8s", "path": self.path, "B": int(B), "G": int(G),
            "N": vals.shape[0], "pad": pad, "_live": bcnt.sum(),
            "_rows": rows, "_marks": marks})
        return out

    def union_concat(self, branches, key_leaf=0, key_fill=K.KEY_SENTINEL):
        if not branches[0][0][0].is_cuda:
            return self.k16_impl(branches, key_leaf, key_fill)
        marks = []
        out = self.k16_impl(branches, key_leaf, key_fill, marks)
        lv0 = branches[0][0]
        self.calls.append({
            "kernel": "K16", "path": self.path, "k": len(branches),
            "N": lv0[0].shape[0], "caps": [lv[0].shape[1]
                                           for lv, _ in branches],
            "row_bytes": sum(K._row_bytes(x) for x in lv0),
            "leaves": len(lv0), "cap_out": out[0][0].shape[1],
            "_totals": out[1], "_marks": marks})
        return out

    def hash_dst_hist(self, key_cols, n, r, n_dst, want_hist=True,
                      want_hash=False):
        key_cols = list(key_cols)
        if not key_cols[0].is_cuda:
            return self.k1_impl(key_cols, n, r, n_dst, want_hist, want_hash)
        marks = []
        _mark(marks, "start")
        with patched(K._libs, "hash_dst_hist", self.k1_lib):
            out = self.k1_impl(key_cols, n, r, n_dst, want_hist, want_hash)
        _mark(marks, "call")
        self.calls.append({
            "kernel": "K1", "path": self.path,
            "cols": [str(c.dtype).replace("torch.", "") for c in key_cols],
            "N": key_cols[0].shape[0], "cap": key_cols[0].shape[1],
            "r": int(r), "n_dst": int(n_dst), "hist": bool(want_hist),
            "hash": bool(want_hash), "_n": n, "_marks": marks})
        return out

    def resolve(self):
        """The calls' event times and row counts (after a synchronize)."""
        torch.cuda.synchronize()
        for c in self.calls:
            if "_marks" not in c:
                continue
            marks = c.pop("_marks")
            c.update(split_ms(marks))
            c["ms"] = marks[0][1].elapsed_time(marks[-1][1])
            if c["kernel"] == "K16":
                c["rows"] = int(c.pop("_totals").sum().item())
            elif c["kernel"] == "K1":
                c["rows"] = int(c.pop("_n").sum().item())
            elif c["kernel"] == "K12":
                c["a_rows"] = int(c.pop("_a_rows").item())
                c["b_rows"] = c["rows"] = int(c.pop("_b_rows").item())
            elif c["kernel"] == "K4":
                c["rows"] = int(c.pop("_rows").item())
                rb = sum(c["row_bytes"])
                c["bound"] = smoke.bound_ms(
                    c["rows"] * rb * 2 + (c["N"] * c["cap_out"] - c["rows"])
                    * rb + 8 * c["N"] * c["N"])
            elif c["kernel"] == "K10":
                c["unique"] = int(c.pop("_unique").item())
                c["rows"] = int(c.pop("_valid").item())
                c["sorted"] = bool(c.pop("_sorted").item())
                rb = sum(c["row_bytes"])
                c["bound"] = smoke.bound_ms(c["rows"] * (8 + rb + 1)
                                            + c["unique"] * (8 + rb))
            elif c["kernel"] == "K17":
                # the valid elements read once, the counts and outputs
                c["rows"] = int(c.pop("_valid").item())
                c["bound"] = smoke.bound_ms(
                    c["rows"] * c["elem"] + 4 * c["N"] * c["classes"]
                    + c["out_bytes"])
            elif c["kernel"] == "K8x":
                # each lane's member id and result read, every slot
                # written (0 past the lanes; a pad slot's member id is its
                # own slot, not read)
                c["rows"] = int(c.pop("_lanes").item())
                c["bound"] = smoke.bound_ms(
                    c["N"] * c["cap"] * sum(c["out_bytes"]) + c["rows"] * (
                        4 + c["res_bytes"] * len(c["out_bytes"])))
            elif c["kernel"] == "K12e":
                # A's valid rows with lo and offs read, every output slot
                # written (B's values read are not counted)
                c["rows"] = int(c.pop("_pairs").item())
                c["a_rows"] = int(c.pop("_a_rows").item())
                c["bound"] = smoke.bound_ms(
                    c["a_rows"] * (c["a_bytes"] + 16) + c["N"] * c["cap_out"]
                    * (c["a_bytes"] + c["b_bytes"]))
            else:
                c["live"] = int(c.pop("_live").item())
                c["rows"] = int(c.pop("_rows").item())

    def report(self, path):
        groups = {}
        for c in self.calls:
            if c["path"] != path:
                continue
            if c["kernel"] == "K16":
                key = ("K16", "k=%d N=%d caps=%s row_bytes=%d leaves=%d "
                       "cap_out=%d" % (c["k"], c["N"], c["caps"],
                                       c["row_bytes"], c["leaves"],
                                       c["cap_out"]))
            elif c["kernel"] == "K12":
                key = ("K12", "nk=%d N=%d cap_a=%d cap_b=%d a_rows=%d" % (
                    c["nk"], c["N"], c["cap_a"], c["cap_b"], c["a_rows"]))
            elif c["kernel"] == "K8s":
                key = ("K8s", "B=%07d G=%d N=%d pad=%s" % (
                    c["B"], c["G"], c["N"], c["pad"]))
            elif c["kernel"] == "K4":
                key = ("K4", "N=%d cap_in=%d cap_out=%d row_bytes=%s" % (
                    c["N"], c["cap_in"], c["cap_out"], c["row_bytes"]))
            elif c["kernel"] == "K17":
                key = ("K17", "op=%s dtype=%s classes=%d N=%d caps=%s "
                       "lanes=%d" % (c["op"], c["dtype"], c["classes"],
                                     c["N"], c["caps"], c["lanes"]))
            elif c["kernel"] == "K8x":
                key = ("K8x", "classes=%s G=%s N=%d cap=%d out_bytes=%s" % (
                    c["classes"], c["G"], c["N"], c["cap"], c["out_bytes"]))
            elif c["kernel"] == "K12e":
                key = ("K12e", "N=%d cap_a=%d cap_out=%d a_bytes=%d "
                       "b_bytes=%d" % (c["N"], c["cap_a"], c["cap_out"],
                                       c["a_bytes"], c["b_bytes"]))
            elif c["kernel"] == "K10":
                key = ("K10", "classes=%d N=%d caps=%s cap_u=%d row_bytes=%s "
                       "sorted=%d" % (c["classes"], c["N"], c["caps"],
                                      c["cap_u"], c["row_bytes"],
                                      c["sorted"]))
            else:
                key = ("K1", "cols=%s N=%d cap=%d r=%d n_dst=%d hist=%d "
                       "hash=%d" % (",".join(c["cols"]), c["N"], c["cap"],
                                    c["r"], c["n_dst"], c["hist"],
                                    c["hash"]))
            groups.setdefault(key, []).append(c)
        totals = {}
        for (kernel, shape), cs in sorted(groups.items()):
            ms = [c["ms"] for c in cs]
            stages = [s for s in STAGES if s in cs[0]]
            bound = sum(c.get("bound", 0.0) for c in cs)
            t = totals.setdefault(kernel, [0, 0.0, 0.0, 0.0])
            t[0] += len(cs)
            t[1] += sum(ms)
            t[2] += sum(c["host"] for c in cs)
            t[3] += bound
            print("census %s %s %s: launches=%d ms=%.4f (%.4f-%.4f) "
                  "total_ms=%.4f host_ms=%.4f rows=%d-%d%s%s%s" % (
                      path, kernel, shape, len(cs), np.mean(ms), min(ms),
                      max(ms), sum(ms), np.mean([c["host"] for c in cs]),
                      min(c["rows"] for c in cs), max(c["rows"] for c in cs),
                      (" live=%d-%d" % (min(c["live"] for c in cs),
                                        max(c["live"] for c in cs))
                       if kernel == "K8s" else ""),
                      (" bound_total_ms=%.4f" % bound
                       if "bound" in cs[0] else ""),
                      "".join(" %s=%.4f" % (s, np.mean([c[s] for c in cs]))
                              for s in stages)), flush=True)
        for kernel, (n, ms, host, bound) in sorted(totals.items()):
            print("census %s %s sum: calls=%d total_ms=%.4f host_ms=%.4f "
                  "bound_ms=%.4f" % (path, kernel, n, ms, host, bound),
                  flush=True)


def census_paths(which):
    """(path, function, arguments) of the smoke's paths named, each made
    when it is next (segmap: the bench and the power-law runs)."""
    def union():
        return ("union gpu:8", smoke.union_path, smoke.bench_data())

    def window():
        return ("window gpu:8", smoke.window_path,
                (smoke.window_batches(smoke.WINDOW_BATCHES),))

    def reduce():
        return ("reduceByKey gpu:8", smoke.main_path,
                ("gpu:8",) + smoke.bench_data())

    def group():
        return ("partition/group/distinct gpu:8", smoke.group_paths,
                smoke.bench_data())

    def sort():
        return ("sort gpu:8", smoke.sort_path, ("gpu:8",) + smoke.sort_data())

    def pregel():
        graph = smoke.kronecker_graph(smoke.GRAPH_SCALE, smoke.EDGE_FACTOR)
        weights = np.random.default_rng(20261022).integers(
            1, 100, len(graph[1])).astype(np.float64)
        return ("pregel gpu:8", smoke.pregel_path, (graph, weights))

    def bagel():
        return ("bagel gpu:8", smoke.bagel_path, (smoke.urand_graph(
            smoke.URAND_SCALE, smoke.URAND_EDGE_FACTOR),))

    def join():
        return ("join gpu:8", smoke.join_path, (smoke.tpch_data(),))

    def segmap():
        """groupByKey(8).mapValues(sum of squares) over bench.py's data,
        then over the power-law rows (the smoke's grouped_paths)."""
        keys, vals = smoke.bench_data()
        want = dict(enumerate(smoke.square_sums(keys, vals,
                                                smoke.KEYS).tolist()))
        yield ("groupByKey gpu:8 segmap", smoke.segmap_path,
               ("segmap", keys, vals, want))
        del keys, vals, want
        gid = smoke.power_law_groups()
        pvals = np.arange(smoke.POWER_ROWS, dtype=np.int64) & 0xFFFF
        sq = smoke.square_sums(gid, pvals, smoke.POWER_GROUPS)
        pwant = dict(zip(smoke.power_law_key(
            np.arange(smoke.POWER_GROUPS)).tolist(), sq.tolist()))
        yield ("groupByKey gpu:8 segmap power-law", smoke.segmap_path,
               ("segmap power-law", smoke.power_law_key(gid), pvals, pwant))
    makers = {"union": union, "window": window, "reduce": reduce,
              "group": group, "sort": sort, "pregel": pregel,
              "bagel": bagel, "join": join}
    for name in which:
        if name == "segmap":
            yield from segmap()
        else:
            yield makers[name]()


def census(args, old):
    kernels = args.kernels.split(",")
    use = set(old) if old is not None else set()
    k1_lib = old["k1"] if "k1" in use else K._kernel("hash_dst_hist")
    k4_lib = old["k4"] if "k4" in use else K._kernel("shard_exchange")
    k10_lib = old["k10"] if "k10" in use else K._kernel("pregel_deliver")
    k16, k12, k8s = new_union_concat, new_join_ranges, new_state_gather
    if "k16" in use:
        def k16(branches, key_leaf=0, key_fill=K.KEY_SENTINEL, marks=None):
            return new_union_concat(branches, key_leaf, key_fill, marks,
                                    lib=old["k16"])
    if "k12" in use:
        def k12(*a, marks=None):
            return old_join_ranges(old, *a, marks=marks)
    if "k8s" in use:
        def k8s(*a, marks=None):
            return old_state_gather(old, *a, marks=marks)
    rec = Census(k16, k1_lib, k12, k8s, k4_lib, k10_lib)
    recorders = {"k16": ["union_concat"], "k1": ["hash_dst_hist"],
                 "k12": ["join_ranges"], "k8s": ["bucket_gather_state"],
                 "k4": ["shard_exchange"],
                 "k10": ["pregel_deliver", "pregel_deliver_classes"],
                 "k17": ["monoid_reduce", "active_count"],
                 "k8x": ["bucket_scatter_classes"],
                 "k12e": ["join_expand"]}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with contextlib.ExitStack() as stack:
        for k in kernels:
            for name in recorders[k]:
                stack.enter_context(patched(K, name, getattr(rec, name)))
        f = stack.enter_context(open(args.out, "w"))
        f.write(json.dumps({"card": CARD, "torch": torch.__version__}) + "\n")
        paths = census_paths(args.paths.split(","))
        while True:
            t0 = time.perf_counter()
            item = next(paths, None)
            if item is None:
                break
            path, fn, fargs = item
            rec.path = path
            print("census %s: inputs in %.1f s" % (
                path, time.perf_counter() - t0), flush=True)
            # the other tree's K10 launches once a class on the object
            # Bagel, where the checkout's launches once a superstep
            smoke.check_launches(path, fn, *fargs, exact=not rec.k10_old)
            del fargs
            rec.resolve()
            rec.report(path)
            for c in rec.calls:
                f.write(json.dumps(c) + "\n")
            rec.calls = []
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------
# compare: old against new at the phases' and the paths' shapes
# ---------------------------------------------------------------------
def k16_cases(dev):
    """(label, branches): the smoke's K16 phases (chip_smoke.py
    union_phase_cases: k = 12 ragged, the union path's k = 2, the window
    path's largest union and its most common one), and k = 12 with every
    count rounded down to even, so that every span of its 8-byte rows
    starts 16-byte aligned in its source and its output."""
    for label, branches in smoke.union_phase_cases(dev):
        yield label, branches
        if label == "k=12":
            yield "k=12 even counts", [(lv, n - n % 2) for lv, n in branches]
        del branches
        torch.cuda.empty_cache()


def k1_cases(dev):
    """(label, (key_cols, n, r, n_dst, want_hist, want_hash)): the
    smoke's K1 phases (chip_smoke.py hash_phase_cases: bench keys with
    and without the histogram, a Pregel superstep's pre-combine)."""
    for label, args in smoke.hash_phase_cases(dev):
        yield label, args
        del args
        torch.cuda.empty_cache()


def k1_floor(key_cols, n, r, n_dst, want_hist, want_hash):
    """torch's time for K1's bytes without its arithmetic: each shard's
    valid keys (n[0] rows, the same on every shard here) converted to
    int32 into a (N, cap) column, the rest filled with n_dst."""
    key = key_cols[0]
    rows = int(n[0].item())
    out = torch.empty(key.shape, dtype=torch.int32, device=key.device)

    def floor():
        out[:, :rows].copy_(key[:, :rows])
        out[:, rows:].fill_(n_dst)
    return smoke.timed(floor, reps=10)


def bits(t):
    return t.contiguous().view(torch.uint8)


def same(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        if g is None and w is None:
            continue
        if g.shape != w.shape or not torch.equal(bits(g), bits(w)):
            return "output %d differs from the plain version" % i
    return None


def graph_ms(call, reps=20):
    """Device ms of call() replayed from a CUDA graph: its launches back
    to back, without the host's time between calls (the wrapper's checks
    and allocations are captured once)."""
    call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        call()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    del g
    return start.elapsed_time(end) / reps


def profile(kernel, label, versions, outputs, want, notes, graph=()):
    """Check, then time old, new, new, old (and the versions named in
    `graph` from a CUDA graph, "device"); returns {version: [ms, ms]}
    and {version: device ms}."""
    print("%s %s: %s" % (kernel, label, " ".join(
        "%s=%s" % (k, ("%.4f" % v) if isinstance(v, float) else v)
        for k, v in notes.items())), flush=True)
    for name, call in versions:
        bad = same(outputs(call()), want)
        if bad is not None:
            if name == "new":
                raise SystemExit("%s new %s: %s" % (kernel, label, bad))
            print("%s %s %s diverges: %s" % (kernel, name, label, bad),
                  flush=True)
    name, call = versions[-1]
    if name == "new":
        a, b = outputs(call()), outputs(call())
        if same(a, b) is not None:
            raise SystemExit("%s new %s: two calls differ" % (kernel, label))
        del a, b
    times = {name: [smoke.timed(call, reps=10)] for name, call in versions}
    for name, call in versions[::-1]:
        times[name].append(smoke.timed(call, reps=10))
    device = {name: graph_ms(call) for name, call in versions
              if name in graph}
    for name, _ in versions:
        print("%s %s %s: ms=%.4f,%.4f%s" % (
            kernel, name, label, *times[name],
            " device_ms=%.4f" % device[name] if name in device else ""),
            flush=True)
    return times, device


def split(call, *args, reps=5):
    """The mean stages of `reps` calls of call(*args, marks=...)."""
    call(*args, marks=[])
    torch.cuda.synchronize()
    sums = {}
    for _ in range(reps):
        marks = []
        call(*args, marks=marks)
        torch.cuda.synchronize()
        for k, v in split_ms(marks).items():
            sums[k] = sums.get(k, 0.0) + v
    return " ".join("%s=%.4f" % (k, v / reps) for k, v in sums.items())


def compare_k16(dev, old):
    for label, branches in k16_cases(dev):
        out, totals = K.union_concat_plain(branches)
        want = list(out) + [totals]
        del out
        rec = smoke.union_case(K, branches, label)

        def outputs(res):
            return list(res[0]) + [res[1]]
        versions = []
        if old is not None:
            versions.append(("old", lambda: new_union_concat(
                branches, lib=old["k16"])))
        versions.append(("new", lambda: K.union_concat(branches)))
        profile("k16", label, versions, outputs, want, {
            "bound_ms": rec["bound_ms"], **rec["notes"]})
        splits = [("new", new_union_concat)]
        if old is not None:
            splits.insert(0, ("old", lambda b, marks: new_union_concat(
                b, marks=marks, lib=old["k16"])))
        for name, call in splits:
            print("k16 split %s %s: %s" % (name, label,
                                           split(call, branches)),
                  flush=True)
        del want


def compare_k1(dev, old):
    for label, a in k1_cases(dev):
        want = list(K.hash_dst_hist_plain(*a))
        _, rec = smoke.hash_case(K, *a)
        versions = []
        if old is not None:
            def old_call(a=a):
                with patched(K._libs, "hash_dst_hist", old["k1"]):
                    return K.hash_dst_hist(*a)
            versions.append(("old", old_call))
        versions.append(("new", lambda: K.hash_dst_hist(*a)))
        profile("k1", label, versions, list, want, {
            "bound_ms": rec["bound_ms"],
            "library_ms": rec["library_ms"],
            "floor_ms": k1_floor(*a)})
        del want


def compare_k12(dev, old):
    """K12's ranges in each of the smoke's join_phase_cases: old, new,
    new, old, then each version's stages."""
    t0 = time.perf_counter()
    data = smoke.tpch_data()
    print("k12 tpch: SF %d generated in %.1f s" % (
        smoke.TPCH_SF, time.perf_counter() - t0), flush=True)
    for label, sides, _ in smoke.join_phase_cases(dev, data):
        AK, _, a_n, BK, _, b_n = sides
        want = list(K.join_ranges_plain(AK, a_n, BK, b_n))
        na, nb = int(a_n.sum().item()), int(b_n.sum().item())
        kb = sum(k.element_size() for k in AK)
        versions = []
        if old is not None:
            versions.append(("old", lambda: old_join_ranges(
                old, AK, a_n, BK, b_n)))
        versions.append(("new", lambda: K.join_ranges(AK, a_n, BK, b_n)))
        notes = {
            "bound_ms": smoke.bound_ms((na + nb) * kb + 3 * smoke.nbytes(
                want[0]) + smoke.nbytes(a_n, b_n, want[3])),
            "nk": len(AK), "a_rows": na, "b_rows": nb,
            "cap_a": AK[0].shape[1], "cap_b": BK[0].shape[1],
            "pairs": int(want[3].sum().item())}
        profile("k12", label, versions, list, want, notes, graph=("new",))
        splits = [("new", new_join_ranges)]
        if old is not None:
            splits.insert(0, ("old", lambda *a, marks: old_join_ranges(
                old, *a, marks=marks)))
        for name, call in splits:
            print("k12 split %s %s: %s" % (name, label, split(
                call, AK, a_n, BK, b_n)), flush=True)
        del sides, AK, BK, want
        torch.cuda.empty_cache()


def compare_k8s(dev, old):
    """K8's state gather at the smoke's phase shape, class by class
    ("zero"; "edge" on the widest), old, new, new, old; the class times
    summed a version."""
    vt, ft, table, classes, notes = smoke.state_gather_inputs(K, dev)
    print("k8s inputs: %s" % notes, flush=True)
    sums = {}
    for b, G, B, boff, bcnt, live, rows in classes:
        for pad in ("zero", "edge") if b == classes[-1][0] else ("zero",):
            args = (*table, boff, bcnt, G, B, vt, ft, pad)
            want = list(K.bucket_gather_state_plain(*args))
            versions = []
            if old is not None:
                versions.append(("old", lambda: old_state_gather(
                    old, *args)))
            versions.append(("new", lambda: K.bucket_gather_state(*args)))
            notes = {"B": B, "G": G, "live": live, "rows": rows,
                     "bound_ms": smoke.bound_ms(
                         rows * 16 + live * 12 + smoke.nbytes(*want)
                         + smoke.nbytes(boff, bcnt))}
            times, device = profile("k8s", "class %d %s" % (b, pad),
                                    versions, list, want, notes,
                                    graph=("old", "new"))
            if pad == "zero":
                for name, ms in times.items():
                    sums[name] = sums.get(name, 0.0) + min(ms)
                for name, ms in device.items():
                    key = name + "_device"
                    sums[key] = sums.get(key, 0.0) + ms
            del want
    print("k8s sum of %d classes: %s" % (len(classes), " ".join(
        "%s=%.4f" % kv for kv in sums.items())), flush=True)


_PREGEL = {}


def pregel_state(dev):
    """The smoke's PageRank DevicePregel after superstep 0 on the Graph500
    graph and superstep 1's pending messages (built once a process)."""
    if not _PREGEL:
        t0 = time.perf_counter()
        graph = smoke.kronecker_graph(smoke.GRAPH_SCALE, smoke.EDGE_FACTOR)
        dp = smoke.pregel_after_step0(dev, graph)
        _PREGEL["dp"], _PREGEL["pending"] = dp, dp._p_gen()[0]
        print("pregel: graph and superstep 0 in %.1f s" % (
            time.perf_counter() - t0), flush=True)
    return _PREGEL["dp"], _PREGEL["pending"]


def k4_cases(dev):
    """(label, (leaves, counts, offsets, cap_out)): the smoke's K4 phases
    (the combined reduceByKey output of bench.py's data, the sort path's
    exchange, a PageRank superstep's message exchange)."""
    from dpark_tpu_torch.backend.cuda import collectives as C
    from dpark_tpu_torch.backend.cuda import layout
    keys, vals, n = smoke.bench_columns(dev)
    kk, vv, counts, offs = C.bucketize_combine_keys([keys], [vals], n, N,
                                                    None, monoid="add")
    del keys, vals
    yield "bench", ([kk[0]] + vv, counts, offs,
                    int(counts.sum(0).max().item()))
    del kk, vv
    torch.cuda.empty_cache()
    yield "sort path", smoke.sort_exchange_inputs(dev)
    torch.cuda.empty_cache()
    _, (counts, offs, kk, vv) = pregel_state(dev)
    yield "pregel superstep 1", ([kk] + vv, counts, offs,
                                 layout.round_capacity_fine(
                                     int(counts.sum(0).max().item())))


def compare_k4(dev, old):
    for label, (leaves, counts, offs, cap_out) in k4_cases(dev):
        args = (leaves, counts, offs, cap_out, 0, K.KEY_SENTINEL)
        out, recv = K.shard_exchange_plain(*args)
        want = list(out) + [recv]
        del out

        def outputs(res):
            return list(res[0]) + [res[1]]
        versions = []
        if old is not None:
            def old_call():
                with patched(K._libs, "shard_exchange", old["k4"]):
                    return K.shard_exchange(*args)
            versions.append(("old", old_call))
        versions.append(("new", lambda: K.shard_exchange(*args)))
        profile("k4", label, versions, outputs, want, {
            "bound_ms": smoke.exchange_bound_ms(leaves, counts, cap_out),
            "floor_ms": smoke.exchange_floor(leaves, counts, cap_out),
            "N": counts.shape[0], "cap_in": leaves[0].shape[1],
            "cap_out": cap_out, "rows": int(counts.sum().item()),
            "row_bytes": [K._row_bytes(x) for x in leaves]},
            graph=("old", "new"))
        del want, leaves, args
        torch.cuda.empty_cache()


def k10_cases(dev):
    """(label, call(fn) -> outputs, the plain outputs, notes): the smoke's
    K10 phases (the PageRank superstep-1 delivery, one call with sorted
    ids; the object PageRank's superstep-1 class tables, unsorted, one
    batched call).  call(one, batched) runs the case through the
    single-class and the batched wrapper."""
    dp, pending = pregel_state(dev)
    vid, vcnt, uk, nu, uv = smoke.pregel_deliver_inputs(dp, pending)
    args = (vid, vcnt, uk, nu, uv, "add")
    out, has = K.pregel_deliver_plain(*args)
    V, U = int(vcnt.sum().item()), int(nu.sum().item())
    yield ("pregel superstep 1",
           lambda one, batched: flat([one(*args)]), flat([(out, has)]), {
               "bound_ms": smoke.bound_ms(V * 17 + U * 16),
               "bound_padded_ms": smoke.bound_ms(vid.numel() * 17 + U * 16),
               "vertices": V, "unique": U, "cap_v": vid.shape[1],
               "cap_u": uk.shape[1]})
    del out, has, args, vid, uk, uv
    _PREGEL.clear()
    torch.cuda.empty_cache()
    graph = smoke.urand_graph(smoke.URAND_SCALE, smoke.URAND_EDGE_FACTOR)
    dop, pending = smoke.bagel_after_step0(dev, graph)
    args = smoke.bagel_deliver_inputs(dop, pending)
    classes, uk, nu, uv = args[:4]
    rb = sum(K._row_bytes(x) for x in uv)
    V = sum(int(c.sum().item()) for _, c in classes)
    slots = sum(v.numel() for v, _ in classes)
    U = int(nu.sum().item())
    yield ("bagel classes superstep 1",
           lambda one, batched: flat(batched(*args)),
           flat(K.pregel_deliver_classes_plain(*args)), {
               "bound_ms": smoke.bound_ms(V * (8 + rb + 1) + U * (8 + rb)),
               "bound_padded_ms": smoke.bound_ms(slots * (8 + rb + 1)
                                                 + U * (8 + rb)),
               "classes": len(classes),
               "caps": [v.shape[1] for v, _ in classes],
               "vertices": V, "unique": U})


def flat(res):
    """[leaves..., has] of each (message leaves, has) in turn."""
    return [x for msg, has in res for x in list(msg) + [has]]


def compare_k10(dev, old):
    """K10 at k10_cases: the old kernel (one call a class on the object
    Bagel), the new one a class, and the new batched entry."""
    def per_class(lib):
        def batched(classes, *rest):
            with patched(K._libs, "pregel_deliver", lib):
                return [K.pregel_deliver(v, c, *rest) for v, c in classes]
        return batched

    def version(lib, batched):
        def run(call):
            def one(*a):
                with patched(K._libs, "pregel_deliver", lib):
                    return K.pregel_deliver(*a)
            return lambda: call(one, batched)
        return run
    new = K._kernel("pregel_deliver")
    for label, call, want, notes in k10_cases(dev):
        makers = []
        if old is not None:
            makers.append(("old", version(old["k10"], per_class(old["k10"]))))
        if label.startswith("bagel"):
            makers.append(("new_per_class", version(new, per_class(new))))
        makers.append(("new", version(new, K.pregel_deliver_classes)))
        versions = [(name, make(call)) for name, make in makers]
        profile("k10", label, versions, list, want, notes,
                graph=tuple(n for n, _ in versions))
        del want, versions
        torch.cuda.empty_cache()


def k17_cases(dev):
    """(label, masks, ns, reduce): the smoke's bool count (8 x 8,388,608
    bools, every row valid; through monoid_reduce when `reduce`), the
    PageRank DevicePregel's active flags after superstep 0 (one class) and
    the object PageRank's after superstep 0 (every degree class)."""
    rng = np.random.default_rng(20261028)
    b = torch.from_numpy(rng.random((N, smoke.CAP)) < 0.5).to(dev)
    full = torch.full((N,), smoke.CAP, dtype=torch.int32, device=dev)
    yield "bench bool count", [b], [full], True
    del b
    dp, _ = pregel_state(dev)
    yield "pregel active count", [dp.active], [dp.vcnt], False
    del dp
    _PREGEL.clear()
    torch.cuda.empty_cache()
    graph = smoke.urand_graph(smoke.URAND_SCALE, smoke.URAND_EDGE_FACTOR)
    dop, _ = smoke.bagel_after_step0(dev, graph)
    yield ("bagel active count", [t["act"] for t in dop.tables],
           [t["vcnt"] for t in dop.tables], False)


def compare_k17(dev, old):
    """The active count: the earlier per-class calls (a bool
    monoid_reduce a class through k17_partial and k17_fold, [0].sum() and
    a running add), the same calls over the checkout's monoid_reduce,
    and active_count's one launch; at the bench shape monoid_reduce over
    bool, old and new, beside col.sum(1)."""
    for label, masks, ns, reduce in k17_cases(dev):
        valid = sum(int(n.long().clamp(max=m.shape[1]).sum().item())
                    * m[0, 0].numel() for m, n in zip(masks, ns))
        notes = {"classes": len(masks), "caps": [m.shape[1] for m in masks],
                 "valid": valid}
        if reduce:
            m, n = masks[0], ns[0]
            want = list(K.monoid_reduce_plain(m, n, "add"))
            versions = [("old", lambda: old_monoid_reduce(old, m, n, "add"))
                        ] if old is not None else []
            versions.append(("new", lambda: K.monoid_reduce(m, n, "add")))
            notes.update(bound_ms=smoke.bound_ms(valid + 4 * N + 3 * 8 * N),
                         library_ms=smoke.timed(lambda: m.sum(1), reps=20))
            profile("k17", label, versions, list, want, notes,
                    graph=tuple(v for v, _ in versions))
            continue

        def per_class(reduce_fn):
            def run():
                total = torch.zeros((), dtype=torch.int64, device=dev)
                for m, n in zip(masks, ns):
                    total = total + reduce_fn(m, n, "add")[0].sum()
                return total
            return run
        want = [K.active_count_plain(masks, ns).view(1)]
        versions = []
        if old is not None:
            versions.append(("old", per_class(
                lambda *a: old_monoid_reduce(old, *a))))
        versions += [("new_per_class", per_class(K.monoid_reduce)),
                     ("new", lambda: K.active_count(masks, ns))]
        notes.update(bound_ms=smoke.bound_ms(valid + 4 * N * len(ns) + 8))
        profile("k17", label, versions, lambda r: [r.view(1)], want, notes,
                graph=tuple(v for v, _ in versions))
        del want, versions
        torch.cuda.empty_cache()


def k8x_tables(dev):
    """(label, members, counts, offsets, [(class, G)]): the power-law
    rows' table (the smoke's K8 scatter phase) and one decayed-counter
    tick's (chip_smoke.state_gather_inputs), each as SegMapOp.apply
    scatters it: every non-empty class, G from the class histogram."""
    from dpark_tpu_torch.backend.cuda.executor import TorchExecutor
    pk, pn = smoke.power_law_columns(K, dev)
    _, _, bucket, n_seg, hist, _ = K.segment_table([pk], pn,
                                                   want_keys=False)
    del pk
    members, counts, offsets = C.bucket_members(bucket, hist, n_seg)
    yield "power-law", members, counts, offsets, [
        (b, G) for b, _, G in TorchExecutor._seg_bucket_layout(hist)]
    del members, counts, offsets, bucket
    torch.cuda.empty_cache()
    _, _, (_, _, members), classes, _ = smoke.state_gather_inputs(K, dev)
    N_, cap = members.shape
    counts = torch.zeros((N_, K.SIZE_CLASSES + 1), dtype=torch.int32,
                         device=dev)
    for b, _, _, _, bcnt, _, _ in classes:
        counts[:, b] = bcnt
    counts[:, -1] = cap - counts[:, :-1].sum(1)
    offsets = (torch.cumsum(counts, 1) - counts).to(torch.int32)
    yield "window tick", members, counts, offsets, [
        (c[0], c[1]) for c in classes]


def compare_k8x(dev, old):
    """K8's scatter at k8x_tables: the earlier path (torch.zeros of the
    output, then one k8_scatter a class on its columns of offsets and
    counts), the same per-class path over the checkout's single-class
    entry, and bucket_scatter_classes' one launch; the floor is one
    Tensor.scatter_ of a members-ordered buffer of the same values."""
    for label, members, counts, offsets, lay in k8x_tables(dev):
        classes = [b for b, _ in lay]
        N_, cap = members.shape
        gen = torch.Generator(device=dev)
        gen.manual_seed(20261101)
        results = [[torch.randint(-2 ** 40, 2 ** 40, (N_, G),
                                  generator=gen, device=dev)]
                   for _, G in lay]
        dts = [torch.int64]
        want = K.bucket_scatter_classes_plain(results, members, offsets,
                                              counts, classes, dts)

        def per_class(scatter):
            def run():
                outs = [torch.zeros((N_, cap), dtype=torch.int64,
                                    device=dev)]
                for b, res in zip(classes, results):
                    scatter(outs, res, members, offsets[:, b].contiguous(),
                            counts[:, b].contiguous())
                return outs
            return run
        versions = []
        if old is not None:
            versions.append(("old", per_class(
                lambda *a: old_bucket_scatter(old, *a))))
        versions += [("new_per_class", per_class(K.bucket_scatter)),
                     ("new", lambda: K.bucket_scatter_classes(
                         results, members, offsets, counts, classes, dts))]
        idx = members.long()
        buf = torch.gather(want[0], 1, idx)
        floor = torch.empty_like(want[0])
        lanes = int(counts[:, classes].sum().item())
        profile("k8x", label, versions, list, want, {
            "classes": len(classes), "lanes": lanes, "N": N_, "cap": cap,
            "bound_ms": smoke.bound_ms(N_ * cap * 8 + lanes * (4 + 8)
                                       + smoke.nbytes(offsets, counts)),
            "bound_members_ms": smoke.bound_ms(N_ * cap * (4 + 8)
                                               + lanes * 8),
            "bound_per_class_ms": smoke.bound_ms(N_ * cap * 8
                                                 + lanes * (4 + 8 + 8)),
            "floor_ms": smoke.timed(lambda: floor.scatter_(1, idx, buf),
                                    reps=10)},
            graph=tuple(v for v, _ in versions))
        del want, versions, results, members, idx, buf, floor
        torch.cuda.empty_cache()


COMPARE = {"k16": compare_k16, "k1": compare_k1, "k12": compare_k12,
           "k8s": compare_k8s, "k4": compare_k4, "k10": compare_k10,
           "k17": compare_k17, "k8x": compare_k8x}


def compare(args, old):
    dev = torch.device("cuda")
    for name in args.kernels.split(","):
        COMPARE[name](dev, old)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("census", "compare"))
    ap.add_argument("--old-csrc", help="a csrc/ holding the earlier "
                    "sources of the kernels compared")
    ap.add_argument("--paths", default="union,window,reduce,group,sort,"
                    "pregel,bagel,join")
    ap.add_argument("--out", default=OUT, help="census: the calls' JSON "
                    "lines")
    ap.add_argument("--old-kernels", help="census: the kernels the other "
                    "tree's replace (those of --kernels by default)")
    ap.add_argument("--kernels", default=ALL,
                    help="the kernels, of k16, k1, k12, k8s, k4, k10, k17, "
                    "k8x and (census) k12e")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    global CARD
    CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(CARD, flush=True)
    t0 = time.perf_counter()
    K.build()
    which = (args.old_kernels or args.kernels).split(",")
    if args.mode == "compare":
        which = args.kernels.split(",")
    old = build_old(args.old_csrc, which) if args.old_csrc else None
    print("build: %.2f s" % (time.perf_counter() - t0), flush=True)
    if args.mode == "census":
        census(args, old)
    else:
        compare(args, old)


if __name__ == "__main__":
    main()
