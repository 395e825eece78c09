"""Where K16 (union_concat), K1 (hash_dst_hist), K12's ranges
(join_ranges) and K8's state gather (bucket_gather_state) spend their
time on the card, call by call where the smoke's paths run them, and the
checkout's kernels against another tree's in one process.

    python3 tools/union_hash_profile.py census [--old-csrc DIR] [--out FILE]
                                               [--paths union,window,...]
    python3 tools/union_hash_profile.py compare [--old-csrc DIR]
                                                [--kernels k16,k1,k12,k8s]

census: drives chip_smoke.py's paths (union, window, reduce = reduceByKey
gpu:8, group = partitionBy/groupByKey/distinct gpu:8, pregel, bagel,
join; all by default) with the launch counts set to 0 around each, as
the smoke's check_launches does, and records every K16, K1, K12 ranges
and K8 state-gather call on them: its shape (K16: branches, rows, row
bytes, cap_out; K1: the key columns, N x cap, r, n_dst, whether the
histogram and the hash are kept; K12: nk, N, cap_a, cap_b and the valid
rows of each side; K8: the class width B, G, the live lanes and their
rows), its time by CUDA events around the call, its host time, and the
call split by CUDA events into its stages (K16: the one host read of the
counts, the earlier wrapper's Python descriptor table and its two
pageable copies or the checkout's arguments, the kernel, the totals;
K12: the host part before the launch, with the earlier wrapper's
pageable copy of the key table, then the earlier kernel's three
launches, ranges, scan and offsets, or the checkout's one; K8: the host
part, then the launch).  Prints one line a path, kernel and shape (the
mean, least and most ms) and writes every call as a JSON line to --out
(build/union_hash_profile/census.jsonl by default).
With --old-csrc the paths run the other tree's kernels named in
--old-kernels (all four by default; built with
their earlier C interfaces: K16's descriptor table and source pointers
copied to the device; K12's key table copied to the device and its
three launches one at a time, through a shim that includes the other
tree's join_expand.cu; K8's state gather without scratch) in place of
the checkout's.

compare: at the smoke's phase shapes (K16: union_phase_cases, K1:
hash_phase_cases, K12: join_phase_cases over TPC-H SF 10, K8:
state_gather_inputs, class by class), each call's CUDA-event time in the
order old, new, new, old, its bound (bytes over 3.35 TB/s), the torch
composite or library call's time, K1's floor (torch moving the same
bytes: the valid keys converted to int32, the rest filled), the K16 and
K12 calls' stages, every output held against the plain version bit for
bit and two calls of the new kernel against each other; K8's class
times summed.  Without --old-csrc, the checkout's kernels alone.  Needs
a card; builds into build/union_hash_profile/.
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
from dpark_tpu_torch.backend.cuda import kernels as K       # noqa: E402

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
N = smoke.N_SHARDS
OUT = os.path.join(ROOT, "build", "union_hash_profile", "census.jsonl")
# the checkout's wrappers (census patches K's with its recorders)
CHECKOUT = {name: getattr(K, name) for name in (
    "union_concat", "hash_dst_hist", "join_ranges", "bucket_gather_state")}
# the stages a report line prints (their mean device ms)
STAGES = ("read", "table", "copies", "arguments", "launch", "totals",
          "setup", "host_setup", "ranges", "scan", "offsets")


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


def build_old(csrc):
    """K1, K16, K12's ranges and K8's state gather of another tree as
    ctypes functions: K1 with the checkout's C interface, K16 with the
    earlier one (a device descriptor table and a device table of source
    pointers), K12 with its device key table (the whole entry and its
    three launches apart), K8 without scratch."""
    out = os.path.join(ROOT, "build", "union_hash_profile")
    os.makedirs(out, exist_ok=True)
    shim = os.path.join(out, "k12_old_shim.cu")
    with open(shim, "w") as f:
        f.write(K12_SHIM)
    procs = {}
    for name in ("hash_dst_hist", "union_concat", "join_expand",
                 "bucket_groups"):
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
    old = {"k1": libs["hash_dst_hist"].dpk_hash_dst_hist,
           "k16": libs["union_concat"].dpk_union_concat,
           "k12": libs["join_expand"].dpk_join_ranges,
           "k12_step": libs["join_expand"].dpk_k12_step,
           "k8s": libs["bucket_groups"].dpk_bucket_gather_state}
    old["k1"].argtypes = [_P, _P, _I, _P, _I, _L, _I, _I, _P, _P, _P, _P]
    old["k16"].argtypes = [_P, _I, _L, _P, _P, _P, _I, _I, ctypes.c_uint64,
                           _P]
    old["k12"].argtypes = [_P, _I, _I, _L, _L, _P, _P, _P, _P, _P, _P, _P,
                           _P]
    old["k12_step"].argtypes = [_I] + old["k12"].argtypes
    old["k8s"].argtypes = [_P, _P, _P, _P, _P, _I, _L, _I, _I, _P, _L, _P,
                           _P, _P, _P, _I, _P]
    for fn in old.values():
        fn.restype = ctypes.c_int
    return old


def _mark(marks, label):
    if marks is not None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((label, ev, time.perf_counter()))


def old_union_concat(fn, branches, key_leaf=0, key_fill=K.KEY_SENTINEL,
                     marks=None):
    """The earlier K16 wrapper: its checks, one host read, a Python
    descriptor loop, two pageable copies, the kernel, the totals' copy;
    `marks` collects (stage, CUDA event, host clock) after each."""
    _mark(marks, "start")
    # the earlier wrapper's checks
    branches = [(list(lv), n) for lv, n in branches]
    lv0 = branches[0][0]
    N_ = lv0[0].shape[0]
    nl = len(lv0)
    spec = [(leaf.dtype, tuple(leaf.shape[2:])) for leaf in lv0]
    tensors = []
    for lv, n in branches:
        K._need(len(lv) == nl and all(
            (leaf.dtype, tuple(leaf.shape[2:])) == sp
            for leaf, sp in zip(lv, spec)), "branches differ")
        K._check_cols(lv, N_, lv[0].shape[1], "branch leaves")
        K._need(n.dtype == torch.int32 and n.shape == (N_,), "counts")
        tensors += lv + [n]
    K._on_cuda(tensors)
    host, totals, cap_out = K._union_sizes([n for _, n in branches])
    _mark(marks, "read")
    dev = lv0[0].device
    out = [torch.empty((N_, cap_out) + shp, dtype=dt, device=dev)
           for dt, shp in spec]
    rows, longest = [], 0
    hc = host.tolist()
    tot = totals.tolist()
    for s in range(N_):
        at = 0
        for j, (lv, _) in enumerate(branches):
            c = hc[j][s]
            if c:
                rows += [j, s * lv[0].shape[1], s * cap_out + at, c]
                longest = max(longest, c)
                at += c
        if cap_out > tot[s]:
            rows += [-1, 0, s * cap_out + tot[s], cap_out - tot[s]]
            longest = max(longest, cap_out - tot[s])
    _mark(marks, "table")
    desc = torch.tensor(rows, dtype=torch.int64).to(dev)
    srcp = torch.tensor([leaf.data_ptr() for lv, _ in branches
                         for leaf in lv], dtype=torch.int64).to(dev)
    _mark(marks, "copies")
    fill_bits = 0
    if key_leaf is not None:
        fill_bits = K._elem_bits(key_fill, lv0[key_leaf].dtype)[0]
    rc = fn(desc.data_ptr(), len(rows) // 4, longest, srcp.data_ptr(),
            K._ptrs(out), (ctypes.c_int64 * nl)(*[K._row_bytes(o)
                                                  for o in out]),
            nl, -1 if key_leaf is None else int(key_leaf), fill_bits,
            K._stream())
    if rc:
        raise RuntimeError("old K16 failed to launch: %d" % rc)
    K.LAUNCHES["union_concat"] += 1
    _mark(marks, "launch")
    res = out, totals.to(torch.int32).to(dev)
    _mark(marks, "totals")
    return res


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
                     marks=None):
    """The checkout's K16 wrapper, with a CUDA event after its host read
    of the counts (K._union_cap_out), its arguments and the kernel (the
    library's entry)."""
    if marks is None:
        return CHECKOUT["union_concat"](branches, key_leaf, key_fill)
    read = K._union_cap_out
    fn = K._kernel("union_concat")

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
    def __init__(self, k16, k1_lib, k12, k8s):
        self.path = None
        self.calls = []
        self.k16_impl = k16
        self.k1_lib = k1_lib
        self.k1_impl = CHECKOUT["hash_dst_hist"]
        self.k12_impl = k12
        self.k8s_impl = k8s

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
            else:
                key = ("K1", "cols=%s N=%d cap=%d r=%d n_dst=%d hist=%d "
                       "hash=%d" % (",".join(c["cols"]), c["N"], c["cap"],
                                    c["r"], c["n_dst"], c["hist"],
                                    c["hash"]))
            groups.setdefault(key, []).append(c)
        for (kernel, shape), cs in sorted(groups.items()):
            ms = [c["ms"] for c in cs]
            stages = [s for s in STAGES if s in cs[0]]
            print("census %s %s %s: launches=%d ms=%.4f (%.4f-%.4f) "
                  "total_ms=%.4f host_ms=%.4f rows=%d-%d%s%s" % (
                      path, kernel, shape, len(cs), np.mean(ms), min(ms),
                      max(ms), sum(ms), np.mean([c["host"] for c in cs]),
                      min(c["rows"] for c in cs), max(c["rows"] for c in cs),
                      (" live=%d-%d" % (min(c["live"] for c in cs),
                                        max(c["live"] for c in cs))
                       if kernel == "K8s" else ""),
                      "".join(" %s=%.4f" % (s, np.mean([c[s] for c in cs]))
                              for s in stages)), flush=True)


def census_paths(which):
    """(path, function, arguments) of the smoke's paths named."""
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
    makers = {"union": union, "window": window, "reduce": reduce,
              "group": group, "pregel": pregel, "bagel": bagel,
              "join": join}
    for name in which:
        yield makers[name]


def census(args, old):
    use = set(args.old_kernels.split(",")) if old is not None else set()
    if use:
        k1_lib = old["k1"]

        def k16(branches, key_leaf=0, key_fill=K.KEY_SENTINEL, marks=None):
            return old_union_concat(old["k16"], branches, key_leaf,
                                    key_fill, marks)

        def k12(*a, marks=None):
            return old_join_ranges(old, *a, marks=marks)

        def k8s(*a, marks=None):
            return old_state_gather(old, *a, marks=marks)
    if "k1" not in use:
        k1_lib = K._kernel("hash_dst_hist")
    if "k16" not in use:
        k16 = new_union_concat
    if "k12" not in use:
        k12 = new_join_ranges
    if "k8s" not in use:
        k8s = new_state_gather
    rec = Census(k16, k1_lib, k12, k8s)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with patched(K, "union_concat", rec.union_concat), \
            patched(K, "hash_dst_hist", rec.hash_dst_hist), \
            patched(K, "join_ranges", rec.join_ranges), \
            patched(K, "bucket_gather_state", rec.bucket_gather_state), \
            open(args.out, "w") as f:
        for make in census_paths(args.paths.split(",")):
            t0 = time.perf_counter()
            path, fn, fargs = make()
            rec.path = path
            print("census %s: inputs in %.1f s" % (
                path, time.perf_counter() - t0), flush=True)
            smoke.check_launches(path, fn, *fargs)
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
            versions.append(("old", lambda: old_union_concat(
                old["k16"], branches)))
        versions.append(("new", lambda: K.union_concat(branches)))
        profile("k16", label, versions, outputs, want, {
            "bound_ms": rec["bound_ms"], **rec["notes"]})
        splits = [("new", new_union_concat)]
        if old is not None:
            splits.insert(0, ("old", lambda b, marks: old_union_concat(
                old["k16"], b, marks=marks)))
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


COMPARE = {"k16": compare_k16, "k1": compare_k1, "k12": compare_k12,
           "k8s": compare_k8s}


def compare(args, old):
    dev = torch.device("cuda")
    for name in args.kernels.split(","):
        COMPARE[name](dev, old)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("census", "compare"))
    ap.add_argument("--old-csrc", help="a csrc/ holding the earlier "
                    "hash_dst_hist.cu, union_concat.cu, join_expand.cu and "
                    "bucket_groups.cu")
    ap.add_argument("--paths", default="union,window,reduce,group,pregel,"
                    "bagel,join")
    ap.add_argument("--out", default=OUT, help="census: the calls' JSON "
                    "lines")
    ap.add_argument("--old-kernels", default="k16,k1,k12,k8s",
                    help="census: the kernels the other tree's replace")
    ap.add_argument("--kernels", default="k16,k1,k12,k8s",
                    help="compare: the kernels, of k16, k1, k12 and k8s")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    K.build()
    old = build_old(args.old_csrc) if args.old_csrc else None
    print("build: %.2f s" % (time.perf_counter() - t0), flush=True)
    if args.mode == "census":
        census(args, old)
    else:
        compare(args, old)


if __name__ == "__main__":
    main()
