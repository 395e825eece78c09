"""Where K16 (union_concat) and K1 (hash_dst_hist) spend their time on the
card, launch by launch where the smoke's paths run them, and the
checkout's kernels against another tree's in one process.

    python3 tools/union_hash_profile.py census [--old-csrc DIR] [--out FILE]
                                               [--paths union,window,...]
    python3 tools/union_hash_profile.py compare --old-csrc DIR
                                                [--k16-only | --k1-only]

census: drives chip_smoke.py's paths (union, window, reduce = reduceByKey
gpu:8, group = partitionBy/groupByKey/distinct gpu:8, pregel, bagel; all
by default) with the launch counts set to 0 around each, as the smoke's
check_launches does, and records every K16 and K1 call on them: its
shape (K16: branches, rows, row bytes, cap_out; K1: the key columns, N x
cap, r, n_dst, whether the histogram and the hash are kept), its time by
CUDA events around the call, its host time, and for K16 the call split
by CUDA events into its stages (the one host read of the counts; the
earlier wrapper's Python descriptor table and its two pageable copies,
or the checkout's arguments; the kernel; the totals).  Prints one line a path, kernel and shape (the mean, least and
most ms) and writes every call as a JSON line to --out
(build/union_hash_profile/census.jsonl by default).
With --old-csrc the paths run the other tree's K16 and K1 (built with
their earlier C interfaces: K16's descriptor table and source pointers
copied to the device) in place of the checkout's.

compare: at the smoke's K16 and K1 phase shapes and at the paths' shapes
that census found, each call's CUDA-event time in the order old, new,
new, old, its bound (bytes over 3.35 TB/s), the torch composite or
library call's time, K1's floor (torch moving the same bytes: the valid
keys converted to int32, the rest filled), the K16 call's stages, every
output held against
the plain version bit for bit and two calls of the new kernel against
each other.  Needs a card; builds into build/union_hash_profile/.
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
# the checkout's wrapper (census patches K.union_concat with its recorder)
CHECKOUT_UNION_CONCAT = K.union_concat


def build_old(csrc):
    """K1 and K16 of another tree as ctypes functions: K1 with the
    checkout's C interface, K16 with the earlier one (a device
    descriptor table and a device table of source pointers)."""
    out = os.path.join(ROOT, "build", "union_hash_profile")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name in ("hash_dst_hist", "union_concat"):
        so = os.path.join(out, "lib%s_old.so" % name)
        procs[name] = (so, subprocess.Popen(
            [K._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-I",
             csrc, "-o", so, os.path.join(csrc, name + ".cu")]))
    libs = {}
    for name, (so, p) in procs.items():
        if p.wait() != 0:
            raise SystemExit("old %s failed to build" % name)
        libs[name] = ctypes.CDLL(so)
    k1 = libs["hash_dst_hist"].dpk_hash_dst_hist
    k1.argtypes = [_P, _P, _I, _P, _I, _L, _I, _I, _P, _P, _P, _P]
    k16 = libs["union_concat"].dpk_union_concat
    k16.argtypes = [_P, _I, _L, _P, _P, _P, _I, _I, ctypes.c_uint64, _P]
    k1.restype = k16.restype = ctypes.c_int
    return k1, k16


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
        return CHECKOUT_UNION_CONCAT(branches, key_leaf, key_fill)
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
        res = CHECKOUT_UNION_CONCAT(branches, key_leaf, key_fill)
    _mark(marks, "totals")
    return res


def split_ms(marks):
    """{stage: device ms since the previous mark}, 'host' the call's host
    ms."""
    out = {label: a.elapsed_time(b)
           for (_, a, _), (label, b, _) in zip(marks, marks[1:])}
    out["host"] = (marks[-1][2] - marks[0][2]) * 1e3
    return out


# ---------------------------------------------------------------------
# census: every K16 and K1 call on the smoke's paths
# ---------------------------------------------------------------------
class Census:
    def __init__(self, k16, k1_lib):
        self.path = None
        self.calls = []
        self.k16_impl = k16
        self.k1_lib = k1_lib
        self.k1_impl = K.hash_dst_hist

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
            c.update(split_ms(c.pop("_marks")))
            c["ms"] = sum(v for k, v in c.items() if k in (
                "read", "table", "copies", "arguments", "launch", "totals",
                "call"))
            if c["kernel"] == "K16":
                c["rows"] = int(c.pop("_totals").sum().item())
            else:
                c["rows"] = int(c.pop("_n").sum().item())

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
            else:
                key = ("K1", "cols=%s N=%d cap=%d r=%d n_dst=%d hist=%d "
                       "hash=%d" % (",".join(c["cols"]), c["N"], c["cap"],
                                    c["r"], c["n_dst"], c["hist"],
                                    c["hash"]))
            groups.setdefault(key, []).append(c)
        for (kernel, shape), cs in sorted(groups.items()):
            ms = [c["ms"] for c in cs]
            stages = [s for s in ("read", "table", "copies", "arguments",
                                  "launch", "totals") if s in cs[0]]
            print("census %s %s %s: launches=%d ms=%.4f (%.4f-%.4f) "
                  "total_ms=%.4f host_ms=%.4f rows=%d-%d%s" % (
                      path, kernel, shape, len(cs), np.mean(ms), min(ms),
                      max(ms), sum(ms), np.mean([c["host"] for c in cs]),
                      min(c["rows"] for c in cs), max(c["rows"] for c in cs),
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
    makers = {"union": union, "window": window, "reduce": reduce,
              "group": group, "pregel": pregel, "bagel": bagel}
    for name in which:
        yield makers[name]


def census(args, old):
    if old is not None:
        k1_lib, k16_fn = old

        def k16(branches, key_leaf=0, key_fill=K.KEY_SENTINEL, marks=None):
            return old_union_concat(k16_fn, branches, key_leaf, key_fill,
                                    marks)
    else:
        k1_lib, k16 = K._kernel("hash_dst_hist"), new_union_concat
    rec = Census(k16, k1_lib)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with patched(K, "union_concat", rec.union_concat), \
            patched(K, "hash_dst_hist", rec.hash_dst_hist), \
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


def profile(kernel, label, versions, outputs, want, notes):
    """Check, then time old, new, new, old."""
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
    times = {name: smoke.timed(call, reps=10) for name, call in versions}
    times2 = {name: smoke.timed(call, reps=10)
              for name, call in versions[::-1]}
    for name, _ in versions:
        print("%s %s %s: ms=%.4f,%.4f" % (kernel, name, label, times[name],
                                          times2[name]), flush=True)


def k16_split(call, branches, reps=5):
    call(branches, marks=[])
    torch.cuda.synchronize()
    sums = {}
    for _ in range(reps):
        marks = []
        call(branches, marks=marks)
        torch.cuda.synchronize()
        for k, v in split_ms(marks).items():
            sums[k] = sums.get(k, 0.0) + v
    return " ".join("%s=%.4f" % (k, v / reps) for k, v in sums.items())


def compare(args, old):
    dev = torch.device("cuda")
    if not args.k1_only:
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
                    old[1], branches)))
            versions.append(("new", lambda: K.union_concat(branches)))
            profile("k16", label, versions, outputs, want, {
                "bound_ms": rec["bound_ms"], **rec["notes"]})
            splits = [("new", new_union_concat)]
            if old is not None:
                splits.insert(0, ("old", lambda b, marks: old_union_concat(
                    old[1], b, marks=marks)))
            for name, call in splits:
                print("k16 split %s %s: %s" % (name, label,
                                               k16_split(call, branches)),
                      flush=True)
            del want
    if not args.k16_only:
        for label, a in k1_cases(dev):
            want = list(K.hash_dst_hist_plain(*a))
            _, rec = smoke.hash_case(K, *a)
            versions = []
            if old is not None:
                def old_call(a=a):
                    with patched(K._libs, "hash_dst_hist", old[0]):
                        return K.hash_dst_hist(*a)
                versions.append(("old", old_call))
            versions.append(("new", lambda: K.hash_dst_hist(*a)))
            profile("k1", label, versions, list, want, {
                "bound_ms": rec["bound_ms"],
                "library_ms": rec["library_ms"],
                "floor_ms": k1_floor(*a)})
            del want


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("census", "compare"))
    ap.add_argument("--old-csrc", help="a csrc/ holding the earlier "
                    "hash_dst_hist.cu and union_concat.cu")
    ap.add_argument("--paths", default="union,window,reduce,group,pregel,"
                    "bagel")
    ap.add_argument("--out", default=OUT, help="census: the calls' JSON "
                    "lines")
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--k16-only", action="store_true")
    only.add_argument("--k1-only", action="store_true")
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
