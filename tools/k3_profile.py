"""Where K3 (reduce_by_key_compact) spends its time on the card, launch by
launch, at the shapes its main paths give it (8 shards of 8,388,608
rows):

  (a) bench (dst, key): the map side's pre-combine of bench.py's pairs
      (bucketize_combine_keys after K2's destination pass), int64 add;
  (b) B6 reduce side: bench.py's pairs sorted by key (K5), int64 add,
      no destination column (segment_reduce_keys);
  (c) pregel combine: a superstep's messages at Graph500 scale 22
      (4,194,304 vertices) sorted by (dst, vertex), float64 add;
  (d) q1 last: TPC-H Q1's (dst, returnflag, linestatus) runs, "last" over
      its six leaves (after K14);
  (e) bench (dst, key) last: (a)'s rows with the tuple reduceByKey's
      (v, 1) leaves, "last" (after K14): (a)'s keys and fills without the
      fold of values.

Then the NaN check: float64 min and max over values that hold NaN at the
first, a middle and the last row of runs, inside one tile and across
tiles (the smoke's k3_nan_inputs), and the smallest input that shows a
divergence (one shard, keys [0, 0], values [1.0, NaN]).

    python3 tools/k3_profile.py [--old-csrc DIR [--old-only]]

Prints, for the kernel in the checkout and (with --old-csrc) for the
reduce_by_key.cu of another source tree built beside it with its own C
interface (the earlier kernel: flags, a one-block-a-shard scan, scatter,
offsets, then an init and a values pass a leaf over an (N, cap) segment
id), each call's CUDA-event time in the order old, new, new, old, and
the device time of every launch of one call under torch.profiler, with
every output held against the plain version (integers bit-equal, float
sums within the smoke's K3_FLOAT_RTOL of max(|plain|, 1), min / max /
last exactly, NaN in the same slots) and two calls of the new kernel
against each other bit for bit.  A divergence of the other tree's
kernel is printed, not raised.  Needs a card; builds into
build/k3_profile/.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as smoke                                  # noqa: E402
import partition_profile                                    # noqa: E402
from dpark_tpu_torch.backend.cuda import collectives       # noqa: E402
from dpark_tpu_torch.backend.cuda import kernels as K       # noqa: E402

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
N, CAP = smoke.N_SHARDS, smoke.CAP
GRAPH_VERTICES = 1 << 22


def build_old(csrc):
    """K3 of another tree as a ctypes library with the earlier C
    interface (a segment id and block counts in place of the status
    words)."""
    out = os.path.join(ROOT, "build", "k3_profile")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libreduce_by_key_old.so")
    subprocess.run([K._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-I", csrc, "-o", so,
                    os.path.join(csrc, "reduce_by_key.cu")], check=True)
    fn = ctypes.CDLL(so).dpk_reduce_by_key
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I,
                   _P, _I, _L, _P, _P, _P, _P, _P, _P]
    fn.restype = ctypes.c_int
    return fn


def old_reduce(fn, key_cols, fills, val_leaves, n, op, dst_col=None,
               n_dst=0):
    """The earlier K3 on the same inputs as kernels.reduce_by_key_compact."""
    N_, cap = key_cols[0].shape[:2]
    dev = key_cols[0].device
    key_out = [torch.empty_like(c) for c in key_cols]
    val_out = [torch.empty_like(v) for v in val_leaves]
    n_unique = torch.empty((N_,), dtype=torch.int32, device=dev)
    dcounts = torch.zeros((N_, max(1, n_dst)), dtype=torch.int32,
                          device=dev)
    doffs = torch.zeros_like(dcounts)
    seg = torch.empty((N_, cap), dtype=torch.int32, device=dev)
    blockcnt = torch.empty((N_, max(1, -(-cap // 1024))), dtype=torch.int32,
                           device=dev)
    nk, nv = len(key_cols), len(val_leaves)
    kinds = [0 if v.dtype == torch.int64 else
             1 if v.dtype == torch.float64 else 2 for v in val_leaves]
    rc = fn(K._ptrs(key_cols), K._ptrs(key_out),
            (ctypes.c_int * nk)(*[c.element_size() for c in key_cols]),
            (ctypes.c_int64 * nk)(*[int(f) for f in fills]), nk,
            dst_col if dst_col is not None else -1, int(n_dst),
            K._ptrs(val_leaves), K._ptrs(val_out),
            (ctypes.c_int64 * max(1, nv))(*[K._row_bytes(v)
                                            for v in val_leaves]),
            (ctypes.c_int * max(1, nv))(*kinds),
            (ctypes.c_int64 * max(1, nv))(*[K._lanes(v)
                                            for v in val_leaves]),
            nv, K.OPS[op], n.data_ptr(), N_, cap, n_unique.data_ptr(),
            dcounts.data_ptr(), doffs.data_ptr(), seg.data_ptr(),
            blockcnt.data_ptr(), K._stream())
    if rc:
        raise RuntimeError("old K3 failed to launch: %d" % rc)
    if dst_col is None:
        return key_out, val_out, n_unique, None, None
    return key_out, val_out, n_unique, dcounts, doffs


def outputs(res):
    return list(res[0]) + list(res[1]) + [res[2]] + (
        [res[3], res[4]] if res[3] is not None else [])


def bits(t):
    return t.contiguous().view(torch.uint8)


def divergence(got, want, op):
    """None when got agrees with the plain version (the smoke's
    k3_divergence), else what differs."""
    return smoke.k3_divergence(got, want, smoke.k3_rtol(op))[1]


def bench_inputs(dev):
    """(a): K2 (a)'s sorted (dst, key) and value."""
    bucket, nb, leaves, src = smoke.destination_inputs(K, dev)
    (sk, sv), _, sd = K.stable_partition(bucket, nb, leaves, src_idx=src)
    n = torch.full((N,), CAP, dtype=torch.int32, device=dev)
    return [sd, sk], [N, smoke.K3_KEY_FILL], [sv], n, "add", 0, N


def b6_inputs(dev):
    """(b): bench.py's pairs sorted by key on each shard (K5)."""
    keys, vals = (torch.from_numpy(c.reshape(N, CAP)).to(dev)
                  for c in smoke.bench_data())
    sk, sv = collectives._lex_sort([keys, vals], 1)
    n = torch.full((N,), CAP, dtype=torch.int32, device=dev)
    return [sk], [smoke.K3_KEY_FILL], [sv], n, "add", None, 0


def pregel_inputs(dev):
    """(c): uniform destination vertices below 2^22, the shard by the
    vertex's low bits, sorted by (dst, vertex), float64 messages."""
    gen = torch.Generator(device=dev).manual_seed(20261043)
    vert = torch.randint(0, GRAPH_VERTICES, (N, CAP), generator=gen,
                         device=dev)
    order = torch.sort(vert % N * GRAPH_VERTICES + vert, dim=1).values
    d = (order // GRAPH_VERTICES).to(torch.int32)
    k = order % GRAPH_VERTICES
    msg = torch.rand((N, CAP), generator=gen, device=dev,
                     dtype=torch.float64)
    n = torch.full((N,), CAP, dtype=torch.int32, device=dev)
    return [d, k], [N, smoke.K3_KEY_FILL], [msg], n, "add", 0, N


def q1_inputs(dev):
    return smoke.k3_q1_inputs(dev) + ("last", 0, N)


def tuple_inputs(dev):
    """(e): (a)'s rows with the (v, 1) leaves of the tuple reduceByKey,
    "last" after K14 (every run's total already at its last row)."""
    keys, fills, vals, n = bench_inputs(dev)[:4]
    return keys, fills, vals + [torch.ones_like(vals[0])], n, "last", 0, N


CASES = (("(a) bench (dst, key)", bench_inputs),
         ("(b) B6 reduce side", b6_inputs),
         ("(c) pregel combine", pregel_inputs),
         ("(d) q1 last", q1_inputs),
         ("(e) bench (dst, key) last", tuple_inputs))


def profile(label, args, old, new):
    keys, fills, vals, n, op, dst_col, n_dst = args
    want = K.reduce_by_key_compact_plain(keys, fills, vals, n, op, dst_col,
                                         n_dst)
    kept = int(want[2].sum().item())
    bound, padded = smoke.k3_bounds(keys, vals, n, kept,
                                    n_dst if dst_col is not None else 0, op)
    print("k3 %s: op=%s kept_rows=%d bound_ms=%.4f padded_bound_ms=%.4f" % (
        label, op, kept, bound, padded), flush=True)
    versions = []
    if old is not None:
        versions.append(("old", lambda: old_reduce(
            old, keys, fills, vals, n, op, dst_col, n_dst)))
    if new:
        versions.append(("new", lambda: K.reduce_by_key_compact(
            keys, fills, vals, n, op, dst_col, n_dst)))
    for name, call in versions:
        bad = divergence(call(), want, op)
        if bad is not None:
            if name == "new":
                raise SystemExit("k3 new %s: %s" % (label, bad))
            print("k3 old %s diverges: %s" % (label, bad), flush=True)
    del want
    if new:
        a, b = outputs(versions[-1][1]()), outputs(versions[-1][1]())
        if not all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b)):
            raise SystemExit("k3 new %s: two calls differ" % label)
        del a, b
    times = {name: smoke.timed(call) for name, call in versions}
    times2 = {name: smoke.timed(call) for name, call in versions[::-1]}
    for name, call in versions:
        per = partition_profile.launches(call)
        print("k3 %s %s: ms=%.4f,%.4f launches=%d device_ms=%.4f" % (
            name, label, times[name], times2[name], len(per),
            sum(t for _, t in per)), flush=True)
        for i, (kname, ms) in enumerate(per):
            print("k3 launch %s %s #%d %s %.4f" % (
                name, label, i, kname.split("(")[0], ms))


def nan_checks(dev, old, new):
    """min and max over NaN-holding values, old and new against the
    plain version; the smallest divergent input."""
    args = bench_inputs(dev)
    keys, fills, vals, n = smoke.k3_nan_inputs(args[0][0], args[0][1],
                                               args[3])
    del args
    for op in ("min", "max"):
        want = K.reduce_by_key_compact_plain(keys, fills, vals, n, op, 0, N)
        said = []
        for name, fn in (("old", old), ("new", new)):
            if not fn:
                continue
            got = (old_reduce(old, keys, fills, vals, n, op, 0, N)
                   if name == "old" else K.reduce_by_key_compact(
                       keys, fills, vals, n, op, 0, N))
            bad = divergence(got, want, op)
            if bad is not None and name == "new":
                raise SystemExit("k3 new nan %s: %s" % (op, bad))
            said.append("%s=%s" % (name, bad or "agrees"))
        print("k3 nan %s (bench runs, two one-run shards): %s" % (
            op, " ".join(said)), flush=True)
    del keys, vals, want
    k = torch.zeros((1, 2), dtype=torch.int64, device=dev)
    v = torch.tensor([[1.0, float("nan")]], dtype=torch.float64, device=dev)
    n = torch.full((1,), 2, dtype=torch.int32, device=dev)
    for op in ("min", "max"):
        row = ["plain=%s" % K.reduce_by_key_compact_plain(
            [k], [smoke.K3_KEY_FILL], [v], n, op)[1][0][0, 0].item()]
        if old is not None:
            row.append("old=%s" % old_reduce(
                old, [k], [smoke.K3_KEY_FILL], [v], n, op)[1][0][0, 0]
                .item())
        if new:
            row.append("new=%s" % K.reduce_by_key_compact(
                [k], [smoke.K3_KEY_FILL], [v], n, op)[1][0][0, 0].item())
        print("k3 nan smallest: one shard, keys [0, 0], values [1.0, nan], "
              "%s: %s" % (op, " ".join(row)), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-csrc", help="a csrc/ holding the earlier "
                    "reduce_by_key.cu")
    ap.add_argument("--old-only", action="store_true",
                    help="time the other tree's kernel alone")
    args = ap.parse_args()
    if args.old_only and not args.old_csrc:
        raise SystemExit("--old-only needs --old-csrc")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    K.build()
    old = build_old(args.old_csrc) if args.old_csrc else None
    print("build: %.2f s" % (time.perf_counter() - t0), flush=True)
    for line in K.build_logs.get("reduce_by_key_compact", "").splitlines():
        if "Compiling entry" in line or "registers" in line or (
                "spill" in line):
            print("ptxas reduce_by_key: %s" % line.strip(), flush=True)
    dev = torch.device("cuda")
    new = not args.old_only
    for label, make in CASES:
        profile(label, make(dev), old, new)
        torch.cuda.empty_cache()
    nan_checks(dev, old, new)


if __name__ == "__main__":
    main()
