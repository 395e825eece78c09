"""Where K2 (stable_partition) and K7 (segment_table) spend their time on
the card, launch by launch, at the main paths' shapes (8 shards of
8,388,608 rows):

  K2 (a) the map side's destination pass (nb = 9, int64 key and value
         through a sort permutation, the sorted bucket kept);
     (b) the validity partition after a K5 sort (nb = 2, through the
         permutation);
     (c) compact (nb = 2, an int64 destination and a float64 message);
     (d) bucket_members (nb = 33 over the power-law table's size
         classes, one int32 leaf);
  K7 on bench.py's keys after groupByKey(8) and on the power-law rows.

    python3 tools/partition_profile.py [--old-csrc DIR [--old-only]]

Prints, for the kernels in the checkout and (with --old-csrc) for the
stable_partition.cu and segment_table.cu of another source tree built
beside them with their own C interfaces (the earlier kernels: a
count, a one-block-a-shard scan and a scatter; a count, a scan, a write
and a sizes pass), each call's CUDA-event time in the order old, new,
new, old, and the device time of every launch of one call under
torch.profiler, in launch order ("launch" lines), with every output held
against the plain version bit for bit and two calls of the new kernel
against each other.  Needs a card; builds into build/partition_profile/.
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

import chip_smoke as smoke                                  # noqa: E402
from dpark_tpu_torch.backend.cuda import kernels as K       # noqa: E402

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def build_old(csrc):
    """K2 and K7 of another tree as ctypes libraries with the earlier
    C interfaces (a blockcnt scratch in place of the status words)."""
    out = os.path.join(ROOT, "build", "partition_profile")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name in ("stable_partition", "segment_table"):
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
    k2 = libs["stable_partition"].dpk_stable_partition
    k2.argtypes = [_P, _P, _I, _L, _I, _P, _P, _P, _I, _P, _P, _P, _P]
    k7 = libs["segment_table"].dpk_segment_table
    k7.argtypes = [_P, _P, _P, _P, _I, _P, _I, _L, _P, _P, _P, _P, _P, _P,
                   _P]
    k2.restype = k7.restype = ctypes.c_int
    return k2, k7


def old_partition(fn, bucket, nb, leaves, src):
    """The old K2 on the same inputs as kernels.stable_partition."""
    N, cap = bucket.shape
    dev = bucket.device
    out = [torch.empty_like(leaf) for leaf in leaves]
    counts = torch.empty((N, nb), dtype=torch.int32, device=dev)
    scratch = torch.empty((N, nb, max(1, -(-cap // 1024))),
                          dtype=torch.int32, device=dev)
    bucket_out = torch.empty_like(bucket)
    rc = fn(bucket.data_ptr(), src.data_ptr() if src is not None else None,
            N, cap, nb, K._ptrs(leaves), K._ptrs(out),
            (ctypes.c_int64 * len(leaves))(*[K._row_bytes(x)
                                             for x in leaves]),
            len(leaves), counts.data_ptr(), scratch.data_ptr(),
            bucket_out.data_ptr(), K._stream())
    if rc:
        raise RuntimeError("old K2 failed to launch: %d" % rc)
    return out, counts, bucket_out


def old_segment_table(fn, keys, n):
    """The old K7 on one key column, as kernels.segment_table."""
    N, cap = keys.shape
    dev = keys.device
    start_rows = torch.empty((N, cap), dtype=torch.int32, device=dev)
    sizes = torch.empty_like(start_rows)
    bucket = torch.empty_like(start_rows)
    n_seg = torch.empty((N,), dtype=torch.int32, device=dev)
    hist = torch.zeros((N, K.SIZE_CLASSES), dtype=torch.int32, device=dev)
    out = torch.empty_like(keys)
    blockcnt = torch.empty((N, -(-cap // 1024)), dtype=torch.int32,
                           device=dev)
    fill = int(torch.tensor(K._seg_fills([keys])[0], dtype=keys.dtype).view(
        torch.int64))
    rc = fn(K._ptrs([keys]), K._ptrs([out]), (ctypes.c_int * 1)(
        K._SEG_KINDS[keys.dtype]), (ctypes.c_int64 * 1)(fill), 1,
        n.data_ptr(), N, cap, start_rows.data_ptr(), sizes.data_ptr(),
        bucket.data_ptr(), n_seg.data_ptr(), hist.data_ptr(),
        blockcnt.data_ptr(), K._stream())
    if rc:
        raise RuntimeError("old K7 failed to launch: %d" % rc)
    return start_rows, sizes, bucket, n_seg, hist, [out]


def launches(call):
    """The device time of every launch of one call, in order."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    evs = sorted((ev for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda ev: ev.time_range.start)
    return [(ev.name, ev.time_range.elapsed_us() / 1e3) for ev in evs]


def same(label, got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(g, w):
            raise SystemExit("%s: output %d differs from the plain version"
                             % (label, i))


def k2_outputs(res, want_bucket):
    return list(res[0]) + [res[1]] + ([res[2]] if want_bucket else [])


def k7_outputs(res):
    return list(res[:5]) + list(res[5])


def k2_cases(dev):
    yield "(a) destination", smoke.destination_inputs(K, dev) + (True,
                                                                  None)
    yield "(b) sort validity", smoke.sort_validity_inputs(K, dev)
    yield "(c) compact", smoke.compact_inputs(dev)
    pk, pn = smoke.power_law_columns(K, dev)
    table = K.segment_table([pk], pn)
    del pk
    yield "(d) bucket_members", smoke.members_inputs(K, table)


def k7_cases(dev):
    yield "bench", smoke.bench_group_keys(dev)
    yield "power-law", smoke.power_law_columns(K, dev)


def profile(kernel, label, versions, want, bounds):
    """Check, time (old, new, new, old) and split each version."""
    print("%s %s: %s" % (kernel, label, " ".join(
        "%s=%.4f" % kv for kv in bounds.items() if kv[1] is not None)),
        flush=True)
    for name, call, pick in versions:
        same("%s %s %s" % (kernel, name, label), pick(call()), want)
    last = versions[-1]
    a, b = last[2](last[1]()), last[2](last[1]())
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise SystemExit("%s %s %s: two calls differ" % (kernel, last[0],
                                                         label))
    del a, b
    times = {name: smoke.timed(call) for name, call, _ in versions}
    times2 = {name: smoke.timed(call) for name, call, _ in versions[::-1]}
    for name, call, _ in versions:
        per = launches(call)
        print("%s %s %s: ms=%.4f,%.4f launches=%d device_ms=%.4f" % (
            kernel, name, label, times[name], times2[name], len(per),
            sum(t for _, t in per)), flush=True)
        for i, (kname, ms) in enumerate(per):
            print("%s launch %s %s #%d %s %.4f" % (
                kernel, name, label, i, kname.split("(")[0], ms))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-csrc", help="a csrc/ holding the earlier "
                    "stable_partition.cu and segment_table.cu")
    ap.add_argument("--old-only", action="store_true",
                    help="time the other tree's kernels alone")
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
    for name in ("stable_partition", "segment_table"):
        for line in K.build_logs.get(name, "").splitlines():
            if "Compiling entry" in line or "registers" in line or (
                    "spill" in line):
                print("ptxas %s: %s" % (name, line.strip()), flush=True)
    dev = torch.device("cuda")
    for label, (bucket, nb, leaves, src, wb, cnt) in k2_cases(dev):
        want = k2_outputs(K.stable_partition_plain(
            bucket, nb, leaves, src, want_bucket=wb), wb)
        versions = [] if args.old_only else [("new", lambda: (
            K.stable_partition(bucket, nb, leaves, src, want_bucket=wb,
                               counts=cnt)), lambda r: k2_outputs(r, wb))]
        if old is not None:
            versions.insert(0, ("old", lambda: old_partition(
                old[0], bucket, nb, leaves, src),
                lambda r: k2_outputs(r, wb)))
        bound, sector = smoke.partition_bounds(bucket, nb, leaves, src, wb)
        profile("k2", label, versions, want, {
            "bound_ms": bound, "sector_bound_ms": sector})
        del bucket, leaves, src, cnt, want
        torch.cuda.empty_cache()
    for label, (keys, n) in k7_cases(dev):
        plain = K.segment_table_plain([keys], n)
        want = k7_outputs(plain)
        versions = [] if args.old_only else [
            ("new", lambda: K.segment_table([keys], n), k7_outputs)]
        if old is not None:
            versions.insert(0, ("old", lambda: old_segment_table(
                old[1], keys, n), k7_outputs))
        bound, padded = smoke.seg_table_bounds(keys, n, plain)
        profile("k7", label, versions, want, {
            "bound_ms": bound, "bound_padded_ms": padded})
        del keys, n, plain, want
        torch.cuda.empty_cache()

if __name__ == "__main__":
    main()
