"""Where K14 (segmented_merge) spends its time on the card, launch by
launch, at the main paths' shape (8 shards of 8,388,608 rows), for the
chip smoke's cases: (a) bench runs with the (v, 1) add, (b) one run a
shard, (c) TPC-H Q1's six leaves over four runs a shard, (d) an argmax.

    python3 tools/k14_profile.py [--old-csrc DIR]

Prints, for the kernel in the checkout and (with --old-csrc) for the
segmented_merge.cu of another source tree built beside it with its own C
interface (the levelled kernel of PR 8: one k14_fold launch a level and
one k14_fixup a level on the way down), each call's CUDA-event time and
the device time of every launch of one call under torch.profiler, in
launch order ("k14 launch" lines), with both versions' outputs held
against the plain version at every run's last row.  Needs a card; builds
into build/k14_profile/.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke                                  # noqa: E402
from dpark_tpu_torch.backend.cuda import collectives        # noqa: E402
from dpark_tpu_torch.backend.cuda import kernels as K       # noqa: E402

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def build_old(csrc):
    """The levelled K14 of another tree, as a ctypes library with PR 8's
    C interface."""
    out = os.path.join(ROOT, "build", "k14_profile")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libsegmented_merge_old.so")
    subprocess.run([K._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-I", csrc, "-o", so,
                    os.path.join(csrc, "segmented_merge.cu")], check=True)
    lib = ctypes.CDLL(so)
    lib.dpk_segmented_merge.argtypes = [_P, _P, _P, _P, _I, _P, _P, _P, _I,
                                        _L, _P, _L, _P]
    lib.dpk_segmented_merge.restype = ctypes.c_int
    lib.dpk_segmented_merge_scratch.argtypes = [_I, _L, _I]
    lib.dpk_segmented_merge_scratch.restype = ctypes.c_int64
    return lib


def old_merge(lib, starts, n, leaves, prog):
    """The levelled kernel on the same slots as kernels.segmented_merge."""
    N, cap = starts.shape
    outs = [torch.empty_like(v) for v in leaves]
    ins, ptrs, types, strides = [], [], [], []
    for v, o in zip(leaves, outs):
        w = K._lanes(v)
        for k in range(w):
            ins.append(v.data_ptr() + k * v.element_size())
            ptrs.append(o.data_ptr() + k * o.element_size())
            types.append(K._K14_TYPES[v.dtype])
            strides.append(w)
    S = len(ins)
    nbytes = lib.dpk_segmented_merge_scratch(N, cap, S)
    scratch = torch.empty((max(8, nbytes),), dtype=torch.uint8,
                          device=starts.device)
    rc = lib.dpk_segmented_merge(
        (ctypes.c_void_p * S)(*ins), (ctypes.c_void_p * S)(*ptrs),
        (ctypes.c_int * S)(*types), (ctypes.c_int64 * S)(*strides), S,
        prog.device_words(starts.device).data_ptr(), starts.data_ptr(),
        n.data_ptr(), N, cap, scratch.data_ptr(), nbytes, K._stream())
    if rc:
        raise RuntimeError("old K14 failed to launch: %d" % rc)
    return outs


def cases(dev):
    """The smoke's K14 cases (chip_smoke.k14_phases), generated alike."""
    N, cap = smoke.N_SHARDS, smoke.CAP
    keys, vals = smoke.bench_data()
    order = np.argsort(keys.reshape(N, cap), axis=1, kind="stable")
    k = torch.from_numpy(np.take_along_axis(keys.reshape(N, cap), order,
                                            1)).to(dev)
    v = torch.from_numpy(vals.reshape(N, cap)).to(dev)
    n = torch.full((N,), cap, dtype=torch.int32, device=dev)
    starts = collectives._starts([k])
    pair = smoke.k14_program(smoke._pair_sum, (np.int64, np.int64))
    yield "(a) bench runs, (v, 1) add", pair, starts, n, [v, torch.ones_like(
        v)]
    one = torch.zeros_like(starts)
    one[:, 0] = True
    yield "(b) one run a shard", pair, one, n, [v, torch.ones_like(v)]
    gen = torch.Generator(device=dev).manual_seed(20261027)
    idx = torch.arange(N * cap, device=dev).view(N, cap)
    val = torch.randn((N, cap), generator=gen, device=dev,
                      dtype=torch.float64)
    yield "(d) argmax", smoke.k14_program(
        smoke._argmax_merge, (np.int64, np.float64)), starts, n, [idx, val]
    bounds = [0, int(cap * 0.2477), int(cap * 0.4954), int(cap * 0.5037)]
    q = torch.zeros((N, cap), dtype=torch.bool, device=dev)
    q[:, bounds] = True
    qty = torch.randint(1, 51, (N, cap), generator=gen, device=dev)
    price = qty * torch.randint(90100, 209_899, (N, cap), generator=gen,
                                device=dev)
    disc = torch.randint(0, 11, (N, cap), generator=gen, device=dev)
    tax = torch.randint(0, 9, (N, cap), generator=gen, device=dev)
    dprice = price * (100 - disc)
    leaves = [qty, price, dprice, dprice * (100 + tax), disc.double() / 100,
              torch.ones_like(qty)]
    yield "(c) tpch q1 6 leaves", smoke.k14_program(
        smoke.q1_merge, (np.int64,) * 4 + (np.float64, np.int64)), q, n, \
        leaves


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


def check(label, got, want, starts, n):
    last = smoke.run_last(starts, n)
    for g, w in zip(got, want):
        g, w = g[last], w[last]
        if g.dtype.is_floating_point:
            rel = float(((g - w).abs() / w.abs().clamp_min(1e-300)).max())
            if rel > smoke.K14_FLOAT_RTOL:
                raise SystemExit("%s: relative error %g" % (label, rel))
        elif not torch.equal(g, w):
            raise SystemExit("%s differs from the plain version" % label)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-csrc", help="a csrc/ holding the levelled K14")
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
    dev = torch.device("cuda")
    for label, prog, starts, n, leaves in cases(dev):
        want = K.segmented_merge_plain(starts, n, leaves, prog)
        versions = [("new", lambda: K.segmented_merge(starts, n, leaves,
                                                      prog))]
        if old is not None:
            versions.insert(0, ("old", lambda: old_merge(
                old, starts, n, leaves, prog)))
        for name, call in versions:
            check("%s %s" % (name, label), call(), want, starts, n)
            # two runs of the same input give the same bits at run ends
            last = smoke.run_last(starts, n)
            a, b = call(), call()
            if not all(torch.equal(x[last], y[last]) for x, y in zip(a, b)):
                raise SystemExit("%s %s: two runs differ" % (name, label))
            del a, b, last
        times = {name: smoke.timed(call) for name, call in versions}
        # parent, change, change, parent
        times2 = {name: smoke.timed(call) for name, call in versions[::-1]}
        for name, call in versions:
            per = launches(call)
            print("k14 %s %s: ms=%.4f,%.4f launches=%d device_ms=%.4f" % (
                name, label, times[name], times2[name], len(per),
                sum(t for _, t in per)), flush=True)
            for i, (kname, ms) in enumerate(per):
                print("k14 launch %s %s #%d %s %.4f" % (
                    name, label, i, kname.split("(")[0], ms))
        del want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
