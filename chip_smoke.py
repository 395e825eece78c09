"""Chip smoke test of the PyTorch/CUDA port (dpark_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit, builds the CUDA kernels from
   csrc/ and prints the build time;
2. holds each kernel (K1-K4) against its plain PyTorch version on the
   card, at the main path's shapes (8 shards of 8,388,608 rows), and
   times kernel, plain version, bound and library call;
3. drives the main path through the public API: bench.py's data (64M
   int64 pairs over 65,536 keys) -> reduceByKey -> count / collect / top
   / reduce, a map+filter chain before the shuffle, on gpu:8 and gpu,
   checked exactly against numpy, every stage on the tensor path, and
   every kernel launched by that run;
4. prints one JSON line describing every kernel, then the result line.

Exits non-zero, printing no result, without CUDA or outside the repo.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_SHARDS = 8
CAP = 8_388_608                    # rows per shard on the main path
PAIRS = N_SHARDS * CAP             # bench.py's 64M pairs
KEYS = 65_536
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
FLOAT_ATOL = 0.0                   # the smoke's values are all integers

SOURCES = {
    "hash_dst_hist": ("dpark_tpu_torch/backend/cuda/csrc/hash_dst_hist.cu",
                      "dpark_tpu/utils/phash.py:143"),
    "stable_partition": (
        "dpark_tpu_torch/backend/cuda/csrc/stable_partition.cu",
        "dpark_tpu/backend/tpu/collectives.py:156"),
    "reduce_by_key_compact": (
        "dpark_tpu_torch/backend/cuda/csrc/reduce_by_key.cu",
        "dpark_tpu/backend/tpu/collectives.py:367"),
    "shard_exchange": ("dpark_tpu_torch/backend/cuda/csrc/shard_exchange.cu",
                       "dpark_tpu/backend/tpu/collectives.py:197"),
}


def fail(msg):
    print("FAIL: %s" % msg, flush=True)
    sys.exit(1)


def timed(fn, reps=5):
    """Mean ms of fn() over `reps` launches after one warm-up (CUDA
    events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes):
    return nbytes / HBM_BYTES_PER_S * 1e3


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def max_err(pairs):
    """Max |a - b| over (kernel, plain) output pairs; raises unless the
    integer outputs are bit-identical."""
    err = 0.0
    for name, a, b in pairs:
        if a.dtype.is_floating_point:
            e = float((a - b).abs().max().item()) if a.numel() else 0.0
            if e > FLOAT_ATOL:
                fail("%s: max abs err %g > %g" % (name, e, FLOAT_ATOL))
            err = max(err, e)
        elif not torch.equal(a, b):
            bad = (a != b).nonzero()[:5].tolist()
            fail("%s differs from its plain version at %s" % (name, bad))
    return err


def kernel_phases(K, dev):
    """K1-K4 against their plain versions at the main path's shapes."""
    rng = np.random.default_rng(20261017)
    keys = torch.from_numpy(rng.integers(0, KEYS, (N_SHARDS, CAP),
                                         dtype=np.int64)).to(dev)
    vals = torch.from_numpy(rng.integers(0, 1 << 16, (N_SHARDS, CAP),
                                         dtype=np.int64)).to(dev)
    n = torch.full((N_SHARDS,), CAP, dtype=torch.int32, device=dev)
    out = {}

    # K1: hash -> destination -> histogram
    a = K.hash_dst_hist([keys], n, N_SHARDS, N_SHARDS)
    b = K.hash_dst_hist_plain([keys], n, N_SHARDS, N_SHARDS)
    err = max_err([("K1 dst", a[0], b[0]), ("K1 hist", a[1], b[1])])
    dst = a[0]
    flat_dst = (dst.long() + torch.arange(N_SHARDS, device=dev)[:, None]
                * (N_SHARDS + 1)).view(-1)
    out["hash_dst_hist"] = {
        "max_abs_err": err,
        "ms": timed(lambda: K.hash_dst_hist([keys], n, N_SHARDS, N_SHARDS)),
        "plain_ms": timed(lambda: K.hash_dst_hist_plain(
            [keys], n, N_SHARDS, N_SHARDS), reps=3),
        "bound_ms": bound_ms(nbytes(keys, n, dst, a[1])),
        "library_ms": timed(lambda: torch.bincount(
            flat_dst, minlength=N_SHARDS * (N_SHARDS + 1))),
    }

    # K2: the destination pass of the map-side sort (rows already in key
    # order through src_idx), gathering key and value
    order = torch.sort(keys, dim=1, stable=True).indices
    src = order.to(torch.int32)
    bucket = torch.gather(dst, 1, order).contiguous()
    nb = N_SHARDS + 1
    a = K.stable_partition(bucket, nb, [keys, vals], src_idx=src)
    b = K.stable_partition_plain(bucket, nb, [keys, vals], src_idx=src)
    err = max_err([("K2 key", a[0][0], b[0][0]), ("K2 val", a[0][1], b[0][1]),
                   ("K2 counts", a[1], b[1]), ("K2 bucket", a[2], b[2])])

    def library_k2():
        o = torch.sort(bucket, dim=1, stable=True).indices
        idx = torch.gather(order, 1, o)
        return torch.gather(keys, 1, idx), torch.gather(vals, 1, idx)
    out["stable_partition"] = {
        "max_abs_err": err,
        "ms": timed(lambda: K.stable_partition(bucket, nb, [keys, vals],
                                               src_idx=src)),
        "plain_ms": timed(lambda: K.stable_partition_plain(
            bucket, nb, [keys, vals], src_idx=src), reps=3),
        "bound_ms": bound_ms(nbytes(bucket, src, keys, vals)
                             + nbytes(*a[0], a[1], a[2])),
        "library_ms": timed(library_k2, reps=3),
    }

    # K3: merge runs of equal (dst, key) and pack, per destination counts
    sd, sk, sv = a[2], a[0][0], a[0][1]
    fills = [N_SHARDS, K.KEY_SENTINEL]
    a = K.reduce_by_key_compact([sd, sk], fills, [sv], n, "add", 0,
                                N_SHARDS)
    b = K.reduce_by_key_compact_plain([sd, sk], fills, [sv], n, "add", 0,
                                      N_SHARDS)
    err = max_err([("K3 dst", a[0][0], b[0][0]), ("K3 key", a[0][1], b[0][1]),
                   ("K3 val", a[1][0], b[1][0]), ("K3 n", a[2], b[2]),
                   ("K3 counts", a[3], b[3]), ("K3 offsets", a[4], b[4])])
    n_out = int(a[2].sum().item())
    out["reduce_by_key_compact"] = {
        "max_abs_err": err,
        "ms": timed(lambda: K.reduce_by_key_compact(
            [sd, sk], fills, [sv], n, "add", 0, N_SHARDS)),
        "plain_ms": timed(lambda: K.reduce_by_key_compact_plain(
            [sd, sk], fills, [sv], n, "add", 0, N_SHARDS), reps=3),
        "bound_ms": bound_ms(nbytes(sd, sk, sv, n) + n_out * (4 + 8 + 8)
                             + 2 * 4 * N_SHARDS * N_SHARDS),
        "library_ms": None,
    }

    # K4: the exchange of the combined map output
    ks, vs, counts, offs = a[0][1], a[1][0], a[3], a[4]
    cap_out = int(counts.sum(0).max().item())
    x = K.shard_exchange([ks, vs], counts, offs, cap_out, 0, K.KEY_SENTINEL)
    y = K.shard_exchange_plain([ks, vs], counts, offs, cap_out, 0,
                               K.KEY_SENTINEL)
    err = max_err([("K4 key", x[0][0], y[0][0]), ("K4 val", x[0][1], y[0][1]),
                   ("K4 counts", x[1], y[1])])
    moved = int(counts.sum().item())
    out["shard_exchange"] = {
        "max_abs_err": err,
        "ms": timed(lambda: K.shard_exchange([ks, vs], counts, offs,
                                             cap_out)),
        "plain_ms": timed(lambda: K.shard_exchange_plain(
            [ks, vs], counts, offs, cap_out, 0, K.KEY_SENTINEL), reps=3),
        "bound_ms": bound_ms(moved * 16 * 2 + nbytes(counts, offs)
                             + (N_SHARDS * cap_out - moved) * 16),
        "library_ms": None,
    }
    for name, rec in out.items():
        print("phase %s: kernel_ms=%.4f plain_ms=%.4f bound_ms=%.4f "
              "library_ms=%s max_abs_err=%g" % (
                  name, rec["ms"], rec["plain_ms"], rec["bound_ms"],
                  "null" if rec["library_ms"] is None
                  else "%.4f" % rec["library_ms"], rec["max_abs_err"]),
              flush=True)
    del keys, vals, order, src, bucket, a, b, x, y
    torch.cuda.empty_cache()
    return out


def check_stages(ctx, what):
    for st in ctx.scheduler.history[-1]["stage_info"]:
        if not st["kind"].startswith("array") or "fallback_reason" in st:
            fail("%s: stage left the tensor path: %s" % (what, st))


def act(label, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    print("action %s: %.3f s" % (label, time.perf_counter() - t0),
          flush=True)
    return res


def bench_data():
    """bench.py's columns: scrambled int keys, deterministic."""
    i = np.arange(PAIRS, dtype=np.int64)
    return (i * 2654435761) % KEYS, i & 0xFFFF


def main_path(master, keys, vals):
    """bench.py's job on one master, checked against numpy."""
    from dpark_tpu_torch import Columns, DparkContext
    sums = np.bincount(keys, weights=vals, minlength=KEYS).astype(np.int64)
    ctx = DparkContext(master)
    P = ctx.default_parallelism

    def add(a, b):
        return a + b
    r = ctx.parallelize(Columns(keys, vals), P).reduceByKey(add, P)
    if act(master + " count", r.count) != KEYS:
        fail("count")
    check_stages(ctx, master + " count")
    got = act(master + " collect", r.collect)
    check_stages(ctx, master + " collect")
    gk = np.array([k for k, _ in got], np.int64)
    gv = np.array([v for _, v in got], np.int64)
    if len(got) != KEYS or not np.array_equal(sums[gk], gv) \
            or len(set(gk.tolist())) != KEYS:
        fail("%s collect differs from numpy" % master)
    top = act(master + " top", lambda: r.top(10, key=lambda kv: kv[1]))
    check_stages(ctx, master + " top")
    order = np.argsort(-sums, kind="stable")[:10]
    if top != [(int(k), int(sums[k])) for k in order]:
        fail("%s top differs from numpy: %s" % (master, top))
    total = act(master + " reduce",
                lambda: r.map(lambda kv: kv[1]).reduce(add))
    kinds = [s["kind"] for s in ctx.scheduler.history[-1]["stage_info"]]
    if total != int(vals.sum()) or kinds != ["array+reduced"]:
        fail("%s reduce: %s %s" % (master, total, kinds))
    chain = (ctx.parallelize(Columns(keys, vals), P)
             .map(lambda kv: (kv[0], kv[1] * 3))
             .filter(lambda kv: kv[1] % 2 == 0)
             .reduceByKey(add, P))
    got = dict(act(master + " map+filter collect", chain.collect))
    check_stages(ctx, master + " map+filter")
    keep = (vals * 3) % 2 == 0
    want = np.bincount(keys[keep], weights=vals[keep] * 3,
                       minlength=KEYS).astype(np.int64)
    present = np.bincount(keys[keep], minlength=KEYS) > 0
    if got != {int(k): int(want[k]) for k in np.nonzero(present)[0]}:
        fail("%s map+filter differs from numpy" % master)
    ctx.stop()


def profile_first_action(keys, vals, top=14):
    """Where the time of the first action goes: one gpu:8 count() (map
    stage, exchange, reduce) under torch.profiler; prints the wall time,
    the summed device time and the ops with the most device time."""
    from torch.profiler import ProfilerActivity, profile
    from dpark_tpu_torch import Columns, DparkContext
    ctx = DparkContext("gpu:8")
    r = ctx.parallelize(Columns(keys, vals), 8).reduceByKey(
        lambda a, b: a + b, 8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r.count()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ctx.stop()
    rows = []
    for ev in prof.key_averages():
        # device-side events only (kernels, memcpys): a host op's device
        # time would count its kernels twice
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
    print("profile gpu:8 count: wall_ms=%.1f device_busy_ms=%.1f "
          "idle_share=%.3f" % (wall * 1e3, busy, 1 - busy / (wall * 1e3)))
    for dev_us, name, count in rows[:top]:
        print("profile  %9.3f ms  x%-4d %s" % (dev_us / 1e3, count,
                                                name[:90]))


def main():
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        sys.exit(2)
    from dpark_tpu_torch.backend.cuda import kernels as K
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print("versions: python %s torch %s cuda %s" % (
        sys.version.split()[0], torch.__version__, torch.version.cuda))
    print("build: %.2f s" % K.build(), flush=True)
    dev = torch.device("cuda")
    phases = kernel_phases(K, dev)

    keys, vals = bench_data()
    K.reset_launches()
    main_path("gpu:8", keys, vals)
    launches = dict(K.LAUNCHES)
    print("launches gpu:8: %s" % json.dumps(launches), flush=True)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail("kernels not launched on the gpu:8 main path: %s" % missing)
    K.reset_launches()
    main_path("gpu", keys, vals)
    one = dict(K.LAUNCHES)
    print("launches gpu: %s" % json.dumps(one), flush=True)
    missing = [k for k, v in one.items()
               if v == 0 and k != "shard_exchange"]
    if missing:
        fail("kernels not launched on the gpu main path: %s" % missing)

    profile_first_action(keys, vals)

    rows = []
    for name, (src, replaces) in SOURCES.items():
        rec = phases[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                     "plain_ms": rec["plain_ms"],
                     "bound_ms": rec["bound_ms"], "bound_by": "bytes",
                     "library_ms": rec["library_ms"]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
