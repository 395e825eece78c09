"""Where K9 (edge_gather) and K11 (obj_emit_pack) spend their time on the
card, at the shapes of the smoke's graph paths and at a second shape
each:

  K9  (a) PageRank: the vertex rank and active flag after superstep 0 of
          run_pregel's PageRank on the Graph500 Kronecker graph at scale
          22 (chip_smoke.py's `edge_gather` phase);
      (b) SSSP: the distances and active flag of the same graph's SSSP at
          its widest frontier (the superstep with the most active
          vertices among the first 12);
  K11 (a) object PageRank superstep 1: the emission blocks of Bagel's
          object PageRank on GAP urand at scale 19 (the smoke's
          `obj_emit_pack` phase);
      (b) its last emitting superstep (19).

    python3 tools/graph_kernels_profile.py [--old-csrc DIR [--old-only]]
                                           [--k9-only | --k11-only]

Prints, for the kernels in the checkout and (with --old-csrc) for the
edge_gather.cu and obj_emit_pack.cu of another source tree built beside
them with their own C interfaces (K11's: count and scatter over
1,024-slot tiles, the output leaves in a second copy of the descriptor
table), each call's CUDA-event time in the order old, new, new, old,
its bound (bytes over 3.35 TB/s: the smoke's, K9's also over every
padded slot), the library call's time (the smoke's), and the device
time of every launch and copy of one call under torch.profiler
("launch" lines).  K9's "floors" line times the checkout's K9 with
every edge padded (its writes alone) and with each shard's live slots
sorted (its reads in row order), and torch's fill_ of tensors of its
outputs' shapes.  The old K11 call is also split by CUDA events into its
descriptor copy, count + scan, host read, second copy and scatter, and
the new one into its arguments, count + scan, host read and scatter
("split" lines).  Every output is held against the plain version bit
for bit (a divergence of the other tree's kernel is printed, not
raised), and two calls of the new kernel against each other.  Needs a
card; builds into build/graph_kernels_profile/.
"""

import argparse
import ctypes
import math
import operator
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as smoke                                  # noqa: E402
import partition_profile                                    # noqa: E402
from dpark_tpu_torch.backend.cuda import kernels as K       # noqa: E402

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
N = smoke.N_SHARDS
SSSP_PROBE_STEPS = 12


def build_old(csrc):
    """K9 and K11 of another tree as ctypes libraries with the earlier C
    interfaces (K9 without the record table; K11's count and scatter
    over a descriptor table in device memory)."""
    out = os.path.join(ROOT, "build", "graph_kernels_profile")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name in ("edge_gather", "obj_emit_pack"):
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
    k9 = libs["edge_gather"].dpk_edge_gather
    k9.argtypes = [_P, _P, _I, _L, _L, _P, _P, _P, _I, _P, _P, _P]
    k9.restype = ctypes.c_int
    count = libs["obj_emit_pack"].dpk_obj_emit_count
    count.argtypes = [_P, _I, _I, _I, _L, _P, _P, _P]
    count.restype = ctypes.c_int
    scatter = libs["obj_emit_pack"].dpk_obj_emit_scatter
    scatter.argtypes = [_P, _I, _I, _I, _I, _L, _P, _P, _L, _P, _P]
    scatter.restype = ctypes.c_int
    return k9, (count, scatter)


def old_edge_gather(fn, e_slot, ecnt, leaves, gate):
    """The earlier K9 on kernels.edge_gather's inputs."""
    N_, cap_e = e_slot.shape
    cap_v = gate.shape[1]
    dev = e_slot.device
    out = [torch.empty((N_, cap_e) + tuple(v.shape[2:]), dtype=v.dtype,
                       device=dev) for v in leaves]
    sa = torch.empty((N_, cap_e), dtype=torch.bool, device=dev)
    rc = fn(e_slot.data_ptr(), ecnt.data_ptr(), N_, cap_e, cap_v,
            K._ptrs(leaves), K._ptrs(out),
            (ctypes.c_int64 * max(1, len(leaves)))(
                *[K._row_bytes(v) for v in leaves]),
            len(leaves), gate.data_ptr(), sa.data_ptr(), K._stream())
    if rc:
        raise RuntimeError("old K9 failed to launch: %d" % rc)
    return out, sa


def old_emit_pack(fns, blocks, marks=None):
    """The earlier K11 wrapper (1,024-slot tiles, the descriptor table
    copied twice, pageable); `marks` collects (label, CUDA event) after
    each of its stages."""
    count_fn, scatter_fn = fns
    N_ = blocks[0][0].shape[0]
    nl = len(blocks[0][2])
    spec = [(leaf.dtype, tuple(leaf.shape[3:])) for leaf in blocks[0][2]]
    dev = blocks[0][0].device
    W = 5 + nl

    def mark(label):
        if marks is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((label, ev, time.perf_counter()))
    mark("start")
    rows, tiles = [], 0
    for gate, dst, lv in blocks:
        cap, m = dst.shape[1], dst.shape[2]
        rows += [gate.data_ptr(), dst.data_ptr(), cap, m, tiles]
        rows += [leaf.data_ptr() for leaf in lv]
        tiles += -(-cap * m // 1024)
    lb = [leaf.element_size() * math.prod(leaf.shape[3:])
          for leaf in blocks[0][2]]
    tileoff = torch.empty((N_, max(1, tiles)), dtype=torch.int32,
                          device=dev)
    counts = torch.empty((N_,), dtype=torch.int32, device=dev)
    table = torch.tensor(rows + lb + [0] * nl, dtype=torch.int64)
    desc = table.to(dev)
    mark("copy")
    rc = count_fn(desc.data_ptr(), len(blocks), W, N_, tiles,
                  tileoff.data_ptr(), counts.data_ptr(), K._stream())
    if rc:
        raise RuntimeError("old K11 count failed to launch: %d" % rc)
    mark("count+scan")
    cap_out = K._emit_width(counts)
    mark("host read")
    dst_out = torch.empty((N_, cap_out), dtype=torch.int64, device=dev)
    leaves = [torch.empty((N_, cap_out) + shp, dtype=dt, device=dev)
              for dt, shp in spec]
    table[len(rows) + nl:] = torch.tensor([o.data_ptr() for o in leaves],
                                          dtype=torch.int64)
    desc = table.to(dev)
    mark("second copy")
    rc = scatter_fn(desc.data_ptr(), len(blocks), W, nl, N_, tiles,
                    tileoff.data_ptr(), counts.data_ptr(), cap_out,
                    dst_out.data_ptr(), K._stream())
    if rc:
        raise RuntimeError("old K11 scatter failed to launch: %d" % rc)
    mark("scatter")
    return dst_out, leaves, counts


def new_emit_pack(blocks, marks):
    """kernels.obj_emit_pack's launches on its own arguments, with a CUDA
    event after each stage (its checks left out)."""
    count_fn, scatter_fn = K._kernel("obj_emit_pack")
    N_ = blocks[0][0].shape[0]
    nl = len(blocks[0][2])
    spec = [(leaf.dtype, tuple(leaf.shape[3:])) for leaf in blocks[0][2]]
    dev = blocks[0][0].device

    def mark(label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((label, ev, time.perf_counter()))
    mark("start")
    first = [0]
    for _, dst, _ in blocks:
        first.append(first[-1] + -(-dst.shape[1] * dst.shape[2]
                                    // K.K11_TILE))
    nb = len(blocks)
    desc = (nb, K._ptrs([g for g, _, _ in blocks]),
            K._ptrs([d for _, d, _ in blocks]),
            (ctypes.c_int64 * nb)(*[d.shape[1] for _, d, _ in blocks]),
            (ctypes.c_int64 * nb)(*[d.shape[2] for _, d, _ in blocks]),
            (ctypes.c_int64 * (nb + 1))(*first))
    src = K._ptrs([x for _, _, lv in blocks for x in lv])
    lb = (ctypes.c_int64 * max(1, nl))(*[
        leaf.element_size() * math.prod(leaf.shape[3:])
        for leaf in blocks[0][2]])
    tileoff = torch.empty((N_, max(1, first[-1])), dtype=torch.int32,
                          device=dev)
    counts = torch.empty((N_,), dtype=torch.int32, device=dev)
    mark("arguments")
    if count_fn(*desc, N_, tileoff.data_ptr(), counts.data_ptr(),
                K._stream()):
        raise RuntimeError("K11 count failed to launch")
    mark("count+scan")
    host = counts.cpu()
    cap_out = K._emit_width(host)
    fill = -(-(cap_out - int(host.min())) // K.K11_TILE)
    mark("host read")
    dst_out = torch.empty((N_, cap_out), dtype=torch.int64, device=dev)
    leaves = [torch.empty((N_, cap_out) + shp, dtype=dt, device=dev)
              for dt, shp in spec]
    if scatter_fn(*desc, src, nl, N_, tileoff.data_ptr(),
                  counts.data_ptr(), cap_out, fill, dst_out.data_ptr(),
                  K._ptrs(leaves), lb, K._stream()):
        raise RuntimeError("K11 scatter failed to launch")
    mark("scatter")
    return dst_out, leaves, counts


def k11_split(call, blocks, reps=5):
    """One K11 call's stages by CUDA events (device ms between marks, each
    also by the host clock), the mean over `reps` calls; `call(blocks,
    marks)` is old_emit_pack or new_emit_pack."""
    call(blocks, [])
    torch.cuda.synchronize()
    sums = {}
    for _ in range(reps):
        marks = []
        call(blocks, marks)
        torch.cuda.synchronize()
        for (_, a, ha), (label, b, hb) in zip(marks, marks[1:]):
            dev_ms, host_ms = sums.get(label, (0.0, 0.0))
            sums[label] = (dev_ms + a.elapsed_time(b),
                           host_ms + (hb - ha) * 1e3)
    return " ".join("%s=%.4f(host %.4f)" % (label, d / reps, h / reps)
                    for label, (d, h) in sums.items())


def k9_outputs(res):
    return list(res[0]) + [res[1]]


def k11_outputs(res):
    return [res[0]] + list(res[1]) + [res[2]]


def bits(t):
    return t.contiguous().view(torch.uint8)


def same(got, want):
    """None when every output equals the plain version's bit for bit,
    else which differs."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or not torch.equal(bits(g), bits(w)):
            return "output %d differs from the plain version" % i
    return None


def k9_bounds(slot, ecnt, vals, V):
    """The smoke's K9 bounds over V vertices: the valid edges, and every
    padded slot."""
    row = sum(v[0, 0].numel() * v.element_size() for v in vals)
    E = int(ecnt.sum().item())
    return {"bound_ms": smoke.bound_ms(E * (4 + row + 1) + V * (row + 1)),
            "bound_padded_ms": smoke.bound_ms(
                slot.numel() * (4 + row + 1) + V * (row + 1)),
            "edges": E, "slots": slot.numel()}


def k9_floors(slot, ecnt, vals, gate):
    """The checkout's K9 on two variants of the inputs, to split its time:
    every edge padded (ecnt 0: the outputs' writes alone), and each
    shard's live slots sorted (the same reads in row order, so that they
    are no longer random)."""
    none = torch.zeros_like(ecnt)
    ordered = torch.sort(torch.where(
        torch.arange(slot.shape[1], device=slot.device)[None, :]
        < ecnt[:, None], slot, torch.iinfo(torch.int32).max), 1).values
    ordered = torch.where(ordered == torch.iinfo(torch.int32).max, 0,
                          ordered).contiguous()
    outs = [torch.empty(slot.shape + v.shape[2:], dtype=v.dtype,
                        device=v.device) for v in vals]
    flags = torch.empty(slot.shape, dtype=torch.bool, device=slot.device)

    def fill():
        for o in outs:
            o.fill_(1)
        flags.fill_(True)
    return {"writes_only": smoke.timed(
                lambda: K.edge_gather(slot, none, vals, gate)),
            "rows_in_order": smoke.timed(
                lambda: K.edge_gather(ordered, ecnt, vals, gate)),
            "torch_fill_of_the_outputs": smoke.timed(fill)}


def k9_library(slot, ecnt, vals, gate):
    live = torch.arange(slot.shape[1], device=slot.device)[None, :] \
        < ecnt[:, None]

    def library():
        idx = slot.long()
        return ([torch.gather(v, 1, idx) for v in vals],
                torch.gather(gate, 1, idx) & live)
    return library


def k9_cases(dev):
    from dpark_tpu_torch.backend.cuda.bagel import DevicePregel
    from dpark_tpu_torch.backend.cuda.executor import TorchExecutor
    t0 = time.perf_counter()
    n, src, dst, source = smoke.kronecker_graph(smoke.GRAPH_SCALE,
                                                smoke.EDGE_FACTOR)
    print("graph: Kronecker scale %d, %d edges, in %.1f s" % (
        smoke.GRAPH_SCALE, len(src), time.perf_counter() - t0), flush=True)
    ex = TorchExecutor(N, dev)
    dp = DevicePregel(ex, np.arange(n), np.full(n, 1.0 / n), (src, dst),
                      *smoke.pagerank_fns(n),
                      max_superstep=smoke.PR_STEPS + 1)
    dp._p_step(0, None)
    V = int(dp.vcnt.sum().item())
    yield "(a) PageRank superstep 1", (dp.e_slot, dp.ecnt, dp.values,
                                       dp.active, V)
    del dp
    weights = np.random.default_rng(20261022).integers(
        1, 100, len(src)).astype(np.float64)
    dp = DevicePregel(ex, np.arange(n), np.full(n, np.inf), (src, dst),
                      *smoke.sssp_fns(), combine="min",
                      edge_values=weights,
                      initial_messages=(np.array([source]),
                                        np.array([0.0])),
                      max_superstep=smoke.SSSP_MAX_SUPERSTEP)
    del src, dst, weights
    pending, total = dp._p_init()
    best = (-1, None, None)
    for s in range(SSSP_PROBE_STEPS):
        n_act = dp._p_step(s, pending if total > 0 else None)
        if n_act > best[0]:
            best = (n_act, s, ([v.clone() for v in dp.values],
                               dp.active.clone()))
        pending, total = dp._p_gen()
        if n_act == 0 and total == 0:
            break
    n_act, s, (vals, act) = best
    print("sssp: widest frontier after superstep %d: %d active" % (
        s, n_act), flush=True)
    yield "(b) SSSP superstep %d" % (s + 1), (dp.e_slot, dp.ecnt, vals, act,
                                              V)


def k11_bounds(blocks, kept):
    rows = sum(g.numel() for g, _, _ in blocks)
    gated = sum(int(g.sum().item()) * d.shape[2] for g, d, _ in blocks)
    leaf_b = sum(x.element_size() * math.prod(x.shape[3:])
                 for x in blocks[0][2])
    return {"bound_ms": smoke.bound_ms(rows + gated * 8
                                       + kept * (8 + 2 * leaf_b)),
            "slots": sum(d.numel() for _, d, _ in blocks),
            "gated_slots": gated, "kept": kept, "blocks": len(blocks)}


def k11_library(blocks):
    def library():
        d = torch.cat([torch.where(g[:, :, None], x, K.KEY_SENTINEL)
                       .reshape(N, -1) for g, x, _ in blocks], 1)
        v = torch.cat([lv[0].reshape(N, -1) for _, _, lv in blocks], 1)
        o = torch.argsort((d == K.KEY_SENTINEL).to(torch.int8), dim=1,
                          stable=True)
        return torch.gather(d, 1, o), torch.gather(v, 1, o)
    return library


def k11_cases(dev):
    from dpark_tpu_torch.backend.cuda.bagel_obj import DeviceObjectPregel
    from dpark_tpu_torch.backend.cuda.executor import TorchExecutor
    from dpark_tpu_torch.utils import pytree
    n, src, dst = smoke.urand_graph(smoke.URAND_SCALE,
                                    smoke.URAND_EDGE_FACTOR)
    deg, tgt, ev = smoke.urand_layout(n, src, dst)
    del src, dst
    dop = DeviceObjectPregel(
        TorchExecutor(N, dev), smoke.bagel_pagerank(n), "add", pytree.LEAF,
        np.arange(n, dtype=np.int64), [np.full(n, 1.0 / n)],
        np.ones(n, bool), deg, tgt, ev, None, smoke.PR_STEPS + 1,
        combine_op=operator.add)
    del deg, tgt, ev
    pending, _, _ = dop._p_step(0, None)
    blocks, _ = dop._step_blocks(1, pending)
    yield "(a) object PageRank superstep 1", blocks
    del blocks
    # supersteps 1 .. PR_STEPS - 2 as the run takes them, then the
    # blocks of the last superstep that emits
    for s in range(1, smoke.PR_STEPS - 1):
        pending, _, _ = dop._p_step(s, pending)
    blocks, _ = dop._step_blocks(smoke.PR_STEPS - 1, pending)
    yield "(b) object PageRank superstep %d" % (smoke.PR_STEPS - 1), blocks


def profile(kernel, label, versions, outputs, want, notes, library):
    """Check, time (old, new, new, old), split each version by launch."""
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
        if not all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b)):
            raise SystemExit("%s new %s: two calls differ" % (kernel,
                                                              label))
        del a, b
    times = {name: smoke.timed(call) for name, call in versions}
    times2 = {name: smoke.timed(call) for name, call in versions[::-1]}
    print("%s library %s: ms=%.4f" % (kernel, label, smoke.timed(library)),
          flush=True)
    for name, call in versions:
        per = partition_profile.launches(call)
        print("%s %s %s: ms=%.4f,%.4f launches=%d device_ms=%.4f" % (
            kernel, name, label, times[name], times2[name], len(per),
            sum(t for _, t in per)), flush=True)
        for i, (kname, ms) in enumerate(per):
            print("%s launch %s %s #%d %s %.4f" % (
                kernel, name, label, i, kname.split("(")[0], ms))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-csrc", help="a csrc/ holding the earlier "
                    "edge_gather.cu and obj_emit_pack.cu")
    ap.add_argument("--old-only", action="store_true",
                    help="time the other tree's kernels alone")
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--k9-only", action="store_true")
    only.add_argument("--k11-only", action="store_true")
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
    old = build_old(args.old_csrc) if args.old_csrc else (None, None)
    print("build: %.2f s" % (time.perf_counter() - t0), flush=True)
    dev = torch.device("cuda")
    new = not args.old_only
    if not args.k11_only:
        for label, (slot, ecnt, vals, gate, V) in k9_cases(dev):
            want = k9_outputs(K.edge_gather_plain(slot, ecnt, vals, gate))
            versions = []
            if old[0] is not None:
                versions.append(("old", lambda: old_edge_gather(
                    old[0], slot, ecnt, vals, gate)))
            if new:
                versions.append(("new", lambda: K.edge_gather(
                    slot, ecnt, vals, gate)))
            profile("k9", label, versions, k9_outputs, want,
                    k9_bounds(slot, ecnt, vals, V),
                    k9_library(slot, ecnt, vals, gate))
            if new:
                print("k9 floors %s: %s" % (label, " ".join(
                    "%s_ms=%.4f" % kv for kv in k9_floors(
                        slot, ecnt, vals, gate).items())), flush=True)
            del want
            torch.cuda.empty_cache()
    if not args.k9_only:
        for label, blocks in k11_cases(dev):
            want = k11_outputs(K.obj_emit_pack_plain(blocks))
            versions = []
            if old[1] is not None:
                versions.append(("old", lambda: old_emit_pack(old[1],
                                                              blocks)))
            if new:
                versions.append(("new", lambda: K.obj_emit_pack(blocks)))
            profile("k11", label, versions, k11_outputs, want,
                    k11_bounds(blocks, int(want[-1].sum().item())),
                    k11_library(blocks))
            splits = [("new", new_emit_pack)] if new else []
            if old[1] is not None:
                splits.insert(0, ("old", lambda b, m: old_emit_pack(
                    old[1], b, m)))
            for name, call in splits:
                print("k11 split %s %s: %s" % (name, label,
                                               k11_split(call, blocks)),
                      flush=True)
            del want, blocks
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
