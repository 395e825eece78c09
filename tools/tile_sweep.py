"""Time K2 (stable_partition), K7 (segment_table), K3
(reduce_by_key_compact), K9 (edge_gather), K11 (obj_emit_pack), K1
(hash_dst_hist), K16 (union_concat), K12's ranges (join_ranges), K8's
state gather (bucket_gather_state), K4 (shard_exchange) or K10
(pregel_deliver) built with other tile constants, each variant held
against the plain version, at the shapes of tools/partition_profile.py
(K2, K7), tools/k3_profile.py (K3), tools/graph_kernels_profile.py (K9,
K11), tools/union_hash_profile.py (K4: k4_cases, K10: k10_cases) or
chip_smoke.py's phases (K1: hash_phase_cases, K16: union_phase_cases,
K12: join_phase_cases over TPC-H SF 10, K8: state_gather_inputs, the 20
classes in one call and the widest alone).

    python3 tools/tile_sweep.py k2|k7|k3|k9|k11|k1|k16|k12|k8s|k4|k10 \
        [NAME=VALUE,...] ...

Each argument after the kernel is one variant: the `#define NAME ...`
lines of its source (stable_partition.cu, segment_table.cu,
reduce_by_key.cu, edge_gather.cu, obj_emit_pack.cu, hash_dst_hist.cu,
union_concat.cu, join_expand.cu, bucket_groups.cu, shard_exchange.cu:
K4_ROWS, K4_THREADS, K4_UNROLL; or pregel_deliver.cu: K10_ITEMS,
K10_SPLITTERS, the splitter table and so its stride, K10_MIN_STRIDE,
K10_BLOCKS, K10_THREADS) rewritten with the values given (an empty
variant, "", is the checkout's source).
Every variant is built beside the others (nvcc with -Xptxas -v, all
started together) under build/tile_sweep/, bound as kernels.py binds the
checkout's library, and timed through the wrapper (the wrapper's tile
constant set to the variant's THREADS x ITEMS, K8's to its K8S_CHUNK),
in the order given and
then reversed.  Prints each variant's ptxas registers and spills and its
ms a shape (for K12, K8, K4 and K10 also its device ms, the call
replayed from a CUDA graph).  Needs a card.
"""

import ctypes
import os
import re
import shutil
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke as smoke                                  # noqa: E402
import graph_kernels_profile as graph                       # noqa: E402
import k3_profile                                           # noqa: E402
import partition_profile as prof                            # noqa: E402
import union_hash_profile as uh                             # noqa: E402
from dpark_tpu_torch.backend.cuda import kernels as K       # noqa: E402

KERNELS = {"k2": ("stable_partition", "K2", "_K2_TILE"),
           "k7": ("segment_table", "K7", "_K7_TILE"),
           "k3": ("reduce_by_key_compact", "K3", "_K3_TILE"),
           "k9": ("edge_gather", "K9", None),
           "k11": ("obj_emit_pack", "K11", "K11_TILE"),
           "k1": ("hash_dst_hist", "K1", None),
           "k16": ("union_concat", "K16", None),
           "k12": ("join_expand", "K12", "_K12_TILE"),
           "k8s": ("bucket_groups", "K8S", "_K8S_CHUNK"),
           "k4": ("shard_exchange", "K4", None),
           "k10": ("pregel_deliver", "K10", None)}
# kernels whose calls a CUDA graph captures: their device ms printed too
DEVICE = ("k12", "k8s", "k4", "k10")


def variant_source(text, defs):
    for name, value in defs.items():
        text, n = re.subn(r"(?m)^#define %s\b.*$" % re.escape(name),
                          "#define %s %s" % (name, value), text)
        if n != 1:
            raise SystemExit("no #define %s in the source" % name)
    return text


def parse(arg):
    return dict(kv.split("=", 1) for kv in arg.split(",") if kv)


def build(name, variants):
    """One library a variant; returns [(label, lib path, build log)]."""
    src = open(os.path.join(K.CSRC, K.SOURCES[name])).read()
    out = os.path.join(ROOT, "build", "tile_sweep")
    shutil.rmtree(out, ignore_errors=True)
    procs = []
    for i, defs in enumerate(variants):
        d = os.path.join(out, "v%d" % i)
        shutil.copytree(K.CSRC, d)
        path = os.path.join(d, K.SOURCES[name])
        with open(path, "w") as f:
            f.write(variant_source(src, defs))
        so = os.path.join(d, "lib%s.so" % name)
        procs.append((defs, so, subprocess.Popen(
            [K._nvcc(), "-Xptxas", "-v", "-gencode",
             "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-I", d, "-o", so, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    built = []
    for defs, so, p in procs:
        log = p.communicate()[0].decode(errors="replace")
        if p.returncode:
            print("variant %s failed to build:\n%s" % (defs, log))
            continue
        built.append((defs, so, log))
    return built


def tile_of(name, defs, prefix):
    """THREADS x ITEMS of a variant (the source's values where not
    given)."""
    src = open(os.path.join(K.CSRC, K.SOURCES[name])).read()

    def value(key):
        if key in defs:
            return int(defs[key])
        return int(re.search(r"(?m)^#define %s (\d+)" % key, src).group(1))
    if prefix == "K8S":
        return value("K8S_CHUNK")
    return value(prefix + "_THREADS") * value(prefix + "_ITEMS")


def k3_check(op):
    def check(label, got, want):
        bad = k3_profile.divergence(got, want, op)
        if bad is not None:
            raise SystemExit("%s: %s" % (label, bad))
    return check


def cases(kernel, dev):
    """(label, the plain version's outputs, a call of the checkout's
    wrapper, the check of its outputs) at each shape of the kernel."""
    if kernel == "k9":
        for label, (slot, ecnt, vals, gate, _) in graph.k9_cases(dev):
            yield (label, graph.k9_outputs(K.edge_gather_plain(
                slot, ecnt, vals, gate)), lambda: graph.k9_outputs(
                    K.edge_gather(slot, ecnt, vals, gate)), prof.same)
        return
    if kernel == "k11":
        for label, blocks in graph.k11_cases(dev):
            yield (label, graph.k11_outputs(K.obj_emit_pack_plain(blocks)),
                   lambda: graph.k11_outputs(K.obj_emit_pack(blocks)),
                   prof.same)
            del blocks
        return
    if kernel == "k1":
        for label, args in smoke.hash_phase_cases(dev):
            yield (label, [x for x in K.hash_dst_hist_plain(*args)
                           if x is not None],
                   lambda: [x for x in K.hash_dst_hist(*args)
                            if x is not None], prof.same)
            del args
        return
    if kernel == "k16":
        def outputs(res):
            return list(res[0]) + [res[1]]
        for label, branches in smoke.union_phase_cases(dev):
            yield (label, outputs(K.union_concat_plain(branches)),
                   lambda: outputs(K.union_concat(branches)), prof.same)
            del branches
        return
    if kernel == "k12":
        for label, sides, _ in smoke.join_phase_cases(dev, smoke.tpch_data()):
            AK, _, a_n, BK, _, b_n = sides
            yield (label, list(K.join_ranges_plain(AK, a_n, BK, b_n)),
                   lambda: list(K.join_ranges(AK, a_n, BK, b_n)), prof.same)
            del sides, AK, BK
        return
    if kernel == "k8s":
        vt, ft, table, classes, _ = smoke.state_gather_inputs(K, dev)

        def run(fn, which):
            return [x for b, G, B, boff, bcnt, _, _ in which
                    for x in fn(*table, boff, bcnt, G, B, vt, ft, "zero")]
        for label, which in (("20 classes", classes),
                             ("widest", classes[-1:])):
            yield (label, run(K.bucket_gather_state_plain, which),
                   lambda: run(K.bucket_gather_state, which), prof.same)
        return
    if kernel == "k4":
        def outputs(res):
            return list(res[0]) + [res[1]]
        for label, (leaves, counts, offs, cap_out) in uh.k4_cases(dev):
            args = (leaves, counts, offs, cap_out, 0, K.KEY_SENTINEL)
            yield (label, outputs(K.shard_exchange_plain(*args)),
                   lambda: outputs(K.shard_exchange(*args)), prof.same)
            del leaves, args
        return
    if kernel == "k10":
        for label, call, want, _ in uh.k10_cases(dev):
            yield (label, want, lambda: call(K.pregel_deliver,
                                             K.pregel_deliver_classes),
                   prof.same)
            del want
        return
    if kernel == "k3":
        for label, make in k3_profile.CASES:
            args = make(dev)
            yield (label, K.reduce_by_key_compact_plain(*args),
                   lambda: K.reduce_by_key_compact(*args), k3_check(args[4]))
            del args
        return
    for label, args in (prof.k2_cases(dev) if kernel == "k2"
                        else prof.k7_cases(dev)):
        if kernel == "k2":
            bucket, nb, leaves, src, wb, cnt = args
            yield (label, prof.k2_outputs(K.stable_partition_plain(
                bucket, nb, leaves, src, want_bucket=wb), wb),
                lambda: prof.k2_outputs(K.stable_partition(
                    bucket, nb, leaves, src, want_bucket=wb, counts=cnt),
                    wb), prof.same)
        else:
            keys, n = args
            yield (label, prof.k7_outputs(K.segment_table_plain([keys], n)),
                   lambda: prof.k7_outputs(K.segment_table([keys], n)),
                   prof.same)
        del args


def main():
    if len(sys.argv) < 2 or sys.argv[1] not in KERNELS:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    kernel = sys.argv[1]
    name, prefix, const = KERNELS[kernel]
    variants = [parse(a) for a in sys.argv[2:]] or [{}]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    K.build()
    built = build(name, variants)
    print("build: %.2f s" % (time.perf_counter() - t0), flush=True)
    libs = []
    for defs, so, log in built:
        label = ",".join("%s=%s" % kv for kv in defs.items()) or "checkout"
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("ptxas %s: %s" % (label, line.strip()))
        libs.append((label, K._bind(name, ctypes.CDLL(so)),
                     tile_of(name, defs, prefix) if const else None))
    dev = torch.device("cuda")
    saved = (K._libs[name], getattr(K, const) if const else None)
    try:
        for label, want, call, check in cases(kernel, dev):
            times, device = {}, {}
            for order in (libs, libs[::-1]):
                for vlabel, fn, tile in order:
                    K._libs[name] = fn
                    if const:
                        setattr(K, const, tile)
                    if vlabel not in times:
                        check("%s %s" % (vlabel, label), call(), want)
                    times.setdefault(vlabel, []).append(smoke.timed(call))
                    if kernel in DEVICE:
                        device.setdefault(vlabel, []).append(
                            uh.graph_ms(call))
            for vlabel, _, _ in libs:
                print("%s %s %s: ms=%s%s" % (
                    kernel, label, vlabel, ",".join(
                        "%.4f" % x for x in times[vlabel]),
                    " device_ms=" + ",".join("%.4f" % x for x in device[
                        vlabel]) if vlabel in device else ""), flush=True)
            del want, call
            torch.cuda.empty_cache()
    finally:
        K._libs[name] = saved[0]
        if const:
            setattr(K, const, saved[1])


if __name__ == "__main__":
    main()
