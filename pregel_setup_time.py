"""Host setup time of the port's device Pregel (DevicePregel._setup, numpy
only) with and without its two host shortcuts, on chip_smoke.py's
Graph500 Kronecker graph (scale 22, edge factor 16 by default):

- edge source -> vertex position: a lookup table over dense labels
  (`_sorted_positions`) vs the reference's clipped np.searchsorted;
- edges grouped by shard: a stable argsort of the narrowest unsigned
  copy of the shard ids (`_shard_order`) vs the reference's stable
  argsort of the int64 column.

    python3 pregel_setup_time.py [--scale 22]

Runs on the CPU (the tensors stay on the host), each form once: at
scale 22 the reference's forms take minutes.  Prints one line per
timing and a JSON summary as its last line; each pair's results are
checked equal.
"""

import argparse
import json
import os
import time
import types

import numpy as np
import torch

from chip_smoke import EDGE_FACTOR, GRAPH_SCALE, kronecker_graph, \
    pagerank_fns
from dpark_tpu_torch.backend.cuda import bagel
from dpark_tpu_torch.utils.phash import phash_np

N_SHARDS = 8


def reference_positions(sorted_ids, keys):
    """dpark_tpu/backend/tpu/bagel.py's edge source lookup."""
    n = sorted_ids.shape[0]
    return np.clip(np.searchsorted(sorted_ids, keys), 0, max(0, n - 1))


def reference_order(shard, ndev):
    """dpark_tpu/backend/tpu/bagel.py's edge order."""
    return np.argsort(shard, kind="stable")


def clock(fn, *args):
    """(fn(*args), its wall seconds)."""
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def setup_seconds(ids, graph, positions, order):
    """One DevicePregel construction on the host with the given forms of
    the two shortcuts: its setup seconds."""
    n, src, dst, _ = graph
    saved = bagel._sorted_positions, bagel._shard_order
    bagel._sorted_positions, bagel._shard_order = positions, order
    try:
        ex = types.SimpleNamespace(ndev=N_SHARDS, device=torch.device("cpu"))
        dp = bagel.DevicePregel(ex, ids, np.full(n, 1.0 / n), (src, dst),
                                *pagerank_fns(n), combine="add")
        return dp.stats["setup_seconds"]
    finally:
        bagel._sorted_positions, bagel._shard_order = saved


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=GRAPH_SCALE)
    args = ap.parse_args()
    t0 = time.perf_counter()
    graph = kronecker_graph(args.scale, EDGE_FACTOR)
    n, src = graph[0], graph[1]
    print("graph: scale %d, %d vertices, %d edges, %.1f s; %d host cores"
          % (args.scale, n, len(src), time.perf_counter() - t0,
             os.cpu_count()), flush=True)
    ids = np.arange(n, dtype=np.int64)
    out = {"scale": args.scale, "vertices": n, "edges": len(src)}

    # the lookup alone: dense labels (span n) and labels spread over 4n,
    # the table's limit (the same positions; a binary search costs the
    # same at either spread, so it runs once: ~2 minutes at scale 22)
    keys = src.astype(np.int64)
    table, s = clock(bagel._sorted_positions, ids, keys)
    ref, r = clock(reference_positions, ids, keys)
    if not np.array_equal(table, ref):
        raise SystemExit("lookup table differs from searchsorted")
    spread, s4 = clock(bagel._sorted_positions, ids * 4, keys * 4)
    if not np.array_equal(spread, ref):
        raise SystemExit("lookup table over 4n differs")
    del keys, table, ref, spread
    out.update(positions_table_s=s, positions_table_span4n_s=s4,
               positions_searchsorted_s=r)
    print("edge source lookup: table %.3f s (labels over 4n: %.3f s), "
          "searchsorted %.3f s" % (s, s4, r), flush=True)

    # the edge order alone
    edev = (phash_np(src.astype(np.int64)) % np.uint32(N_SHARDS)) \
        .astype(np.int64)
    narrow, s = clock(bagel._shard_order, edev, N_SHARDS)
    wide, r = clock(reference_order, edev, N_SHARDS)
    if not np.array_equal(narrow, wide):
        raise SystemExit("narrow edge order differs from the int64 one")
    del edev, narrow, wide
    out.update(order_narrow_s=s, order_int64_s=r)
    print("edge order: narrow key %.3f s, int64 key %.3f s" % (s, r),
          flush=True)

    # the whole setup, each form once
    for name, forms in (
            ("port", (bagel._sorted_positions, bagel._shard_order)),
            ("reference", (reference_positions, reference_order))):
        s = setup_seconds(ids, graph, *forms)
        out["setup_%s_s" % name] = s
        print("whole setup, %s forms: %.3f s" % (name, s), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
