"""Host time of the object Bagel's walk (dpark_tpu_torch/bagel.py `_walk`:
the collected Vertex / Edge objects to numpy columns) with each form of
its per-vertex edge checks, on chip_smoke.py's GAP urand graph of Python
objects (scale 20, edge factor 16 by default):

- `_edge_columns`: the distinct types of each column checked at once,
  the edge-by-edge loop only for a vertex that fails them;
- `_edge_columns_loop`: the edge-by-edge loop alone, as the reference
  checks.

    python3 bagel_walk_time.py [--scale 20] [--reps 2]

Runs on the CPU only (numpy and Python objects).  Times the edge checks
alone over every vertex, then the whole walk, alternating the forms
(type set, loop, loop, type set, ... for `--reps` pairs); each form's
columns are checked equal.  Prints one line per timing and a JSON
summary as its last line.
"""

import argparse
import gc
import json
import os
import time

import numpy as np

from chip_smoke import URAND_EDGE_FACTOR, URAND_SCALE, urand_graph, \
    urand_objects
from dpark_tpu_torch import bagel

FORMS = {"types": bagel._edge_columns, "loop": bagel._edge_columns_loop}


def edge_pass(verts, fn):
    """fn over every vertex's out-edges, as the walk calls it: (targets,
    values, seconds)."""
    t0 = time.perf_counter()
    tgt, ev, state = [], [], None
    for v in verts:
        tl, vl, state = fn(list(v.outEdges), state)
        tgt.extend(tl)
        ev.extend(vl)
    return tgt, ev, time.perf_counter() - t0


def walk(graph, name):
    """The whole walk with the named form of the edge checks: (its
    columns, seconds)."""
    saved = bagel._edge_columns
    bagel._edge_columns = FORMS[name]
    try:
        t0 = time.perf_counter()
        cols = bagel._walk(graph, [])
        return cols, time.perf_counter() - t0
    finally:
        bagel._edge_columns = saved


def same_columns(a, b):
    ids, _, vl, act, degs, tgt, ev = a[:7]
    ids2, _, vl2, act2, degs2, tgt2, ev2 = b[:7]
    return (all(map(np.array_equal, (ids, act, degs, tgt, ev),
                    (ids2, act2, degs2, tgt2, ev2)))
            and all(map(np.array_equal, vl, vl2)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=URAND_SCALE)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    t0 = time.perf_counter()
    g = urand_graph(args.scale, URAND_EDGE_FACTOR)
    graph = dict(urand_objects(g))
    print("graph: scale %d, %d Vertex and %d Edge objects built in %.1f s;"
          " %d host cores" % (args.scale, g[0], len(g[1]),
                              time.perf_counter() - t0, os.cpu_count()),
          flush=True)
    del g
    gc.collect()
    out = {"scale": args.scale, "vertices": len(graph)}
    verts = list(graph.values())
    order = ["types", "loop", "loop", "types"] * args.reps
    ref = None
    for name in order[:2 * args.reps]:
        tgt, ev, s = edge_pass(verts, FORMS[name])
        if ref is None:
            ref = (tgt, ev)
        elif (tgt, ev) != ref:
            raise SystemExit("edge checks %s differ" % name)
        out.setdefault("edges_%s_s" % name, []).append(s)
        print("edge checks alone, %s: %.3f s" % (name, s), flush=True)
        del tgt, ev
    del ref, verts
    ref = None
    for name in order[:2 * args.reps]:
        cols, s = walk(graph, name)
        if ref is None:
            ref = cols
        elif not same_columns(cols, ref):
            raise SystemExit("walk with %s differs" % name)
        out.setdefault("walk_%s_s" % name, []).append(s)
        print("whole walk, %s: %.3f s" % (name, s), flush=True)
        del cols
    print(json.dumps(out))


if __name__ == "__main__":
    main()
