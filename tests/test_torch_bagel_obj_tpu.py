"""Two object Bagel programs on the port's gpu:2 (device="cpu") against
the JAX package's own device path, its tpu:2 master: the ring PageRank of
tests/test_bagel_device.py and the power-law PageRank of
tests/test_bagel_obj_general.py.  Both packages must columnarize the
program (_pregel_device_used) and agree within FLOAT_TOL (the two device
paths add messages in other orders).  Kept apart from
tests/test_torch_bagel_obj.py: the reference compiles one program a
superstep, most of this file's time."""

import operator
import random

import pytest

import dpark_tpu.bagel as REF
import dpark_tpu_torch.bagel as PORT
from dpark_tpu import DparkContext as RefContext
from dpark_tpu_torch import DparkContext

FLOAT_TOL = 1e-9


def _ring(B):
    n = 8
    links = {i: [(i + 1) % n, (i * 5 + 2) % n] for i in range(n)}
    rows = [(i, B.Vertex(i, 1.0 / n, [B.Edge(t) for t in ts]))
            for i, ts in links.items()]
    return n, rows, 20, 4


def _power_law(B):
    n = 400
    ladder = [0, 1, 1, 1, 2, 2, 3, 4, 5, 6, 8, 10, 13, 16,
              20, 26, 32, 40, 64, 128]
    rng = random.Random(7)
    degs = [ladder[min(int(rng.paretovariate(1.1)) - 1, len(ladder) - 1)]
            for _ in range(n)]
    degs[0] = 128
    rows = [(i, B.Vertex(i, 1.0 / n, [B.Edge(rng.randrange(n))
                                      for _ in range(degs[i])]))
            for i in range(n)]
    return n, rows, 8, 8


def _run(B, ctx, graph):
    n, rows, steps, parts = graph(B)

    def compute(vert, msg, agg, s):
        new = vert.value if s == 0 else (
            0.15 / n + 0.85 * (msg if msg is not None else 0.0))
        active = s < steps
        v = B.Vertex(vert.id, new, vert.outEdges, active)
        if active and vert.outEdges:
            share = new / len(vert.outEdges)
            return (v, [B.Message(e.target_id, share)
                        for e in vert.outEdges])
        return (v, [])
    ctx.start()
    final = B.Bagel.run(ctx, ctx.parallelize(rows, parts),
                        ctx.parallelize([], parts), compute,
                        combiner=B.BasicCombiner(operator.add))
    out = {vid: v.value for vid, v in final.collect()}
    assert ctx.scheduler._pregel_device_used
    ctx.stop()
    return out


@pytest.mark.parametrize("graph", [_ring, _power_law],
                         ids=["ring", "power_law"])
def test_pagerank_equals_reference_device(graph):
    want = _run(REF, RefContext("tpu:2"), graph)
    got = _run(PORT, DparkContext("gpu:2", device="cpu"), graph)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= FLOAT_TOL * max(1.0, abs(want[k]))
