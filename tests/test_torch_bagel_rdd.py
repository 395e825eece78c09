"""The object Bagel's RDD-algebra superstep loop (Bagel._run_rdd: the
messages combined with combineByKey, the vertices grouped with their mail
through groupWith, the compute as a cached flatMapValue, the halting
counters by fold), a mirror of the RDD-path cases of tests/test_bagel.py:
test_aggregator_visible_next_superstep, _run_both_paths and the
fast-path-equals-RDD-path cases (PageRank, SSSP with list mail, unknown
targets, initial messages with an aggregator).

Each program is written once against a Bagel module (the port's or the
JAX package's).  With DPARK_BAGEL_FAST and the device columnarizer off,
the port's local, gpu:2 and gpu:8 masters (device="cpu") run the RDD
loop; its result equals the JAX package's RDD loop on its local master,
and the port's own driver-resident loop.  Floats compare within 1e-12
(the message sums fold in another order)."""

import contextlib
import operator
from unittest import mock

import pytest

import dpark_tpu.bagel as REF
import dpark_tpu_torch.bagel as PORT
from dpark_tpu import DparkContext as RefContext
from dpark_tpu_torch import DparkContext

MASTERS = ["local", "gpu:2", "gpu:8"]
TOL = 1e-12
GRAPH = {0: [1, 2], 1: [2], 2: [0], 3: [2]}


def prog_pagerank(B):
    n = len(GRAPH)

    def compute(vert, msg_sum, agg, superstep, damping=0.8, steps=25):
        if superstep == 0:
            new_value = vert.value
        else:
            incoming = msg_sum or 0.0
            new_value = (1 - damping) / n + damping * incoming
        active = superstep < steps
        v = B.Vertex(vert.id, new_value, vert.outEdges, active)
        out = []
        if active and vert.outEdges:
            share = new_value / len(vert.outEdges)
            out = [B.Message(e.target_id, share) for e in vert.outEdges]
        return (v, out)

    def build(c):
        verts = c.parallelize(
            [(i, B.Vertex(i, 1.0 / n, [B.Edge(t) for t in ts]))
             for i, ts in GRAPH.items()], 2)
        return verts, c.parallelize([], 2), B.BasicCombiner(operator.add)
    return compute, build, None


def prog_sssp_lists(B):
    """List-combiner mail, inactive vertices woken by messages, and a
    vertex with no outgoing edges."""
    inf = float("inf")
    chain = {0: [1, 2], 1: [3], 2: [3], 3: []}

    def compute(vert, mail, agg, superstep):
        best = vert.value
        if mail:
            best = min(best, min(mail))
        if best < vert.value or superstep == 0:
            v = B.Vertex(vert.id, best, vert.outEdges, False)
            out = ([B.Message(e.target_id, best + 1) for e in vert.outEdges]
                   if best < inf else [])
            return (v, out)
        return (B.Vertex(vert.id, vert.value, vert.outEdges, False), [])

    def build(c):
        verts = c.parallelize(
            [(i, B.Vertex(i, 0.0 if i == 0 else inf,
                          [B.Edge(t) for t in ts]))
             for i, ts in chain.items()], 2)
        return verts, c.parallelize([], 2), None
    return compute, build, None


def prog_unknown_targets(B):
    """Messages to ids not in the graph vanish."""
    def compute(vert, mail, agg, superstep):
        active = superstep < 2
        return (B.Vertex(vert.id, vert.value + (sum(mail) if mail else 0),
                         vert.outEdges, active),
                [B.Message(99, 1), B.Message(1 - vert.id, 1)]
                if active else [])

    def build(c):
        return (c.parallelize([(i, B.Vertex(i, 0, [])) for i in range(2)],
                              2), c.parallelize([], 2), None)
    return compute, build, None


def _max_aggregator(B):
    class MaxAggregator(B.Aggregator):
        def createAggregator(self, vert):
            return vert.value

        def mergeAggregators(self, a, b):
            return max(a, b)
    return MaxAggregator()


def prog_initial_messages_aggregator(B):
    seen = []

    def compute(vert, mail, agg, superstep):
        seen.append((superstep, agg))
        val = vert.value + (sum(mail) if mail else 0)
        return (B.Vertex(vert.id, val, vert.outEdges, False), [])

    def build(c):
        verts = c.parallelize(
            [(i, B.Vertex(i, float(i), [])) for i in range(4)], 2)
        msgs = c.parallelize([(0, 10.0), (0, 5.0), (3, 1.0)], 2)
        return verts, msgs, None
    return compute, build, (_max_aggregator(B), seen)


def prog_aggregator_next_superstep(B):
    """tests/test_bagel.py::test_aggregator_visible_next_superstep."""
    seen = []

    def compute(vert, mail, agg, superstep):
        if superstep == 1:
            seen.append(agg)
        active = superstep < 1
        return (B.Vertex(vert.id, vert.value, vert.outEdges, active),
                [B.Message(vert.id, 0)] if active else [])

    def build(c):
        return (c.parallelize([(i, B.Vertex(i, float(i), []))
                               for i in range(5)], 2),
                c.parallelize([], 2), None)
    return compute, build, (_max_aggregator(B), seen)


PROGS = [prog_pagerank, prog_sssp_lists, prog_unknown_targets,
         prog_initial_messages_aggregator, prog_aggregator_next_superstep]


def _run(B, c, prog):
    """(final {id: (value, active)}, the aggregates the compute saw)."""
    compute, build, agg = prog(B)
    verts, msgs, combiner = build(c)
    kw = {}
    if agg is not None:
        kw["aggregator"] = agg[0]
    final = B.Bagel.run(c, verts, msgs, compute, combiner=combiner, **kw)
    out = {vid: (v.value, v.active) for vid, v in final.collect()}
    return out, (sorted(agg[1]) if agg is not None else None)


def run_ref(prog):
    """The JAX package's RDD loop on its local master."""
    c = RefContext("local")
    try:
        with mock.patch.object(REF, "FAST_OBJECT_RUN", False):
            return _run(REF, c, prog)
    finally:
        c.stop()


def run_port(master, prog, rdd_loop=True):
    """The program on one of the port's masters, through the RDD loop
    (or, with rdd_loop False, through the driver-resident loop, the RDD
    loop then refused); the device columnarizer is off."""
    c = (DparkContext(master) if master == "local"
         else DparkContext(master, device="cpu"))
    refuse = AssertionError("the other loop ran")
    with contextlib.ExitStack() as st:
        st.enter_context(mock.patch.object(PORT, "DEVICE_OBJECT_RUN", False))
        st.enter_context(mock.patch.object(PORT, "FAST_OBJECT_RUN",
                                           not rdd_loop))
        st.enter_context(mock.patch.object(
            PORT.Bagel, "_run_fast" if rdd_loop else "_run_rdd",
            side_effect=refuse))
        try:
            return _run(PORT, c, prog), c.scheduler.history
        finally:
            c.stop()


def same(got, want):
    assert set(got) == set(want)
    for k, ((gv, ga), (wv, wa)) in ((k, (got[k], want[k])) for k in want):
        assert ga == wa, (k, got[k], want[k])
        assert abs(gv - wv) <= TOL * max(1.0, abs(wv)) or gv == wv, \
            (k, got[k], want[k])


@pytest.mark.parametrize("master", MASTERS)
@pytest.mark.parametrize("prog", PROGS, ids=lambda p: p.__name__[5:])
def test_rdd_loop_matches_reference(prog, master):
    (want, want_seen) = run_ref(prog)
    (got, seen), history = run_port(master, prog)
    same(got, want)
    assert seen == want_seen
    # one fold job a superstep (and one aggregate job with an
    # aggregator), then the final collect
    assert len(history) >= 2


@pytest.mark.parametrize("prog", PROGS, ids=lambda p: p.__name__[5:])
def test_rdd_loop_equals_driver_resident_loop(prog):
    """tests/test_bagel.py's fast-path-equals-RDD-path cases, on the
    port's own two loops."""
    (rdd, rdd_seen), _ = run_port("gpu:2", prog)
    (fast, fast_seen), _ = run_port("gpu:2", prog, rdd_loop=False)
    same(rdd, fast)
    assert rdd_seen == fast_seen


def test_aggregator_visible_next_superstep():
    (_, seen), _ = run_port("local", prog_aggregator_next_superstep)
    assert seen and all(a == 4.0 for a in seen)
