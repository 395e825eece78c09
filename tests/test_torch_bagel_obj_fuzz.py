"""Object Bagel parity fuzzer on the port (a mirror of
tests/test_bagel_fuzz.py): random numeric object programs -- random
graphs and degrees, halting and emission schedules, monoids, initial
messages, message-target modes -- built once against the port's and once
against the JAX package's Vertex / Message classes.  Every program rides
the port's device path (gpu:2 or gpu:8 with device="cpu") and equals the
JAX package's Bagel.run on its `local` master exactly (integer states)."""

import operator
import random

import pytest

import dpark_tpu.bagel as REF
import dpark_tpu_torch.bagel as PORT
from dpark_tpu import DparkContext as RefContext
from dpark_tpu_torch import DparkContext


def _build_program(rng, n, B):
    """tests/test_bagel_fuzz.py's generator, over module B's classes: it
    branches only on the superstep, the out-degree and `msg is not
    None`."""
    a = rng.choice([1, 2])
    b = rng.choice([0, 1, 2])
    c = rng.randint(-3, 3)
    fb = rng.randint(-2, 2)         # no-mail fallback constant
    halt_s = rng.randint(1, 3)
    emit_set = set(rng.sample(range(4), rng.randint(1, 4)))
    mc1 = rng.choice([1, 2])
    mc2 = rng.randint(-2, 2)
    tuple_vals = rng.random() < 0.3
    tmode = rng.choice(["edges", "computed", "first"])
    halt_and_send = rng.random() < 0.3
    tk = rng.randint(1, 5)

    def compute(vert, msg, agg, s):
        if tuple_vals:
            base, acc = vert.value
            got = msg if msg is not None else fb
            newv = (base * a + got * b + c, acc + got)
            mval = newv[0] * mc1 + mc2
        else:
            got = msg if msg is not None else fb
            newv = vert.value * a + got * b + c
            mval = newv * mc1 + mc2
        active = s < halt_s
        v = B.Vertex(vert.id, newv, vert.outEdges, active)
        emit_now = (s == halt_s) if halt_and_send \
            else (active and s in emit_set)
        if emit_now:
            if tmode == "computed":
                return (v, [B.Message((vert.id * tk + s) % n, mval)])
            if tmode == "first" and vert.outEdges:
                return (v, [B.Message(vert.outEdges[0].target_id, mval)])
            if tmode == "edges" and vert.outEdges:
                return (v, [B.Message(e.target_id, mval)
                            for e in vert.outEdges])
        return (v, [])
    return compute, tuple_vals


def _build_graph(rng, ctx, n, tuple_vals, B):
    ladder = [0, 1, 1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 17, 33]
    rows = []
    for i in range(n):
        deg = rng.choice(ladder)
        targets = [rng.randrange(n) for _ in range(deg)]
        val = (rng.randint(-5, 5), rng.randint(-2, 2)) if tuple_vals \
            else rng.randint(-5, 5)
        rows.append((i, B.Vertex(i, val, [B.Edge(t) for t in targets])))
    verts = ctx.parallelize(rows, rng.choice([2, 4]))
    init = [(rng.randrange(n), rng.randint(-4, 4))
            for _ in range(rng.randint(0, n // 2))]
    msgs = ctx.parallelize(init, 2)
    op = rng.choice([operator.add, min, max])
    return verts, msgs, B.BasicCombiner(op)


def _run(seed, B, ctx):
    rng = random.Random(seed)        # the same program on both packages
    n = rng.randint(6, 24)
    compute, tuple_vals = _build_program(random.Random(seed * 7 + 1), n, B)
    verts, msgs, combiner = _build_graph(rng, ctx, n, tuple_vals, B)
    final = B.Bagel.run(ctx, verts, msgs, compute, combiner=combiner,
                        max_superstep=6)
    return sorted((vid, v.value, v.active) for vid, v in final.collect())


@pytest.mark.parametrize("seed", range(8))
def test_object_bagel_fuzz_parity(seed):
    ref = RefContext("local")
    want = _run(seed, REF, ref)
    ref.stop()
    master = "gpu:2" if seed % 2 == 0 else "gpu:8"
    ctx = DparkContext(master, device="cpu")
    got = _run(seed, PORT, ctx)
    assert ctx.scheduler._pregel_device_used, \
        ctx.scheduler._pregel_fallback_reason
    ctx.stop()
    assert got == want, (seed, got, want)
