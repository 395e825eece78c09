"""Object Bagel (Bagel.run over Vertex / Edge / Message objects) on the
port, a mirror of tests/test_bagel_obj_general.py, the object cases of
tests/test_bagel_device.py and the driver-resident cases of
tests/test_bagel.py.

Every program is written once against a Bagel module (the port's or the
JAX package's classes).  The port runs it on `local`, and on gpu:2 and
gpu:8 with device="cpu" (DeviceObjectPregel with the kernels' plain
versions: K11 packs the emitted messages, K1-K5 combine and exchange
them, K10 delivers them per degree class); each result equals the JAX
package's Bagel.run on its `local` master (the driver-resident object
loop): integers and flags exactly, floats within FLOAT_TOL (the device
path adds messages in another order).  A program the reference
columnarizes must ride the port's device too, with the reference's
LAST_RUN_STATS; one that falls back must fall back with the reference's
reason.  The exceptions are the programs of ROADMAP C9 (numpy constants
in tensor arithmetic), which take the host path with the port's reason,
and C10 (the compile-budget knob, not enforced)."""

import contextlib
import operator
import random
from unittest import mock

import numpy as np
import pytest

import dpark_tpu.bagel as REF
import dpark_tpu_torch.bagel as PORT
from dpark_tpu import DparkContext as RefContext
from dpark_tpu_torch import DparkContext
from dpark_tpu_torch.backend.cuda import bagel_obj as port_obj
from dpark_tpu_torch.backend.cuda import kernels

GPU = ["gpu:2", "gpu:8"]
MASTERS = ["local"] + GPU
FLOAT_TOL = 1e-9
STATS_KEYS = ("bucketed", "classes", "widths", "msg_leaves", "msg_merge")


def _port_ctx(master):
    if master == "local":
        return DparkContext("local")
    return DparkContext(master, device="cpu")


def _final(final):
    return {vid: (v.value, v.active) for vid, v in final.collect()}


def run_port(master, prog, **kw):
    """(final {id: (value, active)}, device used, fallback reason, stats)
    of the program on one of the port's masters."""
    c = _port_ctx(master)
    c.start()
    try:
        compute, build = prog(PORT)
        verts, msgs, combiner = build(c)
        port_obj.LAST_RUN_STATS.clear()
        final = PORT.Bagel.run(c, verts, msgs, compute, combiner=combiner,
                               **kw)
        out = _final(final)
        sched = c.scheduler
        return (out, getattr(sched, "_pregel_device_used", None),
                getattr(sched, "_pregel_fallback_reason", None),
                dict(port_obj.LAST_RUN_STATS))
    finally:
        c.stop()


def run_ref(prog, master="local", **kw):
    """(final, device used) of the program on the JAX package."""
    c = RefContext(master)
    c.start()
    try:
        compute, build = prog(REF)
        verts, msgs, combiner = build(c)
        final = REF.Bagel.run(c, verts, msgs, compute, combiner=combiner,
                              **kw)
        return _final(final), getattr(c.scheduler, "_pregel_device_used",
                                      False)
    finally:
        c.stop()


class _Stop(Exception):
    pass


def _stop(self):
    raise _Stop("constructed")


@pytest.fixture(scope="module")
def ref_tpu():
    c = RefContext("tpu:2")
    c.start()
    yield c
    c.stop()


def ref_columnar(ref_tpu, prog, run=False, max_superstep=80):
    """The reference's _run_columnar on its tpu:2 master: without `run`,
    only DeviceObjectPregel's construction (class choice, message-spec
    discovery, the superstep-0 canary), which sets LAST_RUN_STATS.
    Returns (LAST_RUN_STATS or None, the _NotColumnarizable message or
    None)."""
    from dpark_tpu.backend.tpu import bagel_obj as ref_obj
    compute, build = prog(REF)
    verts, msgs, combiner = build(ref_tpu)
    collected = REF.Bagel._collect_bounded(verts, msgs)
    ref_obj.LAST_RUN_STATS.clear()
    reason = None
    patch = (mock.patch.object(ref_obj.DeviceObjectPregel, "run", _stop)
             if not run else contextlib.nullcontext())
    with patch:
        try:
            REF.Bagel._run_columnar(ref_tpu, collected, compute,
                                    combiner or REF.Combiner(), None,
                                    max_superstep, 2)
        except REF._NotColumnarizable as e:
            reason = str(e)
    stats = dict(ref_obj.LAST_RUN_STATS) or None
    if not run and reason is not None and "constructed" in reason:
        reason = None
    return stats, reason


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [y for c in x for y in _leaves(c)]
    return [x]


def same_final(got, want):
    """Equal ids and active flags; integer values exactly, float values
    within FLOAT_TOL; the same structure and kinds."""
    assert set(got) == set(want)
    for k in want:
        (gv, ga), (wv, wa) = got[k], want[k]
        assert bool(ga) == bool(wa), (k, ga, wa)
        gl, wl = _leaves(gv), _leaves(wv)
        assert len(gl) == len(wl), (k, gv, wv)
        for g, w in zip(gl, wl):
            g, w = np.asarray(g), np.asarray(w)
            assert g.shape == w.shape, (k, gv, wv)
            if w.dtype.kind == "f" or g.dtype.kind == "f":
                assert np.allclose(g.astype(np.float64), w.astype(np.float64),
                                   rtol=FLOAT_TOL, atol=FLOAT_TOL,
                                   equal_nan=True), (k, gv, wv)
            else:
                assert g.dtype.kind == w.dtype.kind, (k, gv, wv)
                assert np.array_equal(g, w), (k, gv, wv)


def check(prog, masters=MASTERS, device=True, reason=None, **kw):
    """The program on the port's masters equals the reference's local
    master; on the gpu masters it rides the device (or falls back with
    `reason`).  Returns (the reference's final, the last gpu stats)."""
    want, _ = run_ref(prog, **kw)
    stats = None
    for m in masters:
        got, used, why, st = run_port(m, prog, **kw)
        same_final(got, want)
        if m != "local":
            assert used is device, (m, why)
            if device:
                assert why is None
                stats = {k: st[k] for k in STATS_KEYS}
            elif reason is not None:
                assert why == reason, why
    return want, stats


# ----------------------------------------------------------------------
# programs, written against a Bagel module B (the port's or the JAX
# package's); tests/test_bagel_obj_general.py
# ----------------------------------------------------------------------
def _basic(B, rows, parts=8, op=operator.add, pend=()):
    def build(c):
        return (c.parallelize(rows(), parts),
                c.parallelize(list(pend), parts), B.BasicCombiner(op))
    return build


def _power_law_rows(B, n=400, seed=7):
    ladder = [0, 1, 1, 1, 2, 2, 3, 4, 5, 6, 8, 10, 13, 16,
              20, 26, 32, 40, 64, 128]
    rng = random.Random(seed)
    degs = [ladder[min(int(rng.paretovariate(1.1)) - 1, len(ladder) - 1)]
            for _ in range(n)]
    degs[0] = 128
    rows = []
    for i in range(n):
        edges = [B.Edge(rng.randrange(n)) for _ in range(degs[i])]
        rows.append((i, B.Vertex(i, 1.0 / n, edges)))
    return rows


def prog_power_law(B):
    n = 400

    def compute(vert, msg, agg, s):
        new = vert.value if s == 0 else (
            0.15 / n + 0.85 * (msg if msg is not None else 0.0))
        v = B.Vertex(vert.id, new, vert.outEdges, s < 8)
        if s < 8 and vert.outEdges:
            share = new / len(vert.outEdges)
            return (v, [B.Message(e.target_id, share)
                        for e in vert.outEdges])
        return (v, [])
    return compute, _basic(B, lambda: _power_law_rows(B, n))


def prog_non_neighbors(B):
    n = 64

    def compute(vert, msg, agg, s):
        got = msg if msg is not None else 0
        v = B.Vertex(vert.id, vert.value + got, vert.outEdges, s < 3)
        if s < 3:
            return (v, [B.Message((vert.id * vert.id + 7) % n,
                                  vert.id + 1)])
        return (v, [])
    return compute, _basic(B, lambda: [(i, B.Vertex(i, 0, []))
                                       for i in range(n)])


def prog_constant_hub(B):
    n = 40

    def compute(vert, msg, agg, s):
        got = msg if msg is not None else 0
        v = B.Vertex(vert.id, vert.value + got, vert.outEdges, s < 2)
        if s < 2:
            return (v, [B.Message(0, 1)])
        return (v, [])
    return compute, _basic(B, lambda: [(i, B.Vertex(i, 0, []))
                                       for i in range(n)])


def prog_variable_count(B):
    n = 48

    def rows():
        rng = random.Random(3)
        return [(i, B.Vertex(i, 0, [B.Edge(rng.randrange(n))
                                    for _ in range(6)])) for i in range(n)]

    def compute(vert, msg, agg, s):
        got = msg if msg is not None else 0
        v = B.Vertex(vert.id, vert.value + got, vert.outEdges, s < 3)
        if s < 3 and vert.outEdges:
            return (v, [B.Message(vert.outEdges[0].target_id, 1)])
        return (v, [])
    return compute, _basic(B, rows)


def prog_tuple_values(B):
    n = 32

    def compute(vert, msg, agg, s):
        cnt, w = vert.value
        got = msg if msg is not None else 0.0
        v = B.Vertex(vert.id, (cnt + 1, w + got), vert.outEdges, s < 4)
        if s < 4:
            return (v, [B.Message(e.target_id, w * 0.5)
                        for e in vert.outEdges])
        return (v, [])
    return compute, _basic(B, lambda: [
        (i, B.Vertex(i, (0, float(i)), [B.Edge((i + 1) % n)]))
        for i in range(n)])


def prog_edge_values(B):
    n = 32

    def rows():
        rng = random.Random(11)
        return [(i, B.Vertex(i, 1.0, [B.Edge((i + k) % n, rng.random())
                                      for k in (1, 2, 3)]))
                for i in range(n)]

    def compute(vert, msg, agg, s):
        got = msg if msg is not None else 0.0
        v = B.Vertex(vert.id, vert.value + got, vert.outEdges, s < 3)
        if s < 3:
            return (v, [B.Message(e.target_id, vert.value * e.value)
                        for e in vert.outEdges])
        return (v, [])
    return compute, _basic(B, rows)


def prog_many_degrees(B):
    n = 80

    def compute(vert, msg, agg, s):
        got = msg if msg is not None else 0
        v = B.Vertex(vert.id, vert.value + got, vert.outEdges, s < 2)
        if s < 2:
            return (v, [B.Message(e.target_id, 1) for e in vert.outEdges])
        return (v, [])
    return compute, _basic(B, lambda: [
        (i, B.Vertex(i, 0, [B.Edge((i + k) % n)
                            for k in range(1, 2 + (i % 40))]))
        for i in range(n)])


def prog_string_target(B):
    def compute(vert, msg, agg, s):
        got = msg if msg is not None else 0
        v = B.Vertex(vert.id, vert.value + got, vert.outEdges, s < 2)
        if s < 2:
            return (v, [B.Message("a", 1)])
        return (v, [])
    return compute, _basic(B, lambda: [("a", B.Vertex("a", 0, [])),
                                       ("b", B.Vertex("b", 0, []))], parts=2)


def prog_degree_dependent(B):
    n = 60

    def compute(vert, msg, agg, s):
        v = vert.value + (msg if msg is not None else 0.0)
        out = []
        if s < 2:
            share = v / len(vert.outEdges)
            out = [B.Message(e.target_id, share) for e in vert.outEdges]
        return B.Vertex(vert.id, v, vert.outEdges, s < 2), out
    return compute, _basic(B, lambda: [
        (i, B.Vertex(i, 1.0, [B.Edge((i + k + 1) % n)
                              for k in range(1 + i % 5)]))
        for i in range(n)])


def prog_vector_messages(B):
    n = 36

    def compute(vert, msg, agg, s):
        cnt, vec = vert.value
        if msg is not None:
            mc, mv = msg
            cnt = cnt + mc
            vec = vec + mv
        out = []
        if s < 3:
            out = [B.Message(e.target_id, (1.0, np.ones(3) * (s + 1.0)))
                   for e in vert.outEdges]
        return B.Vertex(vert.id, (cnt, vec), vert.outEdges, s < 3), out
    return compute, _basic(
        B, lambda: [(i, B.Vertex(i, (0.0, np.zeros(3)),
                                 [B.Edge((i + k + 1) % n)
                                  for k in range(1 + i % 3)]))
                    for i in range(n)],
        op=lambda a, b: (a[0] + b[0], a[1] + b[1]))


def _vector_leaf(B, no_mail):
    n = 24

    def compute(vert, msg, agg, s):
        v = vert.value + (msg if msg is not None else no_mail())
        out = []
        if s < 2:
            out = [B.Message(e.target_id, np.ones(2) * (s + 1.0))
                   for e in vert.outEdges]
        return B.Vertex(vert.id, v, vert.outEdges, s < 2), out
    return compute, _basic(
        B, lambda: [(i, B.Vertex(i, np.zeros(2), [B.Edge((i + 1) % n),
                                                  B.Edge((i + 2) % n)]))
                    for i in range(n)], parts=4, op=np.add)


def prog_vector_leaf_numpy(B):
    """tests/test_bagel_obj_general.py's form: a numpy constant added to
    the vertex value (ROADMAP C9 on the port)."""
    return _vector_leaf(B, lambda: np.zeros(2))


def prog_vector_leaf(B):
    """Its twin without a numpy constant in the arithmetic."""
    return _vector_leaf(B, lambda: 0.0)


def prog_budget(B):
    n = 24

    def compute(vert, msg, agg, s):
        got = msg if msg is not None else 0
        v = B.Vertex(vert.id, vert.value + got, vert.outEdges, s < 2)
        return (v, [B.Message(e.target_id, 1)
                    for e in vert.outEdges] if s < 2 else [])
    return compute, _basic(B, lambda: [
        (i, B.Vertex(i, 0, [B.Edge((i + 1 + k) % n)
                            for k in range(1 + i % 3)]))
        for i in range(n)], parts=4)


def test_power_law_pagerank_rides_device(ref_tpu):
    _, stats = check(prog_power_law, masters=["gpu:2"])
    want, _ = ref_columnar(ref_tpu, prog_power_law)
    assert stats == {k: want[k] for k in STATS_KEYS}


@pytest.mark.parametrize("prog", [prog_non_neighbors, prog_constant_hub,
                                  prog_variable_count, prog_tuple_values,
                                  prog_edge_values, prog_vector_messages,
                                  prog_vector_leaf],
                         ids=lambda p: p.__name__[5:])
def test_program_rides_device(prog, ref_tpu):
    _, stats = check(prog)
    want, _ = ref_columnar(ref_tpu, prog)
    assert stats == {k: want[k] for k in STATS_KEYS}


def test_message_to_constant_hub_counts():
    want, _ = run_ref(prog_constant_hub)
    assert want[0][0] == 2 * 40          # the hub got everyone's 1, twice


def test_vector_message_stats():
    _, stats = check(prog_vector_messages, masters=["gpu:2"])
    assert stats["msg_leaves"] == 2 and stats["msg_merge"] == "traced"
    _, stats = check(prog_vector_leaf, masters=["gpu:2"])
    assert stats["msg_leaves"] == 1 and stats["msg_merge"] == "monoid"


def test_numpy_constant_takes_host_path(ref_tpu):
    """ROADMAP C9: a numpy constant in tensor arithmetic cannot run under
    torch.func.vmap; the reference rides its device, the port answers on
    the host loop with the reason, equal results."""
    _, why = ref_columnar(ref_tpu, prog_vector_leaf_numpy)
    assert why is None                   # the reference admits it
    want, _ = run_ref(prog_vector_leaf_numpy)
    got, used, reason, _ = run_port("gpu:2", prog_vector_leaf_numpy)
    assert used is False
    assert reason.startswith("compute does not trace (") \
        and "Cannot access data pointer" in reason, reason
    same_final(got, want)


def test_too_many_degree_classes_now_bucketizes(ref_tpu):
    n_deg = 40
    assert n_deg > PORT.MAX_DEGREE_CLASSES
    _, stats = check(prog_many_degrees)
    assert stats["bucketed"] and stats["classes"] <= 11
    ref_stats, _ = ref_columnar(ref_tpu, prog_many_degrees)
    assert stats == {k: ref_stats[k] for k in STATS_KEYS}
    assert port_obj.LAST_RUN_STATS["distinct_degrees"] == n_deg
    with mock.patch.object(PORT, "DEGREE_BUCKETS", False), \
            mock.patch.object(REF, "DEGREE_BUCKETS", False):
        _, why = ref_columnar(ref_tpu, prog_many_degrees)
        check(prog_many_degrees, masters=["gpu:2"], device=False,
              reason=why)
    assert why == ("40 degree classes > 24 (each distinct degree is a "
                   "separate trace)")


def test_non_integer_target_falls_back(ref_tpu):
    _, why = ref_columnar(ref_tpu, prog_string_target)
    want, _ = check(prog_string_target, device=False, reason=why)
    assert why == "non-integer vertex id 'a'"
    assert want["a"][0] == 4             # both notify "a" twice


def test_degree_dependent_compute_uses_exact_classes(ref_tpu):
    _, stats = check(prog_degree_dependent)
    assert not stats["bucketed"]
    want, _ = ref_columnar(ref_tpu, prog_degree_dependent)
    assert stats == {k: want[k] for k in STATS_KEYS}


def test_compile_budget_knob_not_enforced(ref_tpu):
    """ROADMAP C10: DPARK_BAGEL_MIN_ROWS_PER_TRACE guards XLA compile
    cost, which an eager port does not pay: under the knob the reference
    falls back to the host loop, while the port, which does not read
    it, stays on the device.  Results equal."""
    assert not hasattr(PORT, "BAGEL_MIN_ROWS_PER_TRACE")
    with mock.patch.object(REF, "BAGEL_MIN_ROWS_PER_TRACE", 10_000_000):
        _, why = ref_columnar(ref_tpu, prog_budget)
        assert why.startswith("compile budget: "), why
        check(prog_budget, masters=["gpu:2"], device=True)


class _OddInt(int):
    pass


_E = PORT.Edge


@pytest.mark.parametrize("edges, ev_state", [
    ([], None), ([], False), ([], True),
    ([_E(1), _E(np.int32(2))], None),
    ([_E(1), _E(2)], True),
    ([_E(1, 0.5), _E(2, 3), _E(3, np.float32(1.5))], None),
    ([_E(1, 0.5)], False),
    ([_E(1, None), _E(2, 0.5)], None),
    ([_E(1, 0.5), _E(2, None)], None),
    ([_E(1, 0.5), _E(2, True)], None),
    ([_E(1, 0.5), _E(2, "x")], True),
    ([_E(1), _E(2.0)], None),
    ([_E(True), _E(2)], None),
    ([_E(_OddInt(4), 1.0), _E(np.uint8(5), 2)], None),
], ids=lambda x: None)
def test_edge_columns_equal_the_edge_by_edge_checks(edges, ev_state):
    """The walk's per-type check gives the edge-by-edge loop's columns and
    state, or raises its error."""
    def outcome(fn):
        try:
            return fn(list(edges), ev_state)
        except PORT._NotColumnarizable as e:
            return "raises: %s" % e
    want = outcome(PORT._edge_columns_loop)
    assert outcome(PORT._edge_columns) == want


# ----------------------------------------------------------------------
# tests/test_bagel_device.py, object cases
# ----------------------------------------------------------------------
class _PR:
    def __init__(self, B, n, steps=20):
        self.B, self.n, self.steps = B, n, steps

    def __call__(self, vert, msg, agg, s):
        B = self.B
        if s == 0:
            new = vert.value
        else:
            new = 0.15 / self.n + 0.85 * (msg if msg is not None else 0.0)
        active = s < self.steps
        v = B.Vertex(vert.id, new, vert.outEdges, active)
        if active and vert.outEdges:
            share = new / len(vert.outEdges)
            return (v, [B.Message(e.target_id, share)
                        for e in vert.outEdges])
        return (v, [])


def prog_ring_pagerank(B):
    n = 8
    links = {i: [(i + 1) % n, (i * 5 + 2) % n] for i in range(n)}
    return _PR(B, n), _basic(B, lambda: [
        (i, B.Vertex(i, 1.0 / n, [B.Edge(t) for t in ts]))
        for i, ts in links.items()], parts=4)


def test_object_bagel_auto_columnarizes():
    want, _ = check(prog_ring_pagerank)
    assert abs(sum(v for v, _ in want.values()) - 1.0) < 1e-6


def prog_list_combiner(B):
    def compute(vert, msgs, agg, s):
        total = sum(msgs) if msgs else 0
        v = B.Vertex(vert.id, vert.value + total, vert.outEdges, s < 2)
        if s < 2 and vert.outEdges:
            return (v, [B.Message(e.target_id, 1) for e in vert.outEdges])
        return (v, [])

    def build(c):
        return (c.parallelize([(i, B.Vertex(i, 0, [B.Edge((i + 1) % 4)]))
                               for i in range(4)], 2),
                c.parallelize([], 2), None)
    return compute, build


def test_object_bagel_fallback_for_list_combiner(ref_tpu):
    _, why = ref_columnar(ref_tpu, prog_list_combiner)
    want, _ = check(prog_list_combiner, device=False, reason=why)
    assert why == "list-combining default Combiner"
    assert all(want[i][0] == 2 for i in range(4))


def _two_vertex(B, edges, value=1.0):
    def build(c):
        verts = c.parallelize(
            [(i, B.Vertex(i, value, [B.Edge(t) for t in ts]))
             for i, ts in edges.items()], 2)
        return verts, c.parallelize([], 2), B.BasicCombiner(operator.add)
    return build


def prog_no_mail_sees_none(B):
    def compute(vert, msg, agg, s):
        newv = (msg + 1.0) if msg is not None else (vert.value * 2.0)
        active = s < 3
        v = B.Vertex(vert.id, newv, vert.outEdges, active)
        if active and vert.outEdges:
            return (v, [B.Message(e.target_id, newv)
                        for e in vert.outEdges])
        return (v, [])
    return compute, _two_vertex(B, {0: [1], 1: [2], 2: [3], 3: [1]})


def prog_empty_emission(B):
    def compute(vert, msg, agg, s):
        newv = vert.value + 1.0
        active = bool(vert.outEdges) and s < 3
        return (B.Vertex(vert.id, newv, vert.outEdges, active), [])
    return compute, _two_vertex(B, {0: [1], 1: []}, 0.0)


def prog_halt_and_send(B):
    def compute(vert, msg, agg, s):
        got = msg if msg is not None else 0.0
        v = B.Vertex(vert.id, vert.value + got, vert.outEdges, False)
        if s == 0 and vert.outEdges:
            return (v, [B.Message(e.target_id, 10.0)
                        for e in vert.outEdges])
        return (v, [])
    return compute, _two_vertex(B, {0: [1], 1: []}, 0.0)


@pytest.mark.parametrize("prog, vid, value", [
    (prog_no_mail_sees_none, 0, 16.0),   # doubled every superstep
    (prog_empty_emission, 1, 1.0),       # invoked once, then halted
    (prog_halt_and_send, 1, 10.0),       # woken by the halter's message
], ids=["no_mail_sees_none", "empty_emission_sends_nothing",
        "halt_and_send_delivers"])
def test_object_bagel_semantics(prog, vid, value):
    want, _ = check(prog)
    assert want[vid][0] == value


def prog_widening(B):
    def compute(vert, msg, agg, s):
        v = B.Vertex(vert.id, vert.value + 1, vert.outEdges, s < 2)
        if s < 2 and vert.outEdges:
            val = 1 if s == 0 else 0.5       # int at s=0, float later
            return (v, [B.Message(e.target_id, val)
                        for e in vert.outEdges])
        return (v, [])
    return compute, _two_vertex(B, {i: [(i + 1) % 4] for i in range(4)}, 0)


def test_object_bagel_widening_dtype_falls_back(ref_tpu):
    _, why = ref_columnar(ref_tpu, prog_widening, run=True)
    assert why == ("superstep 1 emits float64 message leaves, wider than "
                   "the discovered int64")
    check(prog_widening, device=False, reason=why)


# ----------------------------------------------------------------------
# host fallbacks with the reference's reasons; errors that propagate
# ----------------------------------------------------------------------
class _MaxAgg:
    def createAggregator(self, vert):
        return vert.value

    def mergeAggregators(self, a, b):
        return max(a, b)


def prog_aggregator(B):
    def compute(vert, mail, agg, s):
        val = vert.value + (mail if mail is not None else 0.0)
        return (B.Vertex(vert.id, val, vert.outEdges, False), [])

    def build(c):
        verts = c.parallelize(
            [(i, B.Vertex(i, float(i), [])) for i in range(4)], 2)
        msgs = c.parallelize([(0, 10.0), (0, 5.0), (3, 1.0)], 2)
        return verts, msgs, B.BasicCombiner(operator.add)
    return compute, build


def prog_custom_combiner(B):
    class MyComb(B.BasicCombiner):
        pass

    def compute(vert, mail, agg, s):
        val = vert.value + (mail if mail is not None else 0)
        active = s < 2
        return (B.Vertex(vert.id, val, vert.outEdges, active),
                [B.Message((vert.id + 1) % 5, 1)] if active else [])

    def build(c):
        return (c.parallelize([(i, B.Vertex(i, 0, [])) for i in range(5)],
                              2), c.parallelize([], 2),
                MyComb(operator.add))
    return compute, build


def prog_over_max_degree(B):
    n = 20

    def compute(vert, msg, agg, s):
        got = msg if msg is not None else 0
        v = B.Vertex(vert.id, vert.value + got, vert.outEdges, s < 1)
        if s < 1 and vert.outEdges:
            return (v, [B.Message(e.target_id, 1) for e in vert.outEdges])
        return (v, [])
    return compute, _basic(B, lambda: [
        (i, B.Vertex(i, 0, [B.Edge((i + j) % n) for j in range(13)]))
        for i in range(n)], parts=4)


def test_fallback_reasons_are_the_references(ref_tpu):
    """An Aggregator, a custom combiner, more out-edges than MAX_DEGREE:
    the host loop answers on every gpu master, with the reference's
    reason, and the results equal its local master."""
    _, why = ref_columnar(ref_tpu, prog_custom_combiner)
    assert why == "custom Combiner 'MyComb'"
    check(prog_custom_combiner, masters=["gpu:2"], device=False, reason=why)
    with mock.patch.object(PORT, "MAX_DEGREE", 12), \
            mock.patch.object(REF, "MAX_DEGREE", 12):
        _, why = ref_columnar(ref_tpu, prog_over_max_degree)
        assert why == "degree 13 > 12"
        check(prog_over_max_degree, masters=["gpu:2"], device=False,
              reason=why)


def test_aggregator_falls_back(ref_tpu):
    compute, build = prog_aggregator(REF)
    verts, msgs, comb = build(ref_tpu)
    with pytest.raises(REF._NotColumnarizable) as e:
        REF.Bagel._run_columnar(ref_tpu, REF.Bagel._collect_bounded(
            verts, msgs), compute, comb, _MaxAgg(), 80, 2)
    want, _ = run_ref(prog_aggregator, aggregator=_MaxAgg())
    for m in MASTERS:
        got, used, why, _ = run_port(m, prog_aggregator,
                                     aggregator=_MaxAgg())
        same_final(got, want)
        if m != "local":
            assert used is False and why == str(e.value)
    assert want[0][0] == 15.0 and want[3][0] == 4.0


def test_degree_cap_boundary():
    """At MAX_DEGREE the program rides the device; one past it falls back
    (tests/test_bagel_fuzz.py::test_fallback_boundary_degree)."""
    def prog_at(deg):
        def prog(B):
            compute, _ = prog_over_max_degree(B)
            return compute, _basic(B, lambda: [
                (i, B.Vertex(i, 0, [B.Edge((i + j) % 20)
                                    for j in range(deg)]))
                for i in range(20)], parts=4)
        return prog
    with mock.patch.object(PORT, "MAX_DEGREE", 12), \
            mock.patch.object(REF, "MAX_DEGREE", 12):
        check(prog_at(12), masters=["gpu:2"], device=True, max_superstep=4)
        check(prog_at(13), masters=["gpu:2"], device=False,
              reason="degree 13 > 12", max_superstep=4)


@pytest.mark.parametrize("name", ["obj_emit_pack", "pregel_deliver"])
def test_port_errors_propagate(name):
    """An error of the port's own code (here a kernel wrapper) propagates
    out of Bagel.run: no host fallback after device work (ROADMAP C8)."""
    def boom(*a, **k):
        raise RuntimeError("kernel %s failed" % name)
    with mock.patch.object(kernels, name, boom):
        with pytest.raises(RuntimeError, match="kernel %s failed" % name):
            run_port("gpu:2", prog_constant_hub)


def test_cuda_error_inside_compute_propagates():
    """A device fault raised inside the user's compute (an out-of-memory)
    propagates too; only the user's own errors fall back."""
    def prog(B):
        compute, build = prog_constant_hub(B)

        def oom(vert, msg, agg, s):
            if s == 1:
                import torch
                raise torch.cuda.OutOfMemoryError("CUDA out of memory")
            return compute(vert, msg, agg, s)
        return oom, build
    import torch
    with pytest.raises(torch.cuda.OutOfMemoryError):
        run_port("gpu:2", prog)


def test_user_error_after_admission_falls_back():
    """The user's compute raising at a later superstep (the reference's
    failed trace of that superstep): the host loop reruns the program
    from superstep 0, and the reason names the failure."""
    def prog(B):
        compute, build = prog_constant_hub(B)

        def late(vert, msg, agg, s):
            if s == 1 and hasattr(vert.id, "shape"):
                raise ValueError("no device form at superstep 1")
            return compute(vert, msg, agg, s)
        return late, build
    want, _ = run_ref(prog_constant_hub)
    got, used, why, _ = run_port("gpu:2", prog)
    assert used is False
    assert why == "device object Pregel failed (no device form at " \
                  "superstep 1)"
    same_final(got, want)


# ----------------------------------------------------------------------
# tests/test_bagel.py: the driver-resident cases
# ----------------------------------------------------------------------
GRAPH = {0: [1, 2], 1: [2], 2: [0], 3: [2]}


def prog_small_pagerank(B):
    return _PR(B, 4, steps=25), _basic(B, lambda: [
        (i, B.Vertex(i, 1.0 / 4, [B.Edge(t) for t in ts]))
        for i, ts in GRAPH.items()], parts=2)


def test_pagerank_converges():
    want, _ = check(prog_small_pagerank)
    ranks = {k: v for k, (v, _) in want.items()}
    assert abs(sum(ranks.values()) - 1.0) < 0.02
    assert ranks[2] == max(ranks.values())


class _SP:
    def __init__(self, B):
        self.B = B

    def __call__(self, vert, mail, agg, superstep):
        B = self.B
        best = vert.value
        if mail:
            best = min(best, min(mail))
        if best < vert.value or superstep == 0:
            out = [B.Message(e.target_id, best + 1) for e in vert.outEdges] \
                if best < float("inf") else []
            return (B.Vertex(vert.id, best, vert.outEdges, False), out)
        return (B.Vertex(vert.id, vert.value, vert.outEdges, False), [])


@pytest.mark.parametrize("chain", [{0: [1], 1: [2], 2: [3], 3: []},
                                   {0: [1, 2], 1: [3], 2: [3], 3: []}],
                         ids=["chain", "diamond"])
def test_shortest_path(chain, ref_tpu):
    """List-combiner mail (the default Combiner): the host loop."""
    def prog(B):
        def build(c):
            return (c.parallelize(
                [(i, B.Vertex(i, 0.0 if i == 0 else float("inf"),
                              [B.Edge(t) for t in ts]))
                 for i, ts in chain.items()], 2), c.parallelize([], 2),
                None)
        return _SP(B), build
    _, why = ref_columnar(ref_tpu, prog)
    want, _ = check(prog, device=False, reason=why)
    assert want[3][0] == (3.0 if len(chain[0]) == 1 else 2.0)


def prog_unknown_targets(B):
    def compute(vert, mail, agg, superstep):
        active = superstep < 2
        return (B.Vertex(vert.id, vert.value + (mail if mail is not None
                                                else 0),
                         vert.outEdges, active),
                [B.Message(99, 1), B.Message(1 - vert.id, 1)]
                if active else [])
    return compute, _basic(B, lambda: [(i, B.Vertex(i, 0, []))
                                       for i in range(2)], parts=2)


def test_unknown_targets_drop():
    want, _ = check(prog_unknown_targets)
    assert want[0][0] == 2 and want[1][0] == 2


def prog_initial_messages(B):
    def compute(vert, mail, agg, superstep):
        val = vert.value + (mail if mail is not None else 0)
        return (B.Vertex(vert.id, val, vert.outEdges, False), [])
    return compute, _basic(B, lambda: [(i, B.Vertex(i, float(i), []))
                                       for i in range(4)], parts=2,
                           pend=[(0, 10.0), (0, 5.0), (3, 1.0)])


def test_initial_messages():
    want, _ = check(prog_initial_messages)
    assert want[0][0] == 15.0 and want[3][0] == 4.0


def test_rdd_loop_cases_raise_not_implemented():
    """Where the reference runs its RDD-algebra loop -- a compute that
    rebinds vertex ids, a graph over FAST_MAX_VERTICES -- the port runs
    that loop too (it raised NotImplementedError before the loop was
    ported; the name is kept), with the reference's results on every
    master."""
    def rebind(B):
        def compute(vert, mail, agg, superstep):
            return (B.Vertex(vert.id + 100, vert.value + 1, [], False), [])
        return compute, _basic(B, lambda: [(i, B.Vertex(i, float(i), []))
                                           for i in range(3)], parts=2)
    want_rebind, _ = run_ref(rebind)
    assert want_rebind == {i: (i + 1.0, False) for i in range(3)}
    with mock.patch.object(REF, "FAST_MAX_VERTICES", 2):
        want_hub, _ = run_ref(prog_constant_hub)
    assert want_hub[0][0] == 80
    for m in MASTERS:
        got, used, _, _ = run_port(m, rebind)
        same_final(got, want_rebind)
        assert used is (False if m != "local" else None)
        with mock.patch.object(PORT, "FAST_MAX_VERTICES", 2):
            got, used, _, _ = run_port(m, prog_constant_hub)
        same_final(got, want_hub)
        assert used is (False if m != "local" else None)


def test_local_master_schedules_no_superstep_jobs():
    """The driver-resident loop runs no job inside the superstep loop:
    one count and two collects."""
    c = DparkContext("local")
    compute, build = prog_small_pagerank(PORT)
    verts, msgs, comb = build(c)
    c.start()
    before = len(c.scheduler.history)
    PORT.Bagel.run(c, verts, msgs, compute, combiner=comb)
    assert len(c.scheduler.history) - before <= 3
    c.stop()
