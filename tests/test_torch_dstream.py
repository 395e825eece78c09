"""The port's DStream (dstream.py, panes.py) on the CPU: a mirror of the
cases of tests/test_dstream.py that the port covers, on the port's local
and gpu:4 masters (device="cpu": the kernels' plain versions), against
the JAX package's local master and, for the jobs that ride the device,
its tpu:4 master (results and stage kinds).  Batches are driven by hand
with a manual clock.  Integers compare exactly; floats within 1e-12
relative.

On the gpu master the windows and the running-sum state fold as one
union-reduce a tick over reduced shuffles kept on the device (B16, K16),
and a traceable update(values, prev) runs as the state-mode segmented
apply (K8's state gather): every steady-state stage is "array" where the
reference's is.  Not ported (ROADMAP A14b): file and socket streams,
checkpoint and recovery, event time, the adaptive split point, and the
lint and metrics surfaces the reference's pane tests also read."""

import math
import operator
import random

import numpy as np
import pytest

from dpark_tpu import DparkContext as RefContext
from dpark_tpu.dstream import StreamingContext as RefStreamingContext
from dpark_tpu_torch import DparkContext, conf, dstream, panes
from dpark_tpu_torch.backend.cuda import kernels
from dpark_tpu_torch.dstream import StreamingContext
from dpark_tpu_torch.rdd import UnionRDD

MASTERS = ["local", "gpu:4"]


def _ctx(master, ref=False):
    if ref:
        return RefContext(master)
    if master == "local":
        return DparkContext(master)
    return DparkContext(master, device="cpu")


def drive(master, build, batches, ref=False, t0=1000.0, batch=1.0,
          keep=None, nb=None):
    """Run build(queue stream) over the queued batches with the manual
    clock: ([(t, sorted output)], the stage kinds of the multi-task
    jobs)."""
    c = _ctx(master, ref)
    ssc = (RefStreamingContext if ref else StreamingContext)(c, batch)
    out = []
    q = ssc.queueStream([list(b) for b in batches])
    s = build(q)
    s.collect_batches(out)
    c.start()
    ssc.zero_time = t0
    for k in range(1, (nb or len(batches)) + 1):
        ssc.run_batch(t0 + k * batch)
    kinds = [(st["rdd"], st.get("kind"))
             for rec in c.scheduler.history if rec.get("parts") != 1
             for st in rec.get("stage_info", ())]
    if keep is not None:
        keep.extend([ssc, s, c])
    else:
        c.stop()
    return [(t, _sorted(v)) for t, v in out], kinds


def _sorted(rows):
    try:
        return sorted(rows)
    except TypeError:            # unorderable values (Counter)
        return sorted(rows, key=repr)


def _device(kinds):
    return {v for _, v in kinds}


# ---------------------------------------------------------------------------
# tests/test_dstream.py:28-95
# ---------------------------------------------------------------------------
SIMPLE = {
    "map_filter": ([[1, 2, 3], [4, 5, 6]],
                   lambda q: q.map(lambda x: x * 2).filter(lambda x: x > 4)),
    "flatmap_count_by_value": (
        [["a b", "c"], ["d e f"]],
        lambda q: q.flatMap(lambda line: line.split()).countByValue()),
    # glom's lists follow the partitioning (the default parallelism):
    # flattened back they are the batch
    "glom": ([[1, 2, 3], [4]],
             lambda q: q.glom().flatMap(lambda part: part)),
    "reduce_by_key": ([[("a", 1), ("a", 2), ("b", 1)]],
                      lambda q: q.reduceByKey(operator.add)),
    "window": ([[1], [2], [3], [4]], lambda q: q.window(2.0)),
    "count_by_window": ([[1, 1], [2], [3, 3, 3], []],
                        lambda q: q.countByWindow(2.0)),
    "rbkaw_plain": ([[("k", 1)], [("k", 2)], [("k", 4)], [("k", 8)]],
                    lambda q: q.reduceByKeyAndWindow(operator.add, 2.0)),
    "rbkaw_incremental": ([[("k", 1)], [("k", 2)], [("k", 4)], [("k", 8)]],
                          lambda q: q.reduceByKeyAndWindow(
                              operator.add, 2.0, invFunc=operator.sub)),
    "update_state": ([[("a", 1)], [("a", 2), ("b", 5)], [("b", 1)]],
                     lambda q: q.updateStateByKey(
                         lambda vs, prev: sum(vs) + (prev or 0))),
}
WANT = {
    "map_filter": [[6], [8, 10, 12]],
    "rbkaw_plain": [[("k", 1)], [("k", 3)], [("k", 6)], [("k", 12)]],
    "update_state": [[("a", 1)], [("a", 3), ("b", 5)], [("a", 3), ("b", 6)]],
    "window": [[1], [1, 2], [2, 3], [3, 4]],
    "count_by_window": [[2], [3], [4], [3]],
    "glom": [[1, 2, 3], [4]],
}
WANT["rbkaw_incremental"] = WANT["rbkaw_plain"]


@pytest.mark.parametrize("master", MASTERS)
@pytest.mark.parametrize("name", sorted(SIMPLE))
def test_simple_streams_match_reference(name, master):
    batches, build = SIMPLE[name]
    got, _ = drive(master, build, batches)
    want, _ = drive("local", build, batches, ref=True)
    assert got == want
    if name in WANT:
        assert [v for _, v in got] == WANT[name]


# ---------------------------------------------------------------------------
# the jobs that ride the device (tests/test_dstream.py:127, :371, :452,
# :479, :636): equal to local and to the reference's tpu:4, every
# steady-state stage "array"
# ---------------------------------------------------------------------------
def _state_sum(q):
    return q.updateStateByKey(lambda vs, prev: (prev or 0) + sum(vs),
                              numSplits=4)


def _decayed(vs, prev):
    base = 0.0 if prev is None else prev
    return base * 0.9 + sum(vs)


DEVICE_JOBS = {
    "stateful_wordcount": (
        [[(hash("w%d" % (i % 9)) % 64, 1) for i in range(j * 17,
                                                        j * 17 + 300)]
         for j in range(5)], _state_sum),
    "linear_window": (
        [[(i % 7, i % 5) for i in range(j * 31, j * 31 + 200)]
         for j in range(5)],
        lambda q: q.reduceByKeyAndWindow(operator.add, 2.0, numSplits=4,
                                         invFunc=operator.sub)),
    "noninv_window": (
        [[(i % 16, 1) for i in range(j * 13, j * 13 + 160)]
         for j in range(4)],
        lambda q: q.reduceByKeyAndWindow(operator.add, 2.0, numSplits=4)),
    "decayed_state": (
        [[(i % 11, (i * 3) % 7) for i in range(j * 13, j * 13 + 250)]
         for j in range(5)],
        lambda q: q.updateStateByKey(_decayed, numSplits=4)),
}


def _close(a, b):
    assert len(a) == len(b)
    for (ta, va), (tb, vb) in zip(a, b):
        assert ta == tb and len(va) == len(vb)
        for (ka, xa), (kb, xb) in zip(va, vb):
            assert ka == kb
            assert math.isclose(xa, xb, rel_tol=1e-12, abs_tol=0), (ka, xa,
                                                                    xb)


@pytest.mark.parametrize("name", sorted(DEVICE_JOBS))
def test_device_streams_match_reference(name):
    batches, build = DEVICE_JOBS[name]
    got, kinds = drive("gpu:4", build, batches)
    local, _ = drive("local", build, batches)
    ref, ref_kinds = drive("tpu:4", build, batches, ref=True)
    if name == "decayed_state":
        _close(got, local)
        _close(got, ref)
    else:
        assert got == local == ref
    assert _device(kinds) == {"array"}, kinds
    assert _device(ref_kinds) == {"array"}, ref_kinds
    assert ("UnionRDD", "array") in kinds
    # the stage kinds of the last (steady-state) job equal the reference's
    assert kinds[-2:] == ref_kinds[-2:]


def test_stream_join_rides_device():
    """Per-batch stream joins expand on the device join source; the last
    job is all "array"."""
    left = [[(i % 32, i) for i in range(j * 11, j * 11 + 120)]
            for j in range(3)]
    right = [[(i % 32, i * 2) for i in range(j * 7, j * 7 + 90)]
             for j in range(3)]

    def run(master, ref=False):
        c = _ctx(master, ref)
        ssc = (RefStreamingContext if ref else StreamingContext)(c, 1.0)
        out = []
        a = ssc.queueStream(left)
        b = ssc.queueStream(right)
        a.join(b, numSplits=4).transform(lambda r: r.map(
            lambda kv: (kv[0], kv[1][0] + kv[1][1]))
            .reduceByKey(operator.add, 4)).collect_batches(out)
        c.start()
        ssc.zero_time = 1000.0
        for k in (1, 2, 3):
            ssc.run_batch(1000.0 + k)
        last = [st.get("kind")
                for st in c.scheduler.history[-1]["stage_info"]]
        c.stop()
        return [sorted(v) for _, v in out], last
    got, last = run("gpu:4")
    assert got == run("local")[0] == run("local", ref=True)[0]
    assert last and set(last) == {"array"}, last


# ---------------------------------------------------------------------------
# tests/test_dstream.py:95, :161, :194, :210
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("master", MASTERS)
def test_state_monoid_hint_and_fallback(master):
    import operator as op

    def total(vs, prev):
        acc = prev if prev is not None else 0
        for v in vs:
            acc += v
        return acc
    assert dstream._classify_state_update(total) is None
    total.__dpark_state_monoid__ = "add"
    assert dstream._classify_state_update(total) is op.add

    def concat(vs, prev):
        s = prev or ""
        for v in vs:
            s += v
        return s
    got, _ = drive(master, lambda q: q.updateStateByKey(concat),
                   [[("k", "a")], [("k", "b")]])
    assert got[1][1] == [("k", "ab")]


@pytest.mark.parametrize("master", MASTERS)
def test_state_eviction(master):
    def update(new_values, prev):
        if not new_values:
            return None                 # evict idle keys
        return sum(new_values) + (prev or 0)
    got, _ = drive(master, lambda q: q.updateStateByKey(update),
                   [[("a", 1), ("b", 1)], [("b", 1)], [("b", 1)]])
    assert got[2][1] == [("b", 3)]


@pytest.mark.parametrize("master", MASTERS)
def test_union_join_streams(master):
    c = _ctx(master)
    ssc = StreamingContext(c, 1.0)
    out_u, out_j = [], []
    a = ssc.queueStream([[("x", 1)], [("y", 2)]])
    b = ssc.queueStream([[("x", 10)], [("y", 20)]])
    a.union(b).collect_batches(out_u)
    a.join(b).collect_batches(out_j)
    c.start()
    ssc.zero_time = 1000.0
    ssc.run_batch(1001.0)
    ssc.run_batch(1002.0)
    c.stop()
    assert sorted(out_u[0][1]) == [("x", 1), ("x", 10)]
    assert out_j[0][1] == [("x", (1, 10))]
    assert out_j[1][1] == [("y", (2, 20))]


@pytest.mark.parametrize("master", MASTERS)
def test_transform_with_time(master):
    got, _ = drive(master, lambda q: q.transform(
        lambda rdd, t: rdd.map(lambda x: (x, t))), [[1], [2]], t0=100.0)
    assert got[0][1] == [(1, 101.0)]


# ---------------------------------------------------------------------------
# tests/test_dstream.py:400-449: the counter window and the window fuzz
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("master", MASTERS)
def test_counter_window_keeps_join_semantics(master):
    from collections import Counter
    got, _ = drive(master, lambda q: q.reduceByKeyAndWindow(
        operator.add, 2.0, invFunc=operator.sub),
        [[("k", Counter(a=1))], [("k", Counter(a=2))],
         [("k", Counter(a=4))], [("k", Counter(a=8))]])
    assert [dict(v) for _, v in got] == [
        {"k": Counter(a=1)}, {"k": Counter(a=3)},
        {"k": Counter(a=6)}, {"k": Counter(a=12)}]


def _window_fuzz(seed):
    rng = random.Random(seed)
    nb = rng.randint(4, 7)
    window = float(rng.randint(1, 3))
    batches = []
    for _ in range(nb):
        if rng.random() < 0.25:
            batches.append([])
        else:
            batches.append([(rng.randint(0, 12), rng.randint(-9, 9))
                            for _ in range(rng.randint(1, 120))])
    return batches, lambda q: q.reduceByKeyAndWindow(
        operator.add, window, numSplits=4, invFunc=operator.sub)


@pytest.mark.parametrize("seed", range(5))
def test_window_fuzz_parity(seed):
    batches, build = _window_fuzz(seed)
    got, _ = drive("gpu:4", build, batches)
    assert got == drive("local", build, batches)[0]
    assert got == drive("local", build, batches, ref=True)[0]


# ---------------------------------------------------------------------------
# tests/test_dstream.py:511-636: the rewrites' fallbacks
# ---------------------------------------------------------------------------
def _manual(master):
    c = _ctx(master)
    ssc = StreamingContext(c, 1.0)
    return c, ssc


def _start(ssc):
    ssc.ctx.start()
    for ins in ssc.input_streams:
        ins.start()
    ssc.zero_time = 1000.0


@pytest.mark.parametrize("master", MASTERS)
def test_state_rewrite_falls_back_on_type_error(master):
    c, ssc = _manual(master)
    out = []
    q = ssc.queueStream([[("a", 1), ("a", 2), ("b", 3)],
                         [("a", 1), ("a", "x"), ("b", 2)],
                         [("a", 5), ("b", 1)]])
    state = q.updateStateByKey(lambda vs, prev: (prev or 0) + sum(vs))
    state.collect_batches(out)
    _start(ssc)
    ssc.run_batch(1001.0)
    assert dict(out[-1][1]) == {"a": 3, "b": 3}
    assert state._numeric is True
    with pytest.raises(Exception) as ei:
        ssc.run_batch(1002.0)
    assert "TypeError" in str(ei.value) or isinstance(ei.value, TypeError)
    assert state._numeric is False
    ssc.run_batch(1003.0)
    assert dict(out[-1][1]) == {"a": 8, "b": 4}
    c.stop()


@pytest.mark.parametrize("master", MASTERS)
def test_window_rewrite_falls_back_on_type_error(master):
    c, ssc = _manual(master)
    out = []
    q = ssc.queueStream([[("k", 1)], [("k", 2)], [("k", "x")], [("k", 8)]])
    q.reduceByKeyAndWindow(operator.add, 2.0,
                           invFunc=operator.sub).collect_batches(out)
    _start(ssc)
    ssc.run_batch(1001.0)
    ssc.run_batch(1002.0)
    assert dict(out[-1][1]) == {"k": 3}
    streams = [s for s in ssc._all_streams()
               if type(s).__name__ == "ReducedWindowedDStream"]
    assert streams and streams[0]._numeric is True
    try:
        ssc.run_batch(1003.0)
    except Exception:
        pass
    assert streams[0]._numeric is False
    c.stop()


@pytest.mark.parametrize("master", MASTERS)
def test_rewrite_fallback_leaves_sibling_chains_intact(master):
    c, ssc = _manual(master)
    out_a, out_b = [], []
    qa = ssc.queueStream([[("a", 1)], [("a", 10)], [("a", 100)]])
    qb = ssc.queueStream([[("b", 1)], [("b", "x")], [("b", 5)]])

    def update(vs, prev):
        return (prev or 0) + sum(vs)
    sa = qa.updateStateByKey(update)
    sb = qb.updateStateByKey(update)
    sa.collect_batches(out_a)
    sb.collect_batches(out_b)
    _start(ssc)
    ssc.run_batch(1001.0)
    assert dict(out_a[-1][1]) == {"a": 1}
    try:
        ssc.run_batch(1002.0)
    except Exception:
        pass
    ssc.run_batch(1003.0)
    assert dict(out_a[-1][1]) == {"a": 111}
    assert sb._numeric is False
    assert sa._numeric is not False
    c.stop()


def test_checked_op_rejects_numpy_strings():
    op = dstream._CheckedNumericOp(operator.add, "add")
    assert op(2, 3) == 5
    assert op(np.int64(2), 3) == 5
    with pytest.raises(dstream._NumericRewriteError):
        op(np.str_("a"), np.str_("b"))
    with pytest.raises(dstream._NumericRewriteError):
        op(1, "x")


def test_checked_op_classifies_and_traces_on_the_port():
    """The checked op carries __dpark_monoid__, so the port's
    classify_merge and probe_merge take it (K3 folds it, no plain scan),
    and the vmapped trace passes its operand check (tensors are
    array-likes)."""
    import torch
    from dpark_tpu_torch.backend.cuda import fuse
    op = dstream._CheckedNumericOp(operator.add, "add")
    assert fuse.classify_merge(op) == "add"
    assert dstream._arraylike(torch.ones(3, dtype=torch.int64))
    merge = fuse.probe_merge(op, (0, 1), [(np.dtype(np.int64), ()),
                                          (np.dtype(np.int64), ())], 1)
    assert merge is not None
    a = torch.tensor([1, 2])
    assert merge([a], [a])[0].tolist() == [2, 4]


def test_untraceable_updatestate_keeps_cogroup_parity():
    """An update with data-dependent Python control flow does not trace:
    the cogroup path answers (eviction included), equal to local and to
    the reference's tpu:4."""
    def update(vs, prev):
        total = (prev if prev is not None else 0) + sum(vs)
        if total > 40:
            return None
        return total
    batches = [[(i % 5, i % 4) for i in range(j * 7, j * 7 + 40)]
               for j in range(4)]

    def build(q):
        return q.updateStateByKey(update, numSplits=4)
    got, _ = drive("gpu:4", build, batches)
    assert got == drive("local", build, batches)[0]
    assert got == drive("tpu:4", build, batches, ref=True)[0]


def test_seg_state_classification():
    """The state dtype is found by a fixed-point trace: int values whose
    update decays to float carry float64 state; an update that needs the
    group's length, or two output leaves, keeps the cogroup path."""
    c = DparkContext("gpu:4", device="cpu")
    ssc = StreamingContext(c, 1.0)
    batch = c.parallelize([(1, 2), (2, 3)], 2)
    q = ssc.queueStream([])
    s = q.updateStateByKey(_decayed)
    got = s._classify_seg_state(batch)
    assert got and got[0].zero == 0.0 and isinstance(got[0].zero, float)
    s = q.updateStateByKey(lambda vs, prev: sum(vs) * len(vs))
    assert s._classify_seg_state(batch) is False
    s = q.updateStateByKey(lambda vs, prev: (sum(vs), 1))
    assert s._classify_seg_state(batch) is False
    c.stop()


# ---------------------------------------------------------------------------
# the pane plane (tests/test_dstream.py:728-873, :975-1017)
# ---------------------------------------------------------------------------
def _fuzz_batches(seed, nb, empties=True):
    rng = random.Random(seed)
    batches = []
    for _ in range(nb):
        if empties and rng.random() < 0.2:
            batches.append([])
        else:
            batches.append([(rng.randint(0, 9), rng.randint(-9, 9))
                            for _ in range(rng.randint(1, 80))])
    return batches


def _window(window, slide=None, invFunc=None, func=operator.add):
    return lambda q: q.reduceByKeyAndWindow(func, float(window), slide,
                                            numSplits=4, invFunc=invFunc)


@pytest.mark.parametrize("window,slide", [(4, None), (8, None), (4, 2.0),
                                          (6, 3.0)])
def test_pane_parity_invertible(monkeypatch, window, slide):
    """The invertible pane path equals the per-batch path on gpu:2, and
    the reference's local."""
    batches = _fuzz_batches(101 + window, 14)
    build = _window(window, slide, operator.sub)
    monkeypatch.setattr(conf, "STREAM_PANES", True)
    got, _ = drive("gpu:4", build, batches)
    monkeypatch.setattr(conf, "STREAM_PANES", False)
    exp, _ = drive("gpu:4", build, batches)
    assert got == exp
    assert got, "no windows emitted"
    assert got == drive("local", build, batches, ref=True)[0]


@pytest.mark.parametrize("window", [4, 8, 16])
def test_pane_parity_noninvertible(monkeypatch, window):
    batches = _fuzz_batches(7 + window, window + 8)
    build = _window(window)
    monkeypatch.setattr(conf, "STREAM_PANES", True)
    got, _ = drive("gpu:4", build, batches)
    monkeypatch.setattr(conf, "STREAM_PANES", False)
    exp, _ = drive("gpu:4", build, batches)
    assert got == exp
    assert got == drive("local", build, batches, ref=True)[0]


def test_pane_parity_counter_generic_inv(monkeypatch):
    from collections import Counter
    batches = [[("k", Counter(a=1, b=j))] for j in range(8)]
    build = _window(3.0, None, operator.sub)
    monkeypatch.setattr(conf, "STREAM_PANES", True)
    got, _ = drive("local", build, batches)
    monkeypatch.setattr(conf, "STREAM_PANES", False)
    exp, _ = drive("local", build, batches)
    assert got == exp


def _union_branches(rdd):
    src = rdd
    while src is not None and not isinstance(src, UnionRDD):
        deps = getattr(src, "dependencies", [])
        src = deps[0].rdd if deps else None
    assert src is not None, "no union under the window update"
    return len(src.rdds)


def test_pane_invertible_constant_branches(monkeypatch):
    monkeypatch.setattr(conf, "STREAM_PANES", True)

    def steady_branches(window):
        keep = []
        batches = [[(i % 5, 1) for i in range(30)]
                   for _ in range(window + 4)]
        drive("gpu:4", _window(window, None, operator.sub), batches,
              keep=keep)
        ssc, s, c = keep
        last = s.generated[max(s.generated)]
        c.stop()
        return _union_branches(last)
    assert steady_branches(4) == steady_branches(16) == 3


def test_pane_tree_log_branches(monkeypatch):
    monkeypatch.setattr(conf, "STREAM_PANES", True)
    w = 16
    keep = []
    batches = [[(i % 5, 1) for i in range(30)] for _ in range(w + 6)]
    drive("local", _window(w), batches, keep=keep)
    ssc, s, c = keep
    assert type(s).__name__ == "PanedWindowReduceDStream"
    assert s._use_tree is True
    assert _union_branches(s.generated[max(s.generated)]) <= \
        2 * math.log2(w) + 2 < w
    assert s._tree.builds <= len(batches) + w
    c.stop()


def test_dyadic_blocks_cover_and_reuse():
    for lo, hi in [(0, 0), (0, 15), (5, 12), (7, 38), (31, 32)]:
        blocks = panes.dyadic_blocks(lo, hi)
        covered = []
        for start, size in blocks:
            assert size & (size - 1) == 0
            assert start % size == 0
            covered.extend(range(start, start + size))
        assert covered == list(range(lo, hi + 1)), (lo, hi, blocks)
    seen = set()
    for lo in range(0, 48):
        seen.update(panes.dyadic_blocks(lo, lo + 15, max_size=8))
    assert sum(1 for _, size in seen if size > 1) <= 64


def test_merge_tree_invalidate_rebuilds_only_covering_nodes():
    nodes = {i: ["p%d" % i] for i in range(8)}
    merged = []

    def merge(kids, size, start):
        merged.append((start, size))
        out = []
        for k in kids:
            out.extend(k)
        return out
    tree = panes.MergeTree(nodes.get, merge)
    cover = tree.cover(0, 7)
    assert sorted(x for blk in cover for x in blk) == \
        sorted(x for v in nodes.values() for x in v)
    n_first = len(merged)
    tree.cover(0, 7)
    assert len(merged) == n_first
    tree.invalidate(3)
    tree.cover(0, 7)
    rebuilt = merged[n_first:]
    assert rebuilt and len(rebuilt) <= 3, rebuilt
    assert all(start <= 3 < start + size or size <= 4
               for start, size in rebuilt)


def test_window_noninv_fallback_marks_plan(monkeypatch):
    """A non-invertible window op with no registered merge recomputes the
    whole window and marks the emitted RDD; __dpark_window_merge__ opts
    an equivalent op back into the pane tree."""
    monkeypatch.setattr(conf, "STREAM_PANES", True)

    def weird(a, b):
        return a + b - 0
    batches = [[("k", j)] for j in range(6)]
    keep = []
    got, _ = drive("gpu:4", _window(4.0, func=weird), batches, keep=keep)
    ssc, s, c = keep
    assert type(s).__name__ == "TransformedDStream"
    assert s.generated[max(s.generated)]._window_noninv["op"] == "weird"
    c.stop()
    weird.__dpark_window_merge__ = True
    keep = []
    got2, _ = drive("gpu:4", _window(4.0, func=weird), batches, keep=keep)
    assert type(keep[1]).__name__ == "PanedWindowReduceDStream"
    keep[2].stop()
    assert got2 == got


@pytest.mark.parametrize("on", [True, False])
def test_slide_cadence_gating(monkeypatch, on):
    monkeypatch.setattr(conf, "STREAM_PANES", on)
    batches = [[("k", 1)] for _ in range(8)]
    got, _ = drive("gpu:4", _window(4.0, 2.0, operator.sub), batches)
    assert [t for t, _ in got] == [1002.0, 1004.0, 1006.0, 1008.0]
    assert [v for _, v in got] == [[("k", 2)], [("k", 4)], [("k", 4)],
                                   [("k", 4)]]


def test_pane_stage_attribution_and_stats(monkeypatch):
    """Stage records carry the pane plane's stream tags; the panes
    registry holds the stream's live stats until the context stops."""
    monkeypatch.setattr(conf, "STREAM_PANES", True)
    keep = []
    drive("gpu:4", _window(3.0, None, operator.sub),
          [[(i % 4, 1) for i in range(40)] for _ in range(6)], keep=keep)
    ssc, s, c = keep
    win = s
    roles = {st["stream"]["role"] for rec in c.scheduler.history
             for st in rec.get("stage_info", ()) if st.get("stream")}
    assert "window-emit" in roles and "pane-build" in roles, roles
    st = panes.stream_stats().get(win._sid)
    assert st and st["panes"] >= 1 and st["ticks"] == 6
    ssc.stop()
    assert win._sid not in panes.stream_stats()
    c.stop()


def test_forget_keeps_what_the_longest_window_needs():
    """A 5 s window beside a 1 s state stream on one queue: the queue's
    batches stay until the window has read them (forgetting per output
    would drop them at the state stream's horizon and pop the next
    queue item in their place)."""
    batches = [[(j, 1)] for j in range(12)]
    c = DparkContext("local")
    ssc = StreamingContext(c, 1.0)
    q = ssc.queueStream(batches)
    wins, states = [], []
    q.window(5.0).collect_batches(wins)
    q.updateStateByKey(lambda vs, prev: (prev or 0) + sum(vs)) \
        .collect_batches(states)
    c.start()
    ssc.zero_time = 1000.0
    for k in range(1, 13):
        ssc.run_batch(1000.0 + k)
    assert sorted(wins[-1][1]) == [(j, 1) for j in range(7, 12)]
    assert len(states[-1][1]) == 12
    c.stop()


# ---------------------------------------------------------------------------
# tests/test_tpu_backend.py:373: batches after the first build no library
# and call the same kernels a batch
# ---------------------------------------------------------------------------
def test_stream_batches_reuse_the_same_kernels(monkeypatch):
    """The port runs eagerly (no program cache to count): after the first
    batch, later batches build no kernel library and call the same kernel
    wrappers the same number of times each."""
    calls = {}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapped
    for name in list(kernels.LAUNCHES):
        if hasattr(kernels, name):
            monkeypatch.setattr(kernels, name, spy(name,
                                                   getattr(kernels, name)))
    monkeypatch.setattr(kernels, "build", lambda: pytest.fail(
        "a later batch built a kernel library"))
    c = DparkContext("gpu:4", device="cpu")
    ssc = StreamingContext(c, 1.0)
    out = []
    q = ssc.queueStream([[(i % 5, 1) for i in range(64)] for _ in range(4)])
    q.reduceByKey(operator.add, 4).collect_batches(out)
    c.start()
    ssc.zero_time = 0.0
    per_batch = []
    for k in (1, 2, 3, 4):
        calls.clear()
        ssc.run_batch(float(k))
        per_batch.append(dict(calls))
    c.stop()
    assert len(out) == 4
    expect = {j: 13 if j < 4 else 12 for j in range(5)}
    assert all(dict(v) == expect for _, v in out)
    assert per_batch[0] and per_batch[1] == per_batch[2] == per_batch[3]
    assert per_batch[1] == per_batch[0]
