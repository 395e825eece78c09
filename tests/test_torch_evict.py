"""One device-memory budget over the port's shuffle stores
(conf.SHUFFLE_HBM_BUDGET, executor._evict_hbm) and the spill of a store
to host runs (executor._spill_shuffle_to_host), on the CPU: gpu:4 with
device="cpu" (the kernels' plain versions), against the JAX package's
`local` master and, for the mirrors of its own eviction tests, its tpu:4
under the same budget.

Mirrors tests/test_tpu_backend.py:178 (budget 1: every store but the
newest leaves the device, and a later action on an evicted shuffle still
answers) and the shuffle tier of :350 (stores down to the newest; a
second collect does not count bytes twice).  Then: a spilled store of
each form (in-core combining, no-combine from sortByKey and groupByKey,
a streamed pre_reduced state, dictionary-encoded text keys) reads back
equal to `local` through the host export and, for a no-combine store,
through _seg_batch_from_runs (a grouped mapValues on the device); the
LRU order (a store fetched again stays while an older one spills);
completed jobs' stores spill before a running job's, whatever their LRU
order; a spill whose write raises drops the store, logs it, and the next
action recomputes it through its lineage; the stages that read a spilled
store record reads="host_runs"; and a 60-tick reduceByKeyAndWindow +
updateStateByKey stream under a small budget is exact against `local`
at every tick with the device-resident store bytes at or under the
budget after every tick (unless the newest store alone is left).  All
comparisons are exact (integer values)."""

import logging
import operator

import numpy as np
import pytest

from dpark_tpu import DparkContext as RefContext
from dpark_tpu import conf as ref_conf
from dpark_tpu_torch import Columns, DparkContext, conf
from dpark_tpu_torch.backend.cuda import executor as port_executor
from dpark_tpu_torch.dstream import StreamingContext


@pytest.fixture
def budget():
    """Set both packages' budgets; restored after the test."""
    old = (conf.SHUFFLE_HBM_BUDGET, ref_conf.SHUFFLE_HBM_BUDGET)

    def set_budget(b):
        conf.SHUFFLE_HBM_BUDGET = b
        ref_conf.SHUFFLE_HBM_BUDGET = b
    yield set_budget
    conf.SHUFFLE_HBM_BUDGET, ref_conf.SHUFFLE_HBM_BUDGET = old


@pytest.fixture
def gctx():
    c = DparkContext("gpu:4", device="cpu")
    c.start()
    yield c
    c.stop()


@pytest.fixture(scope="module")
def lctx():
    c = RefContext("local")
    yield c
    c.stop()


def _ex(ctx):
    return ctx.scheduler.executor


def _spilled(ex):
    return {sid for sid, m in ex.shuffle_store.items() if "host_runs" in m}


def _on_device(ex):
    return {sid for sid, m in ex.shuffle_store.items()
            if "host_runs" not in m}


def _eviction_job(ctx):
    """tests/test_tpu_backend.py:178's three collects."""
    r1 = ctx.parallelize([(i % 4, 1) for i in range(200)], 4) \
        .reduceByKey(lambda a, b: a + b, 4)
    out = [sorted(r1.collect())]
    r2 = ctx.parallelize([(i % 3, 1) for i in range(90)], 4) \
        .reduceByKey(lambda a, b: a + b, 4)
    out.append(sorted(r2.collect()))
    out.append(sorted(r1.collect()))      # r1's store left the device
    return out


def test_eviction_budget_one_matches_reference(budget, gctx, lctx):
    budget(1)                 # every store but the newest leaves
    got = _eviction_job(gctx)
    ex = _ex(gctx)
    assert got == _eviction_job(lctx)
    t = RefContext("tpu:4")
    try:
        assert got == _eviction_job(t)
    finally:
        t.stop()
    assert got[0] == [(k, 50) for k in range(4)]
    assert len(_on_device(ex)) == 1 and ex.resident_bytes == sum(
        ex.shuffle_store[s]["nbytes"] for s in _on_device(ex))
    # the third collect read the spilled store on the host, by design
    info = gctx.scheduler.history[-1]["stage_info"]
    assert [s.get("reads") for s in info] == ["host_runs"]
    assert "fallback_reason" not in info[0]


def test_budget_down_to_newest_no_double_count(budget, gctx):
    """The shuffle tier of tests/test_tpu_backend.py:350 (the port has
    no device result cache: its tier is always 0 bytes)."""
    budget(1)
    ex = _ex(gctx)
    r1 = gctx.parallelize([(i % 4, 1) for i in range(400)], 4) \
        .reduceByKey(lambda a, b: a + b, 4)
    assert dict(r1.collect()) == {k: 100 for k in range(4)}
    r2 = gctx.parallelize([(i % 2, 1) for i in range(100)], 4) \
        .reduceByKey(lambda a, b: a + b, 4)
    assert dict(r2.collect()) == {0: 50, 1: 50}
    assert len(_on_device(ex)) <= 1 and ex._result_bytes == 0
    before = ex.resident_bytes
    assert dict(r2.collect()) == {0: 50, 1: 50}
    assert ex.resident_bytes == before
    assert before == sum(m["nbytes"] for m in ex.shuffle_store.values())


def _spill_sid(ctx, rdd):
    """Spill the store of rdd's shuffle dependency now; returns its id."""
    ex = _ex(ctx)
    sid = rdd.dep.shuffle_id
    assert "host_runs" not in ex.shuffle_store[sid]
    before = ex.resident_bytes
    nbytes = ex.shuffle_store[sid]["nbytes"]
    ex._spill_shuffle_to_host(sid)
    assert "host_runs" in ex.shuffle_store[sid]
    assert ex.resident_bytes == before - nbytes
    assert ex.spills[-1]["sid"] == sid
    return sid


def _pairs(n=3000, keys=97, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(-500, 500, n).astype(np.int64) % keys,
            rng.integers(0, 1000, n).astype(np.int64))


FORMS = {
    # in-core combining: each partition folds with the user's merge
    "reduceByKey": lambda c, cols: c.parallelize(cols, 4)
    .reduceByKey(operator.add, 4),
    # no-combine, range partitioned: the host sort reads the runs
    "sortByKey": lambda c, cols: c.parallelize(cols, 4)
    .sortByKey(numSplits=4),
    # no-combine, hash partitioned: (k, [v]) rows
    "groupByKey": lambda c, cols: c.parallelize(cols, 4).groupByKey(4),
}


def _RefColumns(k, v):
    from dpark_tpu.rdd import Columns as RefColumns
    return RefColumns(k, v)


def _shuffled(rdd):
    """The ShuffledRDD under rdd's narrow chain."""
    while not hasattr(rdd, "dep"):
        rdd = rdd.prev
    return rdd


def _norm(form, rows):
    if form == "groupByKey":
        return sorted((k, sorted(vs)) for k, vs in rows)
    if form == "sortByKey":
        return [k for k, _ in rows], sorted(rows)
    return sorted(rows)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_spilled_store_reads_back_through_host(gctx, lctx, form):
    k, v = _pairs()
    build = FORMS[form]
    want = _norm(form, build(lctx, _RefColumns(k, v)).collect())
    rdd = build(gctx, Columns(k, v))
    assert _norm(form, rdd.collect()) == want
    _spill_sid(gctx, _shuffled(rdd))
    assert _norm(form, rdd.collect()) == want
    info = gctx.scheduler.history[-1]["stage_info"]
    assert info[-1].get("reads") == "host_runs"
    assert not any("fallback_reason" in s for s in info)


def test_spilled_nocombine_store_feeds_segment_op(gctx, lctx,
                                                  monkeypatch):
    """A spilled groupByKey store read by a grouped mapValues on the
    device: _seg_batch_from_runs (SegAggOp and SegMapOp; the combiner
    rewrite off, so that mapValues(sum) reads the grouped shuffle)."""
    monkeypatch.setattr(conf, "GROUP_AGG_REWRITE", False)
    k, v = _pairs(seed=4)
    g = gctx.parallelize(Columns(k, v), 4).groupByKey(4)
    want_sum = sorted(lctx.parallelize(_RefColumns(k, v), 4).groupByKey(4)
                      .mapValues(sum).collect())
    assert sorted(g.mapValues(sum).collect()) == want_sum
    _spill_sid(gctx, g)
    assert sorted(g.mapValues(sum).collect()) == want_sum
    info = gctx.scheduler.history[-1]["stage_info"]
    assert [s["kind"] for s in info] == ["array"]

    def sumsq(vs):
        return sum(x * x for x in vs)
    want = sorted(lctx.parallelize(_RefColumns(k, v), 4).groupByKey(4)
                  .mapValues(sumsq).collect())
    assert sorted(g.mapValues(sumsq).collect()) == want
    assert [s["kind"] for s in gctx.scheduler.history[-1]["stage_info"]] \
        == ["array"]
    assert g.count() == len(np.unique(k))


def test_spilled_pre_reduced_store(gctx, lctx):
    """A streamed combine's per-shard state (shard d holds partition d)
    spills one run a partition."""
    old = conf.STREAM_CHUNK_ROWS
    conf.STREAM_CHUNK_ROWS = 200
    try:
        k, v = _pairs(n=4000, seed=5)
        r = gctx.parallelize(Columns(k, v), 4).reduceByKey(operator.add, 4)
        want = sorted(lctx.parallelize(_RefColumns(k, v), 4)
                      .reduceByKey(operator.add, 4).collect())
        assert sorted(r.collect()) == want
        ex = _ex(gctx)
        assert ex.shuffle_store[r.dep.shuffle_id].get("pre_reduced")
        _spill_sid(gctx, r)
        assert "pre_reduced" not in ex.shuffle_store[r.dep.shuffle_id]
        assert sorted(r.collect()) == want
    finally:
        conf.STREAM_CHUNK_ROWS = old


def test_spilled_encoded_text_keys(gctx, lctx, tmp_path):
    rng = np.random.default_rng(6)
    words = ["w%d" % i for i in range(40)]
    path = tmp_path / "text.txt"
    path.write_text("\n".join(" ".join(rng.choice(words, 6))
                              for _ in range(300)) + "\n")

    def wc(ctx):
        return ctx.textFile(str(path)).flatMap(lambda l: l.split()) \
            .map(lambda w: (w, 1)).reduceByKey(operator.add, 4)
    want = sorted(wc(lctx).collect())
    r = wc(gctx)
    assert sorted(r.collect()) == want
    ex = _ex(gctx)
    assert ex.shuffle_store[r.dep.shuffle_id]["encoded_keys"]
    _spill_sid(gctx, r)
    assert sorted(r.collect()) == want
    assert r.count() == len(want)


def _reduced(ctx, seed, n=800):
    k, v = _pairs(n=n, keys=50, seed=seed)
    return ctx.parallelize(Columns(k, v), 4).reduceByKey(operator.add, 4)


def _ref_reduced(lctx, seed, n=800):
    k, v = _pairs(n=n, keys=50, seed=seed)
    return lctx.parallelize(_RefColumns(k, v), 4) \
        .reduceByKey(operator.add, 4)


def test_lru_order_keeps_a_store_fetched_again(budget, gctx):
    ex = _ex(gctx)
    a, b, c = (_reduced(gctx, s) for s in (7, 8, 9))
    a.collect()
    b.collect()
    sizes = {ex.shuffle_store[r.dep.shuffle_id]["nbytes"] for r in (a, b)}
    assert len(sizes) == 1
    budget(2 * sizes.pop())
    a.count()                          # a is fetched again: b is older
    c.collect()
    assert _spilled(ex) == {b.dep.shuffle_id}
    assert _on_device(ex) == {a.dep.shuffle_id, c.dep.shuffle_id}


def test_completed_jobs_spill_before_a_live_job(budget, gctx, lctx):
    """Job 2 builds y's store, then reads y and, after it, x (job 1's)
    in one union stage that writes u: x is the more recently fetched, yet
    when u's store takes the device over the budget, x spills first,
    because its job has completed."""
    ex = _ex(gctx)
    x = _reduced(gctx, 10)
    x.collect()
    budget(2 * ex.shuffle_store[x.dep.shuffle_id]["nbytes"])
    y = _reduced(gctx, 11)
    u = y.union(x).reduceByKey(operator.add, 4)
    assert sorted(u.collect()) == sorted(
        lctx.union([_ref_reduced(lctx, 11), _ref_reduced(lctx, 10)])
        .reduceByKey(operator.add, 4).collect())
    assert ex.shuffle_store[x.dep.shuffle_id]["seq"] > \
        ex.shuffle_store[y.dep.shuffle_id]["seq"]
    order = [s["sid"] for s in ex.spills]
    assert order[0] == x.dep.shuffle_id
    assert order[1:] in ([], [y.dep.shuffle_id])
    assert [s["kind"] for s in gctx.scheduler.history[-1]["stage_info"]] \
        == ["array", "array", "array"]


def test_victim_order_over_stamped_stores():
    """_evict_victim over stamped stores: completed jobs' least recently
    fetched first; then the live job holding the most bytes, its least
    recently fetched; never the kept, a pinned or a spilled store."""
    ex = port_executor.TorchExecutor(2, "cpu")

    def store(seq, job, nbytes, spilled=False):
        m = {"seq": seq, "job": job, "nbytes": nbytes}
        if spilled:
            m["host_runs"] = []
        return m
    ex.shuffle_store = {1: store(5, 1, 10), 2: store(3, 2, 10),
                        3: store(1, 2, 10), 4: store(2, 3, 50),
                        5: store(0, 1, 10, spilled=True)}
    ex.live_jobs = {2, 3}
    assert ex._evict_victim(keep_sid=None) == 1      # completed job 1
    ex.live_jobs = {1, 2, 3}
    assert ex._evict_victim(keep_sid=None) == 4      # job 3: 50 bytes
    assert ex._evict_victim(keep_sid=4) == 3         # job 2: its LRU
    ex._pinned = {3}
    assert ex._evict_victim(keep_sid=4) == 1         # job 1 ties job 2
    ex.shuffle_store = {5: store(0, 1, 10, spilled=True)}
    assert ex._evict_victim(keep_sid=None) is None


def test_failed_spill_drops_and_recomputes(budget, gctx, monkeypatch,
                                           caplog):
    ex = _ex(gctx)
    a = _reduced(gctx, 12)
    want = sorted(a.collect())
    sid = a.dep.shuffle_id

    def full_disk(path, cols):
        raise OSError(28, "No space left on device")
    monkeypatch.setattr(port_executor, "_write_run", full_disk)
    budget(1)
    with caplog.at_level(logging.WARNING, "dpark_tpu_torch.executor"):
        _reduced(gctx, 13).collect()
    assert sid not in ex.shuffle_store
    assert "dropping it" in caplog.text
    monkeypatch.undo()
    budget("auto")
    assert sorted(a.collect()) == want           # recomputed
    assert sid in ex.shuffle_store and sid not in _spilled(ex)
    kinds = [s["kind"] for s in gctx.scheduler.history[-1]["stage_info"]]
    assert kinds == ["array", "array"]           # the map stage re-ran


STREAM_TICKS = 60


def _stream_batches():
    rng = np.random.default_rng(20)
    return [[(int(k), 1) for k in rng.integers(0, 60, 120)]
            for _ in range(STREAM_TICKS)]


def _drive_stream(ctx, batches, each_tick=None):
    ssc = StreamingContext(ctx, 1.0)
    q = ssc.queueStream(batches)
    win, state = [], []
    q.reduceByKeyAndWindow(operator.add, 6.0, 2.0, numSplits=4,
                           invFunc=operator.sub).collect_batches(win)
    q.updateStateByKey(lambda vs, prev: sum(vs) + (prev or 0),
                       numSplits=4).collect_batches(state)
    ctx.start()
    ssc.zero_time = 1000.0
    for k in range(1, len(batches) + 1):
        ssc.run_batch(1000.0 + k)
        if each_tick is not None:
            each_tick(k)
    ssc.stop()
    return ([sorted((kk, v) for kk, v in rows if v) for _, rows in win],
            [sorted(rows) for _, rows in state])


def test_stream_under_small_budget(budget):
    batches = _stream_batches()
    want = _drive_stream(DparkContext("local"), batches)
    ctx = DparkContext("gpu:4", device="cpu")
    ctx.start()
    ex = _ex(ctx)
    limit = 6000
    budget(limit)
    resident = []

    def each_tick(k):
        dev = [m["nbytes"] for m in ex.shuffle_store.values()
               if "host_runs" not in m]
        assert sum(dev) == ex.resident_bytes
        assert ex.resident_bytes <= limit or len(dev) == 1, (k, dev)
        resident.append(ex.resident_bytes)
    got = _drive_stream(ctx, batches, each_tick)
    try:
        assert len(got[0]) == len(want[0]) == STREAM_TICKS // 2
        assert len(got[1]) == len(want[1]) == STREAM_TICKS
        for t, (g, w) in enumerate(zip(got[1], want[1])):
            assert g == w, t
        assert got[0] == want[0]
        assert len(ex.spills) > 10 and len(_spilled(ex)) > 10
        assert max(resident) <= limit
    finally:
        ctx.stop()
