"""The graph-build combiner rewrite of the PyTorch port
(dpark_tpu_torch.rdd.RDD._group_agg_rewrite): groupByKey().mapValue(
provable aggregate) becomes a map-side-combining combineByKey on every
master, as in the JAX package.  A mirror of tests/test_group_agg_rewrite.py
on the port's `local` and `gpu:2` (device="cpu") masters.  Every result
equals the JAX package's `local` master exactly: float sums included,
because both packages now pre-combine each map partition in row order and
merge the partials in map order."""

import numpy as np
import pytest

from dpark_tpu import DparkContext as RefContext
from dpark_tpu_torch import DparkContext, conf
from dpark_tpu_torch.rdd import MappedValuesRDD, ShuffledRDD, _mk_list

ROWS = [(i % 37, (i * 5) % 13 - 4) for i in range(3000)]
MASTERS = ["local", "gpu:2"]


def _ctx(master):
    if master == "local":
        return DparkContext("local")
    return DparkContext(master, device="cpu")


@pytest.fixture(params=MASTERS)
def tctx(request):
    c = _ctx(request.param)
    c.start()
    yield c
    c.stop()


@pytest.fixture(scope="module")
def lctx():
    c = RefContext("local")
    yield c
    c.stop()


def _groups(rows):
    exp = {}
    for k, v in rows:
        exp.setdefault(k, []).append(v)
    return exp


def _map_stage(ctx):
    (st,) = [s for s in ctx.scheduler.history[-1]["stage_info"]
             if s["shuffle"]]
    return st


def _float_rows(n=5000, seed=3):
    rng = np.random.RandomState(seed)
    return [(int(k), float(v)) for k, v in
            zip(rng.randint(0, 40, n), rng.standard_normal(n) * 1e3)]


def test_float_sum_bit_identical_to_reference_local(tctx, lctx):
    """The repair: the port folds float sums as the JAX package's
    `local` does (map-side partials, merged per partition), bit for bit,
    and the stage record shows a combining shuffle."""
    rows = _float_rows()

    def job(c):
        return sorted(c.parallelize(rows, 2).groupByKey(2)
                      .mapValues(sum).collect())
    got = job(tctx)
    assert got == job(lctx)
    assert _map_stage(tctx)["combine"] is True
    if tctx.master != "local":
        assert all(s["kind"].startswith("array")
                   for s in tctx.scheduler.history[-1]["stage_info"])


def test_rewrite_off_keeps_the_grouping(tctx):
    """conf.GROUP_AGG_REWRITE off: the grouped shuffle stays no-combine
    and the aggregate applies to each group's list."""
    old = conf.GROUP_AGG_REWRITE
    conf.GROUP_AGG_REWRITE = False
    try:
        r = tctx.parallelize(ROWS, 2).groupByKey(2).mapValues(sum)
        assert isinstance(r, MappedValuesRDD)
        got = dict(r.collect())
    finally:
        conf.GROUP_AGG_REWRITE = old
    assert got == {k: sum(vs) for k, vs in _groups(ROWS).items()}
    assert _map_stage(tctx)["combine"] is False


@pytest.mark.parametrize("f,host", [
    (sum, sum),
    (len, len),
    (min, min),
    (max, max),
    (lambda vs: sum(vs) / len(vs), lambda vs: sum(vs) / len(vs)),
])
def test_rewrite_matches_group_semantics(tctx, lctx, f, host):
    def job(c):
        return c.parallelize(ROWS, 2).groupByKey(2).mapValues(f)
    r = job(tctx)
    # the rewrite removed the grouped ShuffledRDD: the graph is a
    # combining shuffle (mean adds one finalize mapValue)
    node = r.prev if isinstance(r, MappedValuesRDD) else r
    assert isinstance(node, ShuffledRDD)
    assert node.aggregator.create_combiner is not _mk_list
    got = dict(r.collect())
    assert got == {k: host(vs) for k, vs in _groups(ROWS).items()}
    assert got == dict(job(lctx).collect())
    assert _map_stage(tctx)["combine"] is True


def test_rewrite_preserves_error_behavior():
    """sum over string values raises on the host path; the rewrite's
    0 + v must raise too, not silently concatenate."""
    with DparkContext("local") as c:
        r = c.parallelize([("k", "a"), ("k", "b")], 2).groupByKey(2) \
            .mapValues(sum)
        with pytest.raises(Exception):
            r.collect()


def test_rewrite_min_over_strings():
    """min/max over strings still work through the rewrite (comparison
    semantics are pairwise-equal)."""
    srows = [(i % 5, "s%02d" % (i % 23)) for i in range(200)]
    with DparkContext("local") as c:
        got = dict(c.parallelize(srows, 4).groupByKey(4)
                   .mapValues(min).collect())
    assert got == {k: min(vs) for k, vs in _groups(srows).items()}


def test_rewrite_mean_float32_width():
    """mean keeps the host's width semantics through the rewrite."""
    rows = [(i % 7, np.float32(i % 5)) for i in range(280)]
    with DparkContext("local") as c:
        got = dict(c.parallelize(rows, 4).groupByKey(4)
                   .mapValues(lambda vs: sum(vs) / len(vs)).collect())
    for k, vs in _groups(rows).items():
        acc = 0
        for v in vs:
            acc = acc + v
        assert np.float32(got[k]) == np.float32(acc / len(vs))


def test_partitionby_mapvalue_not_rewritten(tctx):
    """partitionBy keeps flat (k, v) rows: mapValue(sum) there applies to
    each value and is not a group aggregate."""
    rows = [(i % 5, (i, i + 1)) for i in range(50)]
    r = tctx.parallelize(rows, 2).partitionBy(2).mapValue(sum)
    assert isinstance(r, MappedValuesRDD)
    got = sorted(r.collect())
    assert got == sorted((k, a + b) for k, (a, b) in rows)


def test_np_aggregates_not_rewritten():
    """np.sum/np.mean flatten a list of array values; the pairwise
    rewrite would compute elementwise: np twins keep the grouping."""
    rows = [(i % 3, np.asarray([i, i + 1.0])) for i in range(30)]
    with DparkContext("local") as c:
        r = c.parallelize(rows, 4).groupByKey(4).mapValues(np.mean)
        assert isinstance(r, MappedValuesRDD)
        got = dict(r.collect())
    for k, vs in _groups(rows).items():
        assert abs(got[k] - float(np.mean(vs))) < 1e-9


def test_builtin_sum_over_arrays_still_rewrites():
    """builtin sum over array values is pairwise-equal (chained +): the
    rewrite applies and matches."""
    rows = [(i % 3, np.asarray([i, i * 2])) for i in range(30)]
    with DparkContext("local") as c:
        r = c.parallelize(rows, 4).groupByKey(4).mapValues(sum)
        assert not isinstance(r, MappedValuesRDD)
        got = dict(r.collect())
    for k, vs in _groups(rows).items():
        assert np.array_equal(got[k], sum(vs))


def test_materialized_group_not_rewritten(tctx):
    """Once a grouped RDD's shuffle outputs exist, later aggregates reuse
    them instead of re-scanning the parent."""
    g = tctx.parallelize(ROWS, 2).groupByKey(2)
    assert g.count() == len(_groups(ROWS))     # materializes g's dep
    r = g.mapValues(sum)
    assert isinstance(r, MappedValuesRDD)
    got = dict(r.collect())
    assert got == {k: sum(vs) for k, vs in _groups(ROWS).items()}
