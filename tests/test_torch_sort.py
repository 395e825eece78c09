"""gpu[:N] master, sort / partition / group / distinct, on the CPU
(device="cpu": the kernels' plain versions): a mirror of
tests/test_tpu_backend.py's test_sortbykey_on_device ..
test_inf_float_key_falls_back, plus descending ties, tuple keys and the
host-path reasons.  Every result equals the `local` master row for row
(the JAX package's, and the port's own); a few jobs also run on the JAX
package's tpu:2 master, where integer keys match exactly and float keys
within float32 rounding (that master narrows floats to float32)."""

import random

import numpy as np
import pytest

from dpark_tpu import DparkContext as RefContext
from dpark_tpu.rdd import Columns as RefColumns
from dpark_tpu_torch import Columns, DparkContext
from dpark_tpu_torch.backend.cuda import fuse

MASTERS = ["gpu:2", "gpu:8"]


@pytest.fixture(params=MASTERS)
def gctx(request):
    c = DparkContext(request.param, device="cpu")
    c.start()
    yield c
    c.stop()


@pytest.fixture(scope="module")
def lctx():
    c = RefContext("local")
    yield c
    c.stop()


@pytest.fixture(scope="module")
def pctx():
    """The port's own local master."""
    c = DparkContext("local")
    yield c
    c.stop()


def _P(ctx):
    return ctx.default_parallelism


def _stages(ctx):
    return ctx.scheduler.history[-1]["stage_info"]


def _kinds(ctx):
    return [s["kind"] for s in _stages(ctx)]


def _array_only(ctx):
    return all(s["kind"].startswith("array")
               and "fallback_reason" not in s for s in _stages(ctx))


def _used_array_path(ctx):
    return len(ctx.scheduler.executor.shuffle_store) > 0


def _same_everywhere(build, gctx, lctx, pctx):
    """build(ctx) on the gpu master equals both local masters."""
    got = build(gctx)
    assert got == build(lctx)
    assert got == build(pctx)
    return got


def _int_pairs(n=4000, seed=9):
    rng = random.Random(seed)
    return [(rng.randint(-10000, 10000), i) for i in range(n)]


@pytest.mark.parametrize("ascending", [True, False])
def test_sortbykey_on_device(gctx, lctx, pctx, ascending):
    P = _P(gctx)
    pairs = _int_pairs()

    def build(c):
        return c.parallelize(pairs, P).sortByKey(
            ascending=ascending, numSplits=P).collect()
    got = _same_everywhere(build, gctx, lctx, pctx)
    assert [k for k, _ in got] == sorted((k for k, _ in pairs),
                                         reverse=not ascending)
    assert _used_array_path(gctx)
    assert _array_only(gctx) and len(_stages(gctx)) == 2


@pytest.mark.parametrize("ascending", [True, False])
def test_sortbykey_float_keys_device(gctx, lctx, pctx, ascending):
    P = _P(gctx)
    rng = random.Random(4)
    pairs = [(rng.random() * 100 - 50, i) for i in range(2000)]
    pairs += [(0.0, -1), (-0.0, -2), (1e-300, -3), (-1e300, -4)]

    def build(c):
        return c.parallelize(pairs, P).sortByKey(
            ascending=ascending, numSplits=P).collect()
    got = _same_everywhere(build, gctx, lctx, pctx)
    assert len(got) == len(pairs)
    assert _array_only(gctx)


def test_descending_ties_keep_input_order(gctx, lctx, pctx):
    """Equal keys keep their input order in a descending sort, as
    Python's sorted(reverse=True) does.  The JAX package's tpu master
    reverses an ascending sort instead, so there equal keys come out in
    reverse input order ((4, 59), (4, 54), ... for this job): the port
    follows `local`, the golden model (ROADMAP queue C3)."""
    pairs = [(i % 5, i) for i in range(60)]

    def build(c):
        return c.parallelize(pairs, 2).sortByKey(
            ascending=False, numSplits=2).collect()
    got = _same_everywhere(build, gctx, lctx, pctx)
    assert got[:3] == [(4, 4), (4, 9), (4, 14)]
    assert _array_only(gctx)


@pytest.mark.parametrize("ascending", [True, False])
def test_tuple_key_sortbykey(gctx, lctx, pctx, ascending):
    P = _P(gctx)
    pairs = [(((i * 7) % 11, (i * 5) % 3), i) for i in range(900)]

    def build(c):
        return c.parallelize(pairs, P).sortByKey(
            ascending=ascending, numSplits=P).collect()
    _same_everywhere(build, gctx, lctx, pctx)
    assert _array_only(gctx)


def test_mixed_dtype_tuple_key_falls_back(gctx, lctx, pctx):
    P = _P(gctx)
    pairs = [(((i * 7) % 11, float(i % 3)), i) for i in range(300)]

    def build(c):
        return c.parallelize(pairs, P).sortByKey(numSplits=P).collect()
    _same_everywhere(build, gctx, lctx, pctx)
    assert _stages(gctx)[0]["fallback_reason"] == fuse.RANGE_MIXED_REASON
    assert _stages(gctx)[1]["fallback_reason"] == (
        "parent shuffle output lives on the host")


def test_sort_with_key_function(gctx, lctx, pctx):
    P = _P(gctx)
    data = [(i * 37) % 101 for i in range(500)]

    def build(c):
        return (c.parallelize(data, P).sort(key=lambda x: -x, numSplits=P)
                .collect())
    got = _same_everywhere(build, gctx, lctx, pctx)
    assert got == sorted(data, reverse=True)
    assert _array_only(gctx)


def test_sortbykey_actions_on_device(gctx, lctx, pctx):
    """count() and top() of a sorted RDD on the device."""
    P = _P(gctx)
    pairs = _int_pairs(3000, 11)

    def count(c):
        return c.parallelize(pairs, P).sortByKey(numSplits=P).count()

    def top(c):
        return c.parallelize(pairs, P).sortByKey(numSplits=P).top(7)
    assert _same_everywhere(count, gctx, lctx, pctx) == len(pairs)
    assert _kinds(gctx) == ["array", "array+counts"]
    assert _same_everywhere(top, gctx, lctx, pctx) == sorted(pairs)[-7:][::-1]
    assert _kinds(gctx) == ["array", "array+top"]


def test_sortbykey_single_split_sorts_in_place(lctx, pctx):
    """One input split: sortByKey is one mapPartitions sort (SortOp), no
    shuffle; on a one-shard gpu master it runs on the device."""
    g = DparkContext("gpu", device="cpu")
    try:
        pairs = _int_pairs(700, 3)
        for asc in (True, False):
            def build(c):
                return c.parallelize(pairs, 1).sortByKey(
                    ascending=asc).collect()
            _same_everywhere(build, g, lctx, pctx)
            assert _kinds(g) == ["array"]
    finally:
        g.stop()


def test_columnar_sortbykey_samples_on_the_host(gctx, lctx, pctx):
    """The bounds sample over a columnar input is a lazy host read, then
    the sort runs on the device."""
    P = _P(gctx)
    rng = np.random.RandomState(2)
    keys = rng.randint(-2 ** 40, 2 ** 40, 5000)
    vals = np.arange(5000)
    r = gctx.parallelize(Columns(keys, vals), P)
    got = r.sortByKey(numSplits=P).collect()
    sample_job = gctx.scheduler.history[-2]["stage_info"]
    assert sample_job[0]["fallback_reason"] == (
        "plain read of the input: no device work")
    assert _array_only(gctx)
    want = lctx.parallelize(RefColumns(keys, vals), P).sortByKey(
        numSplits=P).collect()
    assert got == want == pctx.parallelize(Columns(keys, vals), P) \
        .sortByKey(numSplits=P).collect()


def test_groupbykey_on_device(gctx, lctx, pctx):
    P = _P(gctx)
    pairs = [(i % 7, i) for i in range(700)]

    def build(c):
        return dict(c.parallelize(pairs, P).groupByKey(P).collect())
    got = _same_everywhere(build, gctx, lctx, pctx)
    assert set(got) == set(range(7))
    for k in range(7):        # values in input order
        assert got[k] == [i for i in range(700) if i % 7 == k]
    assert _used_array_path(gctx) and _array_only(gctx)

    def count(c):
        return c.parallelize(pairs, P).groupByKey(P).count()
    assert _same_everywhere(count, gctx, lctx, pctx) == 7
    assert _kinds(gctx) == ["array", "array+counts"]


def test_groupbykey_tuple_keys_and_group_by(gctx, lctx, pctx):
    P = _P(gctx)
    pairs = [((i % 4, i % 3), i) for i in range(240)]

    def build(c):
        return sorted(c.parallelize(pairs, P).groupByKey(P).collect())
    _same_everywhere(build, gctx, lctx, pctx)
    assert _array_only(gctx)

    def count(c):
        return c.parallelize(pairs, P).groupByKey(P).count()
    assert _same_everywhere(count, gctx, lctx, pctx) == 12

    def group_by(c):
        return sorted(c.parallelize(list(range(100)), P)
                      .groupBy(lambda x: x % 6, P).collect())
    _same_everywhere(group_by, gctx, lctx, pctx)
    assert _array_only(gctx)


def test_grouped_values_consumed_on_host(gctx, lctx, pctx):
    """A map over whole (k, [v]) records has no device form (only
    mapValues(f) of the groups rides the grouped apply): the reduce stage
    takes the host path with the reference's reason."""
    P = _P(gctx)
    pairs = [(i % 5, i) for i in range(100)]

    def build(c):
        return sorted(c.parallelize(pairs, P).groupByKey(P)
                      .map(lambda kv: (kv[0], len(kv[1]))).collect())
    assert _same_everywhere(build, gctx, lctx, pctx) == [(k, 20)
                                                         for k in range(5)]
    assert _kinds(gctx) == ["array", "object"]
    assert _stages(gctx)[1]["fallback_reason"] == fuse.GROUP_REASON


def test_partition_by_device_then_host_op(gctx, lctx, pctx):
    """partitionBy on the device, then an untraceable op reading the
    no-combine store through the export bridge: flat (k, v) records."""
    P = _P(gctx)
    pairs = [(i, i * 2) for i in range(400)]

    def build(c):
        return c.parallelize(pairs, P).partitionBy(P) \
            .mapPartitions(lambda it: [sorted(it)]).collect()
    got = _same_everywhere(build, gctx, lctx, pctx)
    assert sorted(kv for part in got for kv in part) == pairs
    assert _kinds(gctx) == ["array", "object"]


def test_partition_by_on_device(gctx, lctx, pctx):
    """Row order inside a partition is not part of partitionBy's
    contract: the device (like the JAX package's tpu master) leaves each
    partition key-sorted, `local` in order of first appearance.  Rows per
    partition are equal (test_partition_by_device_then_host_op)."""
    P = _P(gctx)
    pairs = [((i * 13) % 50, i) for i in range(600)]

    def build(c):
        r = c.parallelize(pairs, P).partitionBy(P)
        return r.count(), sorted(r.map(lambda kv: (kv[0], kv[1] + 1))
                                 .collect())
    _same_everywhere(build, gctx, lctx, pctx)
    assert _array_only(gctx)

    def combine(c):
        return sorted(c.parallelize(pairs, P).partitionBy(P)
                      .reduceByKey(lambda a, b: a + b, P).collect())
    _same_everywhere(combine, gctx, lctx, pctx)
    assert _array_only(gctx) and len(_stages(gctx)) == 3


def test_distinct_on_device(gctx, lctx, pctx):
    P = _P(gctx)
    data = [i % 50 for i in range(2000)]

    def build(c):
        return sorted(c.parallelize(data, P).distinct(P).collect())
    assert _same_everywhere(build, gctx, lctx, pctx) == list(range(50))
    assert _array_only(gctx)

    def count(c):
        return c.parallelize([(i % 9, i % 4) for i in range(500)], P) \
            .distinct(P).count()
    assert _same_everywhere(count, gctx, lctx, pctx) == 36
    assert _kinds(gctx) == ["array", "array+counts"]


def test_sentinel_key_in_range_sort_falls_back(gctx, lctx, pctx):
    """INT64_MAX key must not be silently dropped by the device sort."""
    P = _P(gctx)
    pairs = [(i, i) for i in range(100, 1000)] + [(2 ** 63 - 1, 111)]

    def build(c):
        return c.parallelize(pairs, P).sortByKey(numSplits=P).collect()
    got = _same_everywhere(build, gctx, lctx, pctx)
    assert got[-1] == (2 ** 63 - 1, 111) and len(got) == len(pairs)
    assert _stages(gctx)[0]["fallback_reason"] == (
        "key equal to the device sentinel; taking the host path")


def test_inf_float_key_falls_back(gctx, lctx, pctx):
    P = _P(gctx)
    pairs = [(float(i), i) for i in range(50)] + [(float("inf"), -1)]

    def build(c):
        return c.parallelize(pairs, P).sortByKey(numSplits=P).collect()
    got = _same_everywhere(build, gctx, lctx, pctx)
    assert got[-1] == (float("inf"), -1)
    assert _stages(gctx)[0]["fallback_reason"] == (
        "inf/nan float key collides with device padding; taking the host "
        "path")


def _ref_kinds(ctx):
    return [s["kind"] for s in ctx.scheduler.history[-1]["stage_info"]]


def _array_where_ref_is(gctx, tctx):
    ref = _ref_kinds(tctx)
    got = _kinds(gctx)
    return len(got) == len(ref) and all(
        g.startswith("array") for g, r in zip(got, ref)
        if r.startswith("array"))


@pytest.mark.parametrize("case", ["sort", "sort_desc", "tuple", "group",
                                  "partition", "distinct"])
def test_matches_tpu2(case, lctx):
    """The same jobs on the JAX package's tpu:2 master: equal results
    (descending: equal keys, ties aside), and the tensor path wherever
    the reference takes it (its distinct reduce stage runs on the host;
    the port's runs on the device).  partitionBy's rows come out
    key-sorted on both tensor masters; `local` keeps them in order of
    first appearance, so it is compared as a multiset."""
    pairs = [((i * 7919) % 97 - 40, i) for i in range(600)]

    def build(c):
        r = c.parallelize(pairs, 2)
        if case == "sort":
            return r.sortByKey(numSplits=2).collect()
        if case == "sort_desc":
            return [k for k, _ in r.sortByKey(ascending=False,
                                              numSplits=2).collect()]
        if case == "tuple":
            return r.map(lambda kv: ((kv[0] % 5, kv[0]), kv[1])) \
                .sortByKey(numSplits=2).collect()
        if case == "group":
            return sorted(r.groupByKey(2).collect())
        if case == "partition":
            return r.partitionBy(2).collect()
        return sorted(r.map(lambda kv: kv[0]).distinct(2).collect())
    tctx = RefContext("tpu:2")
    gctx = DparkContext("gpu:2", device="cpu")
    try:
        want = build(tctx)
        assert build(gctx) == want
        assert _array_where_ref_is(gctx, tctx)
        assert _array_only(gctx)
        local = build(lctx)
        if case == "partition":
            want, local = sorted(want), sorted(local)
        assert want == local
    finally:
        tctx.stop()
        gctx.stop()


def test_float_sort_matches_tpu2_within_float32(lctx):
    rng = random.Random(5)
    pairs = [(rng.random() * 100 - 50, i) for i in range(800)]
    tctx = RefContext("tpu:2")
    gctx = DparkContext("gpu:2", device="cpu")
    try:
        want = tctx.parallelize(pairs, 2).sortByKey(numSplits=2).collect()
        got = gctx.parallelize(pairs, 2).sortByKey(numSplits=2).collect()
        assert got == lctx.parallelize(pairs, 2).sortByKey(
            numSplits=2).collect()
        assert len(got) == len(want)
        # tpu:2 narrows keys to float32: keys agree within its rounding
        gk = np.array([k for k, _ in got])
        wk = np.array([k for k, _ in want])
        assert np.allclose(gk, wk, rtol=2 ** -23, atol=0)
        assert _kinds(gctx) == _ref_kinds(tctx) == ["array", "array"]
    finally:
        tctx.stop()
        gctx.stop()
