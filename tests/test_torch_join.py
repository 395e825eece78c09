"""Joins, cogroup, union, flatMap, fold and cache on the port, on the CPU
(gpu masters with device="cpu": the kernels' plain versions): a mirror
of tests/test_tpu_backend.py's test_cogroup_device_exchange,
test_join_device_exchange_matches_local, test_device_join_expansion,
test_device_join_disjoint_and_skew, test_device_join_tuple_values and
test_tuple_key_join_rides_device, and of tests/test_rdd.py's
test_join_family, test_cogroup_copartitioned_narrow and the union,
flatMap, fold and cache parts of test_map_filter_flatmap,
test_reduce_fold_aggregate, test_union_zip and test_cache.

Every result runs on the port's local, gpu:2 and gpu:8 masters and
equals the JAX package's local master, sorted where the order of equal
keys is not a contract (ROADMAP C2); the device-join cases also equal
the JAX package's tpu:2.  On the gpu masters a.join(b) over two
no-combine shuffles is a device "join" stage (K12); a cogroup, an outer
join or an ineligible join runs the host merge, seeded from the device
where its inputs live there (`device_precompute`), with its
`fallback_reason`."""

import operator
from unittest import mock

import pytest
import torch

from dpark_tpu import DparkContext as RefContext
from dpark_tpu_torch import DparkContext
from dpark_tpu_torch.backend.cuda import fuse
from dpark_tpu_torch.backend.cuda.executor import TorchExecutor

MASTERS = ["local", "gpu:2", "gpu:8"]


@pytest.fixture(params=MASTERS)
def pctx(request):
    m = request.param
    c = DparkContext(m) if m == "local" else DparkContext(m, device="cpu")
    c.start()
    yield c
    c.stop()


@pytest.fixture(params=["gpu:2", "gpu:8"])
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
def tctx():
    c = RefContext("tpu:2")
    c.start()
    yield c
    c.stop()


def _P(ctx):
    """Partitions of a job: every gpu shard (a wider shuffle takes the
    host path), 8 on local."""
    return 8 if ctx.master == "local" else ctx.default_parallelism


def _on_gpu(ctx):
    return ctx.master != "local"


def _stages(ctx):
    return ctx.scheduler.history[-1]["stage_info"]


def _array_only(ctx):
    return all(s["kind"].startswith("array") and "fallback_reason" not in s
               for s in _stages(ctx))


def _join_stage(ctx):
    return [s for s in _stages(ctx) if s["rdd"] == "FlatMappedValuesRDD"][-1]


def _join(ctx, a_pairs, b_pairs, n=None):
    n = n or _P(ctx)
    return sorted(ctx.parallelize(a_pairs, n)
                  .join(ctx.parallelize(b_pairs, n), n).collect())


def _device_join(pctx, lctx, a_pairs, b_pairs):
    """The join on the port equals the JAX local master; on a gpu master
    every stage, the join source's included, ran on the device."""
    got = _join(pctx, a_pairs, b_pairs)
    assert got == _join(lctx, a_pairs, b_pairs, 8)
    if _on_gpu(pctx):
        assert _array_only(pctx), _stages(pctx)
        assert _join_stage(pctx)["kind"] == "array"
    return got


# ----------------------------------------------------------------------
# tests/test_tpu_backend.py
# ----------------------------------------------------------------------
def test_cogroup_device_exchange(pctx, lctx):
    P = _P(pctx)
    a = pctx.parallelize([(i % 20, i) for i in range(400)], P)
    b = pctx.parallelize([(i % 20, i * 3) for i in range(200)], P)
    got = dict(a.cogroup(b, numSplits=P).collect())
    want = dict(lctx.parallelize([(i % 20, i) for i in range(400)], 8)
                .cogroup(lctx.parallelize([(i % 20, i * 3)
                                           for i in range(200)], 8),
                         numSplits=8).collect())
    assert set(got) == set(want) == set(range(20))
    for k in range(20):
        assert sorted(got[k][0]) == sorted(want[k][0]) == \
            [i for i in range(400) if i % 20 == k]
        assert sorted(got[k][1]) == sorted(want[k][1])
    if _on_gpu(pctx):
        cg = _stages(pctx)[-1]
        assert cg["device_precompute"] == "cogroup", cg
        assert [s["kind"] for s in _stages(pctx)[:-1]] == ["array", "array"]


def test_join_device_exchange_matches_local(pctx, lctx):
    _device_join(pctx, lctx, [(i % 30, i) for i in range(300)],
                 [(i % 30, -i) for i in range(150)])


def test_device_join_expansion(pctx, lctx):
    got = _device_join(pctx, lctx, [(i % 12, i) for i in range(240)],
                       [(i % 12, -i) for i in range(120)])
    assert len(got) == 240 * 120 // 12


def test_device_join_disjoint_and_skew(pctx, lctx):
    assert _device_join(pctx, lctx, [(k, k) for k in range(10)],
                        [(k + 100, k) for k in range(10)]) == []
    got = _device_join(pctx, lctx,
                       [(7, i) for i in range(50)] + [(1, 0)],
                       [(7, -i) for i in range(40)] + [(2, 0)])
    assert len(got) == 50 * 40 and all(k == 7 for k, _ in got)


def test_device_join_tuple_values(pctx, lctx):
    _device_join(pctx, lctx, [(i % 5, (i, i * 2)) for i in range(50)],
                 [(i % 5, float(i)) for i in range(25)])


def test_tuple_key_join_rides_device(pctx, lctx):
    """Composite keys match lexicographically on the device (K12 over
    two key columns); the join-source stage is all-array."""
    _device_join(pctx, lctx, [((i % 3, i % 2), i) for i in range(24)],
                 [((i % 3, i % 2), -i) for i in range(12)])


@pytest.mark.parametrize("case", ["expansion", "skew", "tuple_key",
                                  "tuple_values"])
def test_device_join_matches_tpu(tctx, case):
    """gpu:2's device join equals the JAX package's tpu:2."""
    a, b = {
        "expansion": ([(i % 12, i) for i in range(240)],
                      [(i % 12, -i) for i in range(120)]),
        "skew": ([(7, i) for i in range(50)] + [(1, 0)],
                 [(7, -i) for i in range(40)] + [(2, 0)]),
        "tuple_key": ([((i % 3, i % 2), i) for i in range(24)],
                      [((i % 3, i % 2), -i) for i in range(12)]),
        "tuple_values": ([(i % 5, (i, i * 2)) for i in range(50)],
                         [(i % 5, float(i)) for i in range(25)]),
    }[case]
    c = DparkContext("gpu:2", device="cpu")
    got = _join(c, a, b)
    assert _array_only(c)
    c.stop()
    assert got == _join(tctx, a, b, 2)


# ----------------------------------------------------------------------
# tests/test_rdd.py
# ----------------------------------------------------------------------
def _family(ctx, a_pairs, b_pairs):
    a = ctx.parallelize(a_pairs, 2)
    b = ctx.parallelize(b_pairs, 2)
    return (sorted(a.join(b).collect()),
            sorted(a.leftOuterJoin(b).collect()),
            sorted(a.rightOuterJoin(b).collect()),
            sorted(a.outerJoin(b).collect(), key=repr))


def test_join_family(pctx, lctx):
    a_pairs = [("a", 1), ("b", 2), ("c", 3)]
    b_pairs = [("a", "x"), ("a", "y"), ("d", "z")]
    got = _family(pctx, a_pairs, b_pairs)
    assert got == _family(lctx, a_pairs, b_pairs)
    join, lo, ro, oo = got
    assert join == [("a", (1, "x")), ("a", (1, "y"))]
    assert dict(lo)["b"] == (2, None)
    assert ("d", (None, "z")) in ro
    assert dict(oo)["b"] == (2, None) and dict(oo)["d"] == (None, "z")


def test_join_family_int_keys(pctx, lctx):
    """The outer joins over device-resident inputs: the cogroup is
    exchanged and sorted on the device, merged on the host."""
    a_pairs = [(i % 7, i) for i in range(40)]
    b_pairs = [(i % 9 + 3, -i) for i in range(30)]
    assert _family(pctx, a_pairs, b_pairs) == _family(lctx, a_pairs,
                                                      b_pairs)
    if pctx.master == "gpu:2":
        assert _stages(pctx)[-1]["device_precompute"] == "cogroup"


def test_cogroup_copartitioned_narrow(pctx, lctx):
    def run(c):
        a = c.parallelize([(i, i) for i in range(10)], 2).partitionBy(4)
        b = c.parallelize([(i, i * 2) for i in range(10)], 3) \
            .partitionBy(4)
        return {k: (sorted(x), sorted(y))
                for k, (x, y) in a.cogroup(b, numSplits=4).collect()}
    got = run(pctx)
    assert got == run(lctx)
    assert got[3] == ([3], [6])


def test_union_flatmap(pctx, lctx):
    a = pctx.parallelize([1, 2], 2)
    b = pctx.parallelize([3, 4], 2)
    assert (a + b).collect() == [1, 2, 3, 4]
    assert a.union(b, a).collect() == [1, 2, 3, 4, 1, 2]
    u = a + b + a
    assert len(u.rdds) == 3 and len(u.splits) == 6
    assert pctx.union([b, a]).collect() == [3, 4, 1, 2]
    if _on_gpu(pctx):
        assert _stages(pctx)[-1]["fallback_reason"] == \
            fuse.UNION_RESULT_REASON
    r = pctx.parallelize(range(10), 4)
    assert r.flatMap(lambda x: [x, -x]).count() == 20
    assert r.flatMap(lambda x: [x] * (x % 3)).collect() == \
        lctx.parallelize(range(10), 4).flatMap(
            lambda x: [x] * (x % 3)).collect()
    kv = pctx.parallelize([(1, 2), (3, 4)], 2)
    assert kv.flatMapValue(lambda v: [v, v + 1]).collect() == \
        [(1, 2), (1, 3), (3, 4), (3, 5)]


def test_fold(pctx, lctx):
    r = pctx.parallelize(range(1, 101), 7)
    assert r.fold(0, operator.add) == 5050
    # each partition folds into its own copy of a mutable zero
    got = r.map(lambda x: x % 3).fold([], lambda acc, x: acc + [x]
                                      if isinstance(x, int) else acc + x)
    assert sorted(got) == sorted(x % 3 for x in range(1, 101))
    # zero enters once per partition and once more at the driver
    assert pctx.parallelize([], 3).fold(7, operator.add) == \
        lctx.parallelize([], 3).fold(7, operator.add)
    assert pctx.parallelize([1, 2], 2).fold(7, operator.add) == 24


def test_cache(pctx):
    """A cached RDD computes each partition once; unpersist drops it.
    On a gpu master the cached stage runs the host path (the device
    result cache is not ported)."""
    calls = []
    r = pctx.parallelize(range(10), 2).map(
        lambda x: (calls.append(1), x * 2)[1]).cache()
    assert r.collect() == [x * 2 for x in range(10)]
    first = len(calls)
    assert first == 10
    assert r.collect() == [x * 2 for x in range(10)]
    assert len(calls) == first          # second pass served from cache
    if _on_gpu(pctx):
        assert _stages(pctx)[-1]["fallback_reason"] == \
            fuse.CACHE_REASON % "MappedRDD"
    r.unpersist()
    assert r.count() == 10
    assert len(calls) > first


# ----------------------------------------------------------------------
# the device join inside longer chains, and where it declines
# ----------------------------------------------------------------------
def test_join_map_reduce_stays_on_device(pctx, lctx):
    """join -> map -> reduceByKey: the join source, the map and the
    combining write all run on the device."""
    a_pairs = [(i, i % 13) for i in range(300)]       # (order, customer)
    b_pairs = [(i % 300, i * 10) for i in range(900)]  # (order, revenue)

    def run(c, n):
        return sorted(c.parallelize(b_pairs, n)
                      .join(c.parallelize(a_pairs, n), n)
                      .map(lambda kv: (kv[1][1], kv[1][0]))
                      .reduceByKey(operator.add, n).collect())
    got = run(pctx, _P(pctx))
    assert got == run(lctx, 8)
    if _on_gpu(pctx):
        assert _array_only(pctx), _stages(pctx)
        assert len(_stages(pctx)) == 4
    count = (pctx.parallelize(b_pairs, _P(pctx))
             .join(pctx.parallelize(a_pairs, _P(pctx)), _P(pctx)).count())
    assert count == 900
    if _on_gpu(pctx):
        assert _stages(pctx)[-1]["kind"] == "array+counts"


def test_take_on_join_precomputes(gctx, lctx):
    """A partial job (take) runs the host path; the join's pairs are
    still expanded on the device first."""
    a_pairs = [(i % 6, i) for i in range(60)]
    b_pairs = [(i % 6, -i) for i in range(30)]
    P = _P(gctx)
    got = (gctx.parallelize(a_pairs, P)
           .join(gctx.parallelize(b_pairs, P), P).take(7))
    assert len(got) == 7
    assert set(got) <= set(_join(lctx, a_pairs, b_pairs, 8))
    st = _stages(gctx)[-1]
    assert st["device_precompute"] == "join"
    assert st["fallback_reason"].startswith("partial job")


def _to_int32(kv):
    """The key as int32 on the device, unchanged on the host."""
    k = kv[0]
    return (k.to(torch.int32) if isinstance(k, torch.Tensor) else k, kv[1])


@pytest.mark.parametrize("case", ["narrow", "combined", "host", "dtype",
                                  "width", "leaves"])
def test_ineligible_join_falls_back(gctx, lctx, case):
    """A join the device does not take runs the host path with the
    reason, and equals local."""
    P = _P(gctx)
    ints = [(i % 8, i) for i in range(64)]
    wide = [(i % 8, tuple(range(i, i + 9))) for i in range(16)]

    def build(c, n):
        a = c.parallelize(ints, n)
        b = c.parallelize([(i % 8, -i) for i in range(32)], n)
        if case == "narrow":
            a = a.partitionBy(n)
        elif case == "combined":
            a = a.reduceByKey(operator.add, n)
        elif case == "host":
            a = c.parallelize([(i % 8, "s%d" % i) for i in range(64)], n)
        elif case == "dtype":
            b = b.map(_to_int32)
        elif case == "width":
            a = c.parallelize([((i % 8, 0), i) for i in range(64)], n)
        else:
            a = c.parallelize(wide, n)
            b = c.parallelize([(i % 8, tuple(range(8))) for i in range(8)],
                              n)
        return sorted(a.join(b, n).collect())
    want = build(lctx, 8)
    assert build(gctx, P) == want
    st = _join_stage(gctx)
    reason = {
        "narrow": fuse.JOIN_NARROW_REASON % 0,
        "combined": fuse.JOIN_NARROW_REASON % 0,
        "host": fuse.JOIN_HOST_REASON % 0,
        "dtype": fuse.JOIN_KEY_REASON % ((1, ("int64",)), (1, ("int32",))),
        "width": fuse.JOIN_KEY_REASON % ((2, ("int64", "int64")),
                                         (1, ("int64",))),
        "leaves": fuse.JOIN_LEAVES_REASON % (18, 16),
    }[case]
    assert st["kind"] == "object" and st["fallback_reason"] == reason
    if case == "leaves":
        assert st["device_precompute"] == "cogroup"


def test_join_wider_than_shards_declines():
    """A join over more partitions than shards is no device source."""
    c = DparkContext("gpu:8", device="cpu")
    j = c.parallelize([(i, i) for i in range(16)], 8).join(
        c.parallelize([(i, -i) for i in range(16)], 8), 8)
    assert j.count() == 16
    store = c.scheduler.executor.shuffle_store
    joined, reason = fuse._analyze_join_source(j, 8, store)
    assert joined is not None and reason is None
    assert fuse._analyze_join_source(j, 4, store) == (
        None, fuse.JOIN_WIDE_REASON % (8, 4))
    c.stop()


def test_device_join_errors_propagate(gctx):
    """An error inside the device join's work propagates, on the array
    path and in the host path's precompute alike (ROADMAP C13): nothing
    falls back."""
    P = _P(gctx)

    def sides():
        return (gctx.parallelize([(i % 5, i) for i in range(40)], P),
                gctx.parallelize([(i % 5, -i) for i in range(20)], P))
    boom = RuntimeError("device join failed")
    a, b = sides()
    with mock.patch.object(TorchExecutor, "device_join_batch",
                           side_effect=boom):
        with pytest.raises(RuntimeError, match="device join failed"):
            a.join(b, P).collect()
        a, b = sides()
        with pytest.raises(RuntimeError, match="device join failed"):
            a.join(b, P).take(3)
    a, b = sides()
    with mock.patch.object(TorchExecutor, "gather_rows", side_effect=boom):
        with pytest.raises(RuntimeError, match="device join failed"):
            a.cogroup(b, numSplits=P).collect()
