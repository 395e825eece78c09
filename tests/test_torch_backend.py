"""gpu[:N] master parity, on the CPU (device="cpu": the kernels' plain
versions): a mirror of tests/test_tpu_backend.py's main-path block
(test_parallelize_collect_roundtrip .. test_int64_sentinel_key_falls_back)
without its text, sort, join and eviction tests.  Every result must equal
the JAX package's `local` master on the same program; a few also equal
its `tpu:2` master.  Stage records carry the path taken (`kind`) and,
for host stages, the reason (`fallback_reason`)."""

import pytest

from dpark_tpu import DparkContext as RefContext
from dpark_tpu.rdd import Columns as RefColumns
from dpark_tpu_torch import Columns, DparkContext

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


def _add(a, b):
    return a + b


def test_parallelize_collect_roundtrip(gctx, lctx):
    P = _P(gctx)
    data = list(range(100))
    got = gctx.parallelize(data, P).collect()
    assert got == data == lctx.parallelize(data, 8).collect()
    # a plain read does no device work: the host path, with its reason
    assert _stages(gctx)[0]["fallback_reason"]


def test_map_filter_fused(gctx, lctx):
    P = _P(gctx)
    def build(c, n):
        return (c.parallelize(list(range(64)), n).map(lambda x: x * 3)
                .filter(lambda x: x % 2 == 0).collect())
    assert build(gctx, P) == build(lctx, P)
    assert _kinds(gctx) == ["array"]


def test_reduce_by_key_device_shuffle(gctx, lctx):
    P = _P(gctx)
    pairs = [(i % 13, i) for i in range(1000)]
    got = dict(gctx.parallelize(pairs, P).reduceByKey(_add, P).collect())
    assert got == dict(lctx.parallelize(pairs, P).reduceByKey(_add, P)
                       .collect())
    assert _used_array_path(gctx)
    assert _array_only(gctx) and len(_stages(gctx)) == 2


def test_reduce_by_key_matches_local(gctx, lctx):
    P = _P(gctx)
    pairs = [((i * 7919) % 101, i % 17) for i in range(5000)]
    got = dict(gctx.parallelize(pairs, P).reduceByKey(_add, P).collect())
    assert got == dict(lctx.parallelize(pairs, P).reduceByKey(_add, P)
                       .collect())


def test_negative_and_large_keys(gctx):
    P = _P(gctx)
    pairs = [(k, 1) for k in [-1, -2, 0, 2**30, -(2**30), 7, -7] * 10]
    got = dict(gctx.parallelize(pairs, P).reduceByKey(_add, P).collect())
    assert got == {-1: 10, -2: 10, 0: 10, 2**30: 10,
                   -(2**30): 10, 7: 10, -7: 10}
    assert _array_only(gctx)


def test_skewed_keys(gctx, lctx):
    P = _P(gctx)
    pairs = [(0, 1)] * 3000 + [(i, 1) for i in range(1, 50)]
    got = dict(gctx.parallelize(pairs, P).reduceByKey(_add, P).collect())
    assert got == dict(lctx.parallelize(pairs, P).reduceByKey(_add, P)
                       .collect())
    assert got[0] == 3000


def test_map_after_shuffle(gctx):
    P = _P(gctx)
    pairs = [(i % 5, 1) for i in range(100)]
    got = sorted(gctx.parallelize(pairs, P).reduceByKey(_add, P)
                 .map(lambda kv: (kv[0], kv[1] * 10)).collect())
    assert got == [(k, 200) for k in range(5)]


def test_chained_shuffles(gctx):
    P = _P(gctx)
    pairs = [(i % 10, 1) for i in range(400)]
    got = dict(gctx.parallelize(pairs, P).reduceByKey(_add, P)
               .map(lambda kv: (kv[0] % 2, kv[1]))
               .reduceByKey(_add, P).collect())
    assert got == {0: 200, 1: 200}
    assert _array_only(gctx) and len(_stages(gctx)) == 3


def test_float_values(gctx, lctx):
    P = _P(gctx)
    pairs = [(i % 4, float(i) * 0.5) for i in range(100)]
    got = dict(gctx.parallelize(pairs, P).reduceByKey(_add, P).collect())
    expect = dict(lctx.parallelize(pairs, P).reduceByKey(_add, P)
                  .collect())
    assert got.keys() == expect.keys()
    for k in expect:          # scatter order is not a contract
        assert got[k] == pytest.approx(expect[k], rel=1e-12)


def test_tuple_values_combine(gctx, lctx):
    P = _P(gctx)
    # average via (sum, count) combiners: an unclassified traced merge
    pairs = [(i % 3, (i, 1)) for i in range(90)]

    def merge(a, b):
        return (a[0] + b[0], a[1] + b[1])
    got = dict(gctx.parallelize(pairs, P).reduceByKey(merge, P).collect())
    assert got == dict(lctx.parallelize(pairs, P).reduceByKey(merge, P)
                       .collect())
    assert _array_only(gctx)


def test_untraceable_falls_back(gctx):
    # string records cannot ride the tensor path; the result is right
    r = gctx.parallelize([("a", 1), ("b", 2), ("a", 3)], 2)
    got = dict(r.reduceByKey(_add).collect())
    assert got == {"a": 4, "b": 2}
    assert _stages(gctx)[0]["kind"] == "object"
    assert "no tensor form" in _stages(gctx)[0]["fallback_reason"]


def _branchy(x):
    return x if x > 3 else -x


def _numpy_call(x):
    import numpy as np
    return np.sqrt(x)


def _item_call(x):
    return x.item() * 2 if hasattr(x, "item") else x * 2


@pytest.mark.parametrize("f", [_branchy, _numpy_call, _item_call])
def test_untraceable_lambda_falls_back(gctx, lctx, f):
    """A lambda the vmap probe refuses (data-dependent control flow, a
    numpy call on a tensor, .item()) takes the host path with the probe's
    reason recorded, never a crash."""
    P = _P(gctx)
    got = gctx.parallelize(list(range(10)), P).map(f).collect()
    assert got == lctx.parallelize(list(range(10)), P).map(f).collect()
    assert "not traceable" in _stages(gctx)[0]["fallback_reason"]


def test_wave_threshold_falls_back(gctx, lctx):
    """A columnar input above the wave threshold feeding a shuffle write
    streams in waves on the device (a combining write with a partition
    a shard: a `pre_reduced` store), with no fallback, and its result
    equals `local`."""
    import numpy as np
    from dpark_tpu_torch import conf
    P = _P(gctx)
    keys = np.arange(400) % 7
    old = conf.STREAM_CHUNK_ROWS
    conf.STREAM_CHUNK_ROWS = 10
    try:
        got = dict(gctx.parallelize(Columns(keys, keys), P)
                   .reduceByKey(_add, P).collect())
    finally:
        conf.STREAM_CHUNK_ROWS = old
    assert got == dict(lctx.parallelize(RefColumns(keys, keys), P)
                       .reduceByKey(_add, P).collect())
    assert _array_only(gctx)
    st = _stages(gctx)[0]
    assert st["stream"] == "pre_reduced"
    assert st["pipeline"]["waves"] == -(-400 // P // 10)


def test_side_effect_lambda_falls_back(gctx):
    seen = []
    r = gctx.parallelize([(1, 1), (2, 2)], 2)
    got = dict(r.reduceByKey(lambda a, b: (seen.append(1), a + b)[1])
               .collect())
    assert got == {1: 1, 2: 2}


def test_hbm_to_host_bridge(gctx):
    """A device-written shuffle consumed by a host-only stage
    (mapPartitions) is read through the export bridge."""
    P = _P(gctx)
    pairs = [(i % 6, 1) for i in range(600)]
    r = (gctx.parallelize(pairs, P).reduceByKey(_add, P)
         .mapPartitions(lambda it: [sorted(it)]))
    parts = r.collect()
    flat = [kv for part in parts for kv in part]
    assert dict(flat) == {k: 100 for k in range(6)}
    assert _kinds(gctx) == ["array", "object"]


def test_count_and_take_on_device_pipeline(gctx):
    P = _P(gctx)
    r = gctx.parallelize([(i % 11, 1) for i in range(800)], P) \
        .reduceByKey(_add, P)
    assert r.count() == 11
    assert _kinds(gctx)[-1] == "array+counts"
    assert len(r.take(5)) == 5


def test_non_divisible_partitions(gctx, lctx):
    P = _P(gctx)
    # 5 partitions on 2 or 8 shards: same answer
    pairs = [(i % 3, 1) for i in range(50)]
    got = dict(gctx.parallelize(pairs, 5).reduceByKey(_add, 5).collect())
    assert got == dict(lctx.parallelize(pairs, 5).reduceByKey(_add, 5)
                       .collect()) == {0: 17, 1: 17, 2: 16}
    if P < 5:
        assert "more logical partitions" in \
            _stages(gctx)[0]["fallback_reason"]


def test_large_sum_no_overflow(gctx):
    """Values summing past 2**31 must not wrap (int64 path)."""
    P = _P(gctx)
    pairs = [(1, 2_000_000_000)] * 8
    got = dict(gctx.parallelize(pairs, P).reduceByKey(_add, P).collect())
    assert got == {1: 16_000_000_000}


def test_int32_max_key_not_dropped(gctx):
    """INT32_MAX is a legitimate key, not padding."""
    P = _P(gctx)
    pairs = [(2**31 - 1, 1)] * 8 + [(5, 2)] * 8
    got = dict(gctx.parallelize(pairs, P).reduceByKey(_add, P).collect())
    assert got == {2**31 - 1: 8, 5: 16}


def test_int64_sentinel_key_falls_back(gctx):
    """The one reserved key value (2**63-1) takes the host path."""
    P = _P(gctx)
    pairs = [(2**63 - 1, 1)] * 4 + [(3, 1)] * 4
    got = dict(gctx.parallelize(pairs, P).reduceByKey(_add, P).collect())
    assert got == {2**63 - 1: 4, 3: 4}
    assert _stages(gctx)[0]["fallback_reason"] == (
        "key equal to the device sentinel; taking the host path")


def test_actions_on_device(gctx, lctx):
    """count / top / reduce answered on the device (array+counts,
    array+top, array+reduced) equal the local master."""
    P = _P(gctx)
    import numpy as np
    rng = np.random.RandomState(7)
    keys = rng.randint(0, 50, 3000)
    vals = rng.randint(0, 1000, 3000)

    def build(c, n, cols=Columns):
        return c.parallelize(cols(keys, vals), n).reduceByKey(_add, n)
    g, l = build(gctx, P), build(lctx, P, RefColumns)
    assert g.count() == l.count() == 50
    assert _kinds(gctx) == ["array", "array+counts"]
    top = g.top(10, key=lambda kv: kv[1])
    assert top == l.top(10, key=lambda kv: kv[1])
    assert _kinds(gctx) == ["array+top"]
    assert g.map(lambda kv: kv[1]).reduce(_add) == int(vals.sum())
    assert _kinds(gctx) == ["array+reduced"]


def test_tuple_keys_match_local(gctx, lctx):
    P = _P(gctx)
    pairs = [((i % 7, i % 3), i) for i in range(700)]
    got = dict(gctx.parallelize(pairs, P).reduceByKey(_add, P).collect())
    assert got == dict(lctx.parallelize(pairs, P).reduceByKey(_add, P)
                       .collect())
    assert _array_only(gctx)


def test_min_max_monoids_match_local(gctx, lctx):
    P = _P(gctx)
    pairs = [((i * 31) % 17, (i * 7) % 101 - 50) for i in range(900)]
    for f in (min, max):
        got = dict(gctx.parallelize(pairs, P).reduceByKey(f, P).collect())
        assert got == dict(lctx.parallelize(pairs, P).reduceByKey(f, P)
                           .collect())


@pytest.mark.parametrize("case", ["reduce", "chain", "filter"])
def test_matches_tpu2(case, lctx):
    """The same jobs on the JAX package's tpu:2 master."""
    pairs = [((i * 7919) % 31, i % 17) for i in range(600)]

    def build(c):
        r = c.parallelize(pairs, 2)
        if case == "filter":
            r = r.filter(lambda kv: kv[1] % 3 != 0)
        r = r.reduceByKey(_add, 2)
        if case == "chain":
            r = r.map(lambda kv: (kv[0] % 4, kv[1])).reduceByKey(_add, 2)
        return dict(r.collect())
    tctx = RefContext("tpu:2")
    gctx = DparkContext("gpu:2", device="cpu")
    try:
        want = build(tctx)
        assert build(gctx) == want == build(lctx)
        assert _array_only(gctx)
    finally:
        tctx.stop()
        gctx.stop()
