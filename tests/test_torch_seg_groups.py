"""groupByKey().mapValues(f) on the port's gpu master (device="cpu": the
kernels' plain versions): a mirror of tests/test_seg_groups.py on gpu:2
and gpu:8.  Provable aggregates run as SegAggOp (K3 over the key-sorted
rows), traceable padding-invariant functions as SegMapOp (K7 segment
table, K2 class members, K8 padded gather and scatter, f under
torch.func.vmap); everything else takes the host path with the
reference's reason.  Every result equals the JAX package's `local` master
(integers exactly; float sums within 1e-12 relative, the reorder of a
float fold), and a few jobs also its tpu:2 master.  The combiner rewrite
is off in both packages, so the segment ops are what runs."""

import numpy as np
import pytest
import torch

from dpark_tpu import DparkContext as RefContext
from dpark_tpu import conf as ref_conf
from dpark_tpu_torch import DparkContext, conf
from dpark_tpu_torch.backend.cuda import fuse
from dpark_tpu_torch.utils.monoid import classify_segagg

MASTERS = ["gpu:2", "gpu:8"]
FLOAT_RTOL = 1e-12
ROWS = [(i % 53, (i * 7) % 11 - 3) for i in range(4000)]


@pytest.fixture(autouse=True)
def _no_rewrite():
    """The combiner rewrite would turn the provable aggregates into a
    combining shuffle: switch it off in both packages."""
    old = conf.GROUP_AGG_REWRITE, ref_conf.GROUP_AGG_REWRITE
    conf.GROUP_AGG_REWRITE = ref_conf.GROUP_AGG_REWRITE = False
    yield
    conf.GROUP_AGG_REWRITE, ref_conf.GROUP_AGG_REWRITE = old


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
    return {s["rdd"]: s["kind"] for s in _stages(ctx)}


def _reasons(ctx):
    return [s["fallback_reason"] for s in _stages(ctx)
            if "fallback_reason" in s]


def _array_only(ctx):
    return all(s["kind"].startswith("array") and "fallback_reason" not in s
               for s in _stages(ctx))


def _groups(rows):
    exp = {}
    for k, v in rows:
        exp.setdefault(k, []).append(v)
    return exp


def _same_as_local(build, gctx, lctx):
    got = build(gctx)
    assert got == build(lctx)
    return got


def _close(got, want):
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= FLOAT_RTOL * max(1.0, abs(want[k])), \
            (k, got[k], want[k])


def _minmax(vs):
    t = torch.as_tensor(vs)
    return t.max() - t.min()


def _sumsq(vs):
    return sum(v * v for v in vs)


# ----------------------------------------------------------------------
# provable aggregates: SegAggOp
# ----------------------------------------------------------------------
@pytest.mark.parametrize("f", [
    sum, len, min, max,
    lambda vs: sum(vs),
    lambda vs: len(vs),
    lambda vs: sum(vs) / len(vs),
], ids=["sum", "len", "min", "max", "lsum", "llen", "mean"])
def test_groupby_aggregate_rides_device(gctx, lctx, f):
    P = _P(gctx)

    def build(c):
        return dict(c.parallelize(ROWS, P).groupByKey(P).mapValues(f)
                    .collect())
    got = _same_as_local(build, gctx, lctx)
    assert got == {k: f(vs) for k, vs in _groups(ROWS).items()}
    assert _kinds(gctx)["MappedValuesRDD"] == "array"
    assert _array_only(gctx)


def test_groupby_mean_float32_values(gctx):
    """mean over np.float32 values: the port holds floats as float64, so
    the mean agrees with the host's float32 fold after rounding to
    float32 (these sums are exact in both widths)."""
    rows = [(i % 7, np.float32(i % 5) * np.float32(0.25))
            for i in range(560)]
    got = dict(gctx.parallelize(rows, _P(gctx)).groupByKey(_P(gctx))
               .mapValues(lambda vs: sum(vs) / len(vs)).collect())
    assert _kinds(gctx)["MappedValuesRDD"] == "array"
    exp = {}
    for k, vs in _groups(rows).items():
        acc = np.float32(0)
        for v in vs:
            acc = acc + v
        exp[k] = acc / len(vs)
    assert set(got) == set(exp)
    for k in got:
        assert np.float32(got[k]) == np.float32(exp[k]), (k, got[k], exp[k])


@pytest.mark.parametrize("kind", ["sum", "mean", "min", "max", "count"])
def test_segagg_float32_keeps_width(kind):
    """A float32 value leaf (a narrowing map before the shuffle) keeps
    its width through SegAggOp: K3 folds in float64 and narrows back;
    count is int64."""
    op = fuse.SegAggOp(kind)
    _, specs = op.probe((0, 1), [(np.dtype(np.int64), ()),
                                 (np.dtype(np.float32), ())])
    want = np.int64 if kind == "count" else np.float32
    assert specs[1][0] == np.dtype(want)
    keys = torch.tensor([[1, 1, 2, 5, 5, 5, 0, 0]])
    vals = torch.tensor([[0.5, 1.5, -2.0, 4.0, 0.25, 1.0, 9.0, 9.0]],
                        dtype=torch.float32)
    (k, v), n = op.apply([keys, vals], torch.tensor([6], dtype=torch.int32))
    assert v.dtype == torch.from_numpy(np.zeros(0, want)).dtype
    assert int(n[0]) == 3 and k[0, :3].tolist() == [1, 2, 5]
    exp = {"sum": [2.0, -2.0, 5.25], "mean": [1.0, -2.0, 1.75],
           "min": [0.5, -2.0, 0.25], "max": [1.5, -2.0, 4.0],
           "count": [2, 1, 3]}[kind]
    assert v[0, :3].tolist() == exp


def test_groupby_minmax_nan_masked(gctx):
    """The reference's NaN caveat: NaN values are absent for device
    min/max — the host's answer whenever NaN is not a group's first
    arrival."""
    rows = [(i % 4, float(i)) for i in range(40)]
    rows += [(k, float("nan")) for k in range(4)]
    got = dict(gctx.parallelize(rows, _P(gctx)).groupByKey(_P(gctx))
               .mapValues(min).collect())
    assert _kinds(gctx)["MappedValuesRDD"] == "array"
    assert got == {k: float(k) for k in range(4)}


def test_groupby_aggregate_float_values(gctx, lctx):
    """max over floats is exact; sum over floats holds to the list fold
    within FLOAT_RTOL (K3 may fold in another order)."""
    rows = [(k, v * 0.5 + 0.1) for k, v in ROWS]
    P = _P(gctx)

    def build(c, f):
        return dict(c.parallelize(rows, P).groupByKey(P).mapValues(f)
                    .collect())
    assert build(gctx, max) == build(lctx, max)
    assert _kinds(gctx)["MappedValuesRDD"] == "array"
    _close(build(gctx, sum), build(lctx, sum))
    assert _kinds(gctx)["MappedValuesRDD"] == "array"


def test_groupby_aggregate_chain_continues_on_device(gctx, lctx):
    """Ops after the aggregate (filter) and a downstream shuffle write
    stay on the tensor path."""
    P = _P(gctx)

    def build(c):
        return dict(c.parallelize(ROWS, P).groupByKey(P).mapValues(sum)
                    .filter(lambda kv: kv[0] % 2 == 0)
                    .reduceByKey(lambda a, b: a + b, P).collect())
    got = _same_as_local(build, gctx, lctx)
    assert got == {k: sum(vs) for k, vs in _groups(ROWS).items()
                   if k % 2 == 0}
    assert _array_only(gctx) and len(_stages(gctx)) == 3


def test_groupby_aggregate_sort_downstream(gctx, lctx):
    """groupByKey -> aggregate -> sortByKey: the aggregate feeds a range
    shuffle on the device."""
    P = _P(gctx)

    def build(c):
        return c.parallelize(ROWS, P).groupByKey(P).mapValues(sum) \
            .sortByKey(numSplits=P).collect()
    got = _same_as_local(build, gctx, lctx)
    assert got == sorted((k, sum(vs)) for k, vs in _groups(ROWS).items())
    assert _array_only(gctx)


def test_groupby_aggregate_count_only(gctx):
    """count() over the aggregate answers from the device counts."""
    n = gctx.parallelize(ROWS, _P(gctx)).groupByKey(_P(gctx)) \
        .mapValues(sum).count()
    assert n == len(_groups(ROWS))
    assert _kinds(gctx)["MappedValuesRDD"] == "array+counts"


def test_groupby_aggregate_hint(gctx):
    """A function equal to a monoid but written differently opts in via
    __dpark_segagg__."""
    def total(vs):
        acc = 0
        for v in vs:
            acc += v
        return acc
    total.__dpark_segagg__ = "sum"
    got = dict(gctx.parallelize(ROWS, _P(gctx)).groupByKey(_P(gctx))
               .mapValues(total).collect())
    assert got == {k: sum(vs) for k, vs in _groups(ROWS).items()}
    assert _kinds(gctx)["MappedValuesRDD"] == "array"


def test_groupby_unprovable_aggregate_falls_back(gctx, lctx):
    """sorted(vs)[0] compares tensors (data-dependent control flow under
    vmap): the host path, with the reference's reason, and the same
    result."""
    P = _P(gctx)

    def build(c):
        return dict(c.parallelize(ROWS, P).groupByKey(P)
                    .mapValues(lambda vs: sorted(vs)[0]).collect())
    got = _same_as_local(build, gctx, lctx)
    assert got == {k: min(vs) for k, vs in _groups(ROWS).items()}
    assert _kinds(gctx)["MappedValuesRDD"] == "object"
    (reason,) = _reasons(gctx)
    assert reason.startswith("per-group function is not traceable (")


def test_groupby_shadowed_builtin_not_classified():
    """A local `sum` shadowing the builtin must NOT classify."""
    ns = {"sum": lambda vs: 42}
    f = eval("lambda vs: sum(vs)", ns)
    assert classify_segagg(f) is None
    assert classify_segagg(sum) == "sum"
    assert classify_segagg(len) == "count"
    assert classify_segagg(lambda vs: sum(vs) / len(vs)) == "mean"
    assert classify_segagg(lambda vs: sorted(vs)) is None


def test_groupby_tuple_values_fall_back(gctx, lctx):
    """len over tuple values: segment ops need scalar values, so the host
    path, with the same result."""
    rows = [(i % 11, (i, i + 1)) for i in range(300)]
    P = _P(gctx)

    def build(c):
        return dict(c.parallelize(rows, P).groupByKey(P).mapValues(len)
                    .collect())
    got = _same_as_local(build, gctx, lctx)
    assert got == {k: len(vs) for k, vs in _groups(rows).items()}
    assert _kinds(gctx)["MappedValuesRDD"] == "object"


def test_groupby_aggregate_then_mapvalue(gctx, lctx):
    P = _P(gctx)

    def build(c):
        return sorted(c.parallelize(ROWS, P).groupByKey(P)
                      .mapValues(lambda vs: sum(vs))
                      .mapValue(lambda s: s * 3).collect())
    _same_as_local(build, gctx, lctx)
    assert _array_only(gctx)


def test_groupby_single_key_and_single_rows(gctx):
    """Boundary shapes: one key in total; one row per key."""
    P = _P(gctx)
    one_key = [(7, i) for i in range(100)]
    got = dict(gctx.parallelize(one_key, P).groupByKey(P)
               .mapValues(sum).collect())
    assert got == {7: sum(range(100))}
    distinct = [(i, i * 2) for i in range(64)]
    got = dict(gctx.parallelize(distinct, P).groupByKey(P)
               .mapValues(_sumsq).collect())
    assert got == {i: 4 * i * i for i in range(64)}
    assert _array_only(gctx)


# ----------------------------------------------------------------------
# traceable per-group functions: SegMapOp
# ----------------------------------------------------------------------
def test_seg_map_traceable_fn_rides_device(gctx, lctx):
    P = _P(gctx)

    def build(c):
        return dict(c.parallelize(ROWS, P).groupByKey(P)
                    .mapValues(_sumsq).collect())
    got = _same_as_local(build, gctx, lctx)
    assert got == {k: _sumsq(vs) for k, vs in _groups(ROWS).items()}
    assert _kinds(gctx)["MappedValuesRDD"] == "array"
    assert _array_only(gctx)


def test_seg_map_edge_pad_order_statistic(gctx):
    """Repeat-last padding admits order statistics the zero fill would
    corrupt (max - min over all-negative groups)."""
    rows = [(k, -v - 10) for k, v in ROWS]
    pad, _, _ = fuse.classify_seg_map(_minmax, np.dtype(np.int64))
    assert pad == "edge"
    got = {k: int(v) for k, v in
           gctx.parallelize(rows, _P(gctx)).groupByKey(_P(gctx))
           .mapValues(_minmax).collect()}
    assert got == {k: max(vs) - min(vs) for k, vs in _groups(rows).items()}
    assert _array_only(gctx)


def test_seg_map_chain_and_shuffle_write(gctx, lctx):
    P = _P(gctx)

    def build(c):
        return dict(c.parallelize(ROWS, P).groupByKey(P).mapValues(_sumsq)
                    .filter(lambda kv: kv[0] % 2 == 0)
                    .reduceByKey(lambda a, b: a + b, P).collect())
    got = _same_as_local(build, gctx, lctx)
    assert got == {k: _sumsq(vs) for k, vs in _groups(ROWS).items()
                   if k % 2 == 0}
    assert _array_only(gctx) and len(_stages(gctx)) == 3


def test_seg_map_power_law_group_sizes(gctx, lctx):
    """One hub group and a long tail: several size classes, exact."""
    rows = [(i % 97 + 1, (i * 5) % 23 - 11) for i in range(2000)]
    rows += [(0, i % 9) for i in range(1500)]

    def f(vs):
        return 3 * sum(vs) + sum(v * v for v in vs)
    P = _P(gctx)

    def build(c):
        return dict(c.parallelize(rows, P).groupByKey(P).mapValues(f)
                    .collect())
    got = _same_as_local(build, gctx, lctx)
    assert got == {k: f(vs) for k, vs in _groups(rows).items()}
    assert _array_only(gctx)


def test_seg_map_power_of_two_sizes(gctx):
    """Group g has 2^(g mod 8) rows: every size class from 1 to 128, each
    size exactly a power of two (the class boundary)."""
    rows = []
    for g in range(64):
        rows += [((g * 40503) % 1009, (g * 13 + j) % 17 - 8)
                 for j in range(1 << (g % 8))]
    rng = np.random.RandomState(3)
    rows = [rows[i] for i in rng.permutation(len(rows))]
    got = dict(gctx.parallelize(rows, _P(gctx)).groupByKey(_P(gctx))
               .mapValues(_sumsq).collect())
    assert got == {k: _sumsq(vs) for k, vs in _groups(rows).items()}
    assert _array_only(gctx)


def test_seg_map_pytree_output_rides_device(gctx, lctx):
    """A tuple result whose leaves are all zero-pad-neutral rides the
    device; egest rebuilds (k, (a, b))."""
    P = _P(gctx)

    def f(vs):
        return (sum(vs), sum(v * v for v in vs))

    def build(c):
        return dict(c.parallelize(ROWS, P).groupByKey(P).mapValues(f)
                    .collect())
    got = _same_as_local(build, gctx, lctx)
    assert got == {k: f(vs) for k, vs in _groups(ROWS).items()}
    assert _array_only(gctx)


def test_seg_map_pytree_output_declines_mixed_neutral(gctx, lctx):
    """(max, sumsq) needs repeat-pad for one leaf and zero-pad for the
    other: no single fill is neutral, so the host path, with the
    reason."""
    P = _P(gctx)

    def f(vs):
        return (torch.as_tensor(vs).max(), sum(v * v for v in vs))

    def build(c):
        return {k: (int(a), int(b)) for k, (a, b) in
                c.parallelize(ROWS, P).groupByKey(P).mapValues(f).collect()}
    got = _same_as_local(build, gctx, lctx)
    assert got == {k: (max(vs), _sumsq(vs)) for k, vs in
                   _groups(ROWS).items()}
    assert _kinds(gctx)["MappedValuesRDD"] == "object"
    (reason,) = _reasons(gctx)
    assert reason.startswith("per-group function is not padding-invariant")


def test_seg_map_length_dependent_declines(gctx):
    """A function of the true group length is not padding-invariant."""
    rows = [(k, float(v)) for k, v in ROWS]
    f = lambda vs: sum(vs) / torch.as_tensor(vs).shape[0]  # noqa: E731
    got = dict(gctx.parallelize(rows, _P(gctx)).groupByKey(_P(gctx))
               .mapValues(f).collect())
    exp = {k: sum(vs) / len(vs) for k, vs in _groups(rows).items()}
    _close({k: float(v) for k, v in got.items()}, exp)
    assert _kinds(gctx)["MappedValuesRDD"] == "object"
    assert "padding-invariant" in _reasons(gctx)[0]


def test_seg_map_builtin_max_declines(gctx):
    """Builtin max() over the vmapped row is data-dependent control
    flow: declined as not traceable (the torch form above is admitted)."""
    f = lambda vs: max(vs) + 1                  # noqa: E731
    got = dict(gctx.parallelize(ROWS, _P(gctx)).groupByKey(_P(gctx))
               .mapValues(f).collect())
    assert got == {k: max(vs) + 1 for k, vs in _groups(ROWS).items()}
    assert _reasons(gctx)[0].startswith(
        "per-group function is not traceable (")


def test_seg_map_small_stage_rides_device(gctx, lctx):
    """The port runs eagerly, with no per-bucket compile to budget: a
    stage of a few rows (most shards empty) still takes the device."""
    rows = [(5, 2), (9, -3), (5, 4)]
    P = _P(gctx)

    def build(c):
        return dict(c.parallelize(rows, P).groupByKey(P)
                    .mapValues(_sumsq).collect())
    assert _same_as_local(build, gctx, lctx) == {5: 20, 9: 9}
    assert _array_only(gctx)


def test_seg_map_disabled_by_conf(gctx):
    old = conf.SEG_MAP
    conf.SEG_MAP = False
    try:
        got = dict(gctx.parallelize(ROWS, _P(gctx)).groupByKey(_P(gctx))
                   .mapValues(_sumsq).collect())
    finally:
        conf.SEG_MAP = old
    assert got == {k: _sumsq(vs) for k, vs in _groups(ROWS).items()}
    assert _reasons(gctx) == [
        "grouped consumer stays on host: DPARK_SEG_MAP=0"]


def test_seg_map_tuple_keys(gctx, lctx):
    """Composite keys: segments split on every key column."""
    rows = [((k % 7, k % 3), v) for k, v in ROWS]
    P = _P(gctx)

    def build(c):
        return dict(c.parallelize(rows, P).groupByKey(P)
                    .mapValues(_sumsq).collect())
    got = _same_as_local(build, gctx, lctx)
    assert got == {k: _sumsq(vs) for k, vs in _groups(rows).items()}
    assert _array_only(gctx)


def test_seg_map_float_values_ride_device(gctx, lctx):
    f = lambda vs: sum(3 * v * v + 2 * v for v in vs)   # noqa: E731
    rows = [(k, v * 0.25) for k, v in ROWS]
    P = _P(gctx)

    def build(c):
        return dict(c.parallelize(rows, P).groupByKey(P).mapValues(f)
                    .collect())
    got = {k: float(v) for k, v in build(gctx).items()}
    _close(got, build(lctx))
    assert _array_only(gctx)


def test_seg_map_count_only(gctx):
    n = gctx.parallelize(ROWS, _P(gctx)).groupByKey(_P(gctx)) \
        .mapValues(_sumsq).count()
    assert n == len(_groups(ROWS))
    assert _kinds(gctx)["MappedValuesRDD"] == "array+counts"


def test_seg_bucket_layout_covers_skew():
    """G of a class is the most groups any shard holds in it, rounded up
    to a power-of-two capacity; width is 2^class."""
    from dpark_tpu_torch.backend.cuda.executor import TorchExecutor
    hist = torch.zeros((3, 32), dtype=torch.int32)
    hist[0, 0], hist[1, 0], hist[2, 3], hist[1, 5] = 5, 9, 1, 300
    lay = TorchExecutor._seg_bucket_layout(hist)
    assert lay == ((0, 1, 16), (3, 8, 8), (5, 32, 512))
    assert TorchExecutor._seg_bucket_layout(
        torch.zeros((2, 32), dtype=torch.int32)) == ((0, 1, 8),)


@pytest.mark.parametrize("case", ["segagg", "segmap", "chain"])
def test_matches_tpu2(case, lctx):
    """The same integer jobs on the JAX package's tpu:2 master: equal
    results, every stage on both tensor paths."""
    def build(c):
        r = c.parallelize(ROWS, 2).groupByKey(2)
        if case == "segagg":
            return sorted(r.mapValues(sum).collect())
        if case == "segmap":
            return sorted(r.mapValues(_sumsq_ref).collect())
        return sorted(r.mapValues(_sumsq_ref)
                      .reduceByKey(lambda a, b: a + b, 2).collect())
    tctx = RefContext("tpu:2")
    gctx = DparkContext("gpu:2", device="cpu")
    try:
        want = [(k, int(v)) for k, v in build(tctx)]
        assert [(k, int(v)) for k, v in build(gctx)] == want
        assert want == build(lctx)
        assert _array_only(gctx)
        assert all(s["kind"].startswith("array") for s in
                   tctx.scheduler.history[-1]["stage_info"])
    finally:
        tctx.stop()
        gctx.stop()


def _sumsq_ref(vs):
    """Sum of squares both packages can trace (jax and torch.func)."""
    return sum(v * v for v in vs)
