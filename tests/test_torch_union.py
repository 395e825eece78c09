"""The port's device union source (B16) on the CPU (gpu masters with
device="cpu": K16's plain version).

K16's plain version against the JAX package's _concat_batches /
_compile_concat (backend/tpu/executor.py:2119-2170) on its CPU mesh over
ragged counts, empty shards and 1, 2 and 12 branches: the valid rows
bit-equal, and past each shard's total the port's fill (the key sentinel
in leaf 0, zeros elsewhere; the reference leaves stale rows there).

Then mirrors of tests/test_tpu_backend.py's test_union_of_shuffles_
rides_device, test_union_mixed_ingest_and_shuffle_branches,
test_union_result_stage_stays_host and test_union_shuffle_feeds_object_
consumer on the port's local, gpu:4 and gpu:8 masters, against the JAX
package's local and tpu:4 (results and stage kinds), the reference's
declines (a result stage, more than 12 branches, branches of another
record type), and the cached shuffle branch read from the device store
(the port has no device result cache, ROADMAP A19)."""

import operator

import numpy as np
import pytest
import torch

import jax

from dpark_tpu import DparkContext as RefContext
from dpark_tpu.backend.tpu import layout as ref_layout
from dpark_tpu.rdd import Columns as RefColumns
from dpark_tpu_torch import Columns, DparkContext
from dpark_tpu_torch.backend.cuda import fuse, kernels
from dpark_tpu_torch.backend.cuda.layout import round_capacity

jax.config.update("jax_enable_x64", True)     # int64 keys stay int64

N = 4


@pytest.fixture(scope="module")
def tctx():
    c = RefContext("tpu:%d" % N)
    c.start()
    yield c
    c.stop()


@pytest.fixture(scope="module")
def lctx():
    c = RefContext("local")
    yield c
    c.stop()


@pytest.fixture(params=["local", "gpu:4", "gpu:8"])
def pctx(request):
    m = request.param
    c = DparkContext(m) if m == "local" else DparkContext(m, device="cpu")
    c.start()
    yield c
    c.stop()


def _kinds(ctx):
    return {s["rdd"]: s.get("kind")
            for s in ctx.scheduler.history[-1]["stage_info"]}


def _stages(ctx):
    return ctx.scheduler.history[-1]["stage_info"]


def _branches(k, caps, seed, empty_shard=None, empty_branch=None):
    """k branches of (int64 key, int64 value, float64) leaves over N
    shards with ragged counts (numpy)."""
    rng = np.random.RandomState(seed)
    out = []
    for j in range(k):
        cap = caps[j % len(caps)]
        n = rng.randint(0, cap + 1, N).astype(np.int32)
        if empty_shard is not None:
            n[empty_shard] = 0
        if j == empty_branch:
            n[:] = 0
        leaves = [rng.randint(-1000, 1000, (N, cap)).astype(np.int64),
                  rng.randint(0, 1 << 20, (N, cap)).astype(np.int64),
                  rng.standard_normal((N, cap))]
        out.append((leaves, n))
    return out


def _reference_concat(tctx, branches):
    ex = tctx.scheduler.executor
    sh = ex._sharding()
    batches = [ref_layout.Batch(
        None, [ref_layout.put_sharded(c, sh) for c in lv],
        ref_layout.put_sharded(n, sh)) for lv, n in branches]
    out = ex._concat_batches(batches)
    return ([np.asarray(jax.device_get(c)) for c in out.cols],
            np.asarray(jax.device_get(out.counts)))


@pytest.mark.parametrize("k,caps,empty_shard,empty_branch", [
    (1, [16], None, None),
    (2, [16, 8], 1, None),
    (2, [8], None, 0),
    (12, [8, 32, 16], 2, 5),
])
def test_union_concat_plain_matches_reference(tctx, k, caps, empty_shard,
                                              empty_branch):
    branches = _branches(k, caps, 7 + k, empty_shard, empty_branch)
    ref_cols, ref_n = _reference_concat(tctx, branches)
    leaves, totals = kernels.union_concat(
        [([torch.from_numpy(c) for c in lv], torch.from_numpy(n))
         for lv, n in branches])
    assert totals.dtype == torch.int32
    assert np.array_equal(totals.numpy(), ref_n)
    assert leaves[0].shape[1] == round_capacity(int(ref_n.max()) or 1)
    for li, (got, want) in enumerate(zip(leaves, ref_cols)):
        for s in range(N):
            t = int(ref_n[s])
            # the valid rows bit for bit (floats compared as bits)
            assert np.array_equal(got[s, :t].numpy().view(np.int64),
                                  want[s, :t].view(np.int64)), (li, s)
            fill = kernels.KEY_SENTINEL if li == 0 else 0
            assert (got[s, t:] == fill).all(), (li, s)
    # the same rows, branch after branch, from numpy
    for s in range(N):
        want = np.concatenate([lv[1][s, :n[s]] for lv, n in branches])
        assert np.array_equal(leaves[1][s, :len(want)].numpy(), want)


def test_union_concat_fills_and_checks():
    """Without a key leaf every tail is zero; a float key leaf's tail is
    +inf; branches of other leaves are refused."""
    lv = [torch.arange(8, dtype=torch.float64).view(1, 8),
          torch.ones((1, 8, 2), dtype=torch.int32)]
    n = torch.tensor([3], dtype=torch.int32)
    out, tot = kernels.union_concat([(lv, n), (lv, n)], key_leaf=None)
    assert tot.tolist() == [6] and (out[0][0, 6:] == 0).all()
    assert out[1].shape == (1, 8, 2) and (out[1][0, 6:] == 0).all()
    assert out[0][0, :6].tolist() == [0, 1, 2, 0, 1, 2]
    out, _ = kernels.union_concat([(lv, n), (lv, n)],
                                  key_fill=float("inf"))
    assert torch.isinf(out[0][0, 6:]).all()
    with pytest.raises(ValueError):
        kernels.union_concat([(lv, n), (lv[:1], n)])
    with pytest.raises(ValueError):
        kernels.union_concat([(lv, n)] * 13)


def _rows_sum(rows):
    exp = {}
    for k, v in rows:
        exp[k] = exp.get(k, 0) + v
    return exp


def test_union_of_shuffles_rides_device(pctx, tctx):
    rows = [(i % 50, i % 7) for i in range(5000)]

    def job(c, P):
        b1 = c.parallelize(rows, P).reduceByKey(operator.add, P)
        b2 = c.parallelize(rows, P).reduceByKey(operator.add, P)
        return dict(b1.union(b2).reduceByKey(operator.add, P).collect())
    P = 8 if pctx.master == "local" else pctx.default_parallelism
    got = job(pctx, P)
    assert got == {k: 2 * v for k, v in _rows_sum(rows).items()}
    assert job(tctx, N) == got
    if pctx.master != "local":
        assert _kinds(pctx).get("UnionRDD") == "array"
        assert all(s["kind"].startswith("array") for s in _stages(pctx))
        if pctx.master == "gpu:4":
            assert _kinds(pctx) == _kinds(tctx)


def test_union_mixed_ingest_and_shuffle_branches(pctx, tctx):
    rows = [(i % 50, 1) for i in range(4000)]

    def job(c, P):
        reduced = c.parallelize(rows, P).reduceByKey(operator.add, P) \
            .mapValue(lambda v: v * 10)
        raw = c.parallelize(rows, P)
        return dict(raw.union(reduced).reduceByKey(operator.add, P)
                    .collect())
    P = 8 if pctx.master == "local" else pctx.default_parallelism
    got = job(pctx, P)
    assert got == {k: 11 * v for k, v in _rows_sum(rows).items()}
    assert job(tctx, N) == got
    if pctx.master != "local":
        assert _kinds(pctx).get("UnionRDD") == "array"
        if pctx.master == "gpu:4":
            assert _kinds(pctx) == _kinds(tctx)


def test_union_result_stage_stays_host(pctx, tctx):
    rows = [(i % 20, 1) for i in range(800)]

    def job(c, P):
        b1 = c.parallelize(rows, P).reduceByKey(operator.add, P)
        b2 = c.parallelize(rows, P).reduceByKey(operator.add, P)
        return sorted(b1.union(b2).collect())
    P = 8 if pctx.master == "local" else pctx.default_parallelism
    got = job(pctx, P)
    assert got == sorted(list(_rows_sum(rows).items()) * 2)
    assert job(tctx, N) == got
    assert _kinds(tctx).get("UnionRDD") != "array"
    if pctx.master != "local":
        st = [s for s in _stages(pctx) if s["rdd"] == "UnionRDD"][0]
        assert st["kind"] == "object"
        assert st["fallback_reason"] == fuse.UNION_RESULT_REASON


def test_union_shuffle_feeds_object_consumer(pctx, tctx):
    """A host stage reading a union-written shuffle fetches it through the
    single_map export (a shard is no map partition of the union)."""
    rows = [(i % 30, 1) for i in range(3000)]

    def job(c, P):
        b1 = c.parallelize(rows, P).reduceByKey(operator.add, P)
        b2 = c.parallelize(rows, P).reduceByKey(operator.add, P)
        u = b1.union(b2).reduceByKey(operator.add, P)
        return dict(u.map(lambda kv: (kv[0], str(kv[1]))).collect())
    P = 8 if pctx.master == "local" else pctx.default_parallelism
    got = job(pctx, P)
    assert got == {k: str(v * 2) for k, v in _rows_sum(rows).items()}
    assert job(tctx, N) == got
    if pctx.master != "local":
        kinds = [(s["rdd"], s["kind"]) for s in _stages(pctx)]
        assert ("UnionRDD", "array") in kinds
        ex = pctx.scheduler.executor
        assert any(st.get("single_map") for st in ex.shuffle_store.values())


def test_union_columns_reduce_count_kinds(tctx, lctx):
    """a.union(b).reduceByKey(add).count() over Columns: array,
    array+counts on gpu:4 as on tpu:4, the count equal to local's; with
    8 partitions on gpu:8 too."""
    rng = np.random.RandomState(3)
    k1, v1 = rng.randint(0, 50, 1000), rng.randint(0, 9, 1000)
    k2, v2 = rng.randint(0, 70, 600), rng.randint(0, 9, 600)

    def job(c, cols, P=None):
        a = c.parallelize(cols(k1, v1), 4)
        b = c.parallelize(cols(k2, v2), 3)
        return a.union(b).reduceByKey(operator.add, P).count()
    want = job(lctx, RefColumns)
    assert job(tctx, RefColumns) == want
    for master, P in (("gpu:4", None), ("gpu:8", 8)):
        c = DparkContext(master, device="cpu")
        assert job(c, Columns, P) == want
        assert [s["kind"] for s in _stages(c)] == ["array", "array+counts"]
        if master == "gpu:4":
            assert [s["kind"] for s in _stages(c)] == [
                s["kind"] for s in _stages(tctx)]
        c.stop()


def test_union_declines_like_the_reference():
    """More than 12 branches, and branches of another record type, keep
    the host path with the reason; the results stay right."""
    c = DparkContext("gpu:2", device="cpu")
    r = c.parallelize([(1, 2), (3, 4)], 2)
    u = c.union([r] * 13).reduceByKey(operator.add, 2)
    assert dict(u.collect()) == {1: 26, 3: 52}
    st = [s for s in _stages(c) if s["rdd"] == "UnionRDD"][0]
    assert st["fallback_reason"] == fuse.UNION_WIDE_REASON % (
        13, kernels.MAX_UNION_BRANCHES)
    f = c.parallelize([(1, 2.5)], 2)
    u = r.union(f).reduceByKey(operator.add, 2)
    assert dict(u.collect()) == {1: 4.5, 3: 4}
    st = [s for s in _stages(c) if s["rdd"] == "UnionRDD"][0]
    assert st["fallback_reason"] == fuse.UNION_SPECS_REASON
    u = r.union(c.parallelize([(1, "x")], 2)).groupByKey(2)
    assert sorted((k, sorted(map(str, v))) for k, v in u.collect()) == [
        (1, ["2", "x"]), (3, ["4"])]
    st = [s for s in _stages(c) if s["rdd"] == "UnionRDD"][0]
    assert st["fallback_reason"].startswith(fuse.UNION_BRANCH_REASON % (
        1, ""))
    c.stop()


def test_cached_shuffle_branch_reads_the_device_store():
    """A cached ShuffledRDD over a device store is an "hbm" union branch
    (the port has no device result cache: the store holds its data), as
    the stream's cached panes are; a cached input keeps the host path."""
    c = DparkContext("gpu:2", device="cpu")
    rows = [(i % 10, 1) for i in range(200)]
    pane = c.parallelize(rows, 2).reduceByKey(operator.add, 2).cache()
    assert dict(pane.collect()) == {k: 20 for k in range(10)}
    assert all(s["kind"].startswith("array") for s in _stages(c))
    ex = c.scheduler.executor
    assert fuse._device_cached(pane, ex.shuffle_store)
    u = pane.union(pane.mapValue(lambda v: -v)).reduceByKey(operator.add,
                                                            2)
    assert dict(u.collect()) == {k: 0 for k in range(10)}
    assert [(s["rdd"], s["kind"]) for s in _stages(c)] == [
        ("UnionRDD", "array"), ("ShuffledRDD", "array")]
    # held by the host cache: the host path reads its partitions
    c.cache.put((pane.id, 0), [(0, 20)])
    c.cache.put((pane.id, 1), [(1, 20)])
    assert not fuse._device_cached(pane, ex.shuffle_store)
    cached_in = c.parallelize(rows, 2).cache()
    u = cached_in.union(cached_in).reduceByKey(operator.add, 2)
    assert dict(u.collect()) == {k: 40 for k in range(10)}
    st = [s for s in _stages(c) if s["rdd"] == "UnionRDD"][0]
    assert st["fallback_reason"] == fuse.UNION_BRANCH_REASON % (
        0, fuse.CACHE_REASON % "ParallelCollection")
    c.stop()
