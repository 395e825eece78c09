"""The port's spilled-run stream for untraceable combiners on the CPU
(device="cpu"), mirroring the four columnar tests of
tests/test_object_combiner_ooc.py.  math.gcd is associative and
commutative but neither traces under torch.func.vmap nor classifies as
a monoid: a big columnar input streams its created combiners through
the device exchange into key-sorted runs on the host (K13 folds the
logical partition onto a shard when there are more partitions than
shards), and the export folds each run of equal keys with the user's
merge.  Waves are pinned to 512 rows a shard.  Every answer equals the
JAX package's `local` master and its `tpu:2`."""

import math

import numpy as np
import pytest

import dpark_tpu.conf as ref_conf
from dpark_tpu import DparkContext as RefContext
from dpark_tpu.rdd import Columns as RefColumns
from dpark_tpu_torch import Columns, DparkContext, conf

CHUNK = 512


@pytest.fixture()
def small_chunks():
    old = (conf.STREAM_CHUNK_ROWS, ref_conf.STREAM_CHUNK_ROWS)
    conf.STREAM_CHUNK_ROWS = CHUNK
    ref_conf.STREAM_CHUNK_ROWS = CHUNK
    yield
    conf.STREAM_CHUNK_ROWS, ref_conf.STREAM_CHUNK_ROWS = old


@pytest.fixture(params=["gpu:2", "gpu:8"])
def gctx(request, small_chunks):
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


def _expect_gcd(keys, vals):
    out = {}
    for k, v in zip(keys.tolist(), vals.tolist()):
        out[k] = math.gcd(out[k], v) if k in out else v
    return out


def _refs(job, lctx, tctx):
    """job(ctx, Columns, P) on the reference's local and tpu:2 masters;
    both must agree."""
    local = job(lctx, RefColumns, 8)
    assert job(tctx, RefColumns, 2) == local
    return local


def _stores(ctx):
    return list(ctx.scheduler.executor.shuffle_store.values())


def _streamed_host_combine(ctx):
    """A map stage streamed into spilled runs of created combiners, and
    no stage of any job fell back (a reduce stage reads the runs on the
    host by design)."""
    sts = [s for rec in ctx.scheduler.history for s in rec["stage_info"]]
    assert not any("fallback_reason" in s or "degrade_reason" in s
                   for s in sts), sts
    assert any(s["kind"] == "array+spill" and s["stream"] == "host_runs"
               for s in sts), sts
    assert any(s.get("host_combine") for s in _stores(ctx))


def _gcd_job(n, kfn, vfn, parts):
    def job(ctx, C, P):
        i = np.arange(n, dtype=np.int64)
        return dict(ctx.parallelize(C(kfn(i), vfn(i)), P)
                    .reduceByKey(math.gcd, parts).collect())
    return job


def test_untraceable_merge_streams_columnar(gctx, lctx, tctx):
    """r = 24 > N: created combiners ride the exchange with their rid
    (K13) and the export folds them with gcd."""
    job = _gcd_job(16000, lambda i: (i * 7) % 97, lambda i: (i % 5 + 1) * 6,
                   24)
    want = _refs(job, lctx, tctx)
    i = np.arange(16000, dtype=np.int64)
    assert want == _expect_gcd((i * 7) % 97, (i % 5 + 1) * 6)
    assert job(gctx, Columns, gctx.default_parallelism) == want
    _streamed_host_combine(gctx)


def test_untraceable_merge_streams_r_le_mesh(gctx, lctx, tctx):
    """r = 4: on gpu:8 the shard is the partition (no rid rides); on
    gpu:2 four partitions exceed the shards and the rid rides."""
    job = _gcd_job(12000, lambda i: i % 53, lambda i: (i % 7 + 1) * 10, 4)
    want = _refs(job, lctx, tctx)
    i = np.arange(12000, dtype=np.int64)
    assert want == _expect_gcd(i % 53, (i % 7 + 1) * 10)
    assert job(gctx, Columns, gctx.default_parallelism) == want
    _streamed_host_combine(gctx)


def test_untraceable_merge_small_stays_in_core(gctx, lctx, tctx):
    """Small inputs keep the in-core path: no spilled runs."""
    def job(ctx, C, P):
        i = np.arange(400, dtype=np.int64)
        return dict(ctx.parallelize(C(i % 11, i % 3 + 1), P)
                    .reduceByKey(math.gcd, 4).collect())
    want = _refs(job, lctx, tctx)
    i = np.arange(400, dtype=np.int64)
    assert want == _expect_gcd(i % 11, i % 3 + 1)
    assert job(gctx, Columns, gctx.default_parallelism) == want
    assert not any("host_runs" in s or s.get("host_combine")
                   for s in _stores(gctx))


def test_untraceable_merge_downstream_group(gctx, lctx, tctx):
    """The export feeds downstream host stages: a count over the reduced
    RDD and a filter of it."""
    def job(ctx, C, P):
        i = np.arange(8000, dtype=np.int64)
        r = ctx.parallelize(C(i % 37, (i % 4 + 1) * 9), P).reduceByKey(
            math.gcd, 16)
        return r.count(), dict(r.filter(lambda kv: kv[0] < 5).collect())
    want = _refs(job, lctx, tctx)
    i = np.arange(8000, dtype=np.int64)
    expect = _expect_gcd(i % 37, (i % 4 + 1) * 9)
    assert want == (37, {k: v for k, v in expect.items() if k < 5})
    assert job(gctx, Columns, gctx.default_parallelism) == want
    _streamed_host_combine(gctx)
