"""A combining write over bool values (ROADMAP C27) on the port's gpu:4
(device="cpu": the kernels' plain versions) against the JAX package's
`local` master and its tpu:4.

Python adds two bools as integers (True + True == 2); a tensor's bool add
is a logical or.  The reference's array path refuses a bool add and runs
the object path; the port declines the write at admission
(fuse.BOOL_MERGE_REASON) and runs it on the host, so its counts are
`local`'s: in core, over Columns, and under tiny waves (512 rows a
shard, more partitions than shards), where the spilled runs used to add
their bools on the host.  A merge that keeps a bool a bool (max) stays on
the device."""

import operator

import numpy as np
import pytest

import dpark_tpu.conf as ref_conf
from dpark_tpu import DparkContext as RefContext
from dpark_tpu.rdd import Columns as RefColumns
from dpark_tpu_torch import Columns, DparkContext, conf
from dpark_tpu_torch.backend.cuda import fuse

add = operator.add
CHUNK = 512


@pytest.fixture(scope="module")
def lctx():
    c = RefContext("local")
    yield c
    c.stop()


@pytest.fixture(scope="module")
def tctx():
    c = RefContext("tpu:4")
    c.start()
    yield c
    c.stop()


@pytest.fixture()
def gctx():
    c = DparkContext("gpu:4", device="cpu")
    c.start()
    yield c
    c.stop()


@pytest.fixture()
def tiny_waves():
    old = (conf.STREAM_CHUNK_ROWS, ref_conf.STREAM_CHUNK_ROWS)
    conf.STREAM_CHUNK_ROWS = ref_conf.STREAM_CHUNK_ROWS = CHUNK
    yield
    conf.STREAM_CHUNK_ROWS, ref_conf.STREAM_CHUNK_ROWS = old


def _stages(ctx):
    return ctx.scheduler.history[-1]["stage_info"]


def _pairs(ctx, C):
    return sorted(ctx.parallelize([(0, True), (0, True), (1, False),
                                   (2, True)], 1)
                  .reduceByKey(add, 1).collect())


def _columns(ctx, C):
    k = np.arange(40) % 4
    return sorted(ctx.parallelize(C(k, k % 3 == 0), 4)
                  .reduceByKey(add, 4).collect())


def _waves(ctx, C):
    rng = np.random.default_rng(27)
    k = rng.integers(0, 300, 20_000)
    return sorted(ctx.parallelize(C(k, rng.random(20_000) < 0.5), 4)
                  .reduceByKey(add, 16).collect())


def _declined(ctx):
    write = _stages(ctx)[0]
    assert write["kind"] == "object", write
    assert write["fallback_reason"] == fuse.BOOL_MERGE_REASON % (0, "int")


@pytest.mark.parametrize("job", [_pairs, _columns])
def test_bool_add_counts_in_core(job, gctx, lctx, tctx):
    got = job(gctx, Columns)
    _declined(gctx)
    assert got == job(lctx, RefColumns) == job(tctx, RefColumns)
    assert any(type(v) is int and v > 1 for _, v in got)


def test_bool_add_counts_under_waves(tiny_waves, gctx, lctx, tctx):
    got = _waves(gctx, Columns)
    _declined(gctx)
    want = _waves(lctx, RefColumns)
    assert got == want == _waves(tctx, RefColumns)
    assert len(got) == 300 and max(v for _, v in got) > 30


def test_bool_inside_a_tuple_value(gctx, lctx):
    """(count, flag) under a traced add: the flag leaf turns int on the
    host, so the write declines and the flags count as `local` counts
    them (the reference's tpu:4 keeps True here: its own divergence)."""
    rows = [(i % 5, (1, i % 2 == 0)) for i in range(50)]

    def job(c):
        return sorted(c.parallelize(rows, 4).reduceByKey(
            lambda a, b: (a[0] + b[0], a[1] + b[1]), 4).collect())
    got = job(gctx)
    assert _stages(gctx)[0]["fallback_reason"] == \
        fuse.BOOL_MERGE_REASON % (1, "int")
    assert got == job(lctx)
    assert got[0] == (0, (10, 5))


def test_bool_max_stays_on_the_device(gctx, lctx, tctx):
    k = np.arange(40) % 4

    def job(c, C):
        return sorted(c.parallelize(C(k, k == 1), 4)
                      .reduceByKey(max, 4).collect())
    got = job(gctx, Columns)
    write = _stages(gctx)[0]
    assert write["kind"] == "array" and not write.get("fallback_reason")
    assert got == job(lctx, RefColumns) == job(tctx, RefColumns)
    assert got == [(0, False), (1, True), (2, False), (3, False)]
