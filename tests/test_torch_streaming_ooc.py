"""The port's out-of-core wave stream on the CPU (device="cpu": the
kernels' plain versions), mirroring the eleven columnar tests of
tests/test_streaming_ooc.py: sortByKey (range exchange, spilled sorted
runs), groupByKey and partitionBy (spilled runs), a traced tuple merge
(the streamed combine), more logical partitions than shards (the rid
rides the exchange: K13, and B12's per-wave pre-reduce where a merge
traces), spool hygiene, a re-run and a recovery after a drop.  Waves are
pinned to 500 rows a shard, so a few thousand rows run the whole
pipeline.  Every result equals the JAX package's `local` master and its
`tpu:2` with its own waves pinned the same; every streamed case asserts
that its map stage ran the device stream (no fallback_reason, a
`pre_reduced` or `host_runs` store).  The out-of-memory ladder's
wording is held to the reference's on the emulated ceiling, up to its
last step: the port's second out-of-memory error propagates where the
reference runs the stage on the host."""

import os

import numpy as np
import pytest

import dpark_tpu.conf as ref_conf
from dpark_tpu import DparkContext as RefContext
from dpark_tpu.rdd import Columns as RefColumns
from dpark_tpu_torch import Columns, DparkContext, conf
from dpark_tpu_torch.backend.cuda import executor as port_executor

CHUNK = 500
_REF = {}                  # the reference's answer of each job, once


@pytest.fixture(params=["gpu:2", "gpu:8"])
def gctx(request, tiny_waves):
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


@pytest.fixture()
def tiny_waves():
    old = (conf.STREAM_CHUNK_ROWS, ref_conf.STREAM_CHUNK_ROWS)
    conf.STREAM_CHUNK_ROWS = CHUNK
    ref_conf.STREAM_CHUNK_ROWS = CHUNK
    yield
    conf.STREAM_CHUNK_ROWS, ref_conf.STREAM_CHUNK_ROWS = old


def _N(ctx):
    return ctx.default_parallelism


def _sorted_rows(rows):
    """A sort's contract: the key order and the row multiset (equal
    keys' values may come in another order on another master)."""
    return [k for k, _ in rows], sorted(rows)


def _refs(name, job, lctx, tctx, norm=lambda x: x):
    """norm(job(ctx, Columns, P)) on the reference's local and tpu:2
    masters (tpu:2 with its waves pinned to CHUNK); both must agree."""
    if name not in _REF:
        local = job(lctx, RefColumns, 8)
        old = ref_conf.STREAM_CHUNK_ROWS
        ref_conf.STREAM_CHUNK_ROWS = CHUNK
        try:
            tpu = job(tctx, RefColumns, 2)
        finally:
            ref_conf.STREAM_CHUNK_ROWS = old
        local = norm(local)
        assert norm(tpu) == local
        _REF[name] = local
    return _REF[name]


def _stages(ctx):
    return ctx.scheduler.history[-1]["stage_info"]


def _map_stage(ctx, stream):
    """The last job's streamed map stage: it ran on the device, streamed
    into a `stream` store, and no stage of the job fell back."""
    sts = _stages(ctx)
    assert not any("fallback_reason" in s or "degrade_reason" in s
                   for s in sts), sts
    streamed = [s for s in sts if s.get("stream") == stream]
    assert streamed, sts
    assert streamed[0]["kind"].startswith("array")
    return streamed[0]


def _runs_store(ctx):
    return [s for s in ctx.scheduler.executor.shuffle_store.values()
            if "host_runs" in s][-1]


def _spilled_rows(ctx):
    """Rows across all spilled run files."""
    total = 0
    for s in ctx.scheduler.executor.shuffle_store.values():
        for paths in s.get("host_runs", []):
            for p in paths:
                total += len(port_executor._read_run(p)[0])
    return total


def _sort_job(ascending, splits):
    def job(ctx, C, P):
        rng = np.random.RandomState(5)
        keys = rng.randint(-10**6, 10**6, 20000).astype(np.int64)
        vals = np.arange(20000, dtype=np.int64)
        return ctx.parallelize(C(keys, vals), P) \
            .sortByKey(ascending=ascending,
                       numSplits=splits or P).collect()
    return job


def test_streamed_sortbykey(gctx, lctx, tctx):
    job = _sort_job(True, None)
    want = _refs("sort", job, lctx, tctx, _sorted_rows)
    assert _sorted_rows(job(gctx, Columns, _N(gctx))) == want
    _map_stage(gctx, "host_runs")


def test_streamed_sortbykey_descending(gctx, lctx, tctx):
    def job(ctx, C, P):
        keys = (np.arange(6000, dtype=np.int64) * 7919) % 1000
        vals = np.ones(6000, dtype=np.int64)
        return ctx.parallelize(C(keys, vals), P) \
            .sortByKey(ascending=False, numSplits=4).collect()
    want = _refs("sort desc", job, lctx, tctx, _sorted_rows)
    assert _sorted_rows(job(gctx, Columns, _N(gctx))) == want
    _map_stage(gctx, "host_runs")
    assert want[0] == sorted(want[0], reverse=True)


def _groups(rows):
    return {k: sorted(v) for k, v in rows}


def test_streamed_groupbykey(gctx, lctx, tctx):
    def job(ctx, C, P):
        n = 15000
        keys = (np.arange(n, dtype=np.int64) * 31) % 97
        vals = np.arange(n, dtype=np.int64) % 11
        return _groups(ctx.parallelize(C(keys, vals), P)
                       .groupByKey(P).collect())
    want = _refs("group", job, lctx, tctx)
    assert job(gctx, Columns, _N(gctx)) == want
    _map_stage(gctx, "host_runs")
    assert len(want) == 97


def test_streamed_partitionby_then_reduce(gctx, lctx, tctx):
    def job(ctx, C, P):
        n = 8000
        keys = np.arange(n, dtype=np.int64) % 53
        vals = np.ones(n, dtype=np.int64)
        got = {}
        for k, v in ctx.parallelize(C(keys, vals), P).partitionBy(P) \
                .collect():
            got[k] = got.get(k, 0) + v
        return got
    want = _refs("partitionBy", job, lctx, tctx)
    assert job(gctx, Columns, _N(gctx)) == want
    _map_stage(gctx, "host_runs")
    assert want == {k: 8000 // 53 + (1 if k < 8000 % 53 else 0)
                    for k in range(53)}


def test_spool_cleanup_on_drop(gctx):
    keys = np.arange(5000, dtype=np.int64) % 17
    vals = np.ones(5000, dtype=np.int64)
    gctx.parallelize(Columns(keys, vals), _N(gctx)).groupByKey(8).collect()
    _map_stage(gctx, "host_runs")
    ex = gctx.scheduler.executor
    spools = [s["spool_dir"] for s in ex.shuffle_store.values()
              if s.get("spool_dir")]
    assert spools and all(os.path.isdir(d) for d in spools)
    for sid in list(ex.shuffle_store):
        ex.drop_shuffle(sid)
    assert not any(os.path.isdir(d) for d in spools)


def _pair_sum(a, b):
    return (a[0] + b[0], a[1] + b[1])


def _tuple_job(n, mult, mod, vmod, parts):
    def job(ctx, C, P):
        i = np.arange(n, dtype=np.int64)
        return dict(ctx.parallelize(C((i * mult) % mod, i % vmod), P)
                    .mapValue(lambda v: (v, 1))
                    .reduceByKey(_pair_sum, parts or P).collect())
    return job


def test_streamed_generic_combiner(gctx, lctx, tctx):
    """A traceable non-monoid merge (tuple-wise sums) streams into the
    per-shard state (the traced scan, then K3)."""
    job = _tuple_job(12000, 13, 37, 9, None)
    want = _refs("generic combine", job, lctx, tctx)
    assert job(gctx, Columns, _N(gctx)) == want
    _map_stage(gctx, "pre_reduced")
    assert len(want) == 37


def test_logical_partitions_beyond_mesh(gctx, lctx, tctx):
    """r > N: the logical partition rides the exchange (K13 folds it
    onto a shard) and runs land per logical partition."""
    job = _sort_job(True, 32)
    want = _refs("sort 32", job, lctx, tctx, _sorted_rows)
    assert _sorted_rows(job(gctx, Columns, _N(gctx))) == want
    _map_stage(gctx, "host_runs")
    assert len(_runs_store(gctx)["host_runs"]) == 32

    def group(ctx, C, P):
        rng = np.random.RandomState(11)
        keys = rng.randint(0, 10**6, 20000).astype(np.int64)
        vals = np.arange(20000, dtype=np.int64)
        return _groups(ctx.parallelize(C(keys % 101, vals), P)
                       .groupByKey(64).collect())
    want = _refs("group 64", group, lctx, tctx)
    assert group(gctx, Columns, _N(gctx)) == want
    _map_stage(gctx, "host_runs")
    assert len(_runs_store(gctx)["host_runs"]) == 64


def test_traceable_monoid_beyond_mesh(gctx, lctx, tctx):
    """r > N with a classified monoid: each wave pre-reduces per (rid,
    key) on the device (B12 before the exchange, K5 + K3 after), so the
    runs hold one combiner a distinct key a wave, not every row."""
    def job(ctx, C, P):
        i = np.arange(20000, dtype=np.int64)
        return dict(ctx.parallelize(C((i * 13) % 37, i % 7), P)
                    .reduceByKey(lambda a, b: a + b, 24).collect())
    want = _refs("monoid 24", job, lctx, tctx)
    assert job(gctx, Columns, _N(gctx)) == want
    st = _map_stage(gctx, "host_runs")
    assert _runs_store(gctx)["host_combine"]
    rows = _spilled_rows(gctx)
    assert rows <= 37 * st["pipeline"]["waves"], rows
    if _N(gctx) == 8:
        assert rows <= 37 * 8, rows


def test_traceable_generic_merge_beyond_mesh(gctx, lctx, tctx):
    """A traced tuple merge with r > N: the pre-reduce runs the traced
    scan before K3 on both sides of the exchange."""
    job = _tuple_job(16000, 31, 101, 9, 32)
    want = _refs("generic 32", job, lctx, tctx)
    assert job(gctx, Columns, _N(gctx)) == want
    st = _map_stage(gctx, "host_runs")
    rows = _spilled_rows(gctx)
    assert rows <= 101 * st["pipeline"]["waves"], rows
    if _N(gctx) == 8:
        assert rows <= 101 * 8, rows


def test_spilled_rerun_keeps_new_spool(gctx):
    """Re-running a spilled map stage while the old store is registered
    must not delete the new run files (a spool a run).  6,000 rows
    where the reference has 4,000: at 500 rows a shard on gpu:8, 4,000
    would fit one wave and not stream."""
    keys = np.arange(6000, dtype=np.int64) % 13
    vals = np.arange(6000, dtype=np.int64) % 7
    r = gctx.parallelize(Columns(keys, vals), _N(gctx)).groupByKey(8)
    first = _groups(r.collect())
    for stage in gctx.scheduler.shuffle_to_stage.values():
        stage.output_locs = [None] * len(stage.output_locs)
    second = _groups(r.collect())
    _map_stage(gctx, "host_runs")
    assert second == first
    assert first == {k: sorted(vals[keys == k].tolist()) for k in range(13)}


def test_streamed_store_recovery_after_drop(gctx):
    """Dropping the spilled store recomputes through lineage."""
    keys = np.arange(6000, dtype=np.int64) % 29
    vals = np.arange(6000, dtype=np.int64) % 5
    r = gctx.parallelize(Columns(keys, vals), _N(gctx)) \
        .sortByKey(numSplits=4)
    first = r.collect()
    ex = gctx.scheduler.executor
    for sid in list(ex.shuffle_store):
        ex.drop_shuffle(sid)
    second = r.collect()
    _map_stage(gctx, "host_runs")
    assert [k for k, _ in second] == [k for k, _ in first]
    assert sorted(second) == sorted(first)


def _sumsq(vs):
    return sum(v * v for v in vs)


@pytest.mark.parametrize("f", [sum, _sumsq], ids=["segagg", "segmap"])
def test_segment_op_reads_spilled_runs(gctx, lctx, tctx, f):
    """groupByKey(N).mapValues(f) over spilled runs: the premerged runs
    load back to the device, a partition a shard, and the segment op
    (SegAggOp for sum with the combiner rewrite off, SegMapOp for a sum
    of squares) runs there."""
    def job(ctx, C, P):
        i = np.arange(7000, dtype=np.int64)
        return dict(ctx.parallelize(C((i * 31) % 89, i % 23), P)
                    .groupByKey(P).mapValues(f).collect())
    want = _refs("segment %s" % f.__name__, job, lctx, tctx)
    old = conf.GROUP_AGG_REWRITE
    conf.GROUP_AGG_REWRITE = False
    try:
        got = job(gctx, Columns, _N(gctx))
    finally:
        conf.GROUP_AGG_REWRITE = old
    assert got == want
    _map_stage(gctx, "host_runs")
    assert [s["kind"] for s in _stages(gctx)] == ["array+spill", "array"]


def test_resliced_input_streams(gctx, lctx, tctx):
    """Input slices that are not one a shard: each wave cuts every
    shard's even range of the concatenated slices (the reference runs
    such an input on its host path; the answers agree)."""
    def job(ctx, C, P):
        i = np.arange(9001, dtype=np.int64)
        r = ctx.parallelize(C((i * 7) % 61, i % 13), 3)
        return (dict(r.reduceByKey(lambda a, b: a + b, P).collect()),
                _groups(r.groupByKey(P).collect()))
    want = _refs("resliced", job, lctx, tctx)
    got = job(gctx, Columns, _N(gctx))
    assert got == want
    _map_stage(gctx, "host_runs")
    assert any(s.get("stream") == "pre_reduced"
               for rec in gctx.scheduler.history
               for s in rec["stage_info"])


# ---------------------------------------------------------------------
# the out-of-memory ladder on the emulated ceiling
# ---------------------------------------------------------------------
def _ladder_job(ctx, C, P):
    i = np.arange(6000, dtype=np.int64)
    return dict(ctx.parallelize(C(i % 41, i % 5), P)
                .reduceByKey(lambda a, b: a + b, P).collect())


def _ref_degrade(tctx, ceiling):
    """The reference tpu:2's degrade_reason of the same job."""
    old = (ref_conf.STREAM_CHUNK_ROWS, ref_conf.EMULATED_WAVE_OOM_ROWS)
    ref_conf.STREAM_CHUNK_ROWS = CHUNK
    ref_conf.EMULATED_WAVE_OOM_ROWS = ceiling
    try:
        got = _ladder_job(tctx, RefColumns, 2)
    finally:
        ref_conf.STREAM_CHUNK_ROWS, ref_conf.EMULATED_WAVE_OOM_ROWS = old
    return got, [s["degrade_reason"]
                 for s in tctx.scheduler.history[-1]["stage_info"]
                 if s.get("degrade_reason")]


@pytest.mark.parametrize("ceiling", [300, 100])
def test_oom_ladder_matches_reference(gctx, tctx, ceiling):
    """A wave budget of 500 rows above the emulated ceiling: the stage
    retries on the device with 250 rows a shard.  With ceiling 300 it
    streams, its record keeps the halved budget, and its degrade_reason
    and answer are the reference's.  When 250 is still above the
    ceiling (100), the reference runs the stage on the host; the port
    lets the error propagate, with the reference's wording up to that
    step, and the same context answers rightly once the ceiling is
    lifted."""
    want, ref_reasons = _ref_degrade(tctx, ceiling)
    old = conf.EMULATED_WAVE_OOM_ROWS
    conf.EMULATED_WAVE_OOM_ROWS = ceiling
    try:
        if ceiling == 300:
            got = _ladder_job(gctx, Columns, _N(gctx))
        else:
            with pytest.raises(MemoryError, match="RESOURCE_EXHAUSTED"):
                _ladder_job(gctx, Columns, _N(gctx))
    finally:
        conf.EMULATED_WAVE_OOM_ROWS = old
    assert conf.STREAM_CHUNK_ROWS == CHUNK          # left as pinned
    st = _stages(gctx)[0]
    if ceiling == 300:
        assert got == want
        assert [st["degrade_reason"]] == ref_reasons
        assert st["kind"] == "array" and st["stream"] == "pre_reduced"
        assert st["wave_budget"] == CHUNK // 2
        assert "retried with halved wave budget (250" in st["degrade_reason"]
    else:
        assert gctx.scheduler.history[-1]["state"] == "aborted"
        # the stage never finished, and it took no host path
        assert st["seconds"] is None and "fallback_reason" not in st
        [ref] = ref_reasons
        step = "; halved-wave retry failed (MemoryError: "
        assert ref.endswith("object path for this stage")
        assert (st["degrade_reason"].split(step)[0]
                == ref.split(step)[0])
        assert step in st["degrade_reason"]
        assert st["degrade_reason"].endswith("; the error propagates")
        assert _ladder_job(gctx, Columns, _N(gctx)) == want
        _map_stage(gctx, "pre_reduced")
