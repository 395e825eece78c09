"""TPC-H Q1 as a dpark job (chip_smoke.py's q1_filter / q1_map / q1_merge
/ q1_outputs over its tpch_q1_data generator, here at SF 0.0005: 750
orders, about 3,000 lines) on the port's gpu:4 master with device="cpu"
(K14's plain version: the merge's register program in a Hillis-Steele
scan) against the JAX package's tpu:4 and local masters and numpy: the
integer columns exact, the float ones (the averages, sum_disc's mean)
within 1e-12 relative.  The stage records say every traced merge ran its
K14 program (`merge_route`): Q1's, a tuple reduceByKey's and a spilled
tuple merge's, each lane-separable ("K14 separable": every slot a sum)."""

import importlib.util
import os

import numpy as np
import pytest

from dpark_tpu import Columns as RefColumns, DparkContext as RefContext
from dpark_tpu_torch import Columns, DparkContext, conf

FLOAT_RTOL = 1e-12
SF = 0.0005


@pytest.fixture(scope="module")
def smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("_chip_smoke_q1", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def data(smoke):
    return smoke.tpch_q1_data(sf=SF)


def _job(smoke, ctx, cols, data, parts):
    return (ctx.parallelize(cols(*data), parts).filter(smoke.q1_filter)
            .map(smoke.q1_map).reduceByKey(smoke.q1_merge, parts)
            .mapValues(smoke.q1_outputs))


def _routes(ctx):
    return [st.get("merge_route") for st in
            ctx.scheduler.history[-1]["stage_info"]]


def _same(got, want):
    got, want = dict(got), dict(want)
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = got[key], want[key]
        for i in (0, 1, 2, 3, 7):
            assert int(g[i]) == int(w[i]) and not isinstance(g[i], float)
        for i in (4, 5, 6):
            assert abs(g[i] - w[i]) <= FLOAT_RTOL * abs(w[i])


def test_q1_on_gpu_matches_tpu_local_and_numpy(smoke, data):
    ctx = DparkContext("gpu:4", device="cpu")
    got = _job(smoke, ctx, Columns, data, 4).collect()
    stages = ctx.scheduler.history[-1]["stage_info"]
    assert all(st["kind"].startswith("array") for st in stages), stages
    assert _routes(ctx) == [{"write": "K14 separable"},
                            {"read": "K14 separable"}]
    ctx.stop()
    # four groups, N-O about half the lines
    assert sorted(dict(got)) == [(65, 70), (78, 70), (78, 79), (82, 70)]
    want = smoke.q1_numpy(data)
    _same(got, want)
    for master in ("tpu:4", "local"):
        rctx = RefContext(master)
        ref = _job(smoke, rctx, RefColumns, data, 4).collect()
        rctx.stop()
        _same(got, ref)


def test_q1_generator_follows_the_specification(smoke, data):
    """Section 4.2.3's rules on the generated columns."""
    flag, status, ship, qty, price, disc, tax = data
    assert len(flag) == len(ship) and 750 <= len(flag) <= 750 * 7
    assert set(np.unique(flag)) <= {ord("A"), ord("N"), ord("R")}
    assert np.array_equal(status == ord("O"), ship > smoke.Q1_CURRENT)
    # returnflag N exactly when receiptdate (shipdate + 1..30) is after
    # CURRENTDATE: shipdate past it means N, shipdate 30 days before it
    # means R or A
    assert np.all(flag[ship > smoke.Q1_CURRENT] == ord("N"))
    assert np.all(flag[ship <= smoke.Q1_CURRENT - 30] != ord("N"))
    assert ship.min() >= 1 and ship.max() <= smoke.Q1_ORDER_LAST + 121
    assert qty.min() >= 1 and qty.max() <= 50
    assert disc.min() >= 0 and disc.max() <= 10
    assert tax.min() >= 0 and tax.max() <= 8
    assert np.all(price % qty == 0)
    retail = price // qty
    assert retail.min() >= 90000 and retail.max() <= 90000 + 20000 + 99900


def test_tuple_merges_route_through_k14(smoke):
    """A tuple reduceByKey in core and a spilled tuple merge (more
    partitions than shards, waves of 500 rows a shard) record K14 for
    every traced merge, and equal the JAX package's local master."""
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 300, 6000)
    vals = rng.integers(0, 1000, 6000)
    lctx = RefContext("local")
    pairs = list(zip(keys.tolist(), vals.tolist()))
    want = dict(lctx.parallelize(pairs, 4)
                .map(lambda kv: (kv[0], (kv[1], 1)))
                .reduceByKey(smoke._pair_sum, 4).collect())
    lctx.stop()
    ctx = DparkContext("gpu:4", device="cpu")
    src = ctx.parallelize(Columns(keys, vals), 4).map(
        lambda kv: (kv[0], (kv[1], 1)))
    got = dict(src.reduceByKey(smoke._pair_sum, 4).collect())
    assert got == want
    assert _routes(ctx) == [{"write": "K14 separable"},
                            {"read": "K14 separable"}]
    old = conf.STREAM_CHUNK_ROWS
    conf.STREAM_CHUNK_ROWS = 500
    try:
        got = dict(src.reduceByKey(smoke._pair_sum, 16).collect())
        stages = ctx.scheduler.history[-1]["stage_info"]
    finally:
        conf.STREAM_CHUNK_ROWS = old
    ctx.stop()
    assert got == want
    assert stages[0]["stream"] == "host_runs"
    assert stages[0]["merge_route"] == {"write": "K14 separable"}
    assert stages[1].get("reads") == "host_runs"
    assert "fallback_reason" not in stages[0]
    assert len(stages) == 2
