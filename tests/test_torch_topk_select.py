"""K18 (kernels.topk_select) on the CPU: its plain version against the
composition it replaces, and the device top path that runs it.

1. topk_select_plain (K18's arithmetic: images, per-tile candidates, the
   merge, the row tie-break) equals bit for bit the rows K5 + K2 keep
   through their plain versions (radix_sort_plain over the order-reversed
   key, stable_partition by validity): int32, int64 and float64 keys, one
   and two key columns, largest and smallest, heavy ties (bench values
   i & 0xFFFF), NaN, -0.0/+0.0, both infinities, int64 min and max,
   sorted shards, empty shards, n past a shard's count, n >= cap, n = 1,
   and shards over several tiles.
2. The top action on the port's gpu:8 (device="cpu": the plain version)
   mirrors tests/test_device_topk.py's cases that
   tests/test_torch_topk_ranged.py does not: each result equals the JAX
   package's `local` master and, where its tpu:8 pre-tops on the device,
   its tpu:8 on the CPU mesh; the stage records `top_route` "K18", or the
   reason it kept K5 + K2 (n above K18's limit, more key columns than it
   takes).
3. top(0) and top(-1) on gpu:4, largest and smallest, by a value key and
   over two key columns: no row and no K18 call, as the JAX package's
   `local` and tpu:4 answer (ROADMAP C28).

The kernel itself runs in tests/test_torch_topk_select_cuda.py, on a card
only."""

import operator

import numpy as np
import pytest
import torch

from dpark_tpu import DparkContext as RefContext
from dpark_tpu_torch import DparkContext
from dpark_tpu_torch.backend.cuda import collectives, fuse
from dpark_tpu_torch.backend.cuda import kernels as K

add = operator.add
# 131 generates Z/1009: the values are a permutation of 0..1008, so no
# top-k cutoff ties (tie membership depends on the order on every master)
ROWS = [(i, (i * 131) % 1009) for i in range(1009)]
N = 3


# ---------------------------------------------------------------------
# 1. the plain version against K5 + K2
# ---------------------------------------------------------------------
def _composed(cols, counts, n, largest, leaves):
    """_device_topk's K5 + K2 route on CPU tensors (the plain versions)."""
    cap = cols[0].shape[1]
    if largest:
        cols = [fuse._reversed_order(c) for c in cols]
    inval = (~collectives.valid_rows(counts, cap)).to(torch.int32)
    packed = collectives._partition_through(
        inval, 2, list(leaves), collectives._lex_order(cols))
    keep = min(n, cap)
    return ([v[:, :keep] for v in packed[1:-1]],
            torch.clamp(counts, max=n).to(torch.int32))


def _bits(t):
    t = t.contiguous()
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def _column(kind, cap, seed):
    rng = np.random.default_rng(seed)
    i = np.arange(N * cap, dtype=np.int64).reshape(N, cap)
    if kind == "ties":
        return i & 0xFFFF
    if kind == "sorted":
        return i // 3
    if kind == "f64":
        x = rng.standard_normal((N, cap))
        for k, v in enumerate([np.nan, -0.0, 0.0, np.inf, -np.inf, -np.nan]):
            x.flat[k::7] = v
        return x
    dt = np.int32 if kind == "i32" else np.int64
    info = np.iinfo(dt)
    x = rng.integers(-20, 20, (N, cap)).astype(dt)     # ties
    x.flat[::5] = info.min
    x.flat[1::9] = info.max
    x.flat[2::13] = rng.integers(info.min, info.max, len(x.flat[2::13]),
                                 dtype=dt)
    return x


def _check_plain(cols, counts, n, largest, seed=0):
    rng = np.random.default_rng(seed)
    cap = cols[0].shape[1]
    cols = [torch.from_numpy(c) for c in cols]
    counts = torch.tensor(counts, dtype=torch.int32)
    leaves = [torch.from_numpy(rng.integers(0, 1 << 40, (N, cap))),
              torch.from_numpy(rng.standard_normal((N, cap, 2))),
              torch.from_numpy(rng.random((N, cap)) < 0.5)] + cols
    K.reset_launches()
    got, got_n = K.topk_select(cols, counts, n, largest, leaves)
    assert K.LAUNCHES["topk_select"] == 0        # the CPU: plain version
    want, want_n = _composed(cols, counts, n, largest, leaves)
    assert torch.equal(got_n, want_n)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        for s in range(N):
            m = int(got_n[s])
            assert torch.equal(_bits(g[s, :m]), _bits(w[s, :m]))
            # the rows past the new count are zero
            assert not g[s, m:].any()


@pytest.mark.parametrize("kind", ["i32", "i64", "f64", "ties", "sorted"])
@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("n", [1, 10, 300, 1024])
def test_plain_matches_k5_k2_one_key(kind, largest, n):
    """cap 300: n = 300 is n = cap, n = 1024 is n > cap; shard 1 empty,
    shard 2 short of n = 300."""
    cap = 300
    _check_plain([_column(kind, cap, n)], [cap, 0, 250], n, largest)


@pytest.mark.parametrize("kinds", [("i64", "f64"), ("ties", "i32"),
                                   ("i32", "i64"), ("f64", "sorted")])
@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("n", [1, 10, 1024])
def test_plain_matches_k5_k2_two_keys(kinds, largest, n):
    cap = 400
    cols = [_column(k, cap, i) for i, k in enumerate(kinds)]
    cols[0] = cols[0] % 4 if cols[0].dtype.kind == "i" else cols[0]
    _check_plain(cols, [cap, 17, 0], n, largest)


@pytest.mark.parametrize("kind", ["i64", "f64", "ties", "sorted"])
@pytest.mark.parametrize("tile", [64, 1000])
def test_plain_over_several_tiles(kind, tile):
    """The per-tile candidates and their merge over shards of many tiles
    (smaller tiles than K18's, ragged): the same rows as K5 + K2 and as
    one tile."""
    cap = 3 * tile + 5
    for counts, n, largest in (([cap, tile + 1, 9], 10, True),
                               ([cap, cap - 1, 0], 50, False)):
        cols = [torch.from_numpy(_column(kind, cap, tile))]
        c = torch.tensor(counts, dtype=torch.int32)
        leaves = [torch.arange(N * cap).view(N, cap)]
        got, got_n = K.topk_select_plain(cols, c, n, largest, leaves,
                                         tile=tile)
        want, want_n = _composed(cols, c, n, largest, leaves)
        one, _ = K.topk_select_plain(cols, c, n, largest, leaves,
                                     tile=cap)
        assert torch.equal(got_n, want_n)
        for s in range(N):
            m = int(got_n[s])
            assert torch.equal(got[0][s, :m], want[0][s, :m])
            assert torch.equal(got[0][s, :m], one[0][s, :m])


def test_plain_at_k18_tile():
    """Two tiles of K18's own size, the second ragged."""
    cap = K.K18_TILE + 5
    _check_plain([_column("ties", cap, 3)], [cap, K.K18_TILE + 1, 9], 10,
                 True)


def test_plain_specials_order():
    """NaN last both ways, -0.0 ties +0.0 (row order), infinities and the
    int64 extremes in place."""
    x = np.array([[np.nan, 1.0, -0.0, np.inf, 0.0, -np.inf, np.nan, 2.0]])
    col = torch.from_numpy(x)
    rows = torch.arange(8).view(1, 8)
    counts = torch.tensor([8], dtype=torch.int32)
    (top,), _ = K.topk_select([col], counts, 8, True, [rows])
    assert top.tolist() == [[3, 7, 1, 2, 4, 5, 0, 6]]
    (low,), _ = K.topk_select([col], counts, 8, False, [rows])
    assert low.tolist() == [[5, 2, 4, 1, 7, 3, 0, 6]]
    i = torch.tensor([[0, 2 ** 63 - 1, -2 ** 63, -1, 2 ** 63 - 1]])
    (top,), _ = K.topk_select([i], torch.tensor([5], dtype=torch.int32), 3,
                              True, [torch.arange(5).view(1, 5)])
    assert top.tolist() == [[1, 4, 0]]


def test_route_limits():
    c = torch.zeros((2, 4), dtype=torch.int64)
    assert K.topk_route([c], K.K18_MAX_N) == "K18"
    assert K.topk_route([c, c.double()], 3) == "K18"
    assert K.topk_route([c], K.K18_MAX_N + 1) == "n 1025 above K18's 1024"
    assert K.topk_route([c] * 3, 3) == "3 key columns above K18's 2"
    assert K.topk_route([c.float()], 3) == \
        "key dtype torch.float32 outside K18's"
    with pytest.raises(ValueError):
        K.topk_select([c] * 3, torch.zeros(2, dtype=torch.int32), 3, True,
                      [])


# ---------------------------------------------------------------------
# 2. the top action on gpu:8 against the JAX package
# ---------------------------------------------------------------------
@pytest.fixture()
def gctx():
    c = DparkContext("gpu:8", device="cpu")
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
    c = RefContext("tpu:8")
    c.start()
    yield c
    c.stop()


def _result_stage(ctx):
    return ctx.scheduler.history[-1]["stage_info"][-1]


def _kinds(ctx):
    return {s["rdd"]: s.get("kind")
            for s in ctx.scheduler.history[-1]["stage_info"]}


def _reduced(ctx, rows=ROWS, parts=8):
    return ctx.parallelize(rows, parts).reduceByKey(add, parts)


def _on_k18(ctx):
    st = _result_stage(ctx)
    assert st["kind"] == "array+top" and st["top_route"] == "K18", st


def test_top_by_value_rides_device(gctx, lctx, tctx):
    got = _reduced(gctx).top(7, key=lambda kv: kv[1])
    _on_k18(gctx)
    exp = sorted(ROWS, key=lambda kv: kv[1], reverse=True)[:7]
    assert got == exp == _reduced(lctx).top(7, key=lambda kv: kv[1])
    assert got == _reduced(tctx).top(7, key=lambda kv: kv[1])
    assert "array+top" in _kinds(tctx).values()


def test_top_smallest_and_scalar_records(gctx, lctx, tctx):
    for ctx in (gctx, lctx, tctx):
        r = _reduced(ctx).map(lambda kv: kv[1])
        got = r.top(5, reverse=True)         # smallest
        assert got == sorted(v for _, v in ROWS)[:5]
        if ctx is gctx:
            _on_k18(gctx)
        if ctx is tctx:
            assert "array+top" in _kinds(tctx).values()
        got = r.top(5)
        assert got == sorted((v for _, v in ROWS), reverse=True)[:5]
        if ctx is gctx:
            _on_k18(gctx)


def test_top_traced_key_expression(gctx, lctx, tctx):
    """An injective float key expression: "fn" keys go through K18."""
    key = lambda kv: kv[1] * 2000.0 + kv[0]                 # noqa: E731
    got = _reduced(gctx).top(4, key=key)
    _on_k18(gctx)
    exp = sorted(ROWS, key=key, reverse=True)[:4]
    assert sorted(got) == sorted(exp)
    assert got == _reduced(lctx).top(4, key=key)
    assert sorted(got) == sorted(_reduced(tctx).top(4, key=key))


def test_top_extreme_float_keys(gctx, lctx, tctx):
    """Valid rows whose key is the float extreme outrank padding."""
    rows = [(i, float("-inf")) for i in range(5)] + [(10, 1.0), (11, 2.0)]
    for ctx in (gctx, tctx):
        got = _reduced(ctx, rows).top(5, key=lambda kv: kv[1])
        assert got[:2] == [(11, 2.0), (10, 1.0)]
        assert all(v == float("-inf") and k in range(5)
                   for k, v in got[2:])
        got = _reduced(ctx, rows).top(4, key=lambda kv: kv[1],
                                      reverse=True)
        assert all(v == float("-inf") for _, v in got)
    _on_k18(gctx)
    assert _reduced(gctx, rows).top(2, key=lambda kv: kv[1]) == \
        _reduced(lctx, rows).top(2, key=lambda kv: kv[1])


def test_top_untraceable_key_falls_back(gctx, lctx):
    got = _reduced(gctx).top(3, key=lambda kv: str(kv[1]))
    assert "array+top" not in _kinds(gctx).values()
    assert got == _reduced(lctx).top(3, key=lambda kv: str(kv[1]))


def test_hot_uses_device_top(gctx, lctx, tctx):
    """The port has no rdd.hot; its definition in the JAX package (count
    by value, then top by count) spelled out rides K18."""
    data = []
    for i in range(50):
        data += [i] * (i + 1)
    want = [(49, 50), (48, 49), (47, 48), (46, 47)]
    assert gctx.parallelize(data, 8).map(lambda x: (x, 1)).reduceByKey(
        add).top(4, key=lambda kv: kv[1]) == want
    _on_k18(gctx)
    assert lctx.parallelize(data, 8).hot(4) == want
    assert tctx.parallelize(data, 8).hot(4) == want


def test_top_parity_vs_local(gctx, lctx, tctx):
    def prog(c):
        return _reduced(c).top(9, key=lambda kv: kv[1])
    assert prog(gctx) == prog(lctx) == prog(tctx)
    _on_k18(gctx)


def test_top_of_records_two_key_columns(gctx, lctx, tctx):
    """key None over (k, v) records: both leaves, lexicographic (K18 with
    two key columns), over sorted shards (sortByKey first)."""
    rows = [((i * 37) % 211, i) for i in range(600)]
    got = gctx.parallelize(rows, 8).sortByKey(numSplits=8).top(6)
    _on_k18(gctx)
    assert got == sorted(rows, reverse=True)[:6]
    assert got == lctx.parallelize(rows, 8).sortByKey(numSplits=8).top(6)
    assert got == tctx.parallelize(rows, 8).sortByKey(numSplits=8).top(6)


def test_route_above_k18_keeps_k5_k2(gctx, lctx):
    """n above K18's limit, or three key columns: the top-n runs K5 + K2,
    the record says why, and the answer is the same."""
    rows = [(i, (i * 7919) % 4099) for i in range(4099)]
    n = K.K18_MAX_N + 1
    got = _reduced(gctx, rows).top(n, key=lambda kv: kv[1])
    st = _result_stage(gctx)
    assert st["kind"] == "array+top"
    assert st["top_route"] == "n %d above K18's %d" % (n, K.K18_MAX_N)
    assert got == _reduced(lctx, rows).top(n, key=lambda kv: kv[1])
    # (k, (x, y)) records compare as (k, x, y): three key columns
    triples = [(i % 13, ((i * 31) % 17, i)) for i in range(500)]
    got = gctx.parallelize(triples, 8).sortByKey(numSplits=8).top(5)
    st = _result_stage(gctx)
    assert st["kind"] == "array+top"
    assert st["top_route"] == "3 key columns above K18's 2"
    assert got == sorted(triples, reverse=True)[:5]
    assert got == lctx.parallelize(triples, 8).sortByKey(numSplits=8).top(5)


# ---------------------------------------------------------------------
# 3. top(n) with n below 1 (ROADMAP C28): no row, no launch
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def tctx4():
    c = RefContext("tpu:4")
    c.start()
    yield c
    c.stop()


def _top_small(ctx, n, reverse):
    cols = (np.arange(30) % 4, np.arange(30))
    rows = list(zip(*(c.tolist() for c in cols)))
    return ctx.parallelize(rows, 4).reduceByKey(add, 4).top(
        n, key=lambda kv: kv[1], reverse=reverse)


def _top_two_columns(ctx, n, reverse):
    rows = [(i % 4, i) for i in range(30)]
    return ctx.parallelize(rows, 4).map(lambda r: (r[0], r[1])).top(
        n, reverse=reverse)


@pytest.mark.parametrize("job", [_top_small, _top_two_columns])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [0, -1])
def test_top_below_one_selects_nothing(job, reverse, n, lctx, tctx4,
                                       monkeypatch):
    def no_launch(*a, **k):
        raise AssertionError("K18 called for n = %d" % n)
    monkeypatch.setattr(K, "topk_select", no_launch)
    c = DparkContext("gpu:4", device="cpu")
    got = job(c, n, reverse)
    st = _result_stage(c)
    c.stop()
    assert got == [] == job(lctx, n, reverse) == job(tctx4, n, reverse)
    assert st["kind"] == "array+top", st
    assert st["top_route"] == "n %d below 1: no row selected" % n
