"""The device top(k) on the port with the ranged-int probe and encoded
keys, on the CPU (gpu:8 with device="cpu": K15's plain version),
mirroring tests/test_device_topk.py: an integer key expression rides the
device when its interval over the batch's exact per-column (lo, hi) (K15)
provably stays inside int64; an overflow-risk expression keeps the host
path; over a string-keyed wordcount only a subscript of the count leaf
orders on the device.  Every result equals the JAX package's `local`
master and, for the device cases, its `tpu:8`."""

import operator

import numpy as np
import pytest

from dpark_tpu import DparkContext as RefContext
from dpark_tpu_torch import DparkContext
from dpark_tpu_torch.backend.cuda import fuse
from dpark_tpu_torch.backend.cuda import kernels as K

add = operator.add
# 131 generates Z/1009: the values are a permutation of 0..1008, so no
# top-k cutoff ties (tie membership depends on the order on every master)
ROWS = [(i, (i * 131) % 1009) for i in range(1009)]


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


def _top_kind(ctx):
    """The kind of the last job's result stage: "array+top" when the
    pre-top ran on the device."""
    return ctx.scheduler.history[-1]["stage_info"][-1]["kind"]


def _top(ctx, rows, n, key, parts=8):
    return ctx.parallelize(rows, parts).reduceByKey(add, parts).top(
        n, key=key)


RANGED = {
    "scaled": (6, lambda kv: kv[1] * 1000),
    # a mixed-column affine key with a negative coefficient
    "affine": (5, lambda kv: kv[1] * 2000 - kv[0]),
    # x*(K - x): the interval bounds the intermediates; K = 3000 keeps the
    # key injective on 0..1008
    "product": (4, lambda kv: kv[1] * (3000 - kv[1])),
    # the chip smoke's key: count * 65536 + word
    "packed": (10, lambda kv: kv[1] * 65536 + kv[0]),
    "floordiv": (3, lambda kv: -(kv[1] // 7) * 4096 + kv[0]),
}


@pytest.mark.parametrize("case", sorted(RANGED))
def test_top_ranged_int_key_rides_device(gctx, lctx, tctx, case):
    n, key = RANGED[case]
    K.reset_launches()
    got = _top(gctx, ROWS, n, key)
    assert _top_kind(gctx) == "array+top"
    assert K.LAUNCHES["column_ranges"] == 0    # the CPU: plain version
    assert got == _top(lctx, ROWS, n, key)
    assert got == _top(tctx, ROWS, n, key)
    assert got == sorted(ROWS, key=key, reverse=True)[:n]


def test_top_ranged_smallest(gctx, lctx):
    key = RANGED["affine"][1]
    got = gctx.parallelize(ROWS, 8).reduceByKey(add, 8).top(
        5, key=key, reverse=True)
    assert _top_kind(gctx) == "array+top"
    assert got == lctx.parallelize(ROWS, 8).reduceByKey(add, 8).top(
        5, key=key, reverse=True)


@pytest.mark.parametrize("rows", [
    [(1, 2 ** 61), (2, 5), (3, 7)],
    [(1, -(2 ** 62)), (2, 5), (3, 2 ** 40)],
])
def test_top_int_key_expression_falls_back(gctx, lctx, rows):
    """An integer key expression that could leave int64 on the device
    (the host computes exact Python ints) keeps the host path, and the
    answer stays right."""
    key = lambda kv: kv[1] * 100                            # noqa: E731
    got = _top(gctx, rows, 1, key, parts=2)
    assert _top_kind(gctx) == "array"
    assert got == _top(lctx, rows, 1, key, parts=2)


@pytest.mark.parametrize("key", [
    lambda kv: kv[1] % 7,                  # an operation outside the set
    lambda kv: kv[1] // (kv[0] - 300),     # a divisor not provably > 0
    lambda kv: str(kv[1]),                 # no tensor form
])
def test_top_unprovable_keys_stay_on_host(gctx, lctx, key):
    got = _top(gctx, ROWS[:200], 3, key)
    assert _top_kind(gctx) == "array"
    assert got == _top(lctx, ROWS[:200], 3, key)


def test_top_ranged_over_empty_shards(gctx, lctx):
    """Three keys on eight shards: most shards are empty (K15 leaves the
    dtype's (max, min) there); the probe reads the non-empty ones."""
    rows = [(5, 10), (6, 20), (7, 30)]
    key = RANGED["scaled"][1]
    got = _top(gctx, rows, 2, key)
    assert _top_kind(gctx) == "array+top"
    assert got == _top(lctx, rows, 2, key) == [(7, 30), (6, 20)]


def test_ranged_probe_intervals():
    """The interval probe itself: int64 limits, positive divisors only,
    unranged leaves abort."""
    treedef, specs = (0, 1), [(np.dtype(np.int64), ())] * 2
    ok = fuse._ranged_int_key_ok
    assert ok(lambda kv: kv[0] * kv[1], treedef, specs,
              [(-2 ** 31, 2 ** 31), (-2 ** 31, 2 ** 31)])
    assert not ok(lambda kv: kv[0] * kv[1], treedef, specs,
                  [(-2 ** 32, 2 ** 32), (0, 2 ** 32)])
    assert ok(lambda kv: kv[0] // 3, treedef, specs, [(0, 9), (0, 0)])
    assert not ok(lambda kv: kv[0] // kv[1], treedef, specs,
                  [(0, 9), (-1, 3)])
    assert not ok(lambda kv: kv[0] + 1, treedef, specs, [(0, 9), None])
    assert not ok(lambda kv: kv[0], treedef, specs, None)
    # an all-empty batch: the identities (max, min) never pass
    assert not ok(lambda kv: kv[1], treedef, specs,
                  [(2 ** 63 - 1, -2 ** 63)] * 2)


def _word_counts(ctx, path):
    return (ctx.textFile(path).flatMap(lambda line: line.split())
            .map(lambda w: (w, 1)).reduceByKey(add, 8))


def test_top_encoded_wordcount(gctx, lctx, tctx, tmp_path):
    """String-keyed counts: ordering by the count leaf pre-tops on the
    device (ids never order anything); ordering by the word itself, or a
    key expression that reads it, keeps the host path."""
    p = tmp_path / "t.txt"
    words = []
    for i in range(40):
        words += ["w%02d" % i] * (i + 1)
    p.write_text(" ".join(words) + "\n")
    counts = _word_counts(gctx, str(p))
    got = counts.top(5, key=lambda kv: kv[1])
    assert _top_kind(gctx) == "array+top"
    assert got == [("w%02d" % i, i + 1) for i in range(39, 34, -1)]
    assert got == _word_counts(lctx, str(p)).top(5, key=lambda kv: kv[1])
    assert got == _word_counts(tctx, str(p)).top(5, key=lambda kv: kv[1])

    got = counts.top(3)                  # orders by (word, count)
    assert _top_kind(gctx) != "array+top"
    assert got == [("w39", 40), ("w38", 39), ("w37", 38)]
    got = counts.top(2, key=lambda kv: kv[1] * 1000 + len(kv[0]))
    assert _top_kind(gctx) != "array+top"
    assert got == [("w39", 40), ("w38", 39)]


def test_classify_encoded_rules():
    specs = [(np.dtype(np.int64), ()), (np.dtype(np.int64), ())]
    c = fuse.classify_top_key
    assert c(None, (0, 1), specs, encoded=True) is None
    assert c(lambda kv: kv[0], (0, 1), specs, encoded=True) is None
    assert c(lambda kv: kv[1], (0, 1), specs, encoded=True) == (
        "leaves", (1,))
    assert c(lambda kv: kv[1] * 1.5, (0, 1), specs, encoded=True) is None
    assert c(lambda kv: kv[1] * 2, (0, 1), specs,
             col_ranges=[(0, 5), (0, 5)]) is not None
    assert c(lambda kv: kv[1] * 2, (0, 1), specs) is None
