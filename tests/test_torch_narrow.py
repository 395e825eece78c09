"""Wire narrowing on the port (B14), on the CPU (gpu:8 with device="cpu"),
mirroring the ingest and egest cases of tests/test_narrow_exchange.py and
tests/test_tpu_backend.py (test_egest_narrowed_wire_parity,
test_egest_narrow_skipped_for_big_values).

Host to device: an int64 scalar leaf of a columnar input whose values all
fit int32 is copied as int32 (layout._h2d sees int32) and widened on the
device, so the batch and every result keep int64.  Device to host: an
int64 result column of at least conf.EGEST_NARROW_MIN_BYTES whose valid
values fit int32 (K15's min/max, its plain version here) crosses as int32
(layout._d2h sees int32).  Every result equals the JAX package's `local`
master, and its `tpu:8` where both narrow."""

import operator
from unittest import mock

import numpy as np
import pytest
import torch

import dpark_tpu.conf as ref_conf
from dpark_tpu import DparkContext as RefContext
from dpark_tpu.rdd import Columns as RefColumns
from dpark_tpu_torch import Columns, DparkContext, conf
from dpark_tpu_torch.backend.cuda import kernels, layout

add = operator.add


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


class _Wire:
    """Records the dtype of every host-to-device and device-to-host copy
    of the ingest and egest."""

    def __init__(self):
        self.h2d, self.d2h = [], []
        self._h2d, self._d2h = layout._h2d, layout._d2h

    def __enter__(self):
        def h2d(dst, src):
            self.h2d.append(src.dtype)
            return self._h2d(dst, src)

        def d2h(t):
            self.d2h.append(t.dtype)
            return self._d2h(t)
        self._patches = [mock.patch.object(layout, "_h2d", h2d),
                         mock.patch.object(layout, "_d2h", d2h)]
        for p in self._patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self._patches:
            p.stop()


def _reduce(ctx, keys, vals, cols=Columns, parts=8):
    return dict(ctx.parallelize(cols(np.asarray(keys, np.int64),
                                     np.asarray(vals, np.int64)), 8)
                .reduceByKey(add, parts).collect())


def _expect(keys, vals):
    out = {}
    for k, v in zip(keys, vals):
        out[int(k)] = out.get(int(k), 0) + int(v)
    return out


def _spec():
    return layout.record_spec((0, 0))


def test_ingest_narrows_h2d_wire(gctx, lctx, tctx):
    """Columns that fit int32 are copied as int32 and widened on the
    device; a column beyond int32 keeps the int64 wire; results exact."""
    i = np.arange(4096, dtype=np.int64)
    pc = gctx.parallelize(Columns(i % 1000, i % 7), 8)
    with _Wire() as w:
        batch = layout.ingest(8, "cpu", pc._slices, *_spec(), key_leaf=0)
    assert set(w.h2d) == {torch.int32}
    assert [c.dtype for c in batch.cols] == [torch.int64, torch.int64]
    assert torch.equal(batch.cols[1][0, :512], torch.from_numpy(i[:512] % 7))
    with _Wire() as w:
        got = _reduce(gctx, i % 1000, i % 7)
    assert set(w.h2d) == {torch.int32}
    assert got == _expect(i % 1000, i % 7)
    assert got == _reduce(lctx, i % 1000, i % 7, RefColumns)
    assert got == _reduce(tctx, i % 1000, i % 7, RefColumns)

    big = np.int64(2 ** 31) + i
    pc2 = gctx.parallelize(Columns(i % 50, big), 8)
    with _Wire() as w:
        layout.ingest(8, "cpu", pc2._slices, *_spec(), key_leaf=0)
    assert w.h2d == [torch.int32] * 8 + [torch.int64] * 8   # per leaf
    got = _reduce(gctx, i % 50, big)
    assert got == _expect(i % 50, big)
    assert got == _reduce(tctx, i % 50, big, RefColumns)


@pytest.mark.parametrize("case", ["edge", "over", "negative", "wide_sums"])
def test_int32_boundaries_exact(gctx, lctx, tctx, case):
    """Values at the int32 limits narrow and stay exact; one past them
    keep the int64 wire; negative keys narrow; sums wider than int32 stay
    exact (compute is int64 either way)."""
    lim = 2 ** 31 - 1
    keys, vals, wire = {
        "edge": ([1, 1, 2, 3, 3], [lim, -lim, lim, -(2 ** 31), 0],
                 {torch.int32}),
        "over": ([1, 1, 2, 2], [2 ** 31, 5, -(2 ** 31) - 1, -5],
                 {torch.int32, torch.int64}),
        "negative": ([-(i % 50) - 1 for i in range(10000)],
                     [-i for i in range(10000)], {torch.int32}),
        "wide_sums": ([i % 4 for i in range(64)], [2 ** 30] * 64,
                      {torch.int32}),
    }[case]
    with _Wire() as w:
        got = _reduce(gctx, keys, vals, parts=4)
    assert set(w.h2d) == wire
    assert got == _expect(keys, vals)
    assert got == _reduce(lctx, keys, vals, RefColumns, parts=4)
    assert got == _reduce(tctx, keys, vals, RefColumns, parts=4)


def test_key_int32_max_is_data_int64_max_is_sentinel(gctx, lctx):
    """The sentinel check reads the spec dtype: a key of 2**31-1 in an
    int64 column narrows and rides the device; a key of 2**63-1 equals
    the sentinel and takes the host path."""
    keys, vals = [2 ** 31 - 1, 5, 2 ** 31 - 1], [1, 2, 3]
    with _Wire() as w:
        got = _reduce(gctx, keys, vals)
    assert set(w.h2d) == {torch.int32}
    assert all("fallback_reason" not in s for s in
               gctx.scheduler.history[-1]["stage_info"])
    assert got == {2 ** 31 - 1: 4, 5: 2} == _reduce(lctx, keys, vals,
                                                    RefColumns)
    keys = [2 ** 63 - 1, 5]
    got = _reduce(gctx, keys, [1, 2])
    st = gctx.scheduler.history[-1]["stage_info"][0]
    assert "sentinel" in st["fallback_reason"]
    assert got == {2 ** 63 - 1: 1, 5: 2}


def test_narrowing_off_and_row_partitions_keep_int64(gctx, lctx):
    """conf.NARROW_EXCHANGE off keeps every wire at int64; so do row
    (non-columnar) partitions, as in the reference."""
    i = np.arange(2000, dtype=np.int64)
    old = conf.NARROW_EXCHANGE
    conf.NARROW_EXCHANGE = False
    try:
        with _Wire() as w:
            got = _reduce(gctx, i % 30, i)
    finally:
        conf.NARROW_EXCHANGE = old
    assert set(w.h2d) == {torch.int64}
    assert got == _expect(i % 30, i)
    rows = [(int(k), int(v)) for k, v in zip(i % 30, i)]
    with _Wire() as w:
        got = dict(gctx.parallelize(rows, 8).reduceByKey(add, 8).collect())
    assert set(w.h2d) == {torch.int64}
    assert got == dict(lctx.parallelize(rows, 8).reduceByKey(add, 8)
                       .collect())


@pytest.fixture()
def tiny_egest():
    old = conf.EGEST_NARROW_MIN_BYTES, ref_conf.EGEST_NARROW_MIN_BYTES
    conf.EGEST_NARROW_MIN_BYTES = ref_conf.EGEST_NARROW_MIN_BYTES = 1
    yield
    conf.EGEST_NARROW_MIN_BYTES, ref_conf.EGEST_NARROW_MIN_BYTES = old


def _collect_wire(ctx, pairs):
    calls = []
    real = kernels.column_ranges

    def probe(cols, n):
        calls.append(len(cols))
        return real(cols, n)
    with mock.patch.object(kernels, "column_ranges", probe), \
            _Wire() as w:
        got = dict(ctx.parallelize(pairs, 8).reduceByKey(add, 8)
                   .collect())
    return got, calls, w.d2h


def test_egest_narrowed_wire_parity(gctx, lctx, tctx, tiny_egest):
    """Int64 results whose values fit int32 cross as int32: one K15 call
    over both columns, int32 on the wire, results identical."""
    pairs = [(i % 50, i) for i in range(4000)]
    got, calls, d2h = _collect_wire(gctx, pairs)
    assert calls == [2] and d2h == [torch.int32, torch.int32]
    assert got == _expect(*zip(*pairs))
    assert got == dict(lctx.parallelize(pairs, 8).reduceByKey(add, 8)
                       .collect())
    assert got == dict(tctx.parallelize(pairs, 8).reduceByKey(add, 8)
                       .collect())


def test_egest_narrow_skipped_for_big_values(gctx, lctx, tiny_egest):
    """A column with a value beyond int32 keeps the int64 wire; the key
    column still narrows."""
    big = 1 << 40
    pairs = [(i % 10, big + i) for i in range(100)]
    got, calls, d2h = _collect_wire(gctx, pairs)
    assert calls == [2] and d2h == [torch.int32, torch.int64]
    assert got == dict(lctx.parallelize(pairs, 8).reduceByKey(add, 8)
                       .collect())


def test_egest_below_threshold_not_probed(gctx):
    """Columns under conf.EGEST_NARROW_MIN_BYTES (8 MiB) cross as they
    are, with no probe; neither does an egest with narrowing off."""
    pairs = [(i % 50, i) for i in range(4000)]
    got, calls, d2h = _collect_wire(gctx, pairs)
    assert calls == [] and set(d2h) == {torch.int64}
    assert got == _expect(*zip(*pairs))
    old = conf.NARROW_EXCHANGE, conf.EGEST_NARROW_MIN_BYTES
    conf.NARROW_EXCHANGE, conf.EGEST_NARROW_MIN_BYTES = False, 1
    try:
        _, calls, d2h = _collect_wire(gctx, pairs)
    finally:
        conf.NARROW_EXCHANGE, conf.EGEST_NARROW_MIN_BYTES = old
    assert calls == [] and set(d2h) == {torch.int64}


def test_egest_float_and_empty_shards(gctx, lctx, tiny_egest):
    """A float column never narrows; shards with no rows hold K15's
    identities, which never block the others from narrowing."""
    pairs = [(i % 3, float(i) / 3) for i in range(30)]
    got, calls, d2h = _collect_wire(gctx, pairs)
    assert calls == [1] and d2h == [torch.int32, torch.float64]
    assert got == dict(lctx.parallelize(pairs, 8).reduceByKey(add, 8)
                       .collect())
