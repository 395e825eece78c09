"""The wave threshold of a columnar input on gpu:8 (fuse._wave_rows with
conf.stream_chunk_rows), held to the JAX package's verdict
(backend/tpu/fuse.py _big_columnar with conf.stream_chunk_rows) on the
same input.  The port's eight shards share one card, so each gets an
eighth of its memory, as each of the reference's eight devices has its
own; a shard's rows are counted as it holds them, after the re-slicing
of the input to the shards; a column of shape (n, w) counts w times its
itemsize.  conf.device_bytes_limit (the card's memory) and the
reference's per-device memory are patched to small sizes, and both
packages' fixed floor of 4Mi rows is lowered, so the thresholds fall at
a few hundred rows."""

from unittest import mock

import numpy as np
import pytest

import dpark_tpu.conf as ref_conf
from dpark_tpu.backend.tpu import fuse as ref_fuse
from dpark_tpu.rdd import ParallelCollection as RefPC
from dpark_tpu.rdd import _ColumnarSlice as RefSlice
from dpark_tpu_torch import Columns, DparkContext
from dpark_tpu_torch import conf
from dpark_tpu_torch.backend.cuda import fuse
from dpark_tpu_torch.rdd import _ColumnarSlice

N = 8
ROW_BYTES = 16                     # an int64 (k, v) pair
PER_SHARD = 100                    # rows a shard may hold at 16 B a row
CARD = N * PER_SHARD * 16 * ROW_BYTES


@pytest.fixture()
def card():
    """The card's memory for the port, an eighth of it per device for
    the reference, and a floor of 8 rows in both.  The reference's
    buffer donation is off: the port donates no buffers, so both size a
    wave to memory / 16."""
    with mock.patch.object(conf, "device_bytes_limit",
                           lambda device: CARD), \
            mock.patch.object(conf, "_STREAM_CHUNK_ROWS_FALLBACK", 8), \
            mock.patch.object(ref_conf, "_HBM_LIMIT_CACHE", CARD // N), \
            mock.patch.object(ref_conf, "_STREAM_CHUNK_ROWS_FALLBACK", 8), \
            mock.patch.object(ref_conf, "STREAM_CHUNK_ROWS", "auto"), \
            mock.patch.object(ref_conf, "DONATE_BUFFERS", False):
        yield


def _slices(cls, rows, nslices, width=None):
    keys = np.arange(rows * nslices, dtype=np.int64)
    vals = (keys if width is None
            else np.ones((len(keys), width), np.float64))
    return [cls([keys[i * rows:(i + 1) * rows],
                 vals[i * rows:(i + 1) * rows]]) for i in range(nslices)]


def _port_verdict(rows, nslices, width=None):
    """(threshold or None) of the port's gpu:8 for nslices of `rows`."""
    ctx = DparkContext("gpu:8", device="cpu")
    pc = ctx.parallelize(Columns(np.zeros(1, np.int64)), 1)
    pc._slices = _slices(_ColumnarSlice, rows, nslices, width)
    return fuse._wave_rows(pc, "cpu", N, nslices != N)


def _ref_verdict(rows_per_shard, width=None):
    """The reference's _big_columnar over its eight devices, each given
    the rows the port's shard holds."""
    pc = RefPC.__new__(RefPC)
    pc._slices = _slices(RefSlice, rows_per_shard, N, width)
    return ref_fuse._big_columnar(pc)


@pytest.mark.parametrize("rows", [PER_SHARD - 1, PER_SHARD, PER_SHARD + 1,
                                  4 * PER_SHARD, N * PER_SHARD - 1])
def test_budget_divided_among_shards(card, rows):
    """Eight slices, one a shard: a shard above an eighth of the card's
    budget needs waves (the whole card's budget admitted it before)."""
    got = _port_verdict(rows, N)
    assert (got is not None) == _ref_verdict(rows) == (rows > PER_SHARD)
    if got is not None:
        assert got == PER_SHARD
    assert conf.stream_chunk_rows(ROW_BYTES, "cpu", N) == PER_SHARD


@pytest.mark.parametrize("rows,nslices", [(60, 16), (50, 16), (26, 32),
                                          (25, 32), (400, 2), (101, 8)])
def test_rows_counted_after_reslicing(card, rows, nslices):
    """Slices that re-slice into fewer, larger shards: the shard's rows
    decide (each input slice alone is under the threshold)."""
    per_shard = -(-rows * nslices // N)
    got = _port_verdict(rows, nslices)
    want = _ref_verdict(per_shard)
    assert (got is not None) == want == (per_shard > PER_SHARD)


@pytest.mark.parametrize("width,rows", [(1, 100), (3, 50), (3, 34),
                                        (3, 33), (7, 20)])
def test_vector_column_counts_its_width(card, width, rows):
    """A (n, w) float64 column counts 8 * w bytes a row: (k, w floats)
    rows of 8 + 8w bytes."""
    limit = PER_SHARD * ROW_BYTES // (8 + 8 * width)
    got = _port_verdict(rows, N, width)
    assert (got is not None) == _ref_verdict(rows, width) == (rows > limit)
    assert fuse._columnar_row_bytes(_slices(_ColumnarSlice, 2, 1, width)) \
        == 8 + 8 * width


def test_wave_threshold_names_the_shard_budget(card):
    """A stage over such an input streams in waves of the per-shard
    threshold (its record names the budget), with no fallback, and its
    result is right."""
    ctx = DparkContext("gpu:8", device="cpu")
    keys = np.arange(N * (PER_SHARD + 1)) % 7
    got = dict(ctx.parallelize(Columns(keys, keys), N)
               .reduceByKey(lambda a, b: a + b, N).collect())
    assert got == {k: int(keys[keys == k].sum()) for k in range(7)}
    st = ctx.scheduler.history[-1]["stage_info"][0]
    assert "fallback_reason" not in st
    assert st["wave_budget"] == PER_SHARD
    assert st["stream"] == "pre_reduced" and st["pipeline"]["waves"] == 2
    ctx.stop()
