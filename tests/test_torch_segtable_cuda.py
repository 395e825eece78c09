"""K7 (segment_table) launched on the card against its plain version.

Every test here is marked `cuda` and skips without a card; on the card:
``python -m pytest -m cuda tests/test_torch_segtable_cuda.py``.  The file
imports no JAX: the CPU tests of the plain version against the JAX
package are in tests/test_torch_segtable.py.  Every comparison is exact
(the table is integers and copied key bits).
"""

import numpy as np
import pytest
import torch

from dpark_tpu_torch.backend.cuda import kernels

pytestmark = pytest.mark.cuda

N = 3
TILE = kernels._K7_TILE


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    kernels.build()
    return torch.device("cuda")


def _runs(rng, cap, mean, dtype):
    """(N, cap) sorted runs of mean length `mean` of `dtype` keys."""
    out = np.empty((N, cap), dtype)
    for s in range(N):
        sizes = rng.geometric(1.0 / mean, cap)
        ids = np.repeat(np.arange(cap), sizes)[:cap]
        out[s] = (ids * 7 - 1000).astype(dtype)
    return out


def _run(dev, cols, n, want_keys=True):
    """The kernel on the card (one launch counted, the plain version not
    called) against the plain version on the same card tensors."""
    tc = [torch.from_numpy(np.ascontiguousarray(c)).to(dev) for c in cols]
    tn = torch.from_numpy(np.asarray(n, np.int32)).to(dev)

    def refuse(*a, **k):
        raise AssertionError("segment_table_plain called on a CUDA tensor")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kernels, "segment_table_plain", refuse)
        before = kernels.LAUNCHES["segment_table"]
        got = kernels.segment_table(tc, tn, want_keys)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["segment_table"] == before + (
            1 if cols[0].shape[1] else 0)
    want = kernels.segment_table_plain(tc, tn, want_keys)
    for g, w in zip(got[:5], want[:5]):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if want_keys:
        for g, w in zip(got[5], want[5]):
            assert torch.equal(g.view(torch.int64 if g.element_size() == 8
                                      else torch.int32),
                               w.view(torch.int64 if w.element_size() == 8
                                      else torch.int32))
    else:
        assert got[5] is None
    return got


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float64])
@pytest.mark.parametrize("cap", [1, TILE - 1, 3 * TILE + 1])
@pytest.mark.parametrize("mean", [1, 5, 3000])
def test_segment_table_matches_plain(dev, dtype, cap, mean):
    rng = np.random.RandomState(cap % 1009 + mean)
    keys = _runs(rng, cap, mean, dtype)
    n = [cap, max(0, cap - 17), cap // 2]
    _run(dev, [keys], n)


@pytest.mark.parametrize("cap", [TILE - 1, 3 * TILE + 1])
def test_one_segment_all_distinct_and_empty(dev, cap):
    keys = np.zeros((N, cap), np.int64)
    keys[1] = np.arange(cap)
    keys[2] = np.arange(cap)[::-1]
    got = _run(dev, [keys], [cap, cap, 0])
    assert got[3].tolist() == [1, cap, 0]


def test_float_specials_at_tile_edges(dev):
    """NaN is its own key, -0.0 equals +0.0, also where the pair straddles
    two threads or two tiles."""
    cap = 3 * TILE + 1
    keys = np.repeat(np.arange(cap // 4 + 1, dtype=np.float64), 4)[:cap]
    keys = np.stack([keys] * N)
    for edge in (7, 8, TILE - 1, TILE, 2 * TILE):
        keys[0, edge - 1], keys[0, edge] = -0.0, 0.0
        keys[1, edge - 1], keys[1, edge] = np.nan, np.nan
        keys[2, edge - 1:edge + 2] = np.inf
    _run(dev, [keys], [cap, cap, cap - 3])


def test_four_mixed_key_columns(dev):
    """int32, int64, float64 and int32 columns: a start wherever any
    differs."""
    cap = 2 * TILE + 33
    rng = np.random.RandomState(23)
    cols = [_runs(rng, cap, 40, np.int32), _runs(rng, cap, 9, np.int64),
            _runs(rng, cap, 300, np.float64), _runs(rng, cap, 2, np.int32)]
    cols[2][1, 100:140] = -0.0
    cols[2][1, 120:130] = 0.0
    cols[2][2, 50:60] = np.nan
    for want_keys in (True, False):
        _run(dev, cols, [cap, cap - 5, 1], want_keys)


def test_counts_past_cap_and_ragged(dev):
    """n above cap closes the last segment at n, as the plain version
    does; a shard of one valid row."""
    cap = TILE + 3
    keys = _runs(np.random.RandomState(29), cap, 6, np.int64)
    _run(dev, [keys], [cap + 5, 1, TILE])


def test_many_tiles_repeats_bit_for_bit(dev):
    """2^22 + 3 rows a shard (1,025 tiles, so the look-back walks far,
    and one segment spans many tiles): equal to the plain version, and
    five launches give the same bits."""
    cap = (1 << 22) + 3
    rng = np.random.RandomState(31)
    keys = _runs(rng, cap, 50, np.int64)
    keys[1, 1000:200_000] = keys[1, 999]
    first = _run(dev, [keys], [cap, cap - 1000, 7])
    tk = [torch.from_numpy(keys).to(dev)]
    tn = torch.tensor([cap, cap - 1000, 7], dtype=torch.int32, device=dev)
    for _ in range(5):
        again = kernels.segment_table(tk, tn)
        assert all(torch.equal(a, b) for a, b in zip(again[:5], first[:5]))
        assert torch.equal(again[5][0], first[5][0])
