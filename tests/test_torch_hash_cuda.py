"""K1 (hash_dst_hist) launched on the card against its plain version.

Every test here is marked `cuda` and skips without a card; on the card:
``python -m pytest -m cuda tests/test_torch_hash_cuda.py``.  The file
imports no JAX: the CPU tests of the plain version against the JAX
package's hash are in tests/test_torch_phash.py.  Every comparison is
exact: dst, the histogram and the raw hash bit for bit.

Shapes: 1, 2 and 6 key columns of mixed int32/int64; r in {1, 7, 8, 64,
1000} with n_dst equal to r and above it; every combination of the
histogram and the hash; an empty shard and a full shard; caps of 1, 5
and 4097, whose shards start and end inside a quad (4 rows, the
kernel's vector width); key columns not 16-byte aligned (the row-by-row
loads); r at the shared-memory counters' limit and past it; and a
shape whose blocks flush their byte counters (more than 31 steps a
block), all rows in one bucket."""

import numpy as np
import pytest
import torch

from dpark_tpu_torch.backend.cuda import kernels

pytestmark = pytest.mark.cuda

FLAGS = [(h, x) for h in (False, True) for x in (False, True)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    kernels.build()
    return torch.device("cuda")


def _keys(ncols, N, cap, seed, dev, offset=0):
    """ncols columns, int64 and int32 in turn, the int64 ones over the
    whole range; `offset` elements before each column's first (a view
    `offset` elements into its storage)."""
    rng = np.random.RandomState(seed)
    cols = []
    for c in range(ncols):
        if c % 2 == 0:
            a = rng.randint(-2 ** 62, 2 ** 62, N * cap + offset,
                            dtype=np.int64)
        else:
            a = rng.randint(-2 ** 31, 2 ** 31, N * cap + offset,
                            dtype=np.int64).astype(np.int32)
        t = torch.from_numpy(a).to(dev)
        cols.append(t[offset:].view(N, cap))
    return cols


def _counts(N, cap, seed, dev):
    rng = np.random.RandomState(seed)
    n = rng.randint(0, cap + 1, N).astype(np.int32)
    n[0] = 0                       # an empty shard
    n[-1] = cap                    # a full shard
    return torch.from_numpy(n).to(dev)


def _check(cols, n, r, n_dst, want_hist, want_hash):
    got = kernels.hash_dst_hist(cols, n, r, n_dst, want_hist, want_hash)
    want = kernels.hash_dst_hist_plain(cols, n, r, n_dst, want_hist,
                                       want_hash)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g, w)


@pytest.mark.parametrize("cap", [1, 5, 4097])
@pytest.mark.parametrize("more", [0, 3])
@pytest.mark.parametrize("r", [1, 7, 8, 64, 1000])
@pytest.mark.parametrize("ncols", [1, 2, 6])
def test_hash_dst_hist_matches_plain(dev, ncols, r, more, cap):
    N = 5
    cols = _keys(ncols, N, cap, 17 * ncols + cap, dev)
    n = _counts(N, cap, r + cap, dev)
    before = kernels.LAUNCHES["hash_dst_hist"]
    for want_hist, want_hash in FLAGS:
        _check(cols, n, r, r + more, want_hist, want_hash)
    assert kernels.LAUNCHES["hash_dst_hist"] == before + len(FLAGS)


@pytest.mark.parametrize("ncols", [1, 2])
def test_hash_dst_hist_unaligned_columns(dev, ncols):
    """Columns one element into their storage: no 16-byte key loads."""
    N, cap = 3, 1000
    cols = _keys(ncols, N, cap, 5, dev, offset=1)
    assert cols[0].data_ptr() % 16 != 0
    n = _counts(N, cap, 6, dev)
    for want_hist, want_hash in FLAGS:
        _check(cols, n, 8, 8, want_hist, want_hash)


def test_hash_dst_hist_many_buckets(dev):
    """r up to the shared-memory counters (12,288, 48 KB) takes the
    histogram; past them the launch is refused and the wrapper raises;
    without the histogram any r runs."""
    N, cap = 2, 1 << 16
    cols = _keys(1, N, cap, 9, dev)
    n = _counts(N, cap, 10, dev)
    _check(cols, n, 12288, 12288, True, False)
    with pytest.raises(RuntimeError):
        kernels.hash_dst_hist(cols, n, 12289, 12289, True, False)
    _check(cols, n, 20000, 20001, False, True)


@pytest.mark.parametrize("r", [9, 16])
def test_hash_dst_hist_counter_flush(dev, r):
    """8 shards of 2^25 rows: each block (132 a shard on 132 SMs) walks
    about 62 steps, so its byte counters flush every 31; one key
    everywhere puts 8 rows a step of every thread in one bucket (the
    counters' most)."""
    N, cap = 8, 1 << 25
    keys = torch.full((N, cap), 123456789, dtype=torch.int64, device=dev)
    n = torch.full((N,), cap, dtype=torch.int32, device=dev)
    n[1] = cap - 7
    _check([keys], n, r, r, True, False)
    cols = _keys(1, N, cap, 11, dev)
    _check(cols, n, r, r, True, True)
