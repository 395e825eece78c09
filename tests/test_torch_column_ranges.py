"""K15 (kernels.column_ranges, B14's masked min/max) on the CPU, where its
plain PyTorch version runs, against the JAX package's jnp programs it
replaces on the same seeded numpy inputs: the exchange probe
JAXExecutor._compile_minmax (per device, over the valid prefix of the sum
of its destination counts; int64) and layout._masked_minmax (over the
valid rows of every shard; int64 and int32).  Cases: ragged counts over
key-sentinel padding, empty shards, full shards, one row, int32 columns,
values at the int32 and int64 limits, several columns at once.  Integers
match exactly.  The kernel itself runs in the test marked `cuda`, on a
card only (`python -m pytest -m cuda tests/test_torch_column_ranges.py`)."""

import numpy as np
import pytest
import torch

from dpark_tpu_torch.backend.cuda import kernels

N = 8
SENTINEL = np.iinfo(np.int64).max


@pytest.fixture(scope="module")
def ref():
    """The reference's tpu:8 executor (x64 on) and its layout module."""
    from dpark_tpu import DparkContext as RefContext
    from dpark_tpu.backend.tpu import layout
    c = RefContext("tpu:8")
    c.start()
    yield c.scheduler.executor, layout
    c.stop()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(seed, cap, dtype=np.int64, empty=(), full=(), lo=-2 ** 40,
          hi=2 ** 40):
    """(column with the key sentinel past each shard's count, counts)."""
    rng = np.random.default_rng(seed)
    n = rng.integers(0, cap + 1, N).astype(np.int32)
    n[list(empty)] = 0
    n[list(full)] = cap
    c = rng.integers(lo, hi, (N, cap), dtype=np.int64)
    c[np.arange(cap)[None, :] >= n[:, None]] = np.iinfo(dtype).max
    return c.astype(dtype), n


CASES = {
    "ragged": dict(seed=1, cap=37),
    "empty shards": dict(seed=2, cap=64, empty=(0, 3, 7)),
    "full shards": dict(seed=3, cap=50, full=range(N)),
    "one row": dict(seed=4, cap=1),
    "int64 limits": dict(seed=5, cap=40, lo=-2 ** 63, hi=2 ** 63 - 1),
    "int32 values": dict(seed=6, cap=33, lo=-2 ** 31, hi=2 ** 31),
    "negative": dict(seed=7, cap=29, lo=-5000, hi=-1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_compile_minmax(ref, case):
    """Per shard, as the exchange's probe: the reference reads each
    device's (1, R) destination counts and takes their sum as the valid
    prefix; K15 takes that sum as n."""
    ex, _ = ref
    c, n = _case(**CASES[case])
    cap = c.shape[1]
    # the reference's counts: (N, R) destination counts summing to n
    split = np.minimum(n[:, None], [[cap // 3, cap]]).astype(np.int32)
    dcounts = np.concatenate([split[:, :1], split[:, 1:] - split[:, :1]], 1)
    assert (dcounts.sum(1) == n).all()
    c2 = c + 7
    got = kernels.column_ranges([_t(c), _t(c2)], _t(n))
    (want1, want2) = ex._compile_minmax(2, cap)(dcounts, c, c2)
    assert got.dtype == torch.int64 and got.shape == (2, N, 2)
    assert np.array_equal(got[0].numpy(), np.asarray(want1))
    assert np.array_equal(got[1].numpy(), np.asarray(want2))


@pytest.mark.parametrize("dtype", [np.int64, np.int32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_masked_minmax(ref, case, dtype):
    """Over all shards, as the egest probe: the min of the shards' lo and
    the max of their hi equal layout._masked_minmax; an empty shard holds
    the dtype's (max, min)."""
    _, layout = ref
    kw = dict(CASES[case])
    if dtype == np.int32:
        kw["lo"] = max(kw.get("lo", -2 ** 40), -2 ** 31)
        kw["hi"] = min(kw.get("hi", 2 ** 40), 2 ** 31)
    c, n = _case(dtype=dtype, **kw)
    got = kernels.column_ranges([_t(c)], _t(n))[0].numpy()
    want = np.asarray(layout._masked_minmax(c, n))
    assert want.dtype == np.dtype(dtype)
    assert [got[:, 0].min(), got[:, 1].max()] == want.tolist()
    info = np.iinfo(dtype)
    for s in np.nonzero(n == 0)[0]:
        assert got[s].tolist() == [info.max, info.min]
    for s in np.nonzero(n)[0]:
        assert got[s].tolist() == [c[s, :n[s]].min(), c[s, :n[s]].max()]


def test_all_shards_empty_and_counts_past_cap():
    c = np.full((N, 16), SENTINEL, np.int64)
    got = kernels.column_ranges([_t(c)], _t(np.zeros(N, np.int32)))
    assert (got[0, :, 0] == SENTINEL).all()
    assert (got[0, :, 1] == -SENTINEL - 1).all()
    c = np.arange(N * 16, dtype=np.int64).reshape(N, 16)
    got = kernels.column_ranges([_t(c)], _t(np.full(N, 99, np.int32)))
    assert got[0, :, 0].tolist() == c[:, 0].tolist()
    assert got[0, :, 1].tolist() == c[:, -1].tolist()


def test_wrapper_refuses_what_the_kernel_does_not_take():
    n = torch.zeros(N, dtype=torch.int32)
    with pytest.raises(ValueError, match="int64 or int32"):
        kernels.column_ranges([torch.zeros((N, 4))], n)
    with pytest.raises(ValueError, match="n must be"):
        kernels.column_ranges([torch.zeros((N, 4), dtype=torch.int64)],
                              n.long())
    with pytest.raises(ValueError, match="contiguous"):
        kernels.column_ranges([torch.zeros((N, 4), dtype=torch.int64),
                               torch.zeros((N, 5), dtype=torch.int64)], n)


@pytest.mark.cuda
def test_column_ranges_match_plain_on_card():
    """K15 launched on the card equals its plain version bit for bit, one
    launch a call of up to 16 columns (two for 17), mixed int64 and int32
    columns in one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    for case in sorted(CASES):
        c, n = _case(**CASES[case])
        c32 = np.clip(c, -2 ** 31, 2 ** 31 - 1).astype(np.int32)
        cols = [_t(c), _t(c32), _t(c // 3)]
        before = kernels.LAUNCHES["column_ranges"]
        got = kernels.column_ranges([x.to(dev) for x in cols], _t(n).to(dev))
        assert kernels.LAUNCHES["column_ranges"] == before + 1
        assert torch.equal(got.cpu(), kernels.column_ranges_plain(cols,
                                                                  _t(n)))
    c, n = _case(seed=11, cap=300000, empty=(2,), full=(5,))
    cols = [_t(c + i) for i in range(17)]
    before = kernels.LAUNCHES["column_ranges"]
    got = kernels.column_ranges([x.to(dev) for x in cols], _t(n).to(dev))
    assert kernels.LAUNCHES["column_ranges"] == before + 2
    assert torch.equal(got.cpu(), kernels.column_ranges_plain(cols, _t(n)))
