"""K5 (radix_sort) launched on the card against its plain version and
against torch.sort(stable=True) on the CPU.

Every test here is marked `cuda` and skips without a card; on the card:
``python -m pytest -m cuda tests/test_torch_radix_cuda.py``.  The file
imports no JAX: the CPU tests of the plain version against the JAX
package are in tests/test_torch_radix.py.  Every comparison is exact (a
permutation is integers).
"""

import numpy as np
import pytest
import torch

from dpark_tpu_torch.backend.cuda import kernels

pytestmark = pytest.mark.cuda

N = 3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    kernels.build()
    return torch.device("cuda")


def _column(dtype, cap, seed):
    """(N, cap) keys with ties, negatives and the type's extremes; floats
    with -0.0/+0.0, both infinities and NaN of both signs."""
    rng = np.random.RandomState(seed)
    if dtype == np.float64:
        x = rng.standard_normal((N, cap)) * 1e3
        special = [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan,
                   np.finfo(np.float64).max, -np.finfo(np.float64).tiny]
    else:
        info = np.iinfo(dtype)
        x = rng.randint(info.min, info.max, (N, cap), dtype=dtype)
        x[:, ::3] = rng.randint(-50, 50, (N, len(range(0, cap, 3))))
        special = [info.min, info.max, info.min + 1, 0, -1]
    x = x.astype(dtype)
    if cap:
        pos = rng.randint(0, cap, (N, max(1, cap // 50)))
        for s in range(N):
            x[s, pos[s]] = rng.choice(np.array(special, dtype=dtype),
                                      pos.shape[1])
    return x


def _perm(cap, seed):
    rng = np.random.RandomState(seed)
    return np.stack([rng.permutation(cap) for _ in range(N)]).astype(
        np.int32)


def _check(dev, x, src=None):
    """K5 on the card: one launch counted, no call of the plain version,
    bit-equal to the plain version on the card and to torch.sort's
    stable order on the CPU (composed with src)."""
    col = torch.from_numpy(np.ascontiguousarray(x))
    s = None if src is None else torch.from_numpy(src)

    def refuse(*a, **k):
        raise AssertionError("radix_sort_plain called on a CUDA tensor")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kernels, "radix_sort_plain", refuse)
        before = kernels.LAUNCHES["radix_sort"]
        got = kernels.radix_sort(col.to(dev),
                                 None if s is None else s.to(dev))
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["radix_sort"] == before + (
            1 if x.shape[1] else 0)
    assert got.dtype == torch.int32 and got.shape == x.shape
    plain = kernels.radix_sort_plain(col.to(dev),
                                     None if s is None else s.to(dev))
    assert torch.equal(got, plain)
    cur = col if s is None else torch.gather(col, 1, s.long())
    want = torch.sort(cur, dim=1, stable=True).indices
    if s is not None:
        want = torch.gather(s.long(), 1, want)
    assert torch.equal(got.cpu().long(), want)


@pytest.mark.parametrize("cap", [0, 1, 4097, 2 ** 20 + 3])
@pytest.mark.parametrize("with_src", [False, True])
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float64])
def test_radix_sort_kernel_matches_plain(dev, dtype, with_src, cap):
    x = _column(dtype, cap, 1 + cap % 7)
    _check(dev, x, _perm(cap, 2) if with_src else None)


def test_radix_sort_kernel_one_shard_constant(dev):
    x = _column(np.int64, 50001, 3)
    x[1] = -7
    _check(dev, x)
    _check(dev, x, _perm(50001, 4))


def test_radix_sort_kernel_all_eight_digits(dev):
    rng = np.random.RandomState(5)
    x = rng.randint(-2 ** 63, 2 ** 63 - 1, (N, 70001), dtype=np.int64)
    img, _ = kernels.radix_key_image(torch.from_numpy(x))
    flags = [bool(((kernels.shard_bincount(kernels._digit(img, d), 256) > 0)
                   .sum(1) > 1).any()) for d in range(8)]
    assert kernels.radix_plan(flags) == (list(range(8)), 8)
    _check(dev, x)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_radix_sort_kernel_hot_digit(dev, dtype):
    """99% of the rows share every digit: one peer group fills a warp."""
    rng = np.random.RandomState(6)
    x = np.full((N, 200003), 12345, dtype)
    cold = rng.rand(N, 200003) < 0.01
    x[cold] = rng.randint(-10 ** 6, 10 ** 6, int(cold.sum()))
    _check(dev, x)
    _check(dev, x, _perm(200003, 7))


def test_radix_sort_kernel_float_specials(dev):
    """float64 with +-0.0, +-inf and NaN of both signs (and payloads): NaN
    last, -0.0 tied with +0.0, in input order."""
    rng = np.random.RandomState(8)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1.5,
                        -1.5])
    x = rng.choice(special, (N, 30011))
    x[0, ::7] = np.frombuffer(np.uint64(0x7FF0000000000123).tobytes(),
                              np.float64)[0]
    x[1, ::5] = np.frombuffer(np.uint64(0xFFF8000000000001).tobytes(),
                              np.float64)[0]
    _check(dev, x)
    _check(dev, x, _perm(30011, 9))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_radix_sort_kernel_narrow_range_through_src(dev, dtype):
    """Keys in [-1000, 1000) straddle zero: through src_idx K5 sorts them
    less each shard's least, in two digit passes (four or eight
    without); a shard of one hot value among them."""
    rng = np.random.RandomState(10)
    x = rng.randint(-1000, 1000, (N, 100003)).astype(dtype)
    x[2, ::2] = -1
    src = _perm(100003, 11)
    cur = torch.from_numpy(np.take_along_axis(x, src, 1))
    assert kernels.radix_sorted_image(cur, True)[1] == ([0, 1], 4)
    _check(dev, x, src)
