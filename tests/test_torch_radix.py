"""The port's K5 (radix_sort) and K6 (range_dst_hist) kernels on the CPU,
where their plain PyTorch versions run, against the JAX package's
functions on the same numpy inputs (and against torch.sort).

K5's plain version repeats the kernel's key image and digit skipping, so
these tests cover the float transform (-0.0, NaN, infinities), the
integer sign flip and the skip logic, where the kernel can be wrong
without a card.  Every comparison is exact: a permutation and a
destination are integers, and the float inputs are compared, never
computed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dpark_tpu.backend.tpu import collectives as ref
from dpark_tpu_torch.backend.cuda import collectives as col
from dpark_tpu_torch.backend.cuda import kernels

jax.config.update("jax_enable_x64", True)     # int64 keys stay int64

N, CAP = 3, 300


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _column(dtype, seed, subnormal=False):
    """(N, CAP) keys with many ties, negatives and the type's extremes;
    floats add -0.0/+0.0, both infinities and NaNs of both signs (and,
    on request, subnormals: XLA on the CPU flushes them to zero when it
    compares, so jnp.argsort ties them with 0.0 where torch.sort and
    numpy do not)."""
    rng = np.random.RandomState(seed)
    if dtype == np.float64:
        x = rng.randint(-20, 20, (N, CAP)) * 0.5
        special = [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan,
                   np.finfo(np.float64).max, -np.finfo(np.float64).max,
                   np.finfo(np.float64).tiny, -np.finfo(np.float64).tiny]
        if subnormal:
            special += [5e-324, -5e-324]
    else:
        info = np.iinfo(dtype)
        x = rng.randint(-50, 50, (N, CAP))
        special = [info.min, info.max, info.min + 1, info.max - 1, 0, -1]
    x = x.astype(dtype)
    pos = rng.randint(0, CAP, (N, 40))
    for s in range(N):
        x[s, pos[s]] = rng.choice(np.array(special, dtype=dtype), 40)
    return x


def _perm(seed):
    rng = np.random.RandomState(seed)
    return np.stack([rng.permutation(CAP) for _ in range(N)]).astype(
        np.int32)


@pytest.mark.parametrize("with_src", [False, True])
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float64])
def test_radix_sort_plain_matches_stable_argsort(dtype, with_src):
    x = _column(dtype, 1)
    src = _perm(2) if with_src else None
    got = kernels.radix_sort(_t(x), None if src is None else _t(src))
    assert got.dtype == torch.int32 and got.shape == (N, CAP)
    for s in range(N):
        cur = x[s] if src is None else x[s][src[s]]
        ident = np.arange(CAP) if src is None else src[s]
        want_j = ident[np.asarray(jnp.argsort(jnp.asarray(cur),
                                              stable=True))]
        want_t = ident[torch.sort(_t(cur), stable=True).indices.numpy()]
        assert np.array_equal(got[s].numpy(), want_j)
        assert np.array_equal(got[s].numpy(), want_t)


def test_radix_key_image_is_order_preserving():
    """Sorting the unsigned image equals sorting the floats (NaN last,
    -0.0 tied with +0.0, subnormals in place), and equal keys map to one
    image."""
    x = _column(np.float64, 3, subnormal=True)
    img, ndig = kernels.radix_key_image(_t(x))
    assert ndig == 8
    u = img.numpy().view(np.uint64)
    got = kernels.radix_sort(_t(x))
    for s in range(N):
        want = np.argsort(x[s], kind="stable")
        assert np.array_equal(np.argsort(u[s], kind="stable"), want)
        assert np.array_equal(got[s].numpy(), want)
        assert np.array_equal(
            got[s].numpy(), torch.sort(_t(x[s]), stable=True).indices)
    zeros = img[_t(x) == 0]
    nans = img[torch.isnan(_t(x))]
    assert zeros.unique().numel() == 1 and nans.unique().numel() == 1


def _active(x):
    img, ndig = kernels.radix_key_image(_t(x))
    return [d for d in range(ndig)
            if bool(((kernels.shard_bincount(kernels._digit(img, d), 256)
                      > 0).sum(1) > 1).any())]


def test_radix_sort_skips_digits_all_rows_agree_on():
    rng = np.random.RandomState(5)
    bench = rng.randint(0, 1 << 16, (N, CAP)).astype(np.int64)
    assert _active(bench) == [0, 1]            # bench.py's keys: 2 passes
    # a digit uniform in one shard but not in another still runs
    mixed = bench.copy()
    mixed[1] += 1 << 40
    mixed[1, 0] = 5
    assert _active(mixed) == [0, 1, 5]
    # negative int32 keys differ from non-negative ones in every digit
    assert _active(rng.randint(-9, 9, (N, CAP)).astype(np.int32)) \
        == [0, 1, 2, 3]
    for x in (bench, mixed):
        got = kernels.radix_sort(_t(x))
        for s in range(N):
            assert np.array_equal(got[s].numpy(),
                                  np.argsort(x[s], kind="stable"))


def test_radix_sort_constant_column_is_the_identity():
    x = np.full((N, CAP), -7, np.int64)
    src = _perm(6)
    assert _active(x) == []
    assert np.array_equal(kernels.radix_sort(_t(x)).numpy(),
                          np.tile(np.arange(CAP), (N, 1)))
    assert np.array_equal(kernels.radix_sort(_t(x), _t(src)).numpy(), src)


def test_radix_sort_refuses_other_dtypes():
    with pytest.raises(ValueError):
        kernels.radix_sort(torch.zeros((2, 4), dtype=torch.float32))
    with pytest.raises(ValueError):
        kernels.radix_sort(torch.zeros((2, 4), dtype=torch.int64),
                           torch.zeros((2, 4), dtype=torch.int64))


@pytest.mark.parametrize("flags,want", [
    ([True] * 8, (list(range(8)), 8)),
    ([True, True] + [False] * 6, ([0, 1], 4)),
    ([False] * 3 + [True] + [False] * 4, ([3], 4)),
    ([False] * 4 + [True] + [False] * 3, ([4], 8)),
    ([True] + [False] * 6 + [True], ([0, 7], 8)),
    ([False] * 8, ([], 4)),
    ([True] * 4, ([0, 1, 2, 3], 4)),           # an int32 key
    ([False, False, True, False], ([2], 4)),
])
def test_radix_plan_skips_digits_and_narrows_the_image(flags, want):
    assert kernels.radix_plan(flags) == want


def _plan_of(x):
    img, ndig = kernels.radix_key_image(_t(x))
    return kernels.radix_plan(
        [bool(((kernels.shard_bincount(kernels._digit(img, d), 256) > 0)
               .sum(1) > 1).any()) for d in range(ndig)])


def _low_digits(rng):
    """int64 keys whose active digits lie in the low four bytes: a large
    constant high part, negative in one shard."""
    x = rng.randint(0, 1 << 20, (N, CAP)).astype(np.int64) + (1 << 40)
    x[2] -= 3 << 40
    return x


def _one_high_digit(rng):
    return rng.randint(-128, 128, (N, CAP)).astype(np.int64) << 56


def _one_row_differs(rng):
    """every row shares every digit but one row of one shard, in one
    digit"""
    x = np.full((N, CAP), 0x0102030405060708, np.int64)
    x[1, 123] += 5 << 16
    return x


def _cap_one(rng):
    return rng.randint(-9, 9, (N, 1)).astype(np.int64)


def _ragged_cap(rng):
    """a cap that is not a multiple of any tile (the plain version's 64
    rows, the kernel's 2,048 to 6,144), every digit active"""
    return rng.randint(-2 ** 63, 2 ** 63 - 1, (N, 4097), dtype=np.int64)


@pytest.mark.parametrize("with_src", [False, True])
@pytest.mark.parametrize("make,plan", [
    (_low_digits, ([0, 1, 2], 4)),
    (_one_high_digit, ([7], 8)),
    (_one_row_differs, ([2], 4)),
    (_cap_one, ([], 4)),
    (_ragged_cap, (list(range(8)), 8)),
])
def test_radix_sort_plain_plan_cases(make, plan, with_src):
    """The image width and digit skipping of radix_plan on the cases that
    choose them, and radix_sort_plain (through radix_sort on the CPU) held
    to jnp.argsort(stable=True) and torch.sort(stable=True)."""
    rng = np.random.RandomState(40)
    x = make(rng)
    n, cap = x.shape
    src = (np.stack([rng.permutation(cap) for _ in range(n)]).astype(
        np.int32) if with_src else None)
    cur = x if src is None else np.take_along_axis(x, src, 1)
    assert _plan_of(cur) == plan
    got = kernels.radix_sort(_t(x), None if src is None else _t(src))
    plain = kernels.radix_sort_plain(_t(x), None if src is None
                                     else _t(src))
    assert torch.equal(got, plain)
    for s in range(n):
        ident = np.arange(cap) if src is None else src[s]
        want_j = ident[np.asarray(jnp.argsort(jnp.asarray(cur[s]),
                                              stable=True))]
        want_t = ident[torch.sort(_t(cur[s]), stable=True).indices.numpy()]
        assert np.array_equal(got[s].numpy(), want_j)
        assert np.array_equal(got[s].numpy(), want_t)


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float64])
def test_radix_sort_plain_relative_image_through_src(dtype):
    """Through src_idx the image is taken less each shard's least: keys in
    [-1000, 1000) straddle zero and need every digit as they are, but two
    digits relative; the order is jnp.argsort's and torch.sort's."""
    rng = np.random.RandomState(41)
    x = rng.randint(-1000, 1000, (N, CAP)).astype(dtype)
    if dtype == np.float64:
        x = x / 8.0
    x[1, ::3] = x[1, 0]
    src = np.stack([rng.permutation(CAP) for _ in range(N)]).astype(
        np.int32)
    cur = np.take_along_axis(x, src, 1)
    ndig = 4 if dtype == np.int32 else 8
    assert kernels.radix_sorted_image(_t(cur), False)[1] == (
        list(range(ndig)), ndig)
    if dtype != np.float64:
        assert kernels.radix_sorted_image(_t(cur), True)[1] == ([0, 1], 4)
    got = kernels.radix_sort(_t(x), _t(src))
    assert torch.equal(got, kernels.radix_sort_plain(_t(x), _t(src)))
    for s in range(N):
        want_j = src[s][np.asarray(jnp.argsort(jnp.asarray(cur[s]),
                                               stable=True))]
        want_t = src[s][torch.sort(_t(cur[s]), stable=True).indices.numpy()]
        assert np.array_equal(got[s].numpy(), want_j)
        assert np.array_equal(got[s].numpy(), want_t)


@pytest.mark.parametrize("nb0", [None, 3])
def test_lex_sort_matches_reference_mixed_key_types(nb0):
    """The port's _lex_sort (K5 passes, K2 last with nb0) against the
    reference's on float64, int64 and int32 keys with ties."""
    rng = np.random.RandomState(7)
    ops = [rng.randint(0, 3, (N, CAP)).astype(np.int32),
           _column(np.float64, 8),
           rng.randint(-3, 3, (N, CAP)).astype(np.int64),
           rng.randint(-4, 4, (N, CAP)).astype(np.int32),
           rng.standard_normal((N, CAP, 2))]
    got = col._lex_sort([_t(o) for o in ops], 4, nb0=nb0)
    if nb0 is not None:
        counts = got[-1]
        got = got[:-1]
    for s in range(N):
        want = ref._lex_sort(tuple(jnp.asarray(o[s]) for o in ops), 4)
        for g, w in zip(got, want):
            assert np.array_equal(g[s].numpy(), np.asarray(w),
                                  equal_nan=g.is_floating_point())
        if nb0 is not None:
            assert np.array_equal(counts[s].numpy(),
                                  np.bincount(ops[0][s], minlength=nb0))


def _range_inputs(nk, m, floats, seed):
    rng = np.random.RandomState(seed)
    if floats:
        keys = [rng.randint(-8, 8, (N, CAP)) * 0.25 for _ in range(nk)]
        pool = np.unique(rng.randint(-8, 8, (4 * m + 4, nk)) * 0.25, axis=0)
    else:
        keys = [rng.randint(-8, 8, (N, CAP)).astype(np.int64)
                for _ in range(nk)]
        pool = np.unique(rng.randint(-8, 8, (4 * m + 4, nk)), axis=0)
    # sorted distinct bound rows (lexicographic), some equal to keys
    bounds = pool[np.sort(rng.choice(len(pool), min(m, len(pool)),
                                     replace=False))]
    n = rng.randint(CAP // 3, CAP + 1, N).astype(np.int32)
    return keys, np.ascontiguousarray(bounds), n


@pytest.mark.parametrize("floats", [False, True])
@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("nk,m", [(1, 7), (2, 5), (3, 3), (1, 0), (2, 0)])
def test_range_dst_hist_plain_matches_reference(nk, m, ascending, floats):
    keys, bounds, n = _range_inputs(nk, m, floats, 10 + nk + m)
    r = len(bounds) + 1
    n_dst = 8
    dst, hist = col.range_dst_cols([_t(k) for k in keys], _t(bounds),
                                   ascending, n_dst, _t(n), r)
    for s in range(N):
        valid = jnp.arange(CAP) < n[s]
        if nk == 1:
            want = ref.range_dst(jnp.asarray(keys[0][s]),
                                 jnp.asarray(bounds[:, 0]), ascending,
                                 n_dst, valid, r=r)
        elif m == 0:
            # the reference's lex_searchsorted cannot gather from empty
            # bounds; bisect_left into no bounds is 0
            want = jnp.where(valid, 0 if ascending else r - 1, n_dst)
        else:
            want = ref.range_dst_cols(
                [jnp.asarray(k[s]) for k in keys],
                [jnp.asarray(bounds[:, c]) for c in range(nk)], ascending,
                n_dst, valid, r=r)
        want = np.asarray(want)
        assert np.array_equal(dst[s].numpy(), want)
        assert np.array_equal(hist[s].numpy(),
                              np.bincount(want, minlength=n_dst + 1))
    if m == 0:        # empty bounds: one partition
        assert set(np.unique(dst.numpy())) <= {0, n_dst}


@pytest.mark.parametrize("nk", [1, 2, 3])
def test_lex_searchsorted_matches_reference(nk):
    keys, bounds, _ = _range_inputs(nk, 6, False, 30 + nk)
    got = col.lex_searchsorted([_t(bounds[:, c]) for c in range(nk)],
                               [_t(k) for k in keys])
    for s in range(N):
        want = ref.lex_searchsorted(
            [jnp.asarray(bounds[:, c]) for c in range(nk)],
            [jnp.asarray(k[s]) for k in keys])
        assert np.array_equal(got[s].numpy(), np.asarray(want))
        # and Python's bisect_left over tuples
        import bisect
        rows = [tuple(b) for b in bounds.tolist()]
        for j in range(0, CAP, 37):
            q = tuple(int(k[s, j]) for k in keys)
            assert int(got[s, j]) == bisect.bisect_left(rows, q)
