"""K3's plain version (reduce_by_key_compact) through the port's callers
against the JAX package's reference on the same inputs.

The reduce side (collectives.segment_reduce_keys: the key sort, then K3
through _merge_runs) against the reference's segment_reduce_keys, and
the map side (bucketize_combine_keys: K1's destination, the sort, then K3
with the destination column) against the reference's
bucketize_combine_keys, at the one-sweep kernel's edge shapes (its tile
is kernels._K3_TILE = 6,144 rows): runs inside one tile, runs spanning
two tiles, one run filling a whole shard across many tiles, every row
distinct; a full shard (n = cap), a ragged one and an empty one; cap not
a multiple of the tile.  Op "last" is the non-monoid route: the
segmented scan of an add merge leaves each run's total at its last row
and K3 keeps those rows.  The JAX functions work on one device's block,
so the reference side loops over shards.  Integers must be bit-equal;
floats match within rtol 1e-12, the tolerance of
tests/test_torch_collectives.py (float sums in another association); a
NaN must stand where the reference has one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dpark_tpu.backend.tpu import collectives as ref
from dpark_tpu_torch.backend.cuda import collectives as col
from dpark_tpu_torch.backend.cuda import fuse, kernels

jax.config.update("jax_enable_x64", True)     # int64 keys stay int64

FLOAT_RTOL = 1e-12
TILE = kernels._K3_TILE
N = 3
CAP = 2 * TILE + 5                # not a multiple of the tile
CAP_MANY = 4 * TILE + 3           # one run across five tiles
PATTERNS = ["within", "two", "many", "distinct"]
OPS = ["add", "min", "max", "mul", "last"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jadd(va, vb):
    return [a + b for a, b in zip(va, vb)]


def _cap(pattern):
    return CAP_MANY if pattern == "many" else CAP


def _keys(pattern, cap, nk, dtype, rng):
    """Unsorted key columns whose sort gives the pattern's runs: about 64
    rows a run ("within" one tile), about a tile a run ("two": runs
    spanning two tiles), one run a shard ("many" tiles), every row
    distinct.  A second column splits "within"'s runs in two."""
    if pattern == "within":
        k0 = rng.randint(0, cap // 128, (N, cap))
    elif pattern == "two":
        k0 = rng.randint(0, 2, (N, cap))
    elif pattern == "many":
        k0 = np.full((N, cap), 7)
    else:
        k0 = np.stack([rng.permutation(cap) for _ in range(N)]) - cap // 2
    cols = [k0.astype(dtype)]
    if nk > 1:
        k1 = (rng.randint(0, 2, (N, cap)) if pattern == "within"
              else np.zeros((N, cap), np.int64))
        cols.append(k1.astype(dtype))
    return cols


def _n(cap):
    return np.array([cap, cap // 2 + 3, 0], np.int32)  # full, ragged, empty


def _vals(op, dtype, W, cap, rng):
    shape = (N, cap) if W == 1 else (N, cap, W)
    if dtype == np.float64:
        return rng.standard_normal(shape)
    if op == "mul":
        return rng.randint(-3, 4, shape).astype(np.int64)
    return rng.randint(-50, 50, shape).astype(np.int64)


def _monoid(op):
    return None if op == "last" else op


def _merges(op, nk):
    """The port's and the reference's merge for op ("last": an add merge
    on the non-monoid route)."""
    if op != "last":
        return None, None
    key = 0 if nk == 1 else tuple(range(nk))
    return fuse._leaves_merge_fn(lambda a, b: a + b, (key, nk)), _jadd


def _with_sentinel(keys, n):
    """Key column 0 holds its dtype's max past n[s] (the padding rows'
    key on both packages)."""
    k0 = keys[0].copy()
    sent = np.iinfo(k0.dtype).max
    k0[np.arange(k0.shape[1])[None, :] >= n[:, None]] = sent
    return [k0] + keys[1:]


def _same(got, want, floats):
    if floats:
        np.testing.assert_allclose(got, want, rtol=FLOAT_RTOL)
        assert np.array_equal(np.isnan(got), np.isnan(want))
    else:
        assert got.dtype == want.dtype and np.array_equal(got, want)


def _check_reduce(keys, vals, n, op):
    """segment_reduce_keys on both packages, shard by shard."""
    nk = len(keys)
    cap = keys[0].shape[1]
    pmerge, jmerge = _merges(op, nk)
    ks, vs, nu = col.segment_reduce_keys([_t(k) for k in keys],
                                         [_t(v) for v in vals], _t(n),
                                         pmerge, monoid=_monoid(op))
    jref = jax.jit(lambda kc, vc, m: ref.segment_reduce_keys(
        kc, vc, m, jmerge, monoid=_monoid(op)))
    for s in range(N):
        wk, wv, wn = jref([jnp.asarray(k[s]) for k in keys],
                          [jnp.asarray(v[s]) for v in vals],
                          jnp.arange(cap) < n[s])
        m = int(wn)
        assert int(nu[s]) == m
        for g, w in zip(ks, wk):         # the sentinel past n_unique too
            assert np.array_equal(g[s].numpy(), np.asarray(w))
        for g, w in zip(vs, wv):
            _same(g[s].numpy()[:m], np.asarray(w)[:m],
                  g.dtype == torch.float64)
            assert not g[s].numpy()[m:].any()   # zero values past it


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("kdt", [np.int32, np.int64])
def test_segment_reduce_keys_matches_reference(op, pattern, kdt):
    cap = _cap(pattern)
    rng = np.random.RandomState(OPS.index(op) * 10 + PATTERNS.index(pattern))
    n = _n(cap)
    nk = 2 if pattern in ("within", "many") else 1
    keys = _with_sentinel(_keys(pattern, cap, nk, kdt, rng), n)
    W = 3 if pattern == "distinct" and op != "last" else 1
    _check_reduce(keys, [_vals(op, np.int64, W, cap, rng)], n, op)


# the add merge of "last" takes scalar leaves (its vector leaves are
# the monoid tests' W = 3)
@pytest.mark.parametrize("op,W", [(op, W) for op in OPS for W in (1, 3)
                                  if op != "last" or W == 1])
def test_segment_reduce_keys_float_values(op, W):
    rng = np.random.RandomState(50 + OPS.index(op) + W)
    n = _n(CAP)
    keys = _with_sentinel(_keys("two", CAP, 1, np.int64, rng), n)
    _check_reduce(keys, [_vals(op, np.float64, W, CAP, rng)], n, op)


def _nan_rows(keys, n, where, rng):
    """Float values with NaN at the first, a middle or the last row of
    every third run of the sorted order, a -0.0 and a 0.0 elsewhere in
    runs; returned unsorted in the keys' row order."""
    N_, cap = keys[0].shape
    v = rng.standard_normal((N_, cap))
    for s in range(N_):
        order = np.argsort(keys[0][s], kind="stable")
        ks = keys[0][s][order]
        starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
        ends = np.r_[starts[1:], cap] - 1
        for r, (a, b) in enumerate(zip(starts, ends)):
            if r % 3 == 0:
                row = {"first": a, "middle": (a + b) // 2, "last": b}[where]
                v[s, order[row]] = np.nan
            elif r % 3 == 1 and b > a:
                v[s, order[a]] = -0.0
                v[s, order[a + 1]] = 0.0
    return v


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("where", ["first", "middle", "last"])
@pytest.mark.parametrize("pattern", ["within", "two"])
def test_nan_and_signed_zero_under_min_max(op, where, pattern):
    """NaN wherever it stands in a run gives NaN (runs inside one tile and
    across two), as the reference's segment_min / segment_max; -0.0 and
    0.0 compare equal."""
    rng = np.random.RandomState(70)
    n = np.array([CAP, CAP, CAP - 11], np.int32)
    keys = _with_sentinel(_keys(pattern, CAP, 1, np.int64, rng), n)
    _check_reduce(keys, [_nan_rows(keys, n, where, rng)], n, op)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("pattern", PATTERNS)
def test_bucketize_combine_keys_matches_reference(op, pattern):
    """The map side with K3's destination column: counts, offsets and the
    packed (dst, key) rows."""
    cap = _cap(pattern)
    rng = np.random.RandomState(90 + OPS.index(op) * 10
                                + PATTERNS.index(pattern))
    n = _n(cap)
    keys = _keys(pattern, cap, 1, np.int64, rng)
    vals = [_vals(op, np.int64, 1, cap, rng)]
    pmerge, jmerge = _merges(op, 1)
    ks, vs, counts, offs = col.bucketize_combine_keys(
        [_t(k) for k in keys], [_t(v) for v in vals], _t(n), N, pmerge,
        monoid=_monoid(op))
    jref = jax.jit(lambda kc, vc, ns: ref.bucketize_combine_keys(
        kc, vc, ns, N, jmerge, monoid=_monoid(op)))
    for s in range(N):
        wk, wv, wc, wo = jref([jnp.asarray(k[s]) for k in keys],
                              [jnp.asarray(v[s]) for v in vals], int(n[s]))
        assert np.array_equal(counts[s].numpy(), np.asarray(wc))
        assert np.array_equal(offs[s].numpy(), np.asarray(wo))
        tot = int(np.asarray(wc).sum())
        assert np.array_equal(ks[0][s].numpy()[:tot], np.asarray(wk[0])[:tot])
        assert (ks[0][s].numpy()[tot:] == np.iinfo(np.int64).max).all()
        assert np.array_equal(vs[0][s].numpy()[:tot], np.asarray(wv[0])[:tot])


def test_plain_dst_counts_and_fills_at_tile_edges():
    """K3's plain version called directly at n = cap = a tile, a tile + 1
    and one row, with the destination column: counts and offsets, the
    key fills and zero values past n_unique, against a Python fold."""
    rng = np.random.RandomState(110)
    for cap in (TILE, TILE + 1, 1):
        d = np.sort(rng.randint(0, 9, (N, cap)), 1).astype(np.int32)
        k = rng.randint(0, 3, (N, cap)).astype(np.int64)
        o = np.lexsort((k, d), axis=1)
        d, k = np.take_along_axis(d, o, 1), np.take_along_axis(k, o, 1)
        v = rng.randint(-9, 9, (N, cap)).astype(np.int64)
        n = np.array([cap, cap, 0], np.int32)
        ko, vo, nu, dc, do = kernels.reduce_by_key_compact(
            [_t(d), _t(k)], [9, -1], [_t(v)], _t(n), "add", 0, 9)
        for s in range(N):
            runs = {}
            for i in range(n[s]):
                runs[(d[s, i], k[s, i])] = runs.get((d[s, i], k[s, i]),
                                                    0) + v[s, i]
            got = sorted(runs)
            m = len(got)
            assert int(nu[s]) == m
            assert ko[0][s].tolist() == [a for a, _ in got] + [9] * (cap - m)
            assert ko[1][s].tolist() == [b for _, b in got] + [-1] * (cap - m)
            assert vo[0][s].tolist() == [runs[x] for x in got] + [0] * (
                cap - m)
            want = np.bincount([a for a, _ in got], minlength=9)
            assert dc[s].tolist() == want.tolist()
            assert do[s].tolist() == (np.cumsum(want) - want).tolist()
