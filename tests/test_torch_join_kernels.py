"""The port's K12 (join_ranges, join_expand) on the CPU, where their plain
PyTorch versions run, against the jnp sequence they replace in the JAX
package's device join (dpark_tpu/backend/tpu/executor.py
device_join_batch: _key_ranges over jnp.searchsorted left and right for
one key column and collectives.lex_searchsorted for several, count_dev's
per-row counts and total, expand_dev's searchsorted of each output slot
into the inclusive offsets and its gathers), one shard at a time on the
same seeded numpy inputs: empty shards, one hot key, disjoint keys, float
keys with -0.0 and +0.0, int32 keys, vector and bool value leaves.  Every
comparison is exact: the join moves values and does no arithmetic.  The
kernels themselves run in the test marked `cuda`, on a card only
(`python -m pytest -m cuda tests/test_torch_join_kernels.py`)."""

import numpy as np
import pytest
import torch

from dpark_tpu_torch.backend.cuda import collectives, kernels

N = 4
KEY_KINDS = {"int64": [np.int64] * 4,
             "int32": [np.int32, np.int64, np.int32, np.int64],
             "float64": [np.float64, np.int64, np.float64, np.int32]}


@pytest.fixture(scope="module")
def jnp():
    import jax
    jax.config.update("jax_enable_x64", True)     # int64 keys stay int64
    import jax.numpy
    return jax.numpy


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _sent(dt):
    return np.inf if np.dtype(dt).kind == "f" else np.iinfo(dt).max


def _key_draw(rng, dt, size, domain):
    if np.dtype(dt).kind == "f":
        # both zeros: -0.0 must equal +0.0 (K5 ties them, as jnp does)
        v = rng.randint(-domain // 2, domain - domain // 2, size) * 0.5
        zero = v == 0
        v[zero & (rng.rand(size) < 0.5)] = -0.0
        return v.astype(dt)
    return rng.randint(-domain // 2, domain - domain // 2, size).astype(dt)


def _side(rng, nk, kind, cap, counts, domain, nvals, hot=None):
    """Key columns and value leaves of one side, each shard's valid
    prefix sorted lexicographically (stable; -0.0 ties +0.0), padding
    with the sentinel in key column 0 and zeros elsewhere."""
    dts = KEY_KINDS[kind][:nk]
    keys = [np.zeros((N, cap), dt) for dt in dts]
    keys[0][:] = _sent(dts[0])
    vals = [rng.randint(-1000, 1000, (N, cap)).astype(np.int64),
            rng.randn(N, cap, 3),
            rng.randint(0, 2, (N, cap)).astype(bool)][:nvals]
    for s in range(N):
        n = counts[s]
        cols = [_key_draw(rng, dt, n, domain) for dt in dts]
        if hot is not None and s == hot:
            cols = [np.full(n, 1, c.dtype) for c in cols]
        order = np.lexsort(cols[::-1])
        for c, col in zip(keys, cols):
            c[s, :n] = col[order]
    return keys, vals


def _case(seed, nk, kind, cap_a=24, cap_b=16, domain=6, empty_a=(1,),
          empty_b=(2,), hot=None):
    rng = np.random.RandomState(seed)
    a_n = np.array([0 if s in empty_a else rng.randint(1, cap_a + 1)
                    for s in range(N)], np.int32)
    b_n = np.array([0 if s in empty_b else rng.randint(1, cap_b + 1)
                    for s in range(N)], np.int32)
    if hot is not None:
        a_n[hot], b_n[hot] = cap_a, cap_b
    ak, av = _side(rng, nk, kind, cap_a, a_n, domain, 2, hot)
    bk, bv = _side(rng, nk, kind, cap_b, b_n, domain, 3, hot)
    return ak, av, a_n, bk, bv, b_n


def _ref_ranges(jnp, ak, a_n, bk, b_n, s, nk):
    """The reference's _key_ranges and count_dev for shard s."""
    from dpark_tpu.backend.tpu import collectives as ref
    cap_a, cap_b = ak[0].shape[1], bk[0].shape[1]
    sent = _sent(ak[0].dtype)
    A0 = jnp.where(jnp.arange(cap_a) < a_n[s], ak[0][s], sent)
    B0 = jnp.where(jnp.arange(cap_b) < b_n[s], bk[0][s], sent)
    if nk == 1:
        lo = jnp.searchsorted(B0, A0, side="left")
        hi = jnp.searchsorted(B0, A0, side="right")
    else:
        acols = [A0] + [jnp.asarray(k[s]) for k in ak[1:]]
        bcols = [B0] + [jnp.asarray(k[s]) for k in bk[1:]]
        lo = ref.lex_searchsorted(bcols, acols, "left")
        hi = ref.lex_searchsorted(bcols, acols, "right")
    per = jnp.where(jnp.arange(cap_a) < a_n[s], hi - lo, 0)
    return np.asarray(lo), np.asarray(per)


def _ref_expand(jnp, a_leaves, b_vals, lo, per, cap_out, s):
    """expand_dev's formula for shard s (valid slots only matter)."""
    cap_a, cap_b = a_leaves[0].shape[1], b_vals[0].shape[1]
    lo, per = jnp.asarray(lo), jnp.asarray(per)
    offs = jnp.cumsum(per) - per
    t = jnp.arange(cap_out)
    i = jnp.clip(jnp.searchsorted(offs + per, t, side="right"), 0,
                 cap_a - 1)
    j = t - offs[i]
    bi = jnp.clip(lo[i] + j, 0, cap_b - 1)
    return ([np.asarray(jnp.asarray(x[s])[i]) for x in a_leaves]
            + [np.asarray(jnp.asarray(x[s])[bi]) for x in b_vals])


def _check(jnp, ak, av, a_n, bk, bv, b_n, cap_out=None):
    nk = len(ak)
    lo, per, offs, totals = collectives.join_key_ranges(
        [_t(k) for k in ak], _t(a_n), [_t(k) for k in bk], _t(b_n))
    a_leaves, b_vals = ak + av, bv
    tot = totals.numpy()
    cap_out = cap_out or max(1, int(tot.max()))
    out = collectives.join_expand([_t(x) for x in a_leaves],
                                  [_t(x) for x in b_vals],
                                  (lo, per, offs, totals), _t(a_n), cap_out)
    assert [o.dtype for o in out] == [_t(x).dtype for x in a_leaves + b_vals]
    for s in range(N):
        want_lo, want_per = _ref_ranges(jnp, ak, a_n, bk, b_n, s, nk)
        valid = np.arange(ak[0].shape[1]) < a_n[s]
        assert np.array_equal(lo[s].numpy()[valid], want_lo[valid])
        assert np.array_equal(lo[s].numpy()[~valid], 0 * want_lo[~valid])
        assert np.array_equal(per[s].numpy(), want_per)
        assert np.array_equal(offs[s].numpy(),
                              np.cumsum(want_per) - want_per)
        assert tot[s] == want_per.sum()
        want = _ref_expand(jnp, a_leaves, b_vals, want_lo, want_per,
                           cap_out, s)
        n = int(tot[s])
        for k, (g, w) in enumerate(zip(out, want)):
            g = g[s].numpy()
            assert np.array_equal(g[:n], w[:n]), (s, k)
            pad = g[n:]
            if k == 0:
                assert np.all(pad == _sent(g.dtype)), (s, pad)
            else:
                assert not np.any(pad), (s, k)
    return tot


def _pairs(ak, av, a_n, bk, bv, b_n, s):
    """The nested-loop join of shard s as sorted (key, A value, B value)
    tuples (Python equality: -0.0 == +0.0)."""
    def rows(keys, vals, n):
        return [(tuple(float(k[s, r]) for k in keys), int(vals[0][s, r]))
                for r in range(n)]
    return sorted((ka, va, vb) for ka, va in rows(ak, av, a_n[s])
                  for kb, vb in rows(bk, bv, b_n[s]) if ka == kb)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", sorted(KEY_KINDS))
@pytest.mark.parametrize("nk", [1, 2, 4])
def test_join_plain_matches_reference(jnp, nk, kind, seed):
    case = _case(seed * 7 + nk, nk, kind, domain=6 if nk == 1 else 3)
    tot = _check(jnp, *case)
    ak, av, a_n, bk, bv, b_n = case
    out = collectives.join_expand(
        [_t(x) for x in ak + av], [_t(x) for x in bv],
        collectives.join_key_ranges([_t(k) for k in ak], _t(a_n),
                                    [_t(k) for k in bk], _t(b_n)),
        _t(a_n), max(1, int(tot.max())))
    for s in range(N):
        n = int(tot[s])
        got = sorted((tuple(float(o[s, r]) for o in out[:nk]),
                      int(out[nk][s, r]), int(out[nk + 2][s, r]))
                     for r in range(n))
        assert got == _pairs(ak, av, a_n, bk, bv, b_n, s)


@pytest.mark.parametrize("kind", sorted(KEY_KINDS))
def test_join_hot_key(jnp, kind):
    """One key on every row of one shard on both sides: cap_a x cap_b
    pairs from one A range, spread over every output slot."""
    tot = _check(jnp, *_case(11, 1, kind, cap_a=64, cap_b=48, hot=3,
                             empty_a=(), empty_b=()))
    assert tot[3] == 64 * 48


def test_join_empty_and_disjoint(jnp):
    """Every shard empty, one side empty, disjoint keys: total 0, every
    slot padding."""
    ak, av, a_n, bk, bv, b_n = _case(5, 2, "int64")
    zeros = np.zeros(N, np.int32)
    assert not _check(jnp, ak, av, zeros, bk, bv, zeros, cap_out=8).any()
    assert not _check(jnp, ak, av, a_n, bk, bv, zeros, cap_out=8).any()
    assert not _check(jnp, ak, av, zeros, bk, bv, b_n, cap_out=8).any()
    far = [k.copy() for k in bk]
    far[0][:, :] = np.where(np.arange(bk[0].shape[1])[None, :]
                            < b_n[:, None], 100, far[0])
    assert not _check(jnp, ak, av, a_n, far, bv, b_n, cap_out=8).any()


def test_join_padding_past_total(jnp):
    """An output wider than the largest total: the extra slots are
    padding on every shard."""
    _check(jnp, *_case(9, 1, "float64"), cap_out=512)


def test_join_wrappers_refuse_bad_inputs():
    ak, av, a_n, bk, bv, b_n = _case(1, 1, "int64")
    with pytest.raises(ValueError, match="same dtype"):
        kernels.join_ranges([_t(ak[0])], _t(a_n),
                            [_t(bk[0].astype(np.int32))], _t(b_n))
    with pytest.raises(ValueError, match="key columns"):
        kernels.join_ranges([_t(ak[0])] * 5, _t(a_n), [_t(bk[0])] * 5,
                            _t(b_n))
    r = kernels.join_ranges([_t(ak[0])], _t(a_n), [_t(bk[0])], _t(b_n))
    with pytest.raises(ValueError, match="at most"):
        kernels.join_expand([_t(ak[0])] + [_t(av[0])] * 15,
                            [_t(bv[0])] * 2, *r, _t(a_n), 8)


@pytest.mark.cuda
def test_join_kernels_match_plain_on_card():
    """K12 launched on the card equals its plain version bit for bit
    (ranges, offsets, totals, every output leaf), each entry point's
    launch counted once a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    cases = [_case(s * 7 + nk, nk, kind, domain=6 if nk == 1 else 3)
             for s in range(2) for nk in (1, 2, 4)
             for kind in sorted(KEY_KINDS)]
    cases.append(_case(11, 1, "float64", cap_a=64, cap_b=48, hot=3,
                       empty_a=(), empty_b=()))
    for ak, av, a_n, bk, bv, b_n in cases:
        cpu = ([_t(k) for k in ak], _t(a_n), [_t(k) for k in bk], _t(b_n))
        gpu = ([k.to(dev) for k in cpu[0]], cpu[1].to(dev),
               [k.to(dev) for k in cpu[2]], cpu[3].to(dev))
        before = dict(kernels.LAUNCHES)
        got = kernels.join_ranges(*gpu)
        want = kernels.join_ranges_plain(*cpu)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
        cap_out = max(1, int(want[3].max())) + 5
        a_leaves = [_t(x) for x in ak + av]
        b_vals = [_t(x) for x in bv]
        got_out = kernels.join_expand(
            [x.to(dev) for x in a_leaves], [x.to(dev) for x in b_vals],
            *got, gpu[1], cap_out)
        want_out = kernels.join_expand_plain(a_leaves, b_vals, *want,
                                             cpu[1], cap_out)
        for g, w in zip(got_out, want_out):
            assert torch.equal(g.cpu(), w)
        assert kernels.LAUNCHES["join_ranges"] == before["join_ranges"] + 1
        assert kernels.LAUNCHES["join_expand"] == before["join_expand"] + 1


def test_k12_tile_matches_source():
    """The wrapper sizes K12's status words by kernels._K12_TILE: it must
    be the source's K12_THREADS x K12_ITEMS."""
    import os
    import re
    src = open(os.path.join(kernels.CSRC, "join_expand.cu")).read()

    def define(name):
        return int(re.search(r"(?m)^#define %s (\d+)" % name, src).group(1))
    assert kernels._K12_TILE == define("K12_THREADS") * define("K12_ITEMS")


# ---------------------------------------------------------------------
# K12's ranges on the card: the one-sweep merge against the plain version
# ---------------------------------------------------------------------
K12_TILE = 2048          # kernels._K12_TILE, held to the source above
K12_WINDOW = 4096        # B rows of one int64 key in the shared window


def _sorted_cols(cols, n):
    """Each shard's first n[s] rows of `cols` ((N, cap) numpy key columns)
    sorted lexicographically in K5's order (-0.0 ties +0.0, NaN one value,
    last), the rest left as they are."""
    cols = [c.copy() for c in cols]
    for s in range(cols[0].shape[0]):
        m = int(n[s])
        order_keys = [kernels._order_key(torch.from_numpy(
            np.ascontiguousarray(c[s:s + 1, :m])))[0].numpy() for c in cols]
        order = np.lexsort(order_keys[::-1])
        for c in cols:
            c[s, :m] = c[s, :m][order]
    return cols


def _draw(rng, dt, shape, domain, specials=True):
    """Keys of dtype dt over `domain` values; float keys with -0.0, +0.0
    and NaN among them."""
    v = rng.randint(0, domain, shape)
    if np.dtype(dt).kind != "f":
        return (v - domain // 2).astype(dt)
    v = (v - domain // 2) * 0.5
    if specials:
        u = rng.rand(*shape)
        v[u < 0.05] = -0.0
        v[(u >= 0.05) & (u < 0.1)] = 0.0
        v[(u >= 0.1) & (u < 0.13)] = np.nan
    return v.astype(dt)


def _ranges_case(seed, dts, N_, cap_a, cap_b, a_n, b_n, da, db):
    rng = np.random.RandomState(seed)
    ak = _sorted_cols([_draw(rng, dt, (N_, cap_a), da) for dt in dts], a_n)
    bk = _sorted_cols([_draw(rng, dt, (N_, cap_b), db) for dt in dts], b_n)
    return ak, np.asarray(a_n, np.int32), bk, np.asarray(b_n, np.int32)


def _k12_cases():
    """(id, maker) of the card's K12 ranges cases."""
    full = [3000, 0, 4100, 2900]

    def mixed(dts):
        d = {1: 40, 2: 8, 4: 3}[len(dts)]
        return lambda: _ranges_case(7 + len(dts), dts, 4, 4100, 3000, full,
                                    [2500, 3000, 0, 1700], d, d)
    yield "nk1-float64", mixed([np.float64])
    yield "nk2-int32-float64", mixed([np.int32, np.float64])
    yield "nk4-int64-float64-int32-float64", mixed(
        [np.int64, np.float64, np.int32, np.float64])
    # dense A over a sparse B: narrow windows, many A rows a B key
    yield "dense-a-sparse-b", lambda: _ranges_case(
        3, [np.int64], 3, 3 * K12_TILE + 17, 300, [3 * K12_TILE + 17] * 3,
        [300, 17, 0], 2000, 2000)

    # a sparse A over a dense B: every window past the shared memory
    def sparse():
        N_, cap_b, stride = 2, 1 << 17, 97
        b = np.arange(N_ * cap_b, dtype=np.int64).reshape(N_, cap_b)
        cap_a = cap_b // stride + 5
        a = np.full((N_, cap_a), np.iinfo(np.int64).max, np.int64)
        a[:, :cap_a - 5] = b[:, ::stride][:, :cap_a - 5] + 1
        return [a], np.array([cap_a - 5, cap_a - 5], np.int32), [b], \
            np.array([cap_b, cap_b - 3], np.int32)
    yield "sparse-a-dense-b", sparse

    # one hot key on both sides, inside the shared window and past it
    def hot(rows_b):
        def make():
            a = np.full((2, 6000), 7, np.int64)
            b = np.full((2, rows_b), 7, np.int64)
            return [a], np.array([6000, 1], np.int32), [b], \
                np.array([rows_b, rows_b], np.int32)
        return make
    yield "hot-key-in-window", hot(K12_WINDOW - 1)
    yield "hot-key-past-window", hot(K12_WINDOW + 905)

    # disjoint sides: A below B on one shard, above it on the next
    def disjoint():
        a = np.stack([np.arange(5000), np.arange(5000) + 10 ** 6])
        b = np.stack([np.arange(3000) + 10 ** 5, np.arange(3000)])
        return [a.astype(np.int64)], np.array([5000, 5000], np.int32), \
            [b.astype(np.int64)], np.array([3000, 3000], np.int32)
    yield "disjoint", disjoint
    # an empty shard on each side and a full one, caps off the tile
    yield "empty-and-full-shards", lambda: _ranges_case(
        5, [np.int32], 3, 2 * K12_TILE + 1, 999, [0, 2 * K12_TILE + 1, 40],
        [999, 0, 999], 500, 500)
    # enough tiles a shard that the look-back crosses many of them
    yield "many-tiles", lambda: _ranges_case(
        9, [np.int64], 2, 300 * K12_TILE + 3, 50_000,
        [300 * K12_TILE + 3, 123_457], [50_000, 49_999], 60_000, 60_000)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c, _ in _k12_cases()])
def test_join_ranges_cases_on_card(case):
    """K12's ranges (lo, per, offs, totals) launched on the card equal
    the plain version exactly over the shapes its tiles and windows
    meet; one launch counted a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    ak, a_n, bk, b_n = dict(_k12_cases())[case]()
    cpu = ([_t(k) for k in ak], _t(a_n), [_t(k) for k in bk], _t(b_n))
    gpu = [[k.to(dev) for k in cpu[0]], cpu[1].to(dev),
           [k.to(dev) for k in cpu[2]], cpu[3].to(dev)]
    before = kernels.LAUNCHES["join_ranges"]
    got = kernels.join_ranges(*gpu)
    want = kernels.join_ranges_plain(*cpu)
    assert kernels.LAUNCHES["join_ranges"] == before + 1
    for name, g, w in zip(("lo", "per", "offs", "totals"), got, want):
        assert torch.equal(g.cpu(), w), name
    assert torch.equal(kernels.join_ranges(*gpu)[2].cpu(), want[2])
