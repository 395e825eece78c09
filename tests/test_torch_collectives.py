"""The port's shuffle primitives (on the CPU: the plain versions of the
K1-K4 kernels) against the JAX package's collectives on the same inputs.

The JAX functions work on one device's block, so the reference side
loops over shards; its exchange runs inside shard_map on a 2-device CPU
mesh.  Integers must be bit-identical; float sums match within rtol
1e-12 (the reference's scatter order is not a contract).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dpark_tpu.backend.tpu import collectives as ref
from dpark_tpu_torch.backend.cuda import collectives as col
from dpark_tpu_torch.backend.cuda import fuse, kernels, layout

jax.config.update("jax_enable_x64", True)     # int64 keys stay int64

SENT = np.iinfo(np.int64).max
FLOAT_RTOL = 1e-12


def _inputs(seed, N, cap, nkeys, ncols=1, nvals=1, floats=False):
    rng = np.random.RandomState(seed)
    keys = [rng.randint(-nkeys, nkeys, (N, cap)).astype(np.int64)
            for _ in range(ncols)]
    n = rng.randint(cap // 3, cap + 1, N).astype(np.int32)
    n[0] = cap
    vals = []
    for i in range(nvals):
        if floats and i == 0:
            vals.append(rng.standard_normal((N, cap)))
        else:
            vals.append(rng.randint(-50, 50, (N, cap)).astype(np.int64))
    return keys, vals, n


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jmerge_add(va, vb):
    return [a + b for a, b in zip(va, vb)]


def _jmerge_pair(va, vb):            # (sum, count)-style tuple merge
    return [va[0] + vb[0], va[1] + vb[1]]


@pytest.mark.parametrize("ncols,r", [(1, 4), (2, 4), (3, 3), (4, 2)])
def test_hash_dst_hist_plain_matches_hash_dst_cols(ncols, r):
    N, cap = 4, 300
    keys, _, n = _inputs(1, N, cap, 2 ** 40, ncols=ncols)
    dst, hist, hsh = kernels.hash_dst_hist(
        [_t(k) for k in keys], _t(n), r, N, want_hist=True, want_hash=True)
    for s in range(N):
        valid = jnp.arange(cap) < n[s]
        want = np.asarray(ref.hash_dst_cols([jnp.asarray(k[s]) for k in keys],
                                            N, valid, r=r))
        assert np.array_equal(dst[s].numpy(), want)
        assert np.array_equal(hist[s].numpy(),
                              np.bincount(want, minlength=N + 1))
        from dpark_tpu.utils.phash import phash_device_cols
        h = np.asarray(phash_device_cols([jnp.asarray(k[s])
                                          for k in keys])).astype(np.int64)
        assert np.array_equal(hsh[s].numpy()[:n[s]], h[:n[s]])


@pytest.mark.parametrize("N", [2, 5])
def test_stable_partition_plain_matches_bucketize(N):
    cap = 257
    keys, vals, n = _inputs(2, N, cap, 40, nvals=2, floats=True)
    dst, hist, _ = kernels.hash_dst_hist([_t(keys[0])], _t(n), N, N)
    leaves = [_t(keys[0]), _t(vals[0]), _t(vals[1])]
    out, counts, offs = col.bucketize(leaves, _t(n), N, dst, hist)
    for s in range(N):
        ls, c, o = ref.bucketize(jnp.asarray(keys[0][s]),
                                 [jnp.asarray(v[s]) for v in
                                  (keys[0], vals[0], vals[1])],
                                 int(n[s]), N, dst=jnp.asarray(dst[s].numpy()))
        assert np.array_equal(counts[s].numpy(), np.asarray(c))
        assert np.array_equal(offs[s].numpy(), np.asarray(o))
        for got, want in zip(out, ls):      # the whole stable order
            assert np.array_equal(got[s].numpy(), np.asarray(want))


def test_stable_partition_plain_composes_a_permutation():
    N, cap = 3, 100
    rng = np.random.RandomState(3)
    bucket = rng.randint(0, 4, (N, cap)).astype(np.int32)
    perm = np.stack([rng.permutation(cap) for _ in range(N)]).astype(
        np.int32)
    leaf = rng.randint(0, 1000, (N, cap, 2)).astype(np.int64)
    out, counts, bs = kernels.stable_partition(
        _t(np.take_along_axis(bucket, perm, 1)), 4, [_t(leaf)],
        src_idx=_t(perm))
    for s in range(N):
        order = perm[s][np.argsort(bucket[s][perm[s]], kind="stable")]
        assert np.array_equal(out[0][s].numpy(), leaf[s][order])
        assert np.array_equal(bs[s].numpy(), bucket[s][order])
        assert np.array_equal(counts[s].numpy(),
                              np.bincount(bucket[s], minlength=4))


def test_lex_sort_matches_reference():
    N, cap = 3, 200
    rng = np.random.RandomState(4)
    ops = [rng.randint(0, 3, (N, cap)).astype(np.int64),
           rng.randint(-5, 5, (N, cap)).astype(np.int64),
           rng.standard_normal((N, cap, 2))]
    got = col._lex_sort([_t(o) for o in ops], 2)
    for s in range(N):
        want = ref._lex_sort(tuple(jnp.asarray(o[s]) for o in ops), 2)
        for g, w in zip(got, want):
            assert np.array_equal(g[s].numpy(), np.asarray(w))


def test_compact_matches_reference():
    N, cap = 4, 150
    rng = np.random.RandomState(5)
    leaves = [rng.randint(0, 99, (N, cap)).astype(np.int64),
              rng.standard_normal((N, cap))]
    mask = rng.rand(N, cap) < 0.4
    got, cnt = col.compact([_t(l) for l in leaves], _t(mask))
    for s in range(N):
        want, wc = ref.compact([jnp.asarray(l[s]) for l in leaves],
                               jnp.asarray(mask[s]))
        assert int(cnt[s]) == int(wc)
        for g, w in zip(got, want):
            assert np.array_equal(g[s].numpy(), np.asarray(w))


def _port_merge(treedef, merge):
    return fuse._leaves_merge_fn(merge, treedef)


CASES = [  # (monoid, ncols, floats, port merge, jax merge, value leaves)
    ("add", 1, False, lambda a, b: a + b, _jmerge_add, 1),
    ("add", 1, True, lambda a, b: a + b, _jmerge_add, 1),
    ("min", 1, False, min, None, 1),
    ("max", 2, True, max, None, 1),
    ("mul", 1, False, lambda a, b: a * b, None, 1),
    ("add", 3, False, lambda a, b: a + b, _jmerge_add, 1),
    (None, 1, False, lambda a, b: (a[0] + b[0], a[1] + b[1]),
     _jmerge_pair, 2),
    (None, 2, True, lambda a, b: (a[0] + b[0], a[1] + b[1]),
     _jmerge_pair, 2),
]


def _treedef(ncols, nvals):
    key = 0 if ncols == 1 else tuple(range(ncols))
    v = ncols if nvals == 1 else tuple(range(ncols, ncols + nvals))
    return (key, v)


def _check_packed(kg, vg, n_g, kw, vw, n_w, floats):
    """Packed prefixes equal (ints exact, floats to FLOAT_RTOL)."""
    assert n_g == n_w
    for a, b in zip(kg, kw):
        assert np.array_equal(a[:n_g], b[:n_w])
    for i, (a, b) in enumerate(zip(vg, vw)):
        if floats and i == 0:
            np.testing.assert_allclose(a[:n_g], b[:n_w], rtol=FLOAT_RTOL)
        else:
            assert np.array_equal(a[:n_g], b[:n_w])


@pytest.mark.parametrize("case", range(len(CASES)))
def test_bucketize_combine_keys_matches_reference(case):
    monoid, ncols, floats, pmerge, jmerge, nvals = CASES[case]
    N, cap = 2, 128
    keys, vals, n = _inputs(10 + case, N, cap, 6, ncols=ncols,
                            nvals=nvals, floats=floats)
    merge_fn = (None if monoid is not None
                else _port_merge(_treedef(ncols, nvals), pmerge))
    ks, vs, counts, offs = col.bucketize_combine_keys(
        [_t(k) for k in keys], [_t(v) for v in vals], _t(n), N, merge_fn,
        monoid=monoid)
    jref = jax.jit(lambda kc, vc, ns: ref.bucketize_combine_keys(
        kc, vc, ns, N, jmerge, monoid=monoid))
    for s in range(N):
        wk, wv, wc, wo = jref([jnp.asarray(k[s]) for k in keys],
                              [jnp.asarray(v[s]) for v in vals], int(n[s]))
        assert np.array_equal(counts[s].numpy(), np.asarray(wc))
        assert np.array_equal(offs[s].numpy(), np.asarray(wo))
        tot = int(np.asarray(wc).sum())
        _check_packed([k[s].numpy() for k in ks], [v[s].numpy() for v in vs],
                      tot, [np.asarray(k) for k in wk],
                      [np.asarray(v) for v in wv], tot, floats)
        assert (ks[0][s].numpy()[tot:] == SENT).all()


def _ref_exchange(leaves_np, counts_np, offs_np, slot):
    """The reference's one-round exchange + flatten on a 2-device CPU
    mesh: (flat leaves (N, N*slot, ...), mask (N, N*slot))."""
    from jax.sharding import Mesh, PartitionSpec as P
    from dpark_tpu.backend.tpu.executor import _shard_map
    N = counts_np.shape[0]
    mesh = Mesh(np.array(jax.devices()[:N]), ("parts",))

    def per_device(offsets, counts, sent, *leaves):
        recv, cnt, _, _ = ref.exchange_round(
            "parts", [l[0] for l in leaves], offsets[0], counts[0],
            sent[0], slot)
        flat, mask = ref.flatten_received([recv], [cnt])
        return (jnp.expand_dims(mask, 0),) + tuple(
            jnp.expand_dims(f, 0) for f in flat)

    fn = jax.jit(_shard_map(per_device, mesh,
                            in_specs=(P("parts"),) * (3 + len(leaves_np)),
                            out_specs=(P("parts"),) * (1 + len(leaves_np))))
    outs = fn(offs_np, counts_np, np.zeros_like(counts_np), *leaves_np)
    return [np.asarray(o) for o in outs[1:]], np.asarray(outs[0])


def _jax_map_output(seed, N, cap, monoid=None, floats=False):
    keys, vals, n = _inputs(seed, N, cap, 9, floats=floats)
    jref = jax.jit(lambda k, v, ns: ref.bucketize_combine_keys(
        [k], [v], ns, N, _jmerge_add, monoid=monoid))
    parts = [jref(jnp.asarray(keys[0][s]), jnp.asarray(vals[0][s]),
                  int(n[s])) for s in range(N)]
    leaves = [np.stack([np.asarray(p[0][0]) for p in parts]),
              np.stack([np.asarray(p[1][0]) for p in parts])]
    counts = np.stack([np.asarray(p[2]) for p in parts]).astype(np.int32)
    offs = np.stack([np.asarray(p[3]) for p in parts]).astype(np.int32)
    return leaves, counts, offs


def test_shard_exchange_plain_matches_exchange_round():
    N, cap = 2, 64
    leaves, counts, offs = _jax_map_output(20, N, cap)
    slot = int(counts.max())
    want, mask = _ref_exchange(leaves, counts, offs, slot)
    got, recv = col.exchange([_t(l) for l in leaves], _t(counts), _t(offs))
    for d in range(N):
        m = mask[d]
        assert int(recv[d]) == int(m.sum())
        for g, w in zip(got, want):        # src-major arrival order
            assert np.array_equal(g[d].numpy()[:m.sum()], w[d][m])
        assert (got[0][d].numpy()[int(recv[d]):] == SENT).all()
        assert (got[1][d].numpy()[int(recv[d]):] == 0).all()


def test_shard_exchange_plain_4_shards_against_numpy():
    N, cap = 4, 32
    leaves, counts, offs = _jax_map_output(21, N, cap)
    got, recv = kernels.shard_exchange([_t(l) for l in leaves], _t(counts),
                                       _t(offs), 80, 0, SENT)
    for d in range(N):
        want = np.concatenate([leaves[0][s][offs[s, d]:offs[s, d]
                                            + counts[s, d]]
                               for s in range(N)])
        assert int(recv[d]) == len(want)
        assert np.array_equal(got[0][d].numpy()[:len(want)], want)


@pytest.mark.parametrize("monoid,floats", [("add", False), ("add", True),
                                           (None, False)])
def test_reduce_side_on_a_jax_map_output(monoid, floats):
    """Both packages run the reduce side (exchange + segment reduce) on
    one JAX-produced map output carried across with batch_from_numpy."""
    N, cap = 2, 96
    leaves, counts, offs = _jax_map_output(30, N, cap, monoid="add",
                                           floats=floats)
    batch = layout.batch_from_numpy((0, 1), counts.sum(1), leaves, "cpu")
    recv, n = col.exchange(batch.cols, _t(counts), _t(offs))
    merge_fn = (None if monoid else
                _port_merge((0, 1), lambda a, b: a + b))
    ks, vs, nu = col.segment_reduce_keys(recv[:1], recv[1:], n, merge_fn,
                                         monoid=monoid)
    want, mask = _ref_exchange(leaves, counts, offs, int(counts.max()))
    for d in range(N):
        wk, wv, wn = ref.segment_reduce_keys(
            [jnp.asarray(want[0][d])], [jnp.asarray(want[1][d])],
            jnp.asarray(mask[d]), _jmerge_add, monoid=monoid)
        _check_packed([ks[0][d].numpy()], [vs[0][d].numpy()], int(nu[d]),
                      [np.asarray(wk[0])], [np.asarray(wv[0])], int(wn),
                      floats)


@pytest.mark.parametrize("op", ["add", "min", "max", "mul", "last"])
def test_reduce_by_key_compact_plain_against_numpy(op):
    """K3's plain version on sorted (dst, key) rows with a float and a
    two-lane int value leaf, against a Python fold."""
    N, cap, n_dst = 3, 120, 3
    rng = np.random.RandomState(40)
    d = np.sort(rng.randint(0, n_dst, (N, cap)), 1).astype(np.int32)
    k = rng.randint(0, 4, (N, cap)).astype(np.int64)
    o = np.lexsort((k, d), axis=1)
    d, k = np.take_along_axis(d, o, 1), np.take_along_axis(k, o, 1)
    vf = rng.standard_normal((N, cap))
    vi = rng.randint(-3, 4, (N, cap, 2)).astype(np.int64)
    n = np.array([cap, 50, 0], np.int32)
    ko, vo, nu, dc, do = kernels.reduce_by_key_compact(
        [_t(d), _t(k)], [n_dst, SENT], [_t(vf), _t(vi)], _t(n), op,
        dst_col=0, n_dst=n_dst)
    fold = {"add": lambda a, b: a + b, "mul": lambda a, b: a * b,
            "min": np.minimum, "max": np.maximum,
            "last": lambda a, b: b}[op]
    for s in range(N):
        runs = {}
        for i in range(n[s]):
            key = (int(d[s, i]), int(k[s, i]))
            if key in runs:
                runs[key] = [fold(a, b) for a, b in
                             zip(runs[key], (vf[s, i], vi[s, i]))]
            else:
                runs[key] = [vf[s, i], vi[s, i]]
        keys = sorted(runs)
        assert int(nu[s]) == len(keys)
        assert ko[0][s].numpy()[:len(keys)].tolist() == [a for a, _ in keys]
        assert ko[1][s].numpy()[:len(keys)].tolist() == [b for _, b in keys]
        assert (ko[1][s].numpy()[len(keys):] == SENT).all()
        np.testing.assert_allclose(vo[0][s].numpy()[:len(keys)],
                                   [runs[x][0] for x in keys],
                                   rtol=FLOAT_RTOL)
        assert np.array_equal(vo[1][s].numpy()[:len(keys)],
                              np.array([runs[x][1] for x in keys]
                                       ).reshape(-1, 2))
        assert dc[s].tolist() == [sum(1 for a, _ in keys if a == j)
                                  for j in range(n_dst)]
        assert do[s].tolist() == list(np.cumsum([0] + dc[s].tolist())[:-1])


# K2's stable partition at the one-sweep kernel's edge shapes (its tile
# is kernels._K2_TILE = 4,096 rows): the plain version against the
# reference's bucketize (its counting sort, _dst_order, for nb <= 17;
# a stable argsort above) on every shard
K2_TILE = kernels._K2_TILE


def _partition_leaves(kind, N, cap, rng):
    if kind == "mixed":           # bool, int64 and (N, cap, 3) float32
        return [rng.rand(N, cap) < 0.5,
                rng.randint(-2 ** 62, 2 ** 62, (N, cap)).astype(np.int64),
                rng.standard_normal((N, cap, 3)).astype(np.float32)]
    return [rng.randint(0, 100, (N, cap) if i % 2 else (N, cap, 2)).astype(
        (np.int64, np.float64, np.int32, np.float32)[i % 4])
        for i in range(kernels.MAX_LEAVES)]


def _check_partition(bucket, nb, leaves, src):
    N, cap = bucket.shape
    out, counts, bs = kernels.stable_partition(
        _t(bucket), nb, [_t(x) for x in leaves],
        src_idx=None if src is None else _t(src))
    for s in range(N):
        cur = [x[s] if src is None else x[s][src[s]] for x in leaves]
        ls, c, _ = ref.bucketize(jnp.zeros((cap,), jnp.int64),
                                 [jnp.asarray(x) for x in cur], cap,
                                 nb - 1, dst=jnp.asarray(bucket[s]))
        for got, want in zip(out, ls):
            assert np.array_equal(got[s].numpy(), np.asarray(want))
        want_counts = np.bincount(bucket[s], minlength=nb)
        assert np.array_equal(counts[s].numpy()[:nb - 1], np.asarray(c))
        assert np.array_equal(counts[s].numpy(), want_counts)
        order = np.asarray(ref._dst_order(jnp.asarray(bucket[s]), nb - 1)) \
            if nb <= 17 else np.argsort(bucket[s], kind="stable")
        assert np.array_equal(bs[s].numpy(), bucket[s][order])


@pytest.mark.parametrize("src", [False, True])
@pytest.mark.parametrize("cap", [0, 1, K2_TILE - 1, 3 * K2_TILE + 1])
@pytest.mark.parametrize("nb", [1, 2, 33, 256])
def test_stable_partition_plain_matches_reference_at_tile_edges(nb, cap,
                                                                src):
    N = 3
    rng = np.random.RandomState(nb + cap % 101 + 7 * src)
    bucket = rng.randint(0, nb, (N, cap)).astype(np.int32)
    perm = np.stack([rng.permutation(cap) for _ in range(N)]).astype(
        np.int32) if src else None
    _check_partition(bucket, nb, _partition_leaves("mixed", N, cap, rng),
                     perm)


@pytest.mark.parametrize("case", ["one bucket nb=2", "one bucket nb=33",
                                  "empty shard", "16 leaves",
                                  "16 leaves src_idx"])
def test_stable_partition_plain_special_layouts(case):
    """Every row in one bucket; a shard with no valid row (all of its
    rows in the padding bucket, as bucketize gives it); the 16 leaves a
    call takes, with and without src_idx."""
    N, cap = 3, 2 * K2_TILE + 5
    rng = np.random.RandomState(41)
    nb = 33 if case.endswith("33") else 9
    if case.startswith("one bucket"):
        nb = 2 if case.endswith("2") else 33
        bucket = np.full((N, cap), nb - 1, np.int32)
        bucket[1] = 0
    else:
        bucket = rng.randint(0, nb, (N, cap)).astype(np.int32)
    if case == "empty shard":
        bucket[2] = nb - 1
    kind = "many" if case.startswith("16") else "mixed"
    perm = np.stack([rng.permutation(cap) for _ in range(N)]).astype(
        np.int32) if case.endswith("src_idx") else None
    _check_partition(bucket, nb, _partition_leaves(kind, N, cap, rng), perm)


@pytest.mark.parametrize("mask_kind", ["all", "none", "random"])
@pytest.mark.parametrize("cap", [1, K2_TILE - 1, 3 * K2_TILE + 1])
def test_compact_matches_reference_at_tile_edges(cap, mask_kind):
    N = 3
    rng = np.random.RandomState(cap % 103)
    leaves = _partition_leaves("mixed", N, cap, rng)
    mask = {"all": np.ones((N, cap), bool), "none": np.zeros((N, cap), bool),
            "random": rng.rand(N, cap) < 0.3}[mask_kind]
    got, cnt = col.compact([_t(x) for x in leaves], _t(mask))
    for s in range(N):
        want, wc = ref.compact([jnp.asarray(x[s]) for x in leaves],
                               jnp.asarray(mask[s]))
        assert int(cnt[s]) == int(wc)
        for g, w in zip(got, want):
            assert np.array_equal(g[s].numpy(), np.asarray(w))


def test_bucketize_reads_the_callers_histogram():
    """bucketize hands K1's histogram to K2 as the bucket counts (the
    kernel then skips its own count): the same sorted rows as the
    reference's bucketize, also where the histogram covers padding rows
    and an empty shard."""
    N, cap = 4, K2_TILE + 9
    keys, vals, n = _inputs(43, N, cap, 500, nvals=1)
    n[3] = 0
    dst, hist, _ = kernels.hash_dst_hist([_t(keys[0])], _t(n), N, N)
    out, counts, offs = col.bucketize([_t(keys[0]), _t(vals[0])], _t(n), N,
                                      dst, hist)
    for s in range(N):
        ls, c, o = ref.bucketize(jnp.asarray(keys[0][s]),
                                 [jnp.asarray(keys[0][s]),
                                  jnp.asarray(vals[0][s])],
                                 int(n[s]), N, dst=jnp.asarray(dst[s].numpy()))
        assert np.array_equal(counts[s].numpy(), np.asarray(c))
        assert np.array_equal(offs[s].numpy(), np.asarray(o))
        for got, want in zip(out, ls):
            assert np.array_equal(got[s].numpy(), np.asarray(want))


@pytest.mark.parametrize("source,prefix,const", [
    ("stable_partition.cu", "K2", "_K2_TILE"),
    ("segment_table.cu", "K7", "_K7_TILE")])
def test_tile_constants_match_the_sources(source, prefix, const):
    """The wrappers size the look-back's status words by their tile
    constant: it must be the source's THREADS x ITEMS."""
    import os
    import re
    with open(os.path.join(kernels.CSRC, source)) as f:
        text = f.read()

    def define(name):
        return int(re.search(r"(?m)^#define %s (\d+)" % name, text).group(1))
    assert getattr(kernels, const) == define(prefix + "_THREADS") * define(
        prefix + "_ITEMS")
