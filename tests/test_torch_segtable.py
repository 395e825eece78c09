"""The port's K7 (segment_table) and K8 (bucket_gather / bucket_scatter)
kernels and its K2-based bucket_members on the CPU, where their plain
PyTorch versions run, against the JAX package's segment_spans,
bucket_histogram, bucket_index, bucket_members and gather_bucket_groups
(backend/tpu/collectives.py) on the same seeded numpy inputs, one shard
at a time.  Every comparison is exact: the tables are integers and the
gathered values are copies."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dpark_tpu.backend.tpu import collectives as ref
from dpark_tpu_torch.backend.cuda import collectives as col
from dpark_tpu_torch.backend.cuda import kernels
from dpark_tpu_torch.backend.cuda.layout import round_capacity

jax.config.update("jax_enable_x64", True)     # int64 keys stay int64

CAP = 256


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _keys_from_sizes(sizes, cap, seed):
    """A key-sorted int64 column whose runs have `sizes`, padded to cap
    with the sentinel; returns (column, n)."""
    rng = np.random.RandomState(seed)
    keys = np.sort(rng.choice(10 ** 6, len(sizes), replace=False))
    col_ = np.repeat(keys, sizes).astype(np.int64)
    n = len(col_)
    out = np.full(cap, np.iinfo(np.int64).max, np.int64)
    out[:n] = col_
    return out, n


def _sorted_tuple_keys(nk, rows, cap, seed, hi=3):
    """nk key columns of `rows` random tuples sorted lexicographically,
    padded to cap (column 0 with the sentinel, the rest with 0)."""
    rng = np.random.RandomState(seed)
    cols = [rng.randint(-hi, hi, rows).astype(np.int64) for _ in range(nk)]
    order = np.lexsort(cols[::-1])
    out = []
    for c, kc in enumerate(cols):
        a = np.full(cap, np.iinfo(np.int64).max if c == 0 else 0, np.int64)
        a[:rows] = kc[order]
        out.append(a)
    return out


def _case(name):
    """(list of nk (N, CAP) key columns, n (N,)) of one named layout."""
    shards = []
    if name == "pow2":
        shards.append(_keys_from_sizes([1, 2, 4, 8, 16, 32, 64, 128],
                                       CAP, 1))
        shards.append(_keys_from_sizes([3, 5, 9, 17, 33, 65, 2, 1], CAP, 2))
        shards.append(_keys_from_sizes([128, 64, 63, 1], CAP, 3))
    elif name == "empty_shard":
        shards.append(_keys_from_sizes([5, 7, 1], CAP, 4))
        shards.append(_keys_from_sizes([], CAP, 5))
        shards.append(_keys_from_sizes([2, 2], CAP, 6))
    elif name == "one_segment":
        shards.append(_keys_from_sizes([CAP], CAP, 7))
        shards.append(_keys_from_sizes([100], CAP, 8))
    elif name == "singletons":
        shards.append(_keys_from_sizes([1] * CAP, CAP, 9))
        shards.append(_keys_from_sizes([1] * 77, CAP, 10))
    else:                                   # random sizes
        rng = np.random.RandomState(11)
        for s in range(4):
            sizes = []
            while sum(sizes) < CAP - 40:
                sizes.append(int(rng.choice([1, 1, 2, 3, 4, 7, 8, 16, 31])))
            shards.append(_keys_from_sizes(sizes, CAP, 20 + s))
    keys = np.stack([k for k, _ in shards])
    n = np.array([m for _, m in shards], np.int32)
    return [keys], n


def _tuple_case(nk, seed=30):
    rows = [CAP, 200, 0, 17]
    per = [_sorted_tuple_keys(nk, r, CAP, seed + s)
           for s, r in enumerate(rows)]
    cols = [np.stack([p[c] for p in per]) for c in range(nk)]
    return cols, np.array(rows, np.int32)


def _lanes(members, offsets, counts, b, G):
    """(seg_sel (N, G), gvalid (N, G)) of size class b: the reference's
    bucket_members form (0 on invalid lanes)."""
    seg, valid = kernels._lanes_of(members, offsets[:, b].contiguous(),
                                   counts[:, b].contiguous(), G)
    return seg.to(torch.int32), valid


CASES = ["pow2", "empty_shard", "one_segment", "singletons", "random"]


def _all_cases():
    out = [(name, _case(name)) for name in CASES]
    out += [("tuple%d" % nk, _tuple_case(nk)) for nk in (2, 3, 4)]
    return out


def _ref_table(cols, n, s):
    start_rows, sizes, _, n_seg = ref.segment_spans(
        [jnp.asarray(c[s]) for c in cols], jnp.int32(n[s]))
    hist, max_size = ref.bucket_histogram(
        [jnp.asarray(c[s]) for c in cols], jnp.int32(n[s]))
    return (np.asarray(start_rows), np.asarray(sizes), int(n_seg),
            np.asarray(hist), int(max_size))


@pytest.mark.parametrize("name,case", _all_cases(),
                         ids=[c[0] for c in _all_cases()])
def test_segment_table_matches_reference(name, case):
    cols, n = case
    tcols = [_t(c) for c in cols]
    start_rows, sizes, bucket, n_seg, hist, keys = kernels.segment_table(
        tcols, _t(n))
    assert start_rows.dtype == sizes.dtype == bucket.dtype == torch.int32
    for s in range(len(n)):
        r_start, r_sizes, r_nseg, r_hist, r_max = _ref_table(cols, n, s)
        assert int(n_seg[s]) == r_nseg
        np.testing.assert_array_equal(start_rows[s].numpy(), r_start)
        np.testing.assert_array_equal(sizes[s].numpy(), r_sizes)
        np.testing.assert_array_equal(hist[s].numpy(), r_hist)
        live = np.arange(CAP) < r_nseg
        np.testing.assert_array_equal(
            bucket[s].numpy(),
            np.where(live, np.asarray(ref.bucket_index(jnp.asarray(r_sizes))),
                     kernels.SIZE_CLASSES))
        # the segment keys: each key column at the start rows, the fills
        # past n_seg (the sentinel in column 0, 0 elsewhere)
        for c, kc in enumerate(keys):
            want = np.where(live, cols[c][s][r_start],
                            np.iinfo(np.int64).max if c == 0 else 0)
            np.testing.assert_array_equal(kc[s].numpy(), want)
    # the executor's entry (collectives._segment_table) gives the same
    # table, and each shard's largest size is the reference's max_size
    table = col._segment_table(tcols, _t(n), want_keys=True)
    for got, want in zip(table[:5], (start_rows, sizes, bucket, n_seg,
                                     hist)):
        assert torch.equal(got, want)
    for s in range(len(n)):
        assert int(sizes[s].max()) == _ref_table(cols, n, s)[4]


def test_segment_table_float_keys_follow_not_equal():
    """Float keys split where != says: -0.0 and +0.0 are one key (as the
    host's dict and the reference's jnp != have it), every NaN is its
    own."""
    k = np.array([[-1.5, -0.0, 0.0, 0.0, 2.0, np.nan, np.nan, np.inf]])
    n = np.array([8], np.int32)
    start_rows, sizes, _, n_seg, hist, keys = kernels.segment_table(
        [_t(k)], _t(n))
    r_start, r_sizes, r_nseg, r_hist, _ = _ref_table([k], n, 0)
    assert int(n_seg[0]) == r_nseg == 6
    np.testing.assert_array_equal(start_rows[0].numpy(), r_start)
    np.testing.assert_array_equal(sizes[0].numpy(), r_sizes)
    np.testing.assert_array_equal(hist[0].numpy(), r_hist)
    assert list(sizes[0, :6]) == [1, 3, 1, 1, 1, 1]
    assert np.signbit(keys[0][0, 1].item())          # -0.0 came first


def test_segment_table_int32_keys():
    cols, n = _case("random")
    k32 = (cols[0] % 1000).astype(np.int32)
    k32.sort(axis=1)
    got = kernels.segment_table([_t(k32)], _t(n))
    for s in range(len(n)):
        r_start, r_sizes, r_nseg, r_hist, _ = _ref_table([k32], n, s)
        np.testing.assert_array_equal(got[0][s].numpy(), r_start)
        np.testing.assert_array_equal(got[1][s].numpy(), r_sizes)
        np.testing.assert_array_equal(got[4][s].numpy(), r_hist)


def test_size_class_exact_powers_of_two():
    """A size of exactly 2^k lands in class k, never k+1 (integer
    bit-twiddling, as the reference's bucket_index)."""
    sizes = [0, 1, 2, 3, 4, 5]
    for k in range(2, 31):
        sizes += [(1 << k) - 1, 1 << k, (1 << k) + 1]
    sizes.append(2 ** 31 - 1)
    a = np.array(sizes, np.int64)
    got = kernels.size_class(_t(a)).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref.bucket_index(
        jnp.asarray(a))))
    for k in range(31):
        assert got[sizes.index(1 << k)] == k


@pytest.mark.parametrize("name,case", _all_cases(),
                         ids=[c[0] for c in _all_cases()])
def test_bucket_members_through_stable_partition(name, case):
    """bucket_members is K2's stable partition of segment ids by size
    class: each class's members in segment order, as the reference's
    cumsum-rank scatter gives them."""
    cols, n = case
    start_rows, sizes, bucket, n_seg, hist, _ = kernels.segment_table(
        [_t(c) for c in cols], _t(n))
    members, counts, offsets = col.bucket_members(bucket)
    assert torch.equal(counts[:, :kernels.SIZE_CLASSES], hist)
    for b in range(kernels.SIZE_CLASSES):
        G = round_capacity(int(hist[:, b].max()))
        seg_sel, gvalid = _lanes(members, offsets, counts, b, G)
        for s in range(len(n)):
            r_sel, r_valid = ref.bucket_members(
                jnp.asarray(sizes[s].numpy()), jnp.int32(int(n_seg[s])), b,
                G)
            np.testing.assert_array_equal(gvalid[s].numpy(),
                                          np.asarray(r_valid))
            np.testing.assert_array_equal(seg_sel[s].numpy(),
                                          np.asarray(r_sel))


@pytest.mark.parametrize("pad", ["zero", "edge"])
@pytest.mark.parametrize("vdtype", [np.int64, np.float64, np.float32])
@pytest.mark.parametrize("name", ["pow2", "random", "empty_shard"])
def test_gather_bucket_groups_matches_reference(name, vdtype, pad):
    cols, n = _case(name)
    rng = np.random.RandomState(5)
    vals = (rng.randint(-1000, 1000, cols[0].shape) * 0.5).astype(vdtype)
    start_rows, sizes, bucket, n_seg, hist, _ = kernels.segment_table(
        [_t(c) for c in cols], _t(n))
    members, counts, offsets = col.bucket_members(bucket)
    for b in range(kernels.SIZE_CLASSES):
        if not int(hist[:, b].max()):
            continue
        G = round_capacity(int(hist[:, b].max()))
        B = 1 << b
        got = col.gather_bucket_groups(start_rows, sizes, members, offsets,
                                       counts, b, G, B, _t(vals), pad)
        assert got.shape == (len(n), G, B) and got.dtype == _t(vals).dtype
        for s in range(len(n)):
            r_sel, r_valid = ref.bucket_members(
                jnp.asarray(sizes[s].numpy()), jnp.int32(int(n_seg[s])), b,
                G)
            want = ref.gather_bucket_groups(
                jnp.asarray(start_rows[s].numpy()),
                jnp.asarray(sizes[s].numpy()), r_sel, r_valid, B,
                jnp.asarray(vals[s]), pad)
            np.testing.assert_array_equal(got[s].numpy(), np.asarray(want))


def test_bucket_scatter_writes_valid_lanes_only():
    """Each valid lane's result lands at its segment id (the reference's
    outs.at[where(gvalid, seg_sel, cap)].set(r)); invalid lanes write
    nothing; every leaf of a tuple result."""
    cols, n = _case("random")
    _, sizes, bucket, n_seg, hist, _ = kernels.segment_table(
        [_t(c) for c in cols], _t(n))
    members, counts, offsets = col.bucket_members(bucket)
    N = len(n)
    outs = [torch.full((N, CAP), -7, dtype=torch.int64),
            torch.full((N, CAP), -0.5, dtype=torch.float64)]
    want = [o.numpy().copy() for o in outs]
    for b in range(kernels.SIZE_CLASSES):
        if not int(hist[:, b].max()):
            continue
        G = round_capacity(int(hist[:, b].max()))
        seg_sel, gvalid = _lanes(members, offsets, counts, b, G)
        res = [torch.arange(N * G, dtype=torch.int64).view(N, G) + 1000 * b,
               torch.arange(N * G, dtype=torch.float64).view(N, G) * 0.25]
        kernels.bucket_scatter(outs, res, members,
                               offsets[:, b].contiguous(),
                               counts[:, b].contiguous())
        for s in range(N):
            tgt = np.where(gvalid[s].numpy(), seg_sel[s].numpy(), CAP)
            for w, r in zip(want, res):
                ext = np.concatenate([w[s], w[s][:1]])
                ext[tgt] = r[s].numpy()
                w[s] = ext[:CAP]
    for o, w in zip(outs, want):
        np.testing.assert_array_equal(o.numpy(), w)
    # every live segment was written exactly once (the -7 fill survives
    # only past n_seg)
    written = outs[0].numpy() != -7
    live = np.arange(CAP)[None, :] < n_seg.numpy()[:, None]
    np.testing.assert_array_equal(written, live)


def test_wrappers_refuse_bad_inputs():
    k = torch.zeros((2, 8), dtype=torch.int64)
    n = torch.tensor([8, 8], dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.segment_table([k.float()], n)
    with pytest.raises(ValueError):
        kernels.segment_table([k] * 5, n)
    t = kernels.segment_table([k], n)
    with pytest.raises(ValueError):
        kernels.bucket_gather(t[0], t[1], t[0], t[3], t[3], 4, 4,
                              k, "wrap")


# K7 at the one-sweep kernel's edge shapes (its tile is kernels._K7_TILE
# = 4,096 rows): the plain version against the reference's segment_spans,
# bucket_histogram and bucket_index on every shard
K7_TILE = kernels._K7_TILE


def _check_table(cols, n):
    cap = cols[0].shape[1]
    start_rows, sizes, bucket, n_seg, hist, keys = kernels.segment_table(
        [_t(c) for c in cols], _t(n))
    fills = kernels._seg_fills([_t(c) for c in cols])
    for s in range(len(n)):
        r_start, r_sizes, _, r_nseg = ref.segment_spans(
            [jnp.asarray(c[s]) for c in cols], jnp.int32(n[s]))
        r_hist, _ = ref.bucket_histogram([jnp.asarray(c[s]) for c in cols],
                                         jnp.int32(n[s]))
        r_nseg = int(r_nseg)
        live = np.arange(cap) < r_nseg
        assert int(n_seg[s]) == r_nseg
        np.testing.assert_array_equal(start_rows[s].numpy(),
                                      np.where(live, np.asarray(r_start), 0))
        np.testing.assert_array_equal(sizes[s].numpy(), np.asarray(r_sizes))
        np.testing.assert_array_equal(hist[s].numpy(), np.asarray(r_hist))
        np.testing.assert_array_equal(bucket[s].numpy(), np.where(
            live, np.asarray(ref.bucket_index(jnp.asarray(r_sizes))),
            kernels.SIZE_CLASSES))
        for c, kc in enumerate(keys):
            want = np.where(live, cols[c][s][np.asarray(r_start)], fills[c])
            got = kc[s].numpy()
            assert got.dtype == cols[c].dtype
            np.testing.assert_array_equal(got.view(np.uint8),
                                          want.astype(got.dtype).view(
                                              np.uint8))
    return n_seg


def _layout(name, cap, dtype=np.int64):
    """(N=4, cap) key columns of one layout and n."""
    rng = np.random.RandomState(cap % 97 + len(name))
    N = 4
    if name == "one_segment":
        k = np.zeros((N, cap), dtype)
        n = [cap, cap, max(0, cap - 3), 1]
    elif name == "distinct":
        k = np.tile(np.arange(cap, dtype=dtype), (N, 1))
        n = [cap, cap // 2, 1, cap]
    elif name == "n0":
        k = np.sort(rng.randint(0, 50, (N, cap)), axis=1).astype(dtype)
        n = [0, 0, cap, 0]
    else:                                      # runs of 1-300 rows
        sizes = rng.randint(1, 300, cap)
        ids = np.repeat(np.arange(cap), sizes)[:cap]
        k = np.tile(ids.astype(dtype), (N, 1))
        n = [cap, cap - cap // 3, cap // 7, cap]
    return [k], np.array(n, np.int32)


@pytest.mark.parametrize("layout", ["one_segment", "distinct", "n0",
                                    "runs"])
@pytest.mark.parametrize("cap", [1, K7_TILE - 1, 3 * K7_TILE + 1])
def test_segment_table_matches_reference_at_tile_edges(layout, cap):
    cols, n = _layout(layout, cap)
    n_seg = _check_table(cols, n)
    if layout == "one_segment":
        assert n_seg.tolist() == [1 if m else 0 for m in n]
    if layout == "distinct":
        assert n_seg.tolist() == n.tolist()


def test_segment_table_nan_and_signed_zero_at_tile_edges():
    """-0.0 equals +0.0 and every NaN is its own key also where the pair
    straddles two threads' rows or two tiles."""
    cap = 3 * K7_TILE + 1
    k = np.repeat(np.arange(cap // 4 + 1, dtype=np.float64), 4)[:cap]
    k = np.stack([k] * 3)
    for edge in (7, 8, K7_TILE - 1, K7_TILE, 2 * K7_TILE):
        k[0, edge - 1], k[0, edge] = -0.0, 0.0
        k[1, edge - 1], k[1, edge] = np.nan, np.nan
        k[2, edge - 1:edge + 2] = np.inf
    _check_table([k], np.array([cap, cap, cap - 3], np.int32))


def test_segment_table_four_mixed_key_columns():
    """int32, int64, float64 and int32 columns: a segment starts wherever
    any of them differs; column 0's fill is its dtype's max."""
    cap = 2 * K7_TILE + 33
    rng = np.random.RandomState(47)

    def runs(mean, dtype):
        sizes = rng.geometric(1.0 / mean, cap)
        return np.tile((np.repeat(np.arange(cap), sizes)[:cap] * 3 - 50)
                       .astype(dtype), (3, 1))
    cols = [runs(40, np.int32), runs(9, np.int64), runs(300, np.float64),
            runs(2, np.int32)]
    cols[2][1, 100:140] = -0.0
    cols[2][1, 120:130] = 0.0
    cols[2][2, 50:60] = np.nan
    _check_table(cols, np.array([cap, cap - 5, 1], np.int32))
