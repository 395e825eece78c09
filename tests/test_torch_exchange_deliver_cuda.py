"""K4 (shard_exchange) and K10 (pregel_deliver, with its batched class
entry pregel_deliver_classes) launched on the card against their plain
versions.

Every test here is marked `cuda` and skips without a card; on the card:
``python -m pytest -m cuda tests/test_torch_exchange_deliver_cuda.py``.
The file imports no JAX: the CPU tests of the plain versions against the
JAX package are in tests/test_torch_collectives.py,
tests/test_torch_pregel_kernels.py and tests/test_torch_bagel_obj_kernels.py.
Every comparison is bit for bit (the outputs are copies and fills), and
two calls of each kernel are held against each other.

K4: empty buckets, a source that sends everything to one destination,
N = 2, 4 and 8, int64, int32 and float64 key leaves with their sentinel
tails, leaves of 1, 2, 4, 6, 8, 16 and 24 bytes, source spans whose
offsets differ mod 16 from their outputs' (random gaps in the send
buffers, sources one element into their storage), cap_out past the
total and destinations of several tiles.

K10: sorted and unsorted ids, n_unique 0 and 1 and large enough that the
splitters lie 16 and more keys apart, an empty shard, ids past vcnt and
sentinel ids, class capacities that are no multiple of a thread's slots,
more leaves than MAX_LEAVES, leaves of 1 to 24 bytes (one not 16-byte
aligned), and the batched class entry against the per-class calls with
and without `fills`."""

import numpy as np
import pytest
import torch

from dpark_tpu_torch.backend.cuda import kernels

pytestmark = pytest.mark.cuda

SENT = np.iinfo(np.int64).max


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    kernels.build()
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().cpu().view(torch.uint8)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(_bits(g), _bits(w))


# ---------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------
LEAF_KINDS = {1: (np.int8, ()), 2: (np.int16, ()), 4: (np.int32, ()),
              6: (np.int16, (3,)), 8: (np.int64, ()),
              16: (np.float64, (2,)), 24: (np.int64, (3,))}


def _offset_leaf(a, dev, offset):
    """a on the card, `offset` elements into its storage."""
    flat = torch.zeros(a.size + offset, dtype=torch.from_numpy(a).dtype,
                       device=dev)
    out = flat[offset:].view(a.shape)
    out.copy_(torch.from_numpy(a).to(dev))
    return out


def _exchange_case(N, cap_in, seed, dev, key=np.int64, widths=(8,),
                   pattern="random", gaps=True, offset=0):
    """Send buffers of N shards: bucket d of source s at rows offsets[s,
    d] .. + counts[s, d] (with random gaps between buckets when `gaps`),
    a key leaf of `key` and one leaf a width in `widths`."""
    rng = np.random.RandomState(seed)
    counts = np.zeros((N, N), np.int32)
    offsets = np.zeros((N, N), np.int32)
    for s in range(N):
        room = cap_in
        if pattern == "one":              # everything to one destination
            c = np.zeros(N, np.int64)
            c[(s + 1) % N] = rng.randint(0, cap_in + 1)
        else:
            c = rng.multinomial(rng.randint(0, cap_in + 1),
                                rng.dirichlet(np.ones(N)))
            if pattern == "empty":
                c[rng.rand(N) < 0.5] = 0
        gap_room = room - int(c.sum())
        at = 0
        for d in range(N):
            if gaps and gap_room > 0:
                g = rng.randint(0, min(gap_room, 7) + 1)
                at += g
                gap_room -= g
            offsets[s, d] = at
            counts[s, d] = c[d]
            at += int(c[d])
    if key == np.float64:
        k = rng.randn(N, cap_in)
    else:
        k = rng.randint(-10 ** 6, 10 ** 6, (N, cap_in)).astype(key)
    leaves = [k]
    for w in widths:
        dt, shp = LEAF_KINDS[w]
        leaves.append(rng.randint(-100, 100, (N, cap_in) + shp).astype(dt))
    return ([_offset_leaf(a, dev, offset) for a in leaves],
            torch.from_numpy(counts).to(dev),
            torch.from_numpy(offsets).to(dev))


def _sentinel(dt):
    if dt.is_floating_point:
        return float("inf")
    return torch.iinfo(dt).max


def _check_exchange(leaves, counts, offsets, cap_out, key_leaf=0):
    fill = _sentinel(leaves[key_leaf].dtype) if key_leaf is not None else 0
    before = kernels.LAUNCHES["shard_exchange"]
    a = kernels.shard_exchange(leaves, counts, offsets, cap_out, key_leaf,
                               fill)
    b = kernels.shard_exchange(leaves, counts, offsets, cap_out, key_leaf,
                               fill)
    assert kernels.LAUNCHES["shard_exchange"] == before + 2
    cpu = [x.cpu() for x in leaves]
    want = kernels.shard_exchange_plain(cpu, counts.cpu(), offsets.cpu(),
                                        cap_out, key_leaf, fill)
    _same(list(a[0]) + [a[1]], list(want[0]) + [want[1]])
    _same(list(a[0]) + [a[1]], list(b[0]) + [b[1]])
    return a


@pytest.mark.parametrize("N", [2, 4, 8])
@pytest.mark.parametrize("pattern", ["random", "empty", "one"])
def test_exchange_matches_plain(dev, N, pattern):
    leaves, counts, offsets = _exchange_case(N, 3000, N + 7, dev,
                                             widths=(8, 16),
                                             pattern=pattern)
    cap_out = max(1, int(counts.sum(0).max().item()))
    _check_exchange(leaves, counts, offsets, cap_out)


@pytest.mark.parametrize("width", sorted(LEAF_KINDS))
@pytest.mark.parametrize("offset", [0, 1])
def test_exchange_leaf_widths_and_offsets(dev, width, offset):
    """Rows of 1-24 bytes; sources one element into their storage, so
    that source and output offsets differ mod 16."""
    leaves, counts, offsets = _exchange_case(4, 1500, width * 3 + offset,
                                             dev, widths=(width,),
                                             offset=offset)
    cap_out = int(counts.sum(0).max().item()) + 37    # past the total
    _check_exchange(leaves, counts, offsets, cap_out)


@pytest.mark.parametrize("key", [np.int32, np.int64, np.float64])
def test_exchange_key_fills(dev, key):
    """The key leaf's tail holds its sentinel (int32 max, int64 max,
    +inf), the other leaves' tails zero."""
    leaves, counts, offsets = _exchange_case(3, 700, 5, dev, key=key,
                                             widths=(4, 1))
    cap_out = int(counts.sum(0).max().item()) + 100
    out, recv = _check_exchange(leaves, counts, offsets, cap_out)
    tail = out[0][0, int(recv[0].item()):]
    assert tail.numel() and bool((tail == _sentinel(tail.dtype)).all())


def test_exchange_without_key_leaf(dev):
    leaves, counts, offsets = _exchange_case(2, 900, 11, dev, widths=(2,))
    _check_exchange(leaves, counts, offsets,
                    int(counts.sum(0).max().item()) + 5, key_leaf=None)


def test_exchange_several_tiles(dev):
    """Destinations of many 2,048-row tiles, spans crossing tile edges."""
    leaves, counts, offsets = _exchange_case(8, 40_000, 3, dev,
                                             widths=(8, 6))
    cap_out = int(counts.sum(0).max().item())
    assert cap_out > 4 * 2048
    _check_exchange(leaves, counts, offsets, cap_out + 4096)


def test_exchange_packed_buffers(dev):
    """Buckets packed back to back, as the map-side write leaves them."""
    leaves, counts, offsets = _exchange_case(8, 20_000, 4, dev,
                                             widths=(8,), gaps=False)
    _check_exchange(leaves, counts, offsets,
                    int(counts.sum(0).max().item()))


def test_exchange_all_empty(dev):
    leaves, counts, offsets = _exchange_case(4, 64, 2, dev, widths=(8,))
    counts.zero_()
    out, recv = _check_exchange(leaves, counts, offsets, 16)
    assert int(recv.sum().item()) == 0


# ---------------------------------------------------------------------
# K10
# ---------------------------------------------------------------------
def _deliver_tables(N, cap_v, seed, n_unique, sort=True, empty=(),
                    past=False, universe=None):
    """(vid, vcnt, uk, nu) numpy: each shard's ids (sorted or not), about
    half of them among its n_unique unique keys, the rest of the keys
    ids with no vertex; shards in `empty` hold no vertex.  With `past`,
    slots past vcnt hold ids that have mail (still invalid)."""
    rng = np.random.RandomState(seed)
    universe = universe or max(4 * (cap_v + n_unique), 64)
    cap_u = max(1, n_unique)
    vid = np.full((N, cap_v), SENT, np.int64)
    uk = np.full((N, cap_u), SENT, np.int64)
    vcnt = np.zeros(N, np.int32)
    nu = np.zeros(N, np.int32)
    for s in range(N):
        c = 0 if s in empty else rng.randint(cap_v // 2, cap_v + 1)
        ids = rng.choice(universe, c, replace=False) * N + s
        if sort:
            ids = np.sort(ids)
        vid[s, :c] = ids
        vcnt[s] = c
        if c and rng.rand() < 0.3:
            vid[s, rng.randint(0, c)] = SENT           # a sentinel id
        known = rng.choice(ids, min(c, n_unique // 2), replace=False) \
            if c else np.zeros(0, np.int64)
        other = rng.choice(universe, n_unique, replace=False) * N + s
        keys = np.unique(np.concatenate([known, other]))[:n_unique]
        uk[s, :len(keys)] = keys
        nu[s] = len(keys)
        if past and c < cap_v and len(keys):
            vid[s, c:] = keys[0]
    return vid, vcnt, uk, nu


LEAF_SPECS = [(np.float64, ()), (np.int64, ()), (np.int32, ()),
              (np.float32, ()), (np.bool_, ()), (np.int16, ()),
              (np.float64, (2,)), (np.int64, (3,)), (np.int8, (3,))]


def _msg_leaves(rng, N, cap_u, specs):
    out = []
    for dt, shp in specs:
        if dt == np.bool_:
            out.append(rng.rand(N, cap_u, *shp) < 0.5)
        elif np.dtype(dt).kind == "f":
            out.append((rng.randn(N, cap_u, *shp) * 100).astype(dt))
        else:
            out.append(rng.randint(-100, 100, (N, cap_u) + shp).astype(dt))
    return out


def _t(a, dev=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(dev) if dev is not None else t


def _check_deliver(dev, vid, vcnt, uk, nu, leaves, combine, fills=None):
    args = [_t(vid, dev), _t(vcnt, dev), _t(uk, dev), _t(nu, dev)]
    dl = [x if torch.is_tensor(x) else _t(x, dev) for x in leaves]
    before = kernels.LAUNCHES["pregel_deliver"]
    a = kernels.pregel_deliver(*args, dl, combine, fills=fills)
    b = kernels.pregel_deliver(*args, dl, combine, fills=fills)
    groups = max(1, -(-len(leaves) // kernels.MAX_LEAVES))
    assert kernels.LAUNCHES["pregel_deliver"] == before + 2 * groups
    want = kernels.pregel_deliver_plain(
        *[x.cpu() for x in args], [x.cpu() for x in dl], combine, fills)
    _same(list(a[0]) + [a[1]], list(want[0]) + [want[1]])
    _same(list(a[0]) + [a[1]], list(b[0]) + [b[1]])
    return a


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("combine", ["add", "min", "max", "mul"])
def test_deliver_matches_plain(dev, sort, combine):
    vid, vcnt, uk, nu = _deliver_tables(4, 3000, 1, 1500, sort=sort,
                                        empty=(2,), past=True)
    rng = np.random.RandomState(2)
    specs = LEAF_SPECS if combine in ("add", "mul") else [
        s for s in LEAF_SPECS if s[0] != np.bool_]
    _check_deliver(dev, vid, vcnt, uk, nu,
                   _msg_leaves(rng, 4, uk.shape[1], specs), combine)


@pytest.mark.parametrize("n_unique", [0, 1, 17, 20_000, 70_000])
@pytest.mark.parametrize("sort", [True, False])
def test_deliver_key_counts(dev, n_unique, sort):
    """No key, one key, and so many that the splitter stride grows past
    its least (16 and 64 keys between splitters)."""
    cap_v = 5000 if n_unique < 20_000 else 40_000
    vid, vcnt, uk, nu = _deliver_tables(2, cap_v, n_unique + 3, n_unique,
                                        sort=sort)
    if n_unique == 0:
        nu[:] = 0
    rng = np.random.RandomState(n_unique)
    _check_deliver(dev, vid, vcnt, uk, nu,
                   _msg_leaves(rng, 2, uk.shape[1], [(np.float64, ())]),
                   "add")


@pytest.mark.parametrize("cap_v", [1, 3, 13, 1025, 4099])
def test_deliver_ragged_capacities(dev, cap_v):
    """Capacities that are no multiple of a thread's slots or a block's
    chunk."""
    vid, vcnt, uk, nu = _deliver_tables(3, cap_v, cap_v, 50, sort=False,
                                        empty=(1,))
    rng = np.random.RandomState(cap_v)
    _check_deliver(dev, vid, vcnt, uk, nu,
                   _msg_leaves(rng, 3, uk.shape[1], LEAF_SPECS[:4]), "min")


def test_deliver_more_leaves_than_max(dev):
    vid, vcnt, uk, nu = _deliver_tables(2, 700, 9, 300)
    rng = np.random.RandomState(9)
    specs = (LEAF_SPECS * 2)[:kernels.MAX_LEAVES + 2]
    _check_deliver(dev, vid, vcnt, uk, nu,
                   _msg_leaves(rng, 2, uk.shape[1], specs), "add")


def test_deliver_unaligned_leaf(dev):
    """A 16-byte leaf 8 bytes into its storage takes the row-at-a-time
    route; the result is the same."""
    vid, vcnt, uk, nu = _deliver_tables(2, 900, 4, 400)
    rng = np.random.RandomState(4)
    leaf = (rng.randn(2, uk.shape[1], 2) * 10)
    flat = torch.zeros(leaf.size + 1, dtype=torch.float64, device=dev)
    moved = flat[1:].view(leaf.shape)
    moved.copy_(_t(leaf, dev))
    _check_deliver(dev, vid, vcnt, uk, nu, [moved, _t(leaf, dev)], "max")


def _class_tables(N, caps, seed, n_unique):
    """Degree classes as the object Bagel lays them out: each class's ids
    grouped by shard in input order (unsorted), one set of unique keys."""
    rng = np.random.RandomState(seed)
    universe = 4 * (N * sum(caps) + n_unique)
    pool = rng.choice(universe, N * sum(caps), replace=False)
    classes, at = [], 0
    known = []
    for cap in caps:
        vid = np.full((N, cap), SENT, np.int64)
        vcnt = np.zeros(N, np.int32)
        for s in range(N):
            c = rng.randint(0, cap + 1)
            ids = pool[at:at + c] * N + s
            at += c
            vid[s, :c] = ids
            vcnt[s] = c
            known.append(ids)
        classes.append((vid, vcnt))
    uk = np.full((N, max(1, n_unique)), SENT, np.int64)
    nu = np.zeros(N, np.int32)
    ids = np.concatenate(known) if known else np.zeros(0, np.int64)
    for s in range(N):
        mine = ids[ids % N == s]
        keys = np.unique(np.concatenate([
            rng.choice(mine, min(len(mine), n_unique // 2), replace=False),
            rng.choice(universe, n_unique // 2) * N + s]))[:n_unique]
        uk[s, :len(keys)] = keys
        nu[s] = len(keys)
    return classes, uk, nu


@pytest.mark.parametrize("fills", [None, "zero"])
@pytest.mark.parametrize("caps", [[1], [2, 8, 64, 1024, 4096],
                                  [1] * 40])
def test_deliver_classes_match_per_class(dev, fills, caps):
    """The batched entry equals the per-class calls bit for bit (and
    their plain versions), in one launch for up to K10_MAX_CLASSES
    classes."""
    N = 4
    classes, uk, nu = _class_tables(N, caps, len(caps), 3000)
    rng = np.random.RandomState(7)
    leaves = [_t(x, dev) for x in _msg_leaves(
        rng, N, uk.shape[1], [(np.float64, ()), (np.int64, (3,)),
                              (np.int32, ())])]
    fl = [0.0, 0, 0] if fills == "zero" else None
    cls = [(_t(v, dev), _t(c, dev)) for v, c in classes]
    ukd, nud = _t(uk, dev), _t(nu, dev)
    before = kernels.LAUNCHES["pregel_deliver"]
    got = kernels.pregel_deliver_classes(cls, ukd, nud, leaves, "add", fl)
    again = kernels.pregel_deliver_classes(cls, ukd, nud, leaves, "add", fl)
    launches = -(-len(caps) // kernels.K10_MAX_CLASSES)
    assert kernels.LAUNCHES["pregel_deliver"] == before + 2 * launches
    want = kernels.pregel_deliver_classes_plain(
        [(v.cpu(), c.cpu()) for v, c in cls], uk=_t(uk), n_unique=_t(nu),
        leaves=[x.cpu() for x in leaves], combine="add", fills=fl)
    assert len(got) == len(want) == len(caps)
    for (gm, gh), (am, ah), (wm, wh), (v, c) in zip(got, again, want, cls):
        _same(list(gm) + [gh], list(wm) + [wh])
        _same(list(gm) + [gh], list(am) + [ah])
        one = kernels.pregel_deliver(v, c, ukd, nud, leaves, "add",
                                     fills=fl)
        _same(list(gm) + [gh], list(one[0]) + [one[1]])
