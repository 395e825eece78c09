"""K17's active count (active_count, and monoid_reduce over bool) and
K8's batched scatter (bucket_scatter_classes, and the single-class
bucket_scatter over the same kernel) launched on the card against their
plain versions, bit for bit.

Every test here is marked `cuda` and skips without a card; on the card:
``python -m pytest -m cuda tests/test_torch_count_scatter_cuda.py``.  The
file imports no JAX: the CPU tests of the plain versions against the JAX
package are in tests/test_torch_count_scatter.py.  Cases: caps on both
sides of the 16-byte word and of a block's 16 KiB of words, masks that
start off a 16-byte boundary, trailing lanes, ragged and empty shards,
valid counts past cap, 1 to 70 classes (past K17C_MAX_CLASSES: several
launches, each counted); the scatter over tables of 1 to 17 size
classes, at caps around its 1,024-slot tile, output leaves of 1, 2, 4 and
8 bytes, a table with no groups, and 16 leaves over 17 classes (past
K8X_MAX_RESULTS: two launches).  Each call is one counted launch (or the
stated several), and two calls give the same bits."""

import numpy as np
import pytest
import torch

from dpark_tpu_torch.backend.cuda import collectives, kernels
from dpark_tpu_torch.backend.cuda.executor import TorchExecutor

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    kernels.build()
    return torch.device("cuda")


def _launched(key, fn):
    before = kernels.LAUNCHES[key]
    out = fn()
    torch.cuda.synchronize()
    return out, kernels.LAUNCHES[key] - before


# ---------------------------------------------------------------------
# K17: the bool count
# ---------------------------------------------------------------------
EDGE_CAPS = [1, 15, 16, 17, 31, 33, 4095, 4096, 4097, 16389, (1 << 20) + 3]


def _mask(dev, N, cap, lanes, seed, offset=0, p=0.5):
    """An (N, cap[, lanes]) bool mask on the card, True past n as well
    (only the first n rows may count), its storage `offset` bytes past a
    fresh allocation."""
    rng = np.random.default_rng(seed)
    shape = (N, cap) + ((lanes,) if lanes > 1 else ())
    m = torch.from_numpy(rng.random(shape) < p)
    buf = torch.empty(m.numel() + offset, dtype=torch.bool, device=dev)
    out = buf[offset:].view(shape)
    out.copy_(m.to(dev))
    return out


def _ns(dev, N, cap, seed, kind="ragged"):
    rng = np.random.default_rng(seed + 1)
    if kind == "full":
        n = np.full(N, cap, np.int32)
    elif kind == "empty":
        n = np.zeros(N, np.int32)
    else:
        n = rng.integers(0, cap + 1, N).astype(np.int32)
        n[0] = 0
        n[-1] = cap + 5                  # past cap: every row counts
    return torch.from_numpy(n).to(dev)


@pytest.mark.parametrize("cap", EDGE_CAPS)
@pytest.mark.parametrize("offset", [0, 3])
def test_active_count_one_class(dev, cap, offset):
    m = _mask(dev, 8, cap, 1, cap, offset)
    n = _ns(dev, 8, cap, cap)
    got, launches = _launched("active_count",
                              lambda: kernels.active_count([m], [n]))
    assert launches == 1
    assert got.dtype == torch.int64 and got.dim() == 0 and got.is_cuda
    assert int(got) == int(kernels.active_count_plain([m], [n]))
    assert torch.equal(got, kernels.active_count([m], [n]))


@pytest.mark.parametrize("nc", [1, 7, 32, 33, 70])
def test_active_count_classes(dev, nc):
    rng = np.random.default_rng(nc)
    caps = [int(rng.choice(EDGE_CAPS[:-1])) for _ in range(nc)]
    masks = [_mask(dev, 8, c, 1 + (i % 3 == 2) * 2, i, i % 5)
             for i, c in enumerate(caps)]
    ns = [_ns(dev, 8, c, i, ("ragged", "full", "empty")[i % 3])
          for i, c in enumerate(caps)]
    got, launches = _launched("active_count",
                              lambda: kernels.active_count(masks, ns))
    assert launches == -(-nc // kernels.K17C_MAX_CLASSES)
    assert int(got) == int(kernels.active_count_plain(masks, ns))
    assert torch.equal(got, kernels.active_count(masks, ns))


def test_active_count_bench_shape(dev):
    m = _mask(dev, 8, 8_388_608, 1, 5)
    n = _ns(dev, 8, 8_388_608, 5, "full")
    got = kernels.active_count([m], [n])
    assert int(got) == int(m.sum())


@pytest.mark.parametrize("op", ["add", "min", "max", "mul"])
@pytest.mark.parametrize("cap", [1, 17, 4097, (1 << 20) + 3])
@pytest.mark.parametrize("kind", ["ragged", "full", "empty"])
def test_bool_monoid_reduce(dev, op, cap, kind):
    for p in (0.5, 1.0):               # with and without a False
        m = _mask(dev, 8, cap, 2, cap, 1, p)
        n = _ns(dev, 8, cap, cap, kind)
        got, launches = _launched("monoid_reduce",
                                  lambda: kernels.monoid_reduce(m, n, op))
        assert launches == 1
        want = kernels.monoid_reduce_plain(m, n, op)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


def test_active_count_refuses(dev):
    m = _mask(dev, 8, 64, 1, 0)
    n = _ns(dev, 8, 64, 0)
    with pytest.raises(ValueError):
        kernels.active_count([m.to(torch.uint8)], [n])
    with pytest.raises(ValueError):
        kernels.active_count([m[:, ::2]], [n])
    with pytest.raises(ValueError):
        kernels.active_count([m], [n.cpu()])


# ---------------------------------------------------------------------
# K8: the batched scatter
# ---------------------------------------------------------------------
def _table(dev, plan, cap):
    """K7's table and K2's members of key-sorted shards whose groups have
    the sizes of `plan` (a list a shard); the layout as the executor
    makes it."""
    rng = np.random.default_rng(len(plan) * 31 + cap)
    N = len(plan)
    keys = np.full((N, cap), np.iinfo(np.int64).max, np.int64)
    n = np.zeros(N, np.int32)
    for s, sizes in enumerate(plan):
        ks = np.sort(rng.choice(10 ** 9, len(sizes), replace=False))
        assert sum(sizes) <= cap
        keys[s, :sum(sizes)] = np.repeat(ks, sizes)
        n[s] = sum(sizes)
    table = collectives._segment_table(
        [torch.from_numpy(keys).to(dev)], torch.from_numpy(n).to(dev))
    members, counts, offsets = collectives.bucket_members(
        table[2], table[4], table[3])
    return members, counts, offsets, TorchExecutor._seg_bucket_layout(
        table[4])


def _results(dev, lay, N, dtypes, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = []
    for _, _, G in lay:
        res = []
        for dt in dtypes:
            x = torch.randint(-2 ** 15, 2 ** 15, (N, G), generator=gen,
                              device=dev)
            res.append(x.to(dt) if not dt.is_floating_point
                       else (x.to(torch.float64) / 7).to(dt))
        out.append(res)
    return out


def _plan(rng, N, cap, widest):
    plan = []
    for _ in range(N):
        sizes = []
        while True:
            size = int(1 << rng.integers(0, widest + 1))
            size = max(1, size - int(rng.integers(0, 2)) * (size // 3))
            if sum(sizes) + size > cap - int(rng.integers(0, 40)):
                break
            sizes.append(size)
        plan.append(sizes)
    return plan


SCATTER_DTYPES = [torch.int64, torch.float64, torch.int32, torch.float32,
                  torch.int16, torch.float16, torch.int8, torch.bool]


@pytest.mark.parametrize("cap", [1023, 1024, 1025, 3000, 70_001])
def test_scatter_classes(dev, cap):
    rng = np.random.default_rng(cap)
    widest = min(14, int(np.log2(cap)))
    members, counts, offsets, lay = _table(dev, _plan(rng, 8, cap, widest),
                                           cap)
    classes = [b for b, _, _ in lay]
    assert len(classes) > 1
    for dtypes in ([torch.int64], SCATTER_DTYPES):
        res = _results(dev, lay, 8, dtypes, cap)
        got, launches = _launched("bucket_scatter", lambda: (
            kernels.bucket_scatter_classes(res, members, offsets, counts,
                                           classes, dtypes)))
        assert launches == 1
        want = kernels.bucket_scatter_classes_plain(
            res, members, offsets, counts, classes, dtypes)
        again = kernels.bucket_scatter_classes(res, members, offsets,
                                               counts, classes, dtypes)
        for g, w, a in zip(got, want, again):
            assert g.dtype == w.dtype
            assert torch.equal(g, w) and torch.equal(g, a)
        # only the members of listed classes hold results
        sub = classes[::2]
        got = kernels.bucket_scatter_classes(
            res[::2], members, offsets, counts, sub, dtypes)
        want = kernels.bucket_scatter_classes_plain(
            res[::2], members, offsets, counts, sub, dtypes)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_scatter_classes_no_groups(dev):
    members, counts, offsets, lay = _table(dev, [[]] * 8, 4097)
    assert lay == ((0, 1, 8),)
    res = _results(dev, lay, 8, [torch.float64], 1)
    got, launches = _launched("bucket_scatter", lambda: (
        kernels.bucket_scatter_classes(res, members, offsets, counts, [0],
                                       [torch.float64])))
    assert launches == 1
    assert torch.equal(got[0], torch.zeros_like(got[0]))


def test_scatter_classes_past_parameter_space(dev):
    # 17 classes (sizes 1 .. 2^16) a shard, 16 leaves: 272 result
    # pointers, more than K8X_MAX_RESULTS, so two launches by leaves
    plan = [[1 << b for b in range(17)] + [3, 5], [1 << b for b in
                                                   range(16, -1, -1)]]
    members, counts, offsets, lay = _table(dev, plan, 140_000)
    classes = [b for b, _, _ in lay]
    assert len(classes) == 17
    dtypes = [SCATTER_DTYPES[i % len(SCATTER_DTYPES)] for i in range(16)]
    res = _results(dev, lay, 2, dtypes, 17)
    got, launches = _launched("bucket_scatter", lambda: (
        kernels.bucket_scatter_classes(res, members, offsets, counts,
                                       classes, dtypes)))
    assert launches == 2 == -(-16 // (kernels.K8X_MAX_RESULTS // 17))
    want = kernels.bucket_scatter_classes_plain(res, members, offsets,
                                                counts, classes, dtypes)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("cap", [1025, 70_001])
def test_scatter_one_class_in_place(dev, cap):
    rng = np.random.default_rng(cap + 1)
    members, counts, offsets, lay = _table(dev, _plan(rng, 8, cap, 10),
                                           cap)
    dtypes = [torch.int64, torch.float32, torch.int16]
    for (b, _, G), res in zip(lay, _results(dev, lay, 8, dtypes, 3)):
        boff, bcnt = offsets[:, b].contiguous(), counts[:, b].contiguous()
        base = [torch.randint(-9, 9, (8, cap), device=dev).to(dt)
                for dt in dtypes]
        o1 = [x.clone() for x in base]
        o2 = [x.clone() for x in base]
        _, launches = _launched("bucket_scatter", lambda: (
            kernels.bucket_scatter(o1, res, members, boff, bcnt)))
        assert launches == 1
        kernels.bucket_scatter_plain(o2, res, members, boff, bcnt)
        assert all(torch.equal(x, y) for x, y in zip(o1, o2))


def test_scatter_classes_refuses(dev):
    members, counts, offsets, lay = _table(dev, [[1, 2, 3]] * 8, 64)
    res = _results(dev, lay, 8, [torch.int64], 0)
    classes = [b for b, _, _ in lay]
    with pytest.raises(ValueError):
        kernels.bucket_scatter_classes(res, members, offsets[:, :-1],
                                       counts, classes, [torch.int64])
    with pytest.raises(ValueError):
        kernels.bucket_scatter_classes(res, members, offsets, counts,
                                       classes, [torch.float64])
    with pytest.raises(ValueError):
        kernels.bucket_scatter_classes([[r[0].cpu()] for r in res],
                                       members, offsets, counts, classes,
                                       [torch.int64])
