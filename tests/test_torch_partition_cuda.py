"""K2 (stable_partition) launched on the card against its plain version.

Every test here is marked `cuda` and skips without a card; on the card:
``python -m pytest -m cuda tests/test_torch_partition_cuda.py``.  The
file imports no JAX: the CPU tests of the plain version against the JAX
package are in tests/test_torch_collectives.py and
tests/test_torch_segtable.py.  Every comparison is exact (a stable
partition moves bits).
"""

import numpy as np
import pytest
import torch

from dpark_tpu_torch.backend.cuda import collectives, kernels

pytestmark = pytest.mark.cuda

N = 3
TILE = kernels._K2_TILE


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    kernels.build()
    return torch.device("cuda")


def _leaves(kind, cap, rng):
    """The leaf sets: "pair" an int64 key and a float64 value; "mixed"
    bool, int16, int32 and (N, cap, 3) float32 leaves; "many" the 16
    leaves a call takes, of every width."""
    if kind == "pair":
        return [rng.randint(-2 ** 62, 2 ** 62, (N, cap)).astype(np.int64),
                rng.standard_normal((N, cap))]
    if kind == "mixed":
        return [rng.rand(N, cap) < 0.5,
                rng.randint(-300, 300, (N, cap)).astype(np.int16),
                rng.randint(-2 ** 31, 2 ** 31 - 1, (N, cap)).astype(
                    np.int32),
                rng.standard_normal((N, cap, 3)).astype(np.float32)]
    dts = [np.int64, np.float64, np.int32, np.float32, np.int16, np.int8,
           np.bool_, np.uint8]
    out = []
    for i in range(kernels.MAX_LEAVES):
        shape = (N, cap) if i % 3 else (N, cap, 1 + i % 4)
        out.append((rng.randint(0, 100, shape) % 2 == 0) if dts[i % 8] ==
                   np.bool_ else rng.randint(0, 100, shape).astype(
                       dts[i % 8]))
    return out


def _bucket(pattern, nb, cap, rng):
    if pattern == "one":
        return np.full((N, cap), nb - 1, np.int32)
    if pattern == "skew":                    # one bucket holds 90%
        b = rng.randint(0, nb, (N, cap)).astype(np.int32)
        return np.where(rng.rand(N, cap) < 0.9, nb // 2, b).astype(np.int32)
    return rng.randint(0, nb, (N, cap)).astype(np.int32)


def _run(dev, bucket, nb, leaves, src=None, want_bucket=True, counts=None):
    """The kernel on the card (one launch counted, the plain version not
    called) and the plain version on the same card tensors."""
    tb = torch.from_numpy(bucket).to(dev)
    tl = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in leaves]
    ts = None if src is None else torch.from_numpy(src).to(dev)
    tc = None if counts is None else torch.from_numpy(counts).to(dev)

    def refuse(*a, **k):
        raise AssertionError("stable_partition_plain called on a CUDA "
                             "tensor")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kernels, "stable_partition_plain", refuse)
        before = kernels.LAUNCHES["stable_partition"]
        got = kernels.stable_partition(tb, nb, tl, src_idx=ts,
                                       want_bucket=want_bucket, counts=tc)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["stable_partition"] == before + (
            1 if bucket.shape[1] else 0)
    want = kernels.stable_partition_plain(tb, nb, tl, src_idx=ts,
                                          want_bucket=want_bucket)
    for g, w in zip(got[0], want[0]):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert torch.equal(got[1], want[1])
    if want_bucket:
        assert torch.equal(got[2], want[2])
    else:
        assert got[2] is None
    return got


def _perm(cap, rng):
    return np.stack([rng.permutation(cap) for _ in range(N)]).astype(
        np.int32)


@pytest.mark.parametrize("nb", [1, 2, 9, 33, 256])
@pytest.mark.parametrize("cap", [0, 1, TILE - 1, 3 * TILE + 1])
@pytest.mark.parametrize("src", [False, True])
def test_partition_matches_plain(dev, nb, cap, src):
    rng = np.random.RandomState(nb * 1000 + cap % 997 + src)
    bucket = _bucket("random", nb, cap, rng)
    _run(dev, bucket, nb, _leaves("pair", cap, rng),
         _perm(cap, rng) if src else None)


@pytest.mark.parametrize("kind", ["mixed", "many"])
@pytest.mark.parametrize("src", [False, True])
@pytest.mark.parametrize("want_bucket", [False, True])
def test_partition_leaf_widths(dev, kind, src, want_bucket):
    cap = 2 * TILE + 7
    rng = np.random.RandomState(7 + src)
    _run(dev, _bucket("random", 5, cap, rng), 5, _leaves(kind, cap, rng),
         _perm(cap, rng) if src else None, want_bucket)


@pytest.mark.parametrize("pattern", ["one", "skew"])
@pytest.mark.parametrize("nb", [2, 33])
def test_partition_one_bucket_and_skew(dev, pattern, nb):
    cap = 5 * TILE - 3
    rng = np.random.RandomState(11)
    _run(dev, _bucket(pattern, nb, cap, rng), nb, _leaves("pair", cap, rng),
         _perm(cap, rng))


@pytest.mark.parametrize("nb", [2, 9, 256])
def test_partition_with_callers_counts(dev, nb):
    """Counts the caller holds (K1's histogram) replace the kernel's
    count: the same outputs, and those counts come back."""
    cap = 3 * TILE + 5
    rng = np.random.RandomState(13)
    bucket = _bucket("random", nb, cap, rng)
    counts = np.stack([np.bincount(b, minlength=nb) for b in bucket]) \
        .astype(np.int32)
    got = _run(dev, bucket, nb, _leaves("pair", cap, rng), _perm(cap, rng),
               want_bucket=False, counts=counts)
    assert np.array_equal(got[1].cpu().numpy(), counts)


def test_partition_many_tiles_repeats_bit_for_bit(dev):
    """2^20 + 3 rows a shard (257 tiles, so the look-back walks far):
    equal to the plain version, and five launches give the same bits."""
    cap = (1 << 20) + 3
    rng = np.random.RandomState(17)
    bucket = _bucket("random", 9, cap, rng)
    leaves = _leaves("pair", cap, rng)
    src = _perm(cap, rng)
    first = _run(dev, bucket, 9, leaves, src)
    tb, ts = torch.from_numpy(bucket).to(dev), torch.from_numpy(src).to(dev)
    tl = [torch.from_numpy(x).to(dev) for x in leaves]
    for _ in range(5):
        again = kernels.stable_partition(tb, 9, tl, src_idx=ts)
        assert all(torch.equal(a, b) for a, b in zip(again[0], first[0]))
        assert torch.equal(again[2], first[2])


def test_compact_and_bucket_members_on_the_card(dev):
    """The two callers that keep no sorted bucket, against their plain
    compositions."""
    cap = 4 * TILE + 9
    rng = np.random.RandomState(19)
    mask = torch.from_numpy(rng.rand(N, cap) < 0.3).to(dev)
    leaves = [torch.from_numpy(x).to(dev) for x in _leaves("mixed", cap,
                                                            rng)]
    got, cnt = collectives.compact(leaves, mask)
    want = kernels.stable_partition_plain((~mask).to(torch.int32), 2,
                                          leaves)[0]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(cnt, mask.sum(1).to(torch.int32))
    bucket = torch.from_numpy(rng.randint(0, kernels.SIZE_CLASSES + 1, (
        N, cap)).astype(np.int32)).to(dev)
    members, counts, offsets = collectives.bucket_members(bucket)
    ids = torch.arange(cap, dtype=torch.int32, device=dev).expand(
        N, cap).contiguous()
    (w_members,), w_counts, _ = kernels.stable_partition_plain(
        bucket, kernels.SIZE_CLASSES + 1, [ids])
    assert torch.equal(members, w_members) and torch.equal(counts, w_counts)
