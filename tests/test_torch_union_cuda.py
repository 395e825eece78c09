"""K16 (union_concat) and K8's state gather (bucket_gather_state)
launched on the card against their plain versions.

Every test here is marked `cuda` and skips without a card; on the card:
``python -m pytest -m cuda tests/test_torch_union_cuda.py``.  The file
imports no JAX: the CPU tests of the plain versions against the JAX
package are in tests/test_torch_union.py and
tests/test_torch_state_gather.py.  Every comparison is exact (the
outputs are copies).

K16's byte spans: rows of 1, 2, 4, 6, 8 and 16 bytes; source and output
offsets that differ mod 16 (odd counts of 8-byte rows, 6-byte rows, and
sources one element into their storage); a shard that is all tail; the
most descriptors the wrapper takes in one call at k = 12, N = 8 and 16
leaves (104 rows, more than one launch's 64); int32, int64 and float64
key fills."""

import numpy as np
import pytest
import torch

from dpark_tpu_torch.backend.cuda import collectives, kernels
from dpark_tpu_torch.backend.cuda.layout import round_capacity

pytestmark = pytest.mark.cuda

N = 3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    kernels.build()
    return torch.device("cuda")


def _branches(k, caps, seed, dev, vector=False):
    rng = np.random.RandomState(seed)
    out = []
    for j in range(k):
        cap = caps[j % len(caps)]
        n = rng.randint(0, cap + 1, N).astype(np.int32)
        if j == 1:
            n[0] = 0                         # an empty shard of a branch
        leaves = [rng.randint(-1000, 1000, (N, cap)).astype(np.int64),
                  rng.standard_normal((N, cap)),
                  rng.randint(0, 100, (N, cap)).astype(np.int32)]
        if vector:
            leaves.append(rng.randint(0, 9, (N, cap, 3)).astype(np.int16))
        out.append(([torch.from_numpy(c).to(dev) for c in leaves],
                    torch.from_numpy(n).to(dev)))
    return out


@pytest.mark.parametrize("k,caps", [(1, [5]), (2, [8, 1000]),
                                    (12, [8, 64, 4097])])
@pytest.mark.parametrize("key_leaf", [0, None])
def test_union_concat_kernel_matches_plain(dev, k, caps, key_leaf):
    branches = _branches(k, caps, 3 + k, dev, vector=key_leaf is None)
    got = kernels.union_concat(branches, key_leaf=key_leaf)
    want = kernels.union_concat_plain(branches, key_leaf=key_leaf)
    for x, y in zip(got[0], want[0]):
        assert x.shape == y.shape and torch.equal(x, y)
    assert torch.equal(got[1], want[1])


KINDS = {1: (np.int8, ()), 2: (np.int16, ()), 4: (np.int32, ()),
         6: (np.int16, (3,)), 8: (np.int64, ()), 16: (np.float64, (2,))}


def _span_branches(k, N_, caps, widths, seed, dev, offset=0, tail_shard=None,
                   key=np.int64):
    """k branches over N_ shards: a key leaf of `key`, then one leaf a
    width in `widths`; counts ragged (odd ones included), shard
    `tail_shard` empty in every branch; each leaf `offset` elements into
    its storage."""
    rng = np.random.RandomState(seed)
    out = []
    for j in range(k):
        cap = caps[j % len(caps)]
        n = rng.randint(0, cap + 1, N_)
        n[rng.randint(N_)] |= 1
        if tail_shard is not None:
            n[tail_shard] = 0
        leaves = [rng.randint(-1000, 1000, (N_, cap)).astype(key)]
        for w in widths:
            dt, shp = KINDS[w]
            leaves.append(rng.randint(-100, 100, (N_, cap) + shp).astype(dt))
        lv = []
        for a in leaves:
            t = torch.from_numpy(a).to(dev)
            if offset:
                big = torch.empty(t.numel() + offset, dtype=t.dtype,
                                  device=dev)
                big[offset:] = t.reshape(-1)
                t = big[offset:].view(t.shape)
            lv.append(t)
        out.append((lv, torch.from_numpy(n.astype(np.int32)).to(dev)))
    return out


def _same(branches, key_leaf=0, key_fill=kernels.KEY_SENTINEL):
    before = kernels.LAUNCHES["union_concat"]
    got = kernels.union_concat(branches, key_leaf, key_fill)
    assert kernels.LAUNCHES["union_concat"] == before + 1
    want = kernels.union_concat_plain(branches, key_leaf, key_fill)
    for x, y in zip(got[0], want[0]):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x.view(-1).view(torch.uint8),
                           y.view(-1).view(torch.uint8))
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("k,caps", [(2, [4097, 1000]), (3, [8, 333, 2048]),
                                    (5, [65536, 3])])
def test_union_concat_spans(dev, k, caps, offset):
    """Rows of 1-16 bytes at every relative offset mod 16, one shard all
    tail; sources aligned and one element into their storage."""
    branches = _span_branches(k, 6, caps, [1, 2, 4, 6, 8, 16], 40 + k, dev,
                              offset=offset, tail_shard=2)
    if offset:
        assert branches[0][0][1].data_ptr() % 16 != 0
    _same(branches)
    _same(branches, key_leaf=None)


def test_union_concat_most_descriptors(dev):
    """k = 12 branches over 8 shards with 16 leaves: 104 descriptor rows
    (12 x 8 ranges and 8 tails), past one launch's table."""
    widths = [1, 2, 4, 6, 8, 16, 8, 4, 2, 1, 16, 6, 8, 4, 2]
    branches = _span_branches(12, 8, [100, 1 << 14, 7], widths, 77, dev)
    for _, n in branches:
        n.clamp_(min=1)
    assert len(branches[0][0]) == kernels.MAX_LEAVES
    _same(branches)


@pytest.mark.parametrize("key,fill", [(np.float64, float("inf")),
                                      (np.int32, np.iinfo(np.int32).max),
                                      (np.int64, -5)])
def test_union_concat_key_fills(dev, key, fill):
    """The tail's key fill at 4 and 8 bytes, a float64 sentinel among
    them, over tails that start at odd rows."""
    branches = _span_branches(3, 4, [1000, 17], [8, 6], 91, dev, key=key)
    _same(branches, 0, fill)


@pytest.mark.parametrize("pad", ["zero", "edge"])
@pytest.mark.parametrize("widest", [64, 4096])
def test_state_gather_kernel_matches_plain(dev, pad, widest):
    """Random key-sorted groups up to `widest` rows (the warp form below
    129 columns, the block form above), about half of them with one
    carried row, every size class."""
    rng = np.random.RandomState(widest)
    cap = 1 << 15
    keys = np.full((N, cap), np.iinfo(np.int64).max, np.int64)
    flags = np.zeros((N, cap), np.int64)
    vals = rng.standard_normal((N, cap))
    n = np.zeros(N, np.int32)
    for s in range(N):
        at, key = 0, 0
        while True:
            size = int(min(widest, rng.geometric(0.05)))
            if at + size > cap - 1:
                break
            keys[s, at:at + size] = key
            if rng.rand() < 0.5:
                flags[s, at + rng.randint(size)] = 1
            at += size
            key += 1 + rng.randint(3)
        n[s] = at
    kt, ft, vt, nt = (torch.from_numpy(a).to(dev)
                      for a in (keys, flags, vals, n))
    start_rows, sizes, bucket, _, hist, _ = kernels.segment_table([kt], nt)
    members, counts, offsets = collectives.bucket_members(bucket)
    gmax = hist.cpu().numpy().max(0)
    assert gmax.any()
    for b in np.flatnonzero(gmax).tolist():
        G, B = round_capacity(int(gmax[b])), 1 << b
        args = (start_rows, sizes, members, offsets[:, b].contiguous(),
                counts[:, b].contiguous(), G, B, vt, ft, pad)
        for x, y in zip(kernels.bucket_gather_state(*args),
                        kernels.bucket_gather_state_plain(*args)):
            assert torch.equal(x, y), b
