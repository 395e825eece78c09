"""K16 (union_concat) and K8's state gather (bucket_gather_state)
launched on the card against their plain versions.

Every test here is marked `cuda` and skips without a card; on the card:
``python -m pytest -m cuda tests/test_torch_union_cuda.py``.  The file
imports no JAX: the CPU tests of the plain versions against the JAX
package are in tests/test_torch_union.py and
tests/test_torch_state_gather.py.  Every comparison is exact (the
outputs are copies)."""

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
