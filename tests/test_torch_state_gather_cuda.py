"""K8's state gather (bucket_gather_state) launched on the card against
its plain version, at every class width from 1 to 2^19.

Every test here is marked `cuda` and skips without a card; on the card:
``python -m pytest -m cuda tests/test_torch_state_gather_cuda.py``.  The
file imports no JAX: the CPU tests of the plain version against the JAX
package are in tests/test_torch_state_gather.py.  Every comparison is
exact (the outputs are copies).

The groups of two shards: one of 2^b rows and one of 2^(b-1) + 1 (b >=
1) in each class b up to 19, about half of them with a carried row
(flag 1); in class 19, one group with its flag-1 row in its first, a
middle and its last chunk of K8S_CHUNK slots each; a group of only new
values; a group with no new value (its rows flag 2, as the reference's
pad slots, beside one flag-1 row); a group of one chunk plus 3 rows.
Each class runs at its own G and, in class 19, at G = 64 (a few live
lanes among many dead ones)."""

import numpy as np
import pytest
import torch

from dpark_tpu_torch.backend.cuda import collectives, kernels
from dpark_tpu_torch.backend.cuda.layout import round_capacity

pytestmark = pytest.mark.cuda

CHUNK = 4096             # kernels._K8S_CHUNK (held to the source on the CPU)
WIDEST = 19


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    kernels.build()
    return torch.device("cuda")


def _groups(rng, s):
    """(size, flags or None for random) of shard s's groups."""
    out = []
    for b in range(WIDEST + 1):
        sizes = [1 << b] + ([(1 << (b - 1)) + 1] if b >= 1 else [])
        out += [(n, None) for n in sizes[s::2] or sizes]
    B = 1 << WIDEST
    if s == 0:
        for at in (0, B // 2 + 7, B - 1):            # first, middle, last
            f = np.zeros(B, np.int64)
            f[at] = 1
            out.append((B, f))
        out.append((B - 5, np.zeros(B - 5, np.int64)))  # only new values
    else:
        f = np.full(B - 9, 2, np.int64)                 # no new value
        f[100] = 1
        out.append((B - 9, f))
        out.append((CHUNK + 3, None))                  # one chunk plus 3
    return out


@pytest.fixture(scope="module")
def table(dev):
    """The two shards' keys, flags and a seed's values, key-sorted, and
    their segment table and class members (K7 and K2 on the card)."""
    rng = np.random.RandomState(20261018)
    plans = [_groups(rng, s) for s in range(2)]
    n = [sum(size for size, _ in p) for p in plans]
    cap = round_capacity(max(n) + 1)
    keys = np.full((2, cap), np.iinfo(np.int64).max, np.int64)
    flags = np.zeros((2, cap), np.int64)
    for s, plan in enumerate(plans):
        at = 0
        for key, (size, f) in enumerate(plan):
            keys[s, at:at + size] = key
            if f is None:
                f = np.zeros(size, np.int64)
                if rng.rand() < 0.5:
                    f[rng.randint(size)] = 1
            flags[s, at:at + size] = f
            at += size
    kt, ft = (torch.from_numpy(a).to(dev) for a in (keys, flags))
    nt = torch.tensor(n, dtype=torch.int32, device=dev)
    start_rows, sizes, bucket, _, hist, _ = kernels.segment_table([kt], nt)
    members, counts, offsets = collectives.bucket_members(bucket)
    return (start_rows, sizes, members, counts, offsets,
            hist.cpu().numpy().max(0), ft, rng.standard_normal((2, cap)))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.int64])
@pytest.mark.parametrize("pad", ["zero", "edge"])
def test_state_gather_every_class(dev, table, dtype, pad):
    start_rows, sizes, members, counts, offsets, gmax, ft, draw = table
    vals = torch.from_numpy(draw * 1000).to(dtype).to(dev)
    assert (np.flatnonzero(gmax) == np.arange(WIDEST + 1)).all()
    for b in range(WIDEST + 1):
        boff, bcnt = offsets[:, b].contiguous(), counts[:, b].contiguous()
        Gs = [round_capacity(int(gmax[b]))]
        if b == WIDEST:
            Gs.append(64)                    # one live lane a shard of 64
        for G in Gs:
            args = (start_rows, sizes, members, boff, bcnt, G, 1 << b, vals,
                    ft, pad)
            before = kernels.LAUNCHES["bucket_gather_state"]
            got = kernels.bucket_gather_state(*args)
            assert kernels.LAUNCHES["bucket_gather_state"] == before + 1
            want = kernels.bucket_gather_state_plain(*args)
            for name, x, y in zip(("out", "prev", "has_prev"), got, want):
                assert x.dtype == y.dtype and torch.equal(x, y), (b, G, name)
