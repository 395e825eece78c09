"""K17 (monoid_reduce and distinct_key_counts) launched on the card
against their plain versions.

Every test here is marked `cuda` and skips without a card; on the card:
``python -m pytest -m cuda tests/test_torch_monoid_reduce_cuda.py``.  The
file imports no JAX: the CPU tests of the plain versions against the JAX
package are in tests/test_torch_monoid_reduce.py.  Cases: ops
add/min/max/mul over int64, int32, float64, float32 and bool; ragged
counts with an empty shard, full shards, all shards empty; trailing
lanes; a column whose storage starts off a 16-byte boundary (the
kernel's unaligned head and tail); NaN and infinities for min and max;
nk = 1 and 2 key columns.  Integers, bools, min and max match exactly; a
float add or mul within 1e-12 relative (float64) and 1e-5 (float32),
since the kernel accumulates in double in another order (a float32 mul
against the plain product over the column in float64: the plain float32
product's own rounding grows with the factors); and a float sum is the
same bit for bit from launch to launch."""

import numpy as np
import pytest
import torch

from dpark_tpu_torch.backend.cuda import kernels

pytestmark = pytest.mark.cuda

N = 8
OPS = ("add", "min", "max", "mul")
DTYPES = {"int64": torch.int64, "int32": torch.int32,
          "float64": torch.float64, "float32": torch.float32,
          "bool": torch.bool}
RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    kernels.build()
    return torch.device("cuda")


def _counts(kind, cap, rng):
    if kind == "full":
        return np.full(N, cap, np.int32)
    if kind == "all empty":
        return np.zeros(N, np.int32)
    n = rng.integers(0, cap + 1, N).astype(np.int32)
    n[3] = 0
    return n


def _column(dt, op, n, shape, seed, nan=False):
    rng = np.random.default_rng(seed)
    if dt == torch.bool:
        x = torch.from_numpy(rng.random(shape) < 0.6)
    elif not dt.is_floating_point:
        lim = 4 if op == "mul" else 1 << 20
        x = torch.from_numpy(rng.integers(-lim, lim, shape)).to(dt)
    elif op == "mul":
        x = torch.from_numpy(rng.uniform(0.99, 1.01, shape)).to(dt)
    else:
        x = torch.from_numpy(rng.standard_normal(shape) * 100).to(dt)
    if nan:
        x.view(-1)[5] = float("nan")
        x.view(-1)[9] = float("-inf")
    pad = torch.arange(shape[1])[None, :] >= torch.from_numpy(n)[:, None]
    x[pad] = True if dt == torch.bool else (
        torch.finfo(dt).max if dt.is_floating_point else torch.iinfo(dt).max)
    return x


def _unaligned(x, dev):
    """x on the card in storage that starts one element past a 256-byte
    allocation: contiguous, off every 16-byte boundary (for 8-byte
    elements)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    out = buf[1:].view(x.shape)
    out.copy_(x.to(dev))
    return out


def _check(op, col, n):
    got = kernels.monoid_reduce(col, n, op)
    want = kernels.monoid_reduce_plain(col, n, op)
    if col.dtype == torch.float32 and op == "mul":
        # the plain float32 product rounds at every factor (1.5e-5 off
        # over 196,617 factors): hold the kernel's product, taken in
        # double, to the plain version's over the column in float64
        want = (kernels.monoid_reduce_plain(col.double(), n, op)[0].float(),
                ) + tuple(want[1:])
    for g, w, which in zip(got, want, (op, "min", "max")):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype.is_floating_point and which in ("add", "mul"):
            assert torch.allclose(g, w, rtol=RTOL[g.dtype], atol=0,
                                  equal_nan=True)
        else:
            same = g == w
            if g.dtype.is_floating_point:
                same |= g.isnan() & w.isnan()
            assert bool(same.all()), (which, g, w)


@pytest.mark.parametrize("counts", ["ragged", "full", "all empty"])
@pytest.mark.parametrize("dname", sorted(DTYPES))
@pytest.mark.parametrize("op", OPS)
def test_monoid_reduce_kernel_matches_plain(dev, op, dname, counts):
    cap = 4099
    seed = 10 * OPS.index(op) + len(dname)
    n = _counts(counts, cap, np.random.default_rng(seed))
    col = _column(DTYPES[dname], op, n, (N, cap), seed).to(dev)
    _check(op, col, torch.from_numpy(n).to(dev))


@pytest.mark.parametrize("dname", sorted(DTYPES))
@pytest.mark.parametrize("op", OPS)
def test_monoid_reduce_unaligned_lanes(dev, op, dname):
    """Trailing lanes over storage off a 16-byte boundary, with a large
    ragged shard: the head, the vector body and the tail all run."""
    cap = (1 << 16) + 3
    seed = 50 + OPS.index(op) + len(dname)
    n = _counts("ragged", cap, np.random.default_rng(seed))
    col = _unaligned(_column(DTYPES[dname], op, n, (N, cap, 3), seed), dev)
    _check(op, col, torch.from_numpy(n).to(dev))


@pytest.mark.parametrize("dname", ["float64", "float32"])
@pytest.mark.parametrize("op", ["min", "max", "add"])
def test_monoid_reduce_nan_and_inf(dev, op, dname):
    cap = 1000
    n = np.full(N, cap, np.int32)
    n[2] = 3                 # the NaN (row 5) lies past shard 2's count
    col = _column(DTYPES[dname], op, n, (N, cap), 7, nan=True).to(dev)
    _check(op, col, torch.from_numpy(n).to(dev))


def test_monoid_reduce_float_sum_is_reproducible(dev):
    cap = 1 << 20
    n = torch.full((N,), cap, dtype=torch.int32, device=dev)
    col = torch.randn((N, cap), dtype=torch.float64, device=dev) * 1e3
    first = kernels.monoid_reduce(col, n, "add")[0]
    for _ in range(3):
        assert torch.equal(kernels.monoid_reduce(col, n, "add")[0], first)


def test_monoid_reduce_counts_launches(dev):
    kernels.reset_launches()
    col = torch.ones((N, 64), dtype=torch.int64, device=dev)
    n = torch.full((N,), 10, dtype=torch.int32, device=dev)
    red = kernels.monoid_reduce(col, n, "add")[0]
    assert kernels.LAUNCHES["monoid_reduce"] == 1
    assert red.tolist() == [10] * N


@pytest.mark.parametrize("counts", ["ragged", "full", "all empty"])
@pytest.mark.parametrize("dname", ["int64", "int32", "float64", "float32"])
@pytest.mark.parametrize("nk", [1, 2])
def test_distinct_key_counts_kernel_matches_plain(dev, nk, dname, counts):
    cap = 5003
    rng = np.random.default_rng(nk + len(dname))
    n = _counts(counts, cap, rng)
    dt = DTYPES[dname]
    cols = [np.sort(rng.integers(0, 50, (N, cap)), axis=1)
            for _ in range(nk)]
    if nk == 2:                        # lexicographic: (k0, k1) sorted
        order = np.lexsort([cols[1], cols[0]], axis=1)
        cols = [np.take_along_axis(c, order, 1) for c in cols]
    keys = [torch.from_numpy(c).to(dt).to(dev) for c in cols]
    if dt.is_floating_point:
        keys[0][1, 7] = float("nan")   # differs from both neighbours
    nt = torch.from_numpy(n).to(dev)
    kernels.reset_launches()
    got = kernels.distinct_key_counts(keys, nt)
    assert kernels.LAUNCHES["distinct_key_counts"] == 1
    assert torch.equal(got, kernels.distinct_key_counts_plain(keys, nt))
