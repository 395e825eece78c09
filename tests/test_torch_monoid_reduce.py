"""K17 (kernels.monoid_reduce and kernels.distinct_key_counts, B9's
masked per-shard reductions) on the CPU, where their plain PyTorch
versions run, against the JAX package's functions they replace on the
same seeded numpy inputs: JAXExecutor._monoid_reduce (the reduce action's
per-device reduction with its min and max) and
JAXExecutor._distinct_key_counts (a bare groupByKey().count() over
key-sorted rows) on the reference's tpu:8 executor, and, for what
_monoid_reduce does not take (bool columns, trailing lanes), the Pregel
aggregator's and active count's jnp expressions
(backend/tpu/bagel.py:341-352, 390: _local_reduce over jnp.where with the
monoid's identity, jnp.sum of the active flags).

Cases: ops add/min/max/mul; int64, int32, float64, float32 and bool;
ragged counts with an empty shard, full shards, all shards empty; rows
past each shard's count hold values that would change every result if
read; nk = 1 and 2 key columns.  Integers, bools, min and max match
exactly; a float add or mul within 1e-12 relative (float64) and 1e-5
(float32): the two sum in another order.  The kernel itself runs in
tests/test_torch_monoid_reduce_cuda.py, on a card only."""

import numpy as np
import pytest
import torch

from dpark_tpu_torch.backend.cuda import kernels
from dpark_tpu_torch.backend.cuda.executor import TorchExecutor
from dpark_tpu_torch.backend.cuda.layout import Batch

N = 8
OPS = ("add", "min", "max", "mul")
DTYPES = {"int64": np.int64, "int32": np.int32, "float64": np.float64,
          "float32": np.float32, "bool": np.bool_}
RTOL = {"float64": 1e-12, "float32": 1e-5}
COUNTS = ("ragged", "full", "all empty")


@pytest.fixture(scope="module")
def ref():
    """The reference's tpu:8 executor (x64 on), its Batch and the Pregel
    reduction helpers."""
    from dpark_tpu import DparkContext as RefContext
    from dpark_tpu.backend.tpu import bagel as ref_bagel
    from dpark_tpu.backend.tpu import layout as ref_layout
    from dpark_tpu.bagel import monoid_identity
    c = RefContext("tpu:8")
    c.start()
    yield c.scheduler.executor, ref_layout.Batch, ref_bagel, monoid_identity
    c.stop()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _counts(kind, cap, rng):
    if kind == "full":
        return np.full(N, cap, np.int32)
    if kind == "all empty":
        return np.zeros(N, np.int32)
    n = rng.integers(0, cap + 1, N).astype(np.int32)
    n[3] = 0
    return n


def _column(dname, op, counts, cap, seed, lanes=()):
    """(N, cap, *lanes) values of the dtype; past each shard's count the
    dtype's extreme (or True), which every reduction would notice."""
    rng = np.random.default_rng(seed)
    dt = DTYPES[dname]
    shape = (N, cap) + lanes
    if dname == "bool":
        x = rng.random(shape) < 0.6
    elif np.issubdtype(dt, np.integer):
        lim = 4 if op == "mul" else 1000
        x = rng.integers(-lim, lim, shape).astype(dt)
    elif op == "mul":
        x = rng.uniform(0.5, 1.5, shape).astype(dt)
    else:
        x = (rng.standard_normal(shape) * 100).astype(dt)
    pad = np.arange(cap)[None, :] >= counts[:, None]
    if dname == "bool":
        fill = True
    elif np.issubdtype(dt, np.integer):
        fill = np.iinfo(dt).max
    else:
        fill = np.finfo(dt).max
    x[pad] = fill
    return x


def _assert_same(dname, op, got, want):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape == (N,)
    if dname.startswith("float") and op in ("add", "mul"):
        assert np.allclose(got, want, rtol=RTOL[dname], atol=0)
    else:
        assert np.array_equal(got.astype(np.float64),
                              want.astype(np.float64))


@pytest.mark.parametrize("counts", COUNTS)
@pytest.mark.parametrize("dname", ["int64", "int32", "float64", "float32"])
@pytest.mark.parametrize("op", OPS)
def test_plain_matches_ref_monoid_reduce(ref, op, dname, counts):
    ex, RefBatch, _, _ = ref
    cap = 37
    seed = 10 * OPS.index(op) + len(dname) + COUNTS.index(counts)
    n = _counts(counts, cap, np.random.default_rng(seed))
    col = _column(dname, op, n, cap, seed)
    red, lo, hi = kernels.monoid_reduce(_t(col), _t(n), op)
    assert red.dtype == kernels.monoid_out_dtype(op, _t(col).dtype)
    assert lo.dtype == hi.dtype == _t(col).dtype
    want = ex._monoid_reduce(RefBatch(0, [col], n), op)
    for g, w, which in ((red, want[0], op), (lo, want[1], "min"),
                        (hi, want[2], "max")):
        _assert_same(dname, which, g.numpy(), w)


def _ref_pregel_reduce(ref, op, x, n):
    """The reference Pregel aggregator's per-device expression (bool: the
    active count's jnp.sum, min and max as jnp.all and jnp.any)."""
    import jax.numpy as jnp
    _, _, ref_bagel, monoid_identity = ref
    out = []
    for s in range(N):
        valid = jnp.arange(x.shape[1]) < n[s]
        leaf = jnp.asarray(x[s])
        flag = valid.reshape(valid.shape + (1,) * (leaf.ndim - 1))
        if x.dtype == np.bool_:
            v = leaf & flag
            out.append({"add": jnp.sum(v), "mul": jnp.all(leaf | ~flag),
                        "min": jnp.all(leaf | ~flag),
                        "max": jnp.any(v)}[op])
        else:
            masked = jnp.where(flag, leaf, monoid_identity(op, x.dtype))
            out.append(ref_bagel._local_reduce(op, masked))
    return np.stack([np.asarray(o) for o in out])


@pytest.mark.parametrize("counts", COUNTS)
@pytest.mark.parametrize("op", OPS)
def test_plain_bool_matches_ref_active_count(ref, op, counts):
    cap = 41
    seed = 100 + OPS.index(op) + 7 * COUNTS.index(counts)
    n = _counts(counts, cap, np.random.default_rng(seed))
    col = _column("bool", op, n, cap, seed)
    red, lo, hi = kernels.monoid_reduce(_t(col), _t(n), op)
    assert red.dtype == (torch.bool if op in ("min", "max") else torch.int64)
    assert lo.dtype == hi.dtype == torch.bool
    _assert_same("bool", op, red.numpy(), _ref_pregel_reduce(ref, op, col, n))
    _assert_same("bool", "min", lo.numpy(),
                 _ref_pregel_reduce(ref, "min", col, n))
    _assert_same("bool", "max", hi.numpy(),
                 _ref_pregel_reduce(ref, "max", col, n))


@pytest.mark.parametrize("dname", ["int64", "float64", "float32", "int32"])
@pytest.mark.parametrize("op", OPS)
def test_plain_lanes_match_ref_aggregator(ref, op, dname):
    """An (N, cap, 3) leaf reduces over every trailing lane, as the
    reference's _local_reduce over a device block does."""
    cap = 19
    seed = 200 + OPS.index(op) + len(dname)
    n = _counts("ragged", cap, np.random.default_rng(seed))
    col = _column(dname, op, n, cap, seed, lanes=(3,))
    red, lo, hi = kernels.monoid_reduce(_t(col), _t(n), op)
    _assert_same(dname, op, red.numpy(), _ref_pregel_reduce(ref, op, col, n))
    _assert_same(dname, "min", lo.numpy(),
                 _ref_pregel_reduce(ref, "min", col, n))
    _assert_same(dname, "max", hi.numpy(),
                 _ref_pregel_reduce(ref, "max", col, n))


def _sorted_keys(nk, cap, n, seed, dt):
    """nk (N, cap) key columns, lexicographically sorted over each
    shard's first n[s] rows (many repeats), the sentinel past them."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, 5, (N, cap)).astype(dt) for _ in range(nk)]
    for s in range(N):
        order = np.lexsort([c[s] for c in cols[::-1]])
        for c in cols:
            c[s] = c[s][order]
    for c in cols:
        c[np.arange(cap)[None, :] >= n[:, None]] = (
            np.iinfo(dt).max if np.issubdtype(dt, np.integer)
            else np.finfo(dt).max)
    return cols


@pytest.mark.parametrize("counts", COUNTS)
@pytest.mark.parametrize("dt", [np.int64, np.float64])
@pytest.mark.parametrize("nk", [1, 2])
def test_plain_matches_ref_distinct_key_counts(ref, nk, dt, counts):
    ex, RefBatch, _, _ = ref
    cap = 53
    seed = 300 + nk + 5 * COUNTS.index(counts)
    n = _counts(counts, cap, np.random.default_rng(seed))
    keys = _sorted_keys(nk, cap, n, seed, dt)
    got = kernels.distinct_key_counts([_t(k) for k in keys], _t(n))
    assert got.dtype == torch.int64
    want = ex._distinct_key_counts(RefBatch(0, keys, n), nk=nk)
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_executor_routes_through_k17():
    """The executor's B9 sites call K17's wrappers (on the CPU, their
    plain versions): the reduce action's reduction and a groupByKey
    count's distinct keys."""
    ex = TorchExecutor(N, "cpu")
    rng = np.random.default_rng(5)
    n = _counts("ragged", 29, rng)
    col = _column("int64", "add", n, 29, 5)
    got = ex._monoid_reduce(Batch(0, [_t(col)], _t(n)), "add")
    want = kernels.monoid_reduce_plain(_t(col), _t(n), "add")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    keys = _sorted_keys(2, 29, n, 6, np.int64)
    got = ex._distinct_key_counts(Batch(0, [_t(k) for k in keys] + [
        _t(col)], _t(n)), 2)
    assert torch.equal(got, kernels.distinct_key_counts_plain(
        [_t(k) for k in keys], _t(n)))


def test_wrappers_refuse_what_the_kernel_does_not_take():
    n = torch.zeros(N, dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.monoid_reduce(torch.zeros((N, 4), dtype=torch.int16), n,
                              "add")
    with pytest.raises(ValueError):
        kernels.monoid_reduce(torch.zeros((N, 4)), n, "last")
    with pytest.raises(ValueError):
        kernels.monoid_reduce(torch.zeros((N, 4)), n.long(), "add")
    with pytest.raises(ValueError):
        kernels.distinct_key_counts([torch.zeros((N, 4), dtype=torch.bool)],
                                    n)
