"""K3 (reduce_by_key_compact) launched on the card against its plain
version.  Its tiles are kernels._K3_TILE rows; a tile with many runs
("short", "distinct") stages its outputs in shared memory, one with few
writes them directly: the patterns cover both.

Every test here is marked `cuda` and skips without a card; on the card:
``python -m pytest -m cuda tests/test_torch_reduce_by_key_cuda.py``.  The
file imports no JAX: the CPU tests of the plain version against the JAX
package are in tests/test_torch_reduce_by_key.py.  Integers and op
"last" must be bit-equal; float min and max equal (-0.0 equal to 0.0)
with NaN in the same slots; float sums and products within rtol 1e-12
of the plain version (another association), and the same bits from one
launch to the next.
"""

import numpy as np
import pytest
import torch

from dpark_tpu_torch.backend.cuda import kernels

pytestmark = pytest.mark.cuda

N = 3
TILE = kernels._K3_TILE
RTOL = 1e-12
SENT = np.iinfo(np.int64).max
OPS = ["add", "min", "max", "mul", "last"]
PATTERNS = ["short", "within", "two", "many", "one", "distinct"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    kernels.build()
    return torch.device("cuda")


def _runs(pattern, cap, rng):
    """(N, cap) run ids, nondecreasing along each shard: runs of 1-4 rows
    ("short"), ~64 ("within" a tile), ~TILE ("two" tiles each), ~2.5
    tiles ("many"), one run a shard ("one"), every row its own
    ("distinct")."""
    if pattern == "one":
        return np.zeros((N, cap), np.int64)
    if pattern == "distinct":
        return np.tile(np.arange(cap), (N, 1))
    hi = {"short": 4, "within": 128, "two": 2 * TILE,
          "many": 5 * TILE}[pattern]
    out = np.empty((N, cap), np.int64)
    for s in range(N):
        lens = rng.randint(1, hi + 1, cap)
        out[s] = np.repeat(np.arange(cap), lens)[:cap]
    return out


def _keys(runs, nk, dtype, dst=None):
    """Key columns sorted lexicographically whose runs are `runs`: with a
    second column, column 0 changes every other run and column 1 between;
    with dst, column 0 is the destination (non-decreasing in [0, dst))."""
    cols = []
    if dst is not None:
        top = runs.max(initial=0) + 1
        cols.append((runs * dst // top).astype(np.int32))
    if nk == 1:
        cols.append((runs * 3 - 7).astype(dtype))
    else:
        cols += [(runs // 2).astype(dtype), (runs % 2).astype(dtype)]
    return cols


def _vals(op, dtype, W, cap, rng):
    shape = (N, cap) if W == 1 else (N, cap, W)
    if dtype == np.float64:
        return rng.standard_normal(shape)
    if op == "mul":
        return rng.randint(-3, 4, shape).astype(np.int64)
    return rng.randint(-2 ** 40, 2 ** 40, shape).astype(np.int64)


def _fills(keys, dst):
    return ([dst] if dst is not None else []) + [
        np.iinfo(k.dtype).max for k in keys[1 if dst is not None else 0:]]


def _close(g, w, exact):
    """Equal, or for a float sum or product within RTOL of max(|w|, 1):
    the error of another association scales with the values folded, not
    with their total (a sum near 0 by cancellation)."""
    gn = torch.isnan(g)
    assert torch.equal(gn, torch.isnan(w))
    d = torch.where(g == w, 0.0, (g - w).abs())[~gn]
    lim = 0.0 if exact else RTOL
    assert bool((d <= lim * w[~gn].abs().clamp_min(1.0)).all())


def _run(dev, keys, fills, vals, n, op, dst_col=None, n_dst=0):
    """The kernel on the card (one launch counted, the plain version not
    called) against the plain version on the same card tensors."""
    tk = [torch.from_numpy(np.ascontiguousarray(k)).to(dev) for k in keys]
    tv = [torch.from_numpy(np.ascontiguousarray(v)).to(dev) for v in vals]
    tn = torch.from_numpy(np.asarray(n, np.int32)).to(dev)

    def refuse(*a, **k):
        raise AssertionError("reduce_by_key_compact_plain called on a CUDA "
                             "tensor")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kernels, "reduce_by_key_compact_plain", refuse)
        before = kernels.LAUNCHES["reduce_by_key_compact"]
        got = kernels.reduce_by_key_compact(tk, fills, tv, tn, op, dst_col,
                                            n_dst)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["reduce_by_key_compact"] == before + (
            1 if keys[0].shape[1] else 0)
    want = kernels.reduce_by_key_compact_plain(tk, fills, tv, tn, op,
                                               dst_col, n_dst)
    for g, w in zip(got[0], want[0]):
        assert g.dtype == w.dtype and torch.equal(g, w)
    for g, w in zip(got[1], want[1]):
        assert g.dtype == w.dtype
        if g.is_floating_point():
            _close(g, w, op not in ("add", "mul"))
        else:
            assert torch.equal(g, w)
    assert torch.equal(got[2], want[2])
    if dst_col is None:
        assert got[3] is None and got[4] is None
    else:
        assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
    return got, (tk, fills, tv, tn, op, dst_col, n_dst)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("kdt", [np.int32, np.int64])
def test_k3_matches_plain(dev, op, pattern, kdt):
    """Runs inside a tile, across two and many, one a shard, all rows
    distinct; a full (n = cap), a ragged and an empty shard; cap not a
    multiple of the tile; the destination column on."""
    cap = 3 * TILE + 5
    rng = np.random.RandomState(OPS.index(op) * 10 + PATTERNS.index(pattern))
    keys = _keys(_runs(pattern, cap, rng), 1 + (kdt == np.int64), kdt, 9)
    _run(dev, keys, _fills(keys, 9), [_vals(op, np.int64, 1, cap, rng)],
         [cap, cap - 1000, 0], op, 0, 9)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", [np.int64, np.float64])
@pytest.mark.parametrize("W", [1, 3])
@pytest.mark.parametrize("pattern", ["short", "within", "many"])
def test_k3_value_lanes(dev, op, dtype, W, pattern):
    cap = 2 * TILE + 77
    rng = np.random.RandomState(W * 7 + (dtype == np.float64))
    keys = _keys(_runs(pattern, cap, rng), 1, np.int64)
    _run(dev, keys, _fills(keys, None), [_vals(op, dtype, W, cap, rng)],
         [cap, 17, TILE + 1], op)


@pytest.mark.parametrize("cap", [0, 1, 2, TILE - 1, TILE, TILE + 1,
                                 2 * TILE])
@pytest.mark.parametrize("op", ["add", "last"])
def test_k3_caps(dev, cap, op):
    """n = cap at the tile's edges, with and without the destination."""
    rng = np.random.RandomState(cap % 1000)
    keys = _keys(_runs("short", cap, rng), 1, np.int64, 4)
    vals = [_vals(op, np.int64, 1, cap, rng)]
    _run(dev, keys, _fills(keys, 4), vals, [cap] * N, op, 0, 4)
    _run(dev, keys[1:], _fills(keys[1:], None), vals, [cap] * N, op)


@pytest.mark.parametrize("n_dst", [1, 9, 4096])
@pytest.mark.parametrize("pattern", ["short", "distinct"])
def test_k3_n_dst(dev, n_dst, pattern):
    cap = 2 * TILE + 3
    rng = np.random.RandomState(n_dst)
    keys = _keys(_runs(pattern, cap, rng), 1, np.int64, n_dst)
    _run(dev, keys, _fills(keys, n_dst), [_vals("add", np.int64, 1, cap,
                                                rng)],
         [cap, cap - 5, 3], "add", 0, n_dst)


@pytest.mark.parametrize("width", [1, 2, 4, 8, 12, 16])
def test_k3_last_row_bytes(dev, width):
    """"last" copies rows of any width: bool / int8, int16, int32, int64,
    (N, cap, 3) int32 and (N, cap, 2) float64 leaves."""
    cap = TILE + 300
    rng = np.random.RandomState(width)
    keys = _keys(_runs("within", cap, rng), 1, np.int64, 5)
    shape = (N, cap)
    leaf = {1: rng.rand(*shape) < 0.5,
            2: rng.randint(-300, 300, shape).astype(np.int16),
            4: rng.randint(-9, 9, shape).astype(np.int32),
            8: rng.randint(-9, 9, shape).astype(np.int64),
            12: rng.randint(-9, 9, shape + (3,)).astype(np.int32),
            16: rng.standard_normal(shape + (2,))}[width]
    vals = [leaf] + ([rng.randint(-9, 9, shape).astype(np.int8)]
                     if width == 1 else [])
    _run(dev, keys, _fills(keys, 5), vals, [cap, cap // 3, 0], "last", 0, 5)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("pattern", ["short", "within"])
def test_k3_max_keys_and_leaves(dev, op, pattern):
    """MAX_KEYS key columns (int32 and int64) and MAX_LEAVES value leaves
    (int64 and float64 for a reduction, every width for "last"), with
    tiles dense in runs ("short") and sparse."""
    cap = 2 * TILE + 9
    rng = np.random.RandomState(200 + OPS.index(op))
    runs = _runs(pattern, cap, rng)
    keys = [(runs // 2 ** c % 3).astype(np.int32 if c % 2 else np.int64)
            for c in range(kernels.MAX_KEYS - 1, -1, -1)]
    vals = []
    for i in range(kernels.MAX_LEAVES):
        dt = np.float64 if i % 2 else np.int64
        vals.append(_vals(op, dt, 1 + i % 3, cap, rng) if op != "last" else
                    rng.randint(0, 9, (N, cap) + ((2,) if i % 4 == 1 else ())
                                ).astype([np.int8, np.int16, np.int32,
                                          np.float64][i % 4]))
    _run(dev, keys, _fills(keys, None), vals, [cap, cap - 1, 1], op)


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("where", ["first", "middle", "last", "every"])
@pytest.mark.parametrize("pattern", ["within", "many"])
def test_k3_nan(dev, op, where, pattern):
    """NaN at the first, a middle or the last row of runs (every row of
    some), inside one tile and across tiles, under float min and max;
    -0.0 beside 0.0 in others."""
    cap = 3 * TILE + 11
    rng = np.random.RandomState(300)
    runs = _runs(pattern, cap, rng)
    keys = _keys(runs, 1, np.int64, 3)
    v = rng.standard_normal((N, cap))
    for s in range(N):
        starts = np.flatnonzero(np.r_[True, runs[s, 1:] != runs[s, :-1]])
        ends = np.r_[starts[1:], cap] - 1
        for r, (a, b) in enumerate(zip(starts, ends)):
            if r % 2 == 0 or pattern == "many":
                if where == "every":
                    v[s, a:b + 1] = np.nan
                else:
                    v[s, {"first": a, "middle": (a + b) // 2,
                          "last": b}[where]] = np.nan
            elif b > a:
                v[s, a], v[s, a + 1] = -0.0, 0.0
    _run(dev, keys, _fills(keys, 3), [v], [cap, cap - 4, cap // 2], op, 0, 3)


@pytest.mark.parametrize("op", ["min", "max"])
def test_k3_nan_smallest(dev, op):
    """The smallest input on which the earlier kernel dropped a NaN: one
    shard, keys [0, 0], values [1.0, NaN]."""
    k = np.zeros((1, 2), np.int64)
    v = np.array([[1.0, np.nan]])
    got, _ = _run(dev, [k], [SENT], [v], [2], op)
    assert torch.isnan(got[1][0][0, 0])


@pytest.mark.parametrize("op", ["add", "mul"])
@pytest.mark.parametrize("pattern", ["two", "many", "one"])
def test_k3_float_results_repeat(dev, op, pattern):
    """Float sums and products over runs that cross tiles come out with
    the same bits from launch to launch (one fixed association)."""
    cap = 6 * TILE + 1
    rng = np.random.RandomState(400)
    keys = _keys(_runs(pattern, cap, rng), 1, np.int64)
    v = rng.standard_normal((N, cap))
    if op == "mul":
        v = 1.0 + v * 1e-3
    got, args = _run(dev, keys, _fills(keys, None), [v], [cap] * N, op)
    bits = got[1][0].view(torch.int64).clone()
    for _ in range(5):
        again = kernels.reduce_by_key_compact(*args)
        assert torch.equal(again[1][0].view(torch.int64), bits)


def test_k3_one_launch_no_row_scratch(dev):
    """One launch a call, and no (N, cap) scratch: the memory the call
    allocates beyond its outputs is a few words a tile."""
    cap = 4 * TILE
    rng = np.random.RandomState(500)
    keys = _keys(_runs("within", cap, rng), 1, np.int64, 8)
    tk = [torch.from_numpy(k).to(dev) for k in keys]
    tv = [torch.from_numpy(_vals("add", np.int64, 1, cap, rng)).to(dev)]
    tn = torch.full((N,), cap, dtype=torch.int32, device=dev)
    fills = _fills(keys, 8)
    kernels.reduce_by_key_compact(tk, fills, tv, tn, "add", 0, 8)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = kernels.reduce_by_key_compact(tk, fills, tv, tn, "add", 0, 8)
        torch.cuda.synchronize()
    outs = sum(t.numel() * t.element_size() for t in
               list(out[0]) + list(out[1]) + [out[2], out[3], out[4]])
    assert torch.cuda.max_memory_allocated() - base - outs < N * cap
    names = [ev.name for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("k3_sweep" in x for x in names) == 1
