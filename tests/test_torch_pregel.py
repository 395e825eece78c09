"""run_pregel on the port (a mirror of tests/test_bagel_device.py): on
gpu:2 and gpu:8 with device="cpu" (the device Pregel with the kernels'
plain versions: K9 edge gather, K10 delivery, K1-K5 for the message
combine and exchange) and on the port's `local` (its host loop), every
case equals the JAX package's vectorized host golden model
(dpark_tpu.bagel._pregel_host) on the same seeded numpy inputs; ring
PageRank and SSSP also equal its run_pregel on the tpu:2 master.

Each user function comes as a twin: torch ops for the port, numpy / jnp
for the reference.  Integer states must be equal; float states equal
within FLOAT_RTOL (the device path sums messages in another order)."""

import numpy as np
import pytest
import torch

from dpark_tpu import DparkContext as RefContext
from dpark_tpu.bagel import _pregel_host as ref_host
from dpark_tpu.bagel import run_pregel as ref_run_pregel
from dpark_tpu_torch import DparkContext, run_pregel
from dpark_tpu_torch.backend.cuda import kernels

MASTERS = ["local", "gpu:2", "gpu:8"]
FLOAT_RTOL = 1e-12
HOST_ARGS = ("combine", "edge_values", "active", "initial_messages",
             "aggregator", "max_superstep", "send_gate_leaf")


@pytest.fixture(params=MASTERS)
def pctx(request):
    m = request.param
    c = DparkContext(m) if m == "local" else DparkContext(m, device="cpu")
    c.start()
    yield c
    c.stop()


def _same(got, want):
    """Equal leaves: integers and bools exactly, floats within
    FLOAT_RTOL (nan where nan, inf where inf)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if want.dtype.kind == "f":
        assert got.dtype.kind == "f"
        assert np.allclose(got, want, rtol=FLOAT_RTOL, atol=0,
                           equal_nan=True), np.abs(got - want).max()
    else:
        assert got.dtype == want.dtype, (got.dtype, want.dtype)
        assert np.array_equal(got, want)


def _same_result(got, want):
    gids, gvals, gact = got
    wids, wvals, wact = want
    assert np.array_equal(gids, wids)
    assert np.array_equal(gact, wact)
    if isinstance(wvals, tuple):
        assert isinstance(gvals, tuple) and len(gvals) == len(wvals)
        for g, w in zip(gvals, wvals):
            _same(g, w)
    else:
        _same(gvals, wvals)


def _check(pctx, ids, values, edges, port_fns, ref_fns, **kw):
    """The port's run_pregel with the torch twins equals the reference's
    host golden model with the numpy/jnp twins; the gpu masters must
    ride the device Pregel."""
    got = run_pregel(pctx, ids, values, edges, *port_fns, **kw)
    if pctx.master != "local":
        assert pctx.scheduler._pregel_device_used
        assert pctx.scheduler._pregel_fallback_reason is None
    defaults = {"combine": "add", "max_superstep": 80}
    args = [kw.get(k, defaults.get(k)) for k in HOST_ARGS]
    want = ref_host(ids, values, edges, *ref_fns, *args)
    _same_result(got, want)
    return got


def _ring_graph(n):
    ids = np.arange(n, dtype=np.int64)
    src = np.repeat(ids, 2)
    dst = np.stack([(ids + 1) % n, (ids * 7 + 3) % n], 1).reshape(-1)
    return ids, src, dst


def _pagerank_fns(n, damping=0.85, steps=20):
    def compute(value, msg, has_msg, active, agg, superstep):
        is0 = (superstep == 0) * 1.0
        new = is0 * value + (1 - is0) * ((1 - damping) / n
                                         + damping * msg)
        return new, superstep < steps

    def ref_compute(value, msg, has_msg, active, agg, superstep):
        is0 = superstep == 0
        new = is0 * value + (1 - is0) * ((1 - damping) / n
                                         + damping * msg)
        return new, superstep < steps

    def send(src_value, edge_value, src_degree):
        return src_value / src_degree
    return (compute, send), (ref_compute, send)


def test_pagerank_ring(pctx):
    n = 64
    ids, src, dst = _ring_graph(n)
    port, ref = _pagerank_fns(n)
    _, ranks, _ = _check(pctx, ids, np.full(n, 1.0 / n), (src, dst), port,
                         ref)
    assert abs(float(np.sum(ranks)) - 1.0) < 1e-9
    if pctx.master != "local":
        assert pctx.scheduler._pregel_stats["supersteps"] == 21


def _sssp_case():
    rng = np.random.RandomState(7)
    n = 50
    ids = np.arange(n, dtype=np.int64) * 3 + 1      # non-contiguous ids
    ne = 200
    src = ids[rng.randint(0, n, ne)]
    dst = ids[rng.randint(0, n, ne)]
    w = rng.randint(1, 10, ne).astype(np.float64)
    return ids, src, dst, w


def _sssp_fns():
    def compute(dist, msg, has_msg, active, agg, superstep):
        new = torch.minimum(dist, msg)
        return new, new < dist

    def ref_compute(dist, msg, has_msg, active, agg, superstep):
        import jax.numpy as jnp           # works on np arrays and tracers
        new = jnp.minimum(dist, msg)
        return new, new < dist

    def send(d, w_edge, deg):
        return d + w_edge
    return (compute, send), (ref_compute, send)


def test_sssp_min_combine_initial_messages(pctx):
    ids, src, dst, w = _sssp_case()
    port, ref = _sssp_fns()
    init = (np.array([ids[0]]), np.array([0.0]))
    gids, gdist, _ = _check(pctx, ids, np.full(len(ids), np.inf),
                            (src, dst), port, ref, combine="min",
                            edge_values=w, initial_messages=init)
    # integer weights: every path sum is exact, so equal, not close
    bf = {int(i): np.inf for i in ids}
    bf[int(ids[0])] = 0.0
    for _ in range(len(ids)):
        for s, d, ww in zip(src, dst, w):
            bf[int(d)] = min(bf[int(d)], bf[int(s)] + ww)
    assert np.array_equal(gdist, [bf[int(i)] for i in gids])


def test_pagerank_and_sssp_match_tpu2():
    """The same two runs on the JAX package's tpu:2 master (its device
    Pregel) and the port's gpu:2."""
    tctx = RefContext("tpu:2")
    gctx = DparkContext("gpu:2", device="cpu")
    try:
        n = 48
        ids, src, dst = _ring_graph(n)
        port, ref = _pagerank_fns(n)
        want = ref_run_pregel(tctx, ids, np.full(n, 1.0 / n), (src, dst),
                              *ref)
        assert tctx.scheduler._pregel_device_used
        got = run_pregel(gctx, ids, np.full(n, 1.0 / n), (src, dst), *port)
        assert gctx.scheduler._pregel_device_used
        _same_result(got, want)

        ids, src, dst, w = _sssp_case()
        port, ref = _sssp_fns()
        init = (np.array([ids[0]]), np.array([0.0]))
        kw = dict(combine="min", edge_values=w, initial_messages=init)
        want = ref_run_pregel(tctx, ids, np.full(len(ids), np.inf),
                              (src, dst), *ref, **kw)
        assert tctx.scheduler._pregel_device_used
        got = run_pregel(gctx, ids, np.full(len(ids), np.inf), (src, dst),
                         *port, **kw)
        for g, r in zip(got, want):         # integer weights: exact
            assert np.array_equal(g, r)
    finally:
        tctx.stop()
        gctx.stop()


@pytest.mark.parametrize("amon", ["add", "min", "max", "mul"])
def test_aggregator(pctx, amon):
    """aggregated = global reduce over the PRE-compute state, visible to
    compute the same superstep."""
    n = 40
    ids = np.arange(n, dtype=np.int64)
    values = 1.0 + np.arange(n, dtype=np.float64) / 64

    def compute(value, msg, has_msg, active, agg, superstep):
        return value * 0 + agg, superstep < 1

    def send(v, e, deg):
        return v * 0.0
    _, got, _ = _check(pctx, ids, values, (ids, (ids + 1) % n),
                       (compute, send), (compute, send),
                       aggregator=(lambda v: v, amon), max_superstep=1)
    red = {"add": np.sum, "min": np.min, "max": np.max, "mul": np.prod}
    assert np.allclose(got, red[amon](values), rtol=FLOAT_RTOL)


def test_tuple_values_and_messages(pctx):
    """Tuple-leaf vertex state and messages (float64, int64): the
    monoid combines per leaf (the scan route of K3)."""
    n = 24
    ids = np.arange(n, dtype=np.int64)
    src = np.repeat(ids, 2)
    dst = np.stack([(ids + 1) % n, (ids + 5) % n], 1).reshape(-1)
    v0 = (np.ones(n), np.arange(n, dtype=np.int64))

    def compute(values, msg, has_msg, active, agg, superstep):
        a, b = values
        ma, mb = msg
        return (a + ma, b + mb), superstep < 3

    def send(values, e, deg):
        a, b = values
        return (a * 0.5, b)
    _check(pctx, ids, v0, (src, dst), (compute, send), (compute, send))


def test_vector_message_leaves(pctx):
    """A (k,) message leaf per edge (sum and count in one column)
    combines elementwise."""
    n = 30
    ids = np.arange(n, dtype=np.int64)
    src = np.repeat(ids, 3)
    dst = np.stack([(ids + 1) % n, (ids * 3) % n, (ids + 7) % n],
                   1).reshape(-1)

    def compute(value, msg, has_msg, active, agg, superstep):
        return value + msg[:, 0] * 0.5 + msg[:, 1], superstep < 3

    def send(v, e, deg):
        return torch.stack([v, v * 0 + 1.0], -1)

    def ref_send(v, e, deg):
        return np.stack([v, v * 0 + 1.0], -1)
    _check(pctx, ids, np.arange(n, dtype=np.float64), (src, dst),
           (compute, send), (compute, ref_send))


def test_all_inactive_halts_immediately(pctx):
    n = 8
    ids = np.arange(n, dtype=np.int64)

    def compute(value, msg, has_msg, active, agg, superstep):
        return value, value < 0          # never active

    def send(v, e, deg):
        return v
    _, vals, act = _check(pctx, ids, np.ones(n), (ids, (ids + 1) % n),
                          (compute, send), (compute, send))
    assert not act.any() and np.all(vals == 1.0)
    if pctx.master != "local":
        assert pctx.scheduler._pregel_stats["supersteps"] == 1


def test_messages_to_unknown_ids_dropped(pctx):
    """Mail to ids with no vertex vanishes (integer state: exact)."""
    n = 8
    ids = np.arange(n, dtype=np.int64)
    dst = np.where(ids < 4, ids + 1, 1000 + ids)    # half point nowhere

    def compute(value, msg, has_msg, active, agg, superstep):
        return value + msg, superstep < 2

    def send(v, e, deg):
        return v * 0 + 1
    _, vals, _ = _check(pctx, ids, np.zeros(n, np.int64), (ids, dst),
                        (compute, send), (compute, send))
    assert vals.tolist() == [0, 2, 2, 2, 2, 0, 0, 0]


def test_input_errors_surface_not_fallback(pctx):
    """Invalid input raises PregelInputError on every master instead of
    degrading to the host path."""
    from dpark_tpu_torch.bagel import PregelInputError
    ids = np.arange(8, dtype=np.int64)

    def compute(v, m, h, a, agg, s):
        return v, s < 1

    def send(v, e, deg):
        return v

    with pytest.raises(PregelInputError):        # duplicate ids
        run_pregel(pctx, np.zeros(4, np.int64), np.ones(4),
                   (np.zeros(1, np.int64), np.zeros(1, np.int64)),
                   compute, send)
    with pytest.raises(PregelInputError):        # unknown edge source
        run_pregel(pctx, ids, np.ones(8),
                   (np.array([99]), np.array([0])), compute, send)
    with pytest.raises(PregelInputError):        # msg leaf mismatch
        run_pregel(pctx, ids, np.ones(8), (ids, (ids + 1) % 8),
                   compute, send,
                   initial_messages=(np.array([0]),
                                     (np.ones(1), np.ones(1))))
    if pctx.master != "local":
        with pytest.raises(PregelInputError):    # the padding sentinel
            run_pregel(pctx, np.array([1, 2 ** 63 - 1]), np.ones(2),
                       (np.zeros(0, np.int64), np.zeros(0, np.int64)),
                       compute, send)
        assert not getattr(pctx.scheduler, "_pregel_device_used", False)


def test_empty_graph_and_no_edges(pctx):
    def compute(v, m, h, a, agg, s):
        return v, s < 1

    def send(v, e, deg):
        return v
    none = np.zeros(0, np.int64)
    gids, gvals, gact = run_pregel(pctx, none, np.zeros(0), (none, none),
                                   compute, send)
    assert gids.size == 0 and gvals.size == 0 and gact.size == 0
    # vertices but no edges: no messages, halt after superstep 1
    _check(pctx, np.arange(5, dtype=np.int64), np.ones(5), (none, none),
           (compute, send), (compute, send))


def test_send_gate_leaf(pctx):
    """A bool state leaf replaces `active` as the send mask: halted
    vertices still deliver, and nothing is sent once the gate closes."""
    n = 16
    ids = np.arange(n, dtype=np.int64)
    v0 = (np.arange(n, dtype=np.float64), ids % 3 == 0)

    def compute(values, msg, has_msg, active, agg, superstep):
        val, gate = values
        return (val + msg, gate & (superstep == 0)), val < -1

    def send(values, e, deg):
        val, gate = values
        return val * 2 + 1
    _, (vals, gate), act = _check(
        pctx, ids, v0, (ids, (ids * 5 + 1) % n), (compute, send),
        (compute, send), send_gate_leaf=1)
    assert not act.any() and not gate.any()
    assert (vals != np.arange(n)).sum() == (ids % 3 == 0).sum()


def test_static_superstep(pctx):
    """compute sees `superstep` as a Python int and may branch on it."""
    n = 12
    ids = np.arange(n, dtype=np.int64)
    seen = []

    def compute(value, msg, has_msg, active, agg, superstep):
        if value.numel():
            seen.append(type(superstep))
        if superstep < 2:
            return value + msg + 1, True
        return value, False

    def ref_compute(value, msg, has_msg, active, agg, superstep):
        if superstep < 2:
            return value + msg + 1, True
        return value, False

    def send(v, e, deg):
        return v
    _check(pctx, ids, np.zeros(n, np.int64), (ids, (ids + 1) % n),
           (compute, send), (ref_compute, send), static_superstep=True)
    assert seen and all(t is int for t in seen)


@pytest.mark.parametrize("combine", ["add", "min", "max", "mul"])
@pytest.mark.parametrize("kind", ["float", "int"])
def test_pregel_fuzz_host_vs_device(pctx, combine, kind):
    """Random graphs, every monoid, float and integer state."""
    seed = {"add": 1, "min": 2, "max": 3, "mul": 4}[combine]
    rng = np.random.RandomState(seed + (10 if kind == "int" else 0))
    n = rng.randint(10, 60)
    ids = np.sort(rng.choice(10000, n, replace=False)).astype(np.int64)
    ne = rng.randint(n, 4 * n)
    src = ids[rng.randint(0, n, ne)]
    dst = ids[rng.randint(0, n, ne)]
    steps = int(rng.randint(1, 5))
    if kind == "float":
        w = rng.randint(0, 5, ne).astype(np.float64)
        v0 = rng.randint(0, 100, n).astype(np.float64)

        def send(v, e, deg):
            return v * 0.25 + e
    else:
        w = rng.randint(0, 5, ne).astype(np.int64)
        v0 = rng.randint(0, 100, n).astype(np.int64)

        def send(v, e, deg):
            return v % 5 + e

    def compute(value, msg, has_msg, active, agg, superstep):
        return value + torch.where(has_msg, msg, 0), superstep < steps

    def ref_compute(value, msg, has_msg, active, agg, superstep):
        import jax.numpy as jnp
        return (value + np.asarray(jnp.where(has_msg, msg, 0)),
                superstep < steps)
    _check(pctx, ids, v0, (src, dst), (compute, send),
           (ref_compute, send), combine=combine, edge_values=w)


def test_numpy_send_takes_host_path_with_reason():
    """Admission: a send written with numpy returns no tensor on the
    0-row probe, so the run takes the host loop and says why."""
    n = 20
    ids, src, dst = _ring_graph(n)
    port, ref = _pagerank_fns(n)

    def np_send(v, e, deg):
        return np.asarray(v) / np.asarray(deg)
    c = DparkContext("gpu:2", device="cpu")
    try:
        got = run_pregel(c, ids, np.full(n, 1.0 / n), (src, dst), port[0],
                         np_send)
        assert c.scheduler._pregel_device_used is False
        reason = c.scheduler._pregel_fallback_reason
        assert reason.startswith("send on a 0-row sample: TypeError")
        assert "numpy" in reason
    finally:
        c.stop()
    want = ref_host(ids, np.full(n, 1.0 / n), (src, dst), ref[0], np_send,
                    "add", None, None, None, None, 80)
    _same_result(got, want)


def _raise_cuda(*args, **kw):
    raise RuntimeError("CUDA error: an illegal memory access was "
                       "encountered")


def _raise_late(value, msg, has_msg, active, agg, superstep):
    if value.numel():
        raise ValueError("user code failed on real data")
    return value, superstep < 3


@pytest.mark.parametrize("fault", ["kernel", "compute"])
def test_device_errors_propagate(monkeypatch, fault):
    """Only admission falls back: an error during the device run (a CUDA
    error from a kernel, user code failing on real data) propagates."""
    n = 16
    ids, src, dst = _ring_graph(n)
    port, _ = _pagerank_fns(n)
    compute = port[0]
    if fault == "kernel":
        monkeypatch.setattr(kernels, "pregel_deliver", _raise_cuda)
        exc = RuntimeError
    else:
        compute, exc = _raise_late, ValueError
    c = DparkContext("gpu:2", device="cpu")
    try:
        with pytest.raises(exc):
            run_pregel(c, ids, np.full(n, 1.0 / n), (src, dst), compute,
                       port[1])
        assert not getattr(c.scheduler, "_pregel_device_used", False)
    finally:
        c.stop()


@pytest.mark.parametrize("spread", [1, 4, 5, 1 << 20])
def test_sorted_positions_matches_searchsorted(spread):
    """Host setup's edge source lookup (a table over dense labels, a
    binary search over sparse ones) finds every present id where the
    reference's clipped np.searchsorted does, and never finds an absent
    one."""
    from dpark_tpu_torch.backend.cuda.bagel import _sorted_positions
    rng = np.random.default_rng(spread)
    sorted_ids = np.unique(rng.integers(-50, 400, 300)) * spread
    keys = np.concatenate([rng.choice(sorted_ids, 500),
                           rng.integers(-60 * spread, 500 * spread, 200)])
    got = _sorted_positions(sorted_ids, keys)
    want = np.clip(np.searchsorted(sorted_ids, keys), 0,
                   sorted_ids.size - 1)
    found = sorted_ids[want] == keys
    assert np.array_equal(got[found], want[found])
    assert not np.any(sorted_ids[got[~found]] == keys[~found])
    assert _sorted_positions(sorted_ids[:0], keys).shape == keys.shape


@pytest.mark.parametrize("ndev", [1, 8, 300, 70_000])
def test_shard_order_matches_stable_argsort(ndev):
    """Host setup's edge order on a narrow copy of the shard ids equals
    the reference's stable argsort of the int64 column."""
    from dpark_tpu_torch.backend.cuda.bagel import _shard_order
    shard = np.random.default_rng(ndev).integers(0, ndev, 5000)
    assert np.array_equal(_shard_order(shard, ndev),
                          np.argsort(shard, kind="stable"))
