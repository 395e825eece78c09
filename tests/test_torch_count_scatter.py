"""The active count (K17's active_count) and the group results' scatter
(K8's bucket_scatter_classes) on the CPU, where their plain versions run,
against the JAX package's own formulas: the Pregel and object Bagel
active counts (backend/tpu/bagel.py:390, bagel_obj.py:887: jnp.sum of
the masked active flags) and SegMapOp.apply's write-back
(backend/tpu/fuse.py:880-886: zeros with a dummy row, then each class's
results set at its members' segment ids).  Also SegMapOp.apply's outputs
against the per-class scatter it replaced and the reference's apply, in
the plain and the state mode, and a DeviceObjectPregel run whose active
count a superstep is one call over every class.  Inputs come from numpy
with a seed; every comparison is exact except the state mode's float
update against the reference (rtol 1e-12: torch and XLA sum in another
order)."""

import importlib.util
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dpark_tpu.backend.tpu import collectives as ref
from dpark_tpu.backend.tpu.fuse import SegMapOp as RefSegMapOp
from dpark_tpu_torch.backend.cuda import collectives, fuse, kernels, layout
from dpark_tpu_torch.backend.cuda.executor import TorchExecutor

jax.config.update("jax_enable_x64", True)

N = 3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------
# K17 active_count
# ---------------------------------------------------------------------
ACTIVE_CASES = {
    # caps not multiples of 16, ragged n, an empty shard, n == cap
    "ragged classes": ([8, 13, 40, 64, 131], "ragged"),
    "full shards": ([17, 256], "full"),
    "one class, empty shards": ([33], "empty"),
}


def _masks(caps, kind, seed):
    rng = np.random.default_rng(seed)
    out = []
    for cap in caps:
        m = rng.random((N, cap)) < 0.4
        if kind == "full":
            n = np.full(N, cap, np.int32)
        elif kind == "empty":
            n = np.array([0, cap, 0], np.int32)
        else:
            n = rng.integers(0, cap + 1, N).astype(np.int32)
            n[1] = 0
            n[2] = cap
        # True past n: only the first n rows may count
        m[np.arange(cap)[None, :] >= n[:, None]] = True
        out.append((m, n))
    return out


@pytest.mark.parametrize("case", sorted(ACTIVE_CASES))
def test_active_count_plain_vs_reference(case):
    caps, kind = ACTIVE_CASES[case]
    pairs = _masks(caps, kind, sum(caps))
    # bagel.py:390 / bagel_obj.py:887: the masked flags' jnp.sum, a class
    want = sum(int(jnp.sum(jnp.asarray(m) & (
        jnp.arange(m.shape[1])[None, :] < jnp.asarray(n)[:, None])))
        for m, n in pairs)
    masks, ns = [_t(m) for m, _ in pairs], [_t(n) for _, n in pairs]
    plain = kernels.active_count_plain(masks, ns)
    assert plain.dtype == torch.int64 and plain.dim() == 0
    assert int(plain) == want
    # on CPU tensors the wrapper runs the plain version
    assert int(kernels.active_count(masks, ns)) == want
    # a bool monoid_reduce gives the same count a shard, and min and max
    for m, n in zip(masks, ns):
        red, lo, hi = kernels.monoid_reduce(m, n, "add")
        valid = (torch.arange(m.shape[1])[None, :] < n[:, None].long())
        assert torch.equal(red, (m & valid).sum(1))
        assert torch.equal(hi, (m & valid).any(1))
        assert torch.equal(lo, (m | ~valid).all(1))


def test_active_count_checks():
    m = torch.zeros((N, 8), dtype=torch.bool)
    n = torch.zeros(N, dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.active_count([], [])
    with pytest.raises(ValueError):
        kernels.active_count([m.to(torch.uint8)], [n])
    with pytest.raises(ValueError):
        kernels.active_count([m], [n.long()])


# ---------------------------------------------------------------------
# K8 bucket_scatter_classes
# ---------------------------------------------------------------------
SCATTER_CASES = {
    # group sizes a shard: several classes, the pad class past n_seg
    "classes": [[1, 2, 3, 4, 7, 9, 17, 1], [5, 5, 1, 33], [2, 2, 2, 8]],
    "one class": [[4, 3, 4], [3], [4, 4, 4, 4]],
    "no groups": [[], [], []],
}
CAP = 96


def _sorted_keys(plan, seed):
    rng = np.random.default_rng(seed)
    keys = np.full((N, CAP), np.iinfo(np.int64).max, np.int64)
    n = np.zeros(N, np.int32)
    for s, sizes in enumerate(plan):
        ks = np.sort(rng.choice(10 ** 6, len(sizes), replace=False))
        at = 0
        for k, size in zip(ks, sizes):
            keys[s, at:at + size] = k
            at += size
        n[s] = at
    return keys, n


def _table(plan, seed):
    keys, n = _sorted_keys(plan, seed)
    table = collectives._segment_table([_t(keys)], _t(n), want_keys=True)
    lay = TorchExecutor._seg_bucket_layout(table[4])
    return keys, n, table, lay


@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
def test_bucket_scatter_classes_plain_vs_reference(case):
    keys, n, table, lay = _table(SCATTER_CASES[case], len(case))
    members, counts, offsets = collectives.bucket_members(
        table[2], table[4], table[3])
    rng = np.random.default_rng(7)
    dtypes = [torch.int64, torch.float32]
    results = [[_t(rng.integers(-99, 99, (N, G))),
                _t(rng.standard_normal((N, G)).astype(np.float32))]
               for _, _, G in lay]
    got = kernels.bucket_scatter_classes(
        results, members, offsets, counts, [b for b, _, _ in lay], dtypes)
    assert [g.dtype for g in got] == dtypes

    @jax.jit
    def reference(key, n_s, res):
        start_rows, sizes, _, n_seg = ref.segment_spans([key], n_s)
        outs = [jnp.zeros((CAP + 1,), jnp.int64),
                jnp.zeros((CAP + 1,), jnp.float32)]
        for (b, _, G), r in zip(lay, res):
            seg_sel, gvalid = ref.bucket_members(sizes, n_seg, b, G)
            tgt = jnp.where(gvalid, seg_sel, CAP)
            outs = [o.at[tgt].set(x) for o, x in zip(outs, r)]
        return [o[:CAP] for o in outs]
    for s in range(N):
        want = reference(jnp.asarray(keys[s]), jnp.int32(n[s]),
                         [[jnp.asarray(x[s].numpy()) for x in r]
                          for r in results])
        for g, o in zip(got, want):
            assert np.array_equal(g[s].numpy(), np.asarray(o))


@pytest.mark.parametrize("name, source", [
    ("K17C_MAX_CLASSES", "monoid_reduce.cu"),
    ("K8X_MAX_RESULTS", "bucket_groups.cu")])
def test_launch_limits_match_the_sources(name, source):
    """The wrappers split a layout into launches by these limits."""
    with open(os.path.join(kernels.CSRC, source)) as f:
        text = f.read()
    assert getattr(kernels, name) == int(
        re.search(r"(?m)^#define %s (\d+)" % name, text).group(1))


def test_bucket_scatter_classes_checks():
    _, _, table, lay = _table(SCATTER_CASES["classes"], 1)
    members, counts, offsets = collectives.bucket_members(
        table[2], table[4], table[3])
    res = [[torch.zeros((N, G), dtype=torch.int64)] for _, _, G in lay]
    classes = [b for b, _, _ in lay]
    with pytest.raises(ValueError):            # the pad class is not listed
        kernels.bucket_scatter_classes(
            res + [res[0]], members, offsets, counts,
            classes + [kernels.SIZE_CLASSES], [torch.int64])
    with pytest.raises(ValueError):            # a class twice
        kernels.bucket_scatter_classes(res + [res[0]], members, offsets,
                                       counts, classes + classes[:1],
                                       [torch.int64])
    with pytest.raises(ValueError):            # results of another dtype
        kernels.bucket_scatter_classes(res, members, offsets, counts,
                                       classes, [torch.float64])
    with pytest.raises(ValueError):            # one column of the table
        kernels.bucket_scatter_classes(res, members, offsets[:, :1],
                                       counts, classes, [torch.int64])


# ---------------------------------------------------------------------
# SegMapOp.apply: the batched scatter against the per-class one it
# replaced and against the reference's apply
# ---------------------------------------------------------------------
def _sumsq(vs):
    return sum(v * v for v in vs), 0.5 * sum(vs)


def _decayed(vs, prev):
    return 0.9 * (0.0 if prev is None else prev) + sum(vs)


def _per_class_scatter(results_by_class, members, offsets, counts, classes,
                       out_dtypes):
    """SegMapOp.apply's write-back before the batched scatter: zeros,
    then one scatter a class on its columns of offsets and counts."""
    N_, cap = members.shape
    outs = [torch.zeros((N_, cap), dtype=dt) for dt in out_dtypes]
    for b, res in zip(classes, results_by_class):
        kernels.bucket_scatter(outs, res, members,
                               offsets[:, b].contiguous(),
                               counts[:, b].contiguous())
    return outs


@pytest.mark.parametrize("mode", ["plain", "state"])
def test_seg_map_apply_before_after(mode, monkeypatch):
    plan = SCATTER_CASES["classes"]
    keys, n, table, lay = _table(plan, 11)
    rng = np.random.default_rng(12)
    if mode == "plain":
        vals = rng.integers(-50, 50, (N, CAP))
        specs = [(np.dtype(np.int64), ())] * 2
        _, treedef = layout.tree_flatten((np.int64(1), np.int64(2)))
        op = fuse.SegMapOp(_sumsq, None)
        leaves = [_t(keys), _t(vals)]
    else:
        vals = rng.standard_normal((N, CAP)) * 10
        # the carried state: one row of about half of the groups
        flags = np.zeros((N, CAP), np.int64)
        for s, sizes in enumerate(plan):
            starts = np.cumsum([0] + sizes[:-1])
            for at, size in zip(starts, sizes):
                if rng.random() < 0.5:
                    flags[s, at + rng.integers(size)] = 1
        specs = [(np.dtype(np.int64), ()), (np.dtype(np.float64), ()),
                 (np.dtype(np.int64), ())]
        _, treedef = layout.tree_flatten(
            (np.int64(1), (np.float64(2.0), np.int64(0))))
        op = fuse.SegMapOp(_decayed, None)
        op.state_mode = True
        leaves = [_t(keys), _t(vals), _t(flags)]
    op.probe(treedef, specs)

    def run():
        op.table, op.layout = table, lay
        return op.apply(leaves, _t(n))
    new, n_seg = run()
    monkeypatch.setattr(kernels, "bucket_scatter_classes",
                        _per_class_scatter)
    old, _ = run()
    assert len(new) == len(old)
    for a, b in zip(new, old):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the reference's apply, a shard at a time
    rop = RefSegMapOp(op.f, op.pad)
    rop.nk, rop.layout, rop.state_mode = 1, lay, op.state_mode
    reference = jax.jit(rop.apply)
    for s in range(N):
        got, rn = reference([jnp.asarray(x[s].numpy()) for x in leaves],
                            jnp.int32(n[s]))
        assert int(rn) == int(n_seg[s])
        for a, b in zip(new, got):
            if a.dtype.is_floating_point:
                assert np.allclose(a[s].numpy(), np.asarray(b), rtol=1e-12,
                                   atol=0)
            else:
                assert np.array_equal(a[s].numpy(), np.asarray(b))


# ---------------------------------------------------------------------
# the object Bagel: one active count a superstep over every class
# ---------------------------------------------------------------------
def _smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("_chip_smoke_k17", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_object_bagel_active_count_a_superstep(monkeypatch):
    smoke = _smoke()
    calls = []
    count = kernels.active_count

    def recording(masks, ns):
        out = count(masks, ns)
        # bagel_obj.py:887: n_active + jnp.sum(new_act) a class
        want = sum(int(jnp.sum(jnp.asarray(m.numpy()) & (
            jnp.arange(m.shape[1])[None, :]
            < jnp.asarray(nv.numpy())[:, None])))
            for m, nv in zip(masks, ns))
        calls.append((len(masks), int(out), want))
        return out
    monkeypatch.setattr(kernels, "active_count", recording)
    from dpark_tpu_torch.backend.cuda.bagel_obj import DeviceObjectPregel
    from dpark_tpu_torch.utils import pytree
    n, src, dst = smoke.urand_graph(8, 8)
    deg, tgt, ev = smoke.urand_layout(n, src, dst)
    dop = DeviceObjectPregel(
        TorchExecutor(4, torch.device("cpu")), smoke.bagel_pagerank(n),
        "add", pytree.LEAF, np.arange(n, dtype=np.int64),
        [np.full(n, 1.0 / n)], np.ones(n, bool), deg, tgt, ev, None, 4,
        combine_op=lambda a, b: a + b)
    dop.run()
    assert len(calls) == dop.stats["supersteps"] == 4
    assert all(k == len(dop.tables) > 1 for k, _, _ in calls)
    assert all(got == want for _, got, want in calls)
    assert calls[0][1] == n            # every vertex active at superstep 0
