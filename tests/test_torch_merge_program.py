"""The lowering of traced user merges into K14's register programs
(dpark_tpu_torch/backend/cuda/merge_program.py): for a dozen merges of
the shapes user jobs write (tuple sums, TPC-H Q1's six leaves, min/max
mixes, an argmax, a mean, integer // and %, casts, Python constants, bool
logic, narrow dtypes, a vector leaf, a nested value), the program
evaluated in torch must equal the vmapped merge (fuse._leaves_merge_fn,
cast to each leaf's dtype as segmented_combine casts it) on
hypothesis-drawn rows: every leaf bit-equal, floats too (NaN equal to
NaN), since the program runs the same aten ops in the same dtypes.  The
merges outside the op set are not lowered and keep their reason; and a
merge probed with one sample for both sides still reads a and b."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from hypothesis.extra import numpy as hnp

from dpark_tpu_torch.backend.cuda import fuse, merge_program as mp

I64, I32, F64, F32, B = (np.dtype(np.int64), np.dtype(np.int32),
                         np.dtype(np.float64), np.dtype(np.float32),
                         np.dtype(np.bool_))


def _q1(a, b):
    return tuple(x + y for x, y in zip(a, b))


# name -> (merge, value treedef, value specs, leaves that divide)
MERGES = {
    "tuple add": (lambda a, b: (a[0] + b[0], a[1] + b[1]), (1, 2),
                  [(I64, ()), (I64, ())], ()),
    "q1": (_q1, (1, 2, 3, 4, 5, 6), [(I64, ())] * 5 + [(F64, ())], ()),
    "min max": (lambda a, b: (torch.minimum(a[0], b[0]),
                              torch.maximum(a[1], b[1]), a[2] + b[2]),
                (1, 2, 3), [(I64, ()), (F64, ()), (I32, ())], ()),
    "argmax": (lambda a, b: (torch.where(a[1] >= b[1], a[0], b[0]),
                             torch.maximum(a[1], b[1])), (1, 2),
               [(I64, ()), (F64, ())], ()),
    "mean": (lambda a, b: ((a[0] * a[1] + b[0] * b[1]) / (a[1] + b[1]),
                           a[1] + b[1]), (1, 2), [(F64, ()), (I64, ())],
             ()),
    "int div": (lambda a, b: (a[0] // b[0] + a[1] % b[1],
                              b[1] % 7 - a[1] // -3), (1, 2),
                [(I64, ()), (I64, ())], (0, 1)),
    "casts": (lambda a, b: (a[0].float() + b[0].double(),
                            (a[1] + b[1]).to(torch.int32),
                            (a[2] > b[2]).long() + a[2]), (1, 2, 3),
              [(F32, ()), (I64, ()), (I64, ())], ()),
    "constants": (lambda a, b: (a[0] + 1, a[1] * 0.5 + b[1], 7, 2.5),
                  (1, 2, 3, 4), [(I64, ()), (F64, ()), (I64, ()),
                                 (F64, ())], ()),
    "bool logic": (lambda a, b: (a[0] & b[0], a[1] | ~b[1],
                                 torch.logical_xor(a[0], b[1]) ^ True),
                   (1, 2, 3), [(B, ()), (B, ()), (B, ())], ()),
    "narrow": (lambda a, b: (a[0] + b[0] * 2.0, a[1] - b[1] * 3,
                             torch.abs(a[0] - b[0])), (1, 2, 3),
               [(F32, ()), (I32, ()), (F32, ())], ()),
    # lane 2 of the vector read into the scalar leaf: a select, lowered
    "vector": (lambda a, b: (a[0] + b[0] * b[1],
                             torch.maximum(a[1], b[1]) + a[0][2]),
               (1, 2), [(F64, (3,)), (F64, ())], ()),
    "signs": (lambda a, b: (torch.abs(a[0] - b[0]) - 1, -a[1] + (2 - b[1]),
                            torch.where(a[0] > 0, a[0], 0) + b[0]),
              (1, 2, 3), [(I64, ()), (F64, ()), (I64, ())], ()),
    "nested": (lambda a, b: (a[0] + b[0], (torch.minimum(a[1][0], b[1][0]),
                                           a[1][1] * b[1][1])),
               (1, (2, 3)), [(I64, ()), (F64, ()), (I64, ())], ()),
}


def _probe(name):
    merge, vdef, specs, _ = MERGES[name]
    nk_specs = [(I64, ())] + specs
    merge_fn = fuse.probe_merge(merge, (0, vdef), nk_specs, 1)
    assert merge_fn is not None
    return merge_fn, specs


def _elements(dt):
    if dt == B:
        return st.booleans()
    if dt.kind == "f":
        return st.floats(width=dt.itemsize * 8)
    lim = 2 ** 62 if dt == I64 else 2 ** 30
    return st.integers(-lim, lim)


@st.composite
def _rows(draw, specs, divisors):
    m = draw(st.integers(1, 12))
    out = []
    for side in range(2):
        leaves = []
        for i, (dt, shp) in enumerate(specs):
            arr = draw(hnp.arrays(dt, (m,) + shp, elements=_elements(dt)))
            if i in divisors:
                arr = np.where(arr == 0, 1, arr)
            leaves.append(torch.from_numpy(arr))
        out.append(leaves)
    return out


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.is_floating_point:
        torch.testing.assert_close(got, want, rtol=0, atol=0,
                                   equal_nan=True)
    else:
        assert torch.equal(got, want)


# the merges whose every slot is op(a_j, b_j), op in add/min/max/mul
SEPARABLE_MERGES = {"min max", "nested", "q1", "tuple add"}


@pytest.mark.parametrize("name", sorted(MERGES))
def test_program_equals_vmapped_merge(name):
    merge_fn, specs = _probe(name)
    assert merge_fn.route == (mp.K14_SEPARABLE if name in SEPARABLE_MERGES
                              else mp.K14)
    sig = tuple((fuse.layout.torch_dtype(dt), shp) for dt, shp in specs)
    prog, reason = merge_fn.programs[sig]
    assert reason is None and prog.nslots == sum(
        int(np.prod(shp, dtype=int)) for _, shp in specs)
    assert len(prog.code) <= mp.MAX_INSTRS and prog.nregs <= mp.MAX_REGS

    @settings(max_examples=25, deadline=None)
    @given(_rows(specs, MERGES[name][3]))
    def check(rows):
        a, b = rows
        got = prog.merge_leaves(a, b)
        want = [w.to(v.dtype).expand(v.shape) if w.dim() < v.dim()
                else w.to(v.dtype) for w, v in zip(merge_fn(a, b), a)]
        for g, w in zip(got, want):
            _same(g, w)
    check()


def test_traced_overloads_are_in_the_op_set():
    """The aten overloads the test merges trace to are the ones the
    lowering knows (a new torch that renames one fails here first)."""
    from torch.fx.experimental.proxy_tensor import make_fx
    seen = set()
    for name in MERGES:
        merge_fn, specs = _probe(name)
        ex = [mp._example(fuse.layout.torch_dtype(dt), shp, k)
              for k, (dt, shp) in enumerate(specs + specs)]
        nl = len(specs)
        with fuse.python_float_semantics():
            gm = make_fx(lambda *xs: tuple(merge_fn(list(xs[:nl]),
                                                    list(xs[nl:]))))(*ex)
        gm.graph.eliminate_dead_code()
        seen.update(n.target for n in gm.graph.nodes
                    if n.op == "call_function")
    known = (set(mp._ELEMENTWISE) | set(mp._IDENTITY) | set(mp._RESHAPES)
             | {torch.ops.aten._to_copy.default,
                torch.ops.aten.expand.default,
                torch.ops.aten.select.int,
                # constants only: folded by running them
                torch.ops.aten.scalar_tensor.default})
    assert seen <= known, seen - known
    assert torch.ops.aten.add.Tensor in seen
    assert torch.ops.aten.where.self in seen


def _chain(n):
    def merge(a, b):
        x = a[0]
        for i in range(n):
            x = x * b[0] + i
        return (x,)
    return merge


def _live(n):
    def merge(a, b):
        xs = [a[0] * i for i in range(2, n)]
        x = b[0]
        for y in xs:
            x = x + y
        return (x,)
    return merge


@pytest.mark.parametrize("merge,vdef,specs,reason", [
    (lambda a, b: (a[0] + b[0], torch.cumsum(a[1], 0)), (1, 2),
     [(I64, ()), (I64, ())], "op outside the set: aten.cumsum"),
    (lambda a, b: (a[0] + b[0].sum(),), (1,), [(F64, (4,))],
     "the lanes of a vector leaf mix through aten.sum"),
    (lambda a, b: (a[0] @ b[0],), (1,), [(F64, (3,))],
     "the lanes of a vector leaf mix"),
    (lambda a, b: tuple(x + y for x, y in zip(a, b)), tuple(range(1, 18)),
     [(I64, ())] * 17, "17 slots (the program holds 16)"),
    (_chain(200), (1,), [(I64, ())], "400 instructions"),
    (_live(100), (1,), [(I64, ())], "registers (the program holds 96)"),
    (lambda a, b: (a[0] - b[0],), (1,), [(I64, ())], None),
])
def test_merges_outside_the_set_keep_their_reason(merge, vdef, specs,
                                                   reason):
    merge_fn = fuse.probe_merge(merge, (0, vdef), [(I64, ())] + specs, 1)
    assert merge_fn is not None      # the vmapped scan still runs them
    if reason is None:
        assert merge_fn.route == mp.K14
    else:
        assert reason in merge_fn.route, merge_fn.route
        assert list(merge_fn.programs.values())[0][0] is None


def test_untraceable_leaf_merge_keeps_its_reason():
    def merge(va, vb):
        return [va[0] + int(vb[0].sum().item())]
    prog, reason = mp.lower(merge, [(torch.int64, ())])
    assert prog is None and reason.startswith("does not trace")
    prog, reason = mp.lower(lambda va, vb: [va[0] + vb[0]],
                            [(torch.complex64, ())])
    assert prog is None and "dtype" in reason


def test_probe_with_one_sample_still_reads_a_and_b():
    """probe_merge calls merge_fn(sample, sample) (one tensor for both
    sides); the lowering traces distinct examples, so the program keeps
    a's and b's registers apart (make_fx given one tensor for a and b
    traces a graph that reads b twice)."""
    merge_fn = fuse.probe_merge(
        lambda a, b: (a[0] - b[0], a[1] - 2 * b[1]), (0, (1, 2)),
        [(I64, ())] * 3, 1)
    prog = list(merge_fn.programs.values())[0][0]
    S = prog.nslots
    reads = {r for op, _, _, x, y, _ in prog.code for r in (x, y)}
    assert reads & set(range(S)) and reads & set(range(S, 2 * S))
    a = [torch.tensor([10, 20]), torch.tensor([1, 2])]
    b = [torch.tensor([3, 4]), torch.tensor([5, 6])]
    got = prog.merge_leaves(a, b)
    assert got[0].tolist() == [7, 16] and got[1].tolist() == [-9, -10]


def test_route_is_memoised_per_signature():
    merge_fn, _ = _probe("tuple add")
    sig = ((torch.int64, ()), (torch.int64, ()))
    prog = mp.program_for(merge_fn, sig)
    assert mp.program_for(merge_fn, sig) is prog
    narrow = ((torch.int32, ()), (torch.int32, ()))
    assert mp.program_for(merge_fn, narrow) is not prog
    assert set(merge_fn.programs) == {sig, narrow}
    assert merge_fn.route == mp.K14_SEPARABLE
    with pytest.raises(TypeError):
        mp.program_for(merge_fn.__call__, sig)


def test_words_layout():
    merge_fn, _ = _probe("constants")
    prog = list(merge_fn.programs.values())[0][0]
    w = prog.words()
    nins, ncon, S = (int(x) for x in w[:3])
    assert (nins, ncon, S) == (len(prog.code), len(prog.consts), 4)
    assert len(w) == 3 + mp.WORDS * nins + 2 * ncon + S
    cons = w[3 + mp.WORDS * nins:][:2 * ncon].reshape(ncon, 2)
    bits = {int(r): int(v) for r, v in cons}
    for reg, code, v in prog.consts:
        assert bits[reg] == mp._const_bits(v, code)
    assert list(w[-S:]) == prog.out


@pytest.mark.parametrize("name", sorted(MERGES))
def test_separable_ops_name_each_slots_op(name):
    """separable_ops: (op, dtype code) per slot exactly when every merged
    slot is one add/min/max/mul of a's and b's same slot in its dtype."""
    merge_fn, specs = _probe(name)
    prog = list(merge_fn.programs.values())[0][0]
    ops = prog.separable_ops()
    assert (ops is not None) == (name in SEPARABLE_MERGES)
    if ops is not None:
        S = prog.nslots
        assert len(ops) == S and not prog.consts
        by_dst = {ins[2]: ins for ins in prog.code}
        for j, (op, code) in enumerate(ops):
            ins = by_dst[prog.out[j]]
            assert ins[:2] == (op, code) and ins[3:5] == (j, S + j)
            assert op in mp.SEPARABLE
            assert code == mp.CODE[prog.slot_dtypes[j]]
