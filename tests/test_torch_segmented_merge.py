"""K14's plain version (kernels.segmented_merge_plain: the Hillis-Steele
scan with the merge's register program evaluated in torch) against the
JAX package's segmented_combine (dpark_tpu/backend/tpu/collectives.py: a
lax.associative_scan of the vmapped merge) run through jnp on the CPU,
one shard at a time on the same seeded numpy inputs, at each run's last
valid row: random run starts, one run a shard, an empty shard (n = 0),
cap = 1.  Integers and bools are exact; float sums (of non-negative
values) within 1e-12 relative (the two scans associate differently).
The kernel itself runs in the tests marked `cuda`, on a card only
(`python -m pytest -m cuda tests/test_torch_segmented_merge.py`),
against the plain version."""

import numpy as np
import pytest
import torch

from dpark_tpu_torch.backend.cuda import collectives, fuse, kernels
from dpark_tpu_torch.backend.cuda import merge_program as mp

FLOAT_RTOL = 1e-12
I64, F64, I32, F32, B = (np.int64, np.float64, np.int32, np.float32,
                         np.bool_)


def _jwhere_max(va, vb, jnp):
    return [jnp.where(va[1] >= vb[1], va[0], vb[0]),
            jnp.maximum(va[1], vb[1])]


# name -> (port merge, value treedef, value dtypes, reference leaf merge)
CASES = {
    "pair": (lambda a, b: (a[0] + b[0], a[1] + b[1]), (1, 2), [I64, I64],
             lambda va, vb, jnp: [va[0] + vb[0], va[1] + vb[1]]),
    "q1": (lambda a, b: tuple(x + y for x, y in zip(a, b)),
           (1, 2, 3, 4, 5, 6), [I64] * 5 + [F64],
           lambda va, vb, jnp: [x + y for x, y in zip(va, vb)]),
    "argmax": (lambda a, b: (torch.where(a[1] >= b[1], a[0], b[0]),
                             torch.maximum(a[1], b[1])), (1, 2),
               [I64, F64], _jwhere_max),
    "mixed": (lambda a, b: (torch.minimum(a[0], b[0]), a[1] | b[1],
                            a[2] + b[2]), (1, 2, 3), [I32, B, F64],
              lambda va, vb, jnp: [jnp.minimum(va[0], vb[0]),
                                   va[1] | vb[1], va[2] + vb[2]]),
    # more slots than K14's narrow library takes (6): the wide one's
    "sum8": (lambda a, b: tuple(x + y for x, y in zip(a, b)),
             tuple(range(1, 9)), [I64] * 7 + [F64],
             lambda va, vb, jnp: [x + y for x, y in zip(va, vb)]),
    "argmax7": (lambda a, b: tuple(torch.where(a[0] >= b[0], x, y)
                                   for x, y in zip(a, b)),
                tuple(range(1, 8)), [F64] + [I64] * 6,
                lambda va, vb, jnp: [jnp.where(va[0] >= vb[0], x, y)
                                     for x, y in zip(va, vb)]),
}


@pytest.fixture(scope="module")
def jax_ref():
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from dpark_tpu.backend.tpu import collectives as ref
    return jax, jnp, ref


# the cases whose every slot is op(a_j, b_j): K14's separable route
SEPARABLE = {"pair", "q1", "sum8"}


def _program(name):
    merge, vdef, dts, _ = CASES[name]
    specs = [(np.dtype(I64), ())] + [(np.dtype(d), ()) for d in dts]
    merge_fn = fuse.probe_merge(merge, (0, vdef), specs, 1)
    assert merge_fn.route == (mp.K14_SEPARABLE if name in SEPARABLE
                              else mp.K14)
    return list(merge_fn.programs.values())[0][0]


def _starts(rng, N, cap, layout):
    if layout == "one run":
        s = np.zeros((N, cap), bool)
    elif layout == "long runs":
        s = rng.random((N, cap)) < 0.002
    else:
        s = rng.random((N, cap)) < 0.3
    s[:, 0] = True
    return s


def _leaves(rng, N, cap, dts):
    """Seeded leaves; floats non-negative: the scans associate float sums
    differently, and a sum that cancels has no relative bound."""
    out = []
    for d in dts:
        if d == B:
            out.append(rng.random((N, cap)) < 0.1)
        elif np.dtype(d).kind == "f":
            out.append((rng.random((N, cap)) * 100).astype(d))
        else:
            out.append(rng.integers(-1000, 1000, (N, cap)).astype(d))
    return out


def _run_last(starts, n):
    N, cap = starts.shape
    idx = np.arange(cap)[None, :]
    nxt = np.ones((N, cap), bool)
    nxt[:, :-1] = starts[:, 1:]
    return (idx < n[:, None]) & (nxt | (idx == n[:, None] - 1))


def _check(got, want, mask, dts):
    for g, w, d in zip(got, want, dts):
        g, w = g[mask], w[mask]
        if np.dtype(d).kind == "f":
            np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL, atol=0)
        else:
            assert np.array_equal(g, w)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("cap,layout", [(1, "random"), (300, "random"),
                                        (300, "one run"),
                                        (2000, "long runs")])
def test_plain_matches_reference_segmented_combine(jax_ref, name, cap,
                                                   layout):
    jax, jnp, ref = jax_ref
    _, vdef, dts, jmerge = CASES[name]
    N = 3
    rng = np.random.default_rng(cap + len(name))
    starts = _starts(rng, N, cap, layout)
    leaves = _leaves(rng, N, cap, dts)
    n = np.array([cap, 0, max(0, cap - 7)], np.int32)     # shard 1 empty
    prog = _program(name)
    got = kernels.segmented_merge(
        torch.from_numpy(starts), torch.from_numpy(n),
        [torch.from_numpy(v) for v in leaves], prog)
    mask = _run_last(starts, n)
    got = [g.numpy() for g in got]
    scan = jax.jit(lambda st, *vs: ref.segmented_combine(
        st, list(vs), lambda va, vb: jmerge(va, vb, jnp)))
    for s in range(N):
        want = scan(jnp.asarray(starts[s]),
                    *[jnp.asarray(v[s]) for v in leaves])
        _check([g[s] for g in got], [np.asarray(w) for w in want],
               mask[s], dts)


def test_plain_is_the_scan_with_the_program():
    """segmented_merge_plain is segmented_scan with the program's torch
    evaluator in place of the user merge: every row, not only run ends,
    equals the scan of the vmapped merge (integers exactly)."""
    merge, vdef, dts, _ = CASES["pair"]
    specs = [(np.dtype(I64), ())] * 3
    merge_fn = fuse.probe_merge(merge, (0, vdef), specs, 1)
    prog = list(merge_fn.programs.values())[0][0]
    rng = np.random.default_rng(5)
    starts = torch.from_numpy(_starts(rng, 2, 500, "random"))
    leaves = [torch.from_numpy(v) for v in _leaves(rng, 2, 500, dts)]
    n = torch.tensor([500, 400], dtype=torch.int32)
    got = kernels.segmented_merge_plain(starts, n, leaves, prog)
    want = collectives.segmented_combine(starts, leaves, merge_fn)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_checks_the_leaves_against_the_program():
    prog = _program("pair")
    starts = torch.ones((2, 4), dtype=torch.bool)
    n = torch.tensor([4, 4], dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.segmented_merge(starts, n, [torch.zeros((2, 4), dtype=
                                                         torch.int32)] * 2,
                                prog)
    with pytest.raises(ValueError):
        kernels.segmented_merge(starts.to(torch.uint8), n,
                                [torch.zeros((2, 4), dtype=torch.int64)] * 2,
                                prog)


def test_scratch_levels():
    """The wrapper's scratch size mirrors dpk_segmented_merge_scratch: for
    each tile of K14_TILE rows (a warp's), 2S + 1 int64 words (its last
    run's fold, its head run's fold and end row) and a flag byte, 8-byte
    aligned: one level above the rows, not one every factor of 8."""
    T = kernels.K14_TILE
    assert kernels._k14_scratch_bytes(8, 1, 2) == 8 * 5 * 8 + 8
    assert kernels._k14_scratch_bytes(8, T, 2) == 8 * 5 * 8 + 8
    assert kernels._k14_scratch_bytes(8, T + 1, 2) == 16 * 5 * 8 + 16
    cap, N, S = 8_388_608, 8, 6
    nt = N * (cap // T)
    assert kernels._k14_scratch_bytes(N, cap, S) == nt * 13 * 8 + nt


@pytest.mark.parametrize("name,separable", [("pair", True), ("q1", True),
                                            ("sum8", True),
                                            ("argmax", False),
                                            ("mixed", False),
                                            ("argmax7", False)])
def test_routes_of_the_cases(name, separable):
    """A lane-separable program (the pair, Q1 and 8-leaf sums) takes K14's
    separable route; argmax (a where over a compare), the mixed merge (a
    bool or) and the 7-leaf argmax run the interpreter, whose register
    file (the program's own register count, at least 2S) sizes the
    kernel's shared memory.  Past 6 slots the wide library runs."""
    prog = _program(name)
    assert (prog.separable_ops() is not None) == separable
    assert prog.nregs >= 2 * prog.nslots
    assert (prog.nslots > kernels.K14_NARROW_SLOTS) == (
        name in ("sum8", "argmax7"))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """K14 launched on the card equals its plain version at every run's
    last valid row (one launch a call): integers and bools bit for bit,
    floats within 1e-12 relative; one run over a whole shard, an empty
    shard, cap = 1, runs that cross many threads' chunks and tiles.  Both
    routes: the pair and Q1 sums are lane-separable, argmax and the mixed
    merge run the interpreter; a second call gives identical bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    for name in sorted(CASES):
        _, _, dts, _ = CASES[name]
        prog = _program(name)
        for cap, layout in ((1, "random"), (9, "random"), (1000, "random"),
                            (70_000, "long runs"), (70_000, "one run"),
                            (1 << 20, "one run"), (300_001, "random")):
            N = 3
            starts = _starts(rng, N, cap, layout)
            leaves = _leaves(rng, N, cap, dts)
            n = np.array([cap, 0, max(0, cap - 5)], np.int32)
            args = (torch.from_numpy(starts), torch.from_numpy(n),
                    [torch.from_numpy(v) for v in leaves])
            before = kernels.LAUNCHES["segmented_merge"]
            got = kernels.segmented_merge(
                args[0].to(dev), args[1].to(dev),
                [v.to(dev) for v in args[2]], prog)
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["segmented_merge"] == before + 1
            want = kernels.segmented_merge_plain(*args, prog)
            mask = _run_last(starts, n)
            _check([g.cpu().numpy() for g in got],
                   [w.numpy() for w in want], mask, dts)
            again = kernels.segmented_merge(
                args[0].to(dev), args[1].to(dev),
                [v.to(dev) for v in args[2]], prog)
            m = torch.from_numpy(mask).to(dev)
            for g, a in zip(got, again):
                assert torch.equal(g[m], a[m])
