"""The spilled-run combine on the CPU, where the kernels' plain PyTorch
versions run: K13 (kernels.rid_fold) against the jnp fold it replaces
(dpark_tpu/backend/tpu/collectives.py bucketize_combine_rid's device and
rid columns, lines 446-449, with jnp.bincount of the device), and B12
(collectives.bucketize_combine_rid: K13, K5 passes, K2, K3) against the
JAX package's bucketize_combine_rid under jax.jit on the CPU, one shard
at a time, on the same seeded numpy inputs: empty shards, r below, at
and far above the shard count, one to four key columns, the monoids
add, min and max and a traced tuple merge.  Every comparison is exact:
int results bit for bit, float sums of small integers exact.  The
kernels themselves run in the test marked `cuda`, on a card only
(`python -m pytest -m cuda tests/test_torch_spill_kernels.py`)."""

import numpy as np
import pytest
import torch

from dpark_tpu_torch.backend.cuda import collectives, kernels

N = 4


@pytest.fixture(scope="module")
def jax_ref():
    import jax
    jax.config.update("jax_enable_x64", True)     # int64 stays int64
    import jax.numpy as jnp

    from dpark_tpu.backend.tpu import collectives as ref
    return jax, jnp, ref


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _counts(rng, cap, empty):
    n = rng.integers(0, cap + 1, N).astype(np.int32)
    n[list(empty)] = 0
    return n


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("r", [3, N, 64, 1000])
def test_rid_fold_plain_matches_reference(jax_ref, seed, r):
    """dev = rid % N on valid rows (N on padding), the rid widened to
    int64 (the sentinel on padding), and each shard's bincount of dev."""
    _, jnp, ref = jax_ref
    rng = np.random.default_rng(seed * 31 + r)
    cap = 37 + seed * 11
    rid = rng.integers(0, r, (N, cap)).astype(np.int32)
    n = _counts(rng, cap, empty=(seed % N,))
    before = kernels.LAUNCHES["rid_fold"]
    dev, rid64, hist = kernels.rid_fold(_t(rid), _t(n), N)
    assert kernels.LAUNCHES["rid_fold"] == before   # the plain version ran
    assert dev.dtype == torch.int32 and rid64.dtype == torch.int64
    for s in range(N):
        valid = jnp.arange(cap) < n[s]
        rd = jnp.asarray(rid[s].astype(np.int64))
        want_dev = jnp.where(valid, (rd % N).astype(jnp.int32), N)
        want_rid = jnp.where(valid, rd, ref._sentinel(rd.dtype))
        assert np.array_equal(dev[s].numpy(), np.asarray(want_dev))
        assert np.array_equal(rid64[s].numpy(), np.asarray(want_rid))
        assert np.array_equal(hist[s].numpy(), np.asarray(
            jnp.bincount(want_dev, length=N + 1)))


def _merge_case(kind):
    """(port merge_leaves, reference merge_leaves, value dtypes, monoid)
    of one combine kind."""
    if kind == "tuple":
        def merge(a, b):
            return [a[0] + b[0], a[1] + b[1]]
        return merge, merge, (np.int64, np.int64), None
    if kind == "float add":
        return None, None, (np.float64,), "add"
    return None, None, (np.int64,), kind


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("nk", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["add", "min", "max", "float add",
                                  "tuple"])
def test_bucketize_combine_rid_matches_reference(jax_ref, seed, nk, kind):
    """The port's B12 on the CPU equals the reference's jitted
    bucketize_combine_rid shard by shard: the packed (rid, keys, values)
    rows of every destination, and the counts and offsets."""
    jax, jnp, ref = jax_ref
    rng = np.random.default_rng(1000 + seed * 10 + nk)
    cap, r = 64, {1: 23, 2: 5, 3: N, 4: 200}[nk]     # r vs N shards
    merge, ref_merge, vdts, monoid = _merge_case(kind)
    rid = rng.integers(0, r, (N, cap)).astype(np.int32)
    keys = [rng.integers(-3, 4, (N, cap)).astype(np.int64)
            for _ in range(nk)]
    vals = [rng.integers(-50, 50, (N, cap)).astype(dt) for dt in vdts]
    n = _counts(rng, cap, empty=(seed + 1,))
    leaves, counts, offsets = collectives.bucketize_combine_rid(
        _t(rid), [_t(k) for k in keys], [_t(v) for v in vals], _t(n), N,
        merge, monoid=monoid)
    assert len(leaves) == 1 + nk + len(vals)

    @jax.jit
    def ref_fn(rid_s, n_s, *cols):
        return ref.bucketize_combine_rid(
            rid_s, list(cols[:nk]), list(cols[nk:]), n_s, N, ref_merge,
            monoid=monoid)

    for s in range(N):
        out, rc, ro = ref_fn(jnp.asarray(rid[s].astype(np.int64)),
                             jnp.int32(n[s]),
                             *[jnp.asarray(c[s]) for c in keys + vals])
        assert np.array_equal(counts[s].numpy(), np.asarray(rc))
        assert np.array_equal(offsets[s].numpy(), np.asarray(ro))
        total = int(np.asarray(rc).sum())
        for got, want in zip(leaves, out):
            assert np.array_equal(got[s, :total].numpy(),
                                  np.asarray(want)[:total]), (s, kind)


def test_bucketize_combine_rid_refuses_wide_keys():
    """(dev, rid) and five key columns exceed K3's six: refused, never
    truncated."""
    cap = 8
    z = torch.zeros((N, cap), dtype=torch.int64)
    with pytest.raises(ValueError, match="exceed"):
        collectives.bucketize_combine_rid(
            torch.zeros((N, cap), dtype=torch.int32), [z] * 5, [z],
            torch.full((N,), cap, dtype=torch.int32), N, None,
            monoid="add")


def test_rid_fold_refuses_bad_inputs():
    n = torch.full((N,), 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        kernels.rid_fold(torch.zeros((N, 8), dtype=torch.int64), n, N)
    with pytest.raises(ValueError, match="n must be"):
        kernels.rid_fold(torch.zeros((N, 8), dtype=torch.int32),
                         n.long(), N)


@pytest.mark.cuda
def test_rid_fold_and_b12_match_plain_on_card():
    """K13 launched on the card equals its plain version bit for bit
    (one launch a call), and B12 on the card equals the composition of
    the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    for cap, r in ((1, 3), (1000, N), (5000, 64), (70000, 1000)):
        rid = _t(rng.integers(0, r, (N, cap)).astype(np.int32))
        n = _t(_counts(rng, cap, empty=(1,)))
        before = kernels.LAUNCHES["rid_fold"]
        got = kernels.rid_fold(rid.to(dev), n.to(dev), N)
        assert kernels.LAUNCHES["rid_fold"] == before + 1
        for g, w in zip(got, kernels.rid_fold_plain(rid, n, N)):
            assert torch.equal(g.cpu(), w)
        keys = [_t(rng.integers(0, 50, (N, cap)).astype(np.int64))
                for _ in range(2)]
        vals = [_t(rng.integers(0, 1 << 16, (N, cap)).astype(np.int64))]
        got = collectives.bucketize_combine_rid(
            rid.to(dev), [k.to(dev) for k in keys],
            [v.to(dev) for v in vals], n.to(dev), N, None, monoid="add")
        want = collectives.bucketize_combine_rid(rid, keys, vals, n, N,
                                                 None, monoid="add")
        for g, w in zip(got[0], want[0]):
            assert torch.equal(g.cpu(), w)
        assert torch.equal(got[1].cpu(), want[1])
        assert torch.equal(got[2].cpu(), want[2])
