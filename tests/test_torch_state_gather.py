"""K8's state gather (the state mode of the segmented apply,
updateStateByKey's update(values, prev)) on the CPU, where its plain
version runs, against the JAX package's state mode: gather_bucket_groups
of the values and of the flags with the pad slots pinned to flag 2
(backend/tpu/fuse.py:862-875), then SegMapOp._new_vals and the masked
sum and any() of _apply_bucket (:803-835), one shard at a time, under
both pads.  Every comparison is exact (the values are copies)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dpark_tpu.backend.tpu import collectives as ref
from dpark_tpu.backend.tpu.fuse import SegMapOp as RefSegMapOp
from dpark_tpu_torch.backend.cuda import collectives as col
from dpark_tpu_torch.backend.cuda import kernels
from dpark_tpu_torch.backend.cuda.layout import round_capacity

jax.config.update("jax_enable_x64", True)

CAP = 256


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _shard(sizes, seed, dtype):
    """A key-sorted shard whose groups have `sizes`; in about half of the
    groups one row (at a random place) is the carried state (flag 1)."""
    rng = np.random.RandomState(seed)
    keys = np.sort(rng.choice(10 ** 6, len(sizes), replace=False))
    k = np.full(CAP, np.iinfo(np.int64).max, np.int64)
    f = np.zeros(CAP, np.int64)
    if np.dtype(dtype).kind == "f":
        v = np.zeros(CAP)
        draw = rng.standard_normal(CAP) * 100
    else:
        v = np.zeros(CAP, np.int64)
        draw = rng.randint(-1000, 1000, CAP)
    at = 0
    for g, size in enumerate(sizes):
        k[at:at + size] = keys[g]
        if size and rng.rand() < 0.5:
            f[at + rng.randint(size)] = 1
        at += size
    v[:at] = draw[:at]
    return k, v, f, at


def _case(name, dtype):
    if name == "pow2":
        plan = [[1, 2, 4, 8, 16, 32, 64], [3, 5, 9, 17, 33, 2, 1],
                [100, 28, 1]]
    elif name == "empty_shard":
        plan = [[5, 7, 1], [], [2, 2, 1]]
    else:
        rng = np.random.RandomState(11)
        plan = []
        for s in range(3):
            sizes = []
            while sum(sizes) < CAP - 40:
                sizes.append(int(rng.choice([1, 1, 2, 3, 4, 7, 8, 16])))
            plan.append(sizes)
    shards = [_shard(sizes, 20 + s, dtype) for s, sizes in enumerate(plan)]
    return [np.stack([sh[i] for sh in shards]) for i in range(3)], \
        np.array([sh[3] for sh in shards], np.int32)


def _reference(k, v, f, n, b, G, pad):
    """The reference's state-mode inputs of size class b on one shard:
    (new values (G, B), prev (G,), has_prev (G,), valid lanes (G,))."""
    B = 1 << b
    st, sz, _, nseg = ref.segment_spans([jnp.asarray(k)], jnp.int32(n))
    seg_sel, gvalid = ref.bucket_members(sz, nseg, b, G)
    vals = ref.gather_bucket_groups(st, sz, seg_sel, gvalid, B,
                                    jnp.asarray(v), "zero")
    fl = ref.gather_bucket_groups(st, sz, seg_sel, gvalid, B,
                                  jnp.asarray(f), "zero")
    szs = sz[jnp.clip(seg_sel, 0, CAP - 1)]
    in_range = jnp.arange(B)[None, :] < szs[:, None]
    fl = jnp.where(in_range, fl, jnp.full((), 2, fl.dtype))
    op = RefSegMapOp(lambda vs, prev: vs, pad)
    op.state_mode = True
    new = op._new_vals(vals, fl)
    prevs = jnp.sum(jnp.where(fl == 1, vals, jnp.zeros((), vals.dtype)),
                    axis=1)
    has = jnp.any(fl == 1, axis=1)
    return (np.asarray(new), np.asarray(prevs), np.asarray(has),
            np.asarray(gvalid))


@pytest.mark.parametrize("pad", ["zero", "edge"])
@pytest.mark.parametrize("dtype", [np.float64, np.int64])
@pytest.mark.parametrize("name", ["pow2", "empty_shard", "random"])
def test_state_gather_plain_matches_reference(name, dtype, pad):
    (keys, vals, flags), n = _case(name, dtype)
    table = kernels.segment_table([_t(keys)], _t(n))
    start_rows, sizes, bucket, _, hist, _ = table
    members, counts, offsets = col.bucket_members(bucket)
    gmax = hist.numpy().max(0)
    for b in np.flatnonzero(gmax).tolist():
        G, B = round_capacity(int(gmax[b])), 1 << b
        out, prev, has = col.gather_bucket_state(
            start_rows, sizes, members, offsets, counts, b, G, B,
            _t(vals), _t(flags), pad)
        assert out.shape == (len(n), G, B) and prev.shape == (len(n), G)
        assert out.dtype == prev.dtype == _t(vals).dtype
        assert has.dtype == torch.bool
        for s in range(len(n)):
            r_new, r_prev, r_has, r_valid = _reference(
                keys[s], vals[s], flags[s], n[s], b, G, pad)
            live = int(counts[s, b])
            assert int(r_valid.sum()) == live
            np.testing.assert_array_equal(out[s, :live].numpy(),
                                          r_new[:live])
            np.testing.assert_array_equal(prev[s, :live].numpy(),
                                          r_prev[:live])
            np.testing.assert_array_equal(has[s, :live].numpy(),
                                          r_has[:live])
            # invalid lanes are all zero
            assert not out[s, live:].any() and not prev[s, live:].any()
            assert not has[s, live:].any()


def test_state_gather_keeps_the_carried_bits():
    """prev is the flag-1 row's value copied: a carried -0.0 stays -0.0,
    as the host path's update sees it (the reference's masked sum turns
    it into +0.0)."""
    keys = np.array([[5, 5, 5, 9, 9, 0, 0, 0]], np.int64)
    keys[0, 5:] = np.iinfo(np.int64).max
    vals = np.array([[1.5, -0.0, 2.0, -0.0, 4.0, 0, 0, 0]])
    flags = np.array([[0, 1, 0, 0, 0, 0, 0, 0]], np.int64)
    n = np.array([5], np.int32)
    start_rows, sizes, bucket, _, _, _ = kernels.segment_table(
        [_t(keys)], _t(n))
    members, counts, offsets = col.bucket_members(bucket)
    # group 5 (class 2): new values 1.5, 2.0 compacted, the edge fill
    # repeats 2.0, the carried -0.0 kept
    out, prev, has = col.gather_bucket_state(
        start_rows, sizes, members, offsets, counts, 2, 8, 4, _t(vals),
        _t(flags), "edge")
    assert has[0, :1].tolist() == [True]
    assert np.signbit(prev[0, 0].item())
    assert out[0, 0].tolist() == [1.5, 2.0, 2.0, 2.0]
    # group 9 (class 1): no carried row, its new -0.0 kept
    out, prev, has = col.gather_bucket_state(
        start_rows, sizes, members, offsets, counts, 1, 8, 2, _t(vals),
        _t(flags), "edge")
    assert has[0, 0].item() is False and prev[0, 0].item() == 0.0
    assert out[0, 0].tolist() == [-0.0, 4.0]
    assert np.signbit(out[0, 0, 0].item())
    with pytest.raises(ValueError):
        col.gather_bucket_state(start_rows, sizes, members, offsets,
                                counts, 2, 8, 3, _t(vals), _t(flags),
                                "zero")



def test_k8s_chunk_matches_source():
    """The wrapper sizes the wide classes' chunk records by
    kernels._K8S_CHUNK: it must be the source's K8S_CHUNK."""
    import os
    import re
    src = open(os.path.join(kernels.CSRC, "bucket_groups.cu")).read()
    assert kernels._K8S_CHUNK == int(re.search(
        r"(?m)^#define K8S_CHUNK (\d+)", src).group(1))
