"""The port's torch hash (the plain version of the K1 kernel) against
the JAX package's device hash and the numpy/Python hashes, bit for bit,
on the edge cases of tests/test_phash.py."""

import numpy as np
import pytest
import torch

import jax

from dpark_tpu.utils import phash as ref
from dpark_tpu_torch.utils import phash as port

jax.config.update("jax_enable_x64", True)     # int64 keys stay int64


def _keys(dt, rng):
    info = np.iinfo(dt)
    return np.concatenate([
        rng.randint(info.min, info.max, 500).astype(dt),
        np.array([0, 1, -1, 2, -2, 123456, -123456, info.min, info.max],
                 dt)])


@pytest.mark.parametrize("dt", [np.int32, np.int64])
def test_phash_torch_matches_reference(dt):
    keys = _keys(dt, np.random.RandomState(0))
    got = port.phash_torch(torch.from_numpy(keys)).numpy()
    assert got.dtype == np.int64 and got.min() >= 0 and got.max() < 2 ** 32
    assert np.array_equal(got, np.asarray(ref.phash_device(keys))
                          .astype(np.int64))
    assert np.array_equal(got, ref.phash_np(keys).astype(np.int64))
    assert np.array_equal(port.phash_np(keys), ref.phash_np(keys))
    assert got.tolist() == [ref.portable_hash(int(k)) for k in keys]


def _tuple_key_cols(rng, ncols, n=700):
    cols = [rng.randint(-2 ** 62, 2 ** 62, n).astype(np.int64)
            for _ in range(ncols)]
    edges = np.array([0, 1, -1, 2 ** 31 - 1, -(2 ** 31), 2 ** 62,
                      -(2 ** 62), 2 ** 63 - 1, -(2 ** 63)], np.int64)
    return [np.concatenate([c, np.roll(edges, i)])
            for i, c in enumerate(cols)]


@pytest.mark.parametrize("ncols", [1, 2, 3, 4])
def test_phash_torch_cols_matches_reference(ncols):
    cols = _tuple_key_cols(np.random.RandomState(11), ncols)
    got = port.phash_torch_cols([torch.from_numpy(c) for c in cols]).numpy()
    dev = np.asarray(ref.phash_device_cols(list(cols))).astype(np.int64)
    assert np.array_equal(got, dev)
    assert np.array_equal(got, ref.phash_np_cols(cols).astype(np.int64))
    assert np.array_equal(port.phash_np_cols(cols), ref.phash_np_cols(cols))
    if ncols > 1:
        py = [ref.portable_hash(tuple(int(c[i]) for c in cols))
              for i in range(0, len(cols[0]), 37)]
        assert got[::37].tolist() == py


def test_phash_torch_int32_columns_sign_extend():
    """int32 key columns hash as their sign-extended int64 values."""
    k32 = np.array([0, -1, 5, 2 ** 31 - 1, -(2 ** 31)], np.int32)
    a = port.phash_torch_cols([torch.from_numpy(k32),
                               torch.from_numpy(k32.astype(np.int64))])
    b = port.phash_torch_cols([torch.from_numpy(k32.astype(np.int64))] * 2)
    assert torch.equal(a, b)


def test_portable_hash_copy_agrees():
    """The port's own copy of portable_hash is the reference's function
    on every type the host partitioner sees."""
    vals = [None, 0, -1, 2 ** 40, True, 1.0, 1.5, float("nan"), "abc",
            b"abc", (1, "a"), ((1, 2), 3), np.int32(7), np.float64(2.0)]
    assert [port.portable_hash(v) for v in vals] == \
        [ref.portable_hash(v) for v in vals]
