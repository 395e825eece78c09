"""K18 (topk_select) launched on the card against its plain version.

Every test here is marked `cuda` and skips without a card; on the card:
``python -m pytest -m cuda tests/test_torch_topk_select_cuda.py``.  The
file imports no JAX: the CPU tests of the plain version against the JAX
package and against K5 + K2 are in tests/test_torch_topk_select.py.
Every comparison is bit for bit over each shard's kept rows (the rows
past the new count are zero in both).
"""

import numpy as np
import pytest
import torch

from dpark_tpu_torch.backend.cuda import kernels

pytestmark = pytest.mark.cuda

N = 3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    kernels.build()
    return torch.device("cuda")


def _column(kind, cap, seed):
    """(N, cap) keys: random with the type's extremes and float specials,
    heavy ties (bench values i & 0xFFFF), or sorted either way (the
    threshold's hardest order)."""
    rng = np.random.default_rng(seed)
    i = np.arange(N * cap, dtype=np.int64).reshape(N, cap)
    if kind == "ties":
        return i & 0xFFFF
    if kind == "ascending":
        return i * 3 - 5
    if kind == "descending":
        return -i
    if kind == "f64":
        x = rng.standard_normal((N, cap)) * 1e3
        special = [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan,
                   np.finfo(np.float64).max, -np.finfo(np.float64).tiny]
    else:
        dt = np.int32 if kind == "i32" else np.int64
        info = np.iinfo(dt)
        x = rng.integers(info.min, info.max, (N, cap), dtype=dt,
                         endpoint=True)
        x[:, ::3] = rng.integers(-50, 50, (N, len(range(0, cap, 3))))
        special = [info.min, info.max, info.min + 1, 0, -1]
    if cap:
        pos = rng.integers(0, cap, (N, max(1, cap // 50)))
        for s in range(N):
            x[s, pos[s]] = rng.choice(np.array(special, dtype=x.dtype),
                                      pos.shape[1])
    return x


def _bits(t):
    return t.contiguous().view(torch.int64) if t.dtype == torch.float64 \
        else t


def _check(dev, cols, counts, n, largest, leaves):
    cols = [torch.from_numpy(np.ascontiguousarray(c)) for c in cols]
    counts = torch.tensor(counts, dtype=torch.int32)
    leaves = [torch.from_numpy(np.ascontiguousarray(v)) for v in leaves]
    want, want_n = kernels.topk_select_plain(cols, counts, n, largest,
                                             leaves + cols)
    before = kernels.LAUNCHES["topk_select"]
    got, got_n = kernels.topk_select([c.to(dev) for c in cols],
                                     counts.to(dev), n, largest,
                                     [v.to(dev) for v in leaves + cols])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["topk_select"] == before + 1
    assert torch.equal(got_n.cpu(), want_n)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(_bits(g.cpu()), _bits(w))


def _leaves(cap, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1 << 40, (N, cap)),
            rng.standard_normal((N, cap, 3)),
            rng.integers(0, 100, (N, cap)).astype(np.int32),
            rng.random((N, cap)) < 0.5]


@pytest.mark.parametrize("kind", ["i32", "i64", "f64", "ties", "ascending",
                                  "descending"])
@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("cap", [1, 7, 65_536, 131_073, 300_001, 1 << 20])
def test_one_key_matches_plain(dev, kind, largest, cap):
    col = _column(kind, cap, cap + len(kind))
    if kind == "i32":
        col = col.astype(np.int32)
    counts = [cap, 0, max(0, cap - 11)]          # an empty shard
    for n in (1, 10, 1024):
        _check(dev, [col], counts, min(n, max(cap, 1)), largest,
               _leaves(cap, cap))


@pytest.mark.parametrize("kinds", [("i64", "i64"), ("ties", "f64"),
                                   ("i32", "ascending"), ("f64", "i32")])
@pytest.mark.parametrize("largest", [True, False])
def test_two_keys_match_plain(dev, kinds, largest):
    cap = 70_001
    cols = [_column(k, cap, 7 + i) for i, k in enumerate(kinds)]
    cols = [c.astype(np.int32) if k == "i32" else c
            for c, k in zip(cols, kinds)]
    cols[0] = cols[0] % 5 if cols[0].dtype.kind == "i" else cols[0]
    for n in (1, 10, 777):
        _check(dev, cols, [cap, cap - 1, 3], n, largest, _leaves(cap, 3))


def test_n_above_count_and_cap(dev):
    """n past a shard's count keeps the whole shard; n = cap keeps all."""
    cap = 300
    col = _column("i64", cap, 1)
    _check(dev, [col], [cap, 12, 0], cap, True, _leaves(cap, 1))
    _check(dev, [col], [cap, 12, 0], 64, False, _leaves(cap, 1))


def test_unaligned_key_and_many_leaves(dev):
    """A key column that is not 16-byte aligned (the scalar loads) and
    more leaves than one gather launch copies (two groups of 16)."""
    cap = 65_536
    # a view one element in: data_ptr not a multiple of 16
    flat = torch.empty(N * cap + 1, dtype=torch.int64, device=dev)
    odd = flat[1:].view(N, cap)
    odd.copy_(torch.from_numpy(_column("i64", cap, 5)))
    assert odd.data_ptr() % 16 != 0
    counts = torch.tensor([cap, cap - 3, 17], dtype=torch.int32, device=dev)
    leaves = [torch.full((N, cap), k, dtype=torch.int64, device=dev)
              + torch.arange(cap, device=dev) for k in range(20)]
    got, got_n = kernels.topk_select([odd], counts, 10, True, leaves)
    want, want_n = kernels.topk_select_plain([odd.cpu()], counts.cpu(), 10,
                                             True, [v.cpu() for v in leaves])
    assert torch.equal(got_n.cpu(), want_n)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_wrapper_refuses_what_k18_does_not_take(dev):
    col = torch.zeros((N, 8), dtype=torch.int64, device=dev)
    counts = torch.full((N,), 8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        kernels.topk_select([col], counts, kernels.K18_MAX_N + 1, True, [])
    with pytest.raises(ValueError):
        kernels.topk_select([col] * 3, counts, 2, True, [])
    with pytest.raises(ValueError):
        kernels.topk_select([col.float()], counts, 2, True, [])
