"""K9 (edge_gather) and K11 (obj_emit_pack) launched on the card against
their plain versions, bit for bit, and two calls of each against each
other.

Every test here is marked `cuda` and skips without a card; on the card:
``python -m pytest -m cuda tests/test_torch_graph_kernels_cuda.py``.  The
file imports no JAX: the CPU tests of the plain versions against the JAX
package are in tests/test_torch_pregel_kernels.py and
tests/test_torch_bagel_obj_kernels.py.

K9: edge counts of 0, of cap_e, one below and one above a tile edge
(2,048 edges, the tile of csrc/edge_gather.cu), padded slots holding
other rows than 0 (they gather row 0 all the same), leaves of 1, 2, 4,
8, 16 and 24 B, more leaves than one launch takes (MAX_LEAVES), the send
gate cast from a vertex leaf, a cap_e that ends inside a tile, and one
that is no multiple of 4 (the scalar path).
K11: every gate closed, m = 1, cap * m no multiple of the tile (2,048
slots, kernels.K11_TILE) or odd, an empty shard, 48 blocks, and leaves
of 1, 4, 8, 16 and 24 B."""

import numpy as np
import pytest
import torch

from dpark_tpu_torch.backend.cuda import kernels

pytestmark = pytest.mark.cuda

SENT = np.iinfo(np.int64).max


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    kernels.build()
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().view(torch.uint8)


def _equal(got, want):
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(_bits(x.cpu()), _bits(y.cpu()))


# ---------------------------------------------------------------------
# K9
# ---------------------------------------------------------------------
LEAF_KINDS = {1: (np.int8, ()), 2: (np.int16, ()), 4: (np.float32, ()),
              8: (np.float64, ()), 16: (np.int64, (2,)),
              24: (np.float64, (3,))}


def _k9_inputs(dev, ecnt, cap_e, cap_v, widths, seed, garbage=True):
    rng = np.random.RandomState(seed)
    N = len(ecnt)
    ecnt = np.asarray(ecnt, np.int32)
    slot = rng.randint(0, cap_v, (N, cap_e)).astype(np.int32)
    if not garbage:
        for s in range(N):
            slot[s, ecnt[s]:] = 0
    leaves = []
    for w in widths:
        dt, shp = LEAF_KINDS[w]
        a = rng.randint(-100, 100, (N, cap_v) + shp).astype(dt)
        if np.dtype(dt).kind == "f":
            a = (a + rng.standard_normal(a.shape)).astype(dt)
        leaves.append(a)
    gate = rng.rand(N, cap_v) < 0.5

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t(slot), t(ecnt), [t(a) for a in leaves], t(gate)


def _k9_check(slot, ecnt, leaves, gate):
    before = kernels.LAUNCHES["edge_gather"]
    got = kernels.edge_gather(slot, ecnt, leaves, gate)
    launched = kernels.LAUNCHES["edge_gather"] - before
    assert launched == max(1, -(-len(leaves) // kernels.MAX_LEAVES))
    again = kernels.edge_gather(slot, ecnt, leaves, gate)
    cpu = [x.cpu() for x in leaves]
    want = kernels.edge_gather_plain(slot.cpu(), ecnt.cpu(), cpu,
                                     gate.cpu())
    _equal(list(got[0]) + [got[1]], list(want[0]) + [want[1]])
    _equal(list(got[0]) + [got[1]], list(again[0]) + [again[1]])


TILE = 2048


@pytest.mark.parametrize("ecnt", [
    [0, 0, 0],
    [4 * TILE, 4 * TILE, 4 * TILE],                # every slot live
    [TILE - 1, TILE + 1, 2 * TILE - 4],            # tile edges
    [0, 3 * TILE + 5, 17]])
def test_k9_edge_counts(dev, ecnt):
    _k9_check(*_k9_inputs(dev, ecnt, 4 * TILE, 3000, [8, 1], 1))


@pytest.mark.parametrize("width", sorted(LEAF_KINDS))
def test_k9_leaf_widths(dev, width):
    _k9_check(*_k9_inputs(dev, [5000, 0, 8192], 8192, 777, [width], 2))


def test_k9_padded_slots_gather_row_zero(dev):
    """Padded slots hold zeros as the reference's do, or other rows: the
    kernel reads neither and writes row 0."""
    for garbage in (False, True):
        _k9_check(*_k9_inputs(dev, [100, 2500, 0], 4096, 50, [8, 4], 3,
                              garbage=garbage))


def test_k9_more_leaves_than_one_launch(dev):
    widths = [8, 4, 1, 16, 2, 24] * 3                     # 18 leaves
    _k9_check(*_k9_inputs(dev, [3000, 4096, 1], 4096, 999, widths, 4))


def test_k9_no_leaves(dev):
    _k9_check(*_k9_inputs(dev, [3000, 4096, 1], 4096, 999, [], 5))


def test_k9_send_gate_cast(dev):
    """DevicePregel._p_gen's send gate: a vertex leaf cast to bool."""
    slot, ecnt, leaves, _ = _k9_inputs(dev, [4000, 9000, 0], 9216, 1234,
                                       [8, 4, 1], 6)
    gate = leaves[2].to(torch.bool).contiguous()
    _k9_check(slot, ecnt, leaves, gate)


@pytest.mark.parametrize("cap_e", [2052, 3076, 1028])
def test_k9_cap_inside_a_tile(dev, cap_e):
    """The last tile's threads past cap_e, or with one group inside."""
    _k9_check(*_k9_inputs(dev, [cap_e, cap_e - 3, 1030], cap_e, 300,
                          [8, 1, 16, 24], 8))


@pytest.mark.parametrize("cap_e", [4099, 2050, 6])
def test_k9_unaligned_cap(dev, cap_e):
    """cap_e no multiple of 4: the kernel's scalar path."""
    _k9_check(*_k9_inputs(dev, [cap_e, cap_e // 2, 0], cap_e, 300,
                          [8, 1, 24], 7))


# ---------------------------------------------------------------------
# K11
# ---------------------------------------------------------------------
def _k11_blocks(dev, spec, widths, seed, N=3, closed=(), empty_shard=None):
    """Emission blocks of (cap, m): gates open with probability 0.4
    (none in `closed` blocks or on `empty_shard`), a quarter of the
    targets the sentinel, one leaf per width of LEAF_KINDS."""
    rng = np.random.RandomState(seed)
    out = []
    for b, (cap, m) in enumerate(spec):
        gate = rng.rand(N, cap) < (0.0 if b in closed else 0.4)
        if empty_shard is not None:
            gate[empty_shard] = False
        dst = rng.randint(0, 1 << 40, (N, cap, m)).astype(np.int64)
        dst[rng.rand(N, cap, m) < 0.25] = SENT
        leaves = []
        for w in widths:
            dt, shp = LEAF_KINDS[w]
            leaves.append(rng.randint(-100, 100, (N, cap, m) + shp)
                          .astype(dt))
        out.append((gate, dst, leaves))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return [(t(g), t(d), [t(x) for x in lv]) for g, d, lv in out]


def _k11_check(blocks):
    before = kernels.LAUNCHES["obj_emit_pack"]
    got = kernels.obj_emit_pack(blocks)
    assert kernels.LAUNCHES["obj_emit_pack"] == before + 1
    again = kernels.obj_emit_pack(blocks)
    cpu = [(g.cpu(), d.cpu(), [x.cpu() for x in lv]) for g, d, lv in blocks]
    want = kernels.obj_emit_pack_plain(cpu)

    def flat(r):
        return [r[0]] + list(r[1]) + [r[2]]
    _equal(flat(got), flat(want))
    _equal(flat(got), flat(again))
    return want


def test_k11_all_gates_closed(dev):
    blocks = _k11_blocks(dev, [(64, 4), (300, 2)], [8], 1, closed=(0, 1))
    want = _k11_check(blocks)
    assert int(want[2].sum()) == 0


@pytest.mark.parametrize("spec", [
    [(5000, 1)],                              # m = 1
    [(1000, 3), (777, 5)],                    # cap * m odd, no tile edge
    [(2049, 1), (1025, 2), (683, 3)],         # one past a tile edge
    [(64, 2), (512, 16), (40, 1), (96, 64)],  # mixed widths
])
def test_k11_shapes(dev, spec):
    _k11_check(_k11_blocks(dev, spec, [8], 2))


def test_k11_empty_shard(dev):
    want = _k11_check(_k11_blocks(dev, [(800, 4), (200, 16)], [8, 4], 3,
                                  empty_shard=1))
    assert int(want[2][1]) == 0 and int(want[2].sum()) > 0


def test_k11_48_blocks(dev):
    """The most blocks a superstep has: 24 classes, mail and no-mail."""
    spec = [(32 * (1 + b % 5), 1 << (b // 2 % 7)) for b in range(48)]
    _k11_check(_k11_blocks(dev, spec, [8], 4, closed=(5, 17, 40)))


@pytest.mark.parametrize("widths", [[1], [4], [8], [24], [8, 1, 4, 24, 16]])
def test_k11_leaf_widths(dev, widths):
    _k11_check(_k11_blocks(dev, [(700, 8), (3000, 1), (33, 32)], widths, 5))
