"""The port's K9 (edge_gather) and K10 (pregel_deliver) kernels on the
CPU, where their plain PyTorch versions run, against the jnp expressions
they replace in the JAX package's DevicePregel
(dpark_tpu/backend/tpu/bagel.py): `v[slot]` and `a[slot] & ev` of
_p_gen, and `searchsorted(uk, ids)` / `uk[pos] == ids` / the identity
fill of _p_step, one shard at a time on the same seeded numpy inputs.
Every comparison is exact: the outputs are copies, flags and identities.
The kernels themselves run in the test marked `cuda`, on a card only
(`python -m pytest -m cuda tests/test_torch_pregel_kernels.py`: jax is
imported by the reference fixture alone, so the card's machine needs
none)."""

import numpy as np
import pytest
import torch

from dpark_tpu_torch.backend.cuda import kernels

SENT = np.iinfo(np.int64).max
MONOIDS = ["add", "min", "max", "mul"]
LEAF_DTYPES = [np.int32, np.int64, np.float64, np.float32, np.bool_]


@pytest.fixture(scope="module")
def jnp():
    import jax
    jax.config.update("jax_enable_x64", True)     # int64 ids stay int64
    import jax.numpy
    return jax.numpy


def _ref_identity(combine, dt):
    from dpark_tpu.bagel import monoid_identity
    return monoid_identity(combine, dt)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _leaf(rng, shape, dt):
    if dt == np.bool_:
        return rng.randint(0, 2, shape).astype(bool)
    if np.dtype(dt).kind == "f":
        return (rng.randn(*shape) * 100).astype(dt)
    return rng.randint(-1000, 1000, shape).astype(dt)


def _edge_case(seed, N=3, cap_v=16, cap_e=32, empty=(1,)):
    """Vertex leaves of every dtype (and a (3,) vector leaf), a gate, and
    edge slots; shards in `empty` hold no edge, the others a random
    count, padded slots 0 as the reference pads them."""
    rng = np.random.RandomState(seed)
    leaves = [_leaf(rng, (N, cap_v), dt) for dt in LEAF_DTYPES]
    leaves.append(rng.randn(N, cap_v, 3))
    gate = rng.randint(0, 2, (N, cap_v)).astype(bool)
    ecnt = np.array([0 if s in empty else rng.randint(1, cap_e + 1)
                     for s in range(N)], np.int32)
    slot = np.zeros((N, cap_e), np.int32)
    for s in range(N):
        slot[s, :ecnt[s]] = rng.randint(0, cap_v, ecnt[s])
    return leaves, gate, slot, ecnt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_edge_gather_plain_matches_reference(seed, jnp):
    leaves, gate, slot, ecnt = _edge_case(seed)
    out, sa = kernels.edge_gather(_t(slot), _t(ecnt),
                                  [_t(l) for l in leaves], _t(gate))
    cap_e = slot.shape[1]
    for s in range(slot.shape[0]):
        sl = jnp.asarray(slot[s])
        ev = jnp.arange(cap_e) < ecnt[s]
        want_sa = jnp.asarray(gate[s])[sl] & ev
        assert np.array_equal(sa[s].numpy(), np.asarray(want_sa))
        for got, l in zip(out, leaves):
            want = np.asarray(jnp.asarray(l[s])[sl])
            assert got.dtype == _t(l).dtype
            assert np.array_equal(got[s].numpy(), want)


def test_edge_gather_send_gate_leaf_cast(jnp):
    """A float send-gate leaf cast to bool before the gather equals the
    reference's `vals[g][slot].astype(bool) & ev` (NaN and -0.0 too)."""
    leaves, _, slot, ecnt = _edge_case(5, empty=())
    g = np.array([[0.0, -0.0, np.nan, 2.5] * 4] * 3)
    _, sa = kernels.edge_gather(_t(slot), _t(ecnt), [_t(leaves[1])],
                                _t(g).to(torch.bool).contiguous())
    for s in range(3):
        ev = jnp.arange(slot.shape[1]) < ecnt[s]
        want = jnp.asarray(g[s])[jnp.asarray(slot[s])].astype(bool) & ev
        assert np.array_equal(sa[s].numpy(), np.asarray(want))


def test_edge_gather_padded_slots_read_row_zero(jnp):
    """A padded slot gathers vertex row 0 and flags False whatever its
    e_slot holds: the reference's `v[slot]`, `a[slot] & ev` over its
    zero-padded slots (the kernel never reads a padded slot)."""
    leaves, gate, slot, ecnt = _edge_case(7)
    rng = np.random.RandomState(70)
    junk = slot.copy()
    for s in range(slot.shape[0]):
        junk[s, ecnt[s]:] = rng.randint(1, 16, slot.shape[1] - ecnt[s])
    out, sa = kernels.edge_gather(_t(junk), _t(ecnt),
                                  [_t(l) for l in leaves], _t(gate))
    for s in range(slot.shape[0]):
        sl = jnp.asarray(slot[s])
        ev = jnp.arange(slot.shape[1]) < ecnt[s]
        assert np.array_equal(sa[s].numpy(),
                              np.asarray(jnp.asarray(gate[s])[sl] & ev))
        for got, l in zip(out, leaves):
            assert np.array_equal(got[s].numpy(),
                                  np.asarray(jnp.asarray(l[s])[sl]))


def test_edge_gather_checks_its_inputs():
    leaves, gate, slot, ecnt = _edge_case(0)
    with pytest.raises(ValueError, match="gate"):
        kernels.edge_gather(_t(slot), _t(ecnt), [_t(leaves[0])],
                            _t(gate.astype(np.int32)))
    with pytest.raises(ValueError, match="e_slot"):
        kernels.edge_gather(_t(slot.astype(np.int64)), _t(ecnt),
                            [_t(leaves[0])], _t(gate))


def _deliver_case(seed, N=4, cap_v=16, cap_u=24):
    """Per shard: sorted vertex ids (the sentinel past vcnt), and sorted
    unique message keys (the sentinel past n_unique) drawn partly from
    the shard's ids and partly from ids with no vertex.  Shard 1 has no
    mail, shard 2 no vertex."""
    rng = np.random.RandomState(seed)
    vid = np.full((N, cap_v), SENT, np.int64)
    uk = np.full((N, cap_u), SENT, np.int64)
    vcnt = np.zeros(N, np.int32)
    nu = np.zeros(N, np.int32)
    for s in range(N):
        c = 0 if s == 2 else rng.randint(1, cap_v + 1)
        ids = np.sort(rng.choice(1000, c, replace=False)) * 3 + s
        vid[s, :c] = ids
        vcnt[s] = c
        if s == 1:
            continue
        known = rng.choice(ids, rng.randint(0, c + 1), replace=False) \
            if c else np.zeros(0, np.int64)
        unknown = rng.choice(1000, 5, replace=False) * 3 + s + 1
        keys = np.unique(np.concatenate([known, unknown]))[:cap_u]
        uk[s, :len(keys)] = keys
        nu[s] = len(keys)
    return vid, vcnt, uk, nu


def _ref_deliver(jnp, vid, vcnt, uk, leaves, combine):
    """_p_step:364-370 per shard, in jnp."""
    N, cap_v = vid.shape
    msgs, hass = [[] for _ in leaves], []
    for s in range(N):
        ids = jnp.asarray(vid[s])
        u = jnp.asarray(uk[s])
        valid_v = jnp.arange(cap_v) < vcnt[s]
        pos = jnp.clip(jnp.searchsorted(u, ids), 0, u.shape[0] - 1)
        has = (u[pos] == ids) & valid_v & (ids != SENT)
        hass.append(np.asarray(has))
        for i, l in enumerate(leaves):
            lv = jnp.asarray(l[s])
            h = has.reshape(has.shape + (1,) * (lv.ndim - 1))
            msgs[i].append(np.asarray(jnp.where(
                h, lv[pos], _ref_identity(combine, l.dtype))))
    return [np.stack(m) for m in msgs], np.stack(hass)


@pytest.mark.parametrize("combine", MONOIDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_pregel_deliver_plain_matches_reference(combine, seed, jnp):
    vid, vcnt, uk, nu = _deliver_case(seed)
    rng = np.random.RandomState(seed + 10)
    N, cap_u = uk.shape
    dts = [np.int32, np.int64, np.float64, np.float32]
    leaves = [_leaf(rng, (N, cap_u), dt) for dt in dts]
    leaves.append(rng.randn(N, cap_u, 2))
    if combine in ("add", "mul"):     # bools have no min / max identity
        leaves.append(_leaf(rng, (N, cap_u), np.bool_))
    out, has = kernels.pregel_deliver(_t(vid), _t(vcnt), _t(uk), _t(nu),
                                      [_t(l) for l in leaves], combine)
    want, want_has = _ref_deliver(jnp, vid, vcnt, uk, leaves, combine)
    assert np.array_equal(has.numpy(), want_has)
    assert want_has.any() and not want_has.all()
    for got, w in zip(out, want):
        assert got.numpy().dtype == w.dtype
        assert np.array_equal(got.numpy(), w)


@pytest.mark.parametrize("combine", MONOIDS)
@pytest.mark.parametrize("dt", [np.int32, np.int64, np.float32,
                                np.float64])
def test_pregel_identity_matches_reference(combine, dt):
    """The identity K10 fills with equals the reference's
    monoid_identity for every dtype and monoid."""
    got = torch.full((), kernels.identity(combine, _t(
        np.zeros(0, dt)).dtype), dtype=_t(np.zeros(0, dt)).dtype)
    want = _ref_identity(combine, dt)
    assert got.numpy().dtype == np.dtype(dt)
    assert got.item() == want


def test_pregel_deliver_searches_only_the_unique_prefix():
    """Keys past n_unique are never found, whatever they hold: the search
    is sized by n_unique, not by the exchange's padded width."""
    vid = np.array([[5, 7, 9, SENT]], np.int64)
    uk = np.array([[7, 9, 11, 12]], np.int64)        # 9 lies past n_unique
    leaf = np.array([[70.0, 90.0, 110.0, 120.0]])
    out, has = kernels.pregel_deliver(
        _t(vid), _t(np.array([3], np.int32)), _t(uk),
        _t(np.array([1], np.int32)), [_t(leaf)], "min")
    assert has.tolist() == [[False, True, False, False]]
    assert out[0].tolist() == [[np.inf, 70.0, np.inf, np.inf]]


def test_pregel_deliver_slots_past_vcnt_get_no_mail(jnp):
    """A slot past vcnt[s] is invalid whatever id it holds: no mail, the
    identity (the reference's `& valid_v`)."""
    vid = np.array([[3, 5, 7, 9]], np.int64)        # 7 and 9 past vcnt
    uk = np.array([[5, 7, 9, SENT]], np.int64)
    leaf = np.array([[1, 2, 3, 0]], np.int64)
    vcnt, nu = np.array([2], np.int32), np.array([3], np.int32)
    out, has = kernels.pregel_deliver(_t(vid), _t(vcnt), _t(uk), _t(nu),
                                      [_t(leaf)], "add")
    want, want_has = _ref_deliver(jnp, vid, vcnt, uk, [leaf], "add")
    assert has.tolist() == want_has.tolist() == [[False, True, False,
                                                  False]]
    assert out[0].tolist() == want[0].tolist() == [[0, 1, 0, 0]]


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """K9 and K10 launched on the card equal their plain versions bit for
    bit, and each launch is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    leaves, gate, slot, ecnt = _edge_case(3)
    args = (_t(slot), _t(ecnt), [_t(l) for l in leaves], _t(gate))
    before = kernels.LAUNCHES["edge_gather"]
    a = kernels.edge_gather(*[x.to(dev) if torch.is_tensor(x)
                              else [y.to(dev) for y in x] for x in args])
    b = kernels.edge_gather_plain(*args)
    assert kernels.LAUNCHES["edge_gather"] == before + 1
    for x, y in zip(a[0] + [a[1]], b[0] + [b[1]]):
        assert torch.equal(x.cpu(), y)
    vid, vcnt, uk, nu = _deliver_case(4)
    rng = np.random.RandomState(4)
    ls = [_leaf(rng, uk.shape, np.float64), rng.randn(*uk.shape, 2)]
    past = np.arange(vid.shape[1])[None, :] >= vcnt[:, None]
    for combine in MONOIDS:
        # slots past vcnt hold an id that has mail: still invalid
        v = np.where(past, uk[:, :1], vid) if combine == "add" else vid
        cpu = [_t(v), _t(vcnt), _t(uk), _t(nu)]
        a = kernels.pregel_deliver(*[x.to(dev) for x in cpu],
                                   [_t(l).to(dev) for l in ls], combine)
        b = kernels.pregel_deliver_plain(*cpu, [_t(l) for l in ls], combine)
        assert torch.equal(a[1].cpu(), b[1])
        for x, y in zip(a[0], b[0]):
            assert torch.equal(x.cpu(), y)
