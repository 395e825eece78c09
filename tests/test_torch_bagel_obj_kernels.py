"""The object Bagel's kernels on the CPU, where their plain PyTorch
versions run, against the jnp code they replace in the JAX package's
DeviceObjectPregel._p_step (dpark_tpu/backend/tpu/bagel_obj.py):

  K11 obj_emit_pack   :892-913, each emission block's
                      `where(gate[:, None], dst, SENT)` and reshape, the
                      `concatenate` of the blocks, then
                      collectives.compact(..., dst != SENT), one shard at
                      a time: the packed prefix and the counts equal
                      exactly (the tail is SENT and zeros);
  K10 with fills=     :856-869 under a traced merge, whose filler
                      (_ident) is zero: `where(has, u[pos], 0)`.

The kernels themselves run in the test marked `cuda`, on a card only
(`python -m pytest -m cuda tests/test_torch_bagel_obj_kernels.py`)."""

import numpy as np
import pytest
import torch

from dpark_tpu_torch.backend.cuda import kernels

SENT = np.iinfo(np.int64).max


@pytest.fixture(scope="module")
def jnp():
    import jax
    jax.config.update("jax_enable_x64", True)     # int64 ids stay int64
    import jax.numpy
    return jax.numpy


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _blocks(seed, N=3, spec=((8, 3), (16, 1), (8, 5), (32, 2)),
            empty=(2,)):
    """Emission blocks (gate, dst, [int64 leaf, float64 (2,) vector leaf,
    float32 leaf]) of the given (cap, m); blocks in `empty` have all-false
    gates.  Targets are a mix of ids and the sentinel (dummy edges)."""
    rng = np.random.RandomState(seed)
    out = []
    for b, (cap, m) in enumerate(spec):
        gate = rng.rand(N, cap) < (0.0 if b in empty else 0.6)
        dst = rng.randint(0, 50, (N, cap, m)).astype(np.int64)
        dst[rng.rand(N, cap, m) < 0.25] = SENT
        leaves = [rng.randint(-99, 99, (N, cap, m)).astype(np.int64),
                  rng.randn(N, cap, m, 2),
                  rng.randn(N, cap, m).astype(np.float32)]
        out.append((gate, dst, leaves))
    return out


def _ref_pack(jnp, blocks):
    """bagel_obj.py:892-913 per shard, with the reference's compact."""
    from dpark_tpu.backend.tpu import collectives
    N = blocks[0][0].shape[0]
    nl = len(blocks[0][2])
    packs, counts = [], []
    for s in range(N):
        dsts, vals = [], [[] for _ in range(nl)]
        for gate, dst, leaves in blocks:
            g = jnp.asarray(gate[s])
            dsts.append(jnp.where(g[:, None], jnp.asarray(dst[s]),
                                  SENT).reshape(-1))
            for li, leaf in enumerate(leaves):
                lv = jnp.asarray(leaf[s])
                vals[li].append(lv.reshape((-1,) + lv.shape[2:]))
        dst_flat = jnp.concatenate(dsts)
        flats = [jnp.concatenate(v) for v in vals]
        packed, cnt = collectives.compact([dst_flat] + flats,
                                          dst_flat != SENT)
        packs.append([np.asarray(p) for p in packed])
        counts.append(int(cnt))
    return packs, counts


def _pack(blocks):
    return kernels.obj_emit_pack([(_t(g), _t(d), [_t(l) for l in lv])
                                  for g, d, lv in blocks])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_obj_emit_pack_plain_matches_reference(seed, jnp):
    blocks = _blocks(seed)
    dst, leaves, counts = _pack(blocks)
    packs, want_counts = _ref_pack(jnp, blocks)
    assert counts.tolist() == want_counts
    assert min(want_counts) > 0
    cap_out = dst.shape[1]
    assert cap_out >= max(want_counts)
    for s, c in enumerate(want_counts):
        got = [dst[s].numpy()] + [l[s].numpy() for l in leaves]
        for g, w in zip(got, packs[s]):
            assert g.dtype == w.dtype
            assert np.array_equal(g[:c], w[:c])
        assert (got[0][c:] == SENT).all()
        for g in got[1:]:
            assert (g[c:] == 0).all()


def test_obj_emit_pack_all_gates_closed(jnp):
    """Nothing kept: zero counts, the whole output is tail."""
    blocks = _blocks(3, spec=((8, 2), (8, 4)), empty=(0, 1))
    dst, leaves, counts = _pack(blocks)
    assert counts.tolist() == [0, 0, 0]
    assert _ref_pack(jnp, blocks)[1] == [0, 0, 0]
    assert (dst == kernels.KEY_SENTINEL).all()
    assert all((l == 0).all() for l in leaves)


def test_obj_emit_pack_order_is_block_row_slot():
    """Kept slots pack in (block, row, slot) order."""
    gate = [np.array([[True, True]]), np.array([[False, True]])]
    dst = [np.array([[[5, SENT], [6, 7]]]), np.array([[[8, 9], [10, 11]]])]
    val = [np.array([[[1.0, 2.0], [3.0, 4.0]]]),
           np.array([[[5.0, 6.0], [7.0, 8.0]]])]
    d, (v,), counts = _pack([(gate[b], dst[b], [val[b]]) for b in range(2)])
    assert counts.tolist() == [5]
    assert d[0, :5].tolist() == [5, 6, 7, 10, 11]
    assert v[0, :5].tolist() == [1.0, 3.0, 4.0, 7.0, 8.0]


def test_obj_emit_pack_checks_inputs():
    g, d, lv = _blocks(0, N=2, spec=((8, 3),), empty=())[0]
    good = (_t(g), _t(d), [_t(l) for l in lv])
    with pytest.raises(ValueError, match="at least one"):
        kernels.obj_emit_pack([])
    with pytest.raises(ValueError, match="gate"):
        kernels.obj_emit_pack([(_t(g.astype(np.int32)),) + good[1:]])
    with pytest.raises(ValueError, match="dst"):
        kernels.obj_emit_pack([(good[0], _t(d.astype(np.int32)), good[2])])
    with pytest.raises(ValueError, match="dst"):
        kernels.obj_emit_pack([(good[0], _t(d).transpose(1, 2), good[2])])
    with pytest.raises(ValueError, match="message leaves"):
        kernels.obj_emit_pack([good, (good[0], good[1], good[2][:2])])
    with pytest.raises(ValueError, match="message leaves"):
        kernels.obj_emit_pack([good, (good[0], good[1],
                                      [good[2][0].double()] + good[2][1:])])
    with pytest.raises(ValueError, match="at most"):
        kernels.obj_emit_pack([(good[0], good[1], [good[2][0]] * 17)])


def test_pregel_deliver_fills_match_reference(jnp):
    """A traced merge's filler is zero (_ident): `where(has, u[pos], 0)`
    per shard, over class slots whose ids are in no particular order."""
    rng = np.random.RandomState(5)
    N, cap_v, cap_u = 3, 16, 12
    vcnt = np.array([16, 9, 0], np.int32)
    vid = np.full((N, cap_v), SENT, np.int64)
    uk = np.full((N, cap_u), SENT, np.int64)
    nu = np.zeros(N, np.int32)
    for s in range(N):
        ids = rng.choice(500, vcnt[s], replace=False).astype(np.int64)
        vid[s, :vcnt[s]] = ids                      # unsorted
        keys = np.unique(np.concatenate([
            rng.choice(ids, min(len(ids), 6), replace=False)
            if len(ids) else np.zeros(0, np.int64),
            rng.choice(500, 3) + 500]))[:cap_u]
        uk[s, :len(keys)] = keys
        nu[s] = len(keys)
    leaves = [rng.randn(N, cap_u), rng.randint(-9, 9, (N, cap_u, 3))]
    out, has = kernels.pregel_deliver(_t(vid), _t(vcnt), _t(uk), _t(nu),
                                      [_t(l) for l in leaves], None,
                                      fills=[0.0, 0])
    for s in range(N):
        ids, u = jnp.asarray(vid[s]), jnp.asarray(uk[s])
        valid = jnp.arange(cap_v) < vcnt[s]
        pos = jnp.clip(jnp.searchsorted(u, ids), 0, cap_u - 1)
        want_has = (u[pos] == ids) & valid & (ids != SENT)
        assert np.array_equal(has[s].numpy(), np.asarray(want_has))
        for got, l in zip(out, leaves):
            lv = jnp.asarray(l[s])
            h = want_has.reshape(want_has.shape + (1,) * (lv.ndim - 1))
            want = np.asarray(jnp.where(h, lv[pos], np.zeros((), l.dtype)))
            assert np.array_equal(got[s].numpy(), want)
    assert has.any() and not has[:2].all()
    with pytest.raises(ValueError, match="one fill per"):
        kernels.pregel_deliver(_t(vid), _t(vcnt), _t(uk), _t(nu),
                               [_t(l) for l in leaves], None, fills=[0.0])


@pytest.mark.cuda
def test_obj_emit_pack_matches_plain_on_card():
    """K11 launched on the card equals its plain version bit for bit
    (whole outputs, tails included), and each launch is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    for seed in range(3):
        cpu = [(_t(g), _t(d), [_t(l) for l in lv])
               for g, d, lv in _blocks(seed)]
        card = [(g.to(dev), d.to(dev), [l.to(dev) for l in lv])
                for g, d, lv in cpu]
        before = kernels.LAUNCHES["obj_emit_pack"]
        a = kernels.obj_emit_pack(card)
        b = kernels.obj_emit_pack_plain(cpu)
        assert kernels.LAUNCHES["obj_emit_pack"] == before + 1
        for x, y in zip([a[0]] + a[1] + [a[2]], [b[0]] + b[1] + [b[2]]):
            assert torch.equal(x.cpu(), y)


@pytest.mark.parametrize("fills", [None, [0.0, 0]])
def test_pregel_deliver_classes_match_reference(fills, jnp):
    """The batched class delivery (its CPU route and its plain version)
    against the reference's per-class delivery, bagel_obj.py:856-869:
    `pos = clip(searchsorted(uk, vid))`, `has = (uk[pos] == vid) & (vid
    != SENT)`, `where(has, u[pos], ident)`, over degree classes whose ids
    are grouped by shard in input order (unsorted), the sentinel past each
    shard's count."""
    rng = np.random.RandomState(11)
    N, cap_u, caps = 3, 24, (4, 16, 1, 8)
    pool = rng.choice(1000, N * sum(caps), replace=False).astype(np.int64)
    classes, at, mine = [], 0, [[] for _ in range(N)]
    for cap in caps:
        vid = np.full((N, cap), SENT, np.int64)
        vcnt = np.zeros(N, np.int32)
        for s in range(N):
            c = 0 if (s == 2 and cap == 16) else rng.randint(0, cap + 1)
            vid[s, :c] = pool[at:at + c] * N + s
            at += c
            vcnt[s] = c
            mine[s] += list(vid[s, :c])
        classes.append((vid, vcnt))
    uk = np.full((N, cap_u), SENT, np.int64)
    nu = np.zeros(N, np.int32)
    for s in range(N):
        keys = np.unique(np.concatenate([
            rng.choice(mine[s], min(len(mine[s]), 10), replace=False),
            rng.choice(1000, 6) * N + s + 3000 * N]).astype(np.int64))
        uk[s, :len(keys)] = keys[:cap_u]
        nu[s] = min(len(keys), cap_u)
    leaves = [rng.randn(N, cap_u), rng.randint(-9, 9, (N, cap_u, 2))]
    idents = fills if fills is not None else [0, 0]
    args = ([(_t(v), _t(c)) for v, c in classes], _t(uk), _t(nu),
            [_t(l) for l in leaves], "add", fills)
    got = kernels.pregel_deliver_classes(*args)
    plain = kernels.pregel_deliver_classes_plain(*args)
    assert len(got) == len(plain) == len(caps)
    any_mail = False
    for (vid, _), (msg, has), (pmsg, phas) in zip(classes, got, plain):
        assert torch.equal(has, phas)
        for s in range(N):
            u, ids = jnp.asarray(uk[s]), jnp.asarray(vid[s])
            pos = jnp.clip(jnp.searchsorted(u, ids), 0, cap_u - 1)
            want_has = (u[pos] == ids) & (ids != SENT)
            assert np.array_equal(has[s].numpy(), np.asarray(want_has))
            any_mail |= bool(np.asarray(want_has).any())
            for g, p, l, ident in zip(msg, pmsg, leaves, idents):
                lv = jnp.asarray(l[s])
                h = want_has.reshape(want_has.shape + (1,) * (lv.ndim - 1))
                want = np.asarray(jnp.where(h, lv[pos],
                                            np.asarray(ident, l.dtype)))
                assert np.array_equal(g[s].numpy(), want)
                assert torch.equal(g[s], p[s])
    assert any_mail
