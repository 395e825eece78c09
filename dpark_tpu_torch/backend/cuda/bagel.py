"""Device Pregel of the gpu master: the superstep over the N logical
shards of one device (port of dpark_tpu/backend/tpu/bagel.py).

Vertex state is columnar — int64 ids, numeric value leaves, bool active
flags — sharded by hash(id) % N and sorted by id within a shard, so a
hash-routed message lands on the shard that owns its target.  Edges are
stored with their SOURCE vertex, so message generation is a local
gather.  One superstep, as in the reference:

  deliver   K4 exchange of the pending messages, K5 + K3 combine of
            equal targets (segment_reduce_keys), K10 bisects each
            vertex id into the combined keys (msg, has)
  compute   the user's compute, called ONCE over all N shards flattened
            ((N * cap_v,) tensors; the contract is elementwise)
  generate  K9 gathers the vertex state onto the edges (and the send
            gate), the user's send over (N * cap_e,) edges, K2 packs the
            sent messages, K1 + K5 + K2 + K3 pre-combine them per target
            and bucket them by destination shard (bucketize_combine_keys)

The Python superstep loop stays on the host and reads two counters each
superstep (active vertices, messages sent), exactly like the reference.
PyTorch runs eagerly: the reference's compiled programs are methods.
"""

import time

import numpy as np
import torch

from dpark_tpu_torch.bagel import (
    PREGEL_MONOIDS, PregelInputError, as_leaves, rewrap)
from dpark_tpu_torch.backend.cuda import (collectives, kernels, layout,
                                         merge_program)
from dpark_tpu_torch.backend.cuda.fuse import _as_leaf, python_float_semantics
from dpark_tpu_torch.utils.phash import phash_np

_SENT = kernels.KEY_SENTINEL          # padding id (int64 max)

_REDUCE = {"add": torch.sum, "min": torch.amin, "max": torch.amax,
           "mul": torch.prod}
_COMBINE = {"add": torch.add, "min": torch.minimum, "max": torch.maximum,
            "mul": torch.mul}


def _local_reduce(kind, x, n):
    """Each shard's reduction of an (N, cap, ...) leaf over its first
    n[s] rows and every trailing lane (K17): (N,)."""
    return kernels.monoid_reduce(x.contiguous(), n, kind)[0]


def _axis_reduce(kind, x):
    """Across the mesh: the N per-shard values reduced to one 0-d value
    (the reference's psum / pmin / pmax / all_gather + prod)."""
    return _REDUCE[kind](x, 0)


def _sorted_positions(sorted_ids, keys):
    """np.searchsorted(sorted_ids, keys), clipped to the last index, for
    every key found in sorted_ids; an absent key gets a position whose id
    differs from it (the caller checks).  Ids spanning at most four times
    their count (dense labels) are looked up in a table, one read a key
    instead of a binary search; the span limit caps the table at four
    times the ids' own bytes.  pregel_setup_time.py times both ways."""
    n = sorted_ids.shape[0]
    if n == 0:
        return np.zeros(keys.shape, np.int64)
    lo, hi = int(sorted_ids[0]), int(sorted_ids[-1])
    if hi - lo >= 4 * n + 1024:
        return np.clip(np.searchsorted(sorted_ids, keys), 0, n - 1)
    table = np.zeros(hi - lo + 1, np.int64)
    table[sorted_ids - lo] = np.arange(n)
    inside = (keys >= lo) & (keys <= hi)
    return table[np.where(inside, keys, lo) - lo]


def _shard_order(shard, ndev):
    """np.argsort(shard, kind="stable") of shard ids in [0, ndev), sorted
    on the narrowest unsigned copy: numpy radix-sorts keys of up to 16
    bits.  pregel_setup_time.py times both ways."""
    return np.argsort(shard.astype(np.min_scalar_type(ndev - 1)),
                      kind="stable")


class NotAdmitted(Exception):
    """The device path does not admit the user code: raised while probing
    it on 0-row samples, before any device work.  run_pregel records the
    message and runs the host loop."""


def _tensor_out(x, device, what):
    """A user output leaf as a tensor; numpy output is not admitted."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (np.ndarray, np.generic)):
        raise TypeError("%s returned a numpy %s, not a torch tensor"
                        % (what, type(x).__name__))
    return _as_leaf(x, device)


class DevicePregel:
    """One Pregel run over the executor's N shards.  See
    bagel.run_pregel for the user-facing contract."""

    def __init__(self, executor, ids, values, edges, compute, send,
                 combine="add", edge_values=None, active=None,
                 initial_messages=None, aggregator=None,
                 max_superstep=80, static_superstep=False,
                 send_gate_leaf=None):
        if combine not in PREGEL_MONOIDS:
            raise ValueError(
                "combine must be one of %s" % (PREGEL_MONOIDS,))
        # static_superstep: compute sees `superstep` as a Python int (user
        # code may branch on it); otherwise a 0-d int64 device tensor
        self.static_superstep = bool(static_superstep)
        # send_gate_leaf: index of a bool vertex-state leaf that REPLACES
        # post-compute `active` as the send mask
        self.send_gate = send_gate_leaf
        self.ndev = executor.ndev
        self.device = executor.device
        self.compute = compute
        self.send = send
        self.combine = combine
        # the merge of tuple or narrow messages, as a function K14's
        # programs memoise on
        self._merge = merge_program.lowerable(self._combine_leaves)
        self.aggregator = aggregator
        self.max_superstep = max_superstep
        t0 = time.perf_counter()
        self._setup(ids, values, edges, edge_values, active,
                    initial_messages)
        self.stats = {"setup_seconds": time.perf_counter() - t0,
                      "cap_v": self.cap_v, "cap_e": self.cap_e}

    def _combine_leaves(self, a, b):
        """The message monoid over leaf lists (the merge of tuple or
        narrow messages: K14, collectives._merge_runs)."""
        return [_COMBINE[self.combine](x, y) for x, y in zip(a, b)]

    # ------------------------------------------------------------------
    # host-side setup: partition vertices by hash(id), edges by source
    # ------------------------------------------------------------------
    def _setup(self, ids, values, edges, edge_values, active, init_msgs):
        ndev = self.ndev
        ids = np.ascontiguousarray(np.asarray(ids, np.int64))
        n = ids.shape[0]
        if np.unique(ids).shape[0] != n:
            raise PregelInputError("vertex ids must be unique")
        if n and int(ids.max()) == _SENT:
            raise PregelInputError(
                "vertex id equals the padding sentinel")
        vleaves, self.v_tuple = as_leaves(values)
        vleaves = [np.asarray(l) for l in vleaves]
        act = (np.ones(n, bool) if active is None
               else np.asarray(active, bool))

        vdev = (phash_np(ids) % np.uint32(ndev)).astype(np.int64)
        sid = np.argsort(ids)
        sorted_ids = ids[sid]

        src, dst = np.asarray(edges[0], np.int64), \
            np.asarray(edges[1], np.int64)
        eleaves, self.e_tuple = ((None, False) if edge_values is None
                                 else as_leaves(edge_values))
        eleaves = [np.asarray(l) for l in eleaves] if eleaves else []
        pos = _sorted_positions(sorted_ids, src)
        src_idx = sid[pos] if n else pos
        if src.size and (n == 0
                         or not np.array_equal(ids[src_idx], src)):
            raise PregelInputError("edge source not in vertex ids")
        deg = np.bincount(src_idx, minlength=n) if src.size \
            else np.zeros(n, np.int64)
        edev = vdev[src_idx] if src.size else src_idx

        # admission: probe the user code on 0-row samples before any
        # device work (message leaf specs come from the send probe)
        self._admit(vleaves, eleaves)

        # per-shard vertex tables, sorted by id.  One lexsort by (shard,
        # id) gives contiguous per-shard runs.
        vorder = np.lexsort((ids, vdev))
        vbounds = np.searchsorted(vdev[vorder], np.arange(ndev + 1))
        vcnt = np.diff(vbounds).astype(np.int32)
        self.cap_v = layout.round_capacity(int(vcnt.max()) if n else 1)
        vid = np.full((ndev, self.cap_v), _SENT, np.int64)
        h_vals = [np.zeros((ndev, self.cap_v) + l.shape[1:], l.dtype)
                  for l in vleaves]
        h_act = np.zeros((ndev, self.cap_v), bool)
        # shard-local sorted position of every vertex (for edge gather)
        local_slot = np.zeros(n, np.int64)
        local_slot[vorder] = np.arange(n) - vbounds[vdev[vorder]]
        for d in range(ndev):
            lo, hi = int(vbounds[d]), int(vbounds[d + 1])
            c = hi - lo
            if not c:
                continue
            sel = vorder[lo:hi]
            vid[d, :c] = ids[sel]
            for hl, l in zip(h_vals, vleaves):
                hl[d, :c] = l[sel]
            h_act[d, :c] = act[sel]

        # per-shard edge tables, living with their source vertex, in
        # input order
        eorder = _shard_order(edev, ndev)
        ebounds = np.searchsorted(edev[eorder], np.arange(ndev + 1))
        ecnt = np.diff(ebounds).astype(np.int32)
        self.cap_e = layout.round_capacity(
            int(ecnt.max()) if src.size else 1)
        e_dst = np.full((ndev, self.cap_e), _SENT, np.int64)
        e_slot = np.zeros((ndev, self.cap_e), np.int32)
        e_deg = np.ones((ndev, self.cap_e), np.int64)
        h_evals = [np.zeros((ndev, self.cap_e) + l.shape[1:], l.dtype)
                   for l in eleaves]
        # gather every column once in shard order; each shard's run is
        # then a contiguous slice
        by_src = src_idx[eorder]
        cols = [(e_dst, dst[eorder]), (e_slot, local_slot[by_src]),
                (e_deg, deg[by_src])]
        cols += [(hl, l[eorder]) for hl, l in zip(h_evals, eleaves)]
        for d in range(ndev):
            lo, hi = int(ebounds[d]), int(ebounds[d + 1])
            for table, col in cols:
                table[d, :hi - lo] = col[lo:hi]

        self.vid = self._put(vid)
        self.vcnt = self._put(vcnt)
        self.values = [self._put(l) for l in h_vals]
        self.active = self._put(h_act)
        self.e_dst = self._put(e_dst)
        self.e_slot = self._put(e_slot)
        self.e_deg = self._put(e_deg)
        self.e_vals = [self._put(l) for l in h_evals]
        self.ecnt = self._put(ecnt)

        # initial messages, routed to their target's shard
        self.init = None
        if init_msgs is not None:
            idst = np.asarray(init_msgs[0], np.int64)
            ivls, _ = as_leaves(init_msgs[1])
            ivls = [np.asarray(l) for l in ivls]
            if idst.size:
                if len(ivls) != len(self.msg_dtypes):
                    raise PregelInputError(
                        "initial message leaves mismatch: got %d, send "
                        "produces %d" % (len(ivls),
                                         len(self.msg_dtypes)))
                mdev = (phash_np(idst) % np.uint32(ndev)).astype(np.int64)
                mc = np.bincount(mdev, minlength=ndev)
                cap_m = layout.round_capacity(int(mc.max() or 1))
                hm_d = np.full((ndev, cap_m), _SENT, np.int64)
                hm_v = [np.zeros((ndev, cap_m) + shp,
                                 layout.numpy_dtype(dt))
                        for dt, shp in zip(self.msg_dtypes,
                                           self.msg_shapes)]
                mcnt = np.zeros(ndev, np.int32)
                for d in range(ndev):
                    m = mdev == d
                    c = int(m.sum())
                    mcnt[d] = c
                    if c:
                        hm_d[d, :c] = idst[m]
                        for hl, l in zip(hm_v, ivls):
                            hl[d, :c] = l[m].astype(hl.dtype)
                self.init = (self._put(mcnt), self._put(hm_d),
                             [self._put(l) for l in hm_v])

    def _put(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _empty(self, leaves):
        """0-row device samples of host leaves (dtypes, trailing dims)."""
        return [torch.empty((0,) + l.shape[1:],
                            dtype=layout.torch_dtype(l.dtype),
                            device=self.device) for l in leaves]

    def _admit(self, vleaves, eleaves):
        """Probe send (message leaf specs, the reference's eval_shape),
        the aggregator's create and compute on 0-row samples.  A probe
        that raises or returns no tensor raises NotAdmitted."""
        dev = self.device
        v0, e0 = self._empty(vleaves), self._empty(eleaves)
        try:
            with python_float_semantics():
                out = self.send(rewrap(v0, self.v_tuple),
                                rewrap(e0, self.e_tuple) if e0 else None,
                                torch.empty(0, dtype=torch.int64,
                                            device=dev))
            m_leaves, self.m_tuple = as_leaves(out)
            m_leaves = [_tensor_out(l, dev, "send") for l in m_leaves]
        except Exception as e:
            raise NotAdmitted("send on a 0-row sample: %s: %s"
                              % (type(e).__name__, e)) from e
        # per-message trailing shape of each leaf: () scalars, or (k,)
        # vector leaves riding as one rank-2 column
        self.msg_shapes = [tuple(l.shape[1:]) for l in m_leaves]
        if any(len(shp) > 1 for shp in self.msg_shapes):
            raise PregelInputError("message leaves must be scalars "
                                   "or 1-D vectors")
        self.msg_dtypes = [l.dtype for l in m_leaves]
        none = torch.zeros(0, dtype=torch.bool, device=dev)
        ag, what = None, "create"
        try:
            if self.aggregator is not None:
                create, amon = self.aggregator
                with python_float_semantics():
                    a_leaves, a_tuple = as_leaves(
                        create(rewrap(v0, self.v_tuple)))
                ag = rewrap(
                    [torch.full((), kernels.identity(amon, l.dtype),
                                dtype=l.dtype, device=dev) for l in
                     [_tensor_out(x, dev, "create") for x in a_leaves]],
                    a_tuple)
            what = "compute"
            msg0 = [torch.full((0,) + shp,
                               kernels.identity(self.combine, dt),
                               dtype=dt, device=dev)
                    for dt, shp in zip(self.msg_dtypes, self.msg_shapes)]
            s0 = 0 if self.static_superstep else torch.zeros(
                (), dtype=torch.int64, device=dev)
            with python_float_semantics():
                nv_, na_ = self.compute(rewrap(v0, self.v_tuple),
                                        rewrap(msg0, self.m_tuple), none,
                                        none, ag, s0)
            for l in as_leaves(nv_)[0] + [na_]:
                _tensor_out(l, dev, "compute")
        except Exception as e:
            raise NotAdmitted("%s on a 0-row sample: %s: %s"
                              % (what, type(e).__name__, e)) from e

    # ------------------------------------------------------------------
    # the three programs
    # ------------------------------------------------------------------
    def _p_init(self):
        """Pre-combine the user's initial messages by target and bucket
        them by destination shard."""
        mcnt, mdst, mvals = self.init
        kk, vv, counts, offsets = collectives.bucketize_combine_keys(
            [mdst], mvals, mcnt, self.ndev, self._merge,
            monoid=self.combine)
        return (counts, offsets, kk[0], vv), int(counts.sum())

    def _p_gen(self):
        """Generate per-edge messages from the current vertex state (K9,
        then the user's send), pack the sent ones (K2), pre-combine per
        target and bucket by destination shard (K1, K5, K2, K3).
        Returns (pending, messages sent)."""
        N, cap_e = self.ndev, self.cap_e
        if self.send_gate is not None:
            gate = self.values[self.send_gate].to(torch.bool).contiguous()
        else:
            gate = self.active
        sv, sa = kernels.edge_gather(self.e_slot, self.ecnt, self.values,
                                     gate)

        def flat(t):
            return t.reshape((N * cap_e,) + tuple(t.shape[2:]))
        with python_float_semantics():
            msg = self.send(
                rewrap([flat(v) for v in sv], self.v_tuple),
                rewrap([flat(e) for e in self.e_vals], self.e_tuple)
                if self.e_vals else None, flat(self.e_deg))
        m_leaves = [
            torch.broadcast_to(_tensor_out(l, self.device, "send"),
                               (N * cap_e,) + shp)
            .reshape((N, cap_e) + shp).contiguous()
            for l, shp in zip(as_leaves(msg)[0], self.msg_shapes)]
        dstk = torch.where(sa, self.e_dst, _SENT)
        packed, cnt = collectives.compact([dstk] + m_leaves, sa)
        kk, vv, counts, offsets = collectives.bucketize_combine_keys(
            [packed[0]], packed[1:], cnt, N, self._merge,
            monoid=self.combine)
        return (counts, offsets, kk[0], vv), int(cnt.sum())

    def _p_step(self, s, pending):
        """Deliver the combined messages (K4, K5 + K3, K10), run the
        vertex compute, count the still-active vertices.  aggregated (if
        any) is computed from the PRE-compute state, reduced across the
        shards."""
        N, cap_v, dev = self.ndev, self.cap_v, self.device
        valid_v = collectives.valid_rows(self.vcnt, cap_v)

        def flat(t):
            return t.reshape((N * cap_v,) + tuple(t.shape[2:]))

        def shaped(l):
            """A compute output leaf (or a scalar) as (N, cap_v, ...)."""
            l = _tensor_out(l, dev, "compute")
            return torch.broadcast_to(l, (N * cap_v,) + tuple(
                l.shape[1:])).reshape((N, cap_v) + tuple(l.shape[1:]))

        def bcast(mask, leaf):
            return mask.view(mask.shape + (1,) * (leaf.dim() - 2))

        ag = None
        if self.aggregator is not None:
            create, amon = self.aggregator
            with python_float_semantics():
                a_leaves, a_tuple = as_leaves(
                    create(rewrap([flat(v) for v in self.values],
                                  self.v_tuple)))
            glob = []
            for leaf in a_leaves:
                glob.append(_axis_reduce(amon, _local_reduce(
                    amon, shaped(leaf), self.vcnt)))
            ag = rewrap(glob, a_tuple)

        if pending is not None:
            counts, offsets, kk, vv = pending
            recv, n = collectives.exchange([kk] + vv, counts, offsets)
            uk, uv, n_unique = collectives.segment_reduce_keys(
                [recv[0]], recv[1:], n, self._merge, monoid=self.combine)
            msg, has = kernels.pregel_deliver(self.vid, self.vcnt, uk[0],
                                              n_unique, uv, self.combine)
        else:
            has = torch.zeros((N, cap_v), dtype=torch.bool, device=dev)
            msg = [torch.full((N, cap_v) + shp,
                              kernels.identity(self.combine, dt), dtype=dt,
                              device=dev)
                   for dt, shp in zip(self.msg_dtypes, self.msg_shapes)]

        step = s if self.static_superstep else torch.tensor(
            s, dtype=torch.int64, device=dev)
        with python_float_semantics():
            nv_, na_ = self.compute(
                rewrap([flat(v) for v in self.values], self.v_tuple),
                rewrap([flat(m) for m in msg], self.m_tuple), flat(has),
                flat(self.active & valid_v), ag, step)
        new_act = shaped(na_).to(torch.bool) & valid_v
        self.values = [
            torch.where(bcast(valid_v, l), l,
                        torch.zeros((), dtype=l.dtype, device=dev))
            for l in (shaped(x) for x in as_leaves(nv_)[0])]
        self.active = new_act
        return int(_local_reduce("add", new_act, self.vcnt).sum())

    # ------------------------------------------------------------------
    def run(self):
        t0 = time.perf_counter()
        pending, total_msgs = None, 0
        if self.init is not None:
            pending, total_msgs = self._p_init()
        # the superstep clock starts after the initial messages' combine
        t1 = time.perf_counter()
        s = delivered = 0
        while s < self.max_superstep:
            mail = pending if total_msgs > 0 else None
            delivered += mail is not None
            n_active = self._p_step(s, mail)
            pending, total_msgs = self._p_gen()
            s += 1
            if n_active == 0 and total_msgs == 0:
                break
        self.stats.update(supersteps=s, delivered=delivered,
                          init_seconds=t1 - t0,
                          superstep_seconds=time.perf_counter() - t1)
        return self._collect()

    def _collect(self):
        """Pull the final state to host, unpad, sort by id."""
        vid = self.vid.cpu().numpy()
        vcnt = self.vcnt.cpu().numpy()
        vals = [l.cpu().numpy() for l in self.values]
        act = self.active.cpu().numpy()
        ids, leaves, actv = [], [[] for _ in vals], []
        for d in range(self.ndev):
            c = int(vcnt[d])
            ids.append(vid[d, :c])
            for i, l in enumerate(vals):
                leaves[i].append(l[d, :c])
            actv.append(act[d, :c])
        ids = np.concatenate(ids) if ids else np.zeros(0, np.int64)
        order = np.argsort(ids)
        leaves = [np.concatenate(ls)[order] for ls in leaves]
        return (ids[order],
                rewrap(leaves, self.v_tuple),
                np.concatenate(actv)[order] if actv
                else np.zeros(0, bool))
