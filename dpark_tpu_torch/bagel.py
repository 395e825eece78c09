"""Vectorized Pregel of the PyTorch port: `run_pregel` (port of the
vectorized section of dpark_tpu/bagel.py).

Columnar vertex state, edge-centric vectorized compute/send, monoid
message combine.  On the gpu master each superstep runs over the N
logical shards on the device (backend/cuda/bagel.py: K9 gathers the
vertex state onto the edges, messages are pre-combined and exchanged
with K1-K5, K10 delivers them); on `local` the vectorized numpy loop
below (`_pregel_host`) is the golden model.

User functions are written with torch ops: both paths hand them torch
tensors (CPU tensors on the host loop) and run them with float64 as the
default dtype, so an int / int gives float64 as numpy does.
"""

import logging

import numpy as np
import torch

from dpark_tpu_torch.utils.monoid import monoid_identity

logger = logging.getLogger("dpark_tpu_torch.bagel")

PREGEL_MONOIDS = ("add", "min", "max", "mul")


class PregelInputError(ValueError):
    """Invalid run_pregel input (bad ids/edges/messages).  Never triggers
    the device->host fallback: the input is wrong on both paths."""


def as_leaves(x):
    """(leaves, was_tuple) for a single-array-or-tuple user value."""
    if isinstance(x, (tuple, list)):
        return list(x), True
    return [x], False


def rewrap(leaves, was_tuple):
    return tuple(leaves) if was_tuple else leaves[0]


_NP_COMBINE = {"add": np.add, "min": np.minimum,
               "max": np.maximum, "mul": np.multiply}
_NP_REDUCE = {"add": np.sum, "min": np.min,
              "max": np.max, "mul": np.prod}


def run_pregel(ctx, ids, values, edges, compute, send, combine="add",
               edge_values=None, active=None, initial_messages=None,
               aggregator=None, max_superstep=80,
               static_superstep=False, send_gate_leaf=None):
    """Vectorized Pregel — the device-native Bagel.

    ids:     (n,) int array of unique vertex ids
    values:  (n,) array or tuple of (n, ...) arrays — vertex state
    edges:   (src_ids, dst_ids) int arrays; each edge lives with its
             source, messages flow along it to dst
    compute(values, msg, has_msg, active, aggregated, superstep)
             -> (new_values, new_active): applied BLOCKWISE to torch
             tensors over many vertices at once, so it must be written
             with elementwise torch ops (arithmetic, torch.where,
             comparisons) — no Python control flow on the data.  `msg`
             holds the combined inbound message per vertex (the monoid
             identity where has_msg is False); `superstep` is a 0-d
             int64 tensor on the gpu master (a Python int with
             static_superstep=True, and on the host loop).
    send(src_values, edge_values, src_degree) -> per-edge message value
             (scalar leaf or tuple of scalar or 1-D leaves), same
             contract over edges; only edges whose source is active
             after compute send — unless `send_gate_leaf` is given: the
             index of a bool vertex-state leaf that REPLACES
             post-compute active as the send mask.
    combine: message-combine monoid: "add" | "min" | "max" | "mul"
    aggregator: None or (create(values) -> leaf/tuple, monoid): global
             per-superstep reduce over the PRE-compute vertex state,
             visible to compute as `aggregated` the same superstep
    initial_messages: None or (dst_ids, msg_values) delivered at
             superstep 0

    Halts when no vertex is active and no messages are pending, or at
    max_superstep.  Returns (ids, values, active) sorted by id (numpy).

    On the gpu master the supersteps run on the device
    (backend/cuda/bagel.py).  The host loop takes over only when the
    device path does not admit the user code (send or compute raises on
    a 0-row sample, or returns no tensor); the reason is recorded in
    ctx.scheduler._pregel_fallback_reason.  Any later error propagates.
    """
    if combine not in PREGEL_MONOIDS:
        raise ValueError("combine must be one of %s" % (PREGEL_MONOIDS,))
    if np.asarray(ids).shape[0] == 0 \
            and np.asarray(edges[0]).shape[0] == 0:
        vleaves, v_tuple = as_leaves(values)
        return (np.zeros(0, np.int64),
                rewrap([np.asarray(l)[:0] for l in vleaves], v_tuple),
                np.zeros(0, bool))
    ctx.start()
    sched = ctx.scheduler
    ex = getattr(sched, "executor", None)
    if ex is not None:
        from dpark_tpu_torch.backend.cuda.bagel import (DevicePregel,
                                                        NotAdmitted)
        try:
            dp = DevicePregel(
                ex, ids, values, edges, compute, send, combine=combine,
                edge_values=edge_values, active=active,
                initial_messages=initial_messages, aggregator=aggregator,
                max_superstep=max_superstep,
                static_superstep=static_superstep,
                send_gate_leaf=send_gate_leaf)
        except NotAdmitted as e:
            logger.warning("device Pregel not admitted (%s); host path", e)
            sched._pregel_device_used = False
            sched._pregel_fallback_reason = str(e)
        else:
            out = dp.run()
            sched._pregel_device_used = True
            sched._pregel_fallback_reason = None
            sched._pregel_stats = dp.stats
            return out
    return _pregel_host(ids, values, edges, compute, send, combine,
                        edge_values, active, initial_messages,
                        aggregator, max_superstep, send_gate_leaf)


def _to_torch(x):
    """A host array as a CPU tensor for user code (shares memory)."""
    return torch.from_numpy(np.ascontiguousarray(x))


def _to_numpy(x):
    """A user output (tensor, numpy array or Python scalar) as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _user_call(fn, *args):
    from dpark_tpu_torch.backend.cuda.fuse import python_float_semantics
    with python_float_semantics():
        return fn(*args)


def _pregel_host(ids, values, edges, compute, send, combine,
                 edge_values, active, initial_messages, aggregator,
                 max_superstep, send_gate_leaf=None):
    """Single-host vectorized Pregel: the golden model for the device
    implementation.  The framework side is numpy; user compute/send see
    CPU tensors (torch.from_numpy) and their outputs come back as
    numpy."""
    T, Np = _to_torch, _to_numpy

    def tmap(leaves):
        return [T(l) for l in leaves]
    ids = np.asarray(ids, np.int64)
    n = ids.shape[0]
    if np.unique(ids).shape[0] != n:
        raise PregelInputError("vertex ids must be unique")
    order = np.argsort(ids)
    ids = ids[order]
    vleaves, v_tuple = as_leaves(values)
    vleaves = [np.asarray(l)[order] for l in vleaves]
    act = np.ones(n, bool) if active is None \
        else np.asarray(active, bool)[order]

    src = np.asarray(edges[0], np.int64)
    dst = np.asarray(edges[1], np.int64)
    eleaves, e_tuple = ((None, False) if edge_values is None
                        else as_leaves(edge_values))
    eleaves = [np.asarray(l) for l in eleaves] if eleaves else []
    src_idx = np.searchsorted(ids, src)
    src_idx = np.clip(src_idx, 0, max(0, n - 1))
    if src.size and (n == 0
                     or not np.array_equal(ids[src_idx], src)):
        raise PregelInputError("edge source not in vertex ids")
    deg = np.bincount(src_idx, minlength=n) if src.size \
        else np.zeros(n, np.int64)

    # message dtypes AND trailing shapes, discovered by probing `send`
    # on empty slices
    try:
        probe = _user_call(
            send, rewrap(tmap([l[:0] for l in vleaves]), v_tuple),
            rewrap(tmap([l[:0] for l in eleaves]), e_tuple)
            if eleaves else None, T(deg[:0]))
        m_probe, m_tuple = as_leaves(probe)
        msg_dtypes = [Np(l).dtype for l in m_probe]
        msg_shapes = [Np(l).shape[1:] for l in m_probe]
    except Exception:
        m_tuple = False
        msg_dtypes = [np.dtype(np.float64)]
        msg_shapes = [()]

    def deliver(pdst, pvals):
        """Combine pending messages per target; unknown targets drop.
        Vector leaves combine elementwise — the per-leaf monoid."""
        pos = np.searchsorted(ids, pdst)
        pos = np.clip(pos, 0, max(0, n - 1))
        known = ids[pos] == pdst
        pos = pos[known]
        bufs = []
        for l in pvals:
            buf = np.full((n,) + l.shape[1:],
                          monoid_identity(combine, l.dtype), l.dtype)
            _NP_COMBINE[combine].at(buf, pos, l[known])
            bufs.append(buf)
        has = np.bincount(pos, minlength=n) > 0
        return bufs, has

    pending = None
    if initial_messages is not None:
        idst = np.asarray(initial_messages[0], np.int64)
        ivls, _ = as_leaves(initial_messages[1])
        if idst.size and len(ivls) != len(msg_dtypes):
            raise PregelInputError(
                "initial message leaves mismatch: got %d, send "
                "produces %d" % (len(ivls), len(msg_dtypes)))
        pending = (idst, [np.asarray(l, dt)
                          for l, dt in zip(ivls, msg_dtypes)])

    s = 0
    while s < max_superstep:
        aggregated = None
        if aggregator is not None:
            create, amon = aggregator
            a_leaves, a_tuple = as_leaves(
                _user_call(create, rewrap(tmap(vleaves), v_tuple)))
            aggregated = rewrap(
                [T(np.asarray(_NP_REDUCE[amon](Np(l)))) for l in a_leaves],
                a_tuple)

        if pending is not None and pending[0].size:
            msg_leaves, has = deliver(*pending)
        else:
            msg_leaves = [np.full((n,) + shp,
                                  monoid_identity(combine, dt), dt)
                          for dt, shp in zip(msg_dtypes, msg_shapes)]
            has = np.zeros(n, bool)
        nv_, na_ = _user_call(compute, rewrap(tmap(vleaves), v_tuple),
                              rewrap(tmap(msg_leaves), m_tuple), T(has),
                              T(act), aggregated, s)
        new_leaves, _ = as_leaves(nv_)
        new_leaves = [Np(l) for l in new_leaves]
        vleaves = [np.broadcast_to(l, (n,) + l.shape[1:]).copy()
                   if l.shape[:1] != (n,) else l for l in new_leaves]
        act = np.broadcast_to(Np(na_).astype(bool), (n,)).copy()

        gate = (vleaves[send_gate_leaf].astype(bool)
                if send_gate_leaf is not None else act)
        src_mask = gate[src_idx] if src.size else np.zeros(0, bool)
        if src.size:
            msg = _user_call(send,
                             rewrap(tmap([l[src_idx] for l in vleaves]),
                                    v_tuple),
                             rewrap(tmap(eleaves), e_tuple)
                             if eleaves else None, T(deg[src_idx]))
            m_leaves, m_tuple = as_leaves(msg)
            m_leaves = [Np(l) for l in m_leaves]
            m_leaves = [np.broadcast_to(l, (src.size,) + l.shape[1:]).copy()
                        for l in m_leaves]
            pending = (dst[src_mask],
                       [l[src_mask] for l in m_leaves])
        else:
            pending = (np.zeros(0, np.int64), [])
        n_active = int(act.sum())
        n_msgs = int(src_mask.sum())
        s += 1
        logger.debug("host superstep %d: active=%d msgs=%d",
                     s, n_active, n_msgs)
        if n_active == 0 and n_msgs == 0:
            break
    return ids, rewrap(vleaves, v_tuple), act
