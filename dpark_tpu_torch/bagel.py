"""Bagel of the PyTorch port (port of dpark_tpu/bagel.py): the object
contract (`Bagel.run` over Vertex / Edge / Message objects) and the
vectorized Pregel (`run_pregel`).

Bagel.run collects the graph to the driver once.  On the gpu master a
numeric program is columnarized onto the device
(`_run_columnar` -> backend/cuda/bagel_obj.DeviceObjectPregel: the user
compute vmapped per out-degree class, K11 packs the emitted messages,
K1-K5 combine and exchange them, K10 delivers them); anything the device
path does not admit runs the driver-resident host loop (`_run_fast`)
from superstep 0, and ctx.scheduler._pregel_fallback_reason says why.
Where neither driver-resident path can run the program (a graph over
FAST_MAX_VERTICES, a compute that rebinds vertex ids,
DPARK_BAGEL_FAST=0), the RDD-algebra superstep loop runs: combineByKey
of the messages, groupWith of the vertices, the compute as a cached
flatMapValue, a fold of the halting counters.

run_pregel: columnar vertex state, edge-centric vectorized compute/send,
monoid message combine.  On the gpu master each superstep runs over the
N logical shards on the device (backend/cuda/bagel.py: K9 gathers the
vertex state onto the edges, messages are pre-combined and exchanged
with K1-K5, K10 delivers them); on `local` the vectorized numpy loop
below (`_pregel_host`) is the golden model.  Its user functions are
written with torch ops: both paths hand them torch tensors (CPU tensors
on the host loop) and run them with float64 as the default dtype, so an
int / int gives float64 as numpy does.
"""

import logging
import os
import time

import numpy as np
import torch

from dpark_tpu_torch.utils import pytree
from dpark_tpu_torch.utils.monoid import monoid_identity

logger = logging.getLogger("dpark_tpu_torch.bagel")

PREGEL_MONOIDS = ("add", "min", "max", "mul")


class PregelInputError(ValueError):
    """Invalid run_pregel input (bad ids/edges/messages).  Never triggers
    the device->host fallback: the input is wrong on both paths."""


class Vertex:
    def __init__(self, id, value, outEdges=None, active=True):
        self.id = id
        self.value = value
        self.outEdges = outEdges or []
        self.active = active

    def __repr__(self):
        return "<Vertex(%s, %r, active=%s)>" % (
            self.id, self.value, self.active)


class Edge:
    def __init__(self, target_id, value=None):
        self.target_id = target_id
        self.value = value


class Message:
    def __init__(self, target_id, value):
        self.target_id = target_id
        self.value = value


class Combiner:
    """Pre-shuffle message combine (reference: Bagel Combiner)."""

    def createCombiner(self, msg):
        return [msg]

    def mergeValue(self, combiner, msg):
        combiner.append(msg)
        return combiner

    def mergeCombiners(self, a, b):
        a.extend(b)
        return a


class BasicCombiner(Combiner):
    """Combine message values with a binary op (e.g. operator.add)."""

    def __init__(self, op):
        self.op = op

    def createCombiner(self, msg):
        return msg

    def mergeValue(self, combiner, msg):
        return self.op(combiner, msg)

    def mergeCombiners(self, a, b):
        return self.op(a, b)


class Aggregator:
    """Global per-superstep reduce over all vertices; the result is
    visible to every vertex in the NEXT superstep."""

    def createAggregator(self, vert):
        raise NotImplementedError

    def mergeAggregators(self, a, b):
        raise NotImplementedError


# the knobs of the reference, under its environment names and defaults:
# the driver-resident host loop (DPARK_BAGEL_FAST=0 turns it off), the
# vertex bound of the driver-resident paths, the device columnarizer
# (DPARK_BAGEL_DEVICE=0 turns it off), the exact-class and degree caps,
# and power-of-two degree buckets (DPARK_BAGEL_BUCKETS=0 turns them off).
# The reference's compile-budget guard (DPARK_BAGEL_MIN_ROWS_PER_TRACE)
# is not read: an eager run compiles nothing (ROADMAP C10)
FAST_OBJECT_RUN = os.environ.get("DPARK_BAGEL_FAST", "1") != "0"
FAST_MAX_VERTICES = int(os.environ.get("DPARK_BAGEL_FAST_MAX",
                                       str(4_000_000)))
DEVICE_OBJECT_RUN = os.environ.get("DPARK_BAGEL_DEVICE", "1") != "0"
MAX_DEGREE_CLASSES = int(os.environ.get("DPARK_BAGEL_MAX_CLASSES", "24"))
MAX_DEGREE = int(os.environ.get("DPARK_BAGEL_MAX_DEGREE", "1024"))
DEGREE_BUCKETS = os.environ.get("DPARK_BAGEL_BUCKETS", "1") != "0"

class _ObjectPathNeeded(Exception):
    """Raised inside the driver-resident object run when the program does
    something only the RDD path models (vertex id rebinding), or when the
    graph is too large to collect; inputs are untouched."""


class _NotColumnarizable(Exception):
    """Raised while deciding whether an object Bagel program can ride the
    device; inputs untouched, the host loop runs instead."""


def _is_int_id(x):
    return not isinstance(x, bool) and isinstance(x, (int, np.integer))


def _int_type(t):
    return issubclass(t, (int, np.integer)) and not issubclass(t, bool)


def _num_type(t):
    return (issubclass(t, (int, float, np.integer, np.floating))
            and not issubclass(t, bool))


def _edge_columns_loop(edges, ev_state):
    """(targets, values, ev_state) of one vertex's out-edges, checked edge
    by edge as the reference does (its errors, in its order): the
    targets as a list of ints, the values as a list (empty when all
    None).  ev_state is None while undecided, False when every value so
    far is None, True when every value is numeric."""
    tl, ev_vals = [], []
    for e in edges:
        t = e.target_id
        if not _is_int_id(t):
            raise _NotColumnarizable("non-integer edge target")
        tl.append(t)
        val = getattr(e, "value", None)
        if val is None:
            if ev_state is True:
                raise _NotColumnarizable("mixed None/numeric edge values")
            ev_state = False
        else:
            if ev_state is False:
                raise _NotColumnarizable("mixed None/numeric edge values")
            if isinstance(val, bool) or not isinstance(
                    val, (int, float, np.integer, np.floating)):
                raise _NotColumnarizable(
                    "non-numeric edge value %r" % (val,))
            ev_state = True
            ev_vals.append(val)
    return tl, ev_vals, ev_state


def _edge_columns(edges, ev_state):
    """_edge_columns_loop's result, checked by the distinct types of each
    column at once; a vertex with any odd edge goes through the
    edge-by-edge loop, which raises the reference's first error."""
    tl = [e.target_id for e in edges]
    vl = [getattr(e, "value", None) for e in edges]
    vtypes = set(map(type, vl))
    if all(map(_int_type, set(map(type, tl)))):
        if vtypes == {type(None)} and ev_state is not True:
            return tl, [], False
        if vtypes and ev_state is not False and all(map(_num_type, vtypes)):
            return tl, vl, True
        if not edges:
            return tl, [], ev_state
    return _edge_columns_loop(edges, ev_state)


def _walk(graph, pend):
    """The object walk of _run_columnar: the collected graph ({id:
    Vertex}) and initial messages ([(target, value)]) as numpy columns,
    (ids, vdef, vleaves, act, degs, tgt_flat, ev_flat, pend_cols,
    out_edges), or _NotColumnarizable with the reference's reason."""
    n = len(graph)
    if n == 0:
        raise _NotColumnarizable("empty graph")

    ids_l, act_l, deg_l = [], [], []
    vdef = None
    vleaf_lists = None
    tgt_all, ev_vals = [], []
    ev_state = None       # None undecided / False all-None / True
    out_edges = {}
    for vid, v in graph.items():
        if not isinstance(v, Vertex):
            raise _NotColumnarizable("vertex is %r, not Vertex"
                                     % type(v).__name__)
        if not _is_int_id(vid):
            raise _NotColumnarizable("non-integer vertex id %r"
                                     % (vid,))
        leaves, treedef = pytree.tree_flatten(v.value)
        if vdef is None:
            vdef = treedef
            vleaf_lists = [[] for _ in leaves]
        elif treedef != vdef:
            raise _NotColumnarizable(
                "vertex value structure varies across vertices")
        if not leaves:
            raise _NotColumnarizable(
                "vertex value has no numeric leaves")
        for li, leaf in enumerate(leaves):
            if isinstance(leaf, bool):
                raise _NotColumnarizable(
                    "non-numeric vertex value leaf %r" % (leaf,))
            arr = np.asarray(leaf)
            if arr.dtype.kind not in "if":
                raise _NotColumnarizable(
                    "non-numeric vertex value leaf %r" % (leaf,))
            vleaf_lists[li].append(arr)
        edges = list(v.outEdges)
        if len(edges) > MAX_DEGREE:
            raise _NotColumnarizable("degree %d > %d"
                                     % (len(edges), MAX_DEGREE))
        tl, vl, ev_state = _edge_columns(edges, ev_state)
        tgt_all.extend(tl)
        ev_vals.extend(vl)
        out_edges[int(vid)] = v.outEdges
        ids_l.append(int(vid))
        act_l.append(bool(v.active))
        deg_l.append(len(edges))
    for t, _ in pend:
        if not _is_int_id(t):
            raise _NotColumnarizable("non-integer message target")

    ids = np.asarray(ids_l, np.int64)
    degs = np.asarray(deg_l, np.int64)
    if not DEGREE_BUCKETS and len(set(deg_l)) > MAX_DEGREE_CLASSES:
        raise _NotColumnarizable(
            "%d degree classes > %d (each distinct degree is a "
            "separate trace)" % (len(set(deg_l)),
                                 MAX_DEGREE_CLASSES))
    try:
        vleaves = [np.stack(col) for col in vleaf_lists]
    except ValueError:
        raise _NotColumnarizable("vertex value leaf shapes vary")
    for col in vleaves:
        if col.dtype.kind not in "if":
            raise _NotColumnarizable("vertex values dtype %s"
                                     % col.dtype)
    act = np.asarray(act_l, bool)
    tgt_flat = np.asarray(tgt_all, np.int64)
    ev_flat = None
    if ev_state:
        ev_flat = np.asarray(ev_vals)
        if ev_flat.dtype.kind not in "if":
            raise _NotColumnarizable("edge values dtype %s"
                                     % ev_flat.dtype)
    pend_cols = None
    if pend:
        # initial message values may be any small numeric pytree of
        # one structure: its leaves ride as separate columns
        mdef0 = None
        leaf_lists = None
        for _, v in pend:
            leaves, mdef = pytree.tree_flatten(v)
            if mdef0 is None:
                mdef0, leaf_lists = mdef, [[] for _ in leaves]
            elif mdef != mdef0:
                raise _NotColumnarizable(
                    "initial message value structure varies")
            if not leaves:
                raise _NotColumnarizable(
                    "initial message value has no numeric leaves")
            for li, leaf in enumerate(leaves):
                if isinstance(leaf, bool):
                    raise _NotColumnarizable(
                        "non-numeric message value leaf")
                leaf_lists[li].append(np.asarray(leaf))
        try:
            pleaves = [np.stack(col) for col in leaf_lists]
        except ValueError:
            raise _NotColumnarizable(
                "initial message leaf shapes vary")
        for col in pleaves:
            if col.dtype.kind not in "if":
                raise _NotColumnarizable("non-numeric message value")
        pend_cols = (np.asarray([t for t, _ in pend], np.int64),
                     pleaves, mdef0)
    return (ids, vdef, vleaves, act, degs, tgt_flat, ev_flat, pend_cols,
            out_edges)


class Bagel:
    @classmethod
    def run(cls, ctx, verts, msgs, compute,
            combiner=None, aggregator=None,
            max_superstep=80, numSplits=None, checkpoint_interval=10):
        """verts: RDD of (id, Vertex); msgs: RDD of (id, message_value).

        compute(vertex, messages_or_combined, aggregated, superstep)
          -> (new_vertex, [Message, ...])
        Returns the final verts RDD.

        The graph is collected to the driver once.  On the gpu master a
        numeric program runs on the device (_run_columnar); otherwise,
        and whenever the device path does not admit the program, the
        driver-resident host loop (_run_fast) runs from superstep 0, so
        compute must tolerate re-execution.  Where the reference falls
        back to its RDD-algebra loop (a graph over FAST_MAX_VERTICES, a
        compute that rebinds vertex ids, DPARK_BAGEL_FAST=0) the port runs
        that loop (_run_rdd), from superstep 0.  checkpoint_interval
        belongs to that loop; the port has no checkpoint directory, so
        it is ignored.
        """
        combiner = combiner or Combiner()
        numSplits = numSplits or len(verts.splits)
        ctx.start()
        sched = ctx.scheduler
        want_columnar = DEVICE_OBJECT_RUN \
            and getattr(sched, "executor", None) is not None
        if want_columnar:
            sched._pregel_device_used = False
            sched._pregel_fallback_reason = None
        collected = None
        need = None
        if want_columnar or FAST_OBJECT_RUN:
            try:
                collected = cls._collect_bounded(verts, msgs)
            except (_ObjectPathNeeded, MemoryError) as e:
                need = e
        if collected is not None and want_columnar:
            try:
                return cls._run_columnar(ctx, collected, compute,
                                         combiner, aggregator,
                                         max_superstep, numSplits)
            except _NotColumnarizable as e:
                logger.warning("object Bagel program is not "
                               "device-columnarizable (%s); "
                               "driver-resident host path", e)
                sched._pregel_fallback_reason = str(e)
        if collected is not None and FAST_OBJECT_RUN:
            try:
                return cls._run_fast(ctx, collected, compute, combiner,
                                     aggregator, max_superstep, numSplits)
            except (_ObjectPathNeeded, MemoryError) as e:
                need = e
        logger.warning("object Bagel driver-resident paths cannot run "
                       "this program (%s); running the RDD path",
                       need or "DPARK_BAGEL_FAST=0")
        return cls._run_rdd(verts, msgs, compute, combiner, aggregator,
                            max_superstep, numSplits)

    @classmethod
    def _run_rdd(cls, verts, msgs, compute, combiner, aggregator,
                 max_superstep, numSplits):
        """The reference's RDD-algebra supersteps: the aggregate of the
        vertices, the messages combined per target (combineByKey), the
        vertices grouped with their mail (groupWith), the compute as a
        cached flatMapValue, then a fold of (active vertices, messages)
        decides whether to halt."""
        superstep = 0
        while superstep < max_superstep:
            aggregated = None
            if aggregator is not None:
                parts = [p for p in verts.ctx.runJob(
                    verts.map(_AggCreate(aggregator)),
                    _PartReduceBy(aggregator.mergeAggregators))
                    if p is not _NO_VALUE]
                if parts:
                    aggregated = parts[0]
                    for p in parts[1:]:
                        aggregated = aggregator.mergeAggregators(
                            aggregated, p)
            combined = msgs.combineByKey(
                combiner.createCombiner, combiner.mergeValue,
                combiner.mergeCombiners, numSplits)
            grouped = verts.groupWith(combined, numSplits=numSplits)
            processed = grouped.flatMapValue(
                _ComputeFn(compute, aggregated, superstep)).cache()
            num_active, num_msgs = processed.map(_stats).fold(
                (0, 0), _merge_stats)
            verts = processed.mapValue(_fst_of_pair)
            msgs = processed.flatMap(_OutMessages())
            superstep += 1
            if num_msgs == 0 and num_active == 0:
                break
        return verts

    @classmethod
    def _run_columnar(cls, ctx, collected, compute, combiner,
                      aggregator, max_superstep, numSplits):
        """Columnarize an object-Bagel program onto the device
        (backend/cuda/bagel_obj.py): integer vertex ids and message
        targets, numeric pytree vertex values of one structure, numeric
        message values, Edge.value all None or all numeric, a
        BasicCombiner, no Aggregator, at most MAX_DEGREE out-edges.
        Anything else raises _NotColumnarizable before any device work;
        shape and dtype checks run on every superstep's call of the
        compute, before the superstep is committed."""
        from dpark_tpu_torch.backend.cuda.fuse import classify_merge
        t0 = time.perf_counter()
        if aggregator is not None:
            raise _NotColumnarizable("object Aggregator contract")
        if type(combiner) is BasicCombiner:
            monoid = classify_merge(combiner.op)
        elif type(combiner) is Combiner:
            raise _NotColumnarizable("list-combining default Combiner")
        else:
            raise _NotColumnarizable("custom Combiner %r"
                                     % type(combiner).__name__)
        (ids, vdef, vleaves, act, degs, tgt_flat, ev_flat, pend_cols,
         out_edges) = _walk(*collected)
        walk_seconds = time.perf_counter() - t0

        from dpark_tpu_torch.backend.cuda.bagel_obj import (
            DeviceObjectPregel, UserCodeError, _DegreeDependent)
        try:
            dop = DeviceObjectPregel(
                ctx.scheduler.executor, compute, monoid, vdef, ids,
                vleaves, act, degs, tgt_flat, ev_flat, pend_cols,
                max_superstep, combine_op=combiner.op)
            out_ids, out_leaves, out_act = dop.run()
        except PregelInputError as e:
            # inputs the device rejects (a vertex id equal to its padding
            # sentinel) run on the object path
            raise _NotColumnarizable(
                "device Pregel rejected inputs (%s)" % e)
        except (UserCodeError, _DegreeDependent) as e:
            # the user's code raised under vmap after admission, or a
            # later superstep's canary refused the buckets
            raise _NotColumnarizable(
                "device object Pregel failed (%s)" % str(e)[:200])
        sched = ctx.scheduler
        sched._pregel_device_used = True
        sched._pregel_fallback_reason = None
        dop.stats["setup_seconds"] += walk_seconds
        dop.stats["walk_seconds"] = walk_seconds
        sched._pregel_stats = dop.stats
        out = []
        for i, vid in enumerate(out_ids.tolist()):
            leaves_i = []
            for col in out_leaves:
                x = col[i]
                if x.ndim == 0:
                    x = float(x) if x.dtype.kind == "f" else int(x)
                leaves_i.append(x)
            val = pytree.tree_unflatten(vdef, leaves_i)
            out.append((vid, Vertex(vid, val, out_edges[vid],
                                    bool(out_act[i]))))
        return ctx.parallelize(out, numSplits)

    @classmethod
    def _collect_bounded(cls, verts, msgs):
        """(graph dict, pending list) for the driver-resident paths --
        count first so an oversized graph never collect-then-OOMs."""
        n = verts.count()
        if n > FAST_MAX_VERTICES:
            raise _ObjectPathNeeded(
                "%d vertices > DPARK_BAGEL_FAST_MAX=%d"
                % (n, FAST_MAX_VERTICES))
        return dict(verts.collect()), list(msgs.collect())

    @classmethod
    def _run_fast(cls, ctx, collected, compute, combiner, aggregator,
                  max_superstep, numSplits):
        """Driver-resident object supersteps: the reference's semantics
        (inactive no-mail vertices pass through, messages to unknown ids
        drop, halting when no vertex is active and no message pending),
        delivery by per-target fold through the user's Combiner."""
        graph, pending = collected
        graph = dict(graph)                  # the loop rebinds its copy
        pending = list(pending)
        superstep = 0
        while superstep < max_superstep:
            aggregated = None
            if aggregator is not None:
                it = iter(graph.values())
                first = next(it, None)
                if first is not None:
                    aggregated = aggregator.createAggregator(first)
                    for v in it:
                        aggregated = aggregator.mergeAggregators(
                            aggregated, aggregator.createAggregator(v))

            mail = {}
            for target, value in pending:
                if target not in graph:
                    continue                 # unknown ids drop
                if target in mail:
                    mail[target] = combiner.mergeValue(mail[target], value)
                else:
                    mail[target] = combiner.createCombiner(value)

            pending = []
            new_graph = {}
            for vid, vert in graph.items():
                vmail = mail.get(vid)
                if vmail is None and not vert.active:
                    new_graph[vid] = vert    # untouched pass-through
                    continue
                new_vert, out_msgs = compute(vert, vmail, aggregated,
                                             superstep)
                if new_vert.id != vid:
                    raise _ObjectPathNeeded(
                        "compute rebound vertex id %r -> %r"
                        % (vid, new_vert.id))
                new_graph[vid] = new_vert
                for m in out_msgs:
                    pending.append((m.target_id, m.value))
            graph = new_graph
            num_active = sum(1 for v in graph.values() if v.active)
            superstep += 1
            logger.debug("fast superstep %d: active=%d msgs=%d",
                         superstep, num_active, len(pending))
            if not pending and num_active == 0:
                break
        return ctx.parallelize(list(graph.items()), numSplits)


_NO_VALUE = "__bagel_no_value__"


class _PartReduceBy:
    def __init__(self, merge):
        self.merge = merge

    def __call__(self, it):
        out = _NO_VALUE
        for x in it:
            out = x if out is _NO_VALUE else self.merge(out, x)
        return out


class _AggCreate:
    def __init__(self, aggregator):
        self.aggregator = aggregator

    def __call__(self, kv):
        return self.aggregator.createAggregator(kv[1])


class _ComputeFn:
    """grouped value = ([vertex...], [combined mail...]); an id with no
    vertex (mail to an unknown id) is dropped, an inactive vertex with no
    mail passes through untouched."""

    def __init__(self, compute, aggregated, superstep):
        self.compute = compute
        self.aggregated = aggregated
        self.superstep = superstep

    def __call__(self, groups):
        vs, cs = groups
        if not vs:
            return []
        vert = vs[0]
        mail = cs[0] if cs else None
        if mail is None and not vert.active:
            return [(vert, [])]
        return [self.compute(vert, mail, self.aggregated, self.superstep)]


class _OutMessages:
    def __call__(self, kv):
        _, (vert, out_msgs) = kv
        return [(m.target_id, m.value) for m in out_msgs]


def _stats(kv):
    vert, out_msgs = kv[1]
    return (1 if vert.active else 0, len(out_msgs))


def _merge_stats(a, b):
    return (a[0] + b[0], a[1] + b[1])


def _fst_of_pair(pair):
    return pair[0]


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
