"""Device adapter for OBJECT Bagel programs on the gpu master (port of
dpark_tpu/backend/tpu/bagel_obj.py).

The model is the reference's:

* **Degree classes.**  Vertices are sharded by hash(id) % N and, per
  shard, grouped by out-degree class: with ``bagel.DEGREE_BUCKETS`` on a
  class is a power of two (each edge list pads to the class width with
  dummy edges: the sentinel target, value 0), else the exact degree.  An
  exact-vs-bucket canary, run on small synthetic slices at every
  superstep, checks that the user compute cannot tell the padding apart;
  a compute that reads ``len(outEdges)`` or diverges falls back to exact
  classes (at most ``MAX_DEGREE_CLASSES``), and from there to the host.
* **The user compute, vmapped per class.**  ``compute(vertex, msg, agg,
  superstep)`` runs under ``torch.func.vmap`` over each class's rows,
  twice (the mail call and the no-mail call, where msg is the literal
  None), with float64 as the default dtype.  PyTorch runs eagerly, so
  where the reference traces a program per superstep the port calls the
  vmapped function per superstep with a Python int; the dtype, shape and
  structure checks run on every call, before the superstep's state is
  committed.
* **Messages are data.**  Emitted messages leave compute as (dst,
  value-leaf) columns; K11 packs the kept ones of every (class, mail)
  block, K1-K5 pre-combine them per target and bucket them by hash(dst),
  K4 exchanges them, K5 + K3 (K14 first for a traced merge) combine
  them, and K10 delivers them into every class slice in one launch.

What falls back and what propagates (ROADMAP C8): the host loop answers
when a check refuses the program (_NotColumnarizable, _DegreeDependent,
PregelInputError) or when the user's compute or combiner op raises while
it runs under vmap (UserCodeError, the counterpart of a failed trace).
Anything the port's own code raises -- a kernel, the exchange, an
allocation, a CUDA error or an out-of-memory even inside a user call --
propagates.
"""

import logging
import time

import numpy as np
import torch
from torch.func import vmap

from dpark_tpu_torch.backend.cuda import (collectives, kernels, layout,
                                         merge_program)
from dpark_tpu_torch.backend.cuda.fuse import python_float_semantics
from dpark_tpu_torch.utils import pytree
from dpark_tpu_torch.utils.monoid import monoid_identity
from dpark_tpu_torch.utils.phash import phash_np

logger = logging.getLogger("dpark_tpu_torch.bagel_obj")

_SENT = kernels.KEY_SENTINEL

# how the LAST DeviceObjectPregel construction classified the graph
LAST_RUN_STATS = {}

_COMBINE = {"add": torch.add, "min": torch.minimum, "max": torch.maximum,
            "mul": torch.mul}


def _not_columnar(msg):
    from dpark_tpu_torch.bagel import _NotColumnarizable
    return _NotColumnarizable(msg)


class _DegreeDependent(Exception):
    """Internal: the user compute consults the degree (len(outEdges)) or
    diverges on the exact-vs-bucket canary: buckets are unsound for it;
    fall back to exact degree classes."""


class UserCodeError(Exception):
    """The user's compute or combiner op raised while it ran under vmap:
    the program does not run on the device (the reference's failed
    trace).  ``orig`` is the user's exception."""

    def __init__(self, orig):
        super().__init__(str(orig))
        self.orig = orig


class _EdgeList(list):
    """The outEdges list handed to compute under bucketed classes: a
    bucket width is not the true degree, so any len() is recorded and
    rejects bucketing for the program."""

    def __init__(self, items, cell):
        super().__init__(items)
        self._dpark_cell = cell

    def __len__(self):
        self._dpark_cell["len_used"] = True
        return super().__len__()

    def __bool__(self):
        # "any edges?" is degree-safe: every member of a padded class has
        # at least one real edge (degree 0 is the exact class 0)
        return list.__len__(self) > 0


def _class_width(d, bucketed):
    """Degree class of a vertex: the exact degree, or the next power of
    two under bucketing (0 stays 0)."""
    if not bucketed or d <= 1:
        return int(d)
    return 1 << int(d - 1).bit_length()


def _device_fault(e):
    """An error of the device, not of the user's code."""
    acc = getattr(torch, "AcceleratorError", None)
    return (isinstance(e, torch.cuda.OutOfMemoryError)
            or (acc is not None and isinstance(e, acc))
            or (isinstance(e, RuntimeError) and "CUDA error" in str(e)))


def _user_call(fn, *args):
    """Call user code; its own errors become UserCodeError."""
    try:
        return fn(*args)
    except Exception as e:
        if _device_fault(e):
            raise
        raise UserCodeError(e) from e


def _as_tensor(x, device, what):
    """A user value (tensor, Python or numpy number or array) as a
    tensor on `device`."""
    if isinstance(x, torch.Tensor):
        return x
    try:
        if isinstance(x, (np.ndarray, np.generic)):
            return torch.from_numpy(np.array(x)).to(device)
        return torch.as_tensor(x, device=device)
    except (TypeError, ValueError, RuntimeError):
        raise _not_columnar("non-numeric %s %r" % (what, x))


def _np_dtype(t):
    return layout.numpy_dtype(t.dtype)


class DeviceObjectPregel:
    """One columnarized object-Bagel run over the executor's N shards.

    Inputs are validated and flattened by Bagel._run_columnar: ids (n,)
    int64 unique; vleaves: (n, ...) numeric columns of the flattened
    Vertex.value; act (n,) bool; degs (n,) int64; tgt_flat (E,) int64
    edge targets in per-vertex order (offsets = cumsum(degs)); ev_flat
    None or (E,) edge values; pend None or (dst (m,), leaf columns,
    treedef) initial messages; monoid the classified BasicCombiner op
    (None: the op rides as a traced merge); combine_op the raw op.
    """

    def __init__(self, executor, compute, monoid, vdef, ids, vleaves,
                 act, degs, tgt_flat, ev_flat, pend, max_superstep,
                 combine_op=None):
        from dpark_tpu_torch import bagel as _bagel
        t0 = time.perf_counter()
        self.ndev = executor.ndev
        self.device = executor.device
        self.compute = compute
        self.monoid = monoid
        self.combine_op = combine_op
        self.vdef = vdef
        self.max_superstep = max_superstep
        self._canaried = set()
        n = ids.shape[0]
        if np.unique(ids).shape[0] != n:
            raise _bagel.PregelInputError("vertex ids must be unique")
        if n and int(ids.max()) == _SENT:
            raise _bagel.PregelInputError(
                "vertex id equals the padding sentinel")
        self.vdtypes = [np.dtype(l.dtype) for l in vleaves]
        self.vshapes = [tuple(l.shape[1:]) for l in vleaves]
        self.nvl = len(vleaves)
        self.has_ev = ev_flat is not None
        self.edt = np.dtype(ev_flat.dtype) if self.has_ev else None

        degs_list = degs.tolist()
        want_buckets = _bagel.DEGREE_BUCKETS and len(set(degs_list)) > 1
        try:
            self._setup_classes(degs_list, bucketed=want_buckets,
                                pend=pend)
        except _DegreeDependent as e:
            if not want_buckets:
                raise _not_columnar(str(e))
            logger.info("degree buckets unsound for this compute (%s); "
                        "exact degree classes", e)
            self._setup_classes(degs_list, bucketed=False, pend=pend)
        LAST_RUN_STATS.clear()
        LAST_RUN_STATS.update({
            "bucketed": self.bucketed,
            "classes": len(self.classes),
            "widths": list(self.classes),
            "distinct_degrees": len(set(degs_list)),
            "msg_leaves": self.nm,
            "msg_merge": "monoid" if self._mmerge is None else "traced",
        })
        self.idents = [self._ident(li) for li in range(self.nm)]
        self._setup_tables(ids, vleaves, act, degs, degs_list, tgt_flat,
                           ev_flat)
        self._setup_init(pend)
        self.stats = {"setup_seconds": time.perf_counter() - t0,
                      "canary_seconds": 0.0,
                      "bucketed": self.bucketed,
                      "classes": len(self.classes),
                      "widths": list(self.classes),
                      "caps": [t["cap"] for t in self.tables]}

    # ------------------------------------------------------------------
    # host-side tables, moved to the device
    # ------------------------------------------------------------------
    def _put(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _setup_tables(self, ids, vleaves, act, degs, degs_list, tgt_flat,
                      ev_flat):
        """Per class: (N, cap) vertex ids (the sentinel past each shard's
        count), active flags and value leaves, (N, cap, d) edge targets
        and values (each row's true degree filled, the tail the sentinel
        target and value 0), and the (N,) row counts."""
        ndev = self.ndev
        vdev = (phash_np(ids) % np.uint32(ndev)).astype(np.int64)
        offs = np.concatenate([[0], np.cumsum(degs)]).astype(np.int64)
        widths = np.asarray([_class_width(d, self.bucketed)
                             for d in degs_list], np.int64)
        ecap = max(int(tgt_flat.shape[0]) - 1, 0)
        self.tables = []
        for d in self.classes:
            sel = np.nonzero(widths == d)[0]
            cdev = vdev[sel]
            order = np.argsort(cdev, kind="stable")
            sel = sel[order]
            bounds = np.searchsorted(cdev[order], np.arange(ndev + 1))
            cnt = np.diff(bounds).astype(np.int32)
            cap = layout.round_capacity(int(cnt.max()) if sel.size else 1)
            vid = np.full((ndev, cap), _SENT, np.int64)
            hact = np.zeros((ndev, cap), bool)
            hvl = [np.zeros((ndev, cap) + shp, dt)
                   for dt, shp in zip(self.vdtypes, self.vshapes)]
            htg = np.full((ndev, cap, d), _SENT, np.int64)
            hev = (np.zeros((ndev, cap, d), self.edt)
                   if self.has_ev else None)
            for dev in range(ndev):
                lo, hi = int(bounds[dev]), int(bounds[dev + 1])
                c = hi - lo
                if not c:
                    continue
                s = sel[lo:hi]
                vid[dev, :c] = ids[s]
                hact[dev, :c] = act[s]
                for h, l in zip(hvl, vleaves):
                    h[dev, :c] = l[s]
                if d:
                    dtrue = degs[s]
                    col = np.arange(d)[None, :]
                    eidx = offs[s][:, None] + np.minimum(
                        col, np.maximum(dtrue[:, None] - 1, 0))
                    eidx = np.clip(eidx, 0, ecap)
                    m = col < dtrue[:, None]
                    htg[dev, :c] = np.where(m, tgt_flat[eidx], _SENT)
                    if self.has_ev:
                        hev[dev, :c] = np.where(m, ev_flat[eidx],
                                                np.zeros((), self.edt))
            self.tables.append({
                "d": d, "cap": cap, "vcnt": self._put(cnt),
                "vid": self._put(vid), "act": self._put(hact),
                "vals": [self._put(h) for h in hvl],
                "tgts": self._put(htg),
                "evals": self._put(hev) if self.has_ev else None,
            })

    def _setup_init(self, pend):
        """The initial messages, bucketed by hash(dst) % N."""
        self.init = None
        self.init_count = 0
        if pend is None or not pend[0].size:
            return
        ndev = self.ndev
        idst, ivls, imdef = pend
        if imdef != self.mdef:
            raise _not_columnar(
                "initial message value structure differs from the "
                "structure compute emits")
        for l, shp in zip(ivls, self.mshapes):
            if tuple(np.asarray(l).shape[1:]) != shp:
                raise _not_columnar("initial message leaf shape mismatch")
        mdev = (phash_np(idst) % np.uint32(ndev)).astype(np.int64)
        mc = np.bincount(mdev, minlength=ndev)
        cap_m = layout.round_capacity(int(mc.max() or 1))
        hm_d = np.full((ndev, cap_m), _SENT, np.int64)
        hm_v = [np.zeros((ndev, cap_m) + shp, dt)
                for dt, shp in zip(self.mdts, self.mshapes)]
        mcnt = np.zeros(ndev, np.int32)
        for dev in range(ndev):
            m = mdev == dev
            c = int(m.sum())
            mcnt[dev] = c
            if c:
                hm_d[dev, :c] = idst[m]
                for hl, l in zip(hm_v, ivls):
                    hl[dev, :c] = np.asarray(l)[m].astype(hl.dtype)
        self.init = (self._put(mcnt), self._put(hm_d),
                     [self._put(l) for l in hm_v])
        self.init_count = int(idst.size)

    # ------------------------------------------------------------------
    # class selection + message-spec discovery
    # ------------------------------------------------------------------
    def _setup_classes(self, degs_list, bucketed, pend):
        from dpark_tpu_torch import bagel as _bagel
        self.bucketed = bucketed
        classes = sorted({_class_width(d, bucketed)
                          for d in degs_list}) or [0]
        if not bucketed and len(classes) > _bagel.MAX_DEGREE_CLASSES:
            raise _not_columnar(
                "%d degree classes > %d (each distinct degree is a "
                "separate trace)" % (len(classes),
                                     _bagel.MAX_DEGREE_CLASSES))
        self.classes = classes
        # least true degree per class: a class whose members all sit at
        # its width has no padding, and the canary skips it
        self._class_min_deg = {}
        for d in degs_list:
            w = _class_width(d, bucketed)
            cur = self._class_min_deg.get(w)
            self._class_min_deg[w] = d if cur is None else min(cur, d)
        self._discover_mspec(pend)
        self._setup_merge()
        # a function K14's programs memoise on (a bound method cannot)
        self._merge = merge_program.lowerable(self._merge_leaves)
        if bucketed:
            self._bucket_canary(0)

    @staticmethod
    def _sample_leaf(rng, dt, shape):
        """Seeded positive values (ints 1-4: x % 0 would raise)."""
        dt = np.dtype(dt)
        if dt.kind == "f":
            a = rng.uniform(0.5, 2.0, size=shape)
        elif dt.kind == "b":
            a = np.ones(shape, bool)
        else:
            a = rng.randint(1, 5, size=shape)
        return torch.from_numpy(np.ascontiguousarray(a.astype(dt)))

    def _mail_sample(self, rng, batch=4):
        return [self._sample_leaf(rng, dt, (batch,) + shp)
                for dt, shp in zip(self.mdts, self.mshapes)]

    def _body_sample(self, d, mail, batch=4):
        """A seeded CPU batch of every body argument (the reference's
        ShapeDtypeStructs, with values)."""
        rng = np.random.RandomState(0xD15C0 + d)
        args = [self._sample_leaf(rng, dt, (batch,) + shp)
                for dt, shp in zip(self.vdtypes, self.vshapes)]
        args.append(torch.arange(1, batch + 1, dtype=torch.int64))
        args.append(self._sample_leaf(rng, np.int64, (batch, d)))
        if self.has_ev:
            args.append(self._sample_leaf(rng, self.edt, (batch, d)))
        if mail:
            args.extend(self._mail_sample(rng, batch))
        args.append(torch.ones(batch, dtype=torch.bool))
        return args

    def _discover_mspec(self, pend):
        """Fixed-point discovery of the message value spec -- structure
        and per-leaf dtype and shape -- across all classes and both mail
        variants, by running the vmapped body on CPU samples.  Initial
        messages seed the spec: they feed the same combine."""
        if pend is not None and pend[0].size:
            _, ivls, imdef = pend
            for l in ivls:
                if np.asarray(l).dtype.kind not in "if":
                    raise _not_columnar(
                        "non-numeric initial message values")
            spec = (imdef,
                    [np.asarray(l).dtype for l in ivls],
                    [tuple(np.asarray(l).shape[1:]) for l in ivls])
            pure_guess = False
        else:
            guess = np.result_type(
                *([dt for dt in self.vdtypes if dt.kind in "if"]
                  or [np.dtype(np.float64)]))
            spec = (pytree.LEAF, [np.dtype(guess)], [()])
            pure_guess = True
        for rnd in range(4):
            # only the round-0 pure guess may be replaced wholesale by
            # the first emission; a seeded or settled spec is a contract
            found = [spec[0], list(spec[1]), list(spec[2]),
                     not (pure_guess and rnd == 0)]
            mail_err = None
            for mail in (False, True):
                for d in self.classes:
                    cell = {}
                    self.mdef, self.mdts, self.mshapes = \
                        spec[0], list(spec[1]), list(spec[2])
                    self.nm = len(spec[1])
                    body = self._class_body(d, 0, mail, cell,
                                            discovery=True)
                    try:
                        self._vmapped(body, self._body_sample(d, mail))
                    except UserCodeError as e:
                        if mail:
                            # the mail guess may be wrong this round:
                            # retry once the no-mail emissions correct it
                            mail_err = e
                            continue
                        raise _not_columnar(
                            "compute does not trace (%s)" % str(e)[:200])
                    if self.bucketed and cell.get("len_used"):
                        raise _DegreeDependent(
                            "compute consults len(outEdges)")
                    if "mdef" in cell:
                        if not found[3]:
                            found = [cell["mdef"], list(cell["mdts"]),
                                     list(cell["mshapes"]), True]
                        elif cell["mdef"] != found[0]:
                            raise _not_columnar(
                                "message value structure varies "
                                "across classes/supersteps")
                        elif cell["mshapes"] != found[2]:
                            raise _not_columnar(
                                "message leaf shapes vary")
                        else:
                            found[1] = [np.result_type(a, b)
                                        for a, b in zip(found[1],
                                                        cell["mdts"])]
            found_spec = (found[0], [np.dtype(t) for t in found[1]],
                          found[2])
            if found_spec == spec:
                if mail_err is not None:
                    raise _not_columnar(
                        "compute does not trace (%s)"
                        % str(mail_err)[:200])
                break
            spec = found_spec
        else:
            raise _not_columnar("message spec does not stabilize")
        self.mdef, self.mdts, self.mshapes = \
            spec[0], list(spec[1]), list(spec[2])
        self.nm = len(self.mdts)
        for shp in self.mshapes:
            if len(shp) > 1:
                raise _not_columnar(
                    "message leaves must be scalars or 1-D vectors")

    def _setup_merge(self):
        """The message combine: a classified monoid per leaf when the
        value is a single (scalar or vector) leaf; otherwise the user's
        op as a structure-preserving merge over the leaf tuple, vmapped
        over rows (lowered for K14 by collectives._merge_runs)."""
        from dpark_tpu_torch.bagel import PREGEL_MONOIDS
        if self.nm == 1 and self.monoid in PREGEL_MONOIDS:
            self._mmerge = None
            return
        op = self.combine_op
        if op is None:
            raise _not_columnar("combiner op not a provable monoid")
        mdef, nm = self.mdef, self.nm
        tdts = [layout.torch_dtype(dt) for dt in self.mdts]

        def leaf_merge(*flat):
            a = pytree.tree_unflatten(mdef, list(flat[:nm]))
            b = pytree.tree_unflatten(mdef, list(flat[nm:]))
            leaves, odef = pytree.tree_flatten(_user_call(op, a, b))
            if odef != mdef:
                raise _not_columnar(
                    "combiner op does not preserve the message value "
                    "structure (host semantics would differ)")
            dev = flat[0].device
            return tuple(_as_tensor(l, dev, "combined message value")
                         for l in leaves)
        vfn = vmap(leaf_merge)

        def merged(va_leaves, vb_leaves):
            with python_float_semantics():
                outs = vfn(*(list(va_leaves) + list(vb_leaves)))
            return [o.to(dt) for o, dt in zip(outs, tdts)]

        sample = self._mail_sample(np.random.RandomState(0xC0B1))
        try:
            outs = merged(sample, sample)
        except UserCodeError as e:
            raise _not_columnar(
                "combiner op does not trace over the message leaves "
                "(%s)" % str(e)[:160])
        for o, shp in zip(outs, self.mshapes):
            if tuple(o.shape[1:]) != shp:
                raise _not_columnar("combiner changes a message leaf "
                                    "shape")
        self.monoid = None
        self._mmerge = merged

    def _merge_leaves(self, a, b):
        """The message combine over leaf lists (the merge of K14,
        collectives._merge_runs, when no single-leaf monoid classifies
        it)."""
        if self._mmerge is not None:
            return self._mmerge(a, b)
        return [_COMBINE[self.monoid](x, y) for x, y in zip(a, b)]

    def _ident(self, li):
        """Filler of 'no message' rows of leaf li: the monoid identity
        when a monoid combines, else zero (those rows take the no-mail
        call; the filler is never read)."""
        if self.monoid is not None:
            return np.asarray(monoid_identity(self.monoid,
                                              self.mdts[li])).item()
        return np.dtype(self.mdts[li]).type(0).item()

    # ------------------------------------------------------------------
    # the per-(class, superstep, mail) body, vmapped over a class's rows
    # ------------------------------------------------------------------
    @staticmethod
    def _vmapped(body, args):
        with python_float_semantics():
            return vmap(body)(*args)

    def _class_body(self, d, s, mail, cell, discovery=False):
        """Per-vertex function for vmap over one class slice.  mail=False
        is the no-mail call (msg is the literal None, so `msg is not
        None` branches as on the host paths).  cell["m"] reports the
        emitted-message count of the call; discovery=True collects the
        emitted message spec into the cell instead of checking it."""
        from dpark_tpu_torch.bagel import Edge, Message, Vertex
        nvl, nm = self.nvl, self.nm
        vdef, mdef = self.vdef, self.mdef
        bucketed = self.bucketed

        def body(*args):
            i = nvl
            vls = args[:i]
            vid = args[i]
            tgts = args[i + 1]
            i += 2
            evs = None
            if self.has_ev:
                evs = args[i]
                i += 1
            m = None
            if mail:
                m = pytree.tree_unflatten(mdef, list(args[i:i + nm]))
                i += nm
            a = args[i]
            dev = vid.device
            value = pytree.tree_unflatten(vdef, list(vls))
            edge_items = [Edge(tgts[j], evs[j] if evs is not None
                               else None) for j in range(d)]
            edges = (_EdgeList(edge_items, cell) if bucketed
                     else edge_items)
            vert = Vertex(vid, value, edges, a)
            out = _user_call(self.compute, vert, m, None, s)
            if not (isinstance(out, tuple) and len(out) == 2):
                raise _not_columnar("compute must return "
                                    "(vertex, messages)")
            nv, out_msgs = out
            if not isinstance(nv, Vertex):
                raise _not_columnar("compute returned non-Vertex")
            if nv.id is not vert.id:
                raise _not_columnar("compute rebound vertex id")
            new_leaves, ndef = pytree.tree_flatten(nv.value)
            if ndef != vdef:
                raise _not_columnar(
                    "compute changed the vertex value structure")
            outs = []
            for leaf, dt, shp in zip(new_leaves, self.vdtypes,
                                     self.vshapes):
                arr = _as_tensor(leaf, dev, "vertex value")
                if np.result_type(_np_dtype(arr), dt) != np.dtype(dt):
                    raise _not_columnar(
                        "superstep %d produces %s vertex values, wider "
                        "than the initial %s" % (s, _np_dtype(arr), dt))
                arr = arr.to(layout.torch_dtype(dt))
                if tuple(arr.shape) != shp:
                    raise _not_columnar("vertex value leaf shape "
                                        "changed at superstep %d" % s)
                outs.append(arr)
            dsts, vals = [], []
            for msg_obj in (out_msgs or []):
                if not isinstance(msg_obj, Message):
                    raise _not_columnar("non-Message output")
                t = msg_obj.target_id
                if isinstance(t, bool):
                    raise _not_columnar("non-integer message target")
                td = _as_tensor(t, dev, "message target")
                if td.shape != () or _np_dtype(td).kind not in "iu":
                    raise _not_columnar(
                        "message target must be an integer scalar")
                mleaves, odef = pytree.tree_flatten(msg_obj.value)
                if not mleaves:
                    raise _not_columnar(
                        "message value has no numeric leaves")
                marrs = [_as_tensor(l, dev, "message value")
                         for l in mleaves]
                for arr in marrs:
                    if _np_dtype(arr).kind not in "if":
                        raise _not_columnar("non-numeric message value")
                if discovery:
                    shapes = [tuple(arr.shape) for arr in marrs]
                    if "mdef" in cell:
                        if odef != cell["mdef"] \
                                or shapes != cell["mshapes"]:
                            raise _not_columnar(
                                "message value structure varies "
                                "within one superstep")
                        cell["mdts"] = [np.result_type(x, _np_dtype(arr))
                                        for x, arr in zip(cell["mdts"],
                                                          marrs)]
                    else:
                        cell["mdef"] = odef
                        cell["mdts"] = [_np_dtype(arr) for arr in marrs]
                        cell["mshapes"] = shapes
                else:
                    if odef != mdef:
                        raise _not_columnar(
                            "superstep %d emits a different message "
                            "value structure than discovered" % s)
                    casted = []
                    for arr, dt, shp in zip(marrs, self.mdts,
                                            self.mshapes):
                        if tuple(arr.shape) != shp:
                            raise _not_columnar(
                                "message leaf shape changed at "
                                "superstep %d" % s)
                        if np.result_type(_np_dtype(arr), dt) \
                                != np.dtype(dt):
                            raise _not_columnar(
                                "superstep %d emits %s message leaves, "
                                "wider than the discovered %s"
                                % (s, _np_dtype(arr), dt))
                        casted.append(arr.to(layout.torch_dtype(dt)))
                    marrs = casted
                dsts.append(td.to(torch.int64))
                vals.append(marrs)
            cell["m"] = len(dsts)
            na = _as_tensor(nv.active, dev, "Vertex.active").to(torch.bool)
            if na.shape != ():
                raise _not_columnar("Vertex.active must be a scalar")
            md = (torch.stack(dsts) if dsts
                  else torch.zeros((0,), dtype=torch.int64, device=dev))
            mv_leaves = []
            for li in range(nm):
                dt = layout.torch_dtype(self.mdts[li])
                shp = tuple(self.mshapes[li])
                if vals:
                    mv_leaves.append(torch.stack(
                        [v[li] if li < len(v)
                         else torch.zeros(shp, dtype=dt, device=dev)
                         for v in vals]))
                else:
                    mv_leaves.append(torch.zeros((0,) + shp, dtype=dt,
                                                 device=dev))
            return tuple(outs) + (na, md) + tuple(mv_leaves)
        return body

    # ------------------------------------------------------------------
    # exact-vs-bucket canary
    # ------------------------------------------------------------------
    @staticmethod
    def _canary_draw(rng, dt, shape):
        """Mixed-sign sample values: a dummy tail's zeros and sentinels
        are only visible when real values can sit on either side."""
        if np.dtype(dt).kind == "f":
            return rng.uniform(-5.0, 5.0, size=shape).astype(dt)
        return rng.randint(-4, 5, size=shape).astype(dt)

    def _canary_rows(self, rng, n, d_true, width):
        """Synthetic rows at exact degree d_true, and the same rows
        padded to `width` with dummy edges."""
        vids = np.arange(1, n + 1, dtype=np.int64)
        vals = [self._canary_draw(rng, dt, (n,) + shp)
                for dt, shp in zip(self.vdtypes, self.vshapes)]
        tgt_e = rng.randint(1, n + 1, size=(n, d_true)).astype(np.int64)
        tgt_b = np.concatenate(
            [tgt_e, np.full((n, width - d_true), _SENT, np.int64)], axis=1)
        ev_e = ev_b = None
        if self.has_ev:
            ev_e = self._canary_draw(rng, self.edt, (n, d_true))
            ev_b = np.concatenate(
                [ev_e, np.zeros((n, width - d_true), self.edt)], axis=1)
        act = np.ones(n, bool)
        mleaves = [self._canary_draw(rng, dt, (n,) + shp)
                   for dt, shp in zip(self.mdts, self.mshapes)]
        return vids, vals, act, (tgt_e, ev_e), (tgt_b, ev_b), mleaves

    @staticmethod
    def _same_values(a, b):
        """Exact equality with NaN == NaN."""
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape:
            return False
        if a.dtype.kind == "f" or b.dtype.kind == "f":
            return bool(np.array_equal(a.astype(np.float64),
                                       b.astype(np.float64),
                                       equal_nan=True))
        return bool(np.array_equal(a, b))

    @staticmethod
    def _canary_msgs(outs, nvl, nm):
        """Per-vertex (dst, leaves) lists, dummy-edge messages dropped."""
        md = np.asarray(outs[nvl + 1])
        leaves = [np.asarray(outs[nvl + 2 + li]) for li in range(nm)]
        per_vertex = []
        for i in range(md.shape[0]):
            row = []
            for j in range(md.shape[1]):
                if int(md[i, j]) == _SENT:
                    continue
                row.append((int(md[i, j]),
                            tuple(np.asarray(l[i, j]) for l in leaves)))
            per_vertex.append(row)
        return per_vertex

    @classmethod
    def _canary_msgs_equal(cls, me, mb):
        if len(me) != len(mb):
            return False
        for ra, rb in zip(me, mb):
            if len(ra) != len(rb):
                return False
            for (da, la), (db, lb) in zip(ra, rb):
                if da != db or len(la) != len(lb):
                    return False
                if not all(cls._same_values(x, y)
                           for x, y in zip(la, lb)):
                    return False
        return True

    def _bucket_canary(self, s):
        """Soundness check of the padded classes at superstep `s`: the
        user compute, run on small synthetic CPU slices, must give equal
        vertex values, active flags and non-dummy messages at the exact
        degree and at the bucket width."""
        if not self.bucketed or s in self._canaried:
            return
        self._canaried.add(s)
        T = torch.from_numpy
        for width in self.classes:
            lb = self._class_min_deg.get(width, width)
            if width == 0 or lb >= width:
                continue             # no padded vertex in this class
            degrees = sorted({lb, (lb + width) // 2, width - 1})
            rng = np.random.RandomState(0xBA6E1 + 31 * s)
            for d_true in degrees:
                if d_true < 1:
                    continue
                (vids, vals, act, (tgt_e, ev_e), (tgt_b, ev_b),
                 mleaves) = self._canary_rows(rng, 3, d_true, width)
                for mail in (True, False):
                    def run(width_, tgt, ev):
                        cell = {}
                        body = self._class_body(width_, s, mail, cell)
                        args = [T(v) for v in vals] + [T(vids), T(tgt)]
                        if self.has_ev:
                            args.append(T(ev))
                        if mail:
                            args.extend(T(m) for m in mleaves)
                        args.append(T(act))
                        return self._vmapped(body, args), cell
                    try:
                        oe, ce = run(d_true, tgt_e, ev_e)
                    except Exception as e:
                        # exact classes would fail the same way: surface
                        # through the normal fallback
                        raise _DegreeDependent(
                            "compute fails at exact degree %d (%s)"
                            % (d_true, str(e)[:120]))
                    ob, cb = run(width, tgt_b, ev_b)
                    if ce.get("len_used") or cb.get("len_used"):
                        raise _DegreeDependent(
                            "compute consults len(outEdges)")
                    for li in range(self.nvl):
                        if not self._same_values(oe[li], ob[li]):
                            raise _DegreeDependent(
                                "vertex values diverge between exact "
                                "degree %d and bucket %d at superstep "
                                "%d" % (d_true, width, s))
                    if not np.array_equal(np.asarray(oe[self.nvl]),
                                          np.asarray(ob[self.nvl])):
                        raise _DegreeDependent(
                            "active flags diverge under bucketing")
                    me = self._canary_msgs(oe, self.nvl, self.nm)
                    mb = self._canary_msgs(ob, self.nvl, self.nm)
                    if not self._canary_msgs_equal(me, mb):
                        raise _DegreeDependent(
                            "non-dummy messages diverge between exact "
                            "degree %d and bucket %d" % (d_true, width))

    # ------------------------------------------------------------------
    # supersteps
    # ------------------------------------------------------------------
    def _p_init(self):
        """Pre-combine the initial messages per target and bucket them
        by destination shard."""
        mcnt, mdst, mvals = self.init
        kk, vv, counts, offsets = collectives.bucketize_combine_keys(
            [mdst], mvals, mcnt, self.ndev, self._merge,
            monoid=self.monoid)
        return counts, offsets, kk[0], vv

    def _p_step(self, s, pending):
        """One superstep: deliver, compute and commit (_step_blocks),
        pack the emitted messages of every block (K11), pre-combine and
        bucket them by destination (K1, K5, K2, K3).  Returns (pending,
        active vertices, messages emitted), the two counts read in one
        host sync."""
        blocks, n_active = self._step_blocks(s, pending)
        if not blocks:
            return None, int(n_active.item()), 0
        dst, leaves, cnt = kernels.obj_emit_pack(blocks)
        kk, vv, counts, offsets = collectives.bucketize_combine_keys(
            [dst], leaves, cnt, self.ndev, self._merge, monoid=self.monoid)
        n_act, n_msgs = torch.stack([n_active, cnt.sum().long()]).tolist()
        return (counts, offsets, kk[0], vv), n_act, n_msgs

    def _step_blocks(self, s, pending):
        """Deliver the combined messages into every class slice (K4, K5 +
        K3, one K10 launch for all classes), run the vmapped compute per
        class (mail and no-mail calls), commit the new state once every
        class has passed its checks.  Returns (the emission blocks, in the reference's
        order, and the active count as a device scalar)."""
        t0 = time.perf_counter()
        self._bucket_canary(s)
        self.stats["canary_seconds"] += time.perf_counter() - t0
        N, dev, nvl, nm = self.ndev, self.device, self.nvl, self.nm
        if pending is not None:
            counts, offsets, kk, vv = pending
            recv, n = collectives.exchange([kk] + vv, counts, offsets)
            uk, uv, n_unique = collectives.segment_reduce_keys(
                [recv[0]], recv[1:], n, self._merge, monoid=self.monoid)
            # one K10 launch delivers into every class
            mail = kernels.pregel_deliver_classes(
                [(t["vid"], t["vcnt"]) for t in self.tables], uk[0],
                n_unique, uv, self.monoid, fills=self.idents)
        blocks, committed = [], []
        for ci, t in enumerate(self.tables):
            cap, d = t["cap"], t["d"]
            vid, act, vals = t["vid"], t["act"], t["vals"]
            valid = collectives.valid_rows(t["vcnt"], cap) & (vid != _SENT)
            if pending is not None:
                msg, has = mail[ci]
            else:
                has = torch.zeros((N, cap), dtype=torch.bool, device=dev)
                msg = [torch.full((N, cap) + shp, ident,
                                  dtype=layout.torch_dtype(dt), device=dev)
                       for dt, shp, ident in zip(self.mdts, self.mshapes,
                                                 self.idents)]
            invoked = (act | has) & valid

            def flat(x):
                return x.reshape((N * cap,) + tuple(x.shape[2:]))

            def shaped(x):
                return x.reshape((N, cap) + tuple(x.shape[1:]))
            margs = [flat(v) for v in vals] + [flat(vid), flat(t["tgts"])]
            if self.has_ev:
                margs.append(flat(t["evals"]))
            cm, cn = {}, {}
            om = self._vmapped(self._class_body(d, s, True, cm),
                               margs + [flat(x) for x in msg] + [flat(act)])
            on = self._vmapped(self._class_body(d, s, False, cn),
                               margs + [flat(act)])
            om, on = [shaped(x) for x in om], [shaped(x) for x in on]

            def bc(mask, leaf):
                return mask.view(mask.shape + (1,) * (leaf.dim() - 2))
            new_vals = []
            for li in range(nvl):
                pick = torch.where(bc(has, om[li]), om[li], on[li])
                new_vals.append(torch.where(bc(invoked, pick), pick,
                                            vals[li]).contiguous())
            new_act = invoked & torch.where(has, om[nvl], on[nvl])
            # the mail call's messages from invoked rows with mail, the
            # no-mail call's from invoked rows without
            for blk, gate, cell in ((om, invoked & has, cm),
                                    (on, invoked & ~has, cn)):
                if cell["m"]:
                    blocks.append((gate.contiguous(),
                                   blk[nvl + 1].contiguous(),
                                   [blk[nvl + 2 + li].contiguous()
                                    for li in range(nm)]))
            committed.append((new_vals, new_act))
        # one K17 launch counts every class's active vertices
        n_active = kernels.active_count(
            [new_act.contiguous() for _, new_act in committed],
            [t["vcnt"] for t in self.tables])
        for t, (new_vals, new_act) in zip(self.tables, committed):
            t["vals"], t["act"] = new_vals, new_act
        return blocks, n_active

    def run(self):
        t0 = time.perf_counter()
        pending, total_msgs = None, 0
        if self.init is not None:
            pending, total_msgs = self._p_init(), self.init_count
        t1 = time.perf_counter()
        s = delivered = 0
        while s < self.max_superstep:
            mail = pending if total_msgs > 0 else None
            delivered += mail is not None
            pending, n_active, total_msgs = self._p_step(s, mail)
            s += 1
            logger.debug("obj superstep %d: active=%d msgs=%d", s,
                         n_active, total_msgs)
            if n_active == 0 and total_msgs == 0:
                break
        self.stats.update(supersteps=s, delivered=delivered,
                          init_seconds=t1 - t0,
                          superstep_seconds=time.perf_counter() - t1)
        return self._collect()

    def _collect(self):
        """Final (ids, value leaf columns, active), unpadded and sorted
        by id."""
        ids, leaves, actv = [], [[] for _ in range(self.nvl)], []
        for t in self.tables:
            vid = t["vid"].cpu().numpy()
            m = vid != _SENT
            ids.append(vid[m])
            actv.append(t["act"].cpu().numpy()[m])
            for i, l in enumerate(t["vals"]):
                leaves[i].append(l.cpu().numpy()[m])
        ids = np.concatenate(ids) if ids else np.zeros(0, np.int64)
        order = np.argsort(ids)
        leaves = [np.concatenate(ls)[order] for ls in leaves]
        act = (np.concatenate(actv)[order] if actv
               else np.zeros(0, bool))
        return ids[order], leaves, act
