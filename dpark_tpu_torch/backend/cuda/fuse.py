"""Stage fusion: a narrow RDD chain -> ops over one tensor batch (port of
the main-path subset of dpark_tpu/backend/tpu/fuse.py).

User record-level lambdas become columnar code through torch.func.vmap
(the counterpart of jax.vmap in the reference's MapOp.apply).  Before a
stage is admitted every user function is probed with vmap on a tiny CPU
sample (in place of jax.eval_shape); anything the probe refuses —
strings, data-dependent control flow, .item(), numpy or jnp calls on
tensors — sends the stage to the host object path with the reason
recorded.  analyze_stage never raises for user code.
"""

import contextlib

import numpy as np
import torch
from torch.func import vmap

from dpark_tpu_torch import conf
from dpark_tpu_torch.backend.cuda import layout
from dpark_tpu_torch.dependency import HashPartitioner, RangePartitioner
from dpark_tpu_torch.rdd import (
    FilteredRDD, FlatMappedValuesRDD, KeyedRDD, MappedRDD, MappedValuesRDD,
    MapPartitionsRDD, ParallelCollection, ShuffledRDD, _ColumnarSlice,
    _SortPartFn, _append, _extend, _identity, _mk_list)
from dpark_tpu_torch.utils import monoid as _monoid

_monoid.register_direct({torch.add: "add", torch.mul: "mul",
                         torch.minimum: "min", torch.maximum: "max"})

# reasons a stage leaves the tensor path (the key-shape ones are the
# reference's own strings, fuse._fallback in dpark_tpu)
HASH_KEY_REASON = ("hash shuffle needs an int scalar (or flat "
                   "int-tuple, <= conf.MAX_KEY_LEAVES columns) key")
HASH_KEY_COMBINER_REASON = ("hash shuffle needs an int scalar (or flat "
                            "int-tuple) key after create_combiner")
RANGE_KEY_REASON = ("range shuffle needs a numeric scalar (or flat "
                    "numeric-tuple) key")
RANGE_MIXED_REASON = ("range partitioner over a tuple key with mixed "
                      "column dtypes")
RANGE_WIDTH_REASON = "range bounds do not match the key width"
GROUP_REASON = ("grouped values consumed on the host ((k, [v]) lists have "
                "no device form for this chain)")
WAVE_REASON = ("columnar input above the wave threshold (%d rows per "
               "shard): out-of-core wave stream not yet ported")
WIDE_REASON = ("more logical partitions (%d) than shards (%d): the "
               "spilled-run stream is not yet ported")


def classify_merge(merge):
    """EXACT monoid classification: "add" | "min" | "max" | "mul" |
    None (utils/monoid.py)."""
    return _monoid.classify_merge(merge)


def is_list_agg(agg):
    """The identity list-aggregator of groupByKey / partitionBy: values
    are repartitioned, never combined (a no-combine shuffle)."""
    return (agg.create_combiner is _mk_list
            and agg.merge_value is _append
            and agg.merge_combiners is _extend)


def partitioner_spec(part):
    """("hash",) | ("range", ascending) | None: the device destination
    function of a partitioner."""
    if isinstance(part, HashPartitioner):
        return ("hash",)
    if isinstance(part, RangePartitioner):
        try:
            bounds = np.asarray(part.bounds)
        except Exception:        # ragged or odd user bounds
            return None
        if bounds.dtype == object or bounds.dtype.kind in "USO":
            return None
        return ("range", bool(part.ascending))
    return None


def _range_bounds_array(bounds, specs, nk):
    """The RangePartitioner bounds as the (len(bounds), nk) array the
    range epilogue compares against, in the key columns' one dtype, or
    (None, reason): a tuple key's columns must share a dtype (mixed
    int/float tuples have host bisect semantics no single-dtype compare
    reproduces)."""
    dt = np.dtype(specs[0][0])
    if any(np.dtype(sp[0]) != dt for sp in specs[1:nk]):
        return None, RANGE_MIXED_REASON
    if not bounds:
        return np.zeros((0, nk), dtype=dt), None
    arr = np.asarray(bounds, dtype=dt)
    if nk == 1 and arr.ndim == 1:
        arr = arr[:, None]
    if arr.ndim != 2 or arr.shape[1] != nk:
        return None, RANGE_WIDTH_REASON
    return np.ascontiguousarray(arr), None


@contextlib.contextmanager
def python_float_semantics():
    """Run user code with float64 as the default dtype: an int tensor
    times a Python float must give a Python-precision float."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


def _as_leaf(x, device):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, bool):
        return torch.tensor(x, dtype=torch.bool, device=device)
    if isinstance(x, int):
        return torch.tensor(x, dtype=torch.int64, device=device)
    if isinstance(x, float):
        return torch.tensor(x, dtype=torch.float64, device=device)
    raise TypeError("record leaf of type %s has no tensor form"
                    % type(x).__name__)


def _row_fn(f, in_treedef):
    """A record-level user fn as leaves -> leaves; the output treedef is
    discovered at trace time.  Python scalar outputs become tensors."""
    def fn(*leaves):
        rec = layout.tree_unflatten(in_treedef, list(leaves))
        out_leaves, out_treedef = layout.tree_flatten(f(rec))
        fn.out_treedef = out_treedef
        dev = leaves[0].device
        return tuple(_as_leaf(x, dev) for x in out_leaves)
    return fn


def _sample(specs, rows=2):
    """A tiny CPU batch of ones (not zeros: x % 0 raises on ints)."""
    return [torch.ones((rows,) + tuple(shape), dtype=layout.torch_dtype(dt))
            for dt, shape in specs]


def _flat(leaves):
    N, cap = leaves[0].shape[:2]
    return [leaf.reshape((N * cap,) + tuple(leaf.shape[2:]))
            for leaf in leaves], (N, cap)


def _unflat(leaves, nc):
    return [leaf.reshape(nc + tuple(leaf.shape[1:])) for leaf in leaves]


class MapOp:
    """map / mapValue / keyBy — all record -> record functions."""

    def __init__(self, f):
        self.f = f

    def probe(self, treedef, specs):
        fn = _row_fn(self.f, treedef)
        with python_float_semantics():
            out = vmap(fn)(*_sample(specs))
        out_specs = [(layout.numpy_dtype(o.dtype), tuple(o.shape[1:]))
                     for o in out]
        if not out_specs:
            raise TypeError("a record with no leaves has no tensor form")
        for dt, _ in out_specs:
            if dt.kind not in "bif":
                raise TypeError("leaf dtype %s has no tensor form" % dt)
        self._fn = fn
        self._out_treedef = fn.out_treedef
        self._out_specs = out_specs
        return self._out_treedef, out_specs

    def apply(self, leaves, n):
        flat, nc = _flat(leaves)
        with python_float_semantics():
            out = vmap(self._fn)(*flat)
        out = [o.to(layout.torch_dtype(dt)).contiguous()
               for o, (dt, _) in zip(out, self._out_specs)]
        return _unflat(out, nc), n


class FilterOp:
    def __init__(self, f):
        self.f = f

    def probe(self, treedef, specs):
        fn = _row_fn(self.f, treedef)
        with python_float_semantics():
            out = vmap(fn)(*_sample(specs))
        if len(out) != 1 or out[0].dim() != 1:
            raise TypeError("filter predicate must return a scalar")
        self._fn = fn
        return treedef, specs          # unchanged record type

    def apply(self, leaves, n):
        from dpark_tpu_torch.backend.cuda import collectives
        flat, nc = _flat(leaves)
        with python_float_semantics():
            (pred,) = vmap(self._fn)(*flat)
        mask = pred.reshape(nc).bool() & collectives.valid_rows(n, nc[1])
        return collectives.compact(leaves, mask)


def _reversed_order(col):
    """An order-reversing bijection of a key column: -1-k for ints (no
    overflow), -k for floats."""
    return -col if col.is_floating_point() else -1 - col


class SortOp:
    """Per-shard stable sort by the key — one scalar leaf, or every column
    of a flat tuple key, compared lexicographically like the host's tuple
    sort (sortByKey's final mapPartitions(_SortPartFn) on the device).
    Descending sorts ascending on an order-reversing key, so equal keys
    keep their input order as Python's sorted(reverse=True) does (the
    reference reverses an ascending sort and so reverses ties)."""

    def __init__(self, ascending):
        self.ascending = ascending
        self.nk = 1

    def probe(self, treedef, specs):
        nk = layout.key_width(treedef, specs, kinds="if")
        if nk is None:
            raise TypeError("sort needs a numeric scalar (or flat numeric "
                            "tuple) key")
        self.nk = nk
        return treedef, specs

    def apply(self, leaves, n):
        from dpark_tpu_torch.backend.cuda import collectives
        keys = leaves[:self.nk]
        if not self.ascending:
            keys = [_reversed_order(k) for k in keys]
        # validity is the primary key (the last pass, K2): padding sorts
        # last whatever the key values, NaN and the sentinel included
        inval = (~collectives.valid_rows(n, leaves[0].shape[1])).to(
            torch.int32)
        packed = collectives._partition_through(
            inval, 2, list(leaves), collectives._lex_order(keys))
        return list(packed[1:-1]), n


def _leaves_merge_fn(merge, record_treedef):
    """User merge_combiners (value, value) -> value lifted to leaf lists
    and vmapped.  The value's real structure is rebuilt before calling
    the user function (a nested accumulator sees its own shape)."""
    if isinstance(record_treedef, tuple) and len(record_treedef) == 2:
        vdef = layout._renumber(record_treedef[1])     # (k, value)
        nleaves = layout.num_leaves(vdef)

        def _unwrap(leaves):
            return layout.tree_unflatten(vdef, list(leaves))
    else:                                    # flat (k, v1, v2, ...)
        nleaves = layout.num_leaves(record_treedef) - 1

        def _unwrap(leaves):
            return leaves[0] if nleaves == 1 else tuple(leaves)
    if nleaves == 0:
        # a leafless value ((k, None) records): nothing to merge, as long
        # as the merge keeps the value leafless
        out = merge(_unwrap([]), _unwrap([]))
        if layout.tree_flatten(out)[1] != layout.tree_flatten(
                _unwrap([]))[1]:
            raise TypeError("merge of leafless values grew leaves")
        return lambda va_leaves, vb_leaves: []

    def leaf_merge(*flat):
        out = merge(_unwrap(flat[:nleaves]), _unwrap(flat[nleaves:]))
        return tuple(_as_leaf(x, flat[0].device)
                     for x in layout.tree_leaves(out))

    vfn = vmap(leaf_merge)

    def merged(va_leaves, vb_leaves):
        with python_float_semantics():
            return list(vfn(*(list(va_leaves) + list(vb_leaves))))
    return merged


def probe_merge(merge, treedef, specs, nk):
    """The vmapped merge when it traces on the value specs and keeps
    their leaf count, else None."""
    try:
        merge_fn = _leaves_merge_fn(merge, treedef)
        sample = _sample(specs[nk:])
        out = merge_fn(sample, sample)
        if len(out) != len(specs) - nk:
            return None
        return merge_fn
    except Exception:        # user code: any failure means "not traceable"
        return None


def _subscript_const_index(f):
    """The integer I when f is exactly ``lambda x: x[I]`` (closure-free)
    — the provable select-one-leaf top() key.  None otherwise."""
    code = getattr(f, "__code__", None)
    if code is None or getattr(f, "__closure__", None):
        return None
    if code.co_argcount != 1 or code.co_flags & 0x0C:
        return None
    t = (lambda x: x[99]).__code__
    if not (code.co_code == t.co_code and code.co_names == t.co_names):
        return None
    ints = [c for c in code.co_consts
            if isinstance(c, int) and not isinstance(c, bool)]
    other = [c for c in code.co_consts
             if not isinstance(c, int) or isinstance(c, bool)]
    t_other = [c for c in t.co_consts
               if not isinstance(c, int) or isinstance(c, bool)]
    if len(ints) != 1 or other != t_other:
        return None
    return ints[0]


def _no_none(treedef):
    return treedef is not None and (isinstance(treedef, int) or all(
        _no_none(c) for c in treedef))


def classify_top_key(key, treedef, specs):
    """How to compute each record's top() ordering key on the device:
    ("leaves", (i, ...)) for records compared as themselves (a scalar, or
    a tuple of numeric scalars, lexicographically in leaf order) or a
    provable ``x[i]`` subscript of a flat record, ("fn", key) for a traced
    float64 key expression, None (host path).  Integer key expressions stay
    on the host: the host computes exact Python ints where the device
    would wrap at int64."""
    nl = len(specs)
    if key is None:
        # a None inside a record makes Python's tuple compare raise
        if not _no_none(treedef) or any(
                shape != () or dt.kind not in "if" for dt, shape in specs):
            return None
        return ("leaves", tuple(range(nl)))
    idx = _subscript_const_index(key)
    if idx is not None:
        if not (0 <= idx < nl) or treedef != tuple(range(nl)):
            return None
        dt, shape = specs[idx]
        if shape != () or dt.kind not in "if":
            return None
        return ("leaves", (idx,))
    try:
        fn = _row_fn(key, treedef)
        with python_float_semantics():
            out = vmap(fn)(*_sample(specs))
    except Exception:        # user code: any failure means host path
        return None
    if len(out) == 1 and out[0].dim() == 1 and out[0].dtype == torch.float64:
        return ("fn", key)
    return None


class StagePlan:
    """Everything needed to run one stage on the tensor path."""

    def __init__(self, source, ops, epilogue, in_treedef, in_specs,
                 out_treedef, out_specs, stage):
        self.source = source        # ("ingest", pc) | ("hbm", dep)
        self.ops = ops
        self.epilogue = epilogue    # None | ("shuffle_write", dep)
        self.in_treedef = in_treedef
        self.in_specs = in_specs
        self.out_treedef = out_treedef
        self.out_specs = out_specs
        self.stage = stage
        self.src_nk = 1
        self.src_merge = None       # vmapped merge of an hbm source
        self.group_output = False   # bare groupByKey: (k, [v]) at egest
        self.epi_nk = 1
        self.epi_spec = None        # partitioner_spec of the write
        self.epi_bounds = None      # (m, nk) numpy range bounds
        self.no_combine = False     # the write repartitions, never merges
        self.reslice = False
        # set per run by the scheduler from the stage's tasks
        self.count_only = False
        self.top_candidate = None
        self.reduce_monoid = None
        self.topk_used = False


def _mapvalue_as_record_fn(f):
    def fn(rec):
        return (rec[0], f(rec[1]))
    return fn


def _keyby_as_record_fn(f):
    def fn(rec):
        return (f(rec), rec)
    return fn


def extract_chain(top):
    """Walk narrow one-parent links from the stage's top RDD to its
    source.  Returns (source_rdd, ops root->top, passthrough) or None;
    passthrough: partitionBy's flatMapValue(identity) over a no-combine
    shuffle, whose rows then pass through flat."""
    ops = []
    cur = top
    passthrough = False
    while True:
        if (isinstance(cur, FlatMappedValuesRDD) and cur.f is _identity
                and isinstance(cur.prev, ShuffledRDD)
                and is_list_agg(cur.prev.aggregator)):
            passthrough = True
        elif isinstance(cur, MapPartitionsRDD) \
                and isinstance(cur.f, _SortPartFn):
            ops.append(SortOp(cur.f.ascending))
        elif isinstance(cur, MappedValuesRDD):
            ops.append(MapOp(_mapvalue_as_record_fn(cur.f)))
        elif isinstance(cur, KeyedRDD):
            ops.append(MapOp(_keyby_as_record_fn(cur.f)))
        elif isinstance(cur, MappedRDD):
            ops.append(MapOp(cur.f))
        elif isinstance(cur, FilteredRDD):
            ops.append(FilterOp(cur.f))
        elif isinstance(cur, (ParallelCollection, ShuffledRDD)):
            ops.reverse()
            return cur, ops, passthrough
        else:
            return None
        cur = cur.prev


def _sample_record(pc):
    for s in pc._slices:
        if s:
            return s[0]
    return None


def _columnar_row_bytes(slices):
    for s in slices:
        cols = getattr(s, "columns", None)
        if cols is not None and len(s):
            return sum(np.asarray(c).dtype.itemsize for c in cols)
    return 16


def _wave_rows(pc, device):
    """The wave threshold a columnar input exceeds, or None."""
    slices = pc._slices
    if not all(isinstance(s, _ColumnarSlice) for s in slices):
        return None
    limit = conf.stream_chunk_rows(_columnar_row_bytes(slices), device)
    if max((len(s) for s in slices), default=0) > limit:
        return limit
    return None


def analyze_stage(stage, ndev, executor):
    """(StagePlan, None) when `stage` can run on the tensor path, else
    (None, reason)."""
    top = stage.rdd
    extracted = extract_chain(top)
    if extracted is None:
        return None, ("%s has no tensor form yet; object path"
                      % type(top).__name__)
    source_rdd, ops, passthrough = extracted
    store = executor.shuffle_store
    src_nk = 1
    src_merge = None
    group_output = False
    reslice = False
    if isinstance(source_rdd, ParallelCollection):
        if not stage.is_shuffle_map and not ops:
            return None, "plain read of the input: no device work"
        reslice = len(source_rdd._slices) != ndev
        if reslice and not stage.is_shuffle_map:
            return None, ("result stage over %d input slices on %d "
                          "shards" % (len(source_rdd._slices), ndev))
        wave = _wave_rows(source_rdd, executor.device)
        if wave is not None:
            return None, WAVE_REASON % wave
        sample = _sample_record(source_rdd)
        if sample is None:
            return None, "empty input"
        try:
            treedef, specs = layout.record_spec(sample)
        except TypeError as e:
            return None, "record has no tensor form (%s)" % e
        source = ("ingest", source_rdd)
    else:                                   # ShuffledRDD
        dep = source_rdd.dep
        if dep.shuffle_id not in store:
            return None, "parent shuffle output lives on the host"
        if dep.partitioner.num_partitions > ndev:
            return None, WIDE_REASON % (dep.partitioner.num_partitions,
                                        ndev)
        meta = store[dep.shuffle_id]
        treedef, specs = meta["out_treedef"], meta["out_specs"]
        src_nk = meta["key_cols"]
        if meta["no_combine"]:
            # no-combine shuffle (partitionBy / groupByKey / sortByKey):
            # rows pass through flat; a bare groupByKey groups at egest
            if not passthrough:
                if ops or stage.is_shuffle_map:
                    return None, GROUP_REASON
                group_output = True
        else:
            src_merge = probe_merge(dep.aggregator.merge_combiners, treedef,
                                    specs, src_nk)
            if src_merge is None:
                return None, ("merge_combiners not traceable by "
                              "torch.func.vmap; object path")
        source = ("hbm", dep)

    cur_treedef, cur_specs = treedef, specs
    try:
        for op in ops:
            cur_treedef, cur_specs = op.probe(cur_treedef, cur_specs)
    except Exception as e:   # user code: any failure means host path
        return None, ("user function not traceable by torch.func.vmap "
                      "(%s: %s); object path"
                      % (type(e).__name__, str(e)[:120]))

    plan = StagePlan(source, ops, None, treedef, specs, cur_treedef,
                     cur_specs, stage)
    plan.src_nk = src_nk
    plan.src_merge = src_merge
    plan.group_output = group_output
    plan.reslice = reslice
    if stage.is_shuffle_map:
        reason = _plan_shuffle_write(plan, stage.shuffle_dep, ndev)
        if reason is not None:
            return None, reason
    return plan, None


def _plan_shuffle_write(plan, dep, ndev):
    """Fill in the plan's shuffle-write epilogue; returns the reason the
    write has no device form, or None.  A hash write needs int key
    columns and, when it combines, a traceable create_combiner; a range
    write takes numeric key columns of one dtype and repartitions only;
    a no-combine write (groupByKey / partitionBy) skips create_combiner."""
    spec = partitioner_spec(dep.partitioner)
    if spec is None:
        return ("%s has no device destination function"
                % type(dep.partitioner).__name__)
    no_combine = is_list_agg(dep.aggregator)
    if spec[0] == "hash":
        epi_nk = layout.key_width(plan.out_treedef, plan.out_specs,
                                  kinds="i")
        if epi_nk is None:
            return HASH_KEY_REASON
    else:
        epi_nk = layout.key_width(plan.out_treedef, plan.out_specs,
                                  kinds="if")
        if epi_nk is None:
            return RANGE_KEY_REASON
        plan.epi_bounds, reason = _range_bounds_array(
            dep.partitioner.bounds, plan.out_specs, epi_nk)
        if reason is not None:
            return reason
        if not no_combine:
            return ("range shuffle with a combining aggregator: not yet "
                    "ported")
    if not no_combine:
        create = dep.aggregator.create_combiner
        op = MapOp(lambda rec: (rec[0], create(rec[1])))
        try:
            plan.out_treedef, plan.out_specs = op.probe(plan.out_treedef,
                                                        plan.out_specs)
        except Exception as e:   # user code
            return ("create_combiner not traceable by torch.func.vmap "
                    "(%s: %s); object path"
                    % (type(e).__name__, str(e)[:120]))
        plan.ops.append(op)
        epi_nk = layout.key_width(plan.out_treedef, plan.out_specs,
                                  kinds="i")
        if epi_nk is None:
            return HASH_KEY_COMBINER_REASON
    if dep.partitioner.num_partitions > ndev:
        return WIDE_REASON % (dep.partitioner.num_partitions, ndev)
    plan.epilogue = ("shuffle_write", dep)
    plan.epi_nk = epi_nk
    plan.epi_spec = spec
    plan.no_combine = no_combine
    return None
