"""Stage fusion: a narrow RDD chain -> ops over one tensor batch (port of
the main-path subset of dpark_tpu/backend/tpu/fuse.py).

User record-level lambdas become columnar code through torch.func.vmap
(the counterpart of jax.vmap in the reference's MapOp.apply).  Before a
stage is admitted every user function is probed with vmap on a tiny CPU
sample (in place of jax.eval_shape); anything the probe refuses —
strings, data-dependent control flow, .item(), numpy or jnp calls on
tensors — sends the stage to the host object path with the reason
recorded.  analyze_stage never raises for user code.

A shuffle stage whose narrow chain reads a text file is a "text" source
(analyze_text_stage): the chain runs on the host, string keys become
int64 ids, and ids never feed further device ops (only a plain read of
an encoded store, decoded at egest, rides the device).

An a.join(b) over two device-resident no-combine shuffles is a "join"
source (_analyze_join_source): K12 expands the matched pairs on the
device and the rest of the chain runs on them.  A join the device does
not admit runs the host path with the reason.

A columnar input above the wave threshold (_wave_rows, the predicate
the executor's _stream_mode reads too) feeding a shuffle write streams
in waves; only such an input may write more logical partitions than
shards (`logical_spill`: spilled runs).  A reduce stage over spilled
runs reads them on the host (HOST_RUNS_READ), except a segment op over a
no-combine write with a partition a shard.

A groupByKey consumed by mapValues(f) stays on the device two ways, as
in the reference: a provable aggregate (sum/len/min/max/mean) as
SegAggOp (K3 over the key-sorted rows), any traceable padding-invariant
per-group f as SegMapOp (K7 segment table, K2 size-class members, K8
padded gather and scatter, f vmapped over each size class).  In its
state mode (updateStateByKey's general update(values, prev) over (k, (v,
flag)) rows, dstream._SegStateApply) K8's state gather compacts each
group's new values and picks its carried state row.

A shuffle stage over a.union(b, ...) is a "union" source (B16): each
branch is a sub-plan without an epilogue (an input, or a shuffle output
kept on the device, with or without its combine or a segment op), the
executor materializes the branches and K16 packs their rows per shard,
and the stage's narrow ops and shuffle write run over the union.

A cached RDD whose narrow chain reads a shuffle output kept on the device
(and whose partitions the host cache does not hold) is read through: the
port has no device result cache yet (ROADMAP A19), and the store holds
its data.  A cached RDD over anything else keeps the host path.
"""

import contextlib

import numpy as np
import torch
from torch.func import vmap

from dpark_tpu_torch import conf
from dpark_tpu_torch.backend.cuda import kernels, layout, merge_program
from dpark_tpu_torch.dependency import HashPartitioner, RangePartitioner
from dpark_tpu_torch.rdd import (
    CoGroupedRDD, DerivedRDD, FilteredRDD, FlatMappedRDD,
    FlatMappedValuesRDD, KeyedRDD, MappedRDD, MappedValuesRDD,
    MapPartitionsRDD, ParallelCollection, ShuffledRDD, TextFileRDD,
    UnionRDD, _ColumnarSlice, _SortPartFn, _append, _extend, _identity,
    _join_values, _mk_list)
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
               "shard) read by a result stage: only a shuffle write "
               "streams in waves")
WIDE_REASON = ("more logical partitions (%d) than shards (%d): only an "
               "input above the wave threshold streams to spilled runs")
# not a fallback: a reduce stage over spilled runs reads them on the
# host (the export premerges and folds them), as the reference does
HOST_RUNS_READ = "spilled runs: the host export folds them"
CACHE_REASON = ("cached %s: the device result cache is not yet ported; "
                "its partitions cache on the host")
# the union source's declines (the reference records none: C19)
UNION_RESULT_REASON = ("union read by a result stage: its tasks index the "
                       "union's splits")
UNION_WIDE_REASON = "union of %d branches (the device takes 1..%d)"
UNION_BRANCH_REASON = "union branch %d: %s"
UNION_SPECS_REASON = "union branches disagree on the record type"
# why a.join(b) is not a device join source
JOIN_NARROW_REASON = ("join side %d is already partitioned like the join "
                      "(e.g. a reduceByKey output) and read narrowly: the "
                      "host merges it")
JOIN_HOST_REASON = "join side %d's shuffle output lives on the host"
JOIN_RUNS_REASON = "join side %d's shuffle output is spilled runs"
JOIN_WIDE_REASON = "join over %d partitions on %d shards"
JOIN_RECORD_REASON = ("join side %d's records are not (k, v) pairs with a "
                      "numeric scalar or flat-tuple key")
JOIN_KEY_REASON = "join sides' key widths or dtypes differ (%s vs %s)"
JOIN_LEAVES_REASON = "joined records of %d leaves (the kernel takes %d)"
JOIN_ENCODED_REASON = ("join side %d's keys are dictionary-encoded strings: "
                       "the host path compares the decoded keys")
JOIN_MIXED_REASON = "mixed encoded/plain join keys"
# a store whose keys are dictionary-encoded string ids (text ingest)
ENCODED_REASON = ("keys are dictionary-encoded string ids: only a plain "
                  "read (decoded at egest) rides the device")
TEXT_RESULT_REASON = ("text source read by a result stage: the host runs "
                      "the chain")
TEXT_RECORD_REASON = ("text chain records are not (str or int key, "
                      "numeric value) pairs")
TEXT_RANGE_REASON = "string keys have no range bounds"


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
    the user function (a nested accumulator sees its own shape).  The
    returned function carries its K14 programs (merge_program.program_for:
    `programs` by leaf signature, `route`)."""
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
    merged.route = None
    return merged


def probe_merge(merge, treedef, specs, nk):
    """The vmapped merge when it traces on the value specs and keeps
    their leaf count, else None.  The merge is lowered here, once, for
    the value specs (K14's program, or the reason it stays on the plain
    scan: merge_fn.route)."""
    try:
        merge_fn = _leaves_merge_fn(merge, treedef)
        sample = _sample(specs[nk:])
        out = merge_fn(sample, sample)
        if len(out) != len(specs) - nk:
            return None
    except Exception:        # user code: any failure means "not traceable"
        return None
    if out:
        merge_program.program_for(merge_fn, tuple(
            (layout.torch_dtype(dt), tuple(shape))
            for dt, shape in specs[nk:]))
    return merge_fn


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


class _IntInterval:
    """Exact integer interval for the ranged-int top key probe: the
    user's key expression runs once over per-column [min, max] intervals
    (Python ints: no wrap), and every intermediate checks its bounds
    against int64.  If the whole expression stays in range, int64
    arithmetic on the device provably never wraps and the device's key
    equals the host's exact Python int for every record (a corner check
    of the output alone would miss interior extremes such as x*(K-x)).
    Any operation outside +, -, *, // (by a positive divisor) and unary
    +/- raises and keeps the host path."""

    _LIMIT = 2 ** 63 - 1

    __slots__ = ("lo", "hi")

    def __init__(self, lo, hi):
        if abs(lo) > self._LIMIT or abs(hi) > self._LIMIT:
            raise OverflowError("interval exceeds int64")
        self.lo, self.hi = lo, hi

    @classmethod
    def _of(cls, other):
        if isinstance(other, _IntInterval):
            return other
        if isinstance(other, bool) or not isinstance(other, int):
            raise TypeError("non-int operand")
        return cls(other, other)

    def __add__(self, o):
        o = self._of(o)
        return _IntInterval(self.lo + o.lo, self.hi + o.hi)
    __radd__ = __add__

    def __sub__(self, o):
        o = self._of(o)
        return _IntInterval(self.lo - o.hi, self.hi - o.lo)

    def __rsub__(self, o):
        return self._of(o).__sub__(self)

    def __mul__(self, o):
        o = self._of(o)
        corners = [self.lo * o.lo, self.lo * o.hi,
                   self.hi * o.lo, self.hi * o.hi]
        return _IntInterval(min(corners), max(corners))
    __rmul__ = __mul__

    def __floordiv__(self, o):
        o = self._of(o)
        if o.lo <= 0:
            raise ValueError("floordiv needs a provably positive divisor")
        return _IntInterval(min(self.lo // o.lo, self.lo // o.hi),
                            max(self.hi // o.lo, self.hi // o.hi))

    def __neg__(self):
        return _IntInterval(-self.hi, -self.lo)

    def __pos__(self):
        return self


def _ranged_int_key_ok(key, treedef, specs, col_ranges):
    """True when the user's int key expression provably stays inside
    int64 over the batch's actual per-column value ranges (`col_ranges[i]`
    the exact (lo, hi) of leaf i, None for a leaf that is not an int
    scalar: reading it aborts the probe)."""
    if col_ranges is None or len(col_ranges) != len(specs):
        return False
    try:
        leaves = []
        for rng, (dt, shape) in zip(col_ranges, specs):
            if rng is None or shape != () or dt.kind != "i":
                return False
            leaves.append(_IntInterval(int(rng[0]), int(rng[1])))
        out = key(layout.tree_unflatten(treedef, leaves))
        return isinstance(out, _IntInterval)
    except Exception:        # user code: any failure means host path
        return False


def classify_top_key(key, treedef, specs, encoded=False, col_ranges=None):
    """How to compute each record's top() ordering key on the device:
    ("leaves", (i, ...)) for records compared as themselves (a scalar, or
    a tuple of numeric scalars, lexicographically in leaf order) or a
    provable ``x[i]`` subscript of a flat record, ("fn", key) for a traced
    key expression, None (host path).

    With dictionary-`encoded` string keys in leaf 0, only a subscript of
    a value leaf (index >= 1) qualifies: anything that reads leaf 0 would
    order by the raw ids.  A float key expression rides as it is; an
    integer one only with `col_ranges` (the batch's exact per-column
    (lo, hi), executor._int_col_ranges), when the interval probe proves
    no intermediate leaves int64: the host computes exact Python ints
    where the device would wrap."""
    nl = len(specs)
    if key is None:
        # a None inside a record makes Python's tuple compare raise
        if encoded or not _no_none(treedef) or any(
                shape != () or dt.kind not in "if" for dt, shape in specs):
            return None
        return ("leaves", tuple(range(nl)))
    idx = _subscript_const_index(key)
    if idx is not None:
        if not (0 <= idx < nl) or treedef != tuple(range(nl)):
            return None
        dt, shape = specs[idx]
        if shape != () or dt.kind not in "if" or (encoded and idx == 0):
            return None
        return ("leaves", (idx,))
    if encoded:
        return None
    try:
        fn = _row_fn(key, treedef)
        with python_float_semantics():
            out = vmap(fn)(*_sample(specs))
    except Exception:        # user code: any failure means host path
        return None
    if len(out) != 1 or out[0].dim() != 1:
        return None
    if out[0].dtype == torch.float64:
        return ("fn", key)
    if (out[0].dtype in (torch.int64, torch.int32)
            and _ranged_int_key_ok(key, treedef, specs, col_ranges)):
        return ("fn", key)
    return None


class SegAggOp:
    """groupByKey().mapValues(provable aggregate) consumed on the device:
    the no-combine reduce leaves each shard's rows key-sorted with the
    valid prefix first, so one K3 pass merges each run of equal keys
    into one (k, agg) row — the (k, [v]) lists never materialize.

    REQUIRES key-sorted valid-prefix input: analyze_stage installs it
    only as ops[0] of a no-combine "hbm"-source plan, whose reduce side
    (executor._exchange_sorted) sorts rows by key before the ops run.

    Output dtypes follow the host: count -> int64; int sum/mean -> int64
    / float64 (exact int64 sums, true division); float values keep their
    width (K3 folds float32 in float64 and narrows back).  Float NaN
    caveat: NaN values are treated as absent for min/max (the host
    fold's result for a NaN-bearing group depends on arrival order), as
    in the reference."""

    def __init__(self, kind):
        self.kind = kind
        self.nk = 1

    def probe(self, treedef, specs):
        nk = layout.key_width(treedef, specs, kinds="if")
        if nk is None or len(specs) != nk + 1:
            raise TypeError("segagg needs flat (k, v) records (scalar "
                            "or flat-tuple key, one scalar value)")
        self.nk = nk
        vdt, vshape = specs[nk]
        if vshape != ():
            raise TypeError("segagg needs a scalar value")
        if vdt.kind not in "if" or any(dt.kind not in "if"
                                       for dt, _ in specs[:nk]):
            raise TypeError("segagg needs numeric key and value")
        if any(dt.kind != "i" for dt, _ in specs[:nk]):
            # a hash shuffle only stores int keys, so none arrive here
            raise TypeError("segagg over float keys: K3 merges int keys")
        if self.kind == "count":
            odt = np.dtype(np.int64)
        elif self.kind == "mean":
            odt = np.dtype(np.float64) if vdt.kind == "i" else vdt
        elif self.kind == "sum" and vdt.kind == "i":
            odt = np.dtype(np.int64)
        else:
            odt = vdt
        self._odt = layout.torch_dtype(odt)
        return treedef, list(specs[:nk]) + [(odt, ())]

    def apply(self, leaves, n):
        from dpark_tpu_torch.backend.cuda import collectives, kernels
        nk, kind = self.nk, self.kind
        keys, v = [k.contiguous() for k in leaves[:nk]], leaves[nk]
        if kind == "count":
            vals = [torch.ones(v.shape, dtype=torch.int64, device=v.device)]
        else:
            wide = torch.float64 if v.is_floating_point() else torch.int64
            vals = [v.to(wide)]
            if kind in ("min", "max") and v.is_floating_point():
                ident = float("inf") if kind == "min" else float("-inf")
                vals = [torch.where(torch.isnan(vals[0]), ident, vals[0])]
            if kind == "mean":
                vals.append(torch.ones(v.shape, dtype=torch.int64,
                                       device=v.device))
        op = {"min": "min", "max": "max"}.get(kind, "add")
        fills = [collectives._sentinel(k.dtype) for k in keys]
        k_out, v_out, n_out, _, _ = kernels.reduce_by_key_compact(
            keys, fills, [x.contiguous() for x in vals], n, op)
        agg = v_out[0]
        if kind == "mean":
            agg = agg.to(torch.float64) / torch.clamp(v_out[1], min=1)
        return list(k_out) + [agg.to(self._odt)], n_out


def _seg_row_fn(f):
    """The user's per-group function as (B,) tensor -> tuple of scalar
    leaves; the output treedef is discovered at trace time."""
    def fn(vs):
        leaves, treedef = layout.tree_flatten(f(vs))
        fn.out_treedef = treedef
        return tuple(_as_leaf(x, vs.device) for x in leaves)
    return fn


def _seg_state_row_fns(update):
    """The user's update(values, prev) as two leaf functions: one traced
    with a prev scalar, one with the literal None (so ``if prev is None``
    branches as on the host path)."""
    def with_prev(vs, p):
        leaves, treedef = layout.tree_flatten(update(vs, p))
        with_prev.out_treedef = treedef
        return tuple(_as_leaf(x, vs.device) for x in leaves)

    def without_prev(vs):
        leaves, treedef = layout.tree_flatten(update(vs, None))
        without_prev.out_treedef = treedef
        return tuple(_as_leaf(x, vs.device) for x in leaves)
    return with_prev, without_prev


def _seg_pad_cases(vdt, rng):
    """Deterministic sample value vectors for the padding-invariance
    check: small/large, all-negative, all-positive, zeros — the shapes
    that defeat a wrong fill (0 is NOT neutral for max over negatives;
    repeating the last row is NOT neutral for sums)."""
    sizes = (1, 2, 3, 5, 7, 12)
    cases = []
    for s in sizes:
        if np.dtype(vdt).kind == "i":
            draws = [rng.randint(-1000, 1000, size=s),
                     -rng.randint(1, 1000, size=s),
                     rng.randint(1, 1000, size=s),
                     np.zeros(s, np.int64)]
        else:
            draws = [(rng.standard_normal(s) * 100),
                     -np.abs(rng.standard_normal(s) * 100) - 1,
                     np.abs(rng.standard_normal(s) * 100) + 1,
                     np.zeros(s)]
        cases.extend(np.asarray(d, vdt) for d in draws)
    return cases


def _pad_vec(v, pad, width, vdt):
    """v padded to `width` with the strategy's fill."""
    fill = (v[-1] if (pad == "edge" and len(v)) else np.dtype(vdt).type(0))
    return np.concatenate([v, np.full(width - len(v), fill, vdt)])


def _seg_leaves_close(a_leaves, b_leaves):
    """Equality for the padding-invariance check.  Floats compare at
    1e-3 rel+abs: a wrong fill or a length-dependent result is off by
    O(1) relative, while rounding between the host's list fold and the
    tensor fold is ~1e-7 (float32) or less."""
    for a, b in zip(a_leaves, b_leaves):
        a = np.asarray(a)
        b = np.asarray(b)
        if a.shape != b.shape:
            return False
        if a.dtype.kind == "f" or b.dtype.kind == "f":
            if not np.allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64),
                               rtol=1e-3, atol=1e-3, equal_nan=True):
                return False
        elif not np.array_equal(a, b):
            return False
    return True


# classification runs ~150 tiny eager calls of the user function: memoize
# per (function, value dtype).  The entry pins the function, so a
# recycled id never serves another function a stale verdict.
_SEG_CLASS_CACHE = {}
SEG_PAD_STRATEGIES = ("zero", "edge")


def classify_seg_map(f, vdt, state=False):
    """Admission for the device segmented apply: is `f` a traceable,
    padding-invariant per-group function?  With `state`, f is
    updateStateByKey's update(values, prev), traced and checked with a
    prev scalar and with None, and must return one scalar.

    Returns (pad, out_vdef, out_specs) — pad in SEG_PAD_STRATEGIES,
    out_vdef the output value treedef, out_specs its scalar leaf specs —
    or (None, reason, None).

    Two obligations, both checked here:
      * f traces under torch.func.vmap over a 1-D value row (widths 4
        and 8; the output leaf specs must not depend on the width);
      * f is PADDING-INVARIANT under one fill: the device pads each
        group to its power-of-two size class, so f(padded) must equal
        f(exact) — verified concretely on seeded sample vectors padded
        to 1x and 2x the class width, against the host call form
        f(list), so the list -> tensor change is covered by the same
        check.  Sum-like functions pass "zero", order statistics
        (max - min) pass "edge" (repeat-last); anything needing the true
        group length fails both and keeps the host path."""
    ck = (id(f), bool(state), str(np.dtype(vdt)))
    hit = _SEG_CLASS_CACHE.get(ck)
    if hit is not None and hit[0] is f:
        return hit[1]
    out = _classify_seg_map(f, np.dtype(vdt), state)
    if len(_SEG_CLASS_CACHE) >= 512:
        _SEG_CLASS_CACHE.pop(next(iter(_SEG_CLASS_CACHE)))
    _SEG_CLASS_CACHE[ck] = (f, out)
    return out


def _out_specs(outs):
    return [(layout.numpy_dtype(o.dtype), tuple(o.shape[1:])) for o in outs]


def _classify_seg_map(f, vdt, state=False):
    tdt = layout.torch_dtype(vdt)

    def specs_at(width):
        vs = torch.ones((2, width), dtype=tdt)
        if state:
            fn_p, fn_n = _seg_state_row_fns(f)
            with python_float_semantics():
                sp = _out_specs(vmap(fn_p)(vs, torch.ones((2,), dtype=tdt)))
                sn = _out_specs(vmap(fn_n)(vs))
            if sp != sn or fn_p.out_treedef != fn_n.out_treedef:
                raise TypeError("update(values, prev) and update(values, "
                                "None) disagree on the output spec")
            return sp, fn_p.out_treedef
        fn = _seg_row_fn(f)
        with python_float_semantics():
            outs = vmap(fn)(vs)
        return _out_specs(outs), fn.out_treedef

    try:
        s4, vdef4 = specs_at(4)
        s8, vdef8 = specs_at(8)
    except Exception as e:   # user code: any failure means host path
        return (None, "per-group function is not traceable (%s: %s)"
                % (type(e).__name__, str(e)[:160]), None)
    if s4 != s8 or vdef4 != vdef8:
        return (None, "per-group function output depends on the "
                "padded width", None)
    if not s4:
        return (None, "per-group function returns no leaves", None)
    for dt, shape in s4:
        if shape != () or dt.kind not in "if":
            return (None, "per-group function output is not a pytree "
                    "of numeric scalars", None)
    if state and len(s4) != 1:
        return (None, "state update must produce one scalar state leaf",
                None)

    # -- concrete padding-invariance verification -------------------
    cases = _seg_pad_cases(vdt, np.random.RandomState(0x5E90))
    # the host path passes prev as the Python number its update returned
    prevs = [None]
    if state:
        prevs = [None, np.dtype(vdt).type(3).item(),
                 np.dtype(vdt).type(-7).item()]

    def call(vs, prev, as_list):
        arg = (list(np.asarray(vs).tolist()) if as_list
               else torch.as_tensor(vs))
        with python_float_semantics():
            if not state:
                return layout.tree_flatten(f(arg))
            if prev is not None and not as_list:
                prev = torch.tensor(prev, dtype=tdt)
            return layout.tree_flatten(f(arg, prev))

    for pad in SEG_PAD_STRATEGIES:
        try:
            ok = True
            for v in cases:
                b = 1 << max(0, int(len(v) - 1).bit_length())
                for prev in prevs:
                    base, bdef = call(v, prev, as_list=True)
                    if bdef != vdef4 or not all(_seg_leaves_close(
                            base, call(_pad_vec(v, pad, width, vdt), prev,
                                       as_list=False)[0])
                            for width in (b, 2 * b)):
                        ok = False
                        break
                if not ok:
                    break
            if ok and state:
                # a key held only in the carried state: the host calls
                # update([], prev), the device sees an all-fill row
                for prev in prevs[1:]:
                    base, _ = call(np.zeros(0, vdt), prev, as_list=True)
                    if not all(_seg_leaves_close(base, call(
                            np.zeros(width, vdt), prev, as_list=False)[0])
                            for width in (1, 2, 4)):
                        ok = False
                        break
        except Exception:    # user code
            ok = False
        if ok:
            return (pad, vdef4, s4)
    return (None, "per-group function is not padding-invariant "
            "(its result needs the true group length; zero-fill and "
            "repeat-last fills both change it)", None)


class SegMapOp:
    """Device segmented apply: groupByKey().mapValues(f) with a traceable,
    padding-invariant per-group f consumed on the device.  The group
    lists never materialize: K7 splits the key-sorted rows into segments
    and sorts their sizes into power-of-two classes, K2 lists each
    class's members, K8 gathers each class's groups into a padded
    (N*G, B) matrix (the admission-verified fill past each group's
    size), torch.func.vmap applies f across its rows, and K8 scatters the
    results back to the segment ids.  Output rows are (key, f(group)) in
    key order; the rest of the chain (and any shuffle write) continues on
    the device.

    REQUIRES key-sorted valid-prefix input, like SegAggOp: the executor's
    _run_seg_map feeds it the exchange-sorted batch and sets `table` (K7's
    output for that batch) and `layout` ((class, width, G) per non-empty
    class, from K7's histogram) before the ops run.

    state_mode (updateStateByKey's general update): the records are (k,
    (v, flag)), flag 1 the carried state row (at most one a key), flag 0
    a new value; `f` is the user's update(values, prev), traced twice
    (with a prev scalar, and with None), and K8's state gather hands it
    each group's new values compacted to the front, the carried value and
    whether there is one."""

    state_mode = False

    def __init__(self, f, pad):
        self.f = f
        self.pad = pad
        self.nk = 1
        self.layout = None
        self.table = None

    def probe(self, treedef, specs):
        nk = layout.key_width(treedef, specs, kinds="if")
        nv = 2 if self.state_mode else 1
        if nk is None or len(specs) != nk + nv:
            raise TypeError("seg_map needs flat (k, v) records (scalar "
                            "or flat-tuple key, one scalar value)")
        self.nk = nk
        vdt, vshape = specs[nk]
        if vshape != () or vdt.kind not in "if":
            raise TypeError("seg_map needs a scalar numeric value")
        if self.state_mode and tuple(specs[nk + 1]) != (
                np.dtype(np.int64), ()):
            raise TypeError("state mode needs an int64 scalar flag")
        pad, vdef_or_reason, out_specs = classify_seg_map(
            self.f, vdt, state=self.state_mode)
        if pad is None:
            raise TypeError(vdef_or_reason)
        self.pad = pad
        if self.state_mode:
            self._fns = _seg_state_row_fns(self.f)
        else:
            self._fn = _seg_row_fn(self.f)
        self._out_dtypes = [layout.torch_dtype(dt) for dt, _ in out_specs]
        out_treedef = (treedef[0], layout._renumber(vdef_or_reason, nk))
        return out_treedef, list(specs[:nk]) + list(out_specs)

    def apply(self, leaves, n):
        from dpark_tpu_torch.backend.cuda import collectives
        assert self.layout is not None and self.table is not None, \
            "the executor sets the segment table and layout (_run_seg_map)"
        nk = self.nk
        vcol = leaves[nk]
        start_rows, sizes, bucket, n_seg, _, keys = self.table
        self.table = None
        members, counts, offsets = collectives.bucket_members(bucket)
        N, cap = vcol.shape
        outs = [torch.zeros((N, cap), dtype=dt, device=vcol.device)
                for dt in self._out_dtypes]
        for b, width, G in self.layout:
            if self.state_mode:
                lanes = (torch.arange(G, device=vcol.device)[None, :]
                         < counts[:, b][:, None])
                res = self._apply_state(collectives.gather_bucket_state(
                    start_rows, sizes, members, offsets, counts, b, G,
                    width, vcol, leaves[nk + 1], self.pad), lanes, width)
            else:
                vals = collectives.gather_bucket_groups(
                    start_rows, sizes, members, offsets, counts, b, G,
                    width, vcol, self.pad)
                with python_float_semantics():
                    res = vmap(self._fn)(vals.view(N * G, width))
            res = [r.reshape(N, G).to(dt)
                   for r, dt in zip(res, self._out_dtypes)]
            collectives.scatter_bucket_groups(outs, res, members, offsets,
                                              counts, b)
        return list(keys) + outs, n_seg

    def _apply_state(self, gathered, lanes, width):
        """update(new values, prev) where the group has a carried row,
        update(new values, None) where it has none; a trace no valid
        lane (`lanes`, (N, G) bool) needs is skipped (one host read a
        class)."""
        vals, prev, has_prev = gathered
        fn_p, fn_n = self._fns
        n = lanes.numel()
        vals = vals.view(n, width)
        has = has_prev.view(n)
        need_p, need_n = torch.stack([(has_prev & lanes).any(),
                                      (~has_prev & lanes).any()]).tolist()
        with python_float_semantics():
            with_p = vmap(fn_p)(vals, prev.view(n)) if need_p else None
            without = vmap(fn_n)(vals) if need_n or not need_p else None
        if with_p is None:
            return list(without)
        if without is None:
            return list(with_p)
        return [torch.where(has, p, q.to(p.dtype))
                for p, q in zip(with_p, without)]


def _try_seg_map(f0, meta):
    """(SegMapOp or None, host-path reason or None) for a groupByKey
    consumer that is not a provable aggregate: the conf gate, the value
    shape, traceability + padding invariance (classify_seg_map).  The
    port runs eagerly, so it has no per-bucket compile cost to guard as
    the reference's DPARK_SEG_MIN_ROWS_PER_TRACE does."""
    # dstream's updateStateByKey rewrite marks its per-group consumer
    state_update = getattr(f0, "__dpark_seg_state__", None)
    if not conf.SEG_MAP:
        return None, "grouped consumer stays on host: DPARK_SEG_MAP=0"
    treedef, specs = meta["out_treedef"], meta["out_specs"]
    nk = layout.key_width(treedef, specs, kinds="if")
    nv = 2 if state_update is not None else 1
    if nk is None or len(specs) != nk + nv or specs[nk][1] != () \
            or np.dtype(specs[nk][0]).kind not in "if":
        return None, ("unsupported value pytree for grouped "
                      "consumption (seg_map needs a single scalar "
                      "numeric value per record)")
    fn = state_update if state_update is not None else f0
    pad, reason_or_vdef, _ = classify_seg_map(
        fn, specs[nk][0], state=state_update is not None)
    if pad is None:
        return None, reason_or_vdef
    op = SegMapOp(fn, pad)
    op.state_mode = state_update is not None
    return op, None


def _seg_op(ops, meta):
    """(segment op, None) when ops[0] is a mapValues the device runs over
    the key-sorted rows of a no-combine shuffle (`meta`): a provable
    aggregate (SegAggOp) or a traceable, padding-invariant function
    (SegMapOp); else (None, the reason or None)."""
    f0 = getattr(ops[0], "mapvalue_f", None) if ops else None
    if f0 is None:
        return None, None
    kind = _monoid.classify_segagg(f0)
    if kind is not None:
        return SegAggOp(kind), None
    return _try_seg_map(f0, meta)


class StagePlan:
    """Everything needed to run one stage on the tensor path."""

    def __init__(self, source, ops, epilogue, in_treedef, in_specs,
                 out_treedef, out_specs, stage):
        self.source = source        # ("ingest", pc) | ("hbm", dep) |
        #                             ("join", (dep_a, dep_b)) |
        #                             ("text", text_rdd) |
        #                             ("union", (branch sub-plans))
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
        # more logical partitions than shards: the input streams to
        # spilled runs (admitted only above the wave threshold)
        self.logical_spill = False
        self.merge_probe = None     # executor._merge_probe's memo
        # a text source: the narrow chain (root -> top) the host runs per
        # split, whether string keys are dictionary-encoded to int64 ids,
        # and the canonical wordcount's separator (None: whitespace)
        self.text_chain = None
        self.encoded_keys = False
        self.canonical = False
        self.canonical_sep = None
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


def is_join(rdd):
    """a.join(b): the join's flatMapValue over a two-way cogroup."""
    return (isinstance(rdd, FlatMappedValuesRDD) and rdd.f is _join_values
            and isinstance(rdd.prev, CoGroupedRDD) and len(rdd.prev.rdds) == 2)


def _device_cached(rdd, store):
    """Whether the tensor path reads through the cached `rdd`: the host
    cache does not hold its partitions, and its narrow chain ends at a
    shuffle output kept on the device (`store`) and not spilled to host
    runs, which holds its data (the device result cache, ROADMAP A19, is
    not ported)."""
    if store is None or rdd.ctx.cache.holds(rdd.id, len(rdd.splits)):
        return False
    cur = rdd
    while not isinstance(cur, ShuffledRDD):
        if isinstance(cur, (MappedValuesRDD, KeyedRDD, MappedRDD,
                            FilteredRDD)) or (
                isinstance(cur, FlatMappedValuesRDD)
                and cur.f is _identity) or (
                isinstance(cur, MapPartitionsRDD)
                and isinstance(cur.f, _SortPartFn)):
            cur = cur.prev
        else:
            return False
    meta = store.get(cur.dep.shuffle_id)
    return meta is not None and "host_runs" not in meta


def extract_chain(top, store=None):
    """Walk narrow one-parent links from the stage's top RDD to its
    source.  Returns (source_rdd, ops root->top, passthrough); the
    source is where the walk stopped: an input, a shuffle, an a.join(b),
    a cached RDD the device does not read through (_device_cached over
    the shuffle `store`), or an RDD with no op form (analyze_stage
    decides).  passthrough: partitionBy's flatMapValue(identity) over a
    no-combine shuffle, whose rows then pass through flat."""
    ops = []
    cur = top
    passthrough = False
    while True:
        if is_join(cur) or (cur.should_cache
                            and not _device_cached(cur, store)):
            ops.reverse()
            return cur, ops, passthrough
        if (isinstance(cur, FlatMappedValuesRDD) and cur.f is _identity
                and isinstance(cur.prev, ShuffledRDD)
                and is_list_agg(cur.prev.aggregator)):
            passthrough = True
        elif isinstance(cur, MapPartitionsRDD) \
                and isinstance(cur.f, _SortPartFn):
            ops.append(SortOp(cur.f.ascending))
        elif isinstance(cur, MappedValuesRDD):
            op = MapOp(_mapvalue_as_record_fn(cur.f))
            op.mapvalue_f = cur.f    # analyze may consume f as a seg op
            ops.append(op)
        elif isinstance(cur, KeyedRDD):
            ops.append(MapOp(_keyby_as_record_fn(cur.f)))
        elif isinstance(cur, MappedRDD):
            ops.append(MapOp(cur.f))
        elif isinstance(cur, FilteredRDD):
            ops.append(FilterOp(cur.f))
        else:
            ops.reverse()
            return cur, ops, passthrough
        cur = cur.prev


def _sample_record(pc):
    for s in pc._slices:
        if s:
            return s[0]
    return None


def _columnar_row_bytes(slices):
    """Bytes of one record across a slice's columns, a column of shape
    (n, w...) counting its itemsize times its trailing shape."""
    for s in slices:
        cols = getattr(s, "columns", None)
        if cols is not None and len(s):
            return sum(np.asarray(c).dtype.itemsize
                       * int(np.prod(np.asarray(c).shape[1:]))
                       for c in cols)
    return 16


def _wave_limit(pc, device, ndev):
    """The wave budget (rows per shard) of a columnar input, or None for
    an input that cannot stream.  The ndev shards share the card, so
    each gets 1/ndev of its budget."""
    slices = pc._slices
    if not all(isinstance(s, _ColumnarSlice) for s in slices):
        return None
    return conf.stream_chunk_rows(_columnar_row_bytes(slices), device,
                                  ndev)


def _wave_rows(pc, device, ndev, reslice, limit=None):
    """The wave budget a columnar input exceeds, or None: `limit`
    (_wave_limit's when not given).  Rows are counted as the shards
    hold them, after executor._reslice_parts when the stage
    re-slices."""
    if limit is None:
        limit = _wave_limit(pc, device, ndev)
    if limit is None:
        return None
    slices = pc._slices
    if reslice:
        rows = -(-sum(len(s) for s in slices) // ndev)
    else:
        rows = max((len(s) for s in slices), default=0)
    return limit if rows > limit else None


def joined_treedef(ta, tb):
    """The (k, (va, vb)) treedef of a join of (k, va) and (k, vb)
    records: A's key leaves, then A's value leaves, then B's."""
    sa = layout.tree_unflatten(ta, list(range(layout.num_leaves(ta))))
    sb = layout.tree_unflatten(tb, list(range(layout.num_leaves(tb))))
    return layout.tree_flatten((sa[0], (sa[1], sb[1])))[1]


def _analyze_join_source(join_rdd, ndev, store, allow_encoded=False):
    """((treedef, specs, (dep_a, dep_b)), None) when both inputs of the
    a.join(b) cogroup are device-resident no-combine shuffles (a shuffled
    cogroup input always is one) of (k, v) records with keys of one width
    and dtypes, over at most ndev partitions; else (None, reason).

    Encoded string ids must not feed further device ops, so a join over
    an encoded store is no stage source; the host stage's precompute
    (`allow_encoded`) may still expand it on the device when both sides
    are encoded (one token dict: id equality is string equality), and
    decodes at the exit."""
    cg = join_rdd.prev
    deps = []
    for si, (kind, obj) in enumerate(cg._dep_kinds):
        if kind != "shuffle":
            return None, JOIN_NARROW_REASON % si
        deps.append(obj)
    r = cg.partitioner.num_partitions
    if r > ndev:
        return None, JOIN_WIDE_REASON % (r, ndev)
    metas, sigs = [], []
    for si, dep in enumerate(deps):
        if dep.shuffle_id not in store:
            return None, JOIN_HOST_REASON % si
        meta = store[dep.shuffle_id]
        if "host_runs" in meta:
            return None, JOIN_RUNS_REASON % si
        if meta.get("encoded_keys") and not allow_encoded:
            return None, JOIN_ENCODED_REASON % si
        treedef, specs = meta["out_treedef"], meta["out_specs"]
        nk = layout.key_width(treedef, specs, kinds="if")
        if nk is None or len(treedef) != 2 or len(specs) < nk + 1:
            return None, JOIN_RECORD_REASON % si
        metas.append(meta)
        sigs.append((nk, tuple(str(np.dtype(dt)) for dt, _ in specs[:nk])))
    if bool(metas[0].get("encoded_keys")) != bool(
            metas[1].get("encoded_keys")):
        return None, JOIN_MIXED_REASON
    if sigs[0] != sigs[1]:
        return None, JOIN_KEY_REASON % (sigs[0], sigs[1])
    nk = sigs[0][0]
    specs = (list(metas[0]["out_specs"])
             + list(metas[1]["out_specs"][nk:]))
    if len(specs) > kernels.MAX_LEAVES:
        return None, JOIN_LEAVES_REASON % (len(specs), kernels.MAX_LEAVES)
    treedef = joined_treedef(metas[0]["out_treedef"],
                             metas[1]["out_treedef"])
    return (treedef, specs, (deps[0], deps[1])), None



# ----------------------------------------------------------------------
# text-source stages: the narrow chain over a text file is string-typed
# and untraceable, so it runs as a host prologue per split (the user's own
# generators), string keys are dictionary-encoded to int64 ids, and the
# shuffle write and combine run on the device.  The canonical wordcount
# chain runs the C++ tokenizer instead, verified against the user's
# functions on each run.
# ----------------------------------------------------------------------
def extract_text_chain(top):
    """(text source, chain root -> top) of one-parent narrow links ending
    at a text file, or None (another source, or a cached link: its
    partitions cache on the host)."""
    chain = []
    cur = top
    while True:
        if cur.should_cache:
            return None
        if isinstance(cur, TextFileRDD):
            chain.reverse()
            return cur, chain
        if not isinstance(cur, DerivedRDD):
            return None
        chain.append(cur)
        cur = cur.prev


def _code_matches(f, template):
    """f is a closure-free function with the template's bytecode."""
    code = getattr(f, "__code__", None)
    if code is None or getattr(f, "__closure__", None):
        return False
    t = template.__code__
    return (code.co_code == t.co_code
            and code.co_consts == t.co_consts
            and code.co_names == t.co_names
            and code.co_argcount == t.co_argcount)


def _is_whitespace_split(f):
    # 'split' in the template is an attribute load on the argument, not
    # a global: bytecode equality is sufficient
    return f is str.split or _code_matches(f, lambda line: line.split())


def _const_split_sep(f):
    """The separator when f is exactly `lambda line: line.split(SEP)` with
    a single-byte ASCII constant (not \\n or \\r), else None.  Only the
    string constant may differ from the template's: it is extracted, not
    assumed."""
    code = getattr(f, "__code__", None)
    if code is None or getattr(f, "__closure__", None):
        return None
    t = (lambda line: line.split("\x00")).__code__
    if not (code.co_code == t.co_code
            and code.co_names == t.co_names
            and code.co_argcount == t.co_argcount):
        return None
    strs = [c for c in code.co_consts if isinstance(c, str)]
    others = [c for c in code.co_consts if not isinstance(c, str)]
    t_others = [c for c in t.co_consts if not isinstance(c, str)]
    if len(strs) != 1 or others != t_others:
        return None
    sep = strs[0]
    if len(sep) == 1 and ord(sep) < 0x80 and sep not in "\n\r":
        return sep
    return None


def _is_pair_one(f):
    return _code_matches(f, lambda w: (w, 1))


def canonical_wordcount(chain):
    """The separator when chain is exactly flatMap(split) -> map(w -> (w,
    1)): "" for a whitespace split, a 1-character string for a
    constant-separator split, None otherwise."""
    if len(chain) != 2:
        return None
    fm, mp = chain
    if not (isinstance(fm, FlatMappedRDD) and isinstance(mp, MappedRDD)
            and _is_pair_one(mp.f)):
        return None
    if _is_whitespace_split(fm.f):
        return ""
    return _const_split_sep(fm.f)


def _sample_text_record(top):
    """The first record of the chain, from the first non-empty of its
    first eight splits (memoized on the RDD)."""
    if hasattr(top, "_text_sample"):
        return top._text_sample
    sample = None
    for sp in top.splits[:8]:
        it = top.iterator(sp)
        try:
            for rec in it:
                sample = rec
                break
        finally:
            close = getattr(it, "close", None)
            if close:
                close()
        if sample is not None:
            break
    top._text_sample = sample
    return sample


def _big_text(stage):
    """A text source above conf.STREAM_TEXT_BYTES streams in waves of
    splits."""
    return (sum(max(0, sp.end - sp.begin) for sp in stage.rdd.splits)
            > conf.STREAM_TEXT_BYTES)


def analyze_text_stage(stage, ndev):
    """(StagePlan, None) for a shuffle-map stage whose narrow chain reads a
    text file and yields (str or int key, numeric value) records: a
    ("text", text_rdd) source whose host prologue feeds the device shuffle
    write; (None, reason) for a text chain the device does not take;
    (None, None) when the chain reads no text file."""
    extracted = extract_text_chain(stage.rdd)
    if extracted is None:
        return None, None
    if not stage.is_shuffle_map:
        return None, TEXT_RESULT_REASON
    text_rdd, chain = extracted
    dep = stage.shuffle_dep
    spec = partitioner_spec(dep.partitioner)
    sample = _sample_text_record(stage.rdd)
    if not (isinstance(sample, tuple) and len(sample) == 2):
        return None, TEXT_RECORD_REASON
    k, v = sample
    key_is_str = isinstance(k, str)
    if not key_is_str and (isinstance(k, bool) or not isinstance(
            k, (int, np.integer))):
        return None, TEXT_RECORD_REASON
    if key_is_str and spec is not None and spec[0] != "hash":
        return None, TEXT_RANGE_REASON
    try:
        treedef, specs = layout.record_spec((0, v))
    except TypeError:
        return None, TEXT_RECORD_REASON
    plan = StagePlan(("text", text_rdd), [], None, treedef, specs, treedef,
                     specs, stage)
    plan.text_chain = chain
    plan.encoded_keys = key_is_str
    sep = canonical_wordcount(chain) if key_is_str else None
    plan.canonical = sep is not None
    plan.canonical_sep = sep or None      # "" (whitespace) -> None
    reason = _plan_shuffle_write(plan, dep, ndev, _big_text(stage))
    if reason is not None:
        return None, reason
    return plan, None


def _analyze_union_parent(parent, ndev, executor, stage):
    """(sub-plan, None) turning one union branch into a device Batch of
    its post-ops rows (a plan without an epilogue), or (None, reason).
    A branch is an input below the wave threshold, or a shuffle output
    kept on the device: combining (its reduce side merges), no-combine
    read through partitionBy's passthrough, or consumed by a segment op
    (SegAggOp / SegMapOp, e.g. updateStateByKey's carried state, which
    the reference reads from its device result cache)."""
    store = executor.shuffle_store
    src_rdd, ops, passthrough = extract_chain(parent, store)
    src_merge = None
    src_nk = 1
    reslice = False
    if src_rdd.should_cache and not _device_cached(src_rdd, store):
        return None, CACHE_REASON % type(src_rdd).__name__
    if isinstance(src_rdd, ParallelCollection):
        reslice = len(src_rdd._slices) != ndev
        wave = _wave_rows(src_rdd, executor.device, ndev, reslice)
        if wave is not None:
            # a branch materializes whole: only a shuffle input streams
            return None, ("columnar input above the wave threshold (%d "
                          "rows per shard)" % wave)
        sample = _sample_record(src_rdd)
        if sample is None:
            return None, "empty input"
        try:
            treedef, specs = layout.record_spec(sample)
        except TypeError as e:
            return None, "record has no tensor form (%s)" % e
        source = ("ingest", src_rdd)
    elif isinstance(src_rdd, ShuffledRDD):
        dep = src_rdd.dep
        if dep.shuffle_id not in store:
            return None, "parent shuffle output lives on the host"
        if dep.partitioner.num_partitions > ndev:
            return None, WIDE_REASON % (dep.partitioner.num_partitions,
                                        ndev)
        meta = store[dep.shuffle_id]
        if "host_runs" in meta:
            return None, HOST_RUNS_READ
        if meta.get("encoded_keys"):
            return None, ENCODED_REASON
        treedef, specs = meta["out_treedef"], meta["out_specs"]
        src_nk = meta["key_cols"]
        if meta["no_combine"]:
            if not passthrough:
                seg, reason = _seg_op(ops, meta)
                if seg is None:
                    return None, reason or GROUP_REASON
                ops[0] = seg
        else:
            src_merge = probe_merge(dep.aggregator.merge_combiners, treedef,
                                    specs, src_nk)
            if src_merge is None:
                return None, ("merge_combiners not traceable by "
                              "torch.func.vmap; object path")
        source = ("hbm", dep)
    else:
        return None, ("%s has no tensor form as a union branch"
                      % type(src_rdd).__name__)
    cur_treedef, cur_specs = treedef, specs
    try:
        for op in ops:
            cur_treedef, cur_specs = op.probe(cur_treedef, cur_specs)
    except Exception as e:   # user code: any failure means host path
        return None, ("user function not traceable by torch.func.vmap "
                      "(%s: %s)" % (type(e).__name__, str(e)[:120]))
    sub = StagePlan(source, ops, None, treedef, specs, cur_treedef,
                    cur_specs, stage)
    sub.src_nk = src_nk
    sub.src_merge = src_merge
    sub.reslice = reslice
    return sub, None


def _analyze_union(union_rdd, ndev, executor, stage):
    """((treedef, specs, sub-plans), None) for a union of 1..12 branches
    that all have a device form and agree on the record type, else (None,
    reason)."""
    if not stage.is_shuffle_map:
        return None, UNION_RESULT_REASON
    parents = union_rdd.rdds
    if not 1 <= len(parents) <= kernels.MAX_UNION_BRANCHES:
        return None, UNION_WIDE_REASON % (len(parents),
                                          kernels.MAX_UNION_BRANCHES)
    subs = []
    for i, p in enumerate(parents):
        sub, reason = _analyze_union_parent(p, ndev, executor, stage)
        if sub is None:
            return None, UNION_BRANCH_REASON % (i, reason)
        subs.append(sub)
    t0 = subs[0].out_treedef
    s0 = [(str(np.dtype(dt)), tuple(shape)) for dt, shape in
          subs[0].out_specs]
    for sub in subs[1:]:
        if sub.out_treedef != t0 or s0 != [
                (str(np.dtype(dt)), tuple(shape))
                for dt, shape in sub.out_specs]:
            return None, UNION_SPECS_REASON
    return (t0, list(subs[0].out_specs), tuple(subs)), None


def analyze_stage(stage, ndev, executor):
    """(StagePlan, None) when `stage` can run on the tensor path, else
    (None, reason)."""
    store = executor.shuffle_store
    source_rdd, ops, passthrough = extract_chain(stage.rdd, store)
    src_nk = 1
    src_merge = None
    group_output = False
    reslice = False
    wave = None
    if source_rdd.should_cache and not _device_cached(source_rdd, store):
        return None, CACHE_REASON % type(source_rdd).__name__
    if isinstance(source_rdd, ParallelCollection):
        if not stage.is_shuffle_map and not ops:
            return None, "plain read of the input: no device work"
        reslice = len(source_rdd._slices) != ndev
        if reslice and not stage.is_shuffle_map:
            return None, ("result stage over %d input slices on %d "
                          "shards" % (len(source_rdd._slices), ndev))
        # above the wave threshold a shuffle write streams (the executor
        # reads the same predicate); a result stage takes the host path
        wave = _wave_rows(source_rdd, executor.device, ndev, reslice)
        if wave is not None and not stage.is_shuffle_map:
            return None, WAVE_REASON % wave
        sample = _sample_record(source_rdd)
        if sample is None:
            return None, "empty input"
        try:
            treedef, specs = layout.record_spec(sample)
        except TypeError as e:
            return None, "record has no tensor form (%s)" % e
        source = ("ingest", source_rdd)
    elif is_join(source_rdd):
        joined, reason = _analyze_join_source(source_rdd, ndev, store)
        if joined is None:
            return None, reason
        treedef, specs, deps = joined
        source = ("join", deps)
    elif isinstance(source_rdd, UnionRDD):
        union, reason = _analyze_union(source_rdd, ndev, executor, stage)
        if union is None:
            return None, reason
        treedef, specs, subs = union
        source = ("union", subs)
    elif not isinstance(source_rdd, ShuffledRDD):
        plan, reason = analyze_text_stage(stage, ndev)
        if plan is not None:
            return plan, None
        return None, reason or ("%s has no tensor form yet; object path"
                                % type(source_rdd).__name__)
    else:
        dep = source_rdd.dep
        if dep.shuffle_id not in store:
            return None, "parent shuffle output lives on the host"
        meta = store[dep.shuffle_id]
        if meta.get("encoded_keys") and (ops or stage.is_shuffle_map):
            # the host path sees decoded rows through the export bridge
            return None, ENCODED_REASON
        # spilled runs: the host export consumes them, except for a
        # segment op over a no-combine write (decided below)
        from_runs = "host_runs" in meta
        if from_runs and (meta["host_combine"]
                          or dep.partitioner.num_partitions > ndev):
            return None, HOST_RUNS_READ
        if dep.partitioner.num_partitions > ndev:
            return None, WIDE_REASON % (dep.partitioner.num_partitions,
                                        ndev)
        treedef, specs = meta["out_treedef"], meta["out_specs"]
        src_nk = meta["key_cols"]
        if meta["no_combine"]:
            # no-combine shuffle (partitionBy / groupByKey / sortByKey):
            # rows pass through flat; a bare groupByKey groups at egest;
            # groupByKey().mapValues(f) runs as a segment op over the
            # key-sorted rows when f is a provable aggregate (SegAggOp)
            # or traceable and padding-invariant (SegMapOp)
            if not passthrough:
                seg, seg_reason = _seg_op(ops, meta)
                if seg is not None:
                    ops[0] = seg
                elif ops or stage.is_shuffle_map:
                    return None, seg_reason or GROUP_REASON
                else:
                    group_output = True
        else:
            src_merge = probe_merge(dep.aggregator.merge_combiners, treedef,
                                    specs, src_nk)
            if src_merge is None:
                return None, ("merge_combiners not traceable by "
                              "torch.func.vmap; object path")
        if from_runs and not (ops and isinstance(ops[0],
                                                 (SegAggOp, SegMapOp))):
            return None, HOST_RUNS_READ
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
        reason = _plan_shuffle_write(plan, stage.shuffle_dep, ndev,
                                     wave is not None)
        if reason is not None:
            return None, reason
    return plan, None


def _plan_shuffle_write(plan, dep, ndev, streams=False):
    """Fill in the plan's shuffle-write epilogue; returns the reason the
    write has no device form, or None.  A hash write needs int key
    columns and, when it combines, a traceable create_combiner; a range
    write takes numeric key columns of one dtype and repartitions only;
    a no-combine write (groupByKey / partitionBy) skips create_combiner.
    More logical partitions than shards need the spilled-run stream, so
    an input above the wave threshold (`streams`)."""
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
        if not streams:
            return WIDE_REASON % (dep.partitioner.num_partitions, ndev)
        plan.logical_spill = True
    plan.epilogue = ("shuffle_write", dep)
    plan.epi_nk = epi_nk
    plan.epi_spec = spec
    plan.no_combine = no_combine
    return None
