"""RDD graph: lazy, partitioned datasets (the subset of dpark_tpu/rdd.py
the port runs).

Every compute() is a Python generator: the object path that the local
master runs, and the golden model of the device path.  The gpu master
records narrow chains as ops (backend/cuda/fuse.py) and runs them on
tensors; compute() stays the semantic definition.
"""

import heapq
import itertools
import pickle

from dpark_tpu_torch import cache as _cache
from dpark_tpu_torch import file_manager
from dpark_tpu_torch.dependency import (
    Aggregator, HashPartitioner, OneToOneDependency, RangeDependency,
    RangePartitioner, ShuffleDependency)


class Split:
    def __init__(self, index):
        self.index = index


def _identity(x):
    return x


def _fst(pair):
    return pair[0]


def _snd(pair):
    return pair[1]


def _pair_none(x):
    return (x, None)


def _pair_self(x):
    return (x, x)


def _keep_first(a, b):
    return a


def _add(a, b):
    return a + b


def _one(v):
    return 1


def _radd_zero(v):
    """sum()'s first accumulation step (0 + item): raises for exactly
    the value types sum() raises for — the group-aggregate rewrite must
    not widen what works (a string group must still TypeError)."""
    return 0 + v


def _count_merge(c, v):
    return c + 1


def _mean_create(v):
    return (0 + v, 1)


def _mean_merge_value(c, v):
    return (c[0] + v, c[1] + 1)


def _mean_merge(a, b):
    return (a[0] + b[0], a[1] + b[1])


def _mean_final(sc):
    return sc[0] / sc[1]


# the identity list-aggregator of groupByKey / partitionBy: values are
# repartitioned, never combined (the gpu master's no-combine shuffle)
def _mk_list(v):
    return [v]


def _append(l, v):
    l.append(v)
    return l


def _extend(l1, l2):
    l1.extend(l2)
    return l1


# the join family's value expansions over a cogroup's (a list, b list);
# the gpu master recognises a.join(b) by `f is _join_values`
def _join_values(groups):
    a, b = groups
    return [(x, y) for x in a for y in b]


def _left_join_values(groups):
    a, b = groups
    return [(x, y) for x in a for y in (b or [None])]


def _right_join_values(groups):
    a, b = groups
    return [(x, y) for x in (a or [None]) for y in b]


def _outer_join_values(groups):
    a, b = groups
    return [(x, y) for x in (a or [None]) for y in (b or [None])]


class _Empty:
    def __repr__(self):
        return "_EMPTY"


_EMPTY = _Empty()


class RDD:
    def __init__(self, ctx):
        self.ctx = ctx
        self.id = ctx.new_rdd_id()
        self._splits = None
        self.dependencies = []
        self.partitioner = None
        self.should_cache = False

    @property
    def splits(self):
        if self._splits is None:
            self._splits = self._make_splits()
        return self._splits

    def _make_splits(self):
        raise NotImplementedError

    def compute(self, split):
        raise NotImplementedError

    def iterator(self, split):
        if self.should_cache:
            return _cache.get_or_compute(self, split)
        return self.compute(split)

    def __len__(self):
        return len(self.splits)

    def __repr__(self):
        return "<%s %d>" % (type(self).__name__, self.id)

    # -- narrow transformations -------------------------------------------
    def map(self, f):
        return MappedRDD(self, f)

    def flatMap(self, f):
        return FlatMappedRDD(self, f)

    def filter(self, f):
        return FilteredRDD(self, f)

    def mapPartitions(self, f):
        return MapPartitionsRDD(self, f)

    def mapValue(self, f):
        rewritten = self._group_agg_rewrite(f)
        if rewritten is not None:
            return rewritten
        return MappedValuesRDD(self, f)

    mapValues = mapValue

    def _group_agg_rewrite(self, f):
        """groupByKey().mapValue(provable aggregate) -> combineByKey: the
        combiner optimization, applied at graph-build time so every
        master pre-aggregates map-side and the exchange carries
        O(distinct keys) rows instead of every row.

        Applies only when `self` IS a bare groupByKey output (a
        no-combine hash ShuffledRDD — partitionBy's flat rows sit behind
        a FlatMappedValues(identity) and never reach here), the
        aggregate is provable (utils.monoid.classify_segagg: sum/len/
        min/max/mean or a __dpark_segagg__ hint — NOT the np twins,
        which flatten array values), and the grouping's shuffle outputs
        do not already exist (then reuse beats re-scanning the parent).
        The sum rewrites start from ``0 + v`` like sum()'s accumulator,
        so non-numeric values raise as they always did.
        conf.GROUP_AGG_REWRITE=0 disables (the device SegAggOp path then
        serves these chains).

        FLOAT CAVEAT: the rewrite REASSOCIATES the fold.  sum/mean over
        float values pre-combine map-side and merge per partition, so
        the result's low-order bits depend on partitioning and combine
        order on every master, local included, where the un-rewritten
        chain summed each group's list in row order."""
        import numpy as np
        from dpark_tpu_torch import conf
        from dpark_tpu_torch.utils.monoid import classify_segagg
        if not conf.GROUP_AGG_REWRITE:
            return None
        if not (isinstance(self, ShuffledRDD)
                and self.aggregator.create_combiner is _mk_list
                and self.aggregator.merge_value is _append
                and self.aggregator.merge_combiners is _extend
                and type(self.partitioner) is HashPartitioner):
            return None
        if self.ctx.bucket_store.has_outputs(self.dep.shuffle_id):
            # an earlier job computed this grouped RDD: reuse its map
            # outputs instead of re-scanning the parent
            return None
        # np.sum/np.mean/np.min/np.max flatten a list of array values
        # where the pairwise builtins work elementwise: only the
        # builtins, the bytecode templates and explicit hints rewrite
        try:
            if f in (np.sum, np.mean, np.min, np.max):
                return None
        except TypeError:
            return None
        kind = classify_segagg(f)
        n = self.partitioner.num_partitions
        parent = self.parent
        if kind == "sum":
            return parent.combineByKey(_radd_zero, _add, _add, n)
        if kind == "count":
            return parent.combineByKey(_one, _count_merge, _add, n)
        if kind == "min":
            return parent.combineByKey(_identity, min, min, n)
        if kind == "max":
            return parent.combineByKey(_identity, max, max, n)
        if kind == "mean":
            return parent.combineByKey(
                _mean_create, _mean_merge_value, _mean_merge,
                n).mapValue(_mean_final)
        return None

    def flatMapValue(self, f):
        return FlatMappedValuesRDD(self, f)

    flatMapValues = flatMapValue

    def keyBy(self, f):
        return KeyedRDD(self, f)

    def union(self, *others):
        """Concatenate partitions.  Unions flatten on both sides (a + b +
        c is one UnionRDD), except through a cached union, whose own
        partitions must be read."""
        def flat(r):
            if isinstance(r, UnionRDD) and not r.should_cache:
                return list(r.rdds)
            return [r]
        rdds = flat(self)
        for o in others:
            rdds.extend(flat(o))
        return UnionRDD(self.ctx, rdds)

    def __add__(self, other):
        return self.union(other)

    # -- wide transformations ---------------------------------------------
    def combineByKey(self, createCombiner, mergeValue, mergeCombiners,
                     numSplits=None):
        num = int(numSplits) if numSplits else self.ctx.default_parallelism
        agg = Aggregator(createCombiner, mergeValue, mergeCombiners)
        return ShuffledRDD(self, agg, HashPartitioner(num))

    def reduceByKey(self, func, numSplits=None):
        return self.combineByKey(_identity, func, func, numSplits)

    def groupByKey(self, numSplits=None):
        return self.combineByKey(_mk_list, _append, _extend, numSplits)

    def groupBy(self, f, numSplits=None):
        return self.keyBy(f).groupByKey(numSplits)

    def distinct(self, numSplits=None):
        return (self.map(_pair_none)
                .reduceByKey(_keep_first, numSplits)
                .map(_fst))

    def partitionBy(self, partitioner):
        """Repartition keeping every record (duplicate keys included); the
        result keeps the partitioner."""
        if isinstance(partitioner, int):
            partitioner = HashPartitioner(partitioner)
        if self.partitioner == partitioner:
            return self
        agg = Aggregator(_mk_list, _append, _extend)
        return FlatMappedValuesRDD(ShuffledRDD(self, agg, partitioner),
                                   _identity)

    def sortByKey(self, ascending=True, numSplits=None, sampleSize=2000):
        """Total order by key: range bounds from a sample of every
        partition, a range shuffle, then a sort of each partition.  Equal
        keys keep their input order, in both directions."""
        numSplits = numSplits or len(self.splits)
        if len(self.splits) <= 1:
            return self.mapPartitions(_SortPartFn(ascending))
        per_part = max(20, sampleSize // max(1, len(self.splits)))
        sampled = []
        for part in self.ctx.runJob(self, _TakeSampleKeys(per_part)):
            sampled.extend(part)
        sampled.sort()
        bounds = [sampled[len(sampled) * (i + 1) // numSplits]
                  for i in range(numSplits - 1)] if sampled else []
        # dedup bounds (heavy skew collapses ranges)
        bounds = sorted(set(bounds))
        part = RangePartitioner(bounds, ascending=ascending)
        return self.partitionBy(part).mapPartitions(_SortPartFn(ascending))

    def cogroup(self, *others, **kw):
        """key -> (values of self, values of each other RDD).  The
        partitioner is the first input's with at least numSplits
        partitions (that input is read narrowly), else a hash
        partitioner of numSplits."""
        numSplits = kw.get("numSplits") or self.ctx.default_parallelism
        rdds = [self] + list(others)
        for p in [r.partitioner for r in rdds]:
            if p is not None and p.num_partitions >= numSplits:
                partitioner = p
                break
        else:
            partitioner = HashPartitioner(numSplits)
        return CoGroupedRDD(rdds, partitioner)

    groupWith = cogroup

    def join(self, other, numSplits=None):
        return self.cogroup(other, numSplits=numSplits).flatMapValue(
            _join_values)

    def leftOuterJoin(self, other, numSplits=None):
        return self.cogroup(other, numSplits=numSplits).flatMapValue(
            _left_join_values)

    def rightOuterJoin(self, other, numSplits=None):
        return self.cogroup(other, numSplits=numSplits).flatMapValue(
            _right_join_values)

    def outerJoin(self, other, numSplits=None):
        return self.cogroup(other, numSplits=numSplits).flatMapValue(
            _outer_join_values)

    # -- caching -----------------------------------------------------------
    def cache(self):
        self.should_cache = True
        return self

    def unpersist(self):
        self.should_cache = False
        if self._splits is not None:
            self.ctx.cache.drop(self.id, len(self._splits))
        return self

    def sort(self, key=None, reverse=False, numSplits=None):
        """Sort records by key(record) (the record itself when None)."""
        keyed = self.keyBy(key) if key else self.map(_pair_self)
        return keyed.sortByKey(ascending=not reverse,
                               numSplits=numSplits).map(_snd)

    # -- actions ------------------------------------------------------------
    def collect(self):
        return list(itertools.chain.from_iterable(
            self.ctx.runJob(self, _listify)))

    def count(self):
        return sum(self.ctx.runJob(self, _count_iter))

    def reduce(self, f):
        parts = [r for r in self.ctx.runJob(self, _PartReduce(f))
                 if r is not _EMPTY]
        if not parts:
            raise ValueError("reduce of empty RDD")
        out = parts[0]
        for p in parts[1:]:
            out = f(out, p)
        return out

    def fold(self, zero, f):
        out = zero
        for p in self.ctx.runJob(self, _PartFold(zero, f)):
            out = f(out, p)
        return out

    def take(self, n):
        if n <= 0:
            return []
        out = []
        nsplits = len(self.splits)
        p = 0
        while len(out) < n and p < nsplits:
            # geometric ramp-up of partitions per round
            batch = list(range(p, min(nsplits, p + max(1, p))))
            for part in self.ctx.runJob(self, _TakeN(n - len(out)), batch):
                out.extend(part[:n - len(out)])
                if len(out) >= n:
                    break
            p = batch[-1] + 1
        return out

    def top(self, n=10, key=None, reverse=False):
        parts = list(self.ctx.runJob(
            self, _TopN(n, key, smallest=reverse)))
        allv = list(itertools.chain.from_iterable(parts))
        if reverse:
            return heapq.nsmallest(n, allv, key)
        return heapq.nlargest(n, allv, key)


# ----------------------------------------------------------------------
# per-partition functors of the actions (the gpu master recognises
# _count_iter, _TopN and _PartReduce and answers them on the device)
# ----------------------------------------------------------------------
def _listify(it):
    return list(it)


def _count_iter(it):
    n = 0
    for _ in it:
        n += 1
    return n


class _PartReduce:
    def __init__(self, f):
        self.f = f

    def __call__(self, it):
        out = _EMPTY
        for x in it:
            out = x if out is _EMPTY else self.f(out, x)
        return out


class _PartFold:
    def __init__(self, zero, f):
        self.zero = zero
        self.f = f

    def __call__(self, it):
        # each partition folds into its own copy of zero: f may mutate
        out = pickle.loads(pickle.dumps(self.zero, -1))
        for x in it:
            out = self.f(out, x)
        return out


class _TakeN:
    def __init__(self, n):
        self.n = n

    def __call__(self, it):
        return list(itertools.islice(it, self.n))


class _SortPartFn:
    def __init__(self, ascending):
        self.ascending = ascending

    def __call__(self, it):
        return iter(sorted(it, key=_fst, reverse=not self.ascending))


class _TakeSampleKeys:
    def __init__(self, n):
        self.n = n

    def __call__(self, it):
        return [k for k, _ in itertools.islice(it, self.n)]


class _TopN:
    def __init__(self, n, key, smallest=False):
        self.n = n
        self.key = key
        self.smallest = smallest

    def __call__(self, it):
        if self.smallest:
            return heapq.nsmallest(self.n, it, self.key)
        return heapq.nlargest(self.n, it, self.key)


# ----------------------------------------------------------------------
# narrow RDDs
# ----------------------------------------------------------------------
class DerivedRDD(RDD):
    """One-parent narrow RDD; shares the parent's splits."""

    def __init__(self, prev):
        super().__init__(prev.ctx)
        self.prev = prev
        self.dependencies = [OneToOneDependency(prev)]

    def _make_splits(self):
        return self.prev.splits


class MappedRDD(DerivedRDD):
    def __init__(self, prev, f):
        super().__init__(prev)
        self.f = f

    def compute(self, split):
        return map(self.f, self.prev.iterator(split))


class FlatMappedRDD(DerivedRDD):
    def __init__(self, prev, f):
        super().__init__(prev)
        self.f = f

    def compute(self, split):
        for x in self.prev.iterator(split):
            yield from self.f(x)


class FilteredRDD(DerivedRDD):
    def __init__(self, prev, f):
        super().__init__(prev)
        self.f = f

    def compute(self, split):
        return filter(self.f, self.prev.iterator(split))


class MapPartitionsRDD(DerivedRDD):
    def __init__(self, prev, f):
        super().__init__(prev)
        self.f = f

    def compute(self, split):
        return self.f(self.prev.iterator(split))


class MappedValuesRDD(DerivedRDD):
    def __init__(self, prev, f):
        super().__init__(prev)
        self.f = f
        self.partitioner = prev.partitioner

    def compute(self, split):
        f = self.f
        return ((k, f(v)) for k, v in self.prev.iterator(split))


class FlatMappedValuesRDD(DerivedRDD):
    def __init__(self, prev, f):
        super().__init__(prev)
        self.f = f
        self.partitioner = prev.partitioner

    def compute(self, split):
        f = self.f
        for k, v in self.prev.iterator(split):
            for vv in f(v):
                yield (k, vv)


class KeyedRDD(DerivedRDD):
    def __init__(self, prev, f):
        super().__init__(prev)
        self.f = f

    def compute(self, split):
        f = self.f
        return ((f(x), x) for x in self.prev.iterator(split))


# ----------------------------------------------------------------------
# the shuffle
# ----------------------------------------------------------------------
class ShuffledRDD(RDD):
    """Reduce side of a shuffle: compute() fetches every map output's
    bucket for its partition and merges combiners (the gpu master
    replaces this with the device exchange and the K5 key sort, plus the
    K3 merge when the aggregator combines)."""

    def __init__(self, parent, aggregator, partitioner):
        super().__init__(parent.ctx)
        self.parent = parent
        self.aggregator = aggregator
        self.partitioner = partitioner
        self.dep = ShuffleDependency(parent, aggregator, partitioner)
        self.dependencies = [self.dep]

    def _make_splits(self):
        return [Split(i) for i in range(self.partitioner.num_partitions)]

    def compute(self, split):
        merge = self.aggregator.merge_combiners
        combined = {}
        for k, c in self.ctx.bucket_store.fetch(self.dep.shuffle_id,
                                                split.index):
            if k in combined:
                combined[k] = merge(combined[k], c)
            else:
                combined[k] = c
        return iter(combined.items())


class CoGroupSplit(Split):
    def __init__(self, index, narrow_splits):
        super().__init__(index)
        # (source index, parent split) of each co-partitioned source;
        # shuffled sources are read by dependency order
        self.narrow_splits = narrow_splits


class CoGroupedRDD(RDD):
    """key -> tuple of value lists, one per parent (backs cogroup,
    groupWith and the join family).  A parent already partitioned like
    the result is read narrowly; every other parent is shuffled with
    the list aggregator (a no-combine shuffle)."""

    def __init__(self, rdds, partitioner):
        super().__init__(rdds[0].ctx)
        self.rdds = rdds
        self.partitioner = partitioner
        self._dep_kinds = []        # ("narrow", rdd) | ("shuffle", dep)
        agg = Aggregator(_mk_list, _append, _extend)
        for r in rdds:
            if r.partitioner == partitioner:
                self.dependencies.append(OneToOneDependency(r))
                self._dep_kinds.append(("narrow", r))
            else:
                dep = ShuffleDependency(r, agg, partitioner)
                self.dependencies.append(dep)
                self._dep_kinds.append(("shuffle", dep))

    def _make_splits(self):
        out = []
        for i in range(self.partitioner.num_partitions):
            narrow = [(si, obj.splits[i])
                      for si, (kind, obj) in enumerate(self._dep_kinds)
                      if kind == "narrow"]
            out.append(CoGroupSplit(i, narrow))
        return out

    def compute(self, split):
        from dpark_tpu_torch.shuffle import CoGroupMerger
        merger = CoGroupMerger(len(self.rdds))
        narrow = dict(split.narrow_splits)
        for si, (kind, obj) in enumerate(self._dep_kinds):
            if kind == "narrow":
                merger.append(si, self.rdds[si].iterator(narrow[si]))
            else:
                merger.extend(si, self.ctx.bucket_store.fetch(
                    obj.shuffle_id, split.index))
        return iter(merger)


# ----------------------------------------------------------------------
# union
# ----------------------------------------------------------------------
class UnionSplit(Split):
    def __init__(self, index, rdd_index, parent_split):
        super().__init__(index)
        self.rdd_index = rdd_index
        self.parent_split = parent_split


class UnionRDD(RDD):
    """The partitions of every parent, in order."""

    def __init__(self, ctx, rdds):
        super().__init__(ctx)
        self.rdds = rdds
        pos = 0
        for r in rdds:
            self.dependencies.append(
                RangeDependency(r, 0, pos, len(r.splits)))
            pos += len(r.splits)

    def _make_splits(self):
        out = []
        for ri, r in enumerate(self.rdds):
            for sp in r.splits:
                out.append(UnionSplit(len(out), ri, sp))
        return out

    def compute(self, split):
        return self.rdds[split.rdd_index].iterator(split.parent_split)


# ----------------------------------------------------------------------
# the in-memory source
# ----------------------------------------------------------------------
class ParallelSplit(Split):
    def __init__(self, index, values):
        super().__init__(index)
        self.values = values


class _ColumnarSlice:
    """One partition's data held as numpy column arrays (ingested to the
    device as tensors; row tuples materialize lazily on the object
    path)."""

    def __init__(self, columns):
        self.columns = columns

    def __len__(self):
        return len(self.columns[0]) if self.columns else 0

    def __bool__(self):
        return len(self) > 0

    def __getitem__(self, i):
        row = tuple(c[i] for c in self.columns)
        return row[0] if len(row) == 1 else row

    def __iter__(self):
        # tolist() in bounded chunks: a take over a huge column must not
        # materialize the whole slice as Python objects
        chunk = 1 << 16
        n = len(self)
        if len(self.columns) == 1:
            col = self.columns[0]
            for off in range(0, n, chunk):
                yield from col[off:off + chunk].tolist()
            return
        for off in range(0, n, chunk):
            yield from zip(*(c[off:off + chunk].tolist()
                             for c in self.columns))


class Columns:
    """Explicit columnar input for parallelize: each argument is one 1-D
    column array; records are row tuples across the columns.

        ctx.parallelize(Columns(keys, values), n)
    """

    def __init__(self, *arrays):
        import numpy as np
        self.arrays = [np.ascontiguousarray(a) for a in arrays]
        if not self.arrays:
            raise ValueError("Columns needs at least one array")
        if any(a.ndim != 1 for a in self.arrays):
            raise ValueError("Columns arrays must be 1-D")
        if len({len(a) for a in self.arrays}) != 1:
            raise ValueError("Columns arrays must have equal length")


def _as_columns(seq):
    import numpy as np
    if isinstance(seq, Columns):
        return list(seq.arrays)
    if isinstance(seq, np.ndarray) and seq.ndim == 1:
        return [seq]
    return None


class ParallelCollection(RDD):
    """In-memory sequence split into `num_slices`; Columns input stays
    columnar."""

    def __init__(self, ctx, seq, num_slices=None):
        super().__init__(ctx)
        cols = _as_columns(seq)
        if cols is not None:
            total = len(cols[0])
            n = num_slices or ctx.default_parallelism
            n = max(1, min(n, total) if total else 1)
            self._slices = [
                _ColumnarSlice([c[total * i // n: total * (i + 1) // n]
                                for c in cols])
                for i in range(n)]
            return
        seq = list(seq)
        n = num_slices or ctx.default_parallelism
        n = max(1, min(n, len(seq)) if seq else 1)
        self._slices = [seq[len(seq) * i // n: len(seq) * (i + 1) // n]
                        for i in range(n)]

    def _make_splits(self):
        return [ParallelSplit(i, s) for i, s in enumerate(self._slices)]

    def compute(self, split):
        return iter(split.values)


# ----------------------------------------------------------------------
# file sources
# ----------------------------------------------------------------------
class TextSplit(Split):
    def __init__(self, index, path, begin, end):
        super().__init__(index)
        self.path = path
        self.begin = begin
        self.end = end


DEFAULT_BLOCK = 64 << 20


class TextFileRDD(RDD):
    """The lines of one file or of every file under a directory, in
    newline-aligned byte-range splits: a split owns each line that starts
    inside [begin, end), read to its newline; records are str with the
    trailing \\r\\n stripped, decoded as utf-8 (invalid bytes replaced)."""

    def __init__(self, ctx, path, numSplits=None, splitSize=None):
        super().__init__(ctx)
        self.path = path
        files = list(file_manager.walk(path))
        total = sum(sz for _, sz in files)
        if splitSize is None:
            if numSplits:
                splitSize = max(1, total // numSplits) or 1
            else:
                splitSize = DEFAULT_BLOCK
        self._file_splits = []
        for p, sz in files:
            off = 0
            while off < sz or (sz == 0 and off == 0):
                end = min(off + splitSize, sz)
                self._file_splits.append((p, off, end))
                off = end
                if sz == 0:
                    break

    def _make_splits(self):
        return [TextSplit(i, p, b, e)
                for i, (p, b, e) in enumerate(self._file_splits)]

    @staticmethod
    def split_bytes(split):
        """The bytes of the lines `split` owns (compute's rule, in one
        read): the text ingest tokenizes them whole."""
        with file_manager.open_file(split.path) as f:
            begin = split.begin
            if begin > 0:
                f.seek(begin - 1)
                if f.read(1) != b"\n":
                    f.readline()
                begin = f.tell()
            data = f.read(split.end - begin) if split.end > begin else b""
            if data and not data.endswith(b"\n"):
                data += f.readline()
            return data

    def compute(self, split):
        with file_manager.open_file(split.path) as f:
            if split.begin > 0:
                f.seek(split.begin - 1)
                if f.read(1) != b"\n":
                    f.readline()        # skip the partial first line
            while f.tell() <= split.end:
                line = f.readline()
                if not line:
                    break
                if f.tell() - len(line) >= split.end:
                    break
                yield line.rstrip(b"\r\n").decode("utf-8", "replace")
