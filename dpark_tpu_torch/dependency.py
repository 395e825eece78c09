"""Dependencies, the hash and range partitioners and the combineByKey
aggregator (the subset of dpark_tpu/dependency.py the port runs).  The
DAG scheduler cuts stages on ShuffleDependency edges; a narrow edge
(one-to-one, or the range of a union) stays inside a stage."""

import bisect
import itertools

from dpark_tpu_torch.utils.phash import portable_hash


class Dependency:
    def __init__(self, rdd):
        self.rdd = rdd


class NarrowDependency(Dependency):
    """Child partition depends on a statically known set of parent
    partitions."""

    def get_parents(self, partition_id):
        raise NotImplementedError


class OneToOneDependency(NarrowDependency):
    def get_parents(self, pid):
        return [pid]


class RangeDependency(NarrowDependency):
    """UnionRDD's edge: child partitions [out_start, out_start + length)
    map one to one onto parent partitions [in_start, in_start +
    length)."""

    def __init__(self, rdd, in_start, out_start, length):
        super().__init__(rdd)
        self.in_start = in_start
        self.out_start = out_start
        self.length = length

    def get_parents(self, pid):
        if self.out_start <= pid < self.out_start + self.length:
            return [pid - self.out_start + self.in_start]
        return []


_next_shuffle_id = itertools.count(1)


class ShuffleDependency(Dependency):
    """A wide edge: every child partition reads a bucket of every parent
    partition."""

    def __init__(self, rdd, aggregator, partitioner):
        super().__init__(rdd)
        self.shuffle_id = next(_next_shuffle_id)
        self.aggregator = aggregator
        self.partitioner = partitioner


class Aggregator:
    """combineByKey triple."""

    def __init__(self, create_combiner, merge_value, merge_combiners):
        self.create_combiner = create_combiner
        self.merge_value = merge_value
        self.merge_combiners = merge_combiners


class HashPartitioner:
    def __init__(self, partitions):
        self.partitions = max(1, int(partitions))

    @property
    def num_partitions(self):
        return self.partitions

    def get_partition(self, key):
        return portable_hash(key) % self.partitions

    def __eq__(self, other):
        return (isinstance(other, HashPartitioner)
                and other.partitions == self.partitions)

    def __hash__(self):
        return self.partitions


class RangePartitioner:
    """Sorted-sample range partitioner backing sortByKey: bounds from a
    sample, bisect per key; descending maps partition i to the mirror
    range."""

    def __init__(self, bounds, ascending=True):
        self.bounds = list(bounds)
        self.ascending = ascending

    @property
    def num_partitions(self):
        return len(self.bounds) + 1

    def get_partition(self, key):
        idx = bisect.bisect_left(self.bounds, key)
        return idx if self.ascending else len(self.bounds) - idx

    def __eq__(self, other):
        return (isinstance(other, RangePartitioner)
                and other.bounds == self.bounds
                and other.ascending == self.ascending)

    def __hash__(self):
        return hash((tuple(self.bounds), self.ascending))
