"""Tasks of the host object path (subset of dpark_tpu/task.py)."""

import itertools

_next_task_id = itertools.count(1)


class Task:
    def __init__(self, stage_id, partition):
        self.id = next(_next_task_id)
        self.stage_id = stage_id
        self.partition = partition


class ResultTask(Task):
    def __init__(self, stage_id, rdd, func, partition, output_id):
        super().__init__(stage_id, partition)
        self.rdd = rdd
        self.func = func
        self.split = rdd.splits[partition]
        self.output_id = output_id

    def run(self):
        return self.func(self.rdd.iterator(self.split))

    def __repr__(self):
        return "<ResultTask(%d) of %r part%d>" % (
            self.id, self.rdd, self.partition)


class ShuffleMapTask(Task):
    def __init__(self, stage_id, rdd, shuffle_dep, partition):
        super().__init__(stage_id, partition)
        self.rdd = rdd
        self.shuffle_dep = shuffle_dep
        self.split = rdd.splits[partition]

    def run(self):
        dep = self.shuffle_dep
        agg = dep.aggregator
        get_partition = dep.partitioner.get_partition
        buckets = [{} for _ in range(dep.partitioner.num_partitions)]
        create, merge = agg.create_combiner, agg.merge_value
        # per-record hash + dict combine: the loop the device path
        # replaces with K1 + sort + K2 + K3
        for k, v in self.rdd.iterator(self.split):
            b = buckets[get_partition(k)]
            if k in b:
                b[k] = merge(b[k], v)
            else:
                b[k] = create(v)
        return self.rdd.ctx.bucket_store.write_buckets(
            dep.shuffle_id, self.partition, buckets)

    def __repr__(self):
        return "<ShuffleMapTask(%d) of %r part%d>" % (
            self.id, self.rdd, self.partition)
