"""DAG scheduling (the subset of dpark_tpu/schedule.py this slice runs):
stages cut at ShuffleDependency edges, run parents first, every task
inline in this process.  Masters subclass DAGScheduler and implement
submit_tasks(); the gpu master runs whole stages on the device.

Each job leaves a record in `history` whose `stage_info` list carries
one dict per stage: `kind` ("object", or "array..." when the device ran
it), `fallback_reason` when the device path declined it, `combine` on a
shuffle-map stage (whether its write pre-aggregates), `stream` (the
pane-plane tag of a windowed DStream's RDD), and timings.
"""

import itertools
import time
import traceback

from dpark_tpu_torch.dependency import ShuffleDependency
from dpark_tpu_torch.rdd import _mk_list
from dpark_tpu_torch.task import ResultTask, ShuffleMapTask


class Stage:
    _next_id = itertools.count(1)

    def __init__(self, rdd, shuffle_dep, parents):
        self.id = next(Stage._next_id)
        self.rdd = rdd
        self.shuffle_dep = shuffle_dep          # None for a result stage
        self.parents = parents
        self.num_partitions = len(rdd.splits)
        self.output_locs = [None] * self.num_partitions

    @property
    def is_shuffle_map(self):
        return self.shuffle_dep is not None

    @property
    def is_available(self):
        return (self.is_shuffle_map
                and all(loc is not None for loc in self.output_locs))

    def __repr__(self):
        return "<Stage %d on %r>" % (self.id, self.rdd)


class TaskFailed(RuntimeError):
    """A task raised; the message carries its traceback."""


class DAGScheduler:
    def __init__(self):
        self.shuffle_to_stage = {}
        self.history = []              # job records, newest last
        self._next_job_id = 0
        self.current_record = None
        self.bucket_store = None       # set by the context

    def start(self):
        pass

    def stop(self):
        pass

    def default_parallelism(self):
        return 2

    # -- stage graph -----------------------------------------------------
    def get_shuffle_map_stage(self, dep):
        stage = self.shuffle_to_stage.get(dep.shuffle_id)
        if stage is None:
            stage = Stage(dep.rdd, dep, self.get_parent_stages(dep.rdd))
            self.shuffle_to_stage[dep.shuffle_id] = stage
        return stage

    def get_parent_stages(self, rdd):
        parents = []
        visited = set()

        def visit(r):
            if r.id in visited:
                return
            visited.add(r.id)
            for dep in r.dependencies:
                if isinstance(dep, ShuffleDependency):
                    stage = self.get_shuffle_map_stage(dep)
                    if stage not in parents:
                        parents.append(stage)
                else:
                    visit(dep.rdd)
        visit(rdd)
        return parents

    # -- jobs ------------------------------------------------------------
    def run_job(self, final_rdd, func, partitions=None):
        """Generator yielding per-partition results in partition order."""
        if partitions is None:
            partitions = list(range(len(final_rdd.splits)))
        if not partitions:
            return
        self._next_job_id += 1
        record = {"id": self._next_job_id, "stage_info": [],
                  "parts": len(partitions), "state": "running"}
        self.history.append(record)
        self.current_record = record
        t0 = time.time()
        final_stage = Stage(final_rdd, None,
                            self.get_parent_stages(final_rdd))
        self._job_started(record)
        try:
            try:
                self._run_stage(final_stage, record)     # parents first
                results = self._run_result_stage(final_stage, record, func,
                                                 partitions)
                record["state"] = "done"
            except BaseException:
                record["state"] = "aborted"
                raise
            finally:
                record["seconds"] = round(time.time() - t0, 6)
            yield from results
        finally:
            # its results consumed, or the job aborted (or its consumer
            # closed the generator)
            self._job_finished(record)

    def _job_started(self, record):
        """A job begins running (the gpu master marks its stores live)."""

    def _job_finished(self, record):
        """A job's results were consumed, or it aborted."""

    def _run_stage(self, stage, record):
        for parent in stage.parents:
            if not parent.is_available:
                self._run_stage(parent, record)
                self._run_map_stage(parent, record)

    def _run_map_stage(self, stage, record):
        tasks = [ShuffleMapTask(stage.id, stage.rdd, stage.shuffle_dep, p)
                 for p in range(stage.num_partitions)]

        def report(task, status, payload):
            if status != "success":
                raise TaskFailed("%r failed:\n%s" % (task, payload))
            stage.output_locs[task.partition] = payload[0]
        self._submit(stage, tasks, report, record)
        self.bucket_store.set_map_outputs(stage.shuffle_dep.shuffle_id,
                                          stage.output_locs)

    def _run_result_stage(self, stage, record, func, partitions):
        results = {}
        tasks = [ResultTask(stage.id, stage.rdd, func, p, i)
                 for i, p in enumerate(partitions)]

        def report(task, status, payload):
            if status != "success":
                raise TaskFailed("%r failed:\n%s" % (task, payload))
            results[task.partition] = payload[0]
        self._submit(stage, tasks, report, record)
        return [results[p] for p in partitions]

    def _submit(self, stage, tasks, report, record):
        info = self.stage_info(record, stage.id)
        info.update({"rdd": type(stage.rdd).__name__,
                     "parts": stage.num_partitions,
                     "shuffle": stage.is_shuffle_map})
        # windowed DStreams tag the RDDs they build ({stream, role,
        # pane}): a stage's record says which pane-plane role it served
        stream_tag = getattr(stage.rdd, "_stream_tag", None)
        if stream_tag:
            info["stream"] = dict(stream_tag)
        if stage.is_shuffle_map:
            # a combining write pre-aggregates map-side; groupByKey /
            # partitionBy / sortByKey repartition only
            info["combine"] = (stage.shuffle_dep.aggregator.create_combiner
                               is not _mk_list)
        t0 = time.time()
        self.submit_tasks(stage, tasks, report)
        info["seconds"] = round(time.time() - t0, 6)

    def submit_tasks(self, stage, tasks, report):
        """Run tasks and call report(task, status, payload) for each."""
        raise NotImplementedError

    # -- records ---------------------------------------------------------
    @staticmethod
    def stage_info(record, stage_id):
        for info in record["stage_info"]:
            if info["id"] == stage_id:
                return info
        info = {"id": stage_id, "kind": "object", "seconds": None}
        record["stage_info"].append(info)
        return info

    def note_stage(self, stage_id, **kw):
        """Annotate the current job's record of a stage."""
        if self.current_record is not None:
            self.stage_info(self.current_record, stage_id).update(kw)


def run_task_inline(task):
    """(status, payload) of one task run in this process."""
    try:
        return "success", (task.run(), {}, {})
    except Exception:
        return "failed", traceback.format_exc()


class LocalScheduler(DAGScheduler):
    """Single-threaded in-process master: the golden model every other
    master is tested against."""

    def submit_tasks(self, stage, tasks, report):
        for task in tasks:
            status, payload = run_task_inline(task)
            report(task, status, payload)
