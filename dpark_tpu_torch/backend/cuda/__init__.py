"""The `gpu[:N]` master: DAG scheduling on the host, each stage as one
tensor program over N logical shards on one CUDA device (port of
dpark_tpu/backend/tpu/__init__.py; TPUScheduler becomes GPUScheduler).

A stage the tensor path cannot admit runs the host object path inline,
and its record carries the reason (`fallback_reason`).  A CUDA error, an
out-of-memory or a kernel that fails to build or launch propagates: there
is no runtime degradation ladder in this slice.
"""

import time

from dpark_tpu_torch.backend.cuda import layout
from dpark_tpu_torch.rdd import _count_iter, _EMPTY, _PartReduce, _TopN
from dpark_tpu_torch.schedule import DAGScheduler, run_task_inline
from dpark_tpu_torch.task import ResultTask


class GPUScheduler(DAGScheduler):
    def __init__(self, ndev, device):
        super().__init__()
        self.ndev = ndev
        self.device = device
        self.executor = None

    def start(self):
        if self.executor is None:
            from dpark_tpu_torch.backend.cuda.executor import TorchExecutor
            self.executor = TorchExecutor(self.ndev, self.device)
            self.bucket_store.exporter = self.executor.export_bucket

    def stop(self):
        if self.executor is not None:
            self.executor.stop()
            self.executor = None

    def default_parallelism(self):
        return self.ndev

    def submit_tasks(self, stage, tasks, report):
        from dpark_tpu_torch.backend.cuda import fuse
        self.start()
        if len(tasks) < stage.num_partitions:
            # a partial job (take): the tensor path runs whole stages
            plan, reason = None, ("partial job (%d of %d partitions)"
                                  % (len(tasks), stage.num_partitions))
        else:
            plan, reason = fuse.analyze_stage(stage, self.ndev,
                                              self.executor)
        if plan is not None:
            try:
                self._run_array_stage(stage, tasks, plan, report)
                return
            except layout.HostPath as e:
                # raised while ingesting, before any device work
                reason = str(e)
        self.note_stage(stage.id, fallback_reason=reason)
        for task in tasks:
            status, payload = run_task_inline(task)
            report(task, status, payload)

    def _run_array_stage(self, stage, tasks, plan, report):
        from dpark_tpu_torch.backend.cuda import fuse
        t0 = time.time()
        result_tasks = not stage.is_shuffle_map and bool(tasks)
        # count(): answer from the device counts leaf, no egest
        plan.count_only = result_tasks and all(
            t.func is _count_iter for t in tasks)
        # top(k): per-shard pre-top on the device, N*k rows egested
        plan.top_candidate = None
        if (result_tasks and all(isinstance(t.func, _TopN) for t in tasks)
                and len({(t.func.n, id(t.func.key), t.func.smallest)
                         for t in tasks}) == 1):
            tf = tasks[0].func
            plan.top_candidate = (tf.n, tf.key, tf.smallest)
        # reduce(f) with a provable monoid over scalar records: one
        # per-shard reduction, N scalars egested
        plan.reduce_monoid = None
        if (result_tasks
                and all(isinstance(t.func, _PartReduce) for t in tasks)
                and len({id(t.func.f) for t in tasks}) == 1):
            plan.reduce_monoid = fuse.classify_merge(tasks[0].func.f)
        kind, result = self.executor.run_stage(plan)
        note = {"kind": "array"}
        if kind == "shuffle":
            note["hbm_bytes"] = self.executor.shuffle_store[result]["nbytes"]
            uri = "hbm://%d" % result
            for task in tasks:
                report(task, "success", (uri, {}, {}))
        elif kind == "counts":
            note["kind"] = "array+counts"       # no egest ran
            for task in tasks:
                report(task, "success", (result[task.partition], {}, {}))
        elif kind == "reduced":
            note["kind"] = "array+reduced"
            for task in tasks:
                v, n = result[task.partition]
                report(task, "success", (v if n else _EMPTY, {}, {}))
        else:
            if plan.topk_used:
                note["kind"] = "array+top"      # the pre-top ran
            for task in tasks:
                assert isinstance(task, ResultTask)
                value = task.func(iter(result[task.partition]))
                report(task, "success", (value, {}, {}))
        note["run_seconds"] = round(time.time() - t0, 6)
        self.note_stage(stage.id, **note)
