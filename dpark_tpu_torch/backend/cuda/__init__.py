"""The `gpu[:N]` master: DAG scheduling on the host, each stage as one
tensor program over N logical shards on one CUDA device (port of
dpark_tpu/backend/tpu/__init__.py; TPUScheduler becomes GPUScheduler).

A stage the tensor path cannot admit runs the host object path inline,
and its record carries the reason (`fallback_reason`); a reduce stage
over spilled runs reads them on the host by design (`reads`, no
reason).  A stage that merges with a traced user merge records each
merge's route (`merge_route`: "K14", "K14 separable", or why the merge
kept the plain scan), and a device top-n its route (`top_route`: "K18",
or why it kept K5 + K2).  Before it runs, a join or cogroup whose inputs are
device-resident no-combine shuffles is computed on the device and seeds
the partition cache (`device_precompute` in the record), so only the
group merge runs in Python.  A text stage's record carries `source:
"text"` and `text` (whether the C++ tokenizer ran, on how many splits,
and the tokenize time).

The out-of-memory ladder (port of TPUScheduler._run_degradable): a CUDA
out-of-memory error, or the emulated ceiling of
conf.EMULATED_WAVE_OOM_ROWS, retries the stage once on the device with
half the wave budget the failed attempt used; the retry is written to
the stage's `degrade_reason`.  A second out-of-memory error propagates
(the reference then runs the stage on the host: ROADMAP C16), as does
every other CUDA error and a kernel that fails to build or launch, in
the join and cogroup precompute too (the reference logs and skips a
failed precompute).
"""

import gc
import time

import torch

from dpark_tpu_torch.backend.cuda import layout
from dpark_tpu_torch.dependency import ShuffleDependency
from dpark_tpu_torch.rdd import (CoGroupedRDD, _count_iter, _EMPTY,
                                 _PartReduce, _TopN)
from dpark_tpu_torch.schedule import DAGScheduler, run_task_inline
from dpark_tpu_torch.task import ResultTask


def _device_oom(e):
    """Is `e` (or its cause) the out-of-memory class the ladder owns: a
    CUDA allocation failure, or the emulated ceiling's MemoryError?"""
    for exc in (e, getattr(e, "__cause__", None)):
        if isinstance(exc, torch.cuda.OutOfMemoryError):
            return True
        if isinstance(exc, MemoryError) and "RESOURCE_EXHAUSTED" in str(exc):
            return True
    return False


def _cached(rdd):
    """Whether every partition of the RDD is in the partition cache."""
    return rdd.should_cache and rdd.ctx.cache.holds(rdd.id,
                                                    len(rdd.splits))


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

    def _job_started(self, record):
        """A running job's shuffle stores spill only after every
        completed job's (executor._evict_hbm)."""
        self.start()
        self.executor.live_jobs.add(record["id"])

    def _job_finished(self, record):
        if self.executor is not None:
            self.executor.live_jobs.discard(record["id"])

    def submit_tasks(self, stage, tasks, report):
        from dpark_tpu_torch.backend.cuda import fuse
        self.start()
        # the job each new shuffle store belongs to
        self.executor.current_job = (self.current_record["id"]
                                     if self.current_record else None)
        if len(tasks) < stage.num_partitions:
            # a partial job (take): the tensor path runs whole stages
            plan, reason = None, ("partial job (%d of %d partitions)"
                                  % (len(tasks), stage.num_partitions))
        else:
            plan, reason = fuse.analyze_stage(stage, self.ndev,
                                              self.executor)
        if plan is not None:
            try:
                self._run_degradable(stage, tasks, plan, report)
                return
            except layout.HostPath as e:
                # raised while ingesting, before any device work
                reason = str(e)
        if reason == fuse.HOST_RUNS_READ:
            self.note_stage(stage.id, reads="host_runs")
        else:
            self.note_stage(stage.id, fallback_reason=reason)
        seeded = self._precompute_join(stage)
        if seeded is None:
            seeded = self._precompute_cogroup(stage)
        try:
            for task in tasks:
                status, payload = run_task_inline(task)
                report(task, status, payload)
        finally:
            if seeded is not None:
                # free the seeded partitions unless the user cached the
                # RDD: a later job recomputes them
                rdd, nparts, was_cached = seeded
                if not was_cached:
                    rdd.ctx.cache.drop(rdd.id, nparts)
                    rdd.should_cache = False

    def _run_stage(self, stage, record):
        # a parent whose device output was dropped (a failed spill)
        # recomputes through its lineage, as after a lost map output;
        # running one parent may drop another's, so check again after
        for _ in range(len(stage.parents) + 1):
            self._forget_dropped(stage)
            super()._run_stage(stage, record)
            if not self._forget_dropped(stage):
                return

    def _forget_dropped(self, stage):
        """Mark the parents whose device output is gone unavailable;
        returns whether there was one."""
        dropped = False
        for parent in stage.parents:
            if (parent.is_available and self.executor is not None
                    and str(parent.output_locs[0]).startswith("hbm://")
                    and parent.shuffle_dep.shuffle_id
                    not in self.executor.shuffle_store):
                parent.output_locs = [None] * parent.num_partitions
                dropped = True
        return dropped

    def _run_degradable(self, stage, tasks, plan, report):
        """The tensor path with the out-of-memory ladder.  An
        out-of-memory error (raised by run_stage before any task
        reports) retries the stage once with half the wave budget the
        failed attempt used (executor.last_wave_budget); fuse._wave_rows
        reads that budget too, so the retry may stream a stage that ran
        in core.  An out-of-memory error in a stage without a wave
        budget (no columnar input feeding a shuffle), a second one, and
        every other error propagate."""
        try:
            self._run_array_stage(stage, tasks, plan, report)
            return
        except Exception as e:
            budget = self.executor.last_wave_budget
            if not _device_oom(e) or budget is None:
                raise
            first = "%s: %s" % (type(e).__name__, str(e)[:160])
        halved = max(64, budget // 2)
        self._release()
        try:
            self._run_array_stage(stage, tasks, plan, report,
                                  wave_budget=halved)
        except Exception as e2:
            if _device_oom(e2):
                self.note_stage(stage.id, degrade_reason=(
                    "%s; halved-wave retry failed (%s: %s); the error "
                    "propagates" % (first, type(e2).__name__,
                                    str(e2)[:120])))
            raise
        self.note_stage(stage.id, degrade_reason=(
            "%s; stage retried with halved wave budget (%d rows/device)"
            % (first, halved)))

    def _release(self):
        """Free the failed attempt's tensors (the exception's frames held
        them) and return the cached blocks to the card."""
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    # device precompute of a host stage's join or cogroup
    # ------------------------------------------------------------------
    def _resident_nocombine_deps(self, cg):
        """Every input of a CoGroupedRDD as a device-resident no-combine
        shuffle dependency (a shuffled cogroup input is always
        no-combine), or None (a side read narrowly, an output on the
        host, or spilled runs, which the host merge consumes)."""
        deps = []
        store = self.executor.shuffle_store
        for kind, obj in cg._dep_kinds:
            if (kind != "shuffle" or obj.shuffle_id not in store
                    or "host_runs" in store[obj.shuffle_id]):
                return None
            deps.append(obj)
        return deps

    def _seed(self, stage, rdd, parts, what):
        """Put each partition's rows in the cache and mark the RDD cached
        for this stage's tasks; returns (rdd, partitions, was cached)."""
        for p, rows in enumerate(parts):
            rdd.ctx.cache.put((rdd.id, p), rows)
        was_cached = rdd.should_cache
        rdd.should_cache = True
        self.note_stage(stage.id, device_precompute=what)
        return rdd, len(parts), was_cached

    def _precompute_join(self, stage):
        """When the stage's top RDD is a.join(b) that the device admits
        as a join source (fuse._analyze_join_source) but the stage runs
        on the host (a partial job, an op after the join the device
        refuses, string keys encoded on both sides), expand the pairs on
        the device and seed the join's partitions."""
        from dpark_tpu_torch.backend.cuda import fuse
        top = stage.rdd
        if not fuse.is_join(top) or _cached(top):
            return None
        joined, _ = fuse._analyze_join_source(
            top, self.ndev, self.executor.shuffle_store, allow_encoded=True)
        if joined is None:
            return None
        rows = self.executor.run_device_join(*joined[2])
        return self._seed(stage, top, rows[:len(top.splits)], "join")

    def _precompute_cogroup(self, stage):
        """When the stage reads a CoGroupedRDD (through narrow links)
        whose inputs are all device-resident no-combine shuffles: exchange
        and key-sort each input on the device (gather_rows), merge the
        sorted rows of each partition on the host, and seed the
        cogroup's partitions (the export bridge is never read)."""
        seen = set()
        cg = None
        frontier = [stage.rdd]
        while frontier:
            r = frontier.pop()
            if r.id in seen or _cached(r):
                continue
            seen.add(r.id)
            if isinstance(r, CoGroupedRDD):
                cg = r
                break
            for d in r.dependencies:
                if not isinstance(d, ShuffleDependency):
                    frontier.append(d.rdd)
        if cg is None:
            return None
        deps = self._resident_nocombine_deps(cg)
        if deps is None:
            return None
        per_source = [self.executor.gather_rows(dep) for dep in deps]
        parts = []
        for p in range(cg.partitioner.num_partitions):
            slots = {}
            for si, rows in enumerate(per_source):
                for k, v in rows[p]:
                    slot = slots.get(k)
                    if slot is None:
                        slot = slots[k] = tuple([] for _ in deps)
                    slot[si].append(v)
            parts.append(list(slots.items()))
        return self._seed(stage, cg, parts, "cogroup")

    def _run_array_stage(self, stage, tasks, plan, report,
                         wave_budget=None):
        from dpark_tpu_torch.backend.cuda import fuse
        t0 = time.time()
        result_tasks = not stage.is_shuffle_map and bool(tasks)
        # count(): answer from the device counts leaf, no egest
        plan.count_only = result_tasks and all(
            t.func is _count_iter for t in tasks)
        # top(k): per-shard pre-top on the device, N*k rows egested
        plan.top_candidate = plan.top_route = None
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
        kind, result = self.executor.run_stage(plan, wave_budget)
        note = {"kind": "array"}
        if self.executor.last_stream_stats is not None:
            note["pipeline"] = self.executor.last_stream_stats
            note["wave_budget"] = self.executor.last_wave_budget
        text = self.executor.last_text_stats
        if text is not None:
            # which tokenizer ran: the verified C++ one ("canonical") on
            # cpp_splits, the user's chain on prologue_splits
            note["source"] = "text"
            note["text"] = {
                "canonical": text["canonical"] and text["cpp_splits"] > 0,
                "cpp_splits": text["cpp_splits"],
                "prologue_splits": text["prologue_splits"],
                "tokenize_ms": round(text["tokenize_s"] * 1e3, 1)}
        if kind == "shuffle":
            store = self.executor.shuffle_store[result]
            note["hbm_bytes"] = store["nbytes"]
            if "host_runs" in store:
                note["kind"] = "array+spill"
                note["stream"] = "host_runs"
            elif store.get("pre_reduced"):
                note["stream"] = "pre_reduced"
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
                note["top_route"] = plan.top_route
            for task in tasks:
                assert isinstance(task, ResultTask)
                value = task.func(iter(result[task.partition]))
                report(task, "success", (value, {}, {}))
        routes = self.executor.merge_routes(plan)
        if routes:
            note["merge_route"] = routes
        note["run_seconds"] = round(time.time() - t0, 6)
        self.note_stage(stage.id, **note)
