"""DparkContext of the PyTorch port: parses the master, owns the
scheduler, and builds root RDDs.

Masters:
  local      the in-process host object path (the golden model)
  gpu[:N]    N logical shards (default 1) on one CUDA device; stages run
             as tensor programs with hand-written CUDA kernels

The gpu master runs on CUDA and raises when no CUDA device is present.
Pass ``device="cpu"`` to run the same tensor path on the CPU with the
kernels' plain PyTorch versions (what the tests do).  Root RDDs:
``parallelize`` (rows or Columns) and ``textFile`` (plain files).
"""

import itertools

from dpark_tpu_torch import rdd as _rdd
from dpark_tpu_torch.cache import Cache
from dpark_tpu_torch.shuffle import BucketStore


class DparkContext:
    _rdd_ids = itertools.count(1)

    def __init__(self, master="local", device=None):
        self.master = master
        self.device = device
        self.scheduler = None
        self.started = False
        self.bucket_store = BucketStore()
        self.cache = Cache()         # RDD.cache() partitions
        kind, _, arg = master.partition(":")
        if kind == "local":
            if device is not None:
                raise ValueError("the local master takes no device")
        elif kind == "gpu":
            self._ndev = int(arg) if arg else 1
            if self._ndev < 1:
                raise ValueError("gpu:N needs N >= 1, got %r" % master)
            import torch
            if device is None:
                if not torch.cuda.is_available():
                    raise RuntimeError(
                        "the gpu master needs a CUDA device and none is "
                        "available; pass device='cpu' to run the tensor "
                        "path on the CPU")
                device = "cuda"
            self.device = torch.device(device)
            if self.device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("device %s requested but CUDA is not "
                                   "available" % self.device)
        else:
            raise ValueError("unknown master %r (local/gpu[:N])" % master)

    def start(self):
        if self.started:
            return
        kind = self.master.partition(":")[0]
        if kind == "local":
            from dpark_tpu_torch.schedule import LocalScheduler
            self.scheduler = LocalScheduler()
        else:
            from dpark_tpu_torch.backend.cuda import GPUScheduler
            self.scheduler = GPUScheduler(self._ndev, self.device)
        self.scheduler.bucket_store = self.bucket_store
        self.scheduler.start()
        self.started = True

    def stop(self):
        if not self.started:
            return
        self.started = False
        self.scheduler.stop()
        self.cache.clear()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    def new_rdd_id(self):
        return next(DparkContext._rdd_ids)

    @property
    def default_parallelism(self):
        self.start()
        return self.scheduler.default_parallelism()

    def parallelize(self, seq, numSlices=None):
        return _rdd.ParallelCollection(self, seq, numSlices)

    def textFile(self, path, numSplits=None, splitSize=None):
        """The lines of a plain text file (or of every file under a
        directory) in newline-aligned splits of splitSize bytes (64 MiB,
        or the total over numSplits).  Compressed files are ROADMAP A8b."""
        if path.endswith((".gz", ".bz2")):
            raise NotImplementedError(
                "compressed text sources (%s) are not yet ported (ROADMAP "
                "A8b)" % path)
        return _rdd.TextFileRDD(self, path, numSplits, splitSize)

    def partialTextFile(self, path, begin, end, splitSize=None):
        raise NotImplementedError("partialTextFile is not yet ported "
                                  "(ROADMAP A8b)")

    def csvFile(self, path, dialect="excel", numSplits=None,
                splitSize=None):
        raise NotImplementedError("csvFile is not yet ported (ROADMAP A8b)")

    def union(self, rdds):
        return _rdd.UnionRDD(self, list(rdds))

    def runJob(self, rdd, func, partitions=None):
        self.start()
        return self.scheduler.run_job(rdd, func, partitions)
