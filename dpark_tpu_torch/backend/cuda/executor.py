"""TorchExecutor: runs one stage's plan over N logical shards on one
device (port of the in-core main path of
dpark_tpu/backend/tpu/executor.py; JAXExecutor becomes TorchExecutor).

A stage is: source (host ingest, or a shuffle output kept on the
device) -> narrow ops (vmapped user functions, filters, SortOp) ->
either a result (egest, count, top, reduce) or a shuffle write kept in
`shuffle_store` until the reduce side runs K4's exchange.  A combining
hash write is K1 destination, K5 key sort, K2 partition, K3 combine, and
its reduce side sorts (K5) and merges (K3); a no-combine write
(groupByKey, partitionBy, sortByKey's range shuffle) is K1 or K6
destination and K2 partition, and its reduce side only sorts by key (K5).
A groupByKey().mapValues(f) reduce side then runs SegAggOp (K3) or, for
SegMapOp, K7's segment table first (_run_seg_map).  An a.join(b) source
exchanges and sorts both no-combine sides, then K12 finds each A row's
range of equal B keys and expands the pairs (device_join_batch).  A
"union" source (B16) materializes each branch sub-plan (its source and
narrow ops, through the same _source_batch), packs the branches' rows
per shard with K16 (_union_batch), then runs the stage's ops and write
over the union.

A "text" source runs the stage's narrow chain over a text file on the
host a split at a time (the C++ tokenizer for the verified canonical
wordcount, the user's generators otherwise), encodes string keys to
int64 ids in the executor's token dict, and ingests the columns; every
host exit of an encoded store decodes the ids (_maybe_decode).

A columnar input above the wave threshold, or text above
conf.STREAM_TEXT_BYTES, feeding a shuffle write streams in waves
(_stream_mode).  With at most one logical partition a
shard and a usable merge, each wave's combined map output merges into a
per-shard state on the device (B6: K5 + K3), registered as a
`pre_reduced` store whose reduce side needs no exchange.  Otherwise
each wave is exchanged, sorted by (logical partition, key) and spilled
as key-sorted runs to a host spool (a `host_runs` store); with more
partitions than shards the logical partition rides the exchange (K13
folds it onto a shard) and a usable merge pre-reduces each wave on both
sides (B12: K13 + K5 + K3, then K5 + K3).  The host export premerges a
partition's runs and folds equal keys with the user's merge.

The shuffle stores share one budget (conf.SHUFFLE_HBM_BUDGET, the
reference's): after every write registers, _evict_hbm spills the least
recently fetched stores, completed jobs' first, to the spilled-run form
(_spill_shuffle_to_host: one pinned read, one key-sorted run a
partition); the store keeps its id, and every reader serves its runs.

PyTorch runs eagerly: the reference's compiled programs (narrow,
exchange, reduce) are plain functions here, and there is no program
cache (nor its sticky capacity classes).  Nothing here catches a CUDA
error: a failed kernel propagates (the scheduler's out-of-memory ladder
retries a stage whose allocation failed).
"""

import concurrent.futures
import itertools
import logging
import os
import pickle
import queue
import shutil
import struct
import tempfile
import threading
import time
import zlib

import numpy as np
import torch

from dpark_tpu_torch import conf
from dpark_tpu_torch.backend.cuda import collectives, fuse, kernels, layout
from dpark_tpu_torch.rdd import TextFileRDD, _ColumnarSlice, _fst
from dpark_tpu_torch.shuffle import SpillCorruption, spill_crc

logger = logging.getLogger("dpark_tpu_torch.executor")


def _even_ranges(n, parts):
    base, extra = divmod(n, parts)
    out, lo = [], 0
    for d in range(parts):
        hi = lo + base + (1 if d < extra else 0)
        out.append((lo, hi))
        lo = hi
    return out


def _reslice_parts(slices, ndev):
    """Re-split host partitions to the shard count (shuffle-map stages
    only: the write redistributes by key)."""
    from dpark_tpu_torch.rdd import _ColumnarSlice
    if slices and all(isinstance(s, _ColumnarSlice) for s in slices):
        ncols = len(slices[0].columns)
        cols = [np.concatenate([np.asarray(s.columns[i]) for s in slices])
                for i in range(ncols)]
        return [_ColumnarSlice([c[lo:hi] for c in cols])
                for lo, hi in _even_ranges(len(cols[0]), ndev)]
    rows = [r for s in slices for r in s]
    return [rows[lo:hi] for lo, hi in _even_ranges(len(rows), ndev)]


def _rows_of(slices, starts, lo, hi):
    """Rows [lo, hi) of the concatenation of columnar `slices` (whose
    first rows sit at `starts`) as a _ColumnarSlice: views where one
    slice holds them, one copy of the range where it spans several."""
    pieces = []
    for s, st in zip(slices, starts):
        a, b = max(lo, st), min(hi, st + len(s))
        if a < b:
            pieces.append([c[a - st:b - st] for c in s.columns])
    if len(pieces) == 1:
        return _ColumnarSlice(pieces[0])
    if not pieces:
        return _ColumnarSlice([c[:0] for c in slices[0].columns])
    return _ColumnarSlice([np.concatenate([p[i] for p in pieces])
                           for i in range(len(pieces[0]))])


def _prefetch_iter(it):
    """Run `it` in a background thread, one item ahead: the host
    slices wave k+1 and copies it to the device while the device
    computes wave k.  If the consumer abandons the generator, the
    producer is told to stop and the source iterator is closed from the
    producer thread."""
    q = queue.Queue(maxsize=1)
    done = object()
    stop = threading.Event()

    def _put(x):
        while not stop.is_set():
            try:
                q.put(x, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def run():
        try:
            for x in it:
                if not _put(x):
                    return
            _put(done)
        except BaseException as e:          # re-raised in the consumer
            _put(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                try:
                    close()
                except BaseException:
                    pass

    threading.Thread(target=run, daemon=True,
                     name="dpark-wave-prefetch").start()
    try:
        while True:
            x = q.get()
            if x is done:
                return
            if isinstance(x, BaseException):
                raise x
            yield x
    finally:
        stop.set()


def _async_d2h(tensors):
    """Start device-to-host copies of `tensors` into pinned memory
    without blocking; returns (host tensors, event recorded behind the
    copies).  The wave loop reads them one wave later, after the event:
    a pinned copy returns before its data is there (and a pageable one
    would block here, losing the overlap).  CPU tensors pass through."""
    if tensors[0].device.type != "cuda":
        return list(tensors), None
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


class _StreamStats:
    """Per-stream accounting: ingest / compute / exchange / spill
    seconds, per-wave ms, and a host-observed device-idle share from the
    union of each wave's busy span (its first dispatch to the host read
    of its outputs): a wave's span covers its neighbours' host work, so
    the overlap shows as a lower idle share."""

    PER_WAVE_CAP = 128

    def __init__(self):
        self._clock = time.perf_counter
        self.t0 = self._clock()
        self.waves = 0
        self.ingest_s = 0.0
        self.compute_s = 0.0
        self.exchange_s = 0.0
        self.spill_s = 0.0
        self.spilled_rows = 0
        self.spill_bytes = 0
        self._busy = []              # (start, end) device-busy spans
        self.per_wave = []           # bounded per-wave ms dicts

    def now(self):
        return self._clock()

    def add_busy(self, start, end):
        if end > start:
            self._busy.append((start, end))

    def wave_done(self, ingest_s, compute_s, exchange_s):
        self.waves += 1
        self.ingest_s += ingest_s
        self.compute_s += compute_s
        self.exchange_s += exchange_s
        if len(self.per_wave) < self.PER_WAVE_CAP:
            self.per_wave.append({
                "ingest_ms": round(ingest_s * 1e3, 2),
                "compute_ms": round(compute_s * 1e3, 2),
                "exchange_ms": round(exchange_s * 1e3, 2),
                "spill_ms": 0.0})

    def add_spill(self, seconds, wave):
        self.spill_s += seconds
        if wave < len(self.per_wave):
            self.per_wave[wave]["spill_ms"] = round(
                self.per_wave[wave]["spill_ms"] + seconds * 1e3, 2)

    def _busy_union(self, until):
        total = 0.0
        end_prev = None
        for s, e in sorted(self._busy):
            e = min(e, until)
            if end_prev is None or s > end_prev:
                total += max(0.0, e - s)
                end_prev = e
            elif e > end_prev:
                total += e - end_prev
                end_prev = e
        return total

    def snapshot(self):
        now = self._clock()
        wall = max(now - self.t0, 1e-9)
        idle = max(0.0, wall - self._busy_union(now))
        return {
            "waves": self.waves,
            "ingest_ms": round(self.ingest_s * 1e3, 1),
            "compute_ms": round(self.compute_s * 1e3, 1),
            "exchange_ms": round(self.exchange_s * 1e3, 1),
            "spill_ms": round(self.spill_s * 1e3, 1),
            "spilled_rows": self.spilled_rows,
            "spill_bytes": self.spill_bytes,
            "wall_ms": round(wall * 1e3, 1),
            "device_idle_frac": round(idle / wall, 4),
            "per_wave": list(self.per_wave),
        }


def _write_run(path, cols):
    """One spilled run (a list of column arrays) to disk: pickled,
    zlib-compressed, framed with its crc32; written to a temporary name
    and renamed, so a failed write never leaves a partial run.  Returns
    the bytes written."""
    blob = zlib.compress(pickle.dumps(cols, -1), 1)
    tmp = "%s.tmp-%d-%d" % (path, os.getpid(), threading.get_ident())
    try:
        with open(tmp, "wb") as f:
            f.write(struct.pack("<I", spill_crc(blob)))
            f.write(blob)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return 4 + len(blob)


def _read_run(path):
    """A spilled run's columns; SpillCorruption when its crc fails."""
    with open(path, "rb") as f:
        raw = f.read()
    (crc,) = struct.unpack("<I", raw[:4])
    blob = raw[4:]
    if spill_crc(blob) != crc:
        raise SpillCorruption("spill run %s: crc32 mismatch (corrupted "
                              "run)" % path)
    return pickle.loads(zlib.decompress(blob))


class _SpillWriter:
    """Background run writer of the spilled-run stream: pickling,
    compression and the write happen on a thread with a bounded queue.
    A writer error surfaces on the next put() or at finish(); abort()
    drops queued runs and joins."""

    def __init__(self, depth=4):
        self._q = queue.Queue(maxsize=depth)
        self._err = None
        self._stop = threading.Event()
        self.bytes = 0
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="dpark-spill-writer")
        self._thread.start()

    def _run(self):
        while True:
            try:
                item = self._q.get(timeout=0.5)
            except queue.Empty:
                if self._stop.is_set():
                    return          # aborted and drained
                continue
            try:
                if item is None:
                    return
                if self._stop.is_set():
                    continue        # aborted: drain without writing
                try:
                    self.bytes += _write_run(*item)
                except BaseException as e:
                    self._err = e
                    self._stop.set()
            finally:
                self._q.task_done()

    def _raise_pending(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def put(self, path, cols):
        self._raise_pending()
        self._q.put((path, cols))

    def finish(self):
        """Wait for every queued run to reach the disk; re-raise a writer
        error.  Called before the shuffle registers."""
        self._q.join()
        self._q.put(None)
        self._thread.join()
        self._raise_pending()

    def abort(self):
        self._stop.set()
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass
        self._thread.join(timeout=10)


class _RunPremerger:
    """Export bridge of the spilled runs: merges a partition's key-sorted
    runs (one a wave) into one run, in the background once the stream
    ends, or at the first fetch that finds it unmerged.  ensure(rid) is
    once per partition, behind a lock per partition."""

    def __init__(self, runs, spool, key_cols=1):
        self._runs = runs            # the list object the store holds
        self._spool = spool
        self._key_cols = max(1, key_cols)
        self._locks = [threading.Lock() for _ in runs]
        self._merged = [len(p) <= 1 for p in runs]
        self._stop = threading.Event()
        self._thread = None

    def start_background(self):
        self._thread = threading.Thread(
            target=self._walk, daemon=True, name="dpark-run-premerge")
        self._thread.start()

    def _walk(self):
        for rid in range(len(self._runs)):
            if self._stop.is_set():
                return
            try:
                self.ensure(rid)
            except Exception:   # the export merges inline and raises
                pass

    def ensure(self, rid):
        """Merge partition `rid`'s runs if not yet merged; returns its
        run paths (one key-sorted run once merged)."""
        with self._locks[rid]:
            if self._merged[rid]:
                return self._runs[rid]
            paths = self._runs[rid]
            parts = [_read_run(p) for p in paths]
            cols = [np.concatenate([pt[li] for pt in parts])
                    for li in range(len(parts[0]))]
            # lexicographic over every key column, stable: equal keys
            # keep their run order for the export's adjacent fold
            order = _key_order(cols, self._key_cols)
            cols = [c[order] for c in cols]
            merged = os.path.join(self._spool, "merged-%d" % rid)
            _write_run(merged, cols)
            self._runs[rid] = [merged]
            self._merged[rid] = True
            for p in paths:
                try:
                    os.unlink(p)
                except OSError:
                    pass
            return self._runs[rid]

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60)


def _key_order(cols, nk):
    """Stable lexicographic order of rows by their first nk columns."""
    nk = min(nk, len(cols))
    if nk == 1:
        return np.argsort(cols[0], kind="stable")
    return np.lexsort(tuple(cols[:nk][::-1]))


class TorchExecutor:
    def __init__(self, ndev, device):
        self.ndev = layout.make_mesh(ndev)
        self.device = torch.device(device)
        self.shuffle_store = {}       # sid -> stored map output
        # one budget over the device-resident shuffle stores
        # (conf.SHUFFLE_HBM_BUDGET, _evict_hbm): their bytes, the bytes
        # of the device result cache (its tier, ROADMAP A19, is not
        # ported: always 0), and an LRU clock a fetch advances
        self._store_bytes = 0
        self._result_bytes = 0
        self._hbm_seq = 0
        # jobs running on the owning scheduler: their stores spill only
        # after every completed job's; current_job stamps new stores
        self.live_jobs = set()
        self.current_job = None
        self._pinned = set()          # stores the running stage reads
        self.spills = []              # one record a store spilled
        self.last_stream_stats = None
        self.last_wave_budget = None
        self._spool_seq = 0
        self.token_dict = None        # text ingest's string -> id dict
        self.last_text_stats = None

    # ------------------------------------------------------------------
    # running
    # ------------------------------------------------------------------
    def run_stage(self, plan, wave_budget=None):
        """Run the whole stage for all shards.  Returns ("shuffle", sid),
        ("counts", [n per shard]), ("reduced", [(value, n) per shard]) or
        ("result", [rows per shard]).  `wave_budget` overrides the wave
        budget of a columnar input (the out-of-memory ladder's retry);
        the budget used is left in last_wave_budget."""
        self.last_stream_stats = None
        self.last_wave_budget = None
        self.last_text_stats = None
        # the stores this stage reads stay on the device until it has
        # read them (_fetch_store)
        self._pinned = self._plan_reads(plan)
        try:
            return self._run_stage_plan(plan, wave_budget)
        finally:
            self._pinned = set()

    @classmethod
    def _plan_reads(cls, plan):
        """The shuffle ids of the stores a plan's source reads."""
        kind, arg = plan.source[0], plan.source[1]
        if kind == "hbm":
            return {arg.shuffle_id}
        if kind == "join":
            return {dep.shuffle_id for dep in arg}
        if kind == "union":
            return set().union(*(cls._plan_reads(sub) for sub in arg))
        return set()

    def _run_stage_plan(self, plan, wave_budget):
        mode = self._stream_mode(plan, wave_budget)
        if mode is not None:
            kind, waves = mode
            if kind == "combine":
                return self._run_streamed_shuffle(plan, waves)
            return self._run_streamed_nocombine(plan, waves)
        if plan.logical_spill:
            # admission streams only an input above the wave threshold,
            # with the same predicate: a safety net, not a route
            raise ValueError("logical_spill plan without streaming")
        batch = self._source_batch(plan, plan.epilogue is not None)
        outs = self._run_narrow(plan, batch)
        return self._finish_stage(plan, outs)

    def _source_batch(self, plan, keyed):
        """The plan's source as a Batch, before its narrow ops (a whole
        stage's, or a union branch's sub-plan).  `keyed`: the stage
        writes a shuffle, so an ingested key equal to the sentinel takes
        the host path."""
        kind = plan.source[0]
        if kind == "ingest":
            return self._ingest(plan, keyed)
        if kind == "text":
            return self._ingest_text(plan)
        if kind == "join":
            return self.device_join_batch(*plan.source[1])
        if kind == "union":
            return self._union_batch(plan, keyed)
        if plan.ops and isinstance(plan.ops[0], fuse.SegMapOp):
            # segmented apply: sort the rows, read the size-class
            # histogram, set the op's bucket layout
            return self._run_seg_map(plan)
        return self._exchange_and_reduce(plan)

    def _union_batch(self, plan, keyed):
        """B16: each branch's source and narrow ops, then K16 packs the
        branches' valid rows per shard, branch after branch (one host
        read of every branch's counts sizes the union).  The tail past
        each shard's total holds the key sentinel in leaf 0 when leaf 0
        is a key column, zeros elsewhere."""
        branches = []
        for sub in plan.source[1]:
            lv, n = self._apply_ops(sub, self._source_batch(sub, keyed))
            branches.append(([leaf.contiguous() for leaf in lv],
                             n.to(torch.int32)))
        k0 = branches[0][0][0]
        key_leaf = (0 if k0.dim() == 2 and k0.dtype in (
            torch.int64, torch.int32, torch.float64) else None)
        fill = collectives._sentinel(k0.dtype) if key_leaf == 0 else 0
        leaves, totals = kernels.union_concat(branches, key_leaf, fill)
        return layout.Batch(plan.in_treedef, leaves, totals)

    def _ingest(self, plan, keyed):
        slices = plan.source[1]._slices
        if plan.reslice:
            slices = _reslice_parts(slices, self.ndev)
        # a shuffle write pads with the key sentinel: a real key equal to
        # it must take the host path (HostPath, before any device work)
        return layout.ingest(self.ndev, self.device, slices,
                             plan.in_treedef, plan.in_specs,
                             key_leaf=0 if keyed else None)

    def _exchange_and_reduce(self, plan):
        """Reduce side: K4 exchange of the stored map output, then the
        key sort and, unless the shuffle repartitions only, K3 merge."""
        dep = plan.source[1]
        store = self._fetch_store(dep.shuffle_id)
        nk = plan.src_nk
        if store.get("pre_reduced"):
            # a streamed combine: shard d holds partition d combined
            return layout.Batch(plan.in_treedef, store["leaves"],
                                store["counts"])
        if "host_runs" in store:
            # SegAggOp over spilled runs (admission admits no other op)
            return self._seg_batch_from_runs(store)
        if store["no_combine"]:
            return self._exchange_sorted(store, nk, plan.in_treedef)
        recv, n = collectives.exchange(store["leaves"], store["counts"],
                                       store["offsets"])
        monoid = fuse.classify_merge(dep.aggregator.merge_combiners)
        ks, vs, n_unique = collectives.segment_reduce_keys(
            recv[:nk], recv[nk:], n, plan.src_merge, monoid=monoid)
        return layout.Batch(plan.in_treedef, list(ks) + list(vs), n_unique)

    @staticmethod
    def _exchange_sorted(store, nk, treedef):
        """The no-combine reduce side: K4 exchange, then a sort by the
        full key (padding holds the sentinel: last); equal keys keep
        their arrival order, source-major."""
        recv, n = collectives.exchange(store["leaves"], store["counts"],
                                       store["offsets"])
        packed = collectives._lex_sort(recv, nk)
        return layout.Batch(treedef, list(packed), n)

    # ------------------------------------------------------------------
    # cogroup and join over no-combine shuffles kept on the device
    # ------------------------------------------------------------------
    def gather_rows(self, dep):
        """One no-combine shuffle's rows, exchanged and key-sorted on the
        device: per-partition (k, v) row lists on the host (a cogroup's
        host merge consumes them), string keys decoded."""
        store = self._fetch_store(dep.shuffle_id)
        batch = self._exchange_sorted(store, store["key_cols"],
                                      store["out_treedef"])
        return [self._maybe_decode(store, rows)
                for rows in layout.egest(batch)]

    def run_device_join(self, dep_a, dep_b):
        """a.join(b) over two device-resident no-combine shuffles:
        per-partition (k, (va, vb)) row lists on the host.  Both sides of
        a string-keyed join encode through the one token dict, so id
        equality is string equality; the keys decode here."""
        store_a = self.shuffle_store[dep_a.shuffle_id]
        return [self._maybe_decode(store_a, rows) for rows in
                layout.egest(self.device_join_batch(dep_a, dep_b))]

    def device_join_batch(self, dep_a, dep_b):
        """Inner join of two device-resident no-combine shuffles as a
        Batch of (k, (va, vb)) rows (the "join" source of a stage: keys
        stay on the device for the narrow ops and any shuffle write).
        Both sides: K4 exchange and K5 key sort; then K12's ranges and
        per-shard totals, one host read of the largest total to size the
        output (layout.round_capacity), and K12's expansion.  Rows come
        in A's key order, equal keys in A's then B's arrival order."""
        store_a = self._fetch_store(dep_a.shuffle_id)
        store_b = self._fetch_store(dep_b.shuffle_id)
        nk = store_a["key_cols"]
        a = self._exchange_sorted(store_a, nk, store_a["out_treedef"])
        b = self._exchange_sorted(store_b, nk, store_b["out_treedef"])
        ranges = collectives.join_key_ranges(a.cols[:nk], a.counts,
                                             b.cols[:nk], b.counts)
        totals = ranges[3]
        cap_out = layout.round_capacity(int(totals.max().item()) or 1)
        if cap_out >= 2 ** 31:
            raise ValueError("a join shard of %d rows exceeds the int32 "
                             "row counts" % int(totals.max().item()))
        leaves = collectives.join_expand(a.cols, b.cols[nk:], ranges,
                                         a.counts, cap_out)
        return layout.Batch(fuse.joined_treedef(store_a["out_treedef"],
                                                store_b["out_treedef"]),
                            leaves, totals.to(torch.int32))

    # ------------------------------------------------------------------
    # segmented apply: groupByKey().mapValues(traceable f) as a vmap over
    # power-of-two padded group classes.  Two phases: sort the rows and
    # read the class histogram, then apply with that layout.
    # ------------------------------------------------------------------
    def _run_seg_map(self, plan):
        op = plan.ops[0]
        store = self._fetch_store(plan.source[1].shuffle_id)
        if "host_runs" in store:
            batch = self._seg_batch_from_runs(store)
            table = collectives._segment_table(batch.cols[:op.nk],
                                               batch.counts, want_keys=True)
        else:
            batch, table = self._seg_exchange_sorted(store, op.nk,
                                                     plan.in_treedef)
        op.table = table
        op.layout = self._seg_bucket_layout(table[4])
        return batch

    def _seg_exchange_sorted(self, store, nk, treedef):
        """K4 exchange and K5 key sort, then K7's segment table (start
        rows, sizes, size classes, histogram, segment keys) in one pass
        over the received rows."""
        batch = self._exchange_sorted(store, nk, treedef)
        table = collectives._segment_table(batch.cols[:nk], batch.counts,
                                           want_keys=True)
        return batch, table

    @staticmethod
    def _seg_bucket_layout(hist):
        """((class, width, G), ...) of the non-empty power-of-two size
        classes, G the class's most groups on any shard rounded to a
        power-of-two capacity (hash skew across shards cannot overflow
        it); one empty class when there are no groups."""
        gmax = hist.cpu().numpy().max(axis=0)
        lay = tuple((b, 1 << b, layout.round_capacity(int(g)))
                    for b, g in enumerate(gmax.tolist()) if g)
        return lay or ((0, 1, 8),)

    def _epilogue_merge(self, plan):
        """(merge_fn, monoid) of a combining shuffle write.  A classified
        monoid stands in for an untraceable user merge only over exactly
        one int64/float64 value leaf (the host merges whole records); with
        neither, the write exchanges raw combiners and the host merges."""
        dep = plan.epilogue[1]
        nk = plan.epi_nk
        monoid = fuse.classify_merge(dep.aggregator.merge_combiners)
        merge_fn = fuse.probe_merge(dep.aggregator.merge_combiners,
                                    plan.out_treedef, plan.out_specs, nk)
        values = plan.out_specs[nk:]
        if monoid is not None and not (
                len(values) == 1 and np.dtype(values[0][0]) in (
                    np.dtype(np.int64), np.dtype(np.float64))):
            monoid = None
        return merge_fn, monoid

    @staticmethod
    def merge_routes(plan):
        """The routes of the traced merges a stage ran ("K14", or why the
        merge kept the plain scan), by side: "read" for the merge of its
        combining shuffle source, "write" for its shuffle write's; a side
        that a classified single-leaf monoid merges (K3) is left out."""
        routes = {}
        if plan.src_merge is not None:
            vals = plan.in_specs[plan.src_nk:]
            monoid = fuse.classify_merge(
                plan.source[1].aggregator.merge_combiners)
            if not (monoid is not None and len(vals) == 1 and np.dtype(
                    vals[0][0]) in (np.dtype(np.int64),
                                    np.dtype(np.float64))):
                routes["read"] = getattr(plan.src_merge, "route", None)
        if plan.merge_probe is not None:
            merge_fn, monoid = plan.merge_probe
            if merge_fn is not None and monoid is None:
                routes["write"] = getattr(merge_fn, "route", None)
        return routes

    def _merge_probe(self, plan):
        """_epilogue_merge once a plan (a stream probes it every wave)."""
        if plan.merge_probe is None:
            plan.merge_probe = self._epilogue_merge(plan)
        return plan.merge_probe

    @staticmethod
    def _apply_ops(plan, batch):
        lv, n = list(batch.cols), batch.counts
        for op in plan.ops:
            lv, n = op.apply(lv, n)
        return lv, n

    def _run_narrow(self, plan, batch):
        """Narrow ops, then the shuffle write when the stage has one.
        Returns ("rows", Batch) or ("shuffle", counts, offsets, leaves)."""
        lv, n = self._apply_ops(plan, batch)
        if plan.epilogue is None:
            return ("rows", layout.Batch(plan.out_treedef, lv, n))
        return ("shuffle",) + self._epilogue_block(plan, lv, n)

    def _epilogue_block(self, plan, lv, n):
        """Shuffle-write tail: destinations over the logical partition
        count r <= N (K1 hash or K6 range), then a plain bucketize (K2)
        for a no-combine write or, over a combining hash write,
        bucketize-combine (K5 sort, K2, K3) — or a plain bucketize of raw
        combiners when no merge is usable."""
        nk = plan.epi_nk
        r = plan.epilogue[1].partitioner.num_partitions
        n_dst = self.ndev
        if plan.no_combine:
            if plan.epi_spec[0] == "range":
                # the bounds: one (m, nk) device tensor per stage
                bounds = torch.from_numpy(plan.epi_bounds).to(self.device)
                dst, hist = collectives.range_dst_cols(
                    lv[:nk], bounds, plan.epi_spec[1], n_dst, n, r)
            else:
                dst, hist, _ = collectives.hash_dst_cols(
                    lv[:nk], n_dst, n, r, want_hist=True)
            leaves, cnts, offs = collectives.bucketize(lv, n, n_dst, dst,
                                                       hist)
            return cnts, offs, leaves
        merge_fn, monoid = self._merge_probe(plan)
        if merge_fn is not None or monoid is not None:
            dst, _, hsh = collectives.hash_dst_cols(
                lv[:nk], n_dst, n, r, want_hash=nk > 1)
            ks, vs, cnts, offs = collectives.bucketize_combine_keys(
                lv[:nk], lv[nk:], n, n_dst, merge_fn, monoid=monoid,
                dst=dst, order_col=hsh)
            return cnts, offs, list(ks) + list(vs)
        dst, hist, _ = collectives.hash_dst_cols(lv[:nk], n_dst, n, r,
                                                 want_hist=True)
        leaves, cnts, offs = collectives.bucketize(lv, n, n_dst, dst, hist)
        return cnts, offs, leaves

    # ------------------------------------------------------------------
    # the out-of-core wave stream: an input above the wave threshold
    # feeding a shuffle write, one wave of at most `chunk` rows a shard
    # at a time
    # ------------------------------------------------------------------
    def _stream_mode(self, plan, wave_budget=None):
        """None, or ("combine" | "nocombine", wave iterator); each wave
        is a list of per-shard _ColumnarSlice parts.  The one
        eligibility predicate is fuse._wave_rows, which admission reads
        too: a divergence would turn the safety net in run_stage into a
        user-facing error."""
        if plan.epilogue is None:
            return None
        if plan.source[0] == "text":
            # text above conf.STREAM_TEXT_BYTES: waves of whole splits
            if not fuse._big_text(plan.stage):
                return None
            waves = self._wave_iter_text(plan)
        elif plan.source[0] == "ingest":
            pc = plan.source[1]
            limit = wave_budget or fuse._wave_limit(pc, self.device,
                                                    self.ndev)
            if limit is None:
                return None
            self.last_wave_budget = int(limit)
            chunk = fuse._wave_rows(pc, self.device, self.ndev,
                                    plan.reslice, limit)
            if chunk is None:
                return None
            self._check_wave_oom(chunk)
            waves = self._wave_iter_columnar(plan, chunk)
        else:
            return None
        dep = plan.epilogue[1]
        if fuse.is_list_agg(dep.aggregator):
            return ("nocombine", waves)
        merge_fn, monoid = self._merge_probe(plan)
        if ((merge_fn is not None or monoid is not None)
                and dep.partitioner.num_partitions <= self.ndev):
            return ("combine", waves)
        # more partitions than shards (the per-shard state cannot hold
        # them: the spilled stream pre-reduces each wave on the device),
        # or an untraceable merge (created combiners spill, the user's
        # merge folds them at export)
        return ("nocombine", waves)

    @staticmethod
    def _check_wave_oom(chunk_rows):
        """The emulated memory ceiling (conf.EMULATED_WAVE_OOM_ROWS): a
        wave budget above it raises the out-of-memory class the
        scheduler's ladder halves on."""
        limit = conf.EMULATED_WAVE_OOM_ROWS
        if limit and chunk_rows > limit:
            raise MemoryError(
                "RESOURCE_EXHAUSTED: emulated HBM ceiling: wave "
                "budget %d rows/device exceeds "
                "DPARK_EMULATED_WAVE_OOM_ROWS=%d" % (chunk_rows, limit))

    def _wave_iter_columnar(self, plan, chunk):
        """Per-shard parts of each wave: rows [c*chunk, (c+1)*chunk) of
        every shard.  A re-sliced input's shard d is the d-th even range
        of the concatenated slices, cut a wave at a time (the input is
        never concatenated whole)."""
        slices = plan.source[1]._slices
        if plan.reslice:
            starts = np.cumsum([0] + [len(s) for s in slices[:-1]])
            total = sum(len(s) for s in slices)
            ranges = _even_ranges(total, self.ndev)
        else:
            starts = None
            ranges = [(0, len(s)) for s in slices]
        longest = max(hi - lo for lo, hi in ranges)
        for c in range(-(-longest // chunk)):
            parts = []
            for d, (lo, hi) in enumerate(ranges):
                a = min(hi, lo + c * chunk)
                b = min(hi, lo + (c + 1) * chunk)
                if starts is None:
                    parts.append(_ColumnarSlice(
                        [col[a:b] for col in slices[d].columns]))
                else:
                    parts.append(_rows_of(slices, starts, a, b))
            yield parts

    def _ingest_stage(self, plan, waves, stats, side):
        """Host columns -> device Batch, a wave at a time; yields (batch,
        ready event or None, ingest seconds).  On a CUDA device the
        copies run on the side stream, behind an event the compute
        stream waits on."""
        try:
            for parts in waves:
                t0 = stats.now()
                ready = None
                if side is None:
                    batch = layout.ingest(self.ndev, self.device, parts,
                                          plan.in_treedef, plan.in_specs,
                                          key_leaf=0, fine=True)
                else:
                    with torch.cuda.stream(side):
                        batch = layout.ingest(self.ndev, self.device, parts,
                                              plan.in_treedef,
                                              plan.in_specs, key_leaf=0,
                                              fine=True)
                        ready = torch.cuda.Event()
                        ready.record(side)
                yield batch, ready, stats.now() - t0
        finally:
            waves.close()

    def _stream_batches(self, plan, waves, stats):
        """The slicing and the ingest on one thread: wave k+1 is cut
        and copied to the device while wave k computes (one ingested
        wave queued, one in flight).  Yields (batch, ingest seconds)
        with the batch ready for the compute stream."""
        side = (torch.cuda.Stream(self.device)
                if self.device.type == "cuda" else None)
        batches = _prefetch_iter(self._ingest_stage(plan, waves, stats,
                                                    side))
        try:
            for batch, ready, ingest_s in batches:
                if ready is not None:
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(ready)
                    # the allocator must not hand these blocks to the
                    # side stream again before the compute stream is done
                    for t in batch.cols + [batch.counts]:
                        t.record_stream(cur)
                yield batch, ingest_s
        finally:
            batches.close()

    def _run_streamed_shuffle(self, plan, waves):
        """A combining write with at most one partition a shard: each
        wave runs the narrow ops and the combining write (K1, K5, K2, K3),
        K4's exchange, and merges what it received into the per-shard
        state (B6: K5 + K3).  The result is a `pre_reduced` store: shard
        d holds partition d fully combined."""
        merge_fn, monoid = self._merge_probe(plan)
        stats = _StreamStats()
        state = None                    # (leaves, counts) combined so far
        batches = self._stream_batches(plan, waves, stats)
        try:
            for batch, ingest_s in batches:
                t_disp = stats.now()
                cnts, offs, leaves = self._epilogue_block(
                    plan, *self._apply_ops(plan, batch))
                del batch
                t_x = stats.now()
                recv, rn = collectives.exchange(leaves, cnts, offs)
                del leaves
                exchange_s = stats.now() - t_x
                state = self._shrink_state(self._merge_into_state(
                    plan, state, recv, rn, monoid, merge_fn))
                del recv
                stats.add_busy(t_disp, stats.now())
                stats.wave_done(ingest_s,
                                (stats.now() - t_disp) - exchange_s,
                                exchange_s)
        finally:
            batches.close()
        self.last_stream_stats = stats.snapshot()
        leaves, counts = state
        return self._register_shuffle(plan, {
            "leaves": leaves, "counts": counts, "offsets": None,
            "pre_reduced": True,            # shard d holds partition d
            "single_map": True,
        })

    def _merge_into_state(self, plan, state, recv, rn, monoid, merge_fn):
        """The received rows and the running state, merged into the new
        per-shard unique-key state: both padded with the key sentinel in
        key column 0, side by side, then K5's key sort and K3's merge
        (K14 first for a traced merge)."""
        nk = plan.epi_nk
        if state is not None:
            st_leaves, st_n = state
            recv = [torch.cat([a, b], 1) for a, b in zip(st_leaves, recv)]
            rn = st_n + rn
        ks, vs, n = collectives.segment_reduce_keys(
            recv[:nk], recv[nk:], rn, merge_fn, monoid=monoid)
        return list(ks) + list(vs), n

    @staticmethod
    def _shrink_state(state):
        """The state cut to the capacity class its counts need (one host
        read a wave), so it grows with the distinct keys, not the
        waves."""
        leaves, counts = state
        want = layout.round_capacity(int(counts.max().item()) or 1)
        if leaves[0].shape[1] > want:
            leaves = [leaf[:, :want].contiguous() for leaf in leaves]
        return leaves, counts

    def _rid_over(self, plan, lv, n, r):
        """Each row's logical partition in [0, r) (K1 hash or K6 range;
        r on padding rows)."""
        nk = plan.epi_nk
        if plan.epi_spec[0] == "range":
            bounds = torch.from_numpy(plan.epi_bounds).to(self.device)
            return collectives.range_dst_cols(
                lv[:nk], bounds, plan.epi_spec[1], r, n, r)[0]
        return collectives.hash_dst_cols(lv[:nk], r, n, r)[0]

    def _stream_map(self, plan, batch, r, pre):
        """The spilled stream's map side (the reference's
        _compile_stream_nocombine): the narrow ops, then with r <= N the
        stage's own write; with r > N the rid over r and, with a usable
        merge (`pre`), B12 (K13, K5, K2, K3), else K13 and K2 with the
        int64 rid riding as the first leaf.  Returns (counts, offsets,
        leaves)."""
        lv, n = self._apply_ops(plan, batch)
        if r <= self.ndev:
            return self._epilogue_block(plan, lv, n)
        nk = plan.epi_nk
        rid = self._rid_over(plan, lv, n, r)
        if pre is not None:
            merge_fn, monoid = pre
            leaves, cnts, offs = collectives.bucketize_combine_rid(
                rid, lv[:nk], lv[nk:], n, self.ndev, merge_fn,
                monoid=monoid)
            return cnts, offs, leaves
        dev, rid64, hist = kernels.rid_fold(rid, n, self.ndev)
        leaves, cnts, offs = collectives.bucketize([rid64] + lv, n,
                                                   self.ndev, dev, hist)
        return cnts, offs, leaves

    @staticmethod
    def _rid_prefixed_treedef(plan):
        """plan.out_treedef with the rid column prepended flat: rows read
        (rid, k, v...)."""
        nl = layout.num_leaves(plan.out_treedef)
        rec = layout.tree_unflatten(plan.out_treedef,
                                    list(range(1, 1 + nl)))
        return layout.tree_flatten((0,) + tuple(rec))[1]

    def _sort_received(self, plan, recv, rn, nkeys):
        """A wave's received rows sorted per shard by their first `nkeys`
        leaves (K5); a rid column beyond the plan's leaves rides first."""
        packed = collectives._lex_sort(recv, nkeys)
        treedef = plan.out_treedef
        if len(recv) > len(plan.out_specs):
            treedef = self._rid_prefixed_treedef(plan)
        return layout.Batch(treedef, list(packed), rn)

    def _prereduce_received(self, plan, recv, rn, merge_fn, monoid):
        """A wave's received rows merged per (rid, key) (K5 + K3, K14
        first for a traced merge): the spilled runs
        hold one combiner a distinct key a wave."""
        nk = plan.epi_nk
        ks, vs, n = collectives.segment_reduce_keys(
            recv[:1 + nk], recv[1 + nk:], rn, merge_fn, monoid=monoid)
        return layout.Batch(self._rid_prefixed_treedef(plan),
                            list(ks) + list(vs), n)

    def _spill_wave(self, spool, runs, carry_rid, wave, host, writer,
                    stats):
        """The host side of one wave's spill: wait for the wave's
        device-to-host copy (started when its sort was dispatched), cut
        each shard's valid rows into one run a logical partition, and
        hand the runs to the writer."""
        t0 = stats.now()
        tensors, ready = host
        if ready is not None:
            ready.synchronize()
        counts = tensors[0].numpy()
        cols = [t.numpy() for t in tensors[1:]]
        read_done = stats.now()

        def put(path, rid, run_cols):
            stats.spilled_rows += len(run_cols[0])
            writer.put(path, run_cols)
            runs[rid].append(path)

        for d in range(self.ndev):
            n = int(counts[d])
            if not n:
                continue
            if not carry_rid:            # the shard IS the partition
                # copies: a view would pin the wave's host columns
                put(os.path.join(spool, "%d-%d" % (d, wave)), d,
                    [np.array(col[d, :n]) for col in cols])
                continue
            rid = cols[0][d, :n]
            uniq = np.unique(rid)
            los = np.searchsorted(rid, uniq, side="left")
            his = np.searchsorted(rid, uniq, side="right")
            for u, lo, hi in zip(uniq.tolist(), los.tolist(), his.tolist()):
                put(os.path.join(spool, "%d-%d-%d" % (u, wave, d)), u,
                    [np.array(col[d, lo:hi]) for col in cols[1:]])
        stats.add_spill(stats.now() - t0, wave)
        return read_done

    def _run_streamed_nocombine(self, plan, waves):
        """A no-combine write (sortByKey's range shuffle, groupByKey,
        partitionBy), an untraceable merge, or more partitions than
        shards, over an input above the wave threshold: each wave runs
        the map side (_stream_map), K4's exchange, and the receive side
        (K5 by (rid, key), or K5 + K3 with a merge), then spills one
        key-sorted column run a logical partition to a fresh spool.  The
        device holds one wave; the host one wave of columns.  Wave k's
        runs are read back and spilled while wave k+1 computes; a
        thread writes them, and another premerges each partition's runs
        once the stream ends."""
        dep = plan.epilogue[1]
        r = dep.partitioner.num_partitions
        nk = plan.epi_nk
        self._spool_seq += 1
        root = conf.spool_root()
        os.makedirs(root, exist_ok=True)
        # unique per run: a re-run never writes into (then deletes, with
        # the old store) the directory of the store it replaces
        spool = tempfile.mkdtemp(prefix="%d-%d-" % (dep.shuffle_id,
                                                    self._spool_seq),
                                 dir=root)
        runs = [[] for _ in range(r)]
        carry_rid = r > self.ndev
        host_combine = not fuse.is_list_agg(dep.aggregator)
        pre = None
        if carry_rid and host_combine:
            merge_fn, monoid = self._merge_probe(plan)
            if merge_fn is not None or monoid is not None:
                pre = (merge_fn, monoid)
        stats = _StreamStats()
        writer = _SpillWriter()
        pending = None          # (wave, host copy, dispatch time)
        batches = self._stream_batches(plan, waves, stats)
        ok = False
        try:
            for c, (batch, ingest_s) in enumerate(batches):
                t_disp = stats.now()
                cnts, offs, leaves = self._stream_map(plan, batch, r, pre)
                del batch
                t_x = stats.now()
                recv, rn = collectives.exchange(leaves, cnts, offs)
                del leaves
                exchange_s = stats.now() - t_x
                if pre is not None:
                    wave = self._prereduce_received(plan, recv, rn, *pre)
                else:
                    wave = self._sort_received(
                        plan, recv, rn, (1 + nk) if carry_rid else nk)
                del recv
                host = _async_d2h([wave.counts] + wave.cols)
                del wave
                stats.wave_done(ingest_s,
                                (stats.now() - t_disp) - exchange_s,
                                exchange_s)
                if pending is not None:
                    pw, ph, pd = pending
                    stats.add_busy(pd, self._spill_wave(
                        spool, runs, carry_rid, pw, ph, writer, stats))
                pending = (c, host, t_disp)
            if pending is not None:
                pw, ph, pd = pending
                stats.add_busy(pd, self._spill_wave(
                    spool, runs, carry_rid, pw, ph, writer, stats))
            writer.finish()
            stats.spill_bytes += writer.bytes
            ok = True
        finally:
            batches.close()
            if not ok:
                writer.abort()          # drop queued runs
                # the store never registers: nothing else removes it
                shutil.rmtree(spool, ignore_errors=True)
        self.last_stream_stats = stats.snapshot()
        premerge = _RunPremerger(runs, spool, key_cols=nk)
        premerge.start_background()
        return self._register_shuffle(plan, {
            "leaves": [], "counts": None, "offsets": None,
            "host_runs": runs, "spool_dir": spool, "premerge": premerge,
            "no_combine": not host_combine,
            # runs of a combining write hold CREATED combiners (merged
            # per wave when a merge traced); the export folds equal keys
            # with the user's merge_combiners
            "host_combine": host_combine,
            "agg": dep.aggregator if host_combine else None,
            "single_map": True,
        })

    def _partition_run_cols(self, store, rid):
        """One spilled partition's columns, key-sorted (the premerger's
        one run), or None when it has no runs."""
        runs = store["host_runs"]
        if rid >= len(runs) or not runs[rid]:
            return None
        pieces = [_read_run(p) for p in store["premerge"].ensure(rid)]
        return [np.concatenate([pt[li] for pt in pieces])
                for li in range(len(pieces[0]))]

    def _seg_batch_from_runs(self, store):
        """Premerged spilled runs -> a key-sorted Batch, partition d on
        shard d (admission takes such a source only for a segment op
        with r <= N).  A whole partition loads at once; runs above half
        the card's memory raise HostPath, and the host path consumes them
        through the export."""
        specs = store["out_specs"]
        budget = conf.device_bytes_limit(self.device) // 2
        total = 0
        parts = []
        for d in range(self.ndev):
            cols = self._partition_run_cols(store, d)
            if cols is None:
                parts.append(_ColumnarSlice(
                    [np.zeros((0,) + tuple(shape), dt)
                     for dt, shape in specs]))
                continue
            total += sum(int(c.nbytes) for c in cols)
            if budget and total > budget:
                raise layout.HostPath(
                    "spilled partitions (%d MB so far) exceed the device "
                    "load budget (%d MB): the host merges the runs"
                    % (total >> 20, budget >> 20))
            parts.append(_ColumnarSlice(cols))
        return layout.ingest(self.ndev, self.device, parts,
                             store["out_treedef"], specs)

    # ------------------------------------------------------------------
    # text ingest: the narrow chain over a text file runs as a host
    # prologue per split (the user's own generators, or for the verified
    # canonical wordcount the C++ tokenizer), string keys are
    # dictionary-encoded to int64 ids, then the device shuffle takes over
    # ------------------------------------------------------------------
    def _token_dict(self):
        if self.token_dict is None:
            from dpark_tpu_torch.native import TokenDict
            self.token_dict = TokenDict()
        return self.token_dict

    @staticmethod
    def _tokenizer_safe(data, sep=None):
        """True iff the ASCII byte tokenizer provably equals the Python
        chain on these bytes.  Whitespace mode (sep None): every byte is
        printable ASCII or \\t \\n \\r (bytes >= 0x80 may decode to
        unicode whitespace, and \\x0b \\x0c \\x1c-\\x1f are str.split()
        whitespace but not the tokenizer's).  Separator mode: only bytes
        >= 0x80 (utf-8 replacement may rewrite a token) are unsafe."""
        if not data:
            return True
        a = np.frombuffer(data, np.uint8)
        if sep is not None:
            return not bool((a >= 0x80).any())
        bad = (a >= 0x80) | ((a < 0x20) & (a != 9) & (a != 10) & (a != 13))
        return not bool(bad.any())

    @staticmethod
    def _verify_canonical(plan, data, td):
        """Run the user's own flatMap and map on this split's first 4 KiB
        of whole lines and compare with the C++ tokenizer: a divergence
        (or nothing to compare: a longer first line) keeps the host
        prologue for this run."""
        prefix = data[:4096]
        cut = prefix.rfind(b"\n")
        prefix = b"" if cut < 0 else prefix[:cut + 1]
        if not prefix:
            return False
        fm, mp = plan.text_chain
        expect = []
        # TextFileRDD's lines: \n-separated, trailing \r\n stripped
        for raw in prefix.split(b"\n")[:-1]:
            line = raw.rstrip(b"\r\n").decode("utf-8", "replace")
            for w in fm.f(line):
                rec = mp.f(w)
                if rec[1] != 1:
                    return False
                expect.append(rec[0])
        got = [td.decode(int(t))
               for t in td.encode(prefix, sep=plan.canonical_sep)]
        return got == expect

    @staticmethod
    def _encode_rows(plan, sp, td):
        """The host prologue for one split: the user's chain, its records
        as columns, string keys encoded (HostPath when a record does not
        fit the sampled types)."""
        keys = []
        leaf_lists = [[] for _ in plan.in_specs[1:]]
        for rec in plan.stage.rdd.iterator(sp):
            if not (isinstance(rec, tuple) and len(rec) == 2):
                raise layout.HostPath("records of mixed structure")
            k, v = rec
            if plan.encoded_keys:
                if not isinstance(k, str):
                    raise layout.HostPath("text chain keys of mixed types")
                k = td.put(k)
            leaves = layout.tree_leaves(v)
            if len(leaves) != len(leaf_lists):
                raise layout.HostPath("records of mixed structure")
            keys.append(k)
            for li, leaf in enumerate(leaves):
                leaf_lists[li].append(leaf)
        try:
            return [np.asarray(keys, np.int64)] + [
                np.asarray(ll, dt)
                for ll, (dt, _) in zip(leaf_lists, plan.in_specs[1:])]
        except (TypeError, ValueError, OverflowError) as e:
            raise layout.HostPath("records do not fit the sampled leaf "
                                  "types (%s)" % e) from e

    def _text_split_cols(self, plan, sp, td, state):
        """Columns of one split: the C++ tokenizer on the canonical path
        (the chain proven by bytecode, each split's bytes scanned, the
        first safe split verified against the user's functions), the
        user's own generators otherwise."""
        if state["canonical"]:
            sep = plan.canonical_sep
            data = TextFileRDD.split_bytes(sp)
            if not state["checked"] and self._tokenizer_safe(data[:4096],
                                                             sep):
                state["checked"] = True
                if not self._verify_canonical(plan, data, td):
                    state["canonical"] = False
            if state["canonical"] and self._tokenizer_safe(data, sep):
                ids = td.encode(data, sep=sep)
                state["cpp_splits"] += 1
                return [ids, np.ones(len(ids), np.int64)]
        state["prologue_splits"] += 1
        return self._encode_rows(plan, sp, td)

    def _text_parts(self, plan, chunks):
        """Per-split columns concatenated and cut into even per-shard
        parts, whatever the file's split layout (the hash exchange owns
        placement; the store is read through map 0, single_map)."""
        if chunks:
            cols = [np.concatenate([c[li] for c in chunks])
                    for li in range(len(plan.in_specs))]
        else:
            cols = [np.zeros((0,) + tuple(shape), dt)
                    for dt, shape in plan.in_specs]
        return [_ColumnarSlice([c[lo:hi] for c in cols])
                for lo, hi in _even_ranges(len(cols[0]), self.ndev)]

    def _split_cols_parallel(self, plan, splits, td, state):
        """Per-split columns, tokenized concurrently: after the first
        split that runs the sample verification (walked serially: the C++
        path never runs unverified), worker threads read and tokenize each
        split into a private TokenDict (ctypes releases the GIL), and the
        private vocabularies merge into `td` in split order, so the ids
        equal a serial walk's.  The user's own chain (the host prologue)
        stays on this thread."""
        t0 = time.perf_counter()
        try:
            return self._split_cols(plan, splits, td, state)
        finally:
            state["tokenize_s"] += time.perf_counter() - t0

    def _split_cols(self, plan, splits, td, state):
        nw = conf.INGEST_THREADS or (os.cpu_count() or 1)
        nw = min(nw, max(1, len(splits)))
        results = []
        i = 0
        while (nw > 1 and i < len(splits) and state["canonical"]
               and not state["checked"]):
            results.append(self._text_split_cols(plan, splits[i], td,
                                                 state))
            i += 1
        rest = splits[i:]
        if nw <= 1 or not (state["canonical"] and state["checked"]):
            results.extend(self._text_split_cols(plan, sp, td, state)
                           for sp in rest)
            return results
        sep = plan.canonical_sep

        def work(sp):
            # read, byte scan and tokenize into a private dict; an unsafe
            # split goes back to this thread's host prologue
            from dpark_tpu_torch.native import TokenDict
            data = TextFileRDD.split_bytes(sp)
            if not self._tokenizer_safe(data, sep):
                return None
            ltd = TokenDict()
            return ltd, ltd.encode(data, sep=sep)

        with concurrent.futures.ThreadPoolExecutor(max_workers=nw) as pool:
            done = list(pool.map(work, rest))
        for sp, out in zip(rest, done):       # split order: stable ids
            if out is None:
                state["prologue_splits"] += 1
                results.append(self._encode_rows(plan, sp, td))
                continue
            state["cpp_splits"] += 1
            ltd, local_ids = out
            ids = td.merge_from(ltd)[local_ids] if len(ltd) else local_ids
            results.append([ids, np.ones(len(ids), np.int64)])
        return results

    def _text_state(self, plan):
        """The run's tokenizer state: whether the canonical C++ path is
        still on, whether its sample check ran, and the counts the stage
        record reports (last_text_stats)."""
        self.last_text_stats = {"canonical": plan.canonical,
                                "checked": False, "cpp_splits": 0,
                                "prologue_splits": 0, "tokenize_s": 0.0}
        return self.last_text_stats

    def _ingest_text(self, plan):
        td = self._token_dict() if plan.encoded_keys else None
        state = self._text_state(plan)
        chunks = self._split_cols_parallel(plan, plan.stage.rdd.splits, td,
                                           state)
        return layout.ingest(self.ndev, self.device,
                             self._text_parts(plan, chunks),
                             plan.in_treedef, plan.in_specs, key_leaf=0)

    def _wave_iter_text(self, plan):
        """Per-shard parts of each wave of a text source: groups of
        whole splits of about conf.STREAM_TEXT_BYTES, each group's
        splits tokenized concurrently."""
        td = self._token_dict() if plan.encoded_keys else None
        state = self._text_state(plan)
        budget = conf.STREAM_TEXT_BYTES
        group, acc = [], 0
        for sp in plan.stage.rdd.splits:
            group.append(sp)
            acc += max(0, sp.end - sp.begin) or budget
            if acc >= budget:
                yield self._text_parts(plan, self._split_cols_parallel(
                    plan, group, td, state))
                group, acc = [], 0
        if group:
            yield self._text_parts(plan, self._split_cols_parallel(
                plan, group, td, state))

    # ------------------------------------------------------------------
    # stage results
    # ------------------------------------------------------------------
    def _finish_stage(self, plan, outs):
        if outs[0] == "shuffle":
            _, cnts, offs, leaves = outs
            return self._register_shuffle(plan, {
                "leaves": leaves,            # (N, cap, ...) dst-sorted
                "counts": cnts,              # (N, N) [src, dst]
                "offsets": offs,             # (N, N)
                # text, union and re-sliced ingest spread rows over the
                # shards: a shard is no map partition, the bridge reads
                # the whole shuffle through map 0
                "single_map": (plan.reslice
                               or plan.source[0] in ("text", "union")),
            })
        batch = outs[1]
        store = (self.shuffle_store.get(plan.source[1].shuffle_id, {})
                 if plan.source[0] == "hbm" else {})
        encoded = bool(store.get("encoded_keys"))
        if plan.count_only:
            # count() consumes cardinalities only: read the counts leaf;
            # a bare groupByKey counts the distinct keys of its key-sorted
            # rows instead
            counts = (self._distinct_key_counts(batch, plan.src_nk)
                      if plan.group_output else batch.counts)
            return ("counts", [int(c) for c in counts.cpu()])
        if plan.group_output:
            # bare groupByKey: rows arrive key-sorted; runs of equal keys
            # become (k, [v]) on the host
            return ("result", [self._maybe_decode(store, [
                (k, [rec[1] for rec in grp])
                for k, grp in itertools.groupby(rows, key=_fst)])
                for rows in layout.egest(batch)])
        monoid = plan.reduce_monoid
        col = batch.cols[0]
        if (monoid is not None and len(batch.cols) == 1 and col.dim() == 2
                # bools have no identity table; integer mul overflows
                # where the host fold used exact Python ints
                and (col.dtype.is_floating_point
                     or col.dtype == torch.int64)
                and not (monoid == "mul" and col.dtype == torch.int64)):
            vals, lo, hi = (t.cpu().numpy() for t in
                            self._monoid_reduce(batch, monoid))
            counts = batch.counts.cpu().numpy()
            intk = vals.dtype.kind == "i"
            safe = True
            if intk and monoid == "add":
                # the host fold used exact Python ints: answer from the
                # device only when the int64 sum provably cannot wrap
                total = int(counts.sum())
                nz = counts > 0
                mabs = (max(abs(int(lo[nz].min())), abs(int(hi[nz].max())))
                        if nz.any() else 0)
                safe = total * mabs < 2 ** 62
            if safe:
                py = int if intk else float
                return ("reduced", [(py(v), int(c))
                                    for v, c in zip(vals, counts)])
        top = plan.top_candidate
        if top is not None:
            kspec = fuse.classify_top_key(top[1], plan.out_treedef,
                                          plan.out_specs, encoded)
            if kspec is None and top[1] is not None and not encoded:
                # the ranged-int probe: an integer key expression rides
                # the device when its interval over the batch's exact
                # per-column (lo, hi) stays inside int64 (K15)
                kspec = fuse.classify_top_key(
                    top[1], plan.out_treedef, plan.out_specs, encoded,
                    col_ranges=self._int_col_ranges(batch))
            if kspec is not None:
                batch = self._device_topk(plan, batch, kspec, top[0],
                                          top[2])
                plan.topk_used = True
        return ("result", [self._maybe_decode(store, rows)
                           for rows in layout.egest(batch)])

    @staticmethod
    def _int_col_ranges(batch):
        """Exact (lo, hi) Python ints of each int64/int32 scalar column of
        a result batch over its valid rows (one K15 launch, one host
        read), None for the other leaves: the input of classify_top_key's
        ranged-int probe."""
        idx = [i for i, c in enumerate(batch.cols)
               if c.dim() == 2 and c.dtype in (torch.int64, torch.int32)]
        ranges = [None] * len(batch.cols)
        if idx:
            r = kernels.column_ranges([batch.cols[i] for i in idx],
                                      batch.counts)
            lohi = torch.stack([r[:, :, 0].amin(1), r[:, :, 1].amax(1)], 1)
            for i, (lo, hi) in zip(idx, lohi.cpu().tolist()):
                ranges[i] = (lo, hi)
        return ranges

    def _device_topk(self, plan, batch, kspec, n, smallest):
        """Per-shard top-n by the classified key: a stable sort by
        (invalid flag, order key columns) keeps n rows per shard (ties
        resolve by row order)."""
        lv = batch.cols
        if kspec[0] == "leaves":
            kcols = [lv[i] for i in kspec[1]]
        else:
            fn = fuse._row_fn(kspec[1], plan.out_treedef)
            flat, nc = fuse._flat(lv)
            with fuse.python_float_semantics():
                (kcol,) = fuse.vmap(fn)(*flat)
            kcols = [kcol.reshape(nc)]
        # validity is the primary key: a real key equal to the extreme
        # must never lose to padding.  Largest-first sorts ascending on
        # the order-reversing bijections -1-k (ints) and -k (floats).
        if not smallest:
            kcols = [fuse._reversed_order(k) for k in kcols]
        inval = (~collectives.valid_rows(batch.counts, batch.cap)).to(
            torch.int32)
        packed = collectives._partition_through(
            inval, 2, list(lv), collectives._lex_order(kcols))
        keep = min(n, batch.cap)
        out = [leaf[:, :keep].contiguous() for leaf in packed[1:-1]]
        new_n = torch.clamp(batch.counts, max=n).to(torch.int32)
        return layout.Batch(batch.treedef, out, new_n)

    @staticmethod
    def _distinct_key_counts(batch, nk):
        """(N,) distinct-key counts of a per-shard key-sorted batch (the
        no-combine reduce's row order): valid rows where any of the nk
        key columns differs from the row before (K17)."""
        return kernels.distinct_key_counts(
            [c.contiguous() for c in batch.cols[:nk]],
            batch.counts.to(torch.int32))

    @staticmethod
    def _monoid_reduce(batch, monoid):
        """Per-shard (reduced, min, max) over the valid rows of a
        single-scalar-leaf batch, each (N,) (K17); empty shards yield
        identities."""
        return kernels.monoid_reduce(batch.cols[0].contiguous(),
                                     batch.counts.to(torch.int32), monoid)

    # ------------------------------------------------------------------
    # the shuffle store and its host export bridge
    # ------------------------------------------------------------------
    def _register_shuffle(self, plan, store):
        """Shared bookkeeping of the in-core and streamed writes: the
        re-run guard, the byte account, the LRU stamp, the owning job and
        the reduce width (what a spill writes runs for), then the
        budget's eviction, which never spills the new store."""
        dep = plan.epilogue[1]
        sid = dep.shuffle_id
        self.drop_shuffle(sid)            # a re-run replaces its output
        store["out_treedef"] = plan.out_treedef
        store["out_specs"] = plan.out_specs
        store["key_cols"] = plan.epi_nk
        store["no_combine"] = plan.no_combine
        store["encoded_keys"] = plan.encoded_keys
        # a spilled combining store's export folds with the user's merge
        store.setdefault("agg", None if plan.no_combine else dep.aggregator)
        store["nbytes"] = sum(int(leaf.numel() * leaf.element_size())
                              for leaf in store["leaves"])
        store["seq"] = self._next_seq()
        store["job"] = self.current_job
        store["n_reduce"] = dep.partitioner.num_partitions
        self.shuffle_store[sid] = store
        self._store_bytes += store["nbytes"]
        self._evict_hbm(keep_sid=sid)
        return ("shuffle", sid)

    def _next_seq(self):
        self._hbm_seq += 1
        return self._hbm_seq

    def _fetch_store(self, sid):
        """A store a stage or the export bridge reads, stamped as the
        most recently fetched (the eviction's LRU order); read, it is no
        longer pinned for the running stage."""
        store = self.shuffle_store[sid]
        store["seq"] = self._next_seq()
        self._pinned.discard(sid)
        return store

    @property
    def resident_bytes(self):
        """Bytes of the shuffle stores held on the device."""
        return self._store_bytes

    def _evict_hbm(self, keep_sid=None):
        """Spill shuffle stores to host runs until the device-resident
        bytes are under conf.SHUFFLE_HBM_BUDGET (the reference's
        _evict_hbm): completed jobs' stores first, least recently fetched
        first; then, with only live jobs' stores left, the job holding
        the most bytes pays, its least recently fetched store first.
        Never `keep_sid` (the store just registered), a store the running
        stage reads, or a store already spilled.  A spill that fails
        (a full disk) drops the store: its consumers recompute it through
        its lineage (GPUScheduler._run_stage)."""
        budget = conf.shuffle_hbm_budget(self.device)
        while self._store_bytes + self._result_bytes > budget:
            victim = self._evict_victim(keep_sid)
            if victim is None:
                return
            try:
                self._spill_shuffle_to_host(victim)
            except Exception as e:
                logger.warning("spill of device shuffle %d failed (%s: %s); "
                               "dropping it: its consumers recompute it",
                               victim, type(e).__name__, e)
                self.drop_shuffle(victim)

    def _evict_victim(self, keep_sid):
        movable = [(meta["seq"], sid, meta)
                   for sid, meta in self.shuffle_store.items()
                   if sid != keep_sid and sid not in self._pinned
                   and "host_runs" not in meta and meta["nbytes"]]
        done = [(seq, sid) for seq, sid, meta in movable
                if meta["job"] not in self.live_jobs]
        if done:
            return min(done)[1]
        by_job = {}
        for seq, sid, meta in movable:
            by_job.setdefault(meta["job"], []).append(
                (seq, sid, meta["nbytes"]))
        if not by_job:
            return None
        biggest = max(by_job.values(),
                      key=lambda ss: sum(b for _, _, b in ss))
        return min(biggest)[1]

    def _spill_shuffle_to_host(self, sid):
        """One device-resident store becomes the spilled-run form of the
        wave stream (`host_runs`): one pinned device-to-host read of its
        counts, offsets and leaves; each reduce partition's rows gathered
        from its (src, dst) buckets (a pre_reduced store holds partition
        d on shard d), key-sorted on the host (stable: equal keys keep
        their source-major order) and written as one run to a fresh
        spool.  The store keeps its id and its hbm:// locations; every
        reader serves the runs (the export bridge, _seg_batch_from_runs,
        admission's HOST_RUNS_READ).  Raises, leaving the store as it
        was, when a write fails."""
        store = self.shuffle_store[sid]
        t0 = time.perf_counter()
        pre = bool(store.get("pre_reduced"))
        tensors = [store["counts"]] + ([] if pre else [store["offsets"]])
        host, ready = _async_d2h(tensors + list(store["leaves"]))
        if ready is not None:
            ready.synchronize()
        host = [h.numpy() for h in host]
        counts, leaves = host[0], host[len(tensors):]
        r = store["n_reduce"]
        # (shard, first row, rows) of each partition's buckets
        if pre:
            spans = [[(d, 0, int(counts[d]))] for d in range(r)]
        else:
            offsets = host[1]
            spans = [[(s, int(offsets[s, d]), int(counts[s, d]))
                      for s in range(len(counts))] for d in range(r)]
        parts = [[(s, o, c) for s, o, c in sp if c] for sp in spans]
        self._spool_seq += 1
        root = conf.spool_root()
        os.makedirs(root, exist_ok=True)
        spool = tempfile.mkdtemp(prefix="%d-%d-spill-" % (sid,
                                                          self._spool_seq),
                                 dir=root)
        nk = store["key_cols"]

        def write(d):
            if not parts[d]:
                return [], 0
            cols = [np.concatenate([leaf[s, o:o + c]
                                    for s, o, c in parts[d]])
                    for leaf in leaves]
            order = _key_order(cols, nk)
            path = os.path.join(spool, "%d-spill" % d)
            return [path], _write_run(path, [c[order] for c in cols])

        try:
            with concurrent.futures.ThreadPoolExecutor(
                    min(8, max(1, r))) as pool:
                written = list(pool.map(write, range(r)))
        except BaseException:
            shutil.rmtree(spool, ignore_errors=True)
            raise
        runs = [paths for paths, _ in written]
        nbytes = store["nbytes"]
        store.pop("pre_reduced", None)
        store.update({
            "leaves": [], "counts": None, "offsets": None,
            "host_runs": runs, "spool_dir": spool,
            "premerge": _RunPremerger(runs, spool, key_cols=nk),
            "host_combine": not store["no_combine"], "single_map": True,
            "nbytes": 0})
        self._store_bytes -= nbytes
        seconds = time.perf_counter() - t0
        self.spills.append({
            "sid": sid, "bytes": nbytes, "seconds": seconds,
            "rows": sum(c for p in parts for _, _, c in p),
            "run_bytes": sum(b for _, b in written)})
        logger.info("spilled device shuffle %d (%d bytes) to host runs in "
                    "%.3f s", sid, nbytes, seconds)

    def export_bucket(self, sid, map_id, reduce_id):
        """Device-resident map output -> host (key, combiner) items of one
        (map, reduce) bucket, for a host reduce stage (the HBM -> host
        bridge), string keys decoded.  A no-combine store holds raw
        values: each exports as the list combiner [v] its host merge
        (list extend) expects."""
        if sid not in self.shuffle_store:
            raise KeyError("no device shuffle %d" % sid)
        store = self._fetch_store(sid)
        return self._maybe_decode(store, self._export_rows(store, map_id,
                                                           reduce_id))

    def _export_rows(self, store, map_id, reduce_id):
        if store.get("pre_reduced"):
            # shard d holds partition d combined: map 0's bucket
            if map_id != 0:
                return []
            cnt = int(store["counts"][reduce_id].item())
            if not cnt:
                return []
            lists = [leaf[reduce_id, :cnt].cpu().numpy().tolist()
                     for leaf in store["leaves"]]
            treedef = store["out_treedef"]
            return [layout.tree_unflatten(treedef, [pl[i] for pl in lists])
                    for i in range(cnt)]
        if "host_runs" in store:
            # spilled runs: the whole shuffle exports through map 0
            if map_id != 0:
                return []
            return self._export_runs(store, reduce_id)
        counts = store["counts"].cpu().numpy()
        offsets = store["offsets"].cpu().numpy()
        if store["single_map"]:
            # re-sliced input: device shard != map partition, the whole
            # shuffle exports through map 0
            if map_id != 0:
                return []
            rows = []
            for dev in range(counts.shape[0]):
                rows.extend(self._export_one(store, dev, reduce_id, counts,
                                             offsets))
            return rows
        return self._export_one(store, map_id, reduce_id, counts, offsets)

    @staticmethod
    def _export_one(store, dev, reduce_id, counts, offsets):
        off = int(offsets[dev, reduce_id])
        cnt = int(counts[dev, reduce_id])
        if not cnt:
            return []
        lists = [leaf[dev, off:off + cnt].cpu().numpy().tolist()
                 for leaf in store["leaves"]]
        treedef = store["out_treedef"]
        rows = [layout.tree_unflatten(treedef, [pl[i] for pl in lists])
                for i in range(cnt)]
        if store["no_combine"]:
            return [(k, [v]) for k, v in rows]
        return rows

    def _export_runs(self, store, reduce_id):
        """One spilled partition as host (key, combiner) items: its
        premerged key-sorted run, each row (k, [v]) for a no-combine
        write; for a combining one the user's merge_combiners folds each
        run of equal keys (the values are created combiners, merged per
        wave where a merge traced): O(1) state a key."""
        cols = self._partition_run_cols(store, reduce_id)
        if cols is None:
            return []
        lists = [c.tolist() for c in cols]
        treedef = store["out_treedef"]
        if treedef == (0, 1):
            recs = zip(lists[0], lists[1])
        else:
            recs = (layout.tree_unflatten(treedef, [pl[i] for pl in lists])
                    for i in range(len(lists[0])))
        if not store["host_combine"]:
            return [(k, [v]) for k, v in recs]
        mc = store["agg"].merge_combiners
        rows = []
        for k, v in recs:
            if rows and rows[-1][0] == k:
                rows[-1] = (k, mc(rows[-1][1], v))
            else:
                rows.append((k, v))
        return rows

    def _maybe_decode(self, store, rows):
        """Dictionary-encoded string keys leave the device as ids; every
        host exit decodes them back."""
        if not store.get("encoded_keys") or not rows:
            return rows
        dec = self.token_dict.decode
        return [(dec(r[0]),) + tuple(r[1:]) for r in rows]

    def drop_shuffle(self, sid):
        store = self.shuffle_store.pop(sid, None)
        if store is None:
            return
        self._store_bytes -= store["nbytes"]
        if store.get("premerge") is not None:
            # stop the background merge before deleting what it reads
            store["premerge"].stop()
        if store.get("spool_dir"):
            shutil.rmtree(store["spool_dir"], ignore_errors=True)

    def stop(self):
        for sid in list(self.shuffle_store):
            self.drop_shuffle(sid)
