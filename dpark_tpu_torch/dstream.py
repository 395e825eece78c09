"""DStream: micro-batch stream processing over RDDs (port of
dpark_tpu/dstream.py, cut down).

A DStream is a time-indexed sequence of RDDs; each batch tick turns into
ordinary RDD jobs generated from the output streams.  A window unions
the parent's RDDs over the window; updateStateByKey cogroups the
previous state with the new batch; reduceByKeyAndWindow updates its
window from slide-sized panes (panes.py).

On the gpu master the streams stay on the device through two rewrites,
as in the reference:

  * union-reduce: a provable (+, -) window and the running-sum
    updateStateByKey fold as ONE union-reduce per tick over reduced
    shuffles kept on the device (the device union source, K16), with a
    checked op that falls back for good on the first non-numeric pair;
  * state mode: a traceable, padding-invariant update(values, prev)
    runs as a state-mode SegMapOp over the union of the carried state
    and the batch, tagged (v, flag) (K7, K2, K8's state gather).

Not ported (ROADMAP A14b): textFileStream, socketTextStream, checkpoint
and recovery, event-time windows and late panes, the adaptive pane
split point (conf.STREAM_PANE_TREE_MIN decides), and trace spans.
"""

import inspect
import logging
import numbers
import operator
import threading
import time as _time

import torch

logger = logging.getLogger("dpark_tpu_torch.dstream")

_A14B = ("%s is not yet ported to the PyTorch port (ROADMAP A14b)")


class StreamingContext:
    def __init__(self, ctx, batchDuration):
        from dpark_tpu_torch.context import DparkContext
        if isinstance(ctx, str):
            ctx = DparkContext(ctx)
        self.ctx = ctx
        self._master = ctx.master
        self.batch_duration = float(batchDuration)
        self.zero_time = None
        self.output_streams = []
        self.input_streams = []
        self._stopped = threading.Event()
        self._thread = None

    batchDuration = property(lambda self: self.batch_duration)

    def _all_streams(self):
        out = []
        seen = set()
        frontier = list(self.output_streams) + list(self.input_streams)
        while frontier:
            s = frontier.pop()
            if id(s) in seen:
                continue
            seen.add(id(s))
            out.append(s)
            frontier.extend(s.parents)
        return out

    # -- input stream constructors --------------------------------------
    def queueStream(self, queue, oneAtATime=True, defaultRDD=None):
        """queue: list of RDDs or of plain lists (parallelized at the
        context's default parallelism)."""
        return QueueInputDStream(self, list(queue), oneAtATime, defaultRDD)

    def textFileStream(self, directory, filter_fn=None,
                       stamp_arrival=False):
        raise NotImplementedError(_A14B % "textFileStream")

    fileStream = textFileStream

    def socketTextStream(self, hostname, port, stamp_arrival=False):
        raise NotImplementedError(_A14B % "socketTextStream")

    def checkpoint(self, directory):
        raise NotImplementedError(_A14B % "stream checkpointing")

    def makeStream(self, rdd):
        return ConstantInputDStream(self, rdd)

    def union(self, *streams):
        return UnionDStream(list(streams))

    # -- lifecycle -------------------------------------------------------
    def start(self, t0=None):
        if not self.output_streams:
            raise ValueError("no output streams registered "
                             "(call foreachRDD / pprint)")
        self.ctx.start()
        for ins in self.input_streams:
            ins.start()
        bd = self.batch_duration
        if self.zero_time is None or t0 is not None:
            now = t0 if t0 is not None else _time.time()
            self.zero_time = now - (now % bd)
        self._stopped.clear()
        self._thread = threading.Thread(target=self._run_loop, daemon=True)
        self._thread.start()

    def _run_loop(self):
        bd = self.batch_duration
        t = self.zero_time + bd
        while not self._stopped.is_set():
            now = _time.time()
            if now < t:
                self._stopped.wait(min(t - now, 0.05))
                continue
            try:
                self.run_batch(t)
            except Exception:
                logger.exception("batch at %s failed", t)
            t += bd

    def run_batch(self, t):
        """Generate and run one batch's jobs (the timer loop calls it;
        a caller may drive it by hand with its own clock).

        A _NumericRewriteError escaping a batch whose window or state
        streams took the union-reduce rewrite disables that rewrite for
        good and regenerates the batch through the generic path: the
        5-record probe accelerates, it never decides correctness."""
        t = round(t, 6)
        for out in self.output_streams:
            try:
                out.generate_job(t)
            except (TypeError, RuntimeError) as e:
                if not self._disable_numeric_rewrites(t, e, out):
                    raise
                try:
                    out.generate_job(t)      # the generic path
                except Exception:
                    # the generic path rejects this batch too: drop this
                    # chain's derived RDDs, so later batches carry the
                    # last good state forward
                    for s in self._chain_streams(out):
                        if not isinstance(s, InputDStream):
                            s.generated.pop(t, None)
                    raise
        self._forget_old(t, self.output_streams)

    @staticmethod
    def _forget_old(t, outputs):
        """Drop each stream's RDDs older than the longest any consumer
        still needs: a stream keeps `keep` seconds for each path from an
        output (the output's remember duration, widened by every window
        on the way down).  One pass over all outputs: a parent shared by
        a short output and a window keeps what the window needs (the
        reference forgets per output, so a 30 s window beside a 1 s
        state stream would re-read its batches from the queue)."""
        keeps = {}

        def need(s, keep):
            if id(s) in keeps and keeps[id(s)][1] >= keep:
                return
            keeps[id(s)] = (s, keep)
            for p in s.parents:
                need(p, max(keep, s.window_duration))
        for out in outputs:
            need(out, out._remember_duration())
        for s, keep in keeps.values():
            s._forget(t, keep)

    def _chain_streams(self, out):
        """Every stream reachable from one output stream."""
        seen, chain, frontier = set(), [], [out]
        while frontier:
            s = frontier.pop()
            if id(s) in seen:
                continue
            seen.add(id(s))
            chain.append(s)
            frontier.extend(s.parents)
        return chain

    def _disable_numeric_rewrites(self, t, exc, out):
        """On a _NumericRewriteError: latch the failing chain's _numeric
        off and drop its derived RDDs of the failed batch (input streams
        keep theirs: a queue must not be consumed twice).  False when
        the error is unrelated or no rewrite was on."""
        if not isinstance(exc, _NumericRewriteError) \
                and "_NumericRewriteError" not in str(exc):
            return False
        chain = self._chain_streams(out)
        hit = False
        for s in chain:
            if getattr(s, "_numeric", None):
                s._numeric = False
                hit = True
                logger.warning("%s: the numeric union-reduce rewrite hit a "
                               "non-numeric pair; the generic path takes "
                               "over for good", type(s).__name__)
        if not hit:
            return False
        for s in chain:
            if not isinstance(s, InputDStream):
                s.generated.pop(t, None)
        return True

    def awaitTermination(self, timeout=None):
        if self._thread:
            self._thread.join(timeout)

    def stop(self, stop_context=False):
        self._stopped.set()
        if self._thread:
            self._thread.join(self.batch_duration * 2 + 1)
            self._thread = None
        for ins in self.input_streams:
            ins.stop()
        from dpark_tpu_torch import panes as panes_mod
        for s in self._all_streams():
            sid = getattr(s, "_sid", None)
            if sid is not None:
                panes_mod.unregister_stream(sid)
        if stop_context:
            self.ctx.stop()


class DStream:
    def __init__(self, ssc):
        self.ssc = ssc
        self.generated = {}            # time -> rdd (or None)

    @property
    def slide_duration(self):
        return self.ssc.batch_duration

    @property
    def parents(self):
        return []

    @property
    def window_duration(self):
        """How long this stream's own RDDs must be remembered."""
        return self.slide_duration

    def compute(self, t):
        raise NotImplementedError

    def getOrCompute(self, t):
        t = round(t, 6)
        zero = self.ssc.zero_time
        if zero is not None and t <= zero + 1e-9:
            return None                 # before the stream started
        if t in self.generated:
            return self.generated[t]
        sd = self.slide_duration
        if zero is not None and sd:
            # a stream emits only at multiples of its own slide: the
            # pane boundaries are the emit boundaries
            k = (t - zero) / sd
            if abs(k - round(k)) > 1e-4:
                return None
        rdd = self.compute(t)
        self.generated[t] = rdd
        return rdd

    def forget_old(self, t):
        """Forget what this stream's subgraph no longer needs at t."""
        StreamingContext._forget_old(t, [self])

    def _forget(self, t, keep):
        """Drop this stream's RDDs older than t - keep."""
        for ts in list(self.generated):
            if ts < t - keep:
                rdd = self.generated.pop(ts)
                if rdd is not None and rdd.should_cache:
                    rdd.unpersist()

    def _remember_duration(self):
        return max(self.slide_duration * 4, self.window_duration * 2)

    # -- transformations -------------------------------------------------
    def map(self, f):
        return MappedDStream(self, f)

    def flatMap(self, f):
        return TransformedDStream(self, _rdd_op("flatMap", f))

    def filter(self, f):
        return TransformedDStream(self, _rdd_op("filter", f))

    def glom(self):
        return TransformedDStream(self, _glom_rdd)

    def mapPartitions(self, f):
        return TransformedDStream(self, _rdd_op("mapPartitions", f))

    def mapValue(self, f):
        return TransformedDStream(self, _rdd_op("mapValue", f))

    mapValues = mapValue

    def transform(self, func):
        """func(rdd) or func(rdd, time) -> rdd"""
        return TransformedDStream(self, func)

    def groupByKey(self, numSplits=None):
        return TransformedDStream(self, _rdd_op("groupByKey", numSplits))

    def reduceByKey(self, func, numSplits=None):
        return TransformedDStream(
            self, _rdd_op("reduceByKey", func, numSplits))

    def combineByKey(self, createCombiner, mergeValue, mergeCombiners,
                     numSplits=None):
        return TransformedDStream(
            self, _rdd_op("combineByKey", createCombiner, mergeValue,
                          mergeCombiners, numSplits))

    def countByValue(self):
        return TransformedDStream(
            self, lambda r: r.map(_pair_one_ds).reduceByKey(_add_ds))

    def union(self, other):
        return UnionDStream([self, other])

    def join(self, other, numSplits=None):
        return CoGroupedDStream([self, other], "join", numSplits)

    def cogroup(self, other, numSplits=None):
        return CoGroupedDStream([self, other], "cogroup", numSplits)

    # -- windows ---------------------------------------------------------
    def window(self, windowDuration, slideDuration=None):
        return WindowedDStream(self, windowDuration, slideDuration)

    def reduceByWindow(self, reduceFunc, windowDuration, slideDuration=None,
                       invReduceFunc=None):
        """Whole-window reduce; with invReduceFunc it rides the
        incremental keyed path (one constant key)."""
        if invReduceFunc is not None:
            keyed = self.map(_const_key)
            red = keyed.reduceByKeyAndWindow(
                reduceFunc, windowDuration, slideDuration,
                invFunc=invReduceFunc)
            return TransformedDStream(red, _rdd_op("map", _drop_key))
        w = self.window(windowDuration, slideDuration)
        return TransformedDStream(w, _reduce_to_rdd(reduceFunc))

    def countByWindow(self, windowDuration, slideDuration=None):
        return (self.window(windowDuration, slideDuration)
                .transform(_count_to_rdd))

    def reduceByKeyAndWindow(self, func, windowDuration, slideDuration=None,
                             numSplits=None, invFunc=None,
                             eventTime=None, lateness=None):
        """Windowed per-key reduce; with invFunc the window updates
        incrementally (prev - leaving + entering).

        On the pane grid (window % slide == 0, slide % batch == 0,
        conf.STREAM_PANES on) the window is sliced into slide-sized
        panes whose partial aggregates persist across ticks: with
        invFunc a slide costs a constant number of panes; without, a
        provably mergeable func (a classified monoid, or
        ``func.__dpark_window_merge__ = True``) merges O(log w) cached
        dyadic tree nodes.  A non-invertible func with no registered
        merge recomputes the whole window.

        PROBE CONTRACT: when (func, invFunc) are plain (+, -), the
        incremental update is one union-reduce a tick, but only after a
        one-time probe of up to 5 records shows plain numbers; the
        rewrite re-checks every folded pair, and the first non-numeric
        one sends the stream to the generic leftOuterJoin + invFunc path
        for good."""
        if eventTime is not None or lateness is not None:
            raise NotImplementedError(_A14B % "event-time windows")
        if invFunc is None:
            from dpark_tpu_torch import conf
            slide = float(slideDuration or self.slide_duration)
            aligned = (_grid_multiple(float(windowDuration), slide)
                       and _grid_multiple(slide, self.slide_duration))
            merge_ok = _window_merge_registered(func)
            if conf.STREAM_PANES and aligned and merge_ok:
                return PanedWindowReduceDStream(
                    self, func, windowDuration, slideDuration, numSplits)
            why = ("no registered merge for %r"
                   % getattr(func, "__name__", func)) if not merge_ok \
                else ("window/slide/batch durations not grid-aligned"
                      if not aligned else "DPARK_STREAM_PANES off")
            w = self.window(windowDuration, slideDuration)
            return TransformedDStream(
                w, _MarkedWindowReduce(func, numSplits, why))
        return ReducedWindowedDStream(self, func, invFunc, windowDuration,
                                      slideDuration, numSplits)

    # -- state -----------------------------------------------------------
    def updateStateByKey(self, updateFunc, numSplits=None):
        """updateFunc(new_values_list, prev_state_or_None) -> state|None

        The running-sum idiom ``(prev or 0) + sum(vs)`` (or an update
        carrying __dpark_state_monoid__) folds as one union-reduce a
        batch, after the same numeric probe as the window rewrite.  A
        traceable, padding-invariant update rides the state-mode
        segmented apply (conf.SEG_STATE).  Anything else cogroups."""
        return StateDStream(self, updateFunc, numSplits)

    # -- outputs ---------------------------------------------------------
    def foreachRDD(self, func):
        out = ForEachDStream(self, func)
        self.ssc.output_streams.append(out)
        return out

    def pprint(self, num=10):
        def show(rdd, t):
            items = rdd.take(num)
            print("--- time %s ---" % t)
            for it in items:
                print(it)
        return self.foreachRDD(show)

    def collect_batches(self, sink):
        """Test/utility output: append (time, list) per batch."""
        return self.foreachRDD(
            lambda rdd, t: sink.append((t, rdd.collect())))


def _rdd_op(name, *args):
    def op(rdd):
        f = getattr(rdd, name)
        return f(*[a for a in args if a is not None])
    return op


def _glom_part(it):
    return [list(it)]


def _glom_rdd(rdd):
    return rdd.mapPartitions(_glom_part)


def _pair_one_ds(x):
    return (x, 1)


def _const_key(x):
    return (0, x)


def _drop_key(kv):
    return kv[1]


def _add_ds(a, b):
    return a + b


def _reduce_to_rdd(func):
    def op(rdd):
        vals = rdd.mapPartitions(lambda it: _safe_reduce(it, func)) \
                  .collect()
        out = None
        have = False
        for v in vals:
            out = v if not have else func(out, v)
            have = True
        return rdd.ctx.parallelize([out] if have else [], 1)
    return op


def _safe_reduce(it, func):
    out = None
    have = False
    for x in it:
        out = x if not have else func(out, x)
        have = True
    return [out] if have else []


def _count_to_rdd(rdd):
    return rdd.ctx.parallelize([rdd.count()], 1)


def _grid_multiple(a, b):
    """round(a/b) when a is an (approximate) integer multiple >= 1 of
    b, else 0: the pane-grid alignment test."""
    if not b:
        return 0
    k = a / b
    n = int(round(k))
    return n if n >= 1 and abs(k - n) < 1e-6 else 0


def _window_merge_registered(func):
    """A non-invertible windowed reduce may merge partial aggregates (the
    pane tree) only when that provably equals folding the raw records:
    a classified monoid, or the user's ``func.__dpark_window_merge__``
    assertion."""
    if getattr(func, "__dpark_window_merge__", None):
        return True
    from dpark_tpu_torch.utils.monoid import classify_merge
    try:
        return classify_merge(func) is not None
    except Exception:            # an odd user callable: no merge
        return False


class _MarkedWindowReduce:
    """The whole-window reduce, marking every emitted RDD with why the
    window recomputes (`_window_noninv`)."""

    def __init__(self, func, numSplits, reason):
        self.func = func
        self.numSplits = numSplits
        self.reason = reason

    def __call__(self, rdd):
        out = rdd.reduceByKey(self.func, self.numSplits)
        out._window_noninv = {
            "reason": self.reason,
            "op": getattr(self.func, "__name__", str(self.func))}
        return out


class DerivedDStream(DStream):
    def __init__(self, parent):
        super().__init__(parent.ssc)
        self.parent = parent

    @property
    def parents(self):
        return [self.parent]

    @property
    def slide_duration(self):
        return self.parent.slide_duration


class MappedDStream(DerivedDStream):
    def __init__(self, parent, f):
        super().__init__(parent)
        self.f = f

    def compute(self, t):
        rdd = self.parent.getOrCompute(t)
        return rdd.map(self.f) if rdd is not None else None


def _takes_time(func):
    try:
        return len(inspect.signature(func).parameters) >= 2
    except (TypeError, ValueError):
        return False


class TransformedDStream(DerivedDStream):
    def __init__(self, parent, func):
        super().__init__(parent)
        self.func = func
        self._two_args = _takes_time(func)

    def compute(self, t):
        rdd = self.parent.getOrCompute(t)
        if rdd is None:
            return None
        return self.func(rdd, t) if self._two_args else self.func(rdd)


class UnionDStream(DStream):
    def __init__(self, streams):
        super().__init__(streams[0].ssc)
        self.streams = streams

    @property
    def parents(self):
        return list(self.streams)

    @property
    def slide_duration(self):
        return self.streams[0].slide_duration

    def compute(self, t):
        rdds = [s.getOrCompute(t) for s in self.streams]
        rdds = [r for r in rdds if r is not None]
        if not rdds:
            return None
        return self.ssc.ctx.union(rdds)


class CoGroupedDStream(DStream):
    def __init__(self, streams, how, numSplits=None):
        super().__init__(streams[0].ssc)
        self.streams = streams
        self.how = how
        self.numSplits = numSplits

    @property
    def parents(self):
        return list(self.streams)

    @property
    def slide_duration(self):
        return self.streams[0].slide_duration

    def compute(self, t):
        rdds = [s.getOrCompute(t) for s in self.streams]
        if any(r is None for r in rdds):
            empty = self.ssc.ctx.parallelize([], 1)
            rdds = [r if r is not None else empty for r in rdds]
        a, b = rdds
        if self.how == "join":
            return a.join(b, self.numSplits)
        return a.cogroup(b, numSplits=self.numSplits)


class WindowedDStream(DerivedDStream):
    def __init__(self, parent, windowDuration, slideDuration=None):
        super().__init__(parent)
        self._window = float(windowDuration)
        self._slide = float(slideDuration or parent.slide_duration)

    @property
    def slide_duration(self):
        return self._slide

    @property
    def window_duration(self):
        return self._window

    def compute(self, t):
        rdds = []
        step = self.parent.slide_duration
        # the window covers (t - window, t]
        k = t
        while k > t - self._window + 1e-9:
            rdd = self.parent.getOrCompute(round(k, 6))
            if rdd is not None:
                rdds.append(rdd)
            k -= step
        if not rdds:
            return None
        return self.ssc.ctx.union(rdds)


class _PaneWindowBase(DerivedDStream):
    """The pane plane shared by the windowed streams: the window is
    sliced into slide-sized panes whose partial aggregates live as
    cached reduced RDDs keyed by pane end time (on the gpu master their
    shuffle outputs stay on the device between ticks).  Every emitted
    RDD is tagged with its stream and role (the stage records' `stream`),
    and the stream's live stats register in panes.stream_stats()."""

    _kind = "win"

    def __init__(self, parent, func, windowDuration, slideDuration,
                 numSplits):
        super().__init__(parent)
        self.func = func
        self._window = float(windowDuration)
        self._slide = float(slideDuration or parent.slide_duration)
        self.numSplits = numSplits
        from dpark_tpu_torch import conf
        # the window must be a whole number of slides and the slide a
        # whole number of parent batches
        self._np = _grid_multiple(self._window, self._slide)
        self._bpp = _grid_multiple(self._slide, parent.slide_duration)
        self._pane_mode = bool(conf.STREAM_PANES and self._np
                               and self._bpp)
        self._panes = {}        # pane END time -> reduced rdd or None
        self._anchor = None     # first emit time == pane index 0
        self._sid = None
        self._stats = None

    @property
    def slide_duration(self):
        return self._slide

    @property
    def window_duration(self):
        return self._window

    def _mode_name(self):
        return "pane"

    def _ensure_registered(self):
        from dpark_tpu_torch import panes as panes_mod
        if self._sid is None:
            self._sid = panes_mod.new_stream_id(self._kind)
            self._stats = {
                "type": type(self).__name__, "mode": self._mode_name(),
                "window": self._window, "slide": self._slide,
                "panes": 0, "nodes": 0, "node_builds": 0, "ticks": 0}
            panes_mod.register_stream(self._sid, self._stats)

    def _tag(self, rdd, role, pane=None):
        """Which stream and pane-plane role a stage's RDD serves."""
        if rdd is not None and self._sid is not None:
            tag = {"stream": self._sid, "role": role}
            if pane is not None:
                tag["pane"] = pane
            rdd._stream_tag = tag
        return rdd

    def _idx(self, t):
        return int(round((t - self._anchor) / self._slide))

    def _pane_time(self, idx):
        return round(self._anchor + idx * self._slide, 6)

    def _pane_by_idx(self, idx):
        return self._panes.get(self._pane_time(idx))

    def _new_data(self, t):
        """Union of the parent batches in (t - slide, t], generated in
        ascending time order (queue inputs pop in arrival order)."""
        step = self.parent.slide_duration
        rdds = []
        for j in range(self._bpp - 1, -1, -1):
            r = self.parent.getOrCompute(round(t - j * step, 6))
            if r is not None:
                rdds.append(r)
        if not rdds:
            return None
        return rdds[0] if len(rdds) == 1 else self.ssc.ctx.union(rdds)

    def _reduce(self, rdd):
        return rdd.reduceByKey(self.func, self.numSplits)

    def _ingest_pane(self, t):
        """Build pane(t) from the tick's new data (idempotent per tick:
        the rewrite fallback replays a batch through compute())."""
        t = round(t, 6)
        if t in self._panes:
            return
        self._ensure_registered()
        if self._anchor is None:
            self._anchor = t
        new = self._new_data(t)
        if new is None:
            self._panes[t] = None
        else:
            self._panes[t] = self._tag(self._reduce(new).cache(),
                                       "pane-build", pane=self._idx(t))
        st = self._stats
        st["ticks"] += 1
        st["panes"] = sum(1 for r in self._panes.values() if r is not None)

    def _window_pane_rdds(self, t):
        """The window's existing pane partials."""
        out = []
        k = t
        while k > t - self._window + 1e-9:
            p = self._panes.get(round(k, 6))
            if p is not None:
                out.append(p)
            k -= self._slide
        return out

    def _forget(self, t, keep):
        super()._forget(t, keep)
        horizon = self._window + self._slide * 2
        for ts in list(self._panes):
            if ts < t - horizon:
                rdd = self._panes.pop(ts)
                if rdd is not None and rdd.should_cache:
                    rdd.unpersist()
        if self._stats is not None:
            self._stats["panes"] = sum(
                1 for r in self._panes.values() if r is not None)


class ReducedWindowedDStream(_PaneWindowBase):
    """Incremental windowed reduce: new_window = inv(prev_window - old
    slice) + new slice.  On the pane grid a slide costs a constant
    number of panes (prev + new pane - expired pane); misaligned windows
    (or conf.STREAM_PANES off) keep the per-batch path."""

    _kind = "rwin"

    def __init__(self, parent, func, invFunc, windowDuration,
                 slideDuration=None, numSplits=None):
        super().__init__(parent, func, windowDuration, slideDuration,
                         numSplits)
        self.invFunc = invFunc
        self._reduced = {}      # time -> per-batch reduced rdd (batchwise)
        # provably (add, sub): the update is prev + new - old as ONE
        # union-reduce, every branch a reduced shuffle on the device,
        # once the value probe (_numeric) shows plain numbers
        self._linear_ops = _is_plain_add(func) and _is_plain_sub(invFunc)
        self._numeric = None            # undecided until data shows up
        # one checked op for the stream's lifetime
        self._checked_op = (_CheckedNumericOp(func, "add")
                            if self._linear_ops else None)

    def _mode_name(self):
        return "inv"

    def _batch_reduced(self, t):
        if t not in self._reduced:
            rdd = self.parent.getOrCompute(t)
            self._reduced[t] = (rdd.reduceByKey(self.func, self.numSplits)
                                if rdd is not None else None)
        return self._reduced[t]

    def _probe_numeric(self, prev):
        if self._linear_ops and self._numeric is None:
            probe = _probe_values(prev)
            if probe:
                self._numeric = _numeric_verdict(
                    "add", [rec[1] for rec in probe])

    def compute(self, t):
        if not self._pane_mode:
            return self._compute_batchwise(t)
        t = round(t, 6)
        prev = self.generated.get(round(t - self._slide, 6))
        self._ingest_pane(t)
        pane_new = self._panes.get(t)
        if prev is None:
            # cold start: one union-reduce over the window's panes
            rdds = self._window_pane_rdds(t)
            if not rdds:
                return None
            if len(rdds) == 1:
                return rdds[0]
            out = rdds[0].union(*rdds[1:]) \
                         .reduceByKey(self.func, self.numSplits).cache()
            return self._tag(out, "window-emit")
        pane_old = self._panes.get(round(t - self._window, 6))
        self._probe_numeric(prev)
        if self._linear_ops and self._numeric:
            # prev + new pane - expired pane: one union-reduce over a
            # constant number of branches.  Every key of the expired pane
            # is in prev, so no negated orphan key appears; keys at zero
            # stay, as with leftOuterJoin + sub
            branches = [prev]
            if pane_new is not None:
                branches.append(pane_new)
            if pane_old is not None:
                branches.append(pane_old.mapValue(_neg_value))
            if len(branches) == 1:
                return prev             # quiet tick: window unchanged
            out = branches[0].union(*branches[1:]) \
                .reduceByKey(self._checked_op, self.numSplits).cache()
            return self._tag(out, "window-emit")
        # generic invFunc path at pane granularity: one inverse join for
        # the expired pane (invFunc sees the pane's aggregate) and one
        # union-reduce for the new pane
        out = prev
        if pane_old is not None:
            out = out.leftOuterJoin(pane_old, self.numSplits) \
                     .mapValue(_InvApply(self.invFunc))
        if pane_new is not None:
            out = out.union(pane_new).reduceByKey(self.func, self.numSplits)
        if out is prev:
            return prev
        return self._tag(out.cache(), "window-emit")

    def _compute_batchwise(self, t):
        """The per-batch path (misaligned windows or STREAM_PANES off)."""
        prev = self.generated.get(round(t - self._slide, 6))
        step = self.parent.slide_duration
        if prev is None:
            rdds = []
            k = t
            while k > t - self._window + 1e-9:
                r = self._batch_reduced(round(k, 6))
                if r is not None:
                    rdds.append(r)
                k -= step
            if not rdds:
                return None
            out = rdds[0]
            for r in rdds[1:]:
                out = out.union(r)
            return out.reduceByKey(self.func, self.numSplits).cache()
        leaving, entering = [], []
        k = t - self._window
        while k > t - self._window - self._slide + 1e-9:
            r = self._batch_reduced(round(k, 6))
            if r is not None:
                leaving.append(r)
            k -= step
        k = t
        while k > t - self._slide + 1e-9:
            r = self._batch_reduced(round(k, 6))
            if r is not None:
                entering.append(r)
            k -= step
        self._probe_numeric(prev)
        if self._linear_ops and self._numeric:
            branches = ([prev] + entering
                        + [r.mapValue(_neg_value) for r in leaving])
            out = branches[0]
            if len(branches) > 1:
                out = out.union(*branches[1:]) \
                         .reduceByKey(self._checked_op, self.numSplits)
            return out.cache()
        out = prev
        for r in leaving:
            out = out.leftOuterJoin(r, self.numSplits) \
                     .mapValue(_InvApply(self.invFunc))
        for r in entering:
            out = out.union(r).reduceByKey(self.func, self.numSplits)
        return out.cache()

    def _forget(self, t, keep):
        super()._forget(t, keep)
        for ts in list(self._reduced):
            if ts < t - (self._window + self._slide * 2):
                rdd = self._reduced.pop(ts)
                if rdd is not None and rdd.should_cache:
                    rdd.unpersist()


class PanedWindowReduceDStream(_PaneWindowBase):
    """Non-invertible windowed reduce over the pane plane: each tick
    merges the window's pane range through a cache of aligned dyadic
    merge nodes (panes.MergeTree), at most ~2*log2(w) branches an emit.
    Below conf.STREAM_PANE_TREE_MIN panes the panes union flat.
    Admission (reduceByKeyAndWindow): merging partials with `func` must
    provably equal folding the raw records.  Float caveat: the tree
    re-associates the fold, so float low-order bits can differ from the
    whole-window recompute; integer and min/max aggregates are exact."""

    _kind = "pwin"

    def __init__(self, parent, func, windowDuration, slideDuration=None,
                 numSplits=None):
        super().__init__(parent, func, windowDuration, slideDuration,
                         numSplits)
        assert self._pane_mode, "constructed without pane admission"
        self._tree = None
        self._use_tree = None           # decided at the first emit
        # a node wider than half the window is covered at most once a
        # window length: not worth caching
        half = max(1, self._np // 2)
        self._max_node = 1 << (half.bit_length() - 1)

    def _mode_name(self):
        if self._use_tree is None:
            return "pane"
        return "tree" if self._use_tree else "flat"

    def _get_tree(self):
        if self._tree is None:
            from dpark_tpu_torch import panes as panes_mod
            self._tree = panes_mod.MergeTree(self._pane_by_idx,
                                             self._merge_node)
        return self._tree

    def _merge_node(self, kids, size, start):
        out = kids[0].union(*kids[1:]) \
            .reduceByKey(self.func, self.numSplits).cache()
        return self._tag(out, "tree-merge", pane=start)

    def compute(self, t):
        from dpark_tpu_torch import conf
        t = round(t, 6)
        self._ingest_pane(t)
        if self._use_tree is None:
            self._use_tree = self._np >= max(2, conf.STREAM_PANE_TREE_MIN)
            self._stats["mode"] = self._mode_name()
        hi = self._idx(t)
        lo = max(0, hi - self._np + 1)
        if self._use_tree:
            tree = self._get_tree()
            rdds = tree.cover(lo, hi, max_size=self._max_node)
            self._stats["nodes"] = len(tree.nodes)
            self._stats["node_builds"] = tree.builds
        else:
            rdds = self._window_pane_rdds(t)
        if not rdds:
            return None
        if len(rdds) == 1:
            return rdds[0]
        out = rdds[0].union(*rdds[1:]) \
            .reduceByKey(self.func, self.numSplits).cache()
        return self._tag(out, "window-emit")

    def _forget(self, t, keep):
        super()._forget(t, keep)
        if self._tree is not None and self._anchor is not None:
            horizon = self._window + self._slide * 2
            self._tree.forget(self._idx(t - horizon))


class _InvApply:
    def __init__(self, invFunc):
        self.invFunc = invFunc

    def __call__(self, pair):
        cur, old = pair
        return self.invFunc(cur, old) if old is not None else cur


def _code_is_2arg(f, template):
    """f is a closure-free 2-arg function with the template's bytecode."""
    code = getattr(f, "__code__", None)
    if code is None or getattr(f, "__closure__", None):
        return False
    t = template.__code__
    return (code.co_code == t.co_code
            and code.co_consts == t.co_consts
            and code.co_names == t.co_names
            and code.co_argcount == 2)


def _is_plain_add(f):
    return (f is operator.add
            or _code_is_2arg(f, lambda a, b: a + b)
            or _code_is_2arg(f, lambda a, b: b + a))


def _is_plain_sub(f):
    return f is operator.sub or _code_is_2arg(f, lambda a, b: a - b)


def _neg_value(v):
    return -v


def _arraylike(x):
    """Numeric array-likes: torch tensors (the batched tensors a vmapped
    merge sees included; every torch dtype is numeric) and numpy numeric
    scalars and arrays.  The numpy dtype kind is checked, so np.str_
    cannot slip a string concatenation past the numeric rewrite."""
    if isinstance(x, torch.Tensor):
        return True
    dt = getattr(x, "dtype", None)
    # a dtype without .kind must default-deny
    return (dt is not None and hasattr(x, "shape")
            and getattr(dt, "kind", "?") in "biufc")


class _NumericRewriteError(TypeError):
    """Raised by _CheckedNumericOp when a rewritten union-reduce folds a
    non-numeric pair (a dedicated type, so run_batch never blames the
    rewrite for an unrelated user TypeError)."""


class _CheckedNumericOp:
    """The binary op a numeric union-reduce rewrite folds with,
    re-checking per pair what the 5-record probe asserted: both operands
    are numbers.  It carries the __dpark_monoid__ hint, so the gpu master
    classifies it (utils/monoid.classify_merge) and folds on K3; the
    vmapped trace passes the check (tensors are array-likes).  The
    per-operand verdict caches per (class, dtype kind)."""

    __slots__ = ("op", "__dpark_monoid__")

    _HINTS = {"add": "add", "min": "min", "max": "max", "mul": "mul"}

    # (operand class, dtype kind or None) -> bool, process-global
    _TYPE_VERDICTS = {}

    def __init__(self, op, hint=None):
        self.op = op
        if hint in self._HINTS:
            self.__dpark_monoid__ = hint

    @classmethod
    def _operand_ok(cls, x):
        dt = getattr(x, "dtype", None)
        key = (x.__class__, getattr(dt, "kind", None))
        ok = cls._TYPE_VERDICTS.get(key)
        if ok is None:
            ok = isinstance(x, numbers.Number) or _arraylike(x)
            cls._TYPE_VERDICTS[key] = ok
        return ok

    def __call__(self, a, b):
        if self._operand_ok(a) and self._operand_ok(b):
            return self.op(a, b)
        raise _NumericRewriteError(
            "numeric union-reduce rewrite saw a non-numeric pair "
            "(%s, %s): the probe-based rewrite does not apply to "
            "this stream" % (type(a).__name__, type(b).__name__))


# (op kind, value type) -> bool: sibling streams folding the same op over
# the same record type skip re-deriving the numeric verdict
_PROBE_VERDICTS = {}


def _numeric_verdict(op_kind, values):
    """Are these probed values plain numbers?  Cached per (op kind, value
    type) when the sample is type-homogeneous."""
    vt = values[0].__class__
    if all(v.__class__ is vt for v in values):
        key = (op_kind, vt)
        v = _PROBE_VERDICTS.get(key)
        if v is None:
            v = all(isinstance(x, numbers.Number) for x in values)
            _PROBE_VERDICTS[key] = v
        return v
    return all(isinstance(x, numbers.Number) for x in values)


def _probe_values(rdd, k=5):
    """Up to k records from the first non-empty partition, one
    single-partition job a partition (a partial job runs on the host and
    leaves the stage kinds of full jobs alone)."""
    from itertools import islice

    def head(it):
        return list(islice(it, k))
    for p in range(len(rdd.splits)):
        rows = list(rdd.ctx.runJob(rdd, head, partitions=[p]))[0]
        if rows:
            return rows
    return []


def _classify_state_update(f):
    """The running-sum updateFunc ``(prev or 0) + sum(vs)`` (and its
    spelling variants), or one carrying ``__dpark_state_monoid__``, as
    its binary monoid op for the union-reduce rewrite; None otherwise."""
    hint = getattr(f, "__dpark_state_monoid__", None)
    if hint in ("add", "min", "max", "mul"):
        return {"add": operator.add, "min": min, "max": max,
                "mul": operator.mul}[hint]
    from dpark_tpu_torch.utils import builtin_globals_ok
    for tmpl in (lambda vs, prev: (prev or 0) + sum(vs),
                 lambda vs, prev: sum(vs) + (prev or 0),
                 lambda vs, prev: (prev if prev is not None else 0)
                 + sum(vs)):
        if _code_is_2arg(f, tmpl) and builtin_globals_ok(f):
            return operator.add
    return None


class _TagState:
    """Record-level tag map of the state-mode rewrite: value -> (value
    cast to the state dtype, flag); flag 1 marks the carried state row.
    `+ zero` (a Python 0 or 0.0) is the cast on the host and under
    torch.func.vmap alike.  One instance a (stream, role)."""

    def __init__(self, zero, flag):
        self.zero = zero
        self.flag = flag

    def __call__(self, v):
        return (v + self.zero, self.flag)


class _SegStateApply:
    """Per-group consumer of the state-mode rewrite: the group's items are
    (value, flag) pairs, flag 1 the carried state (at most one a key),
    flag 0 the batch's values.  On the host paths it runs over the list;
    the gpu master recognises `__dpark_seg_state__` and runs the update
    as a state-mode SegMapOp.  Admitted updates return a number in both
    traces, so they never evict (the cogroup path's None filter is
    skipped)."""

    def __init__(self, update):
        self.update = update
        self.__dpark_seg_state__ = update

    def __call__(self, items):
        prev = None
        vs = []
        for v, fl in items:
            if fl:
                prev = v
            else:
                vs.append(v)
        return self.update(vs, prev)


class StateDStream(DerivedDStream):
    def __init__(self, parent, updateFunc, numSplits=None):
        super().__init__(parent)
        self.updateFunc = updateFunc
        self.numSplits = numSplits
        self._monoid_op = _classify_state_update(updateFunc)
        self._numeric = None            # undecided until data shows up
        # the state-mode rewrite: None undecided (needs data), False
        # declined, else (tag_new, tag_old, applyer), built once
        self._seg_state = None
        self._checked_op = None
        if self._monoid_op is not None:
            from dpark_tpu_torch.utils.monoid import classify_merge
            self._checked_op = _CheckedNumericOp(
                self._monoid_op,
                getattr(updateFunc, "__dpark_state_monoid__", None)
                or classify_merge(self._monoid_op))

    def compute(self, t):
        prev = self.generated.get(round(t - self.slide_duration, 6))
        if prev is None:
            # a dropped batch leaves a hole: carry the latest state on
            earlier = [ts for ts, rdd in self.generated.items()
                       if ts < t - 1e-9 and rdd is not None]
            if earlier:
                prev = self.generated[max(earlier)]
        batch = self.parent.getOrCompute(t)
        ctx = self.ssc.ctx
        if self._monoid_op is not None and self._numeric is None \
                and batch is not None:
            probe = _probe_values(batch)
            if probe:
                self._numeric = _numeric_verdict(
                    getattr(self._checked_op, "__dpark_monoid__", "add"),
                    [rec[1] for rec in probe])
        if self._monoid_op is not None and self._numeric:
            # state' = prev U reduce(batch), one union-reduce a batch
            if batch is None and prev is not None:
                return prev
            if batch is not None:
                op = self._checked_op
                reduced = batch.reduceByKey(op, self.numSplits)
                if prev is None:
                    return reduced.cache()
                return prev.union(reduced) \
                    .reduceByKey(op, self.numSplits).cache()
        from dpark_tpu_torch import conf
        if self._monoid_op is None and conf.SEG_STATE \
                and self._seg_state is None and batch is not None:
            self._seg_state = self._classify_seg_state(batch)
        if self._monoid_op is None and self._seg_state:
            tag_new, tag_old, applyer = self._seg_state
            if batch is None and prev is not None:
                b = ctx.parallelize([], 1).mapValue(tag_new)
            elif batch is None:
                return None
            else:
                b = batch.mapValue(tag_new)
            u = b if prev is None else b.union(prev.mapValue(tag_old))
            return u.groupByKey(self.numSplits) \
                    .mapValues(applyer).cache()
        if batch is None:
            batch = ctx.parallelize([], 1)
        if prev is None:
            prev = ctx.parallelize([], 1)
        grouped = batch.cogroup(prev, numSplits=self.numSplits)
        updated = grouped.mapValue(_StateUpdate(self.updateFunc)) \
                         .filter(_state_not_none)
        return updated.mapValue(_unwrap_state).cache()

    def _classify_seg_state(self, batch):
        """(tag_new, tag_old, applyer) when the updateFunc is a traceable,
        padding-invariant update(values, prev) over numeric scalar values
        (the state-mode SegMapOp's admission), False when not (the
        cogroup path), None while there is no data.  The state dtype is
        found by a fixed-point trace under torch.func.vmap (int values
        whose update decays to float carry float state); floats stay
        float64 (ROADMAP C4)."""
        import numpy as np
        f = self.updateFunc
        code = getattr(f, "__code__", None)
        if code is not None and code.co_argcount != 2:
            return False
        probe = _probe_values(batch)
        if not probe:
            return None
        vals = [rec[1] for rec in probe
                if isinstance(rec, tuple) and len(rec) == 2]
        if len(vals) != len(probe) or not all(
                isinstance(v, numbers.Number)
                and not isinstance(v, bool) for v in vals):
            return False
        from torch.func import vmap
        from dpark_tpu_torch.backend.cuda import fuse, layout
        vdt = np.result_type(*[np.asarray(v).dtype for v in vals])
        ds = np.dtype(np.int64) if vdt.kind in "iu" \
            else np.dtype(np.float64)
        try:
            for _ in range(3):
                fn_p, _fn_n = fuse._seg_state_row_fns(f)
                tdt = layout.torch_dtype(ds)
                with fuse.python_float_semantics():
                    outs = vmap(fn_p)(torch.ones((2, 4), dtype=tdt),
                                      torch.ones((2,), dtype=tdt))
                if len(outs) != 1 or outs[0].dim() != 1:
                    return False
                nxt = np.result_type(ds, layout.numpy_dtype(outs[0].dtype))
                if nxt == ds:
                    break
                ds = np.dtype(nxt)
            else:
                return False             # the state dtype does not settle
        except Exception:   # user code: any failure keeps the cogroup path
            return False
        pad, reason, _ = fuse.classify_seg_map(f, ds, state=True)
        if pad is None:
            logger.debug("updateStateByKey stays on the cogroup path: %s",
                         reason)
            return False
        zero = ds.type(0).item()
        return (_TagState(zero, 0), _TagState(zero, 1), _SegStateApply(f))


class _StateUpdate:
    def __init__(self, updateFunc):
        self.updateFunc = updateFunc

    def __call__(self, groups):
        new_values, old_states = groups
        prev = old_states[0] if old_states else None
        return (self.updateFunc(new_values, prev),)


def _state_not_none(kv):
    return kv[1][0] is not None


def _unwrap_state(wrapped):
    return wrapped[0]


class ForEachDStream(DerivedDStream):
    def __init__(self, parent, func):
        super().__init__(parent)
        self.func = func
        self._two_args = _takes_time(func)

    def compute(self, t):
        return self.parent.getOrCompute(t)

    def generate_job(self, t):
        rdd = self.getOrCompute(t)
        if rdd is None:
            return
        if self._two_args:
            self.func(rdd, t)
        else:
            self.func(rdd)


# --------------------------------------------------------------------------
# input streams
# --------------------------------------------------------------------------
class InputDStream(DStream):
    def __init__(self, ssc):
        super().__init__(ssc)
        ssc.input_streams.append(self)

    def start(self):
        pass

    def stop(self):
        pass


class ConstantInputDStream(InputDStream):
    def __init__(self, ssc, rdd):
        super().__init__(ssc)
        self.rdd = rdd

    def compute(self, t):
        return self.rdd


class QueueInputDStream(InputDStream):
    def __init__(self, ssc, queue, oneAtATime=True, defaultRDD=None):
        super().__init__(ssc)
        self.queue = queue
        self.oneAtATime = oneAtATime
        self.defaultRDD = defaultRDD

    def put(self, item):
        self.queue.append(item)

    def _to_rdd(self, item):
        from dpark_tpu_torch.rdd import RDD
        if isinstance(item, RDD):
            return item
        # the default parallelism (the shard count on the gpu master)
        return self.ssc.ctx.parallelize(item)

    def compute(self, t):
        if self.queue:
            if self.oneAtATime:
                return self._to_rdd(self.queue.pop(0))
            items = list(self.queue)
            del self.queue[:len(items)]
            rdds = [self._to_rdd(i) for i in items]
            return rdds[0] if len(rdds) == 1 else self.ssc.ctx.union(rdds)
        return self.defaultRDD
