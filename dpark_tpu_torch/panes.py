"""Pane-tree windowing: the machinery behind the sliding-window DStreams
in dstream.py (port of dpark_tpu/panes.py without its event-time part,
ROADMAP A14b).

A window of w = window/slide panes shares slide-sized partial aggregates
across consecutive window instances instead of re-reducing the whole
window every slide.  Each pane is one cached reduced RDD; on the gpu
master its shuffle output stays on the device between ticks, so a tick
costs the merge work:

  invertible ops      window' = prev + new pane - expired pane: a
                      constant number of panes per slide
                      (ReducedWindowedDStream)
  non-invertible ops  the window's pane range decomposes into at most
                      ~2*log2(w) aligned dyadic blocks; each block's
                      merge is built once, cached, and reused while any
                      later window covers it (MergeTree below)

Every pane stream registers a live stats dict here (stream_stats()).
"""

import itertools
import threading


def dyadic_blocks(lo, hi, max_size=None):
    """Aligned power-of-two blocks covering the inclusive pane-index
    range [lo, hi]: each block (start, size) has size a power of two and
    start % size == 0, so consecutive windows share most blocks.  At
    most ~2*log2(hi-lo+1) blocks; `max_size` caps the block size."""
    assert lo >= 0 and hi >= lo, (lo, hi)
    out = []
    i = lo
    while i <= hi:
        size = (i & -i) if i else 1 << 60
        if max_size:
            size = min(size, max_size)
        while i + size - 1 > hi:
            size >>= 1
        out.append((i, size))
        i += size
    return out


class MergeTree:
    """Cache of dyadic pane-merge nodes for a non-invertible window.

    `get_pane(idx)` returns the pane partial (an RDD) or None;
    `merge(rdds, size, start)` combines children into one node RDD.
    `cover(lo, hi)` returns the node RDDs for a window's pane range,
    building missing nodes bottom-up (each build merges its two
    half-size children).  `invalidate(idx)` drops the nodes covering one
    pane; `forget(before_idx)` the nodes no later window can cover."""

    def __init__(self, get_pane, merge):
        self.get_pane = get_pane
        self.merge = merge
        self.nodes = {}                # (start, size) -> rdd or None
        self._owned = set()            # keys whose rdd this tree built
        self.builds = 0                # merge nodes built

    def _node(self, start, size):
        if size == 1:
            return self.get_pane(start)
        key = (start, size)
        if key in self.nodes:
            return self.nodes[key]
        half = size // 2
        kids = [self._node(start, half), self._node(start + half, half)]
        kids = [k for k in kids if k is not None]
        if not kids:
            rdd = None
        elif len(kids) == 1:
            rdd = kids[0]              # an empty half: the node is its child
        else:
            rdd = self.merge(kids, size, start)
            self._owned.add(key)
            self.builds += 1
        self.nodes[key] = rdd
        return rdd

    def cover(self, lo, hi, max_size=None):
        """Node RDDs covering panes [lo, hi] (Nones filtered)."""
        out = []
        for start, size in dyadic_blocks(lo, hi, max_size):
            rdd = self._node(start, size)
            if rdd is not None:
                out.append(rdd)
        return out

    def invalidate(self, idx):
        """Drop every cached node covering pane `idx` (at most one a
        level)."""
        for start, size in list(self.nodes):
            if start <= idx < start + size:
                self._drop((start, size))

    def forget(self, before_idx):
        """Drop nodes that end before `before_idx`."""
        for start, size in list(self.nodes):
            if start + size - 1 < before_idx:
                self._drop((start, size))

    def _drop(self, key):
        rdd = self.nodes.pop(key)
        # only unpersist rdds this tree built: a single-child node is a
        # pane (or a lower node) that may still be live in the window
        if key in self._owned:
            self._owned.discard(key)
            if rdd is not None and getattr(rdd, "should_cache", False):
                rdd.unpersist()


# ---------------------------------------------------------------------------
# live per-stream stats registry
# ---------------------------------------------------------------------------
_REG_LOCK = threading.Lock()
_REGISTRY = {}
_ids = itertools.count(1)


def new_stream_id(kind):
    return "%s-%d" % (kind, next(_ids))


def register_stream(sid, stats):
    """Expose a stream's live stats dict (the stream updates it in place
    each tick; readers snapshot under the lock)."""
    with _REG_LOCK:
        _REGISTRY[sid] = stats


def unregister_stream(sid):
    with _REG_LOCK:
        _REGISTRY.pop(sid, None)


def stream_stats():
    """Snapshot of every registered pane stream's stats."""
    with _REG_LOCK:
        return {sid: dict(st) for sid, st in _REGISTRY.items()}
