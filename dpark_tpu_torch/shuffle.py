"""In-process shuffle bucket store of the host object path, and the
cogroup merger (the subset of dpark_tpu/shuffle.py the port needs).

A host map task writes its buckets here ("mem://<sid>"), pickled, so
every fetch gets fresh combiners: a reduce merge that mutates one (list
extend) must not change what a later job reads.  A device map stage
leaves its output on the device ("hbm://<sid>") and the store reads such
buckets through the executor's export bridge, so a host reduce stage can
consume either.
"""

import pickle
import zlib


class SpillCorruption(IOError):
    """A spilled run failed its crc check: the run is refused, never
    unpickled into a wrong answer."""


def spill_crc(blob):
    """Checksum of a spilled run's framing (zlib's crc32): runs are
    written and read by one installation, so the polynomial only has to
    agree with itself."""
    return zlib.crc32(blob) & 0xFFFFFFFF


class BucketStore:
    def __init__(self):
        self._buckets = {}         # (sid, map_id) -> [items per reduce]
        self._map_outputs = {}     # sid -> [uri per map id]
        self.exporter = None       # export_bucket(sid, map_id, reduce_id)

    def write_buckets(self, sid, map_id, buckets):
        """Store one map task's per-reduce {key: combiner} buckets."""
        self._buckets[(sid, map_id)] = [pickle.dumps(list(b.items()), -1)
                                        for b in buckets]
        return "mem://%d" % sid

    def set_map_outputs(self, sid, uris):
        self._map_outputs[sid] = list(uris)

    def has_outputs(self, sid):
        return sid in self._map_outputs

    def fetch(self, sid, reduce_id):
        """Every map output's (key, combiner) items for one reduce
        partition, in map order."""
        uris = self._map_outputs.get(sid)
        if uris is None:
            raise KeyError("shuffle %d has no map outputs" % sid)
        for map_id, uri in enumerate(uris):
            if uri.startswith("hbm://"):
                yield from self.exporter(sid, map_id, reduce_id)
            else:
                yield from pickle.loads(
                    self._buckets[(sid, map_id)][reduce_id])

    def drop(self, sid):
        self._map_outputs.pop(sid, None)
        for key in [k for k in self._buckets if k[0] == sid]:
            del self._buckets[key]


class CoGroupMerger:
    """Merge n sources into key -> tuple of n value lists (backs
    CoGroupedRDD)."""

    def __init__(self, n_sources):
        self.n = n_sources
        self.combined = {}

    def _slot(self, key):
        slot = self.combined.get(key)
        if slot is None:
            slot = tuple([] for _ in range(self.n))
            self.combined[key] = slot
        return slot

    def append(self, src_index, items):
        """items of (k, v) from a narrow (co-partitioned) source."""
        for k, v in items:
            self._slot(k)[src_index].append(v)

    def extend(self, src_index, items):
        """items of (k, list of v) from a shuffled source."""
        for k, vs in items:
            self._slot(k)[src_index].extend(vs)

    def __iter__(self):
        return iter(self.combined.items())
