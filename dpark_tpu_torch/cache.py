"""In-process partition cache of RDD.cache() and of the gpu master's
device precompute (the memory tier of dpark_tpu/cache.py; the port has
no disk tier).  Entries are keyed by (rdd id, split index) and hold the
partition's records as a list."""

import threading


class Cache:
    def __init__(self):
        self.memory = {}
        self.lock = threading.Lock()

    def get(self, key):
        with self.lock:
            return self.memory.get(key)

    def put(self, key, items):
        items = list(items)
        with self.lock:
            self.memory[key] = items
        return items

    def drop(self, rdd_id, n_splits):
        with self.lock:
            for i in range(n_splits):
                self.memory.pop((rdd_id, i), None)

    def holds(self, rdd_id, n_splits):
        """Whether every partition of the RDD is cached."""
        with self.lock:
            return all((rdd_id, i) in self.memory for i in range(n_splits))

    def clear(self):
        with self.lock:
            self.memory.clear()


def get_or_compute(rdd, split):
    """RDD.iterator's hook for a cached RDD: the cached partition, or
    compute it once and keep it."""
    cache = rdd.ctx.cache
    key = (rdd.id, split.index)
    cached = cache.get(key)
    if cached is not None:
        return iter(cached)
    return iter(cache.put(key, rdd.compute(split)))
