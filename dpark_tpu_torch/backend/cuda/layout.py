"""Columnar batch layout of the gpu master (port of
dpark_tpu/backend/tpu/layout.py).

The object path holds a partition as a Python iterator of records.  The
tensor path holds a stage's worth of partitions as a struct of arrays on
one device:

  * a record is a nested tuple of scalar (or fixed-shape array) leaves,
    e.g. ``(k, v)`` or ``((k1, k2), (a, b))`` or a bare scalar;
  * each leaf becomes one contiguous tensor of shape ``(N, cap, ...)``:
    logical shard s (= partition s) owns row s;
  * ``counts`` (``(N,)`` int32) gives the valid rows of each shard; rows
    past the count are padding.

The record structure ("treedef") is a nested tuple of leaf indices —
``(0, (1, 2))`` for ``(k, (a, b))``, ``0`` for a bare scalar — built and
read by tree_flatten / tree_unflatten below.  ``None`` is an empty
subtree (no leaf), as jax.tree_util treats it: distinct's ``(x, None)``
records ride the tensor path with the key as their only leaf.
"""

import itertools
import math

import numpy as np
import torch

from dpark_tpu_torch import conf

class HostPath(ValueError):
    """Raised before any device work when a stage's data cannot ride the
    tensor path (e.g. a key equal to the padding sentinel); the
    scheduler records the message as the stage's fallback_reason and
    runs the host object path."""


def make_mesh(ndev):
    """The logical shard count of a gpu:N master."""
    ndev = int(ndev)
    if ndev < 1:
        raise ValueError("need at least one shard")
    return ndev


def round_capacity(n):
    """Pad capacities to power-of-two size classes."""
    return max(8, 1 << math.ceil(math.log2(max(n, 1))))


def round_capacity_fine(n):
    """Pad to 1/16th-octave size classes (worst-case padding 6.25%)."""
    n = max(n, 1)
    if n <= 128:
        return round_capacity(n)
    k = (n - 1).bit_length() - 1          # n in (2^k, 2^(k+1)]
    step = 1 << (k - 4)                   # 16 classes per octave
    return -(-n // step) * step


# ---------------------------------------------------------------------
# record structure
# ---------------------------------------------------------------------
def tree_flatten(rec):
    """(leaves, treedef) of a record: tuples are nodes, None an empty
    subtree, anything else a leaf."""
    leaves = []

    def walk(x):
        if x is None:
            return None
        if isinstance(x, tuple):
            return tuple(walk(c) for c in x)
        leaves.append(x)
        return len(leaves) - 1
    return leaves, walk(rec)


def tree_unflatten(treedef, leaves):
    if treedef is None:
        return None
    if isinstance(treedef, int):
        return leaves[treedef]
    return tuple(tree_unflatten(c, leaves) for c in treedef)


def tree_leaves(rec):
    return tree_flatten(rec)[0]


def num_leaves(treedef):
    if treedef is None:
        return 0
    if isinstance(treedef, int):
        return 1
    return sum(num_leaves(c) for c in treedef)


def _renumber(treedef, start=0):
    """A treedef (sub-tree) renumbered from `start`."""
    n = [start]

    def walk(t):
        if t is None:
            return None
        if isinstance(t, int):
            n[0] += 1
            return n[0] - 1
        return tuple(walk(c) for c in t)
    return walk(treedef)


class Batch:
    """One stage's partitions on the device, struct of arrays."""

    def __init__(self, treedef, cols, counts):
        self.treedef = treedef
        self.cols = list(cols)          # leaf tensors, each (N, cap, ...)
        self.counts = counts            # (N,) int32
        self.ndev = cols[0].shape[0]
        self.cap = cols[0].shape[1]


def _leaf_dtype(leaf):
    if isinstance(leaf, (str, bytes, list, dict, set)):
        raise TypeError("leaf of type %s has no tensor form"
                        % type(leaf).__name__)
    arr = np.asarray(leaf)
    dt = arr.dtype
    if dt == np.bool_:
        return np.dtype(np.bool_), arr.shape
    if np.issubdtype(dt, np.integer):
        # int64 so counting/summing workloads cannot silently wrap
        return np.dtype(np.int64), arr.shape
    if np.issubdtype(dt, np.floating):
        # float64: Python floats' precision (the TPU package narrows to
        # float32; a GPU has a float64 datapath)
        return np.dtype(np.float64), arr.shape
    raise TypeError("leaf dtype %s has no tensor form" % dt)


def record_spec(sample):
    """(treedef, [(numpy dtype, shape)] per leaf) of a sample record."""
    leaves, treedef = tree_flatten(sample)
    if not leaves:
        raise TypeError("a record with no leaves has no tensor form")
    return treedef, [_leaf_dtype(leaf) for leaf in leaves]


def torch_dtype(dt):
    return torch.from_numpy(np.zeros(0, dtype=dt)).dtype


def numpy_dtype(dt):
    return torch.zeros(0, dtype=dt).numpy().dtype


def ingest(ndev, device, partitions, treedef, specs, key_leaf=None,
           fine=False):
    """Host partitions (len == ndev lists of records, or columnar
    slices) -> Batch on `device`.  With `key_leaf`, a key equal to the
    padding sentinel raises HostPath before anything reaches the
    device.  `fine` pads to a 1/16-octave capacity class (a wave of the
    stream) instead of a power of two.

    The host-to-device wire narrows (B14, conf.NARROW_EXCHANGE): when
    every non-empty partition is columnar, an int64 scalar leaf whose
    values all fit int32 (one host pass a column) is cast to int32 on the
    host, copied as int32, and widened back to int64 on the device; the
    Batch holds the spec dtypes either way."""
    assert len(partitions) == ndev, (len(partitions), ndev)
    counts = np.array([len(p) for p in partitions], dtype=np.int32)
    rnd = round_capacity_fine if fine else round_capacity
    cap = rnd(int(counts.max()) if len(counts) else 1)
    host = []                      # per partition: list of leaf arrays
    columnar = True
    for part in partitions:
        cols = getattr(part, "columns", None)
        if not len(part):
            host.append(None)
        elif cols is not None and len(cols) == len(specs):
            host.append([np.asarray(c).astype(dt, copy=False)
                         for c, (dt, _) in zip(cols, specs)])
        elif len(specs) == 1 and treedef == 0:
            columnar = False
            host.append([np.asarray(list(part), dtype=specs[0][0])])
        else:
            columnar = False
            leaf_lists = [[] for _ in specs]
            for rec in part:
                leaves = tree_leaves(rec)
                if len(leaves) != len(specs):
                    raise HostPath("records of mixed structure")
                for li, leaf in enumerate(leaves):
                    leaf_lists[li].append(leaf)
            try:
                host.append([np.asarray(ll, dtype=dt)
                             for ll, (dt, _) in zip(leaf_lists, specs)])
            except (TypeError, ValueError, OverflowError) as e:
                raise HostPath("records do not fit the sampled leaf "
                               "types (%s)" % e) from e
    for arrays in host:
        if arrays is None:
            continue
        for a, (dt, shape) in zip(arrays, specs):
            if a.shape[1:] != tuple(shape):
                raise HostPath("records of mixed leaf shapes")
    # the fit scan: (lo, hi) of each int64 scalar leaf of a columnar input
    ranges = {}
    if conf.NARROW_EXCHANGE and columnar:
        for li, (dt, shape) in enumerate(specs):
            if np.dtype(dt) == np.int64 and tuple(shape) == ():
                ranges[li] = _fit_scan(host, li)
    if key_leaf is not None:
        _check_key(host, key_leaf, ranges.get(key_leaf))
    dev_cols = []
    for li, (dt, shape) in enumerate(specs):
        rng = ranges.get(li)
        wire = dt
        if rng is not None and _I32.min <= rng[0] and rng[1] <= _I32.max:
            wire = np.dtype(np.int32)
        col = torch.zeros((ndev, cap) + tuple(shape),
                          dtype=torch_dtype(wire), device=device)
        for d, arrays in enumerate(host):
            if arrays is not None:
                src = torch.from_numpy(np.ascontiguousarray(arrays[li]))
                _h2d(col[d, :counts[d]], src.to(col.dtype))
        if wire != dt:
            col = col.to(torch_dtype(dt))       # widen on the device
        dev_cols.append(col)
    return Batch(treedef, dev_cols,
                 torch.from_numpy(counts).to(device))


_I32 = np.iinfo(np.int32)


def _fit_scan(host, li):
    """(lo, hi) of leaf `li` over every partition's host array, one
    multi-threaded pass a partition (torch.aminmax); None when all are
    empty."""
    lo = hi = None
    for arrays in host:
        if arrays is None or not arrays[li].size:
            continue
        mn, mx = torch.aminmax(torch.from_numpy(
            np.ascontiguousarray(arrays[li])))
        mn, mx = int(mn), int(mx)
        lo = mn if lo is None else min(lo, mn)
        hi = mx if hi is None else max(hi, mx)
    return None if lo is None else (lo, hi)


def _check_key(host, key_leaf, rng):
    """HostPath when a key collides with the device padding: a float key
    that is inf or nan, an int key equal to its spec dtype's max (the
    sentinel; `rng` is the fit scan's (lo, hi) when it ran)."""
    for arrays in host:
        if arrays is None:
            continue
        kc = arrays[key_leaf]
        if kc.dtype.kind == "f":
            if np.isinf(kc).any() or np.isnan(kc).any():
                raise HostPath("inf/nan float key collides with "
                               "device padding; taking the host path")
        elif kc.size and rng is None \
                and int(kc.max()) == int(np.iinfo(kc.dtype).max):
            raise HostPath("key equal to the device sentinel; "
                           "taking the host path")
    if rng is not None and rng[1] == int(np.iinfo(np.int64).max):
        raise HostPath("key equal to the device sentinel; "
                       "taking the host path")


def _h2d(dst, src):
    """The host-to-device copy of one shard's leaf (src is already in the
    wire dtype)."""
    dst.copy_(src)


def batch_from_numpy(treedef, counts, cols, device):
    """Batch from numpy arrays of the same layout — e.g. the JAX
    package's batch read back to the host — so both packages can run the
    reduce side on one stored map output."""
    return Batch(treedef,
                 [torch.from_numpy(np.ascontiguousarray(c)).to(device)
                  for c in cols],
                 torch.from_numpy(
                     np.asarray(counts, dtype=np.int32)).to(device))


def egest(batch):
    """Batch -> list of per-shard row lists on the host."""
    counts = batch.counts.cpu().numpy()
    # only the longest valid prefix crosses to the host, not the padding
    m = int(counts.max()) if len(counts) else 0
    host_cols = _egest_read(batch.cols, batch.counts, m)
    tdef = batch.treedef
    out = []
    for d in range(batch.ndev):
        n = int(counts[d])
        if not n:
            out.append([])
            continue
        lists = [c[d, :n].tolist() for c in host_cols]
        if isinstance(tdef, int):
            out.append(lists[0])
        else:
            out.append(list(_zip_build(tdef, lists)))
    return out


def _egest_read(cols, counts, m):
    """The first m rows of each column on the host.  The device-to-host
    wire narrows (B14, conf.NARROW_EXCHANGE): the int64 (N, cap) columns
    of at least conf.EGEST_NARROW_MIN_BYTES go through one K15 launch
    (min/max over each shard's valid rows), one host read of each
    column's (lo, hi), and a column that fits int32 is cast on the device
    and crosses as int32 (the row lists built from it are the same
    Python ints)."""
    big = [i for i, c in enumerate(cols)
           if conf.NARROW_EXCHANGE and c.dim() == 2
           and c.dtype == torch.int64
           and c.numel() * c.element_size() >= conf.EGEST_NARROW_MIN_BYTES]
    fits = set()
    if big and m:
        from dpark_tpu_torch.backend.cuda import kernels
        r = kernels.column_ranges([cols[i] for i in big], counts)
        lohi = torch.stack([r[:, :, 0].amin(1), r[:, :, 1].amax(1)], 1)
        for i, (lo, hi) in zip(big, lohi.cpu().tolist()):
            if _I32.min <= lo and hi <= _I32.max:
                fits.add(i)
    return [_d2h(c[:, :m].to(torch.int32) if i in fits else c[:, :m])
            for i, c in enumerate(cols)]


def _d2h(t):
    """The device-to-host copy of an egested column."""
    return t.cpu().numpy()


def _zip_build(struct, lists):
    if struct is None:
        return itertools.repeat(None)
    if isinstance(struct, int):
        return lists[struct]
    return zip(*[_zip_build(x, lists) for x in struct])


def key_width(treedef, specs, kinds="i"):
    """Number of leading KEY COLUMNS of a ``(key, value...)`` record: 1
    for a scalar key, n for a flat tuple key of n scalars (2..
    conf.MAX_KEY_LEAVES), None otherwise (host path).  Every key leaf
    must be a scalar whose dtype kind is in `kinds`."""
    if not specs or not (isinstance(treedef, tuple) and len(treedef) >= 2):
        return None
    key = treedef[0]
    if key == 0:
        nk = 1
    elif (isinstance(key, tuple)
          and 2 <= len(key) <= conf.MAX_KEY_LEAVES
          and all(key[i] == i for i in range(len(key)))):
        nk = len(key)
    else:
        return None
    for dt, shape in specs[:nk]:
        if shape != () or np.dtype(dt).kind not in kinds:
            return None
    return nk

