"""Shuffle primitives of the gpu master (port of the main-path subset of
dpark_tpu/backend/tpu/collectives.py).

The reference functions work on ONE device's block inside shard_map.
Here every function takes the whole ``(N, cap, ...)`` batch with the
shard axis written out, and a shard's valid rows are its first ``n[s]``
rows (``n`` an ``(N,)`` int32 tensor) instead of a validity mask:

  hash destination + histogram   K1 hash_dst_hist
  stable partition by bucket     K2 stable_partition (also compact)
  merge runs of equal keys       K3 reduce_by_key_compact
  exchange among the N shards    K4 shard_exchange
  stable sort by a key column    K5 radix_sort (every _lex_sort key pass)
  range destination + histogram  K6 range_dst_hist
  segment table of sorted rows   K7 segment_table
  members of each size class     K2 stable_partition (by K7's class)
  padded groups of a size class  K8 bucket_gather (and bucket_scatter)
  join match ranges, expansion   K12 join_ranges, join_expand
  fold logical partitions        K13 rid_fold (spilled-run stream)
  merge runs by a traced merge   K14 segmented_merge, then K3 "last"

A user merge that is not a classified single-leaf monoid is traced and
lowered into a register program once, when it is probed
(merge_program.py); K14 runs the program.  A merge the lowering refuses
keeps the plain segmented scan of the vmapped merge (segmented_combine)
on the same device.
"""

import torch

from dpark_tpu_torch.backend.cuda import kernels
from dpark_tpu_torch.backend.cuda import layout
from dpark_tpu_torch.backend.cuda import merge_program


def _sentinel(dtype):
    """Padding key of a key column dtype: its max (ints), +inf (floats)."""
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def valid_rows(n, cap):
    """(N, cap) bool: row < n[s]."""
    return torch.arange(cap, device=n.device)[None, :] < n[:, None]


def hash_dst_cols(key_cols, n_dst, n, r=None, want_hist=False,
                  want_hash=False):
    """Destination partition by portable hash over one or more int key
    columns (HashPartitioner.get_partition of the key, or of the tuple
    key); padding rows get n_dst.  Returns (dst, hist, hash)."""
    r = n_dst if r is None else r
    return kernels.hash_dst_hist(key_cols, n, r, n_dst,
                                 want_hist=want_hist, want_hash=want_hash)


def lex_searchsorted(sorted_cols, query_cols, side="left"):
    """Multi-column searchsorted: for each query row (one value per (N,
    cap) column), the insertion index into the rows of `sorted_cols`
    ((m,) columns, sorted lexicographically ascending) -- before equal
    rows with side "left", after them with "right" -- by the reference's
    vectorised binary search: bit_length(m) fixed steps of a row-wise
    lexicographic compare.  Returns (N, cap) int64."""
    m = int(sorted_cols[0].shape[0])
    q0 = query_cols[0]
    lo = torch.zeros(q0.shape, dtype=torch.int64, device=q0.device)
    if m == 0:
        return lo
    hi = torch.full_like(lo, m)
    for _ in range(m.bit_length()):
        active = lo < hi
        mid = (lo + hi) >> 1
        safe = mid.clamp(0, m - 1)
        lt = eq = None
        for b, q in zip(sorted_cols, query_cols):
            a = b[safe]
            c_lt, c_eq = a < q, a == q
            lt = c_lt if lt is None else lt | (eq & c_lt)
            eq = c_eq if eq is None else eq & c_eq
        if side == "right":
            lt = lt | eq
        lo = torch.where(active & lt, mid + 1, lo)
        hi = torch.where(active & ~lt, mid, hi)
    return lo


def range_dst_cols(key_cols, bounds, ascending, n_dst, n, r=None):
    """Destination partition by sorted bounds (RangePartitioner.
    get_partition of the key, or of the tuple key compared
    lexicographically) over 1..4 key columns of one dtype; padding rows
    get n_dst.  `bounds` is the (m, nk) device tensor of the stage.
    Returns (dst (N, cap) int32, histogram (N, n_dst + 1))."""
    r = n_dst if r is None else r
    return kernels.range_dst_hist([k.contiguous() for k in key_cols], bounds,
                                  ascending, r, n_dst, n)


def _lex_order(key_cols):
    """The (N, cap) int32 permutation that stable-sorts each shard's rows
    lexicographically by key_cols: one K5 pass per column, last column
    first, each reading its column through the running permutation."""
    order = None
    for col in reversed(list(key_cols)):
        order = kernels.radix_sort(col.contiguous(), src_idx=order)
    return order


def _partition_through(bucket, nb, leaves, order, want_bucket=True,
                       counts=None):
    """K2 by a small int32 bucket column over rows in `order` (None: the
    identity), gathering `leaves` through it; `counts`, the (N, nb)
    bucket counts when the caller holds them.  Returns (sorted bucket or
    None unless want_bucket, *sorted leaves, counts (N, nb))."""
    if order is not None:
        bucket = torch.gather(bucket, 1, order.long())
    bucket = bucket.contiguous()
    out = []
    for i in range(0, max(1, len(leaves)), kernels.MAX_LEAVES):
        part, counts, b = kernels.stable_partition(
            bucket, nb, leaves[i:i + kernels.MAX_LEAVES], src_idx=order,
            want_bucket=want_bucket and i == 0, counts=counts)
        if i == 0:
            bsorted = b
        out.extend(part)
    return (bsorted,) + tuple(out) + (counts,)


def _lex_sort(ops, num_keys, nb0=None, want_bucket=True, counts=None):
    """Stable lexicographic sort of each shard's rows of `ops` by its
    first num_keys operands.  K5 passes compose one permutation, key
    num_keys-1 first; every operand is gathered once.  With `nb0` the
    first key is a small int32 bucket column in [0, nb0) and the last
    pass is K2's stable partition, which also does the gather (the
    sorted bucket comes back as None unless want_bucket; `counts`, the
    bucket's (N, nb0) counts when the caller holds them).  Returns the
    sorted ops (and, with nb0, the (N, nb0) bucket counts as a last
    element)."""
    ops = list(ops)
    if nb0 is None:
        order = _lex_order(ops[:num_keys])
        return tuple(kernels.shard_rows(o, order) for o in ops)
    order = _lex_order(ops[1:num_keys]) if num_keys > 1 else None
    return _partition_through(ops[0], nb0, ops[1:], order, want_bucket,
                              counts)


def compact(leaves, mask):
    """Move rows where mask is True to the front of each shard (stable):
    a two-bucket K2 partition.  Returns (leaves, new counts)."""
    keep = mask.sum(1).to(torch.int32)
    if not leaves:
        return [], keep
    counts = torch.stack([keep, mask.shape[1] - keep], 1).to(torch.int32)
    packed = _partition_through((~mask).to(torch.int32), 2, list(leaves),
                                None, want_bucket=False, counts=counts)
    return list(packed[1:-1]), keep


def _excl_offsets(counts):
    return (torch.cumsum(counts, 1) - counts).to(torch.int32)


def bucketize(leaves, n, n_dst, dst, hist):
    """Sort each shard's rows by destination (padding rows, in bucket
    n_dst, last); `hist` is dst's (N, n_dst + 1) histogram over every row
    (K1, K6 or K13), which K2 reads in place of counting.  Returns
    (sorted leaves, counts (N, n_dst), offsets)."""
    sorted_ops = _lex_sort([dst] + list(leaves), 1, nb0=n_dst + 1,
                           want_bucket=False, counts=hist.contiguous())
    counts = hist[:, :n_dst].contiguous()
    return list(sorted_ops[1:-1]), counts, _excl_offsets(counts)


def _starts(key_cols):
    """(N, cap) bool: row 0, or any key column differs from the row
    before (the run boundaries of _changed_adjacent)."""
    start = torch.zeros(key_cols[0].shape[:2], dtype=torch.bool,
                        device=key_cols[0].device)
    start[:, 0] = True
    for c in key_cols:
        start[:, 1:] |= c[:, 1:] != c[:, :-1]
    return start


# the scan of the vmapped merge: the route of a merge that is not lowered
segmented_combine = kernels.segmented_scan


def _monoid_ok(monoid, val_leaves):
    return (monoid is not None and len(val_leaves) == 1
            and val_leaves[0].dtype in (torch.int64, torch.float64))


def _merge_runs(key_cols, fills, val_leaves, n, merge_leaves, monoid,
                dst_col=None, n_dst=0):
    """K3 over rows sorted by key_cols: a classified monoid reduces in the
    kernel; any other merge leaves each run's merge at its last row
    first -- K14 over the merge's program, or the scan of the vmapped
    merge when it has none -- and K3 keeps those rows.  Every traced
    merge of the port reaches K14 here."""
    if _monoid_ok(monoid, val_leaves):
        return kernels.reduce_by_key_compact(
            key_cols, fills, val_leaves, n, monoid, dst_col, n_dst)
    merged = []
    # leafless values (distinct's (x, None)) have nothing to merge
    if val_leaves:
        starts = _starts(key_cols)
        program = merge_program.program_for(
            merge_leaves, merge_program.signature(val_leaves))
        if program is not None:
            merged = kernels.segmented_merge(
                starts, n, [v.contiguous() for v in val_leaves], program)
        else:
            merged = segmented_combine(starts, val_leaves, merge_leaves)
    return kernels.reduce_by_key_compact(
        key_cols, fills, [s.contiguous() for s in merged], n, "last",
        dst_col, n_dst)


def bucketize_combine_keys(key_cols, val_leaves, n, n_dst, merge_leaves,
                           monoid=None, dst=None, r=None, order_col=None):
    """Map-side pre-combine: sort each shard's rows by (destination,
    key columns), merge rows equal in every key column, pack.  Composite
    keys sort by their 32-bit hash (`order_col`) instead of the n key
    columns: the combine only needs equal keys adjacent within their
    destination run (boundaries still compare every key column).
    Returns (key_cols', vals', counts (N, n_dst), offsets (N, n_dst))."""
    key_cols = list(key_cols)
    nk = len(key_cols)
    cap = key_cols[0].shape[1]
    if dst is None:
        dst, _, order_col = hash_dst_cols(key_cols, n_dst, n, r,
                                          want_hash=nk > 1)
    k0 = torch.where(valid_rows(n, cap), key_cols[0],
                     _sentinel(key_cols[0].dtype))
    ks = [k0] + key_cols[1:]
    if nk > 1:
        ops = [dst, order_col] + ks + list(val_leaves)
        sorted_ops = _lex_sort(ops, 2, nb0=n_dst + 1)
        d, ks = sorted_ops[0], list(sorted_ops[2:2 + nk])
    else:
        sorted_ops = _lex_sort([dst] + ks + list(val_leaves), 1 + nk,
                               nb0=n_dst + 1)
        d, ks = sorted_ops[0], list(sorted_ops[1:1 + nk])
    vals = list(sorted_ops[len(sorted_ops) - 1 - len(val_leaves):-1])
    fills = [n_dst] + [_sentinel(k.dtype) for k in ks]
    k_out, v_out, _, counts, offsets = _merge_runs(
        [d] + ks, fills, vals, n, merge_leaves, monoid, dst_col=0,
        n_dst=n_dst)
    return k_out[1:], v_out, counts, offsets


def bucketize_combine_rid(rid, key_cols, val_leaves, n, n_dst,
                          merge_leaves, monoid=None):
    """Map-side pre-combine of the spilled-run stream (B12; more logical
    partitions than shards): K13 folds each row's logical partition `rid`
    ((N, cap) int32 in [0, r)) onto its shard dev = rid % n_dst; K5 passes
    sort by (rid, key columns) and K2's partition by dev; K3 (after K14
    for a traced merge) merges rows equal in (rid, every key column) and
    packs them, with per-shard counts.  The rows
    sort by the TRUE key columns, never by a key hash: the spilled runs'
    premerge and the export's adjacent fold rely on lexicographic run
    order.  Returns ([rid', key cols'...] + vals', counts (N, n_dst),
    offsets (N, n_dst)); rid' is int64."""
    key_cols = list(key_cols)
    nk = len(key_cols)
    if 2 + nk > kernels.MAX_KEYS:
        raise ValueError("(dev, rid) and %d key columns exceed the %d key "
                         "columns K3 merges" % (nk, kernels.MAX_KEYS))
    dev, rid64, _ = kernels.rid_fold(rid, n, n_dst)
    vals = list(val_leaves)
    sorted_ops = _lex_sort([dev, rid64] + key_cols + vals, 2 + nk,
                           nb0=n_dst + 1)
    ks = list(sorted_ops[:2 + nk])
    vals = list(sorted_ops[2 + nk:-1])
    fills = [n_dst, kernels.KEY_SENTINEL] + [_sentinel(k.dtype)
                                             for k in key_cols]
    k_out, v_out, _, counts, offsets = _merge_runs(
        ks, fills, vals, n, merge_leaves, monoid, dst_col=0, n_dst=n_dst)
    return list(k_out[1:]) + list(v_out), counts, offsets


def exchange(leaves, counts, offsets, key_index=0):
    """All-to-all among the N shards: shard d receives bucket d of every
    shard, source-major, padded to a fine capacity class; the key
    column's tail holds the sentinel.  N == 1 is the identity.  Returns
    (received leaves, recv counts (N,) int32)."""
    N = counts.shape[0]
    cap_out = layout.round_capacity_fine(int(counts.sum(0).max().item()))
    k = leaves[key_index]
    if N == 1:
        # the stored rows are already packed: keep the received prefix
        cap_out = min(cap_out, k.shape[1])
        recv = counts[:, 0].contiguous()
        out = [leaf[:, :cap_out].contiguous() for leaf in leaves]
        out[key_index] = torch.where(valid_rows(recv, cap_out),
                                     out[key_index], _sentinel(k.dtype))
        return out, recv
    return kernels.shard_exchange(leaves, counts, offsets, cap_out,
                                  key_index, _sentinel(k.dtype))


def segment_reduce_keys(key_cols, val_leaves, n, merge_leaves, monoid=None):
    """Reduce side: sort each shard's received rows by the key columns
    (padding, whose key column 0 is the sentinel, sorts last), merge rows
    equal in every key column, pack.  Returns (key_cols', vals',
    n_unique)."""
    nk = len(key_cols)
    sorted_ops = _lex_sort(list(key_cols) + list(val_leaves), nk)
    ks, vals = list(sorted_ops[:nk]), list(sorted_ops[nk:])
    fills = [_sentinel(k.dtype) for k in ks]
    k_out, v_out, n_unique, _, _ = _merge_runs(
        ks, fills, vals, n, merge_leaves, monoid)
    return k_out, v_out, n_unique


# ----------------------------------------------------------------------
# segment spans + power-of-two size classes: the machinery of the device
# segmented apply (fuse.SegMapOp).  Group sizes collapse into
# ceil(log2) classes, so any size distribution costs at most one padded
# group matrix per power of two.
# ----------------------------------------------------------------------
def _segment_table(key_cols, n, want_keys=False):
    """K7 over each shard's KEY-SORTED valid-prefix rows (a segment
    starts where ANY key column changes): (start_rows, sizes, bucket,
    n_seg, hist, keys) — see kernels.segment_table."""
    return kernels.segment_table([k.contiguous() for k in key_cols], n,
                                 want_keys=want_keys)


def bucket_members(bucket, hist=None, n_seg=None):
    """Every size class's segment ids in segment order, at once: K2's
    stable partition of the segment ids by their class ((N, cap) int32,
    kernels.SIZE_CLASSES past n_seg).  With the table's class histogram
    and n_seg (K7's), K2 takes the class counts from them instead of
    counting.  Returns (members (N, cap) int32, counts (N, SIZE_CLASSES +
    1), offsets (N, SIZE_CLASSES + 1)): class b's members of shard s are
    members[s, offsets[s, b]:][:counts[s, b]]."""
    N, cap = bucket.shape
    ids = torch.arange(cap, dtype=torch.int32, device=bucket.device) \
        .expand(N, cap).contiguous()
    counts = None
    if hist is not None:
        counts = torch.cat([hist, (cap - n_seg)[:, None]], 1).to(
            torch.int32).contiguous()
    (members,), counts, _ = kernels.stable_partition(
        bucket.contiguous(), kernels.SIZE_CLASSES + 1, [ids],
        want_bucket=False, counts=counts)
    return members, counts, _excl_offsets(counts)


def gather_bucket_groups(start_rows, sizes, members, offsets, counts, b, G,
                         B, val_col, pad):
    """K8: the padded (N, G, B) value matrix of size class b's groups
    (`pad` "zero" writes 0 past a group's size, "edge" repeats its last
    row; invalid lanes are 0)."""
    return kernels.bucket_gather(start_rows, sizes, members,
                                 offsets[:, b].contiguous(),
                                 counts[:, b].contiguous(), G, B,
                                 val_col.contiguous(), pad)


def gather_bucket_state(start_rows, sizes, members, offsets, counts, b, G,
                        B, val_col, flag_col, pad):
    """K8's state gather for size class b: (the (N, G, B) matrix of each
    group's new values compacted to the front and padded, the carried
    value (N, G), has_prev (N, G)) -- see kernels.bucket_gather_state."""
    return kernels.bucket_gather_state(start_rows, sizes, members,
                                       offsets[:, b].contiguous(),
                                       counts[:, b].contiguous(), G, B,
                                       val_col.contiguous(),
                                       flag_col.contiguous(), pad)


# ----------------------------------------------------------------------
# the device join: match ranges of two exchanged, key-sorted sides and
# the expansion of the key-matched pairs (K12)
# ----------------------------------------------------------------------
def join_key_ranges(a_keys, a_n, b_keys, b_n):
    """K12's ranges over the nk key columns of both sides: (lo, per,
    offs, totals) -- see kernels.join_ranges."""
    return kernels.join_ranges([k.contiguous() for k in a_keys], a_n,
                               [k.contiguous() for k in b_keys], b_n)


def join_expand(a_leaves, b_vals, ranges, a_n, cap_out):
    """K12's expansion: (N, cap_out) leaves of the joined rows, A's
    leaves (keys first) then B's values; padding past each shard's total
    holds the key sentinel in key column 0."""
    lo, per, offs, totals = ranges
    return kernels.join_expand([x.contiguous() for x in a_leaves],
                               [x.contiguous() for x in b_vals], lo, per,
                               offs, totals, a_n, cap_out)
