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
range of equal B keys and expands the pairs (device_join_batch).

PyTorch runs eagerly: the reference's compiled programs (narrow,
exchange, reduce) are plain functions here, and there is no program
cache.  Nothing here catches a CUDA error: a failed kernel propagates.
"""

import itertools

import numpy as np
import torch

from dpark_tpu_torch.backend.cuda import collectives, fuse, layout
from dpark_tpu_torch.rdd import _fst
from dpark_tpu_torch.utils.monoid import local_reduce, monoid_identity


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


class TorchExecutor:
    def __init__(self, ndev, device):
        self.ndev = layout.make_mesh(ndev)
        self.device = torch.device(device)
        self.shuffle_store = {}       # sid -> stored map output

    # ------------------------------------------------------------------
    # running
    # ------------------------------------------------------------------
    def run_stage(self, plan):
        """Run the whole stage for all shards.  Returns ("shuffle", sid),
        ("counts", [n per shard]), ("reduced", [(value, n) per shard]) or
        ("result", [rows per shard])."""
        if plan.source[0] == "ingest":
            batch = self._ingest(plan)
        elif plan.source[0] == "join":
            batch = self.device_join_batch(*plan.source[1])
        elif plan.ops and isinstance(plan.ops[0], fuse.SegMapOp):
            # segmented apply: sort the rows, read the size-class
            # histogram, set the op's bucket layout
            batch = self._run_seg_map(plan)
        else:
            batch = self._exchange_and_reduce(plan)
        outs = self._run_narrow(plan, batch)
        return self._finish_stage(plan, outs)

    def _ingest(self, plan):
        slices = plan.source[1]._slices
        if plan.reslice:
            slices = _reslice_parts(slices, self.ndev)
        # a shuffle write pads with the key sentinel: a real key equal to
        # it must take the host path (HostPath, before any device work)
        return layout.ingest(self.ndev, self.device, slices,
                             plan.in_treedef, plan.in_specs,
                             key_leaf=0 if plan.epilogue else None)

    def _exchange_and_reduce(self, plan):
        """Reduce side: K4 exchange of the stored map output, then the
        key sort and, unless the shuffle repartitions only, K3 merge."""
        dep = plan.source[1]
        store = self.shuffle_store[dep.shuffle_id]
        nk = plan.src_nk
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
        host merge consumes them)."""
        store = self.shuffle_store[dep.shuffle_id]
        batch = self._exchange_sorted(store, store["key_cols"],
                                      store["out_treedef"])
        return layout.egest(batch)

    def run_device_join(self, dep_a, dep_b):
        """a.join(b) over two device-resident no-combine shuffles:
        per-partition (k, (va, vb)) row lists on the host."""
        return layout.egest(self.device_join_batch(dep_a, dep_b))

    def device_join_batch(self, dep_a, dep_b):
        """Inner join of two device-resident no-combine shuffles as a
        Batch of (k, (va, vb)) rows (the "join" source of a stage: keys
        stay on the device for the narrow ops and any shuffle write).
        Both sides: K4 exchange and K5 key sort; then K12's ranges and
        per-shard totals, one host read of the largest total to size the
        output (layout.round_capacity), and K12's expansion.  Rows come
        in A's key order, equal keys in A's then B's arrival order."""
        store_a = self.shuffle_store[dep_a.shuffle_id]
        store_b = self.shuffle_store[dep_b.shuffle_id]
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
        store = self.shuffle_store[plan.source[1].shuffle_id]
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

    def _run_narrow(self, plan, batch):
        """Narrow ops, then the shuffle write when the stage has one.
        Returns ("rows", Batch) or ("shuffle", counts, offsets, leaves)."""
        lv, n = list(batch.cols), batch.counts
        for op in plan.ops:
            lv, n = op.apply(lv, n)
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
        merge_fn, monoid = self._epilogue_merge(plan)
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
    # stage results
    # ------------------------------------------------------------------
    def _finish_stage(self, plan, outs):
        if outs[0] == "shuffle":
            _, cnts, offs, leaves = outs
            return self._register_shuffle(plan, {
                "leaves": leaves,            # (N, cap, ...) dst-sorted
                "counts": cnts,              # (N, N) [src, dst]
                "offsets": offs,             # (N, N)
                "single_map": plan.reslice,
            })
        batch = outs[1]
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
            return ("result", [
                [(k, [rec[1] for rec in grp])
                 for k, grp in itertools.groupby(rows, key=_fst)]
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
                                          plan.out_specs)
            if kspec is not None:
                batch = self._device_topk(plan, batch, kspec, top[0],
                                          top[2])
                plan.topk_used = True
        return ("result", layout.egest(batch))

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
        key columns differs from the row before."""
        valid = collectives.valid_rows(batch.counts, batch.cap)
        return (collectives._starts(batch.cols[:nk]) & valid).sum(1)

    def _monoid_reduce(self, batch, monoid):
        """Per-shard (reduced, min, max) over the valid rows of a
        single-scalar-leaf batch, each (N,); empty shards yield
        identities."""
        col = batch.cols[0]
        dt = layout.numpy_dtype(col.dtype)
        valid = collectives.valid_rows(batch.counts, batch.cap)
        ident = {k: np.asarray(monoid_identity(k, dt)).item()
                 for k in (monoid, "min", "max")}
        masked = torch.where(valid, col, ident[monoid])
        lo = torch.where(valid, col, ident["min"]).amin(1)
        hi = torch.where(valid, col, ident["max"]).amax(1)
        return local_reduce(monoid, masked, 1), lo, hi

    # ------------------------------------------------------------------
    # the shuffle store and its host export bridge
    # ------------------------------------------------------------------
    def _register_shuffle(self, plan, store):
        dep = plan.epilogue[1]
        sid = dep.shuffle_id
        self.drop_shuffle(sid)            # a re-run replaces its output
        store["out_treedef"] = plan.out_treedef
        store["out_specs"] = plan.out_specs
        store["key_cols"] = plan.epi_nk
        store["no_combine"] = plan.no_combine
        store["nbytes"] = sum(int(leaf.numel() * leaf.element_size())
                              for leaf in store["leaves"])
        self.shuffle_store[sid] = store
        return ("shuffle", sid)

    def export_bucket(self, sid, map_id, reduce_id):
        """Device-resident map output -> host (key, combiner) items of one
        (map, reduce) bucket, for a host reduce stage (the HBM -> host
        bridge).  A no-combine store holds raw values: each exports as
        the list combiner [v] its host merge (list extend) expects."""
        store = self.shuffle_store.get(sid)
        if store is None:
            raise KeyError("no device shuffle %d" % sid)
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

    def drop_shuffle(self, sid):
        self.shuffle_store.pop(sid, None)

    def stop(self):
        self.shuffle_store.clear()
