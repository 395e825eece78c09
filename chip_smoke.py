"""Chip smoke test of the PyTorch/CUDA port (dpark_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit, builds the seventeen CUDA
   kernel libraries from csrc/ (one nvcc each, all started together) and
   prints the build time, and fails unless the native host library
   (dpark_tpu_torch/native, g++) built and loaded;
2. holds each kernel (K1-K14) against its plain PyTorch version on the
   card, at the main paths' shapes (8 shards of 8,388,608 rows; K12 at
   the join path's), and times kernel, plain version, bound and library
   call; times the plain segmented scan of a vmapped merge at the main
   shape; holds K17 (B9's masked monoid reductions) against its plain
   version at 8 x 8,388,608 rows (bench values: int64 add, min, max;
   float64 and float32 adds; a bool count; ragged shards with an empty
   one) and its distinct-key count over keys sorted per shard (nk = 1
   and 2), with the library calls beside it; holds K14 (B8, a
   traced merge's register program over each run) against its plain
   version in five cases (bench runs with a (v, 1) add, one run a shard,
   TPC-H Q1's six leaves over its four runs, an argmax, an empty
   shard); holds K15 (B14's masked min/max) against its plain version at
   8 x 8,388,608 int64 rows with ragged counts over key-sentinel padding
   and an empty shard; and holds the spilled-run combine (B12: K13 + K5
   + K2 + K3) and the reduce-side merge (B6: K5 + K3) against the same
   compositions of the plain versions;
3. drives the reduceByKey path through the public API: bench.py's data
   (64Mi int64 pairs over 65,536 keys) -> reduceByKey -> count / collect
   / top / reduce, a map+filter chain before the shuffle, on gpu:8 and
   gpu, checked exactly against numpy, with top(10, key=lambda kv: kv[1]
   * 65536 + kv[0]) on the device through the ranged-int probe (K15);
4. drives the sort path: 64Mi (random int64 key, row index) pairs ->
   sortByKey (both directions) -> count / top on gpu:8 (range shuffle)
   and gpu (one in-place sort), and the first 32Mi pairs -> sortByKey ->
   collect checked row for row against numpy's stable argsort; then
   partitionBy / groupByKey /
   distinct counts over bench.py's data, checked against numpy (the
   groupByKey count through K17's distinct keys); then the evict path:
   four partitionBy(8) counts of 32Mi bench pairs each (a 0.5 GiB store
   each) under a pinned 1 GiB shuffle budget, the device-resident bytes
   at or under it after each job, each spill's ms and GB/s, the spilled
   stores' memory freed, and the first (spilled) shuffle's collect,
   read from its host runs, exactly numpy's rows;
5. drives the grouped paths on gpu:8: groupByKey(8).mapValues(sum of
   squares) -> count / collect over bench.py's data (65,536 groups of
   1,024) and over 67,107,840 power-law rows (16,384 groups, group g of
   2^(g mod 16) rows: 1,024 groups in each of 16 size classes), checked
   exactly against numpy (SegMapOp: K7, K2, K8); then mapValues(sum /
   len / min / max / mean) with the combiner rewrite off (SegAggOp: K3
   once a job) and, as a path of its own, sum with it on (a combining
   shuffle); a tuple-value reduceByKey (the traced merge, lowered: K14
   on both sides, no plain scan) over bench.py's data;
6. drives the device Pregel on gpu:8 through run_pregel over a Graph500
   Kronecker graph at scale 22, edge factor 16 (4,194,304 vertices,
   67,108,864 directed edges): PageRank (20 supersteps, checked against
   a numpy power iteration, rtol 1e-10) and SSSP (min combine, integer
   weights, checked exactly against scipy's Dijkstra), after holding K9
   and K10 against their plain versions on that graph;
7. drives the object Bagel on gpu:8 through Bagel.run over a GAP urand
   graph at scale 20, edge factor 16 (1,048,576 Vertex objects,
   16,777,216 Edge objects, both endpoints uniform): PageRank with
   Message(target, rank * Edge.value), 20 updates, checked against a
   numpy power iteration (rtol 1e-10), on bucketed degree classes, after
   holding K11 against its plain version on one superstep's emission
   blocks;
8. drives the device join on gpu:8 over TPC-H lineitem and orders at
   scale factor 10, generated from a seed by the specification's row
   rules (15,000,000 orders, about 60,000,000 lines): the join's count,
   and the revenue of each customer (Q10's shape: join -> map ->
   reduceByKey), checked exactly against numpy; a cogroup count over a
   2^20-row part of the tables (the host merge of rows exchanged and
   sorted on the device), after holding K12 against its plain version at
   the path's shapes and on one hot key (4,096 x 4,096 pairs); then
   TPC-H Q1 as a dpark job on gpu:8 over lineitem at SF 10 (its own
   seed): filter -> map -> reduceByKey of a six-leaf tuple over the
   (returnflag, linestatus) key -> mapValues -> collect, its integer
   sums exactly numpy's and sum_disc within 1e-8 relative, K14 on both
   sides and no plain scan; then the reduceByKey gpu:8 count and the Q1
   collect with the host-to-device wire narrowed (conf.NARROW_EXCHANGE)
   and not, off, on, on, off; then HiBench's wordcount at its `large`
   size on gpu:8: 3.2e9 bytes of text generated from a seed under
   build/ (2^20 lowercase words under Zipf's law, 8 a line) ->
   textFile -> flatMap(split) -> map((w, 1)) -> reduceByKey(add) ->
   top(10) by count and collect, exactly numpy's counts, through the
   canonical C++ tokenizer in text waves, K15 in the collect's egest;
9. drives the out-of-core wave stream on gpu:8: reduceByKey(add, 8) over
   2^30 of bench.py's pairs (16 GiB of columns; halved, and the cut
   printed, when the host's available memory is under three times that)
   at the auto wave threshold -> count / collect, exactly numpy's (a
   pre_reduced store); reduceByKey(add, 64) and a tuple merge at 64
   partitions over the 64Mi pairs in waves of 2^21 rows a shard (K1's
   rid, B12, K4, K5 + K3, spilled runs, the host fold; the tuple merge
   through K14, no plain scan); sortByKey(
   numSplits=32) -> collect and groupByKey(8) -> count over 2^22 random
   int64 keys in waves of 2^17 rows (K6's rid, K13, K2, K4, K5, runs,
   premerge, export); then the out-of-memory ladder on the emulated
   ceiling at a small size;
10. holds K16 (the union's concatenation, B16) against its plain version
   (12 branches over 8 shards of 2^20 rows, ragged counts, an empty
   shard and an empty branch; then 2 branches of 8 x 4,194,304) and K8's
   state gather at one tick of the decayed counter, then drives the
   union path on gpu:8 (bench.py's pairs in two halves: a.union(b)
   .reduceByKey -> count / collect, and the union of the two reduced
   halves -> reduceByKey -> collect, exactly numpy's, K16 in every
   action) and BASELINE.json config 5 on gpu:8: a queue stream of 40
   batches of 8,388,608 Zipf word ids, 1 s each, with
   reduceByKeyAndWindow(add, 30, 10) with and without invFunc=sub and
   updateStateByKey as a running sum, each output checked every tick
   against numpy's counts; then the decayed counter 0.9 * prev + sum(vs)
   over the first 3 batches (the state mode, within 1e-12 relative),
   printing each output's wall, the device memory allocated, the
   executor's store count and its device-resident store bytes, which
   must stay under the shuffle budget (conf.SHUFFLE_HBM_BUDGET, a
   quarter of the card) after every tick;
11. every stage of every checked job must take the tensor path (a reduce
   stage over spilled runs reads them on the host by design, and no
   streamed path's stage may record a fallback or degrade reason), and every
   kernel of a path must launch during that path's run (counts reset
   just before it, read just after), as often as PATH_MIN_LAUNCHES (or
   the path itself: one K9 launch a superstep, one K10 launch a
   superstep with mail, or a class with mail) asks where a path must
   launch a kernel more than once;
12. profiles the first action of each gpu:8 path and one PageRank
   superstep of each Pregel, times the top path's K5 + K2 composition,
   prints one JSON line describing every kernel, then the result line.

Exits non-zero, printing no result, without CUDA or outside the repo.
`python3 chip_smoke.py --stream-only` builds the kernels and runs only
the wave stream's phases and paths (9), printing no result line;
`--text-only` runs only K15's phase, the reduceByKey gpu:8 path, the
narrowing timings and the wordcount (no result line); `--sort-only` runs
only K5's and K6's phases, B7's composed top, B6's merge, the sort and
reduceByKey gpu:8 paths and the sortByKey count's profile (no result
line); `--union-only` runs only K16's and the state gather's phases and
the union and window paths (no result line); `--evict-only` runs only
K17's phases and the reduceByKey gpu:8, partition/group/distinct and
evict paths (no result line).  Every run prints K5's
tiles and ptxas's registers and spills for radix_sort.cu.
"""

import collections
import concurrent.futures
import contextlib
import gc
import json
import math
import operator
import os
import resource
import subprocess
import sys
import time

import numpy as np
import torch

N_SHARDS = 8
CAP = 8_388_608                    # rows per shard on the main path
PAIRS = N_SHARDS * CAP             # bench.py's 64M pairs
KEYS = 65_536
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
FLOAT_ATOL = 0.0                   # the smoke's values are all integers

INT64_MIN, INT64_MAX = -2 ** 63, 2 ** 63 - 1

SOURCES = {
    "hash_dst_hist": ("dpark_tpu_torch/backend/cuda/csrc/hash_dst_hist.cu",
                      "dpark_tpu/utils/phash.py:143"),
    "stable_partition": (
        "dpark_tpu_torch/backend/cuda/csrc/stable_partition.cu",
        "dpark_tpu/backend/tpu/collectives.py:156"),
    "reduce_by_key_compact": (
        "dpark_tpu_torch/backend/cuda/csrc/reduce_by_key.cu",
        "dpark_tpu/backend/tpu/collectives.py:367"),
    "shard_exchange": ("dpark_tpu_torch/backend/cuda/csrc/shard_exchange.cu",
                       "dpark_tpu/backend/tpu/collectives.py:197"),
    "radix_sort": ("dpark_tpu_torch/backend/cuda/csrc/radix_sort.cu",
                   "dpark_tpu/backend/tpu/collectives.py:123"),
    "range_dst_hist": ("dpark_tpu_torch/backend/cuda/csrc/range_dst_hist.cu",
                       "dpark_tpu/backend/tpu/collectives.py:103"),
    "segment_table": ("dpark_tpu_torch/backend/cuda/csrc/segment_table.cu",
                      "dpark_tpu/backend/tpu/collectives.py:515"),
    "bucket_gather": ("dpark_tpu_torch/backend/cuda/csrc/bucket_groups.cu",
                      "dpark_tpu/backend/tpu/collectives.py:605"),
    "bucket_scatter": ("dpark_tpu_torch/backend/cuda/csrc/bucket_groups.cu",
                       "dpark_tpu/backend/tpu/fuse.py:880"),
    "edge_gather": ("dpark_tpu_torch/backend/cuda/csrc/edge_gather.cu",
                    "dpark_tpu/backend/tpu/bagel.py:285"),
    "pregel_deliver": ("dpark_tpu_torch/backend/cuda/csrc/pregel_deliver.cu",
                       "dpark_tpu/backend/tpu/bagel.py:364"),
    "obj_emit_pack": ("dpark_tpu_torch/backend/cuda/csrc/obj_emit_pack.cu",
                      "dpark_tpu/backend/tpu/bagel_obj.py:892"),
    "join_ranges": ("dpark_tpu_torch/backend/cuda/csrc/join_expand.cu",
                    "dpark_tpu/backend/tpu/executor.py:3137"),
    "join_expand": ("dpark_tpu_torch/backend/cuda/csrc/join_expand.cu",
                    "dpark_tpu/backend/tpu/executor.py:3176"),
    "rid_fold": ("dpark_tpu_torch/backend/cuda/csrc/rid_fold.cu",
                 "dpark_tpu/backend/tpu/collectives.py:436"),
    "segmented_merge": (
        "dpark_tpu_torch/backend/cuda/csrc/segmented_merge.cu",
        "dpark_tpu/backend/tpu/collectives.py:303"),
    "column_ranges": ("dpark_tpu_torch/backend/cuda/csrc/column_ranges.cu",
                      "dpark_tpu/backend/tpu/executor.py:960"),
    "union_concat": ("dpark_tpu_torch/backend/cuda/csrc/union_concat.cu",
                     "dpark_tpu/backend/tpu/executor.py:2137"),
    "bucket_gather_state": (
        "dpark_tpu_torch/backend/cuda/csrc/bucket_groups.cu",
        "dpark_tpu/backend/tpu/fuse.py:803"),
    "monoid_reduce": ("dpark_tpu_torch/backend/cuda/csrc/monoid_reduce.cu",
                      "dpark_tpu/backend/tpu/executor.py:1799"),
    "distinct_key_counts": (
        "dpark_tpu_torch/backend/cuda/csrc/monoid_reduce.cu",
        "dpark_tpu/backend/tpu/executor.py:1827"),
}
SEGMAP_KERNELS = ["hash_dst_hist", "stable_partition", "shard_exchange",
                  "radix_sort", "segment_table", "bucket_gather",
                  "bucket_scatter"]
# the kernels each driven path must launch
PATH_KERNELS = {
    # the ranged-int top reads K15's per-column ranges; the reduce
    # action's per-shard reduction is K17
    "reduceByKey gpu:8": ["hash_dst_hist", "stable_partition",
                          "reduce_by_key_compact", "shard_exchange",
                          "radix_sort", "column_ranges", "monoid_reduce"],
    "reduceByKey gpu": ["hash_dst_hist", "stable_partition",
                        "reduce_by_key_compact", "radix_sort",
                        "column_ranges", "monoid_reduce"],
    # each text wave: K1, K5, K2, K3 combine, K4, K5 + K3 into the state;
    # the collect's egest narrows through K15
    "wordcount gpu:8": ["hash_dst_hist", "stable_partition",
                        "reduce_by_key_compact", "shard_exchange",
                        "radix_sort", "column_ranges"],
    "sort gpu:8": ["range_dst_hist", "stable_partition", "shard_exchange",
                   "radix_sort"],
    "sort gpu": ["stable_partition", "radix_sort"],
    # a bare groupByKey's count: K17's distinct keys of each shard
    "partition/group/distinct gpu:8": [
        "hash_dst_hist", "stable_partition", "reduce_by_key_compact",
        "shard_exchange", "radix_sort", "distinct_key_counts"],
    "groupByKey gpu:8 segmap": SEGMAP_KERNELS,
    "groupByKey gpu:8 segmap power-law": SEGMAP_KERNELS,
    # SegAggOp merges with K3 alone: no K7, no K8
    "groupByKey gpu:8 segagg": [
        "hash_dst_hist", "stable_partition", "shard_exchange", "radix_sort",
        "reduce_by_key_compact"],
    # the combiner rewrite turns mapValues(sum) into a combining shuffle
    "groupByKey gpu:8 rewritten sum": [
        "hash_dst_hist", "stable_partition", "reduce_by_key_compact",
        "shard_exchange", "radix_sort"],
    # a superstep: K9 gather and send, K2 pack, K1 + K5 + K2 + K3
    # pre-combine, K4 exchange, K5 + K3 combine, K10 delivery, K17's
    # active count
    "pregel gpu:8": ["hash_dst_hist", "stable_partition",
                     "reduce_by_key_compact", "shard_exchange", "radix_sort",
                     "edge_gather", "pregel_deliver", "monoid_reduce"],
    # an object superstep: K10 per class, the vmapped compute, K11 pack,
    # K1 + K5 + K2 + K3 pre-combine, K4 exchange, K5 + K3 combine, K17's
    # active count per class
    "bagel gpu:8": ["hash_dst_hist", "stable_partition",
                    "reduce_by_key_compact", "shard_exchange", "radix_sort",
                    "pregel_deliver", "obj_emit_pack", "monoid_reduce"],
    # the traced tuple merge: K1 + K5 + K2, K14, K3 "last"; K4; K5, K14,
    # K3 "last"
    "tuple reduceByKey gpu:8": ["hash_dst_hist", "stable_partition",
                                "reduce_by_key_compact", "shard_exchange",
                                "radix_sort", "segmented_merge"],
    # both sides' no-combine writes (K1, K2), exchanges (K4) and key
    # sorts (K5), K12's ranges and expansion, then the revenue's
    # combining write (K1, K5, K2, K3) and its merge (K4, K5, K3)
    "join gpu:8": ["hash_dst_hist", "stable_partition", "shard_exchange",
                   "radix_sort", "join_ranges", "join_expand",
                   "reduce_by_key_compact"],
    # each wave: K1, K5, K2, K3 combine, K4, then K5 + K3 into the state
    "reduceByKey waves gpu:8": ["hash_dst_hist", "stable_partition",
                                "reduce_by_key_compact", "shard_exchange",
                                "radix_sort"],
    # each wave: K1's rid over r, B12 (K13, K5, K2, K3), K4, K5 + K3;
    # the tuple merge's waves K14 before each K3
    "reduceByKey spilled gpu:8": ["hash_dst_hist", "rid_fold",
                                  "stable_partition", "radix_sort",
                                  "reduce_by_key_compact",
                                  "shard_exchange", "segmented_merge"],
    # TPC-H Q1: filter (K2), the composite key's hash (K1), K5 by it, K2,
    # K14 over the six leaves, K3 "last"; K4; K5, K14, K3 "last"
    "tpch q1 gpu:8": ["hash_dst_hist", "stable_partition",
                      "reduce_by_key_compact", "shard_exchange",
                      "radix_sort", "segmented_merge"],
    # sortByKey: K6's rid over r, K13, K2, K4, K5 by (rid, key);
    # groupByKey(8): K1, K2, K4, K5
    "sort spilled gpu:8": ["range_dst_hist", "hash_dst_hist", "rid_fold",
                           "stable_partition", "shard_exchange",
                           "radix_sort"],
    # each half's ingest and the union's K16, then the combining write
    # (K1, K5, K2, K3) and its merge (K4, K5, K3); the union of reduced
    # halves reads both halves' merges first
    "union gpu:8": ["union_concat", "hash_dst_hist", "stable_partition",
                    "reduce_by_key_compact", "shard_exchange", "radix_sort"],
    # the windows' pane builds and union-reduces (K16 and the combining
    # shuffle), the running sum's union-reduce; the decayed counter's
    # groupByKey (K1, K2, K4, K5), K7, K2's class members, K8's state
    # gather and scatter
    "window gpu:8": ["union_concat", "hash_dst_hist", "stable_partition",
                     "reduce_by_key_compact", "shard_exchange", "radix_sort",
                     "segment_table", "bucket_gather_state",
                     "bucket_scatter"],
    # each partitionBy(8) count: K1, K2, then K4 and K5 on the reduce side
    "evict gpu:8": ["hash_dst_hist", "stable_partition", "shard_exchange",
                    "radix_sort"],
}
SEGAGG_FNS = {"sum": sum, "len": len, "min": min, "max": max,
              "mean": lambda vs: sum(vs) / len(vs)}
# kernels a path must launch more than once: K3 once for each SegAggOp
# job (its no-combine shuffle launches no K3 of its own)
PATH_MIN_LAUNCHES = {
    "groupByKey gpu:8 segagg": {"reduce_by_key_compact": len(SEGAGG_FNS)},
    # one K9 and one K17 (the active count) a superstep, one K10 a
    # superstep with mail: PageRank's 21 and 20 at least (pregel_path
    # returns the exact counts of both runs)
    "pregel gpu:8": {"edge_gather": 21, "pregel_deliver": 20,
                     "monoid_reduce": 21},
    # one K11 a superstep that emits (PageRank's first 20); K10 once per
    # class a superstep with mail (bagel_path returns 20 x the classes);
    # K17 once per class a superstep
    "bagel gpu:8": {"obj_emit_pack": 20, "monoid_reduce": 21},
    # one K12 ranges and one expansion a join action (count, revenue)
    "join gpu:8": {"join_ranges": 2, "join_expand": 2},
    # K14 wherever the plain scan ran before: the map side's pre-combine
    # and the reduce side's merge; in the spilled run, B12's and the
    # wave's pre-reduce in each of the tuple job's 4 waves
    "tuple reduceByKey gpu:8": {"segmented_merge": 2},
    "tpch q1 gpu:8": {"segmented_merge": 2},
    "reduceByKey spilled gpu:8": {"segmented_merge": 2 * 4},
}
# the path whose launches the kernels line reports for each kernel
LINE_PATH = {"range_dst_hist": "sort gpu:8", "radix_sort": "sort gpu:8",
             "segment_table": "groupByKey gpu:8 segmap",
             "bucket_gather": "groupByKey gpu:8 segmap",
             "bucket_scatter": "groupByKey gpu:8 segmap",
             "edge_gather": "pregel gpu:8", "pregel_deliver": "pregel gpu:8",
             "obj_emit_pack": "bagel gpu:8",
             "join_ranges": "join gpu:8", "join_expand": "join gpu:8",
             "rid_fold": "reduceByKey spilled gpu:8",
             "segmented_merge": "tpch q1 gpu:8",
             "column_ranges": "wordcount gpu:8",
             "union_concat": "union gpu:8",
             "bucket_gather_state": "window gpu:8",
             "distinct_key_counts": "partition/group/distinct gpu:8"}
POWER_GROUPS = 16_384
POWER_ROWS = (POWER_GROUPS // 16) * (2 ** 16 - 1)      # 67,107,840
# Graph500's Kronecker graph (the graph500-22 of LDBC Graphalytics)
GRAPH_SCALE = 22                   # 4,194,304 vertices
EDGE_FACTOR = 16                   # 67,108,864 edges
KRONECKER_ABC = (0.57, 0.19, 0.19)
DAMPING = 0.85
PR_STEPS = 20                      # rank updates; max_superstep = 21
SSSP_MAX_SUPERSTEP = 400
PR_RTOL = 1e-10                    # float64 sums in another order
# the GAP Benchmark Suite's urand graph (Beamer, Asanovic, Patterson,
# arXiv:1508.03619): both endpoints uniform, edge factor 16; scale 27
# cut to 20, every vertex and edge a Python object on the driver
URAND_SCALE = 20                   # 1,048,576 vertices
URAND_EDGE_FACTOR = 16             # 16,777,216 edges
# TPC-H (Standard Specification, section 4.2.3) at scale factor 10
TPCH_SF = 10
COGROUP_ROWS = 1 << 20             # lineitem rows of the cogroup count
SKEW_ROWS = 4096                   # one key's rows on each join side
# TPC-H Q1 (section 2.4.1, DELTA = 90) over lineitem's dates (4.2.3), in
# days since 1992-01-01 (STARTDATE)
Q1_ORDER_LAST = 2405               # 1998-08-02: ENDDATE - 151 days
Q1_CURRENT = 1263                  # 1995-06-17: CURRENTDATE
Q1_SHIP_CUTOFF = 2436              # 1998-09-02: 1998-12-01 - 90 days
K14_FLOAT_RTOL = 1e-8              # float sums in another association
# K17's float add against its plain version: it accumulates in double in
# another order (float32: the plain version sums in float32)
K17_RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# the wave stream: bench.py's pairs at 2^30 (16 GiB of columns, several
# waves at the auto threshold); the spilled paths at pinned wave sizes
WAVE_PAIRS = 1 << 30
# the sortByKey collects read the first half of the sort path's pairs
# (cut from 64Mi for the smoke's time)
SORT_COLLECT_PAIRS = PAIRS // 2
SPILL_PARTS = 64                   # reduceByKey's logical partitions
SPILL_CHUNK = 1 << 21              # rows a shard a wave: 4 waves
SORT_SPILL_PAIRS = 1 << 22           # cut from 2^23 for the smoke's time
SORT_SPILL_PARTS = 32
SORT_SPILL_CHUNK = 1 << 17         # 4 waves
# HiBench's WordCount `large` profile (hibench.wordcount.large.datasize):
# 3.2e9 bytes of text.  Its generator (RandomTextWriter) draws from a fixed
# 1,000-word list; here words come from a seeded vocabulary of 2^20
# lowercase ASCII words under Zipf's law with exponent 1, as in natural
# text, 8 words a line, so the result has about a million rows
WORDCOUNT_BYTES = 3_200_000_000
VOCAB_WORDS = 1 << 20
WORDS_PER_LINE = 8
CORPUS_CHUNK_LINES = 1 << 20       # lines a generator task


def fail(msg):
    print("FAIL: %s" % msg, flush=True)
    sys.exit(1)


def timed(fn, reps=5):
    """Mean ms of fn() over `reps` launches after one warm-up (CUDA
    events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes):
    return nbytes / HBM_BYTES_PER_S * 1e3


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def max_err(pairs):
    """Max |a - b| over (kernel, plain) output pairs; raises unless the
    integer outputs are bit-identical."""
    err = 0.0
    for name, a, b in pairs:
        if a.dtype.is_floating_point:
            e = float((a - b).abs().max().item()) if a.numel() else 0.0
            if e > FLOAT_ATOL:
                fail("%s: max abs err %g > %g" % (name, e, FLOAT_ATOL))
            err = max(err, e)
        elif not torch.equal(a, b):
            bad = (a != b).nonzero()[:5].tolist()
            fail("%s differs from its plain version at %s" % (name, bad))
    return err


def kernel_phases(K, dev):
    """K1-K4 against their plain versions at the main path's shapes."""
    rng = np.random.default_rng(20261017)
    keys = torch.from_numpy(rng.integers(0, KEYS, (N_SHARDS, CAP),
                                         dtype=np.int64)).to(dev)
    vals = torch.from_numpy(rng.integers(0, 1 << 16, (N_SHARDS, CAP),
                                         dtype=np.int64)).to(dev)
    n = torch.full((N_SHARDS,), CAP, dtype=torch.int32, device=dev)
    out = {}

    # K1: hash -> destination -> histogram
    a = K.hash_dst_hist([keys], n, N_SHARDS, N_SHARDS)
    b = K.hash_dst_hist_plain([keys], n, N_SHARDS, N_SHARDS)
    err = max_err([("K1 dst", a[0], b[0]), ("K1 hist", a[1], b[1])])
    dst = a[0]
    flat_dst = (dst.long() + torch.arange(N_SHARDS, device=dev)[:, None]
                * (N_SHARDS + 1)).view(-1)
    out["hash_dst_hist"] = {
        "max_abs_err": err,
        "ms": timed(lambda: K.hash_dst_hist([keys], n, N_SHARDS, N_SHARDS)),
        "plain_ms": timed(lambda: K.hash_dst_hist_plain(
            [keys], n, N_SHARDS, N_SHARDS), reps=3),
        "bound_ms": bound_ms(nbytes(keys, n, dst, a[1])),
        "library_ms": timed(lambda: torch.bincount(
            flat_dst, minlength=N_SHARDS * (N_SHARDS + 1))),
    }

    # K2: the destination pass of the map-side sort (rows already in key
    # order through src_idx), gathering key and value
    order = torch.sort(keys, dim=1, stable=True).indices
    src = order.to(torch.int32)
    bucket = torch.gather(dst, 1, order).contiguous()
    nb = N_SHARDS + 1
    a = K.stable_partition(bucket, nb, [keys, vals], src_idx=src)
    b = K.stable_partition_plain(bucket, nb, [keys, vals], src_idx=src)
    err = max_err([("K2 key", a[0][0], b[0][0]), ("K2 val", a[0][1], b[0][1]),
                   ("K2 counts", a[1], b[1]), ("K2 bucket", a[2], b[2])])

    def library_k2():
        o = torch.sort(bucket, dim=1, stable=True).indices
        idx = torch.gather(order, 1, o)
        return torch.gather(keys, 1, idx), torch.gather(vals, 1, idx)
    out["stable_partition"] = {
        "max_abs_err": err,
        "ms": timed(lambda: K.stable_partition(bucket, nb, [keys, vals],
                                               src_idx=src)),
        "plain_ms": timed(lambda: K.stable_partition_plain(
            bucket, nb, [keys, vals], src_idx=src), reps=3),
        "bound_ms": bound_ms(nbytes(bucket, src, keys, vals)
                             + nbytes(*a[0], a[1], a[2])),
        "library_ms": timed(library_k2, reps=3),
    }

    # K3: merge runs of equal (dst, key) and pack, per destination counts
    sd, sk, sv = a[2], a[0][0], a[0][1]
    fills = [N_SHARDS, K.KEY_SENTINEL]
    a = K.reduce_by_key_compact([sd, sk], fills, [sv], n, "add", 0,
                                N_SHARDS)
    b = K.reduce_by_key_compact_plain([sd, sk], fills, [sv], n, "add", 0,
                                      N_SHARDS)
    err = max_err([("K3 dst", a[0][0], b[0][0]), ("K3 key", a[0][1], b[0][1]),
                   ("K3 val", a[1][0], b[1][0]), ("K3 n", a[2], b[2]),
                   ("K3 counts", a[3], b[3]), ("K3 offsets", a[4], b[4])])
    n_out = int(a[2].sum().item())
    out["reduce_by_key_compact"] = {
        "max_abs_err": err,
        "ms": timed(lambda: K.reduce_by_key_compact(
            [sd, sk], fills, [sv], n, "add", 0, N_SHARDS)),
        "plain_ms": timed(lambda: K.reduce_by_key_compact_plain(
            [sd, sk], fills, [sv], n, "add", 0, N_SHARDS), reps=3),
        "bound_ms": bound_ms(nbytes(sd, sk, sv, n) + n_out * (4 + 8 + 8)
                             + 2 * 4 * N_SHARDS * N_SHARDS),
        "library_ms": None,
    }

    # K4: the exchange of the combined map output
    ks, vs, counts, offs = a[0][1], a[1][0], a[3], a[4]
    cap_out = int(counts.sum(0).max().item())
    x = K.shard_exchange([ks, vs], counts, offs, cap_out, 0, K.KEY_SENTINEL)
    y = K.shard_exchange_plain([ks, vs], counts, offs, cap_out, 0,
                               K.KEY_SENTINEL)
    err = max_err([("K4 key", x[0][0], y[0][0]), ("K4 val", x[0][1], y[0][1]),
                   ("K4 counts", x[1], y[1])])
    moved = int(counts.sum().item())
    out["shard_exchange"] = {
        "max_abs_err": err,
        "ms": timed(lambda: K.shard_exchange([ks, vs], counts, offs,
                                             cap_out)),
        "plain_ms": timed(lambda: K.shard_exchange_plain(
            [ks, vs], counts, offs, cap_out, 0, K.KEY_SENTINEL), reps=3),
        "bound_ms": bound_ms(moved * 16 * 2 + nbytes(counts, offs)
                             + (N_SHARDS * cap_out - moved) * 16),
        "library_ms": None,
    }
    for name, rec in out.items():
        print_phase(name, rec)
    del keys, vals, order, src, bucket, a, b, x, y
    torch.cuda.empty_cache()
    return out


def print_phase(name, rec):
    extra = "".join(" %s=%s" % kv for kv in rec.get("notes", {}).items())
    def ms(x):
        return "null" if x is None else "%.4f" % x
    print("phase %s: kernel_ms=%.4f plain_ms=%s bound_ms=%.4f "
          "library_ms=%s max_abs_err=%g%s" % (
              name, rec["ms"], ms(rec["plain_ms"]), rec["bound_ms"],
              ms(rec["library_ms"]), rec["max_abs_err"], extra),
          flush=True)


def k5_split(K, col, src=None, reps=3):
    """Device ms of one K5 call by part, under torch.profiler over `reps`
    calls: through src the stage (k5_stage), the histogram pass (k5_hist,
    k5_bases), the digit passes (k5_pass) and the rest (the zeroed
    scratch); and the gap, the
    mean time in the same trace from the end of each call's k5_bases to
    the start of its first k5_pass (the host's read of the digit flags
    and the allocation and launch of the passes)."""
    from torch.profiler import ProfilerActivity, profile
    K.radix_sort(col, src)
    torch.cuda.synchronize()
    # the device's activity alone: tracing the host's ops would lengthen
    # the gap it measures
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            K.radix_sort(col, src)
        torch.cuda.synchronize()
    parts = {"stage": 0.0, "hist": 0.0, "passes": 0.0, "other": 0.0}
    evs = sorted((ev for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda ev: ev.time_range.start)
    gaps, bases_end = [], None
    for ev in evs:
        part = ("stage" if "k5_stage" in ev.name
                else "hist" if "k5_hist" in ev.name or "k5_bases" in ev.name
                else "passes" if "k5_pass" in ev.name else "other")
        parts[part] += ev.time_range.elapsed_us() / 1e3 / reps
        if "k5_bases" in ev.name:
            bases_end = ev.time_range.end
        elif "k5_pass" in ev.name and bases_end is not None:
            gaps.append((ev.time_range.start - bases_end) / 1e3)
            bases_end = None
    parts["gap"] = sum(gaps) / len(gaps) if gaps else None
    return parts


def lsd_bytes(rows, nat, src, passes, width):
    """The bytes K5's own passes must move: the histogram pass reads the
    key once (through src: reads src and the key, writes the staged
    image, reads and rewrites it); each digit pass reads its image (the
    key column or the staged image on the first) and its index (none on
    the first without src) and writes both (only the index on the
    last)."""
    total = nat + (4 + 3 * nat if src else 0)
    for j in range(len(passes)):
        total += (nat if j == 0 else width) + (4 if j or src else 0)
        total += 4 + (0 if j == len(passes) - 1 else width)
    return rows * total


def radix_case(K, col, src=None):
    """K5 on one (N, CAP) column against its plain version and against
    torch.sort(stable=True) on the CPU (NaN of either sign last, as numpy
    and jnp sort); timed.  Whether the card's torch.sort agrees is
    printed, not required.  bound_ms: the key column (and src) read once
    and the permutation written once; lsd_bound_ms: the kernel's own
    passes (lsd_bytes); the split of the device time between the
    histogram pass and the digit passes, the gap between them in the
    same trace (k5_split), and the peak scratch of one call, bytes a
    row."""
    a = K.radix_sort(col, src)
    b = K.radix_sort_plain(col, src)
    err = max_err([("K5 perm", a, b)])
    cur = col if src is None else torch.gather(col, 1, src.long())

    def composed(order):
        if src is None:
            return order
        return torch.gather(src.to(order.device).long(), 1, order)
    host = composed(torch.sort(cur.cpu(), dim=1, stable=True).indices)
    if not torch.equal(a.long().cpu(), host):
        fail("K5 differs from torch.sort(stable=True)")
    card = composed(torch.sort(cur, dim=1, stable=True).indices)
    _, (passes, width) = K.radix_sorted_image(cur, src is not None)
    nat = col.element_size()
    extra = [src] if src is not None else []
    ms = timed(lambda: K.radix_sort(col, src))
    split = k5_split(K, col, src)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    K.radix_sort(col, src)
    scratch = torch.cuda.max_memory_allocated() - held
    return {
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": timed(lambda: K.radix_sort_plain(col, src), reps=1),
        "bound_ms": bound_ms(nbytes(col, a, *extra)),
        "library_ms": timed(lambda: torch.sort(cur, dim=1, stable=True)),
        "notes": {"active_digits": len(passes), "image_bytes": width,
                  "tiles": "%s/%s" % (K5_TILES[nat], K5_TILES[width]),
                  "lsd_bound_ms": "%.4f" % bound_ms(lsd_bytes(
                      col.numel(), nat, src is not None, passes, width)),
                  "stage_ms": "%.4f" % split["stage"],
                  "hist_ms": "%.4f" % split["hist"],
                  "passes_ms": "%.4f" % split["passes"],
                  "other_ms": "%.4f" % split["other"],
                  "gap_ms": (None if split["gap"] is None
                             else "%.4f" % split["gap"]),
                  "scratch_bytes_a_row": "%.2f" % (scratch / col.numel()),
                  "card_torch_sort_agrees": bool(torch.equal(a.long(),
                                                             card))},
    }


def range_case(K, cols, bounds, ascending, n):
    """K6 against its plain version; library call (one key column only):
    torch.searchsorted + torch.bincount."""
    r = bounds.shape[0] + 1
    a = K.range_dst_hist(cols, bounds, ascending, r, N_SHARDS, n)
    b = K.range_dst_hist_plain(cols, bounds, ascending, r, N_SHARDS, n)
    err = max_err([("K6 dst", a[0], b[0]), ("K6 hist", a[1], b[1])])
    lib = None
    if len(cols) == 1:
        b1 = bounds[:, 0].contiguous()
        shard = torch.arange(N_SHARDS, device=b1.device)[:, None] * r

        def library():
            d = torch.searchsorted(b1, cols[0])
            return torch.bincount((d + shard).view(-1),
                                  minlength=N_SHARDS * r)
        lib = timed(library)
    return {
        "max_abs_err": err,
        "ms": timed(lambda: K.range_dst_hist(cols, bounds, ascending, r,
                                             N_SHARDS, n)),
        "plain_ms": timed(lambda: K.range_dst_hist_plain(
            cols, bounds, ascending, r, N_SHARDS, n), reps=3),
        "bound_ms": bound_ms(nbytes(*cols, bounds, n, a[0], a[1])),
        "library_ms": lib,
    }


def k5_columns(K, dev, rng):
    """K5's four cases at the sort path's shape, {name: (col, src)}:
    bench.py's keys, full-range random int64 and float64 keys (with -0.0,
    infinities and NaN mixed in), and an int32 column read through a
    permutation (K5's own order of the random int64 keys)."""
    shape = (N_SHARDS, CAP)
    bench, _ = bench_data()
    cases = {"radix_sort bench keys": (
        torch.from_numpy(bench.reshape(shape)).to(dev), None)}
    rand = torch.from_numpy(rng.integers(INT64_MIN, INT64_MAX, shape,
                                         dtype=np.int64)).to(dev)
    cases["radix_sort"] = (rand, None)
    f = rng.standard_normal(shape) * 1e3
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan])
    pos = rng.integers(0, CAP, (N_SHARDS, 4096))
    for s_ in range(N_SHARDS):
        f[s_, pos[s_]] = rng.choice(special, 4096)
    cases["radix_sort float64"] = (torch.from_numpy(f).to(dev), None)
    del f
    perm = K.radix_sort(rand)
    small = torch.from_numpy(rng.integers(-1000, 1000, shape,
                                          dtype=np.int32)).to(dev)
    cases["radix_sort int32 through src_idx"] = (small, perm)
    return cases


K5_TILES = {4: "512x12", 8: "512x8"}    # radix_sort.cu's k5_items


def k5_report(K):
    """K5's tiles and ptxas's registers, shared memory and spills for
    radix_sort.cu's kernels."""
    for width, tile in sorted(K5_TILES.items()):
        print("k5 tile: passes reading a %d-byte image: %s (threads x "
              "rows)" % (width, tile))
    for line in K.build_logs["radix_sort"].splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("k5 ptxas: " + line.strip())
    sys.stdout.flush()


def sort_kernel_phases(K, dev):
    """K5 and K6 against their plain versions at the sort path's shapes.
    K5: k5_columns' four cases.  K6: 7 bounds over one and two int64 key
    columns, both directions, and one float64 column.  The kernels line
    reports the sort path's own cases: random int64 (K5), one int64
    column ascending (K6)."""
    rng = np.random.default_rng(20261018)
    shape = (N_SHARDS, CAP)
    out = {}

    def add(name, rec):
        out[name] = rec
        print_phase(name, rec)
    cases = k5_columns(K, dev, rng)
    for name, (col, src) in cases.items():
        add(name, radix_case(K, col, src))
    rand = cases["radix_sort"][0]
    del cases
    torch.cuda.empty_cache()

    n = torch.full((N_SHARDS,), CAP, dtype=torch.int32, device=dev)
    n -= torch.arange(N_SHARDS, dtype=torch.int32, device=dev) * 37
    hi = torch.from_numpy(rng.integers(0, 16, shape, dtype=np.int64)).to(dev)

    def bounds_of(cols):
        # 7 distinct sorted bound rows drawn from the keys
        idx = rng.choice(CAP, 64, replace=False)
        rows = sorted(set(tuple(int(c[0, i]) for c in cols) for i in idx))
        pick = np.linspace(0, len(rows) - 1, 7).round().astype(int)
        return torch.tensor([rows[i] for i in pick], dtype=torch.int64,
                            device=dev)
    b1, b2 = bounds_of([rand]), bounds_of([hi, rand])
    for nk, cols, bounds in ((1, [rand], b1), (2, [hi, rand], b2)):
        for asc in (True, False):
            name = "range_dst_hist nk=%d %s" % (
                nk, "ascending" if asc else "descending")
            if nk == 1 and asc:
                name = "range_dst_hist"
            add(name, range_case(K, cols, bounds, asc, n))
    fk = torch.from_numpy(rng.standard_normal(shape)).to(dev)
    fb = torch.sort(fk[0, :7].clone()).values[:, None].contiguous()
    add("range_dst_hist float64 nk=1", range_case(K, [fk], fb, True, n))
    del rand, hi, fk
    torch.cuda.empty_cache()
    return out


def seg_table_case(K, keys, n, library=True):
    """K7 on one (N, CAP) key-sorted column against its plain version;
    library call: torch.unique_consecutive(return_inverse=True,
    return_counts=True) over the flattened shards (the same segments
    where no run crosses a shard boundary and every row is valid)."""
    a = K.segment_table([keys], n)
    b = K.segment_table_plain([keys], n)
    names = ["start_rows", "sizes", "bucket", "n_seg", "hist"]
    err = max_err([("K7 " + nm, x, y) for nm, x, y in zip(names, a, b)]
                  + [("K7 keys", a[5][0], b[5][0])])
    n_seg = int(a[3].sum().item())
    lib = None
    if library:
        flat = keys.view(-1)
        lib = timed(lambda: torch.unique_consecutive(
            flat, return_inverse=True, return_counts=True))
    return a, {
        "max_abs_err": err,
        "ms": timed(lambda: K.segment_table([keys], n)),
        "plain_ms": timed(lambda: K.segment_table_plain([keys], n),
                          reps=3),
        # keys and n read once; per segment its start row, size, class
        # and key written once, and n_seg and the histogram per shard
        "bound_ms": bound_ms(nbytes(keys, n, a[3], a[4]) + n_seg * (
            3 * 4 + keys.element_size())),
        "library_ms": lib,
        # the kernel also writes the fill of every padded (N, cap) slot:
        # the bound with those writes counted
        "notes": {"segments": n_seg,
                  "bound_padded_ms": "%.4f" % bound_ms(nbytes(
                      keys, n, *a[:5], a[5][0]))},
    }


def seg_group_cases(K, C, table, vals, b, pads):
    """K8 gather (each pad) and scatter for size class b of `table`
    against their plain versions."""
    from dpark_tpu_torch.backend.cuda.layout import round_capacity
    start_rows, sizes, bucket, _, hist, _ = table
    members, counts, offsets = C.bucket_members(bucket)
    G = round_capacity(int(hist[:, b].max().item()))
    B = 1 << b
    boff, bcnt = offsets[:, b].contiguous(), counts[:, b].contiguous()
    lanes = int(bcnt.sum().item())
    rows_read = int(sizes.gather(1, members.long()).masked_fill(
        ~valid_lanes(members, boff, bcnt), 0).sum().item())
    out = {}
    for pad in pads:
        x = K.bucket_gather(start_rows, sizes, members, boff, bcnt, G, B,
                            vals, pad)
        y = K.bucket_gather_plain(start_rows, sizes, members, boff, bcnt, G,
                                  B, vals, pad)
        err = max_err([("K8 gather %s" % pad, x, y)])
        out[pad] = {
            "max_abs_err": err,
            "ms": timed(lambda: K.bucket_gather(
                start_rows, sizes, members, boff, bcnt, G, B, vals, pad)),
            "plain_ms": timed(lambda: K.bucket_gather_plain(
                start_rows, sizes, members, boff, bcnt, G, B, vals, pad),
                reps=3),
            # the padded matrix written once, each group's rows read once,
            # member id, start row and size read per lane
            "bound_ms": bound_ms(nbytes(x) + rows_read * vals.element_size()
                                 + lanes * 12 + nbytes(boff, bcnt)),
            "library_ms": None,
            "notes": {"G": G, "B": B, "lanes": lanes},
        }
    res = [x.sum(2)]
    o1 = [torch.zeros(vals.shape, dtype=res[0].dtype, device=vals.device)]
    o2 = [o1[0].clone()]
    K.bucket_scatter(o1, res, members, boff, bcnt)
    K.bucket_scatter_plain(o2, res, members, boff, bcnt)
    err = max_err([("K8 scatter", o1[0], o2[0])])
    out["scatter"] = {
        "max_abs_err": err,
        "ms": timed(lambda: K.bucket_scatter(o1, res, members, boff, bcnt)),
        "plain_ms": timed(lambda: K.bucket_scatter_plain(
            o2, res, members, boff, bcnt), reps=3),
        # results read once, one element written and one member id read
        # per valid lane
        "bound_ms": bound_ms(nbytes(*res) + lanes * (8 + 4)
                             + nbytes(boff, bcnt)),
        "library_ms": None,
        "notes": {"G": G, "lanes": lanes},
    }
    return out


def valid_lanes(members, boff, bcnt):
    """(N, cap) bool: the member slots of one size class."""
    i = torch.arange(members.shape[1], device=members.device)[None, :]
    return (i >= boff[:, None]) & (i < (boff + bcnt)[:, None])


def power_law_groups():
    """Group id of each of the 67,107,840 power-law rows: group g has
    2^(g mod 16) rows (1 to 32,768; 1,024 groups in each size class),
    rows in a seeded random order."""
    rng = np.random.default_rng(20261020)
    sizes = 1 << (np.arange(POWER_GROUPS) % 16)
    gid = np.repeat(np.arange(POWER_GROUPS, dtype=np.int64), sizes)
    return gid[rng.permutation(POWER_ROWS)]


def power_law_key(gid):
    """Keys spread by a multiplicative hash (a bijection of the group
    ids below 2^32)."""
    return (gid * 2654435761) % (1 << 32)


def seg_kernel_phases(K, dev):
    """K7 and K8 against their plain versions at the grouped paths'
    shapes, 8 x 8,388,608 key-sorted rows.  K7: bench.py's 65,536 keys
    after groupByKey(8) (8,192 groups of 1,024 rows a shard), and the
    power-law rows cut into 8 key-sorted shards.  K8: the bench groups'
    class (width 1,024) in both pads, the power-law's widest class
    (32,768) zero-padded; scatter of each group's sum."""
    from dpark_tpu_torch.backend.cuda import collectives as C
    out = {}

    def add(name, rec):
        out[name] = rec
        print_phase(name, rec)
    n = torch.full((N_SHARDS,), CAP, dtype=torch.int32, device=dev)
    keys = torch.arange(KEYS, dtype=torch.int64, device=dev) \
        .repeat_interleave(PAIRS // KEYS).view(N_SHARDS, CAP)
    table, rec = seg_table_case(K, keys, n)
    add("segment_table", rec)
    vals = (torch.arange(PAIRS, dtype=torch.int64, device=dev)
            & 0xFFFF).view(N_SHARDS, CAP)
    width = (PAIRS // KEYS).bit_length() - 1        # the class of 1,024
    cases = seg_group_cases(K, C, table, vals, width, ("zero", "edge"))
    add("bucket_gather", cases["zero"])
    add("bucket_gather edge", cases["edge"])
    add("bucket_scatter", cases["scatter"])
    del keys, table, cases
    gid = np.sort(power_law_key(power_law_groups()))
    per = POWER_ROWS // N_SHARDS
    pk = torch.full((N_SHARDS, CAP), K.KEY_SENTINEL, dtype=torch.int64,
                    device=dev)
    pk[:, :per] = torch.from_numpy(gid.reshape(N_SHARDS, per)).to(dev)
    del gid
    pn = torch.full((N_SHARDS,), per, dtype=torch.int32, device=dev)
    table, rec = seg_table_case(K, pk, pn, library=False)
    add("segment_table power-law", rec)
    widest = int(table[4].sum(0).nonzero().max().item())
    cases = seg_group_cases(K, C, table, vals, widest, ("zero",))
    add("bucket_gather power-law widest class", cases["zero"])
    add("bucket_scatter power-law", cases["scatter"])
    del pk, vals, table, cases
    torch.cuda.empty_cache()
    return out


def check_stages(ctx, what):
    for st in ctx.scheduler.history[-1]["stage_info"]:
        if (not st["kind"].startswith("array") or "fallback_reason" in st
                or "degrade_reason" in st):
            fail("%s: stage left the tensor path: %s" % (what, st))


def act(label, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    print("action %s: %.3f s" % (label, time.perf_counter() - t0),
          flush=True)
    return res


def bench_data():
    """bench.py's columns: scrambled int keys, deterministic."""
    i = np.arange(PAIRS, dtype=np.int64)
    return (i * 2654435761) % KEYS, i & 0xFFFF


def main_path(master, keys, vals):
    """bench.py's job on one master, checked against numpy."""
    from dpark_tpu_torch import Columns, DparkContext
    sums = np.bincount(keys, weights=vals, minlength=KEYS).astype(np.int64)
    ctx = DparkContext(master)
    P = ctx.default_parallelism

    def add(a, b):
        return a + b
    r = ctx.parallelize(Columns(keys, vals), P).reduceByKey(add, P)
    if act(master + " count", r.count) != KEYS:
        fail("count")
    check_stages(ctx, master + " count")
    got = act(master + " collect", r.collect)
    check_stages(ctx, master + " collect")
    gk = np.array([k for k, _ in got], np.int64)
    gv = np.array([v for _, v in got], np.int64)
    if len(got) != KEYS or not np.array_equal(sums[gk], gv) \
            or len(set(gk.tolist())) != KEYS:
        fail("%s collect differs from numpy" % master)
    top = act(master + " top", lambda: r.top(10, key=lambda kv: kv[1]))
    check_stages(ctx, master + " top")
    order = np.argsort(-sums, kind="stable")[:10]
    if top != [(int(k), int(sums[k])) for k in order]:
        fail("%s top differs from numpy: %s" % (master, top))
    # an integer key expression: the device top through the ranged-int
    # probe (K15's per-column ranges prove it cannot leave int64)
    top = act(master + " top ranged int",
              lambda: r.top(10, key=lambda kv: kv[1] * 65536 + kv[0]))
    kind = ctx.scheduler.history[-1]["stage_info"][-1]["kind"]
    order = np.argsort(-(sums * 65536 + np.arange(KEYS)), kind="stable")[:10]
    if kind != "array+top" or top != [(int(k), int(sums[k]))
                                      for k in order]:
        fail("%s ranged-int top (%s) differs from numpy: %s"
             % (master, kind, top))
    total = act(master + " reduce",
                lambda: r.map(lambda kv: kv[1]).reduce(add))
    kinds = [s["kind"] for s in ctx.scheduler.history[-1]["stage_info"]]
    if total != int(vals.sum()) or kinds != ["array+reduced"]:
        fail("%s reduce: %s %s" % (master, total, kinds))
    chain = (ctx.parallelize(Columns(keys, vals), P)
             .map(lambda kv: (kv[0], kv[1] * 3))
             .filter(lambda kv: kv[1] % 2 == 0)
             .reduceByKey(add, P))
    got = dict(act(master + " map+filter collect", chain.collect))
    check_stages(ctx, master + " map+filter")
    keep = (vals * 3) % 2 == 0
    want = np.bincount(keys[keep], weights=vals[keep] * 3,
                       minlength=KEYS).astype(np.int64)
    present = np.bincount(keys[keep], minlength=KEYS) > 0
    if got != {int(k): int(want[k]) for k in np.nonzero(present)[0]}:
        fail("%s map+filter differs from numpy" % master)
    ctx.stop()


def sort_data():
    """64Mi (random int64 key, row index) pairs: a TeraSort-shaped input
    (sentinel key excluded: the generator's high end is exclusive)."""
    rng = np.random.default_rng(20261019)
    return (rng.integers(INT64_MIN, INT64_MAX, PAIRS, dtype=np.int64),
            np.arange(PAIRS, dtype=np.int64))


def check_sorted(what, got, keys, order):
    """got (collected (k, v) rows) equals rows `order` of (keys, row
    index)."""
    if len(got) != len(order):
        fail("%s: %d rows, want %d" % (what, len(got), len(order)))
    gk = np.fromiter((kv[0] for kv in got), np.int64, len(got))
    gv = np.fromiter((kv[1] for kv in got), np.int64, len(got))
    if not (np.array_equal(gv, order) and np.array_equal(gk, keys[order])):
        bad = np.nonzero(gv != order)[0][:5]
        fail("%s differs from numpy's stable argsort at rows %s"
             % (what, bad.tolist()))


def sort_path(master, keys, vals):
    """sortByKey on one master, checked against numpy: count and top over
    the 64Mi pairs, and a full collect row for row (equal keys in input
    order) of the first SORT_COLLECT_PAIRS, in both directions on gpu:8,
    ascending on gpu."""
    from dpark_tpu_torch import Columns, DparkContext
    ctx = DparkContext(master)
    P = ctx.default_parallelism
    r = ctx.parallelize(Columns(keys, vals), P)
    made = {}

    def sort_count(ascending):
        made[ascending] = r.sortByKey(ascending=ascending, numSplits=P)
        return made[ascending].count()
    directions = [True] if master == "gpu" else [True, False]
    for ascending in directions:
        label = "%s sortByKey(ascending=%s) count" % (master, ascending)
        if act(label, lambda: sort_count(ascending)) != PAIRS:
            fail(label)
        check_stages(ctx, label)
    top = act(master + " sortByKey top", lambda: made[True].top(10))
    check_stages(ctx, master + " sortByKey top")
    big = np.argsort(keys, kind="stable")[::-1][:10]
    if top != [(int(keys[i]), int(vals[i])) for i in big]:
        fail("%s sortByKey top differs from numpy: %s" % (master, top))
    ck, cv = keys[:SORT_COLLECT_PAIRS], vals[:SORT_COLLECT_PAIRS]
    rc = ctx.parallelize(Columns(ck, cv), P)
    for ascending in directions:
        label = "%s sortByKey(ascending=%s) collect" % (master, ascending)
        got = act(label, rc.sortByKey(ascending=ascending,
                                      numSplits=P).collect)
        check_stages(ctx, label)
        # descending: an ascending stable sort of the reversed key keeps
        # equal keys in input order, as Python's sorted(reverse=True)
        order = np.argsort(ck if ascending else -1 - ck, kind="stable")
        check_sorted(label, got, ck, order)
        del got
    ctx.stop()


def group_paths(keys, vals):
    """partitionBy / groupByKey / distinct counts over bench.py's data on
    gpu:8, checked against numpy."""
    from dpark_tpu_torch import Columns, DparkContext
    ctx = DparkContext("gpu:8")
    r = ctx.parallelize(Columns(keys, vals), 8)
    jobs = [("partitionBy(8) count", lambda: r.partitionBy(8).count(),
             PAIRS),
            ("groupByKey(8) count", lambda: r.groupByKey(8).count(),
             len(np.unique(keys))),
            ("distinct(8) count", lambda: r.distinct(8).count(),
             len(np.unique(keys * (1 << 16) + vals)))]
    for label, job, want in jobs:
        got = act("gpu:8 " + label, job)
        check_stages(ctx, label)
        if got != want:
            fail("%s: %s, numpy %s" % (label, got, want))
    ctx.stop()


def sumsq(vs):
    return sum(v * v for v in vs)


def check_groups(what, got, want):
    """got (collected (k, v) rows) equals want (dict key -> value)."""
    if len(got) != len(want):
        fail("%s: %d groups, want %d" % (what, len(got), len(want)))
    for k, v in got:
        if want.get(k) != v:
            fail("%s: key %s gives %r, numpy %r" % (what, k, v, want.get(k)))


def segmap_path(label, keys, vals, want):
    """groupByKey(8).mapValues(sum of squares) -> count / collect on
    gpu:8, every stage on the tensor path, checked against numpy."""
    from dpark_tpu_torch import Columns, DparkContext
    ctx = DparkContext("gpu:8")
    r = ctx.parallelize(Columns(keys, vals), 8).groupByKey(8) \
        .mapValues(sumsq)
    if act("gpu:8 %s count" % label, r.count) != len(want):
        fail("%s count" % label)
    check_stages(ctx, label + " count")
    got = act("gpu:8 %s collect" % label, r.collect)
    check_stages(ctx, label + " collect")
    check_groups(label, got, want)
    ctx.stop()


def segagg_wants(keys, vals):
    """numpy's sum / len / min / max / mean of each key's values."""
    order = np.argsort(keys, kind="stable")
    starts = np.searchsorted(keys[order], np.arange(KEYS))
    sv = vals[order]
    sums = np.add.reduceat(sv, starts)
    lens = np.diff(np.append(starts, len(keys)))
    wants = {"sum": sums, "len": lens,
             "min": np.minimum.reduceat(sv, starts),
             "max": np.maximum.reduceat(sv, starts),
             "mean": sums / lens}
    return {name: {k: w[k].item() for k in range(KEYS)}
            for name, w in wants.items()}


def segagg_path(keys, vals, wants):
    """groupByKey(8).mapValues(sum / len / min / max / mean) with the
    combiner rewrite off (SegAggOp, a no-combine shuffle), collected and
    checked exactly against numpy."""
    from dpark_tpu_torch import Columns, DparkContext, conf
    ctx = DparkContext("gpu:8")
    r = ctx.parallelize(Columns(keys, vals), 8)
    old = conf.GROUP_AGG_REWRITE
    conf.GROUP_AGG_REWRITE = False
    try:
        for name, f in SEGAGG_FNS.items():
            label = "segagg %s" % name
            got = act("gpu:8 %s collect" % label,
                      r.groupByKey(8).mapValues(f).collect)
            check_stages(ctx, label)
            st = ctx.scheduler.history[-1]["stage_info"]
            if st[0]["combine"]:
                fail("%s: the grouping shuffle combined" % label)
            check_groups(label, got, wants[name])
    finally:
        conf.GROUP_AGG_REWRITE = old
    ctx.stop()


def rewritten_sum_path(keys, vals, wants):
    """groupByKey(8).mapValues(sum) with the combiner rewrite on: the
    stage record must show a combining shuffle; checked against numpy."""
    from dpark_tpu_torch import Columns, DparkContext
    ctx = DparkContext("gpu:8")
    r = ctx.parallelize(Columns(keys, vals), 8)
    got = act("gpu:8 rewritten sum collect",
              r.groupByKey(8).mapValues(sum).collect)
    check_stages(ctx, "rewritten sum")
    if not ctx.scheduler.history[-1]["stage_info"][0]["combine"]:
        fail("rewritten sum: the stage record shows no combining shuffle")
    check_groups("rewritten sum", got, wants["sum"])
    ctx.stop()


def square_sums(gid, vals, groups):
    """Per-group sums of vals**2 as int64.  bincount adds in float64,
    which is exact while every group's sum stays below 2**53 (the weights
    are non-negative, so no partial sum exceeds its group's total)."""
    got = np.bincount(gid, weights=(vals * vals).astype(np.float64),
                      minlength=groups)
    if got.max(initial=0) >= 2.0 ** 53:
        fail("square sums reach 2**53: the float64 reference is inexact")
    return got.astype(np.int64)


def grouped_paths(drive, keys, vals):
    """The four grouped paths; each driven with its own launch counts."""
    want = square_sums(keys, vals, KEYS)
    drive("groupByKey gpu:8 segmap", segmap_path, "segmap", keys, vals,
          dict(enumerate(want.tolist())))
    wants = segagg_wants(keys, vals)
    drive("groupByKey gpu:8 segagg", segagg_path, keys, vals, wants)
    drive("groupByKey gpu:8 rewritten sum", rewritten_sum_path, keys, vals,
          wants)
    del wants
    gid = power_law_groups()
    pkeys = power_law_key(gid)
    pvals = np.arange(POWER_ROWS, dtype=np.int64) & 0xFFFF
    sq = square_sums(gid, pvals, POWER_GROUPS)
    del gid
    pwant = dict(zip(power_law_key(np.arange(POWER_GROUPS)).tolist(),
                     sq.tolist()))
    drive("groupByKey gpu:8 segmap power-law", segmap_path,
          "segmap power-law", pkeys, pvals, pwant)


def kronecker_graph(scale, edge_factor, seed=20261021, parts=16):
    """Graph500's Kronecker generator (its reference code's bit loop: A, B,
    C = 0.57, 0.19, 0.19), vertex labels randomly permuted and edges
    shuffled, from seeded numpy generators: `parts` slices of the edge
    list each draw from a child of the seed (threads fill them at once;
    the graph does not depend on the thread count).  Each generated pair
    is one directed edge (Graph500 treats it as undirected).  Returns (n,
    src, dst, source): `source` is the permuted label of Kronecker vertex
    0."""
    from concurrent.futures import ThreadPoolExecutor
    n, m = 1 << scale, edge_factor << scale
    a, b, c = KRONECKER_ABC
    ab = a + b
    thr = np.array([a / ab, c / (1 - ab)], np.float32)
    src = np.zeros(m, np.int32)            # scale < 31: labels fit int32
    dst = np.zeros(m, np.int32)
    seeds = np.random.SeedSequence(seed).spawn(parts + 1)

    def fill(k):
        rng = np.random.default_rng(seeds[k])
        lo, hi = k * m // parts, (k + 1) * m // parts
        s, d = src[lo:hi], dst[lo:hi]
        for bit in range(scale):
            ii = rng.random(hi - lo, dtype=np.float32) > ab
            jj = rng.random(hi - lo, dtype=np.float32) > thr[ii.view(np.uint8)]
            np.bitwise_or(s, np.left_shift(ii, bit, dtype=np.int32), out=s)
            np.bitwise_or(d, np.left_shift(jj, bit, dtype=np.int32), out=d)
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(fill, range(parts)))
    rng = np.random.default_rng(seeds[parts])
    perm = rng.permutation(n)
    shuffle = rng.permutation(m)
    return n, perm[src[shuffle]], perm[dst[shuffle]], int(perm[0])


def pagerank_fns(n):
    """PageRank as examples/pagerank.py writes it, in torch ops: superstep
    0 keeps the initial rank, later ones (1 - d)/n + d * mail."""
    def compute(value, msg, has_msg, active, agg, superstep):
        is0 = (superstep == 0) * 1.0
        return (is0 * value + (1 - is0) * ((1 - DAMPING) / n
                                           + DAMPING * msg),
                superstep < PR_STEPS)

    def send(value, edge_value, degree):
        return value / degree
    return compute, send


def sssp_fns():
    def compute(dist, msg, has_msg, active, agg, superstep):
        new = torch.minimum(dist, msg)
        return new, new < dist

    def send(dist, weight, degree):
        return dist + weight
    return compute, send


def pagerank_numpy(n, src, dst):
    """The same recurrence, superstep for superstep, as an independent
    power iteration."""
    deg = np.bincount(src, minlength=n)
    r = np.full(n, 1.0 / n)
    for _ in range(PR_STEPS):
        # (r / deg)[src] is r[src] / deg[src], one division a vertex (a
        # vertex with no out-edge divides by 0 and is never gathered)
        with np.errstate(divide="ignore"):
            share = (r / deg)[src]
        r = (1 - DAMPING) / n + DAMPING * np.bincount(dst, weights=share,
                                                      minlength=n)
    return r


def dijkstra_numpy(n, src, dst, w, source):
    """scipy's Dijkstra from `source`, after collapsing parallel edges to
    their least weight (a CSR matrix would SUM duplicate entries)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra
    # (src, dst) in the high bits, the weight (1..99) in the low 7: one
    # sort puts each pair's least weight first
    packed = np.sort((src * n + dst) << 7 | w.astype(np.int64))
    pair = packed >> 7
    first = np.ones(len(pair), bool)
    first[1:] = pair[1:] != pair[:-1]
    pair, least = pair[first], (packed[first] & 127).astype(np.float64)
    g = csr_matrix((least, (pair // n, pair % n)), shape=(n, n))
    return dijkstra(g, directed=True, indices=source)


def pregel_kernel_phases(K, dev, graph):
    """K9 and K10 against their plain versions at the PageRank run's
    shapes on the Graph500 graph (a DevicePregel after superstep 0: K9
    over every edge slot; K10 on the messages superstep 1 delivers),
    then one PageRank superstep under the profiler."""
    from dpark_tpu_torch.backend.cuda import collectives as C
    from dpark_tpu_torch.backend.cuda.bagel import DevicePregel
    from dpark_tpu_torch.backend.cuda.executor import TorchExecutor
    n, src, dst, _ = graph
    dp = DevicePregel(TorchExecutor(N_SHARDS, dev), np.arange(n),
                      np.full(n, 1.0 / n), (src, dst), *pagerank_fns(n),
                      max_superstep=PR_STEPS + 1)
    dp._p_step(0, None)
    out = {}
    V, E = int(dp.vcnt.sum().item()), int(dp.ecnt.sum().item())
    slot, ecnt, vals, gate = dp.e_slot, dp.ecnt, dp.values, dp.active
    a = K.edge_gather(slot, ecnt, vals, gate)
    b = K.edge_gather_plain(slot, ecnt, vals, gate)
    err = max_err([("K9 rank", a[0][0], b[0][0]), ("K9 sa", a[1], b[1])])
    live = torch.arange(dp.cap_e, device=dev)[None, :] < ecnt[:, None]

    def library_k9():
        idx = slot.long()
        return ([torch.gather(v, 1, idx) for v in vals],
                torch.gather(gate, 1, idx) & live)
    row = sum(v[0, 0].numel() * v.element_size() for v in vals)
    out["edge_gather"] = {
        "max_abs_err": err,
        "ms": timed(lambda: K.edge_gather(slot, ecnt, vals, gate)),
        "plain_ms": timed(lambda: K.edge_gather_plain(slot, ecnt, vals,
                                                      gate), reps=3),
        # each input read once (the slot of every edge, every vertex's
        # leaves and gate), each output written once (a row and a flag
        # per edge)
        "bound_ms": bound_ms(E * (4 + row + 1) + V * (row + 1)),
        "library_ms": timed(library_k9),
        "notes": {"edges": E, "vertices": V,
                  "bound_vertex_read_per_edge_ms": "%.4f" % bound_ms(
                      E * (4 + 2 * row + 2)),
                  "bound_padded_ms": "%.4f" % bound_ms(
                      slot.numel() * (4 + row + 1) + V * (row + 1))},
    }
    print_phase("edge_gather", out["edge_gather"])
    pending, _ = dp._p_gen()
    counts, offsets, kk, vv = pending
    recv, rn = C.exchange([kk] + vv, counts, offsets)
    uk, uv, nu = C.segment_reduce_keys([recv[0]], recv[1:], rn, dp._merge,
                                       monoid="add")
    uk = uk[0]
    del recv
    vid, vcnt = dp.vid, dp.vcnt
    a = K.pregel_deliver(vid, vcnt, uk, nu, uv, "add")
    b = K.pregel_deliver_plain(vid, vcnt, uk, nu, uv, "add")
    err = max_err([("K10 msg", a[0][0], b[0][0]), ("K10 has", a[1], b[1])])
    U = int(nu.sum().item())
    live_u = torch.arange(uk.shape[1], device=dev)[None, :] < nu[:, None]
    valid_v = C.valid_rows(vcnt, dp.cap_v)

    def library_k10():
        keys = torch.where(live_u, uk, K.KEY_SENTINEL)
        pos = torch.searchsorted(keys, vid).clamp_(0, uk.shape[1] - 1)
        has = (torch.gather(keys, 1, pos) == vid) & valid_v
        return torch.where(has, torch.gather(uv[0], 1, pos), 0.0), has
    out["pregel_deliver"] = {
        "max_abs_err": err,
        "ms": timed(lambda: K.pregel_deliver(vid, vcnt, uk, nu, uv, "add")),
        "plain_ms": timed(lambda: K.pregel_deliver_plain(
            vid, vcnt, uk, nu, uv, "add"), reps=3),
        # ids, unique keys and their messages read once; a message and a
        # flag written per vertex
        "bound_ms": bound_ms(V * (8 + 8 + 1) + U * (8 + 8)),
        "library_ms": timed(library_k10),
        "notes": {"vertices": V, "unique_targets": U,
                  "cap_v": dp.cap_v, "cap_u": uk.shape[1]},
    }
    print_phase("pregel_deliver", out["pregel_deliver"])
    del uk, uv, nu, a, b
    profile_window("gpu:8 PageRank superstep 1 (deliver, compute, "
                   "generate)", lambda: (dp._p_step(1, pending),
                                         dp._p_gen()))
    del dp, pending
    torch.cuda.empty_cache()
    return out


def topk_phase(dev):
    """B7, the top path's per-shard pre-top (executor._device_topk: K5 on
    the order-reversed key, K2 by validity, keep n rows), at 8 x 8,388,608
    bench rows, top 10 by value; against torch.sort(stable=True) per shard
    plus a slice and the rows' gather (library), torch.topk beside it."""
    from dpark_tpu_torch.backend.cuda.executor import TorchExecutor
    from dpark_tpu_torch.backend.cuda.layout import Batch
    keys, vals = (torch.from_numpy(c.reshape(N_SHARDS, CAP)).to(dev)
                  for c in bench_data())
    n = torch.full((N_SHARDS,), CAP, dtype=torch.int32, device=dev)
    ex, top = TorchExecutor(N_SHARDS, dev), 10
    batch = Batch(None, [keys, vals], n)

    def composed():
        return ex._device_topk(None, batch, ("leaves", [1]), top, False)

    def library():
        o = torch.sort(-1 - vals, dim=1, stable=True).indices[:, :top]
        return torch.gather(keys, 1, o), torch.gather(vals, 1, o)
    got, want = composed(), library()
    err = max_err([("B7 keys", got.cols[0], want[0]),
                   ("B7 vals", got.cols[1], want[1])])
    rec = {
        # a composition of two kernels has no plain version of its own
        "max_abs_err": err, "ms": timed(composed), "plain_ms": None,
        # the order key read once, the kept rows written once
        "bound_ms": bound_ms(nbytes(vals, n) + N_SHARDS * top * 16),
        "library_ms": timed(library),
        "notes": {"topk_ms": "%.4f" % timed(
            lambda: torch.topk(vals, top, dim=1))},
    }
    print_phase("top-n composed of K5 + K2", rec)
    del keys, vals, batch, got, want
    torch.cuda.empty_cache()


def pregel_path(graph, weights):
    """PageRank and SSSP through run_pregel on gpu:8, checked against
    numpy's power iteration (rtol PR_RTOL) and scipy's Dijkstra
    (exactly).  Returns the least K9 and K10 launches the runs need: one
    K9 a superstep, one K10 a superstep with mail."""
    from dpark_tpu_torch import DparkContext, run_pregel
    n, src, dst, source = graph
    ctx = DparkContext("gpu:8")
    ids = np.arange(n, dtype=np.int64)
    steps = delivered = 0

    def run(label, *args, **kw):
        nonlocal steps, delivered
        torch.cuda.reset_peak_memory_stats()
        out = act(label, lambda: run_pregel(ctx, ids, *args, **kw))
        print("pregel %s: peak device memory %.2f GB" % (
            label, torch.cuda.max_memory_allocated() / 1e9), flush=True)
        st = ctx.scheduler._pregel_stats
        if not ctx.scheduler._pregel_device_used:
            fail("%s left the device: %s" % (
                label, ctx.scheduler._pregel_fallback_reason))
        print("pregel %s: setup_s=%.3f init_s=%.4f supersteps=%d "
              "delivered=%d superstep_loop_s=%.3f per_superstep_ms=%.2f "
              "cap_v=%d cap_e=%d" % (
                  label, st["setup_seconds"], st["init_seconds"],
                  st["supersteps"], st["delivered"], st["superstep_seconds"],
                  st["superstep_seconds"] / st["supersteps"] * 1e3,
                  st["cap_v"], st["cap_e"]), flush=True)
        steps += st["supersteps"]
        delivered += st["delivered"]
        return out, st
    (gids, ranks, _), st = run(
        "gpu:8 PageRank", np.full(n, 1.0 / n), (src, dst),
        *pagerank_fns(n), combine="add", max_superstep=PR_STEPS + 1)
    if st["supersteps"] != PR_STEPS + 1:
        fail("PageRank ran %d supersteps" % st["supersteps"])
    want = pagerank_numpy(n, src, dst)
    if not (np.array_equal(gids, ids)
            and np.allclose(ranks, want, rtol=PR_RTOL, atol=0)):
        fail("PageRank differs from numpy's power iteration: max rel err %g"
             % np.max(np.abs(ranks - want) / want))
    print("pregel PageRank: max rel err vs numpy %.3g (rtol %g)" % (
        np.max(np.abs(ranks - want) / want), PR_RTOL), flush=True)
    del ranks, want
    (gids, dist, _), st = run(
        "gpu:8 SSSP", np.full(n, np.inf), (src, dst), *sssp_fns(),
        combine="min", edge_values=weights,
        initial_messages=(np.array([source]), np.array([0.0])),
        max_superstep=SSSP_MAX_SUPERSTEP)
    if st["supersteps"] >= SSSP_MAX_SUPERSTEP:
        fail("SSSP did not halt before superstep %d" % SSSP_MAX_SUPERSTEP)
    ref = dijkstra_numpy(n, src, dst, weights, source)
    if not (np.array_equal(gids, ids) and np.array_equal(dist, ref)):
        fail("SSSP differs from Dijkstra at %d vertices"
             % int((dist != ref).sum()))
    print("pregel SSSP: %d reachable, max distance %g, equal to Dijkstra"
          % (int(np.isfinite(ref).sum()), ref[np.isfinite(ref)].max()),
          flush=True)
    ctx.stop()
    return {"edge_gather": steps, "pregel_deliver": delivered,
            "monoid_reduce": steps}


def urand_graph(scale, edge_factor, seed=20261023):
    """GAP's urand: `edge_factor << scale` directed edges, both endpoints
    uniform over 2^scale vertices (duplicates and self-loops kept)."""
    n, m = 1 << scale, edge_factor << scale
    rng = np.random.default_rng(seed)
    return n, rng.integers(0, n, m), rng.integers(0, n, m)


def urand_layout(n, src, dst):
    """The object walk's output, in numpy: out-degrees, edge targets in
    per-vertex order, and each edge's value 1 / out-degree of its
    source."""
    deg = np.bincount(src, minlength=n)
    order = np.argsort(src, kind="stable")
    inv = 1.0 / np.maximum(deg, 1)
    return deg, dst[order], inv[src[order]]


def urand_objects(graph):
    """The graph as Bagel.run's input rows: (id, Vertex(id, 1 / n, [Edge(
    target, 1 / out-degree), ...])) for every vertex, in id order."""
    from dpark_tpu_torch import Edge, Vertex
    n, src, dst = graph
    deg, tgt, ev = urand_layout(n, src, dst)
    offs = np.concatenate([[0], np.cumsum(deg)]).tolist()
    tgt, ev = tgt.tolist(), ev.tolist()
    return [(v, Vertex(v, 1.0 / n, list(map(
        Edge, tgt[offs[v]:offs[v + 1]], ev[offs[v]:offs[v + 1]]))))
        for v in range(n)]


def bagel_pagerank(n):
    """tests/test_bagel_obj_general.py's PageRank with Message(target,
    rank * Edge.value) in place of the len(outEdges) split (so bucketed
    degree classes stay sound)."""
    from dpark_tpu_torch import Message, Vertex

    def compute(vert, msg, agg, s):
        new = vert.value if s == 0 else (
            0.15 / n + 0.85 * (msg if msg is not None else 0.0))
        v = Vertex(vert.id, new, vert.outEdges, s < PR_STEPS)
        if s < PR_STEPS and vert.outEdges:
            return (v, [Message(e.target_id, new * e.value)
                        for e in vert.outEdges])
        return (v, [])
    return compute


def bagel_pagerank_numpy(n, src, dst):
    """The same recurrence as a numpy power iteration: each edge carries
    rank * (1 / out-degree), as the messages do."""
    w = 1.0 / np.bincount(src, minlength=n)[src]
    r = np.full(n, 1.0 / n)
    for _ in range(PR_STEPS):
        r = 0.15 / n + 0.85 * np.bincount(dst, weights=r[src] * w,
                                          minlength=n)
    return r


def bagel_kernel_phase(K, dev, graph):
    """K11 against its plain version on the emission blocks of PageRank's
    superstep 1 on the urand graph (a DeviceObjectPregel built from the
    object walk's numpy output), then one superstep under the profiler."""
    from dpark_tpu_torch.backend.cuda.bagel_obj import DeviceObjectPregel
    from dpark_tpu_torch.backend.cuda.executor import TorchExecutor
    from dpark_tpu_torch.utils import pytree
    n, src, dst = graph
    deg, tgt, ev = urand_layout(n, src, dst)
    dop = DeviceObjectPregel(
        TorchExecutor(N_SHARDS, dev), bagel_pagerank(n), "add", pytree.LEAF,
        np.arange(n, dtype=np.int64), [np.full(n, 1.0 / n)],
        np.ones(n, bool), deg, tgt, ev, None, PR_STEPS + 1,
        combine_op=operator.add)
    del deg, tgt, ev
    pending, _, _ = dop._p_step(0, None)
    blocks, _ = dop._step_blocks(1, pending)
    a = K.obj_emit_pack(blocks)
    b = K.obj_emit_pack_plain(blocks)
    err = max_err([("K11 dst", a[0], b[0]), ("K11 rank", a[1][0], b[1][0]),
                   ("K11 counts", a[2], b[2])])
    kept = int(a[2].sum().item())
    slots = sum(d.numel() for _, d, _ in blocks)
    rows = sum(g.numel() for g, _, _ in blocks)
    # the dst slots of the rows whose gate is set: the only targets the
    # function needs (the mail and no-mail gates of a class partition
    # its rows; padded rows are closed)
    gated = sum(int(g.sum().item()) * d.shape[2] for g, d, _ in blocks)
    leaf_b = sum(x.element_size() * math.prod(x.shape[3:])
                 for x in blocks[0][2])

    def library():
        d = torch.cat([torch.where(g[:, :, None], x, K.KEY_SENTINEL)
                       .reshape(N_SHARDS, -1) for g, x, _ in blocks], 1)
        v = torch.cat([lv[0].reshape(N_SHARDS, -1) for _, _, lv in blocks], 1)
        o = torch.argsort((d == K.KEY_SENTINEL).to(torch.int8), dim=1,
                          stable=True)
        return torch.gather(d, 1, o), torch.gather(v, 1, o)
    rec = {
        "max_abs_err": err,
        "ms": timed(lambda: K.obj_emit_pack(blocks)),
        "plain_ms": timed(lambda: K.obj_emit_pack_plain(blocks), reps=3),
        # every gate read once, the gated rows' dst slots read, each
        # kept slot's leaves read and its packed row written (the
        # sentinel tail past each shard's count is padding)
        "bound_ms": bound_ms(rows + gated * 8 + kept * (8 + 2 * leaf_b)),
        "library_ms": timed(library, reps=3),
        "notes": {"blocks": len(blocks), "slots": slots,
                  "gated_slots": gated, "kept": kept,
                  "cap_out": a[0].shape[1], "classes": dop.classes},
    }
    print_phase("obj_emit_pack", rec)
    del a, b, blocks
    profile_window("gpu:8 object PageRank superstep 1 (deliver per class, "
                   "compute, pack, pre-combine)",
                   lambda: dop._p_step(1, pending))
    del dop, pending
    torch.cuda.empty_cache()
    return {"obj_emit_pack": rec}


def bagel_path(graph):
    """Object PageRank through Bagel.run on gpu:8 over the urand graph,
    checked against numpy's power iteration (rtol PR_RTOL).  Returns the
    least K10 launches: one per class a superstep with mail."""
    from dpark_tpu_torch import BasicCombiner, DparkContext
    from dpark_tpu_torch.backend.cuda import bagel_obj
    n, src, dst = graph
    t0 = time.perf_counter()
    rows = urand_objects(graph)
    print("bagel: %d Vertex and %d Edge objects built in %.1f s" % (
        n, len(src), time.perf_counter() - t0), flush=True)
    ctx = DparkContext("gpu:8")
    torch.cuda.reset_peak_memory_stats()
    final = act("gpu:8 object PageRank Bagel.run", lambda: _bagel_run(
        ctx, rows, bagel_pagerank(n), BasicCombiner(operator.add)))
    sched = ctx.scheduler
    if not sched._pregel_device_used:
        fail("object PageRank left the device: %s"
             % sched._pregel_fallback_reason)
    stats = dict(bagel_obj.LAST_RUN_STATS)
    if not stats["bucketed"]:
        fail("object PageRank did not run on bucketed classes: %s" % stats)
    st = sched._pregel_stats
    print("bagel object PageRank: setup_s=%.3f (walk %.3f) supersteps=%d "
          "delivered=%d superstep_loop_s=%.3f per_superstep_ms=%.2f "
          "canary_s=%.3f classes=%d widths=%s caps=%s" % (
              st["setup_seconds"], st["walk_seconds"], st["supersteps"],
              st["delivered"], st["superstep_seconds"],
              st["superstep_seconds"] / st["supersteps"] * 1e3,
              st["canary_seconds"], st["classes"], st["widths"], st["caps"]),
          flush=True)
    print("bagel object PageRank: peak device memory %.2f GB, host peak "
          "RSS %.2f GB" % (torch.cuda.max_memory_allocated() / 1e9,
                           resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                           / 1e6), flush=True)
    if st["supersteps"] != PR_STEPS + 1:
        fail("object PageRank ran %d supersteps" % st["supersteps"])
    got = act("gpu:8 object PageRank collect", final.collect)
    ids = np.fromiter((vid for vid, _ in got), np.int64, len(got))
    ranks = np.fromiter((v.value for _, v in got), np.float64, len(got))
    del got, rows, final
    want = bagel_pagerank_numpy(n, src, dst)
    if len(ids) != n or not (np.array_equal(np.sort(ids), np.arange(n))
                             and np.allclose(ranks, want[ids], rtol=PR_RTOL,
                                             atol=0)):
        fail("object PageRank differs from numpy's power iteration: max "
             "rel err %g" % np.max(np.abs(ranks - want[ids]) / want[ids]))
    print("bagel object PageRank: max rel err vs numpy %.3g (rtol %g)" % (
        np.max(np.abs(ranks - want[ids]) / want[ids]), PR_RTOL), flush=True)
    ctx.stop()
    return {"pregel_deliver": st["delivered"] * st["classes"],
            "monoid_reduce": st["supersteps"] * st["classes"]}


def _bagel_run(ctx, rows, compute, combiner):
    from dpark_tpu_torch import Bagel
    return Bagel.run(ctx, ctx.parallelize(rows, N_SHARDS),
                     ctx.parallelize([], N_SHARDS), compute,
                     combiner=combiner, max_superstep=PR_STEPS + 1)


@contextlib.contextmanager
def counting(owner, name, calls):
    """Count the calls of owner.name (a plain-torch function, which has no
    launch counter) into calls[name] while the block runs."""
    orig = getattr(owner, name)

    def wrapper(*a, **kw):
        calls[name] = calls.get(name, 0) + 1
        return orig(*a, **kw)
    setattr(owner, name, wrapper)
    try:
        yield
    finally:
        setattr(owner, name, orig)


def _pair_sum(x, y):
    return (x[0] + y[0], x[1] + y[1])


def plain_phases(dev):
    """B8, plain torch, at the main path's shape (8 x 8,388,608 rows):
    the segmented scan of a traced tuple merge
    (collectives.segmented_combine, log2(CAP) vmapped merge steps) over
    bench keys sorted per shard and (value, 1) pairs."""
    from dpark_tpu_torch.backend.cuda import collectives, fuse
    keys, vals = bench_data()
    order = np.argsort(keys.reshape(N_SHARDS, CAP), axis=1, kind="stable")
    k = torch.from_numpy(np.take_along_axis(
        keys.reshape(N_SHARDS, CAP), order, 1)).to(dev)
    v = torch.from_numpy(vals.reshape(N_SHARDS, CAP)).to(dev)
    ones = torch.ones_like(v)
    del keys, vals, order
    merge = fuse.probe_merge(_pair_sum, (0, (1, 2)),
                             [(np.dtype(np.int64), ())] * 3, 1)
    starts = collectives._starts([k])

    def scan():
        return collectives.segmented_combine(starts, [v, ones], merge)
    got = scan()
    # the scan's last row of each run holds the run's sums: check them
    last = torch.ones_like(starts)
    last[:, :-1] = starts[:, 1:]
    want_sum = torch.zeros_like(v).scatter_add_(
        1, torch.cumsum(starts, 1) - 1, v)
    want_len = torch.zeros_like(v).scatter_add_(
        1, torch.cumsum(starts, 1) - 1, ones)
    seg = (torch.cumsum(starts, 1) - 1)[last]
    rows = torch.arange(N_SHARDS, device=dev)[:, None].expand(
        N_SHARDS, CAP)[last]
    if not (torch.equal(got[0][last], want_sum[rows, seg])
            and torch.equal(got[1][last], want_len[rows, seg])):
        fail("segmented_combine: a run's last row is not its sum")
    b8 = {"ms": timed(scan, reps=3),
          # the run flags and both value leaves read once, both scanned
          # leaves written once
          "bound_ms": bound_ms(nbytes(starts, v, ones) + nbytes(v, ones)),
          "steps": math.ceil(math.log2(CAP))}
    print("phase segmented_combine (B8, plain torch): ms=%.4f bound_ms=%.4f "
          "library_ms=none merge_steps=%d" % (b8["ms"], b8["bound_ms"],
                                              b8["steps"]), flush=True)
    del got, want_sum, want_len, last, seg, rows, k, v, ones, starts
    torch.cuda.empty_cache()
    return b8


def k17_case(K, label, col, n, op, library=None):
    """K17's monoid_reduce against its plain version on one (N, cap)
    column: the reduction, min and max exactly, a float add within
    K17_RTOL; prints ms, bound_ms (the valid elements and the counts read
    once, three (N,) results written once), plain_ms and the library
    calls over the same (full) shards: sum + amin + amax, and aminmax +
    sum (None where the shards are ragged: no call masks them)."""
    got = K.monoid_reduce(col, n, op)
    want = K.monoid_reduce_plain(col, n, op)
    err = 0.0
    for g, w, which in zip(got, want, (op, "min", "max")):
        if g.dtype != w.dtype:
            fail("monoid_reduce %s: %s dtype %s, plain %s"
                 % (label, which, g.dtype, w.dtype))
        if g.dtype.is_floating_point and which in ("add", "mul"):
            ok = torch.allclose(g, w, rtol=K17_RTOL[g.dtype], atol=0)
        else:
            ok = torch.equal(g, w)
        if not ok:
            fail("monoid_reduce %s differs from its plain version (%s): "
                 "%s vs %s" % (label, which, g.tolist(), w.tolist()))
        if g.dtype.is_floating_point:
            d = torch.where(g == w, 0.0, (g.double() - w.double()).abs())
            err = max(err, float(d.max().item()))
    valid = int(n.long().sum().item()) * col.element_size()
    rec = {"ms": timed(lambda: K.monoid_reduce(col, n, op)),
           "plain_ms": timed(lambda: K.monoid_reduce_plain(col, n, op),
                             reps=3),
           "bound_ms": bound_ms(valid + nbytes(n) + 3 * 8 * N_SHARDS),
           "max_abs_err": err, "library_ms": None}
    aminmax = None
    if library == "minmax":
        rec["library_ms"] = timed(lambda: (col.sum(1), col.amin(1),
                                           col.amax(1)))
        aminmax = timed(lambda: (torch.aminmax(col, dim=1), col.sum(1)))
    elif library == "count":
        rec["library_ms"] = timed(lambda: col.sum(1))
    print("phase monoid_reduce %s: ms=%.4f bound_ms=%.4f plain_ms=%.4f "
          "library_ms=%s aminmax_sum_ms=%s max_abs_err=%g" % (
              label, rec["ms"], rec["bound_ms"], rec["plain_ms"],
              "%.4f" % rec["library_ms"] if rec["library_ms"] else "null",
              "%.4f" % aminmax if aminmax else "null", err), flush=True)
    return rec


def distinct_case(K, label, keys, n):
    """K17's distinct_key_counts against its plain version (exact); no
    single PyTorch call counts per shard (library null)."""
    got = K.distinct_key_counts(keys, n)
    if not torch.equal(got, K.distinct_key_counts_plain(keys, n)):
        fail("distinct_key_counts %s differs from its plain version"
             % label)
    valid = int(n.long().sum().item()) * 8 * len(keys)
    rec = {"ms": timed(lambda: K.distinct_key_counts(keys, n)),
           "plain_ms": timed(lambda: K.distinct_key_counts_plain(keys, n),
                             reps=3),
           "bound_ms": bound_ms(valid + nbytes(n) + 8 * N_SHARDS),
           "max_abs_err": 0.0, "library_ms": None}
    print("phase distinct_key_counts %s: ms=%.4f bound_ms=%.4f "
          "plain_ms=%.4f library_ms=null keys=%d" % (
              label, rec["ms"], rec["bound_ms"], rec["plain_ms"],
              int(got.sum().item())), flush=True)
    return rec


def monoid_reduce_phases(K, dev):
    """K17 (B9) at the main path's shape, 8 x 8,388,608 rows: bench
    values (int64) add / min / max with full shards (the reduce action's
    input), float64 and float32 adds, a bool count (the Pregel active
    count's form), ragged shards with an empty one; distinct_key_counts
    over bench keys sorted per shard (nk = 1, a bare groupByKey count's
    input) and over (key, value) pairs sorted per shard (nk = 2)."""
    keys, vals = bench_data()
    rng = np.random.default_rng(20261028)
    v = torch.from_numpy(vals.reshape(N_SHARDS, CAP)).to(dev)
    full = torch.full((N_SHARDS,), CAP, dtype=torch.int32, device=dev)
    out = {"monoid_reduce": k17_case(K, "int64 add (bench values)", v, full,
                                     "add", "minmax")}
    for op in ("min", "max"):
        k17_case(K, "int64 %s (bench values)" % op, v, full, op, "minmax")
    ragged = rng.integers(CAP // 2, CAP + 1, N_SHARDS).astype(np.int32)
    ragged[3] = 0
    k17_case(K, "int64 add (ragged, shard 3 empty)", v,
             torch.from_numpy(ragged).to(dev), "add")
    for dt in (torch.float64, torch.float32):
        f = torch.from_numpy(rng.standard_normal((N_SHARDS, CAP))).to(
            dev).to(dt)
        k17_case(K, "%s add" % str(dt).split(".")[1], f, full, "add",
                 "minmax")
        del f
    b = torch.from_numpy(rng.random((N_SHARDS, CAP)) < 0.5).to(dev)
    k17_case(K, "bool count", b, full, "add", "count")
    del b
    k = torch.from_numpy(keys.reshape(N_SHARDS, CAP)).to(dev)
    out["distinct_key_counts"] = distinct_case(
        K, "nk=1 (bench keys sorted per shard)",
        [torch.sort(k, dim=1).values.contiguous()], full)
    pair = torch.sort(k * 65536 + v, dim=1).values
    distinct_case(K, "nk=2 ((key, value) sorted per shard)",
                  [(pair >> 16).contiguous(), (pair & 0xFFFF).contiguous()],
                  full)
    del k, v, pair
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def no_plain_scan(what):
    """The block must make no call to the plain segmented scan of a
    vmapped merge (collectives.segmented_combine): every traced merge it
    runs lowers to K14 (PATH_MIN_LAUNCHES holds K14's launches)."""
    from dpark_tpu_torch.backend.cuda import collectives
    calls = {}
    with counting(collectives, "segmented_combine", calls):
        yield
    print("calls %s: segmented_combine=%d" % (
        what, calls.get("segmented_combine", 0)), flush=True)
    if calls.get("segmented_combine", 0):
        fail("%s called the plain segmented scan %d times" % (
            what, calls["segmented_combine"]))


def check_merge_routes(ctx, what):
    """Every traced merge of the last job's stages lowered to K14 (the
    stage records' merge_route), and at least one ran."""
    routes = [r for st in ctx.scheduler.history[-1]["stage_info"]
              for r in st.get("merge_route", {}).values()]
    print("merge routes %s: %s" % (what, routes), flush=True)
    if not routes or any(r != "K14" for r in routes):
        fail("%s: a traced merge did not lower to K14: %s" % (what,
                                                             routes))


def tuple_reduce_path(keys, vals):
    """reduceByKey of (value, 1) pairs with a tuple merge on gpu:8: the
    merge is traced and lowered, so both sides merge through K14 and K3's
    "last" (no plain scan); checked exactly against numpy."""
    from dpark_tpu_torch import Columns, DparkContext
    ctx = DparkContext("gpu:8")
    r = (ctx.parallelize(Columns(keys, vals), 8)
         .map(lambda kv: (kv[0], (kv[1], 1)))
         .reduceByKey(_pair_sum, 8))
    with no_plain_scan("tuple reduceByKey gpu:8"):
        got = act("gpu:8 tuple reduceByKey collect", r.collect)
    check_stages(ctx, "tuple reduceByKey")
    check_merge_routes(ctx, "tuple reduceByKey")
    sums = np.bincount(keys, weights=vals, minlength=KEYS).astype(np.int64)
    lens = np.bincount(keys, minlength=KEYS)
    if len(got) != KEYS or any(
            (s_, n_) != (int(sums[k_]), int(lens[k_]))
            for k_, (s_, n_) in got):
        fail("tuple reduceByKey differs from numpy")
    ctx.stop()


# ----------------------------------------------------------------------
# K14: the traced merge's program over each run (B8)
# ----------------------------------------------------------------------
def _argmax_merge(a, b):
    return (torch.where(a[1] >= b[1], a[0], b[0]),
            torch.maximum(a[1], b[1]))


def k14_program(merge, dtypes):
    """The K14 program of `merge` over (k, (v0, v1, ...)) records with
    these value dtypes, lowered by fuse.probe_merge; fails unless the
    merge lowers."""
    from dpark_tpu_torch.backend.cuda import fuse
    specs = [(np.dtype(np.int64), ())] + [(np.dtype(d), ()) for d in dtypes]
    merge_fn = fuse.probe_merge(merge, (0, tuple(range(1, len(specs)))),
                                specs, 1)
    if merge_fn is None or merge_fn.route != "K14":
        fail("merge %s did not lower: %s" % (
            merge.__name__, merge_fn and merge_fn.route))
    return list(merge_fn.programs.values())[0][0]


def run_last(starts, n):
    """(N, cap) bool: each run's last valid row."""
    idx = torch.arange(starts.shape[1], device=starts.device)[None, :]
    nxt = torch.ones_like(starts)
    nxt[:, :-1] = starts[:, 1:]
    return (idx < n[:, None]) & (nxt | (idx == n[:, None] - 1))


def k14_case(K, label, prog, starts, n, leaves, library=True, notes=None):
    """K14 against its plain version at every run's last valid row
    (integer and bool leaves bit-equal, float leaves within
    K14_FLOAT_RTOL), timed with its plain version, its bound and, for a
    sum program over full shards, torch.segment_reduce per leaf."""
    got = K.segmented_merge(starts, n, leaves, prog)
    want = K.segmented_merge_plain(starts, n, leaves, prog)
    last = run_last(starts, n)
    runs = int(last.sum().item())
    err = rel = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g[last], w[last]
        if g.dtype.is_floating_point:
            if g.numel():
                err = max(err, float((g - w).abs().max().item()))
                rel = max(rel, float(((g - w).abs() / w.abs().clamp_min(
                    1e-300)).max().item()))
        elif not torch.equal(g, w):
            bad = (g != w).nonzero()[:5].tolist()
            fail("K14 %s: leaf %d differs from its plain version at run "
                 "ends %s" % (label, i, bad))
    if rel > K14_FLOAT_RTOL:
        fail("K14 %s: float leaf relative error %g > %g" % (
            label, rel, K14_FLOAT_RTOL))
    del got, want
    row_bytes = sum(v.element_size() * v[0, 0].numel() for v in leaves)
    rows = int(n.sum().item())
    rec = {"max_abs_err": err,
           "ms": timed(lambda: K.segmented_merge(starts, n, leaves, prog)),
           "plain_ms": timed(lambda: K.segmented_merge_plain(
               starts, n, leaves, prog), reps=3),
           # each valid row's flag and leaves read once, each run's
           # merged leaves written once
           "bound_ms": bound_ms(rows * (1 + row_bytes) + runs * row_bytes),
           "library_ms": None,
           "notes": dict({"runs": runs, "max_rel_err": "%.3g" % rel},
                         **(notes or {}))}
    if library:
        # one PyTorch call a leaf over the same runs, given their lengths
        pos = torch.nonzero(starts.view(-1)).view(-1)
        lengths = torch.diff(pos, append=torch.tensor(
            [starts.numel()], device=pos.device))
        flat = [v.view(-1) for v in leaves]
        try:
            torch.segment_reduce(flat[0][:8], "sum", lengths=torch.tensor(
                [8], device=pos.device))
            dtype_note = "native"
        except RuntimeError:
            flat = [v.double() for v in flat]
            dtype_note = "float64 copies (int64 refused)"
        rec["library_ms"] = timed(lambda: [
            torch.segment_reduce(v, "sum", lengths=lengths) for v in flat],
            reps=3)
        rec["notes"]["library"] = "segment_reduce_%s" % dtype_note.replace(
            " ", "_")
        del flat, lengths, pos
    print_phase("segmented_merge %s" % label, rec)
    return rec


def k14_phases(K, dev, b8):
    """K14 at the main paths' shape (8 x 8,388,608 rows) against its plain
    version: (a) bench keys sorted per shard (<= 65,536 runs) with the
    (v, 1) int64 add; (b) one run a shard; (c) TPC-H Q1's six leaves (5
    int64, 1 float64) over Q1's four runs a shard; (d) an argmax merge;
    (e) (a) with one shard empty.  `b8` is the plain scan of the
    vmapped merge at (a)'s shape (plain_phases)."""
    from dpark_tpu_torch.backend.cuda import collectives
    keys, vals = bench_data()
    order = np.argsort(keys.reshape(N_SHARDS, CAP), axis=1, kind="stable")
    k = torch.from_numpy(np.take_along_axis(
        keys.reshape(N_SHARDS, CAP), order, 1)).to(dev)
    v = torch.from_numpy(vals.reshape(N_SHARDS, CAP)).to(dev)
    del keys, vals, order
    ones = torch.ones_like(v)
    n = torch.full((N_SHARDS,), CAP, dtype=torch.int32, device=dev)
    starts = collectives._starts([k])
    del k
    pair = k14_program(_pair_sum, (np.int64, np.int64))
    k14_case(K, "(a) bench runs, (v, 1) add", pair, starts, n, [v, ones],
             notes={"b8_plain_scan_ms": "%.4f" % b8["ms"]})
    one = torch.zeros_like(starts)
    one[:, 0] = True
    k14_case(K, "(b) one run a shard", pair, one, n, [v, ones])
    n_e = n.clone()
    n_e[3] = 0
    k14_case(K, "(e) shard 3 empty", pair, starts, n_e, [v, ones],
             library=False)
    gen = torch.Generator(device=dev).manual_seed(20261027)
    val = torch.randn((N_SHARDS, CAP), generator=gen, device=dev,
                      dtype=torch.float64)
    idx = torch.arange(N_SHARDS * CAP, device=dev).view(N_SHARDS, CAP)
    k14_case(K, "(d) argmax", k14_program(_argmax_merge,
                                          (np.int64, np.float64)),
             starts, n, [idx, val], library=False)
    del v, ones, one, val, idx, starts
    # Q1's runs: N-O about half a shard, A-F and R-F a quarter, N-F <1%
    bounds = [0, int(CAP * 0.2477), int(CAP * 0.4954), int(CAP * 0.5037)]
    q_starts = torch.zeros((N_SHARDS, CAP), dtype=torch.bool, device=dev)
    q_starts[:, bounds] = True
    qty = torch.randint(1, 51, (N_SHARDS, CAP), generator=gen, device=dev)
    price = qty * torch.randint(90100, 209_899, (N_SHARDS, CAP),
                                generator=gen, device=dev)
    disc = torch.randint(0, 11, (N_SHARDS, CAP), generator=gen, device=dev)
    tax = torch.randint(0, 9, (N_SHARDS, CAP), generator=gen, device=dev)
    dprice = price * (100 - disc)
    leaves = [qty, price, dprice, dprice * (100 + tax), disc.double() / 100,
              torch.ones_like(qty)]
    del disc, tax
    q1 = k14_program(q1_merge, (np.int64,) * 4 + (np.float64, np.int64))
    rec = k14_case(K, "(c) tpch q1 6 leaves", q1, q_starts, n, leaves)
    del leaves, qty, price, dprice, q_starts
    torch.cuda.empty_cache()
    return {"segmented_merge": rec}


# ----------------------------------------------------------------------
# TPC-H Q1 as a dpark job: filter -> map -> reduceByKey (a six-leaf tuple
# merge over 4 hot keys) -> mapValues -> collect
# ----------------------------------------------------------------------
def q1_filter(r):
    return r[2] <= Q1_SHIP_CUTOFF


def q1_map(r):
    """((returnflag, linestatus), (quantity, base price, discounted price
    x 100, charge x 10^4, discount, 1)); prices in cents."""
    price, disc, tax = r[4], r[5], r[6]
    return ((r[0], r[1]), (r[3], price, price * (100 - disc),
                           price * (100 - disc) * (100 + tax),
                           disc / 100.0, 1))


def q1_merge(a, b):
    return tuple(x + y for x, y in zip(a, b))


def q1_outputs(v):
    """Q1's eight columns: sum_qty, sum_base_price, sum_disc_price,
    sum_charge, avg_qty, avg_price, avg_disc, count_order."""
    return (v[0], v[1], v[2], v[3], v[0] / v[5], v[1] / v[5], v[4] / v[5],
            v[5])


def q1_job(ctx, data, parts):
    """Q1 over the lineitem columns of tpch_q1_data on `parts`
    partitions; its collect gives ((flag, status), eight columns)."""
    from dpark_tpu_torch import Columns
    return (ctx.parallelize(Columns(*data), parts).filter(q1_filter)
            .map(q1_map).reduceByKey(q1_merge, parts).mapValues(q1_outputs))


def tpch_q1_data(sf=None, seed=20261026):
    """TPC-H lineitem's Q1 columns at scale factor `sf` by the
    specification's row rules (section 4.2.3), int64: (l_returnflag,
    l_linestatus, l_shipdate, l_quantity, l_extendedprice (cents),
    l_discount (percent), l_tax (percent)), flags as character codes,
    dates in days since 1992-01-01.  Its own seed: tpch_data's draws stay
    as they are.

    1,500,000 sf orders, o_orderdate uniform in [1992-01-01, 1998-08-02],
    1-7 lines each; l_shipdate = orderdate + [1, 121] days, l_receiptdate
    = shipdate + [1, 30]; l_returnflag R or A when receiptdate <=
    1995-06-17, else N; l_linestatus O when shipdate > 1995-06-17, else F;
    l_quantity in 1-50, l_discount 0-10, l_tax 0-8; l_extendedprice =
    quantity x p_retailprice of a partkey uniform in [1, 200,000 sf]."""
    sf = TPCH_SF if sf is None else sf
    rng = np.random.default_rng(seed)
    n_orders = int(1_500_000 * sf)
    odate = rng.integers(0, Q1_ORDER_LAST + 1, n_orders)
    ship = np.repeat(odate, rng.integers(1, 8, n_orders))
    del odate
    n = len(ship)
    ship += rng.integers(1, 122, n)
    receipt = ship + rng.integers(1, 31, n)
    flag = np.where(receipt <= Q1_CURRENT,
                    np.where(rng.integers(0, 2, n) == 1, ord("R"), ord("A")),
                    ord("N")).astype(np.int64)
    del receipt
    status = np.where(ship > Q1_CURRENT, ord("O"), ord("F")).astype(np.int64)
    qty = rng.integers(1, 51, n)
    partkey = rng.integers(1, int(200_000 * sf) + 1, n)
    price = qty * (90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000))
    del partkey
    return (flag, status, ship, qty, price, rng.integers(0, 11, n),
            rng.integers(0, 9, n))


def q1_numpy(data):
    """Q1 in numpy: {(flag, status): eight columns}, the sums exact in
    int64 (guarded against overflow), sum_disc a float64 sum."""
    flag, status, ship, qty, price, disc, tax = data
    keep = ship <= Q1_SHIP_CUTOFF
    dprice = price * (100 - disc)
    charge = dprice * (100 + tax)
    group = flag * 256 + status
    out = {}
    for g in np.unique(group[keep]):
        m = keep & (group == g)
        cnt = int(m.sum())
        if int(charge[m].max()) * cnt >= 2 ** 63:
            fail("q1: sum_charge could overflow int64")
        sq, sp = int(qty[m].sum()), int(price[m].sum())
        sdp, sc = int(dprice[m].sum()), int(charge[m].sum())
        sd = float((disc[m] / 100.0).sum())
        out[(int(g) // 256, int(g) % 256)] = (
            sq, sp, sdp, sc, sq / cnt, sp / cnt, sd / cnt, cnt)
    return out


def check_q1(what, got, want, rtol):
    """Q1's integer columns exactly, its float columns within rtol."""
    got = dict(got)
    if sorted(got) != sorted(want):
        fail("%s: groups %s, numpy %s" % (what, sorted(got), sorted(want)))
    for key, w in want.items():
        g = got[key]
        ints = [0, 1, 2, 3, 7]
        if any(int(g[i]) != w[i] or isinstance(g[i], float) for i in ints):
            fail("%s: group %s integer columns %s, numpy %s"
                 % (what, key, g, w))
        for i in (4, 5, 6):
            if abs(g[i] - w[i]) > rtol * abs(w[i]):
                fail("%s: group %s column %d %r, numpy %r"
                     % (what, key, i, g[i], w[i]))


def tpch_q1_path(data):
    """TPC-H Q1 on gpu:8 at SF 10: every stage on the tensor path, every
    merge K14 (no plain scan), the eight columns of each (returnflag,
    linestatus) group equal to numpy's (integer sums exactly, sum_disc
    within K14_FLOAT_RTOL)."""
    from dpark_tpu_torch import DparkContext
    ctx = DparkContext("gpu:8")
    with no_plain_scan("tpch q1 gpu:8"):
        got = act("gpu:8 tpch q1 collect",
                  q1_job(ctx, data, N_SHARDS).collect)
    check_stages(ctx, "tpch q1")
    check_merge_routes(ctx, "tpch q1")
    ctx.stop()
    want = q1_numpy(data)
    check_q1("tpch q1", got, want, K14_FLOAT_RTOL)
    for key, cols in sorted(dict(got).items()):
        print("q1 %s%s: %s" % (chr(key[0]), chr(key[1]),
                               " ".join(repr(c) for c in cols)), flush=True)


def tpch_data(sf=None, seed=20261024):
    """TPC-H orders and lineitem at scale factor `sf`, by the
    specification's row rules (section 4.2.3): (l_orderkey, revenue,
    o_orderkey, o_custkey, each line's custkey), int64.

    o_orderkey is sparse, (i // 8) * 32 + i % 8 + 1; o_custkey uniform in
    [1, 150,000 sf], never a multiple of 3; each order has 1-7 lines;
    l_partkey uniform in [1, 200,000 sf], l_quantity in 1-50,
    l_discount in 0-10 percent; p_retailprice in cents is 90000 +
    (partkey // 10) % 20001 + 100 (partkey % 1000).  revenue =
    l_extendedprice (1 - l_discount) in units of 10^-4: quantity x price
    cents x (100 - discount percent), exact in int64."""
    sf = TPCH_SF if sf is None else sf
    rng = np.random.default_rng(seed)
    n_orders = int(1_500_000 * sf)
    i = np.arange(n_orders, dtype=np.int64)
    o_orderkey = (i // 8) * 32 + i % 8 + 1
    c = rng.integers(0, int(100_000 * sf), n_orders)  # the non-multiples of 3
    o_custkey = c + c // 2 + 1
    del i, c
    lines = rng.integers(1, 8, n_orders)
    l_orderkey = np.repeat(o_orderkey, lines)
    l_custkey = np.repeat(o_custkey, lines)
    n = len(l_orderkey)
    partkey = rng.integers(1, int(200_000 * sf) + 1, n)
    price = 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)
    del partkey
    revenue = rng.integers(1, 51, n) * price * (100 - rng.integers(0, 11, n))
    return l_orderkey, revenue, o_orderkey, o_custkey, l_custkey


def _join_side(dev, keys, vals, bounds, cap):
    """(N, cap) key and value columns holding rows [bounds[s],
    bounds[s + 1]) in shard s (the sentinel in the key padding)."""
    kc = torch.full((N_SHARDS, cap), INT64_MAX, dtype=torch.int64)
    vc = torch.zeros((N_SHARDS, cap), dtype=torch.int64)
    for s in range(N_SHARDS):
        lo, hi = bounds[s], bounds[s + 1]
        kc[s, :hi - lo] = torch.from_numpy(keys[lo:hi])
        vc[s, :hi - lo] = torch.from_numpy(vals[lo:hi])
    n = torch.tensor(np.diff(bounds), dtype=torch.int32)
    return kc.to(dev), vc.to(dev), n.to(dev)


def join_case(K, A, AV, a_n, B, BV, b_n, label, library=True):
    """K12 on one pair of key-sorted sides against its plain version;
    ranges and expansion timed apart, each with its bound (the rows this
    data needs read once, every output slot written once) and its
    library calls (torch.searchsorted left and right and torch.cumsum;
    torch.searchsorted of the slots into the offsets and torch.gather)."""
    from dpark_tpu_torch.backend.cuda.layout import round_capacity
    N, cap_a = A.shape
    cap_b = B.shape[1]
    r = K.join_ranges([A], a_n, [B], b_n)
    rp = K.join_ranges_plain([A], a_n, [B], b_n)
    err = max_err([("K12 lo", r[0], rp[0]), ("K12 per", r[1], rp[1]),
                   ("K12 offs", r[2], rp[2]), ("K12 totals", r[3], rp[3])])
    total = int(r[3].sum().item())
    cap_out = round_capacity(int(r[3].max().item()) or 1)
    x = K.join_expand([A, AV], [BV], *r, a_n, cap_out)
    y = K.join_expand_plain([A, AV], [BV], *rp, a_n, cap_out)
    err = max(err, max_err([("K12 key", x[0], y[0]), ("K12 a", x[1], y[1]),
                            ("K12 b", x[2], y[2])]))
    na, nb = int(a_n.sum().item()), int(b_n.sum().item())
    valid = torch.arange(cap_a, device=A.device)[None, :] < a_n[:, None]
    t = torch.arange(cap_out, device=A.device).expand(N, cap_out) \
        .contiguous()

    def lib_ranges():
        lo = torch.searchsorted(B, A)
        hi = torch.searchsorted(B, A, right=True)
        per = torch.where(valid, hi - lo, 0)
        return lo, per, torch.cumsum(per, 1)
    lo, per, end = lib_ranges()

    def lib_expand():
        i = torch.searchsorted(end, t, right=True).clamp_(max=cap_a - 1)
        bi = (torch.gather(lo, 1, i) + t - torch.gather(end - per, 1, i)) \
            .clamp_(0, cap_b - 1)
        return (torch.gather(A, 1, i), torch.gather(AV, 1, i),
                torch.gather(BV, 1, bi))
    notes = {"a_rows": na, "b_rows": nb, "pairs": total,
             "cap_a": cap_a, "cap_b": cap_b, "cap_out": cap_out}
    recs = {
        "join_ranges": {
            "max_abs_err": err,
            "ms": timed(lambda: K.join_ranges([A], a_n, [B], b_n)),
            "plain_ms": timed(lambda: K.join_ranges_plain(
                [A], a_n, [B], b_n), reps=1),
            # both sides' valid keys read once; lo, per and offs written
            "bound_ms": bound_ms((na + nb) * 8 + 3 * nbytes(r[0])
                                 + nbytes(a_n, b_n, r[3])),
            "library_ms": timed(lib_ranges, reps=3) if library else None,
            "notes": notes},
        "join_expand": {
            "max_abs_err": err,
            "ms": timed(lambda: K.join_expand([A, AV], [BV], *r, a_n,
                                              cap_out)),
            "plain_ms": timed(lambda: K.join_expand_plain(
                [A, AV], [BV], *rp, a_n, cap_out), reps=1),
            # A's key, value, lo and offs of its valid rows and B's values
            # read once; every output slot (key, a, b) written once
            "bound_ms": bound_ms(na * 32 + nb * 8 + 3 * N * cap_out * 8
                                 + nbytes(a_n, r[3])),
            "library_ms": timed(lib_expand, reps=3) if library else None,
            "notes": notes},
    }
    for name, rec in recs.items():
        print_phase("%s %s" % (name, label), rec)
    print("phase K12 %s: ranges + expansion ms=%.4f bound_ms=%.4f" % (
        label, recs["join_ranges"]["ms"] + recs["join_expand"]["ms"],
        recs["join_ranges"]["bound_ms"] + recs["join_expand"]["bound_ms"]),
        flush=True)
    return recs


def join_kernel_phase(K, dev, data):
    """K12 at the join path's shapes: lineitem (l_orderkey, revenue) as
    side A and orders (o_orderkey, o_custkey) as side B, each shard an
    eighth of the orders and their lines, key-sorted (as the exchange and
    K5 leave them); then one hot key of SKEW_ROWS rows on each side in
    one shard of eight (SKEW_ROWS^2 pairs)."""
    from dpark_tpu_torch.backend.cuda.layout import round_capacity_fine
    lk, rev, ok, ck, _ = data
    ob = [len(ok) * s // N_SHARDS for s in range(N_SHARDS + 1)]
    lb = list(np.searchsorted(lk, ok[ob[:-1]])) + [len(lk)]
    cap_a = round_capacity_fine(int(np.diff(lb).max()))
    cap_b = round_capacity_fine(int(np.diff(ob).max()))
    A, AV, a_n = _join_side(dev, lk, rev, lb, cap_a)
    B, BV, b_n = _join_side(dev, ok, ck, ob, cap_b)
    recs = join_case(K, A, AV, a_n, B, BV, b_n, "SF %d" % TPCH_SF)
    del A, AV, a_n, B, BV, b_n
    torch.cuda.empty_cache()
    hot = np.full(SKEW_ROWS, 7, np.int64)
    vals = np.arange(SKEW_ROWS, dtype=np.int64)
    bounds = [0] + [SKEW_ROWS] * N_SHARDS
    sides = [_join_side(dev, hot, vals, bounds, SKEW_ROWS) for _ in "ab"]
    skew = join_case(K, *sides[0], *sides[1], "skew", library=False)
    if skew["join_ranges"]["notes"]["pairs"] != SKEW_ROWS ** 2:
        fail("skew: %d pairs" % skew["join_ranges"]["notes"]["pairs"])
    del sides
    torch.cuda.empty_cache()
    return recs


def join_path(data):
    """li.join(od, 8) on gpu:8 over the TPC-H tables: its count must be
    the lineitem rows; the revenue per customer (join -> map ->
    reduceByKey: Q10's shape, its predicates cut) must equal numpy's
    exactly; every stage on the tensor path.  Then a cogroup count over
    the first COGROUP_ROWS lines and their orders: the host merge, seeded
    from rows exchanged and sorted on the device (gather_rows)."""
    from dpark_tpu_torch import Columns, DparkContext
    lk, rev, ok, ck, lc = data
    ctx = DparkContext("gpu:8")
    li = ctx.parallelize(Columns(lk, rev), 8)
    od = ctx.parallelize(Columns(ok, ck), 8)
    got = act("gpu:8 join count", li.join(od, 8).count)
    check_stages(ctx, "join count")
    if got != len(lk):
        fail("join count %d, lineitem rows %d" % (got, len(lk)))
    want = np.bincount(lc, weights=rev)
    if want.max() >= 2.0 ** 53:
        fail("revenue sums reach 2**53: the float64 reference is inexact")
    got = act("gpu:8 join revenue per customer collect",
              li.join(od, 8).map(lambda kv: (kv[1][1], kv[1][0]))
              .reduceByKey(operator.add, 8).collect)
    check_stages(ctx, "join revenue")
    kinds = [s["kind"] for s in ctx.scheduler.history[-1]["stage_info"]]
    if len(kinds) != 4:
        fail("join revenue ran %d stages: %s" % (len(kinds), kinds))
    gk = np.fromiter((k for k, _ in got), np.int64, len(got))
    gv = np.fromiter((v for _, v in got), np.int64, len(got))
    present = np.nonzero(np.bincount(lc))[0]
    if not (np.array_equal(np.sort(gk), present)
            and np.array_equal(gv, want[gk].astype(np.int64))):
        fail("revenue per customer differs from numpy")
    print("join: %d lines, %d orders, %d customers with orders" % (
        len(lk), len(ok), len(present)), flush=True)
    m = COGROUP_ROWS
    mo = int(np.searchsorted(ok, lk[m - 1], side="right")) + m // 8
    cg = ctx.parallelize(Columns(lk[:m], rev[:m]), 8).cogroup(
        ctx.parallelize(Columns(ok[:mo], ck[:mo]), 8), numSplits=8)
    got = act("gpu:8 cogroup count", cg.count)
    st = ctx.scheduler.history[-1]["stage_info"]
    if got != len(np.union1d(lk[:m], ok[:mo])) or \
            st[-1].get("device_precompute") != "cogroup" or \
            any(s["kind"] != "array" for s in st[:-1]):
        fail("cogroup count %d (numpy %d): %s" % (
            got, len(np.union1d(lk[:m], ok[:mo])), st))
    ctx.stop()


# ----------------------------------------------------------------------
# the out-of-core wave stream (A12) and the spilled-run combine (B12)
# ----------------------------------------------------------------------
@contextlib.contextmanager
def plain_kernels(K, names):
    """The wrappers `names` replaced by their plain versions while the
    block runs (a composition of kernels held against the same
    composition of plain versions, on the card)."""
    saved = {n: getattr(K, n) for n in names}
    for n in names:
        setattr(K, n, getattr(K, n + "_plain"))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(K, n, fn)


def spill_kernel_phases(K, dev):
    """K13 and B12 (K13 + K5 + K2 + K3) at the spilled path's shapes: 8 x
    8,388,608 bench rows, the rid over r = SPILL_PARTS by K1's hash."""
    from dpark_tpu_torch.backend.cuda import collectives
    keys, vals = (torch.from_numpy(c.reshape(N_SHARDS, CAP)).to(dev)
                  for c in bench_data())
    n = torch.full((N_SHARDS,), CAP, dtype=torch.int32, device=dev)
    rid = K.hash_dst_hist([keys], n, SPILL_PARTS, SPILL_PARTS,
                          want_hist=False)[0]
    a = K.rid_fold(rid, n, N_SHARDS)
    b = K.rid_fold_plain(rid, n, N_SHARDS)
    err = max_err([("K13 dev", a[0], b[0]), ("K13 rid64", a[1], b[1]),
                   ("K13 hist", a[2], b[2])])
    valid = torch.arange(CAP, device=dev)[None, :] < n[:, None]
    off = torch.arange(N_SHARDS, device=dev)[:, None] * (N_SHARDS + 1)

    def library():
        d = torch.where(valid, torch.remainder(rid, N_SHARDS), N_SHARDS)
        r64 = torch.where(valid, rid.long(), INT64_MAX)
        h = torch.bincount((d + off).view(-1),
                           minlength=N_SHARDS * (N_SHARDS + 1))
        return d, r64, h
    out = {"rid_fold": {
        "max_abs_err": err,
        "ms": timed(lambda: K.rid_fold(rid, n, N_SHARDS)),
        "plain_ms": timed(lambda: K.rid_fold_plain(rid, n, N_SHARDS),
                          reps=3),
        # rid read once; dev, rid64 and the histogram written once
        "bound_ms": bound_ms(nbytes(rid, n) + nbytes(*a)),
        "library_ms": timed(library, reps=3),
        "notes": {"r": SPILL_PARTS}}}
    print_phase("rid_fold", out["rid_fold"])
    del a, b

    def b12():
        return collectives.bucketize_combine_rid(rid, [keys], [vals], n,
                                                 N_SHARDS, None,
                                                 monoid="add")
    got = b12()
    with plain_kernels(K, ["rid_fold", "radix_sort", "stable_partition",
                           "reduce_by_key_compact"]):
        want = b12()
    err = max_err([("B12 %d" % i, g, w) for i, (g, w) in
                   enumerate(zip(got[0], want[0]))]
                  + [("B12 counts", got[1], want[1]),
                     ("B12 offsets", got[2], want[2])])
    kept = int(got[1].sum().item())
    rec = {
        # a composition of kernels: held against the same composition of
        # the plain versions, no single library call
        "max_abs_err": err, "ms": timed(b12), "plain_ms": None,
        # rid, key and value read once; the kept (rid, key, value) rows
        # and the counts and offsets written once
        "bound_ms": bound_ms(nbytes(rid, keys, vals, n) + kept * 24
                             + nbytes(got[1], got[2])),
        "library_ms": None,
        "notes": {"kept_rows": kept}}
    print_phase("B12 composed of K13 + K5 + K3", rec)
    del keys, vals, rid, got, want, valid
    torch.cuda.empty_cache()
    return out


def merge_phase(K, dev):
    """B6, the reduce-side merge (collectives.segment_reduce_keys: K5
    passes by key, then K3) over 8 x 8,388,608 bench rows as an exchange
    leaves them, against the same composition of the plain versions;
    the stream's state merge (_merge_into_state) runs it once a wave."""
    from dpark_tpu_torch.backend.cuda import collectives
    keys, vals = (torch.from_numpy(c.reshape(N_SHARDS, CAP)).to(dev)
                  for c in bench_data())
    n = torch.full((N_SHARDS,), CAP, dtype=torch.int32, device=dev)

    def b6():
        return collectives.segment_reduce_keys([keys], [vals], n, None,
                                               monoid="add")
    got = b6()
    with plain_kernels(K, ["radix_sort", "reduce_by_key_compact"]):
        want = b6()
    err = max_err([("B6 keys", got[0][0], want[0][0]),
                   ("B6 vals", got[1][0], want[1][0]),
                   ("B6 n", got[2], want[2])])
    kept = int(got[2].sum().item())
    rec = {
        # a composition of kernels: held against the same composition of
        # the plain versions, no single library call
        "max_abs_err": err, "ms": timed(b6), "plain_ms": None,
        # keys and values read once, the kept rows and counts written
        "bound_ms": bound_ms(nbytes(keys, vals, n) + kept * 16
                             + nbytes(got[2])),
        "library_ms": None, "notes": {"kept_rows": kept}}
    print_phase("B6 composed of K5 + K3", rec)
    del keys, vals, got, want
    torch.cuda.empty_cache()


def check_streamed(ctx, what, stream):
    """Every stage of the last job ran without a fallback or degrade
    reason; a stage streamed into a `stream` store; a host stage only
    reads spilled runs.  Returns the streamed stage's record."""
    sts = ctx.scheduler.history[-1]["stage_info"]
    for st in sts:
        if "fallback_reason" in st or "degrade_reason" in st:
            fail("%s: a stage fell back: %s" % (what, st))
        if not st["kind"].startswith("array") and \
                st.get("reads") != "host_runs":
            fail("%s: a host stage that reads no spilled runs: %s"
                 % (what, st))
    streamed = [st for st in sts if st.get("stream") == stream]
    if not streamed:
        fail("%s: no stage streamed into a %s store: %s"
             % (what, stream, sts))
    return streamed[0]


def print_stream(label, st):
    p = st["pipeline"]
    print("stream %s: waves=%d wave_budget=%d ingest_ms=%.1f "
          "compute_ms=%.1f exchange_ms=%.1f spill_ms=%.1f wall_ms=%.1f "
          "device_idle_frac=%.4f spilled_rows=%d spill_bytes=%d "
          "per_wave=%s" % (
              label, p["waves"], st["wave_budget"], p["ingest_ms"],
              p["compute_ms"], p["exchange_ms"], p["spill_ms"],
              p["wall_ms"], p["device_idle_frac"], p["spilled_rows"],
              p["spill_bytes"], json.dumps(p["per_wave"])), flush=True)


def host_peak_rss_gib():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def wave_pairs():
    """bench.py's pairs at WAVE_PAIRS rows (16 GiB of columns at 2^30),
    halved while the host's available memory is under three times the
    columns; generated a shard slice at a time into the two columns."""
    pairs = WAVE_PAIRS
    with open("/proc/meminfo") as f:
        avail = [int(line.split()[1]) * 1024 for line in f
                 if line.startswith("MemAvailable:")][0]
    while pairs * 16 * 3 > avail:
        pairs //= 2
        print("cut: wave pairs halved to %d (host memory available %d "
              "bytes)" % (pairs, avail), flush=True)
    keys = np.empty(pairs, np.int64)
    vals = np.empty(pairs, np.int64)
    step = pairs // N_SHARDS
    for s in range(N_SHARDS):
        i = np.arange(s * step, (s + 1) * step, dtype=np.int64)
        np.multiply(i, 2654435761, out=keys[s * step:(s + 1) * step])
        keys[s * step:(s + 1) * step] %= KEYS
        np.bitwise_and(i, 0xFFFF, out=vals[s * step:(s + 1) * step])
    return keys, vals


def bench_sums(keys, vals):
    """Each key's exact int64 sum, a slice at a time."""
    sums = np.zeros(KEYS, np.int64)
    step = 1 << 24
    for lo in range(0, len(keys), step):
        sums += np.bincount(keys[lo:lo + step], weights=vals[lo:lo + step],
                            minlength=KEYS).astype(np.int64)
    return sums


def wave_path(keys, vals):
    """reduceByKey(add, 8) on gpu:8 over `keys, vals` at the auto wave
    threshold (a few waves a shard): count and collect, the collect
    exactly numpy's; the streamed combine leaves a pre_reduced store."""
    from dpark_tpu_torch import Columns, DparkContext, conf
    free, total = torch.cuda.mem_get_info()
    chunk = conf.stream_chunk_rows(16, "cuda", N_SHARDS)
    rows = len(keys) // N_SHARDS
    print("waves: %d pairs (%d bytes of columns), %d rows a shard; card "
          "memory %d bytes (%d free): auto wave threshold %d rows a shard"
          % (len(keys), 16 * len(keys), rows, total, free, chunk),
          flush=True)
    if rows <= chunk:
        fail("the wave path's input fits one wave (%d <= %d rows a shard)"
             % (rows, chunk))
    sums = bench_sums(keys, vals)
    ctx = DparkContext("gpu:8")
    r = ctx.parallelize(Columns(keys, vals), N_SHARDS).reduceByKey(
        operator.add, N_SHARDS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = act("gpu:8 reduceByKey waves count", r.count)
    first_s = time.perf_counter() - t0
    st = check_streamed(ctx, "reduceByKey waves", "pre_reduced")
    if got != KEYS:
        fail("waves count %d, want %d" % (got, KEYS))
    if st["pipeline"]["waves"] < 2:
        fail("the wave path ran %d waves" % st["pipeline"]["waves"])
    print_stream("gpu:8 reduceByKey waves", st)
    got = act("gpu:8 reduceByKey waves collect", r.collect)
    check_stages(ctx, "reduceByKey waves collect")
    gk = np.fromiter((k for k, _ in got), np.int64, len(got))
    gv = np.fromiter((v for _, v in got), np.int64, len(got))
    if len(got) != KEYS or not np.array_equal(sums[gk], gv) \
            or len(np.unique(gk)) != KEYS:
        fail("waves collect differs from numpy")
    print("waves: shuffle_GBps=%.3f peak_device_bytes=%d "
          "host_peak_rss_gib=%.2f" % (
              16 * len(keys) / first_s / 1e9,
              torch.cuda.max_memory_allocated(), host_peak_rss_gib()),
          flush=True)
    ctx.stop()


def spilled_reduce_path(keys, vals):
    """reduceByKey(add, SPILL_PARTS) and the tuple merge at SPILL_PARTS
    partitions on gpu:8, the waves pinned to SPILL_CHUNK rows a shard:
    K1's rid over r, B12 (K13, K5, K2, K3), K4, K5 + K3 pre-reduce,
    spilled runs, the host fold; both exactly numpy's."""
    from dpark_tpu_torch import Columns, DparkContext, conf
    sums = np.bincount(keys, weights=vals, minlength=KEYS).astype(np.int64)
    lens = np.bincount(keys, minlength=KEYS)
    old = conf.STREAM_CHUNK_ROWS
    conf.STREAM_CHUNK_ROWS = SPILL_CHUNK
    try:
        ctx = DparkContext("gpu:8")
        src = ctx.parallelize(Columns(keys, vals), N_SHARDS)
        torch.cuda.reset_peak_memory_stats()
        got = act("gpu:8 reduceByKey(add, %d) spilled collect"
                  % SPILL_PARTS,
                  src.reduceByKey(operator.add, SPILL_PARTS).collect)
        st = check_streamed(ctx, "reduceByKey spilled", "host_runs")
        print_stream("gpu:8 reduceByKey spilled", st)
        gk = np.fromiter((k for k, _ in got), np.int64, len(got))
        gv = np.fromiter((v for _, v in got), np.int64, len(got))
        if len(got) != KEYS or not np.array_equal(sums[gk], gv) \
                or len(np.unique(gk)) != KEYS:
            fail("spilled reduceByKey differs from numpy")
        with no_plain_scan("tuple reduceByKey spilled gpu:8"):
            got = act("gpu:8 tuple reduceByKey(%d) spilled collect"
                      % SPILL_PARTS,
                      src.map(lambda kv: (kv[0], (kv[1], 1)))
                      .reduceByKey(_pair_sum, SPILL_PARTS).collect)
        st = check_streamed(ctx, "tuple reduceByKey spilled", "host_runs")
        check_merge_routes(ctx, "tuple reduceByKey spilled")
        print_stream("gpu:8 tuple reduceByKey spilled", st)
        if len(got) != KEYS or any(
                (s_, n_) != (int(sums[k_]), int(lens[k_]))
                for k_, (s_, n_) in got):
            fail("spilled tuple reduceByKey differs from numpy")
        print("spilled reduce: peak_device_bytes=%d"
              % torch.cuda.max_memory_allocated(), flush=True)
        ctx.stop()
    finally:
        conf.STREAM_CHUNK_ROWS = old


def sort_spill_data():
    """SORT_SPILL_PAIRS (random int64 key, row index) pairs by
    sort_data's rule."""
    rng = np.random.default_rng(20261025)
    return (rng.integers(INT64_MIN, INT64_MAX, SORT_SPILL_PAIRS,
                         dtype=np.int64),
            np.arange(SORT_SPILL_PAIRS, dtype=np.int64))


def spilled_sort_path(keys, vals):
    """sortByKey(numSplits=SORT_SPILL_PARTS).collect on gpu:8 with the
    waves pinned to SORT_SPILL_CHUNK rows a shard (K6's rid over r, K13,
    K2, K4, K5 by (rid, key), runs, premerge, export): numpy's sorted
    keys, the same rows; then groupByKey(8).count (r = N: spilled runs
    a shard)."""
    from dpark_tpu_torch import Columns, DparkContext, conf
    old = conf.STREAM_CHUNK_ROWS
    conf.STREAM_CHUNK_ROWS = SORT_SPILL_CHUNK
    try:
        ctx = DparkContext("gpu:8")
        src = ctx.parallelize(Columns(keys, vals), N_SHARDS)
        torch.cuda.reset_peak_memory_stats()
        got = act("gpu:8 sortByKey(numSplits=%d) spilled collect"
                  % SORT_SPILL_PARTS,
                  src.sortByKey(numSplits=SORT_SPILL_PARTS).collect)
        st = check_streamed(ctx, "sortByKey spilled", "host_runs")
        print_stream("gpu:8 sortByKey spilled", st)
        gk = np.fromiter((kv[0] for kv in got), np.int64, len(got))
        gv = np.fromiter((kv[1] for kv in got), np.int64, len(got))
        if not np.array_equal(gk, np.sort(keys)) or \
                not np.array_equal(np.sort(gv), vals) or \
                not np.array_equal(keys[gv], gk):
            fail("spilled sortByKey differs from numpy")
        del got, gk, gv
        got = act("gpu:8 groupByKey(8) spilled count",
                  src.groupByKey(N_SHARDS).count)
        st = check_streamed(ctx, "groupByKey spilled", "host_runs")
        print_stream("gpu:8 groupByKey spilled", st)
        if got != len(np.unique(keys)):
            fail("spilled groupByKey count %d, numpy %d"
                 % (got, len(np.unique(keys))))
        print("spilled sort: peak_device_bytes=%d"
              % torch.cuda.max_memory_allocated(), flush=True)
        ctx.stop()
    finally:
        conf.STREAM_CHUNK_ROWS = old


def oom_ladder_check():
    """The out-of-memory ladder on the emulated ceiling, at a small size:
    a wave budget of 2^16 rows a shard over a ceiling of 2^15 + 2^14
    retries with 2^15, streams, records the halved budget and gives
    numpy's answer."""
    from dpark_tpu_torch import Columns, DparkContext, conf
    i = np.arange(1 << 20, dtype=np.int64)
    keys, vals = (i * 2654435761) % KEYS, i & 0xFFFF
    sums = np.bincount(keys, weights=vals, minlength=KEYS).astype(np.int64)
    old = conf.STREAM_CHUNK_ROWS, conf.EMULATED_WAVE_OOM_ROWS
    conf.STREAM_CHUNK_ROWS, conf.EMULATED_WAVE_OOM_ROWS = 1 << 16, 3 << 14
    try:
        ctx = DparkContext("gpu:8")
        got = dict(ctx.parallelize(Columns(keys, vals), N_SHARDS)
                   .reduceByKey(operator.add, N_SHARDS).collect())
        st = ctx.scheduler.history[-1]["stage_info"][0]
        ctx.stop()
    finally:
        conf.STREAM_CHUNK_ROWS, conf.EMULATED_WAVE_OOM_ROWS = old
    if got != {int(k): int(sums[k]) for k in range(KEYS)}:
        fail("the OOM ladder's answer differs from numpy")
    if not ("retried with halved wave budget (32768 rows/device)"
            in st.get("degrade_reason", "") and st["kind"] == "array"
            and st.get("wave_budget") == 1 << 15
            and st.get("stream") == "pre_reduced"):
        fail("the OOM ladder's record: %s" % st)
    print("oom ladder: %s" % st["degrade_reason"], flush=True)


def stream_paths(drive):
    """The wave stream's three paths, each driven with its own launch
    counts, then the OOM ladder's check."""
    keys, vals = wave_pairs()
    drive("reduceByKey waves gpu:8", wave_path, keys, vals)
    del keys, vals
    keys, vals = bench_data()
    drive("reduceByKey spilled gpu:8", spilled_reduce_path, keys, vals)
    del keys, vals
    skeys, svals = sort_spill_data()
    drive("sort spilled gpu:8", spilled_sort_path, skeys, svals)
    del skeys, svals
    oom_ladder_check()
    from dpark_tpu_torch import Columns, conf
    keys, vals = bench_data()
    old = conf.STREAM_CHUNK_ROWS
    conf.STREAM_CHUNK_ROWS = SPILL_CHUNK
    try:
        profile_first_action(
            "gpu:8 reduceByKey(add, %d) spilled count" % SPILL_PARTS,
            lambda ctx: ctx.parallelize(Columns(keys, vals), N_SHARDS)
            .reduceByKey(operator.add, SPILL_PARTS).count)
    finally:
        conf.STREAM_CHUNK_ROWS = old


def column_ranges_phase(K, dev):
    """K15 at the main shape: 8 x 8,388,608 random int64 rows, ragged
    counts over key-sentinel padding, shard 3 empty; bound = the valid
    rows' bytes; library = torch.aminmax over each shard's valid slice."""
    rng = np.random.default_rng(20261029)
    col = torch.from_numpy(rng.integers(INT64_MIN, INT64_MAX,
                                        (N_SHARDS, CAP), dtype=np.int64))
    n_host = np.array([CAP - s * (CAP // 16) for s in range(N_SHARDS)],
                      np.int32)
    n_host[3] = 0
    col[torch.arange(CAP)[None, :] >= torch.from_numpy(n_host)[:, None]] = \
        K.KEY_SENTINEL
    col = col.to(dev)
    n = torch.from_numpy(n_host).to(dev)
    a = K.column_ranges([col], n)
    b = K.column_ranges_plain([col], n)
    err = max_err([("K15 ranges", a, b)])
    host = col.cpu().numpy()
    for s in range(N_SHARDS):
        want = ([INT64_MAX, INT64_MIN] if not n_host[s] else
                [host[s, :n_host[s]].min(), host[s, :n_host[s]].max()])
        if a[0, s].tolist() != want:
            fail("K15 shard %d: %s, numpy %s" % (s, a[0, s].tolist(), want))

    def library():
        return [torch.aminmax(col[s, :int(n_host[s])])
                for s in range(N_SHARDS) if n_host[s]]
    rec = {"max_abs_err": err,
           "ms": timed(lambda: K.column_ranges([col], n)),
           "plain_ms": timed(lambda: K.column_ranges_plain([col], n),
                             reps=3),
           "bound_ms": bound_ms(int(n_host.sum()) * 8),
           "library_ms": timed(library),
           "notes": {"valid_rows": int(n_host.sum())}}
    print_phase("column_ranges", rec)
    del col, a, b, host
    torch.cuda.empty_cache()
    return {"column_ranges": rec}


def wordcount_vocab(seed=20261027):
    """VOCAB_WORDS distinct lowercase ASCII words of 3-10 letters in a
    seeded order, as (letters (V, 10) uint8, NUL past each word; lengths
    (V,))."""
    rng = np.random.default_rng(seed)
    m = VOCAB_WORDS * 5 // 4
    lens = rng.integers(3, 11, m)
    letters = rng.integers(97, 123, (m, 10), dtype=np.uint8)
    letters[np.arange(10)[None, :] >= lens[:, None]] = 0
    words = np.unique(letters.view("S10").ravel())
    if len(words) < VOCAB_WORDS:
        fail("vocabulary: %d distinct words" % len(words))
    words = words[rng.permutation(len(words))[:VOCAB_WORDS]]
    table = np.frombuffer(words.astype("S10").tobytes(),
                          np.uint8).reshape(-1, 10)
    return table, (table != 0).sum(1)


def corpus_chunk(table, lens, c):
    """Chunk c of the corpus: CORPUS_CHUNK_LINES lines of WORDS_PER_LINE
    words, each word's rank r in [0, V) drawn as floor((V + 1)^u) - 1, u
    uniform (P(r) = ln((r + 2) / (r + 1)) / ln(V + 1): Zipf's law with
    exponent 1); returns (bytes as uint8, the ranks)."""
    rng = np.random.default_rng([20261028, c])
    n = CORPUS_CHUNK_LINES * WORDS_PER_LINE
    ids = np.floor(np.exp(rng.random(n) * math.log(VOCAB_WORDS + 1)))
    ids = np.clip(ids.astype(np.int64) - 1, 0, VOCAB_WORDS - 1)
    wl = lens[ids]
    rec = np.zeros((n, 11), np.uint8)
    rec[:, :10] = table[ids]
    sep = np.full(n, ord(" "), np.uint8)
    sep[WORDS_PER_LINE - 1::WORDS_PER_LINE] = ord("\n")
    rec[np.arange(n), wl] = sep
    return rec[np.arange(11)[None, :] <= wl[:, None]], ids


def wordcount_corpus(path):
    """Write WORDCOUNT_BYTES of corpus (through the first line end at or
    past it) to `path`, its chunks generated on 8 threads; returns each
    vocabulary word's count and the vocabulary (wordcount_vocab's
    letters)."""
    t0 = time.perf_counter()
    table, lens = wordcount_vocab()
    counts = np.zeros(VOCAB_WORDS, np.int64)
    written = 0
    with open(path, "wb") as f, \
            concurrent.futures.ThreadPoolExecutor(8) as pool:
        pending = collections.deque(
            pool.submit(corpus_chunk, table, lens, c) for c in range(8))
        c = 8
        while written < WORDCOUNT_BYTES:
            buf, ids = pending.popleft().result()
            pending.append(pool.submit(corpus_chunk, table, lens, c))
            c += 1
            need = WORDCOUNT_BYTES - written
            if len(buf) > need:
                end = need - 1 + int(np.flatnonzero(buf[need - 1:] == 10)[0])
                buf = buf[:end + 1]
                ids = ids[:int(np.count_nonzero((buf == 32) | (buf == 10)))]
            buf.tofile(f)
            written += len(buf)
            counts += np.bincount(ids, minlength=VOCAB_WORDS)
        for fut in pending:
            fut.cancel()
    print("wordcount corpus: %d bytes, %d words, %d distinct, generated "
          "in %.1f s" % (written, int(counts.sum()),
                         int(np.count_nonzero(counts)),
                         time.perf_counter() - t0), flush=True)
    return counts, table


def wordcount_path(path, counts, table):
    """HiBench's wordcount on gpu:8: textFile -> flatMap(split) -> map((w,
    1)) -> reduceByKey(add), then top(10) by count and collect, each equal
    to numpy's counts of the drawn words; the map stage must read the
    text through the canonical C++ tokenizer in waves (above
    conf.STREAM_TEXT_BYTES) with no fallback reason."""
    from dpark_tpu_torch import DparkContext
    ctx = DparkContext("gpu:8")
    r = (ctx.textFile(path).flatMap(lambda line: line.split())
         .map(lambda w: (w, 1)).reduceByKey(operator.add))
    nsplits = len(ctx.textFile(path).splits)
    top = act("wordcount gpu:8 top", lambda: r.top(10, key=lambda kv: kv[1]))
    check_stages(ctx, "wordcount top")
    st = ctx.scheduler.history[-1]["stage_info"][0]
    text = st.get("text", {})
    pipe = st.get("pipeline", {})
    if not (st.get("source") == "text" and text.get("canonical")
            and text["cpp_splits"] == nsplits
            and not text["prologue_splits"]
            and pipe.get("waves", 0) >= 2
            and st.get("stream") == "pre_reduced"):
        fail("wordcount map stage: %s" % st)
    print("wordcount gpu:8: splits=%d cpp_splits=%d tokenize_ms=%.1f "
          "waves=%d ingest_ms=%.1f compute_ms=%.1f exchange_ms=%.1f "
          "wall_ms=%.1f device_idle_frac=%.4f" % (
              nsplits, text["cpp_splits"], text["tokenize_ms"],
              pipe["waves"], pipe["ingest_ms"], pipe["compute_ms"],
              pipe["exchange_ms"], pipe["wall_ms"],
              pipe["device_idle_frac"]), flush=True)
    words = table.view("S10").ravel()
    order = np.argsort(-counts, kind="stable")[:10]
    want = [(words[i].decode(), int(counts[i])) for i in order]
    if top != want:
        fail("wordcount top differs from numpy: %s, want %s" % (top, want))
    got = act("wordcount gpu:8 collect", r.collect)
    check_stages(ctx, "wordcount collect")
    nz = np.flatnonzero(counts)
    if len(got) != len(nz) or dict(got) != {
            words[i].decode(): int(counts[i]) for i in nz.tolist()}:
        fail("wordcount collect differs from numpy (%d rows, want %d)"
             % (len(got), len(nz)))
    print("wordcount gpu:8: %d words, top %s" % (len(got), top[:3]),
          flush=True)
    ctx.stop()


def narrow_timings(keys, vals, q1):
    """The first action of the reduceByKey gpu:8 count and of the Q1
    collect with the host-to-device wire narrowed (conf.NARROW_EXCHANGE
    on) and at int64, in the order off, on, on, off, a fresh context
    each."""
    from dpark_tpu_torch import Columns, DparkContext, conf
    jobs = (("reduceByKey gpu:8 count", lambda ctx: ctx.parallelize(
                Columns(keys, vals), N_SHARDS).reduceByKey(
                    operator.add, N_SHARDS).count),
            ("tpch q1 collect", lambda ctx: q1_job(ctx, q1,
                                                   N_SHARDS).collect))
    old = conf.NARROW_EXCHANGE
    try:
        for label, build in jobs:
            secs, results = [], []
            for on in (False, True, True, False):
                conf.NARROW_EXCHANGE = on
                ctx = DparkContext("gpu:8")
                action = build(ctx)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                results.append(action())
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                check_stages(ctx, "narrow " + label)
                ctx.stop()
            if any(res != results[0] for res in results):
                fail("narrow %s: results differ off and on" % label)
            print("narrow %s: off=%.3f on=%.3f on=%.3f off=%.3f s" % (
                (label,) + tuple(secs)), flush=True)
    finally:
        conf.NARROW_EXCHANGE = old


def text_paths(drive, K, dev):
    """K15's phase, the reduceByKey gpu:8 path with its ranged-int top,
    the narrowing on/off timings and the wordcount path.  Returns K15's
    phase record."""
    phase = column_ranges_phase(K, dev)
    keys, vals = bench_data()
    drive("reduceByKey gpu:8", main_path, "gpu:8", keys, vals)
    t0 = time.perf_counter()
    q1 = tpch_q1_data()
    print("tpch q1: SF %d, %d lines, generated in %.1f s" % (
        TPCH_SF, len(q1[0]), time.perf_counter() - t0), flush=True)
    narrow_timings(keys, vals, q1)
    del keys, vals, q1
    wordcount_drive(drive)
    return phase


def wordcount_drive(drive):
    """Generate the corpus under build/ (ignored by git), drive the
    wordcount path, remove the corpus."""
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "smoke_wordcount")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "corpus.txt")
    try:
        counts, table = wordcount_corpus(path)
        drive("wordcount gpu:8", wordcount_path, path, counts, table)
    finally:
        if os.path.exists(path):
            os.remove(path)


def profile_window(label, window, top=14):
    """Where the time of one window of device work goes, under
    torch.profiler: the wall time, the summed device time and the ops
    with the most device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        window()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, memcpys): a host op's device time
    # would count its kernels twice.  Summed from the event list, which
    # holds events that key_averages() of a process's later profiles
    # drops; even the list can miss a later window's first device events
    # (a join count's first ingest), so such a window's idle share is an
    # upper bound
    per_name = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us, n = per_name.get(ev.name, (0.0, 0))
        per_name[ev.name] = (us + ev.time_range.elapsed_us(), n + 1)
    rows = sorted(((us, name, n) for name, (us, n) in per_name.items()
                   if us), reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
    # K5's kernels: the histogram pass and the one-sweep digit passes
    k5 = sum(r[0] for r in rows if "k5_" in r[1]) / 1e3
    print("profile %s: wall_ms=%.1f device_busy_ms=%.1f "
          "idle_share=%.3f k5_ms=%.1f k5_share=%.3f" % (
              label, wall * 1e3, busy, 1 - busy / (wall * 1e3), k5,
              k5 / busy if busy else 0.0))
    for dev_us, name, count in rows[:top]:
        print("profile  %9.3f ms  x%-4d %s" % (dev_us / 1e3, count,
                                                name[:90]))


def profile_first_action(label, build, top=14):
    """Where the time of one first action goes (profile_window).
    build(ctx) returns the action to run."""
    from dpark_tpu_torch import DparkContext
    ctx = DparkContext("gpu:8")
    action = build(ctx)
    profile_window(label, action, top)
    ctx.stop()


def check_launches(path, fn, *args):
    """One path's run with the launch counts set to 0 just before it and
    read just after; every kernel of the path must launch.  Returns the
    counts."""
    from dpark_tpu_torch.backend.cuda import kernels as K
    K.reset_launches()
    need = fn(*args)
    got = dict(K.LAUNCHES)
    print("launches %s: %s" % (path, json.dumps(got)), flush=True)
    missing = [k for k in PATH_KERNELS[path] if not got[k]]
    if missing:
        fail("kernels not launched on the %s path: %s" % (path, missing))
    mins = dict(PATH_MIN_LAUNCHES.get(path, {}), **(need or {}))
    for k, least in mins.items():
        if got[k] < least:
            fail("%s launched %d times on the %s path, want >= %d"
                 % (k, got[k], path, least))
    return got


# ---------------------------------------------------------------------
# the device union source (B16, K16) and DStream windows and state (A14)
# ---------------------------------------------------------------------
UNION_CAP = 1 << 20                # rows a shard a branch, k = 12 phase
UNION_BRANCHES = 12                # the reference's MAX_UNION_SOURCES
UNION_PATH_ROWS = PAIRS // 2 // N_SHARDS     # 4,194,304: a half a shard
# the Spark Streaming Programming Guide's "Window Operations" example:
# reduceByKeyAndWindow(_ + _, _ - _, Seconds(30), Seconds(10)) over
# batches of 1 s of the manual clock
WINDOW_LEN = 30.0
WINDOW_SLIDE = 10.0
WINDOW_BATCHES = 40
WINDOW_ROWS = 1 << 20              # (word id, 1) pairs a shard a batch
DECAY_BATCHES = 3                  # the decayed counter's depth cut
DECAY = 0.9                        # 0.9 * prev + sum(vs)
DECAY_RTOL = 1e-12
STREAM_T0 = 1000.0


def union_case(K, branches, label):
    """K16 on `branches` against its plain version (bit-equal); library:
    none (no one torch call packs ragged per-shard prefixes); the torch
    composite (torch.cat of every shard's slices, after the same host
    read) is timed beside it."""
    a = K.union_concat(branches)
    b = K.union_concat_plain(branches)
    err = max_err([("K16 %s leaf %d" % (label, i), x, y)
                   for i, (x, y) in enumerate(zip(a[0], b[0]))]
                  + [("K16 %s totals" % label, a[1], b[1])])
    counts = torch.stack([n for _, n in branches]).cpu().tolist()
    rows = sum(sum(c) for c in counts)
    row_bytes = sum(leaf.element_size() for leaf in branches[0][0])
    N, cap_out = a[0][0].shape[:2]
    nl = len(branches[0][0])

    def composite():
        hc = torch.stack([n for _, n in branches]).cpu().tolist()
        return [torch.cat([lv[li][s, :hc[j][s]]
                           for j, (lv, _) in enumerate(branches)])
                for li in range(nl) for s in range(N)]
    return {
        "max_abs_err": err,
        "ms": timed(lambda: K.union_concat(branches)),
        "plain_ms": timed(lambda: K.union_concat_plain(branches), reps=3),
        # every valid row read once, every output row (tails included)
        # written once, the counts read and the totals written
        "bound_ms": bound_ms(rows * row_bytes + N * cap_out * row_bytes
                             + 4 * N * (len(branches) + 1)),
        "library_ms": None,
        "notes": {"k": len(branches), "rows": rows, "cap_out": cap_out,
                  "torch_cat_ms": "%.4f" % timed(composite, reps=3)},
    }


def union_kernel_phases(K, dev):
    """K16 against its plain version: k = 12 branches over 8 shards of
    cap 2^20 with ragged counts, shard 3 empty in every branch and branch
    5 empty, int64/int64/float64 leaves; then k = 2 at 8 x 4,194,304
    rows, the union path's shape (bench.py's halves, full counts)."""
    rng = np.random.default_rng(20261031)
    counts = rng.integers(0, UNION_CAP + 1, (UNION_BRANCHES, N_SHARDS))
    counts[:, 3] = 0
    counts[5, :] = 0
    branches = []
    for j in range(UNION_BRANCHES):
        lv = [torch.from_numpy(rng.integers(0, KEYS, (N_SHARDS, UNION_CAP),
                                            dtype=np.int64)).to(dev),
              torch.from_numpy(rng.integers(0, 1 << 16,
                                            (N_SHARDS, UNION_CAP),
                                            dtype=np.int64)).to(dev),
              torch.from_numpy(rng.standard_normal(
                  (N_SHARDS, UNION_CAP))).to(dev)]
        branches.append((lv, torch.from_numpy(
            counts[j].astype(np.int32)).to(dev)))
    out = {}
    rec = union_case(K, branches, "k=12")
    print_phase("union_concat k=12", rec)
    del branches
    torch.cuda.empty_cache()
    keys, vals = (torch.from_numpy(c.reshape(2, N_SHARDS, UNION_PATH_ROWS))
                  .to(dev) for c in bench_data())
    n = torch.full((N_SHARDS,), UNION_PATH_ROWS, dtype=torch.int32,
                   device=dev)
    branches = [([keys[h].contiguous(), vals[h].contiguous()], n)
                for h in range(2)]
    del keys, vals
    out["union_concat"] = union_case(K, branches, "k=2")
    print_phase("union_concat", out["union_concat"])
    del branches
    torch.cuda.empty_cache()
    return out


def zipf_ids(n, seed):
    """n word ids of the wordcount vocabulary drawn under Zipf's law
    (corpus_chunk's rule: rank floor((V + 1)^u) - 1, u uniform)."""
    rng = np.random.default_rng(seed)
    ids = np.floor(np.exp(rng.random(n) * math.log(VOCAB_WORDS + 1)))
    return np.clip(ids.astype(np.int64) - 1, 0, VOCAB_WORDS - 1)


def window_batches(count):
    """The stream's batches: `count` x 8 x 1,048,576 word ids."""
    return [zipf_ids(N_SHARDS * WINDOW_ROWS, [20261030, b])
            for b in range(count)]


def state_gather_phase(K, dev):
    """K8's state gather against its plain version at one tick of the
    decayed counter: batch 2's 8,388,608 new values (flag 0) and the
    state of batch 1's distinct words (flag 1), split over 8 shards by
    key and key-sorted (K7 and K2 give the table and the class members),
    every non-empty size class in the "zero" pad; times summed over the
    classes.  The "edge" pad is held on the widest class."""
    from dpark_tpu_torch.backend.cuda import collectives as C
    from dpark_tpu_torch.backend.cuda.layout import round_capacity
    b0, b1 = window_batches(2)
    state_keys, state_counts = np.unique(b0, return_counts=True)
    keys = np.concatenate([b1, state_keys])
    flags = np.concatenate([np.zeros(len(b1), np.int64),
                            np.ones(len(state_keys), np.int64)])
    vals = np.concatenate([np.ones(len(b1)),
                           0.9 * state_counts.astype(np.float64)])
    shard = keys % N_SHARDS
    order = np.lexsort((keys, shard))
    per = np.bincount(shard, minlength=N_SHARDS)
    cap = round_capacity(int(per.max()))
    kt = np.full((N_SHARDS, cap), INT64_MAX, np.int64)
    ft = np.zeros((N_SHARDS, cap), np.int64)
    vt = np.zeros((N_SHARDS, cap), np.float64)
    at = 0
    for s in range(N_SHARDS):
        idx = order[at:at + per[s]]
        kt[s, :per[s]], ft[s, :per[s]], vt[s, :per[s]] = \
            keys[idx], flags[idx], vals[idx]
        at += per[s]
    kt, ft, vt = (torch.from_numpy(a).to(dev) for a in (kt, ft, vt))
    n = torch.from_numpy(per.astype(np.int32)).to(dev)
    start_rows, sizes, bucket, _, hist, _ = K.segment_table([kt], n,
                                                            want_keys=False)
    members, counts, offsets = C.bucket_members(bucket)
    gmax = hist.cpu().numpy().max(0)
    rec = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
           "library_ms": None}
    lanes = classes = 0
    widest = None
    for b in np.flatnonzero(gmax).tolist():
        G, B = round_capacity(int(gmax[b])), 1 << b
        boff, bcnt = offsets[:, b].contiguous(), counts[:, b].contiguous()
        args = (start_rows, sizes, members, boff, bcnt, G, B, vt, ft)
        x = K.bucket_gather_state(*args, "zero")
        y = K.bucket_gather_state_plain(*args, "zero")
        rec["max_abs_err"] = max(rec["max_abs_err"], max_err(
            [("K8 state class %d out" % b, x[0], y[0]),
             ("K8 state class %d prev" % b, x[1], y[1]),
             ("K8 state class %d has_prev" % b, x[2], y[2])]))
        rec["ms"] += timed(lambda: K.bucket_gather_state(*args, "zero"),
                           reps=3)
        rec["plain_ms"] += timed(
            lambda: K.bucket_gather_state_plain(*args, "zero"), reps=1)
        live = int(bcnt.sum().item())
        rows = int(sizes.gather(1, members.long()).masked_fill(
            ~valid_lanes(members, boff, bcnt), 0).sum().item())
        # each group's values and flags read once, member id, start row
        # and size per lane; the padded matrix, prev and has_prev written
        rec["bound_ms"] += bound_ms(rows * (8 + 8) + live * 12
                                    + nbytes(*x) + nbytes(boff, bcnt))
        lanes += live
        classes += 1
        widest = args
    x = K.bucket_gather_state(*widest, "edge")
    y = K.bucket_gather_state_plain(*widest, "edge")
    rec["max_abs_err"] = max(rec["max_abs_err"], max_err(
        [("K8 state edge out", x[0], y[0]), ("K8 state edge prev", x[1],
                                             y[1])]))
    rec["notes"] = {"rows": len(keys), "groups": int(len(np.unique(keys))),
                    "classes": classes, "lanes": lanes,
                    "widest_B": widest[6]}
    print_phase("bucket_gather_state", rec)
    del kt, ft, vt, start_rows, sizes, bucket, members, x, y
    torch.cuda.empty_cache()
    return {"bucket_gather_state": rec}


def union_path(keys, vals):
    """The device union on gpu:8 over bench.py's pairs split in two halves
    of 32Mi: a.union(b).reduceByKey(add, 8) -> count, then (fresh) ->
    collect, and a.reduceByKey(add, 8).union(b.reduceByKey(add, 8))
    .reduceByKey(add, 8) -> collect, each exactly numpy's, every stage on
    the tensor path, each action launching K16."""
    from dpark_tpu_torch import Columns, DparkContext
    from dpark_tpu_torch.backend.cuda import kernels as K
    half = PAIRS // 2
    sums = np.bincount(keys, weights=vals, minlength=KEYS).astype(np.int64)
    ctx = DparkContext("gpu:8")

    def halves():
        return (ctx.parallelize(Columns(keys[:half], vals[:half]),
                                N_SHARDS),
                ctx.parallelize(Columns(keys[half:], vals[half:]),
                                N_SHARDS))

    def run(label, fn):
        before = K.LAUNCHES["union_concat"]
        res = act(label, fn)
        check_stages(ctx, label)
        if K.LAUNCHES["union_concat"] <= before:
            fail("%s launched no K16" % label)
        return res

    def check(label, got):
        gk = np.array([k for k, _ in got], np.int64)
        gv = np.array([v for _, v in got], np.int64)
        if len(got) != KEYS or len(np.unique(gk)) != KEYS \
                or not np.array_equal(sums[gk], gv):
            fail("%s differs from numpy" % label)
    a, b = halves()
    if run("union gpu:8 count", a.union(b).reduceByKey(
            operator.add, N_SHARDS).count) != KEYS:
        fail("union count")
    a, b = halves()
    check("union gpu:8 collect", run("union gpu:8 collect", a.union(
        b).reduceByKey(operator.add, N_SHARDS).collect))
    a, b = halves()
    r = a.reduceByKey(operator.add, N_SHARDS).union(
        b.reduceByKey(operator.add, N_SHARDS)).reduceByKey(operator.add,
                                                           N_SHARDS)
    check("union of reduced gpu:8 collect",
          run("union of reduced gpu:8 collect", r.collect))
    ctx.stop()


def decayed_update(vs, prev):
    base = 0.0 if prev is None else prev
    return DECAY * base + sum(vs)


def running_sum(vs, prev):
    return (prev or 0) + sum(vs)


def window_want(counts, lo, hi):
    """Per word, the occurrences over batches lo..hi-1."""
    return counts[hi] - counts[lo]


def check_counts(label, got, want, zeros_ok):
    """got ((word, count) rows) equals want's non-zero words exactly; with
    zeros_ok, extra rows of count 0 (the invertible window's keys whose
    count fell to zero) are allowed."""
    gk = np.fromiter((kv[0] for kv in got), np.int64, len(got))
    gv = np.fromiter((kv[1] for kv in got), np.int64, len(got))
    nz = np.flatnonzero(want)
    if len(np.unique(gk)) != len(gk) or not np.array_equal(want[gk], gv) \
            or not np.isin(nz, gk).all() \
            or (not zeros_ok and len(gk) != len(nz)):
        fail("%s differs from numpy (%d rows, want %d non-zero)"
             % (label, len(got), len(nz)))


def stream_output(ctx, name, check, union_ticks, state=False):
    """A foreachRDD function collecting one output each tick: its wall,
    the launches of K16 and K8's state gather in it, the device memory
    and the executor's store count; every stage on the tensor path, K16
    on every union tick, the state gather on every tick of the state
    mode."""
    from dpark_tpu_torch.backend.cuda import kernels as K

    def out(rdd, t):
        tick = int(round(t - STREAM_T0))
        before = dict(K.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = rdd.collect()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {k: K.LAUNCHES[k] - before[k] for k in before}
        check_stages(ctx, "window %s t=%d" % (name, tick))
        if union_ticks(tick) and not launched["union_concat"]:
            fail("window %s t=%d: no K16 launch" % (name, tick))
        if state and not launched["bucket_gather_state"]:
            fail("window %s t=%d: no state gather launch" % (name, tick))
        check(tick, got)
        ex = ctx.scheduler.executor
        print("window %s t=%d: wall_s=%.3f rows=%d k16=%d state_gather=%d "
              "hbm_allocated_gib=%.3f stores=%d resident_gib=%.3f "
              "on_device=%d spilled=%d" % (
                  name, tick, wall, len(got), launched["union_concat"],
                  launched["bucket_gather_state"],
                  torch.cuda.memory_allocated() / 2 ** 30,
                  len(ex.shuffle_store), ex.resident_bytes / 2 ** 30,
                  *store_split(ex)), flush=True)
    return out


def store_split(ex):
    """(stores on the device, stores spilled to host runs)."""
    spilled = sum("host_runs" in m for m in ex.shuffle_store.values())
    return len(ex.shuffle_store) - spilled, spilled


def check_budget(ex, what):
    """The device-resident store bytes are at or under the budget, unless
    the newest store alone is left on the device."""
    from dpark_tpu_torch import conf
    budget = conf.shuffle_hbm_budget(ex.device)
    on_device, _ = store_split(ex)
    if ex.resident_bytes > budget and on_device > 1:
        fail("%s: %d stores hold %d bytes on the device, over the %d-byte "
             "budget" % (what, on_device, ex.resident_bytes, budget))
    return budget


def window_path(batches):
    """BASELINE.json config 5 on gpu:8: a queue stream of Columns batches
    of 8,388,608 (word id, 1) pairs, 1 s of the manual clock each, with
    reduceByKeyAndWindow(add, 30, 10, invFunc=sub) (the pane plane's
    union-reduce: prev + new pane - expired pane), the same without
    invFunc (the flat pane union below STREAM_PANE_TREE_MIN), and
    updateStateByKey as a running sum (the union-reduce rewrite) over
    WINDOW_BATCHES batches; then the decayed counter 0.9 * prev + sum(vs)
    (the state mode) over the first DECAY_BATCHES, on a fresh context.
    Every output is checked each tick against numpy (counts exactly,
    the decayed counter within DECAY_RTOL relative)."""
    from dpark_tpu_torch import Columns, DparkContext
    from dpark_tpu_torch.dstream import StreamingContext
    ones = np.ones(N_SHARDS * WINDOW_ROWS, np.int64)
    cum = np.zeros((len(batches) + 1, VOCAB_WORDS), np.int64)
    for i, ids in enumerate(batches):
        cum[i + 1] = cum[i] + np.bincount(ids, minlength=VOCAB_WORDS)
    slide, win = int(WINDOW_SLIDE), int(WINDOW_LEN)

    def emits(tick):
        return tick % slide == 0

    ctx = DparkContext("gpu:8")
    ssc = StreamingContext(ctx, 1.0)
    q = ssc.queueStream([ctx.parallelize(Columns(ids, ones), N_SHARDS)
                         for ids in batches])

    def check_window(zeros_ok):
        def check(tick, got):
            check_counts("window t=%d" % tick, got,
                         window_want(cum, max(0, tick - win), tick),
                         zeros_ok)
        return check
    q.reduceByKeyAndWindow(operator.add, WINDOW_LEN, WINDOW_SLIDE,
                           numSplits=N_SHARDS, invFunc=operator.sub) \
        .foreachRDD(stream_output(ctx, "inv", check_window(True), emits))
    q.reduceByKeyAndWindow(operator.add, WINDOW_LEN, WINDOW_SLIDE,
                           numSplits=N_SHARDS) \
        .foreachRDD(stream_output(ctx, "noninv", check_window(False),
                                  emits))
    q.updateStateByKey(running_sum, numSplits=N_SHARDS).foreachRDD(
        stream_output(ctx, "running sum", lambda tick, got: check_counts(
            "running sum t=%d" % tick, got, cum[tick], False),
            lambda tick: tick > 1))
    ctx.start()
    ex = ctx.scheduler.executor
    ssc.zero_time = STREAM_T0
    for k in range(1, len(batches) + 1):
        t0 = time.perf_counter()
        ssc.run_batch(STREAM_T0 + k)
        wall = time.perf_counter() - t0
        budget = check_budget(ex, "window tick %d" % k)
        print("window tick %d: %.3f s resident_gib=%.3f budget_gib=%.3f "
              "on_device=%d spilled=%d spill_s=%.3f" % (
                  k, wall, ex.resident_bytes / 2 ** 30, budget / 2 ** 30,
                  *store_split(ex), sum(sp["seconds"] for sp in ex.spills)),
              flush=True)
    ssc.stop()
    ctx.stop()
    torch.cuda.empty_cache()

    decay = np.zeros(VOCAB_WORDS)

    def check_decay(tick, got):
        nonlocal decay
        decay = DECAY * decay + (cum[tick] - cum[tick - 1])
        gk = np.fromiter((kv[0] for kv in got), np.int64, len(got))
        gv = np.fromiter((kv[1] for kv in got), np.float64, len(got))
        seen = np.flatnonzero(cum[tick])
        if len(gk) != len(seen) or not np.array_equal(np.sort(gk), seen) \
                or not np.allclose(gv, decay[gk], rtol=DECAY_RTOL, atol=0):
            fail("decayed counter t=%d differs from numpy" % tick)
    ctx = DparkContext("gpu:8")
    ssc = StreamingContext(ctx, 1.0)
    q = ssc.queueStream([ctx.parallelize(Columns(ids, ones), N_SHARDS)
                         for ids in batches[:DECAY_BATCHES]])
    q.updateStateByKey(decayed_update, numSplits=N_SHARDS).foreachRDD(
        stream_output(ctx, "decayed", check_decay, lambda tick: tick > 1,
                      state=True))
    ctx.start()
    ssc.zero_time = STREAM_T0
    for k in range(1, DECAY_BATCHES + 1):
        t0 = time.perf_counter()
        ssc.run_batch(STREAM_T0 + k)
        print("decay tick %d: %.3f s" % (k, time.perf_counter() - t0),
              flush=True)
    ssc.stop()
    ctx.stop()
    torch.cuda.empty_cache()


EVICT_JOBS = 4
EVICT_PAIRS = PAIRS // 2           # 32Mi bench pairs a job: a 0.5 GiB store
EVICT_BUDGET = 1 << 30


def evict_data(j):
    """Job j's bench pairs: rows [j, j + 1) * EVICT_PAIRS of bench.py's
    formula."""
    i = np.arange(j * EVICT_PAIRS, (j + 1) * EVICT_PAIRS, dtype=np.int64)
    return (i * 2654435761) % KEYS, i & 0xFFFF


def evict_path():
    """One budget over the shuffle stores: EVICT_JOBS partitionBy(8)
    counts of 32Mi bench pairs each on gpu:8 under a pinned budget of 1
    GiB (two stores).  After each job: the device-resident bytes, the
    stores spilled (each spill's ms and GB/s) and the memory allocated;
    the resident bytes stay at or under the budget, and the spilled
    stores' memory is freed (allocated after the fourth job within 0.25
    GiB of that after the second).  Then the first (spilled) shuffle's
    collect, read from its host runs, equals numpy's rows exactly."""
    from dpark_tpu_torch import Columns, DparkContext, conf
    old = conf.SHUFFLE_HBM_BUDGET
    conf.SHUFFLE_HBM_BUDGET = EVICT_BUDGET
    ctx = DparkContext("gpu:8")
    try:
        ctx.start()
        ex = ctx.scheduler.executor
        rdds, alloc = [], []
        for j in range(EVICT_JOBS):
            k, v = evict_data(j)
            r = ctx.parallelize(Columns(k, v), N_SHARDS).partitionBy(N_SHARDS)
            del k, v
            seen = len(ex.spills)
            if act("gpu:8 evict partitionBy(8) count, job %d" % (j + 1),
                   r.count) != EVICT_PAIRS:
                fail("evict job %d: count" % (j + 1))
            check_stages(ctx, "evict job %d" % (j + 1))
            for sp in ex.spills[seen:]:
                print("evict spill: shuffle %d bytes=%d rows=%d run_bytes=%d "
                      "ms=%.1f gb_s=%.3f" % (
                          sp["sid"], sp["bytes"], sp["rows"],
                          sp["run_bytes"], sp["seconds"] * 1e3,
                          sp["bytes"] / sp["seconds"] / 1e9), flush=True)
            torch.cuda.synchronize()
            alloc.append(torch.cuda.memory_allocated())
            check_budget(ex, "evict job %d" % (j + 1))
            print("evict job %d: resident_gib=%.3f budget_gib=%.3f "
                  "on_device=%d spilled=%d allocated_gib=%.3f" % (
                      j + 1, ex.resident_bytes / 2 ** 30,
                      EVICT_BUDGET / 2 ** 30, *store_split(ex),
                      alloc[-1] / 2 ** 30), flush=True)
            rdds.append(r)
        if alloc[3] - alloc[1] >= 2 ** 28:
            fail("evict: allocated %.3f GiB after job 4, %.3f after job 2: "
                 "the spilled stores were not freed" % (
                     alloc[3] / 2 ** 30, alloc[1] / 2 ** 30))
        sid = rdds[0].prev.dep.shuffle_id
        if "host_runs" not in ex.shuffle_store[sid]:
            fail("evict: the first shuffle was not spilled")
        # the host path builds 32Mi Python rows: the cyclic collector's
        # passes over them would triple the check's time (the action's
        # time printed is with it off)
        gc.disable()
        try:
            got = act("gpu:8 evict partitionBy(8) collect (spilled, gc "
                      "off)", rdds[0].collect)
        finally:
            gc.enable()
        for st in ctx.scheduler.history[-1]["stage_info"]:
            if "fallback_reason" in st or st.get("reads") != "host_runs":
                fail("evict collect: a stage that reads no spilled runs: %s"
                     % st)
        gk = np.fromiter((kv[0] for kv in got), np.int64, len(got))
        gv = np.fromiter((kv[1] for kv in got), np.int64, len(got))
        del got
        k, v = evict_data(0)
        go, wo = np.lexsort((gv, gk)), np.lexsort((v, k))
        if not (np.array_equal(gk[go], k[wo]) and np.array_equal(gv[go],
                                                                 v[wo])):
            fail("evict: the spilled shuffle's collect differs from numpy")
        print("evict: the spilled shuffle's %d rows equal numpy's" % len(gk),
              flush=True)
    finally:
        conf.SHUFFLE_HBM_BUDGET = old
        ctx.stop()
    torch.cuda.empty_cache()


def union_paths(drive, K, dev):
    """K16's and the state gather's phases, then the union and window
    paths, each driven with its own launch counts, and a profile of the
    union count."""
    from dpark_tpu_torch import Columns
    out = union_kernel_phases(K, dev)
    out.update(state_gather_phase(K, dev))
    keys, vals = bench_data()
    drive("union gpu:8", union_path, keys, vals)
    half = PAIRS // 2
    profile_first_action(
        "gpu:8 union count", lambda ctx: ctx.parallelize(
            Columns(keys[:half], vals[:half]), N_SHARDS).union(
                ctx.parallelize(Columns(keys[half:], vals[half:]),
                                N_SHARDS)).reduceByKey(operator.add,
                                                       N_SHARDS).count)
    del keys, vals
    t0 = time.perf_counter()
    batches = window_batches(WINDOW_BATCHES)
    print("window: %d batches of %d word ids generated in %.1f s" % (
        len(batches), len(batches[0]), time.perf_counter() - t0),
        flush=True)
    drive("window gpu:8", window_path, batches)
    return out


def sort_only(K, dev):
    """K5's and K6's phases, B7's composed top, B6's merge, the
    sort and reduceByKey gpu:8 paths and the sortByKey count's profile
    (no result line)."""
    from dpark_tpu_torch import Columns
    sort_kernel_phases(K, dev)
    topk_phase(dev)
    merge_phase(K, dev)
    keys, vals = bench_data()
    check_launches("reduceByKey gpu:8", main_path, "gpu:8", keys, vals)
    del keys, vals
    skeys, svals = sort_data()
    check_launches("sort gpu:8", sort_path, "gpu:8", skeys, svals)
    profile_first_action(
        "gpu:8 sortByKey count", lambda ctx: ctx.parallelize(
            Columns(skeys, svals), 8).sortByKey(numSplits=8).count)


def main():
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        sys.exit(2)
    from dpark_tpu_torch import Columns
    from dpark_tpu_torch.backend.cuda import kernels as K
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print("versions: python %s torch %s cuda %s" % (
        sys.version.split()[0], torch.__version__, torch.version.cuda))
    print("build: %.2f s" % K.build(), flush=True)
    from dpark_tpu_torch import native
    if native.get_lib() is None:
        fail("the native host library (dpark_tpu_torch/native) did not "
             "build or load")
    k5_report(K)
    dev = torch.device("cuda")
    if sys.argv[1:] == ["--sort-only"]:
        sort_only(K, dev)
        return
    if sys.argv[1:] == ["--stream-only"]:
        # the wave stream's phases and paths alone (no result line)
        spill_kernel_phases(K, dev)
        merge_phase(K, dev)
        stream_paths(lambda path, fn, *a: check_launches(path, fn, *a))
        return
    if sys.argv[1:] == ["--text-only"]:
        # K15, the ranged-int top, the narrowing timings and the wordcount
        # alone (no result line)
        text_paths(lambda path, fn, *a: check_launches(path, fn, *a), K,
                   dev)
        return
    if sys.argv[1:] == ["--evict-only"]:
        # K17's phases, the reduceByKey gpu:8, partition/group/distinct
        # and evict paths alone (no result line)
        monoid_reduce_phases(K, dev)
        keys, vals = bench_data()
        for path, fn, args in (
                ("reduceByKey gpu:8", main_path, ("gpu:8", keys, vals)),
                ("partition/group/distinct gpu:8", group_paths,
                 (keys, vals)), ("evict gpu:8", evict_path, ())):
            check_launches(path, fn, *args)
        return
    if sys.argv[1:] == ["--union-only"]:
        # K16's and the state gather's phases, the union and window paths
        # alone (no result line)
        union_paths(lambda path, fn, *a: check_launches(path, fn, *a), K,
                    dev)
        return
    if sys.argv[1:]:
        fail("unknown arguments %s" % sys.argv[1:])
    phases = kernel_phases(K, dev)
    phases.update(sort_kernel_phases(K, dev))
    phases.update(seg_kernel_phases(K, dev))
    b8 = plain_phases(dev)
    phases.update(monoid_reduce_phases(K, dev))
    phases.update(k14_phases(K, dev, b8))
    phases.update(column_ranges_phase(K, dev))

    launches = {}

    def drive(path, fn, *args):
        launches[path] = check_launches(path, fn, *args)

    keys, vals = bench_data()
    drive("reduceByKey gpu:8", main_path, "gpu:8", keys, vals)
    drive("reduceByKey gpu", main_path, "gpu", keys, vals)
    drive("partition/group/distinct gpu:8", group_paths, keys, vals)
    drive("evict gpu:8", evict_path)
    profile_first_action(
        "gpu:8 reduceByKey count", lambda ctx: ctx.parallelize(
            Columns(keys, vals), 8).reduceByKey(lambda a, b: a + b, 8).count)
    del keys, vals
    keys, vals = bench_data()
    grouped_paths(drive, keys, vals)
    drive("tuple reduceByKey gpu:8", tuple_reduce_path, keys, vals)
    profile_first_action(
        "gpu:8 groupByKey.mapValues(sumsq) collect", lambda ctx:
        ctx.parallelize(Columns(keys, vals), 8).groupByKey(8)
        .mapValues(sumsq).collect)
    del keys, vals
    skeys, svals = sort_data()
    drive("sort gpu:8", sort_path, "gpu:8", skeys, svals)
    drive("sort gpu", sort_path, "gpu", skeys, svals)
    profile_first_action(
        "gpu:8 sortByKey count", lambda ctx: ctx.parallelize(
            Columns(skeys, svals), 8).sortByKey(numSplits=8).count)
    del skeys, svals
    topk_phase(dev)

    t0 = time.perf_counter()
    data = tpch_data()
    print("tpch: SF %d, %d orders, %d lines, generated in %.1f s" % (
        TPCH_SF, len(data[2]), len(data[0]), time.perf_counter() - t0),
        flush=True)
    phases.update(join_kernel_phase(K, dev, data))
    drive("join gpu:8", join_path, data)
    profile_first_action(
        "gpu:8 join count", lambda ctx: ctx.parallelize(
            Columns(data[0], data[1]), 8).join(ctx.parallelize(
                Columns(data[2], data[3]), 8), 8).count)
    del data

    t0 = time.perf_counter()
    q1 = tpch_q1_data()
    print("tpch q1: SF %d, %d lines, generated in %.1f s" % (
        TPCH_SF, len(q1[0]), time.perf_counter() - t0), flush=True)
    drive("tpch q1 gpu:8", tpch_q1_path, q1)
    profile_first_action(
        "gpu:8 tpch q1 collect",
        lambda ctx: q1_job(ctx, q1, N_SHARDS).collect)
    keys, vals = bench_data()
    narrow_timings(keys, vals, q1)
    del q1, keys, vals
    wordcount_drive(drive)

    t0 = time.perf_counter()
    graph = kronecker_graph(GRAPH_SCALE, EDGE_FACTOR)
    weights = np.random.default_rng(20261022).integers(
        1, 100, len(graph[1])).astype(np.float64)
    print("graph: Kronecker scale %d edge factor %d: %d vertices, %d edges, "
          "max out-degree %d, generated in %.1f s" % (
              GRAPH_SCALE, EDGE_FACTOR, graph[0], len(graph[1]),
              np.bincount(graph[1]).max(), time.perf_counter() - t0),
          flush=True)
    phases.update(pregel_kernel_phases(K, dev, graph))
    drive("pregel gpu:8", pregel_path, graph, weights)
    del graph, weights

    graph = urand_graph(URAND_SCALE, URAND_EDGE_FACTOR)
    print("graph: urand scale %d edge factor %d: %d vertices, %d edges, "
          "max out-degree %d" % (URAND_SCALE, URAND_EDGE_FACTOR, graph[0],
                                 len(graph[1]), np.bincount(graph[1]).max()),
          flush=True)
    phases.update(bagel_kernel_phase(K, dev, graph))
    drive("bagel gpu:8", bagel_path, graph)
    del graph

    phases.update(spill_kernel_phases(K, dev))
    merge_phase(K, dev)
    stream_paths(drive)
    phases.update(union_paths(drive, K, dev))

    rows = []
    for name, (src, replaces) in SOURCES.items():
        rec = phases[name]
        path = LINE_PATH.get(name, "reduceByKey gpu:8")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[path][name],
                     "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                     "plain_ms": rec["plain_ms"],
                     "bound_ms": rec["bound_ms"], "bound_by": "bytes",
                     "library_ms": rec["library_ms"]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
