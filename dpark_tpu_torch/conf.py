"""Knobs of the PyTorch port (the subset of dpark_tpu/conf.py the port
reads)."""

import os

# widest flat tuple key the device path accepts: each extra key leaf is
# one more sort pass in every shuffle
MAX_KEY_LEAVES = 4

# rows per shard above which a columnar input feeding a shuffle write
# streams through the out-of-core wave stream, one wave of at most this
# many rows a shard at a time (executor._stream_mode).  "auto" sizes it
# to device memory; a number pins it.
STREAM_CHUNK_ROWS = "auto"
_STREAM_CHUNK_ROWS_FALLBACK = 4 << 20

# directory under which each spilled-run stream makes its own spool (a
# fresh directory a run, removed when the shuffle is dropped or the
# stream fails); empty means tempfile.gettempdir()
SPOOL_ROOT = os.environ.get("DPARK_SPOOL_ROOT", "")

# a stand-in for the card's memory ceiling (a test aid): a streamed
# stage whose wave budget is above this many rows a shard raises the
# out-of-memory class that GPUScheduler's ladder retries once with half
# the budget.  0 = off.
EMULATED_WAVE_OOM_ROWS = int(os.environ.get(
    "DPARK_EMULATED_WAVE_OOM_ROWS", "0") or 0)


def spool_root():
    """Root of the spilled-run spools."""
    import tempfile
    return os.path.join(SPOOL_ROOT or tempfile.gettempdir(),
                        "dpark_tpu_torch_runs")


def device_bytes_limit(device):
    """Total memory of a CUDA device (torch.cuda.mem_get_info), or 0 for
    the CPU."""
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return 0
    return int(torch.cuda.mem_get_info(dev)[1])


def stream_chunk_rows(row_bytes=16, device="cpu", nshards=1):
    """Wave threshold in rows per shard: a pinned STREAM_CHUNK_ROWS wins;
    "auto" allows each of the `nshards` shards, which share one card, a
    raw wave of 1/nshards of its memory / 16 (the map side holds about
    six copies of its input: ingest, sort passes, partitioned,
    combined), and the fixed fallback where the device reports none."""
    if STREAM_CHUNK_ROWS != "auto":
        return STREAM_CHUNK_ROWS
    limit = device_bytes_limit(device)
    if not limit:
        return _STREAM_CHUNK_ROWS_FALLBACK
    return max(_STREAM_CHUNK_ROWS_FALLBACK,
               limit // max(1, nshards) // (16 * max(1, row_bytes)))


# graph-build-time rewrite of groupByKey().mapValue(provable aggregate)
# to a map-side-combining combineByKey (rdd._group_agg_rewrite), on every
# master.  "0" disables; the device SegAggOp path then serves these
# chains.  FLOAT CAVEAT: the rewrite reassociates the fold — sum/mean
# over float values pre-combine map-side, so low-order bits depend on
# partitioning and combine order on every master (local included).
GROUP_AGG_REWRITE = os.environ.get("DPARK_GROUP_AGG_REWRITE",
                                   "1") != "0"

# device segmented apply (fuse.SegMapOp): groupByKey().mapValues(f) with
# a traceable, padding-invariant per-group f runs on the device as a
# vmap over power-of-two padded group buckets.  "0" keeps such stages on
# the host object path.
SEG_MAP = os.environ.get("DPARK_SEG_MAP", "1") != "0"

# text-source stages bigger than this stream in waves of splits instead of
# tokenizing the whole input into one device batch (executor._stream_mode)
STREAM_TEXT_BYTES = 1 << 28

# threads that read and tokenize text splits (the C++ tokenizer releases
# the GIL, so splits tokenize concurrently).  0 = the CPU count.
INGEST_THREADS = int(os.environ.get("DPARK_INGEST_THREADS", "0") or 0)

# wire narrowing (B14): an int64 scalar column whose values all fit int32
# crosses a wire as int32 and widens back on the other side.  Two wires
# exist on one card: host-to-device at ingest (a host fit scan) and
# device-to-host at egest (K15's masked min/max over the valid rows).
# Compute stays int64 either way; "0" keeps both wires at int64.
NARROW_EXCHANGE = os.environ.get("DPARK_NARROW_EXCHANGE", "1") != "0"

# device-to-host egest: int64 columns of at least this many bytes are
# min/max-probed and cross as int32 when every valid value fits.  Tests
# shrink it to exercise the path at toy sizes.
EGEST_NARROW_MIN_BYTES = 8 << 20

# the pane plane of windowed DStreams (dstream.py, panes.py): the window
# is sliced into slide-sized panes whose partial aggregates persist
# across ticks as cached reduced RDDs (their shuffle outputs stay on the
# device).  Invertible reduceByKeyAndWindow updates the window from a
# constant number of panes per slide (prev + new pane - expired pane);
# a non-invertible window merges O(log w) cached dyadic tree nodes.
# "0" disables: every windowed op takes the whole-window paths.  Pane
# mode needs window % slide == 0 and slide % batch == 0.
STREAM_PANES = os.environ.get("DPARK_STREAM_PANES", "1") != "0"

# non-invertible pane windows below this many panes union their panes
# flat each tick instead of through the merge tree (the reference's
# adaptive split point is ROADMAP A21; this default decides here)
STREAM_PANE_TREE_MIN = int(os.environ.get(
    "DPARK_STREAM_PANE_TREE_MIN", "8") or 0)

# general traceable updateStateByKey on the device: the state and each
# batch union as (k, (v, flag)) rows and the user's update(values, prev)
# runs as a state-mode SegMapOp (K7, K2, K8's state gather).  "0" keeps
# the host cogroup path.
SEG_STATE = os.environ.get("DPARK_SEG_STATE", "1") != "0"
