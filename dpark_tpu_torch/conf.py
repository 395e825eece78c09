"""Knobs of the PyTorch port (the subset of dpark_tpu/conf.py this
slice reads)."""

# widest flat tuple key the device path accepts: each extra key leaf is
# one more sort pass in every shuffle
MAX_KEY_LEAVES = 4

# rows per shard above which a columnar input would need the out-of-core
# wave stream (not yet ported: such stages take the host path).  "auto"
# sizes it to device memory; a number pins it.
STREAM_CHUNK_ROWS = "auto"
_STREAM_CHUNK_ROWS_FALLBACK = 4 << 20


def device_bytes_limit(device):
    """Total memory of a CUDA device (torch.cuda.mem_get_info), or 0 for
    the CPU."""
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return 0
    return int(torch.cuda.mem_get_info(dev)[1])


def stream_chunk_rows(row_bytes=16, device="cpu"):
    """Wave threshold in rows per shard: a pinned STREAM_CHUNK_ROWS wins;
    "auto" allows a raw wave of device memory / 16 (the map side holds
    about six copies of its input: ingest, sort passes, partitioned,
    combined), and the fixed fallback where the device reports none."""
    if STREAM_CHUNK_ROWS != "auto":
        return STREAM_CHUNK_ROWS
    limit = device_bytes_limit(device)
    if not limit:
        return _STREAM_CHUNK_ROWS_FALLBACK
    return max(_STREAM_CHUNK_ROWS_FALLBACK,
               limit // (16 * max(1, row_bytes)))
