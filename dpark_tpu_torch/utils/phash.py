"""Portable, cross-process, host/device-consistent hashing.

Port of dpark_tpu/utils/phash.py.  The same integer mix (murmur3
fmix32) runs three ways and must agree bit for bit:

  * pure Python  (`portable_hash`)           — host path, any object
  * numpy        (`phash_np`, `phash_np_cols`)
  * torch        (`phash_torch`, `phash_torch_cols`) — the plain
    version of the K1 kernel (backend/cuda/csrc/hash_dst_hist.cu)

For an int key k the hash is fmix32(lo32(k) ^ hi32(k)); int32 keys
sign-extend.  Composite (tuple) keys fold columns with portable_hash's
tuple recipe h = (h ^ hash(item)) * 0x9E3779B1 from 0x345678, then
fmix32(h ^ n).

torch has no uint32 shift or modulo on the CPU, so the torch version
computes in int64 and masks to 32 bits after every multiply; results
are int64 tensors holding values in [0, 2**32).
"""

import struct

_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_FNV_OFFSET = 0x811C9DC5
_FNV_PRIME = 0x01000193
_MASK = 0xFFFFFFFF
TUPLE_SEED = 0x345678
TUPLE_MULT = 0x9E3779B1
_INF = float("inf")
_NINF = float("-inf")


def fmix32(h):
    """murmur3 finalizer on a uint32 (pure Python)."""
    h &= _MASK
    h ^= h >> 16
    h = (h * _M1) & _MASK
    h ^= h >> 13
    h = (h * _M2) & _MASK
    h ^= h >> 16
    return h


def _hash_int(x):
    return fmix32((x & _MASK) ^ ((x >> 32) & _MASK))


def _hash_bytes(b):
    h = _FNV_OFFSET
    for c in b:
        h = ((h ^ c) * _FNV_PRIME) & _MASK
    return fmix32(h)


def portable_hash(obj):
    """Deterministic uint32 hash, stable across processes and runs."""
    if obj is None:
        return 0x7F5F
    t = type(obj)
    if t is bool or t is int:
        return _hash_int(int(obj))
    if t is float:
        if obj != obj or obj == _INF or obj == _NINF:
            return _hash_bytes(struct.pack("<d", obj))
        if obj == int(obj) and abs(obj) < 2 ** 62:
            return _hash_int(int(obj))     # hash(1.0) == hash(1)
        return _hash_bytes(struct.pack("<d", obj))
    if t is str:
        return _hash_bytes(obj.encode("utf-8"))
    if t is bytes:
        return _hash_bytes(obj)
    if t is tuple:
        h = TUPLE_SEED
        for item in obj:
            h = ((h ^ portable_hash(item)) * TUPLE_MULT) & _MASK
        return fmix32(h ^ len(obj))
    # subclasses and numpy scalars hash as their value, so equal keys
    # land in one partition whatever their exact type
    if isinstance(obj, str):
        return _hash_bytes(obj.encode("utf-8"))
    if isinstance(obj, bytes):
        return _hash_bytes(bytes(obj))
    if isinstance(obj, (bool, int)):
        return _hash_int(int(obj))
    import numpy as np
    if isinstance(obj, (np.bool_, np.integer)):
        return _hash_int(int(obj))
    if isinstance(obj, (np.floating, float)):
        return portable_hash(float(obj))
    import pickle
    return _hash_bytes(pickle.dumps(obj, 4))


def phash_np(keys):
    """numpy twin: int array -> uint32 array."""
    import numpy as np
    keys = np.asarray(keys)
    if keys.dtype == np.int64:
        lo = (keys & np.int64(0xFFFFFFFF)).astype(np.uint32)
        hi = ((keys >> 32) & np.int64(0xFFFFFFFF)).astype(np.uint32)
    else:
        k = keys.astype(np.int32)
        lo = k.astype(np.uint32)
        hi = (k >> 31).astype(np.uint32)       # 0 or 0xFFFFFFFF
    return _fmix32_np(lo ^ hi)


def _fmix32_np(h):
    import numpy as np
    h = h.astype(np.uint32)
    h ^= h >> np.uint32(16)
    h = h * np.uint32(_M1)
    h ^= h >> np.uint32(13)
    h = h * np.uint32(_M2)
    h ^= h >> np.uint32(16)
    return h


def phash_np_cols(cols):
    """Composite hash of int column arrays -> uint32 array, equal to
    portable_hash((k1, ..., kn)) per row."""
    import numpy as np
    cols = list(cols)
    if len(cols) == 1:
        return phash_np(cols[0])
    h = np.full(np.asarray(cols[0]).shape, TUPLE_SEED, np.uint32)
    for c in cols:
        h = (h ^ phash_np(c)) * np.uint32(TUPLE_MULT)
    return _fmix32_np(h ^ np.uint32(len(cols)))


def _fmix32_torch(h):
    """fmix32 over int64 tensors holding uint32 values."""
    h = h ^ (h >> 16)
    h = (h * _M1) & _MASK
    h = h ^ (h >> 13)
    h = (h * _M2) & _MASK
    return h ^ (h >> 16)


def phash_torch(keys):
    """torch twin of phash_np: int tensor -> int64 tensor of uint32
    hash values (the plain version of K1's per-column hash)."""
    import torch
    if keys.dtype == torch.int64:
        lo = keys & _MASK
        hi = (keys >> 32) & _MASK
    else:
        k = keys.to(torch.int64)          # sign-extends int32
        lo = k & _MASK
        hi = (k >> 32) & _MASK
    return _fmix32_torch(lo ^ hi)


def phash_torch_cols(cols):
    """Composite hash over int key tensors -> int64 tensor of uint32
    values, equal to portable_hash((k1, ..., kn)) per row."""
    import torch
    cols = list(cols)
    if len(cols) == 1:
        return phash_torch(cols[0])
    h = torch.full(cols[0].shape, TUPLE_SEED, dtype=torch.int64,
                   device=cols[0].device)
    for c in cols:
        h = ((h ^ phash_torch(c)) * TUPLE_MULT) & _MASK
    return _fmix32_torch(h ^ len(cols))
