"""ctypes bindings of the port's host C++ code (native/native.cpp, a copy
of the JAX package's): the line splitter and the dictionary token encoder
of the text ingest.

The shared library is built lazily with g++ on first use into
``build/dpark_tpu_torch_kernels/native-<hash of native.cpp>/`` beside the
package (never next to the source), and loaded once.  On a host with no
compiler every binding uses its pure-Python version; ``get_lib()`` returns
None there, which callers that need the library (the chip smoke) check.
"""

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading

import numpy as np

logger = logging.getLogger("dpark_tpu_torch.native")

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native.cpp")
_lock = threading.Lock()
_lib = None
_tried = False


def _so_path():
    from dpark_tpu_torch.backend.cuda.kernels import build_root
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:16]
    return os.path.join(build_root(), "native-" + digest,
                        "libdpark_native.so")


def _build(so):
    os.makedirs(os.path.dirname(so), exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".build-", suffix=".so",
                               dir=os.path.dirname(so))
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-fPIC", "-shared", "-std=c++17",
                        "-o", tmp, _SRC], check=True, capture_output=True)
        os.replace(tmp, so)         # atomic rename: concurrent builds safe
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib():
    """The loaded shared library, or None when it cannot be built."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _so_path()
        try:
            if not os.path.exists(so):
                _build(so)
            lib = ctypes.CDLL(so)
        except (OSError, subprocess.CalledProcessError) as e:
            logger.info("native library unavailable (%s); pure-Python "
                        "versions in use", e)
            return None
        P, L = ctypes.c_void_p, ctypes.c_int64
        lib.split_lines.restype = L
        lib.split_lines.argtypes = [ctypes.c_char_p, L, P, P, L]
        lib.tokendict_new.restype = P
        lib.tokendict_new.argtypes = []
        lib.tokendict_free.restype = None
        lib.tokendict_free.argtypes = [P]
        lib.tokendict_size.restype = L
        lib.tokendict_size.argtypes = [P]
        lib.tokendict_encode.restype = L
        lib.tokendict_encode.argtypes = [P, ctypes.c_char_p, L, P, L]
        lib.tokendict_encode_sep.restype = L
        lib.tokendict_encode_sep.argtypes = [P, ctypes.c_char_p, L,
                                             ctypes.c_uint8, P, L]
        lib.tokendict_get.restype = L
        lib.tokendict_get.argtypes = [P, L, P, L]
        lib.tokendict_put.restype = L
        lib.tokendict_put.argtypes = [P, ctypes.c_char_p, L]
        lib.tokendict_merge.restype = L
        lib.tokendict_merge.argtypes = [P, P, P]
        _lib = lib
        return _lib


def split_lines(buf):
    """(starts, lens) int64 arrays for the lines of `buf` (bytes): lines
    end at \\n, a trailing \\r is not part of the line."""
    lib = get_lib()
    n = len(buf)
    if lib is not None:
        max_lines = buf.count(b"\n") + 1
        starts = np.empty(max_lines, dtype=np.int64)
        lens = np.empty(max_lines, dtype=np.int64)
        cnt = lib.split_lines(buf, n, starts.ctypes.data,
                              lens.ctypes.data, max_lines)
        return starts[:cnt], lens[:cnt]
    starts, lens = [], []
    off = 0
    for line in buf.split(b"\n"):
        body = line[:-1] if line.endswith(b"\r") else line
        if off < n or body:
            starts.append(off)
            lens.append(len(body))
        off += len(line) + 1
    if buf.endswith(b"\n") and starts and lens[-1] == 0 \
            and starts[-1] >= n:
        starts.pop()
        lens.pop()
    return (np.array(starts, dtype=np.int64),
            np.array(lens, dtype=np.int64))


class TokenDict:
    """Exact string -> dense id dictionary encoder (a C++ hash map when the
    library loads).  Ids are assigned in first-seen order."""

    _GET_BYTES = 1 << 16            # the longest token decode() returns

    def __init__(self):
        self._lib = get_lib()
        self._h = self._lib.tokendict_new() if self._lib is not None \
            else None
        if self._h is None:
            self._map = {}
            self._rev = []
        self._buf = threading.local()   # decode's buffer, one a thread

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.tokendict_free(self._h)
            self._h = None

    def __len__(self):
        if self._h:
            return self._lib.tokendict_size(self._h)
        return len(self._rev)

    def _py_id(self, tok):
        tid = self._map.get(tok)
        if tid is None:
            tid = len(self._rev)
            self._map[tok] = tid
            self._rev.append(tok)
        return tid

    def encode(self, buf, sep=None):
        """Tokenize bytes -> int64 id array.

        sep=None: runs of ASCII whitespace (str.split() over ASCII bytes).
        sep=<1-byte str/bytes>: per \\n-line (trailing \\r stripped, as
        TextFileRDD reads lines), split on every separator: exact
        str.split(sep), empty fields included."""
        if isinstance(buf, str):
            buf = buf.encode("utf-8")
        if isinstance(sep, str):
            sep = sep.encode("utf-8")
        if self._h:
            if sep is None:
                max_tokens = max(1, len(buf) // 2 + 1)
                out = np.empty(max_tokens, dtype=np.int64)
                cnt = self._lib.tokendict_encode(
                    self._h, buf, len(buf), out.ctypes.data, max_tokens)
                return out[:cnt]
            # fields a line = separators + 1; lines <= newlines + 1
            max_tokens = buf.count(b"\n") + buf.count(sep) + 2
            out = np.empty(max_tokens, dtype=np.int64)
            cnt = self._lib.tokendict_encode_sep(
                self._h, buf, len(buf), sep[0], out.ctypes.data, max_tokens)
            return out[:cnt]
        if sep is None:
            toks = buf.split()
        else:
            toks = []
            lines = buf.split(b"\n")
            if lines and lines[-1] == b"":
                lines.pop()
            for ln in lines:
                toks.extend(ln.rstrip(b"\r").split(sep))
        return np.array([self._py_id(t) for t in toks], dtype=np.int64)

    def put(self, s):
        """The id of one exact string (it may contain whitespace)."""
        if isinstance(s, str):
            s = s.encode("utf-8")
        if self._h:
            return self._lib.tokendict_put(self._h, s, len(s))
        return self._py_id(s)

    def decode(self, tid):
        return self.raw(tid).decode("utf-8", "replace")

    def raw(self, tid):
        """The exact bytes of token `tid` (decode() re-encodes invalid
        utf-8 lossily)."""
        if self._h:
            buf = getattr(self._buf, "b", None)
            if buf is None:
                buf = self._buf.b = ctypes.create_string_buffer(
                    self._GET_BYTES)
            n = self._lib.tokendict_get(self._h, int(tid), buf,
                                        self._GET_BYTES)
            if n < 0:
                raise KeyError(tid)
            return ctypes.string_at(buf, n)
        return self._rev[tid]

    def merge_from(self, other):
        """Merge `other`'s vocabulary into this dict in other's id order;
        returns remap (int64, len(other)): remap[i] is this dict's id of
        other's token i (the parallel ingest merges private dicts in
        split order, so ids equal a serial walk's)."""
        m = len(other)
        remap = np.empty(m, dtype=np.int64)
        if self._h and other._h:
            self._lib.tokendict_merge(self._h, other._h, remap.ctypes.data)
            return remap
        for i in range(m):
            remap[i] = self.put(other.raw(i))
        return remap
