"""The port's copy of the native host library (dpark_tpu_torch/native),
mirroring tests/test_native.py for what the text path uses: it builds
into the port's ignored build directory, and its TokenDict (encode, put,
decode, merge_from) and split_lines equal the JAX package's bindings and
the port's own pure-Python versions on the same inputs."""

import os

import numpy as np
import pytest

from dpark_tpu import native as ref_native
from dpark_tpu_torch import native

TEXT = [b"the quick brown fox the lazy dog the\n",
        b"a\tb  c\r\nfox dog unseen\n",
        b"x,y,,z\n\n,lead\ntrail,\r\n"]


@pytest.fixture()
def pure_python():
    """The bindings with the library hidden (a host with no compiler)."""
    saved = native._lib, native._tried
    native._lib, native._tried = None, True
    yield
    native._lib, native._tried = saved


def test_library_builds_outside_the_source_tree():
    lib = native.get_lib()
    assert lib is not None, "g++ build failed"
    so = lib._name
    assert os.sep + os.path.join("build", "dpark_tpu_torch_kernels") in so
    assert os.path.dirname(so) != os.path.dirname(native._SRC)


def test_tokendict_roundtrip():
    d = native.TokenDict()
    ids1 = d.encode("the quick brown fox the lazy dog the")
    assert len(ids1) == 8
    assert ids1[0] == ids1[4] == ids1[7]
    ids2 = d.encode("fox dog unseen")
    assert ids2[0] == ids1[3]
    assert d.decode(int(ids1[0])) == "the"
    assert d.decode(int(ids2[2])) == "unseen"
    assert len(d) == 7
    with pytest.raises(KeyError):
        d.raw(7)


def test_tokendict_large():
    d = native.TokenDict()
    text = " ".join("w%d" % (i % 1000) for i in range(50000))
    ids = d.encode(text)
    assert len(ids) == 50000 and len(d) == 1000
    counts = np.bincount(ids)
    assert counts.sum() == 50000 and counts.max() == 50


@pytest.mark.parametrize("sep", [None, ",", "\t"])
def test_encode_matches_reference_and_fallback(sep, pure_python):
    """Ids and vocabularies of the port's C++ dict, the reference's and
    the port's pure-Python dict agree on every input."""
    py = native.TokenDict()
    assert py._h is None
    native._lib, native._tried = None, False
    cpp, ref = native.TokenDict(), ref_native.TokenDict()
    assert cpp._h
    for buf in TEXT:
        a, b, c = cpp.encode(buf, sep=sep), ref.encode(buf, sep=sep), \
            py.encode(buf, sep=sep)
        assert a.dtype == np.int64
        assert a.tolist() == b.tolist() == c.tolist()
    assert [cpp.raw(i) for i in range(len(cpp))] == \
        [ref.raw(i) for i in range(len(ref))] == \
        [py.raw(i) for i in range(len(py))]


def test_put_exact_strings_and_unicode():
    d = native.TokenDict()
    a = d.put("with space")
    assert d.put("with space") == a
    b = d.put("第三行")
    assert d.decode(b) == "第三行" and d.decode(a) == "with space"
    assert d.put(b"\xff") == 2 and d.raw(2) == b"\xff"
    assert d.decode(2) == "�"


@pytest.mark.parametrize("native_other", [True, False])
def test_merge_from_keeps_serial_ids(native_other, pure_python):
    """Private dicts merged in split order give the ids one serial walk
    gives (the parallel text ingest's rule), C++ or pure-Python source."""
    splits = [b"a b c a\n", b"c d e\n", b"e f a g\n"]
    native._lib, native._tried = None, False
    serial = native.TokenDict()
    want = np.concatenate([serial.encode(s) for s in splits])
    merged = native.TokenDict()
    if not native_other:
        native._lib, native._tried = None, True
    got = []
    for s in splits:
        private = native.TokenDict()
        local = private.encode(s)
        got.append(merged.merge_from(private)[local])
    assert np.concatenate(got).tolist() == want.tolist()
    assert [merged.raw(i) for i in range(len(merged))] == \
        [serial.raw(i) for i in range(len(serial))]


@pytest.mark.parametrize("buf", [
    b"one\ntwo\r\nthree\nlast-no-newline", b"trailing\n", b"", b"\n\n",
    b"\r\n", b"a\r\r\nb"])
def test_split_lines(buf, pure_python):
    py = native.split_lines(buf)
    native._lib, native._tried = None, False
    got = native.split_lines(buf)
    want = ref_native.split_lines(buf)
    for a, b, c in zip(got, want, py):
        assert a.tolist() == b.tolist() == c.tolist()
    lines = [buf[s:s + n] for s, n in zip(*got)]
    if buf == b"one\ntwo\r\nthree\nlast-no-newline":
        assert lines == [b"one", b"two", b"three", b"last-no-newline"]
