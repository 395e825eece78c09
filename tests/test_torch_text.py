"""Text ingest on the port (A8), on the CPU (gpu:8 with device="cpu": the
kernels' plain versions), mirroring tests/test_text_device.py without its
gzip and tabular cases (compressed and tabular sources are ROADMAP A8b).

The narrow chain over ctx.textFile runs as a host prologue per split (the
user's generators, or the verified C++ tokenizer for the canonical
wordcount), string keys dictionary-encode to int64 ids, and the shuffle
write and combine run on the device.  Every result equals the JAX
package's `local` master on the same generated file; the canonical
wordcount, the encoded join and the text waves also equal its `tpu:8`.
The stage records show the text source, which tokenizer ran and, for the
waves, the stream."""

import operator
import os
import random

import pytest

import dpark_tpu.conf as ref_conf
from dpark_tpu import DparkContext as RefContext
from dpark_tpu_torch import DparkContext, conf
from dpark_tpu_torch.backend.cuda import fuse

add = operator.add


@pytest.fixture()
def gctx():
    c = DparkContext("gpu:8", device="cpu")
    c.start()
    yield c
    c.stop()


@pytest.fixture(scope="module")
def lctx():
    c = RefContext("local")
    yield c
    c.stop()


@pytest.fixture()
def corpus(tmp_path):
    rng = random.Random(42)
    words = ["spark", "tpu", "mesh", "jit", "pallas", "ici", "hbm"]
    p = str(tmp_path / "corpus.txt")
    with open(p, "w") as f:
        for _ in range(4000):
            f.write(" ".join(rng.choices(words, k=5)) + "\n")
    return p


def _wordcount(ctx, path, parts=4, **kw):
    return dict(ctx.textFile(path, **kw)
                .flatMap(lambda line: line.split())
                .map(lambda w: (w, 1))
                .reduceByKey(add, parts).collect())


def _stages(ctx):
    return ctx.scheduler.history[-1]["stage_info"]


def _text_stage(ctx):
    """The record of the job's text map stage (one per job here)."""
    (st,) = [s for s in _stages(ctx) if s.get("source") == "text"]
    return st


def _on_device(ctx, canonical=True):
    """The text map stage ran on the device with the expected tokenizer,
    its string keys encoded through the executor's dict."""
    st = _text_stage(ctx)
    assert st["kind"].startswith("array") and "fallback_reason" not in st, st
    assert st["text"]["canonical"] is canonical, st
    assert ctx.scheduler.executor.token_dict is not None
    return st


def test_canonical_wordcount_rides_device(gctx, lctx, corpus):
    got = _wordcount(gctx, corpus, splitSize=30000)
    st = _on_device(gctx)
    assert st["text"]["cpp_splits"] == len(
        gctx.textFile(corpus, splitSize=30000).splits)
    assert st["text"]["prologue_splits"] == 0
    assert all("fallback_reason" not in s for s in _stages(gctx))
    assert got == _wordcount(lctx, corpus, splitSize=30000)
    tctx = RefContext("tpu:8")
    tctx.start()
    try:
        assert got == _wordcount(tctx, corpus, splitSize=30000)
    finally:
        tctx.stop()


def test_str_split_method_ref(gctx, lctx, corpus):
    got = dict(gctx.textFile(corpus).flatMap(str.split)
               .map(lambda w: (w, 1)).reduceByKey(add, 4).collect())
    _on_device(gctx)
    assert got == _wordcount(lctx, corpus)


def test_non_canonical_chain_host_prologue(gctx, lctx, corpus):
    """Any string-keyed chain: the user's own generators run per split,
    the keys encode, the device combines."""
    def first_two(line):
        return [(w[:2], len(w)) for w in line.split()]

    def run(ctx):
        return dict(ctx.textFile(corpus).flatMap(first_two)
                    .reduceByKey(add, 4).collect())

    got = run(gctx)
    st = _on_device(gctx, canonical=False)
    assert st["text"]["prologue_splits"] >= 1
    assert got == run(lctx)


def test_int_key_text_chain_no_encoding(gctx, lctx, tmp_path):
    p = str(tmp_path / "nums.txt")
    with open(p, "w") as f:
        for i in range(2000):
            f.write("%d\n" % i)

    def run(ctx):
        return dict(ctx.textFile(p, splitSize=4000)
                    .map(lambda line: (int(line) % 13, 1))
                    .reduceByKey(add, 4).collect())

    got = run(gctx)
    st = _text_stage(gctx)
    assert st["kind"] == "array" and "fallback_reason" not in st
    assert not any(s.get("encoded_keys") for s in
                   gctx.scheduler.executor.shuffle_store.values())
    assert got == run(lctx)


def test_group_by_key_words(gctx, lctx, corpus):
    def run(ctx):
        return {k: sorted(v) for k, v in
                ctx.textFile(corpus).flatMap(lambda line: line.split())
                .map(lambda w: (w, len(w))).groupByKey(4).collect()}

    got = run(gctx)
    assert all(s["kind"].startswith("array") for s in _stages(gctx))
    assert got == run(lctx)


def test_downstream_map_after_reduce(gctx, lctx, corpus):
    """Ops after the reduce would compute on ids: that stage runs on the
    host, and the export bridge hands it decoded rows."""
    def run(ctx):
        return sorted(ctx.textFile(corpus).flatMap(lambda line: line.split())
                      .map(lambda w: (w, 1)).reduceByKey(add, 4)
                      .map(lambda kv: (kv[0].upper(), kv[1] * 2)).collect())

    got = run(gctx)
    assert _stages(gctx)[-1]["fallback_reason"] == fuse.ENCODED_REASON
    assert got == run(lctx)


def test_encoded_ids_never_ordered(gctx, lctx, corpus):
    """sortByKey over the words (a range write over ids) and top() by the
    word itself keep the host path: ids must not order anything."""
    def run(ctx):
        counts = (ctx.textFile(corpus).flatMap(lambda line: line.split())
                  .map(lambda w: (w, 1)).reduceByKey(add, 4))
        return counts.sortByKey(numSplits=2).collect(), counts.top(3)

    got = run(gctx)
    assert "array+top" not in [s["kind"] for s in _stages(gctx)]
    assert got == run(lctx)


def test_word_join_device(gctx, lctx, corpus):
    """A string-keyed join over two reduced sides (co-partitioned: the
    host merges the decoded exports)."""
    def run(ctx):
        words = ctx.textFile(corpus).flatMap(lambda line: line.split())
        a = words.map(lambda w: (w, 1)).reduceByKey(add, 4)
        b = words.map(lambda w: (w, len(w))).reduceByKey(lambda x, y: x, 4)
        return sorted(a.join(b, 4).collect())

    assert run(gctx) == run(lctx)


def _small_corpus(tmp_path, lines=60):
    rng = random.Random(5)
    words = ["spark", "tpu", "mesh", "jit", "pallas", "ici", "hbm"]
    p = str(tmp_path / "small.txt")
    with open(p, "w") as f:
        for _ in range(lines):
            f.write(" ".join(rng.choices(words, k=5)) + "\n")
    return p


def _encoded_join(ctx, path):
    words = ctx.textFile(path, splitSize=500).flatMap(
        lambda line: line.split())
    return sorted(words.map(lambda w: (w, 1))
                  .join(words.map(lambda w: (w, len(w))), 8).collect())


def test_encoded_join_device_precompute(gctx, lctx, tmp_path):
    """Both sides encoded through one dict: the join is no stage source
    (its ids must not feed the narrow ops), but the host stage's
    precompute expands it on the device (K12) and decodes at the exit;
    equal to the JAX local and tpu:8 masters."""
    p = _small_corpus(tmp_path)
    got = _encoded_join(gctx, p)
    st = _stages(gctx)[-1]
    assert st["fallback_reason"] == fuse.JOIN_ENCODED_REASON % 0, st
    assert st["device_precompute"] == "join", st
    assert got == _encoded_join(lctx, p)
    tctx = RefContext("tpu:8")
    tctx.start()
    try:
        assert got == _encoded_join(tctx, p)
    finally:
        tctx.stop()


def test_mixed_encoded_plain_join_refused(gctx, lctx, tmp_path):
    """Ids on one side, user ints on the other: no device join (id
    equality would be spurious); the cogroup precompute exchanges each
    side on the device and the host merges the decoded keys."""
    words = _small_corpus(tmp_path)
    nums = str(tmp_path / "nums.txt")
    with open(nums, "w") as f:
        f.write("".join("%d\n" % i for i in range(50)))

    def join(ctx):
        a = ctx.textFile(words).flatMap(lambda line: line.split()).map(
            lambda w: (w, 1))
        b = ctx.textFile(nums).map(lambda line: (int(line) % 7, 1))
        return a.join(b, 8)

    j = join(gctx)
    assert j.collect() == join(lctx).collect() == []
    st = _stages(gctx)[-1]
    assert st["device_precompute"] == "cogroup", st
    store = gctx.scheduler.executor.shuffle_store
    assert sorted(s["encoded_keys"] for s in store.values()) == [
        False, True]
    assert fuse._analyze_join_source(j, 8, store, allow_encoded=True) == (
        None, fuse.JOIN_MIXED_REASON)


def test_unicode_whitespace_falls_back_correctly(gctx, lctx, tmp_path):
    """NBSP splits in Python but not in the byte tokenizer: the sample
    check catches the divergence and the host prologue runs."""
    p = str(tmp_path / "nbsp.txt")
    with open(p, "w", encoding="utf-8") as f:
        for i in range(200):
            f.write("a b c%d\n" % (i % 3))
    got = _wordcount(gctx, p)
    _on_device(gctx, canonical=False)
    assert got == _wordcount(lctx, p)
    assert "a" in got and "b" in got and "a b" not in got


def test_late_split_divergence_caught(gctx, lctx, tmp_path):
    """Divergence after the first split's sample (NBSP and \\x1c only in
    later splits) is caught by each split's byte scan: exactly those
    splits take the host prologue."""
    p = str(tmp_path / "late.txt")
    with open(p, "w", encoding="utf-8", newline="") as f:
        for i in range(2000):
            f.write("clean ascii words %d\n" % (i % 5))
        for i in range(200):
            f.write("a b\n")
        for i in range(200):
            f.write("p\x1cq\n")
    got = _wordcount(gctx, p, splitSize=8000)
    st = _on_device(gctx)
    assert st["text"]["cpp_splits"] >= 1 and st["text"]["prologue_splits"] >= 1
    assert got == _wordcount(lctx, p, splitSize=8000)
    assert got["a"] == 200 and got["b"] == 200
    assert got["p"] == 200 and got["q"] == 200
    assert "a b" not in got and "p\x1cq" not in got
    assert got["clean"] == 2000


def test_long_first_line_not_trusted(gctx, lctx, tmp_path):
    """A first line above 4 KiB leaves nothing to verify the tokenizer
    against: the canonical path must not run unverified."""
    p = str(tmp_path / "long.txt")
    with open(p, "w", encoding="utf-8") as f:
        f.write("x y " * 2000 + "\n")
    got = _wordcount(gctx, p, parts=2)
    _on_device(gctx, canonical=False)
    assert got == _wordcount(lctx, p, parts=2)
    assert "x" in got and "y" in got and "x y" not in got


def test_separator_split_rides_device(gctx, lctx, tmp_path):
    """flatMap(lambda l: l.split('\\t')): the constant-separator
    tokenizer, with str.split(sep)'s empty fields."""
    p = str(tmp_path / "tsv.txt")
    with open(p, "w") as f:
        for i in range(3000):
            f.write("a\tb b\t\tc%d\n" % (i % 4))
            if i % 7 == 0:
                f.write("\n")

    def run(ctx):
        return dict(ctx.textFile(p, splitSize=9000)
                    .flatMap(lambda line: line.split("\t"))
                    .map(lambda w: (w, 1)).reduceByKey(add, 4).collect())

    got = run(gctx)
    _on_device(gctx)
    assert got == run(lctx)
    assert got["b b"] == 3000
    assert got[""] == 3000 + (3000 + 6) // 7


def test_separator_split_comma(gctx, lctx, tmp_path):
    p = str(tmp_path / "c.txt")
    with open(p, "w") as f:
        for i in range(2000):
            f.write("x,y%d,,z\n" % (i % 3))

    def run(ctx):
        return dict(ctx.textFile(p, splitSize=7000)
                    .flatMap(lambda line: line.split(","))
                    .map(lambda w: (w, 1)).reduceByKey(add, 4).collect())

    got = run(gctx)
    _on_device(gctx)
    assert got == run(lctx) and got[""] == 2000


def _vocab(td):
    return [td.decode(i) for i in range(len(td))]


def test_parallel_ingest_matches_serial(tmp_path):
    """Splits tokenize concurrently into private dicts merged in split
    order: results and the id of every word equal the serial walk's, and
    the JAX package's tpu:8 assigns the same ids."""
    rng = random.Random(3)
    words = ["w%d" % i for i in range(300)]
    p = str(tmp_path / "par.txt")
    with open(p, "w") as f:
        for _ in range(3000):
            f.write(" ".join(rng.choices(words, k=6)) + "\n")

    def run(threads):
        was = conf.INGEST_THREADS
        conf.INGEST_THREADS = threads
        try:
            c = DparkContext("gpu:8", device="cpu")
            got = _wordcount(c, p, splitSize=9000)
            st = _text_stage(c)
            vocab = _vocab(c.scheduler.executor.token_dict)
            c.stop()
            return got, vocab, st
        finally:
            conf.INGEST_THREADS = was

    serial, vocab_serial, st = run(1)
    assert st["text"]["cpp_splits"] > 1
    parallel, vocab_parallel, _ = run(4)
    assert parallel == serial
    assert vocab_parallel == vocab_serial
    was = ref_conf.INGEST_THREADS
    ref_conf.INGEST_THREADS = 1
    tctx = RefContext("tpu:8")
    tctx.start()
    try:
        assert _wordcount(tctx, p, splitSize=9000) == serial
        assert _vocab(tctx.scheduler.executor.token_dict) == vocab_serial
    finally:
        tctx.stop()
        ref_conf.INGEST_THREADS = was


def test_parallel_ingest_unsafe_first_split(lctx, tmp_path):
    """The sample check may not resolve on split 0 (an unsafe prefix):
    the parallel path walks serially until it does, so the C++ tokenizer
    never runs unverified."""
    p = str(tmp_path / "front.txt")
    with open(p, "w", encoding="utf-8") as f:
        for i in range(500):
            f.write("x y%d\n" % (i % 7))
        for i in range(3000):
            f.write("clean words here %d\n" % (i % 5))
    was = conf.INGEST_THREADS
    conf.INGEST_THREADS = 4
    try:
        c = DparkContext("gpu:8", device="cpu")
        got = _wordcount(c, p, splitSize=7000)
        st = _text_stage(c)
        c.stop()
    finally:
        conf.INGEST_THREADS = was
    assert got == _wordcount(lctx, p, splitSize=7000)
    assert got["x"] == 500 and "x y0" not in got
    assert st["text"]["prologue_splits"] >= 1 and st["text"]["cpp_splits"] >= 1


def test_cache_not_poisoned_by_encoded_results(gctx, corpus):
    """A cached reduced-words RDD returns strings on every access."""
    r = (gctx.textFile(corpus).flatMap(lambda line: line.split())
         .map(lambda w: (w, 1)).reduceByKey(add, 4).cache())
    first = dict(r.collect())
    second = dict(r.collect())
    assert first == second
    assert all(isinstance(k, str) for k in second)


def test_lineage_recovery_after_drop(gctx, corpus):
    """Dropping the encoded shuffle recomputes the text stage through its
    lineage; the decoded results stay identical."""
    r = (gctx.textFile(corpus).flatMap(lambda line: line.split())
         .map(lambda w: (w, 1)).reduceByKey(add, 4))
    first = dict(r.collect())
    ex = gctx.scheduler.executor
    for sid in list(ex.shuffle_store):
        ex.drop_shuffle(sid)
    assert dict(r.collect()) == first


@pytest.fixture()
def text_waves():
    """Text above 20,000 bytes streams, in waves of about that much."""
    old = conf.STREAM_TEXT_BYTES, ref_conf.STREAM_TEXT_BYTES
    conf.STREAM_TEXT_BYTES = ref_conf.STREAM_TEXT_BYTES = 20000
    yield
    conf.STREAM_TEXT_BYTES, ref_conf.STREAM_TEXT_BYTES = old


@pytest.mark.parametrize("job", ["reduce", "reduce16", "group"])
def test_text_waves(gctx, lctx, corpus, text_waves, job):
    """Text above conf.STREAM_TEXT_BYTES streams through the wave stream:
    a combining write into the per-shard state (pre_reduced), more
    partitions than shards into spilled runs (host_runs), a groupByKey's
    no-combine write into spilled runs.  Equal to the JAX local and tpu:8
    masters with their own text waves."""
    def run(ctx):
        words = ctx.textFile(corpus, splitSize=8000).flatMap(
            lambda line: line.split())
        if job == "group":
            return {k: sorted(v) for k, v in words.map(
                lambda w: (w, len(w))).groupByKey(8).collect()}
        return dict(words.map(lambda w: (w, 1)).reduceByKey(
            add, 16 if job == "reduce16" else 8).collect())

    got = run(gctx)
    st = _on_device(gctx, canonical=job != "group")
    assert st["pipeline"]["waves"] >= 4, st
    assert st["stream"] == ("pre_reduced" if job == "reduce"
                            else "host_runs"), st
    assert got == run(lctx)
    tctx = RefContext("tpu:8")
    tctx.start()
    try:
        assert got == run(tctx)
    finally:
        tctx.stop()


def test_result_stage_over_text_runs_on_host(gctx, lctx, corpus):
    got = gctx.textFile(corpus).flatMap(lambda line: line.split()).count()
    assert _stages(gctx)[-1]["fallback_reason"] == fuse.TEXT_RESULT_REASON
    assert got == lctx.textFile(corpus).flatMap(
        lambda line: line.split()).count() == 20000


def test_empty_text_file(gctx, lctx, tmp_path):
    p = str(tmp_path / "empty.txt")
    open(p, "w").close()
    assert _wordcount(gctx, p) == _wordcount(lctx, p) == {}
    assert _stages(gctx)[0]["fallback_reason"] == fuse.TEXT_RECORD_REASON


def test_directory_of_files(gctx, lctx, tmp_path):
    d = tmp_path / "dir"
    d.mkdir()
    for i in range(3):
        (d / ("part-%d" % i)).write_text("a b c%d\n" % i * (10 + i))
    (d / ".hidden").write_text("zzz\n")
    got = _wordcount(gctx, str(d))
    _on_device(gctx)
    assert got == _wordcount(lctx, str(d))
    assert "zzz" not in got and got["a"] == 33


@pytest.mark.parametrize("call", ["gz", "bz2", "csv", "partial"])
def test_compressed_csv_partial_not_ported(gctx, call):
    """Compressed, csv and partial text sources are ROADMAP A8b."""
    with pytest.raises(NotImplementedError, match="A8b"):
        if call == "gz":
            gctx.textFile("x.gz")
        elif call == "bz2":
            gctx.textFile("x.bz2")
        elif call == "csv":
            gctx.csvFile("x.csv")
        else:
            gctx.partialTextFile("x.txt", 0, 10)


def test_split_boundaries_match_reference(tmp_path):
    """The port's TextFileRDD cuts and reads splits as the JAX package's
    does: every split's lines equal, whatever the split size, and
    split_bytes (the text ingest's read) holds exactly those lines."""
    p = str(tmp_path / "b.txt")
    rng = random.Random(9)
    with open(p, "w", newline="") as f:
        for i in range(300):
            f.write("x" * rng.randrange(0, 40) + ("\r\n" if i % 5 else "\n"))
    c = DparkContext("local")
    ref = RefContext("local")
    try:
        for size in (1, 7, 64, 1000, 1 << 20):
            ours = c.textFile(p, splitSize=size)
            theirs = ref.textFile(p, splitSize=size)
            assert [(s.begin, s.end) for s in ours.splits] == [
                (s.begin, s.end) for s in theirs.splits]
            lines = [list(ours.iterator(s)) for s in ours.splits]
            assert lines == [list(theirs.iterator(s))
                             for s in theirs.splits]
            # the text ingest's one read of a split holds the same lines
            for s, want in zip(ours.splits, lines):
                got = type(ours).split_bytes(s).split(b"\n")
                if got[-1] == b"":
                    got.pop()
                assert [g.rstrip(b"\r\n").decode() for g in got] == want
        assert os.path.getsize(p) == sum(
            s.end - s.begin for s in c.textFile(p, numSplits=3).splits)
    finally:
        c.stop()
        ref.stop()
