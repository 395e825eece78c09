"""Every fallback reason the reference records, the port records in the
same words (ROADMAP C19).  The reference writes a stage's
`fallback_reason` only for its key-shape and grouped-consumer declines
(backend/tpu/fuse.py `_fallback`); the port keeps those strings
(backend/cuda/fuse.py) and records more reasons where the reference
records none, by design.  Each case here is a job of the mirrored
tests/test_tpu_backend.py and tests/test_seg_groups.py shapes that the
reference declines with a reason: run on its tpu:2 and on the port's
gpu:2 (device="cpu"), the stage's reason and kind must match, and the
results must equal the reference's local."""

import operator

import pytest

from dpark_tpu import DparkContext as RefContext
from dpark_tpu_torch import DparkContext
from dpark_tpu_torch.backend.cuda import fuse

# the reference's strings the port keeps (fuse.py's key-shape block and
# the grouped-consumer declines)
KEPT = {fuse.HASH_KEY_REASON, fuse.HASH_KEY_COMBINER_REASON,
        fuse.RANGE_KEY_REASON, fuse.RANGE_MIXED_REASON,
        fuse.RANGE_WIDTH_REASON, fuse.GROUP_REASON}
PAD_REASON = ("per-group function is not padding-invariant (its result "
              "needs the true group length; zero-fill and repeat-last "
              "fills both change it)")

ROWS = [(i % 13, (i * 7) % 11) for i in range(400)]


def _float_keys(c):
    return sorted(c.parallelize([(k * 0.5, v) for k, v in ROWS], 2)
                  .reduceByKey(operator.add, 2).collect())


def _mixed_tuple_sort(c):
    return c.parallelize([((k, v * 0.5), v) for k, v in ROWS], 2) \
        .sortByKey(numSplits=2).collect()


def _grouped_map(c):
    return sorted(c.parallelize(ROWS, 2).groupByKey(2)
                  .map(lambda kv: (kv[0], len(kv[1]))).collect())


def _length_dependent(c):
    return sorted(c.parallelize(ROWS, 2).groupByKey(2)
                  .mapValues(lambda vs: sum(vs) * len(vs)).collect())


CASES = {
    "hash_float_key": (_float_keys, fuse.HASH_KEY_REASON),
    "range_mixed_tuple_key": (_mixed_tuple_sort, fuse.RANGE_MIXED_REASON),
    "grouped_values_on_host": (_grouped_map, fuse.GROUP_REASON),
    "seg_map_not_padding_invariant": (_length_dependent, PAD_REASON),
}


@pytest.fixture(scope="module")
def tctx():
    c = RefContext("tpu:2")
    c.start()
    yield c
    c.stop()


def _reasons(ctx):
    return [(s["rdd"], s.get("kind"), s.get("fallback_reason"))
            for s in ctx.scheduler.history[-1]["stage_info"]]


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_reasons_are_the_ports(name, tctx):
    job, reason = CASES[name]
    lctx = RefContext("local")
    want = job(lctx)
    lctx.stop()
    assert job(tctx) == want
    ref = [r for r in _reasons(tctx) if r[2]]
    assert ref and {r[2] for r in ref} == {reason}, _reasons(tctx)
    assert reason in KEPT or reason == PAD_REASON
    c = DparkContext("gpu:2", device="cpu")
    assert job(c) == want
    port = {(rdd, kind, why) for rdd, kind, why in _reasons(c)}
    for rdd, kind, why in ref:
        assert (rdd, kind, why) in port, (ref, _reasons(c))
    c.stop()
