"""The port stands alone: importing dpark_tpu_torch and running a job (a
reduceByKey, a textFile wordcount through dpark_tpu_torch.native, a
windowed DStream, a Pregel, an object Bagel) loads neither jax nor the
JAX package, and the
gpu master refuses to start without CUDA unless the caller asks for the
CPU."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import json, os, sys, tempfile
from dpark_tpu_torch import DparkContext
c = DparkContext("gpu:2", device="cpu")
pairs = [(i % 5, i) for i in range(100)]
got = dict(c.parallelize(pairs, 2).reduceByKey(lambda a, b: a + b, 2)
           .collect())
kinds = [s["kind"] for s in c.scheduler.history[-1]["stage_info"]]
# a textFile wordcount: dpark_tpu_torch.native's tokenizer, the text
# ingest and the decode at egest
path = os.path.join(tempfile.mkdtemp(), "words.txt")
with open(path, "w") as f:
    f.write("a b a\nc a b\n" * 50)
words = dict(c.textFile(path).flatMap(lambda line: line.split())
             .map(lambda w: (w, 1)).reduceByKey(lambda a, b: a + b, 2)
             .collect())
text = c.scheduler.history[-1]["stage_info"][0]["text"]
# a windowed stream: dstream, panes and the device union source
from dpark_tpu_torch import StreamingContext
ssc = StreamingContext(c, 1.0)
wins = []
ssc.queueStream([[(i % 3, 1) for i in range(30)] for _ in range(4)]) \
    .reduceByKeyAndWindow(lambda a, b: a + b, 2.0, numSplits=2,
                          invFunc=lambda a, b: a - b) \
    .collect_batches(wins)
ssc.zero_time = 0.0
for t in (1.0, 2.0, 3.0, 4.0):
    ssc.run_batch(t)
stream_kinds = sorted({s["kind"] for s in
                       c.scheduler.history[-1]["stage_info"]})
mods = sorted(m for m in sys.modules
              if m == "jax" or m.startswith("jax.")
              or m == "dpark_tpu" or m.startswith("dpark_tpu."))
print(json.dumps({"sum": sum(got.values()), "kinds": kinds, "mods": mods,
                  "words": words, "canonical": text["canonical"],
                  "window": sorted(wins[-1][1]), "stream_kinds": stream_kinds,
                  "stream": "dpark_tpu_torch.panes" in sys.modules,
                  "native": "dpark_tpu_torch.native" in sys.modules}))
"""


def test_port_imports_no_jax_and_no_reference_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["sum"] == sum(range(100))
    assert res["kinds"] == ["array", "array"]
    assert res["words"] == {"a": 150, "b": 100, "c": 50}
    assert res["canonical"] is True and res["native"] is True
    assert res["window"] == [[0, 20], [1, 20], [2, 20]]
    assert res["stream_kinds"] == ["array"] and res["stream"] is True
    assert res["mods"] == []


_PREGEL_PROBE = r"""
import json, sys
import numpy as np
from dpark_tpu_torch import DparkContext, run_pregel
c = DparkContext("gpu:2", device="cpu")
n = 16
ids = np.arange(n, dtype=np.int64)
src, dst = np.repeat(ids, 2), np.concatenate([(ids + 1) % n, (ids + 3) % n])


def compute(value, msg, has_msg, active, agg, superstep):
    is0 = (superstep == 0) * 1.0
    return is0 * value + (1 - is0) * (0.15 / n + 0.85 * msg), superstep < 5


def send(value, edge_value, degree):
    return value / degree


_, ranks, _ = run_pregel(c, ids, np.full(n, 1.0 / n), (src, dst), compute,
                         send)
mods = sorted(m for m in sys.modules
              if m == "jax" or m.startswith("jax.")
              or m == "dpark_tpu" or m.startswith("dpark_tpu."))
print(json.dumps({"sum": float(ranks.sum()), "mods": mods,
                  "device": c.scheduler._pregel_device_used}))
"""


def test_pregel_imports_no_jax_and_no_reference_package():
    """The same probe over a small run_pregel on gpu:2 (the device Pregel
    with the kernels' plain versions)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _PREGEL_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert abs(res["sum"] - 1.0) < 1e-9
    assert res["device"] is True
    assert res["mods"] == []


_BAGEL_PROBE = r"""
import json, operator, sys
from dpark_tpu_torch import (Bagel, BasicCombiner, DparkContext, Edge,
                             Message, Vertex)
c = DparkContext("gpu:2", device="cpu")
n = 12


def compute(vert, msg, agg, s):
    new = vert.value if s == 0 else 0.15 / n + 0.85 * (
        msg if msg is not None else 0.0)
    v = Vertex(vert.id, new, vert.outEdges, s < 4)
    if s < 4:
        return v, [Message(e.target_id, new * e.value) for e in vert.outEdges]
    return v, []


rows = [(i, Vertex(i, 1.0 / n, [Edge((i + 1) % n, 0.5),
                                Edge((i + 5) % n, 0.5)])) for i in range(n)]
final = Bagel.run(c, c.parallelize(rows, 2), c.parallelize([], 2), compute,
                  combiner=BasicCombiner(operator.add))
total = sum(v.value for _, v in final.collect())
mods = sorted(m for m in sys.modules
              if m == "jax" or m.startswith("jax.")
              or m == "dpark_tpu" or m.startswith("dpark_tpu."))
print(json.dumps({"sum": total, "mods": mods,
                  "device": c.scheduler._pregel_device_used}))
"""


def test_object_bagel_imports_no_jax_and_no_reference_package():
    """The same probe over an object Bagel.run on gpu:2 (DeviceObjectPregel
    with the kernels' plain versions)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _BAGEL_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert abs(res["sum"] - 1.0) < 1e-9
    assert res["device"] is True
    assert res["mods"] == []


def test_gpu_master_needs_cuda():
    import torch
    from dpark_tpu_torch import DparkContext
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for master in ("gpu", "gpu:4"):
        with pytest.raises(RuntimeError, match="CUDA"):
            DparkContext(master)
    with pytest.raises(RuntimeError, match="CUDA"):
        DparkContext("gpu", device="cuda")
    DparkContext("gpu", device="cpu")         # the CPU only when asked


def test_unknown_master_refused():
    from dpark_tpu_torch import DparkContext
    with pytest.raises(ValueError, match="unknown master"):
        DparkContext("tpu:2")
