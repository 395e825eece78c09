"""dpark_tpu_torch: the PyTorch/CUDA port of dpark_tpu.

    from dpark_tpu_torch import (Bagel, BasicCombiner, Columns,
                                 DparkContext, run_pregel)
    ctx = DparkContext("gpu:8")          # 8 logical shards on one card
    r = ctx.parallelize(Columns(keys, vals), 8).reduceByKey(add, 8)
    r.count(); r.collect(); r.top(10, key=lambda kv: kv[1])
    ids, ranks, _ = run_pregel(ctx, ids, ranks, (src, dst), compute, send)
    final = Bagel.run(ctx, verts, msgs, compute,       # (id, Vertex) RDD
                      combiner=BasicCombiner(operator.add))
    li.join(od, 8).count()               # K12 expands the pairs
    wc = (ctx.textFile(path).flatMap(lambda line: line.split())
          .map(lambda w: (w, 1)).reduceByKey(add))
    wc.top(10, key=lambda kv: kv[1])     # words encoded to ids on the card
    a.union(b).reduceByKey(add, 8)       # K16 packs the branches
    ssc = StreamingContext(ctx, 1.0)     # DStreams: windows and state
    ssc.queueStream(batches).reduceByKeyAndWindow(add, 30, 10,
                                                  invFunc=sub)

The package imports torch, never jax, and nothing of dpark_tpu.
"""

from dpark_tpu_torch.bagel import (Bagel, BasicCombiner, Edge, Message,
                                   Vertex, run_pregel)
from dpark_tpu_torch.context import DparkContext
from dpark_tpu_torch.dstream import StreamingContext
from dpark_tpu_torch.rdd import Columns

__all__ = ["DparkContext", "Columns", "run_pregel", "Bagel",
           "BasicCombiner", "Edge", "Message", "Vertex",
           "StreamingContext"]
