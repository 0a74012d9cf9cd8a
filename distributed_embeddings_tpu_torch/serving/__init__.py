"""Online serving (docs/design.md §14, §16, §23): a training checkpoint
freezes into a read-only bundle (``export.py``), the bundle restores into
a ``ServingEngine`` (``engine.py``: a ladder of batch rungs over the
lookup-only forward, a read-only hot cache and cold tier), a
``DynamicBatcher`` (``batcher.py``) merges concurrent requests into
padded batches at the smallest fitting rung with pipelined merge,
execute and demux, a ``ServingEnginePool`` (``pool.py``) routes across
replicas with shedding, failover and a degraded mode, a
``RankFrontEnd`` (``frontend.py``) serves an engine of several ranks
through them (the front door admits and gathers, every rank looks up its
block; ``replica_front_ends`` builds replicas on disjoint rank sets, a
link each), and ``bench.py`` measures them (the JAX package's ``serve_*``
and ``serve_over_*`` blocks)."""

from distributed_embeddings_tpu_torch.serving.export import (
    SERVING_FORMAT,
    export_bundle_from_checkpoint,
    export_serving_bundle,
    load_serving_bundle,
)
from distributed_embeddings_tpu_torch.serving.engine import (
    ServingEngine,
    default_bucket_ladder,
)
from distributed_embeddings_tpu_torch.serving.batcher import (
    PRIORITIES,
    DeadlineExceededError,
    DynamicBatcher,
    ReplicaLostError,
    RequestSheddedError,
    ServeFuture,
)
from distributed_embeddings_tpu_torch.serving.frontend import (
    RankFrontEnd,
    replica_front_ends,
)
from distributed_embeddings_tpu_torch.serving.pool import (
    ServingEnginePool,
)
from distributed_embeddings_tpu_torch.serving.bench import (
    hot_hit_rate,
    measure_overload,
    measure_serving,
    split_requests,
)
