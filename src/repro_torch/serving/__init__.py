"""Serving runtime: async micro-batching scheduler over the segmented
index (DESIGN.md §5) — the port of ``repro.serving``, on the card.

The layer between clients and the segmented index's programs: a
per-collection request queue with dynamic micro-batching (power-of-two
shape buckets → zero steady-state program builds), write interleaving
(inserts/deletes fence reads but never rebuild), bounded queues with
explicit overload rejection, a multi-tenant collection registry, and
``/stats``-style metrics (Prometheus exposition format; request tracing
and the slow-query log live in ``repro_torch.obs`` — pass ``tracer=`` /
configure ``SchedulerConfig.slow_ms`` to turn them on).

Overload hardening (DESIGN.md §12) is opt-in per scheduler: set
``SchedulerConfig.admission`` / ``degrade`` / ``breaker`` to run
deadline-aware cost-budget admission, a graceful-degradation ladder,
and a per-collection circuit breaker in front of the ``max_queue``
backstop; every ``submit_*`` then accepts ``deadline_ms=`` /
``priority=``.

>>> import numpy as np
>>> from repro_torch.serving import CollectionConfig, Scheduler
>>> sched = Scheduler(device="cpu")
>>> _ = sched.create_collection("docs", CollectionConfig(L=8, b=2))
>>> fut = sched.submit_insert("docs", np.zeros((3, 8), np.uint8))
>>> nn = sched.submit_topk("docs", np.zeros(8, np.uint8), k=2)
>>> _ = sched.pump()            # synchronous drive (or .start() threads)
>>> fut.result().tolist()
[0, 1, 2]
>>> nn.result().ids.tolist()
[0, 1]
"""

from .batching import bucket_m, bucket_table, pad_to_bucket
from .collections import Collection, CollectionConfig, CollectionRegistry
from .metrics import LatencyWindow, ServingMetrics
from .overload import (AdmissionConfig, AdmissionController, BreakerConfig,
                       CircuitBreaker, DeadlineExceeded, DegradePolicy,
                       SlowDispatchInjector)
from .scheduler import (OverloadError, Scheduler, SchedulerConfig,
                        SearchResponse, TopKResponse)

__all__ = [
    "bucket_m", "bucket_table", "pad_to_bucket",
    "Collection", "CollectionConfig", "CollectionRegistry",
    "LatencyWindow", "ServingMetrics",
    "AdmissionConfig", "AdmissionController", "BreakerConfig",
    "CircuitBreaker", "DeadlineExceeded", "DegradePolicy",
    "SlowDispatchInjector",
    "OverloadError", "Scheduler", "SchedulerConfig",
    "SearchResponse", "TopKResponse",
]
