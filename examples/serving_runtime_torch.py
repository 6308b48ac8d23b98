"""Serving-runtime walkthrough on the PyTorch / CUDA port: two tenants,
one micro-batching scheduler (DESIGN.md §5).

    PYTHONPATH=src python examples/serving_runtime_torch.py [--device cuda|cpu]

``examples/serving_runtime.py`` on ``repro_torch``: registers two
collections with different geometries and merge policies on the
device, starts the threaded scheduler (one worker thread per
collection), pushes a mixed request stream (inserts, deletes,
individually submitted top-k lookups that the scheduler coalesces into
power-of-two shape buckets), demonstrates overload rejection on a tiny
queue, and prints the ``/stats`` dump.
"""

import argparse

import numpy as np

from repro_torch.serving import (CollectionConfig, OverloadError, Scheduler,
                                 SchedulerConfig)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    rng = np.random.default_rng(0)

    sched = Scheduler(config=SchedulerConfig(max_batch=16, max_queue=256,
                                             max_wait_ms=2.0),
                      device=args.device)
    # tenant isolation: each collection has its own geometry, merge
    # policy, queue, and worker — "products" compacts eagerly after
    # deletes
    sched.create_collection("docs", CollectionConfig(L=32, b=4,
                                                     delta_cap=512))
    sched.create_collection("products", CollectionConfig(
        L=16, b=2, delta_cap=256, compact_dead_frac=0.3))
    sched.start()

    # -- ingest two corpora through the write surface -------------------
    docs = rng.integers(0, 16, size=(2000, 32), dtype=np.uint8)
    prods = rng.integers(0, 4, size=(1000, 16), dtype=np.uint8)
    doc_ids = sched.submit_insert("docs", docs).result()
    prod_ids = sched.submit_insert("products", prods).result()
    print(f"ingested {len(doc_ids)} docs + {len(prod_ids)} products on "
          f"{sched.registry.device}")

    # -- a burst of single-query lookups: the scheduler coalesces them --
    futs = [sched.submit_topk("docs", docs[i], k=5) for i in range(40)]
    answers = [f.result() for f in futs]
    assert all(int(a.ids[0]) == i for i, a in enumerate(answers))
    print(f"40 individually submitted lookups -> "
          f"batch-fill {sched.metrics.batch_fill_ratio():.2f} "
          f"(1.0 = every dispatch filled its power-of-two bucket)")

    # -- writes interleave without rebuilding a program -----------------
    removed = sched.submit_delete("products", prod_ids[:300]).result()
    nn = sched.submit_topk("products", prods[0], k=3).result()
    assert int(nn.ids[0]) != 0            # id 0 was tombstoned
    print(f"deleted {removed} products; post-delete NN of products[0]: "
          f"{nn.ids.tolist()} (id 0 gone)")

    # -- admission control: a full queue rejects instead of queueing ----
    tiny = Scheduler(config=SchedulerConfig(max_queue=4),
                     device=args.device)
    tiny.create_collection("t", CollectionConfig(L=8, b=2))
    rejected = 0
    for _ in range(10):                   # never pumped -> queue fills
        try:
            tiny.submit_search("t", np.zeros(8, np.uint8), tau=1)
        except OverloadError:
            rejected += 1
    print(f"overload demo: {rejected}/10 requests explicitly rejected")

    sched.stop()
    print("\n--- /stats ---")
    print(sched.render_stats())


if __name__ == "__main__":
    main()
