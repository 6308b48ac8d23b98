"""Streaming ingest on the PyTorch / CUDA port: serve similarity search
while the corpus changes.

    PYTHONPATH=src python examples/streaming_ingest_torch.py [--device cuda|cpu]

``examples/streaming_ingest.py`` on ``repro_torch``.  The dynamic
segmented index keeps a mutable delta buffer in front of immutable bST
segments so inserts and deletes land without ever blocking search.  This
example

  1. streams 10k sketches in through ``insert`` (auto-flushing sealed
     segments along the way),
  2. queries mid-stream (delta buffer + segments answer together),
  3. deletes a slice and triggers a size-tiered ``merge`` + ``compact``,
  4. checks the answers the strong way: after at least one merge, the
     segmented ``topk_batch`` must return **exactly** the same
     (distance, id) pairs as a fresh static bST built from the surviving
     sketches,
  5. makes the index durable: the same stream journaled and snapshotted
     into a temporary data directory, "crashed" (abandoned without a
     close), recovered on the device and checked against the live index.

On ``cuda`` the verify, scan and re-rank run through the hand-written
kernels; on ``cpu`` through their plain PyTorch versions.
"""

import argparse
import tempfile

import numpy as np

from repro_torch.core import SegmentedIndex, build_bst, topk_batch
from repro_torch.store import CollectionStore


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    rng = np.random.default_rng(0)
    n, L, b, k = 10_000, 16, 2, 10
    db = rng.integers(0, 1 << b, size=(n, L), dtype=np.uint8)
    queries = np.concatenate([
        db[rng.integers(0, n, 4)],
        rng.integers(0, 1 << b, size=(2, L), dtype=np.uint8)])

    # 1. stream the corpus in (chunks of 500; delta seals every 1800 —
    #    chosen so the mid-stream query below sees a non-empty delta)
    idx = SegmentedIndex(L, b, delta_cap=1800, device=args.device)
    inserted = np.zeros((0,), np.int64)
    for lo in range(0, n // 2, 500):
        inserted = np.concatenate([inserted, idx.insert(db[lo:lo + 500])])

    # 2. query mid-stream: sealed segments + the live delta buffer
    st = idx.stats()
    assert st["delta_rows"] > 0  # the delta buffer really answers queries
    mid = idx.topk_batch(queries, k)
    print(f"mid-stream on {idx.device}: {st['n_live']} live ids across "
          f"{len(st['segments'])} segments + {st['delta_rows']} delta rows; "
          f"top-1 dists {mid.dists[:, 0].tolist()} (tau*={mid.tau})")

    # 3. keep streaming, delete 1500 ids, force a merge + compact
    for lo in range(n // 2, n, 500):
        inserted = np.concatenate([inserted, idx.insert(db[lo:lo + 500])])
    victims = inserted[rng.choice(n, 1500, replace=False)]
    removed = idx.delete(victims)
    idx.flush()
    idx.maybe_merge()
    if idx.counters["merges"] == 0:   # tiny tiers can miss: force one
        idx.merge()
    idx.compact(min_dead_frac=0.1)
    st = idx.stats()
    print(f"after stream: removed {removed}, merges={st['merges']}, "
          f"compactions={st['compactions']}, segments="
          f"{st['segments']}, space={st['space_bits'] / 8 / 1024:.1f} KiB")
    assert st["merges"] >= 1

    # 4. exactness: bit-identical to a fresh static build on survivors
    surv = np.ones(n, bool)
    surv[victims] = False
    surv_ids = np.flatnonzero(surv)
    static = topk_batch(build_bst(db[surv], b, device=args.device),
                        queries, k)
    s_ids = static.ids.cpu().numpy()
    mapped = np.where(s_ids >= 0, surv_ids[np.maximum(s_ids, 0)], -1)
    dyn = idx.topk_batch(queries, k)
    np.testing.assert_array_equal(dyn.dists.cpu().numpy(),
                                  static.dists.cpu().numpy())
    np.testing.assert_array_equal(dyn.ids.cpu().numpy(), mapped)
    print(f"exactness check: segmented top-{k} == static rebuild on "
          f"{surv.sum()} survivors (exact ids AND distances) — OK")

    # 5. durability: journal + snapshots, a hard kill, recovery
    with tempfile.TemporaryDirectory() as root:
        store = CollectionStore(root)
        live = store.attach(SegmentedIndex(L, b, delta_cap=1800,
                                           device=args.device))
        for lo in range(0, n, 500):
            live.insert(db[lo:lo + 500])
        live.delete(victims)
        store.wal.sync()                 # then abandoned: no close()
        rec = CollectionStore(root).recover(
            SegmentedIndex(L, b, delta_cap=1800, device=args.device))
        a, r = live.topk_batch(queries, k), rec.topk_batch(queries, k)
        assert (a.ids.cpu().numpy() == r.ids.cpu().numpy()).all()
        assert (a.dists.cpu().numpy() == r.dists.cpu().numpy()).all()
        st = store.stats()
        print(f"durability: {st['segments_written']} segment snapshots, "
              f"{st['wal_bytes']} journal bytes; recovered "
              f"{rec.n_live} live ids on {rec.device}, same top-{k} — OK")


if __name__ == "__main__":
    main()
