#!/usr/bin/env python3
"""Recovery smoke check on the PyTorch / CUDA port: ``tools/recovery_smoke.py``
over ``repro_torch.serving``.

A child process builds durable collections under a data dir — sealed
segment snapshots plus journaled-but-unsealed delta rows and tombstones
— records the answers it expects to survive, syncs the journal, and
then hard-kills itself with ``os._exit``: no ``close()``, no atexit, no
final flush.  That is exactly the crash the write-ahead log protects
against.  The parent re-opens the directory with
``CollectionRegistry.open`` on the same device and asserts:

1. **Bit-identical answers**: recovered top-k ids and distances equal
   the child's pre-crash answers for every collection, including rows
   that only ever existed in the journal and deletes of sealed rows.
2. **Collision-free resume**: the id allocator continues exactly where
   the crashed process stopped — new inserts extend, never overwrite.
3. **Replay actually happened**: the store counters show journal
   records were replayed (the corpus is built so the delta buffer is
   non-empty at the kill).

These are exact-value checks, deterministic on any runner, so the
script hard-fails on regression.

Usage: ``PYTHONPATH=src python tools/recovery_smoke_torch.py [n_rows]
[--device cuda|cpu]``
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np

from repro_torch.core.hamming import resolve_device
from repro_torch.serving import CollectionConfig, CollectionRegistry

L, B, K, TAIL = 16, 2, 10, 32
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def corpus(n: int):
    rng = np.random.default_rng(42)
    db = rng.integers(0, 1 << B, size=(n + TAIL, L), dtype=np.uint8)
    return db, db[:8]


def collections(n: int):
    return {
        "docs": CollectionConfig(L=L, b=B, delta_cap=max(8, n // 4)),
        "stacks": CollectionConfig(L=L, b=B, n_stacks=2,
                                   delta_cap=max(8, n // 8)),
    }


def child(data_dir: str, expected: str, n: int, device: str) -> None:
    db, qs = corpus(n)
    reg = CollectionRegistry(data_dir, fsync_every=8, device=device)
    out = {}
    for name, cfg in collections(n).items():
        coll = reg.create(name, cfg)
        chunk = max(8, n // 8)
        ids = np.zeros((0,), np.int64)
        for lo in range(0, n, chunk):           # seals segments mid-stream
            ids = np.concatenate([ids, coll.index.insert(db[lo:lo + chunk])])
        coll.index.delete(ids[::7])             # tombstones sealed rows
        coll.index.insert(db[n:n + TAIL])       # tail stays in the delta
        coll.store.wal.sync()                   # durable, but NOT sealed
        nn = coll.index.topk_batch(qs, K)
        out[f"{name}_ids"] = nn.ids.cpu().numpy()
        out[f"{name}_dists"] = nn.dists.cpu().numpy()
        out[f"{name}_n_ids"] = coll.index.n_ids
        out[f"{name}_n_live"] = coll.index.n_live
    np.savez(expected, **out)
    sys.stdout.flush()
    os._exit(17)                                # crash: no close, no flush


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_rows", nargs="?", type=int, default=2048)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--child", nargs=2, metavar=("DATA_DIR", "EXPECTED"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    n = args.n_rows
    resolve_device(args.device)          # no card: raise here, not in a child
    if args.child:
        child(*args.child, n, args.device)
        return 0                                # unreachable (os._exit)

    with tempfile.TemporaryDirectory(prefix="recovery_smoke_") as tmp:
        data = os.path.join(tmp, "data")
        expected = os.path.join(tmp, "expected.npz")
        env = dict(os.environ)
        env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), str(n),
             "--device", args.device, "--child", data, expected], env=env)
        assert proc.returncode == 17, \
            f"child died before the staged kill: rc={proc.returncode}"
        exp = np.load(expected)

        db, qs = corpus(n)
        reg = CollectionRegistry.open(data, device=args.device)
        assert reg.names() == sorted(collections(n)), reg.names()
        for name in reg.names():
            coll = reg.get(name)
            nn = coll.index.topk_batch(qs, K)
            np.testing.assert_array_equal(nn.ids.cpu().numpy(),
                                          exp[f"{name}_ids"])
            np.testing.assert_array_equal(nn.dists.cpu().numpy(),
                                          exp[f"{name}_dists"])
            assert coll.index.n_ids == int(exp[f"{name}_n_ids"])
            assert coll.index.n_live == int(exp[f"{name}_n_live"])
            st = coll.store.stats()
            assert st["replayed_records"] > 0, (name, st)
            # the allocator resumes collision-free past the crash
            n0 = coll.index.n_ids
            new = coll.index.insert(db[:3])
            np.testing.assert_array_equal(new, [n0, n0 + 1, n0 + 2])
            print(f"{name}: n_live={coll.index.n_live} "
                  f"replayed={st['replayed_records']} "
                  f"segments_recovered={st['recovered_segments']} "
                  f"on {args.device}")
        reg.close()
    print("recovery smoke OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
