"""The crash-at-every-point harness of the port's durable store — the
enumeration of ``tests/test_durability.py`` run on ``repro_torch``,
shared by ``tests/test_torch_store_crash*.py`` (split in three files so
that ``--dist loadfile`` spreads the cases: every crash point waits on
the filesystem's fsync and rename).

The fault harness first runs a canonical workload in *counting* mode to
enumerate every fsync/rename boundary the store crosses (WAL syncs,
segment and manifest renames, live-lane rewrites, WAL truncations),
then a parametrization replays the workload once per boundary: crash
there, recover with a fresh store, finish the workload, and require the
final state bit-identical (segment ids/columns/tombstones, delta buffer,
space ledger, and every tenth point the answers) to the port's own
never-crashed index.  Every point for the bst backend, a sample for the
multi backend and the sharded stacks, as the JAX package's own tests
take them.  The two packages meet in ``tests/test_torch_store.py`` and
in ``test_crash_points_match_jax``.
"""

import os
import tempfile
from unittest import mock

import numpy as np
import torch

from repro import store as jstore
from repro.core import segments as jseg
from repro_torch.core.segments import SegmentedIndex, ShardedSegmentedIndex
from repro_torch.store import CollectionStore, CrashPoint, FaultInjector

L, B = 8, 2
ROWS = np.random.default_rng(7).integers(0, 1 << B, size=(32, L),
                                         dtype=np.uint8)

# The canonical workload of tests/test_durability.py: auto-flush,
# size-tiered merge, tombstones in sealed segments and in the delta
# buffer, compaction, live-lane rewrites, and WAL truncation.
OPS = [
    ("insert", (0, 12)),        # auto-flush -> seg(12)
    ("delete", (2, 5, 11)),
    ("insert", (12, 18)),       # 6 delta rows
    ("insert", (18, 22)),       # flush seg(10) + merge -> seg(19)
    ("delete", (0, 1, 13, 17)),
    ("compact", None),          # seg(19) -> seg(15)
    ("insert", (22, 26)),       # 4 delta rows
    ("delete", (3, 22)),        # one sealed + one delta tombstone
    ("insert", (26, 32)),       # flush seg(9), live rewrite, merge
]
# global ids ever assigned after each op completes (the in-flight-op
# probe: an insert is already recovered iff the allocator advanced)
N_IDS_AFTER = [12, 12, 18, 22, 22, 22, 26, 26, 32]


def make_index(kind, pkg="torch"):
    if pkg == "jax":
        return (jseg.ShardedSegmentedIndex(L, B, 2, delta_cap=4)
                if kind == "stacks"
                else jseg.SegmentedIndex(L, B, delta_cap=8, backend=kind))
    if kind == "stacks":
        return ShardedSegmentedIndex(L, B, 2, delta_cap=4, device="cpu")
    return SegmentedIndex(L, B, delta_cap=8, backend=kind, device="cpu")


def _stacks(index):
    return list(index.shards) if hasattr(index, "shards") else [index]


def _apply(index, op):
    kind, arg = op
    if kind == "insert":
        index.insert(ROWS[arg[0]:arg[1]])
    elif kind == "delete":
        index.delete(np.asarray(arg, np.int64))
    else:
        index.compact(min_dead_frac=0.0)


_REF_CACHE = {}


def _reference(kind):
    """The never-crashed, never-persisted reference index (built once)."""
    if kind not in _REF_CACHE:
        index = make_index(kind)
        for op in OPS:
            _apply(index, op)
        _REF_CACHE[kind] = index
    return _REF_CACHE[kind]


_POINT_CACHE = {}


def points(kind, pkg="torch"):
    """Counting mode: run the workload once with an unarmed injector to
    enumerate every crash point the store crosses (their labels)."""
    if (kind, pkg) not in _POINT_CACHE:
        # fsync does not decide the labels: a no-op here, as in
        # crash_recover_verify
        with tempfile.TemporaryDirectory() as d, \
                mock.patch.object(os, "fsync", lambda fd: None):
            if pkg == "jax":
                fi = jstore.FaultInjector()
                store = jstore.CollectionStore(os.path.join(d, "c"),
                                               fsync_every=1, faults=fi)
            else:
                fi = FaultInjector()
                store = CollectionStore(os.path.join(d, "c"), fsync_every=1,
                                        faults=fi)
            index = store.attach(make_index(kind, pkg))
            for op in OPS:
                _apply(index, op)
            _POINT_CACHE[(kind, pkg)] = list(fi.points)
    return _POINT_CACHE[(kind, pkg)]


def n_points(kind):
    return len(points(kind))


def _assert_state_equal(rec, ref):
    """Bit-identical index state: segment ids / packed columns /
    tombstones (in stack order), delta buffers, allocator, ledger.
    Serials are process-monotonic and therefore not value-compared
    across independently built indexes."""
    assert rec.n_ids == ref.n_ids
    assert rec.n_live == ref.n_live
    for sr, sf in zip(_stacks(rec), _stacks(ref)):
        assert len(sr.segments) == len(sf.segments)
        for a, b in zip(sr.segments, sf.segments):
            np.testing.assert_array_equal(a.ids, b.ids)
            np.testing.assert_array_equal(a.packed, b.packed)
            np.testing.assert_array_equal(a.live, b.live)
        np.testing.assert_array_equal(sr._delta_ids, sf._delta_ids)
        np.testing.assert_array_equal(sr._delta_sk, sf._delta_sk)
        np.testing.assert_array_equal(sr._delta_live, sf._delta_live)
    assert (rec.space_ledger()["model_bits"]
            == ref.space_ledger()["model_bits"])


def _assert_queries_equal(rec, ref):
    """The observable contract: identical search planes, top-k results,
    and (after one identical warm query on each side) space ledgers."""
    qs = ROWS[:4]
    a, b = rec.topk_batch(qs, 3), ref.topk_batch(qs, 3)
    assert torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
    assert a.tau == b.tau
    ra, rb = rec.search_batch(qs, 2), ref.search_batch(qs, 2)
    assert torch.equal(ra.mask, rb.mask) and torch.equal(ra.dist, rb.dist)
    assert rec.space_ledger() == ref.space_ledger()


def crash_recover_verify(tmp_path, kind, point, monkeypatch):
    """Crash the canonical workload at fault point ``point``, recover
    with a fresh store, finish the workload, and require the result
    bit-identical to the never-crashed reference.

    The harness kills the *process*, never the OS: the page cache
    outlives a simulated crash, so an ``fsync`` changes nothing that the
    recovery (in the same OS) can read.  It is a no-op here — on this
    kind of disk, unlinking an fsynced file waits tens of ms for the
    discard — while ``tests/test_torch_store.py`` runs the real ones."""
    monkeypatch.setattr(os, "fsync", lambda fd: None)
    d = str(tmp_path / "c")
    done = 0
    try:
        # even creating the empty WAL is an atomic write with crash
        # points — construction stays inside the blast radius
        store = CollectionStore(d, fsync_every=1,
                                faults=FaultInjector(crash_at=point))
        index = store.attach(make_index(kind))
        for op in OPS:
            _apply(index, op)
            done += 1
    except CrashPoint:
        pass
    # hard kill: the store object is abandoned (no close(), which would
    # rescue buffered-but-unsynced WAL records)

    store2 = CollectionStore(d, fsync_every=1)
    rec = store2.recover(make_index(kind))
    if done < len(OPS):
        kind_op, arg = OPS[done]
        if kind_op == "insert":
            # the in-flight insert is already recovered iff its WAL
            # record reached the log before the crash (allocator probe)
            if rec.n_ids < N_IDS_AFTER[done]:
                _apply(rec, OPS[done])
            assert rec.n_ids == N_IDS_AFTER[done]
        else:
            _apply(rec, OPS[done])          # deletes/compacts: idempotent
        for op in OPS[done + 1:]:
            _apply(rec, op)

    ref = _reference(kind)
    _assert_state_equal(rec, ref)
    # recovered serials stay unique (the cache-key invariant)
    serials = [s.serial for st in _stacks(rec) for s in st.segments]
    assert len(set(serials)) == len(serials)
    if point % 10 == 0 or point == n_points(kind) - 1:
        _assert_queries_equal(rec, ref)
    store2.close()
