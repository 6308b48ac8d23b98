"""Durable collection store: segment snapshots + delta-buffer WAL +
recover-on-start — the port of ``repro.store.store`` over the torch
``Segment``.  The on-disk format is the JAX package's, file for file and
dtype for dtype (``Segment.packed``, ``ids``, ``live`` and ``payloads``
are host numpy arrays in both packages), so a directory written by
either package recovers in the other.  Recovery rebuilds every segment
with the index's own build function, on the index's device.

The LSM split in ``core/segments.py`` makes durability almost free:
sealed ``Segment``s are immutable, so each one is snapshotted exactly
once as an atomic directory; the only mutable state is (a) the delta
buffer — journaled by the :mod:`repro_torch.store.wal` — and (b) the
tombstone bitmaps, whose dirty lanes are rewritten at the next
checkpoint (their delete records stay in the WAL until then, so a crash
loses nothing).

On-disk layout (one root per collection)::

    <root>/collection.json              # CollectionConfig (registry)
    <root>/wal.log                      # insert/delete journal
    <root>/MANIFEST.json                # single-stack collections
    <root>/seg_<serial>/                #   arrays.npz  (packed, ids)
                                        #   live.npy    (tombstone bitmap)
                                        #   meta.json   (serial, n, L, b)
    <root>/stack_<s>/...                # sharded: one subtree per stack

``MANIFEST.json`` is the commit point: it names the live segment set
(with merge lineage), the stack's id allocator, a ``serial_floor`` that
keeps post-recovery serials collision-free with every serial ever
persisted, and ``sealed_seq`` — the last WAL sequence number whose
insert rows this stack has sealed into segments.  Every manifest/segment
write uses the atomic tmp-pid → fsync → rename protocol from
:mod:`repro_torch.store.atomic`, so a crash mid-flush/merge/compact recovers
to either the pre- or post-operation segment set, never a mix.

Recovery replays the WAL in order: an insert record applies to a stack
iff its seq is beyond that stack's ``sealed_seq`` (so rows that were
sealed — even ones later compacted away — are never resurrected), and
delete records are idempotent re-tombstones.  The WAL is truncated only
at checkpoints where *every* stack's delta buffer is empty and persisted,
which is what makes the sealed-seq filter sufficient: the journal always
covers everything the snapshots don't.
"""

from __future__ import annotations

import io
import json
import os
import re
import shutil
from typing import Dict, List, Optional

import numpy as np

from ..core.hamming import unpack_vertical
from ..core.segments import Segment, ensure_serial_floor
from .atomic import (atomic_write_bytes, atomic_write_dir, atomic_write_json,
                     read_json, sweep_stale_tmp)
from .wal import (OP_DELETE, OP_INSERT, OP_INSERT_PAYLOAD, WriteAheadLog,
                  decode_delete, decode_insert, decode_insert_payload,
                  encode_delete, encode_insert, encode_insert_payload,
                  read_wal)

_SEG_RE = re.compile(r"^seg_(\d+)$")
_MANIFEST_VERSION = 1
_LINEAGE_KEEP = 32


class StackBinding:
    """What a ``SegmentedIndex`` sees as ``self.store``: log-before-apply
    write hooks and a checkpoint hook fired after flush/merge/compact.
    Shard-level stacks of a ``ShardedSegmentedIndex`` bind with
    ``log_writes=False`` — the top-level index journals global-id records
    once, while each stack still snapshots its own segments."""

    __slots__ = ("store", "stack_id", "log_writes")

    def __init__(self, store: "CollectionStore", stack_id: Optional[int],
                 log_writes: bool):
        self.store = store
        self.stack_id = stack_id
        self.log_writes = log_writes

    def log_insert(self, ids: np.ndarray, sk: np.ndarray,
                   payloads: Optional[np.ndarray] = None) -> None:
        if self.log_writes:
            self.store.log_insert(ids, sk, payloads=payloads)

    def log_delete(self, ids: np.ndarray) -> None:
        if self.log_writes:
            self.store.log_delete(ids)

    def begin_write(self) -> None:
        self.store.begin_write()

    def end_write(self) -> None:
        self.store.end_write()

    def checkpoint(self, idx) -> None:
        if self.stack_id is not None:
            self.store.checkpoint(self.stack_id)


class CollectionStore:
    """Durability engine for one collection (any backend, sharded or
    not).  ``attach`` binds a *fresh* index for durable writes;
    ``recover`` rebuilds a previously persisted index into a fresh one.
    """

    def __init__(self, root: str, *, fsync_every: int = 64, faults=None):
        self.root = root
        self.faults = faults
        os.makedirs(root, exist_ok=True)
        swept = sweep_stale_tmp(root)
        self.wal = WriteAheadLog(os.path.join(root, "wal.log"),
                                 fsync_every=fsync_every, faults=faults)
        self.index = None
        self._stacks: List[object] = []
        self._sharded = False
        self._replaying = False
        self._write_depth = 0
        # per stack: serial -> n_dead as persisted on disk, and the
        # manifest metadata (n_ids / sealed_seq / serial_floor / lineage)
        self._persisted: List[Dict[int, int]] = []
        self._meta: List[Dict[str, object]] = []
        self.counters: Dict[str, int] = {
            "checkpoints": 0, "segments_written": 0, "live_rewrites": 0,
            "wal_truncations": 0, "replayed_records": 0,
            "recovered_segments": 0, "wal_dropped_bytes":
            self.wal.dropped_bytes, "swept_tmp": len(swept)}

    # -- binding ---------------------------------------------------------

    def attach(self, index) -> object:
        """Bind a fresh (empty) index for durable writes.  Must happen
        before the first insert — rows already in memory are not
        journaled retroactively."""
        self.index = index
        self._sharded = hasattr(index, "shards")
        self._stacks = list(index.shards) if self._sharded else [index]
        last = self.wal.next_seq - 1
        self._persisted = [dict() for _ in self._stacks]
        self._meta = [{"n_ids": None, "sealed_seq": last,
                       "serial_floor": 0, "lineage": []}
                      for _ in self._stacks]
        for i, st in enumerate(self._stacks):
            st.store = StackBinding(self, i, log_writes=not self._sharded)
        if self._sharded:
            index.store = StackBinding(self, None, log_writes=True)
        return index

    def _stack_dir(self, i: int) -> str:
        if not self._sharded:
            return self.root
        return os.path.join(self.root, f"stack_{i:04d}")

    # -- write path ------------------------------------------------------

    def log_insert(self, ids: np.ndarray, sk: np.ndarray,
                   payloads: Optional[np.ndarray] = None) -> None:
        if not self._replaying and len(ids):
            if payloads is not None:
                self.wal.append(OP_INSERT_PAYLOAD,
                                encode_insert_payload(ids, sk, payloads))
            else:
                self.wal.append(OP_INSERT, encode_insert(ids, sk))

    def log_delete(self, ids: np.ndarray) -> None:
        if not self._replaying and len(ids):
            self.wal.append(OP_DELETE, encode_delete(ids))

    def begin_write(self) -> None:
        """Mark a multi-stack write in flight: a sharded index journals
        one global record, then routes rows to its stacks one by one.  A
        checkpoint fired mid-routing (a shard's auto-flush) must neither
        advance a *sibling* stack's ``sealed_seq`` over the in-flight
        record nor truncate the journal — the siblings have not applied
        their rows yet, and a crash would lose them."""
        self._write_depth += 1

    def end_write(self) -> None:
        self._write_depth -= 1

    def checkpoint(self, stack_id: int) -> None:
        """Persist one stack's segment set after a flush/merge/compact.
        Syncs the WAL first (so a delete whose lane rewrite lands in
        another stack's *next* checkpoint is never lost), then truncates
        the journal once every stack is empty and persisted.  The
        triggering stack's ``sealed_seq`` may advance even mid-write (it
        has applied its share of the in-flight record — routing is
        sequential), but sibling persistence and truncation wait until
        no write is in flight."""
        self.wal.sync()
        self._persist_stack(stack_id)
        if self._write_depth == 0:
            self._maybe_truncate()
        self.counters["checkpoints"] += 1

    def _persist_stack(self, i: int) -> None:
        idx = self._stacks[i]
        sdir = self._stack_dir(i)
        os.makedirs(sdir, exist_ok=True)
        pers = self._persisted[i]
        meta = self._meta[i]
        cur = {seg.serial: seg for seg in idx.segments}
        new, retired = [], [s for s in pers if s not in cur]
        for serial, seg in cur.items():
            if serial not in pers:
                self._write_segment(sdir, seg)
                new.append(serial)
            elif pers[serial] != seg.n - seg.n_live:
                buf = io.BytesIO()
                np.save(buf, seg.live)
                atomic_write_bytes(
                    os.path.join(sdir, f"seg_{serial:012d}", "live.npy"),
                    buf.getvalue(), faults=self.faults, label="live")
                self.counters["live_rewrites"] += 1
        sealed = (self.wal.next_seq - 1 if len(idx._delta_ids) == 0
                  else meta["sealed_seq"])
        floor = max([meta["serial_floor"]] + [s + 1 for s in cur])
        changed = (new or retired or meta["n_ids"] != idx.n_ids
                   or meta["sealed_seq"] != sealed
                   or meta["serial_floor"] != floor
                   or any(pers[s] != cur[s].n - cur[s].n_live
                          for s in cur if s in pers))
        if not changed:
            return
        lineage = list(meta["lineage"])
        if new or retired:
            lineage = (lineage + [{"new": sorted(new),
                                   "dropped": sorted(retired)}]
                       )[-_LINEAGE_KEEP:]
        manifest = {
            "version": _MANIFEST_VERSION,
            "n_ids": int(idx.n_ids),
            "sealed_seq": int(sealed),
            "serial_floor": int(floor),
            "segments": [{"serial": int(seg.serial), "n": seg.n,
                          "n_dead": seg.n - seg.n_live}
                         for seg in idx.segments],
            "lineage": lineage,
        }
        atomic_write_json(os.path.join(sdir, "MANIFEST.json"), manifest,
                          faults=self.faults, label="manifest")
        # the manifest is the commit point: only now is it safe to drop
        # retired segment directories (crash earlier -> old manifest
        # still references them; crash during the rmtree -> orphans the
        # next recovery sweeps)
        for serial in retired:
            shutil.rmtree(os.path.join(sdir, f"seg_{serial:012d}"),
                          ignore_errors=True)
        self._persisted[i] = {s: seg.n - seg.n_live
                              for s, seg in cur.items()}
        meta.update(n_ids=int(idx.n_ids), sealed_seq=int(sealed),
                    serial_floor=int(floor), lineage=lineage)

    def _write_segment(self, sdir: str, seg: Segment) -> None:
        def populate(tmp: str) -> None:
            arrays = {"packed": seg.packed, "ids": seg.ids}
            if seg.payloads is not None:
                arrays["payloads"] = seg.payloads
            np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            np.save(os.path.join(tmp, "live.npy"), seg.live)
            with open(os.path.join(tmp, "meta.json"), "w",
                      encoding="utf-8") as f:
                json.dump({"serial": int(seg.serial), "n": seg.n,
                           "L": seg.L, "b": seg.b}, f)
        atomic_write_dir(os.path.join(sdir, f"seg_{seg.serial:012d}"),
                         populate, faults=self.faults, label="seg")
        self.counters["segments_written"] += 1

    def _maybe_truncate(self) -> None:
        if any(len(st._delta_ids) for st in self._stacks):
            return
        for i in range(len(self._stacks)):
            self._persist_stack(i)          # no-op when already clean
        if self.wal.next_seq > self.wal.base_seq:
            self.wal.reset()
            self.counters["wal_truncations"] += 1

    # -- recovery --------------------------------------------------------

    def recover(self, index) -> object:
        """Rebuild ``index`` (fresh, empty, same config) from disk: load
        manifest segments, replay the WAL into the delta buffers, restore
        the id allocators and advance the global serial counter, then run
        the same maintenance fixpoint a live index would have run
        (flush-at-cap + size-tiered merge) so the recovered partition
        matches a never-crashed one."""
        self.attach(index)
        self._replaying = True
        try:
            floor = 0
            for i, st in enumerate(self._stacks):
                floor = max(floor, self._load_stack(i, st))
            if self._sharded:
                S = len(self._stacks)
                index.n_ids = max(
                    [0] + [(m["n_ids"] - 1) * S + s + 1
                           for s, m in enumerate(self._meta)
                           if m["n_ids"]])
            ensure_serial_floor(floor)
            _base, records, _dropped = read_wal(self.wal.path)
            for seq, op, payload in records:
                if op == OP_INSERT:
                    self._replay_insert(seq, *decode_insert(payload))
                elif op == OP_INSERT_PAYLOAD:
                    self._replay_insert(seq,
                                        *decode_insert_payload(payload))
                elif op == OP_DELETE:
                    index.delete(decode_delete(payload))
            self.counters["replayed_records"] += len(records)
        finally:
            self._replaying = False
        for st in self._stacks:
            if len(st._delta_ids) >= st.delta_cap:
                st.flush()
            if st.auto_merge:
                # restore the size-tier invariant: a crash between an
                # in-memory merge and its durable checkpoint recovers to
                # the pre-merge set; re-running the (idempotent) policy
                # converges it to what a never-crashed index holds
                st.maybe_merge()
        return index

    def _load_stack(self, i: int, st) -> int:
        sdir = self._stack_dir(i)
        man = read_json(os.path.join(sdir, "MANIFEST.json")) or {
            "n_ids": 0, "sealed_seq": -1, "serial_floor": 0,
            "segments": [], "lineage": []}
        segs: List[Segment] = []
        for ent in man["segments"]:
            d = os.path.join(sdir, f"seg_{ent['serial']:012d}")
            with np.load(os.path.join(d, "arrays.npz")) as arr:
                packed, ids = arr["packed"], arr["ids"]
                pay = arr["payloads"] if "payloads" in arr.files else None
            live = np.load(os.path.join(d, "live.npy"))
            sk = unpack_vertical(packed, st.b, st.L)
            segs.append(Segment(index=st._build(sk), packed=packed,
                                ids=ids, live=live, L=st.L, b=st.b,
                                serial=int(ent["serial"]), payloads=pay))
        st.segments = segs
        st.n_ids = int(man["n_ids"])
        self._persisted[i] = {seg.serial: seg.n - seg.n_live
                              for seg in segs}
        self._meta[i] = {"n_ids": int(man["n_ids"]),
                         "sealed_seq": int(man["sealed_seq"]),
                         "serial_floor": int(man["serial_floor"]),
                         "lineage": list(man.get("lineage", []))}
        self.counters["recovered_segments"] += len(segs)
        keep = {f"seg_{seg.serial:012d}" for seg in segs}
        if os.path.isdir(sdir):
            for name in os.listdir(sdir):      # orphans of a crashed write
                if _SEG_RE.match(name) and name not in keep:
                    shutil.rmtree(os.path.join(sdir, name),
                                  ignore_errors=True)
        return max([int(man["serial_floor"])]
                   + [seg.serial + 1 for seg in segs])

    def _replay_insert(self, seq: int, ids: np.ndarray, sk: np.ndarray,
                       pay: Optional[np.ndarray] = None) -> None:
        if self._sharded:
            S = len(self._stacks)
            for s, st in enumerate(self._stacks):
                if seq <= self._meta[s]["sealed_seq"]:
                    continue                    # already sealed pre-crash
                rows = np.flatnonzero(ids % S == s)
                if rows.size:
                    st._replay_insert(
                        ids[rows] // S, sk[rows],
                        payloads=pay[rows] if pay is not None else None)
            self.index.n_ids = max(self.index.n_ids, int(ids.max()) + 1)
        elif seq > self._meta[0]["sealed_seq"]:
            self._stacks[0]._replay_insert(ids, sk, payloads=pay)

    # -- config / observability -----------------------------------------

    def save_config(self, config: Dict[str, object]) -> None:
        atomic_write_json(os.path.join(self.root, "collection.json"),
                          config, faults=self.faults, label="config")

    @staticmethod
    def load_config(root: str) -> Optional[Dict[str, object]]:
        return read_json(os.path.join(root, "collection.json"))

    def stats(self) -> Dict[str, int]:
        snap = 0
        for dirpath, _dirnames, filenames in os.walk(self.root):
            for name in filenames:
                if name == "wal.log":
                    continue
                try:
                    snap += os.path.getsize(os.path.join(dirpath, name))
                except OSError:
                    pass
        return {"wal_bytes": self.wal.size_bytes(),
                "snapshot_bytes": snap, **self.counters}

    def close(self) -> None:
        self.wal.close()
