"""Collection registry: multiple independent dynamic indexes behind one
scheduler (DESIGN.md §5) — the port of ``repro.serving.collections``.

A **collection** is one named corpus — its own ``SegmentedIndex`` (or
``ShardedSegmentedIndex``), its own (b, L) sketch geometry, backend, and
merge policy.  Tenants are isolated at the collection level: requests
queue per collection, a merge or compaction in one collection never
blocks another, and global ids are scoped per collection.

The device is the registry's, never the config's: ``collection.json``
holds ``dataclasses.asdict(CollectionConfig)`` exactly as the JAX
package writes and reads it, so a data directory written by either
package opens in the other.
"""

from __future__ import annotations

import dataclasses
import os
import re
import threading
from typing import Dict, List, Optional

from ..core.hamming import resolve_device
from ..core.segments import BACKENDS, SegmentedIndex, ShardedSegmentedIndex
from ..kernels.ops import DEFAULT_BLOCK_M
from ..store import CollectionStore

__all__ = ["CollectionConfig", "Collection", "CollectionRegistry"]

# durable collection names become directory names — keep them portable
_NAME_RE = re.compile(r"^[A-Za-z0-9._-]+$")


@dataclasses.dataclass(frozen=True)
class CollectionConfig:
    """Per-collection geometry + maintenance policy.

    Attributes:
      L, b:         sketch length / bits per character (Σ = [0, 2^b)).
      backend:      segment backend — "bst" (default), "multi", "sharded".
      delta_cap:    delta-buffer rows before a segment seals.
      auto_merge:   run the size-tiered merge policy after auto-flushes.
      compact_dead_frac: when set, the scheduler opportunistically
                    compacts segments whose dead fraction exceeds this
                    after a delete (None = manual compaction only).
      n_stacks:     > 1 builds a ``ShardedSegmentedIndex`` with this many
                    independent per-shard segment stacks.
      use_arena:    serve reads through the fused one-dispatch segment
                    arena (DESIGN.md §6; default) — read latency stays
                    flat in the collection's segment count.
      layout:       sealed-column layout — "suffix" (default; packed
                    below each segment's traversal root, DESIGN.md §7)
                    or "full" (full-length reference layout).
      hot_bytes:    device budget for sealed columns.  None (default)
                    keeps every block device-resident; a byte budget
                    demotes least-recently-used blocks to the host cold
                    tier, served via staged copy-ahead slabs.
      payload_words: uint32 words per row payload bitmap (DESIGN.md §10).
                    When set, inserts carry ``payloads`` and topk
                    requests may ask for the exact two-stage
                    ``rerank=`` contract; None disables re-ranking.
      default_deadline_ms: latency budget applied to this collection's
                    requests that pass ``deadline_ms=None`` (DESIGN.md
                    §12); wins over the scheduler-wide default.  None
                    (default) = defer to the scheduler.
      priority:     default request priority for this collection's
                    tenants; > 0 bypasses cost-budget admission (still
                    subject to the hard ``max_queue`` backstop and the
                    circuit breaker).
      mi_blocks / n_shards / lam / block_m: forwarded to the index.
    """

    L: int
    b: int
    backend: str = "bst"
    delta_cap: int = 4096
    auto_merge: bool = True
    compact_dead_frac: Optional[float] = None
    n_stacks: int = 1
    mi_blocks: int = 2
    n_shards: int = 4
    lam: float = 0.5
    block_m: int = DEFAULT_BLOCK_M
    use_arena: bool = True
    layout: str = "suffix"
    hot_bytes: Optional[int] = None
    payload_words: Optional[int] = None
    default_deadline_ms: Optional[float] = None
    priority: int = 0

    def create(self, device="cuda"):
        """Instantiate the configured dynamic index on ``device``."""
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}")
        kw = dict(delta_cap=self.delta_cap, backend=self.backend,
                  lam=self.lam, auto_merge=self.auto_merge,
                  block_m=self.block_m, use_arena=self.use_arena,
                  layout=self.layout, hot_bytes=self.hot_bytes,
                  payload_words=self.payload_words, device=device)
        if self.n_stacks > 1:
            return ShardedSegmentedIndex(self.L, self.b, self.n_stacks, **kw)
        return SegmentedIndex(self.L, self.b, mi_blocks=self.mi_blocks,
                              n_shards=self.n_shards, **kw)


@dataclasses.dataclass
class Collection:
    """One registered collection: config + live index (+ durable store
    when the registry has a ``data_dir``)."""

    name: str
    config: CollectionConfig
    index: object
    store: Optional[CollectionStore] = None

    def stats(self) -> Dict[str, object]:
        out = self.index.stats()
        if self.store is not None:
            out["store"] = self.store.stats()
        return out


class CollectionRegistry:
    """Thread-safe name -> Collection map.

    With a ``data_dir`` every collection is durable: creates bind a
    :class:`repro_torch.store.CollectionStore` under
    ``<data_dir>/<name>/`` (journaling writes, snapshotting sealed
    segments), and :meth:`CollectionRegistry.open` rebuilds the whole
    registry from disk after a crash or restart (DESIGN.md §8).

    Every index of the registry lives on ``device`` (default "cuda";
    raises without a card, as every entry point of the port does).

    >>> reg = CollectionRegistry(device="cpu")
    >>> _ = reg.create("docs", CollectionConfig(L=8, b=2))
    >>> reg.names()
    ['docs']
    >>> reg.get("docs").config.b
    2
    """

    def __init__(self, data_dir: Optional[str] = None, *,
                 fsync_every: int = 64, device="cuda"):
        self._lock = threading.Lock()
        self._collections: Dict[str, Collection] = {}
        self.data_dir = data_dir
        self.fsync_every = int(fsync_every)
        self.device = resolve_device(device)

    @classmethod
    def open(cls, data_dir: str, *, fsync_every: int = 64,
             device="cuda") -> "CollectionRegistry":
        """Recover every collection persisted under ``data_dir``: load
        manifest segments, replay each WAL into the delta buffer, restore
        id allocators and the segment-serial floor.  Directories without
        a ``collection.json`` (never fully created) are skipped.  The
        segments are rebuilt on ``device``."""
        reg = cls(data_dir=data_dir, fsync_every=fsync_every, device=device)
        if not os.path.isdir(data_dir):
            return reg
        for name in sorted(os.listdir(data_dir)):
            root = os.path.join(data_dir, name)
            cfg_dict = CollectionStore.load_config(root)
            if not os.path.isdir(root) or cfg_dict is None:
                continue
            config = CollectionConfig(**cfg_dict)
            store = CollectionStore(root, fsync_every=fsync_every)
            index = store.recover(config.create(reg.device))
            with reg._lock:
                reg._collections[name] = Collection(
                    name=name, config=config, index=index, store=store)
        return reg

    def create(self, name: str, config: CollectionConfig) -> Collection:
        with self._lock:
            if name in self._collections:
                raise ValueError(f"collection {name!r} already exists")
            store = None
            if self.data_dir is not None:
                if not _NAME_RE.match(name):
                    raise ValueError(
                        f"durable collection name {name!r} must match "
                        f"{_NAME_RE.pattern}")
                store = CollectionStore(os.path.join(self.data_dir, name),
                                        fsync_every=self.fsync_every)
            index = config.create(self.device)
            if store is not None:
                store.attach(index)
                store.save_config(dataclasses.asdict(config))
            coll = Collection(name=name, config=config, index=index,
                              store=store)
            self._collections[name] = coll
            return coll

    def get(self, name: str) -> Collection:
        with self._lock:
            try:
                return self._collections[name]
            except KeyError:
                raise KeyError(f"unknown collection {name!r}") from None

    def drop(self, name: str) -> None:
        """Unregister a collection.  A durable collection's store is
        closed (WAL synced) but its on-disk state is retained — a later
        ``open`` still recovers it."""
        with self._lock:
            coll = self._collections.pop(name, None)
        if coll is not None and coll.store is not None:
            coll.store.close()

    def close(self) -> None:
        """Sync and close every durable collection's store."""
        with self._lock:
            colls = list(self._collections.values())
        for coll in colls:
            if coll.store is not None:
                coll.store.close()

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._collections)

    def stats(self) -> Dict[str, Dict[str, object]]:
        """Per-collection index stats (occupancy, segments, tombstones)."""
        with self._lock:
            colls = list(self._collections.values())
        return {c.name: c.stats() for c in colls}
