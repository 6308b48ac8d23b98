"""Suffix column store: the layout layer of the segment data plane.

A full-length arena keeps one (b, W, R) verify column per sealed row.
That is redundant: the fused program's traversal already computes the
exact prefix distance down to every segment's collapse depth ℓ_s and
hands it to the verify through the gathered root base plane, so the
columns only need the **suffix** below ℓ_s.  Each sealed segment gets a
``_Block`` whose geometry depends on its own ℓ_s: when the b bit planes
of the S = L - ℓ_s suffix symbols fit one 32-bit word (b·S <= 32), the
row packs into a single word (``hamming.pack_suffix_words``, kernel
``sparse_verify_arena_packed``); otherwise the block falls back to
plane-packed (b, ceil(S/32), n) columns for the full-length arena kernel
with W = ceil(S/32).  Blocks of equal geometry share one kernel launch
inside the fused program.

Placement is per block.  Hot blocks keep their columns (and payload
bitmaps) on the index's device; cold blocks keep host master copies
only — pinned memory on a CUDA index, so that a copy from them is truly
asynchronous, plain host tensors on a CPU index.  ``stage()`` copies
every cold block of a geometry group into its slice of one device
staging slab, with ``non_blocking`` copies on a side stream; the fused
program makes its stream wait on the copies' event just before the
group's verify, so the transfer overlaps the traversal before it.
Demotion is LRU under the ``hot_bytes`` budget (``None`` = unlimited:
every block stays hot); freed budget promotes the most recently used
cold block back.  Tier flips bump ``gen``, which keys the fused-program
cache, so a program built for one placement never reads another's.

The store keeps the arena's maintenance surface (``serials``, ``live``,
``col_off``, ``col_ids``, ``array_bytes``): a flush appends a block, a
merge or compact rebuilds, and ``SegmentedIndex.delete`` flips device
liveness lanes in place through ``col_off``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..obs.trace import span as _obs_span
from .hamming import (as_words, n_words, pack_suffix_words, pack_vertical,
                      resolve_device)

WORD_BYTES = 4
TIER_HOT = "hot"
TIER_COLD = "cold"

# Process-wide placement counters: promotions/demotions count tier flips,
# prefetches the cold blocks staged to the device, staged_bytes the bytes
# those copies moved (staged_payload_bytes the payload-bitmap share).
_TIER_STATS = {"promotions": 0, "demotions": 0, "prefetches": 0,
               "staged_bytes": 0, "staged_payload_bytes": 0}


def tier_stats() -> Dict[str, int]:
    """Placement counters of the tiered column store: ``promotions`` /
    ``demotions`` (tier flips under the ``hot_bytes`` budget),
    ``prefetches`` (cold blocks copied ahead to a device staging slab)
    and ``staged_bytes`` (bytes those copies moved)."""
    return dict(_TIER_STATS)


def reset_tier_stats() -> None:
    for k in _TIER_STATS:
        _TIER_STATS[k] = 0


class SuffixGeometry(NamedTuple):
    """Column geometry of one segment's suffix block: ``suffix_len`` =
    L - ℓ_s symbols below the collapse depth; ``packed`` when all b bit
    planes fit one uint32 word per row (b·suffix_len <= 32);
    ``row_words`` the words per column (1 packed, b·ceil(S/32)
    plane-packed)."""

    suffix_len: int
    packed: bool
    row_words: int


def geometry_for(L: int, b: int, ls: int) -> SuffixGeometry:
    """Pick the layout for a segment collapsing at depth ``ls``."""
    S = int(L) - int(ls)
    if b * S <= 32:
        return SuffixGeometry(S, True, 1)
    return SuffixGeometry(S, False, b * n_words(S))


@dataclasses.dataclass
class _Block:
    """One sealed segment's suffix columns and their placement.

    ``cols_hot`` (device) and ``cols_cold`` (host) are mutually
    exclusive — exactly one is set, per the block's ``tier``.  Packed
    geometry stores (n,) int32 words, plane geometry (b, W_sfx, n).
    ``base_idx`` (host, immutable once appended) is the segment-offset
    lane into the global root base plane; ``pays_hot`` / ``pays_cold``
    the (Wp, n) re-rank payload bitmaps, in the same tier as the columns
    (a tier flip moves both)."""

    serial: int
    n: int
    geom: SuffixGeometry
    base_idx: np.ndarray
    cols_hot: Optional[torch.Tensor] = None
    cols_cold: Optional[torch.Tensor] = None
    last_used: int = 0
    pays_hot: Optional[torch.Tensor] = None
    pays_cold: Optional[torch.Tensor] = None
    pay_words: int = 0

    @property
    def tier(self) -> str:
        return TIER_HOT if self.cols_hot is not None else TIER_COLD

    @property
    def col_bytes(self) -> int:
        return self.n * self.geom.row_words * WORD_BYTES

    @property
    def pay_bytes(self) -> int:
        return self.n * self.pay_words * WORD_BYTES

    @property
    def block_bytes(self) -> int:
        """Placement-budget charge: columns and payload bitmaps."""
        return self.col_bytes + self.pay_bytes


class _Group(NamedTuple):
    """One geometry group of the current plan: the fused program runs
    one verify launch per group.  The group's columns are its blocks in
    stack order, hot or cold (``perm`` maps them to global stack
    positions), so a cold block costs no permutation of the output
    planes; ``cols_hot`` / ``pays_hot`` hold them concatenated when every
    block is hot, and ``ColumnStore.assemble`` puts a mixed group
    together from its hot blocks and its staging slab."""

    geom: SuffixGeometry
    cols_hot: Optional[torch.Tensor]  # all columns, when every block is hot
    base_idx: torch.Tensor            # (n_group,) int32 device constant
    perm: np.ndarray                  # (n_group,) int64 stack positions
    blocks: Tuple[int, ...]           # indexes into store.blocks
    cold_blocks: Tuple[int, ...]      # the cold ones among them
    cold_bytes: int
    pays_hot: Optional[torch.Tensor] = None  # (Wp, n_group) bitmaps
    pay_cold_bytes: int = 0


class Staged(NamedTuple):
    """One group's staging slab: its cold blocks copied into one device
    tensor, and the event that the copies recorded on the store's side
    stream (None on a CPU index, where the copies are done on return)."""

    data: torch.Tensor
    event: Optional[object] = None

    def wait(self) -> torch.Tensor:
        """Order the current stream after the copies and return the
        slab.  ``record_stream`` keeps the allocator from handing the
        slab's memory to the side stream again before this stream's work
        on it is done."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.data.device)
            stream.wait_event(self.event)
            self.data.record_stream(stream)
        return self.data


class ColumnStore:
    """Tiered suffix column store for one segment stack (bst backend).

    A flush *appends* a block (and its liveness/gid/id lanes) without
    touching existing ones; a merge or compact changes the serial
    fingerprint non-monotonically and the owner rebuilds from scratch.
    ``delete`` flips the shared ``live`` lanes in place through
    ``col_off`` — liveness is an argument of every fused program call,
    so a delete never moves a block between tiers.
    """

    def __init__(self, L: int, b: int, hot_bytes: Optional[int] = None,
                 payload_words: Optional[int] = None, device="cuda"):
        self.L, self.b = int(L), int(b)
        self.hot_bytes = hot_bytes
        self.payload_words = payload_words
        self.device = resolve_device(device)
        self.serials: Tuple[int, ...] = ()
        self.blocks: List[_Block] = []
        self.live = torch.zeros((0,), dtype=torch.bool, device=self.device)
        self.gids = torch.zeros((0,), dtype=torch.int32, device=self.device)
        self.col_ids = np.zeros((0,), np.int64)
        self.col_off: Dict[int, int] = {}
        self.root_off: Dict[int, int] = {}
        self.t_root_total = 0
        self.gen = 0                   # bumped on every tier flip
        self._tick = 0                 # LRU clock
        self._plan: Optional[Tuple[_Group, ...]] = None
        self._stream = None            # side stream of the staging copies

    @property
    def n_cols(self) -> int:
        return int(self.col_ids.shape[0])

    # -- maintenance -----------------------------------------------------

    def append_segment(self, seg) -> None:
        """Append one sealed segment's block: suffix columns sliced below
        its own ℓ_s, packed per :func:`geometry_for`, plus the shared
        base-offset/gid/liveness/id lanes.  New blocks start hot; the
        budget is enforced at :meth:`seal`."""
        ls = int(seg.index.ls)
        geom = geometry_for(self.L, self.b, ls)
        sfx = seg.sketches[:, ls:]
        if geom.packed:
            cols = pack_suffix_words(sfx, self.b)            # (n,)
        else:
            cols = np.transpose(pack_vertical(sfx, self.b), (1, 2, 0))
        root0 = 1 + self.t_root_total        # slot 0: delta's trivial base
        tail = seg.index.tail
        base_idx = (root0 + tail.leaf_root.cpu().numpy()[
            seg.index.id_leaf.cpu().numpy()]).astype(np.int32)
        pays_hot = None
        pay_words = 0
        if self.payload_words is not None:
            if getattr(seg, "payloads", None) is None:
                raise ValueError(
                    "payload_words is set but the segment holds no payloads")
            pay_words = int(self.payload_words)
            pays_hot = as_words(seg.payloads.T, self.device)  # (Wp, n)
        self._tick += 1
        self.blocks.append(_Block(
            serial=seg.serial, n=seg.n, geom=geom, base_idx=base_idx,
            cols_hot=as_words(cols, self.device), last_used=self._tick,
            pays_hot=pays_hot, pay_words=pay_words))
        self.col_off[seg.serial] = self.n_cols
        self.root_off[seg.serial] = root0
        self.t_root_total += int(tail.t_root)
        self.live = torch.cat([self.live,
                               torch.from_numpy(seg.live).to(self.device)])
        self.gids = torch.cat([self.gids, torch.from_numpy(
            seg.ids.astype(np.int32)).to(self.device)])
        self.col_ids = np.concatenate([self.col_ids, seg.ids])
        self._plan = None

    def seal(self, serials: Tuple[int, ...]) -> None:
        """Stamp the stack fingerprint and enforce the placement budget
        (LRU demotion under pressure, promotion into freed room)."""
        self.serials = serials
        self._enforce_budget()

    def _to_host(self, x: torch.Tensor) -> torch.Tensor:
        """A host master copy: pinned on a CUDA index (an asynchronous
        copy from pageable memory would quietly synchronise), a plain
        tensor on a CPU index."""
        if self.device.type != "cuda":
            return x
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        return host

    def _demote(self, blk: _Block) -> None:
        blk.cols_cold = self._to_host(blk.cols_hot)
        blk.cols_hot = None
        if blk.pays_hot is not None:
            blk.pays_cold = self._to_host(blk.pays_hot)
            blk.pays_hot = None
        _TIER_STATS["demotions"] += 1
        self.gen += 1
        self._plan = None

    def _promote(self, blk: _Block) -> None:
        blk.cols_hot = blk.cols_cold.to(self.device)
        blk.cols_cold = None
        if blk.pays_cold is not None:
            blk.pays_hot = blk.pays_cold.to(self.device)
            blk.pays_cold = None
        self._tick += 1
        blk.last_used = self._tick
        _TIER_STATS["promotions"] += 1
        self.gen += 1
        self._plan = None

    def _enforce_budget(self) -> None:
        if self.hot_bytes is None:
            return
        budget = int(self.hot_bytes)

        def hot():
            return [blk for blk in self.blocks if blk.tier == TIER_HOT]
        used = sum(blk.block_bytes for blk in hot())
        while used > budget:
            victims = hot()
            if not victims:
                break
            lru = min(victims, key=lambda blk: blk.last_used)
            self._demote(lru)
            used -= lru.block_bytes
        # freed room (a merge shrank R, or the budget grew): pull the most
        # recently used cold blocks back while they fit
        cold = sorted((blk for blk in self.blocks if blk.tier == TIER_COLD),
                      key=lambda blk: -blk.last_used)
        for blk in cold:
            if used + blk.block_bytes > budget:
                continue
            self._promote(blk)
            used += blk.block_bytes

    # -- plan / staging --------------------------------------------------

    def plan(self) -> Tuple[_Group, ...]:
        """Group blocks by geometry (one kernel launch per group inside
        the fused program): an all-hot group's columns and payloads
        pre-concatenated on the device, cold blocks listed for
        :meth:`stage`, base-offset lanes as one device constant, and the
        stack-position permutation that restores the global column
        order.  Cached until the stack or a tier changes."""
        if self._plan is not None:
            return self._plan
        order: Dict[SuffixGeometry, List[int]] = {}
        for bi, blk in enumerate(self.blocks):
            order.setdefault(blk.geom, []).append(bi)
        groups: List[_Group] = []
        for geom, idxs in order.items():
            cold = [i for i in idxs if self.blocks[i].tier == TIER_COLD]
            blks = [self.blocks[i] for i in idxs]
            perm = np.concatenate([self.col_off[blk.serial] + np.arange(blk.n)
                                   for blk in blks]).astype(np.int64)
            base_idx = np.concatenate([blk.base_idx for blk in blks])
            cols_hot = pays_hot = None
            if not cold:
                cols_hot = torch.cat([blk.cols_hot for blk in blks], dim=-1)
                if self.payload_words is not None:
                    pays_hot = torch.cat([blk.pays_hot for blk in blks],
                                         dim=-1)
            groups.append(_Group(
                geom=geom, cols_hot=cols_hot,
                base_idx=torch.from_numpy(base_idx).to(self.device),
                perm=perm, blocks=tuple(idxs), cold_blocks=tuple(cold),
                cold_bytes=sum(self.blocks[i].col_bytes for i in cold),
                pays_hot=pays_hot,
                pay_cold_bytes=sum(self.blocks[i].pay_bytes for i in cold)))
        self._plan = tuple(groups)
        return self._plan

    def _upload(self, parts: List[torch.Tensor]) -> Staged:
        """Copy host blocks, in order, into their slices of one new device
        slab along the column axis.  On the card: ``non_blocking`` copies
        from pinned memory on the store's side stream, the slab allocated
        there, and an event recorded after the last copy."""
        if self.device.type != "cuda":
            return Staged(torch.cat(parts, dim=-1))
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        shape = tuple(parts[0].shape[:-1]) + (sum(p.shape[-1]
                                                  for p in parts),)
        with torch.cuda.stream(self._stream):
            slab = torch.empty(shape, dtype=torch.int32, device=self.device)
            lo = 0
            for p in parts:
                slab[..., lo:lo + p.shape[-1]].copy_(p, non_blocking=True)
                lo += p.shape[-1]
            event = torch.cuda.Event()
            event.record(self._stream)
        return Staged(slab, event)

    def assemble(self, g: _Group, slab: Optional[Staged],
                 payloads: bool = False) -> torch.Tensor:
        """A group's columns (or payload bitmaps) in its stack order: the
        all-hot concatenation, or its hot blocks' tensors with each cold
        block's slice of ``slab`` in its place, once the slab's copies
        are done."""
        if slab is None:
            return g.pays_hot if payloads else g.cols_hot
        cold = slab.wait()
        parts, lo = [], 0
        for i in g.blocks:
            blk = self.blocks[i]
            if blk.tier == TIER_HOT:
                parts.append(blk.pays_hot if payloads else blk.cols_hot)
            else:
                parts.append(cold[..., lo:lo + blk.n])
                lo += blk.n
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)

    def stage(self) -> Tuple[Optional[Staged], ...]:
        """Copy-ahead: every cold block's columns into one device staging
        slab per geometry group (``None`` where the group is fully hot).
        Call once per fused query, before the rung loop: the copies run
        on a side stream while the traversal runs, and ladder retries
        reuse the same slabs."""
        slabs: List[Optional[Staged]] = []
        for g in self.plan():
            if not g.cold_blocks:
                slabs.append(None)
                continue
            with _obs_span("tier_stage", cat="device",
                           blocks=len(g.cold_blocks), bytes=g.cold_bytes):
                slabs.append(self._upload(
                    [self.blocks[i].cols_cold for i in g.cold_blocks]))
            _TIER_STATS["prefetches"] += len(g.cold_blocks)
            _TIER_STATS["staged_bytes"] += g.cold_bytes
        return tuple(slabs)

    def stage_payloads(self) -> Tuple[Optional[Staged], ...]:
        """Copy-ahead for the re-rank pass: every cold block's payload
        bitmaps into one (Wp, n_cold) device slab per plan group (``None``
        where the group is fully hot, or when the store holds no
        payloads); counted under ``staged_bytes`` and
        ``staged_payload_bytes``."""
        slabs: List[Optional[Staged]] = []
        for g in self.plan():
            if self.payload_words is None or not g.cold_blocks:
                slabs.append(None)
                continue
            with _obs_span("tier_stage_payloads", cat="device",
                           blocks=len(g.cold_blocks),
                           bytes=g.pay_cold_bytes):
                slabs.append(self._upload(
                    [self.blocks[i].pays_cold for i in g.cold_blocks]))
            _TIER_STATS["staged_bytes"] += g.pay_cold_bytes
            _TIER_STATS["staged_payload_bytes"] += g.pay_cold_bytes
        return tuple(slabs)

    # -- accounting ------------------------------------------------------

    def array_bytes(self) -> int:
        """Resident device bytes: hot columns and payloads, the shared
        gid/liveness lanes and the per-block base-offset lanes (the
        staging slabs are transient, counted by
        ``tier_stats()['staged_bytes']``)."""
        by = int(self.live.numel() * self.live.element_size()
                 + self.gids.numel() * self.gids.element_size())
        by += self.col_bytes(TIER_HOT) + self.pay_bytes(TIER_HOT)
        by += sum(blk.base_idx.nbytes for blk in self.blocks)
        return by

    def host_bytes(self) -> int:
        """Resident host bytes: the cold blocks' master copies (columns
        and payload bitmaps)."""
        return self.col_bytes(TIER_COLD) + self.pay_bytes(TIER_COLD)

    def col_bytes(self, tier: Optional[str] = None) -> int:
        """Sketch-column bytes, optionally restricted to one tier."""
        return sum(blk.col_bytes for blk in self.blocks
                   if tier is None or blk.tier == tier)

    def pay_bytes(self, tier: Optional[str] = None) -> int:
        """Re-rank payload-bitmap bytes, optionally per tier."""
        return sum(blk.pay_bytes for blk in self.blocks
                   if tier is None or blk.tier == tier)

    def tier_summary(self) -> Dict[str, int]:
        """Placement snapshot for ``SegmentedIndex.stats()``."""
        n_cold = sum(blk.tier == TIER_COLD for blk in self.blocks)
        return {"hot_blocks": len(self.blocks) - n_cold, "cold_blocks": n_cold,
                "hot_bytes": self.col_bytes(TIER_HOT),
                "cold_bytes": self.col_bytes(TIER_COLD)}
