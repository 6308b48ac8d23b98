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

This port keeps every block hot (device-resident), the JAX package's
``hot_bytes=None`` placement: ``stage()``/``stage_payloads()`` have no
cold block to upload (one ``None`` per group), so the fused programs
take no staging slabs, and the tier counters count nothing.  A
``hot_bytes`` budget (LRU demotion to host-packed cold blocks staged per
query) is not ported yet and raises ``NotImplementedError``.

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

from .hamming import (as_words, n_words, pack_suffix_words, pack_vertical,
                      resolve_device)

WORD_BYTES = 4
TIER_HOT = "hot"
TIER_COLD = "cold"

# Placement counters of the JAX package's tiered store (promotions /
# demotions under a hot budget, cold blocks staged and their bytes).
# Every block is hot here, so they stay 0.
_TIER_STATS = {"promotions": 0, "demotions": 0, "prefetches": 0,
               "staged_bytes": 0, "staged_payload_bytes": 0}


def tier_stats() -> Dict[str, int]:
    """Placement counters (all 0: every block is device-resident)."""
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
    """One sealed segment's suffix columns, on the device.  Packed
    geometry stores (n,) int32 words, plane geometry (b, W_sfx, n).
    ``base_idx`` (host, immutable once appended) is the segment-offset
    lane into the global root base plane; ``pays_hot`` the (Wp, n)
    re-rank payload bitmaps."""

    serial: int
    n: int
    geom: SuffixGeometry
    base_idx: np.ndarray
    cols_hot: torch.Tensor
    pays_hot: Optional[torch.Tensor] = None
    pay_words: int = 0

    @property
    def tier(self) -> str:
        return TIER_HOT

    @property
    def col_bytes(self) -> int:
        return self.n * self.geom.row_words * WORD_BYTES

    @property
    def pay_bytes(self) -> int:
        return self.n * self.pay_words * WORD_BYTES

    @property
    def block_bytes(self) -> int:
        return self.col_bytes + self.pay_bytes


class _Group(NamedTuple):
    """One geometry group of the current plan: the fused program runs
    one verify launch per group.  ``perm`` maps the group's column order
    (its blocks in stack order) back to global stack positions."""

    geom: SuffixGeometry
    cols_hot: torch.Tensor            # concatenated columns (device)
    base_idx: torch.Tensor            # (n_group,) int32 device constant
    perm: np.ndarray                  # (n_group,) int64 stack positions
    cold_blocks: Tuple[int, ...]      # always () here
    cold_bytes: int
    pays_hot: Optional[torch.Tensor] = None  # (Wp, n_group) bitmaps
    pay_cold_bytes: int = 0


class ColumnStore:
    """Suffix column store for one segment stack (bst backend).

    A flush *appends* a block (and its liveness/gid/id lanes) without
    touching existing ones; a merge or compact changes the serial
    fingerprint non-monotonically and the owner rebuilds from scratch.
    ``delete`` flips the shared ``live`` lanes in place through
    ``col_off`` — liveness is an argument of every fused program call.
    """

    def __init__(self, L: int, b: int, hot_bytes: Optional[int] = None,
                 payload_words: Optional[int] = None, device="cuda"):
        if hot_bytes is not None:
            raise NotImplementedError(
                "hot_bytes: the cold tier of the column store is not "
                "ported yet; every block stays on the device")
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
        self.gen = 0                   # placement generation (never moves)
        self._plan: Optional[Tuple[_Group, ...]] = None

    @property
    def n_cols(self) -> int:
        return int(self.col_ids.shape[0])

    # -- maintenance -----------------------------------------------------

    def append_segment(self, seg) -> None:
        """Append one sealed segment's block: suffix columns sliced below
        its own ℓ_s, packed per :func:`geometry_for`, plus the shared
        base-offset/gid/liveness/id lanes."""
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
        self.blocks.append(_Block(
            serial=seg.serial, n=seg.n, geom=geom, base_idx=base_idx,
            cols_hot=as_words(cols, self.device), pays_hot=pays_hot,
            pay_words=pay_words))
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
        """Stamp the stack fingerprint (the placement budget would be
        enforced here: every block is hot)."""
        self.serials = serials

    # -- plan / staging --------------------------------------------------

    def plan(self) -> Tuple[_Group, ...]:
        """Group blocks by geometry (one kernel launch per group inside
        the fused program): columns and payloads pre-concatenated on the
        device, base-offset lanes as one device constant, and the
        stack-position permutation that restores the global column
        order.  Cached until the stack changes."""
        if self._plan is not None:
            return self._plan
        order: Dict[SuffixGeometry, List[int]] = {}
        for bi, blk in enumerate(self.blocks):
            order.setdefault(blk.geom, []).append(bi)
        groups: List[_Group] = []
        for geom, idxs in order.items():
            blks = [self.blocks[i] for i in idxs]
            perm = np.concatenate([self.col_off[blk.serial] + np.arange(blk.n)
                                   for blk in blks]).astype(np.int64)
            base_idx = np.concatenate([blk.base_idx for blk in blks])
            pays_hot = None
            if self.payload_words is not None:
                pays_hot = torch.cat([blk.pays_hot for blk in blks], dim=-1)
            groups.append(_Group(
                geom=geom,
                cols_hot=torch.cat([blk.cols_hot for blk in blks], dim=-1),
                base_idx=torch.from_numpy(base_idx).to(self.device),
                perm=perm, cold_blocks=(), cold_bytes=0, pays_hot=pays_hot))
        self._plan = tuple(groups)
        return self._plan

    def stage(self) -> Tuple[None, ...]:
        """One staging slab per plan group: ``None`` everywhere, since no
        block is cold."""
        return (None,) * len(self.plan())

    def stage_payloads(self) -> Tuple[None, ...]:
        """The re-rank pass's staging slabs: ``None`` per plan group."""
        return (None,) * len(self.plan())

    # -- accounting ------------------------------------------------------

    def array_bytes(self) -> int:
        """Resident device bytes: columns and payloads + the shared
        gid/liveness lanes + the per-block base-offset lanes."""
        by = int(self.live.numel() * self.live.element_size()
                 + self.gids.numel() * self.gids.element_size())
        by += sum(blk.block_bytes for blk in self.blocks)
        by += sum(blk.base_idx.nbytes for blk in self.blocks)
        return by

    def host_bytes(self) -> int:
        """Resident host bytes of cold blocks: none."""
        return 0

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
        return {"hot_blocks": len(self.blocks), "cold_blocks": 0,
                "hot_bytes": self.col_bytes(), "cold_bytes": 0}
