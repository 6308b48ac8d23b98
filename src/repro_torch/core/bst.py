"""b-Bit Sketch Trie (bST) and baseline succinct tries over torch tensors.

Every index is a stack of per-level *encodings* with one batched
operation

    children(parent_ids: int32[F]) -> (ids, labels, exists): [F, 2^b]

— the paper's ``children(u)`` over a whole frontier at once.  Encodings:

  * ``DenseLevel``  — complete 2^b-ary level: children are arithmetic,
                      storage is *zero bits* (paper §V-A).
  * ``TableLevel``  — bitmap H_ℓ of length 2^b·t_{ℓ-1}; existence is
                      ``H.get``, the child id is ``H.rank`` (paper §V-B).
  * ``ListLevel``   — labels C_ℓ + first-sibling bitvector B_ℓ; the child
                      range is two ``select`` calls (paper §V-B).
  * ``LoudsLevel``  — labels C_ℓ + unary degree sequence U_ℓ with
                      ``select0`` child ranges — the LOUDS-trie baseline.
  * ``SparseTail``  — collapsed root-to-leaf suffix paths P, stored in the
                      vertical bit-plane layout the verify kernel streams,
                      + leftmost-leaf bitvector D (paper §V-C).

The builders scan the database on the host in numpy and move the arrays
to ``device`` at the end; ``index_from_numpy`` carries an index built by
the JAX package across, leaf for leaf.  Indexes are plain dataclasses
with a ``.to(device)`` method.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .bitvector import BitVector
from .hamming import as_words, pack_vertical, resolve_device
from .trie_builder import TrieLevels, build_trie_levels, pick_layers, table_or_list


def _arange_labels(A: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(A, dtype=torch.int32, device=like.device)[None, :]


@dataclasses.dataclass(frozen=True)
class DenseLevel:
    b: int
    t_prev: int

    def to(self, device) -> "DenseLevel":
        return self

    def children(self, u: torch.Tensor):
        A = 1 << self.b
        c = _arange_labels(A, u)
        ids = u[:, None] * A + c
        labels = c.expand(ids.shape)
        exists = torch.ones(ids.shape, dtype=torch.bool, device=u.device)
        return ids, labels, exists

    def model_bits(self) -> int:
        return 64  # just the level number (paper: O(log ℓ_m))

    def array_bytes(self) -> int:
        return 8


@dataclasses.dataclass(frozen=True)
class TableLevel:
    H: BitVector
    b: int
    t_prev: int

    def to(self, device) -> "TableLevel":
        return dataclasses.replace(self, H=self.H.to(device))

    def children(self, u: torch.Tensor):
        A = 1 << self.b
        c = _arange_labels(A, u)
        u_safe = torch.clamp(u, 0, self.t_prev - 1)
        pos = u_safe[:, None] * A + c                    # (F, A)
        exists = self.H.get(pos) == 1
        ids = self.H.rank(pos)                           # ones before pos = child index
        labels = c.expand(ids.shape)
        return ids, labels, exists

    def model_bits(self) -> int:
        n = (1 << self.b) * self.t_prev
        return n + int(self.H.cum.shape[0]) * 32  # payload + rank dir

    def array_bytes(self) -> int:
        return _nbytes(self.H.words, self.H.cum)


def _list_children(C: torch.Tensor, start: torch.Tensor, end: torch.Tensor,
                   A: int):
    j = _arange_labels(A, start)
    ids = start[:, None] + j
    exists = ids < end[:, None]
    labels = C[torch.clamp(ids, 0, C.shape[0] - 1)].to(torch.int32)
    return ids, labels, exists


@dataclasses.dataclass(frozen=True)
class ListLevel:
    C: torch.Tensor       # (t,) uint8 edge labels
    B: BitVector          # (t,) first-sibling flags
    b: int
    t_prev: int

    def to(self, device) -> "ListLevel":
        return dataclasses.replace(self, C=self.C.to(device),
                                   B=self.B.to(device))

    def children(self, u: torch.Tensor):
        u_safe = torch.clamp(u, 0, self.t_prev - 1)
        start = self.B.select(u_safe + 1)                # (F,)
        end = self.B.select(u_safe + 2)                  # t for the last parent
        return _list_children(self.C, start, end, 1 << self.b)

    def model_bits(self) -> int:
        t = int(self.C.shape[0])
        return (self.b + 1) * t + int(self.B.cum.shape[0]) * 32

    def array_bytes(self) -> int:
        return _nbytes(self.C, self.B.words, self.B.cum)


@dataclasses.dataclass(frozen=True)
class LoudsLevel:
    C: torch.Tensor       # (t,) uint8 edge labels
    U: BitVector          # (t_prev + t,) unary degrees: 1^deg 0 per parent
    b: int
    t_prev: int

    def to(self, device) -> "LoudsLevel":
        return dataclasses.replace(self, C=self.C.to(device),
                                   U=self.U.to(device))

    def children(self, u: torch.Tensor):
        u_safe = torch.clamp(u, 0, self.t_prev - 1)
        # ones before the u-th zero = cumulative degree of parents < u
        s0 = self.U.select0(torch.clamp(u_safe, min=1))
        start = torch.where(u_safe == 0, 0, s0 - u_safe + 1)
        end = self.U.select0(u_safe + 1) - u_safe
        return _list_children(self.C, start, end, 1 << self.b)

    def model_bits(self) -> int:
        t = int(self.C.shape[0])
        # labels b bits + 2 topology bits per node (unary seq has t ones, ~t zeros)
        return self.b * t + (self.t_prev + t) + int(self.U.cum.shape[0]) * 32

    def array_bytes(self) -> int:
        return _nbytes(self.C, self.U.words, self.U.cum)


@dataclasses.dataclass(frozen=True)
class SparseTail:
    paths_vert: torch.Tensor  # (b, W_sfx, t_L) int32 — kernel-ready layout
    D: BitVector              # (t_L,) leftmost-leaf flags per ℓ_s subtrie
    leaf_root: torch.Tensor   # (t_L,) int32 — leaf -> its ℓ_s ancestor id
    b: int
    suffix_len: int
    t_root: int               # t[ℓ_s]

    def to(self, device) -> "SparseTail":
        return dataclasses.replace(self, paths_vert=self.paths_vert.to(device),
                                   D=self.D.to(device),
                                   leaf_root=self.leaf_root.to(device))

    def model_bits(self) -> int:
        t_L = int(self.leaf_root.shape[0])
        return self.b * self.suffix_len * t_L + t_L + int(self.D.cum.shape[0]) * 32

    def array_bytes(self) -> int:
        return _nbytes(self.paths_vert, self.D.words, self.D.cum,
                       self.leaf_root)


def _nbytes(*tensors: torch.Tensor) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


@dataclasses.dataclass(frozen=True)
class SketchIndex:
    """A trie index over one database of b-bit sketches."""

    levels: Tuple        # encodings for ℓ = 1 .. depth (ℓ_s for bST, L otherwise)
    tail: Optional[SparseTail]
    id_leaf: torch.Tensor  # (n,) int32 original id -> leaf index
    L: int
    b: int
    n: int
    t: Tuple[int, ...]   # node counts per level 0..L
    lm: int
    ls: int
    kinds: Tuple[str, ...]

    @property
    def device(self) -> torch.device:
        return self.id_leaf.device

    def to(self, device) -> "SketchIndex":
        device = resolve_device(device)
        return dataclasses.replace(
            self, levels=tuple(lv.to(device) for lv in self.levels),
            tail=None if self.tail is None else self.tail.to(device),
            id_leaf=self.id_leaf.to(device))

    def model_bits(self) -> int:
        bits = sum(lv.model_bits() for lv in self.levels)
        if self.tail is not None:
            bits += self.tail.model_bits()
        return bits

    def array_bytes(self, include_ids: bool = True) -> int:
        by = sum(lv.array_bytes() for lv in self.levels)
        if self.tail is not None:
            by += self.tail.array_bytes()
        if include_ids:
            by += _nbytes(self.id_leaf)
        return by


# ---------------------------------------------------------------------------
# builders (host-side numpy; arrays move to the device at the end)
# ---------------------------------------------------------------------------

def _build_table_level(trie: TrieLevels, lev: int) -> TableLevel:
    A = 1 << trie.b
    t_prev = trie.t[lev - 1]
    bits = np.zeros(A * t_prev, dtype=np.uint8)
    pos = trie.parents[lev] * A + trie.labels[lev].astype(np.int64)
    bits[pos] = 1
    return TableLevel(H=BitVector.from_bits(bits), b=trie.b, t_prev=t_prev)


def _build_list_level(trie: TrieLevels, lev: int) -> ListLevel:
    par = trie.parents[lev]
    first = np.concatenate([[True], par[1:] != par[:-1]]) if len(par) > 1 else np.ones(len(par), bool)
    return ListLevel(C=torch.from_numpy(trie.labels[lev].copy()),
                     B=BitVector.from_bits(first.astype(np.uint8)),
                     b=trie.b, t_prev=trie.t[lev - 1])


def _build_louds_level(trie: TrieLevels, lev: int) -> LoudsLevel:
    par = trie.parents[lev]
    t_prev = trie.t[lev - 1]
    deg = np.bincount(par, minlength=t_prev)
    # 1^deg 0 per parent: ones everywhere except at terminator positions
    u_bits = np.ones(t_prev + len(par), dtype=np.uint8)
    u_bits[np.cumsum(deg + 1) - 1] = 0
    return LoudsLevel(C=torch.from_numpy(trie.labels[lev].copy()),
                      U=BitVector.from_bits(u_bits), b=trie.b, t_prev=t_prev)


def _build_sparse_tail(trie: TrieLevels, ls: int) -> SparseTail:
    t_L = trie.t[trie.L]
    sfx = trie.L - ls
    leaf_root = trie.node_of_leaf[ls]
    if sfx > 0:
        planes = pack_vertical(trie.uniq[:, ls:], trie.b)  # (t_L, b, W)
        paths_vert = np.transpose(planes, (1, 2, 0))       # (b, W, t_L)
    else:
        paths_vert = np.zeros((trie.b, 1, t_L), dtype=np.uint32)
    d_bits = np.concatenate([[1], (leaf_root[1:] != leaf_root[:-1]).astype(np.uint8)]) \
        if t_L > 1 else np.ones(1, np.uint8)
    return SparseTail(paths_vert=as_words(paths_vert, "cpu"),
                      D=BitVector.from_bits(d_bits),
                      leaf_root=torch.from_numpy(leaf_root.astype(np.int32)),
                      b=trie.b, suffix_len=sfx, t_root=trie.t[ls])


def _index(trie: TrieLevels, levels, tail, lm: int, ls: int, kinds,
           device) -> SketchIndex:
    return SketchIndex(levels=tuple(levels), tail=tail,
                       id_leaf=torch.from_numpy(trie.id_leaf.astype(np.int32)),
                       L=trie.L, b=trie.b, n=trie.n, t=tuple(trie.t),
                       lm=lm, ls=ls, kinds=tuple(kinds)).to(device)


def build_bst(sketches: np.ndarray, b: int, lam: float = 0.5,
              trie: Optional[TrieLevels] = None,
              device="cuda") -> SketchIndex:
    """The paper's bST: dense prefix + adaptive TABLE/LIST middle + collapsed
    sparse tail.

    sketches: (n, L) uint8 over Σ=[0, 2^b); returns a ``SketchIndex`` on
    ``device`` (ids are row positions in ``sketches``)."""
    device = resolve_device(device)
    trie = trie or build_trie_levels(sketches, b)
    lm, ls = pick_layers(trie, lam)
    levels: List = []
    kinds: List[str] = []
    for lev in range(1, ls + 1):
        if lev <= lm:
            levels.append(DenseLevel(b=b, t_prev=trie.t[lev - 1]))
            kinds.append("dense")
        elif table_or_list(trie, lev) == "table":
            levels.append(_build_table_level(trie, lev))
            kinds.append("table")
        else:
            levels.append(_build_list_level(trie, lev))
            kinds.append("list")
    return _index(trie, levels, _build_sparse_tail(trie, ls), lm, ls, kinds,
                  device)


def build_louds(sketches: np.ndarray, b: int,
                trie: Optional[TrieLevels] = None,
                device="cuda") -> SketchIndex:
    """LOUDS-trie baseline: every level as (labels, unary-degree bitvector),
    no dense shortcut, no path collapse (Table III comparison)."""
    device = resolve_device(device)
    trie = trie or build_trie_levels(sketches, b)
    levels = [_build_louds_level(trie, lev) for lev in range(1, trie.L + 1)]
    return _index(trie, levels, None, 0, trie.L, ["louds"] * trie.L, device)


def build_fst_style(sketches: np.ndarray, b: int,
                    trie: Optional[TrieLevels] = None,
                    device="cuda") -> SketchIndex:
    """FST-style two-layer baseline: bitmap-encoded top levels while the
    density rule favours TABLE, list-encoded below; no path collapse
    (Table III comparison)."""
    device = resolve_device(device)
    trie = trie or build_trie_levels(sketches, b)
    levels: List = []
    kinds: List[str] = []
    in_top = True
    for lev in range(1, trie.L + 1):
        if in_top and table_or_list(trie, lev) == "table":
            levels.append(_build_table_level(trie, lev))
            kinds.append("table")
        else:
            in_top = False
            levels.append(_build_list_level(trie, lev))
            kinds.append("list")
    return _index(trie, levels, None, 0, trie.L, kinds, device)


# ---------------------------------------------------------------------------
# carrying an index across from the JAX package
# ---------------------------------------------------------------------------

def index_from_numpy(meta: dict, arrays: Sequence[np.ndarray],
                     device="cuda") -> SketchIndex:
    """Rebuild a ``SketchIndex`` from an index's static metadata and its
    array leaves, in the order the JAX package's pytree flattens them.

    meta: ``L``, ``b``, ``n``, ``t``, ``lm``, ``ls``, ``kinds`` and
    ``tail`` (bool: the index has a collapsed sparse tail);
    arrays: per level in order — table: (H.words, H.cum); list:
    (C, B.words, B.cum); louds: (C, U.words, U.cum); dense: nothing —
    then, with a tail, (paths_vert, D.words, D.cum, leaf_root), and last
    id_leaf.  Words may be uint32 or int32; every length and static
    field is derived from ``meta``."""
    it = iter(arrays)
    index = _index_from_iter(meta, it, resolve_device(device))
    if next(it, None) is not None:
        raise ValueError("more arrays than the metadata describes")
    return index


def _index_from_iter(meta: dict, it, device) -> SketchIndex:
    """``index_from_numpy`` over an iterator of leaves: takes exactly the
    index's own leaves and leaves the rest (a multi-index's next block)."""
    L, b, t, ls = meta["L"], meta["b"], tuple(meta["t"]), meta["ls"]
    A = 1 << b

    def bitvector(length: int) -> BitVector:
        words = as_words(next(it), "cpu")
        cum = torch.from_numpy(np.asarray(next(it), dtype=np.int32).copy())
        return BitVector(words, cum, length)

    def labels() -> torch.Tensor:
        return torch.from_numpy(np.asarray(next(it), dtype=np.uint8).copy())

    levels: List = []
    for lev, kind in enumerate(meta["kinds"], start=1):
        t_prev = t[lev - 1]
        if kind == "dense":
            levels.append(DenseLevel(b=b, t_prev=t_prev))
        elif kind == "table":
            levels.append(TableLevel(bitvector(A * t_prev), b, t_prev))
        elif kind == "list":
            C = labels()
            levels.append(ListLevel(C, bitvector(C.shape[0]), b, t_prev))
        elif kind == "louds":
            C = labels()
            levels.append(LoudsLevel(C, bitvector(t_prev + C.shape[0]), b,
                                     t_prev))
        else:
            raise ValueError(f"unknown level kind {kind!r}")
    tail = None
    if meta["tail"]:
        paths_vert = as_words(next(it), "cpu")
        tail = SparseTail(paths_vert, bitvector(t[L]),
                          torch.from_numpy(np.asarray(next(it), np.int32).copy()),
                          b=b, suffix_len=L - ls, t_root=t[ls])
    id_leaf = torch.from_numpy(np.asarray(next(it), np.int32).copy())
    return SketchIndex(levels=tuple(levels), tail=tail, id_leaf=id_leaf,
                       L=L, b=b, n=meta["n"], t=t, lm=meta["lm"], ls=ls,
                       kinds=tuple(meta["kinds"])).to(device)
