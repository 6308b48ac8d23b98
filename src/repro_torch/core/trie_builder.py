"""Host-side trie construction over a b-bit sketch database.

A copy of ``repro.core.trie_builder`` (pure numpy), kept in this package
so that ``repro_torch`` imports nothing of ``repro``.  Index build is
preprocessing, so it runs in numpy; the queryable encodings it feeds
(``bst.py``) hold torch tensors on the search device.

The construction never materializes a pointer trie.  Because sketches are
*fixed-length* strings (the paper's "favorable property"), sorting the
database lexicographically makes every trie level recoverable by prefix
change-detection over the sorted unique rows — an O(n·L) scan, no pointer
chasing, no allocation per node.  Level ``ℓ`` facts derived per scan:

  * ``t[ℓ]``        — number of nodes (distinct length-ℓ prefixes),
  * ``labels[ℓ]``   — edge label from each node to its parent (char ℓ-1),
  * ``parents[ℓ]``  — parent node id at level ℓ-1 (lexicographic ranks),
  * ``node_of_leaf``— each leaf's ancestor id at ℓ (kept only where needed).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class TrieLevels:
    """Raw per-level facts (numpy, host-side)."""

    L: int
    b: int
    n: int                      # database size (with duplicates)
    uniq: np.ndarray            # (t_L, L) unique sketches, lex-sorted
    t: List[int]                # node count per level, t[0] == 1 (root)
    labels: List[np.ndarray]    # labels[ℓ] : (t[ℓ],) uint8, ℓ in 1..L
    parents: List[np.ndarray]   # parents[ℓ]: (t[ℓ],) int64 ids at ℓ-1
    leaf_offsets: np.ndarray    # (t_L+1,) CSR into ids_sorted
    ids_sorted: np.ndarray      # (n,) original ids grouped by leaf
    id_leaf: np.ndarray         # (n,) original id -> leaf index
    node_of_leaf: List[np.ndarray]  # per level ℓ: (t_L,) leaf -> ancestor id

    def first_leaf_of_node(self, level: int) -> np.ndarray:
        """(t[level],) index of the leftmost leaf under each node."""
        nol = self.node_of_leaf[level]
        first = np.zeros(self.t[level], dtype=np.int64)
        # nodes appear in nondecreasing order over leaves; mark boundaries
        boundary = np.concatenate([[True], nol[1:] != nol[:-1]])
        first[nol[boundary]] = np.flatnonzero(boundary)
        return first


def build_trie_levels(sketches: np.ndarray, b: int) -> TrieLevels:
    """Scan a sketch database into per-level trie facts.

    sketches: (n, L) uint8 over Σ=[0, 2^b) (duplicates allowed — they
    share a leaf); returns a host-side ``TrieLevels`` with node counts,
    labels, parents, and leaf maps per level (shapes in the dataclass).
    O(n·L) after the lexicographic sort; no pointer trie is built."""
    sketches = np.ascontiguousarray(np.asarray(sketches, dtype=np.uint8))
    n, L = sketches.shape
    assert sketches.max(initial=0) < (1 << b), "character exceeds alphabet"

    # lexicographic sort of rows (np.lexsort keys: last key is primary)
    order = np.lexsort(tuple(sketches[:, c] for c in range(L - 1, -1, -1)))
    srt = sketches[order]

    # unique rows -> leaves
    if n > 1:
        row_new = np.concatenate([[True], np.any(srt[1:] != srt[:-1], axis=1)])
    else:
        row_new = np.ones(1, dtype=bool)
    leaf_of_row = np.cumsum(row_new) - 1          # (n,)
    uniq = srt[row_new]                            # (t_L, L)
    t_L = uniq.shape[0]

    counts = np.bincount(leaf_of_row, minlength=t_L)
    leaf_offsets = np.zeros(t_L + 1, dtype=np.int64)
    np.cumsum(counts, out=leaf_offsets[1:])
    ids_sorted = order.astype(np.int64)
    id_leaf = np.empty(n, dtype=np.int64)
    id_leaf[order] = leaf_of_row

    # per-level prefix boundaries over unique rows
    t = [1]
    labels: List[np.ndarray] = [np.zeros(0, dtype=np.uint8)]   # pad index 0
    parents: List[np.ndarray] = [np.zeros(0, dtype=np.int64)]
    node_of_leaf: List[np.ndarray] = [np.zeros(t_L, dtype=np.int64)]  # root
    boundary = np.zeros(t_L, dtype=bool)
    boundary[0] = True  # level-0 "prefix" (empty) boundary bookkeeping
    prev_nodes = np.zeros(t_L, dtype=np.int64)    # node id at ℓ-1 per leaf

    for lev in range(1, L + 1):
        col = uniq[:, lev - 1]
        if t_L > 1:
            boundary = boundary | np.concatenate([[True], col[1:] != col[:-1]])
            boundary[0] = True
        # int64: a billion-scale level can exceed 2^31 nodes and the
        # cumsum must not wrap; the queryable encodings downcast to int32
        # at encoding time, after any per-shard split has bounded t.
        nodes = np.cumsum(boundary, dtype=np.int64) - 1  # leaf -> node id at lev
        t_lev = int(nodes[-1]) + 1
        first = np.flatnonzero(boundary)           # first leaf per node
        labels.append(col[first].astype(np.uint8))
        parents.append(prev_nodes[first])
        node_of_leaf.append(nodes.copy())
        t.append(t_lev)
        prev_nodes = nodes

    return TrieLevels(L=L, b=b, n=n, uniq=uniq, t=t, labels=labels,
                      parents=parents, leaf_offsets=leaf_offsets,
                      ids_sorted=ids_sorted, id_leaf=id_leaf,
                      node_of_leaf=node_of_leaf)


def pick_layers(trie: TrieLevels, lam: float = 0.5):
    """Layer boundaries (ℓ_m, ℓ_s) per paper §V.

    * dense:  largest ℓ_m with t[ℓ_m] == 2^(b·ℓ_m) (complete 2^b-ary trie).
    * sparse: smallest ℓ_s >= ℓ_m with t[ℓ_s] >= λ·t[L].
      (The paper prints the condition as D(ℓ_s, L) < λ with
      D(ℓ1,ℓ2)=t_{ℓ2}/t_{ℓ1}, which is unsatisfiable since t is
      non-decreasing; the intended reading — consistent with the reported
      (ℓ_m, ℓ_s) pairs and λ=0.5 — is t[ℓ_s]/t[L] >= λ, i.e. the level
      from which at least a λ fraction of root-to-leaf paths have become
      non-branching.  Recorded as a paper typo in DESIGN.md.)
    """
    b, L = trie.b, trie.L
    lm = 0
    for lev in range(1, L + 1):
        if b * lev < 63 and trie.t[lev] == (1 << (b * lev)):
            lm = lev
        else:
            break
    ls = L
    for lev in range(lm, L + 1):
        if trie.t[lev] >= lam * trie.t[L]:
            ls = lev
            break
    return lm, ls


def table_or_list(trie: TrieLevels, lev: int) -> str:
    """Adaptive middle-layer encoding (paper §V-B): TABLE iff the level's
    node density exceeds 2^b/(b+1)."""
    density = trie.t[lev] / max(trie.t[lev - 1], 1)
    return "table" if density > (1 << trie.b) / (trie.b + 1) else "list"
