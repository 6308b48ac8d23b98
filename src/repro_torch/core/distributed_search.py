"""The sharded bST on one card, and the shard-merge selection.

The database of n sketches is split into S shards (global id i lands on
shard ``i % S``); each shard owns a *local* bST over its slice and
answers every query against it, and the result planes merge back onto
global ids.  The JAX package runs one SPMD program over the shards
(``jax.vmap`` over a stacked, padded pytree, partitioned over a mesh).
On one GPU the shard axis is a leading batched dimension instead:

  * every shard shares one static layer plan (dense span, TABLE/LIST
    per level, collapse level ℓ_s), computed from aggregate statistics,
    and every per-shard array is zero-padded to the largest shard and
    stacked on a leading (S, ...) axis; true sizes (t per level, n_local)
    travel as data, and a padded lane comes out dead (BIG);
  * the traversal runs shard by shard (a Python loop over S: each level
    is a handful of small launches), and the scan verify of ALL shards is
    ONE launch of the batched verify kernel
    (``ops.sparse_verify_batch_batched``, grid.z = S, the query planes
    shared), where the JAX package's ``pallas_call`` batches the shard
    axis onto its grid;
  * the per-query "gather" verify mode calls
    ``ops.sparse_verify(..., use_kernel=False)`` — the plain version —
    on its gathered candidates, as the JAX package does.

Every result is bit-identical to ``repro.core.distributed_search``.  Words
are int32 bit-views of the uint32 words; scatters that the reference
drops out of range (``mode="drop"``) land in a spare sink column here,
and every gather it leaves unclipped is clamped.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..kernels.ref import BIG, popcount32
from .bitvector import BitVector, _select_in_word
from .cost_model import frontier_capacities
from .hamming import as_words, pack_vertical, pack_vertical_torch, resolve_device
from .search import _compact_batch
from .trie_builder import TrieLevels, build_trie_levels

WORD_SHIFT = 5
WORD_MASK = 31
_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# rank/select on padded (words, cum) pairs, with a per-shard length
# ---------------------------------------------------------------------------

def _rank(words: torch.Tensor, cum: torch.Tensor, i: torch.Tensor,
          length: int) -> torch.Tensor:
    """Set bits in [0, i) of one shard's padded bit vector; ``i`` clipped
    to [0, length]."""
    i = torch.clamp(i.to(torch.int32), 0, length)
    w = (i >> WORD_SHIFT).long()
    r = i & WORD_MASK
    base = cum[torch.clamp(w, max=cum.shape[0] - 1)]
    word = words[torch.clamp(w, max=words.shape[0] - 1)]
    mask = (1 << r.to(torch.int64)) - 1          # r == 0 -> empty mask
    partial = popcount32(word.to(torch.int64) & mask)
    return base + torch.where(r > 0, partial, 0)


def _select(words: torch.Tensor, cum: torch.Tensor, k: torch.Tensor,
            length: int) -> torch.Tensor:
    """Position of the k-th one (1-indexed); ``length`` when out of range
    (the shard's own length, not the padded array's)."""
    k = k.to(torch.int32)
    total = _rank(words, cum, torch.tensor(length, device=words.device),
                  length)
    valid = (k >= 1) & (k <= total)
    k_safe = torch.minimum(torch.clamp(k, min=1), torch.clamp(total, min=1))
    w = torch.searchsorted(cum, k_safe, right=False).to(torch.int32) - 1
    w = torch.clamp(w, 0, words.shape[0] - 1)
    wl = w.long()
    inword = _select_in_word(words[wl], k_safe - cum[wl])
    pos = (w << WORD_SHIFT) + inword
    return torch.where(valid, pos, length)


# ---------------------------------------------------------------------------
# stacked, padded index container
# ---------------------------------------------------------------------------

class ShardedLevel(NamedTuple):
    kind: str                        # "dense" | "table" | "list"
    words: Optional[torch.Tensor]    # (S, Wmax) int32 (table: H; list: B)
    cum: Optional[torch.Tensor]      # (S, Wmax+1) int32
    labels: Optional[torch.Tensor]   # (S, Tmax) uint8 (list only)


class ShardedBST(NamedTuple):
    levels: Tuple[ShardedLevel, ...]
    t: torch.Tensor            # (S, L+1) int32 true node counts per level
    paths_vert: torch.Tensor   # (S, b, Wsfx, tLmax) int32
    d_words: torch.Tensor      # (S, WD) int32 — leftmost-leaf bit vector
    d_cum: torch.Tensor        # (S, WD+1) int32
    leaf_root: torch.Tensor    # (S, tLmax) int32 (t_root sentinel on pads)
    id_leaf: torch.Tensor      # (S, n_max) int32 (leaf per local id)
    n_local: torch.Tensor      # (S,) int32
    shard_of: np.ndarray       # (n,) host: global id -> shard
    pos_of: np.ndarray         # (n,) host: global id -> local position
    merge_idx: torch.Tensor    # (n,) int32 device: shard_of * n_max + pos_of
    # static metadata (identical across shards)
    L: int
    b: int
    lm: int
    ls: int
    kinds: Tuple[str, ...]
    n_max: int
    max_leaves_per_root: int

    @property
    def device(self) -> torch.device:
        return self.t.device

    @property
    def n_shards(self) -> int:
        return int(self.t.shape[0])

    def array_bytes(self, include_ids: bool = True) -> int:
        """Resident device bytes of the padded per-shard arrays (the
        sharded entry of ``SegmentedIndex.space_ledger()``'s device
        column); ``include_ids=False`` drops the id_leaf map.  The
        routing maps are not counted, as in the JAX package."""
        arrays = [a for lv in self.levels
                  for a in (lv.words, lv.cum, lv.labels) if a is not None]
        arrays += [self.t, self.paths_vert, self.d_words, self.d_cum,
                   self.leaf_root, self.n_local]
        if include_ids:
            arrays.append(self.id_leaf)
        return sum(a.numel() * a.element_size() for a in arrays)

    def model_bits(self) -> int:
        """In the padded layout the device arrays are the model: the
        padded payload minus the host routing maps."""
        return 8 * self.array_bytes(include_ids=False)


def _pad_to(arr: np.ndarray, n: int, fill=0) -> np.ndarray:
    pad = n - arr.shape[0]
    if pad <= 0:
        return arr
    return np.concatenate(
        [arr, np.full((pad,) + arr.shape[1:], fill, arr.dtype)])


def _host_bv(bits: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(words uint32, cum int32) of a 0/1 array, as ``BitVector``."""
    bv = BitVector.from_bits(bits)
    return bv.words.numpy().view(np.uint32), bv.cum.numpy()


def _assemble(levels_np, t_mat, paths, dwords, dcums, leafroots, idleafs,
              n_local, shard_of, pos_of, meta, device) -> ShardedBST:
    """The device ShardedBST from its host arrays."""
    def words(a):
        return as_words(a, device)

    def ints(a):
        return torch.from_numpy(np.asarray(a, np.int32).copy()).to(device)
    levels = []
    for kind, wd, cm, lb in levels_np:
        if kind == "dense":
            levels.append(ShardedLevel("dense", None, None, None))
            continue
        levels.append(ShardedLevel(
            kind, words(wd), ints(cm),
            torch.from_numpy(np.asarray(lb, np.uint8).copy()).to(device)
            if kind == "list" else None))
    shard_of = np.asarray(shard_of, np.int64)
    pos_of = np.asarray(pos_of, np.int64)
    n_max = int(meta["n_max"])
    return ShardedBST(
        levels=tuple(levels), t=ints(t_mat), paths_vert=words(paths),
        d_words=words(dwords), d_cum=ints(dcums), leaf_root=ints(leafroots),
        id_leaf=ints(idleafs), n_local=ints(n_local),
        shard_of=shard_of, pos_of=pos_of,
        merge_idx=ints(shard_of * n_max + pos_of),
        L=int(meta["L"]), b=int(meta["b"]), lm=int(meta["lm"]),
        ls=int(meta["ls"]), kinds=tuple(meta["kinds"]), n_max=n_max,
        max_leaves_per_root=int(meta["max_leaves_per_root"]))


def build_sharded_bst(sketches: np.ndarray, b: int, n_shards: int,
                      lam: float = 0.5, device="cuda") -> ShardedBST:
    """One index over ``n_shards`` padded per-shard bSTs, built on the
    host.

    sketches: (n, L) uint8 over Σ=[0, 2^b); global id i lands on shard
    ``i % n_shards``.  All shards share one static layer plan (computed
    from aggregate statistics) and common padded array shapes; true sizes
    travel as int32 data."""
    device = resolve_device(device)
    n, L = sketches.shape
    shard_of = (np.arange(n) % n_shards).astype(np.int64)
    tries: List[TrieLevels] = []
    locals_: List[np.ndarray] = []
    pos_of = np.zeros(n, np.int64)
    for s in range(n_shards):
        ids = np.flatnonzero(shard_of == s)
        pos_of[ids] = np.arange(len(ids))
        locals_.append(ids)
        tries.append(build_trie_levels(sketches[ids], b))

    # the common layer plan from aggregate statistics
    agg_t = [sum(tr.t[lev] for tr in tries) for lev in range(L + 1)]
    lm = 0
    A = 1 << b
    while lm + 1 <= L and agg_t[lm + 1] == n_shards * (A ** (lm + 1)):
        lm += 1
    ls = L
    while ls - 1 >= lm and agg_t[L] / max(agg_t[ls - 1], 1) < 1.0 / lam:
        ls -= 1
    ls = max(ls, lm)
    kinds: List[str] = []
    for lev in range(1, ls + 1):
        if lev <= lm:
            kinds.append("dense")
        elif agg_t[lev] * (b + 1) < agg_t[lev - 1] * A:
            kinds.append("list")
        else:
            kinds.append("table")

    levels_np = []
    for lev in range(1, ls + 1):
        kind = kinds[lev - 1]
        if kind == "dense":
            levels_np.append(("dense", None, None, None))
            continue
        words_l, cum_l, labels_l = [], [], []
        for tr in tries:
            if kind == "table":
                bits = np.zeros(A * tr.t[lev - 1], dtype=np.uint8)
                pos = tr.parents[lev] * A + tr.labels[lev].astype(np.int64)
                bits[pos] = 1
                wd, cm = _host_bv(bits)
                labels_l.append(np.zeros(1, np.uint8))
            else:
                par = tr.parents[lev]
                first = (np.concatenate([[True], par[1:] != par[:-1]])
                         if len(par) > 1 else np.ones(len(par), bool))
                wd, cm = _host_bv(first.astype(np.uint8))
                labels_l.append(np.asarray(tr.labels[lev]))
            words_l.append(wd)
            cum_l.append(cm)
        wmax = max(w.shape[0] for w in words_l)
        tmax = max(lb.shape[0] for lb in labels_l)
        levels_np.append((
            kind, np.stack([_pad_to(w, wmax) for w in words_l]),
            np.stack([_pad_to(c, wmax + 1, fill=c[-1]) for c in cum_l]),
            np.stack([_pad_to(lb, tmax) for lb in labels_l])))

    # the sparse tail
    sfx = L - ls
    tl_max = max(tr.t[L] for tr in tries)
    n_max = max(len(ids) for ids in locals_)
    paths, dwords, dcums, leafroots, idleafs = [], [], [], [], []
    for tr in tries:
        t_L = tr.t[L]
        if sfx > 0:
            planes = pack_vertical(tr.uniq[:, ls:], b)      # (t_L, b, W)
            pv = np.transpose(planes, (1, 2, 0))            # (b, W, t_L)
        else:
            pv = np.zeros((b, 1, t_L), np.uint32)
        pv = np.concatenate(
            [pv, np.zeros(pv.shape[:2] + (tl_max - t_L,), np.uint32)], -1)
        paths.append(pv)
        lr = tr.node_of_leaf[ls]
        d_bits = (np.concatenate([[1], (lr[1:] != lr[:-1]).astype(np.uint8)])
                  if t_L > 1 else np.ones(t_L, np.uint8))
        wd, cm = _host_bv(d_bits)
        dwords.append(wd)
        dcums.append(cm)
        leafroots.append(_pad_to(np.asarray(lr, np.int32), tl_max,
                                 fill=tr.t[ls]))
        idleafs.append(_pad_to(np.asarray(tr.id_leaf, np.int32), n_max))
    wd_max = max(w.shape[0] for w in dwords)
    max_lpr = 1
    for tr in tries:
        lr = tr.node_of_leaf[ls]
        if len(lr):
            max_lpr = max(max_lpr, int(np.bincount(lr).max()))
    meta = dict(L=L, b=b, lm=lm, ls=ls, kinds=kinds, n_max=n_max,
                max_leaves_per_root=max_lpr)
    return _assemble(
        levels_np, np.stack([np.asarray(tr.t, np.int32) for tr in tries]),
        np.stack(paths), np.stack([_pad_to(w, wd_max) for w in dwords]),
        np.stack([_pad_to(c, wd_max + 1, fill=c[-1]) for c in dcums]),
        np.stack(leafroots), np.stack(idleafs),
        [len(ids) for ids in locals_], shard_of, pos_of, meta, device)


def sharded_bst_from_numpy(meta: dict, arrays: Sequence[np.ndarray],
                           device="cuda") -> ShardedBST:
    """Rebuild a ``ShardedBST`` from the JAX package's arrays.

    meta: ``L``, ``b``, ``lm``, ``ls``, ``kinds``, ``n_max`` and
    ``max_leaves_per_root``; arrays, in order: per table level (words,
    cum), per list level (words, cum, labels), dense levels nothing; then
    t, paths_vert, d_words, d_cum, leaf_root, id_leaf, n_local, shard_of
    and pos_of.  Words may be uint32 or int32."""
    device = resolve_device(device)
    it = iter(arrays)
    levels_np = []
    for kind in meta["kinds"]:
        if kind == "dense":
            levels_np.append(("dense", None, None, None))
        elif kind == "table":
            levels_np.append(("table", next(it), next(it), None))
        elif kind == "list":
            levels_np.append(("list", next(it), next(it), next(it)))
        else:
            raise ValueError(f"unknown level kind {kind!r}")
    rest = [next(it) for _ in range(9)]
    if next(it, None) is not None:
        raise ValueError("more arrays than the metadata describes")
    return _assemble(levels_np, *rest, meta, device)


# ---------------------------------------------------------------------------
# one shard's traversal, with its true sizes
# ---------------------------------------------------------------------------

def _children_dense(u: torch.Tensor, b: int):
    A = 1 << b
    c = torch.arange(A, dtype=torch.int32, device=u.device)[None, :]
    ids = u[:, None] * A + c
    return ids, c.expand(ids.shape), torch.ones(ids.shape, dtype=torch.bool,
                                                device=u.device)


def _children_table(words, cum, u, t_prev: int, b: int):
    A = 1 << b
    c = torch.arange(A, dtype=torch.int32, device=u.device)[None, :]
    u_safe = torch.clamp(u, 0, max(t_prev - 1, 0))
    pos = u_safe[:, None] * A + c
    length = t_prev * A
    w = (pos >> WORD_SHIFT).long()
    r = (pos & WORD_MASK).to(torch.int64)
    word = words[torch.clamp(w, max=words.shape[0] - 1)].to(torch.int64)
    bit = ((word & _M32) >> r) & 1
    exists = (bit == 1) & (pos < length)
    ids = _rank(words, cum, pos, length)
    return ids, c.expand(ids.shape), exists


def _children_list(words, cum, labels, u, t_prev: int, t_cur: int, b: int):
    A = 1 << b
    u_safe = torch.clamp(u, 0, max(t_prev - 1, 0))
    length = words.shape[0] * 32
    start = _select(words, cum, u_safe + 1, length)
    end = torch.clamp(_select(words, cum, u_safe + 2, length), max=t_cur)
    j = torch.arange(A, dtype=torch.int32, device=u.device)[None, :]
    ids = start[:, None] + j
    exists = ids < end[:, None]
    lab = labels[torch.clamp(ids, 0, labels.shape[0] - 1).long()].to(
        torch.int32)
    return ids, lab, exists


def _children(index: ShardedBST, s: int, lev: int, t_row, u: torch.Tensor):
    """Children of the level-(lev-1) nodes ``u`` in shard ``s``."""
    kind = index.kinds[lev - 1]
    lv = index.levels[lev - 1]
    if kind == "dense":
        return _children_dense(u, index.b)
    if kind == "table":
        return _children_table(lv.words[s], lv.cum[s], u, int(t_row[lev - 1]),
                               index.b)
    return _children_list(lv.words[s], lv.cum[s], lv.labels[s], u,
                          int(t_row[lev - 1]), int(t_row[lev]), index.b)


def _shard_frontier(index: ShardedBST, s: int, t_row, qs: torch.Tensor,
                    tau: int, caps):
    """Shard ``s``'s 2D-frontier descent to its ℓ_s roots: ``qs`` (m, L)
    int32 -> final (ids, dists, valid), each (m, cap_ls), and (m,)
    overflow."""
    m, dev = qs.shape[0], qs.device
    ids = torch.zeros((m, 1), dtype=torch.int32, device=dev)
    dists = torch.zeros((m, 1), dtype=torch.int32, device=dev)
    valid = torch.ones((m, 1), dtype=torch.bool, device=dev)
    overflow = torch.zeros((m,), dtype=torch.int32, device=dev)
    for lev in range(1, index.ls + 1):
        cap = ids.shape[1]
        c_ids, c_lab, c_ex = _children(index, s, lev, t_row, ids.reshape(-1))
        A = c_ids.shape[-1]
        c_ids = c_ids.reshape(m, cap, A)
        c_lab = c_lab.reshape(m, cap, A)
        c_ex = c_ex.reshape(m, cap, A)
        q_char = qs[:, lev - 1][:, None, None]
        c_d = dists[:, :, None] + (c_lab != q_char).to(torch.int32)
        c_v = valid[:, :, None] & c_ex & (c_d <= tau)
        ids, dists, valid, ov = _compact_batch(
            c_ids.reshape(m, -1), c_d.reshape(m, -1), c_v.reshape(m, -1),
            caps[lev])
        overflow += ov
    return ids, dists, valid, overflow


def _scatter_min(size: int, slot: torch.Tensor, vals: torch.Tensor
                 ) -> torch.Tensor:
    """(…, size) plane of BIG with the per-slot minimum of ``vals``;
    ``slot`` == size is the sink (the reference's dropped lanes)."""
    out = torch.full(slot.shape[:-1] + (size + 1,), BIG, dtype=torch.int32,
                     device=slot.device)
    out.scatter_reduce_(-1, slot.long(), vals, "amin", include_self=True)
    return out[..., :size]


def _map_ids(index: ShardedBST, survive: torch.Tensor,
             leaf_dist: torch.Tensor, id_leaf: torch.Tensor,
             n_local: torch.Tensor):
    """Leaf planes (…, t_Lmax) -> local-id planes (…, n_max): mask and
    exact distance, BIG off the mask and past the shard's n_local."""
    t_Lmax = survive.shape[-1]
    leaf_of_id = torch.clamp(id_leaf, 0, t_Lmax - 1).long()
    local = torch.arange(index.n_max, device=survive.device) < n_local[..., None]
    idx = leaf_of_id.expand(survive.shape[:-1] + (index.n_max,))
    mask = torch.gather(survive, -1, idx) & local
    dist = torch.where(mask, torch.gather(leaf_dist, -1, idx), BIG)
    return mask, dist


def _shard_search(index: ShardedBST, s: int, t_row, q: torch.Tensor,
                  tau: int, caps, verify: str = "scan"):
    """Shard ``s``, one query (L,) -> ((n_max,) bool local mask, (n_max,)
    int32 exact local distances — BIG off-mask and on pad lanes,
    overflow).

    ``verify``: "scan" streams every collapsed suffix path past the query;
    "gather" verifies only the leaves under *surviving* ℓ_s roots,
    gathered into a fixed-capacity candidate buffer.  Both run the verify's
    plain version (``use_kernel=False``), as the JAX package does here."""
    q = q.to(torch.int32)
    dev = q.device
    ids, dists, valid, overflow = _shard_frontier(index, s, t_row, q[None],
                                                  tau, caps)
    ids, dists, valid, overflow = ids[0], dists[0], valid[0], overflow[0]
    t_L = int(t_row[index.L])
    t_Lmax = index.paths_vert.shape[-1]
    sfx = index.L - index.ls
    paths_vert = index.paths_vert[s]
    q_sfx = (pack_vertical_torch(q[None, index.ls:], index.b)[0]
             if sfx > 0 else None)

    if verify == "gather":
        # the leaf range of every surviving root, from the leftmost-leaf
        # bit vector
        d_words, d_cum = index.d_words[s], index.d_cum[s]
        safe = torch.where(valid, ids, 0)
        start = _select(d_words, d_cum, safe + 1, t_L)          # (F,)
        end = torch.clamp(_select(d_words, d_cum, safe + 2, t_L), max=t_L)
        counts = torch.where(valid, torch.clamp(end - start, min=0), 0)
        prefix = torch.cumsum(counts, 0, dtype=torch.int32)    # inclusive
        total = prefix[-1]
        cap_v = min(t_Lmax, caps[index.ls] * index.max_leaves_per_root)
        slots = torch.arange(cap_v, dtype=torch.int32, device=dev)
        root_idx = torch.searchsorted(prefix, slots, right=True)
        root_idx = torch.clamp(root_idx, 0, start.shape[0] - 1)
        excl = prefix[root_idx] - counts[root_idx]
        leaf = start[root_idx] + (slots - excl)
        ok = slots < torch.clamp(total, max=cap_v)
        leaf_safe = torch.clamp(leaf, 0, t_Lmax - 1)
        overflow = overflow + torch.clamp(total - cap_v, min=0)
        base = torch.where(ok, dists[root_idx], BIG)
        if sfx > 0:
            cand = paths_vert.index_select(2, leaf_safe.long())  # (b, W, cap_v)
            hm, cand_dist = ops.sparse_verify(cand, q_sfx, base, tau=tau,
                                              use_kernel=False)
            hit = hm > 0
        else:
            hit = base <= tau
            cand_dist = base
        slot = torch.where(ok, leaf_safe, t_Lmax).long()
        survive = torch.zeros((t_Lmax + 1,), dtype=torch.uint8, device=dev)
        survive.scatter_reduce_(0, slot, (hit & ok).to(torch.uint8), "amax",
                                include_self=True)
        survive = survive[:t_Lmax].bool()
        leaf_dist = _scatter_min(t_Lmax, slot,
                                 torch.where(hit & ok, cand_dist, BIG))
    else:
        slot = torch.where(valid, torch.clamp(ids, 0, t_Lmax), t_Lmax)
        base_root = torch.full((t_Lmax + 1,), BIG, dtype=torch.int32,
                               device=dev)
        base_root.scatter_reduce_(0, slot.long(),
                                  torch.where(valid, dists, BIG), "amin",
                                  include_self=True)
        lr = torch.clamp(index.leaf_root[s], 0, t_Lmax).long()
        base_leaf = base_root[lr]
        lanes = torch.arange(t_Lmax, device=dev)
        base_leaf = torch.where(lanes < t_L, base_leaf, BIG)
        if sfx > 0:
            hm, leaf_dist = ops.sparse_verify(paths_vert, q_sfx, base_leaf,
                                              tau=tau, use_kernel=False)
            survive = hm > 0
        else:
            survive = base_leaf <= tau
            leaf_dist = base_leaf
    mask, dist = _map_ids(index, survive, leaf_dist, index.id_leaf[s],
                          index.n_local[s])
    return mask, dist, overflow


def _shard_search_batch(index: ShardedBST, t_host: np.ndarray,
                        qs: torch.Tensor, tau: int, caps,
                        block_m: int = ops.DEFAULT_BLOCK_M):
    """Every shard, the WHOLE query batch -> ((S, m, n_max) bool local
    masks, (S, m, n_max) int32 exact local distances, (S, m) int32
    overflow) — the "scan" verify mode.

    Each shard descends its (m, cap) 2D frontier in turn and scatters it
    onto its own (m, t_Lmax + 1) ℓ_s-root plane (column t_Lmax is the
    sink); the S leaf base planes stack into (S, m, t_Lmax), and ONE
    batched verify launch streams every shard's padded collapsed-path
    array past the shared query planes."""
    qs = qs.to(torch.int32)
    m, dev = qs.shape[0], qs.device
    S = index.n_shards
    t_Lmax = index.paths_vert.shape[-1]
    lanes = torch.arange(t_Lmax, device=dev)
    bases, overflows = [], []
    for s in range(S):
        t_row = t_host[s]
        ids, dists, valid, ov = _shard_frontier(index, s, t_row, qs, tau,
                                                caps)
        slot = torch.where(valid, torch.clamp(ids, 0, t_Lmax), t_Lmax)
        base_root = torch.full((m, t_Lmax + 1), BIG, dtype=torch.int32,
                               device=dev)
        base_root.scatter_reduce_(1, slot.long(),
                                  torch.where(valid, dists, BIG), "amin",
                                  include_self=True)
        lr = torch.clamp(index.leaf_root[s], 0, t_Lmax).long()
        base_leaf = base_root.index_select(1, lr)               # (m, t_Lmax)
        bases.append(torch.where(lanes[None, :] < int(t_row[index.L]),
                                 base_leaf, BIG))
        overflows.append(ov)
    base = torch.stack(bases)                                   # (S, m, t_Lmax)
    if index.L - index.ls > 0:
        q_sfx = ops.to_lane_major(pack_vertical_torch(qs[:, index.ls:],
                                                      index.b))  # (b, W, m)
        hm, leaf_dist = ops.sparse_verify_batch_batched(
            index.paths_vert, q_sfx, base, tau=tau, block_m=block_m)
        survive = hm > 0
    else:
        survive = base <= tau
        leaf_dist = base
    mask, dist = _map_ids(index, survive, leaf_dist, index.id_leaf[:, None, :],
                          index.n_local[:, None])
    return mask, dist, torch.stack(overflows)


def expected_caps(t: Tuple[int, ...], b: int, tau: int,
                  safety: int = 16, floor: int = 64) -> Tuple[int, ...]:
    """Expected-case frontier capacities: for uniform sketches the
    expected level-ℓ frontier is t_ℓ · sigs(b, ℓ, τ) / A^ℓ, far below the
    worst-case bound of ``frontier_capacities``.  The overflow counter
    and the host retry ladder keep the answer exact."""
    A = 1 << b
    caps = [1]
    for lev in range(1, len(t)):
        exp = t[lev] * min(
            sum(math.comb(lev, k) * (A - 1) ** k for k in range(tau + 1))
            / float(A) ** lev, 1.0)
        caps.append(int(min(t[lev], max(floor, safety * math.ceil(exp)))))
    return tuple(caps)


def _t_host(index: ShardedBST) -> np.ndarray:
    """(S, L+1) true node counts, on the host (one small copy)."""
    return index.t.cpu().numpy()


def _as_queries(index: ShardedBST, qs) -> torch.Tensor:
    if not torch.is_tensor(qs):
        qs = torch.from_numpy(np.asarray(qs).astype(np.int32))
    return qs.to(device=index.device, dtype=torch.int32)


def sharded_column_dists(index: ShardedBST, queries: torch.Tensor, tau: int,
                         caps, block_m: int = ops.DEFAULT_BLOCK_M,
                         live: torch.Tensor | None = None,
                         t_host: np.ndarray | None = None):
    """The sharded search merged onto global columns — a sharded
    segment's part of the segmented index's fused program.

    queries: (m, L) -> ((m, n) int32 exact global column distances, BIG
    off-mask and on dead columns; int32 total overflow).  The shard ->
    global merge is one device gather through ``merge_idx``.  ``live``:
    optional (n,) bool tombstone lane over global rows."""
    if t_host is None:
        t_host = _t_host(index)
    _, dists, overflows = _shard_search_batch(index, t_host, queries, tau,
                                              caps, block_m=block_m)
    m = dists.shape[1]
    merged = dists.transpose(0, 1).reshape(m, -1).index_select(
        1, index.merge_idx)                                     # (m, n)
    if live is not None:
        merged = torch.where(live[None, :], merged, BIG)
    return merged, overflows.sum()


def make_sharded_searcher(index: ShardedBST, tau: int,
                          cap_max: int = 1 << 14, verify: str = "scan",
                          caps_mode: str = "worst",
                          block_m: int = ops.DEFAULT_BLOCK_M):
    """Returns f(queries (m, L)) -> ((m, S, n_max) bool masks, (m, S,
    n_max) int32 exact distances, int32 overflow).

    ``verify="scan"`` (the default) batches the queries inside each shard
    and verifies every shard in one launch (``_shard_search_batch``).
    ``verify="gather"`` runs the per-query search (candidate gathering is
    query-dependent), each query against each shard in turn."""
    t_host = _t_host(index)
    t_max = tuple(int(x) for x in t_host.max(axis=0))
    if caps_mode == "expected":
        caps = expected_caps(t_max, index.b, tau)
    else:
        caps = frontier_capacities(t_max, index.b, tau, cap_max)

    if verify == "scan":
        def search(queries):
            masks, dists, overflows = _shard_search_batch(
                index, t_host, _as_queries(index, queries), tau, caps,
                block_m=block_m)
            # (S, m, ...) -> (m, S, ...): the public result contract
            return (masks.transpose(0, 1), dists.transpose(0, 1),
                    overflows.sum())
    else:
        def search(queries):
            queries = _as_queries(index, queries)
            masks, dists, overflow = [], [], torch.zeros(
                (), dtype=torch.int32, device=index.device)
            for q in queries:
                rows = [_shard_search(index, s, t_host[s], q, tau, caps,
                                      verify=verify)
                        for s in range(index.n_shards)]
                masks.append(torch.stack([r[0] for r in rows]))
                dists.append(torch.stack([r[1] for r in rows]))
                overflow = overflow + sum(r[2] for r in rows)
            return torch.stack(masks), torch.stack(dists), overflow
    return search


def gather_ids(index: ShardedBST, masks) -> List[np.ndarray]:
    """(m, S, n_max) masks -> per-query arrays of global ids."""
    masks = masks.cpu().numpy() if torch.is_tensor(masks) else np.asarray(masks)
    return [np.flatnonzero(qmask[index.shard_of, index.pos_of])
            for qmask in masks]


def topk_from_dists(dists: np.ndarray, k: int,
                    ids: Optional[np.ndarray] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Select per-query top-k from merged distance planes.

    dists: (m, n) int32 — one distance per (query, column), BIG on
    non-results; ids: optional (n,) int global labels per column
    (default: the column index itself).  Returns ((m, k) int32 ids,
    (m, k) int32 dists), each row sorted ascending by (distance, label);
    slots beyond a query's real survivors are (-1, BIG) pads.
    """
    m, n = dists.shape
    kk = min(k, n)
    labels = np.arange(n, dtype=np.int64) if ids is None \
        else np.asarray(ids, dtype=np.int64)
    out_ids = np.full((m, k), -1, np.int32)
    out_d = np.full((m, k), int(BIG), np.int32)
    for qi in range(m):
        d = np.asarray(dists[qi])
        # partial selection, then a full (distance, label) sort over
        # every candidate at or below the k-th distance — a bare
        # argpartition would pick arbitrarily among ties at the boundary
        if kk < n:
            thresh = d[np.argpartition(d, kk - 1)[:kk]].max()
            cand = np.flatnonzero(d <= thresh)
        else:
            cand = np.arange(n)
        order = cand[np.lexsort((labels[cand], d[cand]))][:kk]
        real = d[order] < int(BIG)
        out_ids[qi, :kk] = np.where(real, labels[order], -1)
        out_d[qi, :kk] = d[order]
    return out_ids, out_d


def gather_topk(index: ShardedBST, dists, k: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Merge per-shard distance planes into the global per-query top-k.

    dists: (m, S, n_max) int32 from the sharded searcher (BIG off-mask).
    Returns ((m, k) ids, (m, k) dists), each row ascending by (distance,
    id), through ``topk_from_dists`` on the host.  Slots past a query's
    within-τ survivors are (-1, BIG) pads: there is no τ ladder here."""
    dists = dists.cpu().numpy() if torch.is_tensor(dists) else np.asarray(dists)
    merged = dists[:, index.shard_of, index.pos_of]             # (m, n)
    return topk_from_dists(merged, k)
