"""Wrappers around the hand-written CUDA kernels (``csrc/*.cu``).

Each wrapper takes tensors in the kernel layout — (b, W, n) int32
bit-views of the uint32 bit-plane words, database axis last; (n,)
packed suffix words; (Wp, n) payload bitmaps — and dispatches on where
they lie:

  * a CUDA tensor launches the kernel, at every n (``use_kernel=False``
    is the one explicit request for the plain version there);
  * a CPU tensor runs the plain version in ``ref.py``.

``block_m`` is the query tile (queries played against each database word
a thread loads; rounded up to a power of two, at most 32) and
``block_n`` the database columns of one CUDA block (a multiple of 32,
at most 1024) of the scan and the static verify: the same two tile axes
as the TPU kernels' grid.  The arena verifies, the re-rank and the flash
kernel take their own tiles, and accept the two for the common
signature only.  The kernels mask the ragged edges themselves, so
nothing is padded here.

``hamming_distances_batched`` and ``sparse_verify_batch_batched`` are
the scan and the verify over a leading batch axis, in one launch
(grid.z): the sharded bST verify batches its shards, and the batched
scan is the counterpart of the JAX package's ``vmap`` of the scan.  The
unbatched scan and static verifies launch the same kernels at batch 1.
``hamming_distances_gather`` is the MI-bST candidate verify: it reads
the database through each query's candidate ids and scores only the
valid prefix of its row, with no gathered copy.

``flash_attention_fwd`` and ``flash_attention_bwd`` are the float
kernels: (B, H, S, D) float32 or bfloat16 attention and its FA-2
gradient, read through strides.

While an op counter is active (``launch/op_cost.py``'s ``OpCounter``,
the dry-run's), the flash wrappers, the scan and static verify wrappers
and the candidate verify record their kernel's operations and bytes
from their arguments — the reckoning of the bound column of PERF.md's
kernel table, so the count reads the same work whatever runs it — and
the ops they run inside are not counted again.  On the ``meta`` device
they then return empty outputs of the kernel's shapes and dtypes; on
CUDA they still launch the kernel and on the CPU run the plain version.
With no counter the wrappers pay one test of a module global.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from . import ref
from .ref import BIG, RERANK_METRICS

DEFAULT_BLOCK_M = 8
DEFAULT_BLOCK_N = 256
_MAX_TILE_M = 32

# Process-wide launch ledger keyed by wrapper name: ``<name>`` counts
# kernel launches (bumped after the launch succeeded, and only there),
# ``<name>:ref`` calls that ran the plain version instead, and, for the
# flash kernels, ``<name>:bf16`` / ``<name>:f32`` the same launches by the
# route their dtype chose (tensor cores / scalar) and
# ``flash_attention_fwd:lse`` the forwards that also wrote the lse.
_KSTATS_LOCK = threading.Lock()
_KERNEL_STATS: dict = {}


def _count(name: str, launched: bool, *routes: str) -> None:
    keys = [name] if launched else [name + ":ref"]
    if launched:
        keys += [f"{name}:{route}" for route in routes]
    with _KSTATS_LOCK:
        for key in keys:
            _KERNEL_STATS[key] = _KERNEL_STATS.get(key, 0) + 1


def kernel_stats() -> dict:
    """Per-wrapper call counts (``<name>`` kernel launched, ``<name>:ref``
    plain version ran, ``<name>:bf16``/``<name>:f32`` the flash kernels'
    launches by route, ``flash_attention_fwd:lse`` forwards with lse)."""
    with _KSTATS_LOCK:
        return dict(_KERNEL_STATS)


def reset_kernel_stats() -> None:
    with _KSTATS_LOCK:
        _KERNEL_STATS.clear()


# ---------------------------------------------------------------------------
# counting by formula (the dry-run)
# ---------------------------------------------------------------------------

_COUNTER = None     # the active ``launch.op_cost.OpCounter``, or None


def set_counter(counter):
    """Make ``counter`` the active op counter (None: none); returns the
    previous one."""
    global _COUNTER
    prev, _COUNTER = _COUNTER, counter
    return prev


def _count_call(fn, cost, *args, **kw):
    """``fn(*args, **kw)`` with the counter inactive inside, its kernel's
    (operations, bytes, empty outputs) from ``cost(*args, **kw)`` recorded
    by formula; on ``meta`` inputs the empty outputs are the result."""
    counter = set_counter(None)
    try:
        ops_, nbytes, empty = cost(*args, **kw)
        with counter.kernel(fn.__name__, ops_, nbytes):
            out = empty() if args[0].is_meta else fn(*args, **kw)
    finally:
        set_counter(counter)
    counter.allocated(out)
    return out


def _scan_cost(B: int, b: int, W: int, n: int, m: int, q_sets: int,
               verify: bool):
    """(operations, bytes) of a scan or static verify launch: B databases
    of (b, W, n) words and ``q_sets`` sets of m query columns read once,
    B (m, n) planes in (the verify's base) and out; per (entry, query,
    column) W·(b XOR + (b-1) OR + popc + add), plus add, compare and min
    for the verify (``chip_smoke.py``'s ``batched_bound``)."""
    planes = 3 if verify else 1
    return (B * m * n * (W * (2 * b + 1) + (3 if verify else 0)),
            4 * (B * b * W * n + q_sets * b * W * m + planes * B * m * n))


def _int32_planes(shape, device, count: int):
    """A maker of ``count`` empty int32 planes (a plane alone at 1)."""
    def make():
        out = tuple(torch.empty(shape, dtype=torch.int32, device=device)
                    for _ in range(count))
        return out if count > 1 else out[0]
    return make


def visible_pairs(Sq: int, Skv: int, causal: bool, window: int,
                  q_offset: int) -> int:
    """The (query, key) pairs a flash kernel's masks leave visible in one
    (batch, head)."""
    pos = np.arange(Sq, dtype=np.int64) + q_offset
    hi = np.minimum(pos + 1, Skv) if causal else np.full(Sq, Skv)
    lo = np.maximum(pos - window + 1, 0) if window else np.zeros(Sq)
    return int(np.maximum(hi - lo, 0).sum())


def _flash_fwd_cost(q, k, v, *, causal=True, window=0, q_offset=0,
                    return_lse=False, **_):
    """4·pairs·D operations (q·kᵀ and p·v); q, k, v read and the output
    written once, the lse (float32) written where asked."""
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    pairs = B * H * visible_pairs(Sq, Skv, causal, window, q_offset)
    es = q.element_size()
    nbytes = es * (2 * B * H * Sq * D + 2 * B * H * Skv * D) + (
        4 * B * H * Sq if return_lse else 0)

    def empty():
        out = torch.empty((B, Sq, H, D), dtype=q.dtype,
                          device=q.device).transpose(1, 2)
        if not return_lse:
            return out
        return out, torch.empty((B, H, Sq), dtype=torch.float32,
                                device=q.device)
    return 4 * pairs * D, nbytes, empty


def _flash_bwd_cost(q, k, v, out, lse, dout, *, causal=True, window=0,
                    q_offset=0, **_):
    """10·pairs·D operations (s recomputed, dp, dq, dk, dv); q, out, dout
    and k, v read, dq, dk, dv written, the lse read."""
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    pairs = B * H * visible_pairs(Sq, Skv, causal, window, q_offset)
    es = q.element_size()
    nbytes = es * 4 * B * H * (Sq + Skv) * D + 4 * B * H * Sq

    def empty():
        return tuple(torch.empty((B, S, H, D), dtype=q.dtype,
                                 device=q.device).transpose(1, 2)
                     for S in (Sq, Skv, Skv))
    return 10 * pairs * D, nbytes, empty


def _scan_cost_call(db_vert, q_vert, **_):
    b, W, n = db_vert.shape
    m = q_vert.shape[-1]
    return (*_scan_cost(1, b, W, n, m, 1, False),
            _int32_planes((m, n), db_vert.device, 1))


def _scan_batched_cost(db_vert, q_vert, **_):
    B, b, W, n = db_vert.shape
    m = q_vert.shape[-1]
    return (*_scan_cost(B, b, W, n, m, q_vert.shape[0], False),
            _int32_planes((B, m, n), db_vert.device, 1))


def _verify_cost(paths_vert, q_vert, base_dist, **_):
    b, W, n = paths_vert.shape
    m = q_vert.shape[-1] if q_vert.dim() == 3 else 1
    shape = (m, n) if q_vert.dim() == 3 else (n,)
    return (*_scan_cost(1, b, W, n, m, 1, True),
            _int32_planes(shape, paths_vert.device, 2))


def _verify_batched_cost(paths_vert, q_vert, base_dist, **_):
    B, b, W, n = paths_vert.shape
    m = q_vert.shape[-1]
    return (*_scan_cost(B, b, W, n, m, 1, True),
            _int32_planes((B, m, n), paths_vert.device, 2))


def _gather_cost(full_vert, q_vert, ids, counts, **_):
    """(operations, bytes, empty output) of a candidate verify over V
    valid slots: the function's own bytes — V ids and the b·W words of
    each valid candidate read, every (m, C) output slot written, the
    query words and counts read — and V·W·(b XOR + (b-1) OR + popc +
    add) operations.  V is the clamped counts' sum, or every slot on
    ``meta``, where the counts are unknown.  (The card moves a 32-byte
    sector for each gathered word of far-apart candidates: a cost of the
    (b, W, n) layout, not of the function; PERF.md's row 2b prints it
    beside the bound.)"""
    b, W, _ = full_vert.shape
    m, C = ids.shape
    V = m * C if counts.is_meta else int(counts.clamp(0, C).sum())
    nbytes = 4 * V + 4 * b * W * V + 4 * m * C + 4 * (b * W * m + m)
    return (V * W * (2 * b + 1), nbytes,
            _int32_planes((m, C), full_vert.device, 1))


def to_lane_major(planes: torch.Tensor) -> torch.Tensor:
    """(n, b, W) sketch-major -> (b, W, n) lane-major (kernel layout)."""
    return planes.permute(1, 2, 0).contiguous()


def _on_kernel(x: torch.Tensor, use_kernel: bool | None) -> bool:
    return x.is_cuda and use_kernel is not False


def _tile_m(block_m: int, m: int) -> int:
    t = max(1, min(block_m, m, _MAX_TILE_M))
    return 1 << (t - 1).bit_length()


# The arena verifies walk the queries in passes of Q, through a (T,) slab
# of 4-bit codes of the pass's Q rows of the base plane (csrc/arena.cu):
# the most queries whose slab stays within SLAB_BYTES, well inside the
# card's 50 MB L2.
SLAB_BYTES = 16 << 20
_SLAB_DTYPES = {4: torch.int16, 8: torch.int32, 16: torch.int64}


def _slab_queries(T: int) -> int:
    """Queries per pass of the arena verifies at T roots: 16, 8 or 4."""
    for q in (16, 8):
        if T * q // 2 <= SLAB_BYTES:
            return q
    return 4


def _slab(T: int, device: torch.device):
    """(slab, Q): the (T,) scratch of an arena verify and its queries per
    pass."""
    q = _slab_queries(T)
    return torch.empty((T,), dtype=_SLAB_DTYPES[q], device=device), q


def _check(name: str, db: torch.Tensor, q: torch.Tensor,
           base: torch.Tensor | None) -> None:
    """The scan's and the verifies' operands: contiguous int32 (B, b, W, n)
    planes, queries (B or 1, b, W, m) and, for the verify, a (B, m, n)
    int32 base plane.  The unbatched wrappers pass their operands as the
    B = 1 views ``x[None]``."""
    for what, x in (("database", db), ("queries", q)):
        if x.dtype != torch.int32 or x.dim() != 4 or not x.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous (b, W, ·) "
                             f"int32 bit-view (batched: (B, b, W, ·)), got "
                             f"{x.dtype} {tuple(x.shape[1:])} under batch "
                             f"{x.shape[0] if x.dim() else None}")
        if x.device != db.device:
            raise ValueError(f"{name}: {what} on {x.device}, "
                             f"database on {db.device}")
    B = db.shape[0]
    if q.shape[1:3] != db.shape[1:3]:
        raise ValueError(f"{name}: query planes {tuple(q.shape[1:3])} != "
                         f"database planes {tuple(db.shape[1:3])}")
    if q.shape[0] not in (1, B):
        raise ValueError(f"{name}: query batch {q.shape[0]} is neither 1 "
                         f"nor the database batch {B}")
    if base is not None and (base.dtype != torch.int32
                             or base.shape != (B, q.shape[-1], db.shape[-1])
                             or not base.is_contiguous()
                             or base.device != db.device):
        raise ValueError(f"{name}: base must be a contiguous (m, n) int32 "
                         f"tensor (batched: (B, m, n)) on {db.device}, got "
                         f"{base.dtype} {tuple(base.shape)} on {base.device}")
    if B > 65535:
        raise ValueError(f"{name}: batch {B} exceeds the grid's z extent")


def _launch_scan(name, db_vert, q_vert, block_m, block_n):
    """(B, b, W, n) x (B or 1, b, W, m) -> (B, m, n) in one launch
    (grid.z = B), counted under ``name``; a query batch of 1 is shared
    (batch stride 0)."""
    from . import _build
    _check(name, db_vert, q_vert, None)
    B, b, W, n = db_vert.shape
    m = q_vert.shape[-1]
    out = torch.empty((B, m, n), dtype=torch.int32, device=db_vert.device)
    lib = _build.load_library()
    code = lib.hamming_distances_batched_launch(
        db_vert.data_ptr(), q_vert.data_ptr(), out.data_ptr(), n, m, b, W, B,
        b * W * n, 0 if q_vert.shape[0] == 1 else b * W * m, m * n,
        _tile_m(block_m, m), block_n,
        torch.cuda.current_stream(db_vert.device).cuda_stream)
    _build.check(lib, code, name)
    _count(name, B * m * n > 0)
    return out


def _launch_verify(name, paths_vert, q_vert, base, tau, block_m, block_n):
    """(B, b, W, n) paths x (1, b, W, m) shared queries + (B, m, n) base ->
    ((B, m, n) masks, (B, m, n) totals) in one launch, counted under
    ``name``."""
    from . import _build
    _check(name, paths_vert, q_vert, base)
    B, b, W, n = paths_vert.shape
    m = q_vert.shape[-1]
    mask = torch.empty((B, m, n), dtype=torch.int32, device=paths_vert.device)
    dist = torch.empty_like(mask)
    lib = _build.load_library()
    code = lib.sparse_verify_batch_batched_launch(
        paths_vert.data_ptr(), q_vert.data_ptr(), base.data_ptr(),
        mask.data_ptr(), dist.data_ptr(), n, m, b, W, int(tau), B,
        b * W * n, 0, m * n, m * n, _tile_m(block_m, m), block_n,
        torch.cuda.current_stream(paths_vert.device).cuda_stream)
    _build.check(lib, code, name)
    _count(name, B * m * n > 0)
    return mask, dist


def hamming_distances(db_vert: torch.Tensor, q_vert: torch.Tensor,
                      *, block_m: int = DEFAULT_BLOCK_M,
                      block_n: int = DEFAULT_BLOCK_N,
                      use_kernel: bool | None = None) -> torch.Tensor:
    """(b, W, n) x (b, W, m) -> (m, n) int32 Hamming distances: the
    batch-1 case of ``hamming_distances_batched``."""
    if _COUNTER is not None:
        return _count_call(hamming_distances, _scan_cost_call, db_vert,
                           q_vert, block_m=block_m, block_n=block_n,
                           use_kernel=use_kernel)
    if not _on_kernel(db_vert, use_kernel):
        _count("hamming_distances", False)
        return ref.hamming_distances_ref(db_vert, q_vert)
    return _launch_scan("hamming_distances", db_vert[None], q_vert[None],
                        block_m, block_n)[0]


def hamming_distances_batched(db_vert: torch.Tensor, q_vert: torch.Tensor,
                              *, block_m: int = DEFAULT_BLOCK_M,
                              block_n: int = DEFAULT_BLOCK_N,
                              use_kernel: bool | None = None) -> torch.Tensor:
    """(B, b, W, n) x (B or 1, b, W, m) -> (B, m, n) int32 Hamming
    distances: ``hamming_distances`` for B databases in ONE launch
    (grid.z = B).  A query batch of 1 is shared by every entry (batch
    stride 0).  Per-query candidate sets, (m, b, W, C) against (m, b, W,
    1), are the JAX package's ``vmap`` of the scan over the MI-bST's
    queries (the port's MI path takes ``hamming_distances_gather``)."""
    if _COUNTER is not None:
        return _count_call(hamming_distances_batched, _scan_batched_cost,
                           db_vert, q_vert, block_m=block_m,
                           block_n=block_n, use_kernel=use_kernel)
    if not _on_kernel(db_vert, use_kernel):
        _count("hamming_distances_batched", False)
        return ref.hamming_distances_batched_ref(db_vert, q_vert)
    return _launch_scan("hamming_distances_batched", db_vert, q_vert,
                        block_m, block_n)


def _check_gather(full_vert: torch.Tensor, q_vert: torch.Tensor,
                  ids: torch.Tensor, counts: torch.Tensor) -> None:
    """The candidate verify's operands: contiguous int32 (b, W, n) planes
    with b in 1..8, (b, W, m) queries, m <= 65535, (m,) counts, and (m, C)
    int32 ids whose columns are contiguous (a row stride >= C, such as a
    slice of a wider compaction buffer, is taken as it is)."""
    name = "hamming_distances_gather"
    dev = full_vert.device
    for what, x, dim in (("full_vert", full_vert, 3), ("q_vert", q_vert, 3),
                         ("counts", counts, 1), ("ids", ids, 2)):
        if x.dtype != torch.int32 or x.dim() != dim or x.device != dev:
            raise ValueError(f"{name}: {what} must be a {dim}-D int32 tensor "
                             f"on {dev}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
        if what != "ids" and not x.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    b, W, _ = full_vert.shape
    m, C = ids.shape
    if tuple(q_vert.shape) != (b, W, m) or tuple(counts.shape) != (m,):
        raise ValueError(f"{name}: queries {tuple(q_vert.shape)} and counts "
                         f"{tuple(counts.shape)} do not fit planes "
                         f"{(b, W)} and ids {(m, C)}")
    if (C > 1 and ids.stride(1) != 1) or (m > 1 and ids.stride(0) < C):
        raise ValueError(f"{name}: ids must have contiguous rows, got "
                         f"strides {ids.stride()}")
    if not 1 <= b <= 8 or m > 65535:
        raise ValueError(f"{name}: b={b} outside 1..8 or m={m} past the "
                         "grid's y extent")


def hamming_distances_gather(full_vert: torch.Tensor, q_vert: torch.Tensor,
                             ids: torch.Tensor, counts: torch.Tensor, *,
                             use_kernel: bool | None = None) -> torch.Tensor:
    """(b, W, n) database x (b, W, m) queries through (m, C) candidate ids
    -> (m, C) int32: the Hamming distance of query j to ``ids[j, s]`` for
    s < ``counts[j]``, BIG past it — the MI-bST candidate verify (the JAX
    package gathers ``full_vert[:, :, ids]`` and vmaps the scan over the
    queries).  The kernel reads each valid candidate's words through its
    id and only stores BIG past the counts."""
    if _COUNTER is not None:
        return _count_call(hamming_distances_gather, _gather_cost, full_vert,
                           q_vert, ids, counts, use_kernel=use_kernel)
    name = "hamming_distances_gather"
    _check_gather(full_vert, q_vert, ids, counts)
    if not _on_kernel(full_vert, use_kernel):
        _count(name, False)
        return ref.hamming_distances_gather_ref(full_vert, q_vert, ids, counts)
    from . import _build
    b, W, n = full_vert.shape
    m, C = ids.shape
    out = torch.empty((m, C), dtype=torch.int32, device=full_vert.device)
    lib = _build.load_library()
    code = lib.hamming_distances_gather_launch(
        full_vert.data_ptr(), q_vert.data_ptr(), ids.data_ptr(),
        counts.data_ptr(), out.data_ptr(), n, m, C, b, W,
        ids.stride(0) if m > 1 else C,
        torch.cuda.current_stream(full_vert.device).cuda_stream)
    _build.check(lib, code, name)
    _count(name, m * C > 0)
    return out


def sparse_verify_batch_batched(paths_vert: torch.Tensor,
                                q_vert: torch.Tensor,
                                base_dist: torch.Tensor, *, tau: int,
                                block_m: int = DEFAULT_BLOCK_M,
                                block_n: int = DEFAULT_BLOCK_N,
                                use_kernel: bool | None = None):
    """``sparse_verify_batch`` for B databases in ONE launch (grid.z = B):

    paths_vert: (B, b, W, n) — one collapsed-path array per entry (the
                sharded bST's padded shards);
    q_vert:     (b, W, m) — the query suffixes, shared (batch stride 0);
    base_dist:  (B, m, n) per-entry prefix distances (BIG = pruned);
    returns ((B, m, n) int32 masks, (B, m, n) int32 totals, BIG-clamped).
    """
    if _COUNTER is not None:
        return _count_call(sparse_verify_batch_batched, _verify_batched_cost,
                           paths_vert, q_vert, base_dist, tau=tau,
                           block_m=block_m, block_n=block_n,
                           use_kernel=use_kernel)
    base_dist = base_dist.to(torch.int32)
    if not _on_kernel(paths_vert, use_kernel):
        _count("sparse_verify_batch_batched", False)
        mask, dist = ref.sparse_verify_batch_batched_ref(paths_vert, q_vert,
                                                         base_dist, tau)
        return mask.to(torch.int32), dist
    return _launch_verify("sparse_verify_batch_batched", paths_vert,
                          q_vert[None], base_dist.contiguous(), tau, block_m,
                          block_n)


def sparse_verify(paths_vert: torch.Tensor, q_vert: torch.Tensor,
                  base_dist: torch.Tensor, *, tau: int,
                  live: torch.Tensor | None = None,
                  block_n: int = DEFAULT_BLOCK_N,
                  use_kernel: bool | None = None):
    """Fused single-query verify: ((n,) int32 mask of leaves with
    prefix+suffix dist <= tau, (n,) int32 exact total distances —
    BIG-clamped when pruned).  ``live`` is an optional (n,) bool
    tombstone mask: dead lanes get a BIG base distance, so they are
    pruned exactly like subtries the traversal never reached.  The m=1
    case of the batched kernel."""
    if _COUNTER is not None:
        return _count_call(sparse_verify, _verify_cost, paths_vert, q_vert,
                           base_dist, tau=tau, live=live, block_n=block_n,
                           use_kernel=use_kernel)
    base_dist = base_dist.to(torch.int32)
    if live is not None:
        base_dist = torch.where(live, base_dist, BIG)
    if not _on_kernel(paths_vert, use_kernel):
        _count("sparse_verify", False)
        mask, dist = ref.sparse_verify_ref(paths_vert, q_vert, base_dist, tau)
        return mask.to(torch.int32), dist
    mask, dist = _launch_verify("sparse_verify", paths_vert[None],
                                q_vert[None, ..., None].contiguous(),
                                base_dist[None, None, :].contiguous(), tau, 1,
                                block_n)
    return mask[0, 0], dist[0, 0]


def sparse_verify_batch(paths_vert: torch.Tensor, q_vert: torch.Tensor,
                        base_dist: torch.Tensor, *, tau: int,
                        live: torch.Tensor | None = None,
                        block_m: int = DEFAULT_BLOCK_M,
                        block_n: int = DEFAULT_BLOCK_N,
                        use_kernel: bool | None = None):
    """Fused query-tiled verify over a whole batch (the batch-1 case of
    ``sparse_verify_batch_batched``).

    paths_vert: (b, W, n) collapsed suffix paths (shared database);
    q_vert:     (b, W, m) query suffixes;
    base_dist:  (m, n) per-query prefix distances (BIG = pruned subtrie);
    live:       optional (n,) bool tombstone mask shared by every query —
                dead lanes get a BIG base distance;
    returns ((m, n) int32 masks, (m, n) int32 exact totals, BIG-clamped).
    """
    if _COUNTER is not None:
        return _count_call(sparse_verify_batch, _verify_cost, paths_vert,
                           q_vert, base_dist, tau=tau, live=live,
                           block_m=block_m, block_n=block_n,
                           use_kernel=use_kernel)
    base_dist = base_dist.to(torch.int32)
    if live is not None:
        base_dist = torch.where(live[None, :], base_dist, BIG)
    if not _on_kernel(paths_vert, use_kernel):
        _count("sparse_verify_batch", False)
        mask, dist = ref.sparse_verify_batch_ref(paths_vert, q_vert,
                                                 base_dist, tau)
        return mask.to(torch.int32), dist
    mask, dist = _launch_verify("sparse_verify_batch", paths_vert[None],
                                q_vert[None], base_dist[None].contiguous(),
                                tau, block_m, block_n)
    return mask[0], dist[0]


def _check_lanes(name: str, n: int, base_plane: torch.Tensor, m: int,
                 base_idx: torch.Tensor, live: torch.Tensor,
                 device: torch.device) -> None:
    """The arena verifies' shared lanes: an (m, T) int32 plane with
    T >= 1, an (n,) int32 segment-offset lane and an (n,) bool liveness
    lane, contiguous, on the columns' device."""
    if (base_plane.dtype != torch.int32 or base_plane.dim() != 2
            or base_plane.shape[0] != m or base_plane.shape[1] < 1
            or not base_plane.is_contiguous() or base_plane.device != device):
        raise ValueError(f"{name}: base_plane must be a contiguous (m={m}, "
                         f"T>=1) int32 tensor on {device}, got "
                         f"{base_plane.dtype} {tuple(base_plane.shape)} on "
                         f"{base_plane.device}")
    for what, x, dtype in (("base_idx", base_idx, torch.int32),
                           ("live", live, torch.bool)):
        if (x.dtype != dtype or x.shape != (n,) or not x.is_contiguous()
                or x.device != device):
            raise ValueError(f"{name}: {what} must be a contiguous ({n},) "
                             f"{dtype} tensor on {device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")


def sparse_verify_arena(paths_vert: torch.Tensor, q_vert: torch.Tensor,
                        base_plane: torch.Tensor, base_idx: torch.Tensor,
                        live: torch.Tensor, *, tau: int,
                        block_m: int = DEFAULT_BLOCK_M,
                        block_n: int = DEFAULT_BLOCK_N,
                        use_kernel: bool | None = None):
    """Fused multi-segment verify over a column arena.

    paths_vert: (b, W, n) concatenated verify columns (every segment and
                the delta buffer, one column per physical row);
    q_vert:     (b, W, m) query planes;
    base_plane: (m, T) per-(segment, root) base distances (BIG = pruned);
    base_idx:   (n,) int32 index of each column into the T axis, in
                [0, T) (the segment-offset lane);
    live:       (n,) bool per-column liveness;
    returns ((m, n) int32 masks, (m, n) int32 totals, BIG-clamped).

    The kernel is the packed verify's query-major slab pass over plane
    columns; ``block_m``/``block_n`` are accepted for the common
    signature of the verifies only."""
    if not _on_kernel(paths_vert, use_kernel):
        _count("sparse_verify_arena", False)
        mask, dist = ref.sparse_verify_arena_ref(paths_vert, q_vert,
                                                 base_plane, base_idx, live,
                                                 tau)
        return mask.to(torch.int32), dist
    from . import _build
    name = "sparse_verify_arena"
    _check(name, paths_vert[None], q_vert[None], None)
    b, W, n = paths_vert.shape
    m = q_vert.shape[-1]
    dev = paths_vert.device
    _check_lanes(name, n, base_plane, m, base_idx, live, dev)
    T = base_plane.shape[1]
    mask = torch.empty((m, n), dtype=torch.int32, device=dev)
    dist = torch.empty_like(mask)
    slab, slab_q = _slab(T, dev)
    lib = _build.load_library()
    code = lib.sparse_verify_arena_launch(
        paths_vert.data_ptr(), q_vert.data_ptr(), base_plane.data_ptr(),
        base_idx.data_ptr(), live.data_ptr(), mask.data_ptr(),
        dist.data_ptr(), slab.data_ptr(), n, m, T, b, W, int(tau), slab_q,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, name)
    _count(name, m * n > 0)
    return mask, dist


def sparse_verify_arena_packed(db_words: torch.Tensor, q_words: torch.Tensor,
                               base_plane: torch.Tensor,
                               base_idx: torch.Tensor, live: torch.Tensor,
                               *, b: int, S: int, tau: int,
                               block_m: int = DEFAULT_BLOCK_M,
                               block_n: int = DEFAULT_BLOCK_N,
                               use_kernel: bool | None = None):
    """Arena verify over single-word packed suffix columns (b·S <= 32).

    db_words:   (n,) int32 — one packed suffix word per column (the b
                bit planes of the S symbols below the segment's ℓ_s);
    q_words:    (m,) int32 query suffixes in the same packing;
    base_plane: (m, T) per-(segment, root) *prefix* distances (BIG =
                pruned), so that prefix + suffix is the full-length
                Hamming distance;
    base_idx:   (n,) int32 segment-offset lane, in [0, T);
    live:       (n,) bool;
    returns ((m, n) int32 masks, (m, n) int32 totals, BIG-clamped).

    The kernel walks the queries in order, Q at a time (16, 8 or 4, by
    T) through a (T,) slab of their codes, so that what it gathers from
    stays in L2; its tiles are its own, and ``block_m``/``block_n`` are
    accepted for the common signature of the verifies only."""
    if not (S >= 0 and b * S <= 32):
        raise ValueError(f"sparse_verify_arena_packed: b*S = {b * S} "
                         "does not fit one 32-bit word")
    if not _on_kernel(db_words, use_kernel):
        _count("sparse_verify_arena_packed", False)
        mask, dist = ref.sparse_verify_arena_packed_ref(
            db_words, q_words, base_plane, base_idx, live, b, S, tau)
        return mask.to(torch.int32), dist
    from . import _build
    name = "sparse_verify_arena_packed"
    for what, x in (("columns", db_words), ("queries", q_words)):
        if (x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous()
                or x.device != db_words.device):
            raise ValueError(f"{name}: {what} must be a contiguous 1-D "
                             f"int32 bit-view on {db_words.device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    n, m = db_words.shape[0], q_words.shape[0]
    _check_lanes(name, n, base_plane, m, base_idx, live, db_words.device)
    T = base_plane.shape[1]
    dev = db_words.device
    mask = torch.empty((m, n), dtype=torch.int32, device=dev)
    dist = torch.empty_like(mask)
    slab, slab_q = _slab(T, dev)
    lib = _build.load_library()
    code = lib.sparse_verify_arena_packed_launch(
        db_words.data_ptr(), q_words.data_ptr(), base_plane.data_ptr(),
        base_idx.data_ptr(), live.data_ptr(), mask.data_ptr(),
        dist.data_ptr(), slab.data_ptr(), n, m, T, b, S, int(tau), slab_q,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, name)
    _count(name, m * n > 0)
    return mask, dist


def exact_rerank(pay_vert: torch.Tensor, q_vert: torch.Tensor,
                 surv: torch.Tensor, *, metric: str,
                 block_m: int = DEFAULT_BLOCK_M,
                 block_n: int = DEFAULT_BLOCK_N,
                 use_kernel: bool | None = None) -> torch.Tensor:
    """Exact re-rank pass over the survivor plane.

    pay_vert: (Wp, n) int32 bit-views of the column-major payload
              bitmaps; q_vert: (Wp, m) query bitmaps; surv: (m, n)
              survivor mask (nonzero = the lane survived the trie sweep
              at the final τ rung; int32 on the card);
    returns (m, n) float32 exact Jaccard / cosine / containment scores,
    -1.0 on non-survivor lanes.

    The kernel scores a strip of columns for every query and loads a
    column's payload only where one of its lanes survives; its tiles
    are its own, and ``block_m``/``block_n`` are accepted for the
    common signature only."""
    if metric not in RERANK_METRICS:
        raise ValueError(f"unknown rerank metric {metric!r}")
    if not _on_kernel(pay_vert, use_kernel):
        _count("exact_rerank", False)
        return ref.exact_rerank_ref(pay_vert, q_vert, surv, metric)
    from . import _build
    name = "exact_rerank"
    for what, x in (("payloads", pay_vert), ("queries", q_vert)):
        if (x.dtype != torch.int32 or x.dim() != 2 or not x.is_contiguous()
                or x.device != pay_vert.device):
            raise ValueError(f"{name}: {what} must be a contiguous (Wp, ·) "
                             f"int32 bit-view on {pay_vert.device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    Wp, n = pay_vert.shape
    m = q_vert.shape[-1]
    if q_vert.shape[0] != Wp:
        raise ValueError(f"{name}: query words {q_vert.shape[0]} != "
                         f"payload words {Wp}")
    if (surv.dtype != torch.int32 or surv.shape != (m, n)
            or not surv.is_contiguous() or surv.device != pay_vert.device):
        raise ValueError(f"{name}: surv must be a contiguous ({m}, {n}) "
                         f"int32 tensor on {pay_vert.device}, got "
                         f"{surv.dtype} {tuple(surv.shape)} on {surv.device}")
    out = torch.empty((m, n), dtype=torch.float32, device=pay_vert.device)
    lib = _build.load_library()
    code = lib.exact_rerank_launch(
        pay_vert.data_ptr(), q_vert.data_ptr(), surv.data_ptr(),
        out.data_ptr(), n, m, Wp, RERANK_METRICS.index(metric),
        torch.cuda.current_stream(pay_vert.device).cuda_stream)
    _build.check(lib, code, name)
    _count(name, m * n > 0)
    return out


# the kernels' head dims: SMOKE configs 16, smollm-135m 64, hubert-xlarge
# 80, the larger models 128 (the plain version takes any D)
FLASH_HEAD_DIMS = (16, 64, 80, 128)
_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FLASH_ROUTES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check_flash(name: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, window: int, cap: float) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k, v must be (B, H, S, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, _, D = q.shape
    if (k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[3] != D):
        raise ValueError(f"{name}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be (B={B}, H={H}, Skv, "
                         f"D={D})")
    if q.dtype not in _FLASH_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k, v must all be float32 or bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: q on {q.device}, k on {k.device}, v on "
                         f"{v.device}")
    if window < 0 or cap < 0:
        raise ValueError(f"{name}: window {window} and cap {cap} must be >= 0")


def _tma_ok(x: torch.Tensor) -> bool:
    """A bf16 operand the wgmma kernels can read through a TMA tensor map
    (and the backward with 16-byte loads): a 16-byte aligned base pointer
    and positive (b, h, s) strides of whole 8-element chunks wherever the
    dimension has more than one index (a size-1 dimension is never
    stepped: its stride does not matter)."""
    return x.data_ptr() % 16 == 0 and all(
        n == 1 or (st > 0 and st % 8 == 0)
        for n, st in zip(x.shape[:3], x.stride()[:3]))


def _tma_operands(xs):
    """The bf16 backward's operands as its tensor maps read them: each that
    fails ``_tma_ok`` replaced by a contiguous copy (never sent to a plain
    path)."""
    return [x if _tma_ok(x) else x.clone(memory_format=torch.contiguous_format)
            for x in xs]


def _kernel_operands(name: str, xs):
    """The kernels' operands, D the unit stride (else a contiguous copy);
    raises for a head dim no kernel takes."""
    xs = [x if x.stride(-1) == 1 else x.contiguous() for x in xs]
    D = xs[0].shape[-1]
    if D not in FLASH_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not in {FLASH_HEAD_DIMS}")
    return xs


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        cap: float = 0.0, scale: float | None = None,
                        q_offset: int = 0, return_lse: bool = False,
                        tile_bf16: bool = False,
                        use_kernel: bool | None = None):
    """Fused attention forward, (B, H, S, D) layout.

    q: (B, H, Sq, D); k, v: (B, H, Skv, D), the same H (the caller
    repeats kv heads for GQA), float32 or bfloat16 alike; ``scale=None``
    is 1/√D; ``q_offset`` is the absolute position of q's first row.
    Returns (B, H, Sq, D) in q's dtype, and with ``return_lse`` also the
    (B, H, Sq) float32 log-sum-exp of each row's scores (-inf where no
    key is visible), the FA-2 backward's residual.  Any Sq and Skv: the
    kernel masks the ragged kv edge itself.  The plain version takes any
    D; the kernels take D in ``FLASH_HEAD_DIMS`` and any other D raises
    on the card.  Strided views are read and written in place as long as
    D is the unit stride: the output is allocated (B, Sq, H, D) and
    returned as its (B, H, Sq, D) view, so the caller's transpose back is
    free.  ``tile_bf16`` rounds P and V to bfloat16 for P·V (the JAX
    package's ``set_tile_dtype(bfloat16)``).

    On the card, bfloat16 runs the warp-specialised wgmma kernel fed by
    TMA at every head dim (P always rounded to bf16 for P·V; q, k and v
    need 16-byte aligned base pointers and (b, h, s) strides of whole
    8-element chunks, which ``_tma_ok`` checks: any other raises; a
    launch the card refuses raises) and float32 the scalar kernel, exact
    to 2e-5."""
    if _COUNTER is not None:
        return _count_call(flash_attention_fwd, _flash_fwd_cost, q, k, v,
                           causal=causal, window=window, cap=cap,
                           scale=scale, q_offset=q_offset,
                           return_lse=return_lse, tile_bf16=tile_bf16,
                           use_kernel=use_kernel)
    name = "flash_attention_fwd"
    _check_flash(name, q, k, v, window, cap)
    B, H, Sq, D = q.shape
    if scale is None:
        scale = 1.0 / float(D) ** 0.5
    if not _on_kernel(q, use_kernel):
        _count(name, False)
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       cap=cap, scale=scale,
                                       q_offset=q_offset,
                                       return_lse=return_lse,
                                       tile_bf16=tile_bf16)
    q, k, v = _kernel_operands(name, (q, k, v))
    if q.dtype == torch.bfloat16:      # the wgmma kernel's tensor maps
        for what, x in (("q", q), ("k", k), ("v", v)):
            if not _tma_ok(x):
                raise ValueError(
                    f"{name}: bfloat16 {what} needs a 16-byte aligned base "
                    f"pointer and (b, h, s) strides (multiples of 8 "
                    f"elements), got strides {tuple(x.stride())}")
    from . import _build
    out = torch.empty((B, Sq, H, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    strides = [st for x in (q, k, v, out) for st in x.stride()[:3]]
    lib = _build.load_library()
    code = lib.flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Sq,
        k.shape[2], D, *strides, int(bool(causal)), int(window), float(cap),
        float(scale), int(q_offset), lse.data_ptr() if return_lse else None,
        int(bool(tile_bf16)), _FLASH_DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, name)
    _count(name, B * H * Sq > 0, _FLASH_ROUTES[q.dtype],
           *(("lse",) if return_lse else ()))
    return (out, lse) if return_lse else out


def flash_bwd_args(q, k, v, out, lse, dout, *, causal: bool, window: int,
                   cap: float, scale: float, q_offset: int, tile_bf16: bool):
    """Allocate the backward kernel's outputs and scratch and return them
    with the launcher's argument list (everything but ``passes`` and the
    stream): dq in a (B, Sq, H, D) and dk, dv in (B, Skv, H, D)
    allocations, returned as (B, H, S, D) views as the forward's output
    is; delta a (B, H, Sq) float32 scratch."""
    B, H, Sq, D = q.shape
    Skv = k.shape[2]

    def grad_like(S):
        return torch.empty((B, S, H, D), dtype=q.dtype,
                           device=q.device).transpose(1, 2)

    dq, dk, dv = grad_like(Sq), grad_like(Skv), grad_like(Skv)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = [st for x in (q, k, v, out, dout, dq, dk, dv)
               for st in x.stride()[:3]]
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, H, Sq, Skv, D, *strides,
            int(bool(causal)), int(window), float(cap), float(scale),
            int(q_offset), int(bool(tile_bf16)), _FLASH_DTYPES[q.dtype])
    return (dq, dk, dv, delta), args


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0, cap: float = 0.0,
                        scale: float | None = None, q_offset: int = 0,
                        tile_bf16: bool = False,
                        use_kernel: bool | None = None):
    """The FA-2 backward of ``flash_attention_fwd``, (B, H, S, D) layout.

    q, k, v, ``causal``, ``window``, ``cap``, ``scale`` and ``q_offset``
    as given to the forward; ``out`` and ``lse`` its outputs (the lse
    float32 (B, H, Sq), from ``return_lse=True``); ``dout`` the output's
    cotangent, shaped and typed as ``out``.  Returns (dq, dk, dv) in the
    inputs' dtype, as (B, H, S, D) views of (B, S, H, D) allocations.
    ``tile_bf16`` rounds P, dS and the operands they multiply to
    bfloat16, as the forward's flag.

    On the card, two launches of ``csrc/flash_attn_bwd.cu``: the dq pass
    (which also writes delta = rowsum(dout·out)) and the dk/dv pass,
    float32 sums, no atomics (the same bits every run).  bfloat16 runs
    the warp-specialised wgmma kernels at every head dim (P and dS
    rounded to bf16 for their products, as ``tile_bf16`` does), which
    read q, k, v and dout through TMA tensor maps: 64-column blocks under
    the 128-byte swizzle and, at D 80 and 16, a 16-column tail under the
    32-byte swizzle; q, k, v, out and dout are copied first where their
    base or strides fail ``_tma_ok``, and a launch the card refuses
    raises.  float32 runs the scalar kernels.  One count per call.  On
    the CPU the plain ``ref.flash_attention_bwd_ref``."""
    if _COUNTER is not None:
        return _count_call(flash_attention_bwd, _flash_bwd_cost, q, k, v,
                           out, lse, dout, causal=causal, window=window,
                           cap=cap, scale=scale, q_offset=q_offset,
                           tile_bf16=tile_bf16, use_kernel=use_kernel)
    name = "flash_attention_bwd"
    _check_flash(name, q, k, v, window, cap)
    B, H, Sq, D = q.shape
    for what, x in (("out", out), ("dout", dout)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name}: {what} must be {tuple(q.shape)} "
                             f"{q.dtype} on {q.device}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if (lse.shape != (B, H, Sq) or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError(f"{name}: lse must be ({B}, {H}, {Sq}) float32 on "
                         f"{q.device}, got {tuple(lse.shape)} {lse.dtype} "
                         f"on {lse.device}")
    if scale is None:
        scale = 1.0 / float(D) ** 0.5
    if not _on_kernel(q, use_kernel):
        _count(name, False)
        return ref.flash_attention_bwd_ref(
            q, k, v, out, lse, dout, causal=causal, window=window, cap=cap,
            scale=scale, q_offset=q_offset, tile_bf16=tile_bf16)
    q, k, v, out, dout = _kernel_operands(name, (q, k, v, out, dout))
    if q.dtype == torch.bfloat16:      # TMA tensor maps and 16-byte loads
        q, k, v, out, dout = _tma_operands((q, k, v, out, dout))
    lse = lse.contiguous()
    from . import _build
    (dq, dk, dv, _), args = flash_bwd_args(
        q, k, v, out, lse, dout, causal=causal, window=window, cap=cap,
        scale=scale, q_offset=q_offset, tile_bf16=tile_bf16)
    lib = _build.load_library()
    code = lib.flash_attention_bwd_launch(
        *args, 3, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, name)
    _count(name, B * H * Sq > 0, _FLASH_ROUTES[q.dtype])
    return dq, dk, dv
