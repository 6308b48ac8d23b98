"""Wrappers around the hand-written CUDA kernels (``csrc/hamming.cu``).

Each wrapper takes tensors in the kernel layout — (b, W, n) int32
bit-views of the uint32 bit-plane words, database axis last — and
dispatches on where they lie:

  * a CUDA tensor launches the kernel, at every n (``use_kernel=False``
    is the one explicit request for the plain version there);
  * a CPU tensor runs the plain version in ``ref.py``.

``block_m`` is the query tile (queries played against each database word
a thread loads; rounded up to a power of two, at most 32) and
``block_n`` the database columns of one CUDA block (a multiple of 32,
at most 1024): the same two tile axes as the TPU kernels' grid.  The
kernels mask the ragged edges themselves, so nothing is padded here.
"""

from __future__ import annotations

import threading

import torch

from . import ref
from .ref import BIG

DEFAULT_BLOCK_M = 8
DEFAULT_BLOCK_N = 256
_MAX_TILE_M = 32

# Process-wide launch ledger keyed by wrapper name: ``<name>`` counts
# kernel launches (bumped after the launch succeeded, and only there),
# ``<name>:ref`` calls that ran the plain version instead.
_KSTATS_LOCK = threading.Lock()
_KERNEL_STATS: dict = {}


def _count(name: str, launched: bool) -> None:
    key = name if launched else name + ":ref"
    with _KSTATS_LOCK:
        _KERNEL_STATS[key] = _KERNEL_STATS.get(key, 0) + 1


def kernel_stats() -> dict:
    """Per-wrapper call counts (``<name>`` kernel launched, ``<name>:ref``
    plain version ran)."""
    with _KSTATS_LOCK:
        return dict(_KERNEL_STATS)


def reset_kernel_stats() -> None:
    with _KSTATS_LOCK:
        _KERNEL_STATS.clear()


def to_lane_major(planes: torch.Tensor) -> torch.Tensor:
    """(n, b, W) sketch-major -> (b, W, n) lane-major (kernel layout)."""
    return planes.permute(1, 2, 0).contiguous()


def _on_kernel(x: torch.Tensor, use_kernel: bool | None) -> bool:
    return x.is_cuda and use_kernel is not False


def _tile_m(block_m: int, m: int) -> int:
    t = max(1, min(block_m, m, _MAX_TILE_M))
    return 1 << (t - 1).bit_length()


def _check(name: str, db: torch.Tensor, q: torch.Tensor,
           base: torch.Tensor | None) -> None:
    for what, x in (("database", db), ("queries", q)):
        if x.dtype != torch.int32 or x.dim() != 3 or not x.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous (b, W, ·) "
                             f"int32 bit-view, got {x.dtype} {tuple(x.shape)}")
        if x.device != db.device:
            raise ValueError(f"{name}: {what} on {x.device}, "
                             f"database on {db.device}")
    if q.shape[:2] != db.shape[:2]:
        raise ValueError(f"{name}: query planes {tuple(q.shape[:2])} != "
                         f"database planes {tuple(db.shape[:2])}")
    if base is not None and (base.dtype != torch.int32
                             or base.shape != (q.shape[-1], db.shape[-1])
                             or not base.is_contiguous()
                             or base.device != db.device):
        raise ValueError(f"{name}: base must be a contiguous (m, n) int32 "
                         f"tensor on {db.device}, got {base.dtype} "
                         f"{tuple(base.shape)} on {base.device}")


def _launch_verify(name, paths_vert, q_vert, base, tau, block_m, block_n):
    from . import _build
    _check(name, paths_vert, q_vert, base)
    b, W, n = paths_vert.shape
    m = q_vert.shape[-1]
    mask = torch.empty((m, n), dtype=torch.int32, device=paths_vert.device)
    dist = torch.empty_like(mask)
    lib = _build.load_library()
    code = lib.sparse_verify_batch_launch(
        paths_vert.data_ptr(), q_vert.data_ptr(), base.data_ptr(),
        mask.data_ptr(), dist.data_ptr(), n, m, b, W, int(tau),
        _tile_m(block_m, m), block_n,
        torch.cuda.current_stream(paths_vert.device).cuda_stream)
    _build.check(lib, code, name)
    _count(name, m * n > 0)
    return mask, dist


def hamming_distances(db_vert: torch.Tensor, q_vert: torch.Tensor,
                      *, block_m: int = DEFAULT_BLOCK_M,
                      block_n: int = DEFAULT_BLOCK_N,
                      use_kernel: bool | None = None) -> torch.Tensor:
    """(b, W, n) x (b, W, m) -> (m, n) int32 Hamming distances."""
    if not _on_kernel(db_vert, use_kernel):
        _count("hamming_distances", False)
        return ref.hamming_distances_ref(db_vert, q_vert)
    from . import _build
    _check("hamming_distances", db_vert, q_vert, None)
    b, W, n = db_vert.shape
    m = q_vert.shape[-1]
    out = torch.empty((m, n), dtype=torch.int32, device=db_vert.device)
    lib = _build.load_library()
    code = lib.hamming_distances_launch(
        db_vert.data_ptr(), q_vert.data_ptr(), out.data_ptr(), n, m, b, W,
        _tile_m(block_m, m), block_n,
        torch.cuda.current_stream(db_vert.device).cuda_stream)
    _build.check(lib, code, "hamming_distances")
    _count("hamming_distances", m * n > 0)
    return out


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
    base_dist = base_dist.to(torch.int32)
    if live is not None:
        base_dist = torch.where(live, base_dist, BIG)
    if not _on_kernel(paths_vert, use_kernel):
        _count("sparse_verify", False)
        mask, dist = ref.sparse_verify_ref(paths_vert, q_vert, base_dist, tau)
        return mask.to(torch.int32), dist
    mask, dist = _launch_verify("sparse_verify", paths_vert,
                                q_vert[..., None].contiguous(),
                                base_dist[None, :].contiguous(), tau, 1,
                                block_n)
    return mask[0], dist[0]


def sparse_verify_batch(paths_vert: torch.Tensor, q_vert: torch.Tensor,
                        base_dist: torch.Tensor, *, tau: int,
                        live: torch.Tensor | None = None,
                        block_m: int = DEFAULT_BLOCK_M,
                        block_n: int = DEFAULT_BLOCK_N,
                        use_kernel: bool | None = None):
    """Fused query-tiled verify over a whole batch.

    paths_vert: (b, W, n) collapsed suffix paths (shared database);
    q_vert:     (b, W, m) query suffixes;
    base_dist:  (m, n) per-query prefix distances (BIG = pruned subtrie);
    live:       optional (n,) bool tombstone mask shared by every query —
                dead lanes get a BIG base distance;
    returns ((m, n) int32 masks, (m, n) int32 exact totals, BIG-clamped).
    """
    base_dist = base_dist.to(torch.int32)
    if live is not None:
        base_dist = torch.where(live[None, :], base_dist, BIG)
    if not _on_kernel(paths_vert, use_kernel):
        _count("sparse_verify_batch", False)
        mask, dist = ref.sparse_verify_batch_ref(paths_vert, q_vert,
                                                 base_dist, tau)
        return mask.to(torch.int32), dist
    return _launch_verify("sparse_verify_batch", paths_vert, q_vert,
                          base_dist.contiguous(), tau, block_m, block_n)
