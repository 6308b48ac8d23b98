"""Data pipeline with bST near-duplicate filtering — the port of the JAX
package's ``data/pipeline.py``, the paper's flagship application
(web-scale near-dup detection) wired into training.

Determinism contract: ``batch_for_step(step)`` is a pure function of
(config, step, the history of earlier steps).  Candidate documents and
the embeds branch are drawn by numpy ``default_rng((seed, step))``
exactly as the JAX package draws them, and the sketch parameters can be
handed in, so the two packages give the same batches bit for bit.

Dedup flow per step (when enabled):
  1. generate ``oversample x batch`` candidate documents; a configurable
     fraction are *near-duplicates* (token-perturbed copies);
  2. b-bit-minhash each document (``core.sketch.sketch_tokens``) on the
     pipeline's device;
  3. reject candidates within Hamming ``tau`` of (a) the persistent
     history index — a bST over every sketch accepted so far, rebuilt on
     a doubling schedule and searched on the device by
     ``make_batch_searcher`` (the verify kernel) — or (b) an already
     accepted candidate of this batch (the pairwise distances on the
     device, the greedy pass on the host);
  4. take the first ``batch`` survivors (padding deterministically with
     rejected docs if over-aggressive).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..core.bst import build_bst
from ..core.hamming import hamming_pairwise_naive, resolve_device
from ..core.search import make_batch_searcher
from ..core.sketch import hash_params, sketch_tokens

# elements of the (rows, seq, L) hash intermediate one sketch call holds
_SKETCH_CHUNK = 1 << 26


@dataclasses.dataclass
class DataConfig:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    dedup: bool = False
    oversample: int = 2
    dup_frac: float = 0.25       # injected near-duplicate rate
    dedup_L: int = 16
    dedup_b: int = 2
    dedup_tau: int = 2
    embeds_dim: int = 0          # >0: frontend-stub pipeline (hubert)
    rebuild_factor: float = 2.0  # rebuild history bST when 2x larger


class SketchDedupPipeline:
    """Batches for a training run on ``device`` (default ``cuda``).
    ``sketch_params``: the (L,) hash parameters ``(a, c)``; by default
    ``hash_params(L, torch.Generator().manual_seed(seed ^ 0x5E7C))``.
    ``rebuilds`` and ``rebuild_seconds`` count the history bST's builds
    and their host seconds."""

    def __init__(self, cfg: DataConfig, *, device="cuda",
                 sketch_params=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if sketch_params is None:
            sketch_params = hash_params(
                cfg.dedup_L, torch.Generator().manual_seed(cfg.seed ^ 0x5E7C))
        self._sketch_params = sketch_params
        self._history: Optional[np.ndarray] = None     # accepted sketches
        self._index = None
        self._index_size = 0
        self.stats = {"candidates": 0, "rejected_in_batch": 0,
                      "rejected_history": 0}
        self.rebuilds = 0
        self.rebuild_seconds = 0.0

    # -- candidate generation (pure in (cfg, step)) -----------------------
    def _candidates(self, step: int) -> np.ndarray:
        cfg = self.cfg
        n = cfg.batch * (cfg.oversample if cfg.dedup else 1)
        rng = np.random.default_rng((cfg.seed, step))
        toks = rng.integers(0, cfg.vocab, size=(n, cfg.seq + 1), dtype=np.int64)
        if cfg.dedup and cfg.dup_frac > 0:
            n_dup = int(n * cfg.dup_frac)
            src = rng.integers(0, n - n_dup, size=n_dup)
            for i, s in enumerate(src):
                row = toks[s].copy()
                # perturb ~2% of positions — a near (not exact) duplicate
                flip = rng.random(cfg.seq + 1) < 0.02
                row[flip] = rng.integers(0, cfg.vocab, size=flip.sum())
                toks[n - n_dup + i] = row
            perm = rng.permutation(n)
            toks = toks[perm]
        return toks

    def _sketch(self, toks: np.ndarray) -> torch.Tensor:
        """(n, L) uint8 sketches of the documents ``toks[:, :-1]``, on the
        device, in row chunks that bound the hash intermediate."""
        cfg = self.cfg
        docs = torch.from_numpy(toks[:, :-1].astype(np.int32)).to(self.device)
        rows = max(1, _SKETCH_CHUNK // max(cfg.seq * cfg.dedup_L, 1))
        return torch.cat([sketch_tokens(self._sketch_params, docs[r:r + rows],
                                        L=cfg.dedup_L, b=cfg.dedup_b)
                          for r in range(0, docs.shape[0], rows)])

    # -- dedup -------------------------------------------------------------
    def _dedup_mask(self, sketches: torch.Tensor) -> np.ndarray:
        """Greedy accept mask: True = keep."""
        cfg = self.cfg
        n = sketches.shape[0]
        keep = np.ones(n, bool)

        # (a) vs history bST
        if self._index is not None:
            searcher = make_batch_searcher(self._index, cfg.dedup_tau)
            res = searcher(sketches.to(torch.int32))
            dup_hist = res.mask.any(dim=1).cpu().numpy()
            self.stats["rejected_history"] += int(dup_hist.sum())
            keep &= ~dup_hist

        # (b) in-batch greedy: reject anything within tau of an earlier kept
        close = (hamming_pairwise_naive(sketches, sketches)
                 <= cfg.dedup_tau).cpu().numpy()
        for i in range(n):
            if not keep[i]:
                continue
            later = close[i, i + 1:]
            dropped = later & keep[i + 1:]
            self.stats["rejected_in_batch"] += int(dropped.sum())
            keep[i + 1:] &= ~later
        return keep

    def _update_history(self, accepted: np.ndarray) -> None:
        if self._history is None:
            self._history = accepted.copy()
        else:
            self._history = np.concatenate([self._history, accepted])
        if (self._index is None
                or len(self._history) >= self.cfg.rebuild_factor
                * max(self._index_size, 1)):
            t0 = time.perf_counter()
            self._index = build_bst(self._history, self.cfg.dedup_b,
                                    device=self.device)
            self._index_size = len(self._history)
            self.rebuilds += 1
            self.rebuild_seconds += time.perf_counter() - t0

    # -- public ------------------------------------------------------------
    def batch_for_step(self, step: int) -> Dict[str, torch.Tensor]:
        """{"tokens", "targets"} (B, seq) int32 on the device — or, for a
        frontend-stub config, {"embeds" (B, seq, d) float32, "targets"}."""
        cfg = self.cfg
        dev = self.device
        if cfg.embeds_dim:
            rng = np.random.default_rng((cfg.seed, step))
            embeds = rng.standard_normal(
                (cfg.batch, cfg.seq, cfg.embeds_dim), dtype=np.float32)
            targets = rng.integers(0, cfg.vocab, (cfg.batch, cfg.seq))
            return {"embeds": torch.from_numpy(embeds).to(dev),
                    "targets": torch.from_numpy(
                        targets.astype(np.int32)).to(dev)}
        toks = self._candidates(step)
        if cfg.dedup:
            sk_t = self._sketch(toks)
            sk = sk_t.cpu().numpy()
            self.stats["candidates"] += len(toks)
            keep = self._dedup_mask(sk_t)
            order = np.concatenate([np.flatnonzero(keep),
                                    np.flatnonzero(~keep)])
            chosen = order[:cfg.batch]
            self._update_history(sk[chosen[keep[chosen]]]
                                 if keep[chosen].any() else sk[chosen[:1]])
            toks = toks[chosen]
        else:
            toks = toks[:cfg.batch]
        toks = toks.astype(np.int32)
        return {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
                "targets": torch.from_numpy(toks[:, 1:].copy()).to(dev)}
