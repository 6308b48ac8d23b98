"""Fault-tolerance policies: resume-or-init, straggler detection and
planned failures — the port of the JAX package's
``distributed/fault_tolerance.py``.

* **Checkpoint/restart** — ``resume_or_init`` restores the latest
  complete checkpoint (atomic directories mean a crash mid-write can
  never be picked up) or initializes fresh.  A restore may target
  another device than the one that saved (checkpoints are logical host
  arrays).
* **Elastic re-shard** — checkpoints are logical (whole arrays), so a
  restore may target a *different* mesh: ``resume_or_init(mesh=)``
  restores them whole and cuts each rank's shards by the new mesh's
  training placement (``distributed.sharding.shard_state``).  A run
  saved on four ranks resumes on two, or on one process with no mesh.
* **Straggler mitigation** — the data pipeline is a pure function of
  (config, step), so a replacement worker regenerates any step's batch;
  ``StragglerMonitor`` is the detection policy (EWMA step time, flag at
  ``factor``x).
* **Preemption drills** — ``SimulatedFailure`` raises at a planned step;
  ``launch/train.py --fail-at`` uses it to prove the restart path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

from . import checkpoint as ckpt
from ..store.faults import CrashPoint
from .sharding import shard_state

Tree = Any


def resume_or_init(ckpt_dir: str, abstract_tree: Tree,
                   init_fn: Callable[[], Tree],
                   device="cuda", mesh=None) -> Tuple[Tree, int]:
    """Restore the latest checkpoint onto ``device``, or init.  Returns
    (tree, start_step).  Under ``mesh`` the restored tree is this rank's
    shards of it (every ``Params`` cut by the mesh's training placement;
    ``init_fn`` returns shards itself), and only rank 0 sweeps."""
    if ckpt.is_writer(mesh):
        ckpt.sweep_stale(ckpt_dir)  # GC a crashed writer's tmp/old dirs
    step = ckpt.latest_checkpoint(ckpt_dir)
    if step is None:
        return init_fn(), 0
    tree = ckpt.restore_checkpoint(ckpt_dir, step, abstract_tree,
                                   device=device)
    return (tree if mesh is None else shard_state(tree, mesh)), step


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time tracker; ``check`` returns the list of flagged
    worker ids."""

    n_workers: int
    alpha: float = 0.2
    factor: float = 2.0
    warmup: int = 3
    _ewma: Optional[List[float]] = None
    _count: int = 0

    def observe(self, worker_times: List[float]) -> None:
        assert len(worker_times) == self.n_workers
        if self._ewma is None:
            self._ewma = list(worker_times)
        else:
            self._ewma = [self.alpha * t + (1 - self.alpha) * e
                          for t, e in zip(worker_times, self._ewma)]
        self._count += 1

    def check(self) -> List[int]:
        if self._ewma is None or self._count < self.warmup:
            return []
        med = sorted(self._ewma)[self.n_workers // 2]
        return [i for i, e in enumerate(self._ewma) if e > self.factor * med]


class SimulatedFailure(CrashPoint):
    """Planned-step failure (restart drills).  Subclasses the store's
    :class:`repro_torch.store.faults.CrashPoint` so one except clause
    covers both planned-step and planned-I/O-boundary kills."""

    def __init__(self, message: str):
        RuntimeError.__init__(self, message)


@dataclasses.dataclass
class FailurePlan:
    """Deterministic failure injection for restart drills."""
    fail_at_step: int
    fired: bool = False

    def maybe_fail(self, step: int) -> None:
        if not self.fired and step == self.fail_at_step:
            self.fired = True
            raise SimulatedFailure(f"injected node failure at step {step}")
