"""Fault injection for the durability layer — a copy of
``repro.store.faults``.

The store kills a process at planned *I/O boundaries*: every
fsync/rename in the snapshot, WAL-append, flush, merge, and compact
paths calls ``faults.hit(label)``,
and a :class:`FaultInjector` armed with ``crash_at=i`` raises
:class:`CrashPoint` at the *i*-th boundary it sees.  A process that dies
there has exactly the on-disk state a real crash at that instant would
leave (the WAL buffers unsynced records in memory, so they are genuinely
lost).  The recovery property test first runs in *counting* mode
(``crash_at=None``) to enumerate the boundaries, then replays the same
workload once per boundary — robustness by enumeration.
"""

from __future__ import annotations

from typing import List, Optional


class CrashPoint(RuntimeError):
    """Raised by :class:`FaultInjector` to simulate dying at an I/O
    boundary.  Carries the boundary's label and ordinal."""

    def __init__(self, label: str, ordinal: int):
        super().__init__(f"simulated crash at point {ordinal} ({label})")
        self.label = label
        self.ordinal = ordinal


class FaultInjector:
    """Counts labelled crash points; optionally kills at one of them.

    >>> fi = FaultInjector()                 # counting mode
    >>> fi.hit("wal:pre-fsync"); fi.hit("manifest:pre-rename")
    >>> fi.points
    ['wal:pre-fsync', 'manifest:pre-rename']
    >>> fi = FaultInjector(crash_at=1)
    >>> fi.hit("wal:pre-fsync")              # point 0: survives
    >>> fi.hit("manifest:pre-rename")        # point 1: dies
    Traceback (most recent call last):
        ...
    repro_torch.store.faults.CrashPoint: simulated crash at point 1 \
(manifest:pre-rename)
    """

    def __init__(self, crash_at: Optional[int] = None):
        self.crash_at = crash_at
        self.points: List[str] = []

    @property
    def count(self) -> int:
        return len(self.points)

    def hit(self, label: str) -> None:
        ordinal = len(self.points)
        self.points.append(label)
        if self.crash_at is not None and ordinal == self.crash_at:
            raise CrashPoint(label, ordinal)
