"""Structured slow-query log (DESIGN.md §11).

Any request slower than the scheduler's ``slow_ms`` threshold dumps its
completed span tree here: a bounded in-memory ring (inspection from
tests / a REPL) plus an optional JSONL file (one self-contained record
per line — the on-disk artifact ``tools/trace_report.py`` reads next to
the Chrome trace).
"""

from __future__ import annotations

import collections
import json
import threading
import time
from typing import Dict, List, Optional

from .trace import Span, span_to_dict

__all__ = ["SlowQueryLog"]


class SlowQueryLog:
    """Ring of slow-request records; thread-safe (the scheduler records
    from worker threads)."""

    def __init__(self, capacity: int = 256, path: Optional[str] = None):
        self.capacity = int(capacity)
        self.path = path
        self._lock = threading.Lock()
        self._entries = collections.deque(maxlen=self.capacity)
        self.dropped = 0          # records pushed out of the ring

    def record(self, root: Span, **meta) -> Dict[str, object]:
        """Log one finished request: the span tree (inlined, children
        and all) plus caller metadata (op, collection, threshold)."""
        entry: Dict[str, object] = {
            "time_unix": time.time(),
            "e2e_ms": round(root.dur * 1e3, 3),
            **meta,
            "spans": span_to_dict(root),
        }
        with self._lock:
            if len(self._entries) == self.capacity:
                self.dropped += 1
            self._entries.append(entry)
        if self.path is not None:
            line = json.dumps(entry)
            with self._lock:
                with open(self.path, "a") as f:
                    f.write(line + "\n")
        return entry

    def entries(self) -> List[Dict[str, object]]:
        with self._lock:
            return list(self._entries)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
