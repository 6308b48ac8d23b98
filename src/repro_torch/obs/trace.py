"""Per-request span tracing (DESIGN.md §11).

A ``Span`` is one timed interval with nested children; a ``Tracer``
holds completed *root* spans in a bounded ring buffer (old requests
fall off — a long-lived server's trace memory is O(capacity), never
O(requests served)).

The instrumentation contract is built for the scheduler's threading
model:

  * the scheduler opens one root span per request at submit time and
    one shared *batch* span when a coalesced group executes — every
    request root of the group links the same batch node (the work was
    genuinely shared; the export de-duplicates it);
  * the executing thread *attaches* the batch span to a thread-local
    slot (``attach``), and every instrumentation point deeper in the
    stack (``core.segments``' rung dispatches, ``core.column_store``'s
    tier staging, the re-rank pass) calls the module-level ``span()``
    helper, which nests under whatever is attached — no signature
    threading through the query path;
  * with nothing attached, ``span()`` returns a shared no-op context
    manager after ONE thread-local read — the disabled cost is a dict
    build and a ``getattr``, and no device work ever happens either way
    (spans are host-side wall-clock timers only; the zero-dispatch
    invariant is spy-tested in ``tests/test_obs.py`` and
    ``tests/test_torch_obs.py``).  A span never synchronises the card:
    around an asynchronous CUDA launch it measures the dispatch, and the
    device time surfaces in the span that holds the host's next read.

Export is Chrome trace-event JSON (``chrome_trace`` /
``Tracer.write_chrome``): "X" complete events in microseconds, one
``tid`` per track, loadable in Perfetto / chrome://tracing.
``tools/trace_report.py`` validates and summarizes these files.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional

__all__ = ["Span", "Tracer", "attach", "chrome_trace", "current", "span",
           "span_to_dict", "write_chrome"]

_TLS = threading.local()


class Span:
    """One timed interval: ``ts``/``dur`` are ``time.perf_counter``
    seconds, ``args`` free-form labels, ``children`` nested spans.
    ``track`` names the export lane ("worker-..." for executor threads);
    None inherits the parent's lane (roots get a fresh request lane)."""

    __slots__ = ("name", "cat", "ts", "dur", "args", "children", "track")

    def __init__(self, name: str, cat: str = "span",
                 ts: Optional[float] = None, dur: float = 0.0,
                 track: Optional[str] = None,
                 args: Optional[dict] = None):
        self.name = name
        self.cat = cat
        self.ts = time.perf_counter() if ts is None else ts
        self.dur = dur
        self.track = track
        self.args = {} if args is None else args
        self.children: List["Span"] = []

    def child(self, name: str, cat: str = "span", **args) -> "Span":
        sp = Span(name, cat=cat, args=args)
        self.children.append(sp)
        return sp

    def find(self, name: str) -> Optional["Span"]:
        """First descendant (pre-order) with this name, else None."""
        for ch in self.children:
            if ch.name == name:
                return ch
            hit = ch.find(name)
            if hit is not None:
                return hit
        return None

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, dur={self.dur * 1e3:.3f}ms, "
                f"children={len(self.children)})")


def span_to_dict(sp: Span) -> dict:
    """Recursive JSON-ready form (the slow-query log's record body).
    Times are milliseconds relative to the process clock."""
    return {"name": sp.name, "cat": sp.cat,
            "ts_ms": round(sp.ts * 1e3, 3),
            "dur_ms": round(sp.dur * 1e3, 3),
            "args": dict(sp.args),
            "children": [span_to_dict(c) for c in sp.children]}


# -- thread-local context ------------------------------------------------

def current() -> Optional[Span]:
    """The span new ``span()`` calls nest under on this thread."""
    return getattr(_TLS, "cur", None)


class _NullCtx:
    """Shared do-nothing context manager — the disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullCtx()


class _SpanCtx:
    __slots__ = ("parent", "sp")

    def __init__(self, parent: Span, name: str, cat: str, args: dict):
        self.parent = parent
        self.sp = Span(name, cat=cat, args=args)

    def __enter__(self) -> Span:
        self.parent.children.append(self.sp)
        _TLS.cur = self.sp
        return self.sp

    def __exit__(self, *exc):
        self.sp.dur = time.perf_counter() - self.sp.ts
        _TLS.cur = self.parent
        return False


def span(name: str, cat: str = "span", **args):
    """Open a child span under the thread's attached context.  With no
    context attached this is a shared no-op — instrumentation points in
    the query path call it unconditionally."""
    parent = getattr(_TLS, "cur", None)
    if parent is None:
        return _NULL
    return _SpanCtx(parent, name, cat, args)


class _AttachCtx:
    __slots__ = ("root", "prev")

    def __init__(self, root: Optional[Span]):
        self.root = root
        self.prev = None

    def __enter__(self):
        self.prev = getattr(_TLS, "cur", None)
        _TLS.cur = self.root
        return self.root

    def __exit__(self, *exc):
        _TLS.cur = self.prev
        return False


def attach(root: Optional[Span]) -> _AttachCtx:
    """Make ``root`` the thread's current span for the duration (the
    scheduler attaches the batch span around execution; ``None``
    detaches — a no-op region)."""
    return _AttachCtx(root)


# -- ring buffer ---------------------------------------------------------

class Tracer:
    """Bounded ring of completed request trees.  ``add()`` is called by
    the scheduler once per finished request with its root span; when
    more than ``capacity`` roots accumulate the oldest fall off."""

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._roots: List[Span] = []

    def add(self, root: Span) -> None:
        with self._lock:
            self._roots.append(root)
            if len(self._roots) > self.capacity:
                del self._roots[: len(self._roots) - self.capacity]

    def roots(self) -> List[Span]:
        with self._lock:
            return list(self._roots)

    def clear(self) -> None:
        with self._lock:
            self._roots.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._roots)

    def chrome_events(self) -> List[dict]:
        return chrome_trace(self.roots())

    def write_chrome(self, path: str) -> str:
        """Dump the ring as one Chrome trace-event JSON file (a plain
        event array — Perfetto and chrome://tracing load it directly)."""
        return write_chrome(self.roots(), path)


# -- Chrome trace-event export -------------------------------------------

def chrome_trace(roots: List[Span]) -> List[dict]:
    """Flatten span trees into Chrome trace events ("X" complete events,
    microsecond ts/dur).  Tracks map to tids; spans without a track
    inherit the enclosing lane, and each root without one gets a fresh
    request lane (overlapping requests must not share a tid — a tid is a
    stack in the trace model).  Shared nodes (one batch span linked from
    several request roots) emit once, on their own track."""
    events: List[dict] = []
    tids: Dict[str, int] = {}
    seen: set = set()

    def tid_of(track: str) -> int:
        tid = tids.get(track)
        if tid is None:
            tid = tids[track] = len(tids) + 1
            events.append({"name": "thread_name", "ph": "M", "pid": 0,
                           "tid": tid, "args": {"name": track}})
        return tid

    def emit(sp: Span, lane: str) -> None:
        if id(sp) in seen:
            return
        seen.add(id(sp))
        lane = sp.track if sp.track is not None else lane
        events.append({
            "name": sp.name, "cat": sp.cat, "ph": "X",
            "ts": round(sp.ts * 1e6, 3),
            "dur": round(sp.dur * 1e6, 3),
            "pid": 0, "tid": tid_of(lane),
            "args": dict(sp.args),
        })
        for ch in sp.children:
            emit(ch, lane)

    for i, root in enumerate(roots):
        emit(root, root.track if root.track is not None else f"request-{i}")
    return events


def write_chrome(roots: List[Span], path: str) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(roots), f)
    return path
