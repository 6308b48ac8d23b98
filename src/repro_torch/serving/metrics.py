"""Serving metrics: latency percentiles + histograms, throughput
counters, batching efficiency, and a ``/stats`` text dump in real
Prometheus exposition format (DESIGN.md §5, §11) — the port of
``repro.serving.metrics``: the same families, names and labels.

One ``ServingMetrics`` instance is shared by a scheduler and all its
collections.  Latencies are kept in bounded per-op ring buffers (recent
window, not full history) so a long-lived server's percentile cost stays
O(window), plus fixed-bucket cumulative ``Histogram``s (full history —
what a scraper rates over).  All mutators take an internal lock — the
scheduler records from its worker threads while ``snapshot()`` /
``render_text()`` may be called from any thread.

Cache / dispatch / tier efficiency come from *process-level* counters
(``repro_torch.core.search.searcher_cache_info``,
``repro_torch.core.segments.dispatch_stats``,
``repro_torch.core.column_store.tier_stats``).  Those globals are shared by
every index in the process, so each ``ServingMetrics`` snapshots them at
construction and reports **deltas since its own start** — two schedulers
(or a test running after a warm-up) no longer see each other's traffic.
``rebaseline()`` re-zeros the deltas in place.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.column_store import tier_stats
from ..core.search import searcher_cache_info
from ..core.segments import dispatch_stats
from ..obs.prom import (DEFAULT_LATENCY_BUCKETS_S, Histogram, format_value,
                        render_family)

__all__ = ["LatencyWindow", "ServingMetrics"]


class LatencyWindow:
    """Bounded ring buffer of recent latency samples (seconds)."""

    def __init__(self, window: int = 2048):
        self.samples = collections.deque(maxlen=window)
        self.count = 0          # total ever recorded (not windowed)
        self.total = 0.0        # total seconds ever recorded

    def add(self, seconds: float) -> None:
        self.samples.append(seconds)
        self.count += 1
        self.total += seconds

    def percentile(self, p: float) -> float:
        if not self.samples:
            return 0.0
        return float(np.percentile(np.asarray(self.samples), p))

    def summary(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "mean_ms": (self.total / self.count * 1e3) if self.count else 0.0,
            "p50_ms": self.percentile(50) * 1e3,
            "p99_ms": self.percentile(99) * 1e3,
        }


class ServingMetrics:
    """Counters + latency windows/histograms for one scheduler.

    * ``record_latency(op, s)`` — end-to-end (enqueue -> complete).
    * ``record_exec(op, s)``    — device dispatch only.
    * ``record_queue(op, s)``   — queue wait (enqueue -> batch pop).
    * ``record_batch(op, size, bucket)`` — one coalesced read dispatch;
      feeds batches_total and the batch-fill ratio (Σsize / Σbucket).
    * ``inc(name, n)``          — plain counters (``requests_total:<op>``,
      ``rejected_total`` plus per-op ``rejected_total:<op>``,
      ``shed_total:<reason>``, ``deadline_exceeded_total`` plus per-op,
      ``degraded_total`` plus per-stage ``degraded_total:<stage>``,
      ``write_ops_total``, ``executor_errors_total``, ...).
    * ``set_gauge(name, v)``    — point-in-time gauges (DESIGN.md §12:
      ``serving_stopped_dirty``, ...); rendered as their own gauge
      families in the exposition.
    """

    def __init__(self, window: int = 2048,
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_S):
        self._lock = threading.Lock()
        self._window = window
        self._buckets = tuple(buckets)
        self.latency: Dict[str, LatencyWindow] = {}
        self.exec_latency: Dict[str, LatencyWindow] = {}
        self.queue_latency: Dict[str, LatencyWindow] = {}
        self._hists: Dict[Tuple[str, str], Histogram] = {}
        self.counters: Dict[str, int] = collections.defaultdict(int)
        self.gauges: Dict[str, float] = {}
        self.batch_sizes = 0
        self.batch_buckets = 0
        self.rebaseline()

    def rebaseline(self) -> None:
        """Re-zero the process-global cache/dispatch/tier deltas: every
        later ``snapshot()`` reports activity since this call (called
        once at construction — i.e. scheduler start)."""
        with self._lock:
            self._cache0 = searcher_cache_info()
            self._disp0 = dispatch_stats()
            self._tier0 = tier_stats()

    # -- recording -------------------------------------------------------

    def _win(self, table: Dict[str, LatencyWindow], op: str) -> LatencyWindow:
        win = table.get(op)
        if win is None:
            win = table[op] = LatencyWindow(self._window)
        return win

    def _hist(self, kind: str, op: str) -> Histogram:
        h = self._hists.get((kind, op))
        if h is None:
            h = self._hists[(kind, op)] = Histogram(self._buckets)
        return h

    def record_latency(self, op: str, seconds: float) -> None:
        with self._lock:
            self._win(self.latency, op).add(seconds)
            self._hist("latency", op).observe(seconds)

    def record_exec(self, op: str, seconds: float) -> None:
        with self._lock:
            self._win(self.exec_latency, op).add(seconds)
            self._hist("exec_latency", op).observe(seconds)

    def record_queue(self, op: str, seconds: float) -> None:
        with self._lock:
            self._win(self.queue_latency, op).add(seconds)
            self._hist("queue_latency", op).observe(seconds)

    def record_batch(self, op: str, size: int, bucket: int) -> None:
        with self._lock:
            self.counters[f"batches_total:{op}"] += 1
            self.batch_sizes += int(size)
            self.batch_buckets += int(bucket)

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def set_gauge(self, name: str, value: float) -> None:
        """Set a point-in-time gauge (full metric name, optionally with
        a ``{label="..."}`` suffix) exported by ``render_text``."""
        with self._lock:
            self.gauges[name] = value

    # -- export ----------------------------------------------------------

    def batch_fill_ratio(self) -> float:
        """Real queries / dispatched bucket rows across all read batches
        (1.0 = every dispatch exactly filled its power-of-two bucket)."""
        return self.batch_sizes / self.batch_buckets if self.batch_buckets \
            else 0.0

    def snapshot(self) -> Dict[str, object]:
        """One coherent dict of everything: counters, per-op latency
        summaries (count / mean / p50 / p99 ms), batch fill, and the
        compiled-searcher cache / dispatch / tier counters **as deltas
        since this instance's baseline** (``size`` stays absolute — it
        is an occupancy gauge, not a flow)."""
        with self._lock:
            out: Dict[str, object] = {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "latency": {op: w.summary() for op, w in self.latency.items()},
                "exec_latency": {op: w.summary()
                                 for op, w in self.exec_latency.items()},
                "queue_latency": {op: w.summary()
                                  for op, w in self.queue_latency.items()},
                "batch_fill_ratio": self.batch_fill_ratio(),
            }
            cache0, disp0, tier0 = self._cache0, self._disp0, self._tier0
        cache_now = searcher_cache_info()
        cache = {k: cache_now[k] - cache0.get(k, 0)
                 for k in cache_now if k != "size"}
        cache["size"] = cache_now.get("size", 0)
        lookups = cache["hits"] + cache["misses"]
        cache["hit_rate"] = cache["hits"] / lookups if lookups else 0.0
        out["searcher_cache"] = cache
        out["device_dispatch"] = {k: v - disp0.get(k, 0)
                                  for k, v in dispatch_stats().items()}
        out["tier"] = {k: v - tier0.get(k, 0)
                       for k, v in tier_stats().items()}
        return out

    def render_text(self, extra: Optional[Dict[str, object]] = None) -> str:
        """``/stats`` dump in Prometheus text exposition format: every
        family gets ``# HELP`` / ``# TYPE`` lines and histogram families
        render cumulative ``_bucket``/``_sum``/``_count`` series — the
        output round-trips through ``repro_torch.obs.prom.parse_exposition``
        (and therefore a real scraper).  ``extra`` appends pre-flattened
        gauge lines (queue depths, index occupancy) supplied by the
        scheduler."""
        snap = self.snapshot()
        out: List[str] = []
        typed: set = set()

        def emit(family: str, ftype: str, help_text: str,
                 lines: List[str]) -> None:
            if family not in typed:
                out.extend(render_family(family, ftype, help_text, lines))
                typed.add(family)
            else:
                out.extend(lines)

        fams: Dict[str, List[str]] = {}
        for name, val in sorted(snap["counters"].items()):
            if ":" in name:
                base, op = name.split(":", 1)
                fam = f"serving_{base}"
                line = f'{fam}{{op="{op}"}} {format_value(val)}'
            else:
                fam = f"serving_{name}"
                line = f"{fam} {format_value(val)}"
            fams.setdefault(fam, []).append(line)
        for fam in sorted(fams):
            emit(fam, "counter", "Scheduler request counter.", fams[fam])

        for table, label in ((snap["latency"], "latency"),
                             (snap["exec_latency"], "exec_latency"),
                             (snap["queue_latency"], "queue_latency")):
            for stat in ("p50_ms", "p99_ms", "mean_ms"):
                fam = f"serving_{label}_{stat}"
                lines = [f'{fam}{{op="{op}"}} {format_value(s[stat])}'
                         for op, s in sorted(table.items())]
                if lines:
                    emit(fam, "gauge",
                         f"Windowed {label} {stat} per op.", lines)

        emit("serving_batch_fill_ratio", "gauge",
             "Real queries / dispatched bucket rows.",
             ["serving_batch_fill_ratio "
              + format_value(snap["batch_fill_ratio"])])

        with self._lock:
            hist_items = sorted(self._hists.items())
            for (kind, op), h in hist_items:
                fam = f"serving_{kind}_seconds"
                emit(fam, "histogram",
                     f"Request {kind} histogram (seconds).",
                     h.sample_lines(fam, f'op="{op}"'))

        for k, v in sorted(snap["searcher_cache"].items()):
            emit(f"searcher_cache_{k}", "gauge",
                 "Compiled-searcher cache (delta since scheduler start).",
                 [f"searcher_cache_{k} {format_value(v)}"])
        for k, v in sorted(snap["device_dispatch"].items()):
            emit(f"device_dispatch_{k}", "counter",
                 "Device launches (delta since scheduler start).",
                 [f"device_dispatch_{k} {format_value(v)}"])
        for k, v in sorted(snap["tier"].items()):
            emit(f"tier_{k}", "counter",
                 "Column-store tier movement (delta since scheduler start).",
                 [f"tier_{k} {format_value(v)}"])
        merged = dict(snap["gauges"])
        merged.update(extra or {})
        for k, v in sorted(merged.items()):
            fam = k.split("{", 1)[0].split()[0]
            emit(fam, "gauge", "Scheduler gauge.",
                 [f"{k} {format_value(v)}"])
        return "\n".join(out) + "\n"
