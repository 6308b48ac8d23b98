"""Overload control plane (DESIGN.md §12) — a copy of
``repro.serving.overload`` (host-side control logic only).

The scheduler's only pre-existing defense against overload was a hard
``OverloadError`` at a fixed ``max_queue`` — one bursting tenant could
push every queued co-tenant request into multi-second tails before the
cliff fired.  This module replaces the cliff with a *pressure-aware*
control plane, built from the paper's own τ-ladder cost model plus the
classic resilience patterns (CoDel queue management, graceful
degradation, circuit breaking):

  * **Deadlines** — every request may carry a latency budget
    (``deadline_ms``); requests whose budget expires while queued are
    cancelled with :class:`DeadlineExceeded` *before* device dispatch
    (never a wasted fused launch), and :class:`DeadlineExceeded` /
    ``OverloadError`` both carry a machine-readable ``retry_after_ms``
    so clients can implement honest backoff.
  * **Adaptive admission** — :class:`AdmissionController` admits against
    the queue's outstanding *estimated cost* (paper Appendix A cost
    model, normalized so a reference top-k ≈ 1 unit) rather than its raw
    length, and watches a CoDel-style queue-delay target: an interval
    whose *minimum* delay never dips below target is sustained
    standing-queue pressure (not a burst absorbing into slack) and
    escalates the pressure level; a good interval resets it.
  * **Graceful degradation** — :class:`DegradePolicy` maps the pressure
    level onto an explicit ladder of cheaper answers
    (``rerank_off`` → ``shrink_k`` → ``cheap_tau`` → reject): under
    pressure a b-bit sketch trie query is answered *cheaper*, not
    *later*, and every degraded response is labelled with the stage that
    produced it (response ``degraded`` field, ``degraded_total:<stage>``
    counters, batch-span ``degrade`` args) so a degraded answer is
    always distinguishable from a full one.  Degraded answers are
    bit-identical to an undegraded run at the same effective
    (τ, k, rerank) settings — degradation changes parameters, never the
    kernels.
  * **Circuit breaking** — :class:`CircuitBreaker` trips a collection
    open after its recent window blows too many deadlines, rejects with
    ``retry_after_ms`` while open, and probes with a bounded number of
    half-open requests before closing again.
  * **Fault injection** — :class:`SlowDispatchInjector` reuses the
    ``store.faults`` ``hit(label)`` protocol at the scheduler's
    execution boundary (``execute:<collection>:<op>``) so a chaos
    harness can inject deterministic slow-dispatch faults per tenant.

Everything here is host-side control logic: no device work, no new
kernels, and zero cost when the knobs are left at their ``None``
defaults (the scheduler then behaves exactly as before this module
existed, fixed ``max_queue`` cliff included).
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import List, Optional, Tuple

__all__ = [
    "DeadlineExceeded", "AdmissionConfig", "AdmissionController",
    "DegradePolicy", "BreakerConfig", "CircuitBreaker",
    "SlowDispatchInjector", "estimate_units", "REF_K",
]

# the admission controller's cost normalizer: 1 unit == the cost-model
# estimate of one top-REF_K lookup over the collection's current corpus
REF_K = 8


class DeadlineExceeded(RuntimeError):
    """A request's latency budget expired while it was still queued; it
    was cancelled before any device dispatch.  Carries the shed
    request's context plus ``retry_after_ms`` — the controller's
    current estimate of when the queue will have drained enough for a
    retry to meet the same budget."""

    def __init__(self, message: str, *, collection: Optional[str] = None,
                 op: Optional[str] = None,
                 deadline_ms: Optional[float] = None,
                 retry_after_ms: float = 0.0):
        super().__init__(message)
        self.collection = collection
        self.op = op
        self.deadline_ms = deadline_ms
        self.retry_after_ms = retry_after_ms


# ---------------------------------------------------------------------------
# cost estimation (paper Appendix A through core.segments.cost_hint)
# ---------------------------------------------------------------------------

def estimate_units(index, op: str, key: tuple, payload: dict) -> float:
    """Estimated cost of one request in normalized units (reference
    top-``REF_K`` ≈ 1.0) via the index's ``cost_hint`` (the paper's cost
    model over the collection's live (b, L, n)).  Clamped to
    [1/16, 64] so one mis-estimated request can neither starve nor
    flood the admission budget.  Indexes without a ``cost_hint``
    (custom backends) cost 1 unit flat."""
    hint = getattr(index, "cost_hint", None)
    if hint is None:
        return 1.0
    ref = max(float(hint("topk", k=REF_K)), 1e-9)
    if op == "topk":
        raw = float(hint("topk", k=int(key[1])))
        if key[3] is not None:          # two-stage rerank: one extra
            raw *= 1.25                 # fused dispatch + payload gather
    elif op == "search":
        raw = float(hint("search", tau=int(key[1])))
    elif op == "insert":
        raw = float(hint("write", rows=len(payload["sketches"])))
    else:                               # delete
        raw = float(hint("write", rows=len(payload["ids"])))
    return min(max(raw / ref, 1.0 / 16.0), 64.0)


# ---------------------------------------------------------------------------
# adaptive admission (cost budget + CoDel delay target)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Adaptive-admission knobs (DESIGN.md §12).

    Attributes:
      target_delay_ms: CoDel queue-delay target — the delay a healthy
                   queue should dip under at least once per interval.
      interval_ms: CoDel observation interval; one fully-bad interval
                   escalates the pressure level by one, one good
                   interval resets it to zero.
      cost_capacity: admission budget in normalized cost units
                   (``estimate_units``); outstanding queued cost beyond
                   it sheds new best-effort work at submit time.
      min_queue:   always admit while fewer than this many requests are
                   queued, whatever the cost ledger says (a bad cost
                   estimate must never dead-lock an idle queue).
      rate_init:   initial service-rate estimate (units/s) used for
                   ``retry_after_ms`` before any batch has completed.
      max_level:   pressure-level ceiling (bounds the ladder index).
    """

    target_delay_ms: float = 5.0
    interval_ms: float = 100.0
    cost_capacity: float = 64.0
    min_queue: int = 8
    rate_init: float = 256.0
    max_level: int = 8


class AdmissionController:
    """Per-collection adaptive admission state: a cost-unit ledger of
    queued work, an EWMA of the measured service rate, and the
    CoDel-style pressure level the degradation ladder indexes.

    All mutators take the internal lock — submits, workers, and metric
    scrapes touch one controller concurrently.  The clock is injectable
    for deterministic tests and must match the scheduler's
    (``time.perf_counter``)."""

    def __init__(self, config: Optional[AdmissionConfig] = None,
                 clock=time.perf_counter):
        self.config = config if config is not None else AdmissionConfig()
        self._clock = clock
        self._lock = threading.Lock()
        self._level = 0
        self._queued_units = 0.0
        self._rate = float(self.config.rate_init)     # units/s EWMA
        self._int_min = math.inf
        self._int_end: Optional[float] = None
        self.sheds = 0                                # cost-budget rejects

    # -- ledger ----------------------------------------------------------

    def on_admit(self, units: float) -> None:
        with self._lock:
            self._queued_units += units

    def on_pop(self, units: float) -> None:
        with self._lock:
            self._queued_units = max(0.0, self._queued_units - units)

    def queued_units(self) -> float:
        with self._lock:
            return self._queued_units

    # -- CoDel pressure ---------------------------------------------------

    def note_delay(self, delay_s: float,
                   now: Optional[float] = None) -> None:
        """Record one request's queue delay (called at batch pop).  The
        per-interval *minimum* is what escalates: a burst whose tail
        still dips under target within the interval is absorbed; a
        standing queue whose minimum never does is pressure."""
        now = self._clock() if now is None else now
        cfg = self.config
        with self._lock:
            if self._int_end is None:
                self._int_end = now + cfg.interval_ms / 1e3
            self._int_min = min(self._int_min, delay_s)
            if now >= self._int_end:
                if self._int_min * 1e3 > cfg.target_delay_ms:
                    self._level = min(self._level + 1, cfg.max_level)
                else:
                    self._level = 0
                self._int_min = math.inf
                self._int_end = now + cfg.interval_ms / 1e3

    def note_empty(self) -> None:
        """The queue drained: standing-queue pressure is over (CoDel's
        exit condition) — counts as a zero-delay sample."""
        with self._lock:
            self._int_min = 0.0
            self._level = 0

    def note_exec(self, units: float, seconds: float) -> None:
        """Fold one completed batch into the service-rate EWMA (feeds
        ``retry_after_ms``)."""
        if seconds <= 0 or units <= 0:
            return
        with self._lock:
            self._rate = 0.8 * self._rate + 0.2 * (units / seconds)

    def pressure(self) -> int:
        """Current pressure level (0 = healthy; indexes the ladder)."""
        with self._lock:
            return self._level

    def retry_after_ms(self) -> float:
        """Estimated drain time of the queued cost at the measured
        service rate — what shed requests report to clients."""
        with self._lock:
            ms = self._queued_units / max(self._rate, 1e-6) * 1e3
        return min(max(ms, 1.0), 5000.0)

    def admit(self, units: float, queue_len: int,
              priority: int = 0) -> Optional[float]:
        """Admission check for one request of ``units`` estimated cost.
        Returns None to admit, else the suggested ``retry_after_ms``.
        Positive-priority requests bypass the cost budget (they remain
        subject to the scheduler's hard ``max_queue`` backstop)."""
        if priority > 0 or queue_len < self.config.min_queue:
            return None
        with self._lock:
            if self._queued_units + units <= self.config.cost_capacity:
                return None
            self.sheds += 1
        return self.retry_after_ms()


# ---------------------------------------------------------------------------
# graceful-degradation ladder
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DegradePolicy:
    """The explicit degradation ladder (DESIGN.md §12): pressure level N
    applies the first N stages, cheapest-loss first.  Stage semantics:

      * ``rerank_off`` — two-stage ``rerank=`` lookups execute as plain
        sketch top-k (drops the exact re-rank dispatch; scores absent).
      * ``shrink_k``   — k divides by ``k_shrink`` (floor ``k_floor``):
        a smaller k seeds a cheaper τ ladder and a smaller readback.
      * ``cheap_tau``  — top-k ladders restart from ``tau0``; range
        searches clamp τ to ``tau_cap`` (a cheaper — narrower — answer).

    Beyond the last stage the scheduler sheds at submit time (the
    ``reject`` stage).  A stage that changes nothing for a given request
    (e.g. ``rerank_off`` on a plain lookup) does not mark the answer
    degraded — only actually-degraded answers are labelled."""

    stages: Tuple[str, ...] = ("rerank_off", "shrink_k", "cheap_tau")
    k_floor: int = 1
    k_shrink: int = 2
    tau0: int = 0
    tau_cap: int = 1

    @property
    def reject_level(self) -> int:
        """First pressure level at which new best-effort work is shed
        at submit time instead of degraded."""
        return len(self.stages) + 1

    def apply_topk(self, level: int, k: int, tau0: Optional[int],
                   metric: Optional[str]):
        """-> (k_eff, tau0_eff, metric_eff, stage | None) — the deepest
        stage that actually changed the request, or None."""
        applied: Optional[str] = None
        for stage in self.stages[:max(0, min(level, len(self.stages)))]:
            if stage == "rerank_off":
                if metric is not None:
                    metric = None
                    applied = stage
            elif stage == "shrink_k":
                k_new = max(self.k_floor, k // self.k_shrink)
                if k_new < k:
                    k = k_new
                    applied = stage
            elif stage == "cheap_tau":
                if tau0 is None or tau0 > self.tau0:
                    tau0 = self.tau0
                    applied = stage
        return k, tau0, metric, applied

    def apply_search(self, level: int, tau: int):
        """-> (tau_eff, stage | None)."""
        active = self.stages[:max(0, min(level, len(self.stages)))]
        if "cheap_tau" in active and tau > self.tau_cap:
            return self.tau_cap, "cheap_tau"
        return tau, None


# ---------------------------------------------------------------------------
# per-collection circuit breaker
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    """Circuit-breaker knobs (DESIGN.md §12).

    Attributes:
      window:      outcome ring length (one entry per completed or
                   deadline-cancelled request).
      fail_frac:   failure fraction of the window that trips OPEN.
      min_samples: never trip on fewer than this many outcomes.
      open_ms:     how long the breaker stays OPEN before probing.
      probes:      HALF_OPEN probe budget; all must succeed to close.
      backoff:     OPEN duration multiplier per consecutive re-trip.
      max_open_ms: OPEN duration ceiling under backoff.
    """

    window: int = 16
    fail_frac: float = 0.5
    min_samples: int = 8
    open_ms: float = 1000.0
    probes: int = 2
    backoff: float = 2.0
    max_open_ms: float = 30000.0


class CircuitBreaker:
    """closed → open → half-open → closed state machine over request
    outcomes (success = completed within its deadline).  ``allow()`` is
    the submit-time gate; ``record()`` feeds completions and deadline
    cancellations back.  The clock is injectable for deterministic
    tests."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
    _CODES = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}

    def __init__(self, config: Optional[BreakerConfig] = None,
                 clock=time.perf_counter):
        self.config = config if config is not None else BreakerConfig()
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._outcomes: List[bool] = []
        self._open_until = 0.0
        self._trips = 0                 # consecutive re-trips (backoff)
        self.trips_total = 0
        self._probes_inflight = 0
        self._probe_ok = 0

    # -- introspection ---------------------------------------------------

    def state(self) -> str:
        with self._lock:
            return self._effective_state(self._clock())

    def state_code(self) -> int:
        """Numeric state for Prometheus gauges: closed=0, open=1,
        half_open=2."""
        return self._CODES[self.state()]

    def _effective_state(self, now: float) -> str:
        """OPEN lazily becomes HALF_OPEN once its window elapses (the
        transition happens on the next observation — there is no
        timer thread)."""
        if self._state == self.OPEN and now >= self._open_until:
            self._state = self.HALF_OPEN
            self._probes_inflight = 0
            self._probe_ok = 0
        return self._state

    # -- submit-time gate ------------------------------------------------

    def allow(self) -> Tuple[bool, float]:
        """-> (admit, retry_after_ms).  HALF_OPEN admits at most
        ``probes`` in-flight probe requests."""
        now = self._clock()
        with self._lock:
            state = self._effective_state(now)
            if state == self.CLOSED:
                return True, 0.0
            if state == self.OPEN:
                return False, max((self._open_until - now) * 1e3, 1.0)
            if self._probes_inflight < self.config.probes:
                self._probes_inflight += 1
                return True, 0.0
            return False, max(self.config.open_ms / 2.0, 1.0)

    def cancel(self) -> None:
        """Undo one ``allow()`` that never enqueued (a later admission
        check rejected the request) so a HALF_OPEN probe slot is not
        leaked."""
        with self._lock:
            if self._state == self.HALF_OPEN and self._probes_inflight > 0:
                self._probes_inflight -= 1

    # -- outcome feed ----------------------------------------------------

    def record(self, ok: bool) -> None:
        cfg = self.config
        now = self._clock()
        with self._lock:
            state = self._effective_state(now)
            if state == self.HALF_OPEN:
                if self._probes_inflight > 0:
                    self._probes_inflight -= 1
                if ok:
                    self._probe_ok += 1
                    if self._probe_ok >= cfg.probes:
                        self._state = self.CLOSED
                        self._outcomes.clear()
                        self._trips = 0
                else:
                    self._trip(now)
                return
            if state == self.OPEN:
                return                  # queued stragglers draining out
            self._outcomes.append(bool(ok))
            if len(self._outcomes) > cfg.window:
                del self._outcomes[: len(self._outcomes) - cfg.window]
            fails = self._outcomes.count(False)
            if (len(self._outcomes) >= cfg.min_samples
                    and fails / len(self._outcomes) >= cfg.fail_frac):
                self._trip(now)

    def _trip(self, now: float) -> None:
        cfg = self.config
        open_ms = min(cfg.open_ms * (cfg.backoff ** self._trips),
                      cfg.max_open_ms)
        self._state = self.OPEN
        self._open_until = now + open_ms / 1e3
        self._trips += 1
        self.trips_total += 1
        self._outcomes.clear()


# ---------------------------------------------------------------------------
# chaos-harness fault injection
# ---------------------------------------------------------------------------

class SlowDispatchInjector:
    """Slow-dispatch fault injection at the scheduler's execution
    boundary, ``store.faults``-style: the scheduler calls
    ``hit("execute:<collection>:<op>")`` once per batch before running
    it; an injector armed with ``delay_s`` sleeps there when the label
    contains ``match`` — a deterministic "the device got slow for this
    tenant" fault with no device code involved.  ``points`` records
    every label seen (counting mode), ``fired`` how many actually
    slept.

    >>> inj = SlowDispatchInjector(delay_s=0.0, match="victim")
    >>> inj.hit("execute:victim:topk"); inj.hit("execute:cotenant:topk")
    >>> (inj.fired, inj.points)
    (1, ['execute:victim:topk', 'execute:cotenant:topk'])
    """

    def __init__(self, delay_s: float = 0.0, match: str = "",
                 limit: Optional[int] = None):
        self.delay_s = float(delay_s)
        self.match = match
        self.limit = limit
        self.points: List[str] = []
        self.fired = 0
        self._lock = threading.Lock()

    def hit(self, label: str) -> None:
        with self._lock:
            self.points.append(label)
            fire = (self.match in label
                    and (self.limit is None or self.fired < self.limit))
            if fire:
                self.fired += 1
        if fire and self.delay_s > 0:
            time.sleep(self.delay_s)
