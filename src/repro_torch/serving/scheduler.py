"""Async micro-batching request scheduler over the segmented index
(DESIGN.md §5) — the port of ``repro.serving.scheduler``.

One ``Scheduler`` fronts a ``CollectionRegistry``: clients submit
single-request ``search`` / ``topk`` / ``insert`` / ``delete`` ops and
get a ``concurrent.futures.Future`` back.  Requests queue **per
collection** (tenant isolation: one collection's merge or burst never
blocks another's queue) and are executed by one worker per collection
(threaded mode) or by an explicit ``pump()`` (synchronous mode — used by
the deterministic property tests and single-threaded callers).

Execution model, per collection queue:

  * **Reads coalesce, writes fence.**  The worker takes the longest
    prefix of queued reads that share the head request's batch key
    (``("search", τ)`` or ``("topk", k, τ0)``), up to
    ``SchedulerConfig.max_batch`` queries; a queued write is a barrier —
    reads behind it must observe it, so they stay queued.  Reads commute
    with reads, which makes any coalescing order bit-identical to
    sequential execution (the batched searchers are bit-identical per
    row; this is the scheduler's core correctness property, held by
    ``tests/test_torch_serving.py`` against the JAX package's
    scheduler).
  * **Shape buckets.**  A group of g queries is padded to the
    power-of-two ``bucket_m(g)`` rows and results are sliced back, so
    every dispatch runs at one of a handful of shapes; after
    ``warmup()`` every program a read needs is built — a varying-size
    request stream causes zero steady-state builds.
  * **Max-wait flush.**  A partially filled read batch waits at most
    ``max_wait_ms`` (measured from its oldest request) for more
    arrivals; a write landing behind the read prefix flushes it
    immediately (nothing can join the prefix anymore).
  * **Admission control.**  Queues are bounded (``max_queue``); a full
    queue rejects new work with ``OverloadError`` at submit time instead
    of queueing unboundedly — overload is explicit, not silent latency.
    With ``SchedulerConfig.admission`` set, a pressure-aware control
    plane (``serving.overload``, DESIGN.md §12) runs *in front of* that
    backstop: cost-budget admission fed by the τ-ladder cost model,
    CoDel-style queue-delay pressure tracking, a graceful-degradation
    ladder applied per batch (``degrade``), and a per-collection circuit
    breaker (``breaker``).  Requests may carry a ``deadline_ms`` budget;
    a request whose budget expires while queued is cancelled with
    ``DeadlineExceeded`` before any device dispatch.
  * **Writes interleave re-jit-free.**  ``insert`` lands in the delta
    buffer, ``delete`` flips tombstone bits that every program reads
    afresh; neither invalidates a cached program, so read batches stream
    on between writes.

On the card, a read batch runs on the collection's device and its
result planes come back to the host **once per batch** (one copy per
plane, sliced to the batch's real rows), inside the ``exec`` timing
window, so ``exec`` seconds cover the device work; each response is a
row of those host arrays.  Responses are numpy, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Deque, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.search import TopKResult
from ..obs.slowlog import SlowQueryLog
from ..obs.trace import Span, Tracer, attach
from ..obs.trace import span as _obs_span
from .batching import bucket_m, bucket_table, pad_to_bucket
from .collections import Collection, CollectionConfig, CollectionRegistry
from .metrics import ServingMetrics
from .overload import (AdmissionConfig, AdmissionController, BreakerConfig,
                       CircuitBreaker, DeadlineExceeded, DegradePolicy,
                       estimate_units)

__all__ = ["OverloadError", "DeadlineExceeded", "SchedulerConfig",
           "Scheduler", "SearchResponse", "TopKResponse"]

_WRITES = ("insert", "delete")
_LOG = logging.getLogger(__name__)


class OverloadError(RuntimeError):
    """Raised at submit time when a collection sheds the request — queue
    full (the hard ``max_queue`` backstop), cost budget exhausted, the
    degradation ladder at its ``reject`` stage, or the circuit breaker
    open.  Carries the shed request's context so callers (and logs) can
    see *what* was rejected — ``collection``, ``op``, ``queue_depth``,
    ``reason`` — and a machine-readable ``retry_after_ms`` backoff
    hint."""

    def __init__(self, message: str, *, collection: Optional[str] = None,
                 op: Optional[str] = None,
                 queue_depth: Optional[int] = None,
                 retry_after_ms: float = 0.0,
                 reason: str = "queue_full"):
        super().__init__(message)
        self.collection = collection
        self.op = op
        self.queue_depth = queue_depth
        self.retry_after_ms = retry_after_ms
        self.reason = reason


def _host(t: torch.Tensor) -> np.ndarray:
    """One device->host copy of a batch plane (a no-op view on the
    CPU)."""
    return t.cpu().numpy()


class SearchResponse(NamedTuple):
    mask: np.ndarray     # (n_ids,) bool — live ids within τ
    dist: np.ndarray     # (n_ids,) int32 — exact distance on mask, BIG off
    overflow: int        # total dropped frontier entries of the dispatch
    degraded: Optional[str] = None   # ladder stage that degraded this
    #                      answer ("cheap_tau"), or None for a full answer


class TopKResponse(NamedTuple):
    ids: np.ndarray      # (k,) int32 global ids, ascending (distance, id);
    #                      rerank= requests order by (score desc, id asc)
    dists: np.ndarray    # (k,) int32 exact distances; BIG on pad
    tau: int             # final ladder rung of the dispatch (batch-shared)
    overflow: int
    scores: Optional[np.ndarray] = None   # (k,) f32 exact re-rank scores
    #                      (rerank= requests only); -1.0 on pad
    degraded: Optional[str] = None   # deepest ladder stage that degraded
    #                      this answer ("rerank_off" | "shrink_k" |
    #                      "cheap_tau"), or None for a full answer


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Batching and admission-control knobs.

    Attributes:
      max_batch:   most queries coalesced into one read dispatch (the
                   largest shape bucket is ``bucket_m(max_batch)``).
      max_queue:   per-collection bound on queued requests; beyond it
                   ``submit_*`` raises ``OverloadError``.
      max_wait_ms: longest a partially filled read batch waits for more
                   arrivals before flushing (threaded mode; ``pump()``
                   always flushes immediately).
      slow_ms:     slow-query threshold (end-to-end, milliseconds); a
                   request at or above it dumps its span tree into the
                   scheduler's ``SlowQueryLog``.  None (default)
                   disables the slow log — and, with no ``tracer``
                   either, disables span recording entirely (requests
                   carry no spans and the query path's instrumentation
                   points are shared no-ops).
      admission:   per-collection adaptive admission control
                   (``overload.AdmissionConfig``): cost-budget admission
                   over the τ-ladder cost model + CoDel queue-delay
                   pressure levels.  None (default) keeps only the hard
                   ``max_queue`` cliff — pre-§12 behavior.
      degrade:     graceful-degradation ladder (``overload.DegradePolicy``)
                   applied per batch at the current pressure level;
                   requires ``admission``.  None = never degrade.
      breaker:     per-collection circuit breaker
                   (``overload.BreakerConfig``) over deadline outcomes.
                   None = never trip.
      default_deadline_ms: deadline applied to requests that pass
                   ``deadline_ms=None`` (per-collection
                   ``CollectionConfig.default_deadline_ms`` wins over
                   this scheduler-wide default).  None = no deadline.
      join_timeout_s: how long ``stop()`` waits for each worker thread
                   before declaring the shutdown dirty.
    """

    max_batch: int = 64
    max_queue: int = 1024
    max_wait_ms: float = 2.0
    slow_ms: Optional[float] = None
    admission: Optional[AdmissionConfig] = None
    degrade: Optional[DegradePolicy] = None
    breaker: Optional[BreakerConfig] = None
    default_deadline_ms: Optional[float] = None
    join_timeout_s: float = 60.0


@dataclasses.dataclass(eq=False)      # identity equality: requests are
class _Request:                       # queue entries, never value-compared
    op: str                       # "search" | "topk" | "insert" | "delete"
    key: tuple                    # reads: batch key; writes: (op,)
    payload: dict
    future: Future
    t_enq: float
    span: Optional[Span] = None   # request root (tracing enabled only)
    deadline: Optional[float] = None   # absolute perf_counter() budget
    priority: int = 0             # > 0 bypasses cost-budget admission
    units: float = 1.0            # estimated cost (reference top-k = 1)


class _CollState:
    """Per-collection queue + condition variable (+ the collection's
    admission controller and circuit breaker, when configured)."""

    def __init__(self, ctrl: Optional[AdmissionController] = None,
                 breaker: Optional[CircuitBreaker] = None):
        self.queue: Deque[_Request] = deque()
        self.cond = threading.Condition()
        self.ctrl = ctrl
        self.breaker = breaker


class Scheduler:
    """Micro-batching front end over a ``CollectionRegistry``.

    Threaded mode: ``start()`` spawns one worker per collection;
    ``stop()`` drains every queue and joins.  Synchronous mode: skip
    ``start()`` and call ``pump()`` to drain queues deterministically on
    the caller's thread (batching behaves identically, minus the
    max-wait timer).

    Without a ``registry`` the scheduler builds its own on ``device``
    (default "cuda"; raises without a card); a given registry brings its
    own device.
    """

    def __init__(self, registry: Optional[CollectionRegistry] = None,
                 config: Optional[SchedulerConfig] = None,
                 metrics: Optional[ServingMetrics] = None,
                 tracer: Optional[Tracer] = None,
                 slowlog: Optional[SlowQueryLog] = None,
                 faults=None, device="cuda"):
        self.registry = registry if registry is not None \
            else CollectionRegistry(device=device)
        self.config = config if config is not None else SchedulerConfig()
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.tracer = tracer
        if slowlog is None and self.config.slow_ms is not None:
            slowlog = SlowQueryLog()        # slow_ms implies a log to fill
        self.slowlog = slowlog
        # fault-injection hook (chaos harness): any object with
        # ``hit(label)`` — called once per batch as
        # ``execute:<collection>:<op>`` before the batch runs, matching
        # the store.faults protocol (overload.SlowDispatchInjector)
        self.faults = faults
        self._states: Dict[str, _CollState] = {}
        self._states_lock = threading.Lock()
        self._workers: Dict[str, threading.Thread] = {}
        self._started = False
        self._stopping = False
        self.stopped_dirty = False          # a stop() failed to join
        self._dirty: set = set()            # collections with stuck workers
        # adopt collections already in the registry (a recovered
        # CollectionRegistry.open(data_dir)): queue state + metrics tap,
        # exactly as create_collection would have wired them
        for name in self.registry.names():
            coll = self.registry.get(name)
            for idx in getattr(coll.index, "shards", [coll.index]):
                idx.event_hook = self._maintenance_hook
            self._ensure_state(name)

    # -- collection management -------------------------------------------

    def create_collection(self, name: str,
                          config: CollectionConfig) -> Collection:
        """Register a collection and tap its index's write events into
        the metrics (``maintenance_total:flush|merge|compact`` ...)."""
        coll = self.registry.create(name, config)
        for idx in getattr(coll.index, "shards", [coll.index]):
            idx.event_hook = self._maintenance_hook
        self._ensure_state(name)
        return coll

    def _maintenance_hook(self, event: str, info: dict) -> None:
        self.metrics.inc(f"maintenance_total:{event}")

    def _ensure_state(self, name: str) -> _CollState:
        with self._states_lock:
            state = self._states.get(name)
            if state is None:
                cfg = self.config
                ctrl = AdmissionController(cfg.admission) \
                    if cfg.admission is not None else None
                breaker = CircuitBreaker(cfg.breaker) \
                    if cfg.breaker is not None else None
                state = self._states[name] = _CollState(ctrl, breaker)
                if self._started and not self._stopping:
                    self._spawn_worker(name)
            return state

    # -- submission ------------------------------------------------------

    def _shed(self, name: str, op: str, reason: str,
              retry_after_ms: float, depth: int) -> None:
        """Reject one request at submit time with full context."""
        self.metrics.inc("rejected_total")
        self.metrics.inc(f"rejected_total:{op}")
        self.metrics.inc(f"shed_total:{reason}")
        raise OverloadError(
            f"collection {name!r} shed {op} ({reason}, "
            f"queue_depth={depth}, retry_after_ms={retry_after_ms:.0f})",
            collection=name, op=op, queue_depth=depth,
            retry_after_ms=retry_after_ms, reason=reason)

    def _submit(self, name: str, op: str, key: tuple, payload: dict,
                deadline_ms: Optional[float] = None,
                priority: Optional[int] = None) -> Future:
        coll = self.registry.get(name)     # raises KeyError if unknown
        state = self._ensure_state(name)
        if deadline_ms is None:
            deadline_ms = getattr(coll.config, "default_deadline_ms", None)
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        if priority is None:
            priority = int(getattr(coll.config, "priority", 0) or 0)
        fut: Future = Future()
        t_enq = time.perf_counter()
        req = _Request(
            op=op, key=key, payload=payload, future=fut, t_enq=t_enq,
            deadline=(None if deadline_ms is None
                      else t_enq + float(deadline_ms) / 1e3),
            priority=int(priority))
        ctrl, breaker = state.ctrl, state.breaker
        if ctrl is not None:
            req.units = estimate_units(coll.index, op, key, payload)
        probed = False
        if breaker is not None:
            ok, retry = breaker.allow()
            if not ok:
                self._shed(name, op, "breaker_open", retry,
                           len(state.queue))
            probed = True        # admitted through a possibly-probing
        try:                     # breaker: cancel the slot on any reject
            with state.cond:
                if self._stopping:
                    raise RuntimeError("scheduler is stopped")
                depth = len(state.queue)
                if depth >= self.config.max_queue:
                    retry = ctrl.retry_after_ms() if ctrl is not None \
                        else 0.0
                    self._shed(name, op, "queue_full", retry, depth)
                if ctrl is not None and req.priority <= 0 \
                        and depth >= ctrl.config.min_queue:
                    # past the ladder there is no cheaper answer left:
                    # shed new best-effort work at submit time
                    reject_level = (self.config.degrade.reject_level
                                    if self.config.degrade is not None
                                    else 2)
                    if ctrl.pressure() >= reject_level:
                        self._shed(name, op, "pressure",
                                   ctrl.retry_after_ms(), depth)
                if ctrl is not None:
                    retry = ctrl.admit(req.units, depth, req.priority)
                    if retry is not None:
                        self._shed(name, op, "cost_budget", retry, depth)
                if self.tracer is not None or self.slowlog is not None:
                    req.span = Span("request", cat="request", ts=req.t_enq,
                                    args={"op": op, "collection": name})
                state.queue.append(req)
                if ctrl is not None:
                    ctrl.on_admit(req.units)
                state.cond.notify_all()
        except BaseException:
            if probed:
                breaker.cancel()           # don't leak a half-open probe
            raise
        self.metrics.inc(f"requests_total:{op}")
        return fut

    def submit_search(self, collection: str, q: np.ndarray, tau: int,
                      deadline_ms: Optional[float] = None,
                      priority: Optional[int] = None) -> Future:
        """One range query -> Future[SearchResponse].  Coalesces with
        other queued ``(collection, τ)`` searches.  ``deadline_ms`` is
        the request's end-to-end latency budget (expired-in-queue
        requests fail with ``DeadlineExceeded`` before any dispatch);
        ``priority > 0`` bypasses cost-budget admission."""
        q = np.asarray(q, dtype=np.uint8)
        return self._submit(collection, "search", ("search", int(tau)),
                            {"q": q}, deadline_ms=deadline_ms,
                            priority=priority)

    def submit_topk(self, collection: str, q: np.ndarray, k: int,
                    tau0: Optional[int] = None,
                    rerank: Optional[str] = None,
                    q_payload: Optional[np.ndarray] = None,
                    deadline_ms: Optional[float] = None,
                    priority: Optional[int] = None) -> Future:
        """One kNN query -> Future[TopKResponse].  Coalesces with other
        queued ``(collection, k, τ0, metric)`` lookups — a two-stage
        ``rerank=`` request never coalesces with a plain one (the batch
        key carries the metric), and ``q_payload`` is the query's (Wp,)
        uint32 set bitmap.  ``deadline_ms``/``priority`` as
        ``submit_search``."""
        q = np.asarray(q, dtype=np.uint8)
        payload = {"q": q}
        if q_payload is not None:
            payload["q_payload"] = np.asarray(q_payload,
                                              np.uint32).reshape(-1)
        return self._submit(collection, "topk",
                            ("topk", int(k),
                             None if tau0 is None else int(tau0), rerank),
                            payload, deadline_ms=deadline_ms,
                            priority=priority)

    def submit_insert(self, collection: str, sketches: np.ndarray,
                      payloads: Optional[np.ndarray] = None,
                      deadline_ms: Optional[float] = None,
                      priority: Optional[int] = None) -> Future:
        """Insert -> Future[(k,) int64 global ids].  ``payloads`` carries
        the rows' (k, Wp) uint32 re-rank set bitmaps for collections
        configured with ``payload_words``."""
        payload = {"sketches": np.asarray(sketches, dtype=np.uint8),
                   "payloads": (None if payloads is None
                                else np.asarray(payloads, np.uint32))}
        return self._submit(collection, "insert", ("insert",), payload,
                            deadline_ms=deadline_ms, priority=priority)

    def submit_delete(self, collection: str, ids,
                      deadline_ms: Optional[float] = None,
                      priority: Optional[int] = None) -> Future:
        """Delete -> Future[int newly-removed count]."""
        return self._submit(collection, "delete", ("delete",),
                            {"ids": np.atleast_1d(np.asarray(ids,
                                                             np.int64))},
                            deadline_ms=deadline_ms, priority=priority)

    # -- batch formation -------------------------------------------------

    def _peek_read_group(self, state: _CollState) \
            -> Tuple[List[_Request], bool]:
        """The coalescible read prefix: requests matching the head's
        batch key, stopping the scan at the first write (a fence).
        Returns (group, fence_seen)."""
        head = state.queue[0]
        group: List[_Request] = []
        for req in state.queue:
            if req.op in _WRITES:
                return group, True
            if req.key == head.key:
                group.append(req)
                if len(group) >= self.config.max_batch:
                    break            # a full group flushes regardless
        return group, False

    def _fail_deadline(self, name: str, state: _CollState,
                       req: _Request) -> None:
        """Cancel one expired request: ``DeadlineExceeded`` to the
        client (with the controller's backoff hint), outcome fed to the
        breaker, span closed.  The request never reaches a dispatch."""
        retry = state.ctrl.retry_after_ms() if state.ctrl is not None \
            else 0.0
        budget_ms = (req.deadline - req.t_enq) * 1e3
        self.metrics.inc("deadline_exceeded_total")
        self.metrics.inc(f"deadline_exceeded_total:{req.op}")
        if state.breaker is not None:
            state.breaker.record(False)
        if req.span is not None:
            req.span.args["deadline_exceeded"] = True
            req.span.dur = time.perf_counter() - req.t_enq
            if self.tracer is not None:
                self.tracer.add(req.span)
        if not req.future.done():
            req.future.set_exception(DeadlineExceeded(
                f"{req.op} on {name!r} expired in queue "
                f"(budget {budget_ms:.0f} ms, cancelled before dispatch)",
                collection=name, op=req.op, deadline_ms=budget_ms,
                retry_after_ms=retry))

    def _purge_expired(self, name: str, state: _CollState) -> None:
        """``state.cond`` held: drop queued requests whose deadline has
        already passed — they can only waste a device dispatch."""
        now = time.perf_counter()
        expired = [r for r in state.queue
                   if r.deadline is not None and now >= r.deadline]
        if not expired:
            return
        dead = set(map(id, expired))
        state.queue = deque(r for r in state.queue if id(r) not in dead)
        for r in expired:
            if state.ctrl is not None:
                state.ctrl.on_pop(r.units)
            self._fail_deadline(name, state, r)

    def _next_batch(self, name: str, state: _CollState,
                    block: bool) -> Optional[List[_Request]]:
        """Pop the next executable batch (one write, or a coalesced read
        group).  ``block=True`` (worker threads) waits for work and holds
        partially filled read batches up to max_wait; ``block=False``
        (``pump``) flushes whatever is queued and returns None on empty."""
        max_wait = self.config.max_wait_ms / 1e3
        with state.cond:
            while True:
                self._purge_expired(name, state)
                if not state.queue:
                    if state.ctrl is not None:
                        state.ctrl.note_empty()
                    if not block or self._stopping:
                        return None
                    state.cond.wait(timeout=0.1)
                    continue
                head = state.queue[0]
                if head.op in _WRITES:
                    state.queue.popleft()
                    return [head]
                group, fence = self._peek_read_group(state)
                deadline = head.t_enq + max_wait
                if (not block or fence or self._stopping
                        or len(group) >= self.config.max_batch
                        or time.perf_counter() >= deadline):
                    picked = set(map(id, group))   # one O(queue) rebuild
                    state.queue = deque(
                        r for r in state.queue if id(r) not in picked)
                    return group
                state.cond.wait(
                    timeout=max(deadline - time.perf_counter(), 0.0))

    # -- execution -------------------------------------------------------

    def _execute(self, name: str, batch: List[_Request]) -> None:
        """Run one batch; any exception fails the batch's futures (the
        clients see it) and never escapes to the worker loop — a failed
        batch must not kill a queue's only worker or skip the latency
        accounting of its requests.

        Tracing (enabled per request at submit): each traced request
        root gets a ``queue_wait`` child covering enqueue -> here, then
        links the ONE shared ``batch`` span (the work was genuinely
        shared by the coalesced group; the Chrome export de-duplicates
        it).  The batch span is attached to this thread for the
        execution, so the query path's instrumentation points
        (``rung_dispatch``, ``tier_stage``, ``rerank``, ...) nest under
        it with no signature threading."""
        op = batch[0].op
        state = self._ensure_state(name)
        ctrl, breaker = state.ctrl, state.breaker
        t_pop = time.perf_counter()
        for req in batch:
            self.metrics.record_queue(op, t_pop - req.t_enq)
            if ctrl is not None:
                ctrl.on_pop(req.units)
                ctrl.note_delay(t_pop - req.t_enq, now=t_pop)
        if self.faults is not None:
            # chaos-harness hook: an armed SlowDispatchInjector sleeps
            # here — the "device got slow for this tenant" fault
            self.faults.hit(f"execute:{name}:{op}")
        # last-gasp deadline check (the fault may have slept): an
        # expired request must never reach the dispatch below
        now = time.perf_counter()
        expired = [r for r in batch
                   if r.deadline is not None and now >= r.deadline]
        if expired:
            for req in expired:
                self._fail_deadline(name, state, req)
            dead = set(map(id, expired))
            batch = [r for r in batch if id(r) not in dead]
            if not batch:
                return
        level = ctrl.pressure() if ctrl is not None else 0
        batch_span: Optional[Span] = None
        traced = [r for r in batch if r.span is not None]
        if traced:
            batch_span = Span(
                "batch", cat="batch", ts=t_pop,
                track=threading.current_thread().name,
                args={"op": op, "collection": name, "size": len(batch),
                      "key": repr(batch[0].key)})
            for req in traced:
                wait = req.span.child("queue_wait", cat="sched")
                wait.ts, wait.dur = req.t_enq, t_pop - req.t_enq
                req.span.children.append(batch_span)
        try:
            coll = self.registry.get(name)
            if batch_span is not None:
                with attach(batch_span):
                    self._run_batch(coll, op, batch, level, batch_span)
            else:
                self._run_batch(coll, op, batch, level, batch_span)
        except Exception as e:                     # noqa: BLE001
            self.metrics.inc("executor_errors_total")
            for req in batch:
                if not req.future.done():
                    req.future.set_exception(e)
        finally:
            t_done = time.perf_counter()
            if ctrl is not None:
                ctrl.note_exec(sum(r.units for r in batch),
                               t_done - t_pop)
            if batch_span is not None:
                batch_span.dur = t_done - batch_span.ts
            for req in batch:
                e2e = t_done - req.t_enq
                self.metrics.record_latency(op, e2e)
                if breaker is not None:
                    exc = req.future.exception() if req.future.done() \
                        else None
                    ok = exc is None and (req.deadline is None
                                          or t_done <= req.deadline)
                    breaker.record(ok)
                if req.span is None:
                    continue
                req.span.dur = e2e
                if self.tracer is not None:
                    self.tracer.add(req.span)
                if (self.slowlog is not None
                        and self.config.slow_ms is not None
                        and e2e * 1e3 >= self.config.slow_ms):
                    self.slowlog.record(
                        req.span, op=op, collection=name,
                        slow_ms=self.config.slow_ms)

    def _run_batch(self, coll: Collection, op: str, batch: List[_Request],
                   level: int = 0,
                   batch_span: Optional[Span] = None) -> None:
        if op in _WRITES:
            self._execute_write(coll, batch[0])
        else:
            self._execute_reads(coll, batch, level, batch_span)

    def _execute_reads(self, coll: Collection, batch: List[_Request],
                       level: int = 0,
                       batch_span: Optional[Span] = None) -> None:
        op, key = batch[0].op, batch[0].key
        g = len(batch)
        policy = self.config.degrade
        degraded: Optional[str] = None
        with _obs_span("batch_assembly", cat="sched", size=g,
                       bucket=bucket_m(g)):
            qs = pad_to_bucket(np.stack([r.payload["q"] for r in batch]))
        t0 = time.perf_counter()
        if op == "search":
            tau = key[1]
            if policy is not None and level > 0:
                tau, degraded = policy.apply_search(level, tau)
            with _obs_span("execute", cat="exec", op=op, tau=tau):
                res = coll.index.search_batch(qs, tau)
                mask, dist = _host(res.mask[:g]), _host(res.dist[:g])
            self.metrics.record_exec(op, time.perf_counter() - t0)
            overflow = int(res.overflow)
            with _obs_span("respond", cat="sched"):
                for i, req in enumerate(batch):
                    req.future.set_result(SearchResponse(
                        mask=mask[i], dist=dist[i], overflow=overflow,
                        degraded=degraded))
        else:
            k, tau0, metric = key[1], key[2], key[3]
            if policy is not None and level > 0:
                # degradation changes *parameters*, never kernels: the
                # degraded answer is bit-identical to an undegraded run
                # at the same effective (k, τ0, rerank) settings
                k, tau0, metric, degraded = policy.apply_topk(
                    level, k, tau0, metric)
            with _obs_span("execute", cat="exec", op=op, k=k):
                if metric is not None:
                    pays = pad_to_bucket(np.stack(
                        [r.payload["q_payload"] for r in batch]))
                    res: TopKResult = coll.index.topk_batch(
                        qs, k, tau0=tau0, rerank=metric, q_payloads=pays)
                else:
                    res = coll.index.topk_batch(qs, k, tau0=tau0)
                ids, dists = _host(res.ids[:g]), _host(res.dists[:g])
                scores = (None if res.scores is None
                          else _host(res.scores[:g]))
            self.metrics.record_exec(op, time.perf_counter() - t0)
            with _obs_span("respond", cat="sched"):
                for i, req in enumerate(batch):
                    req.future.set_result(TopKResponse(
                        ids=ids[i], dists=dists[i], tau=int(res.tau),
                        overflow=int(res.overflow),
                        scores=None if scores is None else scores[i],
                        degraded=degraded))
        if degraded is not None:
            self.metrics.inc("degraded_total", g)
            self.metrics.inc(f"degraded_total:{degraded}", g)
            if batch_span is not None:
                batch_span.args["degrade"] = degraded
                batch_span.args["pressure_level"] = level
        self.metrics.record_batch(op, g, bucket_m(g))

    def _execute_write(self, coll: Collection, req: _Request) -> None:
        t0 = time.perf_counter()
        with _obs_span("execute", cat="exec", op=req.op):
            if req.op == "insert":
                result = coll.index.insert(
                    req.payload["sketches"],
                    payloads=req.payload.get("payloads"))
            else:
                result = coll.index.delete(req.payload["ids"])
                frac = coll.config.compact_dead_frac
                if frac is not None:
                    coll.index.compact(min_dead_frac=frac)
        self.metrics.record_exec(req.op, time.perf_counter() - t0)
        self.metrics.inc("write_ops_total")
        req.future.set_result(result)

    # -- drive -----------------------------------------------------------

    def start(self) -> "Scheduler":
        """Spawn one worker thread per registered collection."""
        # _started flips under _states_lock so a concurrent
        # create_collection() cannot race us into spawning a second
        # worker on one queue (which would let a read pass a write fence)
        with self._states_lock:
            if self._started:
                return self
            self._started = True
            self._stopping = False
            for name in self._states:
                self._spawn_worker(name)
        return self

    def _spawn_worker(self, name: str) -> None:
        prev = self._workers.get(name)
        if prev is not None and prev.is_alive():
            return                          # one worker per queue, ever
        t = threading.Thread(target=self._worker, args=(name,),
                             name=f"serving-{name}", daemon=True)
        self._workers[name] = t
        t.start()

    def _worker(self, name: str) -> None:
        state = self._ensure_state(name)
        while True:
            batch = self._next_batch(name, state, block=True)
            if batch is None:
                return                      # stopping and drained
            if batch:
                try:
                    self._execute(name, batch)
                except Exception:           # noqa: BLE001 — paranoia:
                    # _execute already routes failures into the batch's
                    # futures; whatever still escapes (metrics bugs, OOM
                    # cleanup) must not silently kill the queue's worker
                    self.metrics.inc("executor_errors_total")

    def stop(self) -> None:
        """Drain every queue (outstanding futures complete) and join the
        workers.  Subsequent submits raise.

        A worker that fails to join within ``config.join_timeout_s`` is
        a loud event, never a silent one: it is logged at ERROR,
        ``stopped_dirty`` flips (surfaced in ``stats()`` and as the
        ``serving_stopped_dirty`` gauge), and ``pump()`` permanently
        skips the stuck collection — its queue may still be owned by
        the wedged thread, and a second caller would break the
        one-executor-per-queue invariant (a read could pass a write
        fence)."""
        self._stopping = True
        with self._states_lock:
            states = list(self._states.items())
        for _, state in states:
            with state.cond:
                state.cond.notify_all()
        for name, t in list(self._workers.items()):
            t.join(timeout=self.config.join_timeout_s)
            if t.is_alive():
                self.stopped_dirty = True
                self._dirty.add(name)
                self.metrics.inc("stopped_dirty_total")
                self.metrics.set_gauge("serving_stopped_dirty", 1)
                _LOG.error(
                    "stop(): worker %r failed to join within %.1f s — "
                    "DIRTY shutdown; collection %r is quarantined from "
                    "pump() (its queue may still be owned by the wedged "
                    "thread)", t.name, self.config.join_timeout_s, name)
        self._workers.clear()
        self._started = False
        self.pump()                         # finish anything left behind

    def pump(self) -> int:
        """Synchronous drive: drain every collection queue on the calling
        thread (deterministic — no timers).  Returns batches executed.
        Collections quarantined by a dirty ``stop()`` are skipped."""
        executed = 0
        progressed = True
        while progressed:
            progressed = False
            with self._states_lock:
                items = list(self._states.items())
            for name, state in items:
                if name in self._dirty:
                    continue
                while True:
                    batch = self._next_batch(name, state, block=False)
                    if not batch:
                        break
                    self._execute(name, batch)
                    executed += 1
                    progressed = True
        return executed

    def warmup(self, collection: Optional[str] = None,
               ks: Tuple[int, ...] = (8,),
               taus: Tuple[int, ...] = (),
               reranks: Tuple[str, ...] = ()) -> Dict[str, int]:
        """Run every power-of-two shape bucket up to ``max_batch`` once
        on the card so first-request set-up never pollutes serving p99:
        the first call builds the CUDA kernels (``kernels/_build.py``),
        and each (k / τ / metric, ladder rung) builds its program.

        Drives ``topk_batch`` for each k in ``ks``, ``search_batch`` for
        each τ in ``taus`` and, on collections with ``payload_words``,
        the ``rerank=`` ``topk_batch`` for each metric in ``reranks`` at
        every k (empty query bitmaps), over zero-sketch queries at every
        bucket size, for ``collection`` (default: all), then waits for
        the device.  Empty collections are skipped (their programs
        rebuild on first insert anyway).  Returns ``{"buckets", "calls",
        "traces"}`` — ``traces`` is the number of program builds the
        warmup absorbed (``searcher_cache_info()["traces"]``)."""
        from ..core.search import searcher_cache_info
        names = [collection] if collection is not None \
            else self.registry.names()
        buckets = bucket_table(self.config.max_batch)
        traces0 = searcher_cache_info().get("traces", 0)
        calls = 0
        for name in names:
            coll = self.registry.get(name)
            if getattr(coll.index, "n_live", 0) == 0:
                continue
            wp = coll.config.payload_words
            for bkt in buckets:
                qs = np.zeros((bkt, coll.config.L), dtype=np.uint8)
                for k in ks:
                    coll.index.topk_batch(qs, int(k))
                    calls += 1
                    for metric in (reranks if wp is not None else ()):
                        coll.index.topk_batch(
                            qs, int(k), rerank=metric,
                            q_payloads=np.zeros((bkt, wp), np.uint32))
                        calls += 1
                for tau in taus:
                    coll.index.search_batch(qs, int(tau))
                    calls += 1
            if coll.index.device.type == "cuda":
                torch.cuda.synchronize(coll.index.device)
        self.metrics.inc("warmup_calls_total", calls)
        return {"buckets": len(buckets), "calls": calls,
                "traces": searcher_cache_info().get("traces", 0) - traces0}

    # -- introspection ---------------------------------------------------

    def queue_depth(self, collection: Optional[str] = None) -> int:
        with self._states_lock:
            states = [self._states[collection]] if collection is not None \
                else list(self._states.values())
        return sum(len(s.queue) for s in states)

    def stats(self) -> Dict[str, object]:
        """One dict: metrics snapshot + queue depths + per-collection
        index occupancy (segments, tombstones, live counts) + the
        overload control plane's state (pressure level, queued cost
        units, breaker state/trips) when configured."""
        with self._states_lock:
            depths = {name: len(state.queue)
                      for name, state in self._states.items()}
            overload: Dict[str, Dict[str, object]] = {}
            for name, state in self._states.items():
                d: Dict[str, object] = {}
                if state.ctrl is not None:
                    d["pressure_level"] = state.ctrl.pressure()
                    d["queued_units"] = state.ctrl.queued_units()
                    d["retry_after_ms"] = state.ctrl.retry_after_ms()
                    d["cost_sheds"] = state.ctrl.sheds
                if state.breaker is not None:
                    d["breaker"] = state.breaker.state()
                    d["breaker_trips"] = state.breaker.trips_total
                if d:
                    overload[name] = d
        out = {**self.metrics.snapshot(), "queue_depth": depths,
               "collections": self.registry.stats(),
               "stopped_dirty": self.stopped_dirty}
        if overload:
            out["overload"] = overload
        return out

    def render_stats(self) -> str:
        """``/stats``-style text dump of everything ``stats()`` reports."""
        extra: Dict[str, object] = {}
        with self._states_lock:
            for name, state in self._states.items():
                extra[f'serving_queue_depth{{collection="{name}"}}'] = \
                    len(state.queue)
                if state.breaker is not None:
                    extra[f'serving_breaker_state{{collection="{name}"}}'] \
                        = state.breaker.state_code()
                if state.ctrl is not None:
                    extra[f'serving_pressure_level{{collection="{name}"}}'] \
                        = state.ctrl.pressure()
                    extra[f'serving_queued_cost_units'
                          f'{{collection="{name}"}}'] = \
                        state.ctrl.queued_units()
        for name, st in self.registry.stats().items():
            for gauge in ("n_live", "tombstones", "n_segments", "n_ids",
                          "arena_bytes", "device_bytes", "host_bytes"):
                if gauge in st:
                    extra[f'index_{gauge}{{collection="{name}"}}'] = st[gauge]
            for gauge in ("wal_bytes", "snapshot_bytes", "wal_truncations",
                          "replayed_records", "recovered_segments"):
                if "store" in st and gauge in st["store"]:
                    extra[f'store_{gauge}{{collection="{name}"}}'] = \
                        st["store"][gauge]
        return self.metrics.render_text(extra=extra)
