#!/usr/bin/env python
"""Chaos/overload harness for the serving control plane on the PyTorch /
CUDA port: ``tools/overload_smoke.py`` over ``repro_torch.serving``,
its four scenarios and their gates unchanged (DESIGN.md §12).

Four phases, each a hard gate (the SLO is CI-enforced, not aspirational):

  A. **Burst SLO** — one tenant ("victim") fires a 10× open-loop burst
     while a ``SlowDispatchInjector`` stalls every one of its dispatches
     (the "device got slow for this tenant" fault); two well-behaved
     co-tenant clients run closed-loop beside it.  Asserts: co-tenant
     goodput (answers within deadline) ≥ 0.9, victim p99 ≤ 10× its p50
     (deadlines bound the tail — overload degrades *bounded*, not
     unbounded), at least one queued victim request was cancelled by
     deadline, and every degraded response names its ladder stage.
  B. **Expired-never-dispatch** — requests whose deadline has already
     passed are cancelled with zero device launches, asserted with the
     ``dispatch_stats()`` spy.
  C. **Degrade determinism** — at a forced pressure level the scheduler
     answers with degraded parameters, the response says so, and the
     answer is bit-identical to calling the index directly at the same
     effective (k, τ0) / τ — degradation changes parameters, never
     kernels.
  D. **Breaker lifecycle** — closed → open (repeated deadline blowouts)
     → rejecting with ``retry_after_ms`` → half-open probing → closed,
     both on a fake clock and through a live scheduler.

Usage: ``PYTHONPATH=src python tools/overload_smoke_torch.py [--smoke]
[--out overload_smoke.json] [--device cuda|cpu]``.  Exit code 0 iff
every gate holds.  Every collection lives on ``--device`` (default
``cuda``); on ``cpu`` the kernels run their plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np

from repro_torch.core.segments import dispatch_stats
from repro_torch.serving import (AdmissionConfig, BreakerConfig, CircuitBreaker,
                           CollectionConfig, DeadlineExceeded, DegradePolicy,
                           OverloadError, Scheduler, SchedulerConfig,
                           SlowDispatchInjector)

L, B = 16, 2
POLICY = DegradePolicy()
# --smoke's stall per victim dispatch.  Its burst of 120 runs as 15
# batches of max_batch 8; at 80 ms a batch the stalls alone take 1.2 s,
# past the 800 ms deadline, so the last queued requests expire (the
# deadline_exceeded >= 1 gate bites) however fast a dispatch is.  At the
# full burst's 40 ms they took 600 ms, and on a card whose dispatches
# are quick nothing expired (ROADMAP F9).
SMOKE_FAULT_S = 0.08


def _corpus(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << B, size=(n, L), dtype=np.uint8)


def _make_sched(device, faults=None, breaker=True, capacity=1024.0,
                max_queue=4096) -> Scheduler:
    # interval_ms=50: escalation needs ~3 interval closes (pops) past a
    # standing queue, and the ladder must engage well inside the
    # deadline even when a loaded CI box stretches the batch period
    return Scheduler(config=SchedulerConfig(
        max_batch=8, max_queue=max_queue, max_wait_ms=1.0,
        admission=AdmissionConfig(cost_capacity=capacity,
                                  interval_ms=50.0),
        degrade=POLICY,
        breaker=BreakerConfig(window=32, min_samples=16, fail_frac=0.5,
                              open_ms=100.0, probes=2) if breaker
        else None), faults=faults, device=device)


# ---------------------------------------------------------------------------
# phase A: 10x burst + slow-dispatch faults, multi-tenant SLO
# ---------------------------------------------------------------------------

def run_burst(n_docs: int = 2048, burst: int = 160, k: int = 10,
              deadline_ms: float = 800.0, fault_s: float = 0.04,
              cotenant_clients: int = 2, cotenant_ops: int = 30,
              seed: int = 0, device="cuda") -> dict:
    """The burst scenario; returns the measured SLO dict (also consumed
    by the JAX package's ``benchmarks.bench_serving``).  The
    burst is ~10× the co-tenant offered load: ``burst`` one-shot
    requests vs ``cotenant_clients * cotenant_ops`` closed-loop ones,
    with every victim dispatch stalled ``fault_s`` seconds."""
    docs = _corpus(n_docs, seed)
    inj = SlowDispatchInjector(delay_s=fault_s, match="execute:victim")
    sched = _make_sched(device, faults=inj)
    sched.create_collection("victim", CollectionConfig(L=L, b=B))
    sched.create_collection("cotenant", CollectionConfig(L=L, b=B))
    f1 = sched.submit_insert("victim", docs)
    f2 = sched.submit_insert("cotenant", docs)
    sched.pump()
    f1.result(), f2.result()
    sched.warmup(ks=(k,))               # compiles never pollute the SLO
    sched.start()

    # victim: open-loop 10x burst under slow-dispatch faults.  Outcomes
    # land via done-callbacks (an open-loop client never waits).
    vic_lock = threading.Lock()
    vic_lat: list = []                  # (seconds, ok, degraded_stage)
    vic_shed = 0
    rng = np.random.default_rng(seed + 1)
    pending = []
    for i in range(burst):
        q = docs[rng.integers(0, n_docs)]
        t0 = time.perf_counter()
        try:
            fut = sched.submit_topk("victim", q, k, deadline_ms=deadline_ms)
        except OverloadError as e:
            assert e.retry_after_ms >= 0.0
            vic_shed += 1
            continue

        def _done(f, t0=t0):
            lat = time.perf_counter() - t0
            exc = f.exception()
            stage = None if exc is not None else f.result().degraded
            ok = exc is None and lat * 1e3 <= deadline_ms
            with vic_lock:
                vic_lat.append((lat, ok, stage))

        fut.add_done_callback(_done)
        pending.append(fut)

    # co-tenants: closed-loop, same deadline, their own collection —
    # the victim's burst must not eat their latency budget
    co_ok, co_total, co_errors = [0], [0], []

    def _cotenant(cid: int) -> None:
        crng = np.random.default_rng(seed + 100 + cid)
        for _ in range(cotenant_ops):
            q = docs[crng.integers(0, n_docs)]
            t0 = time.perf_counter()
            co_total[0] += 1
            try:
                r = sched.submit_topk("cotenant", q, k,
                                      deadline_ms=deadline_ms)
                r.result(timeout=60)
                if (time.perf_counter() - t0) * 1e3 <= deadline_ms:
                    co_ok[0] += 1
            except (DeadlineExceeded, OverloadError):
                pass
            except Exception as e:     # noqa: BLE001
                co_errors.append(e)
                return

    threads = [threading.Thread(target=_cotenant, args=(c,))
               for c in range(cotenant_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    deadline_wall = time.time() + 120
    for fut in pending:
        try:
            fut.result(timeout=max(deadline_wall - time.time(), 1))
        except Exception:              # noqa: BLE001 — outcome recorded
            pass                       # by the done-callback
    sched.stop()
    if co_errors:
        raise co_errors[0]

    snap = sched.stats()
    lats = np.asarray([s for s, _, _ in vic_lat])
    degraded = [st for _, _, st in vic_lat if st is not None]
    out = {
        "burst": burst,
        "victim_shed": vic_shed,
        "victim_completed": len(vic_lat),
        "victim_ok": sum(1 for _, ok, _ in vic_lat if ok),
        "victim_p50_ms": float(np.percentile(lats, 50)) * 1e3,
        "victim_p99_ms": float(np.percentile(lats, 99)) * 1e3,
        "cotenant_total": co_total[0],
        "cotenant_ok": co_ok[0],
        "goodput": co_ok[0] / max(co_total[0], 1),
        "degraded": len(degraded),
        "degraded_frac": len(degraded) / max(len(vic_lat), 1),
        "degraded_stages": sorted(set(degraded)),
        "deadline_exceeded":
            snap["counters"].get("deadline_exceeded_total", 0),
        "breaker_trips": sum(
            d.get("breaker_trips", 0)
            for d in snap.get("overload", {}).values()),
        "stopped_dirty": snap["stopped_dirty"],
    }
    out["victim_p99_ratio"] = out["victim_p99_ms"] \
        / max(out["victim_p50_ms"], 1e-6)
    return out


def check_burst(res: dict) -> None:
    # the SLO (smoke thresholds): co-tenants keep
    # >= 90% goodput and the victim's own tail stays deadline-bounded
    assert res["goodput"] >= 0.9, res
    assert res["victim_p99_ratio"] <= 10.0, res
    assert res["deadline_exceeded"] >= 1, res
    assert res["victim_completed"] + res["victim_shed"] == res["burst"], res
    # the ladder must actually engage (the fault sleep floors the pop
    # cadence, so CoDel reaches shrink_k well inside the deadline) and
    # every degraded answer must name its stage
    assert res["degraded"] >= 1, res
    for stage in res["degraded_stages"]:
        assert stage in POLICY.stages, res
    assert not res["stopped_dirty"], res


# ---------------------------------------------------------------------------
# phase B: expired requests never reach the device
# ---------------------------------------------------------------------------

def run_expired_never_dispatch(n_docs: int = 512, n_req: int = 16,
                               device="cuda") -> dict:
    docs = _corpus(n_docs, 7)
    sched = _make_sched(device, breaker=False)
    sched.create_collection("docs", CollectionConfig(L=L, b=B))
    sched.submit_insert("docs", docs)
    sched.pump()
    futs = [sched.submit_topk("docs", docs[i], 5, deadline_ms=0.01)
            for i in range(n_req)]
    time.sleep(0.01)                    # every budget is now blown
    before = dispatch_stats()
    sched.pump()                        # the dispatch_stats() spy: the
    after = dispatch_stats()            # purge must launch NOTHING
    cancelled = 0
    for f in futs:
        try:
            f.result(timeout=5)
        except DeadlineExceeded as e:
            assert e.retry_after_ms >= 0.0 and e.deadline_ms is not None
            cancelled += 1
    return {"requests": n_req, "cancelled": cancelled,
            "dispatch_delta": after["total"] - before["total"]}


def check_expired(res: dict) -> None:
    assert res["cancelled"] == res["requests"], res
    assert res["dispatch_delta"] == 0, res


# ---------------------------------------------------------------------------
# phase C: degraded answers are labelled and bit-identical
# ---------------------------------------------------------------------------

def run_degrade_identity(n_docs: int = 512, device="cuda") -> dict:
    docs = _corpus(n_docs, 11)
    sched = _make_sched(device, breaker=False)
    sched.create_collection("docs", CollectionConfig(L=L, b=B))
    sched.submit_insert("docs", docs)
    sched.pump()
    idx = sched.registry.get("docs").index
    ctrl = sched._states["docs"].ctrl

    def _force_level(level: int, start: float) -> None:
        # fabricate a sustained standing queue with timestamps far in
        # the future so live pops (which sample near-zero delays at the
        # real clock) can never close an interval underneath the check.
        # The first sample only opens (or flushes) an interval; each of
        # the next ``level`` samples closes one bad interval.
        for i in range(level + 1):
            ctrl.note_delay(0.05, now=start + 0.11 * i)

    far = time.perf_counter() + 1e9
    _force_level(2, far)
    level = ctrl.pressure()
    assert level == 2, level            # rerank_off + shrink_k active

    q = docs[3]
    fut = sched.submit_topk("docs", q, 10)
    sched.pump()
    res = fut.result(timeout=60)
    k_eff, tau0_eff, _, stage = POLICY.apply_topk(level, 10, None, None)
    direct = idx.topk_batch(q[None, :], k_eff, tau0=tau0_eff)
    topk_identical = (res.degraded == stage == "shrink_k"
                      and np.array_equal(res.ids,
                                         direct.ids[0].cpu().numpy())
                      and np.array_equal(res.dists,
                                         direct.dists[0].cpu().numpy()))

    _force_level(3, far + 1000.0)                  # level 3: cheap_tau
    fut = sched.submit_search("docs", q, tau=4)
    sched.pump()                       # NB: draining calls note_empty()
    sres = fut.result(timeout=60)      # which resets pressure to 0, so
    tau_eff, sstage = POLICY.apply_search(3, 4)    # use the forced level
    sdirect = idx.search_batch(q[None, :], tau_eff)
    search_identical = (sres.degraded == sstage == "cheap_tau"
                        and np.array_equal(sres.mask,
                                           sdirect.mask[0].cpu().numpy()))
    degraded_ctr = sched.stats()["counters"].get("degraded_total", 0)
    return {"level": level, "topk_stage": res.degraded,
            "topk_identical": bool(topk_identical),
            "search_stage": sres.degraded,
            "search_identical": bool(search_identical),
            "degraded_total": degraded_ctr}


def check_degrade(res: dict) -> None:
    assert res["topk_identical"], res
    assert res["search_identical"], res
    assert res["degraded_total"] >= 2, res


# ---------------------------------------------------------------------------
# phase D: breaker lifecycle (fake clock + live scheduler)
# ---------------------------------------------------------------------------

def run_breaker_lifecycle(n_docs: int = 256, device="cuda") -> dict:
    # fake-clock state machine: closed -> open -> half_open -> closed
    clock = [0.0]
    br = CircuitBreaker(BreakerConfig(window=8, min_samples=4,
                                      fail_frac=0.5, open_ms=100.0,
                                      probes=2), clock=lambda: clock[0])
    states = [br.state()]
    for _ in range(4):
        br.record(False)
    states.append(br.state())           # tripped open
    allowed, retry = br.allow()
    assert not allowed and retry > 0.0
    clock[0] += 0.15                    # open window elapses
    states.append(br.state())           # half_open
    assert br.allow()[0] and br.allow()[0]      # two probe slots
    assert not br.allow()[0]                    # budget spent
    br.record(True)
    br.record(True)
    states.append(br.state())           # probes succeeded -> closed

    # live scheduler: deadline blowouts trip the collection's breaker,
    # submits shed with retry_after_ms, probing closes it again
    docs = _corpus(n_docs, 13)
    sched = Scheduler(config=SchedulerConfig(
        max_batch=8, max_queue=4096, max_wait_ms=1.0,
        admission=AdmissionConfig(cost_capacity=1024.0),
        breaker=BreakerConfig(window=8, min_samples=4, fail_frac=0.5,
                              open_ms=50.0, probes=2)), device=device)
    sched.create_collection("docs", CollectionConfig(L=L, b=B))
    sched.submit_insert("docs", docs)
    sched.pump()
    for i in range(8):
        sched.submit_topk("docs", docs[i], 5, deadline_ms=0.01)
    time.sleep(0.01)
    sched.pump()                        # purge -> 8 failures -> OPEN
    live_open = sched._states["docs"].breaker.state()
    shed_reason = None
    try:
        sched.submit_topk("docs", docs[0], 5)
    except OverloadError as e:
        shed_reason = e.reason
        assert e.retry_after_ms > 0.0
    time.sleep(0.08)                    # open window elapses
    for _ in range(2):                  # half-open probes succeed
        f = sched.submit_topk("docs", docs[0], 5)
        sched.pump()
        f.result(timeout=60)
    live_closed = sched._states["docs"].breaker.state()
    return {"fake_states": states, "live_open": live_open,
            "shed_reason": shed_reason, "live_closed": live_closed}


def check_breaker(res: dict) -> None:
    assert res["fake_states"] == ["closed", "open", "half_open",
                                  "closed"], res
    assert res["live_open"] == "open", res
    assert res["shed_reason"] == "breaker_open", res
    assert res["live_closed"] == "closed", res


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="smaller corpus/burst, each victim dispatch "
                         "stalled SMOKE_FAULT_S (CI-sized; same gates)")
    ap.add_argument("--out", default=None,
                    help="write the phase reports as JSON here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = args.device

    burst_kw = (dict(n_docs=1024, burst=120, fault_s=SMOKE_FAULT_S)
                if args.smoke else {})
    report = {}
    t0 = time.time()
    report["burst"] = run_burst(device=dev, **burst_kw)
    check_burst(report["burst"])
    print(f"A burst SLO: goodput={report['burst']['goodput']:.3f} "
          f"victim p99/p50={report['burst']['victim_p99_ratio']:.1f} "
          f"deadline_exceeded={report['burst']['deadline_exceeded']} "
          f"degraded={report['burst']['degraded']} "
          f"{report['burst']['degraded_stages']} "
          f"breaker_trips={report['burst']['breaker_trips']}")
    report["expired"] = run_expired_never_dispatch(device=dev)
    check_expired(report["expired"])
    print(f"B expired-never-dispatch: {report['expired']['cancelled']} "
          f"cancelled, dispatch_delta={report['expired']['dispatch_delta']}")
    report["degrade"] = run_degrade_identity(device=dev)
    check_degrade(report["degrade"])
    print(f"C degrade identity: topk stage={report['degrade']['topk_stage']}"
          f" search stage={report['degrade']['search_stage']} "
          f"bit-identical={report['degrade']['topk_identical'] and report['degrade']['search_identical']}")
    report["breaker"] = run_breaker_lifecycle(device=dev)
    check_breaker(report["breaker"])
    print(f"D breaker lifecycle: {' -> '.join(report['breaker']['fake_states'])}"
          f" (live: {report['breaker']['live_open']} -> "
          f"{report['breaker']['live_closed']})")
    print(f"overload smoke: ALL GATES PASS in {time.time() - t0:.1f}s "
          f"on {dev}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
