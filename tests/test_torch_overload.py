"""The port's overload control plane (``repro_torch.serving.overload``
and the scheduler around it) against the JAX package's, on the CPU.

Mirrors ``tests/test_overload.py``: deadlines cancel expired work before
any dispatch; the CoDel-style admission controller, the degradation
ladder and the circuit breaker make the **same decisions as the JAX
package's on the same clock injection** (each step's pressure level,
admit / shed verdict, retry hint, breaker state); degraded answers equal
both an undegraded port run and the JAX scheduler's degraded answer at
the same effective (k, τ0, rerank); ``stop()`` failures are loud;
every new signal round-trips through the strict Prometheus parser.
Tolerance: bit-exact; the retry hints are the same float arithmetic.
"""

import logging
import time

import numpy as np
import pytest

from repro import serving as jserving
from repro.serving import overload as joverload
from repro_torch.core.segments import dispatch_stats
from repro_torch.obs.prom import parse_exposition
from repro_torch.serving import (AdmissionConfig, AdmissionController,
                                 BreakerConfig, CircuitBreaker,
                                 CollectionConfig, DeadlineExceeded,
                                 DegradePolicy, OverloadError, Scheduler,
                                 SchedulerConfig, SlowDispatchInjector)
from repro_torch.serving.overload import estimate_units

L, B = 8, 2


def corpus(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << B, size=(n, L), dtype=np.uint8)


def make_sched(admission=False, degrade=False, breaker=None, faults=None,
               n=64, pkg="torch", **kw):
    cfg = dict(max_batch=4, max_queue=256, max_wait_ms=1.0, breaker=breaker,
               **kw)
    if pkg == "jax":
        sched = jserving.Scheduler(config=jserving.SchedulerConfig(
            admission=(jserving.AdmissionConfig(cost_capacity=1024.0)
                       if admission else None),
            degrade=jserving.DegradePolicy() if degrade else None, **cfg),
            faults=faults)
        sched.create_collection("docs", jserving.CollectionConfig(L=L, b=B))
    else:
        sched = Scheduler(config=SchedulerConfig(
            admission=(AdmissionConfig(cost_capacity=1024.0)
                       if admission else None),
            degrade=DegradePolicy() if degrade else None, **cfg),
            faults=faults, device="cpu")
        sched.create_collection("docs", CollectionConfig(L=L, b=B))
    sched.submit_insert("docs", corpus(n))
    sched.pump()
    return sched


def force_level(ctrl, level):
    """Fabricate a standing queue with timestamps far in the future so
    real pops (near-zero delays at the real clock) can't close a CoDel
    interval underneath the test."""
    start = time.perf_counter() + 1e9
    for i in range(level + 1):
        ctrl.note_delay(0.05, now=start + 0.11 * i)


# -- the same decisions as the JAX package ----------------------------------

def _script(seed, n=600):
    """A scripted stream of controller events at increasing times:
    (t, kind, delay_s, units, queue_len, priority)."""
    rng = np.random.default_rng(seed)
    t, out = 100.0, []
    for _ in range(n):
        t += float(rng.uniform(0.0, 0.02))
        kind = int(rng.choice(5, p=[0.45, 0.22, 0.18, 0.12, 0.03]))
        out.append((t, kind, float(rng.uniform(0.003, 0.03)),
                    float(rng.uniform(0.05, 4.0)), int(rng.integers(0, 8)),
                    int(rng.random() < 0.1)))
    return out


def test_admission_decisions_match_jax_on_the_same_clock():
    """The same event script on both controllers with one injected
    clock: the pressure level, queued units, retry hint and admission
    verdict equal after every step."""
    clock = [0.0]
    cfg = dict(target_delay_ms=5.0, interval_ms=50.0, cost_capacity=12.0,
               min_queue=3, rate_init=64.0, max_level=5)
    ctrls = (AdmissionController(AdmissionConfig(**cfg),
                                 clock=lambda: clock[0]),
             joverload.AdmissionController(joverload.AdmissionConfig(**cfg),
                                           clock=lambda: clock[0]))
    levels = []
    for t, kind, delay, units, qlen, prio in _script(0):
        clock[0] = t
        outs = []
        for c in ctrls:
            if kind == 0:
                c.note_delay(delay)
            elif kind == 1:
                c.on_admit(units)
            elif kind == 2:
                c.on_pop(units)
            elif kind == 3:
                c.note_exec(units, 0.01 + units / 100)
            else:
                c.note_empty()
            outs.append((c.pressure(), c.queued_units(), c.retry_after_ms(),
                         c.admit(units, qlen, priority=prio)))
        assert outs[0] == outs[1], (t, outs)
        levels.append(outs[0][0])
    assert max(levels) >= 2 and ctrls[0].sheds == ctrls[1].sheds > 0


def test_breaker_decisions_match_jax_on_the_same_clock():
    """Outcomes, gates and cancels scripted on one injected clock: both
    breakers walk the same states, trips and retry hints."""
    rng = np.random.default_rng(1)
    clock = [0.0]
    cfg = dict(window=8, fail_frac=0.5, min_samples=4, open_ms=30.0,
               probes=2, backoff=2.0, max_open_ms=200.0)
    brs = (CircuitBreaker(BreakerConfig(**cfg), clock=lambda: clock[0]),
           joverload.CircuitBreaker(joverload.BreakerConfig(**cfg),
                                    clock=lambda: clock[0]))
    states = set()
    for _ in range(800):
        clock[0] += float(rng.uniform(0.0, 0.01))
        kind = int(rng.choice(3, p=[0.5, 0.4, 0.1]))
        ok = bool(rng.random() < 0.55)
        outs = []
        for br in brs:
            if kind == 0:
                r = br.allow()
            elif kind == 1:
                r = br.record(ok)
            else:
                r = br.cancel()
            outs.append((r, br.state(), br.state_code(), br.trips_total))
        assert outs[0] == outs[1]
        states.add(outs[0][1])
    assert states == {"closed", "open", "half_open"}
    assert brs[0].trips_total >= 2


def test_degrade_policy_matches_jax():
    pol, jpol = DegradePolicy(), joverload.DegradePolicy()
    assert pol.reject_level == jpol.reject_level == 4
    for level in range(6):
        for k in (1, 2, 5, 8, 10):
            for tau0 in (None, 0, 1, 3):
                for metric in (None, "jaccard"):
                    assert pol.apply_topk(level, k, tau0, metric) == \
                        jpol.apply_topk(level, k, tau0, metric)
        for tau in (0, 1, 2, 4):
            assert pol.apply_search(level, tau) == \
                jpol.apply_search(level, tau)


def test_estimate_units_match_jax():
    sched, jsched = make_sched(), make_sched(pkg="jax")
    idx = sched.registry.get("docs").index
    jidx = jsched.registry.get("docs").index
    for key, payload in ((("topk", 2, None, None), {}),
                         (("topk", 32, None, "jaccard"), {}),
                         (("search", 3), {}),
                         (("insert",), {"sketches": corpus(5)}),
                         (("delete",), {"ids": np.arange(9)})):
        got = estimate_units(idx, key[0], key, payload)
        assert got == joverload.estimate_units(jidx, key[0], key, payload)
        assert 1 / 16 <= got <= 64


# -- deadlines --------------------------------------------------------------

def test_expired_requests_never_reach_the_device():
    sched = make_sched(admission=True)
    docs = corpus()
    futs = [sched.submit_topk("docs", docs[i], 3, deadline_ms=0.01)
            for i in range(8)]
    time.sleep(0.01)                    # every budget is now blown
    before = dispatch_stats()["total"]
    sched.pump()
    assert dispatch_stats()["total"] == before   # zero launches
    for f in futs:
        with pytest.raises(DeadlineExceeded) as ei:
            f.result(timeout=5)
        assert ei.value.collection == "docs" and ei.value.op == "topk"
        assert ei.value.retry_after_ms >= 0.0
    snap = sched.stats()
    assert snap["counters"]["deadline_exceeded_total"] == 8
    assert snap["counters"]["deadline_exceeded_total:topk"] == 8


def test_live_requests_unaffected_by_expired_neighbours():
    sched = make_sched(admission=True)
    docs = corpus()
    dead = sched.submit_topk("docs", docs[0], 3, deadline_ms=0.01)
    live = sched.submit_topk("docs", docs[1], 3, deadline_ms=60_000.0)
    time.sleep(0.01)
    sched.pump()
    with pytest.raises(DeadlineExceeded):
        dead.result(timeout=5)
    res = live.result(timeout=5)
    direct = sched.registry.get("docs").index.topk_batch(
        docs[1][None, :], 3)
    assert np.array_equal(res.ids, direct.ids[0].numpy())
    assert res.degraded is None


def test_default_deadline_comes_from_collection_config():
    sched = Scheduler(config=SchedulerConfig(max_batch=4, max_queue=256),
                      device="cpu")
    sched.create_collection("docs", CollectionConfig(
        L=L, b=B, default_deadline_ms=0.01))
    sched.submit_insert("docs", corpus())
    sched.pump()
    fut = sched.submit_topk("docs", corpus()[0], 3)   # inherits 0.01ms
    time.sleep(0.01)
    sched.pump()
    with pytest.raises(DeadlineExceeded):
        fut.result(timeout=5)


# -- degradation ladder -----------------------------------------------------

@pytest.mark.parametrize("level", [1, 2, 3])
def test_degraded_answers_match_undegraded_run_and_jax(level):
    """At each forced pressure level: the answer is labelled with the
    deepest stage that changed it, equals an undegraded port call at the
    effective (k, τ0), and equals the JAX scheduler's degraded answer."""
    docs = corpus()
    res = []
    for pkg in ("torch", "jax"):
        sched = make_sched(admission=True, degrade=True, pkg=pkg)
        force_level(sched._states["docs"].ctrl, level)
        fut = sched.submit_topk("docs", docs[3], 8)
        sched.pump()
        res.append(fut.result(timeout=5))
        if pkg == "torch":
            idx = sched.registry.get("docs").index
            pol = sched.config.degrade
            k_eff, tau0_eff, _, stage = pol.apply_topk(level, 8, None, None)
            assert res[0].degraded == stage
            direct = idx.topk_batch(docs[3][None, :], k_eff, tau0=tau0_eff)
            assert np.array_equal(res[0].ids, direct.ids[0].numpy())
            assert np.array_equal(res[0].dists, direct.dists[0].numpy())
            counters = sched.stats()["counters"]
            if stage is None:           # level 1 (rerank_off): a plain
                assert "degraded_total" not in counters   # lookup stays
            else:
                assert counters[f"degraded_total:{stage}"] == 1
    assert res[0].degraded == res[1].degraded
    np.testing.assert_array_equal(res[0].ids, res[1].ids)
    np.testing.assert_array_equal(res[0].dists, res[1].dists)


def test_pressure_reject_sheds_new_work_but_spares_priority():
    sched = make_sched(admission=True, degrade=True)
    docs = corpus()
    state = sched._states["docs"]
    force_level(state.ctrl, sched.config.degrade.reject_level)
    for i in range(state.ctrl.config.min_queue):
        sched.submit_topk("docs", docs[i], 3, priority=1)
    with pytest.raises(OverloadError) as ei:
        sched.submit_topk("docs", docs[0], 3)
    assert ei.value.reason == "pressure"
    assert ei.value.retry_after_ms >= 0.0
    fut = sched.submit_topk("docs", docs[0], 3, priority=1)   # exempt
    sched.pump()
    fut.result(timeout=5)


# -- circuit breaker --------------------------------------------------------

def test_breaker_trips_in_scheduler_and_sheds_with_retry_hint():
    sched = make_sched(admission=True, breaker=BreakerConfig(
        window=8, min_samples=4, fail_frac=0.5, open_ms=50.0, probes=2))
    docs = corpus()
    for i in range(8):
        sched.submit_topk("docs", docs[i], 3, deadline_ms=0.01)
    time.sleep(0.01)
    sched.pump()                       # purge -> 8 failures -> OPEN
    assert sched._states["docs"].breaker.state() == "open"
    with pytest.raises(OverloadError) as ei:
        sched.submit_topk("docs", docs[0], 3)
    assert ei.value.reason == "breaker_open"
    assert ei.value.retry_after_ms > 0.0
    time.sleep(0.08)                   # open window elapses; probes heal
    for _ in range(2):
        f = sched.submit_topk("docs", docs[0], 3)
        sched.pump()
        f.result(timeout=5)
    assert sched._states["docs"].breaker.state() == "closed"


# -- threaded burst + faults ------------------------------------------------

def test_burst_under_faults_keeps_cotenant_clean_threaded():
    inj = SlowDispatchInjector(delay_s=0.02, match="execute:docs:topk")
    sched = make_sched(admission=True, degrade=True, faults=inj)
    sched.create_collection("quiet", CollectionConfig(L=L, b=B))
    sched.submit_insert("quiet", corpus())
    sched.pump()
    docs = corpus()
    sched.start()
    futs = [sched.submit_topk("docs", docs[i % 64], 3, deadline_ms=150.0)
            for i in range(48)]
    ok = err = 0
    for f in futs:
        try:
            f.result(timeout=30)
            ok += 1
        except DeadlineExceeded:
            err += 1
    t0 = time.perf_counter()
    q = sched.submit_topk("quiet", docs[0], 3, deadline_ms=5_000.0)
    q.result(timeout=30)
    assert (time.perf_counter() - t0) < 5.0
    sched.stop()
    assert ok + err == 48 and err >= 1            # faults bit something
    assert inj.fired >= 1
    assert not sched.stopped_dirty


def test_stop_join_failure_is_loud_and_quarantines(caplog):
    inj = SlowDispatchInjector(delay_s=0.5, match="execute:docs")
    sched = make_sched(admission=True, faults=inj, join_timeout_s=0.05)
    docs = corpus()
    sched.start()
    fut = sched.submit_topk("docs", docs[0], 3)   # worker naps 0.5s
    time.sleep(0.05)                              # let it enter the fault
    with caplog.at_level(logging.ERROR,
                         logger="repro_torch.serving.scheduler"):
        sched.stop()
    assert sched.stopped_dirty
    assert sched.stats()["counters"]["stopped_dirty_total"] == 1
    assert any("join" in r.message for r in caplog.records)
    assert sched.pump() == 0           # dirty collections are quarantined
    fut.result(timeout=30)             # the stuck worker still finishes


# -- observability ----------------------------------------------------------

def test_new_signals_round_trip_through_prom_parser():
    sched = make_sched(admission=True, degrade=True,
                       breaker=BreakerConfig())
    docs = corpus()
    dead = sched.submit_topk("docs", docs[0], 3, deadline_ms=0.01)
    time.sleep(0.01)
    force_level(sched._states["docs"].ctrl, 2)
    live = sched.submit_topk("docs", docs[1], 8)
    sched.pump()
    with pytest.raises(DeadlineExceeded):
        dead.result(timeout=5)
    assert live.result(timeout=5).degraded == "shrink_k"
    parsed = parse_exposition(sched.render_stats())
    names = {s[0] for s in parsed["samples"]}
    for family in ("serving_deadline_exceeded_total",
                   "serving_degraded_total", "serving_breaker_state",
                   "serving_pressure_level", "serving_queued_cost_units"):
        assert family in names, (family, sorted(names))
    by = {(s[0], tuple(sorted(s[1].items()))): s[2]
          for s in parsed["samples"]}
    assert by[("serving_breaker_state",
               (("collection", "docs"),))] == 0.0  # closed
    assert by[("serving_pressure_level",
               (("collection", "docs"),))] >= 0.0
