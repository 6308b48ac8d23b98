"""The port's observability against the JAX package's (the bst cases of
``tests/test_obs.py``).

``explain=True`` must give the plain call's bits, and its record must
match the JAX package's on the same seeded numpy inputs: each rung's
``tau``, ``candidates``, ``survivors``, ``pruned``, ``overflow``,
``dispatches`` and ``frontier``, and the request's ``tier`` deltas (with
every block cold, so that they count).  Tracing disabled is a shared
no-op that adds no dispatch; a traced call nests the query path's spans.
The ``repro_torch.obs`` copy (span ring, Chrome export, slow-query log,
Prometheus formatting) gives byte-identical output to ``repro.obs``, and
``cost_hint`` returns the JAX package's floats exactly.  Tolerance:
bit-exact everywhere (wall-clock durations are not compared).
"""

import importlib
import json

import numpy as np
import pytest

from repro import obs as jobs
from repro.core import column_store as jcs
from repro.core import segments as jseg
from repro.core.hamming import pack_sets
from repro_torch import obs as tobs
from repro_torch.core import column_store as tcs
from repro_torch.core import segments as tseg
from repro_torch.obs.trace import _NULL, current

L, B = 12, 2
RNG = np.random.default_rng(7)
SKETCHES = RNG.integers(0, 1 << B, size=(180, L), dtype=np.uint8)
SETS = [RNG.choice(64, size=9, replace=False) for _ in range(len(SKETCHES))]
PAYS = pack_sets(SETS, 64)
QUERIES = SKETCHES[[11, 40, 99]]
RUNG_FIELDS = ("tau", "candidates", "survivors", "pruned", "overflow",
               "dispatches", "frontier")


def both(**kw):
    """The same index in both packages: 180 rows, two sealed segments and
    a live delta buffer."""
    out = []
    for pkg in (jseg, tseg):
        extra = {} if pkg is jseg else dict(device="cpu")
        idx = pkg.SegmentedIndex(L=L, b=B, delta_cap=64, auto_merge=False,
                                 **kw, **extra)
        for lo in range(0, len(SKETCHES), 64):      # flushes at 64 rows
            pays = (dict(payloads=PAYS[lo:lo + 64])
                    if "payload_words" in kw else {})
            idx.insert(SKETCHES[lo:lo + 64], **pays)
        out.append(idx)
    return out


def np_(x):
    return np.asarray(x)


def same_record(jex, tex):
    """The deterministic fields of two QueryExplain records."""
    for f in ("op", "backend", "n_queries", "n_live", "k", "tau0",
              "tau_final", "rerank", "rerank_survivors", "dispatch",
              "tier"):
        assert getattr(tex, f) == getattr(jex, f), f
    assert len(tex.rungs) == len(jex.rungs)
    for jr, tr in zip(jex.rungs, tex.rungs):
        for f in RUNG_FIELDS:
            assert getattr(tr, f) == getattr(jr, f), f
    assert tex.summary() == jex.summary()


@pytest.mark.parametrize("cold", [False, True])
def test_explain_topk_matches_jax(cold):
    kw = dict(hot_bytes=0) if cold else {}
    jidx, tidx = both(**kw)
    assert len(tidx.segments) == 2 and len(tidx._delta_ids) > 0
    for pkg, cs, idx in ((jseg, jcs, jidx), (tseg, tcs, tidx)):
        idx.topk_batch(QUERIES, 4)                  # build the programs
    recs = []
    for pkg, cs, idx in ((jseg, jcs, jidx), (tseg, tcs, tidx)):
        plain = idx.topk_batch(QUERIES, 4)
        cs.reset_tier_stats()
        res, ex = idx.topk_batch(QUERIES, 4, explain=True)
        np.testing.assert_array_equal(np_(res.ids), np_(plain.ids))
        np.testing.assert_array_equal(np_(res.dists), np_(plain.dists))
        assert res.tau == plain.tau and res.overflow == plain.overflow
        recs.append((res, ex))
    (jres, jex), (tres, tex) = recs
    np.testing.assert_array_equal(np_(tres.ids), np_(jres.ids))
    same_record(jex, tex)
    assert tex.rungs[-1].frontier is not None
    assert len(tex.rungs[-1].frontier[0]) == L
    assert (tex.tier["prefetches"] > 0) == cold
    assert set(tex.cache) == {"hits", "misses", "traces"}
    one, one_ex = tidx.topk(QUERIES[0], k=4, explain=True)
    assert one_ex.n_queries == 1 and one.ids.shape == (4,)


def test_explain_search_and_batch_match_jax():
    jidx, tidx = both()
    for call in ("search_batch", "search_columns_batch"):
        recs = []
        for idx in (jidx, tidx):
            plain = getattr(idx, call)(QUERIES, tau=3)
            res, ex = getattr(idx, call)(QUERIES, tau=3, explain=True)
            np.testing.assert_array_equal(np_(res.mask), np_(plain.mask))
            np.testing.assert_array_equal(np_(res.dist), np_(plain.dist))
            recs.append((res, ex))
        (jres, jex), (tres, tex) = recs
        np.testing.assert_array_equal(np_(tres.dist), np_(jres.dist))
        same_record(jex, tex)
        assert tex.op == "search" and tex.tau0 == 3
        np.testing.assert_array_equal(np_(tex.rungs[-1].survivors),
                                      np_(tres.mask).sum(axis=1))
    res, ex = tidx.search(QUERIES[0], tau=2, explain=True)
    assert ex.n_queries == 1 and res.mask.shape == (tidx.n_ids,)


def test_explain_rerank_matches_jax():
    jidx, tidx = both(payload_words=PAYS.shape[1])
    qp = PAYS[[11, 40, 99]]
    recs = []
    for idx in (jidx, tidx):
        plain = idx.topk_batch(QUERIES, 4, rerank="jaccard", q_payloads=qp)
        res, ex = idx.topk_batch(QUERIES, 4, rerank="jaccard",
                                 q_payloads=qp, explain=True)
        np.testing.assert_array_equal(np_(res.ids), np_(plain.ids))
        np.testing.assert_array_equal(np_(res.scores).view(np.int32),
                                      np_(plain.scores).view(np.int32))
        recs.append((res, ex))
    (jres, jex), (tres, tex) = recs
    np.testing.assert_array_equal(np_(tres.scores), np_(jres.scores))
    same_record(jex, tex)
    assert tex.rerank == "jaccard"
    assert tex.rerank_survivors == tex.rungs[-1].survivors


def test_span_disabled_is_shared_noop():
    assert current() is None
    assert tobs.span("anything", cat="x", a=1) is _NULL
    with tobs.span("nested"):
        pass
    assert current() is None


def test_tracing_adds_no_dispatch_and_nests_the_spans():
    """Spans are host wall-clock timers only: a traced call dispatches
    exactly what the plain call does and returns the same bits; the
    cold tier's staging shows as its own spans."""
    _, tidx = both(hot_bytes=0, payload_words=PAYS.shape[1])
    qp = PAYS[[11, 40, 99]]
    tidx.topk_batch(QUERIES, 4)
    for extra in ({}, dict(rerank="jaccard", q_payloads=qp)):
        d0 = tseg.dispatch_stats()
        plain = tidx.topk_batch(QUERIES, 4, **extra)
        d1 = tseg.dispatch_stats()
        root = tobs.Span("request")
        with tobs.attach(root):
            traced = tidx.topk_batch(QUERIES, 4, **extra)
        d2 = tseg.dispatch_stats()
        assert {k: d2[k] - d1[k] for k in d2} == {k: d1[k] - d0[k]
                                                  for k in d1}
        np.testing.assert_array_equal(np_(traced.ids), np_(plain.ids))
        names = {"rung_dispatch", "tier_stage",
                 "topk_readback" if not extra else "rerank"}
        if extra:
            names.add("tier_stage_payloads")
        for name in names:
            assert root.find(name) is not None, name
        sp = root.find("tier_stage")
        assert sp.args["bytes"] > 0 and sp.args["blocks"] == 2
    root = tobs.Span("request")
    tidx.use_arena = False
    with tobs.attach(root):
        tidx.search_columns_batch(QUERIES, 2)
    assert root.find("segment_fanout") is not None
    assert root.find("delta_scan").args == {"rows": len(tidx._delta_ids)}


def span_tree():
    """The same span tree for both packages, with fixed clocks."""
    trees = []
    for mod in (jobs, tobs):
        root = mod.Span("request", ts=1.0, dur=0.25, args={"op": "topk"})
        batch = mod.Span("batch", ts=1.01, dur=0.2, track="worker-0")
        root.children.append(batch)
        ch = batch.child("rung_dispatch", cat="device", tau=3, rung=0)
        ch.ts, ch.dur = 1.02, 0.0123456
        other = mod.Span("request", ts=1.5, dur=0.125)
        other.children.append(batch)
        trees.append((root, other))
    return trees


def test_chrome_ring_and_slowlog_byte_identical(tmp_path):
    (jr, jo), (tr, to) = span_tree()
    assert json.dumps(tobs.chrome_trace([tr, to])) == json.dumps(
        jobs.chrome_trace([jr, jo]))
    assert tobs.span_to_dict(tr) == jobs.span_to_dict(jr)
    rings = []
    for mod in (jobs, tobs):
        ring = mod.Tracer(capacity=4)
        for i in range(10):
            ring.add(mod.Span(f"r{i}", ts=float(i), dur=0.5))
        rings.append(ring)
        assert [s.name for s in ring.roots()] == ["r6", "r7", "r8", "r9"]
    paths = [tmp_path / "j.json", tmp_path / "t.json"]
    for ring, p in zip(rings, paths):
        ring.write_chrome(str(p))
    assert paths[0].read_bytes() == paths[1].read_bytes()
    logs = []
    for mod, root, name in ((jobs, jr, "j"), (tobs, tr, "t")):
        path = tmp_path / f"slow_{name}.jsonl"
        log = mod.SlowQueryLog(capacity=2, path=str(path))
        for _ in range(3):
            log.record(root, op="topk")
        assert len(log) == 2 and log.dropped == 1
        logs.append([json.loads(x) for x in path.read_text().splitlines()])
    for a, b in zip(*logs):
        a.pop("time_unix"), b.pop("time_unix")
        assert a == b


def test_prometheus_formatting_byte_identical():
    for v in (0, 3, -17, 0.1, 0.30000000000000004, 1e-9, 2.5, 3.0, True,
              float("inf"), float("-inf"), float("nan")):
        assert tobs.format_value(v) == jobs.format_value(v)
    lines = []
    for mod in (jobs, tobs):
        h = mod.Histogram(buckets=(0.001, 0.01, 0.1))
        for v in (0.0005, 0.005, 0.05, 0.5, 0.05):
            h.observe(v)
        lines.append(h.sample_lines("lat", 'op="topk"'))
    assert lines[0] == lines[1]
    text = "# TYPE lat histogram\n" + "\n".join(lines[1]) + "\n"
    assert tobs.parse_exposition(text) == jobs.parse_exposition(text)
    with pytest.raises(ValueError):
        tobs.parse_exposition("orphan_sample 1\n")


def test_cost_hint_matches_jax_exactly():
    jidx, tidx = both()
    tidx.delete([1, 2, 3])
    jidx.delete([1, 2, 3])
    for op, kw in (("topk", dict(k=1)), ("topk", dict(k=10)),
                   ("topk", {}), ("search", dict(tau=0)),
                   ("search", dict(tau=3)), ("search", dict(tau=99)),
                   ("search", {}), ("write", dict(rows=1)),
                   ("write", dict(rows=500))):
        assert tidx.cost_hint(op, **kw) == jidx.cost_hint(op, **kw), (op, kw)
    empty = tseg.SegmentedIndex(L, B, device="cpu")
    assert empty.cost_hint("topk", k=4) == jseg.SegmentedIndex(
        L, B).cost_hint("topk", k=4)


def test_traces_count_fused_builds():
    ts = importlib.import_module("repro_torch.core.search")
    tseg.clear_fused_cache()
    ts.clear_searcher_cache()
    _, tidx = both()
    tidx.topk_batch(QUERIES, 4)
    built = ts.searcher_cache_info()["traces"]
    assert built >= 1
    tidx.topk_batch(QUERIES, 4)
    assert ts.searcher_cache_info()["traces"] == built
    _, ex = tidx.topk_batch(QUERIES, 4, explain=True)
    assert ex.cache["traces"] >= 1                   # the width program
