"""The port's serving runtime (``repro_torch.serving``) against the JAX
package's, on the CPU.

Mirrors ``tests/test_serving.py``: the same seeded request streams —
interleaved inserts, deletes, range and top-k lookups, two-stage
``rerank=`` lookups — go through ``repro.serving.Scheduler`` and
``repro_torch.serving.Scheduler(device="cpu")``, and every response
(ids, distances, masks, float32 score bits, insert ids, delete counts)
must be equal, and equal to the port's own sequential execution; the
batch counts, bucket fill, write fences and overload rejections must
match; after ``warmup`` a varying-size stream builds no program;
``render_stats()`` carries the JAX package's metric families with the
same request, batch, dispatch and index values.  The ``cuda`` cases run
a cold collection under ``start()`` and a recovery on the card.
Tolerance: bit-exact.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # clean env: deterministic fallback shim
    from _hypothesis_compat import given, settings, st

from repro import serving as jserving
from repro.obs.prom import parse_exposition as jparse
from repro_torch.core import (SegmentedIndex, clear_searcher_cache,
                              searcher_cache_info)
from repro_torch.core.hamming import pack_sets
from repro_torch.obs.prom import parse_exposition
from repro_torch.serving import (CollectionConfig, CollectionRegistry,
                                 OverloadError, Scheduler, SchedulerConfig,
                                 bucket_table)

L, B, TAU, K = 10, 2, 2, 3


def make_stream(rnd, n_ops=18):
    """The stream generator of tests/test_serving.py: a bootstrap corpus
    insert, then mixed reads/writes.  Returns [(op, payload), ...]."""
    rng = np.random.default_rng(rnd.randint(0, 2**31))
    corpus = rng.integers(0, 1 << B, size=(24, L), dtype=np.uint8)
    stream = [("insert", corpus)]
    n_inserted = len(corpus)
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.55:
            q = corpus[rng.integers(0, len(corpus))] if rng.random() < 0.7 \
                else rng.integers(0, 1 << B, size=L, dtype=np.uint8)
            stream.append(("search", q) if rng.random() < 0.5
                          else ("topk", q))
        elif r < 0.8:
            rows = rng.integers(0, 1 << B,
                                size=(int(rng.integers(1, 4)), L),
                                dtype=np.uint8)
            stream.append(("insert", rows))
            n_inserted += len(rows)
        else:
            stream.append(
                ("delete", rng.integers(0, n_inserted, size=2)))
    return stream


def run_sequential(stream):
    """The oracle: every request alone, in order, on a fresh port index."""
    idx = SegmentedIndex(L, B, delta_cap=16, device="cpu")
    out = []
    for op, payload in stream:
        if op == "insert":
            out.append(idx.insert(payload))
        elif op == "delete":
            out.append(idx.delete(payload))
        elif op == "search":
            res = idx.search(payload, TAU)
            out.append((res.mask.numpy(), res.dist.numpy()))
        else:
            nn = idx.topk(payload, K)
            out.append((nn.ids.numpy(), nn.dists.numpy()))
    return out


def submit_stream(sched, stream):
    futs = []
    for op, payload in stream:
        if op == "insert":
            futs.append(sched.submit_insert("c", payload))
        elif op == "delete":
            futs.append(sched.submit_delete("c", payload))
        elif op == "search":
            futs.append(sched.submit_search("c", payload, TAU))
        else:
            futs.append(sched.submit_topk("c", payload, K))
    return futs


def check_same(stream, got_futs, want_futs):
    """Each port response equals the JAX scheduler's, field by field."""
    for (op, _), fut, ref in zip(stream, got_futs, want_futs):
        got, want = fut.result(timeout=300), ref.result(timeout=300)
        if op == "insert":
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        elif op == "delete":
            assert got == want
        elif op == "search":
            assert got.mask.dtype == want.mask.dtype == np.bool_
            np.testing.assert_array_equal(got.mask, want.mask)
            np.testing.assert_array_equal(got.dist, want.dist)
            assert (got.overflow, got.degraded) == (want.overflow,
                                                    want.degraded)
        else:
            np.testing.assert_array_equal(got.ids, want.ids)
            np.testing.assert_array_equal(got.dists, want.dists)
            assert (got.tau, got.overflow, got.degraded) == (
                want.tau, want.overflow, want.degraded)


def check_results(stream, futs, want):
    for (op, _), fut, ref in zip(stream, futs, want):
        got = fut.result(timeout=300)
        if op == "insert":
            np.testing.assert_array_equal(got, ref)
        elif op == "delete":
            assert got == ref
        elif op == "search":
            np.testing.assert_array_equal(got.mask, ref[0])
            np.testing.assert_array_equal(got.dist, ref[1])
        else:
            np.testing.assert_array_equal(got.ids, ref[0])
            np.testing.assert_array_equal(got.dists, ref[1])


def sched_cfg(**kw):
    cfg = dict(max_batch=8, max_queue=10_000, max_wait_ms=1.0)
    cfg.update(kw)
    return cfg


def make_sched(**kw):
    sched = Scheduler(config=SchedulerConfig(**sched_cfg(**kw)),
                      device="cpu")
    sched.create_collection("c", CollectionConfig(L=L, b=B, delta_cap=16))
    return sched


def make_jsched(**kw):
    sched = jserving.Scheduler(config=jserving.SchedulerConfig(
        **sched_cfg(**kw)))
    sched.create_collection("c", jserving.CollectionConfig(
        L=L, b=B, delta_cap=16))
    return sched


# ---------------------------------------------------------------------------
# the core property: the port's scheduler answers as the JAX package's
# ---------------------------------------------------------------------------

@settings(max_examples=3, deadline=None)
@given(st.randoms())
def test_interleaved_stream_matches_jax_scheduler(rnd):
    stream = make_stream(rnd)
    jsched, sched = make_jsched(), make_sched()
    jfuts = submit_stream(jsched, stream)
    futs = submit_stream(sched, stream)     # whole stream queued at once
    assert sched.pump() == jsched.pump()    # the same batches
    check_same(stream, futs, jfuts)
    check_results(stream, futs, run_sequential(stream))
    assert (sched.stats()["counters"] == jsched.stats()["counters"])


def test_incremental_pumping_matches_jax():
    """Draining the queue in arbitrary chunks (pump between submits)
    changes no result in either package."""
    import random
    stream = make_stream(random.Random(7), n_ops=12)
    jsched, sched = make_jsched(), make_sched()
    futs, jfuts = [], []
    for i, item in enumerate(stream):
        futs.extend(submit_stream(sched, [item]))
        jfuts.extend(submit_stream(jsched, [item]))
        if i % 3 == 0:
            sched.pump()
            jsched.pump()
    sched.pump()
    jsched.pump()
    check_same(stream, futs, jfuts)


def test_threaded_mode_matches_sequential():
    """The worker thread + max-wait flush (single producer, so the
    submission order is still deterministic)."""
    import random
    stream = make_stream(random.Random(11), n_ops=10)
    want = run_sequential(stream)
    sched = make_sched(max_wait_ms=5.0).start()
    futs = submit_stream(sched, stream)
    check_results(stream, futs, want)
    sched.stop()
    assert sched.queue_depth() == 0


# ---------------------------------------------------------------------------
# batching mechanics
# ---------------------------------------------------------------------------

def test_reads_coalesce_into_one_bucketed_dispatch():
    rng = np.random.default_rng(1)
    docs = rng.integers(0, 1 << B, size=(30, L), dtype=np.uint8)
    snaps = []
    for sched in (make_sched(), make_jsched()):
        sched.submit_insert("c", docs)
        futs = [sched.submit_search("c", docs[i], TAU) for i in range(5)]
        sched.pump()
        snaps.append(sched.stats())
        hits = [int(f.result().mask[i]) for i, f in enumerate(futs)]
        assert hits == [1] * 5              # each query finds itself
    # 5 same-key reads -> ONE dispatch, padded 5 -> bucket 8
    for snap in snaps:
        assert snap["counters"]["batches_total:search"] == 1
        assert snap["batch_fill_ratio"] == pytest.approx(5 / 8)
    assert snaps[0]["device_dispatch"] == snaps[1]["device_dispatch"]


def test_bucket_padding_rows_never_reach_a_response():
    """A batch of g is padded to bucket_m(g) by repeating the last query;
    the responses are the g real rows, sliced on the host once per
    plane, equal to the JAX package's and to single-query calls."""
    rng = np.random.default_rng(12)
    docs = rng.integers(0, 1 << B, size=(40, L), dtype=np.uint8)
    qs = rng.integers(0, 1 << B, size=(11, L), dtype=np.uint8)
    out = []
    for sched in (make_sched(max_batch=16), make_jsched(max_batch=16)):
        sched.submit_insert("c", docs)
        sched.pump()
        ft = [sched.submit_topk("c", q, 4) for q in qs]
        fs = [sched.submit_search("c", q, 3) for q in qs]
        sched.pump()
        assert sched.stats()["batch_fill_ratio"] == pytest.approx(22 / 32)
        out.append(([f.result() for f in ft], [f.result() for f in fs]))
    idx = SegmentedIndex(L, B, delta_cap=16, device="cpu")
    idx.insert(docs)
    for i, q in enumerate(qs):
        pt, jt = out[0][0][i], out[1][0][i]
        ps, js = out[0][1][i], out[1][1][i]
        one = idx.topk(q, 4)
        for got in (pt, jt):
            np.testing.assert_array_equal(got.ids, one.ids.numpy())
            np.testing.assert_array_equal(got.dists, one.dists.numpy())
        np.testing.assert_array_equal(ps.mask, js.mask)
        np.testing.assert_array_equal(ps.dist, js.dist)
        assert ps.mask.shape == (40,)


def test_mixed_key_reads_split_into_separate_batches():
    rng = np.random.default_rng(2)
    sched = make_sched()
    docs = rng.integers(0, 1 << B, size=(20, L), dtype=np.uint8)
    sched.submit_insert("c", docs)
    f1 = [sched.submit_search("c", docs[i], 1) for i in range(2)]
    f2 = [sched.submit_search("c", docs[i], 2) for i in range(2)]
    f3 = [sched.submit_topk("c", docs[i], K) for i in range(2)]
    sched.pump()
    snap = sched.stats()
    assert snap["counters"]["batches_total:search"] == 2   # tau=1 and tau=2
    assert snap["counters"]["batches_total:topk"] == 1
    for i, f in enumerate(f1 + f2):
        assert int(f.result().mask[i % 2]) == 1
    for i, f in enumerate(f3):
        assert int(f.result().ids[0]) == i


def test_write_fences_reads():
    """A read submitted before a write must not observe it; a read after
    must."""
    sched = make_sched()
    base = np.zeros((4, L), np.uint8)
    sched.submit_insert("c", base)
    probe = np.full(L, 1, np.uint8)
    before = sched.submit_search("c", probe, 0)
    sched.submit_insert("c", probe[None])           # exact match lands
    after = sched.submit_search("c", probe, 0)
    sched.pump()
    assert before.result().mask.sum() == 0          # pre-insert state
    assert after.result().mask.sum() == 1
    assert after.result().mask.shape[0] == 5        # plane grew


def test_overload_rejection_and_context():
    sched = make_sched(max_queue=3)
    q = np.zeros(L, np.uint8)
    for _ in range(3):
        sched.submit_search("c", q, TAU)
    with pytest.raises(OverloadError) as ei:
        sched.submit_topk("c", q, K)
    assert (ei.value.collection, ei.value.op, ei.value.queue_depth) == (
        "c", "topk", 3)
    with pytest.raises(OverloadError):
        sched.submit_delete("c", np.asarray([0], np.int64))
    counters = sched.stats()["counters"]
    assert counters["rejected_total"] == 2
    assert counters["rejected_total:topk"] == 1
    assert counters["rejected_total:delete"] == 1
    assert 'serving_rejected_total{op="topk"} 1' in sched.render_stats()
    assert sched.queue_depth("c") == 3
    sched.pump()                                    # queued work drains
    assert sched.queue_depth("c") == 0


def test_collection_registry_errors():
    sched = make_sched()
    with pytest.raises(KeyError):
        sched.submit_search("nope", np.zeros(L, np.uint8), 1)
    with pytest.raises(ValueError):
        sched.create_collection("c", CollectionConfig(L=L, b=B))
    assert sched.registry.names() == ["c"]
    assert bucket_table(8) == [1, 2, 4, 8]


def test_collection_config_has_no_device_field():
    """collection.json is ``asdict(CollectionConfig)`` in both packages:
    the same fields and defaults, no device among them; the device sits
    on the registry, and the scheduler's default registry takes it."""
    tf = [(f.name, f.default) for f in dataclasses.fields(CollectionConfig)]
    jf = [(f.name, f.default)
          for f in dataclasses.fields(jserving.CollectionConfig)]
    assert tf == jf
    assert "device" not in dict(tf)
    sched = Scheduler(device="cpu")
    assert sched.registry.device == torch.device("cpu")
    coll = sched.create_collection("x", CollectionConfig(L=8, b=2))
    assert coll.index.device == torch.device("cpu")
    reg = CollectionRegistry(device="cpu")
    assert Scheduler(registry=reg).registry is reg


def test_scheduler_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Scheduler()


# ---------------------------------------------------------------------------
# steady state: after warmup, varying-m traffic builds nothing
# ---------------------------------------------------------------------------

def test_varying_batch_stream_zero_new_builds_after_warmup():
    rng = np.random.default_rng(3)
    sched = make_sched()
    docs = rng.integers(0, 1 << B, size=(64, L), dtype=np.uint8)
    ids = sched.submit_insert("c", docs)
    sched.pump()
    ids = ids.result()
    idx = sched.registry.get("c").index
    idx.flush()                       # single sealed segment, empty delta

    def burst(sizes, offset):
        for g in sizes:
            futs = [sched.submit_search("c", docs[(offset + j) % 60], TAU)
                    for j in range(g)]
            futs += [sched.submit_topk("c", docs[(offset + j) % 60], 1,
                                       tau0=TAU) for j in range(g)]
            sched.pump()
            for f in futs:
                f.result(timeout=300)

    clear_searcher_cache()
    rep = sched.warmup(ks=(1,), taus=(TAU,))
    assert rep["buckets"] == 4 and rep["calls"] == 8 and rep["traces"] >= 1
    burst((1, 2, 4, 8), offset=0)
    sched.submit_delete("c", ids[60:62])        # tombstones are data
    sched.pump()
    warm = searcher_cache_info()
    burst((1, 3, 5, 2, 7, 8, 4, 6), offset=5)   # varying-m steady state
    sched.submit_delete("c", ids[62:64])
    sched.pump()
    burst((8, 1, 6, 3), offset=11)
    info = searcher_cache_info()
    assert info["misses"] == warm["misses"], (warm, info)
    assert info["traces"] == warm["traces"], (warm, info)
    assert info["hits"] > warm["hits"]


def test_warmup_covers_rerank_and_is_idempotent():
    """With ``reranks=`` the re-rank programs are built too: a re-rank
    stream after the warmup builds nothing."""
    rng, sk, pays = _rerank_fixture(31)
    sched = make_rerank_sched()
    sched.submit_insert("r", sk, pays)
    sched.pump()
    clear_searcher_cache()
    rep = sched.warmup(collection="r", ks=(K,), reranks=("jaccard",))
    assert rep["calls"] == 2 * rep["buckets"] and rep["traces"] >= 2
    assert sched.warmup(collection="r", ks=(K,),
                        reranks=("jaccard",))["traces"] == 0
    before = searcher_cache_info()["traces"]
    for g in (1, 5, 8, 3):
        futs = [sched.submit_topk("r", sk[i], K, rerank="jaccard",
                                  q_payload=pays[i]) for i in range(g)]
        sched.pump()
        for i, f in enumerate(futs):
            assert int(f.result().ids[0]) == i
    assert searcher_cache_info()["traces"] == before
    sched.create_collection("empty", CollectionConfig(L=L, b=B))
    assert sched.warmup(collection="empty")["calls"] == 0


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _families(text, parse):
    parsed = parse(text)
    samples = {}
    for name, labels, value in parsed["samples"]:
        samples[(name, tuple(sorted(labels.items())))] = value
    return samples


def test_render_stats_same_families_and_counts_as_jax():
    """The same traffic through both schedulers: the same metric
    families and label sets; equal request, batch, write, maintenance,
    dispatch, tier and index values (latencies and the searcher cache's
    build counts are each package's own)."""
    rng = np.random.default_rng(4)
    docs = rng.integers(0, 1 << B, size=(40, L), dtype=np.uint8)
    texts = []
    for sched, parse in ((make_sched(), parse_exposition),
                         (make_jsched(), jparse)):
        sched.metrics.rebaseline()
        sched.submit_insert("c", docs[:20])
        for i in range(3):
            sched.submit_topk("c", docs[i], K)
        sched.submit_search("c", docs[0], TAU)
        sched.submit_delete("c", np.asarray([1, 2], np.int64))
        sched.submit_insert("c", docs[20:])
        sched.submit_topk("c", docs[30], K)
        sched.pump()
        texts.append(_families(sched.render_stats(), parse))
    port, jax = texts
    assert set(port) == set(jax)
    noisy = ("latency", "searcher_cache_")
    for key, value in jax.items():
        if not any(n in key[0] for n in noisy):
            assert port[key] == value, key
    assert port[("serving_requests_total", (("op", "topk"),))] == 4
    assert port[("index_n_live", (("collection", "c"),))] == 38


def test_metrics_snapshot_and_text_dump():
    sched = make_sched()
    rng = np.random.default_rng(4)
    docs = rng.integers(0, 1 << B, size=(16, L), dtype=np.uint8)
    sched.submit_insert("c", docs)
    for i in range(3):
        sched.submit_topk("c", docs[i], K)
    sched.pump()
    snap = sched.stats()
    assert snap["counters"]["requests_total:topk"] == 3
    assert snap["latency"]["topk"]["count"] == 3
    assert snap["exec_latency"]["topk"]["count"] == 1
    assert snap["latency"]["topk"]["p99_ms"] >= \
        snap["latency"]["topk"]["p50_ms"]
    assert snap["queue_depth"]["c"] == 0
    assert snap["collections"]["c"]["n_live"] == 16
    text = sched.render_stats()
    for needle in ('serving_requests_total{op="topk"} 3',
                   'serving_latency_p99_ms{op="topk"}',
                   'index_n_live{collection="c"} 16',
                   "serving_batch_fill_ratio",
                   "searcher_cache_traces"):
        assert needle in text, needle


def test_executor_exception_fails_batch_but_worker_survives():
    rng = np.random.default_rng(6)
    sched = make_sched().start()
    docs = rng.integers(0, 1 << B, size=(8, L), dtype=np.uint8)
    sched.submit_insert("c", docs).result(timeout=300)
    bad = np.full((2, L), 1 << B, np.uint8)         # character out of Σ
    with pytest.raises(ValueError):
        sched.submit_insert("c", bad).result(timeout=300)
    nn = sched.submit_topk("c", docs[0], 1).result(timeout=300)
    assert int(nn.dists[0]) == 0
    snap = sched.stats()
    assert snap["counters"]["executor_errors_total"] == 1
    assert snap["collections"]["c"]["n_live"] == 8  # bad rows never landed
    sched.stop()


def test_counters_and_caches_survive_threaded_hammering():
    """The dispatch counters, one ServingMetrics and the searcher cache's
    counters are bumped from every worker thread: nothing is lost, and
    the program caches stay consistent under concurrent builds."""
    import importlib
    tsearch = importlib.import_module("repro_torch.core.search")
    from repro_torch.core.segments import _dispatch, dispatch_stats
    from repro_torch.serving.metrics import ServingMetrics
    m = ServingMetrics()
    before = dispatch_stats()
    c0 = searcher_cache_info()
    per_thread, n_threads = 400, 8

    def hammer(_):
        for i in range(per_thread):
            _dispatch("fused")
            tsearch._note_trace()
            m.inc("stress_total")
            m.record_latency("op", 1e-3)
            m.record_batch("op", 1, 2)
            if i % 100 == 0:
                m.snapshot()

    threads = [threading.Thread(target=hammer, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    total = per_thread * n_threads
    after = dispatch_stats()
    assert after["total"] - before["total"] == total
    assert after["fused"] - before["fused"] == total
    assert searcher_cache_info()["traces"] - c0["traces"] == total
    snap = m.snapshot()
    assert snap["counters"]["stress_total"] == total
    assert snap["counters"]["batches_total:op"] == total
    assert snap["latency"]["op"]["count"] == total
    assert m.batch_fill_ratio() == pytest.approx(0.5)


def test_two_collections_served_by_two_workers():
    """One worker per collection, each building and reading its own
    programs at the same time: every answer equals the sequential one."""
    rng = np.random.default_rng(8)
    sched = make_sched(max_wait_ms=2.0)
    sched.create_collection("d", CollectionConfig(L=L, b=B, delta_cap=8))
    docs = rng.integers(0, 1 << B, size=(48, L), dtype=np.uint8)
    sched.start()
    for name in ("c", "d"):
        sched.submit_insert(name, docs).result(timeout=300)
    futs = {name: [sched.submit_topk(name, docs[i], K, tau0=t)
                   for t in (0, 1, 2, 3) for i in range(12)]
            for name in ("c", "d")}
    idx = SegmentedIndex(L, B, delta_cap=8, device="cpu")
    idx.insert(docs)
    for name, fs in futs.items():
        for j, f in enumerate(fs):
            want = idx.topk(docs[j % 12], K, tau0=j // 12)
            got = f.result(timeout=300)
            np.testing.assert_array_equal(got.ids, want.ids.numpy())
            np.testing.assert_array_equal(got.dists, want.dists.numpy())
    sched.stop()


# ---------------------------------------------------------------------------
# two-stage re-rank requests
# ---------------------------------------------------------------------------

RVOCAB = 64
RWP = (RVOCAB + 31) // 32


def _rerank_fixture(seed, n_docs=30):
    rng = np.random.default_rng(seed)
    sk = rng.integers(0, 1 << B, size=(n_docs, L), dtype=np.uint8)
    sets = [rng.choice(RVOCAB, size=int(rng.integers(2, 12)), replace=False)
            for _ in range(n_docs)]
    return rng, sk, pack_sets(sets, RVOCAB)


def make_rerank_sched(**kw):
    sched = make_sched(**kw)
    sched.create_collection(
        "r", CollectionConfig(L=L, b=B, delta_cap=16, payload_words=RWP))
    return sched


def test_mixed_rerank_and_plain_stream_matches_jax():
    """Interleaved ``rerank=`` / plain top-k traffic plus writes: ids,
    dists and the exact scores' float32 bits equal the JAX scheduler's;
    plain responses carry no scores."""
    rng, sk, pays = _rerank_fixture(19)
    stream = [("insert", sk[:20], pays[:20])]
    for i in range(12):
        if i % 4 == 3:
            stream.append(("insert", sk[20 + i // 4:21 + i // 4],
                           pays[20 + i // 4:21 + i // 4]))
        elif i % 3 == 0:
            stream.append(("topk", sk[i]))
        else:
            metric = "jaccard" if i % 2 else "cosine"
            stream.append(("rerank", sk[i], pays[i], metric))
    stream.append(("delete", np.arange(3, dtype=np.int64)))
    stream.append(("rerank", sk[5], pays[5], "containment"))
    jsched = make_jsched()
    jsched.create_collection("r", jserving.CollectionConfig(
        L=L, b=B, delta_cap=16, payload_words=RWP))
    results = []
    for sched in (make_rerank_sched(), jsched):
        futs = []
        for op, *a in stream:
            if op == "insert":
                futs.append(sched.submit_insert("r", a[0], payloads=a[1]))
            elif op == "delete":
                futs.append(sched.submit_delete("r", a[0]))
            elif op == "topk":
                futs.append(sched.submit_topk("r", a[0], K))
            else:
                futs.append(sched.submit_topk("r", a[0], K, rerank=a[2],
                                              q_payload=a[1]))
        sched.pump()
        results.append([f.result(timeout=300) for f in futs])
    for (op, *a), got, want in zip(stream, *results):
        if op == "insert":
            np.testing.assert_array_equal(got, want)
        elif op == "delete":
            assert got == want
        else:
            np.testing.assert_array_equal(got.ids, want.ids)
            np.testing.assert_array_equal(got.dists, want.dists)
            if op == "topk":
                assert got.scores is None and want.scores is None
            else:
                assert got.scores.dtype == np.float32
                np.testing.assert_array_equal(got.scores.view(np.int32),
                                              want.scores.view(np.int32))


def test_rerank_coalesces_only_within_same_metric_key():
    rng, sk, pays = _rerank_fixture(29)
    sched = make_rerank_sched()
    sched.submit_insert("r", sk, pays)
    sched.pump()
    futs = [sched.submit_topk("r", sk[i], K) for i in range(3)]
    futs += [sched.submit_topk("r", sk[i], K, rerank="jaccard",
                               q_payload=pays[i]) for i in range(2)]
    futs += [sched.submit_topk("r", sk[i], K, rerank="cosine",
                               q_payload=pays[i]) for i in range(2)]
    sched.pump()
    snap = sched.stats()
    assert snap["counters"]["batches_total:topk"] == 3
    assert snap["batch_fill_ratio"] == pytest.approx(7 / 8)
    for i, f in enumerate(futs[:3]):
        assert int(f.result().ids[0]) == i and f.result().scores is None
    for i, f in enumerate(futs[3:5]):
        assert int(f.result().ids[0]) == i
        assert float(f.result().scores[0]) == 1.0


def test_concurrent_submitters_all_complete():
    rng = np.random.default_rng(5)
    sched = make_sched(max_queue=10_000).start()
    docs = rng.integers(0, 1 << B, size=(40, L), dtype=np.uint8)
    sched.submit_insert("c", docs).result(timeout=300)
    results, errs = [], []

    def client(seed):
        try:
            r = np.random.default_rng(seed)
            for _ in range(5):
                i = int(r.integers(0, len(docs)))
                nn = sched.submit_topk("c", docs[i], 1).result(timeout=300)
                results.append((i, int(nn.ids[0]), int(nn.dists[0])))
        except Exception as e:              # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=client, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    sched.stop()
    assert not errs
    assert len(results) == 20
    for i, nn_id, nn_dist in results:
        assert nn_dist == 0
        np.testing.assert_array_equal(docs[nn_id], docs[i])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the scheduler's workers launch "
                    "the CUDA kernels and the cold tier's side-stream "
                    "copies")
    return torch.device("cuda")


@pytest.mark.cuda
class TestServingOnTheCard:

    def test_cold_collection_under_start(self, cuda_device):
        """A collection with every block cold (pinned host blocks staged
        on a side stream that waits on the worker thread's current
        stream) served by the threaded scheduler from 4 client threads:
        every answer equals the all-hot index's, bit for bit."""
        rng, sk, pays = _rerank_fixture(41, n_docs=6000)
        sched = Scheduler(config=SchedulerConfig(max_batch=16,
                                                 max_wait_ms=2.0))
        sched.create_collection("hot", CollectionConfig(
            L=L, b=B, delta_cap=2048, payload_words=RWP))
        sched.create_collection("cold", CollectionConfig(
            L=L, b=B, delta_cap=2048, payload_words=RWP, hot_bytes=0))
        sched.start()
        for name in ("hot", "cold"):
            sched.submit_insert(name, sk, pays).result(timeout=300)
            sched.submit_delete(name, np.arange(0, 6000, 50)).result(
                timeout=300)
        cold = sched.registry.get("cold").index
        assert cold._refresh_store().tier_summary()["cold_blocks"] > 0
        out = {"hot": [], "cold": []}
        errs = []

        def client(t):
            try:
                for i in range(t, 64, 4):
                    for name in ("hot", "cold"):
                        out[name].append((i, sched.submit_topk(
                            name, sk[i], 5, rerank="jaccard",
                            q_payload=pays[i]).result(timeout=300)))
            except Exception as e:          # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        sched.stop()
        assert not errs
        hot = dict(out["hot"])
        assert len(hot) == 64 and len(out["cold"]) == 64
        for i, got in out["cold"]:
            np.testing.assert_array_equal(got.ids, hot[i].ids)
            np.testing.assert_array_equal(got.dists, hot[i].dists)
            np.testing.assert_array_equal(got.scores.view(np.int32),
                                          hot[i].scores.view(np.int32))

    def test_recovery_on_the_card(self, cuda_device, tmp_path):
        """A durable collection written on the CPU opens on the card:
        segments rebuilt there, the journal replayed, the answers equal
        the writer's."""
        rng, sk, pays = _rerank_fixture(43, n_docs=3000)
        d = str(tmp_path / "data")
        reg = CollectionRegistry(d, device="cpu")
        coll = reg.create("c", CollectionConfig(
            L=L, b=B, delta_cap=1024, payload_words=RWP))
        coll.index.insert(sk, payloads=pays)
        coll.index.delete(np.arange(0, 3000, 7))
        want = coll.index.topk_batch(sk[:9], 6, rerank="jaccard",
                                     q_payloads=pays[:9])
        coll.store.wal.sync()
        rec = CollectionRegistry.open(d).get("c")
        assert rec.index.device.type == "cuda"
        assert rec.store.counters["replayed_records"] > 0
        got = rec.index.topk_batch(sk[:9], 6, rerank="jaccard",
                                   q_payloads=pays[:9])
        assert torch.equal(got.ids.cpu(), want.ids)
        assert torch.equal(got.scores.cpu().view(torch.int32),
                           want.scores.view(torch.int32))
