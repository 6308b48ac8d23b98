"""The port's other segmented backends against the JAX package's.

The same seeded numpy op stream runs on ``repro.core`` and
``repro_torch.core`` (on the CPU, where the kernel wrappers run their
plain versions):

  * ``SegmentedIndex(backend="multi")`` and ``backend="sharded"``, fused
    and fan-out (``use_arena=False``), through chunked inserts (automatic
    flushes and a live delta buffer), flush, deletes across segments and
    the delta, merges to one segment and compact, and an ``auto_merge``
    stream; after each step ``topk_batch``, ``search_columns_batch``,
    ``search_batch`` and the single-query column search agree (ids,
    dists, τ, overflow, masks, column ids) with the ``dispatch_stats()``
    deltas, and the fused path agrees with the fan-out;
  * the two-stage re-rank on both backends and every metric (float32
    score bits);
  * ``ShardedSegmentedIndex`` over bst stacks, fused and fan-out, with
    the re-rank, explain and the brute force.

Tolerance: bit for bit (integers, bools, and float32 scores compared as
bit patterns).
"""

import numpy as np
import pytest
import torch

from repro.core import segments as jseg
from repro_torch.core import segments as tseg
from repro_torch.core.hamming import pack_sets
from test_torch_rerank import METRICS, VOCAB, WP, assert_request, make_rows
from test_torch_segments import (answers, assert_same, corpus, lifecycle,
                                 queries)

BIG = 1 << 20
BACKENDS = {"multi": dict(backend="multi", mi_blocks=2),
            "multi3": dict(backend="multi", mi_blocks=3),
            "sharded": dict(backend="sharded", n_shards=3)}
PATHS = {"fused": {}, "fanout": dict(use_arena=False)}


@pytest.mark.parametrize("L,b", [(16, 2), (24, 4)])
@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("path", list(PATHS))
def test_lifecycle_matches_jax(L, b, backend, path):
    db = corpus(L, b, 160, seed=L + b + 5)
    extra = corpus(L, b, 12, seed=L + b + 6)
    qs = queries(db, b, seed=L + 1)
    kw = dict(delta_cap=50, auto_merge=False, **BACKENDS[backend],
              **PATHS[path])
    jidx = jseg.SegmentedIndex(L, b, **kw)
    tidx = tseg.SegmentedIndex(L, b, device="cpu", **kw)
    snaps = {}
    for pkg, idx in ((jseg, jidx), (tseg, tidx)):
        rows = []
        lifecycle(idx, db, extra,
                  lambda name: rows.append((name, answers(pkg, idx, qs, 7))))
        snaps[pkg] = rows
    for (name, j), (_, t) in zip(snaps[jseg], snaps[tseg]):
        assert_same(j, t, f"{backend} {path} L={L} b={b} after {name}")
    assert jidx.stats()["segments"] == tidx.stats()["segments"]
    assert jidx.space_ledger() == tidx.space_ledger()


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_auto_merge_stream_matches_jax_and_fanout(backend):
    L, b = 16, 2
    db = corpus(L, b, 230, seed=40)
    qs = queries(db, b, seed=41)
    kw = dict(delta_cap=16, auto_merge=True, **BACKENDS[backend])
    jidx = jseg.SegmentedIndex(L, b, **kw)
    tidx = tseg.SegmentedIndex(L, b, device="cpu", **kw)
    fan = tseg.SegmentedIndex(L, b, device="cpu", use_arena=False, **kw)
    for lo in range(0, len(db), 7):
        for idx in (jidx, tidx, fan):
            idx.insert(db[lo:lo + 7])
        if lo % 49 == 0:
            for idx in (jidx, tidx, fan):
                idx.delete(np.arange(lo // 3, lo // 3 + 4))
    for idx in (jidx, tidx, fan):
        idx.insert(db[:3])                  # a live delta buffer
    assert len(tidx.segments) >= 2 and len(tidx._delta_ids) > 0
    assert_same(answers(jseg, jidx, qs, 6), answers(tseg, tidx, qs, 6),
                f"{backend} auto-merge")
    got, want = tidx.topk_batch(qs, 6), fan.topk_batch(qs, 6)
    assert torch.equal(got.ids, want.ids) and torch.equal(got.dists,
                                                          want.dists)
    gc, wc = tidx.search_columns_batch(qs, 3), fan.search_columns_batch(qs, 3)
    assert torch.equal(gc.dist, wc.dist) and (gc.ids == wc.ids).all()


@pytest.mark.parametrize("backend", ["multi", "sharded"])
def test_rerank_matches_jax(backend):
    rng = np.random.default_rng(23)
    sk, pay = make_rows(rng, 60)
    sk2, pay2 = make_rows(rng, 30)
    qs = np.concatenate([sk[[3, 41]], rng.integers(0, 4, size=(2, 12),
                                                   dtype=np.uint8)])
    qp = np.concatenate([pay[[3, 41]], pack_sets(
        [rng.choice(VOCAB, size=7, replace=False) for _ in range(2)], VOCAB)])
    for path in PATHS.values():
        kw = dict(delta_cap=25, payload_words=WP, auto_merge=False,
                  **BACKENDS[backend], **path)
        jidx = jseg.SegmentedIndex(12, 2, **kw)
        tidx = tseg.SegmentedIndex(12, 2, device="cpu", **kw)
        for idx in (jidx, tidx):
            ids = idx.insert(sk, payloads=pay)
            idx.delete(ids[5:15])
            idx.merge()
            idx.insert(sk2[:26], payloads=pay2[:26])      # seals
            idx.insert(sk2[26:], payloads=pay2[26:])      # a live delta
            idx.delete(ids[40:44])
            idx.compact()
        assert len(tidx.segments) >= 1 and len(tidx._delta_ids) > 0
        for metric in METRICS:
            assert_request(jidx, tidx, qs, qp, 8, metric)


def filled_sharded(pkg, db, dels, **kw):
    idx = (pkg.ShardedSegmentedIndex(12, 2, n_shards=3, delta_cap=40, **kw)
           if pkg is jseg else
           pkg.ShardedSegmentedIndex(12, 2, n_shards=3, delta_cap=40,
                                     device="cpu", **kw))
    ids = idx.insert(db)
    assert idx.delete(ids[dels]) == len(dels)
    return idx


@pytest.mark.parametrize("path", list(PATHS))
def test_sharded_segmented_index_matches_jax(path):
    rng = np.random.default_rng(77)
    db = rng.integers(0, 4, size=(300, 12), dtype=np.uint8)
    db[250:] = db[:50]
    dels = rng.choice(300, 50, replace=False)
    qs = np.concatenate([db[[3, 99, 260]],
                         rng.integers(0, 4, size=(1, 12), dtype=np.uint8)])
    jidx = filled_sharded(jseg, db, dels, **PATHS[path])
    tidx = filled_sharded(tseg, db, dels, **PATHS[path])
    for step in ("stream", "flush", "merge", "compact"):
        if step == "flush":
            jidx.flush(), tidx.flush()
        elif step == "merge":
            assert tidx.merge() == jidx.merge()
        elif step == "compact":
            assert tidx.compact() == jidx.compact()
        want, got = jidx.topk_batch(qs, 5), tidx.topk_batch(qs, 5)
        np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
        np.testing.assert_array_equal(got.dists.numpy(),
                                      np.asarray(want.dists))
        assert (got.tau, got.overflow) == (want.tau, want.overflow)
        jr, tr = jidx.search_batch(qs, 2), tidx.search_batch(qs, 2)
        np.testing.assert_array_equal(tr.mask.numpy(), np.asarray(jr.mask))
        np.testing.assert_array_equal(tr.dist.numpy(), np.asarray(jr.dist))
        assert tr.overflow == jr.overflow
        assert tidx.n_live == jidx.n_live == 250
        assert tidx.tombstones == jidx.tombstones
        assert tidx.space_ledger() == jidx.space_ledger()
        assert tidx.cost_hint("topk", k=5) == jidx.cost_hint("topk", k=5)
    # the brute force over the surviving rows
    surv = np.ones(300, bool)
    surv[dels] = False
    d = (qs[:, None] != db[None]).sum(-1)
    np.testing.assert_array_equal(tr.mask.numpy(), (d <= 2) & surv[None])


def test_sharded_segmented_rerank_and_explain_match_jax():
    rng = np.random.default_rng(17)
    sk, pay = make_rows(rng, 50)
    jidx = jseg.ShardedSegmentedIndex(12, 2, n_shards=3, delta_cap=20,
                                      payload_words=WP)
    tidx = tseg.ShardedSegmentedIndex(12, 2, n_shards=3, delta_cap=20,
                                      payload_words=WP, device="cpu")
    for idx in (jidx, tidx):
        ids = idx.insert(sk, payloads=pay)
        idx.delete(ids[::7])
        idx.merge()
    qs = rng.integers(0, 4, size=(2, 12), dtype=np.uint8)
    qp = pack_sets([rng.choice(VOCAB, size=5, replace=False)
                    for _ in range(2)], VOCAB)
    for metric in METRICS:
        assert_request(jidx, tidx, qs, qp, 6, metric)
    plain = tidx.topk_batch(qs, 4)
    res, ex = tidx.topk_batch(qs, 4, explain=True)
    _, jex = jidx.topk_batch(qs, 4, explain=True)
    assert torch.equal(plain.ids, res.ids) and plain.tau == res.tau
    assert ex.backend == jex.backend == "sharded-stacks"
    assert [(r.tau, r.candidates, r.survivors, r.frontier)
            for r in ex.rungs] == [(r.tau, r.candidates, r.survivors,
                                    r.frontier) for r in jex.rungs]
    sres, sex = tidx.search(qs[0], 3, explain=True)
    assert sex.op == "search" and sex.tau0 == 3
    assert torch.equal(sres.dist, tidx.search(qs[0], 3).dist)


@pytest.mark.parametrize("backend", ["multi", "sharded"])
def test_explain_has_no_frontier_on_other_backends(backend):
    db = corpus(16, 2, 120, seed=9)
    kw = dict(delta_cap=50, **BACKENDS[backend])
    jidx = jseg.SegmentedIndex(16, 2, **kw)
    tidx = tseg.SegmentedIndex(16, 2, device="cpu", **kw)
    for idx in (jidx, tidx):
        idx.insert(db)
    res, ex = tidx.topk(db[4], 3, explain=True)
    jres, jex = jidx.topk(db[4], 3, explain=True)
    np.testing.assert_array_equal(res.ids.numpy(), np.asarray(jres.ids))
    assert ex.backend == jex.backend == backend
    assert all(r.frontier is None for r in ex.rungs)
    assert [(r.tau, r.survivors, r.dispatches) for r in ex.rungs] == \
        [(r.tau, r.survivors, r.dispatches) for r in jex.rungs]


def test_sharded_searchers_key_on_segment_serials():
    """The fan-out's sharded searchers are cached per segment serial:
    after merges a query reaches the NEW segments' searchers."""
    rng = np.random.default_rng(9)
    db = rng.integers(0, 4, size=(90, 8), dtype=np.uint8)
    idx = tseg.SegmentedIndex(8, 2, delta_cap=10 ** 9, backend="sharded",
                              n_shards=2, auto_merge=False, use_arena=False,
                              device="cpu")
    for lo in range(0, 90, 30):
        idx.insert(db[lo:lo + 30])
        idx.flush()
    serials = {seg.serial for seg in idx.segments}
    idx.topk_batch(db[:2], 3)
    assert {k[0] for k in tseg._SHARDED_SEARCHER_CACHE} >= serials
    idx.merge()
    idx.merge()
    new = idx.segments[0].serial
    assert new not in serials
    res = idx.topk_batch(db[[5, 41]], 4)
    assert any(k[0] == new for k in tseg._SHARDED_SEARCHER_CACHE)
    d = (db[[5, 41]][:, None] != db[None]).sum(-1)
    want = np.lexsort((np.broadcast_to(np.arange(90), d.shape), d))[:, :4]
    np.testing.assert_array_equal(res.ids.numpy(), want)


def test_sharded_segment_shards_clamp_to_rows():
    idx = tseg.SegmentedIndex(8, 2, delta_cap=10 ** 9, backend="sharded",
                              n_shards=4, device="cpu")
    idx.insert(np.zeros((2, 8), np.uint8))
    idx.flush()
    assert idx.segments[0].index.n_shards == 2
    assert idx.topk(np.zeros(8, np.uint8), 2).dists.tolist() == [0, 0]


def test_sharded_stacks_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tseg.ShardedSegmentedIndex(16, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tseg.SegmentedIndex(16, 2, backend="multi")
