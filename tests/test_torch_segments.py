"""The port's segmented index against the JAX package's, op for op.

The same seeded numpy op stream — chunked inserts, flush, delete, merge
to one segment, compact, and an ``auto_merge`` stream — runs on
``repro.core.SegmentedIndex`` and ``repro_torch.core.SegmentedIndex``
(on the CPU, where the kernel wrappers run their plain versions).  After
every step both answer the same queries through ``topk_batch`` (ids,
dists, τ, overflow), ``search_columns_batch`` (mask, dist, column ids,
overflow) and ``search_batch`` (mask, dist, overflow), and the
``dispatch_stats()`` deltas of those calls agree.  This runs for the
suffix layout, the full layout and the reference fan-out
(``use_arena=False``) at (L, b) = (16, 2) (packed suffix words), (24, 2)
(b·S > 32: the plane-packed fallback) and (32, 4).  Tolerance:
bit-exact; every output is an integer or a bool.
"""

import importlib

import numpy as np
import pytest
import torch

from repro.core import column_store as jcs
from repro.core import segments as jseg
from repro_torch.core import column_store as tcs
from repro_torch.core import segments as tseg

BIG = 1 << 20
GEOMETRIES = [(16, 2), (24, 2), (32, 4)]
LAYOUTS = {"suffix": dict(layout="suffix"), "full": dict(layout="full"),
           "fanout": dict(use_arena=False)}


def corpus(L, b, n, seed):
    """Uniform sketches with duplicated rows (ties at every distance)."""
    rng = np.random.default_rng(seed)
    db = rng.integers(0, 1 << b, size=(n, L)).astype(np.uint8)
    db[n - n // 8:] = db[: n // 8]
    return db


def queries(db, b, seed, m=5):
    """Database rows with 0-2 symbols changed, and uniform rows."""
    rng = np.random.default_rng(seed)
    L = db.shape[1]
    near = db[rng.integers(0, len(db), size=m - 2)].copy()
    for row in near:
        pos = rng.choice(L, size=rng.integers(0, 3), replace=False)
        row[pos] = (row[pos] + 1) % (1 << b)
    return np.concatenate([near, rng.integers(0, 1 << b, size=(2, L))
                           .astype(np.uint8)])


def answers(pkg, idx, qs, k):
    """Every query contract of one index, as numpy, plus the dispatch
    counter deltas of the calls."""
    pkg.reset_dispatch_stats()
    top = idx.topk_batch(qs, k)
    tau = int(top.tau)
    cols = idx.search_columns_batch(qs, tau)
    dense = idx.search_batch(qs, tau + 1)
    single = idx.search_columns(qs[0], tau)
    out = dict(ids=top.ids, dists=top.dists, tau=top.tau,
               overflow=top.overflow, c_mask=cols.mask, c_dist=cols.dist,
               c_ids=cols.ids, c_over=cols.overflow, d_mask=dense.mask,
               d_dist=dense.dist, d_over=dense.overflow, s_dist=single.dist,
               dispatch=pkg.dispatch_stats())
    return {k_: (v.numpy() if isinstance(v, torch.Tensor) else
                 v if isinstance(v, (int, dict)) else np.asarray(v))
            for k_, v in out.items()}


def assert_same(j, t, where):
    assert j.keys() == t.keys()
    for key in j:
        if isinstance(j[key], np.ndarray):
            np.testing.assert_array_equal(t[key], j[key],
                                          err_msg=f"{where}: {key}")
        else:
            assert t[key] == j[key], (where, key, t[key], j[key])


def lifecycle(idx, db, extra, stage):
    """Chunked inserts (two automatic flushes and a live delta), flush,
    insert + delete across segments and delta, merge to one, compact."""
    chunk = len(db) // 4
    ids = [idx.insert(db[lo:lo + chunk]) for lo in range(0, len(db), chunk)]
    stage("inserts")
    idx.flush()
    stage("flush")
    more = idx.insert(extra)
    dead = np.concatenate([ids[0][5:20], ids[2][::3], more[1:4]])
    assert idx.delete(dead) == len(np.unique(dead))
    stage("delete")
    while idx.merge():
        pass
    assert len(idx.segments) == 1
    stage("merge")
    idx.compact()
    stage("compact")


@pytest.mark.parametrize("L,b", GEOMETRIES)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_lifecycle_matches_jax(L, b, layout):
    db = corpus(L, b, 160, seed=L + b)
    extra = corpus(L, b, 12, seed=L + b + 1)
    qs = queries(db, b, seed=L)
    kw = dict(delta_cap=50, auto_merge=False, **LAYOUTS[layout])
    jidx = jseg.SegmentedIndex(L, b, **kw)
    tidx = tseg.SegmentedIndex(L, b, device="cpu", **kw)
    snaps = {}
    for pkg, idx in ((jseg, jidx), (tseg, tidx)):
        rows = []
        lifecycle(idx, db, extra,
                  lambda name: rows.append((name, answers(pkg, idx, qs, 7))))
        snaps[pkg] = rows
    for (name, j), (_, t) in zip(snaps[jseg], snaps[tseg]):
        assert_same(j, t, f"{layout} L={L} b={b} after {name}")
    assert jidx.stats()["segments"] == tidx.stats()["segments"]
    assert jidx.space_bits() == tidx.space_bits()


@pytest.mark.parametrize("L,b", GEOMETRIES)
def test_auto_merge_stream_matches_jax(L, b):
    """Small inserts with ``auto_merge``: the size-tiered policy merges
    as it goes; both stacks and all their answers stay equal."""
    db = corpus(L, b, 230, seed=2 * L + b)
    qs = queries(db, b, seed=L + 3)
    kw = dict(delta_cap=16, auto_merge=True)
    jidx = jseg.SegmentedIndex(L, b, **kw)
    tidx = tseg.SegmentedIndex(L, b, device="cpu", **kw)
    for idx in (jidx, tidx):
        for lo in range(0, 220, 11):
            idx.insert(db[lo:lo + 11])
        idx.insert(db[220:])                     # a live delta buffer
        idx.delete(np.arange(0, 230, 7))
    assert [s.n for s in tidx.segments] == [s.n for s in jidx.segments]
    assert tidx.counters == jidx.counters
    assert len(tidx.segments) >= 2 and len(tidx._delta_ids) > 0
    assert_same(answers(jseg, jidx, qs, 9), answers(tseg, tidx, qs, 9),
                f"auto_merge L={L} b={b}")
    assert tidx.stats()["tombstones"] == jidx.stats()["tombstones"]


@pytest.mark.parametrize("L,b", [(16, 2), (24, 2)])
def test_column_store_plan_matches_jax(L, b):
    """The suffix store's geometry groups, stack permutations, base-offset
    lanes and liveness lanes."""
    db = corpus(L, b, 150, seed=9)
    jidx = jseg.SegmentedIndex(L, b, delta_cap=40, auto_merge=False)
    tidx = tseg.SegmentedIndex(L, b, delta_cap=40, auto_merge=False,
                               device="cpu")
    for idx in (jidx, tidx):
        idx.insert(db[:100])
        idx.insert(db[100:])
        idx.delete(np.arange(3, 150, 11))
    jst, tst = jidx._refresh_store(), tidx._refresh_store()
    jplan, tplan = jst.plan(), tst.plan()
    assert [g.geom for g in tplan] == [tuple(g.geom) for g in jplan]
    # L=24: the shallow collapse leaves b·S > 32, the plane-packed group
    assert any(not g.geom.packed for g in tplan) == (L == 24)
    for jg, tg in zip(jplan, tplan):
        np.testing.assert_array_equal(tg.perm, jg.perm)
        np.testing.assert_array_equal(tg.base_idx.numpy(),
                                      np.asarray(jg.base_idx))
        np.testing.assert_array_equal(tg.cols_hot.numpy().view(np.uint32),
                                      np.asarray(jg.cols_hot))
    np.testing.assert_array_equal(tst.live.numpy(), np.asarray(jst.live))
    np.testing.assert_array_equal(tst.col_ids, jst.col_ids)
    assert tst.t_root_total == jst.t_root_total
    assert tst.array_bytes() == jst.array_bytes()
    assert tst.tier_summary() == jst.tier_summary()
    assert tst.stage() == (None,) * len(tplan)
    for L_, b_, ls in ((16, 2, 4), (64, 8, 0), (16, 1, 0), (24, 2, 5)):
        assert tcs.geometry_for(L_, b_, ls) == tuple(
            jcs.geometry_for(L_, b_, ls))


def test_full_arena_lanes_match_jax():
    db = corpus(16, 2, 120, seed=4)
    jidx = jseg.SegmentedIndex(16, 2, delta_cap=50, layout="full",
                               auto_merge=False)
    tidx = tseg.SegmentedIndex(16, 2, delta_cap=50, layout="full",
                               auto_merge=False, device="cpu")
    for idx in (jidx, tidx):
        idx.insert(db[:60])
        idx._refresh_arena()           # then a flush appends incrementally
        idx.insert(db[60:])
        idx.delete([1, 2, 70])
    ja, ta = jidx._refresh_arena(), tidx._refresh_arena()
    for name in ("base_idx", "gids", "live"):
        np.testing.assert_array_equal(getattr(ta, name).numpy(),
                                      np.asarray(getattr(ja, name)))
    np.testing.assert_array_equal(ta.cols.numpy().view(np.uint32),
                                  np.asarray(ja.cols))
    # serials are process-wide counters: compare the offsets in stack order
    assert list(ta.col_off.values()) == list(ja.col_off.values())
    assert list(ta.root_off.values()) == list(ja.root_off.values())
    assert ta.array_bytes() == ja.array_bytes()


def test_empty_index_and_k_past_live_count():
    qs = corpus(16, 2, 3, seed=1)
    jidx = jseg.SegmentedIndex(16, 2, delta_cap=8)
    tidx = tseg.SegmentedIndex(16, 2, delta_cap=8, device="cpu")
    for j, t in ((jidx.topk_batch(qs, 4), tidx.topk_batch(qs, 4)),):
        np.testing.assert_array_equal(t.ids.numpy(), np.asarray(j.ids))
        np.testing.assert_array_equal(t.dists.numpy(), np.asarray(j.dists))
    assert tidx.search_columns_batch(qs, 3).dist.shape == (3, 0)
    db = corpus(16, 2, 11, seed=2)
    for idx in (jidx, tidx):
        idx.insert(db)
        idx.delete([0, 5])
    j, t = jidx.topk_batch(qs, 20), tidx.topk_batch(qs, 20)
    assert t.tau == j.tau == 16
    np.testing.assert_array_equal(t.ids.numpy(), np.asarray(j.ids))
    np.testing.assert_array_equal(t.dists.numpy(), np.asarray(j.dists))
    assert (t.ids.numpy()[:, 9:] == -1).all()
    one = tidx.topk(qs[0], 3)
    np.testing.assert_array_equal(one.ids.numpy(), t.ids.numpy()[0, :3])
    assert len(tidx) == jidx.n_live == 9


def test_fused_cache_counts_and_drops_dead_generations():
    db = corpus(16, 2, 80, seed=6)
    qs = queries(db, 2, seed=6)
    tseg.clear_fused_cache()
    idx = tseg.SegmentedIndex(16, 2, delta_cap=40, auto_merge=False,
                              device="cpu")
    idx.insert(db[:40])
    idx.insert(db[40:])
    ts = importlib.import_module("repro_torch.core.search")
    ts.clear_searcher_cache()
    idx.topk_batch(qs, 5)
    misses = ts.searcher_cache_info()["misses"]
    assert misses >= 1
    idx.topk_batch(qs, 5)
    assert ts.searcher_cache_info()["misses"] == misses
    assert ts.searcher_cache_info()["hits"] >= 1
    scope = [k for k in tseg._FUSED_CACHE if k[2] == idx._fused_id]
    assert scope
    assert idx.merge()
    idx.topk_batch(qs, 5)           # new fingerprint: old programs dropped
    assert not set(scope) & set(tseg._FUSED_CACHE)


class _Recorder:
    """A durability binding that records its hooks' calls in order."""

    def __init__(self):
        self.calls = []

    def log_insert(self, ids, sk, payloads=None):
        self.calls.append(("insert", ids.tolist()))

    def log_delete(self, ids):
        self.calls.append(("delete", ids.tolist()))

    def begin_write(self):
        self.calls.append(("begin",))

    def end_write(self):
        self.calls.append(("end",))

    def checkpoint(self, idx):
        self.calls.append(("checkpoint", len(idx.segments)))


def test_unported_options_raise():
    """Unknown backends and layouts still raise; the durability binding
    is ported: every backend (the cold tier and the sharded stacks too)
    takes a ``store`` and calls its hooks where the JAX package does —
    log before apply, checkpoint after flush, merge and compact."""
    rows = corpus(16, 2, 8, 0)
    for kw in (dict(backend="multi"), dict(backend="sharded"),
               dict(hot_bytes=1 << 20)):
        idx = tseg.SegmentedIndex(16, 2, delta_cap=4, device="cpu", **kw)
        assert idx.store is None
        idx.store = rec = _Recorder()
        idx.insert(rows[:4])                        # auto-flush at 4
        idx.delete([1, 1, 9])
        idx.insert(rows[4:8])                       # flush + merge
        idx.delete([2])
        idx.compact()
        assert rec.calls == [("insert", [0, 1, 2, 3]), ("checkpoint", 1),
                             ("delete", [1, 9]), ("insert", [4, 5, 6, 7]),
                             ("checkpoint", 2), ("checkpoint", 1),
                             ("delete", [2]), ("checkpoint", 1)], \
            (kw, rec.calls)
    sharded = tseg.ShardedSegmentedIndex(16, 2, n_shards=2, device="cpu")
    assert sharded.store is None
    sharded.store = rec = _Recorder()
    sharded.insert(rows[:3])
    sharded.delete([0, 7])
    assert rec.calls == [("insert", [0, 1, 2]), ("begin",), ("end",),
                         ("delete", [0])]
    with pytest.raises(ValueError):
        tseg.SegmentedIndex(16, 2, backend="lsh", device="cpu")
    with pytest.raises(ValueError):
        tseg.SegmentedIndex(16, 2, layout="columnar", device="cpu")
    assert tcs.tier_stats().keys() == jcs.tier_stats().keys()


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tseg.SegmentedIndex(16, 2)


def test_column_store_default_device_raises_without_cuda(monkeypatch):
    """A bare ColumnStore asks for the card, like SegmentedIndex and
    LinearScan.build, and never quietly runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcs.ColumnStore(16, 2)
    assert tcs.ColumnStore(16, 2, device="cpu").device.type == "cpu"


def test_tombstone_bits_and_event_hook():
    for n in (0, 1, 31, 32, 64, 1000):
        assert tseg.tombstone_bits(n) == jseg.tombstone_bits(n)
    events = []
    idx = tseg.SegmentedIndex(8, 2, delta_cap=4, device="cpu")
    idx.event_hook = lambda ev, info: events.append(ev)
    ids = idx.insert(np.zeros((5, 8), np.uint8))
    idx.delete(ids[:2])
    assert events == ["insert", "flush", "delete"]
    assert idx.stats()["tombstones"] == 2 and idx.tombstones == 2
