"""The cold tier of the port's suffix column store against the JAX
package's (the cold cases of ``tests/test_column_store.py``).

The same seeded numpy op stream runs on ``repro.core.SegmentedIndex``
and ``repro_torch.core.SegmentedIndex`` (on the CPU, where the kernel
wrappers run their plain versions and cold blocks are plain host
tensors) with a ``hot_bytes`` budget.  Answers must be bit-identical to
the JAX package's and to the all-hot port, at equal fused dispatch
counts; the placement (tiers, ``gen``) and the ``tier_stats()`` deltas
must equal the JAX package's.  Tolerance: bit-exact (integers, bools and
float32 score bits).  The ``cuda`` cases hold the pinned-memory staging
path on the card against the all-hot index and skip where there is none
(``python -m pytest tests/test_torch_column_store.py -m cuda``).
"""

import numpy as np
import pytest
import torch

from repro.core import column_store as jcs
from repro.core import segments as jseg
from repro.core.hamming import pack_sets as jpack_sets
from repro_torch.core import column_store as tcs
from repro_torch.core import segments as tseg
from test_torch_segments import answers, assert_same, corpus, queries

KW = dict(delta_cap=10 ** 9, auto_merge=False)


def filled(pkg, L, b, db, chunk=40, **kw):
    """An index of len(db) // chunk sealed segments (one flush each)."""
    idx = (pkg.SegmentedIndex(L, b, device="cpu", **KW, **kw)
           if pkg is tseg else pkg.SegmentedIndex(L, b, **KW, **kw))
    for lo in range(0, len(db), chunk):
        idx.insert(db[lo:lo + chunk], **({} if "payload_words" not in kw
                                         else {"payloads": PAYS[lo:lo + chunk]}))
        idx.flush()
    return idx


RNG = np.random.default_rng(17)
PAYS = jpack_sets([RNG.choice(64, size=int(RNG.integers(3, 12)),
                              replace=False) for _ in range(200)], 64)


def tier_delta(pkg, cs, idx, qs, k):
    """answers() of one index with the tier counters reset around it."""
    cs.reset_tier_stats()
    out = answers(pkg, idx, qs, k)
    out["tier"] = cs.tier_stats()
    return out


@pytest.mark.parametrize("L,b", [(16, 2), (24, 2)])
def test_cold_tier_matches_jax_and_all_hot(L, b):
    """hot_bytes=0: every sealed block cold (at (24, 2) the plane group
    too, b·S > 32).  Same bits as JAX and as the all-hot port, the same
    fused dispatches, and the same tier counters as JAX."""
    db = corpus(L, b, 120, seed=L)
    qs = queries(db, b, seed=L + 1)
    hot = filled(tseg, L, b, db)
    cold = filled(tseg, L, b, db, hot_bytes=0)
    jcold = filled(jseg, L, b, db, hot_bytes=0)
    a_hot = answers(tseg, hot, qs, 5)
    a_cold = tier_delta(tseg, tcs, cold, qs, 5)
    a_j = tier_delta(jseg, jcs, jcold, qs, 5)
    assert_same(a_j, a_cold, f"cold L={L} b={b}")
    t = a_cold.pop("tier")
    assert_same(a_hot, a_cold, f"cold vs hot L={L} b={b}")
    assert t["prefetches"] >= 3 and t["staged_bytes"] > 0
    assert t["demotions"] == 3 and t["promotions"] == 0
    st = cold._refresh_store()
    plan = st.plan()
    assert all(g.cols_hot is None and g.cold_blocks for g in plan)
    assert any(not g.geom.packed for g in plan) == (L == 24)
    assert st.tier_summary() == jcold._refresh_store().tier_summary()
    assert st.array_bytes() == jcold._refresh_store().array_bytes()
    assert st.host_bytes() == jcold._refresh_store().host_bytes() > 0
    assert cold.stats()["tier"] == jcold.stats()["tier"]
    assert cold.space_ledger()["host_bytes"] - hot.space_ledger()[
        "host_bytes"] == st.host_bytes()


def test_lru_demotion_and_promotion_match_jax():
    """A budget of two of three blocks demotes the oldest; mixed hot/cold
    answers stay equal; a larger budget promotes it back and bumps gen —
    step for step as in the JAX package."""
    db = corpus(16, 2, 120, seed=14)
    qs = db[:3]
    idxs = {pkg: filled(pkg, 16, 2, db) for pkg in (jseg, tseg)}
    r0 = {pkg: answers(pkg, idx, qs, 4) for pkg, idx in idxs.items()}
    stores = {pkg: idx._refresh_store() for pkg, idx in idxs.items()}
    blk_bytes = stores[tseg].blocks[0].col_bytes
    assert blk_bytes == stores[jseg].blocks[0].col_bytes == 40 * 4
    seen = {}
    for pkg, cs in ((jseg, jcs), (tseg, tcs)):
        st, rows = stores[pkg], []
        cs.reset_tier_stats()
        st.hot_bytes = 2 * blk_bytes
        st._enforce_budget()                    # LRU: the oldest demotes
        gen0 = st.gen
        rows.append((st.tier_summary(), [blk.tier for blk in st.blocks],
                     cs.tier_stats()))
        r1 = answers(pkg, idxs[pkg], qs, 4)     # mixed hot/cold
        st.hot_bytes = 10 ** 9                  # budget grew: promote
        st._enforce_budget()
        rows.append((st.tier_summary(), [blk.tier for blk in st.blocks],
                     cs.tier_stats(), st.gen - gen0))
        r2 = answers(pkg, idxs[pkg], qs, 4)
        seen[pkg] = (rows, r1, r2)
    assert seen[tseg][0] == seen[jseg][0]
    assert seen[tseg][0][0][0] == {"hot_blocks": 2, "cold_blocks": 1,
                                   "hot_bytes": 2 * blk_bytes,
                                   "cold_bytes": blk_bytes}
    assert seen[tseg][0][0][1][0] == tcs.TIER_COLD
    assert seen[tseg][0][1][2]["promotions"] == 1 and seen[tseg][0][1][3] > 0
    for i in (1, 2):
        assert_same(seen[jseg][i], seen[tseg][i], f"lru step {i}")
        assert_same(r0[tseg], seen[tseg][i], f"lru step {i} vs all hot")


def test_rerank_with_cold_payloads_matches_jax():
    """The Jaccard re-rank with every block cold: payload slabs staged
    per request, scores bit-identical to JAX and to all-hot, one re-rank
    dispatch, and the payload share of the staged bytes counted."""
    db = corpus(16, 2, 120, seed=21)
    qs = queries(db, 2, seed=22)
    qp = PAYS[150:150 + len(qs)]
    kw = dict(payload_words=PAYS.shape[1])
    runs = {}
    for name, pkg, cs, extra in (("jax", jseg, jcs, dict(hot_bytes=0)),
                                 ("cold", tseg, tcs, dict(hot_bytes=0)),
                                 ("hot", tseg, tcs, {})):
        idx = filled(pkg, 16, 2, db, **kw, **extra)
        idx.insert(db[:7], payloads=PAYS[120:127])   # a live delta
        cs.reset_tier_stats()
        pkg.reset_dispatch_stats()
        res = idx.topk_batch(qs, 6, rerank="jaccard", q_payloads=qp)
        runs[name] = (np.asarray(res.ids), np.asarray(res.dists),
                      np.asarray(res.scores).view(np.int32), res.tau,
                      pkg.dispatch_stats(), cs.tier_stats())
    for name in ("cold", "hot"):
        for a, b_ in zip(runs["jax"][:5], runs[name][:5]):
            np.testing.assert_array_equal(np.asarray(b_), np.asarray(a))
    assert runs["cold"][5] == runs["jax"][5]
    assert runs["cold"][4]["rerank"] == 1
    t = runs["cold"][5]
    assert t["staged_payload_bytes"] == 120 * PAYS.shape[1] * 4
    assert t["staged_bytes"] > t["staged_payload_bytes"]
    assert runs["hot"][5]["staged_bytes"] == 0


def test_delete_and_merge_while_cold_match_jax():
    """A half budget through the lifecycle: deletes flip liveness lanes of
    cold blocks, a merge rebuilds the store and re-applies the budget;
    every step is bit-identical to JAX with the same placement."""
    db = corpus(16, 2, 160, seed=31)
    extra = corpus(16, 2, 12, seed=32)
    qs = queries(db, 2, seed=33)
    snaps = {}
    for pkg in (jseg, tseg):
        idx = filled(pkg, 16, 2, db, hot_bytes=2 * 40 * 4)
        rows = [answers(pkg, idx, qs, 7)]
        more = idx.insert(extra)
        idx.delete(np.concatenate([np.arange(0, 40, 3), more[1:4]]))
        rows.append(answers(pkg, idx, qs, 7))
        assert idx.merge(0, 1)
        rows.append(answers(pkg, idx, qs, 7))
        idx.compact()
        rows.append(answers(pkg, idx, qs, 7))
        snaps[pkg] = (rows, idx._refresh_store().tier_summary(),
                      [blk.tier for blk in idx._refresh_store().blocks])
    for i, (j, t) in enumerate(zip(snaps[jseg][0], snaps[tseg][0])):
        assert_same(j, t, f"cold lifecycle step {i}")
    assert snaps[tseg][1:] == snaps[jseg][1:]
    assert "cold" in snaps[tseg][2]


def test_tier_flip_drops_stale_programs():
    """gen keys the fused cache: after a demotion the next call builds a
    new program and the old placement's programs are gone."""
    db = corpus(16, 2, 80, seed=41)
    qs = queries(db, 2, seed=42)
    idx = filled(tseg, 16, 2, db)
    want = idx.topk_batch(qs, 5)
    scope = [k for k in tseg._FUSED_CACHE if k[2] == idx._fused_id]
    st = idx._refresh_store()
    st.hot_bytes = 0
    st._enforce_budget()
    got = idx.topk_batch(qs, 5)
    assert not set(scope) & set(tseg._FUSED_CACHE)
    assert torch.equal(got.ids, want.ids) and torch.equal(got.dists,
                                                          want.dists)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cold tier's staging copies "
                    "run on a CUDA side stream")
    return torch.device("cuda")


@pytest.mark.cuda
class TestCudaColdTier:
    """The pinned-memory staging path on the card."""

    @pytest.mark.parametrize("L,b", [(16, 2), (24, 2)])
    def test_cold_equals_hot_on_the_card(self, cuda_device, L, b):
        db = corpus(L, b, 3000, seed=L)
        qs = queries(db, b, seed=L + 1, m=9)
        pays = jpack_sets([np.arange(i % 50, i % 50 + 5) for i in
                           range(len(db))], 64)
        qp = pays[:len(qs)]
        out = {}
        for name, kw in (("hot", {}), ("cold", dict(hot_bytes=0))):
            idx = tseg.SegmentedIndex(L, b, payload_words=pays.shape[1],
                                      device="cuda", **KW, **kw)
            for lo in range(0, len(db), 1000):
                idx.insert(db[lo:lo + 1000], payloads=pays[lo:lo + 1000])
                idx.flush()
            idx.insert(db[:5], payloads=pays[:5])
            tseg.reset_dispatch_stats()
            top = idx.topk_batch(qs, 7)
            cols = idx.search_columns_batch(qs, top.tau)
            rr = idx.topk_batch(qs, 7, rerank="jaccard", q_payloads=qp)
            torch.cuda.synchronize()
            out[name] = (top.ids.cpu(), top.dists.cpu(), cols.dist.cpu(),
                         rr.ids.cpu(), rr.scores.cpu().view(torch.int32),
                         tseg.dispatch_stats())
            if name == "cold":
                st = idx._refresh_store()
                assert all(blk.cols_cold.is_pinned()
                           and blk.pays_cold.is_pinned()
                           for blk in st.blocks)
                slabs = st.stage()
                assert all(s.data.is_cuda and s.event is not None
                           for s in slabs)
        for a, b_ in zip(out["hot"], out["cold"]):
            if isinstance(a, dict):
                assert a == b_
            else:
                assert torch.equal(a, b_)

    def test_staging_overlaps_no_sync(self, cuda_device):
        """stage() returns before its copies finish (no synchronise):
        the slab is read right only after ``wait()``."""
        db = corpus(16, 2, 200_000, seed=5)
        idx = tseg.SegmentedIndex(16, 2, hot_bytes=0, device="cuda", **KW)
        idx.insert(db)
        idx.flush()
        st = idx._refresh_store()
        (slab,) = st.stage()
        data = slab.wait()
        torch.cuda.synchronize()
        assert torch.equal(data.cpu(), st.blocks[0].cols_cold)
