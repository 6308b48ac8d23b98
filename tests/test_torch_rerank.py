"""The port's two-stage exact re-rank against the JAX package.

The same seeded rows (b-bit sketches and their token-set payload
bitmaps) go through ``repro.core.SegmentedIndex`` and
``repro_torch.core.SegmentedIndex`` on the CPU, across the lifecycle
(insert -> delete -> merge -> insert -> delete -> compact), for the
suffix layout, the full layout and the reference fan-out.  Every metric
must give the same ids, dists, τ and scores — scores compared as float32
bit patterns — as the JAX package and as a numpy float32 brute force
ordered by (score desc, id asc), with exactly one ``"rerank"`` dispatch
per request.  Tolerance: bit-exact.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import segments as jseg
from repro_torch.core import segments as tseg
from repro_torch.core.hamming import pack_sets

jsearch = importlib.import_module("repro.core.search")
tsearch = importlib.import_module("repro_torch.core.search")

L, B = 12, 2
VOCAB = 96
WP = (VOCAB + 31) // 32
METRICS = ("jaccard", "cosine", "containment")
LAYOUTS = {"suffix": dict(layout="suffix"), "full": dict(layout="full"),
           "fanout": dict(use_arena=False)}
BIG = 1 << 20


def popcount_rows(x):
    x = np.ascontiguousarray(x, np.uint32)
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(axis=-1)


def brute(metric, q_pay, pay, surv):
    """numpy float32 scores: q_pay (m, Wp), pay (n, Wp), surv (m, n)."""
    inter = popcount_rows(q_pay[:, None, :] & pay[None, :, :])
    inter = inter.astype(np.float32)
    sa = popcount_rows(q_pay).astype(np.float32)[:, None]
    sb = popcount_rows(pay).astype(np.float32)[None, :]
    if metric == "jaccard":
        den = sa + sb - inter
    elif metric == "cosine":
        den = np.sqrt(sa * sb).astype(np.float32)
    else:
        den = np.broadcast_to(sa, inter.shape)
    safe = np.where(den > 0, den, np.float32(1))
    sc = np.where(den > 0, (inter / safe).astype(np.float32), np.float32(0))
    return np.where(surv, sc, np.float32(-1.0))


def brute_topk(metric, q_pay, pay, dist, ids, k):
    """Score the survivors (dist < BIG), order by (score desc, id asc),
    pad with (-1, BIG, -1.0)."""
    sc = brute(metric, q_pay, pay, dist < BIG)
    out_i, out_d, out_s = [], [], []
    for r in range(sc.shape[0]):
        sel = [j for j in np.lexsort((ids, -sc[r])) if sc[r, j] >= 0][:k]
        pad = k - len(sel)
        out_i.append([ids[j] for j in sel] + [-1] * pad)
        out_d.append([dist[r, j] for j in sel] + [BIG] * pad)
        out_s.append([sc[r, j] for j in sel] + [np.float32(-1.0)] * pad)
    return (np.array(out_i), np.array(out_d),
            np.array(out_s, np.float32))


def make_rows(rng, n, max_tokens=20):
    sets = [rng.choice(VOCAB, size=int(rng.integers(1, max_tokens)),
                       replace=False) for _ in range(n)]
    return (rng.integers(0, 1 << B, size=(n, L), dtype=np.uint8),
            pack_sets(sets, VOCAB))


def bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def request(pkg, idx, qs, qp, k, metric):
    """One re-rank request: the result as numpy, and its dispatch delta."""
    pkg.reset_dispatch_stats()
    res = idx.topk_batch(qs, k, rerank=metric, q_payloads=qp)
    out = [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
           for x in (res.ids, res.dists, res.scores)]
    return out, res.tau, res.overflow, pkg.dispatch_stats()


def assert_request(jidx, tidx, qs, qp, k, metric):
    (ji, jd, js), jtau, jov, jdisp = request(jseg, jidx, qs, qp, k, metric)
    (ti, td, tsc), ttau, tov, tdisp = request(tseg, tidx, qs, qp, k, metric)
    assert tsc.dtype == np.float32 and ti.dtype == np.int32
    assert (ttau, tov) == (jtau, jov)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(bits(tsc), bits(js))
    assert tdisp == jdisp and tdisp["rerank"] == 1, (tdisp, jdisp)
    # and the numpy two-stage brute force over the final-τ survivors
    dist, col_ids, _ = tidx._search_columns(qs, ttau)
    bi, bd, bs = brute_topk(metric, qp, tidx._payload_rows(),
                            dist.numpy(), col_ids, k)
    np.testing.assert_array_equal(ti, bi)
    np.testing.assert_array_equal(td, bd)
    np.testing.assert_array_equal(bits(tsc), bits(bs))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_rerank_matches_jax_through_lifecycle(layout):
    rng = np.random.default_rng(17)
    sk, pay = make_rows(rng, 60)
    sk2, pay2 = make_rows(rng, 30)
    qs = np.concatenate([sk[[3, 41]], rng.integers(
        0, 1 << B, size=(2, L), dtype=np.uint8)])
    qp = np.concatenate([pay[[3, 41]], pack_sets(
        [rng.choice(VOCAB, size=7, replace=False) for _ in range(2)], VOCAB)])
    kw = dict(delta_cap=25, payload_words=WP, auto_merge=False,
              **LAYOUTS[layout])
    jidx = jseg.SegmentedIndex(L, B, **kw)
    tidx = tseg.SegmentedIndex(L, B, device="cpu", **kw)
    steps = [
        lambda idx: idx.insert(sk, payloads=pay),
        lambda idx: idx.delete(np.arange(5, 15)),
        lambda idx: idx.merge(),
        lambda idx: (idx.insert(sk2[:26], payloads=pay2[:26]),   # seals
                     idx.insert(sk2[26:], payloads=pay2[26:])),  # live delta
        lambda idx: idx.delete(np.arange(40, 44)),
        lambda idx: idx.compact(),
    ]
    for step, act in enumerate(steps):
        act(jidx)
        act(tidx)
        if step in (0, 3, 5):
            for metric in METRICS:
                assert_request(jidx, tidx, qs, qp, 8, metric)
    assert len(tidx.segments) >= 1 and len(tidx._delta_ids) > 0


def test_one_rerank_launch_with_many_segments_and_pads():
    """Six sealed segments + a live delta cost ONE re-rank dispatch; plain
    top-k costs none; k past the live count pads with (-1, BIG, -1.0)."""
    rng = np.random.default_rng(23)
    kw = dict(delta_cap=10, payload_words=WP, auto_merge=False)
    jidx = jseg.SegmentedIndex(L, B, **kw)
    tidx = tseg.SegmentedIndex(L, B, device="cpu", **kw)
    rows = [make_rows(rng, 10) for _ in range(6)] + [make_rows(rng, 4)]
    for idx in (jidx, tidx):
        for sk, pay in rows:
            idx.insert(sk, payloads=pay)
    assert len(tidx.segments) == 6 and tidx.stats()["delta_rows"] == 4
    qs = rng.integers(0, 1 << B, size=(2, L), dtype=np.uint8)
    qp = pack_sets([rng.choice(VOCAB, size=6, replace=False)
                    for _ in range(2)], VOCAB)
    assert_request(jidx, tidx, qs, qp, 5, "jaccard")
    res = tidx.topk_batch(qs, 70, rerank="cosine", q_payloads=qp)
    jres = jidx.topk_batch(qs, 70, rerank="cosine", q_payloads=qp)
    np.testing.assert_array_equal(bits(res.scores.numpy()), bits(jres.scores))
    assert (res.ids.numpy()[:, 64:] == -1).all()
    assert (res.scores.numpy()[:, 64:] == -1.0).all()
    tseg.reset_dispatch_stats()
    tidx.topk_batch(qs, 5)
    assert tseg.dispatch_stats()["rerank"] == 0


def test_own_payload_ranks_first_with_score_one():
    rng = np.random.default_rng(31)
    idx = tseg.SegmentedIndex(L, B, delta_cap=16, payload_words=WP,
                              device="cpu")
    sk, pay = make_rows(rng, 40)
    ids = idx.insert(sk, payloads=pay)
    for metric in METRICS:
        res = idx.topk(sk[11], 3, rerank=metric, q_payloads=pay[11])
        assert int(res.ids[0]) == int(ids[11])
        assert float(res.scores[0]) == 1.0


def test_empty_index_rerank_pads():
    qs = np.zeros((2, L), np.uint8)
    qp = np.zeros((2, WP), np.uint32)
    res = tseg.SegmentedIndex(L, B, payload_words=WP, device="cpu") \
        .topk_batch(qs, 3, rerank="jaccard", q_payloads=qp)
    jres = jseg.SegmentedIndex(L, B, payload_words=WP) \
        .topk_batch(qs, 3, rerank="jaccard", q_payloads=qp)
    for t, j in zip((res.ids, res.dists, res.scores),
                    (jres.ids, jres.dists, jres.scores)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("k", [3, 40])
def test_select_topk_scores_matches_jax(k):
    """Both JAX lowerings (k unrolled reductions for k <= 32, one sort
    above) against the port's single int64-key top-k: ties at equal
    score order by the smaller label; sentinel lanes pad."""
    rng = np.random.default_rng(k)
    m, R = 4, 60
    scores = rng.choice(np.array([0.0, 0.25, 0.5, 1.0, 1 / 3], np.float32),
                        size=(m, R))
    surv = rng.random((m, R)) < 0.5
    surv[3] = False                              # a row with no survivor
    scores = np.where(surv, scores, np.float32(-1.0)).astype(np.float32)
    dist = np.where(surv, rng.integers(0, 6, size=(m, R)), BIG)
    dist = dist.astype(np.int32)
    labels = rng.permutation(1000)[:R].astype(np.int32)
    want = jsearch.select_topk_scores(jnp.asarray(scores), jnp.asarray(dist),
                                      jnp.asarray(labels), k)
    got = tsearch.select_topk_scores(torch.from_numpy(scores),
                                     torch.from_numpy(dist),
                                     torch.from_numpy(labels), k)
    for t, j in zip(got, want):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert (got[0].numpy()[3] == -1).all()


def test_pad_topk_matches_jax():
    d = np.array([[1, 2]], np.int32)
    i = np.array([[7, 9]], np.int32)
    jd, ji = jsearch._pad_topk(d, i, 4)
    td, ti = tsearch._pad_topk(torch.from_numpy(d), torch.from_numpy(i), 4)
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_array_equal(ti.numpy(), ji)
    assert tsearch.TopKResult(ids=i, dists=d, tau=1, overflow=0).scores is None


def test_rerank_argument_contract():
    rng = np.random.default_rng(5)
    q = np.zeros((1, L), np.uint8)
    qp = np.zeros((1, WP), np.uint32)
    plain = tseg.SegmentedIndex(L, B, device="cpu")
    with pytest.raises(ValueError):        # no payload plane configured
        plain.topk_batch(q, 2, rerank="jaccard", q_payloads=qp)
    with pytest.raises(ValueError):        # payloads without rerank=
        plain.topk_batch(q, 2, q_payloads=qp)
    idx = tseg.SegmentedIndex(L, B, payload_words=WP, device="cpu")
    with pytest.raises(ValueError):        # rerank= without payloads
        idx.topk_batch(q, 2, rerank="jaccard")
    with pytest.raises(ValueError):        # unknown metric
        idx.topk_batch(q, 2, rerank="dice", q_payloads=qp)
    with pytest.raises(ValueError):        # wrong payload width
        idx.topk_batch(q, 2, rerank="jaccard",
                       q_payloads=np.zeros((1, WP + 1), np.uint32))
    with pytest.raises(ValueError):        # insert without payloads
        idx.insert(rng.integers(0, 1 << B, size=(3, L), dtype=np.uint8))
    with pytest.raises(ValueError):        # payloads on a plain index
        plain.insert(rng.integers(0, 1 << B, size=(3, L), dtype=np.uint8),
                     payloads=np.zeros((3, WP), np.uint32))


@pytest.mark.parametrize("layout", ["suffix", "full"])
def test_payload_columns_in_space_ledger(layout):
    """The payload plane grows the ledger by at least its bytes on the
    device and the host, and leaves the model bits alone — as in the JAX
    package, whose ledger this one equals."""
    rng = np.random.default_rng(41)
    sk, pay = make_rows(rng, 48)
    q = sk[:1]
    ledgers = {}
    for pkg, kw in ((jseg, {}), (tseg, dict(device="cpu"))):
        base = pkg.SegmentedIndex(L, B, delta_cap=16, auto_merge=False,
                                  layout=layout, **kw)
        base.insert(sk)
        with_pay = pkg.SegmentedIndex(L, B, delta_cap=16, payload_words=WP,
                                      auto_merge=False, layout=layout, **kw)
        with_pay.insert(sk, payloads=pay)
        base.topk_batch(q, 2)
        with_pay.topk_batch(q, 2, rerank="jaccard", q_payloads=pay[:1])
        ledgers[pkg] = (base.space_ledger(), with_pay.space_ledger())
    led0, led1 = ledgers[tseg]
    sealed = 48 * WP * 4
    assert led1["host_bytes"] - led0["host_bytes"] >= sealed
    assert led1["device_bytes"] - led0["device_bytes"] >= sealed
    assert led1["model_bits"] == led0["model_bits"]
    assert ledgers[tseg] == ledgers[jseg]
