"""The port's range search, batched searcher and τ-ladder top-k against
the JAX package, on the quickstart flow at n ≈ 3000.

Both packages build their index from the same seeded numpy sketches and
answer the same queries.  Tolerance: bit-exact — masks, distances,
overflow and traversed counts, top-k ids, dists, τ* and overflow are all
integers or bools and must be identical.  bST indexes run at the three
(L, b) geometries; LOUDS and FST (no collapsed tail) at L=16, b=2.
The JAX searches run each batch searcher at the τ its top-k ends on, so
the top-k reuses the compiled searcher.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bst as jbst
from repro_torch.core import bst as tbst

js = importlib.import_module("repro.core.search")
ts = importlib.import_module("repro_torch.core.search")

BIG = 1 << 20
CASES = [(16, 2, "bst"), (32, 4, "bst"), (40, 2, "bst"),
         (16, 2, "louds"), (16, 2, "fst")]
BUILDERS = {"bst": (jbst.build_bst, tbst.build_bst),
            "louds": (jbst.build_louds, tbst.build_louds),
            "fst": (jbst.build_fst_style, tbst.build_fst_style)}
_BUILT: dict = {}


def quickstart_db(L, b, n=3000, seed=0):
    """Uniform sketches with 10% duplicated rows (shared leaves, ties)."""
    rng = np.random.default_rng(seed + L * 10 + b)
    db = rng.integers(0, 1 << b, size=(n, L)).astype(np.uint8)
    db[n - n // 10:] = db[: n // 10]
    return db


def queries(db, b, m, seed):
    """Half database rows with 0-2 symbols changed, half uniform rows."""
    rng = np.random.default_rng(seed)
    L = db.shape[1]
    near = db[rng.integers(0, len(db), size=m - m // 2)].copy()
    for row in near:
        pos = rng.choice(L, size=rng.integers(0, 3), replace=False)
        row[pos] = (row[pos] + rng.integers(1, 1 << b, size=len(pos))) % (1 << b)
    far = rng.integers(0, 1 << b, size=(m // 2, L)).astype(np.uint8)
    return np.concatenate([near, far])


def built(L, b, kind):
    """(db, JAX index, port index), built once per module run."""
    key = (L, b, kind)
    if key not in _BUILT:
        db = quickstart_db(L, b)
        jb, tb = BUILDERS[kind]
        _BUILT[key] = (db, jb(db, b), tb(db, b, device="cpu"))
    return _BUILT[key]


def assert_same(jres, tres):
    assert len(jres) == len(tres)
    for j, t in zip(jres, tres):
        if isinstance(t, torch.Tensor):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        else:
            assert t == j


@pytest.mark.parametrize("L,b,kind", CASES)
def test_batch_search_and_topk_match_jax(L, b, kind):
    db, jidx, tidx = built(L, b, kind)
    qs = queries(db, b, 5, seed=L + b)          # m = 5, not a power of two
    jtop = js.topk_batch(jidx, qs, 10)
    ttop = ts.topk_batch(tidx, qs, 10)
    assert ttop.tau == jtop.tau and ttop.overflow == jtop.overflow == 0
    np.testing.assert_array_equal(ttop.ids.numpy(), np.asarray(jtop.ids))
    np.testing.assert_array_equal(ttop.dists.numpy(), np.asarray(jtop.dists))
    jres = js.make_batch_searcher(jidx, jtop.tau)(jnp.asarray(qs))
    tres = ts.make_batch_searcher(tidx, jtop.tau)(qs)
    assert tres.mask.shape == (5, len(db)) and tres.mask.dtype == torch.bool
    assert_same(jres, tres)
    # and both agree with brute force
    d = (qs[:, None, :] != db[None]).sum(2)
    np.testing.assert_array_equal(tres.mask.numpy(), d <= jtop.tau)
    np.testing.assert_array_equal(tres.dist.numpy(),
                                  np.where(d <= jtop.tau, d, BIG))


@pytest.mark.parametrize("L,b", [(16, 2), (32, 4), (40, 2)])
def test_single_search_matches_jax(L, b):
    db, jidx, tidx = built(L, b, "bst")
    q = queries(db, b, 2, seed=7)[0]
    tau = 3 if b == 2 else 6
    jres = js.search(jidx, q, tau)
    tres = ts.search(tidx, q, tau)
    assert tres.overflow.dim() == 0 and tres.traversed.dim() == 0
    assert_same(jres, tres)


@pytest.mark.parametrize("kind,batch", [("bst", True), ("bst", False),
                                        ("louds", True)])
def test_tombstone_searchers_match_jax(kind, batch):
    """``with_live=True``: dead ids never survive and fully dead leaves
    are pruned (at the verify, or on the leaves without a tail)."""
    db, jidx, tidx = built(16, 2, kind)
    qs = queries(db, 2, 3, seed=11)
    if not batch:
        qs = qs[0]
    id_live = np.random.default_rng(2).random(len(db)) < 0.6
    jrun = js.get_searcher(jidx, 3, batch=batch, with_live=True)
    trun = ts.get_searcher(tidx, 3, batch=batch, with_live=True)
    tres = trun(qs, torch.from_numpy(id_live))
    assert_same(jrun(jnp.asarray(qs), jnp.asarray(id_live)), tres)
    assert not tres.mask.numpy()[..., ~id_live].any()


@pytest.mark.parametrize("capacity", [1, 7, 40])
def test_compaction_and_selection_match_jax(capacity):
    """The building blocks later slices reuse: masked compaction (with
    overflow past ``capacity``), the root-plane scatter-min and the
    labeled (distance, label) selection with ties."""
    rng = np.random.default_rng(capacity)
    m, K, t_root = 3, 30, 9
    ids = rng.integers(0, t_root, size=(m, K)).astype(np.int32)
    dists = rng.integers(0, 5, size=(m, K)).astype(np.int32)
    valid = rng.random((m, K)) < 0.6
    tids, tdists, tvalid = (torch.from_numpy(x) for x in (ids, dists, valid))
    assert_same(js._compact_batch(jnp.asarray(ids), jnp.asarray(dists),
                                  jnp.asarray(valid), capacity),
                ts._compact_batch(tids, tdists, tvalid, capacity))
    assert_same(js._compact(jnp.asarray(ids[0]), jnp.asarray(dists[0]),
                            jnp.asarray(valid[0]), capacity),
                ts._compact(tids[0], tdists[0], tvalid[0], capacity))
    np.testing.assert_array_equal(
        ts.scatter_root_plane(tids, tdists, tvalid, m, t_root).numpy(),
        np.asarray(js.scatter_root_plane(jnp.asarray(ids), jnp.asarray(dists),
                                         jnp.asarray(valid), m, t_root)))
    plane = np.where(valid, dists, BIG).astype(np.int32)     # ties + BIG
    labels = rng.permutation(1000)[:K].astype(np.int32)
    k = min(capacity, K)
    assert_same(js.select_topk_columns(jnp.asarray(plane), jnp.asarray(labels), k),
                ts.select_topk_columns(torch.from_numpy(plane),
                                       torch.from_numpy(labels), k))


def test_topk_ties_from_duplicated_rows():
    """Every row appears three times: ties at each distance order by id."""
    rng = np.random.default_rng(21)
    base = rng.integers(0, 4, size=(60, 12)).astype(np.uint8)
    db = np.concatenate([base, base, base])[rng.permutation(180)]
    jidx, tidx = jbst.build_bst(db, 2), tbst.build_bst(db, 2, device="cpu")
    qs = np.stack([db[0], db[5], rng.integers(0, 4, size=12).astype(np.uint8)])
    jtop = js.topk_batch(jidx, qs, 7)
    ttop = ts.topk_batch(tidx, qs, 7)
    assert ttop.tau == jtop.tau
    np.testing.assert_array_equal(ttop.ids.numpy(), np.asarray(jtop.ids))
    np.testing.assert_array_equal(ttop.dists.numpy(), np.asarray(jtop.dists))
    d = (qs[:, None] != db[None]).sum(2)
    for i in range(len(qs)):
        want = np.lexsort((np.arange(len(db)), d[i]))[:7]
        np.testing.assert_array_equal(ttop.ids[i].numpy(), want)


def test_topk_k_exceeds_n_pads():
    rng = np.random.default_rng(12)
    db = rng.integers(0, 4, size=(40, 12)).astype(np.uint8)
    jidx, tidx = jbst.build_bst(db, 2), tbst.build_bst(db, 2, device="cpu")
    jtop = js.topk(jidx, db[0], 64)
    ttop = ts.topk(tidx, db[0], 64)
    assert ttop.ids.shape == (64,) and ttop.tau == jtop.tau
    np.testing.assert_array_equal(ttop.ids.numpy(), np.asarray(jtop.ids))
    np.testing.assert_array_equal(ttop.dists.numpy(), np.asarray(jtop.dists))
    assert (ttop.ids.numpy()[40:] == -1).all()
    assert (ttop.dists.numpy()[40:] == BIG).all()


def test_overflow_ladder_matches_jax():
    """A small ``cap_max`` overflows the frontier: the first rung reports
    the same overflow in both packages, and both ladders converge to the
    same exact answer."""
    db, jidx, tidx = built(16, 2, "bst")
    qs = queries(db, 2, 3, seed=5)
    jres = js.make_batch_searcher(jidx, 4, cap_max=256)(jnp.asarray(qs))
    tres = ts.make_batch_searcher(tidx, 4, cap_max=256)(qs)
    assert int(tres.overflow.sum()) > 0
    assert_same(jres, tres)
    jtop = js.topk_batch(jidx, qs, 10, tau0=4, cap_max=256)
    ttop = ts.topk_batch(tidx, qs, 10, tau0=4, cap_max=256)
    assert ttop.overflow == jtop.overflow == 0 and ttop.tau == jtop.tau
    np.testing.assert_array_equal(ttop.ids.numpy(), np.asarray(jtop.ids))
    np.testing.assert_array_equal(ttop.dists.numpy(), np.asarray(jtop.dists))


def test_searcher_cache_counts_and_bucketing():
    db, _, tidx = built(16, 2, "bst")
    ts.clear_searcher_cache()
    run = ts.make_batch_searcher(tidx, 2)
    assert ts.searcher_cache_info() == {"hits": 0, "misses": 1, "traces": 0,
                                        "size": 1}
    assert ts.make_batch_searcher(tidx, 2) is run
    assert ts.searcher_cache_info()["hits"] == 1
    ts.make_batch_searcher(tidx, 3)
    assert ts.searcher_cache_info()["misses"] == 2
    assert ts.bucket_m(5) == 8 and ts.bucket_m(8) == 8 and ts.bucket_m(1) == 1
    qs = torch.from_numpy(queries(db, 2, 5, seed=3).astype(np.int32))
    padded = ts._pad_rows(qs, 8)
    assert padded.shape == (8, 16) and (padded[5:] == qs[-1]).all()
    with pytest.raises(ValueError):
        ts.bucket_m(0)


def test_linear_scan_matches_jax():
    from repro.core.baselines import LinearScan as JLinearScan
    from repro_torch.core import LinearScan
    db, _, _ = built(16, 2, "bst")
    qs = queries(db, 2, 4, seed=9)
    jscan, tscan = JLinearScan.build(db, 2), LinearScan.build(db, 2, device="cpu")
    assert tscan.array_bytes() == jscan.array_bytes()
    np.testing.assert_array_equal(tscan.full_vert.numpy().view(np.uint32),
                                  np.asarray(jscan.full_vert))
    np.testing.assert_array_equal(tscan.distances(qs).numpy(),
                                  (qs[:, None] != db[None]).sum(2))
    for q in qs:
        np.testing.assert_array_equal(tscan.search(q, 3), jscan.search(q, 3))
