"""The port's sharded bST against the JAX package's.

The same seeded numpy sketches go through
``repro.core.distributed_search`` (one SPMD program vmapped over the
shard axis) and ``repro_torch.core.distributed_search`` on the CPU (a
loop over the shards, then one shard-batched verify whose wrapper runs
its plain version here).  Held: the searcher's masks, distances and
overflow at S in {1, 3, 4}, τ in {0, 1, 2}, both verify modes and both
capacity modes; other geometries; ``sharded_column_dists`` with a
tombstone lane; ``gather_ids`` and ``gather_topk`` (ties by id) against
brute force; a lost shard rebuilt; the result's independence of the
shard count; the padded arrays and ``sharded_bst_from_numpy`` on the
JAX package's own arrays.  Tolerance: bit for bit (every output is an
integer or a bool).

``tests/test_distributed_search.py::test_sharded_lowers_on_spmd_mesh``
checks that the JAX searcher lowers with its shard axis on a device
mesh; on one card the shard axis is a batched dimension and there is no
mesh to lower onto, so it has no counterpart here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed_search as jd
from repro.core.cost_model import frontier_capacities as jcaps
from repro_torch.core import distributed_search as td
from repro_torch.core.cost_model import frontier_capacities
from repro_torch.kernels import ops

BIG = 1 << 20


def db_of(n, L, b, seed=0, dup=0.15):
    rng = np.random.default_rng(seed)
    db = rng.integers(0, 1 << b, size=(n, L)).astype(np.uint8)
    k = int(n * dup)
    db[n - k:] = db[:k]
    return db


def queries_of(db, b, seed, m=6):
    rng = np.random.default_rng(seed)
    L = db.shape[1]
    near = db[rng.integers(0, len(db), size=m - 2)].copy()
    for row in near:
        pos = rng.choice(L, size=rng.integers(0, 3), replace=False)
        row[pos] = (row[pos].astype(np.int64) + 1) % (1 << b)
    return np.concatenate([near, rng.integers(0, 1 << b, size=(2, L))
                           .astype(np.uint8)])


def brute(qs, db):
    return (qs[:, None, :] != db[None, :, :]).sum(-1)


def assert_search_equal(jidx, tidx, qs, tau, **kw):
    jm, jdist, jov = jd.make_sharded_searcher(jidx, tau, **kw)(
        jnp.asarray(qs))
    tm, tdist, tov = td.make_sharded_searcher(tidx, tau, **kw)(qs)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm), err_msg=str(kw))
    np.testing.assert_array_equal(tdist.numpy(), np.asarray(jdist),
                                  err_msg=str(kw))
    assert int(tov) == int(jov), (kw, int(tov), int(jov))
    return tm, tdist, int(tov)


@pytest.mark.parametrize("n_shards", [1, 3, 4])
@pytest.mark.parametrize("verify", ["scan", "gather"])
@pytest.mark.parametrize("caps_mode", ["worst", "expected"])
def test_sharded_searcher_matches_jax(n_shards, verify, caps_mode):
    L, b = 12, 2
    db = db_of(450, L, b, seed=n_shards)
    qs = queries_of(db, b, seed=n_shards + 10)
    jidx = jd.build_sharded_bst(db, b, n_shards)
    tidx = td.build_sharded_bst(db, b, n_shards, device="cpu")
    d = brute(qs, db)
    for tau in (0, 1, 2):
        masks, dists, ov = assert_search_equal(
            jidx, tidx, qs, tau, verify=verify, caps_mode=caps_mode)
        if ov == 0:
            for qi, got in enumerate(td.gather_ids(tidx, masks)):
                np.testing.assert_array_equal(got, np.flatnonzero(d[qi] <= tau))


@pytest.mark.parametrize("L,b,n_shards", [(24, 2, 4), (32, 4, 3), (8, 2, 4),
                                          (16, 1, 2)])
def test_other_geometries_match_jax(L, b, n_shards):
    db = db_of(360, L, b, seed=L + b)
    qs = queries_of(db, b, seed=L)
    jidx = jd.build_sharded_bst(db, b, n_shards)
    tidx = td.build_sharded_bst(db, b, n_shards, device="cpu")
    assert (tidx.kinds, tidx.lm, tidx.ls, tidx.n_max) == \
        (jidx.kinds, jidx.lm, jidx.ls, jidx.n_max)
    for tau in (1, 3):
        for verify in ("scan", "gather"):
            assert_search_equal(jidx, tidx, qs, tau, verify=verify)


def test_capacity_overflow_matches_jax():
    """A starved cap_max drops frontier entries: the same overflow, and
    the same partial planes, on both."""
    db = db_of(600, 12, 2, seed=4)
    qs = queries_of(db, 2, seed=5)
    jidx = jd.build_sharded_bst(db, 2, 3)
    tidx = td.build_sharded_bst(db, 2, 3, device="cpu")
    for verify in ("scan", "gather"):
        _, _, ov = assert_search_equal(jidx, tidx, qs, 3, cap_max=8,
                                       verify=verify)
        assert ov > 0


@pytest.mark.parametrize("n_shards", [1, 4])
def test_sharded_column_dists_with_live(n_shards):
    L, b = 12, 2
    db = db_of(380, L, b, seed=20 + n_shards)
    qs = queries_of(db, b, seed=21)
    jidx = jd.build_sharded_bst(db, b, n_shards)
    tidx = td.build_sharded_bst(db, b, n_shards, device="cpu")
    live = np.random.default_rng(3).random(len(db)) > 0.3
    for tau in (1, 2):
        t_max = tuple(int(x) for x in np.asarray(jidx.t).max(axis=0))
        caps = jcaps(t_max, b, tau, 1 << 14)
        assert caps == frontier_capacities(t_max, b, tau, 1 << 14)
        for lv in (None, live):
            want, wov = jd.sharded_column_dists(
                jidx, jnp.asarray(qs), tau, caps,
                live=None if lv is None else jnp.asarray(lv))
            got, gov = td.sharded_column_dists(
                tidx, torch.from_numpy(qs.astype(np.int32)), tau, caps,
                live=None if lv is None else torch.from_numpy(lv))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert int(gov) == int(wov)
            d = brute(qs, db)
            ok = d <= tau if lv is None else (d <= tau) & lv[None]
            np.testing.assert_array_equal(got.numpy(), np.where(ok, d, BIG))


@pytest.mark.parametrize("n_shards", [1, 3])
def test_gather_topk_ties_by_id(n_shards):
    n, L, b, tau, k = 240, 10, 2, 4, 7
    rng = np.random.default_rng(8)
    base = rng.integers(0, 1 << b, size=(40, L), dtype=np.uint8)
    db = base[rng.integers(0, 40, size=n)]          # many exact duplicates
    qs = db[:3]
    jidx = jd.build_sharded_bst(db, b, n_shards)
    tidx = td.build_sharded_bst(db, b, n_shards, device="cpu")
    _, tdist, ov = assert_search_equal(jidx, tidx, qs, tau)
    assert ov == 0
    _, jdist, _ = jd.make_sharded_searcher(jidx, tau)(jnp.asarray(qs))
    ids, dk = td.gather_topk(tidx, tdist, k)
    wids, wdk = jd.gather_topk(jidx, np.asarray(jdist), k)
    np.testing.assert_array_equal(ids, wids)
    np.testing.assert_array_equal(dk, wdk)
    d = brute(qs, db)
    for qi in range(len(qs)):
        dq = np.where(d[qi] <= tau, d[qi], BIG)
        want = np.lexsort((np.arange(n), dq))[:k]
        real = dq[want] < BIG
        np.testing.assert_array_equal(ids[qi], np.where(real, want, -1))
        np.testing.assert_array_equal(dk[qi], dq[want])


def test_shard_loss_rebuild():
    """A lost shard rebuilt from its slice of the raw data gives identical
    arrays and answers (the build is a pure function of the data)."""
    db = db_of(400, 12, 2)
    idx1 = td.build_sharded_bst(db, 2, 4, device="cpu")
    idx2 = td.build_sharded_bst(db, 2, 4, device="cpu")
    for a, c in zip(idx1.levels, idx2.levels):
        for x, y in zip(a[1:], c[1:]):
            assert (x is None and y is None) or torch.equal(x, y)
    q = db_of(5, 12, 2, seed=3)
    m1 = td.make_sharded_searcher(idx1, 2)(q)[0]
    m2 = td.make_sharded_searcher(idx2, 2)(q)[0]
    assert torch.equal(m1, m2)


@pytest.mark.parametrize("seed", range(6))
def test_shard_count_invariance(seed):
    """The result set does not depend on the shard count (the elastic
    scaling invariant), and a padded lane never comes out live."""
    rng = np.random.default_rng(seed)
    b = int(rng.choice([1, 2, 4]))
    L = int(rng.integers(4, 20))
    n = int(rng.integers(5, 90))
    db = rng.integers(0, 1 << b, size=(n, L)).astype(np.uint8)
    tau = int(rng.integers(0, 3))
    q = db[:2]
    ref = td.build_sharded_bst(db, b, 1, device="cpu")
    got1 = td.gather_ids(ref, td.make_sharded_searcher(ref, tau)(q)[0])
    for n_shards in range(2, 5):
        if n < n_shards:
            continue
        idx = td.build_sharded_bst(db, b, n_shards, device="cpu")
        masks, dists, _ = td.make_sharded_searcher(idx, tau)(q)
        pad = (torch.arange(idx.n_max)[None, :]
               >= idx.n_local[:, None])                # (S, n_max)
        assert not masks[:, pad].any()
        assert (dists[:, pad] == BIG).all()
        for a, c in zip(got1, td.gather_ids(idx, masks)):
            np.testing.assert_array_equal(np.sort(a), np.sort(c))


def sharded_arrays(jidx):
    """The JAX ShardedBST's arrays in ``sharded_bst_from_numpy`` order."""
    arrays = []
    for lv in jidx.levels:
        if lv.kind == "table":
            arrays += [lv.words, lv.cum]
        elif lv.kind == "list":
            arrays += [lv.words, lv.cum, lv.labels]
    arrays += [jidx.t, jidx.paths_vert, jidx.d_words, jidx.d_cum,
               jidx.leaf_root, jidx.id_leaf, jidx.n_local, jidx.shard_of,
               jidx.pos_of]
    return [np.asarray(a) for a in arrays]


def test_padded_arrays_and_from_numpy_match_jax():
    db = db_of(700, 16, 2, seed=9)
    qs = queries_of(db, 2, seed=9)
    jidx = jd.build_sharded_bst(db, 2, 4)
    tidx = td.build_sharded_bst(db, 2, 4, device="cpu")
    jarr, tarr = sharded_arrays(jidx), []
    for lv in tidx.levels:
        tarr += [a for a in (lv.words, lv.cum, lv.labels) if a is not None]
    tarr += [tidx.t, tidx.paths_vert, tidx.d_words, tidx.d_cum,
             tidx.leaf_root, tidx.id_leaf, tidx.n_local]
    for want, got in zip(jarr, tarr):
        got = got.numpy()
        if want.dtype == np.uint32:
            got = got.view(np.uint32)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tidx.shard_of, jidx.shard_of)
    np.testing.assert_array_equal(tidx.pos_of, jidx.pos_of)
    assert tidx.array_bytes() == jidx.array_bytes()
    assert tidx.model_bits() == jidx.model_bits()
    assert tidx.max_leaves_per_root == jidx.max_leaves_per_root
    meta = dict(L=jidx.L, b=jidx.b, lm=jidx.lm, ls=jidx.ls, kinds=jidx.kinds,
                n_max=jidx.n_max,
                max_leaves_per_root=jidx.max_leaves_per_root)
    carried = td.sharded_bst_from_numpy(meta, jarr, "cpu")
    for verify in ("scan", "gather"):
        assert_search_equal(jidx, carried, qs, 2, verify=verify)
    with pytest.raises(ValueError):
        td.sharded_bst_from_numpy(meta, jarr + [jarr[-1]], "cpu")


def test_rank_select_and_expected_caps_match_jax():
    rng = np.random.default_rng(12)
    bits = (rng.random(300) < 0.4).astype(np.uint8)
    jbv = jd.BitVector.from_bits(bits)
    words = torch.from_numpy(np.asarray(jbv.words).view(np.int32).copy())
    cum = torch.from_numpy(np.asarray(jbv.cum).copy())
    i = rng.integers(-3, 320, size=64).astype(np.int32)
    k = rng.integers(-2, 140, size=64).astype(np.int32)
    for length in (300, 250, 31):
        np.testing.assert_array_equal(
            td._rank(words, cum, torch.from_numpy(i), length).numpy(),
            np.asarray(jd._rank(jbv.words, jbv.cum, jnp.asarray(i),
                                jnp.int32(length))))
        np.testing.assert_array_equal(
            td._select(words, cum, torch.from_numpy(k), length).numpy(),
            np.asarray(jd._select(jbv.words, jbv.cum, jnp.asarray(k),
                                  jnp.int32(length))))
    t = (1, 4, 16, 64, 250, 900, 2000, 3000)
    for tau in range(4):
        assert td.expected_caps(t, 2, tau) == jd.expected_caps(t, 2, tau)


def test_scan_verify_is_one_shard_batched_launch():
    db = db_of(300, 12, 2, seed=2)
    tidx = td.build_sharded_bst(db, 2, 4, device="cpu")
    ops.reset_kernel_stats()
    td.make_sharded_searcher(tidx, 2)(db[:5])
    stats = ops.kernel_stats()
    assert stats["sparse_verify_batch_batched:ref"] == 1
    assert "sparse_verify_batch:ref" not in stats
    ops.reset_kernel_stats()
    td.make_sharded_searcher(tidx, 2, verify="gather")(db[:2])
    # the per-query gather mode runs the plain verify, per query and shard
    assert ops.kernel_stats() == {"sparse_verify:ref": 8}


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        td.build_sharded_bst(np.zeros((8, 8), np.uint8), 2, 2)
