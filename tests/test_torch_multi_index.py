"""The port's MI-bST against the JAX package's.

The same seeded numpy sketches (with duplicated rows, so that ties and
shared leaves are routine) go through ``repro.core.multi_index`` (its
verify in the Pallas interpret mode or the jnp oracle, as the JAX tests
run it) and ``repro_torch.core.multi_index`` on the CPU, where the
batched scan wrapper runs its plain version.  Held: ``mi_search_batch``
with and without a tombstone mask at b in {1, 2, 4} and m in {2, 3}
blocks, the single-query searcher, the overflow ladder from a starved
candidate capacity, ``candidate_capacity`` and ``choose_plan``, the
space accounting, and ``multi_index_from_numpy`` on the JAX package's
own arrays.  Tolerance: bit for bit (masks, distances, candidate counts,
overflow; every output is an integer or a bool).
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import multi_index as jmi
from repro_torch.core import multi_index as tmi
from repro_torch.kernels import ops

REVIEW_N = 12_886_488


def corpus(rng, n, L, b):
    db = rng.integers(0, 1 << b, size=(n, L)).astype(np.uint8)
    db[n - n // 6:] = db[: n // 6]
    return db


def queries(rng, db, b, m=5):
    """Database rows with one or two symbols changed, and uniform rows."""
    L = db.shape[1]
    near = db[rng.integers(0, len(db), size=m - 1)].copy()
    for row in near:
        pos = rng.choice(L, size=rng.integers(1, 3), replace=False)
        row[pos] = (row[pos].astype(np.int64) + 1) % (1 << b)
    return np.concatenate([near, rng.integers(0, 1 << b, size=(1, L))
                           .astype(np.uint8)])


def assert_result_equal(j, t, where):
    for field in j._fields:
        np.testing.assert_array_equal(
            getattr(t, field).numpy(), np.asarray(getattr(j, field)),
            err_msg=f"{where}: {field}")


@pytest.mark.parametrize("b", [1, 2, 4])
@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("with_live", [False, True])
def test_mi_search_batch_matches_jax(b, m, with_live):
    rng = np.random.default_rng(100 * b + 10 * m + with_live)
    L = 16 if b < 4 else 12
    db = corpus(rng, 500, L, b)
    qs = queries(rng, db, b)
    jidx = jmi.build_multi_index(db, b, m)
    tidx = tmi.build_multi_index(db, b, m, device="cpu")
    assert tidx.bounds == jidx.bounds
    live = (rng.random(len(db)) > 0.25) if with_live else None
    for tau in (0, 1, 2, 4):
        want = jmi.mi_search_batch(jidx, qs, tau, id_live=live)
        got = tmi.mi_search_batch(tidx, qs, tau, id_live=live)
        assert_result_equal(want, got, f"b={b} m={m} tau={tau}")
        assert got.mask.dtype == torch.bool and got.dist.dtype == torch.int32
        if live is not None:
            assert not got.mask.numpy()[:, ~live].any()
    assert tidx.model_bits() == jidx.model_bits()
    assert tidx.array_bytes() == jidx.array_bytes()


def test_single_query_searcher_and_mi_search_match_jax():
    rng = np.random.default_rng(7)
    db = corpus(rng, 400, 16, 2)
    qs = queries(rng, db, 2, m=3)
    jidx = jmi.build_multi_index(db, 2, 2)
    tidx = tmi.build_multi_index(db, 2, 2, device="cpu")
    for tau in (1, 3):
        for q in qs:
            assert_result_equal(jmi.mi_search(jidx, q, tau),
                                tmi.mi_search(tidx, q, tau), f"tau={tau}")
            want = jmi.make_mi_searcher(jidx, tau)(jax.numpy.asarray(q))
            got = tmi.make_mi_searcher(tidx, tau)(q)
            assert_result_equal(want, got, f"single tau={tau}")


def test_overflow_ladder_from_a_starved_candidate_capacity():
    """A candidate capacity of 4 drops candidates: the searcher reports
    the same overflow as JAX's, and the ladder ends exact on both."""
    rng = np.random.default_rng(11)
    db = corpus(rng, 600, 12, 2)
    qs = db[:4]
    jidx = jmi.build_multi_index(db, 2, 2)
    tidx = tmi.build_multi_index(db, 2, 2, device="cpu")
    want = jmi.make_mi_searcher(jidx, 3, cand_cap=4, batch=True)(
        jax.numpy.asarray(qs))
    got = tmi.make_mi_searcher(tidx, 3, cand_cap=4, batch=True)(qs)
    assert int(got.overflow.sum()) > 0
    assert_result_equal(want, got, "starved")
    assert_result_equal(jmi.mi_search_batch(jidx, qs, 3),
                        tmi.mi_search_batch(tidx, qs, 3), "ladder")


def test_searcher_cache_pins_and_clears():
    rng = np.random.default_rng(2)
    tidx = tmi.build_multi_index(corpus(rng, 200, 12, 2), 2, 2, device="cpu")
    tmi.clear_mi_searcher_cache()
    f1 = tmi.make_mi_searcher(tidx, 2, batch=True)
    assert tmi.make_mi_searcher(tidx, 2, batch=True) is f1
    assert tmi.make_mi_searcher(tidx, 2, batch=True, with_live=True) is not f1
    assert all(entry[0] is tidx for entry in tmi._MI_SEARCHER_CACHE.values())
    tmi.clear_mi_searcher_cache()
    assert not tmi._MI_SEARCHER_CACHE


@pytest.mark.parametrize("b,L,n", [(2, 16, REVIEW_N), (2, 16, 1 << 20),
                                   (4, 32, 1 << 22), (1, 64, 10_000)])
def test_candidate_capacity_and_choose_plan_match_jax(b, L, n):
    rng = np.random.default_rng(n % 97)
    db = corpus(rng, 64, L, b)
    for m in (2, 3, 4):
        jidx = jmi.build_multi_index(db, b, m)
        tidx = tmi.build_multi_index(db, b, m, device="cpu")
        # the capacity at the geometry's n: only n, b and the bounds enter
        jbig = jmi.MultiIndex(jidx.blocks, jidx.full_vert, jidx.bounds,
                              L, b, n)
        tbig = tmi.MultiIndex(tidx.blocks, tidx.full_vert, tidx.bounds,
                              L, b, n)
        for tau in range(6):
            assert tmi.candidate_capacity(tbig, tau) == \
                jmi.candidate_capacity(jbig, tau)
            assert tmi.mi_trace_params(tidx, tau) == \
                jmi.mi_trace_params(jidx, tau)
    for tau in range(8):
        assert tmi.choose_plan(b, L, tau, n) == jmi.choose_plan(b, L, tau, n)
    if n == REVIEW_N:
        assert tmi.choose_plan(2, 16, 3, n) == ("multi", 2)


def test_multi_index_from_numpy_carries_the_jax_arrays():
    rng = np.random.default_rng(5)
    db = corpus(rng, 300, 16, 2)
    qs = queries(rng, db, 2)
    jidx = jmi.build_multi_index(db, 2, 3)
    meta = dict(L=jidx.L, b=jidx.b, n=jidx.n, bounds=jidx.bounds,
                blocks=[dict(L=blk.L, b=blk.b, n=blk.n, t=blk.t, lm=blk.lm,
                             ls=blk.ls, kinds=blk.kinds,
                             tail=blk.tail is not None)
                        for blk in jidx.blocks])
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jidx)]
    carried = tmi.multi_index_from_numpy(meta, leaves, "cpu")
    built = tmi.build_multi_index(db, 2, 3, device="cpu")
    assert carried.model_bits() == built.model_bits() == jidx.model_bits()
    np.testing.assert_array_equal(carried.full_vert.numpy().view(np.uint32),
                                  np.asarray(jidx.full_vert))
    for tau in (1, 2):
        assert_result_equal(jmi.mi_search_batch(jidx, qs, tau),
                            tmi.mi_search_batch(carried, qs, tau),
                            f"carried tau={tau}")
    with pytest.raises(ValueError):
        tmi.multi_index_from_numpy(meta, leaves + [leaves[-1]], "cpu")


def test_verify_is_one_batched_launch_per_search():
    """Every query's candidates go through ONE candidate verify call,
    and no batched scan."""
    rng = np.random.default_rng(3)
    db = corpus(rng, 300, 12, 2)
    tidx = tmi.build_multi_index(db, 2, 2, device="cpu")
    caps, cc = tmi.mi_trace_params(tidx, 2)
    ops.reset_kernel_stats()
    tmi.mi_column_dists(tidx, torch.from_numpy(db[:9].astype(np.int32)), 2,
                        caps, cc)
    stats = ops.kernel_stats()
    assert stats["hamming_distances_gather:ref"] == 1
    assert not any(k.startswith("hamming_distances_batched") for k in stats)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmi.build_multi_index(np.zeros((4, 8), np.uint8), 2, 2)
