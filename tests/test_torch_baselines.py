"""The port's baselines (SIH, MIH, HmSearch, the signature enumeration)
against the JAX package's and against ``LinearScan``.

The same seeded numpy sketches go through ``repro.core.baselines`` and
``repro_torch.core.baselines`` on the CPU (the verify's scan wrapper runs
its plain version here).  Held: the enumerated signatures with and
without ``limit``, and every baseline's mask, truncation flag and
candidate count, at b in {1, 2, 4} and, for HmSearch, b = 8, where its
position byte keeps a wildcard from colliding with a real symbol.
Tolerance: bit for bit (the outputs are integers and bools).  MIH is
exact only where its block thresholds keep the pigeonhole bound (F4,
``mih_exact``), in both packages alike.

At b = 8 the JAX package's ``enumerate_signatures`` raises under NumPy 2
(``(q[p] + combo) % 256`` on uint8: 256 does not fit the type; ROADMAP
Queue 3, F3); the port adds in int64, and is held there against
``LinearScan`` and brute force.
"""

import numpy as np
import pytest

from repro.core import baselines as jb
from repro_torch.core import baselines as tb
from repro_torch.core import cost_model as tcm


def corpus(rng, n, L, b):
    db = rng.integers(0, 1 << b, size=(n, L)).astype(np.uint8)
    db[n - n // 8:] = db[: n // 8]
    return db


def near(rng, db, b, changes):
    q = db[rng.integers(0, len(db))].copy()
    pos = rng.choice(db.shape[1], size=changes, replace=False)
    q[pos] = (q[pos].astype(np.int64) + 1) % (1 << b)
    return q


def mih_exact(tau, m):
    """MIH finds every id within τ iff its block thresholds τ^j satisfy
    the pigeonhole bound Σ (τ^j + 1) > τ.  The MIH rule of
    ``cost_model.block_thresholds`` (a copy of the JAX package's) gives
    the first τ − m⌊τ/m⌋ + 1 blocks ⌊τ/m⌋ − 1, which breaks it at, e.g.,
    τ = 3, m = 2 (thresholds [0, 0]; ROADMAP Queue 3, F4); the port
    keeps the rule for parity."""
    return sum(t + 1 for t in tcm.block_thresholds(tau, m, mih_style=True)) > tau


@pytest.mark.parametrize("b,L", [(1, 12), (2, 10), (4, 6)])
@pytest.mark.parametrize("tau", [0, 1, 2, 3])
@pytest.mark.parametrize("limit", [None, 40])
def test_enumerate_signatures_matches_jax(b, L, tau, limit):
    rng = np.random.default_rng(b * 10 + tau)
    q = rng.integers(0, 1 << b, size=L).astype(np.uint8)
    want, wtr = jb.enumerate_signatures(q, b, tau, limit)
    got, gtr = tb.enumerate_signatures(q, b, tau, limit)
    np.testing.assert_array_equal(got, want)
    assert gtr == wtr
    if limit is None:
        d = (got != q[None]).sum(1)
        assert (d <= tau).all() and len(np.unique(got, axis=0)) == len(got)


@pytest.mark.parametrize("b,L", [(1, 16), (2, 16), (4, 12)])
def test_baselines_match_jax_and_linear_scan(b, L):
    rng = np.random.default_rng(b + L)
    db = corpus(rng, 500, L, b)
    ls = tb.LinearScan.build(db, b, device="cpu")
    sih_j, sih_t = jb.SIH.build(db, b), tb.SIH.build(db, b)
    mih_j, mih_t = jb.MIH.build(db, b, 2), tb.MIH.build(db, b, 2,
                                                        device="cpu")
    assert sih_t.array_bytes() == sih_j.array_bytes()
    assert mih_t.array_bytes() == mih_j.array_bytes()
    for tau in (0, 1, 2, 3):
        hm_j = jb.HmSearch.build(db, b, tau)
        hm_t = tb.HmSearch.build(db, b, tau, device="cpu")
        assert hm_t.m == hm_j.m and hm_t.array_bytes() == hm_j.array_bytes()
        for changes in (0, 1, 2):
            q = near(rng, db, b, changes)
            want = ls.search(q, tau)
            np.testing.assert_array_equal(
                want, np.asarray(jb.LinearScan.build(db, b).search(q, tau)))
            for j, t in ((sih_j.search(q, tau, limit=20_000),
                          sih_t.search(q, tau, limit=20_000)),
                         (mih_j.search(q, tau), mih_t.search(q, tau)),
                         (hm_j.search(q, tau), hm_t.search(q, tau))):
                np.testing.assert_array_equal(t[0], j[0])
                assert t[1:] == j[1:]
            # the filters are exact where their pigeonhole bound holds
            np.testing.assert_array_equal(hm_t.search(q, tau)[0], want)
            if mih_exact(tau, 2):
                np.testing.assert_array_equal(mih_t.search(q, tau)[0], want)
            mask, truncated = sih_t.search(q, tau, limit=20_000)
            if not truncated:
                np.testing.assert_array_equal(mask, want)


def test_sih_truncates_like_jax():
    rng = np.random.default_rng(3)
    db = corpus(rng, 300, 16, 2)
    q = db[0]
    for limit in (1, 10, 100):
        j = jb.SIH.build(db, 2).search(q, 3, limit=limit)
        t = tb.SIH.build(db, 2).search(q, 3, limit=limit)
        np.testing.assert_array_equal(t[0], j[0])
        assert t[1] == j[1] is True


def test_hmsearch_b8_no_wildcard_collision():
    """b = 8: the zeroed wildcard byte equals a real symbol 0; the
    position byte keeps the variant keys apart, on both packages."""
    rng = np.random.default_rng(8)
    db = corpus(rng, 400, 8, 8)
    db[:20, 3] = 0                    # real zeros where wildcards go
    ls = tb.LinearScan.build(db, 8, device="cpu")
    for tau in (0, 1, 2, 3):
        hm_j = jb.HmSearch.build(db, 8, tau)
        hm_t = tb.HmSearch.build(db, 8, tau, device="cpu")
        for changes in (0, 1, 2):
            q = near(rng, db, 8, changes)
            j, t = hm_j.search(q, tau), hm_t.search(q, tau)
            np.testing.assert_array_equal(t[0], j[0])
            assert t[1] == j[1]
            np.testing.assert_array_equal(t[0], ls.search(q, tau))


def test_b8_enumeration_past_the_reference_fault():
    """F3: at b = 8 the port enumerates (the reference raises), and SIH
    and MIH answer exactly; at τ^j = 0 both packages agree."""
    rng = np.random.default_rng(18)
    db = corpus(rng, 300, 6, 8)
    q = near(rng, db, 8, 1)
    sigs, truncated = tb.enumerate_signatures(q, 8, 1)
    assert not truncated and len(sigs) == 1 + 6 * 255
    assert ((sigs != q[None]).sum(1) <= 1).all()
    assert len(np.unique(sigs, axis=0)) == len(sigs)
    ls = tb.LinearScan.build(db, 8, device="cpu")
    for tau in (1, 2):
        mask, truncated = tb.SIH.build(db, 8).search(q, tau,
                                                     limit=2_000_000)
        assert not truncated
        np.testing.assert_array_equal(mask, ls.search(q, tau))
        np.testing.assert_array_equal(
            tb.MIH.build(db, 8, 2, device="cpu").search(q, tau)[0],
            ls.search(q, tau))
    # τ = 0 and MIH's τ^j = 0 at τ = 1 never reach the faulty addition
    for tau in (0, 1):
        j = jb.MIH.build(db, 8, 2).search(q, tau)
        t = tb.MIH.build(db, 8, 2, device="cpu").search(q, tau)
        np.testing.assert_array_equal(t[0], j[0])
        assert t[1:] == j[1:]


def test_mih_threshold_rule_misses_like_jax():
    """F4: at τ = 3 and m = 2 the MIH thresholds are [0, 0], so an id at
    distance 2 split 1 + 1 over the blocks is missed — by both packages,
    identically."""
    assert not mih_exact(3, 2) and mih_exact(2, 2)
    db = np.zeros((2, 8), np.uint8)
    db[1, [0, 4]] = 1                  # one mismatch in each block
    q = db[0]
    j = jb.MIH.build(db, 2, 2).search(q, 3)
    t = tb.MIH.build(db, 2, 2, device="cpu").search(q, 3)
    np.testing.assert_array_equal(t[0], j[0])
    assert t[1:] == j[1:]
    np.testing.assert_array_equal(t[0], [True, False])
    assert tb.LinearScan.build(db, 2, device="cpu").search(q, 3).all()
