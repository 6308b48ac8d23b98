"""The port's sketching and packers against the JAX package.

``bbit_minhash`` runs with the hash parameters the JAX package draws
from its key (``_hash_params``), handed to the port as explicit arrays;
the packers and ``jaccard`` take the same seeded numpy inputs.
Tolerance: bit-exact — sketches are uint8, packed words uint32 (compared
through the port's int32 bit-views), Jaccard values float32 bit
patterns.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hamming as JH
from repro.core import sketch as JS
from repro_torch.core import hamming as TH
from repro_torch.core import sketch as TS


def jax_params(seed: int, L: int):
    a, c = JS._hash_params(jax.random.PRNGKey(seed), L)
    return np.asarray(a), np.asarray(c)


def padded_sets(rng, batch, max_items, vocab):
    items = rng.integers(0, vocab, size=(batch, max_items)).astype(np.int32)
    mask = rng.random((batch, max_items)) < 0.7
    mask[:, 0] = True
    return items, mask


@pytest.mark.parametrize("L,b", [(16, 2), (32, 2), (64, 4), (8, 1), (24, 8)])
@pytest.mark.parametrize("vocab", [256, 2 ** 31 - 1])
def test_bbit_minhash_matches_jax(L, b, vocab):
    """Large ids drive a·x + c and both mixer multiplies through the
    uint32 wraparound."""
    rng = np.random.default_rng(L * 10 + b)
    items, mask = padded_sets(rng, 9, 40, vocab)
    key = jax.random.PRNGKey(L + b)
    want = np.asarray(JS.bbit_minhash(key, jnp.asarray(items),
                                      jnp.asarray(mask), L=L, b=b))
    params = tuple(np.asarray(p) for p in JS._hash_params(key, L))
    got = TS.bbit_minhash(params, torch.from_numpy(items),
                          torch.from_numpy(mask), L=L, b=b)
    assert got.dtype == torch.uint8 and got.shape == (9, L)
    np.testing.assert_array_equal(got.numpy(), want)


def test_mix32_wraps_like_uint32():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 2 ** 32, size=1000, dtype=np.uint64)
    x[:4] = [0, 1, 2 ** 32 - 1, 2 ** 31]
    want = np.asarray(JS._mix32(jnp.asarray(x.astype(np.uint32))))
    got = TS._mix32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_sketch_tokens_matches_jax():
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 1000, size=(5, 30)).astype(np.int32)
    toks[:, 20:] = -1                                  # padding
    key = jax.random.PRNGKey(2)
    want = np.asarray(JS.sketch_tokens(key, jnp.asarray(toks), L=16, b=2))
    got = TS.sketch_tokens(jax_params(2, 16), torch.from_numpy(toks), L=16,
                           b=2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_jaccard_matches_jax():
    rng = np.random.default_rng(5)
    ia, ma = padded_sets(rng, 12, 20, 30)
    ib, mb = padded_sets(rng, 12, 20, 30)
    ib[3], mb[3] = ia[3], ma[3]                        # identical sets
    want = np.asarray(JS.jaccard(jnp.asarray(ia), jnp.asarray(ma),
                                 jnp.asarray(ib), jnp.asarray(mb)))
    got = TS.jaccard(torch.from_numpy(ia), torch.from_numpy(ma),
                     torch.from_numpy(ib), torch.from_numpy(mb))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.astype(np.float32).view(np.int32))
    assert got[3] == 1.0


def test_minhash_approximates_jaccard_with_drawn_params():
    """Parameters from ``hash_params`` (a torch generator): the match rate
    of two sketches estimates the Jaccard of their sets."""
    a = np.arange(60)
    bset = np.arange(20, 80)
    items = torch.from_numpy(np.stack([a, bset]).astype(np.int32))
    mask = torch.ones_like(items, dtype=torch.bool)
    params = TS.hash_params(512, torch.Generator().manual_seed(0))
    assert params[0].shape == (512,) and bool((params[0] % 2 == 1).all())
    assert int(params[0].max()) < 2 ** 31 and int(params[1].min()) >= 0
    sk = TS.bbit_minhash(params, items, mask, L=512, b=8)
    match = float((sk[0] == sk[1]).float().mean())
    assert abs(match - 0.5) < 0.08, match
    assert abs(float(TS.jaccard(items[:1], mask[:1], items[1:],
                                mask[1:])[0]) - 0.5) < 1e-6
    with pytest.raises(ValueError):
        TS.bbit_minhash(params, items, mask, L=16, b=2)


@pytest.mark.parametrize("vocab", [96, 256, 33])
def test_pack_sets_matches_jax(vocab):
    rng = np.random.default_rng(vocab)
    sets = [rng.choice(vocab, size=int(rng.integers(0, 20)), replace=False)
            for _ in range(15)]
    want = JH.pack_sets(sets, vocab)
    got = TH.pack_sets(sets, vocab)
    assert got.dtype == np.uint32 and got.shape == (15, (vocab + 31) // 32)
    np.testing.assert_array_equal(got, want)
    multihot = np.zeros((15, vocab), np.uint8)
    for r, s in enumerate(sets):
        multihot[r, s] = 1
    np.testing.assert_array_equal(TH.pack_sets(multihot, vocab), want)
    with pytest.raises(ValueError):
        TH.pack_sets([[vocab]], vocab)


@pytest.mark.parametrize("b,S", [(1, 32), (2, 16), (2, 4), (4, 8), (8, 4),
                                 (2, 0), (3, 7)])
def test_pack_suffix_words_match_jax(b, S):
    rng = np.random.default_rng(b * 50 + S)
    sfx = rng.integers(0, 1 << b, size=(40, S)).astype(np.uint8)
    want = JH.pack_suffix_words(sfx, b)
    np.testing.assert_array_equal(TH.pack_suffix_words(sfx, b), want)
    np.testing.assert_array_equal(
        np.asarray(JH.pack_suffix_words_jax(jnp.asarray(sfx), b)), want)
    got = TH.pack_suffix_words_torch(torch.from_numpy(sfx), b)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_pack_suffix_words_reject_wide_suffixes():
    for fn, x in ((TH.pack_suffix_words, np.zeros((1, 20), np.uint8)),
                  (TH.pack_suffix_words_torch,
                   torch.zeros((1, 20), dtype=torch.uint8))):
        with pytest.raises(ValueError):
            fn(x, 2)                                   # 2 * 20 > 32


# ---------------------------------------------------------------------------
# 0-bit CWS, the min-max kernel and the Hamming helpers
# ---------------------------------------------------------------------------

def jax_cws_params(seed: int, L: int, dim: int):
    """The (r, c, beta) draws ``repro.core.sketch.zbit_cws`` makes from
    its key, as numpy."""
    kr, kc, kb = jax.random.split(jax.random.PRNGKey(seed), 3)
    r = jax.random.exponential(kr, (2, L, dim)).sum(0).astype(jnp.float32)
    c = jax.random.exponential(kc, (2, L, dim)).sum(0).astype(jnp.float32)
    beta = jax.random.uniform(kb, (L, dim), dtype=jnp.float32)
    return tuple(np.asarray(p) for p in (r, c, beta))


@jax.jit
def _jax_cws_terms(weights, r, c, beta):
    """The JAX side's floor arguments and ln a values, computed as
    ``zbit_cws`` computes them."""
    logw = jnp.where(weights > 0, jnp.log(jnp.maximum(weights, 1e-30)),
                     -jnp.inf)
    x = logw[:, None, :] / r[None] + beta[None]
    lny = r[None] * (jnp.floor(x) - beta[None])
    lna = jnp.log(c)[None] - lny - r[None]
    return x, jnp.where(jnp.isfinite(logw)[:, None, :], lna, jnp.inf)


def cws_unsure_lanes(weights, params, ulps=4):
    """(batch, L) bool: lanes where, on the JAX side, a ``floor``
    argument lies within ``ulps`` float32 ulps of an integer, or the two
    smallest ln a lie within ``ulps`` ulps of each other — where one ulp
    of ``log`` between XLA and torch may flip the symbol."""
    x, lna = (np.asarray(a) for a in _jax_cws_terms(
        jnp.asarray(weights), *(jnp.asarray(p) for p in params)))
    fin = np.isfinite(x)
    xs = np.where(fin, x, 0).astype(np.float32)
    near_int = fin & (np.abs(xs - np.round(xs))
                      <= ulps * np.spacing(np.abs(xs)))
    top2 = np.sort(lna, axis=-1)[..., :2]
    fin2 = np.isfinite(top2[..., 1])
    top2 = np.where(np.isfinite(top2), top2, 0).astype(np.float32)
    scale = np.spacing(np.abs(top2).max(axis=-1))
    close = fin2 & (top2[..., 1] - top2[..., 0] <= ulps * scale)
    return near_int.any(axis=-1) | close


def sift_like(rng, batch, dim, zero_frac):
    """uint8-valued weights (as SIFT's descriptors), a share of them 0."""
    w = rng.integers(0, 256, size=(batch, dim)).astype(np.float32)
    w[rng.random((batch, dim)) < zero_frac] = 0
    w[0] = 0                                    # an all-zero row
    return w


@pytest.mark.parametrize("dim,L,b,batch", [(128, 32, 4, 96),
                                           (960, 64, 8, 12)])
def test_zbit_cws_matches_jax(dim, L, b, batch):
    """SIFT (dim 128, L 32, b 4) and GIST (dim 960, L 64, b 8) shapes:
    symbols equal to the JAX package's with its own draws, except at the
    lanes ``cws_unsure_lanes`` names, which are counted and printed."""
    rng = np.random.default_rng(dim)
    w = sift_like(rng, batch, dim, 0.3)
    params = jax_cws_params(dim + L, L, dim)
    want = np.asarray(JS.zbit_cws(jax.random.PRNGKey(dim + L),
                                  jnp.asarray(w), L=L, b=b))
    got = TS.zbit_cws(params, torch.from_numpy(w), L=L, b=b)
    assert got.dtype == torch.uint8 and got.shape == (batch, L)
    unsure = cws_unsure_lanes(w, params)
    differ = got.numpy() != want
    print(f"zbit_cws dim={dim} L={L} b={b}: {int(unsure.sum())} of "
          f"{unsure.size} lanes within 4 ulps on the JAX side, "
          f"{int(differ.sum())} symbols differ")
    assert not (differ & ~unsure).any()
    assert unsure.mean() < 0.05
    assert (got.numpy()[0] == 0).all()          # all-zero row: argmin 0


def test_zbit_cws_chunks_and_draws(monkeypatch):
    """Row chunks change no symbol; ``cws_params`` draws Gamma(2, 1) and
    U(0, 1) in float32; the sketch's match rate estimates the min-max
    kernel (as the JAX package's test holds it)."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(sift_like(rng, 40, 64, 0.2))
    params = TS.cws_params(16, 64, torch.Generator().manual_seed(1))
    assert all(p.shape == (16, 64) and p.dtype == torch.float32
               for p in params)
    whole = TS.zbit_cws(params, w, L=16, b=4)
    monkeypatch.setattr(TS, "CWS_CHUNK_ELEMS", 16 * 64 * 3)
    assert torch.equal(TS.zbit_cws(params, w, L=16, b=4), whole)
    r, c, beta = TS.cws_params(64, 512, torch.Generator().manual_seed(2))
    assert abs(float(r.mean()) - 2) < 0.05 and float(c.min()) > 0
    assert 0 <= float(beta.min()) and float(beta.max()) < 1
    w1 = rng.uniform(0, 1, size=64).astype(np.float32)
    w2 = w1.copy()
    w2[:16] = rng.uniform(0, 1, size=16)
    wt = torch.from_numpy(np.stack([w1, w2]))
    sk = TS.zbit_cws(TS.cws_params(512, 64, torch.Generator().manual_seed(4)),
                     wt, L=512, b=8)
    match = float((sk[0] == sk[1]).float().mean())
    k = float(TS.minmax_kernel(wt[0], wt[1]))
    assert abs(match - k) < 0.1, (match, k)
    with pytest.raises(ValueError):
        TS.zbit_cws(params, w, L=8, b=4)


def test_minmax_kernel_within_one_ulp_of_jax():
    """uint8-valued weights (SIFT's): each row's sums stay below 2^24, so
    they are exact in float32 in any summation order, and the one
    division is IEEE-rounded in both packages."""
    rng = np.random.default_rng(9)
    wa = rng.integers(0, 256, size=(50, 128)).astype(np.float32)
    wb = rng.integers(0, 256, size=(50, 128)).astype(np.float32)
    wa[:5] = 0
    wb[:3] = 0                                  # rows 0-2: both all zero
    want = np.asarray(JS.minmax_kernel(jnp.asarray(wa), jnp.asarray(wb)))
    got = TS.minmax_kernel(torch.from_numpy(wa), torch.from_numpy(wb))
    assert got.dtype == torch.float32 and got.shape == (50,)
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert (np.abs(got.numpy() - want) <= ulp).all()
    assert (got.numpy()[:3] == 0).all()


@pytest.mark.parametrize("b,L", [(1, 8), (2, 16), (2, 40), (4, 70)])
def test_hamming_helpers_match_jax(b, L):
    rng = np.random.default_rng(b * 100 + L)
    db = rng.integers(0, 1 << b, size=(57, L)).astype(np.uint8)
    qs = rng.integers(0, 1 << b, size=(6, L)).astype(np.uint8)
    qs[0] = db[3]
    want = np.asarray(JH.hamming_pairwise_naive(jnp.asarray(qs),
                                                jnp.asarray(db)))
    got = TH.hamming_pairwise_naive(torch.from_numpy(qs), torch.from_numpy(db))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        TH.hamming_naive(torch.from_numpy(db), torch.from_numpy(qs[1])).numpy(),
        np.asarray(JH.hamming_naive(jnp.asarray(db), jnp.asarray(qs[1]))))
    dbp, qp = JH.pack_vertical(db, b), JH.pack_vertical(qs, b)
    jv = np.asarray(JH.hamming_vertical_many(jnp.asarray(dbp),
                                             jnp.asarray(qp)))
    tv = TH.hamming_vertical_many(TH.as_words(dbp, "cpu"),
                                  TH.as_words(qp, "cpu"))
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(jv, want)
    np.testing.assert_array_equal(
        TH.hamming_vertical(TH.as_words(dbp, "cpu"),
                            TH.as_words(qp[2], "cpu")).numpy(),
        np.asarray(JH.hamming_vertical(jnp.asarray(dbp), jnp.asarray(qp[2]))))
