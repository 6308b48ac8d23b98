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
