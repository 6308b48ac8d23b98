"""The port's bit vector, bit-plane packing and index builders against the
JAX package.

Seeded numpy inputs go through ``repro.core`` and ``repro_torch.core``
(on the CPU).  Tolerance: bit-exact — every rank, select, bit, level
array, node count, layer boundary and space figure is an integer and
must be equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bst as jbst
from repro.core.bitvector import BitVector as JBitVector
from repro.core.hamming import pack_vertical_jax
from repro_torch.core import bst as tbst
from repro_torch.core.bitvector import BitVector
from repro_torch.core.hamming import (pack_vertical, pack_vertical_torch,
                                       unpack_vertical)

BUILDERS = {
    "bst": (jbst.build_bst, tbst.build_bst),
    "louds": (jbst.build_louds, tbst.build_louds),
    "fst": (jbst.build_fst_style, tbst.build_fst_style),
}


def port_leaves(index) -> list:
    """The port index's arrays in the JAX pytree's flattening order."""
    out = []
    for lv in index.levels:
        if isinstance(lv, tbst.TableLevel):
            out += [lv.H.words, lv.H.cum]
        elif isinstance(lv, tbst.ListLevel):
            out += [lv.C, lv.B.words, lv.B.cum]
        elif isinstance(lv, tbst.LoudsLevel):
            out += [lv.C, lv.U.words, lv.U.cum]
    if index.tail is not None:
        t = index.tail
        out += [t.paths_vert, t.D.words, t.D.cum, t.leaf_root]
    return out + [index.id_leaf]


def assert_leaves_equal(jax_leaves, port):
    port = port_leaves(port)
    assert len(jax_leaves) == len(port)
    for j, p in zip(jax_leaves, port):
        j = np.asarray(j)
        p = p.cpu().numpy()
        assert j.shape == p.shape and j.itemsize == p.itemsize
        np.testing.assert_array_equal(p.view(j.dtype), j)


def meta_of(jidx) -> dict:
    return dict(L=jidx.L, b=jidx.b, n=jidx.n, t=jidx.t, lm=jidx.lm,
                ls=jidx.ls, kinds=jidx.kinds, tail=jidx.tail is not None)


def random_db(rng, n, L, b, dup_frac=0.3):
    n_uniq = max(1, int(n * (1 - dup_frac)))
    base = rng.integers(0, 1 << b, size=(n_uniq, L)).astype(np.uint8)
    db = np.concatenate([base, base[rng.integers(0, n_uniq, n - n_uniq)]])
    rng.shuffle(db)
    return db


# ---------------------------------------------------------------------------
# BitVector
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames="name")
def jax_query(bv, name, arg):
    """One jitted JAX BitVector query (eager dispatch compiles per op)."""
    return getattr(bv, name)(arg)


@jax.jit
def jax_children(level, u):
    return level.children(u)


def _bits(kind: str, n: int, rng) -> np.ndarray:
    if kind == "zeros":
        return np.zeros(n, np.uint8)
    if kind == "ones":
        return np.ones(n, np.uint8)
    return (rng.random(n) < {"sparse": 0.1, "half": 0.5}[kind]).astype(np.uint8)


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 100, 517])
@pytest.mark.parametrize("kind", ["zeros", "ones", "sparse", "half"])
def test_bitvector_matches_jax(n, kind):
    rng = np.random.default_rng(n * 7 + len(kind))
    bits = _bits(kind, n, rng)
    jbv = JBitVector.from_bits(bits)
    tbv = BitVector.from_bits(bits)
    np.testing.assert_array_equal(tbv.words.numpy().view(np.uint32),
                                  np.asarray(jbv.words))
    np.testing.assert_array_equal(tbv.cum.numpy(), np.asarray(jbv.cum))
    assert tbv.length == jbv.length and tbv.nbits() == jbv.nbits()
    # one query length for every n (fewer compiles); covers -2 .. n + 3
    pos = np.arange(-2, 522, dtype=np.int32)
    for name in ("rank", "get", "select", "select0"):
        want = np.asarray(jax_query(jbv, name, jnp.asarray(pos)))
        got = getattr(tbv, name)(torch.from_numpy(pos))
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    # batched 2D queries, as the traversal issues them
    grid = np.random.default_rng(1).integers(-1, n + 2, size=(4, 5)).astype(np.int32)
    np.testing.assert_array_equal(tbv.select(torch.from_numpy(grid)).numpy(),
                                  np.asarray(jax_query(jbv, "select",
                                                       jnp.asarray(grid))))


@pytest.mark.parametrize("L,b", [(16, 2), (32, 4), (40, 2), (7, 8)])
def test_pack_vertical_torch_matches_jax(L, b):
    rng = np.random.default_rng(L + b)
    sk = rng.integers(0, 1 << b, size=(33, L)).astype(np.uint8)
    sk[0] = (1 << b) - 1                      # every plane bit set: sign bit
    want = np.asarray(pack_vertical_jax(jnp.asarray(sk), b))
    got = pack_vertical_torch(torch.from_numpy(sk), b)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(pack_vertical(sk, b), want)
    np.testing.assert_array_equal(unpack_vertical(want, b, L), sk)


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("builder", list(BUILDERS))
@pytest.mark.parametrize("L,b,n", [(16, 2, 3000), (32, 4, 800), (40, 2, 600),
                                   (10, 1, 300)])
def test_builders_match_jax(builder, L, b, n):
    rng = np.random.default_rng(L * 13 + b + n)
    db = random_db(rng, n, L, b)
    jbuild, tbuild = BUILDERS[builder]
    jidx = jbuild(db, b)
    tidx = tbuild(db, b, device="cpu")
    assert (tidx.L, tidx.b, tidx.n, tidx.t, tidx.lm, tidx.ls, tidx.kinds) == \
        (jidx.L, jidx.b, jidx.n, jidx.t, jidx.lm, jidx.ls, jidx.kinds)
    assert (tidx.tail is None) == (jidx.tail is None)
    assert tidx.model_bits() == jidx.model_bits()
    assert tidx.array_bytes() == jidx.array_bytes()
    assert tidx.array_bytes(include_ids=False) == jidx.array_bytes(include_ids=False)
    jleaves = jax.tree_util.tree_leaves(jidx)
    assert_leaves_equal(jleaves, tidx)
    # the JAX-built index carried across equals the port's own build
    carried = tbst.index_from_numpy(meta_of(jidx),
                                    [np.asarray(x) for x in jleaves], "cpu")
    assert_leaves_equal(jleaves, carried)
    assert carried.model_bits() == tidx.model_bits()
    assert carried.array_bytes() == tidx.array_bytes()
    assert (carried.t, carried.lm, carried.ls, carried.kinds) == \
        (tidx.t, tidx.lm, tidx.ls, tidx.kinds)
    # children() of every level agrees on a random frontier (ids past
    # t_prev included: both clamp them)
    for lev, (jl, tl) in enumerate(zip(jidx.levels, tidx.levels), start=1):
        t_prev = jidx.t[lev - 1]
        u = rng.integers(0, t_prev + 3, size=64).astype(np.int32)
        want = jax_children(jl, jnp.asarray(u))
        got = tl.children(torch.from_numpy(u))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"level {lev}")


def test_index_from_numpy_rejects_extra_arrays():
    rng = np.random.default_rng(3)
    db = random_db(rng, 200, 16, 2)
    jidx = jbst.build_bst(db, 2)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jidx)]
    with pytest.raises(ValueError):
        tbst.index_from_numpy(meta_of(jidx), leaves + [leaves[-1]], "cpu")


def test_index_to_device_roundtrip_keeps_arrays():
    rng = np.random.default_rng(4)
    db = random_db(rng, 500, 16, 2)
    tidx = tbst.build_bst(db, 2, device="cpu")
    moved = tidx.to("cpu")
    assert moved.device == torch.device("cpu")
    for a, c in zip(port_leaves(tidx), port_leaves(moved)):
        assert torch.equal(a, c)
