"""The port's sequence-parallel decode attention
(``repro_torch.models.decode_sp``) against the JAX package.

``tests/test_decode_sp.py`` on the port: at mesh (1, 1), in this
process, the attention output within 2e-5 of JAX's
``decode_attention_seq_sharded`` and of its reference ``decode_attention``
(write, then attend), soft cap 0 and 30, 2 and 4 KV heads, the caches
exact; its owner-rank test, which the JAX package skips without two
devices, at 2 gloo ranks (the new K/V lands once, in the rank that owns
slot ``cache_len``); and the same cases over 2 and 4 CPU ranks (meshes
(1, 2), (2, 2) and (1, 4)), each rank holding its slice of the sequence,
against ``decode_attention``: within 2e-5 (float32; the ranks'
partial softmaxes add in another order), the slices placed back exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ranks import decode_sp_worker, run_ranks
from repro.models.decode_sp import decode_attention_seq_sharded as jdecode_sp
from repro.models.layers import decode_attention as jdecode_attention
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.decode_sp import decode_attention_seq_sharded
from repro_torch.models.layers import decode_attention

B, S, HQ, D, CLEN = 2, 64, 8, 16, 37
GRID = [(cap, kv) for cap in (0.0, 30.0) for kv in (2, 4)]


def _case(cap, kv, clen=CLEN, seed=0):
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return dict(q=f32(B, 1, HQ, D), kn=f32(B, 1, kv, D), vn=f32(B, 1, kv, D),
                kc=f32(B, S, kv, D), vc=f32(B, S, kv, D), clen=clen, cap=cap)


def _reference(c):
    """Write the new K/V at ``clen``, then attend (the JAX package's)."""
    k = jax.lax.dynamic_update_slice_in_dim(jnp.asarray(c["kc"]), c["kn"],
                                            c["clen"], axis=1)
    v = jax.lax.dynamic_update_slice_in_dim(jnp.asarray(c["vc"]), c["vn"],
                                            c["clen"], axis=1)
    out = jdecode_attention(jnp.asarray(c["q"]), k, v, c["clen"] + 1,
                            cap=c["cap"])
    return np.asarray(out), np.asarray(k), np.asarray(v)


@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("kv", [2, 4])
def test_seq_sharded_matches_reference(cap, kv):
    c = _case(cap, kv)
    mesh = make_mesh((1, 1), ("data", "model"))
    t = {k: torch.from_numpy(v) for k, v in c.items()
         if isinstance(v, np.ndarray)}
    out, kc, vc = decode_attention_seq_sharded(
        t["q"], t["kn"], t["vn"], t["kc"].clone(), t["vc"].clone(), CLEN,
        mesh, cap=cap)
    ref, k_ref, v_ref = _reference(c)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(kc.numpy(), k_ref)
    np.testing.assert_array_equal(vc.numpy(), v_ref)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jout, _, _ = jax.jit(lambda *a: jdecode_sp(*a, jmesh, cap=cap))(
        c["q"], c["kn"], c["vn"], c["kc"], c["vc"], jnp.int32(CLEN))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=2e-5,
                               atol=2e-5)
    # the port's own plain decode attention, on the written caches
    np.testing.assert_allclose(
        decode_attention(t["q"], kc, vc, CLEN + 1, cap=cap).numpy(), ref,
        rtol=2e-5, atol=2e-5)


def _owner_case():
    """tests/test_decode_sp.py's owner case: S 8, one KV head, slot 5."""
    return dict(q=np.ones((1, 1, 2, 4), np.float32),
                kn=np.full((1, 1, 1, 4), 7.0, np.float32),
                vn=np.full((1, 1, 1, 4), 9.0, np.float32),
                kc=np.zeros((1, 8, 1, 4), np.float32),
                vc=np.zeros((1, 8, 1, 4), np.float32), clen=5, cap=0.0)


# the 2-rank group also runs the owner case (last); the 4-rank group the grid
# with a slot in each rank's slice and one past every written slot
CLENS = {2: [CLEN], 4: [CLEN, 3, 63]}
MESHES = {2: [(1, 2)], 4: [(2, 2), (1, 4)]}


def _cases(world):
    out = [_case(cap, kv, clen, seed=i) for i, (cap, kv) in enumerate(GRID)
           for clen in CLENS[world]]
    return out + ([_owner_case()] if world == 2 else [])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    return {world: run_ranks(decode_sp_worker, world, tmp,
                             dict(meshes=MESHES[world], cases=_cases(world)))
            for world in MESHES}


def _assembled(results, world, shape, i):
    """(attention output of model rank 0, caches put back from the slices
    along "model") of case ``i`` at ``shape``; every model rank's output
    is the same."""
    D_, M = shape
    j = MESHES[world].index(shape) * len(_cases(world)) + i
    outs = [results[r][j] for r in range(M)]     # data row 0's model ranks
    for o in outs[1:]:
        np.testing.assert_array_equal(o["out"], outs[0]["out"])
    kc = np.concatenate([o["kc"] for o in outs], axis=1)
    vc = np.concatenate([o["vc"] for o in outs], axis=1)
    return outs[0]["out"], kc, vc, outs


@pytest.mark.parametrize("world,shape,i", [
    (w, s, i) for w in MESHES for s in MESHES[w]
    for i in range(len(GRID) * len(CLENS[w]))])
def test_ranks_match_reference(world, shape, i, ranks):
    c = _cases(world)[i]
    out, kc, vc, outs = _assembled(ranks[world], world, shape, i)
    ref, k_ref, v_ref = _reference(c)
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(kc, k_ref)
    np.testing.assert_array_equal(vc, v_ref)
    # one MAX and one SUM all-reduce over "model" a call
    names = sorted(outs[0]["stats"])
    assert names == ["all_reduce_max:model", "all_reduce_sum:model"]


def test_cache_write_goes_to_owner_rank_only(ranks):
    """With 2 model ranks the new KV lands exactly once (slot ownership):
    slot 5 of 8 belongs to rank 1, whose slice holds it at 1; rank 0's
    slice is unchanged."""
    c = _owner_case()
    i = len(_cases(2)) - 1
    out, kc, vc, outs = _assembled(ranks[2], 2, (1, 2), i)
    expect = c["kc"].copy()
    expect[:, 5] = 7.0
    np.testing.assert_array_equal(kc, expect)
    np.testing.assert_array_equal(outs[0]["kc"], c["kc"][:, :4])
    assert (outs[1]["kc"][:, 1] == 7.0).all() and (outs[1]["vc"][:, 1]
                                                   == 9.0).all()
    ref, _, _ = _reference(c)
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
