"""The port's MoE block (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe`` on seeded numpy inputs.

Tolerances and why:

  * routing indices, the capacity plan's kept mask and positions:
    exact (integers; the same float32 router logits on both sides,
    and the tie order of ``lax.top_k`` kept by a stable sort);
  * the gates: 1e-6 (float32 softmax and normalisation, a few ulps);
  * the block's output in float32: 1e-5 (einsums summed in another
    order on both sides);
  * ``aux_load_balance_loss``: 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JMOE
from repro_torch.models import moe as TMOE

D, E, FF = 32, 8, 16


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _params(n_shared=0, seed=0):
    jp = JMOE.moe_init(jax.random.PRNGKey(seed), D, E, FF, n_shared,
                       jnp.float32)
    tp = jax.tree_util.tree_map(t, jp)
    return jp, tp


def _x(shape=(2, 24, D), seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax_plan(idx, E, capacity_factor):
    """The kept mask and positions of ``repro.models.moe.moe_apply``
    (its lines, on its own routing) for one group axis."""
    G, tg, k = idx.shape
    cap = max(int(np.ceil(tg * k / E * capacity_factor)), k)
    onehot = jax.nn.one_hot(idx, E, dtype=jnp.int32)
    flat = onehot.reshape(G, tg * k, E)
    pos = jnp.cumsum(flat, axis=1) - 1
    pos_own = (pos * flat).sum(-1).reshape(G, tg, k)
    return np.asarray(pos_own < cap), np.asarray(pos_own), cap


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_route_matches_jax(top_k):
    jp, tp = _params()
    x = _x()
    jg, ji = JMOE._route(jp["router"], jnp.asarray(x), top_k)
    tg, ti = TMOE._route(tp["router"], t(x), top_k)
    assert ti.dtype == torch.int64 and tg.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-6)


def test_route_ties_keep_lax_top_k_order():
    """Experts 1, 3 and 6 share one router column, 2 and 5 another: every
    token's gates tie among them, and ``lax.top_k`` puts the lower expert
    first; so must the port."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal((D, E)).astype(np.float32)
    w[:, 3] = w[:, 1]
    w[:, 6] = w[:, 1]
    w[:, 5] = w[:, 2]
    x = _x((3, 16, D), seed=3)
    for top_k in (2, 4, 6):
        jg, ji = JMOE._route(jnp.asarray(w), jnp.asarray(x), top_k)
        tg, ti = TMOE._route(t(w), t(x), top_k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                                   atol=1e-6)
    # ties are present, and each tied group comes out in ascending order
    ji = np.asarray(ji)
    assert ((ji[..., :-1] < ji[..., 1:])
            & np.isin(ji[..., :-1], [1, 3, 6])
            & np.isin(ji[..., 1:], [1, 3, 6])).any()


def test_top_k_matches_lax_on_heavy_ties():
    vals = np.random.default_rng(4).integers(0, 3, (50, 12)).astype(
        np.float32)
    for k in (1, 5, 12):
        jv, ji = jax.lax.top_k(jnp.asarray(vals), k)
        tv, ti = TMOE._top_k(t(vals), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("num_groups", [1, 2])
@pytest.mark.parametrize("capacity_factor", [1.0, 4.0])
def test_moe_apply_matches_jax(capacity_factor, num_groups):
    """capacity_factor 1.0 drops (token, slot) pairs, 4.0 drops none; the
    kept mask must match bit for bit and the output within 1e-5."""
    jp, tp = _params()
    x = _x()
    kw = dict(top_k=2, act="silu", num_groups=num_groups,
              capacity_factor=capacity_factor)
    want = JMOE.moe_apply(jp, jnp.asarray(x), **kw)
    got = TMOE.moe_apply(tp, t(x), **kw)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)

    xg = x.reshape(num_groups, -1, D)
    _, ji = JMOE._route(jp["router"], jnp.asarray(xg), 2)
    _, ti = TMOE._route(tp["router"], t(xg), 2)
    jkeep, jpos, jcap = _jax_plan(ji, E, capacity_factor)
    tkeep, tpos, tcap = TMOE._capacity_plan(ti, E, capacity_factor)
    assert tcap == jcap
    np.testing.assert_array_equal(tkeep.numpy(), jkeep)
    np.testing.assert_array_equal(tpos.numpy(), jpos)
    assert jkeep.all() == (capacity_factor == 4.0)


def test_moe_apply_matches_dense_without_drops():
    _, tp = _params()
    x = t(_x())
    got = TMOE.moe_apply(tp, x, top_k=2, act="gelu", capacity_factor=4.0)
    want = TMOE.moe_apply_dense(tp, x, top_k=2, act="gelu")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    jp, _ = _params()
    jwant = JMOE.moe_apply_dense(jp, jnp.asarray(x.numpy()), top_k=2,
                                 act="gelu")
    np.testing.assert_allclose(want.numpy(), np.asarray(jwant), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_aux_load_balance_loss_matches_jax(top_k):
    jp, tp = _params()
    x = _x(seed=5)
    want = JMOE.aux_load_balance_loss(jp, jnp.asarray(x), top_k=top_k)
    got = TMOE.aux_load_balance_loss(tp, t(x), top_k=top_k)
    assert got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("n_shared", [1, 2])
def test_shared_experts_match_jax(n_shared):
    jp, tp = _params(n_shared=n_shared, seed=6)
    assert tp["shared"]["w_up"].shape == (D, n_shared * FF)
    x = _x(seed=7)
    for cf in (1.0, 4.0):
        want = JMOE.moe_apply(jp, jnp.asarray(x), top_k=2, act="silu",
                              capacity_factor=cf)
        got = TMOE.moe_apply(tp, t(x), top_k=2, act="silu",
                             capacity_factor=cf)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
    dense = TMOE.moe_apply_dense(tp, t(x), top_k=2, act="silu")
    np.testing.assert_allclose(
        dense.numpy(),
        np.asarray(JMOE.moe_apply_dense(jp, jnp.asarray(x), top_k=2,
                                        act="silu")), rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_shared", [0, 2])
def test_moe_init_matches_jax_shapes(n_shared):
    """The port's init has the JAX package's tree, shapes and dtypes (the
    router float32 under a bf16 ``dtype``) and, roughly, its scales."""
    jp = JMOE.moe_init(jax.random.PRNGKey(0), 64, E, 48, n_shared,
                       jnp.bfloat16)
    tp = TMOE.moe_init(torch.Generator().manual_seed(0), 64, E, 48,
                       n_shared, torch.bfloat16)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jp))
    flat_t = {}

    def walk(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat_t[path + (k,)] = v
    walk(tp)
    assert len(flat_t) == len(flat_j)
    for path, leaf in flat_j.items():
        mine = flat_t[tuple(p.key for p in path)]
        assert tuple(mine.shape) == leaf.shape
        assert str(mine.dtype).split(".")[-1] == str(leaf.dtype)
        ratio = float(mine.float().std()) / float(
            np.asarray(leaf, np.float32).std())
        assert 0.8 < ratio < 1.25, (path, ratio)
    assert tp["router"].dtype == torch.float32


def test_bf16_dispatch_keeps_the_f32_router():
    """bf16 activations route on float32 logits: the routing (and so the
    kept mask) is the float32 routing of the bf16-rounded input."""
    _, tp = _params()
    x = t(_x()).to(torch.bfloat16)
    tp16 = {k: (v.to(torch.bfloat16) if k != "router" else v)
            for k, v in tp.items()}
    y = TMOE.moe_apply(tp16, x, top_k=2, act="silu", capacity_factor=1.0)
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()
    _, idx16 = TMOE._route(tp["router"], x, 2)
    _, idx32 = TMOE._route(tp["router"], x.float(), 2)
    assert torch.equal(idx16, idx32)
