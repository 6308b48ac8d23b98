"""The port's AdamW, cosine schedule and global-norm clip against the JAX
package's ``optim/adamw.py`` on identical float32 inputs.

Both run the same float32 operations in the same order; the libraries'
``pow``, ``cos`` and ``sqrt`` may round a last bit apart, and the global
norm sums its leaves' squares in another order.  Bounds: the schedule
and the norm within 1 float32 ulp; after three updates the parameters
and moments within 2 ulps (each update adds at most one rounding
difference per operation that meets one); the clipped gradients within
2 ulps (the scale inherits the norm's ulp, the product adds one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JA
from repro_torch.models.layers import Params
from repro_torch.optim import adamw as TA

# sorted keys: the JAX package flattens dicts in key order, the port in
# insertion order, so both see the leaves in one order
SHAPES = {"bias": (7,), "cube": (3, 5, 2), "mat": (16, 8)}
HYPER = dict(base_lr=1e-2, warmup_steps=2, total_steps=10)


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def test_cosine_lr_matches_jax():
    for h in (JA.Hyper(**HYPER), JA.Hyper()):
        th = TA.Hyper(*h)
        for step in (0, 1, 2, 3, 5, 9, 10, 11, 100, 9_999, 20_000):
            want = np.asarray(JA.cosine_lr(jnp.int32(step), h))
            got = TA.cosine_lr(torch.tensor(step, dtype=torch.int32),
                               th).numpy()
            np.testing.assert_array_max_ulp(got, want, maxulp=1)


@pytest.mark.parametrize("scale", [1e-3, 10.0])
def test_clip_by_global_norm_matches_jax(scale):
    """Below the clip (scale 1e-3: untouched) and above it (10: scaled to
    norm 1)."""
    g = _tree(np.random.default_rng(0), scale)
    j_clipped, j_norm = JA.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in g.items()}, 1.0)
    clipped, norm = TA.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in g.items()}, 1.0)
    np.testing.assert_array_max_ulp(norm.numpy(), np.asarray(j_norm),
                                    maxulp=1)
    for got, key in zip(clipped, SHAPES):
        np.testing.assert_array_max_ulp(got.numpy(),
                                        np.asarray(j_clipped[key]), maxulp=2)


def test_adamw_update_matches_jax():
    rng = np.random.default_rng(1)
    p0 = _tree(rng)
    grads = [_tree(rng, s) for s in (0.1, 3.0, 0.01)]
    h = JA.Hyper(**HYPER)
    j_params = {k: jnp.asarray(v) for k, v in p0.items()}
    j_state = JA.adamw_init(j_params)
    params = Params({k: torch.from_numpy(v.copy())
                     for k, v in p0.items()}).requires_grad_(True)
    state = TA.adamw_init(params)
    assert state.step.dtype == torch.int32 and int(state.step) == 0
    for g in grads:
        j_params, j_state, j_m = JA.adamw_update(
            {k: jnp.asarray(v) for k, v in g.items()}, j_state, j_params, h)
        out, state, m = TA.adamw_update(
            [torch.from_numpy(g[k]) for k in SHAPES], state, params,
            TA.Hyper(*h))
        assert out is params                     # written in place
        assert int(state.step) == int(j_state.step)
        np.testing.assert_array_max_ulp(m["lr"].numpy(),
                                        np.asarray(j_m["lr"]), maxulp=1)
        np.testing.assert_array_max_ulp(m["grad_norm"].numpy(),
                                        np.asarray(j_m["grad_norm"]),
                                        maxulp=1)
        for key, p, mu, nu in zip(SHAPES, params.parameters(),
                                  state.mu.parameters(),
                                  state.nu.parameters()):
            np.testing.assert_array_max_ulp(
                p.detach().numpy(), np.asarray(j_params[key]), maxulp=2)
            np.testing.assert_array_max_ulp(
                mu.numpy(), np.asarray(j_state.mu[key]), maxulp=2)
            np.testing.assert_array_max_ulp(
                nu.numpy(), np.asarray(j_state.nu[key]), maxulp=2)


def test_weight_decay_spares_vectors():
    """A zero gradient moves only the matrices (decay on ndim >= 2)."""
    p0 = _tree(np.random.default_rng(2))
    params = Params({k: torch.from_numpy(v.copy()) for k, v in p0.items()})
    state = TA.adamw_init(params)
    TA.adamw_update([torch.zeros(s) for s in SHAPES.values()], state, params,
                    TA.Hyper(**HYPER))
    for (key, shape), p in zip(SHAPES.items(), params.parameters()):
        moved = not np.array_equal(p.detach().numpy(), p0[key])
        assert moved == (len(shape) >= 2), key


def test_abstract_opt_state_is_meta():
    params = Params({k: torch.empty(s, device="meta")
                     for k, s in SHAPES.items()})
    st = TA.abstract_opt_state(params)
    assert st.step.device.type == "meta" and st.step.dtype == torch.int32
    assert [tuple(x.shape) for x in st.mu.parameters()] == list(
        SHAPES.values())
    j_st = jax.eval_shape(JA.adamw_init,
                          {k: jax.ShapeDtypeStruct(s, jnp.float32)
                           for k, s in SHAPES.items()})
    assert [tuple(j_st.nu[k].shape) for k in SHAPES] == [
        tuple(x.shape) for x in st.nu.parameters()]
