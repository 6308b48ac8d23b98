"""The port's Mamba2 SSD block (``repro_torch.models.ssm``) against the
JAX package's ``repro.models.ssm`` on seeded numpy inputs, all float32.

Tolerance: 1e-5 relative (with an absolute floor of 1e-5 times the
output's largest magnitude, for the entries near zero).  The staged
contractions of ``ssd_chunked`` sum in another order than XLA's
four-operand einsums, a few ulps apart.  ``_segsum``'s -inf pattern
is exact and its values within 1e-6 (XLA's cumsum associates its sums
another way); the conv is exact: the same float32 products and sums, in
the reference's order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro_torch.models import ssm as TS

CFG = dict(d_model=32, d_inner=64, d_state=8, head_dim=16, d_conv=4,
           chunk=8)
JCFG, TCFG = JS.SSMConfig(**CFG), TS.SSMConfig(**CFG)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _params(seed=0):
    """JAX's init, with its identity conv taps and zero biases perturbed
    so the conv's order of taps is exercised."""
    jp = JS.ssm_init(jax.random.PRNGKey(seed), JCFG, jnp.float32)
    rng = np.random.default_rng(seed)
    jp = dict(jp)
    for k in ("conv_x", "conv_B", "conv_C", "conv_bx", "conv_bB", "conv_bC",
              "norm"):
        jp[k] = jnp.asarray(np.asarray(jp[k]) + 0.3 * rng
                            .standard_normal(jp[k].shape).astype(np.float32))
    return jp, {k: t(v) for k, v in jp.items()}


def test_segsum_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 2, 9)).astype(np.float32)
    got = TS._segsum(t(x)).numpy()
    want = np.asarray(JS._segsum(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-6)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 11, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    st = rng.standard_normal((2, 3, 6)).astype(np.float32) if with_state \
        else None
    jy, js = JS._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             None if st is None else jnp.asarray(st))
    ty, ts = TS._causal_conv(t(x), t(w), t(b), None if st is None else t(st))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _ssd_inputs(T, seed=2, B=2, H=4, P=16, N=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, H)))).astype(np.float32)
    A = -np.exp(rng.uniform(0, 1.5, H)).astype(np.float32)
    Bm = rng.standard_normal((B, T, N)).astype(np.float32)
    Cm = rng.standard_normal((B, T, N)).astype(np.float32)
    s0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, s0


@pytest.mark.parametrize("T", [16, 21, 5])
@pytest.mark.parametrize("init_state", [False, True])
def test_ssd_chunked_matches_jax(T, init_state):
    """T = 21 and 5 are not multiples of the chunk (8): dt = 0 padding."""
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(T)
    s0 = s0 if init_state else None
    jy, jst = JS.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), 8,
                             init_state=None if s0 is None
                             else jnp.asarray(s0))
    ty, tst = TS.ssd_chunked(*map(t, (x, dt, A, Bm, Cm)), 8,
                             init_state=None if s0 is None else t(s0))
    assert ty.shape == x.shape and tst.shape == (2, 4, 16, 8)
    close(ty, jy)
    close(tst, jst)


def test_ssd_chunked_is_the_recurrence():
    """An independent reference: the token-by-token recurrence
    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_tᵀ, y_t = h_t C_t, in float64."""
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(13, seed=3)
    y, st = TS.ssd_chunked(*map(t, (x, dt, A, Bm, Cm)), 4,
                           init_state=t(s0))
    h = s0.astype(np.float64)
    ys = []
    for i in range(x.shape[1]):
        decay = np.exp(dt[:, i] * A)[:, :, None, None]
        h = h * decay + np.einsum("bh,bhp,bn->bhpn", dt[:, i], x[:, i],
                                  Bm[:, i])
        ys.append(np.einsum("bhpn,bn->bhp", h, Cm[:, i]))
    close(y, np.stack(ys, 1), 1e-4)
    close(st, h, 1e-4)


@pytest.mark.parametrize("T", [16, 19])
def test_ssm_apply_matches_jax(T):
    jp, tp = _params()
    x = np.random.default_rng(4).standard_normal((2, T, 32)).astype(
        np.float32)
    jout, jst = JS.ssm_apply(jp, jnp.asarray(x), JCFG, return_state=True)
    tout, tst = TS.ssm_apply(tp, t(x), TCFG, return_state=True)
    close(tout, jout)
    close(tst, jst)
    close(TS.ssm_apply(tp, t(x), TCFG), jout)


@pytest.mark.parametrize("T", [2, 9])
def test_ssm_prefill_cache_matches_jax(T):
    """T = 2 is shorter than the conv window (3): the tail is padded."""
    jp, tp = _params(seed=5)
    x = np.random.default_rng(5).standard_normal((2, T, 32)).astype(
        np.float32)
    _, jst = JS.ssm_apply(jp, jnp.asarray(x), JCFG, return_state=True)
    _, tst = TS.ssm_apply(tp, t(x), TCFG, return_state=True)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        jc = JS.ssm_prefill_cache(jp, jnp.asarray(x), jst, JCFG, dtype=jdtype)
        tc = TS.ssm_prefill_cache(tp, t(x), tst, TCFG, dtype=dtype)
        for name in ("conv_x", "conv_B", "conv_C"):
            got, want = getattr(tc, name), getattr(jc, name)
            assert got.dtype == dtype and tuple(got.shape) == want.shape
            close(got.float(), np.asarray(want.astype(jnp.float32)),
                  1e-5 if dtype == torch.float32 else 1e-2)
        assert tc.state.dtype == torch.float32
        close(tc.state, jc.state)


def test_three_decode_steps_match_jax():
    """Prefill 10 tokens, then three one-token steps on both sides, each
    output and each cache within 1e-5 relative; the steps also match the
    full block run over all 13 tokens."""
    jp, tp = _params(seed=6)
    x = np.random.default_rng(6).standard_normal((2, 13, 32)).astype(
        np.float32)
    _, jst = JS.ssm_apply(jp, jnp.asarray(x[:, :10]), JCFG, return_state=True)
    _, tst = TS.ssm_apply(tp, t(x[:, :10]), TCFG, return_state=True)
    jc = JS.ssm_prefill_cache(jp, jnp.asarray(x[:, :10]), jst, JCFG,
                              dtype=jnp.float32)
    tc = TS.ssm_prefill_cache(tp, t(x[:, :10]), tst, TCFG,
                              dtype=torch.float32)
    full = TS.ssm_apply(tp, t(x), TCFG)
    for i in range(10, 13):
        jy, jc = JS.ssm_decode_step(jp, jnp.asarray(x[:, i:i + 1]), jc, JCFG)
        ty, tc = TS.ssm_decode_step(tp, t(x[:, i:i + 1]), tc, TCFG)
        close(ty, jy)
        for name in TS.SSMCache._fields:
            close(getattr(tc, name), getattr(jc, name))
        close(ty[:, 0], full[:, i].numpy(), 1e-4)


def test_ssm_cache_init_matches_jax():
    jc = JS.ssm_cache_init(3, JCFG, jnp.bfloat16)
    tc = TS.ssm_cache_init(3, TCFG, torch.bfloat16, device="cpu")
    for name in TS.SSMCache._fields:
        got, want = getattr(tc, name), getattr(jc, name)
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        assert not got.any()


def test_ssm_init_matches_jax():
    """The tree, shapes and dtypes of JAX's init, its fixed values (the
    identity taps, D = 1, zero biases and norm) and the ranges of A and
    of the softplus of the dt bias."""
    jp = JS.ssm_init(jax.random.PRNGKey(0), JCFG, jnp.bfloat16)
    tp = TS.ssm_init(torch.Generator().manual_seed(0), TCFG, torch.bfloat16)
    assert tp.keys() == jp.keys()
    for k, want in jp.items():
        got = tp[k]
        assert tuple(got.shape) == want.shape, k
        assert str(got.dtype).split(".")[-1] == str(want.dtype), k
        if k.startswith("conv") or k in ("D", "norm"):
            np.testing.assert_array_equal(
                got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    a = torch.exp(tp["A_log"])
    assert ((a >= 1.0) & (a < 16.0)).all()
    dt = torch.nn.functional.softplus(tp["dt_bias"])
    assert ((dt > 0.9e-3) & (dt < 0.11)).all()
