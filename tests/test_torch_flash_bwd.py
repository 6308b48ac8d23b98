"""The port's flash attention gradient against the JAX package's FA-2 VJP.

The same seeded numpy inputs go through ``repro.models.flash`` (its
``custom_vjp``, plain JAX) under ``jax.grad`` and through
``repro_torch.models.flash.flash_attention`` (the ``autograd.Function``)
under ``torch.autograd``, on the CPU, where the wrappers run the plain
versions ``ref.flash_attention_ref`` and ``ref.flash_attention_bwd_ref``.
Tolerance 5e-4 on dq, dk and dv, that of ``tests/test_flash.py`` (both
sides compute in float32 and sum in another order); outputs 2e-5.  The
cases are ``tests/test_flash.py``'s five (causal, window, cap, GQA),
head dim 80, and bfloat16 tiles.

The ``cuda``-marked tests hold the CUDA backward kernel against its plain
version on the card, and skip where there is none; there run them with
``python -m pytest tests/test_torch_flash_bwd.py -m cuda``.  float32
(the scalar kernels): 5e-4, as above.  bfloat16 (the tensor-core
kernels, which round P and dS to bf16 for their products) against the
plain version with bf16 tiles: both sum in float32 from the same bf16
operands and round each gradient to bf16 once, so an element may land a
bf16 ulp apart (2^-8 of its magnitude) where the sums' order moves it,
or a P or dS, across a rounding boundary; the bound is 2^-7 of the
tensor's largest magnitude.  Both also repeat a call and require the
same bits (no atomics).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.models import flash as tflash

try:  # the reference; the card's machine has no JAX
    import jax
    import jax.numpy as jnp
    from repro.models import flash as jflash
except ImportError:
    jax = jnp = jflash = None

# tests/test_flash.py's cases, then head dim 80
CASES = [
    dict(causal=True, window=0, cap=0.0, hq=4, hkv=4, D=16),
    dict(causal=True, window=7, cap=0.0, hq=4, hkv=2, D=16),
    dict(causal=True, window=0, cap=30.0, hq=4, hkv=4, D=16),
    dict(causal=False, window=0, cap=0.0, hq=4, hkv=4, D=16),
    dict(causal=True, window=5, cap=50.0, hq=8, hkv=2, D=16),
    dict(causal=False, window=0, cap=0.0, hq=4, hkv=4, D=80),
]
GRAD_TOL = 5e-4


def _inputs(case, seed=0):
    B, S = 2, 48 if case["causal"] else 64
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, case["hq"], case["D"])).astype(np.float32)
    k = rng.standard_normal((B, S, case["hkv"], case["D"])).astype(np.float32)
    v = rng.standard_normal((B, S, case["hkv"], case["D"])).astype(np.float32)
    return q, k, v


def _jax_value_and_grads(q, k, v, kw, **blocks):
    D = q.shape[-1]

    def loss(q, k, v):
        return (jflash.flash_attention(q, k, v, **blocks, **kw)
                * jnp.cos(jnp.arange(D))).sum()

    args = tuple(jnp.asarray(x) for x in (q, k, v))
    out = jflash.flash_attention(*args, **blocks, **kw)
    grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_value_and_grads(q, k, v, kw):
    D = q.shape[-1]
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = tflash.flash_attention(*ts, **kw)
    (out * torch.cos(torch.arange(D, dtype=torch.float32))).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("case", CASES)
def test_flash_grads_match_jax_vjp(case):
    q, k, v = _inputs(case)
    kw = dict(causal=case["causal"], window=case["window"], cap=case["cap"])
    ops.reset_kernel_stats()
    out, grads = _torch_value_and_grads(q, k, v, kw)
    assert ops.kernel_stats() == {"flash_attention_fwd:ref": 1,
                                  "flash_attention_bwd:ref": 1}
    j_out, j_grads = _jax_value_and_grads(q, k, v, kw, q_block=16,
                                          kv_block=16)
    np.testing.assert_allclose(out, j_out, rtol=2e-5, atol=2e-5)
    for got, want, name in zip(grads, j_grads, "qkv"):
        np.testing.assert_allclose(got, want, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"d{name} for {case}")


@pytest.mark.parametrize("case", [CASES[0], CASES[4]])
def test_flash_grads_match_jax_vjp_bf16_tiles(case):
    """``set_tile_dtype(bfloat16)`` on both sides: P, dS and their
    operands rounded to bf16 before the products (one kv block on the
    JAX side, so its forward rounds P against the same row maximum)."""
    q, k, v = _inputs(case, seed=1)
    kw = dict(causal=case["causal"], window=case["window"], cap=case["cap"])
    tflash.set_tile_dtype(torch.bfloat16)
    jflash.set_tile_dtype(jnp.bfloat16)
    try:
        out, grads = _torch_value_and_grads(q, k, v, kw)
        j_out, j_grads = _jax_value_and_grads(q, k, v, kw)
    finally:
        tflash.set_tile_dtype(torch.float32)
        jflash.set_tile_dtype(jnp.float32)
    np.testing.assert_allclose(out, j_out, rtol=2e-5, atol=2e-5)
    for got, want, name in zip(grads, j_grads, "qkv"):
        np.testing.assert_allclose(got, want, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"d{name} for {case}")


def test_tile_dtype_is_checked():
    with pytest.raises(ValueError, match="tile dtype"):
        tflash.set_tile_dtype(torch.float16)


def test_lse_matches_jax_forward():
    """The plain forward's lse is the JAX blockwise forward's residual,
    -inf on a row that sees no key (a window shorter than the offset
    gap)."""
    rng = np.random.default_rng(2)
    B, H, S, D = 2, 3, 40, 16
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    _, j_lse = jflash._fwd_blocks(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, window=6,
                                  cap=20.0, qb=8, kb=8, q_offset=0)
    _, lse = ref.flash_attention_ref(
        *(torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)),
        causal=True, window=6, cap=20.0, scale=1.0, return_lse=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), rtol=2e-5,
                               atol=2e-5)
    q_t, k_t, v_t = (torch.from_numpy(x).transpose(1, 2) for x in (q, k, v))
    _, lse = ref.flash_attention_ref(q_t[:, :, :4], k_t, v_t, causal=True,
                                     window=3, q_offset=-10, scale=1.0,
                                     return_lse=True)
    assert bool(torch.isneginf(lse).all())


def test_bwd_wrapper_refuses_bad_residuals():
    q = torch.randn(1, 2, 8, 16)
    out, lse = ops.flash_attention_fwd(q, q, q, return_lse=True)
    with pytest.raises(ValueError, match="lse must be"):
        ops.flash_attention_bwd(q, q, q, out, lse[..., :4], out)
    with pytest.raises(ValueError, match="dout must be"):
        ops.flash_attention_bwd(q, q, q, out, lse, out.bfloat16())


# ---------------------------------------------------------------------------
# the CUDA kernel against its plain version (on the card only)
# ---------------------------------------------------------------------------

CUDA_CASES = [(dtype, D, kw, shape)
              for dtype in (torch.float32, torch.bfloat16)
              for D in ops.FLASH_HEAD_DIMS
              for kw, shape in (
                  (dict(causal=True), (2, 3, 130, 130)),
                  (dict(causal=False), (2, 3, 100, 257)),
                  (dict(causal=True, window=96, cap=30.0, q_offset=500),
                   (2, 3, 200, 700)))]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want, dtype, what):
    e = float((got.float() - want.float()).abs().max())
    if dtype == torch.bfloat16:
        bound = 2 ** -7 * float(want.float().abs().max())
    else:
        bound = GRAD_TOL * (1 + float(want.float().abs().max()))
    assert e <= bound, f"{what}: max err {e} > {bound}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,kw,shape", CUDA_CASES)
def test_cuda_bwd_kernel_matches_plain(cuda_device, dtype, D, kw, shape):
    B, H, Sq, Skv = shape
    g = torch.Generator(device=cuda_device).manual_seed(D + Sq)

    def rnd(*s):
        return torch.randn(s, device=cuda_device, generator=g).to(dtype)

    q, k, v, dout = rnd(B, H, Sq, D), rnd(B, H, Skv, D), rnd(B, H, Skv, D), \
        rnd(B, H, Sq, D)
    out, lse = ops.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    _, lse_r = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    fin = torch.isfinite(lse_r)
    assert torch.equal(fin, torch.isfinite(lse))
    assert float((lse - lse_r)[fin].abs().max()) < 1e-3
    ops.reset_kernel_stats()
    got = ops.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    again = ops.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert ops.kernel_stats()["flash_attention_bwd"] == 2
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                       tile_bf16=dtype == torch.bfloat16,
                                       **kw)
    for a, b, w, name in zip(got, again, want, ("dq", "dk", "dv")):
        assert torch.equal(a, b), f"{name} differs between two runs"
        assert a.dtype == dtype and a.shape == w.shape
        _close(a, w, dtype, f"{name} {dtype} D={D} {kw}")


@pytest.mark.cuda
def test_cuda_autograd_function_matches_plain(cuda_device):
    """The model's GQA path on the card: the kernels' gradients against
    the plain path's at smollm's head layout (9 / 3 heads of 64)."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    shapes = ((2, 300, 9, 64), (2, 300, 3, 64), (2, 300, 3, 64))
    base = [torch.randn(s, device=cuda_device, generator=g) for s in shapes]
    grads = []
    for use_kernel in (True, False):
        ts = [x.clone().requires_grad_(True) for x in base]
        if use_kernel:
            out = tflash.flash_attention(*ts, causal=True, cap=30.0)
        else:
            out = tflash.flash_attention(*(t.cpu() for t in ts), causal=True,
                                         cap=30.0)
        (out.float().cos().sum()).backward()
        grads.append([t.grad for t in ts])
    for a, b, name in zip(grads[0], grads[1], "qkv"):
        _close(a, b.to(a.device), torch.float32, f"d{name}")
