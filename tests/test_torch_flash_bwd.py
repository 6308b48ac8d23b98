"""The port's flash attention gradient against the JAX package's FA-2 VJP.

The same seeded numpy inputs go through ``repro.models.flash`` (its
``custom_vjp``, plain JAX) under ``jax.grad`` and through
``repro_torch.models.flash.flash_attention`` (the ``autograd.Function``)
under ``torch.autograd``, on the CPU, where the wrappers run the plain
versions ``ref.flash_attention_ref`` and ``ref.flash_attention_bwd_ref``.
Tolerance 5e-4 on dq, dk and dv, that of ``tests/test_flash.py`` (both
sides compute in float32 and sum in another order); outputs 2e-5.  The
cases are ``tests/test_flash.py``'s five (causal, window, cap, GQA),
head dim 80 (bidirectional and causal), and bfloat16 tiles.

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

# tests/test_flash.py's cases, then head dim 80 in hubert-xlarge's form
# (bidirectional) and zamba2-2.7b's (causal)
CASES = [
    dict(causal=True, window=0, cap=0.0, hq=4, hkv=4, D=16),
    dict(causal=True, window=7, cap=0.0, hq=4, hkv=2, D=16),
    dict(causal=True, window=0, cap=30.0, hq=4, hkv=4, D=16),
    dict(causal=False, window=0, cap=0.0, hq=4, hkv=4, D=16),
    dict(causal=True, window=5, cap=50.0, hq=8, hkv=2, D=16),
    dict(causal=False, window=0, cap=0.0, hq=4, hkv=4, D=80),
    dict(causal=True, window=0, cap=0.0, hq=4, hkv=4, D=80),
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


@pytest.mark.parametrize("case", [CASES[0], CASES[4], CASES[5], CASES[6]])
def test_flash_grads_match_jax_vjp_bf16_tiles(case):
    """``set_tile_dtype(bfloat16)`` on both sides: P, dS and their
    operands rounded to bf16 before the products (one kv block on the
    JAX side, so its forward rounds P against the same row maximum).
    The bf16 tiles are the specification the card's bf16 kernels are
    held to, D 80 among them.  The D 16 cases agree to float32 rounding
    (GRAD_TOL).  At D 80, s and dP are sums of 80 float32 products that
    the two packages order differently, so a P or dS may round to the
    other bf16 neighbour on one side and move one term of a gradient
    element by a bf16 ulp: there the bound is one bf16 ulp (2^-8) of the
    gradient's largest magnitude."""
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
        tol = (GRAD_TOL if case["D"] < 80
               else 2 ** -8 * float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=GRAD_TOL, atol=tol,
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
# the wrapper's host side: what the kernels are handed (on the CPU)
# ---------------------------------------------------------------------------

def _bshd_view(B, S, H, D, dtype=torch.bfloat16):
    """A (B, H, S, D) view of a (B, S, H, D) allocation, as the model's."""
    return torch.randn(B, S, H, D).to(dtype).transpose(1, 2)


def test_tma_ok_takes_the_models_views():
    x = _bshd_view(2, 50, 9, 64)
    assert ops._tma_ok(x)
    assert ops._tma_ok(torch.randn(2, 3, 50, 128).bfloat16())


def test_tma_ok_refuses_what_a_tensor_map_cannot_address():
    flat = torch.zeros(2 * 3 * 10 * 64 + 1, dtype=torch.bfloat16)
    off = flat[1:].view(2, 3, 10, 64)            # base 2 bytes past 16
    assert off.data_ptr() % 16 == 2 and not ops._tma_ok(off)
    odd = torch.zeros(2, 3, 10, 68, dtype=torch.bfloat16)[..., :64]
    assert odd.stride()[2] == 68 and not ops._tma_ok(odd)   # 136-byte rows
    rep = torch.zeros(2, 1, 10, 64, dtype=torch.bfloat16).expand(2, 3, 10, 64)
    assert rep.stride()[1] == 0 and not ops._tma_ok(rep)


def test_tma_ok_ignores_the_strides_of_size_one_dims():
    x = torch.zeros(1, 1, 10, 64, dtype=torch.bfloat16).as_strided(
        (1, 1, 10, 64), (3, 5, 64, 1))
    assert ops._tma_ok(x)
    y = torch.zeros(2, 3, 1, 64, dtype=torch.bfloat16).as_strided(
        (2, 3, 1, 64), (192, 64, 7, 1))
    assert ops._tma_ok(y)


def test_tma_operands_copy_only_what_needs_it():
    good = _bshd_view(2, 20, 3, 64)
    flat = torch.randn(2 * 3 * 20 * 64 + 8).bfloat16()
    bad = flat[3:3 + 2 * 3 * 20 * 64].view(2, 3, 20, 64)
    kept, copied = ops._tma_operands((good, bad))
    assert kept is good
    assert copied.data_ptr() != bad.data_ptr() and ops._tma_ok(copied)
    assert copied.is_contiguous() and torch.equal(copied, bad)


@pytest.mark.parametrize("Sq,Skv", [(100, 257), (1, 40)])
def test_flash_bwd_args_layout(Sq, Skv):
    """The gradients come back as (B, H, S, D) views of (B, S, H, D)
    allocations, delta a contiguous (B, H, Sq) float32 scratch, and the
    argument list matches the launcher's signature but its last two
    (passes, stream)."""
    from repro_torch.kernels import _build
    B, H, D = 2, 3, 64
    q, out, dout = (_bshd_view(B, Sq, H, D) for _ in range(3))
    k, v = _bshd_view(B, Skv, H, D), _bshd_view(B, Skv, H, D)
    lse = torch.zeros(B, H, Sq)
    (dq, dk, dv, delta), args = ops.flash_bwd_args(
        q, k, v, out, lse, dout, causal=True, window=0, cap=0.0, scale=0.125,
        q_offset=0, tile_bf16=False)
    assert dq.shape == (B, H, Sq, D) and dk.shape == dv.shape == (B, H, Skv, D)
    for x, S in ((dq, Sq), (dk, Skv), (dv, Skv)):
        assert x.dtype == torch.bfloat16
        assert x.stride() == (S * H * D, D, H * D, 1)
    assert delta.shape == (B, H, Sq) and delta.dtype == torch.float32
    assert delta.is_contiguous()
    sig = _build._SIGNATURES["flash_attention_bwd_launch"]
    assert len(args) == len(sig) - 2
    assert args[10:15] == (B, H, Sq, Skv, D)
    assert args[-1] == 1                          # bfloat16


PTXAS_REPORT = """\
ptxas info    : Compiling entry function '_Z3fooILi64EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z3fooILi64EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : (C7511) Potential Performance Loss: wgmma.mma_async ...
ptxas info    : Compiling entry function '_Z3barILi80EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z3barILi80EEvv
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 8 bytes cumulative stack size
"""


def test_ptxas_report_parse():
    """The build's report read per kernel: registers and spill bytes, the
    numbers the chip smoke test holds every bf16 backward kernel to."""
    from repro_torch.kernels import _build
    assert _build.ptxas_kernels(PTXAS_REPORT) == {
        "_Z3fooILi64EEvv": (168, 0, 0), "_Z3barILi80EEvv": (255, 4, 8)}
    assert _build.ptxas_kernels("") == {}


# ---------------------------------------------------------------------------
# the CUDA kernel against its plain version (on the card only)
# ---------------------------------------------------------------------------

# (B, H, Sq, Skv); the last four are the edges of the wgmma kernels' tiles
# (a CTA owns 128 rows, a streamed tile holds 64): Sq and Skv off both,
# with Skv < 64; one q row at an offset; a window narrower than a tile;
# a cap without a window
CUDA_CASES = [(dtype, D, kw, shape)
              for dtype in (torch.float32, torch.bfloat16)
              for D in ops.FLASH_HEAD_DIMS
              for kw, shape in (
                  (dict(causal=True), (2, 3, 130, 130)),
                  (dict(causal=False), (2, 3, 100, 257)),
                  (dict(causal=True, window=96, cap=30.0, q_offset=500),
                   (2, 3, 200, 700)),
                  (dict(causal=False), (2, 3, 300, 40)),
                  (dict(causal=True, q_offset=332), (2, 3, 1, 333)),
                  (dict(causal=True, window=20), (2, 3, 257, 257)),
                  (dict(causal=True, cap=50.0), (2, 3, 190, 190)))]


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
@pytest.mark.parametrize("D", [16, 64, 80, 128])
def test_cuda_bwd_kernel_copies_what_tma_cannot_read(cuda_device, D):
    """bf16 operands at a base 2 bytes past 16 (and `out` among them) go
    through contiguous copies to the wgmma kernels: the same gradients as
    from aligned copies of the same values, bit for bit."""
    B, H, S = 2, 3, 150
    g = torch.Generator(device=cuda_device).manual_seed(D)
    n = B * H * S * D

    def shifted():
        flat = torch.randn(n + 1, device=cuda_device, generator=g).bfloat16()
        return flat[1:].view(B, H, S, D)

    q, k, v, dout = (shifted() for _ in range(4))
    # the forward refuses such views: it runs on aligned copies
    out, lse = ops.flash_attention_fwd(*(x.clone() for x in (q, k, v)),
                                       return_lse=True, causal=True)
    out_s = torch.empty(n + 1, device=cuda_device,
                        dtype=torch.bfloat16)[1:].view(B, H, S, D)
    out_s.copy_(out)
    assert not any(ops._tma_ok(x) for x in (q, k, v, out_s, dout))
    got = ops.flash_attention_bwd(q, k, v, out_s, lse, dout, causal=True)
    want = ops.flash_attention_bwd(*(x.contiguous().clone() for x in
                                     (q, k, v, out_s)), lse,
                                   dout.contiguous().clone(), causal=True)
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        assert torch.equal(a, b), f"{name} differs from the aligned call"


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
