"""The port's flash-attention forward against the JAX package.

The same seeded numpy inputs go through ``repro`` — the Pallas kernel in
interpret mode and ``models.flash.flash_attention`` — and through
``repro_torch`` on the CPU, where ``ops.flash_attention_fwd`` runs its
plain version ``ref.flash_attention_ref``.  Tolerance: 2e-5 in float32
and 2e-2 in bfloat16, those of the Pallas kernel's own tests (the sums
run in another order; bf16 inputs round the same way in both, the
float32 softmax differs by a few ulps).  The ``cuda``-marked class holds
the CUDA kernel against its plain version on the card and skips where
there is none; there run it with ``python -m pytest
tests/test_torch_flash.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.models.flash import flash_attention

try:  # the reference; the card's machine has no JAX
    import jax.numpy as jnp
    from repro.kernels.flash_attn_kernel import flash_attention_fwd_pallas
    from repro.models import flash as jflash
except ImportError:
    jnp = flash_attention_fwd_pallas = jflash = None

# the Pallas kernel's test cases (tests/test_kernels_flash.py)
CASES = [
    dict(causal=True, window=0, cap=0.0, dtype="float32", S=256, D=64),
    dict(causal=True, window=96, cap=0.0, dtype="float32", S=256, D=64),
    dict(causal=True, window=0, cap=30.0, dtype="float32", S=256, D=128),
    dict(causal=False, window=0, cap=0.0, dtype="float32", S=256, D=64),
    dict(causal=True, window=0, cap=0.0, dtype="bfloat16", S=384, D=128),
]
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tol(dtype: str) -> float:
    return 2e-2 if dtype == "bfloat16" else 2e-5


def qkv(rng, B, H, S, D, Skv=None):
    Skv = S if Skv is None else Skv
    return (rng.standard_normal((B, H, S, D)).astype(np.float32),
            rng.standard_normal((B, H, Skv, D)).astype(np.float32),
            rng.standard_normal((B, H, Skv, D)).astype(np.float32))


def as_torch(a: np.ndarray, dtype: str, device="cpu") -> torch.Tensor:
    return torch.from_numpy(a).to(TORCH_DTYPES[dtype]).to(device)


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("case", CASES)
def test_flash_ref_matches_pallas(case):
    B, H, S, D = 2, 3, case["S"], case["D"]
    rng = np.random.default_rng(0)
    q, k, v = qkv(rng, B, H, S, D)
    jd = getattr(jnp, case["dtype"])
    want = flash_attention_fwd_pallas(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
        causal=case["causal"], window=case["window"], cap=case["cap"],
        bq=128, bk=128, interpret=True)
    got = ref.flash_attention_ref(
        as_torch(q, case["dtype"]), as_torch(k, case["dtype"]),
        as_torch(v, case["dtype"]), causal=case["causal"],
        window=case["window"], cap=case["cap"])
    assert got.dtype == TORCH_DTYPES[case["dtype"]]
    t = tol(case["dtype"])
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32),
                               rtol=t, atol=t)


@pytest.mark.parametrize("Sq,Skv,Hq,Hkv,causal,window,cap,dtype", [
    (100, 100, 6, 2, True, 0, 0.0, "float32"),       # GQA, ragged S
    (77, 77, 4, 1, True, 16, 0.0, "float32"),        # window
    (64, 64, 4, 4, False, 0, 50.0, "float32"),       # non-causal, softcap
    (130, 130, 6, 3, True, 24, 30.0, "float32"),     # window + softcap
    (90, 90, 4, 2, True, 0, 0.0, "bfloat16"),
])
def test_model_flash_matches_jax(Sq, Skv, Hq, Hkv, causal, window, cap, dtype):
    """(B, S, H, D) GQA attention of the model path, port vs JAX (the JAX
    function pads to its blocks; the kernel masks the ragged edge)."""
    rng = np.random.default_rng(Sq + Hq)
    B, D = 2, 16
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    jd = getattr(jnp, dtype)
    want = jflash.flash_attention(jnp.asarray(q, jd), jnp.asarray(k, jd),
                                  jnp.asarray(v, jd), causal=causal,
                                  window=window, cap=cap, q_block=32,
                                  kv_block=32 if causal else 64)
    got = flash_attention(as_torch(q, dtype), as_torch(k, dtype),
                          as_torch(v, dtype), causal=causal, window=window,
                          cap=cap, q_block=32, kv_block=32 if causal else 64)
    assert got.shape == (B, Sq, Hq, D) and got.dtype == TORCH_DTYPES[dtype]
    t = tol(dtype)
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32),
                               rtol=t, atol=t)


def test_q_offset_matches_jax():
    """A query block at absolute positions [offset, offset + Sq) — the
    JAX function's ``q_offset`` — goes to the kernel's query positions."""
    rng = np.random.default_rng(5)
    B, Sq, Skv, H, D, off = 1, 32, 96, 2, 16, 64
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, H, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, H, D)).astype(np.float32)
    want = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, window=40,
                                  q_block=32, kv_block=32, q_offset=off)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True, window=40,
                          q_offset=off)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_wrapper_runs_plain_on_cpu_and_counts_it():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(a) for a in qkv(rng, 1, 2, 40, 16))
    ops.reset_kernel_stats()
    got = ops.flash_attention_fwd(q, k, v, causal=True, window=7)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=7)
    assert torch.equal(got, want)
    assert ops.kernel_stats() == {"flash_attention_fwd:ref": 1}


def test_fully_masked_rows_are_zero():
    """q_offset = -Sq puts every query before every key: causal masks all."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(a) for a in qkv(rng, 1, 1, 8, 16))
    out = ops.flash_attention_fwd(q, k, v, causal=True, q_offset=-8)
    assert torch.equal(out, torch.zeros_like(out))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.flash_attention_fwd(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.flash_attention_fwd(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="head dim"):
        z = torch.zeros((1, 2, 8, 32))
        ops.flash_attention_fwd(z, z, z)
    with pytest.raises(ValueError, match=r"\(B, H, S, D\)"):
        ops.flash_attention_fwd(q[0], q[0], q[0])
    with pytest.raises(ValueError, match="must be"):
        ops.flash_attention_fwd(q, torch.zeros((1, 3, 8, 16)), q)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention_fwd(q, q, q, window=-1)


def test_model_flash_refuses_grad_and_ragged_noncausal():
    x = torch.zeros((1, 10, 2, 16), requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        flash_attention(x, x, x, causal=True)
    with torch.no_grad():
        flash_attention(x, x, x, causal=True)
    y = torch.zeros((1, 10, 2, 16))
    with pytest.raises(ValueError, match="multiple of kv_block"):
        flash_attention(y, y, y, causal=False, kv_block=4)


@pytest.mark.cuda
class TestCudaKernel:
    """The CUDA kernel against its plain version on the card."""

    @pytest.mark.parametrize("case", CASES)
    def test_pallas_cases(self, cuda_device, case):
        rng = np.random.default_rng(3)
        q, k, v = (as_torch(a, case["dtype"], cuda_device)
                   for a in qkv(rng, 2, 3, case["S"], case["D"]))
        kw = dict(causal=case["causal"], window=case["window"],
                  cap=case["cap"])
        got = ops.flash_attention_fwd(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        t = tol(case["dtype"])
        torch.testing.assert_close(got.float(), want.float(), rtol=t, atol=t)

    @pytest.mark.parametrize("Sq,Skv,D,dtype", [
        (1, 1, 16, "float32"), (1000, 1000, 64, "bfloat16"),
        (33, 200, 16, "float32"), (200, 33, 64, "float32"),
        (129, 129, 128, "bfloat16")])
    def test_ragged_and_head_dims(self, cuda_device, Sq, Skv, D, dtype):
        rng = np.random.default_rng(Sq + D)
        q, k, v = (as_torch(a, dtype, cuda_device)
                   for a in qkv(rng, 2, 3, Sq, D, Skv))
        for kw in (dict(causal=True), dict(causal=False),
                   dict(causal=True, window=17, cap=20.0, q_offset=Skv - Sq)):
            got = ops.flash_attention_fwd(q, k, v, **kw)
            want = ref.flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            t = tol(dtype)
            torch.testing.assert_close(got.float(), want.float(), rtol=t,
                                       atol=t)

    def test_strided_views_and_count(self, cuda_device):
        """(B, S, H, D) tensors read as (B, H, S, D) views, no copy."""
        rng = np.random.default_rng(4)
        x = [torch.from_numpy(a).to(cuda_device).transpose(1, 2)
             for a in qkv(rng, 2, 100, 5, 64)]
        ops.reset_kernel_stats()
        got = ops.flash_attention_fwd(*x, causal=True)
        assert ops.kernel_stats() == {"flash_attention_fwd": 1}
        want = ref.flash_attention_ref(*x, causal=True)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
