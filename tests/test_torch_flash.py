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


def tc_emulate(q, k, v, *, causal, window=0, cap=0.0, scale=None,
               q_offset=0, round_p, block=64):
    """The card's numerics in plain torch, float32 on the CPU: products of
    the input values summed in float32 (a bf16·bf16 product is exact in
    float32), scale and cap on the float32 scores, an online softmax over
    ``block``-key tiles with a float32 running max and sum, and — where
    ``round_p``, as on the tensor-core (bf16) route — P rounded to bf16
    before P·V, while the sum l adds the unrounded P."""
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    scale = 1.0 / D ** 0.5 if scale is None else scale
    qf, kf, vf = (x.to(torch.float32) for x in (q, k, v))
    m = torch.full((B, H, Sq, 1), -torch.inf)
    l = torch.zeros((B, H, Sq, 1))
    acc = torch.zeros((B, H, Sq, D))
    q_pos = q_offset + torch.arange(Sq)[:, None]
    for k0 in range(0, Skv, block):
        kk, vv = kf[:, :, k0:k0 + block], vf[:, :, k0:k0 + block]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kk) * scale
        if cap:
            s = torch.tanh(s / cap) * cap
        k_pos = k0 + torch.arange(kk.shape[2])[None, :]
        mask = torch.ones((Sq, kk.shape[2]), dtype=torch.bool)
        if causal:
            mask &= q_pos >= k_pos
        if window:
            mask &= (q_pos - k_pos) < window
        s = torch.where(mask, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        ref_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
        corr = torch.exp(m - ref_m)
        p = torch.exp(s - ref_m)
        l = l * corr + p.sum(-1, keepdim=True)
        if round_p:
            p = p.to(torch.bfloat16).to(torch.float32)
        acc = acc * corr + torch.einsum("bhqk,bhkd->bhqd", p, vv)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


@pytest.mark.parametrize("case", CASES)
def test_tc_numerics_match_pallas(case):
    """The card's numerics, route by dtype (bf16: tensor cores, P rounded
    to bf16; float32: the scalar kernel, no rounding), against the Pallas
    kernel in interpret mode at its own tests' tolerances."""
    B, H, S, D = 2, 3, case["S"], case["D"]
    q, k, v = qkv(np.random.default_rng(0), B, H, S, D)
    jd = getattr(jnp, case["dtype"])
    kw = dict(causal=case["causal"], window=case["window"], cap=case["cap"])
    want = flash_attention_fwd_pallas(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
        bq=128, bk=128, interpret=True, **kw)
    got = tc_emulate(as_torch(q, case["dtype"]), as_torch(k, case["dtype"]),
                     as_torch(v, case["dtype"]),
                     round_p=case["dtype"] == "bfloat16", **kw)
    t = tol(case["dtype"])
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32),
                               rtol=t, atol=t)


@pytest.mark.parametrize("case", CASES)
def test_tc_numerics_in_bf16_match_pallas(case):
    """Every mask of the Pallas tests (causal, window, cap, non-causal)
    through the tensor-core route: bf16 inputs, P rounded to bf16 for
    P·V, held against the Pallas kernel on the same bf16 inputs at the
    bf16 tolerance 2e-2 — the rounding's budget, shown before the card."""
    B, H, S, D = 2, 3, case["S"], case["D"]
    q, k, v = qkv(np.random.default_rng(1), B, H, S, D)
    kw = dict(causal=case["causal"], window=case["window"], cap=case["cap"])
    want = flash_attention_fwd_pallas(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), bq=128, bk=128,
        interpret=True, **kw)
    got = tc_emulate(*(as_torch(x, "bfloat16") for x in (q, k, v)),
                     round_p=True, **kw)
    unrounded = tc_emulate(*(as_torch(x, "bfloat16") for x in (q, k, v)),
                           round_p=False, **kw)
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)
    # the rounding of P moves the output by a few bf16 ulps at most
    assert float((got.float() - unrounded.float()).abs().max()) < 2e-2


def row_errors(got, want) -> torch.Tensor:
    """Per row: max |got - want| over D, over the row's largest |want|
    (the largest of these is ``chip_smoke.py``'s bf16 row error)."""
    d = (got.float() - want.float()).abs().amax(-1)
    return d / want.float().abs().amax(-1).clamp_min(1e-6)


def test_row_error_sees_a_dropped_tile():
    """``chip_smoke.py`` holds bf16 attention row by row, within 1.5e-2
    of each row's largest output.  At the serving length (S 2000,
    causal) the tensor-core route's numerics stay about one bf16 ulp
    (2^-7) from the plain version, while a kernel that dropped one 64-key
    tile for the late rows — the first, a middle or the last one they
    see — fails the limit on every such row."""
    B, H, S, D = 1, 2, 2000, 64
    q, k, v = (as_torch(x, "bfloat16")
               for x in qkv(np.random.default_rng(3), B, H, S, D))
    want = ref.flash_attention_ref(q, k, v, causal=True)
    good = tc_emulate(q, k, v, causal=True, round_p=True)
    assert float(row_errors(good, want).max()) <= 1e-2
    i = torch.arange(S)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * D ** -0.5
    seen = i[:, None] >= i[None, :]
    for t0, r0 in ((0, 1900), (640, 1000), (1920, 1984)):
        drop = ((i[:, None] >= r0) & (i[None, :] >= t0)
                & (i[None, :] < t0 + 64))
        p = torch.softmax(torch.where(seen & ~drop, s, -torch.inf), -1)
        bad = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).bfloat16()
        late = row_errors(bad, want)[:, :, r0:]
        assert float(late.min()) > 1.5e-2, (t0, r0, float(late.min()))


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
    z = torch.zeros((1, 2, 8, 32))      # no kernel takes D = 32: the
    assert ops.flash_attention_fwd(z, z, z).shape == z.shape  # plain one does
    with pytest.raises(ValueError, match=r"\(B, H, S, D\)"):
        ops.flash_attention_fwd(q[0], q[0], q[0])
    with pytest.raises(ValueError, match="must be"):
        ops.flash_attention_fwd(q, torch.zeros((1, 3, 8, 16)), q)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention_fwd(q, q, q, window=-1)


@pytest.mark.parametrize("D,causal", [(80, False), (80, True), (32, True)])
def test_head_dims_past_the_kernels_match_jax(D, causal):
    """Head dim 80 (hubert-xlarge) and 32 run the plain version on the CPU,
    as the JAX package runs them: q, k, v (1, 24, 2, D), numpy seed 0."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, 24, 2, D)).astype(np.float32)
               for _ in range(3))
    want = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal, q_block=8,
                                  kv_block=8)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal, q_block=8,
                          kv_block=8)
    assert got.shape == (1, 24, 2, D)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_model_flash_refuses_grad_and_ragged_noncausal():
    """A tensor that requires grad was refused until the FA-2 backward
    came (the name is kept from then): it now runs the forward with its
    lse and the backward (see tests/test_torch_flash_bwd.py for the
    values).  A ragged non-causal kv is still refused, as in JAX."""
    x = torch.zeros((1, 10, 2, 16), requires_grad=True)
    ops.reset_kernel_stats()
    flash_attention(x, x, x, causal=True).sum().backward()
    assert x.grad.shape == x.shape
    assert ops.kernel_stats() == {"flash_attention_fwd:ref": 1,
                                  "flash_attention_bwd:ref": 1}
    with torch.no_grad():
        flash_attention(x, x, x, causal=True)
    y = torch.zeros((1, 10, 2, 16))
    with pytest.raises(ValueError, match="multiple of kv_block"):
        flash_attention(y, y, y, causal=False, kv_block=4)


def _assert_lse(got: torch.Tensor, want: torch.Tensor) -> None:
    """A kernel's lse against the plain version's: -inf at the same rows
    (those with no visible key), the rest within 1e-4 (float32 sums in
    another order, ex2.approx; chip_smoke.py's limit)."""
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert bool(torch.isneginf(got[~fin]).all())
    if bool(fin.any()):
        assert float((got[fin] - want[fin]).abs().max()) <= 1e-4


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

    @pytest.mark.parametrize("D", [16, 64, 80, 128])
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("Sq,Skv", [
        (257, 257), (1, 1), (127, 127), (129, 129), (1000, 1000),
        (127, 129), (129, 127), (1, 1000)])
    @pytest.mark.parametrize("lse", [False, True])
    def test_bf16_head_dims(self, cuda_device, D, causal, Sq, Skv, lse):
        """The wgmma route at every head dim, with and without the lse,
        at Sq and Skv around the 128-row q tile and the 128-key kv tile
        (1, 127, 129, 1,000 and a ragged 257), at the bf16 tolerance; the
        lse within 1e-4, -inf exactly where the plain version's is."""
        rng = np.random.default_rng(D + causal + Sq + 3 * Skv)
        q, k, v = (as_torch(a, "bfloat16", cuda_device)
                   for a in qkv(rng, 2, 3, Sq, D, Skv))
        kw = dict(causal=causal, q_offset=Skv - Sq if causal else 0)
        ops.reset_kernel_stats()
        got = ops.flash_attention_fwd(q, k, v, return_lse=lse, **kw)
        want = ref.flash_attention_ref(q, k, v, return_lse=lse, **kw)
        assert ops.kernel_stats() == {
            "flash_attention_fwd": 1, "flash_attention_fwd:bf16": 1,
            **({"flash_attention_fwd:lse": 1} if lse else {})}
        torch.cuda.synchronize()
        if lse:
            (got, got_lse), (want, want_lse) = got, want
            _assert_lse(got_lse, want_lse)
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)

    @pytest.mark.parametrize("Sq,Skv,q_offset", [
        (64, 300, 236), (17, 129, 112), (100, 40, 0), (130, 200, -30),
        (1, 1000, 999), (127, 1000, 873), (129, 1000, 871),
        (300, 300, -200)])
    def test_bf16_q_offset(self, cuda_device, Sq, Skv, q_offset):
        """Sq != Skv with the query block at absolute position q_offset:
        a decode-style chunk at the end of the keys (one row, and 127 or
        129 rows across the q tile), a short one, keys fewer than
        queries, and offsets that hide rows entirely: at -200 every row
        of the first 128-row q tile sees no key (output 0, lse -inf)."""
        rng = np.random.default_rng(Sq + Skv)
        q, k, v = (as_torch(a, "bfloat16", cuda_device)
                   for a in qkv(rng, 2, 3, Sq, 64, Skv))
        for kw in (dict(causal=True), dict(causal=True, window=50)):
            got, got_lse = ops.flash_attention_fwd(
                q, k, v, q_offset=q_offset, return_lse=True, **kw)
            want, want_lse = ref.flash_attention_ref(
                q, k, v, q_offset=q_offset, return_lse=True, **kw)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                       atol=2e-2)
            _assert_lse(got_lse, want_lse)
            blind = q_offset + torch.arange(Sq, device=cuda_device) < 0
            assert bool((got[:, :, blind] == 0).all())
            assert bool(torch.isneginf(got_lse[:, :, blind]).all())

    @pytest.mark.parametrize("D", [16, 64, 80, 128])
    def test_bf16_window_and_cap(self, cuda_device, D):
        rng = np.random.default_rng(D)
        q, k, v = (as_torch(a, "bfloat16", cuda_device)
                   for a in qkv(rng, 2, 3, 500, D))
        for kw in (dict(causal=True, window=96, cap=30.0),
                   dict(causal=False, window=70, cap=20.0),
                   dict(causal=True, window=1),
                   dict(causal=True, window=200, cap=50.0)):
            got = ops.flash_attention_fwd(q, k, v, **kw)
            want = ref.flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                       atol=2e-2)

    @pytest.mark.parametrize("S,H,D", [(300, 9, 64), (1000, 16, 80),
                                       (129, 4, 16), (257, 8, 128)])
    def test_bf16_strided_views(self, cuda_device, S, H, D):
        """The model's (B, S, H, D) bf16 tensors read as (B, H, S, D)
        views by the wgmma kernel's tensor maps, no copy (smollm-135m's
        9 heads of 64, hubert-xlarge's 16 of 80, and D 16 and 128); the
        output and the lse are written through their strides."""
        rng = np.random.default_rng(6 + D)
        x = [as_torch(a, "bfloat16", cuda_device).transpose(1, 2)
             for a in qkv(rng, 2, S, H, D)]
        assert not x[0].is_contiguous()
        for causal in (True, False):
            got, got_lse = ops.flash_attention_fwd(*x, causal=causal,
                                                   return_lse=True)
            want, want_lse = ref.flash_attention_ref(*x, causal=causal,
                                                     return_lse=True)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=2e-2, atol=2e-2)
            _assert_lse(got_lse, want_lse)

    @pytest.mark.parametrize("D", [16, 64, 80, 128])
    def test_bf16_every_head_dim(self, cuda_device, D):
        """The wgmma kernel at each head dim (D 80 and 16 with the
        16-column tail) over the masks, a ragged S and a query block at
        an offset."""
        rng = np.random.default_rng(D + 5)
        q, k, v = (as_torch(a, "bfloat16", cuda_device)
                   for a in qkv(rng, 2, 3, 333, D, 400))
        for kw in (dict(causal=True, q_offset=67), dict(causal=False),
                   dict(causal=True, window=40, cap=30.0, q_offset=67)):
            got = ops.flash_attention_fwd(q, k, v, **kw)
            want = ref.flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                       atol=2e-2)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("D", [32, 96])
    def test_head_dim_without_a_kernel_raises(self, cuda_device, D, dtype):
        """On the card a head dim that neither route takes raises; it is
        never handed to the plain version quietly."""
        x = torch.zeros((1, 2, 8, D), device=cuda_device).to(
            TORCH_DTYPES[dtype])
        ops.reset_kernel_stats()
        with pytest.raises(ValueError, match="head dim"):
            ops.flash_attention_fwd(x, x, x)
        assert ops.kernel_stats() == {}

    def test_hubert_shape_d80(self, cuda_device):
        """hubert-xlarge's attention (H 16, D 80, bidirectional) at a
        ragged S on both routes, through the model's GQA wrapper too."""
        rng = np.random.default_rng(80)
        for dtype in ("bfloat16", "float32"):
            q, k, v = (as_torch(a, dtype, cuda_device)
                       for a in qkv(rng, 2, 16, 250, 80))
            got = ops.flash_attention_fwd(q, k, v, causal=False)
            want = ref.flash_attention_ref(q, k, v, causal=False)
            torch.cuda.synchronize()
            t = tol(dtype)
            torch.testing.assert_close(got.float(), want.float(), rtol=t,
                                       atol=t)
            x = [a.transpose(1, 2) for a in (q, k, v)]
            got = flash_attention(*x, causal=False, kv_block=250)
            torch.testing.assert_close(got.transpose(1, 2).float(),
                                       want.float(), rtol=t, atol=t)

    def test_bf16_misaligned_raises(self, cuda_device):
        """A tensor map reads 16-byte aligned rows: a row stride or base
        pointer that is not 16-byte aligned is refused, not read wrong."""
        wide = torch.zeros((1, 8, 2, 68), dtype=torch.bfloat16,
                           device=cuda_device)
        odd_stride = wide[..., :64].transpose(1, 2)   # h stride 68
        ok = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16,
                         device=cuda_device)
        with pytest.raises(ValueError, match="16-byte"):
            ops.flash_attention_fwd(odd_stride, ok, ok)
        flat = torch.zeros(1 + 2 * 8 * 64, dtype=torch.bfloat16,
                           device=cuda_device)
        odd_base = flat[1:].view(1, 2, 8, 64)         # 2 bytes off
        with pytest.raises(ValueError, match="16-byte"):
            ops.flash_attention_fwd(ok, odd_base, ok)

    @pytest.mark.parametrize("D", [16, 64, 80, 128])
    def test_f32_route_exact(self, cuda_device, D):
        """float32 keeps the scalar kernel, at 2e-5, and counts under the
        same name as the bf16 route."""
        rng = np.random.default_rng(7 + D)
        q, k, v = (as_torch(a, "float32", cuda_device)
                   for a in qkv(rng, 2, 3, 200, D, 230))
        ops.reset_kernel_stats()
        for kw in (dict(causal=True, q_offset=30),
                   dict(causal=True, window=33, cap=25.0, q_offset=30),
                   dict(causal=False)):
            got = ops.flash_attention_fwd(q, k, v, **kw)
            want = ref.flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        assert ops.kernel_stats() == {"flash_attention_fwd": 3,
                                      "flash_attention_fwd:f32": 3}

    def test_strided_views_and_count(self, cuda_device):
        """(B, S, H, D) tensors read as (B, H, S, D) views, no copy."""
        rng = np.random.default_rng(4)
        x = [torch.from_numpy(a).to(cuda_device).transpose(1, 2)
             for a in qkv(rng, 2, 100, 5, 64)]
        ops.reset_kernel_stats()
        got = ops.flash_attention_fwd(*x, causal=True)
        assert ops.kernel_stats() == {"flash_attention_fwd": 1,
                                      "flash_attention_fwd:f32": 1}
        want = ref.flash_attention_ref(*x, causal=True)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
