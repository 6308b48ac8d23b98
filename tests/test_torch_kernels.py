"""The port's kernel wrappers and plain versions against the JAX package.

The same seeded numpy inputs go through ``repro.kernels`` — the Pallas
kernels in interpret mode (``use_kernel=True``) and the jnp oracles — and
through ``repro_torch.kernels`` on the CPU, where the wrappers run the
plain PyTorch versions.  Tolerance: bit-exact; every output is int32 or
bool.  The ``cuda``-marked class holds each CUDA kernel against its plain
version on the card and skips where there is none; on the card run it
alone with ``python -m pytest tests/test_torch_kernels.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.hamming import pack_vertical
from repro_torch.kernels import ops, ref

try:  # the reference; the card's machine has no JAX, and there only the
    import jax.numpy as jnp          # cuda-marked class runs (-m cuda)
    from repro.kernels import ops as jops, ref as jref
except ImportError:
    jnp = jops = jref = None

BIG = 1 << 20


def make_db(rng, n, L, b):
    """(n, L) sketches and their (b, W, n) uint32 lane-major planes."""
    db = rng.integers(0, 1 << b, size=(n, L)).astype(np.uint8)
    return db, np.ascontiguousarray(np.transpose(pack_vertical(db, b),
                                                 (1, 2, 0)))


def tw(words: np.ndarray, device="cpu") -> torch.Tensor:
    """uint32 words -> the port's int32 bit-view tensor."""
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32)).to(device)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("b,L", [(2, 16), (2, 32), (4, 32), (8, 64), (1, 8),
                                 (4, 100)])
@pytest.mark.parametrize("n,m,block_n", [(256, 3, 128), (512, 1, 512),
                                         (130, 2, 128)])
def test_hamming_distances_matches_jax(b, L, n, m, block_n):
    rng = np.random.default_rng(b * 1000 + L + n)
    db, db_vert = make_db(rng, n, L, b)
    q, q_vert = make_db(rng, m, L, b)
    want = np.asarray(jops.hamming_distances(jnp.asarray(db_vert),
                                             jnp.asarray(q_vert),
                                             block_n=block_n, use_kernel=True))
    np.testing.assert_array_equal(
        want, np.asarray(jref.hamming_distances_ref(jnp.asarray(db_vert),
                                                    jnp.asarray(q_vert))))
    got = ops.hamming_distances(tw(db_vert), tw(q_vert), block_n=block_n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ref.hamming_distances_ref(tw(db_vert), tw(q_vert)).numpy(), want)
    np.testing.assert_array_equal(want, (q[:, None] != db[None]).sum(2))


@pytest.mark.parametrize("b,L,tau", [(2, 16, 2), (4, 32, 5), (8, 64, 3),
                                     (2, 16, 0)])
def test_sparse_verify_matches_jax(b, L, tau):
    rng = np.random.default_rng(b + L + tau)
    n = 384
    _, paths_vert = make_db(rng, n, L, b)
    _, q_vert = make_db(rng, 1, L, b)
    base = rng.integers(0, tau + 2, size=n).astype(np.int32)
    base[::7] = BIG
    want, want_d = jops.sparse_verify(jnp.asarray(paths_vert),
                                      jnp.asarray(q_vert[..., 0]),
                                      jnp.asarray(base), tau=tau,
                                      block_n=128, use_kernel=True)
    got, got_d = ops.sparse_verify(tw(paths_vert), tw(q_vert[..., 0]),
                                   torch.from_numpy(base), tau=tau)
    assert got.dtype == got_d.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    r, r_d = ref.sparse_verify_ref(tw(paths_vert), tw(q_vert[..., 0]),
                                   torch.from_numpy(base), tau)
    j, j_d = jref.sparse_verify_ref(jnp.asarray(paths_vert),
                                    jnp.asarray(q_vert[..., 0]),
                                    jnp.asarray(base), tau)
    np.testing.assert_array_equal(r.numpy(), np.asarray(j))
    np.testing.assert_array_equal(r_d.numpy(), np.asarray(j_d))


@pytest.mark.parametrize("b,L,tau", [(2, 16, 2), (4, 32, 5), (8, 64, 3)])
@pytest.mark.parametrize("m,n,block_m,block_n", [
    (5, 390, 2, 128),    # neither m nor n a tile multiple
    (8, 384, 4, 128),    # both exact multiples
    (1, 200, 4, 128),    # m=1 degenerate tile (m < block_m)
    (3, 100, 8, 256),    # n < block_n
])
def test_sparse_verify_batch_matches_jax(b, L, tau, m, n, block_m, block_n):
    rng = np.random.default_rng(b * 100 + L + m + n)
    _, paths_vert = make_db(rng, n, L, b)
    _, q_vert = make_db(rng, m, L, b)
    base = rng.integers(0, tau + 3, size=(m, n)).astype(np.int32)
    base[:, ::5] = BIG
    want, want_d = jops.sparse_verify_batch(
        jnp.asarray(paths_vert), jnp.asarray(q_vert), jnp.asarray(base),
        tau=tau, block_m=block_m, block_n=block_n, use_kernel=True)
    got, got_d = ops.sparse_verify_batch(tw(paths_vert), tw(q_vert),
                                         torch.from_numpy(base), tau=tau,
                                         block_m=block_m, block_n=block_n)
    assert got.shape == got_d.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    r, r_d = ref.sparse_verify_batch_ref(tw(paths_vert), tw(q_vert),
                                         torch.from_numpy(base), tau)
    j, j_d = jref.sparse_verify_batch_ref(jnp.asarray(paths_vert),
                                          jnp.asarray(q_vert),
                                          jnp.asarray(base), tau)
    np.testing.assert_array_equal(r.numpy(), np.asarray(j))
    np.testing.assert_array_equal(r_d.numpy(), np.asarray(j_d))


@pytest.mark.parametrize("batch", [False, True])
def test_live_mask_matches_jax(batch):
    """``live=``: dead lanes get a BIG base, so they never survive."""
    rng = np.random.default_rng(31)
    b, L, m, n, tau = 2, 16, 3, 300, 16
    _, paths_vert = make_db(rng, n, L, b)
    _, q_vert = make_db(rng, m, L, b)
    base = rng.integers(0, 3, size=(m, n)).astype(np.int32)
    live = rng.random(n) < 0.7
    if batch:
        want = jops.sparse_verify_batch(
            jnp.asarray(paths_vert), jnp.asarray(q_vert), jnp.asarray(base),
            tau=tau, live=jnp.asarray(live), block_n=128, use_kernel=True)
        got = ops.sparse_verify_batch(tw(paths_vert), tw(q_vert),
                                      torch.from_numpy(base), tau=tau,
                                      live=torch.from_numpy(live))
    else:
        want = jops.sparse_verify(
            jnp.asarray(paths_vert), jnp.asarray(q_vert[..., 0]),
            jnp.asarray(base[0]), tau=tau, live=jnp.asarray(live),
            block_n=128, use_kernel=True)
        got = ops.sparse_verify(tw(paths_vert), tw(q_vert[..., 0]),
                                torch.from_numpy(base[0]), tau=tau,
                                live=torch.from_numpy(live))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0].numpy()[..., ~live] == 0).all()
    assert (got[1].numpy()[..., ~live] == BIG).all()


def test_big_sentinel_and_popcount_edges():
    assert ref.BIG == ops.BIG == int(jref.BIG) == BIG
    words = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x55555555, 0x0F0F0F0F,
                      0xDEADBEEF], np.uint32)
    want = np.array([bin(int(w)).count("1") for w in words])
    np.testing.assert_array_equal(ref.popcount32(tw(words)).numpy(), want)


def test_to_lane_major_matches_jax():
    rng = np.random.default_rng(5)
    _, vert = make_db(rng, 17, 40, 3)
    planes = np.ascontiguousarray(np.transpose(vert, (2, 0, 1)))  # (n, b, W)
    got = ops.to_lane_major(tw(planes))
    assert got.is_contiguous()
    np.testing.assert_array_equal(
        got.numpy().view(np.uint32),
        np.asarray(jops.to_lane_major(jnp.asarray(planes))))


def test_kernel_stats_count_plain_runs_on_cpu():
    rng = np.random.default_rng(6)
    _, d = make_db(rng, 40, 16, 2)
    _, q = make_db(rng, 2, 16, 2)
    base = torch.zeros((2, 40), dtype=torch.int32)
    ops.reset_kernel_stats()
    ops.hamming_distances(tw(d), tw(q))
    ops.sparse_verify_batch(tw(d), tw(q), base, tau=2)
    ops.sparse_verify_batch(tw(d), tw(q), base, tau=2, use_kernel=True)
    ops.sparse_verify(tw(d), tw(q[..., 0]), base[0], tau=2)
    assert ops.kernel_stats() == {"hamming_distances:ref": 1,
                                  "sparse_verify_batch:ref": 2,
                                  "sparse_verify:ref": 1}
    ops.reset_kernel_stats()
    assert ops.kernel_stats() == {}


@pytest.mark.cuda
class TestKernelsOnCard:
    """Each CUDA kernel against its plain version, on the card."""

    SHAPES = [(2, 16, 1, 1), (2, 16, 130, 3), (1, 8, 4097, 8),
              (8, 64, 4097, 64), (4, 100, 130, 33), (2, 32, 100_003, 64)]

    @pytest.mark.parametrize("b,L,n,m", SHAPES)
    def test_hamming_distances(self, cuda_device, b, L, n, m):
        rng = np.random.default_rng(n + m)
        _, d = make_db(rng, n, L, b)
        _, q = make_db(rng, m, L, b)
        d, q = tw(d, cuda_device), tw(q, cuda_device)
        ops.reset_kernel_stats()
        got = ops.hamming_distances(d, q)
        torch.cuda.synchronize()
        assert ops.kernel_stats() == {"hamming_distances": 1}
        assert torch.equal(got, ref.hamming_distances_ref(d, q))

    @pytest.mark.parametrize("b,L,n,m", SHAPES)
    @pytest.mark.parametrize("tau", [0, 3])
    def test_sparse_verify_batch(self, cuda_device, b, L, n, m, tau):
        rng = np.random.default_rng(n + m + tau)
        _, d = make_db(rng, n, L, b)
        _, q = make_db(rng, m, L, b)
        base = rng.integers(0, tau + 3, size=(m, n)).astype(np.int32)
        base[rng.random((m, n)) < 0.2] = BIG
        d, q = tw(d, cuda_device), tw(q, cuda_device)
        base = torch.from_numpy(base).to(cuda_device)
        ops.reset_kernel_stats()
        mask, dist = ops.sparse_verify_batch(d, q, base, tau=tau)
        torch.cuda.synchronize()
        assert ops.kernel_stats() == {"sparse_verify_batch": 1}
        want_mask, want_dist = ref.sparse_verify_batch_ref(d, q, base, tau)
        assert torch.equal(mask, want_mask.to(torch.int32))
        assert torch.equal(dist, want_dist)
        one_mask, one_dist = ops.sparse_verify(d, q[..., 0].contiguous(),
                                               base[0], tau=tau)
        assert torch.equal(one_mask, mask[0]) and torch.equal(one_dist, dist[0])

    def test_wrapper_rejects_bad_inputs(self, cuda_device):
        d = torch.zeros((2, 1, 64), dtype=torch.int64, device=cuda_device)
        q = torch.zeros((2, 1, 3), dtype=torch.int32, device=cuda_device)
        with pytest.raises(ValueError):
            ops.hamming_distances(d, q)
        with pytest.raises(ValueError):
            ops.sparse_verify_batch(d.to(torch.int32), q,
                                    torch.zeros((3, 63), dtype=torch.int32,
                                                device=cuda_device), tau=1)
