"""The batched launches of the scan and verify kernels, and the MI-bST
candidate verify.

``ops.hamming_distances_batched`` and ``ops.sparse_verify_batch_batched``
add a leading batch axis (grid.z on the card) to the two kernels of
``csrc/hamming.cu``: per-query candidate sets for the scan, the sharded
bST's shards for the verify.  The JAX package reaches the same two
Pallas kernels through ``jax.vmap``.  ``ops.hamming_distances_gather`` is
the port's MI-bST candidate verify: it reads the database through each
query's candidate ids, where the JAX package gathers ``full_vert[:, :,
safe_ids]`` and vmaps the scan over the queries
(``repro/core/multi_index.py:160-169``).  On the CPU the port's plain
versions are held here against those ``vmap``s of ``repro.kernels.ops``
on the same seeded numpy inputs, and the ``cuda``-marked class holds
each kernel against its plain version on the card (run it there with
``python -m pytest tests/test_torch_batched_kernels.py -m cuda``; it
skips where there is no card): batch 1, 3, 4 and 64, ragged n and m, a
shared query set (batch stride 0) and per-entry ones, base planes with
BIG lanes; candidate counts of 0, ragged and C, ids at 0 and n - 1.
Tolerance: bit for bit (int32 and bool outputs).
"""

import numpy as np
import pytest
import torch

from repro_torch.core.hamming import pack_vertical
from repro_torch.kernels import ops, ref

try:  # the reference; the card's machine has no JAX, and there only the
    import jax                       # cuda-marked class runs (-m cuda)
    import jax.numpy as jnp
    from repro.kernels import ops as jops
except ImportError:
    jax = jnp = jops = None

BIG = 1 << 20


def planes(rng, B, n, L, b):
    """(B, b, W, n) uint32 lane-major planes of B random databases."""
    db = rng.integers(0, 1 << b, size=(B, n, L)).astype(np.uint8)
    return np.ascontiguousarray(np.stack(
        [np.transpose(pack_vertical(d, b), (1, 2, 0)) for d in db]))


def tw(words: np.ndarray, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32)).to(
        device)


def base_plane(rng, B, m, n, tau):
    base = rng.integers(0, tau + 3, size=(B, m, n)).astype(np.int32)
    base[rng.random((B, m, n)) < 0.2] = BIG
    return base


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("b,L", [(2, 16), (4, 32), (1, 8), (8, 64)])
@pytest.mark.parametrize("B,m,n", [(5, 1, 37), (3, 4, 130), (1, 2, 64)])
def test_hamming_batched_ref_matches_jax_vmap(b, L, B, m, n):
    """Per-entry query sets (the MI verify's shape when m = 1)."""
    rng = np.random.default_rng(b * 100 + B * 10 + m)
    db, q = planes(rng, B, n, L, b), planes(rng, B, m, L, b)
    want = np.asarray(jax.vmap(
        lambda d, qq: jops.hamming_distances(d, qq))(jnp.asarray(db),
                                                     jnp.asarray(q)))
    got = ops.hamming_distances_batched(tw(db), tw(q))
    assert got.dtype == torch.int32 and got.shape == (B, m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    shared = ops.hamming_distances_batched(tw(db), tw(q[:1]))
    for z in range(B):
        np.testing.assert_array_equal(
            shared[z].numpy(), np.asarray(jops.hamming_distances(
                jnp.asarray(db[z]), jnp.asarray(q[0]))))


@pytest.mark.parametrize("b,L", [(2, 8), (4, 16), (2, 40)])
@pytest.mark.parametrize("S,m,n", [(4, 5, 70), (1, 8, 33), (3, 1, 200)])
@pytest.mark.parametrize("tau", [0, 2])
def test_verify_batched_ref_matches_jax_vmap(b, L, S, m, n, tau):
    """Per-shard databases and base planes, the query planes shared (the
    sharded scan's shape)."""
    rng = np.random.default_rng(b * 1000 + S * 100 + m + tau)
    db, q = planes(rng, S, n, L, b), planes(rng, 1, m, L, b)[0]
    base = base_plane(rng, S, m, n, tau)
    wm, wd = jax.vmap(lambda d, bs: jops.sparse_verify_batch(
        d, jnp.asarray(q), bs, tau=tau))(jnp.asarray(db), jnp.asarray(base))
    gm, gd = ops.sparse_verify_batch_batched(tw(db), tw(q),
                                             torch.from_numpy(base), tau=tau)
    assert gm.dtype == torch.int32 and gd.dtype == torch.int32
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm).astype(np.int32))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


def gather_case(rng, b, L, n, m, C, counts):
    """(full_vert, q_vert, ids, counts) of a candidate verify: each row's
    valid prefix ascending random ids (n - 1 and 0 among them where the
    prefix holds two), garbage ids past it as the compaction leaves."""
    full = planes(rng, 1, n, L, b)[0]
    q = planes(rng, 1, m, L, b)[0]
    ids = rng.integers(0, n, size=(m, C)).astype(np.int32)
    for j, k in enumerate(counts):
        row = np.sort(rng.choice(n, size=k, replace=False)).astype(np.int32)
        if k >= 2:
            row[0], row[-1] = 0, n - 1
        ids[j, :k] = row
    return full, q, ids, np.asarray(counts, np.int32)


def jax_gather_verify(full, q, ids, counts):
    """The JAX package's MI-bST verify (``repro/core/multi_index.py``):
    gather every slot's columns, vmap the scan over the queries."""
    C = ids.shape[1]
    valid = np.arange(C)[None, :] < counts[:, None]
    safe = np.where(valid, ids, 0)
    cand = jnp.asarray(full)[:, :, safe]                       # (b, W, m, C)
    dist = jax.vmap(lambda cv, qv: jops.hamming_distances(cv, qv[..., None])[0],
                    in_axes=(2, 2))(cand, jnp.asarray(q))      # (m, C)
    return np.asarray(dist), valid


@pytest.mark.parametrize("b,L", [(1, 8), (2, 16), (4, 40), (8, 64)])
@pytest.mark.parametrize("n,C,counts", [
    (50, 7, [0, 3, 7, 1]),          # empty, ragged and full rows
    (97, 16, [16, 16]),             # every slot valid
    (40, 5, [0, 0, 0]),             # no candidate at all
    (300, 33, [2, 33, 17, 0, 9])])
def test_gather_ref_matches_jax_vmap(b, L, n, C, counts):
    """The plain candidate verify equals the JAX package's vmapped scan at
    every valid slot, and is BIG past each count."""
    rng = np.random.default_rng(b * 1000 + n + C)
    full, q, ids, cnt = gather_case(rng, b, L, n, len(counts), C, counts)
    want, valid = jax_gather_verify(full, q, ids, cnt)
    got = ops.hamming_distances_gather(tw(full), tw(q), torch.from_numpy(ids),
                                       torch.from_numpy(cnt))
    assert got.dtype == torch.int32 and got.shape == ids.shape
    np.testing.assert_array_equal(got.numpy(), np.where(valid, want, BIG))
    # a row-strided slice of a wider compaction buffer reads the same
    wide = np.concatenate([ids, np.zeros((len(counts), 1), np.int32)], 1)
    sliced = torch.from_numpy(wide)[:, :C]
    np.testing.assert_array_equal(ops.hamming_distances_gather(
        tw(full), tw(q), sliced, torch.from_numpy(cnt)).numpy(), got.numpy())


def test_gather_rejects_bad_inputs():
    full = torch.zeros((2, 1, 64), dtype=torch.int32)
    q = torch.zeros((2, 1, 3), dtype=torch.int32)
    ids = torch.zeros((3, 5), dtype=torch.int32)
    cnt = torch.zeros((3,), dtype=torch.int32)
    for bad in ((full.long(), q, ids, cnt),               # dtype
                (full, q[:1].contiguous(), ids, cnt),     # query planes
                (full, q, ids[:2], cnt),                  # ids rows != m
                (full, q, ids, cnt[:2]),                  # counts shape
                (full, q, ids.t(), cnt[:1].contiguous()),  # strided columns
                (full.transpose(0, 1), q, ids, cnt),      # not contiguous
                (torch.zeros((9, 1, 4), dtype=torch.int32),
                 torch.zeros((9, 1, 3), dtype=torch.int32), ids, cnt)):  # b 9
        with pytest.raises(ValueError):
            ops.hamming_distances_gather(*bad)


def test_plain_runs_are_counted_under_the_batched_names():
    rng = np.random.default_rng(0)
    db, q = planes(rng, 2, 40, 16, 2), planes(rng, 2, 3, 16, 2)
    ops.reset_kernel_stats()
    ops.hamming_distances_batched(tw(db), tw(q))
    ops.sparse_verify_batch_batched(tw(db), tw(q[0]), torch.zeros(
        (2, 3, 40), dtype=torch.int32), tau=1)
    ops.hamming_distances_gather(tw(db[0]), tw(q[0]), torch.zeros(
        (3, 4), dtype=torch.int32), torch.ones((3,), dtype=torch.int32))
    assert ops.kernel_stats() == {"hamming_distances_batched:ref": 1,
                                  "sparse_verify_batch_batched:ref": 1,
                                  "hamming_distances_gather:ref": 1}


@pytest.mark.cuda
class TestBatchedKernelsOnCard:
    """Each batched launch against its plain version, on the card."""

    SHAPES = [(1, 2, 16, 1, 1), (3, 2, 16, 130, 3), (4, 1, 8, 4097, 8),
              (64, 2, 16, 1000, 1), (4, 8, 64, 4097, 64),
              (3, 4, 100, 130, 33), (64, 2, 16, 3001, 1)]

    @pytest.mark.parametrize("B,b,L,n,m", SHAPES)
    @pytest.mark.parametrize("shared", [False, True])
    def test_hamming_distances_batched(self, cuda_device, B, b, L, n, m,
                                       shared):
        rng = np.random.default_rng(B * n + m)
        db = tw(planes(rng, B, n, L, b), cuda_device)
        q = tw(planes(rng, 1 if shared else B, m, L, b), cuda_device)
        ops.reset_kernel_stats()
        got = ops.hamming_distances_batched(db, q)
        torch.cuda.synchronize()
        assert ops.kernel_stats() == {"hamming_distances_batched": 1}
        assert torch.equal(got, ref.hamming_distances_batched_ref(db, q))
        one = ops.hamming_distances(db[-1].contiguous(), q[-1].contiguous())
        assert torch.equal(one, got[-1])

    @pytest.mark.parametrize("B,b,L,n,m", SHAPES)
    @pytest.mark.parametrize("tau", [0, 3])
    def test_sparse_verify_batch_batched(self, cuda_device, B, b, L, n, m,
                                         tau):
        rng = np.random.default_rng(B * n + m + tau)
        db = tw(planes(rng, B, n, L, b), cuda_device)
        q = tw(planes(rng, 1, m, L, b)[0], cuda_device)
        base = torch.from_numpy(base_plane(rng, B, m, n, tau)).to(cuda_device)
        ops.reset_kernel_stats()
        mask, dist = ops.sparse_verify_batch_batched(db, q, base, tau=tau)
        torch.cuda.synchronize()
        assert ops.kernel_stats() == {"sparse_verify_batch_batched": 1}
        want_mask, want_dist = ref.sparse_verify_batch_batched_ref(db, q,
                                                                   base, tau)
        assert torch.equal(mask, want_mask.to(torch.int32))
        assert torch.equal(dist, want_dist)
        one_mask, one_dist = ops.sparse_verify_batch(
            db[0].contiguous(), q, base[0].contiguous(), tau=tau)
        assert torch.equal(one_mask, mask[0]) and torch.equal(one_dist,
                                                              dist[0])

    GATHER = [(1, 8, 37, 5, [0, 3, 5]), (2, 16, 4097, 300, [300, 0, 17]),
              (4, 40, 1000, 64, [64] * 64), (8, 64, 4099, 1000, [999, 1]),
              (3, 20, 70001, 2049, [2049, 1024, 0, 513]),
              (2, 16, 100, 1, [1])]

    @pytest.mark.parametrize("b,L,n,C,counts", GATHER)
    def test_hamming_distances_gather(self, cuda_device, b, L, n, C, counts):
        rng = np.random.default_rng(b * n + C)
        full, q, ids, cnt = (torch.from_numpy(np.ascontiguousarray(x).view(
            np.int32)).to(cuda_device) for x in gather_case(
                rng, b, L, n, len(counts), C, counts))
        ops.reset_kernel_stats()
        got = ops.hamming_distances_gather(full, q, ids, cnt)
        torch.cuda.synchronize()
        assert ops.kernel_stats() == {"hamming_distances_gather": 1}
        assert torch.equal(got, ref.hamming_distances_gather_ref(full, q, ids,
                                                                 cnt))

    def test_wrappers_reject_bad_inputs(self, cuda_device):
        db = torch.zeros((3, 2, 1, 64), dtype=torch.int32, device=cuda_device)
        with pytest.raises(ValueError):       # a query batch of 2, not 1/3
            ops.hamming_distances_batched(db, torch.zeros(
                (2, 2, 1, 4), dtype=torch.int32, device=cuda_device))
        with pytest.raises(ValueError):       # 3-D database
            ops.hamming_distances_batched(db[0], db[0])
        q = torch.zeros((2, 1, 4), dtype=torch.int32, device=cuda_device)
        with pytest.raises(ValueError):       # base of the wrong shape
            ops.sparse_verify_batch_batched(db, q, torch.zeros(
                (3, 4, 63), dtype=torch.int32, device=cuda_device), tau=1)
