"""The port's arena verifies and exact re-rank against the JAX package.

The same seeded numpy inputs go through ``repro.kernels`` — the jnp
oracles, and the wrappers, which take the Pallas kernels in interpret
mode from n >= 2048 columns (``DEFAULT_BLOCK_N``) — and through
``repro_torch.kernels`` on the CPU, where the wrappers run the plain
PyTorch versions.  Tolerance: bit-exact; masks and distances are int32 or
bool, and re-rank scores are compared as float32 bit patterns.  The
``cuda``-marked class holds each CUDA kernel against its plain version
on the card and skips where there is none.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.hamming import pack_suffix_words, pack_vertical
from repro_torch.kernels import ops, ref

try:  # the reference; the card's machine has no JAX, and there only the
    import jax.numpy as jnp          # cuda-marked class runs (-m cuda)
    from repro.kernels import ops as jops, ref as jref
except ImportError:
    jnp = jops = jref = None

BIG = 1 << 20
PACKED_BS = [(1, 32), (2, 16), (2, 4), (4, 8), (8, 4), (2, 0)]
PLANE_BL = [(2, 16), (2, 40), (4, 32), (8, 64), (1, 8)]
METRICS = ("jaccard", "cosine", "containment")


def tw(words: np.ndarray, device="cpu") -> torch.Tensor:
    """uint32 words -> the port's int32 bit-view tensor."""
    return torch.from_numpy(
        np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)).to(device)


def bits(x) -> np.ndarray:
    """float32 scores as their int32 bit patterns."""
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32)).view(np.int32)


def lanes(rng, n, m, T, tau):
    """An (m, T) base plane with BIG lanes, an (n,) index lane into it
    and an (n,) liveness lane with dead columns."""
    plane = rng.integers(0, tau + 3, size=(m, T)).astype(np.int32)
    plane[rng.random((m, T)) < 0.2] = BIG
    idx = rng.integers(0, T, size=n).astype(np.int32)
    live = rng.random(n) < 0.8
    return plane, idx, live


def packed_inputs(rng, n, m, b, S):
    db = pack_suffix_words(rng.integers(0, 1 << b, size=(n, S)), b)
    q = pack_suffix_words(rng.integers(0, 1 << b, size=(m, S)), b)
    return db, q


def plane_inputs(rng, n, m, b, L):
    db = rng.integers(0, 1 << b, size=(n, L))
    q = rng.integers(0, 1 << b, size=(m, L))
    vert = (lambda x: np.ascontiguousarray(
        np.transpose(pack_vertical(x, b), (1, 2, 0))))
    return vert(db), vert(q)


def rerank_inputs(rng, n, m, Wp, empty=True):
    pay = rng.integers(0, 1 << 32, size=(Wp, n), dtype=np.uint32)
    q = rng.integers(0, 1 << 32, size=(Wp, m), dtype=np.uint32)
    if empty:
        pay[:, n // 3] = 0                 # |B| = 0
        q[:, 0] = 0                        # |A| = 0
    surv = (rng.random((m, n)) < 0.4).astype(np.int32)
    return pay, q, surv


def assert_pair(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("b,S", PACKED_BS)
@pytest.mark.parametrize("m,n,T", [(5, 390, 7), (1, 64, 1), (8, 300, 40)])
def test_packed_verify_ref_matches_jax(b, S, m, n, T):
    rng = np.random.default_rng(b * 100 + S + n + m)
    tau = 3
    db, q = packed_inputs(rng, n, m, b, S)
    plane, idx, live = lanes(rng, n, m, T, tau)
    want = jref.sparse_verify_arena_packed_ref(
        jnp.asarray(db), jnp.asarray(q), jnp.asarray(plane),
        jnp.asarray(idx), jnp.asarray(live), b, S, tau)
    got = ref.sparse_verify_arena_packed_ref(
        tw(db), tw(q), torch.from_numpy(plane), torch.from_numpy(idx),
        torch.from_numpy(live), b, S, tau)
    assert got[0].dtype == torch.bool and got[1].dtype == torch.int32
    assert_pair(got, want)
    wrapped = ops.sparse_verify_arena_packed(
        tw(db), tw(q), torch.from_numpy(plane), torch.from_numpy(idx),
        torch.from_numpy(live), b=b, S=S, tau=tau)
    assert wrapped[0].dtype == torch.int32
    assert_pair(wrapped, (np.asarray(want[0]).astype(np.int32), want[1]))


@pytest.mark.parametrize("b,L", PLANE_BL)
@pytest.mark.parametrize("m,n,T", [(5, 390, 7), (1, 64, 1), (3, 200, 33)])
def test_plane_verify_ref_matches_jax(b, L, m, n, T):
    rng = np.random.default_rng(b * 100 + L + n + m)
    tau = 4
    db, q = plane_inputs(rng, n, m, b, L)
    plane, idx, live = lanes(rng, n, m, T, tau)
    want = jref.sparse_verify_arena_ref(
        jnp.asarray(db), jnp.asarray(q), jnp.asarray(plane),
        jnp.asarray(idx), jnp.asarray(live), tau)
    got = ref.sparse_verify_arena_ref(
        tw(db), tw(q), torch.from_numpy(plane), torch.from_numpy(idx),
        torch.from_numpy(live), tau)
    assert_pair(got, want)
    wrapped = ops.sparse_verify_arena(
        tw(db), tw(q), torch.from_numpy(plane), torch.from_numpy(idx),
        torch.from_numpy(live), tau=tau)
    assert_pair(wrapped, (np.asarray(want[0]).astype(np.int32), want[1]))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("Wp,m,n", [(1, 1, 70), (3, 5, 64), (8, 3, 130),
                                    (33, 8, 40)])
def test_rerank_ref_matches_jax(metric, Wp, m, n):
    rng = np.random.default_rng(Wp * 1000 + m + n)
    pay, q, surv = rerank_inputs(rng, n, m, Wp)
    want = np.asarray(jref.exact_rerank_ref(jnp.asarray(pay), jnp.asarray(q),
                                            jnp.asarray(surv), metric))
    got = ref.exact_rerank_ref(tw(pay), tw(q), torch.from_numpy(surv), metric)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))
    wrapped = ops.exact_rerank(tw(pay), tw(q), torch.from_numpy(surv),
                               metric=metric)
    np.testing.assert_array_equal(bits(wrapped.numpy()), bits(want))
    assert (got.numpy()[surv == 0] == -1.0).all()
    assert np.isfinite(got.numpy()).all()


def survivor_plane(pattern: str, m: int, n: int) -> np.ndarray:
    """(m, n) int32 survivor flags in the patterns the re-rank kernel
    treats specially: none at all, one lane per row, or only the last
    three (ragged) columns."""
    surv = np.zeros((m, n), np.int32)
    if pattern == "one_per_row":
        surv[np.arange(m), (np.arange(m) * 37 + 5) % n] = 1
    elif pattern == "ragged_tail":
        surv[:, -3:] = 1
    return surv


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("pattern", ["none", "one_per_row", "ragged_tail"])
@pytest.mark.parametrize("Wp", [3, 9])
def test_rerank_ref_survivor_patterns_match_jax(metric, pattern, Wp):
    """The survivor patterns of the kernel's lazy payload loads, and
    Wp > 8 (words past those it keeps in registers), on n = 131 (ragged
    for 4 columns a thread)."""
    rng = np.random.default_rng(Wp * 10 + len(pattern))
    m, n = 5, 131
    pay, q, _ = rerank_inputs(rng, n, m, Wp)
    surv = survivor_plane(pattern, m, n)
    want = np.asarray(jref.exact_rerank_ref(jnp.asarray(pay), jnp.asarray(q),
                                            jnp.asarray(surv), metric))
    got = ref.exact_rerank_ref(tw(pay), tw(q), torch.from_numpy(surv), metric)
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))
    wrapped = ops.exact_rerank(tw(pay), tw(q), torch.from_numpy(surv),
                               metric=metric)
    np.testing.assert_array_equal(bits(wrapped.numpy()), bits(want))
    assert (got.numpy()[surv == 0] == -1.0).all()
    assert int((got.numpy() != -1.0).sum()) <= int(surv.sum())


def edge_lanes(rng, n, m, T, case):
    """Base planes and lanes at the plane verify's slab codes: bases 0..13
    (a code of their own), 14 and up and negatives (read back from the
    row), BIG mixed in; or every lane dead."""
    plane = rng.integers(0, 14, size=(m, T)).astype(np.int32)
    plane[rng.random((m, T)) < 0.25] = BIG
    odd = rng.random((m, T)) < 0.25
    plane[odd] = rng.choice([14, 15, 16, 40, -1, BIG - 1, BIG + 1],
                            size=int(odd.sum()))
    idx = rng.integers(0, T, size=n).astype(np.int32)
    live = (np.zeros(n, bool) if case == "all_dead"
            else rng.random(n) < 0.8)
    return plane, idx, live


@pytest.mark.parametrize("case,T", [("escape", 19), ("all_dead", 19),
                                    ("escape", 1)])
@pytest.mark.parametrize("m", [1, 17])
@pytest.mark.parametrize("b,L", [(2, 22), (2, 40)])
def test_plane_verify_ref_edge_bases_match_jax(case, T, m, b, L):
    """The plane verify at its slab's codes (bases 0..13, 14 and up,
    negatives and BIG), with every lane dead, at T = 1, for one query and
    for 17 (one more than a 16-query pass), W of 1 and 2; τ = 16 so that
    bases past 13 can still verify."""
    rng = np.random.default_rng(m * 7 + T + L)
    n, tau = 131, 16
    db, q = plane_inputs(rng, n, m, b, L)
    plane, idx, live = edge_lanes(rng, n, m, T, case)
    want = jref.sparse_verify_arena_ref(
        jnp.asarray(db), jnp.asarray(q), jnp.asarray(plane),
        jnp.asarray(idx), jnp.asarray(live), tau)
    args = (tw(db), tw(q), torch.from_numpy(plane), torch.from_numpy(idx),
            torch.from_numpy(live))
    assert_pair(ref.sparse_verify_arena_ref(*args, tau), want)
    wrapped = ops.sparse_verify_arena(*args, tau=tau)
    assert_pair(wrapped, (np.asarray(want[0]).astype(np.int32), want[1]))
    if case == "all_dead":
        assert (np.asarray(want[1]) == BIG).all()


def test_slab_queries_by_roots():
    """The arena verifies' queries per pass: 16 while a 64-bit slab stays
    within SLAB_BYTES, then 8, then 4 (the packed verify's 4-query slab
    at the segmented Review shape's T)."""
    cap = ops.SLAB_BYTES
    assert ops._slab_queries(1) == 16
    assert ops._slab_queries(662_938) == 16
    assert ops._slab_queries(cap // 8) == 16
    assert ops._slab_queries(cap // 8 + 1) == 8
    assert ops._slab_queries(cap // 4) == 8
    assert ops._slab_queries(cap // 4 + 1) == 4
    assert ops._slab_queries(6_818_030) == 4
    slab, q = ops._slab(100, torch.device("cpu"))
    assert q == 16 and slab.shape == (100,) and slab.element_size() == 8


@pytest.mark.parametrize("kernel", ["packed", "plane", "rerank"])
def test_wrappers_match_jax_pallas_interpret(kernel):
    """n >= 2048 columns: the JAX wrappers run the Pallas kernels (in
    interpret mode on the CPU), with their padding of n, m and T."""
    rng = np.random.default_rng(77)
    n, m, T, tau = 2100, 3, 9, 5
    plane, idx, live = lanes(rng, n, m, T, tau)
    if kernel == "packed":
        db, q = packed_inputs(rng, n, m, 2, 12)
        want = jops.sparse_verify_arena_packed(
            jnp.asarray(db), jnp.asarray(q), jnp.asarray(plane),
            jnp.asarray(idx), jnp.asarray(live), b=2, S=12, tau=tau)
        got = ops.sparse_verify_arena_packed(
            tw(db), tw(q), torch.from_numpy(plane), torch.from_numpy(idx),
            torch.from_numpy(live), b=2, S=12, tau=tau)
        assert_pair(got, want)
    elif kernel == "plane":
        db, q = plane_inputs(rng, n, m, 2, 40)
        want = jops.sparse_verify_arena(
            jnp.asarray(db), jnp.asarray(q), jnp.asarray(plane),
            jnp.asarray(idx), jnp.asarray(live), tau=tau)
        got = ops.sparse_verify_arena(
            tw(db), tw(q), torch.from_numpy(plane), torch.from_numpy(idx),
            torch.from_numpy(live), tau=tau)
        assert_pair(got, want)
    else:
        pay, qp, surv = rerank_inputs(rng, n, m, 3)
        for metric in METRICS:
            want = jops.exact_rerank(jnp.asarray(pay), jnp.asarray(qp),
                                     jnp.asarray(surv), metric=metric)
            got = ops.exact_rerank(tw(pay), tw(qp), torch.from_numpy(surv),
                                   metric=metric)
            np.testing.assert_array_equal(bits(got.numpy()), bits(want))


@pytest.mark.parametrize("tau", [0, 2, 5])
def test_threshold_count_ref_matches_jax(tau):
    rng = np.random.default_rng(tau)
    db, q = plane_inputs(rng, 300, 4, 2, 16)
    want = jref.hamming_threshold_count_ref(jnp.asarray(db), jnp.asarray(q),
                                            tau)
    got = ref.hamming_threshold_count_ref(tw(db), tw(q), tau)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_packed_distances_are_suffix_hamming():
    """The OR-fold of the b S-bit fields of the XOR is the Hamming
    distance of the suffixes, at every packable (b, S) — including the
    word's top bit (S = 32) and the empty suffix (S = 0)."""
    rng = np.random.default_rng(3)
    for b, S in PACKED_BS:
        a = rng.integers(0, 1 << b, size=(40, S))
        c = rng.integers(0, 1 << b, size=(6, S))
        d = ref.packed_distances_ref(tw(pack_suffix_words(a, b)),
                                     tw(pack_suffix_words(c, b)), b, S)
        np.testing.assert_array_equal(d.numpy(),
                                      (c[:, None] != a[None]).sum(2))
    assert ref.field_mask(0) == 0 and ref.field_mask(32) == 0xFFFFFFFF


def test_argument_checks():
    z = torch.zeros((4,), dtype=torch.int32)
    one = torch.ones((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError):               # b*S > 32
        ops.sparse_verify_arena_packed(z, z[:1], one[:, :1], z, z.bool(), b=2,
                                       S=17, tau=1)
    with pytest.raises(ValueError):               # unknown metric
        ops.exact_rerank(z[None], z[None, :1], one, metric="dice")
    with pytest.raises(ValueError):
        ref.exact_rerank_ref(z[None], z[None, :1], torch.ones((1, 4)), "dice")
    assert ref.RERANK_METRICS == ops.RERANK_METRICS \
        == tuple(jref.RERANK_METRICS)


def test_kernel_stats_count_plain_runs_on_cpu():
    rng = np.random.default_rng(6)
    n, m, T = 50, 2, 3
    plane, idx, live = lanes(rng, n, m, T, 2)
    plane, idx, live = (torch.from_numpy(x) for x in (plane, idx, live))
    db, q = packed_inputs(rng, n, m, 2, 5)
    vdb, vq = plane_inputs(rng, n, m, 2, 16)
    pay, qp, surv = rerank_inputs(rng, n, m, 2)
    ops.reset_kernel_stats()
    ops.sparse_verify_arena_packed(tw(db), tw(q), plane, idx, live, b=2, S=5,
                                   tau=2)
    ops.sparse_verify_arena(tw(vdb), tw(vq), plane, idx, live, tau=2)
    ops.sparse_verify_arena(tw(vdb), tw(vq), plane, idx, live, tau=2,
                            use_kernel=True)
    ops.exact_rerank(tw(pay), tw(qp), torch.from_numpy(surv), metric="cosine")
    assert ops.kernel_stats() == {"sparse_verify_arena_packed:ref": 1,
                                  "sparse_verify_arena:ref": 2,
                                  "exact_rerank:ref": 1}
    ops.reset_kernel_stats()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
class TestArenaKernelsOnCard:
    """Each CUDA kernel of this file against its plain version, on the
    card: bit-exact over ragged n and m, T from 1 past 2^22 (every slab
    width), dead lanes, BIG and escape-coded bases, survivor densities
    from none to all, and misaligned views."""

    SHAPES = [(1, 1, 1), (130, 3, 7), (4097, 8, 100_003), (100_003, 33, 7)]

    @pytest.mark.parametrize("b,S", PACKED_BS)
    @pytest.mark.parametrize("n,m,T", SHAPES)
    def test_packed(self, cuda_device, b, S, n, m, T):
        rng = np.random.default_rng(n + m + b + S)
        db, q = packed_inputs(rng, n, m, b, S)
        plane, idx, live = (torch.from_numpy(x).to(cuda_device)
                            for x in lanes(rng, n, m, T, 3))
        db, q = tw(db, cuda_device), tw(q, cuda_device)
        ops.reset_kernel_stats()
        got = ops.sparse_verify_arena_packed(db, q, plane, idx, live, b=b,
                                             S=S, tau=3)
        torch.cuda.synchronize()
        assert ops.kernel_stats() == {"sparse_verify_arena_packed": 1}
        want = ref.sparse_verify_arena_packed_ref(db, q, plane, idx, live,
                                                  b, S, 3)
        assert torch.equal(got[0], want[0].to(torch.int32))
        assert torch.equal(got[1], want[1])

    @pytest.mark.parametrize("n", [100_003, 1 << 17])
    @pytest.mark.parametrize("m", [1, 2, 63, 64, 65])
    def test_packed_query_pass_edges(self, cuda_device, m, n):
        """The query-major passes at their edges: m of one query, of a
        ragged pass, one short of, at and past a multiple of the 4 or 8
        queries of a slab pass; ragged n (one column a thread) and
        n % 4 = 0 (four); a T past 2^22 with base_idx at T - 1 and at 0."""
        T = (1 << 22) + 3
        b, S = 2, 4
        rng = np.random.default_rng(m + n)
        db, q = packed_inputs(rng, n, m, b, S)
        plane, idx, live = lanes(rng, n, m, T, 3)
        idx[::7] = T - 1
        idx[3::7] = 0
        plane[:, T - 1] = rng.integers(0, 3, size=m)
        plane, idx, live = (torch.from_numpy(x).to(cuda_device)
                            for x in (plane, idx, live))
        db, q = tw(db, cuda_device), tw(q, cuda_device)
        ops.reset_kernel_stats()
        got = ops.sparse_verify_arena_packed(db, q, plane, idx, live, b=b,
                                             S=S, tau=3)
        torch.cuda.synchronize()
        assert ops.kernel_stats() == {"sparse_verify_arena_packed": 1}
        want = ref.sparse_verify_arena_packed_ref(db, q, plane, idx, live,
                                                  b, S, 3)
        assert torch.equal(got[0], want[0].to(torch.int32))
        assert torch.equal(got[1], want[1])
        assert bool(got[0][:, ::7].any())        # the T - 1 lanes verify

    @pytest.mark.parametrize("n", [4097, 1 << 16])
    def test_packed_escape_values(self, cuda_device, n):
        """Base values the kernel's slab codes as escapes (negative,
        13..BIG-1, past BIG) are read back from the int32 plane: still
        bit-exact against the plain version, on the one-column and the
        four-column path."""
        m, T, b, S = 5, 100_003, 4, 8
        rng = np.random.default_rng(n)
        db, q = packed_inputs(rng, n, m, b, S)
        plane, idx, live = lanes(rng, n, m, T, 3)
        odd = rng.random((m, T)) < 0.05
        plane[odd] = rng.choice([-3, 13, 14, 15, 253, 254, 300, BIG - 1,
                                 BIG + 1, 2 ** 31 - 1], size=int(odd.sum()))
        plane, idx, live = (torch.from_numpy(x).to(cuda_device)
                            for x in (plane, idx, live))
        db, q = tw(db, cuda_device), tw(q, cuda_device)
        got = ops.sparse_verify_arena_packed(db, q, plane, idx, live, b=b,
                                             S=S, tau=3)
        torch.cuda.synchronize()
        want = ref.sparse_verify_arena_packed_ref(db, q, plane, idx, live,
                                                  b, S, 3)
        assert torch.equal(got[0], want[0].to(torch.int32))
        assert torch.equal(got[1], want[1])

    @pytest.mark.parametrize("b,L", PLANE_BL)
    @pytest.mark.parametrize("n,m,T", SHAPES)
    def test_plane(self, cuda_device, b, L, n, m, T):
        rng = np.random.default_rng(n + m + b + L)
        db, q = plane_inputs(rng, n, m, b, L)
        plane, idx, live = (torch.from_numpy(x).to(cuda_device)
                            for x in lanes(rng, n, m, T, 4))
        db, q = tw(db, cuda_device), tw(q, cuda_device)
        ops.reset_kernel_stats()
        got = ops.sparse_verify_arena(db, q, plane, idx, live, tau=4)
        torch.cuda.synchronize()
        assert ops.kernel_stats() == {"sparse_verify_arena": 1}
        want = ref.sparse_verify_arena_ref(db, q, plane, idx, live, 4)
        assert torch.equal(got[0], want[0].to(torch.int32))
        assert torch.equal(got[1], want[1])

    @pytest.mark.parametrize("kind", ["packed", "plane"])
    @pytest.mark.parametrize("T", [7, 3_000_000, (1 << 22) + 3])
    @pytest.mark.parametrize("m", [1, 63, 64, 65])
    def test_slab_passes(self, cuda_device, kind, T, m):
        """Both arena verifies at each slab width the launch picks from T
        (16, 8 and 4 queries a pass: 5, 9 and 17 passes at m = 65), m
        one short of, at and past 64, escape-coded bases, dead lanes and
        base_idx at 0 and T - 1; four columns a thread (n % 4 = 0) and
        one (n odd); the plane columns with W = 2."""
        gen = torch.Generator(device=cuda_device).manual_seed(T + m)
        dev = cuda_device
        plane = torch.randint(0, 14, (m, T), dtype=torch.int32, device=dev,
                              generator=gen)
        plane[torch.rand((m, T), device=dev, generator=gen) < 0.3] = BIG
        odd = torch.rand((m, T), device=dev, generator=gen) < 0.05
        vals = torch.tensor([-3, 14, 15, 40, BIG - 1, BIG + 1, 2 ** 31 - 1],
                            dtype=torch.int32, device=dev)
        plane[odd] = vals[torch.randint(0, len(vals), (int(odd.sum()),),
                                        device=dev, generator=gen)]
        plane[:, T - 1] = 2
        for n in (1 << 17, 100_003):
            idx = torch.randint(0, T, (n,), dtype=torch.int32, device=dev,
                                generator=gen)
            idx[::7] = T - 1
            idx[3::7] = 0
            live = torch.rand(n, device=dev, generator=gen) >= 0.1
            words = (lambda *shape: torch.randint(
                -2 ** 31, 2 ** 31, shape, dtype=torch.int32, device=dev,
                generator=gen))
            ops.reset_kernel_stats()
            if kind == "packed":
                db, q = words(n), words(m)
                got = ops.sparse_verify_arena_packed(db, q, plane, idx, live,
                                                     b=2, S=4, tau=16)
                want = ref.sparse_verify_arena_packed_ref(
                    db, q, plane, idx, live, 2, 4, 16)
            else:
                db, q = words(2, 2, n), words(2, 2, m)
                db[..., ::5] = q[..., :1]
                got = ops.sparse_verify_arena(db, q, plane, idx, live,
                                              tau=16)
                want = ref.sparse_verify_arena_ref(db, q, plane, idx, live,
                                                   16)
            torch.cuda.synchronize()
            assert ops.kernel_stats() == {
                "sparse_verify_arena_packed" if kind == "packed"
                else "sparse_verify_arena": 1}
            assert torch.equal(got[0], want[0].to(torch.int32))
            assert torch.equal(got[1], want[1])
        assert ops._slab_queries(T) == {7: 16, 3_000_000: 8}.get(T, 4)

    @pytest.mark.parametrize("density", [0.0, "one", 0.01, 1.0])
    @pytest.mark.parametrize("Wp", [1, 8, 33])
    @pytest.mark.parametrize("n", [1 << 17, 100_003])
    def test_rerank_densities(self, cuda_device, density, Wp, n):
        """The re-rank's lazy payloads at survivor densities of 0, one
        lane, 1% and 100%, with payload words in registers (Wp 1, 8) and
        past them (33), four columns a thread and one (n odd)."""
        rng = np.random.default_rng(Wp + n)
        m = 64
        pay, q, _ = rerank_inputs(rng, n, m, Wp)
        pay, q = tw(pay, cuda_device), tw(q, cuda_device)
        if density == "one":
            surv = torch.zeros((m, n), dtype=torch.int32, device=cuda_device)
            surv[m // 2, n - 1] = 1
        else:
            surv = (torch.rand((m, n), device=cuda_device) < density).to(
                torch.int32)
        for metric in METRICS:
            ops.reset_kernel_stats()
            got = ops.exact_rerank(pay, q, surv, metric=metric)
            torch.cuda.synchronize()
            assert ops.kernel_stats() == {"exact_rerank": 1}
            want = ref.exact_rerank_ref(pay, q, surv, metric)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))

    @pytest.mark.parametrize("m", [1, 63, 64, 65])
    @pytest.mark.parametrize("n", [4096, 4097])
    def test_rerank_misaligned_view(self, cuda_device, m, n):
        """A contiguous view whose pointer is 4 bytes past a 16-byte
        boundary (pay[:, 1:] with Wp = 1) takes one column a thread, for
        n % 4 of 0 and 1, at m one short of, at and past 64."""
        rng = np.random.default_rng(m + n)
        pay, q, surv = rerank_inputs(rng, n + 1, m, 1)
        pay = tw(pay, cuda_device)[:, 1:]
        q = tw(q, cuda_device)
        surv = torch.from_numpy(surv[:, 1:].copy()).to(cuda_device)
        assert pay.is_contiguous() and pay.data_ptr() % 16 == 4
        for metric in METRICS:
            got = ops.exact_rerank(pay, q, surv, metric=metric)
            want = ref.exact_rerank_ref(pay, q, surv, metric)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))

    @pytest.mark.parametrize("metric", METRICS)
    @pytest.mark.parametrize("Wp", [1, 8, 33])
    @pytest.mark.parametrize("n,m", [(1, 1), (130, 3), (100_003, 33)])
    def test_rerank(self, cuda_device, metric, Wp, n, m):
        rng = np.random.default_rng(n + m + Wp)
        pay, q, surv = rerank_inputs(rng, n, m, Wp, empty=n > 1)
        pay, q = tw(pay, cuda_device), tw(q, cuda_device)
        surv = torch.from_numpy(surv).to(cuda_device)
        ops.reset_kernel_stats()
        got = ops.exact_rerank(pay, q, surv, metric=metric)
        torch.cuda.synchronize()
        assert ops.kernel_stats() == {"exact_rerank": 1}
        want = ref.exact_rerank_ref(pay, q, surv, metric)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
