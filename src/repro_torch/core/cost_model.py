"""Query cost model (paper Appendix A, Eq. 2-4).

A copy of ``repro.core.cost_model`` (pure Python), kept in this package
so that ``repro_torch`` imports nothing of ``repro``.  The searcher
derives its frontier capacities from ``sigs`` (the level-ℓ frontier is a
subset of both the t_ℓ trie nodes and the sigs(b, ℓ, τ) strings within
distance τ) and seeds the top-k τ-ladder with ``tau_for_k``; the
multi-index planner of later slices uses ``cost_multi``.
"""

from __future__ import annotations

import math
from typing import List, Tuple

_CAP = float(2**62)


def sigs(b: int, L: int, tau: int) -> float:
    """Number of signatures |{q' : ham(q, q') <= tau}| (Eq. 3); float with
    saturation (the exact value overflows int64 for large b, L, τ)."""
    total = 0.0
    for k in range(min(tau, L) + 1):
        total += math.comb(L, k) * float((1 << b) - 1) ** k
        if total > _CAP:
            return _CAP
    return total


def tau_for_k(b: int, L: int, n: float, k: int) -> int:
    """Smallest τ whose expected candidate count over a uniform DB of n
    sketches reaches k: |I(τ)| ≈ n·sigs(b, L, τ)/(2^b)^L (Appendix A).
    Seeds the τ-escalation ladders of ``search.topk*`` and the dynamic
    segmented index — one estimator, every ladder."""
    denom = float(1 << b) ** min(L, 64)
    n = max(float(n), 1.0)
    for tau in range(L + 1):
        if sigs(b, L, tau) * n / denom >= k:
            return tau
    return L


def cost_single(b: int, L: int, tau: int, n: float) -> float:
    """cost_S = sigs(b,L,τ)·L + |I|  (Eq. 2), with |I| estimated under the
    uniform-distribution assumption of Appendix A."""
    s = sigs(b, L, tau)
    expected_I = min(s * n / float(1 << b) ** min(L, 64), n)
    return s * L + expected_I


def _block_lengths(L: int, m: int) -> List[int]:
    base = L // m
    rem = L - base * m
    return [base + 1] * rem + [base] * (m - rem)


def block_thresholds(tau: int, m: int, mih_style: bool = False) -> List[int]:
    """Pigeonhole thresholds.  Traditional rule: τ^j = ⌊τ/m⌋ (no false
    negatives).  MIH rule: the first τ − m·⌊τ/m⌋ + 1 blocks get ⌊τ/m⌋ − 1
    [Norouzi et al.], valid because a candidate must beat the *strict*
    bound in at least one block."""
    base = tau // m
    if not mih_style:
        return [base] * m
    k = tau - m * base + 1
    out = [max(base - 1, 0)] * k + [base] * (m - k)
    return out


def cost_multi(b: int, L: int, tau: int, n: float, m: int,
               mih_style: bool = False) -> float:
    """cost_M (Eq. 4): filtering + verification, uniform-DB candidate
    estimate |C^j| = sigs(b, L^j, τ^j)·n/(2^b)^{L^j}."""
    lens = _block_lengths(L, m)
    taus = block_thresholds(tau, m, mih_style)
    total = 0.0
    for Lj, tj in zip(lens, taus):
        s = sigs(b, Lj, tj)
        cand = min(s * n / float(1 << b) ** Lj, n)
        total += s * Lj + L * cand
    return total


def frontier_capacities(t: Tuple[int, ...], b: int, tau: int,
                        cap_max: int = 1 << 17) -> Tuple[int, ...]:
    """Static frontier capacity per level: min(t_ℓ, sigs(b, ℓ, τ), cap_max).
    ``cap_max`` bounds memory; the searcher detects overflow and the host
    wrapper retries on the next rung of the ladder."""
    caps = []
    for lev in range(len(t)):
        s = sigs(b, lev, tau)
        caps.append(int(min(float(t[lev]), s, float(cap_max))))
    return tuple(max(c, 1) for c in caps)
