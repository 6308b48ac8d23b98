"""Mixture-of-Experts block: shared + routed experts, top-k routing with
capacity-based dispatch — the port of the JAX package's ``models/moe.py``.

Dispatch is *grouped*: the token axis is reshaped to (G, T/G); routing,
the position-in-expert cumsum and the capacity drops are computed per
group.  Under a data-parallel mesh (``mesh=``, each rank holding its
rows of the batch) one group spans the global batch, as the reference's
global arrays do: the ranks exchange their per-expert (E,) counts, so
capacity and positions are the global batch's and the kept (token,
slot) pairs those of one rank holding every row.  Expert parallelism
over a "model" axis is ``moe_sharded.py``'s.

The decisions are the reference's, bit for bit where they are integers:

  * the router runs in float32 whatever the compute dtype (its weights
    may arrive bf16-rounded from ``cast_for_compute``, as in the JAX
    package; the product is float32);
  * the top-k keeps ``lax.top_k``'s order — descending gate, the lower
    expert first on a tie — through a stable descending sort
    (``torch.topk`` promises no order among ties);
  * the position-in-expert cumsum runs over the flattened (token, slot)
    order, so the same (token, slot) pairs are dropped; dropped pairs
    write the scratch row ``cap`` of the dispatch buffer, which is
    sliced off (duplicate writes land only there).

The expert products are plain ``einsum``s (batched matmuls), as they are
XLA's outside any Pallas kernel in the JAX package.

Weights: routed ``w_*`` are stacked (E, d, ff); shared experts are a plain
fused MLP of width ``n_shared * moe_d_ff``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..distributed.sharding import batch_coord, dp_shards
from .layers import act_fn, scaled_normal


def moe_init(gen, d_model: int, n_experts: int, moe_d_ff: int,
             n_shared: int, dtype) -> dict:
    """The block's parameters drawn from ``gen`` (on its device; the
    ``meta`` device, undrawn, when ``gen`` is None) with the JAX
    package's shapes and scales; the router is float32 always."""
    s_in = 1.0 / np.sqrt(d_model)
    s_out = 1.0 / np.sqrt(moe_d_ff)
    E = n_experts
    params = {
        "router": scaled_normal(gen, s_in, torch.float32, d_model, E),
        "w_gate": scaled_normal(gen, s_in, dtype, E, d_model, moe_d_ff),
        "w_up": scaled_normal(gen, s_in, dtype, E, d_model, moe_d_ff),
        "w_down": scaled_normal(gen, s_out, dtype, E, moe_d_ff, d_model),
    }
    if n_shared:
        ff_sh = n_shared * moe_d_ff
        params["shared"] = {
            "w_gate": scaled_normal(gen, s_in, dtype, d_model, ff_sh),
            "w_up": scaled_normal(gen, s_in, dtype, d_model, ff_sh),
            "w_down": scaled_normal(gen, s_out, dtype, ff_sh, d_model),
        }
    return params


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: values descending, the lower
    index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(router_w: torch.Tensor, x: torch.Tensor, top_k: int):
    """x: (..., d) -> gates (..., k) f32 (normalized over top-k), idx
    (..., k) int64."""
    logits = x.to(torch.float32) @ router_w.to(torch.float32)   # (..., E)
    gate_all = torch.softmax(logits, dim=-1)
    gates, idx = _top_k(gate_all, top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx


def _shared_mlp(sh, x: torch.Tensor, act: str) -> torch.Tensor:
    hs = act_fn(act)(x @ sh["w_gate"]) * (x @ sh["w_up"])
    return hs @ sh["w_down"]


def _capacity(tokens: int, top_k: int, n_experts: int,
              capacity_factor: float) -> int:
    return max(int(np.ceil(tokens * top_k / n_experts * capacity_factor)),
               top_k)


def _capacity_plan(idx: torch.Tensor, n_experts: int,
                   capacity_factor: float, *, mesh=None):
    """The capacity plan of ``moe_apply`` for routings ``idx`` (G, tg, k):
    (keep mask (G, tg, k) bool, position in expert (G, tg, k), cap).

    The position of a (token, slot) pair in its expert is a running count
    over the flattened (token, slot) order, as in the reference; the scan
    runs along the innermost axis of an (G, E, tg·k) one-hot (along an
    outer axis of the narrow (G, tg·k, E) one it took ≈ 49 ms a layer on
    the H100 at granite's 16,000 tokens).

    With ``mesh`` (one group, G = 1, spanning the batch axes' ranks in
    their order) the cap is the global batch's and a pair is kept where
    its position plus the pairs of earlier ranks in its expert is below
    it; the returned positions stay this rank's own, below the cap."""
    G, tg, k = idx.shape
    flat = idx.reshape(G, tg * k)
    onehot = F.one_hot(flat, n_experts).transpose(1, 2).contiguous()
    pos = torch.cumsum(onehot, dim=-1) - 1                 # (G, E, tg*k)
    pos_own = torch.gather(pos, 1, flat[:, None, :])[:, 0].reshape(G, tg, k)
    if mesh is None:
        cap = _capacity(tg, k, n_experts, capacity_factor)
        return pos_own < cap, pos_own, cap
    if G != 1:
        raise ValueError(f"a global capacity plan is one group, not {G}")
    # this rank's pairs in each expert, and its tokens: (E + 1,) int64
    counts = torch.cat([pos[0, :, -1] + 1, pos.new_tensor([tg])])
    for axis in ("data", "pod"):       # (ranks, E + 1), pod-major order
        if axis in mesh.axis_names:
            counts = mesh.all_gather(counts.reshape(-1, n_experts + 1),
                                     axis, dim=0)
    counts = counts.reshape(dp_shards(mesh), n_experts + 1)
    cap = _capacity(int(counts[:, -1].sum()), k, n_experts, capacity_factor)
    before = counts[:batch_coord(mesh), :n_experts].sum(0)  # (E,)
    return pos_own + before[idx] < cap, pos_own, cap


def moe_apply(params, x: torch.Tensor, *, top_k: int, act: str,
              num_groups: int = 1, capacity_factor: float = 1.25,
              mesh=None) -> torch.Tensor:
    """Capacity-based top-k MoE.  x: (B, S, d) -> (B, S, d).

    ``num_groups`` must divide B·S; each group routes and drops on its
    own tokens.  With a data-parallel ``mesh`` (x this rank's rows, the
    weights whole) one group spans the global batch (module doc)."""
    B, S, d = x.shape
    E = params["router"].shape[-1]
    T = B * S
    if T % num_groups:
        raise ValueError(f"{num_groups} groups do not divide {T} tokens")
    G, tg = num_groups, T // num_groups
    xg = x.reshape(G, tg, d)

    gates, idx = _route(params["router"], xg, top_k)      # (G, tg, k)
    keep, pos_own, cap = _capacity_plan(idx, E, capacity_factor, mesh=mesh)

    # dispatch into (G, E, cap+1, d); row ``cap`` is the scratch row of
    # the capacity-dropped pairs
    pos_clip = torch.where(keep, pos_own, cap)
    g_idx = torch.arange(G, device=x.device)[:, None, None]
    buf = torch.zeros((G, E, cap + 1, d), dtype=x.dtype, device=x.device)
    buf[g_idx, idx, pos_clip] = xg[:, :, None, :].expand(G, tg, top_k, d)
    buf = buf[:, :, :cap]

    h = torch.einsum("gecd,edf->gecf", buf, params["w_gate"])
    u = torch.einsum("gecd,edf->gecf", buf, params["w_up"])
    h = act_fn(act)(h) * u
    out = torch.einsum("gecf,efd->gecd", h, params["w_down"])
    out = torch.cat([out, out.new_zeros((G, E, 1, d))], dim=2)

    # combine with the gates in token order
    picked = out[g_idx, idx, pos_clip]                     # (G, tg, k, d)
    w = (gates * keep).to(x.dtype)
    y = (picked * w[..., None]).sum(dim=2).reshape(B, S, d)

    if "shared" in params:
        y = y + _shared_mlp(params["shared"], x, act)
    return y


def moe_apply_dense(params, x: torch.Tensor, *, top_k: int,
                    act: str) -> torch.Tensor:
    """Dense all-experts reference (oracle for the dispatch path): every
    expert runs on every token; outputs combined by top-k gates."""
    gates, idx = _route(params["router"], x, top_k)       # (B, S, k)
    h = torch.einsum("bsd,edf->besf", x, params["w_gate"])
    u = torch.einsum("bsd,edf->besf", x, params["w_up"])
    h = act_fn(act)(h) * u
    out = torch.einsum("besf,efd->besd", h, params["w_down"])  # (B, E, S, d)
    comb = torch.zeros(x.shape[:2] + (out.shape[1],), dtype=torch.float32,
                       device=x.device).scatter_(-1, idx, gates)
    y = torch.einsum("bse,besd->bsd", comb.to(x.dtype), out)
    if "shared" in params:
        y = y + _shared_mlp(params["shared"], x, act)
    return y


def aux_load_balance_loss(params, x: torch.Tensor, *,
                          top_k: int) -> torch.Tensor:
    """Switch-style load-balance auxiliary: E * sum_e f_e * p_e."""
    logits = x.to(torch.float32) @ params["router"].to(torch.float32)
    E = logits.shape[-1]
    p = torch.softmax(logits, dim=-1)                      # (B, S, E)
    _, idx = _top_k(p, top_k)
    f = F.one_hot(idx, E).to(torch.float32).sum(dim=-2)    # (B, S, E)
    return E * torch.mean(f.mean(dim=(0, 1)) * p.mean(dim=(0, 1)))
