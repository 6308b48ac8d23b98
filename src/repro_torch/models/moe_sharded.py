"""Expert-parallel MoE on the rank's own shards — the port of the JAX
package's ``models/moe_sharded.py`` (its ``shard_map`` body, written out
for one rank of a ``launch.mesh.Mesh``).

  * activations are REPLICATED over the "model" axis and split over
    (pod, data): every model rank holds all tokens of its data shard;
  * each model rank owns E/m contiguous experts (weights split over
    "model" on E, FSDP over "data" on d — gathered here, whose transpose
    is the reduce-scatter of their gradients);
  * dispatch = LOCAL scatter of the rank's own tokens to its own
    experts; capacity comes from the rank's LOCAL token count, as in the
    reference's body;
  * the shared experts' ``ff`` is split over "model", each rank adding
    its slice's partial product;
  * combine = local gather + gate-weighted sum, then ONE all-reduce (sum)
    over "model".

Numerically the reference's (same routing, same capacity-drop policy),
asserted in tests/test_torch_moe_sharded.py.  Differentiable: the input
and the gathered router enter the model-parallel region through an
identity whose backward sums over "model", the output leaves it through
an all-reduce whose backward is the identity (the Megatron pair,
``distributed.sharding``'s, which the dense layers share), and an FSDP
gather's backward sums the gradient over "data" and keeps the rank's
slice — so each rank's gradients are its slices of the global
function's.

``shard_moe_params`` cuts a rank's shards from whole weights by
``MOE_SPECS`` (the reference body's ``in_specs``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.sharding import (_FromModel, _GatherData, _ToModel,
                                     leaf_logical, local_shard)
from . import moe
from .layers import act_fn

# the reference body's in_specs, per leaf of the MoE block: the router
# (d, E) and the experts (E, d, ff) / (E, ff, d) as the parameter rules
# place a unit's MoE leaves; the shared experts (d, ff_sh) / (ff_sh, d)
# as the body's own in_specs, which differ from the rules' (those give a
# shared leaf, stacked, the experts' rule)
MOE_SPECS = {
    **{leaf: leaf_logical(f"units.0.l0.moe.{leaf}", ndim)
       for leaf, ndim in (("router", 2), ("w_gate", 3), ("w_up", 3),
                          ("w_down", 3))},
    "shared.w_gate": ("data", "model"),
    "shared.w_up": ("data", "model"),
    "shared.w_down": ("model", "data"),
}


def shard_moe_params(params: dict, mesh, copy: bool = True) -> dict:
    """This rank's shards of a MoE block (nested dict or ``Params``),
    each a contiguous copy (a view with ``copy=False``), keyed as the
    block is."""
    out = {}
    for name, spec in MOE_SPECS.items():
        head, _, leaf = name.rpartition(".")
        if head and head not in params:
            continue
        src = params[head] if head else params
        dst = out.setdefault(head, {}) if head else out
        dst[leaf] = local_shard(src[leaf], spec, mesh)
        if copy:
            dst[leaf] = dst[leaf].clone(memory_format=torch.contiguous_format)
    return out


def _gather(w, mesh, dim):
    if mesh.shape.get("data", 1) == 1:
        return w
    return _GatherData.apply(w, mesh, dim)


def _local_plan(idx: torch.Tensor, lo: int, e_loc: int, cap: int):
    """The capacity plan of the rank's experts [lo, lo + e_loc) for the
    routings ``idx`` (t, k): (keep (t·k,) bool, the expert's local index
    (t·k,), position in it (t·k,)).  A pair routed elsewhere is not
    kept; positions count the rank's pairs in (token, slot) order, the
    cumsum along the inner axis of an (e_loc, t·k) one-hot (moe.py's
    ``_capacity_plan`` says why)."""
    rel = (idx - lo).reshape(-1)
    sel = (rel >= 0) & (rel < e_loc)
    rel_c = rel.clamp(0, e_loc - 1)
    onehot = (F.one_hot(rel_c, e_loc) * sel[:, None]).T.contiguous()
    pos = torch.cumsum(onehot, dim=-1) - 1                 # (e_loc, t*k)
    pos_own = torch.gather(pos, 0, rel_c[None, :])[0]
    return sel & (pos_own < cap), rel_c, pos_own


def moe_apply_sharded(params, x: torch.Tensor, mesh, *, top_k: int,
                      act: str, capacity_factor: float = 1.25
                      ) -> torch.Tensor:
    """x: (B_loc, S, d), this rank's rows -> (B_loc, S, d) under explicit
    expert parallelism; ``params`` hold this rank's shards
    (``shard_moe_params``)."""
    E = params["router"].shape[-1]
    m_size = mesh.shape["model"]
    e_loc = params["w_gate"].shape[0]
    if e_loc * m_size != E:
        raise ValueError(f"{e_loc} local experts on {m_size} model ranks, "
                         f"the router has {E}: pass the rank's shards")
    router_full = _gather(params["router"], mesh, 0)
    if m_size > 1:          # every model rank routes: its gradient is a sum
        router_full = _ToModel.apply(mesh, router_full)
    wg = _gather(params["w_gate"], mesh, 1)
    wu = _gather(params["w_up"], mesh, 1)
    wd = _gather(params["w_down"], mesh, 2)

    b_loc, s, d = x.shape
    t = b_loc * s
    x = _ToModel.apply(mesh, x) if m_size > 1 else x
    xt = x.reshape(t, d)
    gates, idx = moe._route(router_full, xt, top_k)       # (t, k)

    cap = moe._capacity(t, top_k, E, capacity_factor)
    keep, rel_c, pos_own = _local_plan(idx, mesh.coord("model") * e_loc,
                                       e_loc, cap)
    dest = torch.where(keep, rel_c * cap + pos_own, e_loc * cap)
    src = xt[:, None, :].expand(t, top_k, d).reshape(-1, d)
    buf = torch.zeros((e_loc * cap + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((dest,), src)       # duplicates only at the scratch
    be = buf[:-1].reshape(e_loc, cap, d)

    h = torch.einsum("ecd,edf->ecf", be, wg)
    u = torch.einsum("ecd,edf->ecf", be, wu)
    h = act_fn(act)(h) * u
    o = torch.einsum("ecf,efd->ecd", h, wd).reshape(e_loc * cap, d)
    o = torch.cat([o, o.new_zeros((1, d))], dim=0)

    picked = o[dest]                                      # (t*k, d)
    w = (gates.reshape(-1) * keep).to(x.dtype)
    y = (picked * w[:, None]).reshape(t, top_k, d).sum(dim=1)

    if "shared" in params:
        sh = params["shared"]
        sg, su = _gather(sh["w_gate"], mesh, 0), _gather(sh["w_up"], mesh, 0)
        sd = _gather(sh["w_down"], mesh, 1)
        hs = act_fn(act)(xt @ sg) * (xt @ su)
        y = y + hs @ sd                                   # partial over ff
    if m_size > 1:
        y = _FromModel.apply(y, mesh)
    return y.reshape(b_loc, s, d)
