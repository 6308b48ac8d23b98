"""Mamba2 SSD (state-space duality) block, chunked parallel scan form —
the port of the JAX package's ``models/ssm.py``.

The sequence is split into chunks; within a chunk the recurrence is a
masked, decay-weighted attention-like product; across chunks a small
(c+1 x c+1) decay matrix propagates the states [Dao & Gu,
arXiv:2405.21060].  As in the JAX package the z / x / B / C / dt streams
have projections and depthwise convolutions of their own.

The reference writes the chunk products as four-operand ``einsum``s.
Here each is a staged contraction, two operands at a time, in an order
whose intermediates are no larger than the (B, H, c, l, l) decay matrix
itself: contracted the wrong way round, the intra-chunk product alone
would build a (B, H, c, l, l, P) tensor (about 68 GB for mamba2-1.3b at
8 x 2,048 tokens).  The products are plain ``torch`` matmuls, as they
are XLA's outside any Pallas kernel in the JAX package.

Decode is the O(1) recurrent step on a (B, H, P, N) float32 state plus
rolling depthwise-conv windows in the cache dtype.

Tensor parallelism (``mesh=``, a mesh whose "model" axis of m ranks
divides the H SSM heads; ``models/model.py`` passes it): the block runs
on the rank's H / m heads, as GSPMD runs the JAX package's block from
its placement (``wz``, ``wx`` and ``conv_x`` over d_inner, ``out_proj``
row-split, JAX ``ssm.py:176``'s ``constrain`` on the x stream).  The
replicated input enters the region through ``_ToModel``; ``wz``, ``wx``,
``conv_x`` and ``out_proj`` arrive as the rank's d_inner slices; ``wB``,
``wC``, ``conv_B``, ``conv_C`` and their biases stay whole on every rank
(the B and C streams are computed whole), ``wdt``, ``A_log``, ``D``,
``dt_bias``, ``conv_bx`` and ``norm`` are whole leaves cut to the rank's
heads or channels — all of these enter the region through ``_ToModel``,
so each gradient sums the ranks' shares.  The gated RMSNorm over d_inner
sums its squares over "model" before it scales, and the output
projection's partial product is summed over "model" (``_FromModel``).
Under tensor parallelism an ``SSMCache`` holds the rank's d_inner
channels of ``conv_x`` and its heads of ``state``; ``conv_B`` and
``conv_C`` stay whole, as the port computes those streams whole — where
the JAX package's ``cache_specs`` would split them over "model" too
(the same values, another placement).  A "model" axis that does not
divide the heads leaves the block whole (``model._ssm_block``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.hamming import resolve_device
from ..distributed.sharding import (from_model, model_ranks, model_slice,
                                    to_model)
from .layers import rms_norm, scaled_normal


class SSMConfig(NamedTuple):
    d_model: int
    d_inner: int
    d_state: int
    head_dim: int
    d_conv: int
    chunk: int

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def ssm_init(gen, cfg: SSMConfig, dtype) -> dict:
    """The block's parameters drawn from ``gen`` (on its device; the
    ``meta`` device, undrawn, when ``gen`` is None) with the JAX
    package's shapes, scales and fixed initial values: A in [1, 16),
    the dt bias the inverse softplus of a log-uniform dt in [1e-3, 0.1),
    identity conv taps."""
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads
    K = cfg.d_conv
    s_in = 1.0 / np.sqrt(d)
    s_out = 1.0 / np.sqrt(di)
    dev = gen.device if gen is not None else torch.device("meta")

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand((H,), generator=gen, device=dev)

    if gen is None:         # shapes only: no arithmetic on ``meta``
        a_log, dt_bias, skip = (torch.empty((H,), device=dev)
                                for _ in range(3))
    else:
        a_log = torch.log(uniform(1.0, 16.0))
        dt = torch.exp(uniform(np.log(1e-3), np.log(0.1)))
        dt_bias = dt + torch.log(-torch.expm1(-dt))      # inverse softplus
        skip = torch.ones((H,), device=dev)

    def taps(width):
        w = torch.zeros((K, width), dtype=dtype, device=dev)
        w[-1] = 1.0
        return w

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    return {
        "wz": scaled_normal(gen, s_in, dtype, d, di),
        "wx": scaled_normal(gen, s_in, dtype, d, di),
        "wB": scaled_normal(gen, s_in, dtype, d, N),
        "wC": scaled_normal(gen, s_in, dtype, d, N),
        "wdt": scaled_normal(gen, s_in, dtype, d, H),
        "out_proj": scaled_normal(gen, s_out, dtype, di, d),
        "conv_x": taps(di),
        "conv_bx": zeros(di),
        "conv_B": taps(N),
        "conv_bB": zeros(N),
        "conv_C": taps(N),
        "conv_bC": zeros(N),
        "A_log": a_log,
        "D": skip,
        "dt_bias": dt_bias,
        "norm": zeros(di),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., l) -> (..., l, l); out[i, j] = sum_{k in (j, i]} x[k],
    -inf above the diagonal (diagonal itself is 0)."""
    l = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    return torch.where(mask, seg, -torch.inf)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d.  x: (B, T, C); w: (K, C).
    ``state``: (B, K-1, C) left context (decode); returns (y, new_state).
    The K shifted products are summed in the reference's order."""
    K = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    T = x.shape[1]
    y = 0
    for i in range(K):
        y = y + xp[:, i:i + T] * w[i]
    return y + b, xp[:, -(K - 1):]


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x:  (B, T, H, P) f32 head inputs;  dt: (B, T, H) f32 (post-softplus);
    A:  (H,) f32 negative decay rates;  Bm, Cm: (B, T, N) f32 (ngroups=1).
    Returns (y: (B, T, H, P), final_state: (B, H, P, N)).
    """
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    pad = (-T) % chunk
    if pad:
        # dt = 0 padding is an identity step: decay exp(0·A) = 1 and the
        # injected input dt·B·x = 0, so the final state is unaffected and
        # the padded outputs are sliced off below.
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    c = (T + pad) // chunk

    xd = x * dt[..., None]                                  # dt-scaled input
    dA = dt * A[None, None, :]                              # (B, T, H)

    # chunked views
    xc = xd.reshape(Bsz, c, chunk, H, P)
    Bc = Bm.reshape(Bsz, c, chunk, N)
    Cc = Cm.reshape(Bsz, c, chunk, N)
    dAc = dA.reshape(Bsz, c, chunk, H).permute(0, 3, 1, 2)  # (B, H, c, l)
    dA_cs = torch.cumsum(dAc, dim=-1)                       # (B, H, c, l)

    # 1. intra-chunk (diagonal blocks): "bcln,bcsn,bhcls,bcshp->bclhp"
    #    as (C·Bᵀ) ∘ L, then that (B, H, c, l, s) matrix times x
    L = torch.exp(_segsum(dAc))                             # (B, H, c, l, l)
    CB = torch.einsum("bcln,bcsn->bcls", Cc, Bc)            # (B, c, l, s)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", L * CB[:, None], xc)
    del L

    # 2. per-chunk end states: "bcln,bhcl,bclhp->bchpn"
    decay_states = torch.exp(dA_cs[..., -1:] - dA_cs)       # (B, H, c, l)
    xw = xc * decay_states.permute(0, 2, 3, 1)[..., None]   # (B, c, l, H, P)
    states = torch.einsum("bclhp,bcln->bchpn", xw, Bc)

    # 3. inter-chunk recurrence on the (c+1)-long chunk-state chain
    if init_state is None:
        init_state = torch.zeros((Bsz, H, P, N), dtype=x.dtype,
                                 device=x.device)
    states = torch.cat([init_state[:, None], states], dim=1)  # (B, c+1, H, P, N)
    chain = F.pad(dA_cs[..., -1], (1, 0))                     # (B, H, c+1)
    decay_chunk = torch.exp(_segsum(chain))                   # (B, H, c+1, c+1)
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    prev_states, final_state = new_states[:, :-1], new_states[:, -1]

    # 4. state -> output contribution: "bcln,bchpn,bhcl->bclhp"
    state_decay = torch.exp(dA_cs).permute(0, 2, 3, 1)        # (B, c, l, H)
    y_off = (torch.einsum("bcln,bchpn->bclhp", Cc, prev_states)
             * state_decay[..., None])

    y = (y_diag + y_off).reshape(Bsz, T + pad, H, P)
    return y[:, :T], final_state


_WHOLE = ("wB", "wC", "wdt", "conv_B", "conv_bB", "conv_C", "conv_bC",
          "conv_bx", "A_log", "D", "dt_bias", "norm")


def _rank_leaves(params, cfg: SSMConfig, mesh):
    """The block's leaves as this model rank computes with them (module
    doc); ``params`` themselves with no ``mesh``."""
    if mesh is None:
        return params
    h0, h1 = model_slice(cfg.n_heads, mesh)
    c0, c1 = h0 * cfg.head_dim, h1 * cfg.head_dim
    p = dict(zip(_WHOLE, to_model(mesh, *(params[n] for n in _WHOLE))))
    p.update({n: params[n] for n in ("wz", "wx", "conv_x", "out_proj")})
    p["wdt"] = p["wdt"][:, h0:h1]
    for n in ("A_log", "D", "dt_bias"):
        p[n] = p[n][h0:h1]
    for n in ("conv_bx", "norm"):
        p[n] = p[n][c0:c1]
    return p


def _gated_norm(y: torch.Tensor, scale: torch.Tensor, eps: float,
                d_inner: int, mesh) -> torch.Tensor:
    """``rms_norm`` over d_inner; under tensor parallelism the mean of
    squares is the sum over "model" of the ranks' sums (a sum whose
    backward sums too: every rank's share of the gradient reaches every
    rank's slice)."""
    if mesh is None:
        return rms_norm(y, scale, eps)
    dtype = y.dtype
    y = y.to(torch.float32)
    ss = to_model(mesh, from_model(torch.sum(y * y, dim=-1, keepdim=True),
                                   mesh))
    out = y * torch.rsqrt(ss / d_inner + eps) * (1.0 + scale.to(
        torch.float32))
    return out.to(dtype)


def _streams(params, x: torch.Tensor, conv_state: Optional[Tuple] = None):
    """Project + causal-conv + silu the x/B/C streams; project z and dt.
    Returns (z, xs, Bm, Cm, dt_raw, new_conv_state)."""
    z = x @ params["wz"]
    xs = x @ params["wx"]
    Bm = x @ params["wB"]
    Cm = x @ params["wC"]
    dt_raw = x @ params["wdt"]
    cs = conv_state or (None, None, None)
    xs, c_x = _causal_conv(xs, params["conv_x"], params["conv_bx"], cs[0])
    Bm, c_B = _causal_conv(Bm, params["conv_B"], params["conv_bB"], cs[1])
    Cm, c_C = _causal_conv(Cm, params["conv_C"], params["conv_bC"], cs[2])
    return z, F.silu(xs), F.silu(Bm), F.silu(Cm), dt_raw, (c_x, c_B, c_C)


def ssm_apply(params, x: torch.Tensor, cfg: SSMConfig, *,
              norm_eps: float = 1e-6,
              init_state: Optional[torch.Tensor] = None,
              return_state: bool = False, mesh=None):
    """Full Mamba2 block (train/prefill).  x: (B, T, d_model); under
    ``mesh`` (module doc) the rank's heads, the output summed over
    "model" and the state the rank's heads'."""
    Bsz, T, _ = x.shape
    P = cfg.head_dim
    params = _rank_leaves(params, cfg, mesh)
    x = to_model(mesh, x)
    H = params["A_log"].shape[0]
    z, xs, Bm, Cm, dt_raw, _ = _streams(params, x)

    dt = F.softplus(dt_raw.to(torch.float32) + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    xh = xs.reshape(Bsz, T, H, P).to(torch.float32)
    y, final_state = ssd_chunked(xh, dt, A, Bm.to(torch.float32),
                                 Cm.to(torch.float32), cfg.chunk,
                                 init_state=init_state)
    y = y + params["D"][None, None, :, None] * xh
    y = y.reshape(Bsz, T, H * P).to(x.dtype)

    y = _gated_norm(y * F.silu(z), params["norm"], norm_eps, cfg.d_inner,
                    mesh)
    out = from_model(y @ params["out_proj"], mesh)
    if return_state:
        return out, final_state
    return out


class SSMCache(NamedTuple):
    conv_x: torch.Tensor   # (B, K-1, d_inner)
    conv_B: torch.Tensor   # (B, K-1, N)
    conv_C: torch.Tensor   # (B, K-1, N)
    state: torch.Tensor    # (B, H, P, N) f32


def ssm_cache_init(batch: int, cfg: SSMConfig, dtype=torch.bfloat16, *,
                   device="cuda", mesh=None) -> SSMCache:
    """Empty caches on ``device``: conv windows in ``dtype``, the state in
    float32; under ``mesh`` the rank's heads and channels (module doc)."""
    K = cfg.d_conv
    dev = resolve_device(device)
    H = cfg.n_heads // model_ranks(mesh)

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    return SSMCache(
        conv_x=z(batch, K - 1, H * cfg.head_dim),
        conv_B=z(batch, K - 1, cfg.d_state),
        conv_C=z(batch, K - 1, cfg.d_state),
        state=z(batch, H, cfg.head_dim, cfg.d_state, dt=torch.float32))


def ssm_prefill_cache(params, x_pre: torch.Tensor, state: torch.Tensor,
                      cfg: SSMConfig, dtype=torch.bfloat16, *,
                      mesh=None) -> SSMCache:
    """Cache from a prefill: trailing conv windows of the *pre-conv*
    streams + the final SSD state.  x_pre: (B, T, d_model) block input
    (post-ln); under ``mesh`` the rank's slices (module doc)."""
    params = _rank_leaves(params, cfg, mesh)
    K = cfg.d_conv
    tail = x_pre[:, -(K - 1):]
    pad = (K - 1) - tail.shape[1]
    if pad > 0:
        tail = F.pad(tail, (0, 0, pad, 0))
    return SSMCache(
        conv_x=(tail @ params["wx"]).to(dtype),
        conv_B=(tail @ params["wB"]).to(dtype),
        conv_C=(tail @ params["wC"]).to(dtype),
        state=state)


def ssm_decode_step(params, x: torch.Tensor, cache: SSMCache,
                    cfg: SSMConfig, *, norm_eps: float = 1e-6, mesh=None):
    """One-token recurrent step.  x: (B, 1, d_model) -> (y, new_cache);
    under ``mesh`` on the rank's heads (module doc)."""
    Bsz = x.shape[0]
    P = cfg.head_dim
    params = _rank_leaves(params, cfg, mesh)
    x = to_model(mesh, x)
    H = params["A_log"].shape[0]
    z, xs, Bm, Cm, dt_raw, (c_x, c_B, c_C) = _streams(
        params, x, conv_state=(cache.conv_x, cache.conv_B, cache.conv_C))
    xs, Bm, Cm = xs[:, 0], Bm[:, 0], Cm[:, 0]

    dt = F.softplus(dt_raw[:, 0].to(torch.float32) + params["dt_bias"])  # (B, H)
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt * A[None, :])                          # (B, H)
    xh = xs.reshape(Bsz, H, P).to(torch.float32)
    # "bh,bn,bhp->bhpn"
    dBx = ((dt[:, :, None] * xh)[..., None]
           * Bm.to(torch.float32)[:, None, None, :])
    state = cache.state * dA[..., None, None] + dBx
    y = torch.einsum("bn,bhpn->bhp", Cm.to(torch.float32), state)
    y = y + params["D"][None, :, None] * xh
    y = y.reshape(Bsz, 1, H * P).to(x.dtype)

    y = _gated_norm(y * F.silu(z), params["norm"], norm_eps, cfg.d_inner,
                    mesh)
    out = from_model(y @ params["out_proj"], mesh)
    return out, SSMCache(conv_x=c_x.to(cache.conv_x.dtype),
                         conv_B=c_B.to(cache.conv_B.dtype),
                         conv_C=c_C.to(cache.conv_C.dtype),
                         state=state)
