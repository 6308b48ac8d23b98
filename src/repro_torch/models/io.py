"""Input stand-ins: the shapes and dtypes of every model entry point's
inputs — the port of the JAX package's ``models/io.py``.

``batch_specs_for`` and ``input_specs`` return tensors on the ``meta``
device (the JAX package's ``ShapeDtypeStruct``s: shapes and dtypes, no
memory), global shapes, for the dry-run to read.  ``synthetic_batch``
generates concrete batches for smoke tests and the examples, seeded and
deterministic in (arch, step) with the JAX package's draws — and with
its fault (ROADMAP F10): the seed takes ``hash(cfg.arch_id)``, which
Python salts per process unless ``PYTHONHASHSEED`` is fixed, so a batch
is reproducible within one process, and across processes only when they
share that variable.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.hamming import resolve_device
from .config import ModelConfig, ShapeConfig
from .model import init_cache


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs_for(cfg: ModelConfig, batch: int, seq: int,
                    with_targets: bool) -> Dict[str, torch.Tensor]:
    specs: Dict[str, torch.Tensor] = {}
    if cfg.inputs_embeds:
        specs["embeds"] = _meta((batch, seq, cfg.d_model), torch.float32)
    else:
        specs["tokens"] = _meta((batch, seq), torch.int32)
    if with_targets:
        specs["targets"] = _meta((batch, seq), torch.int32)
    return specs


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                cache_dtype=torch.bfloat16) -> Dict[str, object]:
    """Stand-ins for one (arch x shape) cell, keyed by the step function's
    arguments:  train -> {batch};  prefill -> {batch};
    decode -> {tokens, cache, cache_len}.  Called outside a mesh (the
    caches of ``init_cache`` are global there)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"batch": batch_specs_for(cfg, B, S, with_targets=True)}
    if shape.kind == "prefill":
        return {"batch": batch_specs_for(cfg, B, S, with_targets=False)}
    if shape.kind != "decode":
        raise ValueError(f"unknown shape kind {shape.kind!r}")
    cache = init_cache(cfg, B, S, dtype=cache_dtype, device="meta")
    tok = (_meta((B, 1, cfg.d_model), torch.float32) if cfg.inputs_embeds
           else _meta((B, 1), torch.int32))
    return {"tokens": tok, "cache": cache,
            "cache_len": _meta((), torch.int32)}


def synthetic_batch(cfg: ModelConfig, batch: int, seq: int, step: int,
                    with_targets: bool = True, *,
                    device="cuda") -> Dict[str, torch.Tensor]:
    """Deterministic synthetic batch for (cfg, step) on ``device`` — the
    JAX package's draws (see the module doc for the seed's scope)."""
    dev = resolve_device(device)
    rng = np.random.default_rng((hash(cfg.arch_id) & 0xFFFF, step))
    out: Dict[str, torch.Tensor] = {}

    def t(a, dtype):
        return torch.from_numpy(a).to(device=dev, dtype=dtype)

    if cfg.inputs_embeds:
        out["embeds"] = t(rng.standard_normal((batch, seq, cfg.d_model),
                                              dtype=np.float32),
                          torch.float32)
    else:
        toks = rng.integers(0, cfg.vocab, size=(batch, seq + 1),
                            dtype=np.int64)
        out["tokens"] = t(toks[:, :-1], torch.int32)
        if with_targets:
            out["targets"] = t(toks[:, 1:], torch.int32)
        return out
    if with_targets:
        out["targets"] = t(rng.integers(0, cfg.vocab, size=(batch, seq),
                                        dtype=np.int64), torch.int32)
    return out
