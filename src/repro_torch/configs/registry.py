"""Architecture registry: ``--arch <id>`` resolution, smoke variants,
per-arch valid shape cells, and the paper's own sketch-dataset configs."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from ..models.config import SHAPES, ModelConfig, ShapeConfig
from . import (chameleon_34b, command_r_35b, deepseek_moe_16b, gemma2_27b,
               granite_moe_3b, hubert_xlarge, mamba2_1p3b, smollm_135m,
               yi_9b, zamba2_2p7b)

_MODULES = {
    "gemma2-27b": gemma2_27b,
    "command-r-35b": command_r_35b,
    "smollm-135m": smollm_135m,
    "yi-9b": yi_9b,
    "granite-moe-3b-a800m": granite_moe_3b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "hubert-xlarge": hubert_xlarge,
    "chameleon-34b": chameleon_34b,
    "zamba2-2.7b": zamba2_2p7b,
    "mamba2-1.3b": mamba2_1p3b,
}

ARCH_IDS: Tuple[str, ...] = tuple(_MODULES)


def get_config(arch: str, *, smoke: bool = False,
               pad_for_mesh: bool = False, model_axis: int = 16) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    cfg = _MODULES[arch].SMOKE if smoke else _MODULES[arch].CONFIG
    if pad_for_mesh:
        cfg = cfg.padded(model_axis)
    return cfg


def valid_shapes(arch: str) -> List[str]:
    """The assigned shape grid minus principled skips (DESIGN.md §4):
    encoder-only archs have no decode step; ``long_500k`` requires
    sub-quadratic context (SSM/hybrid only)."""
    cfg = get_config(arch)
    shapes = ["train_4k", "prefill_32k"]
    if cfg.causal and not cfg.inputs_embeds:
        shapes.append("decode_32k")
    if cfg.ssm:
        shapes.append("long_500k")
    return shapes


def all_cells() -> List[Tuple[str, str]]:
    """Every runnable (arch, shape) dry-run cell."""
    return [(a, s) for a in ARCH_IDS for s in valid_shapes(a)]


def skipped_cells() -> List[Tuple[str, str, str]]:
    """(arch, shape, reason) for each principled skip — reported, not lost."""
    out = []
    for a in ARCH_IDS:
        cfg = get_config(a)
        valid = set(valid_shapes(a))
        for s in SHAPES:
            if s in valid:
                continue
            if s in ("decode_32k", "long_500k") and (not cfg.causal
                                                     or cfg.inputs_embeds):
                out.append((a, s, "encoder-only: no autoregressive decode"))
            elif s == "long_500k":
                out.append((a, s, "full quadratic attention at 524k context"))
    return out


# ---------------------------------------------------------------------------
# the paper's own experimental configs (Table I)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SketchDatasetConfig:
    name: str
    n: int              # database size in the paper
    hashing: str        # "bbit_minhash" | "zbit_cws"
    L: int
    b: int
    lm: int             # paper's dense-layer top level (ℓ_m)
    ls: int             # paper's sparse-layer start (ℓ_s)


PAPER_DATASETS: Dict[str, SketchDatasetConfig] = {
    "review": SketchDatasetConfig("review", 12_886_488, "bbit_minhash", 16, 2, 8, 11),
    "cp": SketchDatasetConfig("cp", 216_121_626, "bbit_minhash", 32, 2, 9, 14),
    "sift": SketchDatasetConfig("sift", 1_000_000_000, "zbit_cws", 32, 4, 0, 21),
    "gist": SketchDatasetConfig("gist", 79_302_017, "zbit_cws", 64, 8, 0, 49),
}
