"""Architecture registry: ``--arch <id>`` → (CONFIG, SMOKE) (port of
``repro.configs.registry``).

Each assigned architecture lives in its own ``configs/<arch>.py`` module
exporting ``CONFIG`` (exact published config) and ``SMOKE`` (reduced
same-family config for CPU tests); this module aggregates them and provides
``input_specs``. Where the reference returns ``jax.ShapeDtypeStruct``
stand-ins, the port returns tensors on the ``meta`` device: a shape and a
torch dtype, with no storage.
"""

from __future__ import annotations

import importlib
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

__all__ = [
    "ARCHS",
    "SMOKES",
    "ARCH_MODULES",
    "get_config",
    "get_smoke",
    "input_specs",
    "cell_supported",
]

ARCH_MODULES = {
    "deepseek-moe-16b": "deepseek_moe_16b",
    "qwen2-moe-a2.7b": "qwen2_moe_a27b",
    "musicgen-medium": "musicgen_medium",
    "mamba2-1.3b": "mamba2_13b",
    "qwen1.5-4b": "qwen15_4b",
    "qwen1.5-0.5b": "qwen15_05b",
    "command-r-plus-104b": "command_r_plus_104b",
    "gemma-7b": "gemma_7b",
    "hymba-1.5b": "hymba_15b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
}

ARCHS: Dict[str, ModelConfig] = {}
SMOKES: Dict[str, ModelConfig] = {}
for _name, _mod in ARCH_MODULES.items():
    _m = importlib.import_module(f"repro_torch.configs.{_mod}")
    ARCHS[_name] = _m.CONFIG
    SMOKES[_name] = _m.SMOKE


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]


def get_smoke(arch: str) -> ModelConfig:
    if arch not in SMOKES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(SMOKES)}")
    return SMOKES[arch]


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Is (arch × shape) runnable? long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "long_500k skipped: pure full-attention arch (see DESIGN.md "
            "§Arch-applicability) — a 524288-token context requires "
            "sub-quadratic attention (SSM / hybrid-SWA archs only)"
        )
    return True, ""


def input_specs(
    cfg: ModelConfig, shape: ShapeConfig, mode: Optional[str] = None
) -> Dict[str, torch.Tensor]:
    """``meta`` tensors standing in for every model input (no allocation).

    * train/prefill: token batch (+ labels for train, + stub modality
      inputs: precomputed patch/frame embeddings).
    * decode: one new token per sequence + absolute positions.
    """
    mode = mode or shape.kind
    b, s = shape.global_batch, shape.seq_len

    def spec(shape_, dtype=torch.int32):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if mode == "decode":
        t = (b, 1, cfg.num_codebooks) if cfg.num_codebooks > 1 else (b, 1)
        return {"tokens": spec(t), "pos": spec((b,))}

    specs: Dict[str, torch.Tensor] = {}
    if cfg.modality == "vision_text":
        n_img = cfg.num_patches
        specs["tokens"] = spec((b, s - n_img))
        specs["image_embeds"] = spec((b, n_img, cfg.d_model), torch.bfloat16)
        if mode == "train":
            specs["labels"] = spec((b, s - n_img))
    elif cfg.num_codebooks > 1:
        specs["tokens"] = spec((b, s, cfg.num_codebooks))
        if mode == "train":
            specs["labels"] = spec((b, s, cfg.num_codebooks))
    else:
        specs["tokens"] = spec((b, s))
        if mode == "train":
            specs["labels"] = spec((b, s))
    return specs
