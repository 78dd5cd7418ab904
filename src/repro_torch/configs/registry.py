"""Architecture registry: ``--arch <id>`` -> ModelConfig (+ smoke config)."""
from __future__ import annotations

import importlib

ARCHS = {
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "qwen2-1.5b": "qwen2_1_5b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "gemma-2b": "gemma_2b",
    "deepseek-67b": "deepseek_67b",
    "hubert-xlarge": "hubert_xlarge",
    "internvl2-76b": "internvl2_76b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "zamba2-2.7b": "zamba2_2_7b",
}


def _module(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; available: {list(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch_id]}")


def get_config(arch_id: str):
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str):
    return _module(arch_id).SMOKE


def list_archs():
    return list(ARCHS)


def sub_quadratic(cfg) -> bool:
    """True if decode/long-context cost per token is sub-quadratic-safe
    (SSM / hybrid families; paper-spec gate for the long_500k shape)."""
    return cfg.family in ("ssm", "hybrid")
