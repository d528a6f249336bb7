"""Architecture registry (port of ``repro.configs.registry``): ``--arch <id>``
resolution and the reduced smoke configs."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

from repro_torch.models.config import ModelConfig

ARCH_IDS = (
    "qwen1_5_32b",
    "starcoder2_3b",
    "minitron_4b",
    "stablelm_12b",
    "mamba2_370m",
    "whisper_tiny",
    "recurrentgemma_2b",
    "llama32_vision_11b",
    "qwen3_moe_30b",
    "qwen3_moe_235b",
)

# public --arch aliases (match the assignment's spelling)
ALIASES = {
    "qwen1.5-32b": "qwen1_5_32b",
    "starcoder2-3b": "starcoder2_3b",
    "minitron-4b": "minitron_4b",
    "stablelm-12b": "stablelm_12b",
    "mamba2-370m": "mamba2_370m",
    "whisper-tiny": "whisper_tiny",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    # the paper's own problems
    "lofar-cs302": "lofar_cs302",
    "gaussian-toy": "gaussian_toy",
    "mri-brain": "mri_brain",
}


def resolve(arch: str) -> str:
    return ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{resolve(arch)}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config: small layers/width/experts, tiny vocab."""
    mod = importlib.import_module(f"repro_torch.configs.{resolve(arch)}")
    return mod.SMOKE


def all_model_archs():
    return ARCH_IDS
