"""Architecture registry: ``--arch <id>`` resolution for every launcher."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "llama-3.2-vision-11b": "repro_torch.configs.llama_3_2_vision_11b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "yi-6b": "repro_torch.configs.yi_6b",
    "llama3.2-3b": "repro_torch.configs.llama3_2_3b",
    "qwen3-32b": "repro_torch.configs.qwen3_32b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch_id]).smoke_config()
