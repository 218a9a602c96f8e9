"""Architecture registry: ``--arch <id>`` resolves here.  The port
registers the architectures it runs: the dense family (qwen3-0.6b,
internlm2-20b, qwen1.5-32b, qwen2.5-32b), the vision-prefix VLM
(llava-next-34b), the MoE family (qwen2-moe-a2.7b) and RWKV-6
(rwkv6-3b)."""

from repro_torch.configs import (
    internlm2_20b,
    llava_next_34b,
    qwen2_moe_a27b,
    qwen3_06b,
    qwen15_32b,
    qwen25_32b,
    rwkv6_3b,
)
from repro_torch.configs.base import CompressionConfig, ModelConfig, TrainConfig

_MODULES = {
    "qwen3-0.6b": qwen3_06b,
    "internlm2-20b": internlm2_20b,
    "qwen1.5-32b": qwen15_32b,
    "qwen2.5-32b": qwen25_32b,
    "llava-next-34b": llava_next_34b,
    "qwen2-moe-a2.7b": qwen2_moe_a27b,
    "rwkv6-3b": rwkv6_3b,
}

ARCH_IDS = tuple(_MODULES)

__all__ = ["ARCH_IDS", "CompressionConfig", "ModelConfig", "TrainConfig",
           "get_config", "get_smoke_config"]


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise ValueError(f"unknown arch {arch!r}; have {list(_MODULES)}")
    return _MODULES[arch].CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise ValueError(f"unknown arch {arch!r}; have {list(_MODULES)}")
    return _MODULES[arch].smoke()
