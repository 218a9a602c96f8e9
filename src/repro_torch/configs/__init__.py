"""Architecture registry: ``--arch <id>`` resolves here.  The port
registers only the architectures it runs (qwen3-0.6b, rwkv6-3b)."""

from repro_torch.configs import qwen3_06b, rwkv6_3b
from repro_torch.configs.base import CompressionConfig, ModelConfig, TrainConfig

_MODULES = {
    "qwen3-0.6b": qwen3_06b,
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
