"""Architecture registry: ``--arch <id>`` resolves here.  The port
registers the architectures it runs: the dense family (qwen3-0.6b,
internlm2-20b, qwen1.5-32b, qwen2.5-32b), the vision-prefix VLM
(llava-next-34b), the MoE family (qwen2-moe-a2.7b; deepseek-v2-lite-16b
with multi-head latent attention), RWKV-6 (rwkv6-3b), the Mamba-2 hybrid
(zamba2-1.2b) and the audio encoder-decoder (seamless-m4t-large-v2): the
reference's ten, ``ARCH_IDS``.  Besides them, ``get_config`` resolves
the port-only architectures, which the reference lacks: zamba2-7b, the
published Zamba2 block (grouped Mamba-2, shared blocks over the hidden
state and the embedding, per-use adapters; ``Zamba2Config``)."""

from repro_torch.configs import (
    deepseek_v2_lite_16b,
    internlm2_20b,
    llava_next_34b,
    qwen2_moe_a27b,
    qwen3_06b,
    qwen15_32b,
    qwen25_32b,
    rwkv6_3b,
    seamless_m4t_large_v2,
    zamba2_7b,
    zamba2_12b,
)
from repro_torch.configs.base import (
    INPUT_SHAPES,
    CompressionConfig,
    InputShape,
    ModelConfig,
    TrainConfig,
    Zamba2Config,
)

_MODULES = {     # the reference's order
    "rwkv6-3b": rwkv6_3b,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "llava-next-34b": llava_next_34b,
    "qwen2.5-32b": qwen25_32b,
    "internlm2-20b": internlm2_20b,
    "qwen3-0.6b": qwen3_06b,
    "qwen1.5-32b": qwen15_32b,
    "seamless-m4t-large-v2": seamless_m4t_large_v2,
    "qwen2-moe-a2.7b": qwen2_moe_a27b,
    "zamba2-1.2b": zamba2_12b,
}

ARCH_IDS = tuple(_MODULES)

#: architectures of the port alone, not in ``ARCH_IDS``
_PORT_ONLY = {
    "zamba2-7b": zamba2_7b,
}

__all__ = ["ARCH_IDS", "CompressionConfig", "INPUT_SHAPES", "InputShape",
           "ModelConfig", "TrainConfig", "Zamba2Config", "get_config",
           "get_smoke_config"]


def _module(arch: str):
    mod = _MODULES.get(arch) or _PORT_ONLY.get(arch)
    if mod is None:
        raise ValueError(f"unknown arch {arch!r}; have "
                         f"{list(_MODULES) + list(_PORT_ONLY)}")
    return mod


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke()
