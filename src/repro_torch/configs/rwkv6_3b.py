"""rwkv6-3b -- Finch: attention-free RNN with data-dependent decay
[arXiv:2404.05892].  32L, d_model=2560, d_ff=8960, vocab=65536."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    arch_type="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,            # 2560 / 64 WKV heads
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    rwkv_head_dim=64,
    source="arXiv:2404.05892 (RWKV-6 Finch 3B)",
)


def smoke() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
                        d_ff=256, vocab_size=512)
