"""zamba2-1.2b — hybrid: Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].  38 Mamba2 layers, d_model=2048, shared attn block
(32H MHA) applied every 6 layers, d_ff=8192, ssm_state=64, vocab=32000."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    attn_every=6,
    rwkv_head_dim=64,       # mamba2 head dim
    source="arXiv:2411.15242 (Zamba2-1.2B)",
)

def smoke() -> ModelConfig:
    return CONFIG.with_(n_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
                        d_ff=256, vocab_size=512, ssm_state=16, attn_every=2)
