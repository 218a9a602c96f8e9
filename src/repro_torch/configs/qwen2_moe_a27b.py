"""qwen2-moe-a2.7b — MoE with shared experts [hf:Qwen/Qwen1.5-MoE-A2.7B].
24L, d_model=2048, 16H (kv=16), 60 routed experts top-4 + 4 shared,
expert d_ff=1408, vocab=151936."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    arch_type="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5632,              # shared-expert fused width (4 x 1408)
    vocab_size=151936,
    qkv_bias=True,
    n_experts=60,
    n_shared_experts=4,
    experts_per_token=4,
    moe_d_ff=1408,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)

def smoke() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                        d_ff=128, vocab_size=512, n_experts=4,
                        experts_per_token=2, n_shared_experts=1, moe_d_ff=64)
