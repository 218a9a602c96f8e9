"""deepseek-v2-lite-16b — MLA + fine-grained MoE [arXiv:2405.04434].
27L, d_model=2048, 16H, MLA kv_lora=512, 64 routed experts top-6 +
2 shared, expert d_ff=1408, first layer dense, vocab=102400.

Note: the assignment bracket mentions "160 routed" which is the *full*
DeepSeek-V2 configuration; the headline spec (64e top-6) matches
DeepSeek-V2-Lite and is what we implement.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,            # dense-FFN width of the first (non-MoE) layer
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    head_dim=192,          # qk_nope + qk_rope
    n_experts=64,
    n_shared_experts=2,
    experts_per_token=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    source="arXiv:2405.04434 (DeepSeek-V2-Lite)",
)

def smoke() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
                        d_ff=256, vocab_size=512, kv_lora_rank=32,
                        qk_rope_dim=16, qk_nope_dim=32, v_head_dim=32,
                        head_dim=48, n_experts=4, experts_per_token=2,
                        n_shared_experts=1, moe_d_ff=64, first_dense_layers=1)
