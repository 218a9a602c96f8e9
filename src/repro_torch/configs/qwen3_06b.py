"""qwen3-0.6b — dense GQA with QK-norm [hf:Qwen/Qwen3-8B family].
28L, d_model=1024, 16H (kv=8), d_ff=3072, vocab=151936, head_dim=128."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    arch_type="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=3072,
    vocab_size=151936,
    head_dim=128,              # decoupled head_dim per Qwen3 card
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-0.6B (qk_norm per Qwen3-8B card)",
)


def smoke() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                        d_ff=256, vocab_size=512, head_dim=32)
