"""qwen2.5-32b — dense GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B family].
64L, d_model=5120, 40H (kv=8), d_ff=27648, vocab=152064."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    arch_type="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen2.5-32B (per assignment; bias per Qwen2.5-0.5B card)",
)

def smoke() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                        d_ff=256, vocab_size=512)
