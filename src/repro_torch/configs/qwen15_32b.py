"""qwen1.5-32b — dense MHA-kv (kv=40 == heads: full MHA) with QKV bias
[hf:Qwen/Qwen1.5-0.5B family].  64L, d_model=5120, 40H (kv=40),
d_ff=27392, vocab=152064."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    arch_type="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    source="hf:Qwen/Qwen1.5-32B (bias per Qwen1.5-0.5B card)",
)

def smoke() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                        d_ff=256, vocab_size=512)
