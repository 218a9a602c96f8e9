"""internlm2-20b — dense GQA [arXiv:2403.17297].
48L, d_model=6144, 48H (kv=8), d_ff=16384, vocab=92544."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    arch_type="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
    rope_theta=1_000_000.0,
    source="arXiv:2403.17297 (InternLM2 20B)",
)

def smoke() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                        d_ff=256, vocab_size=512)
