"""llava-next-34b — VLM: anyres vision tiling feeding a dense GQA decoder
[hf:llava-hf/llava-v1.6-mistral-7b-hf, scaled per assignment].
Backbone only: 60L, d_model=7168, 56H (kv=8), d_ff=20480, vocab=64000.
Vision frontend is a stub: input_specs() provides projected patch
embeddings (B, num_prefix_tokens, d_model)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    arch_type="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    modality="vision_prefix",
    num_prefix_tokens=576,     # one 24x24 anyres tile
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf (34B assignment scale)",
)

def smoke() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                        d_ff=256, vocab_size=512, num_prefix_tokens=16)
