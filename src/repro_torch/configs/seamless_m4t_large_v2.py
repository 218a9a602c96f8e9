"""seamless-m4t-large-v2 — encoder-decoder multimodal translation backbone
[arXiv:2308.11596].  24L decoder + 24L encoder, d_model=1024, 16H (kv=16),
d_ff=8192, vocab=256206.  The mel-spectrogram/conformer feature frontend is
a stub: ``data.tokens.synth_batch`` provides frame embeddings (B, S_src,
d_model).

long_500k is skipped for this arch (500k source frames would require a
quadratic full-attention encoder pass and is far outside the model's
training domain): ``launch.serve.serving_config`` refuses it."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    arch_type="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    is_encoder_decoder=True,
    n_enc_layers=24,
    modality="audio_frames",
    source="arXiv:2308.11596 (SeamlessM4T-Large v2)",
)

def smoke() -> ModelConfig:
    return CONFIG.with_(n_layers=2, n_enc_layers=2, d_model=128, n_heads=4,
                        n_kv_heads=4, d_ff=256, vocab_size=512)
