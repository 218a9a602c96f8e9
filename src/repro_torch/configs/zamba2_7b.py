"""zamba2-7b -- Zamba2-7B-Instruct (hf:Zyphra/Zamba2-7B-Instruct,
config.json; arXiv:2411.15242), a port-only architecture: 81 Mamba-2
layers (d_model 3584, expand 2, 112 heads of 64, 2 B/C groups, state
64, conv 4) and two shared attention blocks used in turn at the 13
hybrid layers, each over the hidden state and the embedding
concatenated (7168 wide: 32 heads of 224, RoPE, softmax scale
(224/2)^-0.5), with a GELU-gated MLP of 14336 whose gate and up take a
rank-128 adapter of each use's own, and each use's own 3584^2
``linear``; tied vocab 32000.  7,356,749,648 params."""

from repro_torch.configs.base import Zamba2Config

CONFIG = Zamba2Config(
    name="zamba2-7b",
    arch_type="zamba2",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=224,           # attention_head_dim = 2 d_model / heads
    d_ff=14336,
    vocab_size=32000,
    rope_theta=10_000.0,
    ssm_state=64,
    rwkv_head_dim=64,       # mamba2 head dim
    conv_kernel=4,
    norm_eps=1e-5,
    tie_embeddings=True,
    hybrid_layer_ids=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
    num_mem_blocks=2,
    mamba_ngroups=2,
    adapter_rank=128,
    source="hf:Zyphra/Zamba2-7B-Instruct (arXiv:2411.15242)",
)


def smoke() -> Zamba2Config:
    """Six layers, hybrid at 1, 3 and 5: both blocks, block 0 used
    twice."""
    return CONFIG.with_(n_layers=6, d_model=64, n_heads=4, n_kv_heads=4,
                        head_dim=32, d_ff=128, vocab_size=512, ssm_state=16,
                        rwkv_head_dim=16, hybrid_layer_ids=(1, 3, 5),
                        adapter_rank=8)
