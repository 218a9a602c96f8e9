"""Config dataclasses: architecture + run configuration.

A copy of the reference's ``repro/configs/base.py`` (the port imports
nothing of the JAX package), with the same fields and defaults so a
config means the same run on both sides.  ``CompressionConfig.make``
builds the port's codec and shift rule.  ``InputShape`` and
``INPUT_SHAPES`` are the dry-run's input shapes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | vlm | audio
    #                                (| zamba2: Zamba2Config)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0        # 0 = full attention; >0 = window size
    attn_q_chunk: int = 512        # key-chunk size of the online softmax

    # MLA (DeepSeek-V2)
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001
    moe_group_size: int = 4096

    # SSM / RWKV / hybrid
    ssm_state: int = 0
    rwkv_head_dim: int = 64
    attn_every: int = 0
    conv_kernel: int = 4

    # encoder-decoder (audio)
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0

    # modality frontends
    modality: str = "text"         # text | vision_prefix | audio_frames
    num_prefix_tokens: int = 576

    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"        # activation/param dtype
    source: str = ""               # citation for the config

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        from repro_torch.models.model import count_params_analytic
        return count_params_analytic(self)


@dataclass(frozen=True)
class Zamba2Config(ModelConfig):
    """The published Zamba2 block (``arch_type`` "zamba2"; port-only,
    the reference has no such family): Mamba-2 layers whose B and C come
    in ``mamba_ngroups`` groups, and at each of ``hybrid_layer_ids`` one
    of ``num_mem_blocks`` shared attention blocks, used in turn, over the
    hidden state and the token embedding concatenated, each use with its
    own rank-``adapter_rank`` adapter on the MLP's gate and up
    projections and its own ``linear`` (``models/model.py``).  The
    attention reads ``2 d_model`` through ``n_heads`` heads of
    ``head_dim``; the MLP is GELU-gated, ``d_ff`` wide."""
    hybrid_layer_ids: tuple = ()
    num_mem_blocks: int = 1
    mamba_ngroups: int = 1
    adapter_rank: int = 0


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


#: the dry-run's input shapes, the reference's
INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class CompressionConfig:
    """How the DCGD-SHIFT layer is wired into the training step (same
    fields as the reference).  The port runs the ``dense``,
    ``randk_shared``, ``q8_ring``, ``q8_ring_fused``, ``ef21``, ``efbv``,
    ``sim``, ``q8_ring_overlap``, ``efbv_overlap`` and
    ``q8_ring_fused_vjp`` comm modes (the overlap modes' bucket budget is
    ``overlap_bucket_bytes``); ``auto`` is the tuner's sentinel, resolved
    to one of them by ``repro_torch.tune`` before a channel is built; the
    ``fixed``/``dcgd``/``diana``/``rand_diana``/``ef21``/``efbv``/
    ``vr_gdci`` rules and every codec of the reference's registry;
    unknown values raise ``ValueError`` where they are resolved."""
    enabled: bool = True
    compressor: str = "natural"
    compressor_kwargs: tuple = ()  # tuple of (key, value) pairs (hashable)
    shift_rule: str = "diana"
    shift_alpha: float = 0.125     # DIANA alpha
    shift_p: float = 0.05
    gdci_eta: float = 0.5
    efbv_eta: float = 1.0
    efbv_nu: float = 1.0
    comm_mode: str = "dense"
    randk_q: float = 0.05
    overlap_bucket_bytes: int = 4 << 20
    q8_block_rows: int = 64
    drift_resync_every: int = 0    # dense h_bar resync period (0 = off)
    moe_wire: str = "none"
    act_wire: str = "none"
    model_wire: str = "none"
    publish_every: int = 1

    @property
    def effective_shift_rule(self) -> str:
        """The update rule actually run (the ``ef21``/``efbv`` comm
        modes imply their rule)."""
        if self.comm_mode == "ef21":
            return "ef21"
        if self.comm_mode in ("efbv", "efbv_overlap"):
            return "efbv"
        return self.shift_rule

    @property
    def aggregation_mode(self) -> str:
        """Wire format of the master-side aggregation: disabled configs
        and EF21 aggregate densely (EF21's savings are in the per-worker
        contractive messages)."""
        if not self.enabled:
            return "dense"
        if self.comm_mode == "auto":
            raise ValueError(
                "comm_mode 'auto' has no aggregation format until the "
                "tuner resolves it (repro_torch.tune.autotune + apply_plan)"
            )
        from repro_torch.comm.channel import aggregation_mode_of

        return aggregation_mode_of(self.comm_mode)

    def make(self, learning_rate: Optional[float] = None):
        """Build the ``(compressor, rule)`` pair this config describes.
        ``vr_gdci`` (Algorithm 2, compressed iterates) needs the outer
        ``learning_rate`` as its gradient-mapping gamma; the other rules
        ignore it."""
        from repro_torch.core.compressors import make_compressor
        from repro_torch.core.shift_rules import make_shift_rule

        q = make_compressor(self.compressor, **dict(self.compressor_kwargs))
        rule_name = self.effective_shift_rule
        if rule_name == "vr_gdci":
            from repro_torch.core.iterate_comp import VRGDCI

            if learning_rate is None:
                raise ValueError(
                    "shift_rule 'vr_gdci' needs learning_rate (its "
                    "gradient-mapping gamma); pass make(learning_rate=...)"
                )
            return q, VRGDCI(q=q, gamma=learning_rate, eta=self.gdci_eta,
                             alpha=self.shift_alpha)
        rule_kwargs = {
            "fixed": {},
            "dcgd": {},
            "diana": dict(alpha=self.shift_alpha),
            "rand_diana": dict(p=self.shift_p),
            "ef21": {},
            "efbv": dict(eta=self.efbv_eta, nu=self.efbv_nu),
        }
        if rule_name not in rule_kwargs:
            raise ValueError(
                f"unknown shift rule {rule_name!r}; have trainer rules "
                f"{tuple(sorted(rule_kwargs)) + ('vr_gdci',)}"
            )
        return q, make_shift_rule(rule_name, **rule_kwargs[rule_name])


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    warmup_steps: int = 100
    total_steps: int = 1000
    optimizer: str = "adamw"       # adamw
    train_attn_chunk: int = 256    # key-chunk for TRAIN attention (<=0:
                                   # keep the arch default)
    remat: bool = True
    zero_opt_state: bool = True
    fsdp_params: bool = False
    compression: CompressionConfig = field(default_factory=CompressionConfig)
