"""Architecture config schema + input-shape definitions for all assigned
architectures (see configs/<id>.py for the ten instances).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int = 0              # 0 => d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6

    # attention pattern
    attn_kind: str = "gqa"         # gqa | mla | none
    local_ratio: int = 0           # N local layers per 1 global (gemma3: 5)
    window: int = 0                # sliding window for local layers
    n_full_attn: int = 0           # hybrid: count of full-attention layers

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_dense_residual: bool = False   # arctic: dense FFN parallel to MoE
    d_ff_expert: int = 0

    # MLA
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # SSM / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    slstm_every: int = 0           # xlstm: every k-th block is sLSTM

    # encoder-decoder
    enc_layers: int = 0

    # modality frontend stub: number of precomputed embedding positions
    # prepended to the token sequence (vlm) / encoder input (audio)
    frontend: str = ""             # "" | "vision" | "audio"
    n_frontend_embeds: int = 0

    # capacity factor for MoE dispatch
    capacity_factor: float = 1.25

    # long-context support marker (decides long_500k applicability)
    subquadratic: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def reduced(self, **overrides) -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers, 2),
            d_model=min(self.d_model, 64),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=min(self.d_ff, 128) if self.d_ff else 0,
            vocab=min(self.vocab, 256),
            head_dim=0,
            window=min(self.window, 8) if self.window else 0,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            d_ff_expert=min(self.d_ff_expert, 64) if self.d_ff_expert else 0,
            kv_lora_rank=min(self.kv_lora_rank, 16),
            qk_nope_dim=16 if self.kv_lora_rank else self.qk_nope_dim,
            qk_rope_dim=8 if self.kv_lora_rank else self.qk_rope_dim,
            v_head_dim=16 if self.kv_lora_rank else self.v_head_dim,
            enc_layers=min(self.enc_layers, 2),
            n_frontend_embeds=min(self.n_frontend_embeds, 4),
            n_full_attn=min(self.n_full_attn, 1),
            ssm_state=min(self.ssm_state, 4) if self.ssm_state else 0,
            name=self.name + "-smoke",
            # dropless dispatch so prefill/decode consistency is exact
            capacity_factor=8.0,
        )
        # keep n_kv_heads dividing n_heads
        if small["n_heads"] % small["n_kv_heads"]:
            small["n_kv_heads"] = 1
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig) -> dict[str, ShapeConfig]:
    """long_500k only for sub-quadratic archs (assignment rule)."""
    out = dict(SHAPES)
    if not cfg.subquadratic:
        out.pop("long_500k")
    return out
