"""Model configuration for the LM side: the port's copy of
``repro.models.config`` (pure Python, copied rather than imported, so the
port imports nothing of the JAX package)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None  # explicit (qwen3); default d_model//n_heads
    # --- layer options ---
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    activation: str = "swiglu"  # swiglu | squared_relu | gelu
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    dense_residual: bool = False  # arctic: dense MLP in parallel with MoE
    dense_d_ff: int = 0
    router_aux_coef: float = 0.01
    # "model": expert parallelism on the model axis (arctic: big experts).
    # "data_zero": experts ZeRO-sharded for storage but *replicated at
    # compute* — dispatch is then shard-local with zero collectives
    # (granite: 40 tiny 512-wide experts; see EXPERIMENTS §Perf).
    moe_expert_sharding: str = "model"
    # --- SSM / hybrid ---
    attn_free: bool = False  # rwkv6
    hybrid: bool = False  # hymba: parallel attn + mamba heads per layer
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_chunk: int = 64  # chunk-parallel WKV/SSM block length (0 = scan)
    sliding_window: int = 0  # 0 = full attention
    global_attn_layers: tuple[int, ...] = ()  # hymba full-attn layers
    # --- modality / structure ---
    encoder_only: bool = False  # hubert
    embed_inputs: bool = False  # vlm/audio: frontend stub provides embeddings
    frontend_dim: int = 0  # stub feature dim (audio frames / vision patches)
    n_prefix_embeds: int = 0  # vlm: patch embeddings prepended to text
    # --- training ---
    dtype: str = "bfloat16"
    remat: bool = True
    loss_chunk: int = 512  # sequence chunking for the CE loss
    # --- sharding / memory policy ---
    param_sharding: str = "tp"  # tp | fsdp_tp (ZeRO-3 style)
    optimizer_dtype: str = "float32"  # float32 | bfloat16 | int8 (quantized moments)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd

    @property
    def is_subquadratic(self) -> bool:
        """True if the arch supports 500k-token decode (SSM/hybrid)."""
        return self.attn_free or self.hybrid

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def segments(self) -> list[tuple[int, int, int]]:
        """Contiguous (start, end, window) runs of identical layer type.

        Layers inside a segment are homogeneous: the same attention window,
        so the same decode-state shapes (a sliding-window segment holds
        rings of the window's size). The decode state is one dict of
        stacked per-layer tensors per segment.
        """
        wins = [self.sliding_window] * self.n_layers
        for g in self.global_attn_layers:
            wins[g] = 0
        segs = []
        start = 0
        for i in range(1, self.n_layers + 1):
            if i == self.n_layers or wins[i] != wins[start]:
                segs.append((start, i, wins[start]))
                start = i
        return segs

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, L = self.d_model, self.n_layers
        p = self.vocab * d * (1 if self.tie_embeddings else 2)
        per = 0
        if not self.attn_free:
            per += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        else:
            per += 4 * d * d + 2 * d * self.d_ff  # rwkv time-mix + channel-mix
        if self.hybrid:
            per += 2 * d * self.d_inner + self.d_inner * (2 * self.ssm_state + 2)
        if self.n_experts:
            ff_mults = 3 if self.activation == "swiglu" else 2
            per += self.n_experts * ff_mults * d * self.d_ff + d * self.n_experts
            if self.dense_residual:
                per += ff_mults * d * (self.dense_d_ff or self.d_ff)
        elif not self.attn_free:
            ff_mults = 3 if self.activation == "swiglu" else 2
            per += ff_mults * d * self.d_ff
        return p + L * per

    def n_active_params(self) -> int:
        """Active parameters per token (MoE counts top_k experts only)."""
        if not self.n_experts:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        ff_mults = 3 if self.activation == "swiglu" else 2
        inactive = L * (self.n_experts - self.top_k) * ff_mults * d * self.d_ff
        return self.n_params() - inactive


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (arch x input-shape) dry-run cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}


def applicable_shapes(cfg: ModelConfig) -> dict[str, ShapeCell | None]:
    """Shape cells for an arch; None marks a skip (recorded in DESIGN.md)."""
    out: dict[str, ShapeCell | None] = {}
    for name, cell in SHAPES.items():
        skip = None
        if cfg.encoder_only and cell.kind == "decode":
            skip = "encoder-only arch has no decode step"
        elif name == "long_500k" and not cfg.is_subquadratic:
            skip = "pure full-attention arch; 500k decode needs sub-quadratic attention"
        out[name] = None if skip else cell
    return out
