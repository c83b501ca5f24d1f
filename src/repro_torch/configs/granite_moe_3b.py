"""granite-moe-3b-a800m [moe] — top-8 routing
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].
32L d_model=1536 24H (GQA kv=8) expert d_ff=512 vocab=49155, MoE 40e top-8."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab=49155,
    n_experts=40, top_k=8,
    activation="swiglu", norm="rmsnorm", rope_theta=1e4,
    tie_embeddings=True,
    # 40 tiny (512-wide) experts, stored sharded and replicated at compute
    # on a mesh (the reference's field; one card holds them whole)
    moe_expert_sharding="data_zero",
)

SMOKE = ModelConfig(
    name="granite-moe-3b-smoke", family="moe",
    n_layers=3, d_model=96, n_heads=6, n_kv_heads=2, d_ff=64, vocab=512,
    n_experts=8, top_k=2, tie_embeddings=True, dtype="float32", loss_chunk=32,
)
