"""arctic-480b [moe] — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base; hf].
35L d_model=7168 56H (GQA kv=8) expert d_ff=4864 vocab=32000.
The sharding and optimizer fields (``param_sharding="fsdp_tp"``, int8
AdamW moments) are the reference's: 480B parameters cannot hold fp32
optimizer state on one host."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000,
    n_experts=128, top_k=2, dense_residual=True, dense_d_ff=4864,
    activation="swiglu", norm="rmsnorm", rope_theta=1e4,
    param_sharding="fsdp_tp", optimizer_dtype="int8",
)

SMOKE = ModelConfig(
    name="arctic-480b-smoke", family="moe",
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_ff=64, vocab=512,
    n_experts=8, top_k=2, dense_residual=True, dense_d_ff=64,
    dtype="float32", loss_chunk=32,
)
