"""hymba-1.5b [hybrid] — parallel attn+mamba heads [arXiv:2411.13676; hf].
32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Sliding-window attention (2048) everywhere except 3 global layers
(first/middle/last, per the Hymba paper); meta-tokens omitted."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", hybrid=True,
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001, ssm_state=16, ssm_expand=2,
    sliding_window=2048, global_attn_layers=(0, 15, 31),
    activation="swiglu", norm="rmsnorm", rope_theta=1e4,
)

SMOKE = ModelConfig(
    name="hymba-1.5b-smoke", family="hybrid", hybrid=True,
    n_layers=3, d_model=80, n_heads=5, n_kv_heads=1, d_ff=192, vocab=512,
    ssm_state=8, sliding_window=16, global_attn_layers=(0, 2),
    dtype="float32", loss_chunk=32,
)
