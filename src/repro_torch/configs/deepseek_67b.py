"""deepseek-67b [dense] — llama-arch [arXiv:2401.02954; hf].
95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=102400,
    activation="swiglu", norm="rmsnorm", rope_theta=1e4,
    param_sharding="fsdp_tp",
)

SMOKE = ModelConfig(
    name="deepseek-67b-smoke", family="dense",
    n_layers=3, d_model=128, n_heads=8, n_kv_heads=2, d_ff=352, vocab=512,
    activation="swiglu", norm="rmsnorm", dtype="float32", loss_chunk=32,
)
