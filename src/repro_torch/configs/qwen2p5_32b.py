"""qwen2.5-32b [dense] — GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B; hf].
64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=27648, vocab=152064,
    qkv_bias=True, activation="swiglu", norm="rmsnorm", rope_theta=1e6,
    param_sharding="fsdp_tp",
)

SMOKE = ModelConfig(
    name="qwen2.5-32b-smoke", family="dense",
    n_layers=3, d_model=96, n_heads=6, n_kv_heads=2, d_ff=256, vocab=512,
    qkv_bias=True, dtype="float32", loss_chunk=32,
)
