"""nemotron-4-15b [dense] — GQA, squared-ReLU [arXiv:2402.16819; unverified].
32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=24576, vocab=256000,
    activation="squared_relu", norm="layernorm", rope_theta=1e4,
    param_sharding="fsdp_tp",
)

SMOKE = ModelConfig(
    name="nemotron-4-15b-smoke", family="dense",
    n_layers=3, d_model=96, n_heads=6, n_kv_heads=2, d_ff=256, vocab=512,
    activation="squared_relu", norm="layernorm", dtype="float32", loss_chunk=32,
)
