"""rwkv6-1.6b [ssm] — Finch, data-dependent decay [arXiv:2404.05892;
unverified]. 24L d_model=2048 (attn-free) d_ff=7168 vocab=65536.
32 heads of size 64 (RWKV6 head_size=64). O(1)-state decode => runs the
long_500k cell."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm", attn_free=True,
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab=65536,
    norm="layernorm",
)

SMOKE = ModelConfig(
    name="rwkv6-1.6b-smoke", family="ssm", attn_free=True,
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=224, vocab=512,
    norm="layernorm", dtype="float32", loss_chunk=32,
)
