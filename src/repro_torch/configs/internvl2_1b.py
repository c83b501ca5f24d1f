"""internvl2-1b [vlm] — InternViT + InternLM2 [arXiv:2404.16821; hf].
24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655. The InternViT
frontend is a stub: the batch carries precomputed patch embeddings,
projected by a linear frontend."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab=151655,
    embed_inputs=True, frontend_dim=1024, n_prefix_embeds=256,
    activation="swiglu", norm="rmsnorm", rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="internvl2-1b-smoke", family="vlm",
    n_layers=3, d_model=96, n_heads=6, n_kv_heads=2, d_ff=192, vocab=512,
    embed_inputs=True, frontend_dim=48, n_prefix_embeds=8,
    dtype="float32", loss_chunk=32,
)
