"""hubert-xlarge [audio] — encoder-only, w2v2 arch [arXiv:2106.07447;
unverified]. 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (masked-unit
prediction). The conv waveform frontend is a stub: the batch carries precomputed
frame embeddings (frontend_dim=512), projected by a linear frontend.
Encoder-only, so no decode or long-context shapes."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab=504,
    encoder_only=True, embed_inputs=True, frontend_dim=512,
    activation="gelu", norm="layernorm",
)

SMOKE = ModelConfig(
    name="hubert-xlarge-smoke", family="audio",
    n_layers=3, d_model=96, n_heads=4, n_kv_heads=4, d_ff=192, vocab=64,
    encoder_only=True, embed_inputs=True, frontend_dim=32,
    activation="gelu", norm="layernorm", dtype="float32", loss_chunk=32,
)
