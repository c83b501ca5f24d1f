"""The LM side: model definitions for the architecture pool (dense, MoE,
hybrid, SSM, VLM and audio), their prefill and ring-cache decode, and the
train step. The port of ``repro.models``; it imports nothing of it."""
from .config import SHAPES, ModelConfig, ShapeCell, applicable_shapes
from .steps import (init_train_state, make_batch, make_decode_step,
                    make_prefill_step, make_train_step)
from .transformer import LMModel, init_params, loss_fn

__all__ = [
    "ModelConfig", "SHAPES", "ShapeCell", "applicable_shapes", "LMModel",
    "make_batch", "make_decode_step", "make_prefill_step", "init_params",
    "loss_fn", "init_train_state", "make_train_step",
]
