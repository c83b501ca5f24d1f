"""Step builders of the serving path: ``make_prefill_step``,
``make_decode_step`` and the synthetic ``make_batch``. The port of
``repro.models.steps``; the training steps come with the training path.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from . import decode as dec
from . import transformer as tfm
from .config import ModelConfig
from .layers import torch_dtype

__all__ = ["make_prefill_step", "make_decode_step", "make_batch"]


def make_prefill_step(cfg: ModelConfig, max_len: int):
    """``prefill_step(model, batch) -> (last-position logits [B, vocab],
    decode state)``, with caches ``max_len`` deep."""

    @torch.no_grad()
    def prefill_step(params, batch):
        return tfm.backbone_with_state(params, cfg, batch, max_len)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``decode_step(model, state, token [B], pos) -> (logits [B, vocab],
    state)``; the state is updated in place."""

    @torch.no_grad()
    def decode_step(params, state, token, pos):
        return dec.decode_step(params, cfg, state, token, pos)

    return decode_step


def make_batch(cfg: ModelConfig, batch: int, seq: int, key=None,
               device=None) -> dict:
    """A synthetic batch of the arch's input contract (tokens for LMs,
    feature frames for audio, patches and tokens for VLM), from the
    reference's ``np.random.default_rng`` draws in the reference's order,
    so both packages build the same batch bit for bit."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0 if key is None else key)
    dt = torch_dtype(cfg.dtype)

    def floats(a):
        return torch.as_tensor(a).to(dt).to(dev)

    def ints(a):
        return torch.as_tensor(a.astype(np.int32), device=dev)

    if cfg.family == "audio":
        return {
            "features": floats(rng.standard_normal((batch, seq,
                                                    cfg.frontend_dim))),
            "mask": torch.as_tensor(rng.random((batch, seq)) < 0.08,
                                    device=dev),
            "labels": ints(rng.integers(0, cfg.vocab, (batch, seq))),
        }
    if cfg.family == "vlm":
        npfx = min(cfg.n_prefix_embeds, max(seq // 8, 1))
        s_text = seq - npfx
        return {
            "tokens": ints(rng.integers(0, cfg.vocab, (batch, s_text))),
            "patches": floats(rng.standard_normal((batch, npfx,
                                                   cfg.frontend_dim))),
            "labels": ints(rng.integers(0, cfg.vocab, (batch, s_text))),
        }
    return {
        "tokens": ints(rng.integers(0, cfg.vocab, (batch, seq))),
        "labels": ints(rng.integers(0, cfg.vocab, (batch, seq))),
    }
