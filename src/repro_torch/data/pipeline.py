"""Data pipeline: deterministic, shardable, restartable (the port of
``repro.data.pipeline``).

A counter-based (stateless) generator: batch ``i`` is a pure function of
(seed, i), so every host can produce exactly its own shard without
coordination, a restart from a checkpoint replays nothing and skips
nothing (the pipeline's state is the step counter in the checkpoint
manifest's ``extra``), and an elastic restart re-partitions cleanly.

Synthetic corpus: a Zipf-ish unigram mixture with injected n-gram
structure, so the LM loss actually decreases. The draws are the
reference's numpy draws in the reference's order, so both packages build
the same batch bit for bit; floating features are drawn in fp32 and
rounded to the model's dtype as JAX rounds them (to nearest, ties to
even).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.layers import torch_dtype


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    zipf_a: float = 1.2
    ngram: int = 3  # injected structure length


class TokenPipeline:
    """Batches of ``cfg``'s input contract, as tensors on ``device`` (the
    card unless ``"cpu"`` is given)."""

    def __init__(self, cfg: ModelConfig, dcfg: DataConfig = DataConfig(),
                 device=None):
        self.cfg = cfg
        self.dcfg = dcfg
        self.device = resolve_device(device)
        rng = np.random.default_rng(dcfg.seed)
        V = max(cfg.vocab, 2)
        ranks = np.arange(1, V + 1)
        p = ranks ** (-dcfg.zipf_a)
        self.unigram = p / p.sum()
        # deterministic "grammar": token t is often followed by succ[t]
        self.succ = rng.permutation(V)

    def _ints(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a.astype(np.int32), device=self.device)

    def _floats(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device).to(
            torch_dtype(self.cfg.dtype))

    def batch(self, index: int, batch: int, seq: int) -> dict:
        """Batch ``index`` (pure function of (seed, index))."""
        cfg = self.cfg
        rng = np.random.default_rng((self.dcfg.seed, index))
        if cfg.family == "audio":
            feats = rng.standard_normal(
                (batch, seq, cfg.frontend_dim)).astype(np.float32)
            mask = rng.random((batch, seq)) < 0.08
            labels = rng.integers(0, cfg.vocab, (batch, seq))
            return {"features": self._floats(feats),
                    "mask": torch.as_tensor(mask, device=self.device),
                    "labels": self._ints(labels)}
        toks = rng.choice(len(self.unigram), size=(batch, seq),
                          p=self.unigram)
        follow = rng.random((batch, seq)) < 0.6
        n = self.dcfg.ngram
        for k in range(1, n):
            toks[:, k::n] = np.where(
                follow[:, k::n],
                self.succ[toks[:, k - 1::n][:, : toks[:, k::n].shape[1]]],
                toks[:, k::n],
            )
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = -1  # no target for the final position
        if cfg.family == "vlm":
            npfx = min(cfg.n_prefix_embeds, max(seq // 8, 1))
            patches = rng.standard_normal(
                (batch, npfx, cfg.frontend_dim)).astype(np.float32)
            return {"tokens": self._ints(toks[:, : seq - npfx]),
                    "patches": self._floats(patches),
                    "labels": self._ints(labels[:, : seq - npfx])}
        return {"tokens": self._ints(toks), "labels": self._ints(labels)}
