r"""Step builders: ``init_train_state`` and ``make_train_step`` (training
through autograd and the port's AdamW), ``make_prefill_step``,
``make_decode_step`` and the synthetic ``make_batch``. The port of
``repro.models.steps``.

``param_tree`` gives the model's parameters in the reference's tree: the
same keys, each segment a dict whose leaves are ``adamw.Stack``\ s of its
layers' parameters (the reference stacks them along a leading axis).
The optimizer state is keyed and shaped by that tree, so it equals the
reference's leaf for leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..optim import adamw
from . import decode as dec
from . import transformer as tfm
from .config import ModelConfig
from .layers import torch_dtype

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step",
           "make_batch", "init_train_state", "param_tree", "grad_tree"]


def param_tree(model: tfm.LMModel) -> dict:
    """The model's parameters in the reference's tree: parameter
    ``segments.s.i.<path>`` is layer ``i`` of the :class:`Stack` at
    ``tree["segments"][s][<path>]``, every other parameter the leaf at its
    own path."""
    tree: dict = {}
    n_seg = len(model.segments)
    for name, prm in model.named_parameters():
        path = name.split(".")
        if path[0] == "segments":
            node = tree.setdefault("segments", [{} for _ in range(n_seg)])
            node, keys = node[int(path[1])], path[3:]
        else:
            node, keys = tree, path
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        if path[0] == "segments":
            node.setdefault(keys[-1], []).append(prm)
        else:
            node[keys[-1]] = prm
    return _stacks(tree)


def _stacks(tree):
    """Each list of per-layer parameters in ``tree`` as a Stack."""
    if isinstance(tree, dict):
        return {k: _stacks(v) for k, v in tree.items()}
    if isinstance(tree, list) and tree and isinstance(tree[0], torch.Tensor):
        return adamw.Stack(tree)
    if isinstance(tree, list):
        return [_stacks(t) for t in tree]
    return tree


def grad_tree(params: dict) -> dict:
    """``params``' gradients in its structure, zeros where a parameter has
    none (it did not reach the loss), as ``jax.grad`` gives them."""
    def grad(p):
        return torch.zeros_like(p) if p.grad is None else p.grad

    return adamw.tree_map(
        lambda leaf: adamw.Stack(map(grad, leaf.parts))
        if isinstance(leaf, adamw.Stack) else grad(leaf), params)


def init_train_state(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                     generator: torch.Generator | None = None, device=None):
    """``(model, opt_state)``: ``tfm.init_params``' model (drawn from
    ``generator``, a fresh one seeded 0 when None) and zero moments in the
    reference's tree (``param_tree``)."""
    model = tfm.init_params(cfg, generator, device)
    return model, adamw.init_state(opt_cfg, param_tree(model))


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig):
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``: the loss's gradients through autograd, then one AdamW step
    on the model's parameters in place; metrics ``loss``, ``ce``, ``aux``,
    ``grad_norm`` and ``lr`` as 0-d tensors."""

    def train_step(model, opt_state, batch):
        model.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss, parts = tfm.loss_fn(model, cfg, batch)
            loss.backward()
        params = param_tree(model)
        opt_state, om = adamw.apply_updates(opt_cfg, params,
                                            grad_tree(params), opt_state)
        metrics = {"loss": loss.detach(), "ce": parts["ce"].detach(),
                   "aux": parts["aux"].detach(), **om}
        return model, opt_state, metrics

    return train_step


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
