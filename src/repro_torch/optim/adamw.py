r"""AdamW with optional 8-bit (block-quantized) moment storage: the port of
``repro.optim.adamw``.

Quantized moments are the memory-side trick that lets arctic-480b's
optimizer state fit a single pod: m/v are kept as int8 codes with
per-block fp32 scales (blocks of 256 over the flattened leaf), dequantized
on the fly inside the update. The second moment is quantized in sqrt
space, with a half-step floor on load.

The update is written out, not ``torch.optim.AdamW``: it is
``(m/bc1) / (sqrt(v/bc2) + eps)``, weight decay enters as
``lr·(upd + wd·p)`` on an fp32 copy of p, and the gradient is clipped by
``min(1, clip / max(‖g‖, 1e-12))`` over all leaves, in fp32; the schedule,
its bias corrections and the clip factor are fp32 tensors, as the
reference computes them.

Trees are the reference's: nested dicts (keys taken in sorted order) and
lists, whose leaves are tensors or :class:`Stack`\ s. A ``Stack`` is one
leaf of the reference's tree held by the model as per-layer tensors (a
segment's layers are stacked along a leading axis there): the optimizer
stacks it for the update, so the int8 blocks run over the stacked leaf as
the reference's do, and writes the slices back (a large leaf a few
layers at a time, where that gives the same bits). :func:`apply_updates`
updates the parameters and the moments in place.
"""
from __future__ import annotations

import dataclasses
import math

import torch

BLOCK = 256
# a Stack of more elements is updated in pieces of whole layers of at
# most this many elements (512 MB in fp32)
UPDATE_CHUNK = 1 << 27


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"  # float32 | bfloat16 | int8
    warmup_steps: int = 100
    total_steps: int = 10_000


class Stack:
    """One leaf of the reference's tree held as per-layer tensors: the leaf
    is ``torch.stack(parts)``, layer ``i`` is ``parts[i]``."""

    def __init__(self, parts):
        self.parts = tuple(parts)

    @property
    def shape(self) -> tuple:
        return (len(self.parts),) + tuple(self.parts[0].shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    def value(self) -> torch.Tensor:
        return torch.stack(self.parts)

    def assign(self, x: torch.Tensor) -> None:
        for part, xi in zip(self.parts, x):
            part.copy_(xi)


# ------------------------------------------------------------------ trees --

def is_leaf(x) -> bool:
    """A tree's leaf: a tensor or a :class:`Stack`."""
    return isinstance(x, (torch.Tensor, Stack))


def tree_paths(tree, prefix=()) -> list:
    """``(path, leaf)`` of every leaf, in ``jax.tree_util``'s order."""
    if is_leaf(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in tree_paths(tree[k],
                                                               prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, t in enumerate(tree) for pl in tree_paths(
            t, prefix + (i,))]
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def tree_map(fn, tree):
    """``tree``'s structure with ``fn(leaf)`` at each leaf."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t) for t in tree)
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def tree_at(tree, path):
    """The subtree of ``tree`` at ``path``."""
    for k in path:
        tree = tree[k]
    return tree


def value(leaf) -> torch.Tensor:
    """A leaf as one tensor (a :class:`Stack` stacked)."""
    return leaf.value() if isinstance(leaf, Stack) else leaf


def assign(leaf, x: torch.Tensor) -> None:
    """Write ``x`` into a leaf in place (a :class:`Stack` slice by slice)."""
    if isinstance(leaf, Stack):
        leaf.assign(x)
    else:
        leaf.copy_(x)


# -------------------------------------------------------------- the codec --

def _q8_encode(x: torch.Tensor):
    """Block-quantize the flattened leaf: (codes int8 [n_blocks, BLOCK],
    scales fp32 [n_blocks, 1])."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    blk = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = blk.abs().amax(dim=1, keepdim=True) / 127.0
    codes = torch.round(blk / torch.clamp(scale, min=1e-30)).to(torch.int8)
    return codes, scale.to(torch.float32)


def _q8_decode(codes: torch.Tensor, scale: torch.Tensor,
               shape) -> torch.Tensor:
    flat = (codes.to(torch.float32) * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def _store(x: torch.Tensor, dtype: str):
    if dtype == "int8":
        return _q8_encode(x)
    return x.to(getattr(torch, dtype))


def _load(s, dtype: str, shape) -> torch.Tensor:
    if dtype == "int8":
        return _q8_decode(s[0], s[1], shape)
    return s.to(torch.float32)


def _store_v(x: torch.Tensor, dtype: str):
    """Second moment: int8 in sqrt space (v ≥ 0 spans a huge in-block
    range; storing sqrt(v) halves the exponent range)."""
    if dtype == "int8":
        return _q8_encode(torch.sqrt(torch.clamp(x, min=0.0)))
    return x.to(getattr(torch, dtype))


def _load_v(s, dtype: str, shape) -> torch.Tensor:
    if dtype == "int8":
        u = _q8_decode(s[0], s[1], shape)
        # half-step floor: never dequantize a stored-positive v to zero
        n = math.prod(shape)
        blk = torch.repeat_interleave(s[1][:, 0], BLOCK)[:n].reshape(shape)
        u = torch.where(u > 0, torch.maximum(u, blk * 0.5),
                        torch.zeros((), dtype=u.dtype, device=u.device))
        return u * u
    return s.to(torch.float32)


# -------------------------------------------------------------- optimizer --

def init_state(cfg: AdamWConfig, params) -> dict:
    """``{"step": int32 0, "m": ..., "v": ...}``, the moments zero in
    ``cfg.moment_dtype`` with ``params``' structure (an int8 moment is a
    ``(codes, scales)`` pair over the leaf as the reference stacks it)."""
    def zeros_like_stored(p):
        return _store(torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), cfg.moment_dtype)

    dev = tree_paths(params)[0][1].device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": tree_map(zeros_like_stored, params),
            "v": tree_map(zeros_like_stored, params)}


def _lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine to 0.1·lr, in fp32 (``step`` an int32
    tensor)."""
    warm = torch.clamp(step.to(torch.float32) / max(cfg.warmup_steps, 1),
                       max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps).to(torch.float32)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    # cos of the fp32 angle, rounded from fp64: torch's fp32 cos can stand
    # an ulp off where XLA's does not, and 1 + cos amplifies it near the end
    cos = 0.5 * (1 + torch.cos((math.pi * prog).double()).float())
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over the leaves of each leaf's fp32 sum of squares,
    leaf by leaf in the tree's order (a :class:`Stack` layer by layer)."""
    total = None
    for _, g in tree_paths(grads):
        for part in g.parts if isinstance(g, Stack) else (g,):
            s = torch.sum(torch.square(part.to(torch.float32)))
            total = s if total is None else total + s
    return torch.sqrt(total)


def _layer_ranges(leaf, dt: str):
    """The layer ranges ``[a, b)`` :func:`apply_updates` takes ``leaf`` in,
    or None for the whole leaf: a :class:`Stack` of more than
    ``UPDATE_CHUNK`` elements goes a few layers at a time (at most
    ``UPDATE_CHUNK`` elements, at least one layer) where that gives the
    stacked leaf's bits (moments not int8, or each layer a whole number of
    int8 blocks, as every large leaf is). It bounds the update's fp32
    temporaries where they would be large, and keeps one pass over the leaf
    (fewer launches) where they are not."""
    if not isinstance(leaf, Stack) or math.prod(leaf.shape) <= UPDATE_CHUNK:
        return None
    per = leaf.parts[0].numel()
    if dt == "int8" and per % BLOCK:
        return None
    k, n = max(1, UPDATE_CHUNK // per), len(leaf.parts)
    return [(a, min(a + k, n)) for a in range(0, n, k)]


def _moment_rows(s, a: int, b: int, n: int, dt: str):
    """Layers ``[a, b)`` of ``n`` of a stored moment (a view)."""
    if dt == "int8":
        r = s[0].shape[0] // n
        return s[0][a * r:b * r], s[1][a * r:b * r]
    return s[a:b]


def _write(s, new) -> None:
    """Overwrite a stored moment (or a piece of one) in place."""
    for old, x in zip(s, new) if isinstance(s, tuple) else ((s, new),):
        old.copy_(x)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state: dict):
    """One AdamW step: ``params``' leaves are updated in place (each
    rounded back to its dtype), and so are the moments of ``state``;
    returns ``(state, {"grad_norm", "lr"})``, the norm the raw
    (unclipped) one. ``grads`` has ``params``' structure."""
    dt = cfg.moment_dtype
    step = state["step"] + 1
    gn = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-12), max=1.0)
    lr = _lr_at(cfg, step)
    bc1 = 1.0 - cfg.b1 ** step.to(torch.float32)
    bc2 = 1.0 - cfg.b2 ** step.to(torch.float32)
    for path, p in tree_paths(params):
        g_leaf = tree_at(grads, path)
        m_s, v_s = tree_at(state["m"], path), tree_at(state["v"], path)
        ranges = _layer_ranges(p, dt)
        if ranges is None:
            pieces = [(p, g_leaf, m_s, v_s)]
        else:
            n = len(p.parts)
            pieces = [(Stack(p.parts[a:b]), Stack(g_leaf.parts[a:b]),
                       _moment_rows(m_s, a, b, n, dt),
                       _moment_rows(v_s, a, b, n, dt)) for a, b in ranges]
        for pp, gp, mi, vi in pieces:
            shape = pp.shape
            g = value(gp).to(torch.float32) * clip
            m = cfg.b1 * _load(mi, dt, shape) + (1 - cfg.b1) * g
            v = (cfg.b2 * _load_v(vi, dt, shape)
                 + (1 - cfg.b2) * g * g)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            pf = value(pp).to(torch.float32)
            pf = pf - lr * (upd + cfg.weight_decay * pf)
            assign(pp, pf.to(pp.dtype))
            _write(mi, _store(m, dt))
            _write(vi, _store_v(v, dt))
            del g, m, v, upd, pf
    return ({"step": step, "m": state["m"], "v": state["v"]},
            {"grad_norm": gn, "lr": lr})
