"""Cross-pod gradient compression with error feedback: the port of
``repro.optim.compress``.

The pod axis is the slow link. Across pods each pod exchanges
int8-quantized partial gradients (blocks of 512, one fp32 scale a block)
and keeps an error-feedback residual, so compression noise is unbiased
over steps (Seide et al. / EF-SGD):

    q_t = Q(g_t + e_t);  e_{t+1} = (g_t + e_t) - dQ(q_t)

Here the pods are a one-process pod group: the ``n_pods`` copies of each
gradient leaf are stacked on one device, ``[n_pods, ...]``, and the ring's
shifts are ``ShardGroup.ppermute`` copies between them, so the group counts
the bytes of the int8 codes and scales that cross the slow link.
"""
from __future__ import annotations

import math

import torch

from ..core.shards import ShardGroup
from .adamw import is_leaf, tree_at, tree_paths

BLOCK = 512


def _quantize(x: torch.Tensor):
    """(codes int8 [n_blocks, BLOCK], scales [n_blocks, 1]) of the
    flattened ``x``; the scales keep ``x``'s dtype."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    blk = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = blk.abs().amax(dim=1, keepdim=True) / 127.0
    codes = torch.round(blk / torch.clamp(scale, min=1e-30)).to(torch.int8)
    return codes, scale


def _dequantize(codes: torch.Tensor, scale: torch.Tensor,
                shape) -> torch.Tensor:
    flat = (codes.to(torch.float32) * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def make_cross_pod_reduce(n_pods: int, enabled: bool = True, device=None):
    """``reduce(grads, err) -> (mean, new_err)`` over ``n_pods`` pods.

    Each leaf of ``grads`` and ``err`` is ``[n_pods, ...]``, pod ``i``'s
    copy at index ``i``; so is each leaf of the result, every pod holding
    its own sum of the dequantized parts over ``n_pods`` and its own
    quantization error. With ``enabled=False`` it is the plain mean (the
    baseline), and ``err`` comes back as it went in. The shifts go through
    ``reduce.group``, a :class:`ShardGroup` of ``n_pods`` shards named
    ``"pod"``, which counts their bytes."""
    group = ShardGroup(n_pods, device=device, name="pod")

    def dequantize_each(codes, scale, shape):
        return torch.stack([_dequantize(codes[i], scale[i], shape)
                            for i in range(n_pods)])

    def reduce_leaf(g: torch.Tensor, err: torch.Tensor):
        if g.shape[0] != n_pods:
            raise ValueError(f"a leaf of {g.shape[0]} copies for {n_pods} "
                             "pods")
        if not enabled:
            mean = group.psum(list(g), label="pmean") / n_pods
            return mean.expand_as(g).clone(), err
        acc = g + err
        shape = g.shape[1:]
        codes, scale = map(torch.stack, zip(*(_quantize(a) for a in acc)))
        total = dequantize_each(codes, scale, shape)
        new_err = acc - total  # own quantization error
        for shift in range(1, n_pods):
            perm = [(i, (i + shift) % n_pods) for i in range(n_pods)]
            c = group.ppermute(codes, perm, label=f"pod-codes[{shift}]")
            s = group.ppermute(scale, perm, label=f"pod-scales[{shift}]")
            total = total + dequantize_each(c, s, shape)
        return total / n_pods, new_err

    def reduce(grads, err):
        out = {path: reduce_leaf(g, tree_at(err, path))
               for path, g in tree_paths(grads)}
        return (tree_from_paths(grads, {p: r[0] for p, r in out.items()}),
                tree_from_paths(grads, {p: r[1] for p, r in out.items()}))

    reduce.group = group
    return reduce


def tree_from_paths(tree, by_path: dict, prefix=()):
    """``tree``'s structure with ``by_path[path]`` at each leaf's path."""
    if is_leaf(tree):
        return by_path[prefix]
    if isinstance(tree, dict):
        return {k: tree_from_paths(v, by_path, prefix + (k,))
                for k, v in tree.items()}
    return type(tree)(tree_from_paths(t, by_path, prefix + (i,))
                      for i, t in enumerate(tree))
