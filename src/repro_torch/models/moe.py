"""Mixture-of-experts layer with capacity-based dispatch: the port of
``repro.models.moe``.

Prefill and train dispatch tokens into per-expert buffers of a fixed
capacity within each group of tokens (a group is one sequence of the
batch, up to 32 groups), run every expert over its buffer in one batched
product and combine the results back; decode evaluates each token's
``top_k`` experts directly from gathered weight slices.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import MLP, activation, normal_, up


class Experts(nn.Module):
    """Stacked expert weights: ``gate``/``up`` [E, d, ff] (``gate`` only
    for SwiGLU) and ``down`` [E, ff, d]."""

    def __init__(self, E: int, d: int, ff: int, act: str, dtype, device=None):
        super().__init__()
        self.act = act
        self.gate = (nn.Parameter(torch.empty(E, d, ff, dtype=dtype,
                                              device=device))
                     if act == "swiglu" else None)
        self.up = nn.Parameter(torch.empty(E, d, ff, dtype=dtype,
                                           device=device))
        self.down = nn.Parameter(torch.empty(E, ff, d, dtype=dtype,
                                             device=device))

    def reset_parameters(self, generator=None) -> None:
        d, ff = self.up.shape[1], self.up.shape[2]
        if self.gate is not None:
            normal_(self.gate, 1.0 / math.sqrt(d), generator)
        normal_(self.up, 1.0 / math.sqrt(d), generator)
        normal_(self.down, 1.0 / math.sqrt(ff), generator)


class MoE(nn.Module):
    """``router`` [d, E], ``experts`` and, for arctic's dense residual, a
    ``dense`` MLP beside them."""

    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        d, E = cfg.d_model, cfg.n_experts
        self.router = nn.Parameter(torch.empty(d, E, dtype=dtype,
                                               device=device))
        self.experts = Experts(E, d, cfg.d_ff, cfg.activation, dtype, device)
        self.dense = (MLP(d, cfg.dense_d_ff or cfg.d_ff, cfg.activation, dtype,
                          device) if cfg.dense_residual else None)

    def reset_parameters(self, generator=None) -> None:
        normal_(self.router, 1.0 / math.sqrt(self.router.shape[0]), generator)


def _ffn(pe: Experts, h_in, eq_in: str, eq_out: str) -> torch.Tensor:
    """The experts' FFN over a buffer, batched by ``eq_in`` (input · w1)
    and ``eq_out`` (hidden · down)."""
    if pe.act == "swiglu":
        h = F.silu(torch.einsum(eq_in, h_in, pe.gate))
        h = h * torch.einsum(eq_in, h_in, pe.up)
    else:
        h = activation(torch.einsum(eq_in, h_in, pe.up), pe.act)
    return torch.einsum(eq_out, h, pe.down)


def route(p: MoE, cfg, xt: torch.Tensor):
    """Router logits (at least fp32), the ``top_k`` experts of each token
    and their softmax gates: ``(logits, gates, idx)``, ``xt [..., d]``."""
    logits = up(xt @ p.router)
    top, idx = torch.topk(logits, cfg.top_k, dim=-1)
    return logits, torch.softmax(top, dim=-1), idx


def apply_moe(p: MoE, cfg, x: torch.Tensor, capacity_factor: float = 1.25,
              n_groups: int | None = None):
    """x [B,S,d] -> ([B,S,d], aux_loss).

    Group-local dispatch: every position count (the cumulative sum over
    the one-hot assignment) is within a group. A (token, slot) past an
    expert's capacity ``Cg`` lands in the spare slot ``Cg`` of a
    ``Cg + 1``-deep buffer and contributes nothing (a dropped token).
    """
    B, S, d = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.top_k
    G = n_groups or min(B, 32)
    Tg = T // G
    xt = x.reshape(G, Tg, d)
    logits, gates, idx = route(p, cfg, xt)  # [G,Tg,E], [G,Tg,k] x2

    # load-balancing auxiliary loss (Switch-style)
    probs = torch.softmax(logits, dim=-1)
    frac_tokens = F.one_hot(idx, E).float().sum(dim=2).mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac_tokens * frac_probs)

    Cg = max(int(Tg * k / E * capacity_factor), 1)
    flat_e = idx.reshape(G, Tg * k)  # expert of each (token, slot)
    oh = F.one_hot(flat_e, E)  # [G, Tg*k, E]
    pos_all = torch.cumsum(oh, dim=1) - oh  # group-local prefix sums
    pos = torch.gather(pos_all, 2, flat_e[..., None])[..., 0]
    keep = pos < Cg
    pos_c = torch.where(keep, pos, Cg)

    src = torch.repeat_interleave(xt, k, dim=1)  # [G, Tg*k, d]
    buf = torch.zeros((G, E, Cg + 1, d), dtype=x.dtype, device=x.device)
    gidx = torch.arange(G, device=x.device)[:, None].expand_as(flat_e)
    buf.index_put_((gidx, flat_e, pos_c), src, accumulate=True)
    out_buf = _ffn(p.experts, buf[:, :, :Cg], "gecd,edf->gecf",
                   "gecf,efd->gecd")
    out_buf = torch.cat([out_buf, out_buf.new_zeros((G, E, 1, d))], dim=2)
    gathered = out_buf[gidx, flat_e, pos_c]  # [G, Tg*k, d]
    w = (gates.reshape(G, Tg * k) * keep).to(x.dtype)
    y = (gathered * w[..., None]).reshape(G, Tg, k, d).sum(dim=2)
    y = y.reshape(B, S, d)
    if p.dense is not None:
        y = y + p.dense(x)
    return y, aux * cfg.router_aux_coef


def apply_moe_decode(p: MoE, cfg, x: torch.Tensor) -> torch.Tensor:
    """Single-token MoE (decode): each token's ``top_k`` experts from
    gathered weight slices (``[B, k, d, ff]`` each), no capacity buffers.
    """
    B, _, d = x.shape
    xt = x.reshape(B, d)
    _, gates, idx = route(p, cfg, xt)  # [B, k]
    pe = p.experts
    if pe.act == "swiglu":
        h = F.silu(torch.einsum("bd,bkdf->bkf", xt, pe.gate[idx]))
        h = h * torch.einsum("bd,bkdf->bkf", xt, pe.up[idx])
    else:
        h = activation(torch.einsum("bd,bkdf->bkf", xt, pe.up[idx]), pe.act)
    y = torch.einsum("bkf,bkfd->bkd", h, pe.down[idx])
    y = (y * gates[..., None].to(y.dtype)).sum(dim=1).reshape(B, 1, d)
    if p.dense is not None:
        y = y + p.dense(x)
    return y
