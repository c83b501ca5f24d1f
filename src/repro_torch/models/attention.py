"""GQA attention: the port of ``repro.models.attention``.

Train and prefill run ``chunked_attention``, an online softmax over KV
chunks (no ``S x S`` score tensor); ``decode_attention`` attends one token
against a flat KV cache. Scores and the weighted sum accumulate in fp32
from the operands' dtype, as the reference's ``preferred_element_type``
does: bf16 operands are widened to fp32 (``layers.up``) (their products are exact there)
and the probabilities rounded to the values' dtype before the sum. Plain
torch ops; no library attention kernel.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .layers import Linear, apply_rope, rms_head_norm, torch_dtype, up

NEG_INF = -1e30


class Attention(nn.Module):
    """``wq``, ``wk``, ``wv``, ``wo`` (``Linear``) and, with qk_norm,
    ``q_norm`` / ``k_norm`` ``[hd]`` scales."""

    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        d = cfg.d_model
        self.wq = Linear(d, cfg.q_dim, dtype, device, bias=cfg.qkv_bias)
        self.wk = Linear(d, cfg.kv_dim, dtype, device, bias=cfg.qkv_bias)
        self.wv = Linear(d, cfg.kv_dim, dtype, device, bias=cfg.qkv_bias)
        self.wo = Linear(cfg.q_dim, d, dtype, device)
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.empty(cfg.hd, dtype=dtype,
                                                   device=device))
            self.k_norm = nn.Parameter(torch.empty(cfg.hd, dtype=dtype,
                                                   device=device))
        else:
            self.q_norm = self.k_norm = None

    def reset_parameters(self, generator=None) -> None:
        if self.q_norm is not None:
            with torch.no_grad():
                self.q_norm.fill_(1.0)
                self.k_norm.fill_(1.0)


def _qkv(p: Attention, cfg, x: torch.Tensor, positions: torch.Tensor):
    B, S, _ = x.shape
    q = p.wq(x).reshape(B, S, cfg.n_heads, cfg.hd)
    k = p.wk(x).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = p.wv(x).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        q = rms_head_norm(p.q_norm, q)
        k = rms_head_norm(p.k_norm, k)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      chunk: int = 1024, group: int = 1) -> torch.Tensor:
    """Online-softmax attention over KV chunks.

    q [B,Sq,H,hd], k/v [B,Sk,Hkv,hd] with H = Hkv*group; queries sit at
    positions 0..Sq-1. Memory per step is O(Sq * chunk). ``window`` > 0
    restricts each query to keys in (pos-window, pos].
    """
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    chunk = min(chunk, Sk)
    n_chunks = -(-Sk // chunk)
    qg = up(q.reshape(B, Sq, Hkv, H // Hkv, hd))
    scale = float(1.0 / math.sqrt(hd))
    q_pos = torch.arange(Sq, device=q.device)
    w_lim = window if window > 0 else Sk + Sq + 2
    m = torch.full((B, Sq, Hkv, H // Hkv), NEG_INF, dtype=qg.dtype,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Sq, Hkv, H // Hkv, hd), dtype=qg.dtype,
                      device=q.device)
    for c in range(n_chunks):
        kb = k[:, c * chunk:(c + 1) * chunk]
        vb = v[:, c * chunk:(c + 1) * chunk]
        k_pos = c * chunk + torch.arange(kb.shape[1], device=q.device)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qg, up(kb)) * scale
        mask = k_pos[None, :] > q_pos[:, None] - w_lim
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        pr = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + pr.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqhgk,bkhd->bqhgd", up(pr.to(vb.dtype)), up(vb))
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def attention_block(p: Attention, cfg, x, positions, *, causal=True,
                    window=0, return_kv=False):
    """Full attention sublayer for train/prefill. x [B,S,d]."""
    q, k, v = _qkv(p, cfg, x, positions)
    group = cfg.n_heads // cfg.n_kv_heads
    out = chunked_attention(q, k, v, causal=causal, window=window,
                            group=group)
    B, S = x.shape[:2]
    y = p.wo(out.reshape(B, S, cfg.q_dim))
    if return_kv:
        return y, (k, v)
    return y


# ------------------------------------------------------------------ decode --

def init_kv_cache(cfg, batch: int, max_len: int, layers=None, dtype=None,
                  device=None) -> dict:
    """Zero flat caches ``k``/``v`` [L, B, max_len, Hkv, hd]."""
    L = layers if layers is not None else cfg.n_layers
    dt = torch_dtype(dtype or cfg.dtype)
    shape = (L, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def decode_attention(p: Attention, cfg, x, cache_k, cache_v, pos: int, *,
                     window: int = 0):
    """Single-token attention against a flat KV cache.

    x [B,1,d]; cache_k/v [B,Smax,Hkv,hd], written at ``pos`` in place;
    ``pos`` is the current index. Returns (out [B,1,d], cache_k, cache_v).
    """
    B = x.shape[0]
    pos = int(pos)
    q, k, v = _qkv(p, cfg, x, torch.full((1,), pos, device=x.device))
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    Smax = cache_k.shape[1]
    group = cfg.n_heads // cfg.n_kv_heads
    qg = up(q.reshape(B, 1, cfg.n_kv_heads, group, cfg.hd))
    scale = float(1.0 / math.sqrt(cfg.hd))
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg, up(cache_k)) * scale
    k_pos = torch.arange(Smax, device=x.device)
    w_lim = window if window > 0 else Smax + 2
    mask = (k_pos <= pos) & (k_pos > pos - w_lim)
    s = torch.where(mask[None, None, None, None, :], s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    out = torch.einsum("bqhgk,bkhd->bqhgd", up(pr.to(cache_v.dtype)),
                       up(cache_v))
    out = out.reshape(B, 1, cfg.q_dim).to(x.dtype)
    return p.wo(out), cache_k, cache_v
