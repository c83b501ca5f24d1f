"""Serving paths: prefill (build the decode state) and single-token decode.
The port of ``repro.models.decode``.

Decode caches are ring buffers: slot = pos % W with W = min(window, S_max)
for sliding-window layers and W = S_max for full-attention layers. The
absolute position of slot j at time pos is p_j = pos - ((pos - j) % W)
(a floor modulo: torch's ``%`` on tensors, never ``fmod``), which gives
the causal and sliding-window mask of both kinds with one formula.
RWKV6 and Mamba layers carry O(1) recurrent states instead.

The decode state is one dict per segment of stacked per-layer tensors of
the reference's shapes (``k``/``v`` ``[Ls, B, W, Hkv, hd]``; ``wkv``,
``x_tm``, ``x_cm``; ``ssm``, ``conv``). A decode step updates it in place
and returns it.
"""
from __future__ import annotations

import math

import torch

from . import moe as moe_mod
from . import ssm
from .attention import NEG_INF, _qkv
from .config import ModelConfig
from .layers import torch_dtype, unembed, up
from .transformer import lm_head_table, ring_width


# ----------------------------------------------------------- ring caches --

def ring_update(ck, cv, k, v, pos: int):
    """ck/cv [B,W,H,hd]; k/v [B,1,H,hd]; write slot pos % W in place."""
    slot = int(pos) % ck.shape[1]
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    return ck, cv


def ring_attend(cfg: ModelConfig, q, ck, cv, pos: int, window: int):
    """q [B,1,H,hd] (rope applied); returns attention output [B,1,q_dim]."""
    B = q.shape[0]
    W = ck.shape[1]
    group = cfg.n_heads // cfg.n_kv_heads
    qg = up(q.reshape(B, 1, cfg.n_kv_heads, group, cfg.hd))
    scale = float(1.0 / math.sqrt(cfg.hd))
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg, up(ck)) * scale
    j = torch.arange(W, device=q.device)
    p_j = pos - torch.remainder(pos - j, W)  # absolute position in slot j
    w_lim = window if window > 0 else W + pos + 2
    mask = (p_j >= 0) & (p_j <= pos) & (p_j > pos - w_lim)
    s = torch.where(mask[None, None, None, None, :], s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    out = torch.einsum("bqhgk,bkhd->bqhgd", pr, up(cv))
    return out.reshape(B, 1, cfg.q_dim).to(q.dtype)


def attn_decode(p, cfg: ModelConfig, x, ck, cv, pos: int, window: int):
    q, k, v = _qkv(p, cfg, x, torch.full((1,), pos, device=x.device))
    ck, cv = ring_update(ck, cv, k, v, pos)
    out = ring_attend(cfg, q, ck, cv, pos, window)
    return p.wo(out), ck, cv


# ------------------------------------------------------------ block paths --

def block_decode(lp, cfg: ModelConfig, x, st: dict, pos: int, window: int):
    """One layer, one token. ``st`` is this layer's state (views into the
    segment's stacked tensors), updated in place. Returns (x, st)."""
    if cfg.family == "ssm":
        xin = lp.norm1(x)
        y, wkv, x_tm = ssm.rwkv_time_mix(lp.time_mix, cfg, xin,
                                         state=st["wkv"], x_prev=st["x_tm"])
        x = x + y
        xin = lp.norm2(x)
        y, x_cm = ssm.rwkv_channel_mix(lp.channel_mix, cfg, xin,
                                       x_prev=st["x_cm"])
        st["wkv"].copy_(wkv)
        st["x_tm"].copy_(x_tm)
        st["x_cm"].copy_(x_cm)
        return x + y, st
    xin = lp.norm1(x)
    a, _, _ = attn_decode(lp.attn, cfg, xin, st["k"], st["v"], pos, window)
    if cfg.hybrid:
        m, h_ssm, conv = ssm.mamba_block(lp.mamba, cfg, xin, state=st["ssm"],
                                         conv_state=st["conv"])
        a = 0.5 * (lp.norm_attn(a) + lp.norm_mamba(m))
        st["ssm"].copy_(h_ssm)
        st["conv"].copy_(conv)
    x = x + a
    xin = lp.norm2(x)
    if cfg.n_experts:
        y = moe_mod.apply_moe_decode(lp.moe, cfg, xin)
    else:
        y = lp.mlp(xin)
    return x + y, st


# --------------------------------------------------------- state creation --

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                      device=None) -> list:
    """Zero decode state: one dict per homogeneous segment. Sliding-window
    segments hold rings of the window's size only. ``dtype`` (a torch
    dtype or a name; ``cfg.dtype`` by default) is that of the caches and
    the carried tokens; recurrent states are at least fp32."""
    dt = torch_dtype(dtype) if isinstance(dtype, str) else (
        dtype or torch_dtype(cfg.dtype))
    d = cfg.d_model
    f32 = torch.promote_types(dt, torch.float32)

    def z(shape, t=dt):
        return torch.zeros(shape, dtype=t, device=device)

    states = []
    for (a, b, w) in cfg.segments():
        Ls = b - a
        if cfg.family == "ssm":
            H = cfg.n_heads
            hd = d // H
            states.append({"wkv": z((Ls, batch, H, hd, hd), f32),
                           "x_tm": z((Ls, batch, d)),
                           "x_cm": z((Ls, batch, d))})
            continue
        W = ring_width(w, max_len)
        st = {"k": z((Ls, batch, W, cfg.n_kv_heads, cfg.hd)),
              "v": z((Ls, batch, W, cfg.n_kv_heads, cfg.hd))}
        if cfg.hybrid:
            st["ssm"] = z((Ls, batch, cfg.d_inner, cfg.ssm_state), f32)
            st["conv"] = z((Ls, batch, 3, cfg.d_inner))
        states.append(st)
    return states


# ------------------------------------------------------------ decode step --

def decode_step(params, cfg: ModelConfig, state: list, token, pos: int):
    """One new token for every sequence. token [B] (int); ``pos`` the
    tokens' position. Returns (logits [B, vocab], state), the state
    updated in place."""
    pos = int(pos)
    x = params.embed(token[:, None])  # [B,1,d]
    for (_, _, w), blocks, seg in zip(cfg.segments(), params.segments, state):
        for i, lp in enumerate(blocks):
            x, _ = block_decode(lp, cfg, x, {n: t[i] for n, t in seg.items()},
                                pos, w)
    h = params.final_norm(x)
    return unembed(lm_head_table(params, cfg), h[:, 0]), state


# ----------------------------------------------------------------- prefill --

def prefill(params, cfg: ModelConfig, batch, max_len: int):
    """Process a full prompt, returning (last-position logits, decode
    state): the train-path forward with each layer's state collected."""
    from .transformer import backbone_with_state

    return backbone_with_state(params, cfg, batch, max_len)
