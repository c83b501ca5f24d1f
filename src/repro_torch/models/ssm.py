"""State-space and linear-recurrence blocks: RWKV6 (Finch) and the
Mamba-style selective SSM of the Hymba hybrid. The port of
``repro.models.ssm``.

Prefill runs RWKV6's WKV chunk-parallel where the length allows and the
per-token recurrence otherwise (and at decode); Mamba runs its recurrence
token by token with the per-token factors formed for the whole sequence
(one fused multiply-add a step). Decode threads O(1) per-layer
states: the WKV state ``[B, H, hd, hd]`` and the last token of each mix
for RWKV6, the SSM state ``[B, d_inner, N]`` and the convolution's last
three inputs ``[B, 3, d_inner]`` for Mamba.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import normal_, up

# =========================================================== RWKV6 (Finch) ==

LORA_R = 32
DECAY_LORA_R = 64


def _params(module: nn.Module, dtype, device, shapes: dict) -> None:
    for name, shape in shapes.items():
        setattr(module, name, nn.Parameter(torch.empty(shape, dtype=dtype,
                                                       device=device)))


class RWKVTimeMix(nn.Module):
    """The time-mix parameters: token-shift mixes ``mu_x``, ``mu`` (r, w,
    k, v, g) and their LoRA ``lora_A``/``lora_B``, the decay ``w0``,
    ``wA``, ``wB``, projections ``Wr``, ``Wk``, ``Wv``, ``Wg``, ``Wo``, the
    per-head bonus ``u`` and the group norm's ``ln_scale``."""

    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        d, H = cfg.d_model, cfg.n_heads
        _params(self, dtype, device, {
            "mu_x": (d,), "mu": (5, d), "lora_A": (d, 5 * LORA_R),
            "lora_B": (5, LORA_R, d), "w0": (d,), "wA": (d, DECAY_LORA_R),
            "wB": (DECAY_LORA_R, d), "Wr": (d, d), "Wk": (d, d),
            "Wv": (d, d), "Wg": (d, d), "Wo": (d, d), "u": (H, d // H),
            "ln_scale": (d,)})

    def reset_parameters(self, generator=None) -> None:
        d = self.Wr.shape[0]
        with torch.no_grad():
            self.mu_x.zero_()
            self.mu.zero_()
            self.w0.fill_(-6.0)  # slow decay
            self.ln_scale.fill_(1.0)
        normal_(self.lora_A, 1.0 / math.sqrt(d), generator)
        normal_(self.lora_B, 1.0 / math.sqrt(LORA_R), generator)
        normal_(self.wA, 1.0 / math.sqrt(d), generator)
        normal_(self.wB, 0.1 / math.sqrt(DECAY_LORA_R), generator)
        for w in (self.Wr, self.Wk, self.Wv, self.Wg, self.Wo):
            normal_(w, 1.0 / math.sqrt(d), generator)
        normal_(self.u, 1.0 / math.sqrt(self.u.shape[1]), generator)


def _rwkv_mix(p: RWKVTimeMix, x, x_shift):
    """Data-dependent token-shift interpolation (5 projections)."""
    xx = x_shift - x
    xxx = x + xx * p.mu_x
    m = torch.tanh(xxx @ p.lora_A)  # [B,S,5R]
    B, S = x.shape[:2]
    m = m.reshape(B, S, 5, LORA_R)
    delta = torch.einsum("bsfr,frd->bsfd", m, p.lora_B)  # [B,S,5,d]
    mixed = x[:, :, None, :] + xx[:, :, None, :] * (p.mu[None, None] + delta)
    return [mixed[:, :, i] for i in range(5)]  # r, w, k, v, g inputs


def _rwkv_decay(p: RWKVTimeMix, xw):
    """Data-dependent per-channel decay w in (0, 1)."""
    ww = up(p.w0) + up(torch.tanh(xw @ p.wA)) @ up(p.wB)
    return torch.exp(-torch.exp(ww))  # [B,S,d]


def _wkv_scan(r, k, v, w, u, state):
    """Per-token recurrence. r/k/v/w [B,S,H,hd] fp32, state [B,H,hd,hd]."""
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # [B,H,hd,hd]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               state + u[None, :, :, None] * kv))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(ys, dim=1), state


_EXP_CLAMP = 30.0  # bounds exp(-L_s); pairs beyond it contribute < e^-30


def _wkv_chunked(r, k, v, w, u, state, chunk: int):
    """Chunk-parallel WKV6. Within a chunk of C tokens the recurrence is
    matmuls:

      y_t = A_t @ S_0 + strict_tril(A B^T) V + diag(r·u·k) V,
      A_t = r_t * exp(L_{t-1}),  B_s = k_s * exp(-L_s),
      L_t = sum_{u<=t} log w_u,

    and the state crosses chunk boundaries only: S -> exp(L_C)*(S + B^T V).
    exp(-L_s) is clamped at e^30, where the true weight exp(L_t - L_s) of a
    pair is below fp32's resolution of the sum.
    """
    B, S, H, hd = r.shape
    C = chunk
    n = S // C
    rc = r.reshape(B, n, C, H, hd)
    kc = k.reshape(B, n, C, H, hd)
    vc = v.reshape(B, n, C, H, hd)
    logw = torch.log(torch.clamp(w, min=1e-38)).reshape(B, n, C, H, hd)
    L = torch.cumsum(logw, dim=2)  # L_t, inclusive
    Lm1 = L - logw  # L_{t-1}
    A = rc * torch.exp(Lm1)
    Bm = kc * torch.exp(torch.clamp(-L, max=_EXP_CLAMP))
    scores = torch.einsum("bnthk,bnshk->bnhts", A, Bm)  # [B,n,H,C,C]
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device), -1)
    scores = torch.where(tri, scores, 0.0)
    bonus = torch.einsum("bnthk,bnthk->bnth", rc, u * kc)
    intra = (torch.einsum("bnhts,bnshv->bnthv", scores, vc)
             + bonus[..., None] * vc)
    decay_tot = torch.exp(L[:, :, -1])  # [B,n,H,hd]
    kTv = torch.einsum("bnshk,bnshv->bnhkv", Bm, vc)  # [B,n,H,hd,hd]
    y0 = []
    for i in range(n):  # the cross-chunk state pass, sequential over n
        y0.append(torch.einsum("bthk,bhkv->bthv", A[:, i], state))
        state = decay_tot[:, i, :, :, None] * (state + kTv[:, i])
    y = intra + torch.stack(y0, dim=1)
    return y.reshape(B, S, H, hd), state


def rwkv_time_mix(p: RWKVTimeMix, cfg, x, *, state=None, x_prev=None):
    """x [B,S,d]; state [B,H,hd,hd] WKV state; x_prev [B,d] last token.
    Returns (y, new_state, new_x_prev)."""
    B, S, d = x.shape
    H = cfg.n_heads
    hd = d // H
    if x_prev is None:
        x_prev = x.new_zeros((B, d))
    x_shift = torch.cat([x_prev[:, None], x[:, :-1]], dim=1)
    xr, xw, xk, xv, xg = _rwkv_mix(p, x, x_shift)
    r = (xr @ p.Wr).reshape(B, S, H, hd)
    k = (xk @ p.Wk).reshape(B, S, H, hd)
    v = (xv @ p.Wv).reshape(B, S, H, hd)
    g = F.silu(xg @ p.Wg)
    w = _rwkv_decay(p, xw).reshape(B, S, H, hd)
    u = up(p.u)
    if state is None:
        state = torch.zeros((B, H, hd, hd), dtype=u.dtype, device=x.device)
    args = (up(r), up(k), up(v), up(w))
    C = cfg.ssm_chunk
    if C and S % C == 0 and S > C:
        ys, state = _wkv_chunked(*args, u, state, C)
    else:
        ys, state = _wkv_scan(*args, u, state)
    # group norm over each head, then the gate
    yf = ys.reshape(B, S, H, hd)
    mu = yf.mean(dim=-1, keepdim=True)
    var = torch.square(yf - mu).mean(dim=-1, keepdim=True)
    yf = (yf - mu) * torch.rsqrt(var + 1e-5)
    y = (yf.reshape(B, S, d) * up(p.ln_scale)).to(x.dtype)
    y = (y * g.to(y.dtype)) @ p.Wo
    return y, state, x[:, -1]


class RWKVChannelMix(nn.Module):
    """The channel-mix parameters: ``mu_k``, ``mu_r``, ``Wk`` [d, ff],
    ``Wv`` [ff, d], ``Wr`` [d, d]."""

    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        _params(self, dtype, device, {"mu_k": (d,), "mu_r": (d,),
                                      "Wk": (d, ff), "Wv": (ff, d),
                                      "Wr": (d, d)})

    def reset_parameters(self, generator=None) -> None:
        d, ff = self.Wk.shape
        with torch.no_grad():
            self.mu_k.zero_()
            self.mu_r.zero_()
        normal_(self.Wk, 1.0 / math.sqrt(d), generator)
        normal_(self.Wv, 1.0 / math.sqrt(ff), generator)
        normal_(self.Wr, 1.0 / math.sqrt(d), generator)


def rwkv_channel_mix(p: RWKVChannelMix, cfg, x, *, x_prev=None):
    B, S, d = x.shape
    if x_prev is None:
        x_prev = x.new_zeros((B, d))
    x_shift = torch.cat([x_prev[:, None], x[:, :-1]], dim=1)
    xx = x_shift - x
    xk = x + xx * p.mu_k
    xr = x + xx * p.mu_r
    kk = torch.square(F.relu(xk @ p.Wk))
    y = torch.sigmoid(xr @ p.Wr) * (kk @ p.Wv)
    return y, x[:, -1]


# ==================================================== Mamba selective SSM ==

class Mamba(nn.Module):
    """``in_proj`` [d, 2·di], the depthwise causal conv ``conv_w`` [4, di],
    ``x_proj``, ``dt_proj``, ``dt_bias``, ``A_log`` [di, N] and ``D``
    [di] (both fp32), ``out_proj``."""

    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
        dt_rank = max(d // 16, 1)
        _params(self, dtype, device, {
            "in_proj": (d, 2 * di), "conv_w": (4, di),
            "x_proj": (di, dt_rank + 2 * N), "dt_proj": (dt_rank, di),
            "dt_bias": (di,), "out_proj": (di, d)})
        _params(self, torch.float32, device, {"A_log": (di, N), "D": (di,)})

    def reset_parameters(self, generator=None) -> None:
        d, di = self.in_proj.shape[0], self.conv_w.shape[1]
        N = self.A_log.shape[1]
        dt_rank = self.dt_proj.shape[0]
        normal_(self.in_proj, 1.0 / math.sqrt(d), generator)
        normal_(self.conv_w, 1.0 / math.sqrt(4), generator)
        normal_(self.x_proj, 1.0 / math.sqrt(di), generator)
        normal_(self.dt_proj, 1.0 / math.sqrt(dt_rank), generator)
        normal_(self.out_proj, 1.0 / math.sqrt(di), generator)
        with torch.no_grad():
            self.dt_bias.zero_()
            n = torch.arange(1, N + 1, dtype=torch.float32,
                             device=self.A_log.device)
            self.A_log.copy_(torch.log(n)[None, :].expand(di, N))
            self.D.fill_(1.0)


def _mamba_scan(A, dt, Bv, Cv, xv, state):
    """h_t = exp(dt_t·A) h_{t-1} + dt_t·x_t·B_t ; y_t = C_t·h_t.

    dt, xv [B,S,di]; Bv, Cv [B,S,N] (fp32); A [di,N]; state [B,di,N].
    Returns (y [B,S,di], final state). The per-step factors are formed
    for the whole sequence at once; the recurrence is then one fused
    multiply-add a step."""
    dA = torch.exp(dt[..., None] * A)  # [B,S,di,N]
    dBx = (dt * xv)[..., None] * Bv[:, :, None, :]  # [B,S,di,N]
    hs = []
    h = state
    for a_t, b_t in zip(dA.unbind(1), dBx.unbind(1)):
        h = torch.addcmul(b_t, a_t, h)
        hs.append(h)
    return torch.einsum("bsdn,bsn->bsd", torch.stack(hs, dim=1), Cv), h


def mamba_block(p: Mamba, cfg, x, *, state=None, conv_state=None):
    """x [B,S,d] -> (y, ssm_state [B,di,N], conv_state [B,3,di])."""
    B, S, d = x.shape
    di = cfg.d_inner
    N = cfg.ssm_state
    dt_rank = p.dt_proj.shape[0]
    xz = x @ p.in_proj
    xs, z = xz.chunk(2, dim=-1)  # [B,S,di]
    # causal depthwise conv (kernel 4), spelt as the reference's sum
    if conv_state is None:
        conv_state = xs.new_zeros((B, 3, di))
    xpad = torch.cat([conv_state, xs], dim=1)  # [B,S+3,di]
    w = p.conv_w.to(xs.dtype)
    xc = (xpad[:, 0:S] * w[0] + xpad[:, 1:S + 1] * w[1]
          + xpad[:, 2:S + 2] * w[2] + xpad[:, 3:S + 3] * w[3])
    xc = F.silu(xc)
    proj = xc @ p.x_proj  # [B,S,dt_rank+2N]
    dt_in, Bv, Cv = torch.split(proj, [dt_rank, N, N], dim=-1)
    dt = up(F.softplus(dt_in @ p.dt_proj + p.dt_bias))
    A = -torch.exp(p.A_log)  # [di,N]
    if state is None:
        state = torch.zeros((B, di, N), dtype=dt.dtype, device=x.device)
    y, state = _mamba_scan(A, dt, up(Bv), up(Cv), up(xc), state)
    y = y + up(xc) * p.D
    y = (y.to(x.dtype) * F.silu(z)) @ p.out_proj
    return y, state, xpad[:, -3:]
