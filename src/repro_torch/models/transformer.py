"""Model assembly for the architecture pool: the port of
``repro.models.transformer``.

The model is an ``nn.Module`` tree whose parameter names follow the
reference's tree paths: ``segments.{s}.{i}.attn.wq.w`` is layer ``i`` of
segment ``s`` (``cfg.segments()``), the reference's
``params["segments"][s]["attn"]["wq"]["w"][i]`` (its layers are stacked
along a leading axis, and looped with ``lax.scan``; here the layer loop
is plain Python). Training takes its gradients through autograd
(``steps.make_train_step``); with ``cfg.remat`` each block and each CE
chunk is checkpointed, as the reference's are.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import attention as attn
from . import moe as moe_mod
from . import ssm
from .config import ModelConfig
from .layers import MLP, Embed, Linear, Norm, torch_dtype, unembed


# ------------------------------------------------------------------ blocks --

class Block(nn.Module):
    """One layer. RWKV6: ``norm1``, ``time_mix``, ``norm2``,
    ``channel_mix``. Otherwise ``norm1``, ``attn`` (with ``mamba``,
    ``norm_attn`` and ``norm_mamba`` in the hybrid), ``norm2`` and ``moe``
    or ``mlp``."""

    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        d = cfg.d_model
        self.norm1 = Norm(d, cfg.norm, dtype, device)
        if cfg.family == "ssm":  # rwkv6
            self.time_mix = ssm.RWKVTimeMix(cfg, dtype, device)
            self.norm2 = Norm(d, cfg.norm, dtype, device)
            self.channel_mix = ssm.RWKVChannelMix(cfg, dtype, device)
            return
        self.attn = attn.Attention(cfg, dtype, device)
        if cfg.hybrid:
            self.mamba = ssm.Mamba(cfg, dtype, device)
            self.norm_attn = Norm(d, cfg.norm, dtype, device)
            self.norm_mamba = Norm(d, cfg.norm, dtype, device)
        self.norm2 = Norm(d, cfg.norm, dtype, device)
        if cfg.n_experts:
            self.moe = moe_mod.MoE(cfg, dtype, device)
        else:
            self.mlp = MLP(d, cfg.d_ff, cfg.activation, dtype, device)


def block_forward(p: Block, cfg: ModelConfig, x, positions, *, window,
                  causal=True, collect=False, capacity_factor=1.25):
    """One layer, train/prefill path. Returns (x, aux_loss, state|None).

    With ``collect=True`` the layer's decode state is returned too: the
    keys and values ``kv`` (and Mamba's ``ssm``/``conv``), or RWKV6's
    ``wkv``, ``x_tm`` and ``x_cm``. ``capacity_factor`` sizes the MoE
    buffers (the reference's default; ``n_experts / top_k`` drops none).
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        h, wkv, x_tm = ssm.rwkv_time_mix(p.time_mix, cfg, p.norm1(x))
        x = x + h
        h, x_cm = ssm.rwkv_channel_mix(p.channel_mix, cfg, p.norm2(x))
        st = {"wkv": wkv, "x_tm": x_tm, "x_cm": x_cm} if collect else None
        return x + h, aux, st
    xin = p.norm1(x)
    a = attn.attention_block(p.attn, cfg, xin, positions, causal=causal,
                             window=window, return_kv=collect)
    st = None
    if collect:
        a, kv = a
        st = {"kv": kv}
    if cfg.hybrid:
        m, h_ssm, conv = ssm.mamba_block(p.mamba, cfg, xin)
        a = 0.5 * (p.norm_attn(a) + p.norm_mamba(m))
        if collect:
            st["ssm"], st["conv"] = h_ssm, conv
    x = x + a
    xin = p.norm2(x)
    if cfg.n_experts:
        y, aux = moe_mod.apply_moe(p.moe, cfg, xin,
                                   capacity_factor=capacity_factor)
    else:
        y = p.mlp(xin)
    return x + y, aux, st


# ------------------------------------------------------------------ model --

class LMModel(nn.Module):
    """``frontend`` (audio/VLM stub: a linear feature projection),
    ``embed``, ``segments`` (one ``ModuleList`` of ``Block`` per segment),
    ``final_norm`` and, untied, ``lm_head``."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        dt = dtype or torch_dtype(cfg.dtype)
        if cfg.embed_inputs:
            self.frontend = Linear(cfg.frontend_dim, cfg.d_model, dt, device)
        if cfg.vocab:
            self.embed = Embed(cfg.vocab, cfg.d_model, dt, device)
        self.segments = nn.ModuleList(
            nn.ModuleList(Block(cfg, dt, device) for _ in range(b - a))
            for a, b, _ in cfg.segments())
        self.final_norm = Norm(cfg.d_model, cfg.norm, dt, device)
        if cfg.vocab and not cfg.tie_embeddings:
            self.lm_head = Embed(cfg.vocab, cfg.d_model, dt, device)


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None, dtype=None) -> LMModel:
    """A model with the reference's initial distributions, drawn from
    ``generator`` (a fresh one seeded 0 on ``device`` when None): linear
    weights N(0, 1/fan_in), embedding tables N(0, 0.02²), norm scales 1,
    biases 0, and the RWKV6 and Mamba constants. The draws are not JAX's:
    to hold the port to the reference, carry its weights across with
    ``convert.lm_params_from_arrays``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = LMModel(cfg, device=dev, dtype=dtype)
    for m in model.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator)
    return model


def backbone(params: LMModel, cfg: ModelConfig, x, positions, *, causal=True,
             capacity_factor=1.25):
    """Run all layers on embedded input x [B,S,d]. Returns (h, aux_loss).

    With ``cfg.remat`` and grad enabled each block is checkpointed (its
    activations recomputed in backward), as the reference's scan body is:
    the memory changes, not the values."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for (_, _, w), blocks in zip(cfg.segments(), params.segments):
        for lp in blocks:
            def run(xx, lp=lp, w=w):
                return block_forward(lp, cfg, xx, positions, window=w,
                                     causal=causal,
                                     capacity_factor=capacity_factor)[:2]
            x, al = (checkpoint(run, x, use_reentrant=False) if remat
                     else run(x))
            aux = aux + al
    return params.final_norm(x), aux


def ring_width(w: int, max_len: int) -> int:
    """Ring depth of a segment: its window (at most ``max_len``), or
    ``max_len`` for full attention."""
    return min(w, max_len) if w > 0 else max_len


def _ring_place(ring: torch.Tensor, k: torch.Tensor) -> None:
    """Scatter the last W positions of k [B, S, H, hd] into ``ring``
    [B, W, H, hd] at slots pos % W, decode's ring addressing."""
    W, S = ring.shape[1], k.shape[1]
    take = min(W, S)
    slots = torch.arange(S - take, S, device=k.device) % W
    ring.index_copy_(1, slots, k[:, S - take:].to(ring.dtype))


def backbone_with_state(params: LMModel, cfg: ModelConfig, batch,
                        max_len: int, *, capacity_factor=1.25):
    """Prefill: full-sequence forward that also builds the decode state.
    Returns (last-position logits [B, vocab], decode state: one dict of
    stacked per-layer tensors per segment, ``decode.init_decode_state``'s
    shapes)."""
    from .decode import init_decode_state

    x, positions, _, _ = embed_batch(params, cfg, batch)
    B = x.shape[0]
    states = init_decode_state(cfg, B, max_len, dtype=x.dtype,
                               device=x.device)
    for (_, _, w), blocks, seg in zip(cfg.segments(), params.segments,
                                      states):
        for i, lp in enumerate(blocks):
            x, _, st = block_forward(lp, cfg, x, positions, window=w,
                                     causal=True, collect=True,
                                     capacity_factor=capacity_factor)
            if cfg.family != "ssm":
                k, v = st.pop("kv")
                _ring_place(seg["k"][i], k)
                _ring_place(seg["v"][i], v)
            for name, val in st.items():
                seg[name][i].copy_(val)
    h = params.final_norm(x)
    logits = unembed(lm_head_table(params, cfg), h[:, -1])
    return logits, states


def embed_batch(params: LMModel, cfg: ModelConfig, batch):
    """Map a batch dict to (x [B,S,d], positions [S], labels/None,
    mask/None)."""
    if cfg.family == "audio":
        x = params.frontend(batch["features"])
        if "mask" in batch:  # masked prediction: zero the masked frames
            x = torch.where(batch["mask"][..., None], 0.0, x)
        S = x.shape[1]
        return (x, torch.arange(S, device=x.device), batch.get("labels"),
                batch.get("mask"))
    if cfg.family == "vlm":
        tx = params.embed(batch["tokens"])
        px = params.frontend(batch["patches"])
        x = torch.cat([px, tx], dim=1)
        return x, torch.arange(x.shape[1], device=x.device), \
            batch.get("labels"), None
    x = params.embed(batch["tokens"])
    return x, torch.arange(x.shape[1], device=x.device), \
        batch.get("labels"), None


def lm_head_table(params: LMModel, cfg: ModelConfig) -> torch.Tensor:
    return (params.embed if cfg.tie_embeddings else params.lm_head).table


def chunked_ce_loss(table, h, labels, chunk: int, mask=None):
    """Cross-entropy without materializing [B,S,V]: a loop over S chunks.

    ``mask`` selects positions contributing to the loss (audio masked
    prediction); None means all positions with label >= 0.
    """
    S = h.shape[1]
    chunk = min(chunk, S)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.int64, device=h.device)
    remat = torch.is_grad_enabled()  # the reference checkpoints every chunk
    for c in range(0, S, chunk):
        lc = labels[:, c:c + chunk].long()
        valid = lc >= 0
        if mask is not None:
            valid = valid & mask[:, c:c + chunk]
        hc = h[:, c:c + chunk]
        part = (checkpoint(_ce_chunk, table, hc, lc, valid,
                           use_reentrant=False) if remat
                else _ce_chunk(table, hc, lc, valid))
        tot = tot + part
        cnt = cnt + valid.sum()
    return tot / torch.clamp(cnt, min=1)


def _ce_chunk(table, hc, lc, valid):
    """The summed CE of one chunk, its logits [B,C,V] in fp32."""
    logits = (hc @ table.T).float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, torch.clamp(lc, min=0)[..., None])[..., 0]
    return torch.where(valid, logz - ll, 0.0).sum()


def loss_fn(params: LMModel, cfg: ModelConfig, batch):
    x, positions, labels, mask = embed_batch(params, cfg, batch)
    h, aux = backbone(params, cfg, x, positions, causal=not cfg.encoder_only)
    if cfg.family == "vlm":  # loss only over the text region
        h = h[:, batch["patches"].shape[1]:]
    ce = chunked_ce_loss(lm_head_table(params, cfg), h, labels,
                         cfg.loss_chunk, mask)
    return ce + aux, {"ce": ce, "aux": aux}
