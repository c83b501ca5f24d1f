"""Shared neural-net primitives: the port of ``repro.models.layers``.

Each parameter container of the reference's tree is an ``nn.Module`` whose
parameters carry the reference's leaf names and shapes (a linear layer's
``w`` is ``[d_in, d_out]`` and computes ``x @ w``), so the reference's
arrays load leaf for leaf. Norms and RoPE compute in fp32 (``up``: at
least fp32, so an fp64 model stays fp64) and round back to the input's
dtype, as the reference does. Modules are built empty;
``reset_parameters(generator)`` draws the reference's distributions.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def torch_dtype(name: str) -> torch.dtype:
    """``cfg.dtype`` ("bfloat16", "float32", ...) as a torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def up(x: torch.Tensor) -> torch.Tensor:
    """``x`` in at least fp32: bf16 widened, fp32 and fp64 as they are
    (the reference's ``astype(float32)`` on its own dtypes)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def normal_(t: torch.Tensor, std: float, generator) -> torch.Tensor:
    """Fill ``t`` with N(0, std²) draws from ``generator``, in place."""
    with torch.no_grad():
        return t.normal_(0.0, std, generator=generator)


def activation(x: torch.Tensor, name: str) -> torch.Tensor:
    """The MLP nonlinearity; ``gelu`` is the tanh form, ``jax.nn.gelu``'s
    default."""
    if name == "swiglu":
        raise ValueError("swiglu gates two projections; see MLP")
    if name == "squared_relu":
        return torch.square(F.relu(x))
    return F.gelu(x, approximate="tanh")


# ------------------------------------------------------------------ norms --

class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale``, ``bias``) over the last
    axis, in at least fp32."""

    def __init__(self, d: int, kind: str, dtype, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(d, dtype=dtype, device=device))
        if kind == "layernorm":
            self.bias = nn.Parameter(torch.empty(d, dtype=dtype, device=device))
        else:
            self.bias = None

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        xf = up(x)
        if self.bias is not None:
            mu = xf.mean(dim=-1, keepdim=True)
            var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
            y = (xf - mu) * torch.rsqrt(var + eps)
            return (y * up(self.scale) + up(self.bias)).to(x.dtype)
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps)
        return (y * up(self.scale)).to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS norm (qk_norm), x [..., H, hd]."""
    xf = up(x)
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * up(scale)).to(x.dtype)


# ----------------------------------------------------------------- linear --

class Linear(nn.Module):
    """``y = x @ w (+ b)`` with ``w [d_in, d_out]``, drawn N(0, 1/d_in)."""

    def __init__(self, d_in: int, d_out: int, dtype, device=None,
                 bias: bool = False):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_in, d_out, dtype=dtype,
                                          device=device))
        self.b = (nn.Parameter(torch.empty(d_out, dtype=dtype, device=device))
                  if bias else None)

    def reset_parameters(self, generator=None) -> None:
        normal_(self.w, 1.0 / math.sqrt(self.w.shape[0]), generator)
        if self.b is not None:
            with torch.no_grad():
                self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w
        if self.b is not None:
            y = y + self.b
        return y


# ----------------------------------------------------------------- rotary --

def rope_freqs(hd: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))


@functools.lru_cache(maxsize=32)
def _rope_freqs_on(hd: int, theta: float, device: torch.device):
    """``rope_freqs`` as fp32 on ``device``, copied there once (a copy
    from host memory waits for the device)."""
    return torch.as_tensor(rope_freqs(hd, theta), dtype=torch.float32,
                           device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [..., S, H, hd] rotated at ``positions`` [S] (halves, not pairs)."""
    hd = x.shape[-1]
    freqs = _rope_freqs_on(hd, float(theta), x.device)
    ang = positions[..., None].float() * freqs  # [S, hd/2]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = up(x).chunk(2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ------------------------------------------------------------------- MLPs --

class MLP(nn.Module):
    """SwiGLU (``gate``, ``up``, ``down``) or a plain two-layer MLP
    (``up``, ``down``) with squared ReLU or tanh-GELU."""

    def __init__(self, d: int, d_ff: int, act: str, dtype, device=None):
        super().__init__()
        self.act = act
        if act == "swiglu":
            self.gate = Linear(d, d_ff, dtype, device)
        self.up = Linear(d, d_ff, dtype, device)
        self.down = Linear(d_ff, d, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.act == "swiglu":
            h = F.silu(self.gate(x)) * self.up(x)
        else:
            h = activation(self.up(x), self.act)
        return self.down(h)


# -------------------------------------------------------------- embedding --

class Embed(nn.Module):
    """A ``[vocab, d]`` table, drawn N(0, 0.02²): rows by token, and the
    output logits ``x @ table.T``."""

    def __init__(self, vocab: int, d: int, dtype, device=None):
        super().__init__()
        self.table = nn.Parameter(torch.empty(vocab, d, dtype=dtype,
                                              device=device))

    def reset_parameters(self, generator=None) -> None:
        normal_(self.table, 0.02, generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.table[tokens]


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Logits via the (tied or separate) output table [vocab, d]."""
    return x @ table.T
