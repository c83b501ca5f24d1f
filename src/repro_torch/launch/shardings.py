"""PartitionSpec rules: where each leaf of the parameters, the optimizer
state, a batch and a decode state lies on the production mesh.

The port's counterpart of ``repro/launch/shardings.py``, with the same
rules over the mesh's shape alone (``launch/mesh.py``): one card holds no
256-chip mesh, so there are no ``NamedSharding``\\ s to build
(``to_shardings`` has no counterpart) and :func:`per_device_shape` gives
what each chip would hold instead. A spec is a tuple with one entry per
dimension at most: an axis name, a tuple of axis names, or None.

Mesh semantics: ``model`` is the horizontal layer (tensor parallel),
``data`` (and ``pod``) the vertical layer (batch, bundles). ``fsdp_tp``
also shards the big weight matrices, and so the optimizer state, along
the data axes (ZeRO-3 style), as arctic-480b and deepseek-67b need.

The trees are the port's: ``models.steps.param_tree(model)`` (each
segment's per-layer parameters one stacked leaf, an ``optim.adamw.Stack``),
the AdamW state keyed by it, and the decode state of
``models.decode.init_decode_state``. Their leaves need only a ``shape``,
so trees on the meta device serve.
"""
from __future__ import annotations

import math

from ..models.config import ModelConfig

__all__ = ["TP", "dp_axes", "param_pspecs", "opt_pspecs", "batch_pspecs",
           "decode_state_pspecs", "per_device_shape", "tree_map_with_path"]

TP = "model"


def dp_axes(mesh_shape: dict) -> tuple:
    return tuple(a for a in mesh_shape if a in ("pod", "data"))


def tree_map_with_path(fn, tree, prefix: str = ""):
    """``tree``'s structure with ``fn(path, leaf)`` at each leaf, ``path``
    its keys and indices joined by ``/`` as the reference spells a tree
    path; a leaf is anything with a ``shape`` (a tensor, a ``Stack``)."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, t, join(i))
                          for i, t in enumerate(tree))
    return fn(prefix, tree)


def _axes_size(mesh_shape: dict, axes) -> int:
    return math.prod(mesh_shape[a] for a in axes)


def _axes_ok(mesh_shape: dict, shape, spec) -> bool:
    """True if every sharded dim divides evenly (jit input requirement)."""
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if ax is None:
            continue
        if dim % _axes_size(mesh_shape, ax if isinstance(ax, tuple) else (ax,)):
            return False
    return True


def _normalized(spec) -> tuple:
    """``spec`` as ``PartitionSpec`` spells it: a one-axis tuple is the
    axis name."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


def _pick(mesh_shape: dict, shape, *candidates) -> tuple:
    for c in candidates:
        if _axes_ok(mesh_shape, shape, c):
            return c
    return (None,) * len(shape)


def _param_rule(pstr: str, shape, cfg: ModelConfig, mesh_shape: dict) -> tuple:
    ndim = len(shape)
    dp = dp_axes(mesh_shape)
    fsdp = dp if cfg.param_sharding == "fsdp_tp" else None
    lead = (None,) if pstr.startswith("segments/") else ()

    def pick(*cands):
        return _pick(mesh_shape, shape, *cands)

    def spec(*tail):
        full = lead + tail
        if len(full) != ndim:
            raise ValueError(f"{pstr}: a spec of {len(full)} for {ndim} dims")
        # drop the fsdp axes (not TP) if they don't divide
        if _axes_ok(mesh_shape, shape, full):
            return full
        relaxed = tuple(None if (a == fsdp and a is not None) else a
                        for a in full)
        if _axes_ok(mesh_shape, shape, relaxed):
            return relaxed
        return pick(full, relaxed)

    def replicated():
        return spec(*([None] * (ndim - len(lead))))

    last = pstr.rsplit("/", 1)[-1]
    # ---------------- embeddings / head ----------------
    if pstr in ("embed/table", "lm_head/table"):
        # vocab on model (the LM-head layout switch); fall back to sharding
        # d_model when the vocab is not 16-divisible (hubert/granite/hymba)
        return pick((TP, fsdp), (TP, None), (fsdp, TP), (None, TP))
    if pstr.startswith("frontend/"):
        return pick((None, TP) if ndim == 2 else (TP,))
    # ---------------- norms & small vectors ----------------
    if "norm" in pstr or last in ("scale", "bias", "b", "mu_x", "w0",
                                  "dt_bias", "ln_scale", "q_norm", "k_norm",
                                  "D"):
        return replicated()
    # ---------------- attention ----------------
    if "/attn/" in pstr:
        if "/wo/" in pstr:
            return spec(TP, fsdp)
        return spec(fsdp, TP)  # wq/wk/wv: output (heads) dim on model
    # ---------------- MoE ----------------
    if "/moe/router" in pstr:
        return spec(None, None)
    if "/moe/experts/" in pstr:
        if cfg.moe_expert_sharding == "data_zero":
            # storage sharded over data axes (ZeRO), replicated at compute:
            # the widest inner dim over the data axes
            return pick(lead + (None, dp, None), lead + (None, None, dp))
        # expert parallelism on model; if n_experts is not 16-divisible
        # fall back to TP inside the expert ffn dim
        if last == "down":
            return pick(lead + (TP, None, fsdp), lead + (TP, None, None),
                        lead + (None, TP, fsdp), lead + (None, TP, None))
        return pick(lead + (TP, fsdp, None), lead + (TP, None, None),
                    lead + (None, fsdp, TP), lead + (None, None, TP))
    if "/moe/dense/" in pstr or "/mlp/" in pstr:
        if "down" in pstr:
            return spec(TP, fsdp)
        return spec(fsdp, TP)
    # ---------------- RWKV6 ----------------
    if "/time_mix/" in pstr:
        if last in ("Wr", "Wk", "Wv", "Wg"):
            return spec(fsdp, TP)
        if last == "Wo":
            return spec(TP, fsdp)
        if last == "u":
            return spec(TP, None)
        return replicated()  # loras, mu
    if "/channel_mix/" in pstr:
        if last == "Wv":
            return spec(TP, fsdp)
        return spec(fsdp, TP) if last in ("Wk", "Wr") else replicated()
    # ---------------- Mamba ----------------
    if "/mamba/" in pstr:
        if last == "in_proj":
            return spec(fsdp, TP)
        if last in ("x_proj", "out_proj", "A_log"):
            return spec(TP, None)
        if last == "conv_w":
            return spec(None, TP)
        return replicated()
    # default: replicate
    return (None,) * ndim


def param_pspecs(cfg: ModelConfig, mesh_shape: dict, params):
    """A spec tree matching the parameter tree (shapes suffice)."""
    return tree_map_with_path(
        lambda p, leaf: _normalized(_param_rule(p, tuple(leaf.shape), cfg,
                                                mesh_shape)), params)


def opt_pspecs(cfg: ModelConfig, mesh_shape: dict, opt_state, params_spec):
    """Optimizer-state specs: moments follow the parameters; int8 codes
    and scales are flat-sharded across every mesh axis (a pure memory
    layout)."""
    flat_axes = tuple(mesh_shape)

    def rule(pstr, leaf):
        if pstr == "step":
            return ()
        if cfg.optimizer_dtype == "int8":
            # (codes [nblk, BLOCK], scales [nblk, 1]) leaves
            return _normalized(_pick(
                mesh_shape, tuple(leaf.shape), (flat_axes, None),
                (("data", "model"), None), (("model",), None),
                (("data",), None)))
        ps = params_spec  # strip the leading m/ or v/
        for k in pstr.split("/")[1:]:
            ps = ps[int(k)] if isinstance(ps, list) else ps[k]
        return ps

    return tree_map_with_path(rule, opt_state)


def batch_pspecs(cfg: ModelConfig, mesh_shape: dict, batch):
    dp = dp_axes(mesh_shape)

    def rule(_, leaf):
        nd = len(leaf.shape)
        b = leaf.shape[0] if nd else 1
        bdp = dp if (dp and b % _axes_size(mesh_shape, dp) == 0) else ()
        return _normalized((bdp if bdp else None,) + (None,) * (nd - 1))

    return tree_map_with_path(rule, batch)


def _state_rule(pstr: str, sh: tuple, bdp, mesh_shape: dict) -> tuple:
    last = pstr.rsplit("/", 1)[-1]
    if last in ("k", "v", "wkv"):  # [Ls,B,W,H,hd] / [Ls,B,H,hd,hd]
        return _pick(mesh_shape, sh, (None, bdp, TP, None, None),
                     (None, bdp, None, None, None))
    if last == "ssm":  # [Ls,B,di,N]
        return _pick(mesh_shape, sh, (None, bdp, TP, None),
                     (None, bdp, None, None))
    if last == "conv":  # [Ls,B,3,di]
        return _pick(mesh_shape, sh, (None, bdp, None, TP),
                     (None, bdp, None, None))
    if last in ("x_tm", "x_cm"):
        return _pick(mesh_shape, sh, (None, bdp, None))
    return (None,) * len(sh)


def decode_state_pspecs(cfg: ModelConfig, mesh_shape: dict, state,
                        batch: int):
    """Ring/KV caches: batch on the data axes when divisible, the ring
    axis (S / W) on ``model`` — decode's softmax then reduces tiny [B, H]
    partials over ``model`` instead of moving the cache."""
    dp = dp_axes(mesh_shape)
    bdp = dp if batch % _axes_size(mesh_shape, dp) == 0 else None
    return tree_map_with_path(
        lambda p, leaf: _normalized(_state_rule(p, tuple(leaf.shape), bdp,
                                                mesh_shape)), state)


def per_device_shape(shape, spec, mesh_shape: dict) -> tuple:
    """The shape one chip holds of a leaf of ``shape`` laid out by
    ``spec``: each dimension over the product of its axes' sizes."""
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        n = 1 if ax is None else _axes_size(
            mesh_shape, ax if isinstance(ax, tuple) else (ax,))
        if dim % n:
            raise ValueError(f"dimension {dim} of {tuple(shape)} does not "
                             f"split over {n} chips ({spec})")
        out.append(dim // n)
    return tuple(out)
