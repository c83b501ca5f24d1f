"""RWKV6's fp32 error over depth, the port against the reference, on the
CPU.

From the reference's weights of rwkv6-1.6b at its depth of 24 layers and
its SMOKE width, each layer's output in fp32 is held against the port's
fp64 run of the same weights (the port computes wholly in fp64 there; the
reference's fp64 run keeps fp32 steps of its own, so it is no truth to
measure against). The port's fp32 error stays within a small factor of
the reference's at every layer — at or below it — so the growth of the
fp32 error with depth is a property of the model at random init, not a
fault of the port.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import transformer as ref_tfm
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_arrays
from repro_torch.models import transformer as tfm

N_LAYERS, B, S = 24, 2, 32
#: the port's fp32 error may stand this far above the reference's
FACTOR = 4.0


def _ref_fp32_layers(cfg, params, x0) -> list:
    out, x = [], jnp.asarray(x0)
    for (a, b, w), seg in zip(cfg.segments(), params["segments"]):
        block = jax.jit(functools.partial(ref_tfm.block_forward, cfg=cfg,
                                          window=w))
        for i in range(b - a):
            lp = jax.tree.map(lambda t, i=i: t[i], seg)
            x = block(lp, x=x, positions=jnp.arange(S))[0]
            out.append(np.asarray(x, np.float64))
    return out


def _port_layers(cfg, arrays, x0, dtype) -> list:
    model = lm_params_from_arrays(cfg, arrays, device="cpu").to(dtype)
    cfg = dataclasses.replace(cfg, dtype=str(dtype)[6:])
    out, x = [], torch.as_tensor(x0).to(dtype)
    with torch.no_grad():
        for (_, _, w), blocks in zip(cfg.segments(), model.segments):
            for lp in blocks:
                x = tfm.block_forward(lp, cfg, x, torch.arange(S), window=w)[0]
                out.append(x.double().numpy())
    return out


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def per_layer_errors() -> tuple[list, list]:
    """Each layer's fp32 error (max abs over max abs of the truth) of the
    reference and of the port, against the port's fp64 run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rcfg = dataclasses.replace(ref_smoke("rwkv6-1.6b"), n_layers=N_LAYERS)
        cfg = dataclasses.replace(get_smoke_config("rwkv6-1.6b"),
                                  n_layers=N_LAYERS)
        params = ref_tfm.init_params(rcfg, jax.random.PRNGKey(0))
        arrays = jax.tree.map(np.asarray, params)
        x0 = np.random.default_rng(0).standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
        ref32 = _ref_fp32_layers(rcfg, params, x0)
        port32 = _port_layers(cfg, arrays, x0, torch.float32)
        port64 = _port_layers(cfg, arrays, x0, torch.float64)
    finally:
        torch.set_num_threads(n)
    assert len(ref32) == len(port32) == N_LAYERS
    return ([_rel(r, t) for r, t in zip(ref32, port64)],
            [_rel(p, t) for p, t in zip(port32, port64)])


def test_rwkv6_fp32_error_per_layer_is_the_reference_s():
    ref_err, port_err = per_layer_errors()
    for layer, (e_port, e_ref) in enumerate(zip(port_err, ref_err), 1):
        assert e_port <= FACTOR * e_ref, (layer, e_port, e_ref)
    # both grow with depth, and neither reaches fp32's end of precision
    assert ref_err[-1] > ref_err[0] and port_err[-1] > port_err[0]
    assert max(ref_err + port_err) < 1e-3


if __name__ == "__main__":
    # the table behind ROADMAP's settled item (PYTHONPATH=src python
    # tests/test_torch_rwkv_drift.py)
    jax.config.update("jax_enable_x64", True)
    for layer, (e_ref, e_port) in enumerate(zip(*per_layer_errors()), 1):
        print(f"layer {layer:2d}: reference fp32 {e_ref:.3e}  port fp32 "
              f"{e_port:.3e}")
