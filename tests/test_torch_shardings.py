"""The port's sharding rules (``repro_torch.launch.shardings``) against the
reference's ``PartitionSpec``\\ s, leaf for leaf.

For every arch at full size on both production meshes (16 × 16 and
2 × 16 × 16), the reference's specs come from ``jax.eval_shape`` trees on
a ``jax.sharding.AbstractMesh`` (no devices), the port's from its trees on
the meta device: the parameters, the optimizer state of the config's
moment dtype, the batch of each train/prefill cell and the decode state
of each decode cell. ``per_device_shape`` equals ``NamedSharding
.shard_shape`` on every leaf. Only ``repro.launch.shardings`` is imported
from the reference's launch package: ``repro.launch.dryrun`` sets
``XLA_FLAGS`` when it is imported.
"""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as ref_config
from repro.launch import shardings as ref_sh
from repro.models import decode as ref_dec
from repro.models import transformer as ref_tfm
from repro.models.config import applicable_shapes
from repro.optim import adamw as ref_adamw
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import dryrun, shardings
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models import decode as dec
from repro_torch.models import steps
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw

MESHES = {False: "16x16", True: "2x16x16"}


def _abstract_mesh(multi_pod: bool) -> AbstractMesh:
    shape = production_mesh_shape(multi_pod)
    return AbstractMesh(tuple(shape.values()), tuple(shape))


def _ref_leaves(values, specs) -> dict:
    """The reference's ``path -> (shape, spec)``, its paths spelled as its
    rules spell them."""
    paths = jax.tree_util.tree_flatten_with_path(values)[0]
    specs = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, P))
    assert len(paths) == len(specs)
    return {ref_sh._path_str(p): (tuple(v.shape), s)
            for (p, v), s in zip(paths, specs)}


def _port_leaves(values, specs) -> dict:
    """The port's ``path -> (shape, spec)``, each spec found along its
    leaf's path in the spec tree."""
    out = {}

    def leaf(path, v):
        s = specs
        for k in path.split("/") if path else ():
            s = s[k] if isinstance(s, dict) else s[int(k)]
        out[path] = (tuple(v.shape), s)
        return v

    shardings.tree_map_with_path(leaf, values)
    return out


def _assert_same(ref: dict, port: dict, mesh, mesh_shape) -> None:
    assert sorted(ref) == sorted(port)
    for path, (shape, spec) in ref.items():
        pshape, pspec = port[path]
        assert pshape == shape, path
        assert pspec == tuple(spec), (path, pspec, spec)
        assert shardings.per_device_shape(shape, pspec, mesh_shape) == \
            tuple(NamedSharding(mesh, spec).shard_shape(shape)), path


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str):
    return jax.eval_shape(lambda: ref_tfm.init_params(
        ref_config(arch), jax.random.PRNGKey(0)))


def _port_model(arch: str):
    return tfm.LMModel(get_config(arch), device=torch.device("meta"))


def _ref_batch(cfg, batch: int, seq: int) -> dict:
    """The reference dry-run's ``batch_specs`` (its module is not
    imported here)."""
    S, dt = jax.ShapeDtypeStruct, jnp.dtype(cfg.dtype)
    if cfg.family == "audio":
        return {"features": S((batch, seq, cfg.frontend_dim), dt),
                "mask": S((batch, seq), jnp.bool_),
                "labels": S((batch, seq), jnp.int32)}
    if cfg.family == "vlm":
        npfx = min(cfg.n_prefix_embeds, max(seq // 8, 1))
        return {"tokens": S((batch, seq - npfx), jnp.int32),
                "patches": S((batch, npfx, cfg.frontend_dim), dt),
                "labels": S((batch, seq - npfx), jnp.int32)}
    return {"tokens": S((batch, seq), jnp.int32),
            "labels": S((batch, seq), jnp.int32)}


@pytest.mark.parametrize("multi_pod", [False, True], ids=MESHES.get)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_match_the_reference(arch, multi_pod):
    mesh, mesh_shape = _abstract_mesh(multi_pod), production_mesh_shape(
        multi_pod)
    rcfg, cfg = ref_config(arch), get_config(arch)
    pshape = _ref_params(arch)
    rspec = ref_sh.param_pspecs(rcfg, mesh, pshape)
    params = steps.param_tree(_port_model(arch))
    pspec = shardings.param_pspecs(cfg, mesh_shape, params)
    _assert_same(_ref_leaves(pshape, rspec), _port_leaves(params, pspec),
                 mesh, mesh_shape)

    ocfg = ref_adamw.AdamWConfig(moment_dtype=rcfg.optimizer_dtype)
    oshape = jax.eval_shape(functools.partial(ref_adamw.init_state, ocfg),
                            pshape)
    ropt = ref_sh.opt_pspecs(rcfg, mesh, oshape, rspec)
    opt = adamw.init_state(adamw.AdamWConfig(
        moment_dtype=cfg.optimizer_dtype), params)
    popt = shardings.opt_pspecs(cfg, mesh_shape, opt, pspec)
    _assert_same(_ref_leaves(oshape, ropt), _port_leaves(opt, popt), mesh,
                 mesh_shape)


@pytest.mark.parametrize("multi_pod", [False, True], ids=MESHES.get)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_decode_state_specs_match_the_reference(arch, multi_pod):
    mesh, mesh_shape = _abstract_mesh(multi_pod), production_mesh_shape(
        multi_pod)
    rcfg, cfg = ref_config(arch), get_config(arch)
    checked = 0
    for shape, cell in applicable_shapes(rcfg).items():
        if cell is None:
            continue
        B = cell.global_batch
        if cell.kind in ("train", "prefill"):
            rb = _ref_batch(rcfg, B, cell.seq_len)
            pb = dryrun.batch_specs(cfg, B, cell.seq_len)
            _assert_same(_ref_leaves(rb, ref_sh.batch_pspecs(rcfg, mesh, rb)),
                         _port_leaves(pb, shardings.batch_pspecs(
                             cfg, mesh_shape, pb)), mesh, mesh_shape)
        if cell.kind in ("prefill", "decode"):
            rs = jax.eval_shape(functools.partial(
                ref_dec.init_decode_state, rcfg, B, cell.seq_len))
            ps = dec.init_decode_state(cfg, B, cell.seq_len,
                                       device=torch.device("meta"))
            _assert_same(
                _ref_leaves(rs, ref_sh.decode_state_pspecs(rcfg, mesh, rs, B)),
                _port_leaves(ps, shardings.decode_state_pspecs(
                    cfg, mesh_shape, ps, B)), mesh, mesh_shape)
        if cell.kind == "decode":
            rt = {"t": jax.ShapeDtypeStruct((B,), jnp.int32)}
            pt = {"t": torch.zeros((B,), dtype=torch.int32,
                                   device=torch.device("meta"))}
            _assert_same(_ref_leaves(rt, ref_sh.batch_pspecs(rcfg, mesh, rt)),
                         _port_leaves(pt, shardings.batch_pspecs(
                             cfg, mesh_shape, pt)), mesh, mesh_shape)
        checked += 1
    assert checked == sum(c is not None for c in applicable_shapes(
        rcfg).values()) > 0


def test_production_mesh_shape_is_the_reference_mesh():
    """The axis names and sizes of ``repro/launch/mesh.py``'s meshes."""
    assert production_mesh_shape() == {"data": 16, "model": 16}
    assert production_mesh_shape(True) == {"pod": 2, "data": 16, "model": 16}
    assert shardings.dp_axes(production_mesh_shape(True)) == ("pod", "data")


def test_per_device_shape_refuses_an_uneven_split():
    with pytest.raises(ValueError):
        shardings.per_device_shape((30, 8), ("model", None),
                                   production_mesh_shape())
