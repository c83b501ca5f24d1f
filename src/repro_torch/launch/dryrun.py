"""The dry-run on one card: the port's counterpart of
``repro/launch/dryrun.py``.

The reference lowers and compiles every (architecture × input shape) and
one FD macro-iteration of each paper config on the production mesh (256
or 512 chips, ``launch/mesh.py``) and reads memory, cost and roofline
terms from the compiled artifact. One card holds no such mesh and torch
has no HLO, so the port keeps the reference's records and their meaning
and changes only where each number comes from:

* **plan arithmetic** — every field that the reference computes on the
  host (χ, the comm plan, the neighbor schedule, the s-step ghosts, the
  row partition, the planner's ranking and predicted bytes) is computed
  at the production mesh's shape, exactly as the reference computes it,
  with the port's copies of the planner, partition, sketch and census;
* **measured terms** of an eigen cell come from one macro-iteration
  (TSQR, the redistribution to the filter layout, a degree-32 filter,
  the redistribution back) run on the card over a one-card grid of
  shards (``--grid``, by default the layout's split of 8 shards), with
  the config's operator in the reference's dtype (float32, complex64)
  and the kernels on, counted by ``launch/op_analysis.py`` and timed;
  their fields say they are of the grid (``grid_*``). The reference's
  HLO-measured ``plan_measured_*`` bytes at 256 chips have no
  counterpart;
* **LM costs** come from counting a step's ops on the meta device at the
  cell's global shapes (nothing is allocated): its flops and bytes per
  chip are the count over the mesh's chips, an even split. Unlike the
  reference's per-chip HLO counts they hold no partitioner redundancy,
  and the collectives the partitioner would add are not counted
  (``coll_bytes_per_chip`` is null). The per-chip shapes and bytes of
  parameters, optimizer state, batch and decode state follow
  ``launch/shardings.py``'s rules.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
      [--out cells.jsonl]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --eigen roadnet48k \\
      --layout panel --spmv-comm compressed --spmv-schedule matching \\
      --plan --verify [--grid 4x2] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --eigen hubbard16 \\
      --layout stack --grid 1x1 --grid-params n_sites=12,n_fermions=6
  PYTHONPATH=src python -m repro_torch.launch.dryrun --fit-machine fit.json \\
      --family Hubbard --params n_sites=12,n_fermions=6,U=25,ranpot=1 \\
      --n-devices 4 --n-search 512

``--fit-machine`` fits the machine model on measured fused-step times
(``python -m repro_torch.launch.solve --layout auto --machine fit.json``
plans with it). The grid runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

from ..configs import ARCHS, get_config
from ..core import perf_model as pm
from ..core.planner import comm_plan, estimate_nnzr
from ..core.shards import ShardGroup
from ..core.spmv import build_dist_ell, make_fused_cheb_step
from ..device import resolve_device
from ..matrices import get_family
from ..matrices.sparse import CSR
from ..models import decode as dec
from ..models import steps as steps_mod
from ..models import transformer as tfm
from ..models.config import SHAPES, ModelConfig, applicable_shapes
from ..models.layers import torch_dtype
from ..optim import adamw
from . import roofline as rl
from .mesh import mesh_label, mesh_size, production_mesh_shape
from .op_analysis import OpCensus
from .shardings import (batch_pspecs, decode_state_pspecs, opt_pspecs,
                        param_pspecs, per_device_shape, tree_map_with_path)
from .solve import parse_params

__all__ = ["run_cell", "run_eigen", "fit_machine", "stream_copy_rate",
           "batch_specs", "input_specs", "iter_cells", "main"]

META = torch.device("meta")
#: The filter degree of an eigen cell's macro-iteration (the reference's).
DEGREE = 32


# ----------------------------------------------------------- input specs --

def batch_specs(cfg: ModelConfig, batch: int, seq: int, device=META) -> dict:
    """Stand-ins for every model input, on the meta device (no
    allocation) unless ``device`` is given."""
    def z(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    dt = torch_dtype(cfg.dtype)
    if cfg.family == "audio":
        return {"features": z((batch, seq, cfg.frontend_dim), dt),
                "mask": z((batch, seq), torch.bool),
                "labels": z((batch, seq), torch.int32)}
    if cfg.family == "vlm":
        npfx = min(cfg.n_prefix_embeds, max(seq // 8, 1))
        return {"tokens": z((batch, seq - npfx), torch.int32),
                "patches": z((batch, npfx, cfg.frontend_dim), dt),
                "labels": z((batch, seq - npfx), torch.int32)}
    return {"tokens": z((batch, seq), torch.int32),
            "labels": z((batch, seq), torch.int32)}


def input_specs(arch: str, shape: str):
    """(cfg, cell, batch stand-ins or None) for one dry-run cell."""
    cfg = get_config(arch)
    cell = SHAPES[shape]
    if cell.kind in ("train", "prefill"):
        return cfg, cell, batch_specs(cfg, cell.global_batch, cell.seq_len)
    return cfg, cell, None


def _model_flops(cfg: ModelConfig, cell) -> float:
    """MODEL_FLOPS: 6·N_active·D_tokens (train) / 2·N_active·D_tokens
    (forward)."""
    n = cfg.n_active_params()
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    return (6.0 if cell.kind == "train" else 2.0) * n * tokens


# ------------------------------------------------------------- LM cells --

def _placement(tree, specs, mesh_shape: dict) -> dict:
    """Each leaf's spec and per-chip shape, and the bytes a chip holds."""
    leaves: dict = {}
    total = 0

    def walk(path, leaf):
        nonlocal total
        spec = specs
        for k in path.split("/") if path else ():
            spec = spec[k] if isinstance(spec, dict) else spec[int(k)]
        per = per_device_shape(tuple(leaf.shape), spec, mesh_shape)
        n = math.prod(per) * leaf.dtype.itemsize
        total += n
        leaves[path] = {"spec": [list(a) if isinstance(a, tuple) else a
                                 for a in spec],
                        "shape": list(leaf.shape), "per_chip": list(per)}
        return leaf

    tree_map_with_path(walk, tree)
    return {"bytes_per_chip": total, "leaves": leaves}


def run_cell(arch: str, shape: str, multi_pod: bool = False,
             verbose: bool = True) -> dict:
    """One (architecture × input shape) cell on the production mesh: the
    per-chip placement of every tree, and the step counted on the meta
    device (module docstring)."""
    mesh_shape = production_mesh_shape(multi_pod)
    n_chips = mesh_size(mesh_shape)
    cfg, cell, batch = input_specs(arch, shape)
    t0 = time.perf_counter()
    model = tfm.LMModel(cfg, device=META)
    params = steps_mod.param_tree(model)
    pspec = param_pspecs(cfg, mesh_shape, params)
    trees = {"params": (params, pspec)}
    outputs = ["params"]
    B = cell.global_batch
    if cell.kind == "train":
        ocfg = adamw.AdamWConfig(moment_dtype=cfg.optimizer_dtype)
        opt = adamw.init_state(ocfg, params)
        trees["opt_state"] = (opt, opt_pspecs(cfg, mesh_shape, opt, pspec))
        trees["batch"] = (batch, batch_pspecs(cfg, mesh_shape, batch))
        outputs.append("opt_state")
        step = steps_mod.make_train_step(cfg, ocfg)

        def run():
            step(model, opt, batch)
    else:
        state = dec.init_decode_state(cfg, B, cell.seq_len, device=META)
        trees["decode_state"] = (state, decode_state_pspecs(
            cfg, mesh_shape, state, B))
        outputs = ["decode_state"]
        if cell.kind == "prefill":
            trees["batch"] = (batch, batch_pspecs(cfg, mesh_shape, batch))
            step = steps_mod.make_prefill_step(cfg, cell.seq_len)

            def run():
                step(model, batch)
        else:  # decode: one new token against a seq_len-deep cache
            token = torch.zeros((B,), dtype=torch.int32, device=META)
            trees["token"] = (token, batch_pspecs(cfg, mesh_shape,
                                                  {"t": token})["t"])
            step = steps_mod.make_decode_step(cfg)

            def run():
                step(model, state, token, cell.seq_len - 1)
    placement = {k: _placement(t, sp, mesh_shape)
                 for k, (t, sp) in trees.items()}
    arg_bytes = sum(placement[k]["bytes_per_chip"] for k in trees
                    if k != "decode_state" or cell.kind == "decode")
    out_bytes = sum(placement[k]["bytes_per_chip"] for k in outputs)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_label(mesh_shape),
           "n_chips": n_chips, "status": "ok",
           "memory": rl.memory_summary(arg_bytes, out_bytes),
           "model_flops": _model_flops(cfg, cell), "placement": placement,
           "count": "ops of the step on the meta device at the global "
                    "shapes, split evenly over the chips: no partitioner "
                    "redundancy, no collectives"}
    census = OpCensus()
    try:
        with census:
            run()
    except (NotImplementedError, RuntimeError) as e:
        rec.update(status="error", error_op=census.failed_op,
                   error=f"{type(e).__name__}: {str(e).splitlines()[0][:300]}")
        if verbose:
            print(f"[dryrun] {arch} x {shape}: ERROR at {census.failed_op}: "
                  f"{rec['error']}")
        return rec
    costs = census.costs()
    roof = rl.analyze(costs, rec["model_flops"], n_chips, dtype=cfg.dtype,
                      collectives=False)
    rec.update(t_count_s=round(time.perf_counter() - t0, 1),
               ops=costs.ops, **roof.row())
    if verbose:
        print(f"[dryrun] {arch} x {shape} on {rec['mesh']}: OK "
              f"(counted {costs.ops} ops in {rec['t_count_s']:.0f}s)")
        print(f"  memory: {rec['memory']}")
        print(f"  cost: flops/chip={roof.flops_per_chip:.3e} "
              f"bytes/chip={roof.hbm_bytes_per_chip:.3e}")
        print(f"  roofline: compute={roof.t_compute * 1e3:.2f}ms "
              f"memory={roof.t_memory * 1e3:.2f}ms dominant={roof.dominant} "
              f"useful={roof.useful_flops_ratio:.2f} "
              f"frac={roof.roofline_fraction:.3f}")
    return rec


def iter_cells():
    for arch in ARCHS:
        for shape, cell in applicable_shapes(get_config(arch)).items():
            yield arch, shape, cell


# -------------------------------------------------- eigensolver dry-runs --

def _nnzr(fam) -> float:
    probe = np.arange(0, min(fam.D, 4096), dtype=np.int64)
    r, _ = fam.row_cols(probe)
    return len(r) / len(probe)


def _production_split(layout_name: str, mesh_shape: dict) -> tuple:
    """``(N_row, n_col)`` of the layout on the production mesh: the
    horizontal layer on ``model``, the bundles on the other axes."""
    P = mesh_size(mesh_shape)
    if layout_name == "stack":
        return P, 1
    if layout_name == "pillar":
        return 1, P
    return mesh_shape["model"], P // mesh_shape["model"]


def _mesh_splits(P: int, n_row: int, n_search: int) -> list:
    """The reference's ``plan_for_mesh`` splits: stack, panel on the
    row axes, pillar, each where the bundles divide N_s."""
    splits = []
    for nr, nc in ((P, 1), (n_row, P // max(n_row, 1)), (1, P)):
        if nr >= 1 and nc >= 1 and nr * nc == P and n_search % nc == 0 \
                and (nr, nc) not in splits:
            splits.append((nr, nc))
    return splits


#: The shard group's kind of each of the census's HLO kinds.
_GROUP_KIND = {"all-to-all": "all_to_all", "collective-permute": "ppermute",
               "all-reduce": "psum"}


def _grid_prediction(terms, P: int) -> dict:
    """Bytes the shard groups should count, by kind, for ``terms`` (the
    census's per-device terms of one macro-iteration) over ``P`` shards:
    the groups sum over their shards, and the redistribution counts its
    off-device (moved) size."""
    out: dict = {}
    for t in terms:
        if t.label == "gram-allreduce":
            continue  # the dry-run's macro-iteration has no Gram product
        if t.label.startswith("redistribute["):
            kind, b = "redistribute", t.alt_bytes[0]
        else:
            kind, b = _GROUP_KIND[t.kind], t.bytes
        out[kind] = out.get(kind, 0) + P * b * t.count
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_grid(name: str, conf: dict, *, layout_name: str, overlap: bool,
              grid: tuple, n_search: int, params: dict | None,
              spmv_comm: str, spmv_schedule: str, spmv_balance: str,
              spmv_reorder: str, spmv_sstep: int, plan_mode: str,
              verify: bool, device, reps: int, verbose: bool) -> dict:
    """One macro-iteration of the config's operator (its matrix, or the
    same family at ``params``) over the one-card ``grid``: counted,
    timed, and with ``verify`` attributed by the census."""
    from ..analysis.census import census_of, expected_census, macro_iteration
    from ..core.filter_diag import FDConfig, FilterDiag
    from ..core.layouts import layout_on_grid
    from ..core.partition import RowMap, plan_rowmap

    device = resolve_device(device)
    mspec = dict(conf["matrix"])
    family = mspec.pop("family")
    fam = get_family(family, **(mspec if params is None
                                else {**mspec, **params}))
    t0 = time.perf_counter()
    P = grid[0] * grid[1]
    N_row = layout_on_grid(layout_name, *grid).n_row
    # the row map as the census cells plan it: at the filter level, its
    # padded extent a multiple of every shard count
    rowmap = None
    if (spmv_balance, spmv_reorder) != ("rows", "none") and N_row > 1:
        rowmap = plan_rowmap(fam, N_row, balance=spmv_balance,
                             reorder=spmv_reorder, sstep=spmv_sstep,
                             block_multiple=P // N_row, plan_mode=plan_mode)
        if rowmap.identity:
            rowmap = None
    cfg = FDConfig(n_target=1, n_search=n_search, layout=layout_name,
                   spmv_overlap=overlap, spmv_comm=spmv_comm,
                   spmv_schedule=spmv_schedule, spmv_balance=spmv_balance,
                   spmv_reorder=spmv_reorder, spmv_kernel=True,
                   spmv_sstep=spmv_sstep, plan_mode=plan_mode,
                   dtype="float32")
    fd = FilterDiag(fam, cfg, device=device, n_row=grid[0], n_col=grid[1],
                    rowmap=rowmap if rowmap is not None
                    else RowMap.rows(fam.D, P))
    N_col = fd.N_col
    if rowmap is not None:
        cp = comm_plan(fam, N_row, rowmap=rowmap, sstep=spmv_sstep)
    elif spmv_sstep > 1:
        cp = comm_plan(fam, N_row, d_pad=fd.D_pad, sstep=spmv_sstep)
    else:
        cp = comm_plan(fam, N_row, d_pad=fd.D_pad, exact=True)
    S = fd.ell.vals.element_size()
    t_build = time.perf_counter() - t0
    rec = {"grid": f"{grid[0]}x{grid[1]}",
           "grid_layout": f"{layout_name}({N_row}x{N_col})",
           "grid_matrix": fam.describe(), "grid_D": fd.D,
           "grid_n_search": n_search, "grid_dtype": str(fd.dtype)[6:],
           "grid_device": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"),
           "grid_build_s": t_build}
    V = fd.random_search_vectors(fd.generator(0))
    iteration = macro_iteration(fd, DEGREE, gram=False)
    terms = expected_census(cp, comm=spmv_comm, schedule=spmv_schedule,
                            degree=DEGREE, n_b=n_search // N_col, S_d=S,
                            n_s=n_search, P_total=P, n_col=N_col,
                            D_pad=fd.D_pad)
    # a first iteration builds what the kernels read (their compact
    # forms); with --verify it is the census's own
    if verify:
        report = census_of(fd, cp, degree=DEGREE, cell=f"{name}/{rec['grid']}")
        rec["verify_ok"] = report.ok
        rec["verify_errors"] = report.errors
        if verbose or not report.ok:
            print(report.describe())
    else:
        iteration(V)
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    census = OpCensus(groups=(fd.grid.stack, fd.grid.panel))
    with census:
        Vs, _ = iteration(V)
    _sync(device)
    if not bool(torch.isfinite(Vs).all()):
        raise RuntimeError(f"{name}: the grid's macro-iteration is not "
                           "finite")
    del Vs
    costs = census.costs()
    times = []
    for _ in range(max(int(reps), 1)):
        _sync(device)
        t1 = time.perf_counter()
        iteration(V)
        _sync(device)
        times.append(time.perf_counter() - t1)
    nnz = int((fd.ell.vals != 0).sum())
    useful = DEGREE * 2.0 * nnz * n_search * (4 if fd.dtype.is_complex
                                             else 1) \
        + 2.0 * fd.D * n_search * n_search
    roof = rl.analyze(costs, useful, 1, dtype=str(fd.dtype)[6:])
    block = fd.D_pad * n_search * S
    rec.update(
        grid_ms=min(times) * 1e3, grid_ms_all=[t * 1e3 for t in times],
        grid_model_flops=useful, grid_flops=costs.flops,
        grid_hbm_bytes=costs.hbm_bytes, grid_ops=costs.ops,
        grid_kernels=costs.kernels,
        grid_coll_bytes={k: v for k, v in costs.coll_breakdown.items() if v},
        grid_coll_pred_bytes=_grid_prediction(terms, P),
        grid_roofline=roof.row(),
        grid_memory=rl.memory_summary(block, block, device))
    rec["grid_coll_match"] = rec["grid_coll_bytes"] == \
        rec["grid_coll_pred_bytes"]
    if verbose:
        print(f"[dryrun-eigen] grid {rec['grid_layout']} of "
              f"{rec['grid_matrix']} on {rec['grid_device']}: "
              f"{rec['grid_ms']:.3f} ms a macro-iteration (degree "
              f"{DEGREE}, N_s={n_search}, {rec['grid_dtype']}); counted "
              f"{costs.ops} ops, {costs.flops:.3e} flops, "
              f"{costs.hbm_bytes:.3e} B -> t_memory "
              f"{roof.t_memory * 1e3:.3f} ms; kernels {costs.kernels}")
        print(f"  collectives (bytes over the shards): measured "
              f"{rec['grid_coll_bytes']} predicted "
              f"{rec['grid_coll_pred_bytes']}")
    return rec


def run_eigen(name: str, layout_name: str = "pillar", multi_pod: bool = False,
              n_search: int | None = None, verbose: bool = True,
              plan: bool = False, spmv_comm: str = "a2a",
              spmv_schedule: str = "cyclic", spmv_balance: str = "rows",
              spmv_reorder: str = "none", spmv_kernel: bool = False,
              spmv_sstep: int = 1, plan_mode: str = "auto",
              machine: pm.MachineModel | None = None, verify: bool = False,
              grid: tuple | None = (4, 2), grid_params: dict | None = None,
              grid_n_search: int | None = None, device=None,
              reps: int = 3) -> dict:
    """One FD macro-iteration cell of a paper config (module docstring).

    The plan fields are the reference's (``repro/launch/dryrun.py:172-768``)
    for the same arguments at the production mesh's ``N_row`` and
    ``n_col``: ``chi_comm_plan_L``, ``n_vc_max``, ``nbr_H``,
    ``nbr_rounds``, the ``sstep_*`` and ``partition_*`` fields,
    ``t_comm_schedule_s``, ``plan_best``, ``plan_chi1``, ``plan_pred_*``
    and the cell tag in ``shape``; ``t_model_*`` and the ranking are
    priced on ``machine`` (default ``h100-1card``). Requests that cannot
    be planned are relabeled as the reference relabels them.

    ``grid`` (``(n_row, n_col)``, None: no grid run) is the one-card grid
    of the measured macro-iteration: the layout splits it as
    ``layouts.layout_on_grid`` does, ``grid_params`` overrides the
    config's matrix parameters (a config too large for one card is cut
    there), ``grid_n_search`` its N_s (default the cell's). ``verify``
    attributes the grid's collectives to the census's predicted terms
    (``analysis.census_of``: ``verify_ok``, ``verify_errors``)."""
    from ..core.metrics import chi_from_nvc
    from ..core.partition import partition_plan_default, plan_rowmap
    from ..core.planner import exact_comm_default, plan_layout
    from ..core.redistribute import redistribution_volume

    machine = machine or pm.H100_1CARD
    conf = get_config(name)
    fdc = conf["fd"]
    overlap = layout_name.endswith("+ov")
    if overlap:
        layout_name = layout_name[:-3]
    mesh_shape = production_mesh_shape(multi_pod)
    P_total = mesh_size(mesh_shape)
    N_row, n_col = _production_split(layout_name, mesh_shape)
    mspec = dict(conf["matrix"])
    fam = get_family(mspec.pop("family"), **mspec)
    D = fam.D
    n_s = n_search or fdc.n_search
    n_s = -(-n_s // max(n_col, 1)) * max(n_col, 1)  # pad to the bundles
    S_cell = 8 if fam.is_complex else 4  # complex64 / float32

    # the planned row partition at the cell's N_row, block_multiple =
    # P_total / N_row so its padded extent divides the full mesh;
    # unplannable requests are relabeled to rows/none
    rowmap = None
    use_sampled = plan_mode == "sampled" or (
        plan_mode == "auto" and not partition_plan_default(fam, N_row))
    if (spmv_balance, spmv_reorder) != ("rows", "none") and N_row > 1 \
            and partition_plan_default(fam, N_row, plan_mode) \
            and not (use_sampled and spmv_reorder != "none"):
        rowmap = plan_rowmap(fam, N_row, balance=spmv_balance,
                             reorder=spmv_reorder,
                             block_multiple=P_total // N_row,
                             plan_mode=plan_mode)
        if rowmap.identity:
            rowmap = None
    if rowmap is None:
        spmv_balance, spmv_reorder = "rows", "none"
    D_pad = rowmap.D_pad if rowmap is not None \
        else -(-D // P_total) * P_total

    cp_part = None
    if rowmap is not None:
        if use_sampled and not exact_comm_default(fam):
            from ..core.sketch import sampled_comm_plan

            cp_part = sampled_comm_plan(fam, N_row, rowmap=rowmap)
        else:
            cp_part = comm_plan(fam, N_row, rowmap=rowmap)
        n_vc = cp_part.n_vc
    else:
        n_vc = fam.n_vc(np.minimum(np.arange(N_row + 1) * (D_pad // N_row),
                                   D)) if N_row > 1 else np.zeros(1)
    nnzr = _nnzr(fam)
    if N_row <= 1:
        L = 1
    elif cp_part is not None:
        L = max(cp_part.L, 1)  # the planned partition's exact pair max
    else:
        L = max(-(-int(n_vc.max()) // max(N_row - 1, 1)), 1)
    compressed = spmv_comm == "compressed" and N_row > 1
    perms, round_L = (), ()
    cp_nbr = None
    if compressed:
        if cp_part is not None:
            cp_nbr = cp_part
            perms, round_L = cp_nbr.permute_schedule(spmv_schedule)
        elif exact_comm_default(fam):
            cp_nbr = comm_plan(fam, N_row, d_pad=D_pad, exact=True)
            perms, round_L = cp_nbr.permute_schedule(spmv_schedule)
        else:
            # without per-pair counts only the uniform cyclic rounds
            spmv_schedule = "cyclic"
            perms = tuple(tuple((j, (j + k) % N_row) for j in range(N_row))
                          for k in range(1, N_row))
            round_L = (L,) * (N_row - 1)
    H = int(sum(round_L))

    sstep = max(int(spmv_sstep), 1)
    if sstep > 1 and overlap:
        raise ValueError("s-step dry-run cells run the plain engine only "
                         "(drop the '+ov' layout suffix)")
    if sstep > 1 and N_row <= 1:
        sstep = 1  # comm-free layout: every s is the same cell
    if sstep > 1 and not exact_comm_default(fam):
        if verbose:
            print(f"[dryrun-eigen] {name}: depth-{sstep} ghost plan needs "
                  "the exact pattern pass — relabeling to s=1")
        sstep = 1
    cp_s = None
    G_s = L_s = 0
    if sstep > 1:
        cp_s = (comm_plan(fam, N_row, rowmap=rowmap, sstep=sstep)
                if rowmap is not None
                else comm_plan(fam, N_row, d_pad=D_pad, sstep=sstep))
        G_s, L_s = int(cp_s.n_vc.max()), int(cp_s.L)
        if G_s == 0:
            sstep, cp_s = 1, None  # no halo at this split
        elif compressed:
            perms, round_L = cp_s.permute_schedule(spmv_schedule)
            H = int(sum(round_L))

    cmp_tag = ("" if not compressed
               else "+mat" if spmv_schedule == "matching" else "+cmp")
    part_tag = ("+cv" if spmv_balance == "commvol" else "") + \
        ("+rcm" if spmv_reorder == "rcm" else "")
    krn_tag = "+krn" if spmv_kernel else ""
    ss_tag = f"+s{sstep}" if sstep > 1 else ""
    cell_tag = (f"{layout_name}{part_tag}{cmp_tag}"
                f"{'+ov' if overlap else ''}{krn_tag}{ss_tag}")
    nnz = D * nnzr
    useful = DEGREE * 2.0 * nnz * n_s * (4 if fam.is_complex else 1) \
        + 2.0 * D * n_s * n_s
    rec = {
        "arch": name, "shape": f"fd_iter[{cell_tag},Ns={n_s},deg={DEGREE}]",
        "mesh": mesh_label(mesh_shape), "n_chips": P_total, "status": "ok",
        "model_flops": useful,
        "chi_comm_plan_L": int(L),
        "n_vc_max": int(n_vc.max()) if N_row > 1 else 0,
        "spmv_comm": spmv_comm, "spmv_schedule": spmv_schedule,
        "spmv_balance": spmv_balance, "spmv_reorder": spmv_reorder,
        "spmv_kernel": spmv_kernel, "spmv_sstep": sstep,
        "nbr_H": H, "nbr_rounds": len(perms), "machine": machine.name,
    }
    if sstep > 1:
        rec["sstep_L"] = L_s
        rec["sstep_ghosts_max"] = G_s
        rec["sstep_groups"] = cp_s.n_groups(DEGREE)
        rec["sstep_work_factor"] = round(cp_s.sstep_work_factor(), 4)
    if rowmap is not None:
        sizes = rowmap.block_sizes(N_row)
        rec["partition_rows_min"] = int(sizes.min())
        rec["partition_rows_max"] = int(sizes.max())
    if compressed:
        rec["t_comm_schedule_s"] = pm.schedule_comm_time(
            machine, round_L, n_b=n_s // max(n_col, 1), S_d=S_cell)
    if N_row > 1:
        if rowmap is not None:
            n_vm = rowmap.block_sizes(N_row)
        else:
            bnd = np.minimum(np.arange(N_row + 1) * (D_pad // N_row), D)
            n_vm = np.diff(bnd)
        chim = chi_from_nvc(n_vc, n_vm, D)
        kw = dict(D=D, N_p=N_row, n_b=max(n_s // max(n_col, 1), 1),
                  chi=chim.chi1, n_nzr=nnzr, S_d=S_cell)
        rec["t_model_additive_s"] = pm.cheb_iter_time(machine, **kw)
        rec["t_model_overlap_s"] = pm.cheb_iter_time_overlap(machine, **kw)
        rec["overlap_model_speedup"] = round(
            rec["t_model_additive_s"] / rec["t_model_overlap_s"], 3)
    if plan:
        exact_ok = exact_comm_default(fam)
        lp = plan_layout(
            fam, P_total, n_search=n_s,
            splits=_mesh_splits(P_total, mesh_shape["model"], n_s),
            degree=DEGREE, S_d=S_cell,
            exact_comm=None if exact_ok else False, d_pad=D_pad,
            n_nzr=nnzr, machine=machine, plan_mode=plan_mode,
            reorder=tuple(dict.fromkeys(("none", spmv_reorder))),
            sstep=tuple(dict.fromkeys((1, sstep))),
            comm_plan_by_row=None if cp_nbr is None or rowmap is not None
            else {N_row: cp_nbr},
            n_vc_by_row=None if exact_ok or N_row <= 1 or rowmap is not None
            else {N_row: n_vc})
        if rowmap is not None and exact_ok:
            # the equal-rows partition's χ and pad volumes against the
            # planned map's, at the cell's N_row
            cp_before = comm_plan(fam, N_row, d_pad=-(-D // P_total) * P_total,
                                  exact=True)
            for tag, cp_x in (("before", cp_before), ("after", cp_part)):
                chim_x = cp_x.chi
                rec[f"partition_{tag}"] = {
                    "chi1": round(chim_x.chi1, 4),
                    "chi2": round(chim_x.chi2, 4),
                    "chi3": round(chim_x.chi3, 4),
                    "a2a_pad_entries": cp_x.moved_entries_per_device("a2a"),
                    "H_cyclic": cp_x.moved_entries_per_device(
                        "compressed", "cyclic"),
                    "H_matching": cp_x.moved_entries_per_device(
                        "compressed", "matching"),
                }
            if verbose:
                b, a = rec["partition_before"], rec["partition_after"]
                print(f"[plan] partition {spmv_balance}/{spmv_reorder} "
                      f"before -> after at N_row={N_row}:")
                print(f"       chi2 {b['chi2']:.4f} -> {a['chi2']:.4f}  "
                      f"chi3 {b['chi3']:.4f} -> {a['chi3']:.4f}")
        # predicted per-chip collective operand bytes of the cell: degree
        # halo exchanges, the TSQR butterfly, two redistributions (the
        # full local slice and the moved subset)
        n_b_cell = n_s // max(n_col, 1)
        if sstep > 1:
            pred_spmv = sum(b * c for _, b, c in cp_s.sstep_collectives(
                spmv_comm, spmv_schedule, n_b_cell, S_cell, DEGREE))
        else:
            spmv_entries = (H if compressed else N_row * L) \
                if N_row > 1 else 0
            pred_spmv = DEGREE * spmv_entries * n_b_cell * S_cell
        pred_tsqr = P_total.bit_length() - 1 \
            if P_total & (P_total - 1) == 0 else int(np.ceil(np.log2(P_total)))
        pred_tsqr *= n_s * n_s * S_cell
        pred_red_full = 2 * (D_pad // P_total) * n_s * S_cell \
            if n_col > 1 else 0
        pred_red_moved = 2 * int(redistribution_volume(
            D_pad, n_s, P_total, n_col, S_cell)["bytes_total"] / P_total) \
            if n_col > 1 else 0
        rec["plan_best"] = lp.best.describe()
        rec["plan_chi1"] = lp.best.chi1
        rec["plan_pred_spmv_bytes"] = pred_spmv
        rec["plan_pred_a2a_bytes_full"] = pred_spmv + pred_tsqr + pred_red_full
        rec["plan_pred_a2a_bytes_moved"] = \
            pred_spmv + pred_tsqr + pred_red_moved
        if verbose:
            print(lp.report())
            print(f"[plan] cell spmv/chip predicted: {DEGREE}x"
                  f"{pred_spmv // max(DEGREE, 1)} + tsqr {pred_tsqr} "
                  f"+ redist(full) {pred_red_full} = "
                  f"{rec['plan_pred_a2a_bytes_full']} | redist(moved) "
                  f"{pred_red_moved} = {rec['plan_pred_a2a_bytes_moved']}")
    if verbose:
        print(f"[dryrun-eigen] {name} [{cell_tag}] planned on {rec['mesh']}")
        if "overlap_model_speedup" in rec:
            print(f"  perf model/iter ({machine.name}): additive="
                  f"{rec['t_model_additive_s'] * 1e3:.4f}ms overlap="
                  f"{rec['t_model_overlap_s'] * 1e3:.4f}ms "
                  f"(x{rec['overlap_model_speedup']:.2f} if overlapped)")
    if grid is not None:
        rec.update(_run_grid(
            name, conf, layout_name=layout_name, overlap=overlap,
            grid=tuple(grid), n_search=grid_n_search or n_s,
            params=grid_params, spmv_comm=spmv_comm,
            spmv_schedule=spmv_schedule, spmv_balance=spmv_balance,
            spmv_reorder=spmv_reorder, spmv_sstep=sstep, plan_mode=plan_mode,
            verify=verify, device=device, reps=reps, verbose=verbose))
    return rec


# -------------------------------------------------- machine-model fitting --

def stream_copy_rate(device=None, n_bytes: int = 1 << 30,
                     reps: int = 10) -> float:
    """Memory bandwidth b_m [B/s] from a STREAM-style copy: a block of
    ``n_bytes`` copied ``reps`` times, the bytes read plus the bytes
    written over the fastest copy's time (STREAM's convention)."""
    device = resolve_device(device)
    n = max(int(n_bytes) // 8, 1)
    src = torch.ones(n, dtype=torch.float64, device=device)
    dst = torch.empty_like(src)
    dst.copy_(src)
    _sync(device)
    best = float("inf")
    for _ in range(max(int(reps), 1)):
        t0 = time.perf_counter()
        dst.copy_(src)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return 2.0 * 8 * n / best


def fit_machine(matrix=None, out_path: str | None = "machine_fit.json", *,
                n_devices: int = 8, n_search: int = 16, reps: int = 20,
                device=None, stream_bytes: int = 1 << 30,
                verbose: bool = True):
    """Calibrate the planner's machine constants from measured step times.

    Runs the real fused Chebyshev step in fp64 (the a2a engine, kernels
    on) of ``matrix`` (default SpinChainXXZ(12,6), as the reference)
    across the splits ``n_row × n_col`` with ``n_row ∈ {n_devices,
    n_devices/2, n_devices/4}`` and ``n_col = n_devices / n_row``: the
    operator at ``n_row`` row shards of one ``ShardGroup``, the block in
    ``n_col`` bundles of ``width / n_col`` columns, each bundle's step in
    turn.
    Each split is timed at the full width ``n_search`` and, where it has
    a halo (``n_row > 1``), at a *tiny* width ``n_col`` whose exchange
    moves almost nothing but launches the same rounds, so that the α
    column of ``MachineModel.fit`` is not collinear with the χ·bytes
    column. Each sample carries one round per step when ``n_row > 1``
    (one all_to_all). ``MachineModel.fit`` then fits κ, b_c and α.

    Two departures from the reference, both forced by one card:

    * **b_m is measured here**, by :func:`stream_copy_rate` on a block of
      ``stream_bytes`` (at least 1 GB on the card), as the paper fixes
      b_m from STREAM. The reference keeps b_m from its TPU base model.
    * **A sample's ``t`` is the step's wall time over ``n_devices``.**
      In the reference ``t`` is one device's time, the devices running
      at once; on one card the shards and bundles run one after
      another, so the wall time covers all ``n_devices`` of them.

    Writes the model to ``out_path`` (:func:`perf_model.save_machine`;
    None: not written) and returns ``(model, samples)``; each sample
    holds the fit's inputs, its split and width, and ``t_model``, the
    fitted model's Eq. 12 time for it.
    """
    device = resolve_device(device)
    if matrix is None:
        matrix = get_family("SpinChainXXZ", n_sites=12, n_up=6)
    csr = matrix if isinstance(matrix, CSR) else matrix.build_csr()
    label = (matrix.describe() if hasattr(matrix, "describe")
             else f"CSR{csr.shape}")
    D = csr.shape[0]
    n_nzr = estimate_nnzr(csr)
    D_pad = -(-D // n_devices) * n_devices
    b_m = stream_copy_rate(device, stream_bytes)
    if verbose:
        print(f"[fit-machine] b_m = {b_m / 1e9:.1f} GB/s (copy of "
              f"{stream_bytes} B on {device}); timing {label} fused "
              f"Chebyshev steps over {n_devices} shards", flush=True)
    gen = torch.Generator(device=device).manual_seed(0)
    samples = []
    splits = sorted({n for n in (n_devices, n_devices // 2, n_devices // 4)
                     if n >= 1}, reverse=True)
    for n_row in splits:
        n_col = n_devices // n_row
        if n_search % n_col:
            continue
        ell = build_dist_ell(csr, n_row, dtype="float64", d_pad=D_pad,
                             device=device)
        S_d = int(ell.vals.element_size())
        cp = comm_plan(csr, n_row, d_pad=D_pad)
        chi_eng = pm.engine_chi(cp.moved_entries_per_device("a2a"), D, n_row)
        step = make_fused_cheb_step(ell, group=ShardGroup(n_row, device),
                                    use_kernel=True)
        rounds = 1.0 if n_row > 1 else 0.0  # one all_to_all per step
        widths = [n_search] + ([n_col] if n_row > 1 else [])
        for width in widths:
            n_b = width // n_col

            def block():
                x = torch.randn((n_col, D_pad, n_b), generator=gen,
                                dtype=torch.float64, device=device)
                x[:, D:] = 0
                return x.to(ell.vals.dtype)

            w1, w2 = block(), block()

            def run():
                return [step(w1[j], w2[j], 0.7, -0.2) for j in range(n_col)]

            y = run()  # first launches outside the timing
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(reps):
                y = run()
            _sync(device)
            wall = (time.perf_counter() - t0) / reps
            del y, w1, w2
            samples.append(dict(t=wall / n_devices, D=D, N_p=n_row, n_b=n_b,
                                chi=chi_eng, n_nzr=n_nzr, S_d=S_d,
                                rounds=rounds, n_col=n_col, width=width,
                                wall=wall, route=step.kind))
            if verbose:
                print(f"[fit-machine] {n_row}x{n_col} n_b={n_b} "
                      f"({step.kind}): chi_eng={chi_eng:.3f} "
                      f"rounds={rounds:g} step wall={wall * 1e6:.1f}us "
                      f"t={wall / n_devices * 1e6:.1f}us", flush=True)
        del ell, step
        if device.type == "cuda":
            torch.cuda.empty_cache()
    fitted = pm.MachineModel.fit(samples, b_m=b_m, name="fitted-local")
    for s in samples:
        s["t_model"] = pm.cheb_iter_time(
            fitted, D=s["D"], N_p=s["N_p"], n_b=s["n_b"], chi=s["chi"],
            n_nzr=s["n_nzr"], S_d=s["S_d"], rounds=s["rounds"])
    if out_path is not None:
        pm.save_machine(fitted, out_path)
    if verbose:
        for s in samples:
            print(f"[fit-machine] {s['N_p']}x{s['n_col']} n_b={s['n_b']}: "
                  f"measured t={s['t'] * 1e6:.1f}us, model "
                  f"{s['t_model'] * 1e6:.1f}us")
        bc = fitted.b_c / 1e9
        print(f"[fit-machine] fitted b_c={bc:.2f} GB/s "
              f"kappa={fitted.kappa:.3f} alpha={fitted.alpha * 1e6:.2f}us "
              f"(b_m measured {fitted.b_m / 1e9:.1f} GB/s)"
              + (f" -> {out_path}" if out_path else ""), flush=True)
    return fitted, samples


def _grid_arg(s: str):
    if s.lower() == "none":
        return None
    n_row, n_col = (int(v) for v in s.lower().split("x"))
    return n_row, n_col


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--eigen", help="paper config dry-run (exciton200/"
                                    "hubbard16/roadnet48k/hubnet48k)")
    ap.add_argument("--layout", default="pillar",
                    choices=["stack", "panel", "pillar", "panel+ov",
                             "stack+ov"],
                    help="eigensolver vector layout for --eigen cells; "
                         "'+ov' runs the split-phase overlap engine")
    ap.add_argument("--spmv-comm", default="a2a", choices=["a2a", "compressed"])
    ap.add_argument("--spmv-schedule", default="cyclic",
                    choices=["cyclic", "matching"])
    ap.add_argument("--spmv-balance", default="rows",
                    choices=["rows", "commvol"])
    ap.add_argument("--spmv-reorder", default="none", choices=["none", "rcm"])
    ap.add_argument("--spmv-kernel", action="store_true",
                    help="the '+krn' cell tag (the grid's macro-iteration "
                         "runs the kernels in any case)")
    ap.add_argument("--spmv-sstep", type=int, default=1)
    ap.add_argument("--plan-mode", default="auto",
                    choices=["exact", "sampled", "auto"])
    ap.add_argument("--plan", action="store_true",
                    help="with --eigen: the planner's ranking at the "
                         "production mesh and the cell's predicted "
                         "collective bytes")
    ap.add_argument("--verify", action="store_true",
                    help="with --eigen: attribute every collective of the "
                         "grid's macro-iteration to a predicted term "
                         "(analysis.census_of); exits 1 on any "
                         "unattributed or missing collective")
    ap.add_argument("--grid", type=_grid_arg, default=(4, 2),
                    help="the one-card grid n_rowxn_col of an --eigen "
                         "cell's measured macro-iteration, split by the "
                         "layout (default 4x2: stack 8x1, panel 4x2, "
                         "pillar 1x8; 'none': plan fields only)")
    ap.add_argument("--grid-params", default=None,
                    help="the grid's matrix parameters over the config's "
                         "(k=v,...), to cut a config one card cannot hold")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed repetitions of the grid's macro-iteration")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--machine", default="h100-1card",
                    help="machine model of the --plan ranking and the "
                         "cell's model times: a builtin name or a JSON "
                         "path saved by --fit-machine")
    ap.add_argument("--fit-machine", metavar="PATH", default=None,
                    help="fit the machine model on measured fused-step "
                         "times and write it here as JSON (for "
                         "`solve --layout auto --machine PATH`)")
    ap.add_argument("--family", default=None,
                    help="with --fit-machine: fit on this family (with "
                         "--params); default SpinChainXXZ(12,6)")
    ap.add_argument("--params", default="")
    ap.add_argument("--n-devices", type=int, default=8,
                    help="with --fit-machine: shards P of the splits P x 1, "
                         "P/2 x 2, P/4 x 4")
    ap.add_argument("--n-search", type=int, default=16,
                    help="with --fit-machine: full block width of the "
                         "timed steps")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="append JSON records here")
    args = ap.parse_args(argv)
    if args.spmv_schedule != "cyclic" and args.spmv_comm != "compressed":
        ap.error(f"--spmv-schedule {args.spmv_schedule} requires "
                 "--spmv-comm compressed")

    if args.fit_machine:
        matrix = (get_family(args.family, **parse_params(args.params))
                  if args.family else None)
        fitted, _ = fit_machine(matrix, args.fit_machine,
                                n_devices=args.n_devices,
                                n_search=args.n_search, device=args.device,
                                stream_bytes=(1 << 30) if args.device == "cuda"
                                else 1 << 26)
        return fitted
    mesh = mesh_label(production_mesh_shape(args.multi_pod))
    records = []
    try:
        if args.eigen:
            records.append(run_eigen(
                args.eigen, args.layout, args.multi_pod, plan=args.plan,
                spmv_comm=args.spmv_comm, spmv_schedule=args.spmv_schedule,
                spmv_balance=args.spmv_balance,
                spmv_reorder=args.spmv_reorder, spmv_kernel=args.spmv_kernel,
                spmv_sstep=args.spmv_sstep, plan_mode=args.plan_mode,
                machine=pm.resolve_machine(args.machine), verify=args.verify,
                grid=args.grid,
                grid_params=parse_params(args.grid_params)
                if args.grid_params else None,
                device=args.device, reps=args.reps))
        elif args.all:
            for arch, shape, cell in iter_cells():
                if cell is None:
                    records.append({"arch": arch, "shape": shape,
                                    "mesh": mesh, "status": "skip"})
                    continue
                records.append(run_cell(arch, shape, args.multi_pod))
        elif args.arch and args.shape:
            cell = applicable_shapes(get_config(args.arch))[args.shape]
            if cell is None:
                records.append({"arch": args.arch, "shape": args.shape,
                                "mesh": mesh, "status": "skip"})
                print(f"[dryrun] {args.arch} x {args.shape}: SKIP (not "
                      "applicable to this arch)")
            else:
                records.append(run_cell(args.arch, args.shape,
                                        args.multi_pod))
        else:
            ap.error("give --eigen, --all, --arch with --shape, or "
                     "--fit-machine")
    finally:
        if args.out and records:
            with open(args.out, "a") as f:
                for r in records:
                    f.write(json.dumps(r) + "\n")
    if args.verify and any(r.get("verify_errors") or not r.get(
            "verify_ok", True) for r in records):
        sys.exit(1)
    return records


if __name__ == "__main__":
    main()
