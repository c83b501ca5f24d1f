"""Carry the reference's host objects into the port.

The JAX package's operator and solver state, handed over as numpy arrays
(``np.asarray`` of its device arrays), become the port's tensors, real or
complex, so both packages can compute on the same operator and from the
same state:

* a ``DistEll`` of P row shards: ``cols/vals [P, R, W]`` (``[R, W]`` is
  taken as one shard), and where given its ``send_idx [P, P, L]``,
  ``pair_counts``, ``n_vc``, its split-phase blocks, its neighbour
  plans' arrays and its row map;
* a planned ``RowMap`` (``perm``, ``boundaries``, ``R``, ``P``,
  ``balance``, ``reorder``, ``sstep``);
* an ``SstepEll`` of the s-step filter: its step blocks ``[P, R+G,
  W_i]``, exchange plan, ghost statistics, split-phase blocks and its
  ``SstepNeighbor`` plans' arrays;
* a ``DiaPlan``'s ``offsets/dvals`` (``[1, n_diag, R]`` or
  ``[n_diag, R]``);
* an ``FDState``'s search block ``V`` and interval ``lam``;
* the planner's host values, as plain fields (numpy arrays, floats,
  strings): a ``MachineModel``, an ``SpmvCommPlan`` (at any depth s), a
  ``SampledCommEstimate`` (with its ``ChiMetrics`` and ``ChiBand``) and a
  ``Plan`` with its candidates, each with the row map it holds; or a
  ``Plan`` through its JSON (``service/plan_cache.py``'s format, the same
  in both packages);
* the draws of a batched service group: the Lanczos start vector from
  ``jax.random.split(PRNGKey(service_seed))[0]`` and each request's search
  block from ``split(PRNGKey(seed))[1]``, as ``BatchedJob``'s ``v0`` and
  ``V0``;
* the census's values: the reference's predicted ``ExpectedTerm`` lists
  and measured ``CollectiveOp`` multisets (objects, or dicts of their
  fields, as a subprocess hands them over), as the port's
  ``analysis.census`` types, so either side's ``attribute`` can take
  them;
* the LM side: a ``ModelConfig`` from the reference's fields, the
  reference's parameter tree (numpy leaves, each segment's layers stacked
  along a leading axis) as the port's ``LMModel`` and back, its
  per-segment decode states and its AdamW state as the port's.

Each function that makes tensors puts them on ``device``: the card unless
``"cpu"`` is given. The planner's converters take the reference's
objects and read their fields.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core import perf_model as pm
from .core.filter_diag import FDState
from .core.metrics import ChiMetrics
from .core.partition import RowMap
from .core.planner import Candidate, Plan, SpmvCommPlan
from .core.sketch import ChiBand, SampledCommEstimate
from .analysis.census import CollectiveOp, ExpectedTerm
from .core.spmv import DistEll, NeighborPlan, SstepEll, SstepNeighbor
from .device import resolve_device
from .kernels.ops import DiaPlan
from .kernels.plan import span_of
from .models import LMModel, ModelConfig
from .models.steps import param_tree
from .optim import adamw
from .service import plan_cache


def _one_shard(a: np.ndarray, ndim: int, what: str) -> np.ndarray:
    a = np.asarray(a)
    if a.ndim == ndim + 1:
        if a.shape[0] != 1:
            raise ValueError(f"{what}: {a.shape[0]} shards where one is "
                             "expected")
        a = a[0]
    if a.ndim != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got shape {a.shape}")
    return a


def _span(cols: np.ndarray, vals: np.ndarray, send_idx: np.ndarray,
          R: int) -> int:
    """``max |col − row|`` over the stored entries in position numbering
    (the global one without a row map): a local column c of shard p is
    ``p·R + c``, a halo column ``R + q·L + s`` is row
    ``send_idx[q, p, s]`` of shard q."""
    P = cols.shape[0]
    L = send_idx.shape[2]
    c = cols.astype(np.int64)
    p = np.broadcast_to(np.arange(P, dtype=np.int64)[:, None, None], c.shape)
    glob = p * R + c
    halo = c >= R
    if halo.any():
        q, s = (c[halo] - R) // L, (c[halo] - R) % L
        glob[halo] = q * R + send_idx[q, p[halo], s]
    rows = np.broadcast_to(np.arange(P * R, dtype=np.int64).reshape(P, R, 1),
                           c.shape)
    stored = vals != 0
    return span_of(rows[stored], glob[stored])


def rowmap_from_arrays(D: int, P: int, perm, boundaries, R: int, *,
                       balance: str, reorder: str, sstep: int = 1) -> RowMap:
    """The port's :class:`RowMap` from a reference ``RowMap``'s fields
    (its host arrays ``perm`` and ``boundaries``, the rest scalars)."""
    return RowMap(D=int(D), P=int(P), balance=str(balance),
                  reorder=str(reorder),
                  perm=np.asarray(perm, dtype=np.int64).copy(),
                  boundaries=np.asarray(boundaries, dtype=np.int64).copy(),
                  R=int(R), sstep=int(sstep))


def dist_ell_from_arrays(cols, vals, D: int | None = None, *, send_idx=None,
                         pair_counts=None, n_vc=None, split=None, nbr=None,
                         rowmap: RowMap | None = None,
                         device=None) -> DistEll:
    """The port's operator from a reference ``DistEll``'s arrays.

    ``cols/vals`` ``[P, R, W]`` (or ``[R, W]``: one shard); ``send_idx``
    ``[P, P, L]`` (required when P > 1; ``L`` is its last extent);
    ``pair_counts``, ``n_vc`` host arrays; ``split`` the four
    arrays of ``DistEll.split()``; ``nbr`` maps a schedule name to a
    reference ``NeighborPlan`` or to a dict of its ``perms``,
    ``round_L``, ``send_nbr``, ``cols_nbr`` (and, when built,
    ``cols_halo_nbr`` and ``halo_rounds``); ``rowmap`` the map a mapped
    operator was built on (:func:`rowmap_from_arrays`), at either level
    (its ``D_pad`` is ``P·R``; the equal-rows ``RowMap.rows(D, P, P·R)``
    when none is given). The span is taken in position space, as
    ``build_dist_ell`` takes it."""
    dev = resolve_device(device)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    if cols.ndim == 2:
        cols, vals = cols[None], vals[None]
    if cols.ndim != 3 or vals.shape != cols.shape:
        raise ValueError(f"cols {cols.shape} / vals {vals.shape}: expected "
                         "[P, R, W]")
    P, R, _ = cols.shape
    if send_idx is None:
        if P > 1:
            raise ValueError(f"{P} shards need their send_idx")
        send_idx = np.zeros((1, 1, 0), dtype=np.int32)
    send_idx = np.asarray(send_idx).astype(np.int32)
    L = int(send_idx.shape[2])
    if rowmap is None:
        rowmap = RowMap.rows(P * R if D is None else int(D), P, P * R)
    D = rowmap.D if D is None else int(D)

    def t(a):
        return torch.tensor(np.asarray(a), device=dev)

    ell = DistEll(cols=t(cols.astype(np.int32)), vals=t(vals),
                  send_idx=t(send_idx), R=R, L=L, P=P, D=D,
                  n_vc=None if n_vc is None else np.asarray(n_vc),
                  pair_counts=(None if pair_counts is None
                               else np.asarray(pair_counts)),
                  span=_span(cols, vals, send_idx, R), rowmap=rowmap)
    if rowmap.D_pad != P * R:
        raise ValueError(f"the row map's D_pad={rowmap.D_pad} is not the "
                         f"operator's {P}·{R}")
    if split is not None:
        ell.cols_loc, ell.vals_loc, ell.cols_halo, ell.vals_halo = (
            t(a) for a in split)
    if nbr:
        ell.nbr = {}
        for name, plan in nbr.items():
            get = (plan.get if isinstance(plan, dict)
                   else lambda k, d=None, p=plan: getattr(p, k, d))
            rounds = get("halo_rounds")
            halo = get("cols_halo_nbr")
            ell.nbr[name] = NeighborPlan(
                perms=tuple(tuple((int(s), int(d)) for s, d in perm)
                            for perm in get("perms")),
                round_L=tuple(int(x) for x in get("round_L")),
                send_nbr=t(np.asarray(get("send_nbr")).astype(np.int32)),
                cols_nbr=t(np.asarray(get("cols_nbr")).astype(np.int32)),
                cols_halo_nbr=None if halo is None else t(halo),
                halo_rounds=None if rounds is None else tuple(
                    (t(c), t(v)) for c, v in rounds))
    return ell


def sstep_ell_from_arrays(steps, *, send_idx, gather_a2a, R: int, D: int,
                          s: int, n_vc, pair_counts, ghost_cum, ghost_owner,
                          ghost_rank, split=None, nbr=None,
                          rowmap: RowMap | None = None,
                          device=None) -> SstepEll:
    """The port's s-step operator from a reference ``SstepEll``'s arrays.

    ``steps`` the s pairs ``(cols, vals)`` ``[P, R+G, W_i]``; ``send_idx
    [P, P, L]``, ``gather_a2a [P, G]``; ``n_vc``, ``pair_counts``,
    ``ghost_cum``, ``ghost_owner``, ``ghost_rank`` host arrays; ``split``
    the four arrays of ``SstepEll.split()``; ``nbr`` maps a schedule name
    to a reference ``SstepNeighbor`` or a dict of its ``perms``,
    ``round_L``, ``send_nbr`` and ``gather``; ``rowmap`` the map it was
    built on (the equal-rows ``RowMap.rows(D, P, P·R)`` when none is
    given). The span is taken in position space from the owned rows of
    step 0, which hold every entry."""
    dev = resolve_device(device)
    steps = [(np.asarray(c).astype(np.int32), np.asarray(v))
             for c, v in steps]
    P, RG, _ = steps[0][0].shape
    send_idx = np.asarray(send_idx).astype(np.int32)
    ghost_owner = np.asarray(ghost_owner, dtype=np.int64)
    ghost_rank = np.asarray(ghost_rank, dtype=np.int64)
    L = int(send_idx.shape[2])
    R = int(R)
    if rowmap is None:
        rowmap = RowMap.rows(int(D), P, P * R)
    if rowmap.D_pad != P * R:
        raise ValueError(f"the row map's D_pad={rowmap.D_pad} is not the "
                         f"operator's {P}·{R}")
    # step 0's owned rows in position numbering: a ghost address R + j of
    # shard p is row send_idx[owner, p, rank] of its owner
    c0, v0 = steps[0][0][:, :R].astype(np.int64), steps[0][1][:, :R]
    p_of = np.broadcast_to(np.arange(P, dtype=np.int64)[:, None, None],
                           c0.shape)
    glob = p_of * R + c0
    gh = c0 >= R
    if gh.any():
        j = c0[gh] - R
        own = ghost_owner[p_of[gh], j]
        glob[gh] = own * R + send_idx[own, p_of[gh], ghost_rank[p_of[gh], j]]
    rows = np.broadcast_to(np.arange(P * R, dtype=np.int64).reshape(P, R, 1),
                           c0.shape)
    stored = v0 != 0

    def t(a):
        return torch.tensor(np.asarray(a), device=dev)

    sell = SstepEll(
        steps=tuple((t(c), t(v)) for c, v in steps),
        send_idx=t(send_idx),
        gather_a2a=t(np.asarray(gather_a2a).astype(np.int32)),
        R=R, G=RG - R, L=L, P=P, D=int(D), s=int(s),
        n_vc=np.asarray(n_vc, dtype=np.int64).copy(),
        pair_counts=np.asarray(pair_counts, dtype=np.int64).copy(),
        ghost_cum=tuple(int(g) for g in ghost_cum),
        ghost_owner=ghost_owner.copy(), ghost_rank=ghost_rank.copy(),
        span=span_of(rows[stored], glob[stored]), rowmap=rowmap)
    if split is not None:
        sell.cols_loc, sell.vals_loc, sell.cols_post, sell.vals_post = (
            t(a) for a in split)
    if nbr:
        sell.nbr = {}
        for name, plan in nbr.items():
            get = (plan.get if isinstance(plan, dict)
                   else lambda k, p=plan: getattr(p, k))
            sell.nbr[name] = SstepNeighbor(
                perms=tuple(tuple((int(a), int(b)) for a, b in perm)
                            for perm in get("perms")),
                round_L=tuple(int(x) for x in get("round_L")),
                send_nbr=t(np.asarray(get("send_nbr")).astype(np.int32)),
                gather=t(np.asarray(get("gather")).astype(np.int32)))
    return sell


def dia_plan_from_arrays(offsets, dvals, device=None) -> DiaPlan:
    """The port's DIA plan from a ``DiaPlan``'s ``offsets/dvals``."""
    dvals = _one_shard(dvals, 2, "dvals")
    return DiaPlan(offsets=tuple(int(o) for o in offsets),
                   dvals=torch.tensor(dvals, device=resolve_device(device)))


def fd_state_from_arrays(V, lam, *, iteration: int = 0, total_spmvs: int = 0,
                         device=None) -> FDState:
    """An :class:`FDState` at an iteration boundary from ``V [D_pad, N_s]``
    and the Lanczos interval ``lam``."""
    V = np.asarray(V)
    return FDState(V=torch.tensor(V, device=resolve_device(device)),
                   lam=(float(lam[0]), float(lam[1])),
                   iteration=iteration, total_spmvs=total_spmvs)


# --------------------------------------------------------------------------
# the planner's host values
# --------------------------------------------------------------------------


def _rowmap_of(rm) -> RowMap | None:
    """A reference ``RowMap`` as the port's; None stays None."""
    if rm is None:
        return None
    return rowmap_from_arrays(rm.D, rm.P, rm.perm, rm.boundaries, rm.R,
                              balance=rm.balance, reorder=rm.reorder,
                              sstep=rm.sstep)


def _opt_array(a, dtype=np.int64):
    return None if a is None else np.asarray(a, dtype=dtype).copy()


def machine_from_fields(m) -> pm.MachineModel:
    """The port's :class:`~repro_torch.core.perf_model.MachineModel` from
    a reference ``MachineModel``'s ``name``, ``b_m``, ``b_c``, ``kappa``
    and ``alpha``."""
    return pm.MachineModel(name=str(m.name), b_m=float(m.b_m),
                           b_c=float(m.b_c), kappa=float(m.kappa),
                           alpha=float(m.alpha))


def comm_plan_from_fields(cp) -> SpmvCommPlan:
    """The port's :class:`~repro_torch.core.planner.SpmvCommPlan` from a
    reference one, at any depth (``sstep``, ``ghost_cum``)."""
    return SpmvCommPlan(
        n_row=int(cp.n_row), D=int(cp.D), L=int(cp.L),
        n_vc=_opt_array(cp.n_vc), exact=bool(cp.exact),
        d_pad=None if cp.d_pad is None else int(cp.d_pad),
        pair_counts=_opt_array(cp.pair_counts), sstep=int(cp.sstep),
        ghost_cum=(None if cp.ghost_cum is None
                   else tuple(int(g) for g in cp.ghost_cum)),
        rowmap=_rowmap_of(cp.rowmap))


def _chi_of(c) -> ChiMetrics:
    return ChiMetrics(N_p=int(c.N_p), D=int(c.D), chi1=float(c.chi1),
                      chi2=float(c.chi2), chi3=float(c.chi3),
                      n_vc=_opt_array(c.n_vc), n_vm=_opt_array(c.n_vm))


def _band_of(b) -> ChiBand:
    return ChiBand(level=float(b.level),
                   **{k: tuple(float(v) for v in getattr(b, k))
                      for k in ("chi1", "chi2", "chi3")})


def sampled_estimate_from_fields(est) -> SampledCommEstimate:
    """The port's :class:`~repro_torch.core.sketch.SampledCommEstimate`
    from a reference one: its counts, its χ metrics (``ChiMetrics``) and
    confidence band (``ChiBand``) as their fields."""
    return SampledCommEstimate(
        n_row=int(est.n_row), D=int(est.D), fraction=float(est.fraction),
        seed=int(est.seed), sampled_rows=int(est.sampled_rows),
        pair_counts=_opt_array(est.pair_counts), n_vc=_opt_array(est.n_vc),
        n_vm=_opt_array(est.n_vm), chi=_chi_of(est.chi),
        band=_band_of(est.band),
        d_pad=None if est.d_pad is None else int(est.d_pad),
        rowmap=_rowmap_of(est.rowmap))


_CANDIDATE_FIELDS = ("layout", "n_row", "n_col", "overlap", "comm",
                     "schedule", "redistribute", "chi1", "chi2", "chi_eng",
                     "t_iter", "t_redist", "t_pass", "comm_bytes_per_device",
                     "balance", "reorder", "kernel", "sstep")


def candidate_from_fields(c) -> Candidate:
    """The port's :class:`~repro_torch.core.planner.Candidate` from a
    reference one (its scalar fields and its row map)."""
    kinds = dict(n_row=int, n_col=int, overlap=bool, redistribute=bool,
                 chi1=float, chi2=float, chi_eng=float, t_iter=float,
                 t_redist=float, t_pass=float, comm_bytes_per_device=int,
                 kernel=bool, sstep=int)
    return Candidate(**{k: kinds.get(k, str)(getattr(c, k))
                        for k in _CANDIDATE_FIELDS},
                     rowmap=_rowmap_of(c.rowmap))


def plan_from_fields(plan) -> Plan:
    """The port's :class:`~repro_torch.core.planner.Plan` from a reference
    one, its candidates in the reference's order."""
    return Plan(matrix=str(plan.matrix), D=int(plan.D),
                n_devices=int(plan.n_devices),
                n_search=int(plan.n_search),
                degree=int(plan.degree),
                machine=str(plan.machine),
                candidates=tuple(candidate_from_fields(c)
                                 for c in plan.candidates))


def plan_from_json(j: dict) -> Plan:
    """The port's :class:`~repro_torch.core.planner.Plan` from the JSON of
    a reference plan (``repro.service.plan_cache.plan_to_json``), its
    candidates and row maps exact."""
    return plan_cache.plan_from_json(j)


def batch_draws_from_arrays(v0, V0_by_request: dict) -> dict:
    """``BatchedJob``'s ``v0`` and ``V0`` from the reference batcher's
    draws (``repro/service/batcher.py:147-167``): ``v0`` the Lanczos start
    ``[D_pad]`` or ``[D_pad, 1]`` (position space), ``V0_by_request``
    ``{req_id: [D_pad, n_search]}`` (its ``random_search_vectors``, the
    equal-rows partition's positions) or ``[D, n_search]`` (row order)."""
    return dict(v0=np.array(v0, dtype=np.float64).reshape(-1, 1),
                V0={str(rid): np.array(V) for rid, V in V0_by_request.items()})


def _field(o, name: str):
    return o[name] if isinstance(o, dict) else getattr(o, name)


def expected_terms_from_fields(terms) -> list:
    """The reference's ``ExpectedTerm`` list as the port's (label, kind,
    bytes, count, alt_bytes)."""
    return [ExpectedTerm(label=_field(t, "label"), kind=_field(t, "kind"),
                         bytes=int(_field(t, "bytes")),
                         count=float(_field(t, "count")),
                         alt_bytes=tuple(int(b) for b in
                                         _field(t, "alt_bytes")))
            for t in terms]


def collective_ops_from_fields(ops) -> list:
    """The reference's measured ``CollectiveOp`` multiset (compiled HLO) as
    the port's ``CollectiveOp`` list."""
    return [CollectiveOp(kind=_field(o, "kind"), bytes=int(_field(o, "bytes")),
                         mult=float(_field(o, "mult")),
                         name=str(_field(o, "name")),
                         computation=str(_field(o, "computation")))
            for o in ops]


def model_config_from_fields(ref_cfg) -> ModelConfig:
    """The port's ``ModelConfig`` with every field of the reference's
    (an object or a dict of its fields)."""
    return ModelConfig(**{f.name: _field(ref_cfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def _lm_tensor(a, device) -> torch.Tensor:
    """A numpy leaf as a tensor of its own dtype; bfloat16 (ml_dtypes)
    goes through fp32, which holds it exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.as_tensor(a.astype(np.float32), device=device).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for k, v in enumerate(tree):
            yield from _leaf_paths(v, prefix + (str(k),))
    else:
        yield prefix


def lm_params_from_arrays(cfg, tree, device=None) -> LMModel:
    """The reference's parameter tree (``jax.tree.map(np.asarray,
    params)``) as the port's model: leaf ``segments[s][...][i]`` of the
    reference (layer ``i`` of segment ``s``, stacked) becomes parameter
    ``segments.s.i....``, every other leaf the parameter of its path. Each
    leaf must be used, with the port parameter's shape and dtype."""
    cfg = cfg if isinstance(cfg, ModelConfig) else \
        model_config_from_fields(cfg)
    dev = resolve_device(device)
    model = LMModel(cfg, device=dev)
    used = set()
    with torch.no_grad():
        for name, prm in model.named_parameters():
            path = name.split(".")
            layer = None
            if path[0] == "segments":
                path, layer = path[:2] + path[3:], int(path[2])
            node = tree
            for key in path:
                node = node[int(key)] if isinstance(node, (list, tuple)) \
                    else node[key]
            a = np.asarray(node) if layer is None else np.asarray(node)[layer]
            t = _lm_tensor(a, dev)
            if tuple(t.shape) != tuple(prm.shape) or t.dtype != prm.dtype:
                raise ValueError(f"{name}: reference leaf {a.dtype}"
                                 f"{list(a.shape)}, port parameter "
                                 f"{prm.dtype}{list(prm.shape)}")
            prm.copy_(t)
            used.add(tuple(path))
    unused = set(_leaf_paths(tree)) - used
    if unused:
        raise ValueError(f"reference leaves with no port parameter: "
                         f"{sorted(unused)}")
    return model


def decode_state_from_arrays(states, device=None) -> list:
    """The reference's decode state (one dict of stacked per-layer arrays
    per segment) as the port's, leaf for leaf in each leaf's dtype."""
    dev = resolve_device(device)
    return [{k: _lm_tensor(v, dev) for k, v in seg.items()} for seg in states]


def lm_params_to_arrays(model: LMModel) -> dict:
    """The inverse of :func:`lm_params_from_arrays`: the model's parameters
    as the reference's tree of numpy arrays, each segment's layers stacked
    along a leading axis (``steps.param_tree``); a bfloat16 leaf comes out
    as float32, which holds it exactly."""
    def host(leaf):
        t = adamw.value(leaf).detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return adamw.tree_map(host, param_tree(model))


def _state_tree(tree, device):
    if isinstance(tree, dict):
        return {k: _state_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_state_tree(t, device) for t in tree)
    return _lm_tensor(tree, device)


def opt_state_from_arrays(opt_cfg, state, device=None) -> dict:
    """The reference's AdamW state (``jax.tree.map(np.asarray, state)``:
    ``step`` and the moments ``m``, ``v`` in the parameters' tree) as the
    port's, leaf for leaf in each leaf's dtype. With ``opt_cfg.moment_dtype``
    ``"int8"`` each moment is a ``(codes int8, scales fp32)`` pair, else one
    array of that dtype; anything else raises."""
    dev = resolve_device(device)
    out = _state_tree(state, dev)
    want = opt_cfg.moment_dtype
    for key in ("m", "v"):
        for path, leaf in _moment_leaves(out[key]):
            dts = tuple(str(t.dtype).removeprefix("torch.") for t in leaf)
            if dts != (("int8", "float32") if want == "int8" else (want,)):
                raise ValueError(f"{key}{list(path)}: moment of {dts} for "
                                 f"moment_dtype {want!r}")
    return out


def _moment_leaves(tree, prefix=()):
    """``(path, (tensor, ...))`` of each moment: a ``(codes, scales)``
    pair or one tensor."""
    if isinstance(tree, torch.Tensor):
        yield prefix, (tree,)
    elif isinstance(tree, tuple):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _moment_leaves(tree[k], prefix + (k,))
    else:
        for i, t in enumerate(tree):
            yield from _moment_leaves(t, prefix + (i,))
