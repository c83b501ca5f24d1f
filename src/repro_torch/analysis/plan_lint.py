"""Plan-invariant linter: pattern-only checks, nothing runs on a device
(the port's copy of ``repro/analysis/plan_lint.py:34-393``).

Everything here runs on numpy data that exists *before* any engine
runs — the pair-volume matrix, the neighbor schedules derived from it,
the planned row map, and the :class:`~repro_torch.core.planner.
SpmvCommPlan` byte accounting. The invariants are exactly the
assumptions the SpMV engines and the χ-driven planner silently rely on:

* every neighbor round is a valid partial permutation (each device at
  most once as source, at most once as destination, never to itself)
  whose pad equals the max scheduled pair volume;
* every nonzero (sender, receiver) pair is scheduled in exactly one
  round with enough pad — no dropped and no double-sent pairs;
* ``H_matching <= H_cyclic`` (the matching scheduler's construction
  guarantee) and both are bounded by the padded a2a's ``(P-1) * L``;
* a zero-halo partition yields empty schedules and zero predicted bytes;
* the RowMap embed/extract is a bijection (eigenvector un-permutation
  cannot lose rows);
* ``SpmvCommPlan`` bytes are internally consistent across the comm /
  schedule / partition axes and against its own pair counts.

Each function returns a list of human-readable error strings (empty =
clean); ``run_plan_lint`` orchestrates all of them for one matrix.
"""
from __future__ import annotations

import numpy as np

__all__ = ["lint_rounds", "lint_schedules", "lint_rowmap",
           "lint_comm_plan", "lint_dist_ell", "lint_sstep",
           "lint_sampled_plan", "run_plan_lint"]


def _np(a) -> np.ndarray:
    """A host array of ``a`` (a tensor on any device, or array-like)."""
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def lint_rounds(pair_counts, perms, round_L, label: str = "") -> list[str]:
    """Check one schedule's rounds against the pair-volume matrix.

    ``perms``/``round_L`` are in :func:`repro_torch.core.spmv.
    neighbor_schedule` format. Violations found here are exactly what
    would corrupt the
    compressed engine's receive-buffer layout (``DistEll._round_offsets``
    assigns each scheduled pair a contiguous ``round_L[r]`` slot range).
    """
    pc = np.asarray(pair_counts)
    P = pc.shape[0]
    tag = f"[{label}] " if label else ""
    errors: list[str] = []
    if pc.shape != (P, P):
        return [f"{tag}pair_counts is not square: {pc.shape}"]
    if len(perms) != len(round_L):
        errors.append(f"{tag}{len(perms)} rounds but {len(round_L)} pads")
    seen: dict[tuple[int, int], int] = {}
    for r, (perm, Lr) in enumerate(zip(perms, round_L)):
        srcs = [s for s, _ in perm]
        dsts = [d for _, d in perm]
        if len(set(srcs)) != len(srcs):
            errors.append(f"{tag}round {r} repeats a source device: not a "
                          f"partial permutation ({sorted(perm)})")
        if len(set(dsts)) != len(dsts):
            errors.append(f"{tag}round {r} repeats a destination device: "
                          f"not a partial permutation ({sorted(perm)})")
        for s, d in perm:
            if s == d:
                errors.append(f"{tag}round {r} schedules a self-send "
                              f"({s} -> {d})")
            if not (0 <= s < P and 0 <= d < P):
                errors.append(f"{tag}round {r} pair ({s}, {d}) outside "
                              f"device range [0, {P})")
                continue
            if (s, d) in seen:
                errors.append(f"{tag}pair ({s} -> {d}) double-sent: "
                              f"scheduled in rounds {seen[s, d]} and {r}")
            seen[s, d] = r
            if pc[s, d] > Lr:
                errors.append(f"{tag}round {r} pad {Lr} < pair volume "
                              f"L[{s},{d}] = {int(pc[s, d])} (truncated send)")
        vols = [int(pc[s, d]) for s, d in perm
                if 0 <= s < P and 0 <= d < P]
        if vols and Lr != max(vols):
            errors.append(f"{tag}round {r} pad {Lr} != max scheduled pair "
                          f"volume {max(vols)} (wasted or short pad)")
        if Lr <= 0:
            errors.append(f"{tag}round {r} has nonpositive pad {Lr}")
    for s in range(P):
        for d in range(P):
            if s != d and pc[s, d] and (s, d) not in seen:
                errors.append(f"{tag}nonzero pair ({s} -> {d}, volume "
                              f"{int(pc[s, d])}) scheduled in no round "
                              f"(dropped halo data)")
    return errors


def lint_schedules(pair_counts, label: str = "") -> list[str]:
    """Derive both schedulers from ``pair_counts`` via the engine's own
    :func:`~repro_torch.core.spmv.neighbor_schedule` and lint each, plus the
    cross-schedule invariants (H_matching <= H_cyclic <= (P-1)·L; empty
    pair matrix -> empty schedules)."""
    from ..core.spmv import SPMV_SCHEDULES, neighbor_schedule

    pc = np.asarray(pair_counts)
    tag = f"[{label}] " if label else ""
    errors: list[str] = []
    H = {}
    for sched in SPMV_SCHEDULES:
        perms, round_L = neighbor_schedule(pc, sched)
        errors += lint_rounds(pc, perms, round_L,
                              label=f"{label}:{sched}" if label else sched)
        H[sched] = int(sum(round_L))
        if not pc.any() and perms:
            errors.append(f"{tag}zero-halo pair matrix but schedule "
                          f"{sched!r} has {len(perms)} rounds")
    if H["matching"] > H["cyclic"]:
        errors.append(f"{tag}H_matching = {H['matching']} > H_cyclic = "
                      f"{H['cyclic']} (matching must never pay more)")
    L = int(pc.max()) if pc.size else 0
    P = pc.shape[0]
    if H["cyclic"] > max(P - 1, 0) * L:
        errors.append(f"{tag}H_cyclic = {H['cyclic']} exceeds the padded "
                      f"a2a bound (P-1)*L = {(P - 1) * L}")
    return errors


def lint_rowmap(rowmap, label: str = "") -> list[str]:
    """RowMap structural invariants: monotone boundaries covering [0, D),
    blocks within the padded extent, and a bijective embed/extract."""
    tag = f"[{label}] " if label else ""
    errors: list[str] = []
    b = np.asarray(rowmap.boundaries, dtype=np.int64)
    if b.shape != (rowmap.P + 1,):
        errors.append(f"{tag}boundaries shape {b.shape} != (P+1,) = "
                      f"({rowmap.P + 1},)")
        return errors
    if b[0] != 0 or b[-1] != rowmap.D:
        errors.append(f"{tag}boundaries do not span [0, D): "
                      f"b[0]={int(b[0])}, b[-1]={int(b[-1])}, D={rowmap.D}")
    if (np.diff(b) < 0).any():
        errors.append(f"{tag}boundaries not monotone: {b.tolist()}")
    sizes = np.diff(b)
    if (sizes > rowmap.R).any():
        p = int(np.argmax(sizes))
        errors.append(f"{tag}block {p} holds {int(sizes[p])} rows > padded "
                      f"extent R = {rowmap.R}")
    perm = np.asarray(rowmap.perm)
    if perm.shape != (rowmap.D,) or np.unique(perm).size != rowmap.D:
        errors.append(f"{tag}perm is not a permutation of [0, D)")
    if not rowmap.is_bijection():
        errors.append(f"{tag}embed/extract is not a bijection "
                      f"(extract(embed(X)) != X)")
    else:
        # spot-check the roundtrip on data — cheap and fully independent
        # of the is_bijection() implementation
        rng = np.random.default_rng(0)
        X = rng.standard_normal(rowmap.D)
        if not np.array_equal(rowmap.extract(rowmap.embed(X)), X):
            errors.append(f"{tag}extract(embed(X)) != X on random data")
    return errors


def lint_comm_plan(cp, label: str = "", n_b: int = 3, S_d: int = 8
                   ) -> list[str]:
    """SpmvCommPlan internal consistency across the engine axes.

    On the exact path this cross-checks ``L``/``n_vc`` against the pair
    counts, lints both neighbor schedules, and verifies the byte
    accounting (``a2a_bytes_per_device``, ``comm_bytes_per_device``) is
    the moved-entry count times ``n_b * S_d`` for both engines.
    """
    tag = f"[{label}] " if label else ""
    errors: list[str] = []
    if cp.n_row <= 1 or cp.L == 0:
        # zero-halo plan: everything must collapse to "no communication"
        if cp.a2a_bytes_per_device(n_b, S_d) != 0:
            errors.append(f"{tag}zero-halo plan predicts nonzero a2a bytes")
        if cp.moved_entries_per_device("a2a") != 0:
            errors.append(f"{tag}zero-halo plan moves a2a entries")
        if cp.pair_counts is not None:
            if cp.pair_counts.any():
                errors.append(f"{tag}zero-halo plan carries nonzero "
                              f"pair_counts")
            for sched in ("cyclic", "matching"):
                if cp.permute_schedule(sched)[0]:
                    errors.append(f"{tag}zero-halo plan has {sched} rounds")
        return errors
    pc = cp.pair_counts
    if pc is not None:
        pc = np.asarray(pc)
        if np.diagonal(pc).any():
            errors.append(f"{tag}pair_counts has nonzero diagonal "
                          f"(self-halo)")
        if int(pc.max()) != cp.L:
            errors.append(f"{tag}L = {cp.L} != max pair volume "
                          f"{int(pc.max())}")
        recv = pc.sum(axis=0)
        if not np.array_equal(recv, np.asarray(cp.n_vc)):
            errors.append(f"{tag}column sums of pair_counts disagree with "
                          f"n_vc (remote-column accounting broken)")
        errors += lint_schedules(pc, label=label)
        for sched in ("cyclic", "matching"):
            H = int(sum(cp.permute_schedule(sched)[1]))
            if cp.moved_entries_per_device("compressed", sched) != H:
                errors.append(f"{tag}moved_entries(compressed, {sched}) != "
                              f"round sum H = {H}")
            want = H * n_b * S_d
            got = cp.comm_bytes_per_device("compressed", n_b, S_d, sched)
            if got != want:
                errors.append(f"{tag}comm_bytes(compressed, {sched}) = "
                              f"{got} != H*n_b*S_d = {want}")
            terms = cp.spmv_collectives("compressed", sched, n_b, S_d)
            if sum(b * c for _, b, c in terms) != want:
                errors.append(f"{tag}spmv_collectives(compressed, {sched}) "
                              f"bytes disagree with comm_bytes ({want})")
    moved = cp.moved_entries_per_device("a2a")
    if moved != cp.n_row * cp.L:
        errors.append(f"{tag}moved_entries(a2a) = {moved} != P*L = "
                      f"{cp.n_row * cp.L}")
    if cp.a2a_bytes_per_device(n_b, S_d) != moved * n_b * S_d:
        errors.append(f"{tag}a2a_bytes_per_device != moved*n_b*S_d")
    terms = cp.spmv_collectives("a2a", "cyclic", n_b, S_d)
    if sum(b * c for _, b, c in terms) != moved * n_b * S_d:
        errors.append(f"{tag}spmv_collectives(a2a) bytes disagree with "
                      f"a2a_bytes_per_device")
    if cp.rowmap is not None:
        errors += lint_rowmap(cp.rowmap, label=label)
    return errors


def lint_dist_ell(ell, label: str = "") -> list[str]:
    """Engine-side invariants of a built operator: the schedules the
    engine will actually execute (``DistEll.neighbor_plan``) must match
    the ones re-derived from its own pair counts, and the send indices
    must stay inside the local row block."""
    from ..core.spmv import SPMV_SCHEDULES, neighbor_schedule

    tag = f"[{label}] " if label else ""
    errors: list[str] = []
    send = _np(ell.send_idx)
    if send.size and (send.min() < 0 or send.max() >= ell.R):
        errors.append(f"{tag}send_idx outside the local row block "
                      f"[0, R={ell.R})")
    if ell.pair_counts is None:
        return errors
    pc = np.asarray(ell.pair_counts)
    if int(pc.max(initial=0)) > ell.L:
        errors.append(f"{tag}pair volume {int(pc.max())} exceeds the "
                      f"padded slot count L = {ell.L}")
    for sched in SPMV_SCHEDULES:
        perms, round_L = neighbor_schedule(pc, sched)
        if not pc.any():
            if perms:
                errors.append(f"{tag}zero-halo operator but {sched} "
                              f"schedule has rounds")
            continue
        plan = ell.neighbor_plan(schedule=sched)
        if plan.perms != perms or plan.round_L != round_L:
            errors.append(f"{tag}engine {sched} schedule diverges from "
                          f"neighbor_schedule(pair_counts) — plan and "
                          f"engine no longer share one source of truth")
        errors += lint_rounds(pc, plan.perms, plan.round_L,
                              label=f"{label}:{sched}" if label else sched)
        pairs = plan.scheduled_pairs()
        if len(set(pairs)) != len(pairs):
            errors.append(f"{tag}{sched} schedule repeats a (src, dst) "
                          f"pair across rounds")
    return errors


def lint_sstep(cp1, cps, label: str = "", n_b: int = 3, S_d: int = 8,
               degree: int = 8) -> list[str]:
    """Depth-s ghost-zone plan invariants against the depth-1 plan.

    ``cp1`` is the classic per-SpMV halo plan, ``cps`` the depth-s plan
    of the SAME matrix on the SAME partition. Two families of checks:

    * **ghost coverage** — the depth-s ghost set contains the depth-1
      halo (``n_vc_s >= n_vc_1`` and ``pair_counts_s >= pair_counts_1``
      elementwise; BFS reachability is monotone in depth), and the
      per-depth cumulative counts ``ghost_cum`` rise monotonically from
      0 to the full ghost count, with depth 1 matching the classic halo;
    * **byte accounting** — the plan's own column sums, pad ``L``, and
      the whole-filter :meth:`SpmvCommPlan.sstep_collectives` terms,
      whose total must equal ``moved x (2.ceil(n/s) - 1) x n_b x S_d``
      for both comm engines (the first exchange ships single width, the
      remaining ``ceil(n/s) - 1`` ship the doubled ``[w1 | w2]`` payload).
    """
    tag = f"[{label}] " if label else ""
    errors: list[str] = []
    s = int(getattr(cps, "sstep", 1))
    if s < 2:
        return [f"{tag}lint_sstep called on a depth-{s} plan"]
    if getattr(cp1, "sstep", 1) != 1:
        errors.append(f"{tag}reference plan has sstep = {cp1.sstep} != 1")
    if cps.n_row != cp1.n_row:
        return errors + [f"{tag}plans disagree on the shard count "
                         f"({cps.n_row} vs {cp1.n_row})"]
    # --- ghost coverage -------------------------------------------------
    nv1 = np.asarray(cp1.n_vc, dtype=np.int64)
    nvs = np.asarray(cps.n_vc, dtype=np.int64)
    if (nvs < nv1).any():
        errors.append(f"{tag}depth-{s} ghost count smaller than the "
                      f"depth-1 halo on some shard (coverage hole)")
    if (cp1.pair_counts is not None and cps.pair_counts is not None
            and (np.asarray(cps.pair_counts)
                 < np.asarray(cp1.pair_counts)).any()):
        errors.append(f"{tag}depth-{s} pair_counts drop below the "
                      f"depth-1 volumes for some (sender, receiver) pair")
    gc = cps.ghost_cum
    if gc is None or len(gc) != s + 1:
        errors.append(f"{tag}ghost_cum missing or wrong length "
                      f"({None if gc is None else len(gc)} != {s + 1})")
    else:
        if gc[0] != 0:
            errors.append(f"{tag}ghost_cum[0] = {gc[0]} != 0")
        if any(gc[d] > gc[d + 1] for d in range(s)):
            errors.append(f"{tag}ghost_cum not monotone: {gc}")
        if int(gc[s]) != int(nvs.max(initial=0)):
            errors.append(f"{tag}ghost_cum[{s}] = {gc[s]} != max ghost "
                          f"count {int(nvs.max(initial=0))}")
        if int(gc[1]) != int(nv1.max(initial=0)):
            errors.append(f"{tag}ghost_cum[1] = {gc[1]} != depth-1 halo "
                          f"max {int(nv1.max(initial=0))} (depth-1 slice "
                          f"of the BFS diverges from the classic plan)")
        if cps.sstep_work_factor() < 1.0:
            errors.append(f"{tag}sstep_work_factor < 1")
    # --- byte accounting ------------------------------------------------
    if cps.pair_counts is not None:
        pcs = np.asarray(cps.pair_counts)
        if int(pcs.max(initial=0)) != cps.L:
            errors.append(f"{tag}depth-{s} L = {cps.L} != max pair "
                          f"volume {int(pcs.max(initial=0))}")
        if not np.array_equal(pcs.sum(axis=0), nvs):
            errors.append(f"{tag}depth-{s} pair_counts column sums "
                          f"disagree with n_vc")
    ng = cps.n_groups(degree)
    if ng != -(-degree // s):
        errors.append(f"{tag}n_groups({degree}) = {ng} != ceil({degree}/"
                      f"{s})")
    for comm, sched in (("a2a", "cyclic"), ("compressed", "cyclic"),
                        ("compressed", "matching")):
        moved = cps.moved_entries_per_device(comm, sched)
        want = moved * (2 * ng - 1) * n_b * S_d
        terms = cps.sstep_collectives(comm, sched, n_b, S_d, degree)
        got = sum(b * c for _, b, c in terms)
        if got != want:
            errors.append(f"{tag}sstep_collectives({comm}, {sched}) total "
                          f"bytes {got} != moved*(2*ng-1)*n_b*S_d = {want}")
        if sum(c for _, _, c in terms) != ng * cps.rounds_per_exchange(
                comm, sched):
            errors.append(f"{tag}sstep_collectives({comm}, {sched}) op "
                          f"count disagrees with ng * rounds_per_exchange")
    return errors


def lint_sampled_plan(cp, band=None, label: str = "") -> list[str]:
    """Sampled-plan invariants: the estimated plan must satisfy every
    structural :func:`lint_comm_plan` check (the engines consume it
    through the same code paths as an exact plan), it must be marked
    estimated (``exact=False`` is what keeps the s-step axis off it),
    and its advertised confidence band (``core/sketch.py ChiBand``) must
    be well-formed and contain the plan's own center χ — a band that
    excludes its own point estimate is a broken error model, whatever
    the true values are."""
    tag = f"[{label}] " if label else ""
    errors = lint_comm_plan(cp, label=label)
    if cp.exact:
        errors.append(f"{tag}sampled plan is marked exact=True (the "
                      f"planner would trust it for depth-s ghosts)")
    if band is not None:
        if not band.valid():
            errors.append(f"{tag}confidence band is malformed: {band}")
        elif not band.contains(cp.chi):
            errors.append(f"{tag}band does not contain the plan's own "
                          f"center χ estimate ({cp.chi})")
    return errors


def run_plan_lint(matrix, n_rows=(4, 8), balances=("rows", "commvol"),
                  label: str = "") -> list[str]:
    """Full pattern-only lint of one matrix: comm plans (and their
    schedules, byte accounting, and row maps) at every shard count in
    ``n_rows`` crossed with the partition ``balances``."""
    from ..core.partition import plan_rowmap
    from ..core.planner import comm_plan

    errors: list[str] = []
    for P in n_rows:
        for balance in balances:
            cell = f"{label}P{P}:{balance}" if label else f"P{P}:{balance}"
            if balance == "rows":
                cp = comm_plan(matrix, P, exact=True)
            else:
                rm = plan_rowmap(matrix, P, balance=balance)
                errors += lint_rowmap(rm, label=cell)
                cp = comm_plan(matrix, P, rowmap=rm)
            errors += lint_comm_plan(cp, label=cell)
    return errors
