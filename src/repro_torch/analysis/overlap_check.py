"""Overlap dependency checker: prove, from the ordered record of one
engine call, that a split-phase engine's halo exchange is independent of
its local contraction, and that the round-pipelined engine is a pipeline
(the port's counterpart of ``repro/analysis/overlap_check.py``).

The reference proves these on the jaxpr of an engine closure. The port
has no program to read before it runs, so it proves them on the
:class:`~repro_torch.core.shards.CommTrace` of one call ``spmv(x)`` (or
one group of the s-step filter) on a fresh input ``x``, the order in
which the engine issued its collectives, ``start``/``wait`` pairs,
contractions (one entry per phase: ``local``, ``halo``, ``round[k]``,
``full``, ``step[j]``, whatever the launches per phase) and the copies
that carry an exchange's data. Op B *depends* on op A (A before B) when

1. B reads a byte range that A wrote (the ranges of the storages, so
   ``xfull[:, :R]`` and ``xfull[:, R:]`` do not alias); or
2. B is on the side stream and A was on the main stream before B's
   ``start`` (``ShardGroup.start`` makes the side stream wait for the
   main one); or
3. B is on the main stream after the ``wait`` on A's exchange;

and the transitive closure of that. A range is written by any earlier
op that wrote it, so storage reused within the call can only add a
dependence. Conditions, as the reference states them:

* **(A) independent exchange** — no halo collective (``all_to_all`` /
  ``ppermute`` of a ``halo*`` or ``sstep-exchange*`` call site) depends
  on a contraction. A violation means the exchange cannot start until
  local compute finishes: the engine silently lost its overlap. An
  exchange started after the local blocks (:func:`late_start`, the
  planted defect) fails it through rule 2.
* **(B) hideable work** — some contraction depends on no collective:
  there *is* local work the exchange can hide behind. The plain engines
  fail exactly this (their one contraction reads the received halo),
  the check's non-vacuity control.
* for the round-pipelined engine (:func:`check_round_pipeline`), with
  ``c_1 .. c_n`` its halo collectives in issue order: **(a)** every
  contraction's set of rounds is a prefix ``{c_1 .. c_k}``; **(b)**
  lengths 0 and n are both witnessed; **(c)** for n ≥ 2 some length
  strictly between. The unpipelined body (``pipeline=False``) satisfies
  (a) and (b) but fails (c).

Rule 1 is an order only where the reader waited: on the card a
main-stream op that reads or writes what a side op wrote (or writes what
it reads) before the ``wait`` on that exchange races with it, whatever
the record's issue order says. Both proofs therefore also report the
faults of the issue and wait order itself (:func:`race_errors`): an
exchange started and never waited, and a main-stream op that touches an
exchange's ranges before its wait. :func:`dropped_wait` is the planted
defect (an engine that drops its ``wait``), which rule 1 alone would let
pass (A), (B) and (a)–(c).

On the card a proof also requires (``real_side=True``) that every entry
of the side stream ran on a real ``torch.cuda.Stream`` other than the
current one; on the CPU the same record runs in order.

A rank's record (one process per shard, ``core/ranks.py``) is proved the
same way: its exchange is issued inside ``start`` and lands at the
``wait``, and the s-step filter gathers its ghosts from the receive
buffers after that ``wait`` (a main-stream copy that reads what the
exchange wrote, ordered by rule 3).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

__all__ = ["OverlapReport", "PipelineReport", "check_split_phase",
           "check_round_pipeline", "dependences", "race_errors",
           "late_start", "dropped_wait", "HALO_KINDS", "HALO_LABELS"]

#: Collective kinds of a halo exchange, and its call sites' label prefixes
HALO_KINDS = frozenset({"all_to_all", "ppermute"})
HALO_LABELS = ("halo", "sstep-exchange")


def _is_halo(e) -> bool:
    return e.kind in HALO_KINDS and e.label.startswith(HALO_LABELS)


def _by_storage(ranges) -> dict:
    out: dict = {}
    for key, a, b in ranges:
        out.setdefault(key, []).append((a, b))
    return out


def _overlap(ra: dict, rb: dict) -> bool:
    """Whether two :func:`_by_storage` maps share a byte (each key's
    ranges sorted and disjoint, as ``byte_ranges`` gives them)."""
    for key, xs in ra.items():
        ys = rb.get(key)
        if not ys:
            continue
        xs, ys = sorted(xs), sorted(ys)
        i = j = 0
        while i < len(xs) and j < len(ys):
            if xs[i][0] < ys[j][1] and ys[j][0] < xs[i][1]:
                return True
            if xs[i][1] <= ys[j][1]:
                i += 1
            else:
                j += 1
    return False


def dependences(trace) -> dict:
    """``{index: frozenset of indices}``: every op of the record (not the
    ``start``/``wait`` markers) with the ops it depends on, transitively
    (module docstring)."""
    entries = trace.entries
    start_at = {e.pending: e.index for e in entries if e.kind == "start"}
    wait_at = {e.pending: e.index for e in entries if e.kind == "wait"}
    ops = [e for e in entries if e.kind not in ("start", "wait")]
    reads = {e.index: _by_storage(e.reads) for e in ops}
    writes = {e.index: _by_storage(e.writes) for e in ops}
    anc: dict = {}
    for j, b in enumerate(ops):
        direct = set()
        for a in ops[:j]:
            if (_overlap(reads[b.index], writes[a.index])
                    or (b.stream == "side" and a.stream == "main"
                        and a.index < start_at.get(b.pending, -1))
                    or (b.stream == "main" and a.stream == "side"
                        and wait_at.get(a.pending, b.index) < b.index)):
                direct.add(a.index)
        deps = set(direct)
        for i in direct:
            deps |= anc[i]
        anc[b.index] = frozenset(deps)
    return anc


def race_errors(trace) -> list:
    """The faults of the issue and wait order (module docstring): every
    ``start`` with no ``wait``, and every main-stream op that reads or
    writes a range a side op wrote, or writes a range it read, before
    the ``wait`` on that side op's exchange."""
    entries = trace.entries
    waited: dict = {}
    for e in entries:
        if e.kind == "wait":
            waited.setdefault(e.pending, e.index)
    errors = [f"exchange {e.label}#{e.index} (pending {e.pending}) is "
              f"started and never waited" for e in entries
              if e.kind == "start" and e.pending not in waited]
    side = [(e, _by_storage(e.reads), _by_storage(e.writes))
            for e in entries
            if e.stream == "side" and e.kind not in ("start", "wait")]
    for b in entries:
        if b.stream != "main" or b.kind in ("start", "wait"):
            continue
        br, bw = _by_storage(b.reads), _by_storage(b.writes)
        for a, ar, aw in side:
            if a.index > b.index:
                break
            if waited.get(a.pending, b.index) < b.index:
                continue
            if _overlap(br, aw) or _overlap(bw, aw) or _overlap(bw, ar):
                errors.append(
                    f"{b.label}#{b.index} ({b.kind}) on the main stream "
                    f"touches the ranges of {a.label}#{a.index} ({a.kind}) "
                    f"of exchange {a.pending} before its wait: a race on "
                    f"the card")
    return errors


def _side_errors(trace) -> list:
    return [f"{e.label}#{e.index} ({e.kind}) is on the logical side "
            f"stream but did not run on a real CUDA side stream"
            for e in trace.entries if e.stream == "side" and not e.real_side]


@dataclasses.dataclass
class OverlapReport:
    """Result of one split-phase dependency check."""

    collectives: list  # (label, kind, depends_on_contraction: bool)
    contractions: list  # (label, depends_on_collective: bool)
    errors: list

    @property
    def ok(self) -> bool:
        return not self.errors

    @property
    def independent_contractions(self) -> int:
        """Contractions with no collective ancestor — the local work the
        exchange can hide behind."""
        return sum(1 for _, dep in self.contractions if not dep)

    def describe(self) -> str:
        lines = [f"collectives: {len(self.collectives)}, contractions: "
                 f"{len(self.contractions)} "
                 f"({self.independent_contractions} independent)"]
        for label, kind, dep in self.collectives:
            lines.append(f"  {label}: {kind} "
                         f"{'DEPENDS ON CONTRACTION' if dep else 'independent'}")
        lines += [f"  ERROR: {e}" for e in self.errors]
        return "\n".join(lines)


def check_split_phase(trace, *, real_side: bool = False) -> OverlapReport:
    """Prove conditions (A) and (B) on the record of one engine call, and
    that it has no fault of the issue and wait order (:func:`race_errors`).
    ``real_side`` (on the card) requires every side-stream entry to have
    run on a real side stream."""
    anc = dependences(trace)
    by_index = {e.index: e for e in trace.entries}
    collectives, errors = [], []
    halo_seen = False
    for e in trace.entries:
        if not _is_halo(e):
            continue
        halo_seen = True
        culprits = sorted(by_index[i].label for i in anc[e.index]
                          if by_index[i].kind == "contract")
        collectives.append((f"{e.label}#{e.index}", e.kind, bool(culprits)))
        if culprits:
            errors.append(
                f"halo collective {e.label}#{e.index} ({e.kind}) depends on "
                f"contraction(s) {culprits}: the exchange cannot start "
                f"before local compute — split-phase overlap is lost")
    contractions = [(f"{e.label}#{e.index}",
                     any(by_index[i].collective for i in anc[e.index]))
                    for e in trace.entries if e.kind == "contract"]
    if not halo_seen:
        errors.append("no halo collective found in the record — nothing "
                      "to overlap (wrong call, or a zero-halo cell)")
    elif not any(not dep for _, dep in contractions):
        errors.append(
            "no contraction is independent of the collectives: there "
            "is no local work the halo exchange could hide behind "
            "(the plain engines fail exactly this)")
    errors += race_errors(trace)
    if real_side:
        errors += _side_errors(trace)
    return OverlapReport(collectives=collectives, contractions=contractions,
                         errors=errors)


@dataclasses.dataclass
class PipelineReport:
    """Result of one round-pipeline prefix-chain proof."""

    n_rounds: int
    prefix_lengths: list  # sorted prefix lengths witnessed by contractions
    contractions: list  # (label, prefix length | None when not a prefix)
    errors: list

    @property
    def ok(self) -> bool:
        return not self.errors

    def describe(self) -> str:
        lines = [f"rounds: {self.n_rounds}, contractions: "
                 f"{len(self.contractions)}, prefix lengths witnessed: "
                 f"{self.prefix_lengths}"]
        for label, k in self.contractions:
            lines.append(f"  {label}: "
                         f"{'NOT A PREFIX' if k is None else f'prefix {k}'}")
        lines += [f"  ERROR: {e}" for e in self.errors]
        return "\n".join(lines)


def check_round_pipeline(trace, *, real_side: bool = False
                         ) -> PipelineReport:
    """Prove the round-pipelined engine's prefix-chain property, (a)–(c)
    of the module docstring, on the record of one engine call: round
    ``r``'s contraction waits for no later round's collective, and some
    contraction runs while later rounds are in flight; and that the
    record has no fault of the issue and wait order
    (:func:`race_errors`)."""
    anc = dependences(trace)
    halo = [e.index for e in trace.entries if _is_halo(e)]
    labels = {e.index: f"{e.label}#{e.index}" for e in trace.entries}
    order = {idx: i for i, idx in enumerate(halo)}
    n = len(halo)
    errors, contractions = [], []
    lengths: set = set()
    for e in trace.entries:
        if e.kind != "contract":
            continue
        hidx = sorted(order[i] for i in anc[e.index] if i in order)
        if hidx != list(range(len(hidx))):
            contractions.append((labels[e.index], None))
            errors.append(
                f"contraction {labels[e.index]} depends on halo collectives "
                f"{[labels[halo[i]] for i in hidx]} — not a prefix of the "
                f"issue-order round chain {[labels[i] for i in halo]}: it "
                f"waits on a later round's collective without consuming "
                f"every earlier one")
            continue
        contractions.append((labels[e.index], len(hidx)))
        lengths.add(len(hidx))
    if 0 not in lengths:
        errors.append(
            "no contraction is independent of the halo rounds (prefix "
            "length 0 missing): no local block is contracted while the "
            "exchange is in flight")
    if n and n not in lengths:
        errors.append(
            f"no contraction consumes the full {n}-round chain (prefix "
            f"length {n} missing): the final round's halo slice is never "
            f"contracted")
    if n >= 2 and not any(0 < k < n for k in lengths):
        errors.append(
            f"no contraction witnesses a strict prefix of the {n}-round "
            f"chain (lengths seen: {sorted(lengths)}): every halo "
            f"contraction waits for the last round's collective — the "
            f"engine is not round-pipelined")
    errors += race_errors(trace)
    if real_side:
        errors += _side_errors(trace)
    return PipelineReport(n_rounds=n, prefix_lengths=sorted(lengths),
                          contractions=contractions, errors=errors)


@dataclasses.dataclass
class _Deferred:
    fn: object
    label: str


@contextlib.contextmanager
def late_start(group):
    """The planted defect of condition (A): while active, every exchange
    ``group`` starts is issued at its ``wait``, after the local blocks
    the engine enqueued in between (an engine that starts its exchange
    late). The split-phase engines must then fail (A)."""
    start, wait = group.start, group.wait

    def deferred(fn, label="exchange"):
        return _Deferred(fn, label)

    def late_wait(pending):
        if isinstance(pending, _Deferred):
            pending = start(pending.fn, pending.label)
        return wait(pending)

    group.start, group.wait = deferred, late_wait
    try:
        yield group
    finally:
        del group.start, group.wait


@contextlib.contextmanager
def dropped_wait(group):
    """The planted defect of the issue and wait order: while active,
    ``group``'s ``wait`` hands back an exchange's result without ordering
    the current stream after it and without its record (an engine that
    drops its wait). The engines must then fail :func:`race_errors`. On
    the card the device is synchronized on exit, so that nothing the
    side stream still writes is handed to a later allocation; on ranks
    every collective still in flight is waited on exit."""
    group.wait = lambda pending: pending.result
    try:
        yield group
    finally:
        del group.wait
        if getattr(group, "link", None) is not None:
            group.settle()
        if group.device.type == "cuda":
            torch.cuda.synchronize(group.device)
