"""The port's collective census against the JAX package's on the CPU.

The reference compiles each cell on 8 fake CPU devices (one
``run_distributed`` subprocess for the module) and reads the collectives
of the optimized HLO; the port runs the same cell — one FD
macro-iteration from a ``FilterDiag``'s own pieces — with a
``CommTrace`` attached and turns the record into per-device terms. For
every cell both predict the same terms (label, kind, bytes, count,
alt_bytes), both attribute cleanly, each side's ``attribute`` accepts the
other side's measured multiset, and the two multisets are equal, the
redistribution at either admissible size (the reference's HLO prints the
full local slice, the port counts the moved part). The planted controls:
an extra ``psum`` is unattributed, a skipped Gram is missing.
"""
import json

import numpy as np
import pytest
import torch

from repro.analysis import census as jcensus

from repro_torch import convert
from repro_torch.analysis import extra_psum, run_census_cell, skip_gram
from repro_torch.matrices import HubNet, RoadNet, SpinChainXXZ
from tests.conftest import run_distributed

MATRICES = {"spinchain": ("SpinChainXXZ", dict(n_sites=10, n_up=5)),
            "roadnet": ("RoadNet", dict(n=4000, w=2, m=256, k=4)),
            "hubnet": ("HubNet", dict(n=4000, w=2, h=4, m=192, k=4))}
PORT = {"SpinChainXXZ": SpinChainXXZ, "RoadNet": RoadNet, "HubNet": HubNet}
#: (family, layout, comm, schedule, overlap, balance, reorder, kernel,
#: sstep): the reference gate's four --fast cells, then stack, pillar,
#: s = 3 and the two graph families
CELLS = [
    ("spinchain", "panel", "a2a", "cyclic", False, "rows", "none", False, 1),
    ("spinchain", "panel", "compressed", "matching", True, "commvol", "rcm",
     False, 1),
    ("spinchain", "panel", "compressed", "matching", True, "rows", "none",
     True, 1),
    ("spinchain", "panel", "a2a", "cyclic", False, "rows", "none", False, 2),
    ("spinchain", "stack", "a2a", "cyclic", False, "rows", "none", False, 1),
    ("spinchain", "stack", "compressed", "cyclic", True, "commvol", "none",
     False, 1),
    ("spinchain", "pillar", "a2a", "cyclic", False, "rows", "none", False, 1),
    ("spinchain", "pillar", "compressed", "matching", True, "commvol",
     "none", False, 1),
    ("spinchain", "panel", "compressed", "cyclic", False, "commvol", "none",
     False, 3),
    ("roadnet", "panel", "compressed", "matching", True, "rows", "none",
     False, 1),
    ("hubnet", "stack", "compressed", "matching", False, "commvol", "none",
     False, 2),
]


def _ids():
    return ["-".join(str(v) for v in c) for c in CELLS]


@pytest.fixture(scope="module")
def reference():
    """The reference's census of every cell: its tag, predicted terms and
    compiled-HLO multiset, compiled (never run) on 8 fake CPU devices."""
    out = run_distributed(f"""
import json
from repro.analysis.census import run_census_cell
from repro.matrices import get_family
cells = {CELLS!r}
mats = {MATRICES!r}
res = []
for fam, layout, comm, sched, ov, bal, reo, uk, s in cells:
    name, params = mats[fam]
    rep = run_census_cell(get_family(name, **params), P_total=8,
                          layout=layout, comm=comm, schedule=sched,
                          overlap=ov, use_kernel=uk, balance=bal,
                          reorder=reo, sstep=s)
    res.append(dict(cell=rep.cell, ok=rep.ok, errors=rep.errors,
        expected=[dict(label=t.label, kind=t.kind, bytes=int(t.bytes),
                       count=float(t.count),
                       alt_bytes=[int(b) for b in t.alt_bytes])
                  for t in rep.expected],
        measured=[dict(kind=c.kind, bytes=int(c.bytes), mult=float(c.mult),
                       name=c.name, computation=c.computation)
                  for c in rep.measured]))
print("CENSUS" + json.dumps(res))
""", timeout=600)
    line = next(ln for ln in out.splitlines() if ln.startswith("CENSUS"))
    return json.loads(line[len("CENSUS"):])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cell(cell, **kw):
    fam, layout, comm, sched, ov, bal, reo, uk, s = cell
    name, params = MATRICES[fam]
    return run_census_cell(PORT[name](**params), P_total=8, layout=layout,
                           comm=comm, schedule=sched, overlap=ov,
                           use_kernel=uk, balance=bal, reorder=reo, sstep=s,
                           device="cpu", **kw)


def _multiset(ops) -> dict:
    agg: dict = {}
    for c in ops:
        agg[(c.kind, c.bytes)] = agg.get((c.kind, c.bytes), 0.0) + c.mult
    return agg


def _redist_moved(ops, terms) -> dict:
    """The multiset with each redistribution op at its ``moved`` size
    (the term's ``alt_bytes``)."""
    sizes = {t.bytes: t.alt_bytes[0] for t in terms
             if t.label.startswith("redistribute")}
    return _multiset(convert.collective_ops_from_fields(
        [dict(kind=c.kind, mult=c.mult, name=c.name,
              computation=c.computation,
              bytes=sizes.get(c.bytes, c.bytes) if c.kind == "all-to-all"
              else c.bytes) for c in ops]))


@pytest.mark.parametrize("i", range(len(CELLS)), ids=_ids())
def test_census_predicts_the_reference_terms(reference, i):
    """``expected_census`` through the cell: the reference's terms, term
    by term, under the reference's cell tag."""
    ref = reference[i]
    rep = _port_cell(CELLS[i])
    assert rep.cell == ref["cell"]
    want = convert.expected_terms_from_fields(ref["expected"])
    assert rep.expected == want


@pytest.mark.parametrize("i", range(len(CELLS)), ids=_ids())
def test_census_measures_the_reference_multiset(reference, i):
    """The port's per-device multiset equals the reference's compiled-HLO
    one (the redistribution at either admissible size); both attribute
    cleanly, and each side's ``attribute`` accepts the other's."""
    ref = reference[i]
    assert ref["ok"], ref["errors"]
    rep = _port_cell(CELLS[i])
    assert rep.ok, rep.describe()
    ref_ops = convert.collective_ops_from_fields(ref["measured"])
    assert _redist_moved(rep.measured, rep.expected) == \
        _redist_moved(ref_ops, rep.expected)
    # each side's attribution of the other's measured multiset
    from repro_torch.analysis import attribute

    assert attribute(ref_ops, rep.expected).ok
    jterms = [jcensus.ExpectedTerm(t["label"], t["kind"], t["bytes"],
                                   t["count"], tuple(t["alt_bytes"]))
              for t in ref["expected"]]
    jrep = jcensus.attribute(rep.measured, jterms)
    assert jrep.ok, jrep.errors


def test_census_flags_a_planted_psum():
    """An all-reduce the plan never predicted, issued through ``wrap``, is
    an unattributed collective; the clean cell passes."""
    cell = CELLS[0]
    bad = _port_cell(cell, wrap=extra_psum)
    assert not bad.ok
    assert any("unattributed" in e and "all-reduce" in e
               for e in bad.errors), bad.errors
    assert _port_cell(cell).ok


def test_census_flags_a_skipped_gram():
    """A ``wrap`` that takes the Gram product without its all-reduce: the
    Gram term is missing, nothing is unattributed."""
    bad = _port_cell(CELLS[1], wrap=skip_gram)
    assert not bad.ok
    assert any("missing collective" in e and "gram-allreduce" in e
               for e in bad.errors), bad.errors
    assert not any("unattributed" in e for e in bad.errors)


def test_census_plan_against_built_operator():
    """The halo part of a clean cell: the measured halo bytes and
    executions per device are the plan's ``degree`` exchanges of its
    rounds."""
    rep = _port_cell(CELLS[1])
    halo = [c for c in rep.measured if c.name.startswith("halo")]
    terms = [t for t in rep.expected if t.label.startswith("halo")]
    assert sum(c.bytes * c.mult for c in halo) == \
        sum(t.bytes * t.count for t in terms) > 0
    assert np.isclose(sum(c.mult for c in halo),
                      sum(t.count for t in terms))
