"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``) on the CPU.

* **Plan fields.** The reference's CLI record of the roadnet48k panel
  compressed-matching cell (``--plan --verify --out``), and its records of
  four cheaper cells (a commvol partition, an s-step filter, the Hubbard
  stack, the Exciton pillar), are made in one module-scoped subprocess
  (its module sets ``XLA_FLAGS`` to 512 devices when imported); both
  packages price the cells on the same machine model, the port's
  ``h100-1card`` saved as JSON. Every field the reference computes on the
  host at the production mesh equals the port's exactly; ``t_model_*``
  are the only ones the reference prices on its own TPU model.
* **The grid.** The port's ``--verify`` passes on ``--device cpu`` over
  the 4 × 2 grid: every collective attributed, the shard groups' bytes
  equal to the planner's prediction for the grid, the kernels' calls
  counted as the card makes them.
* **LM cells** counted on the meta device, and the families' ``est_nnz``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.matrices as ref_matrices
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import perf_model as pm
from repro_torch.launch import dryrun
from repro_torch.matrices import get_family
from repro_torch.models import steps as steps_mod
from repro_torch.models.config import applicable_shapes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

RN_FLAGS = ["--eigen", "roadnet48k", "--layout", "panel", "--spmv-comm",
            "compressed", "--spmv-schedule", "matching", "--plan",
            "--verify"]
#: cells without --plan: (name, run_eigen keywords)
CELLS = {
    "hubnet48k-panel-mat-commvol": dict(
        name="hubnet48k", layout_name="panel", spmv_comm="compressed",
        spmv_schedule="matching", spmv_balance="commvol"),
    "hubnet48k-panel-s2": dict(name="hubnet48k", layout_name="panel",
                               spmv_sstep=2),
    "hubbard16-stack": dict(name="hubbard16", layout_name="stack"),
    "exciton200-pillar": dict(name="exciton200", layout_name="pillar"),
}
#: the fields the reference computes on the host at the production mesh
PLAN_FIELDS = (
    "arch", "shape", "mesh", "n_chips", "status", "model_flops",
    "chi_comm_plan_L", "n_vc_max", "spmv_comm", "spmv_schedule",
    "spmv_balance", "spmv_reorder", "spmv_kernel", "spmv_sstep", "nbr_H",
    "nbr_rounds", "sstep_L", "sstep_ghosts_max", "sstep_groups",
    "sstep_work_factor", "partition_rows_min", "partition_rows_max",
    "partition_before", "partition_after", "t_comm_schedule_s", "plan_best",
    "plan_chi1", "plan_pred_spmv_bytes", "plan_pred_a2a_bytes_full",
    "plan_pred_a2a_bytes_moved", "verify_ok", "verify_errors")

REF_SCRIPT = """
import json, sys
from repro.launch import dryrun
from repro.core import perf_model as pm
machine, out, flags, cells = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4]
dryrun.main(json.loads(flags) + ["--machine", machine, "--out", out])
m = pm.resolve_machine(machine)
with open(out, "a") as f:
    for kw in json.loads(cells).values():
        f.write(json.dumps(dryrun.run_eigen(**kw, machine=m, verbose=False))
                + "\\n")
"""


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    pm.save_machine(pm.H100_1CARD, str(d / "machine.json"))
    return d


@pytest.fixture(scope="module")
def ref_proc(workdir):
    """The reference's records, made in a subprocess that runs while the
    port's are made."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(workdir / "machine.json"),
         str(workdir / "ref.jsonl"), json.dumps(RN_FLAGS), json.dumps(CELLS)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def port_records(ref_proc, workdir):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        machine = str(workdir / "machine.json")
        out = str(workdir / "port.jsonl")
        dryrun.main(RN_FLAGS + ["--machine", machine, "--grid", "4x2",
                                "--device", "cpu", "--reps", "1",
                                "--out", out])
        with open(out) as f:
            rn = json.loads(f.readline())
        m = pm.resolve_machine(machine)
        cells = {k: dryrun.run_eigen(**kw, machine=m, verbose=False,
                                     grid=None) for k, kw in CELLS.items()}
    finally:
        torch.set_num_threads(n)
    return {"roadnet48k-panel-mat-plan": rn, **cells}


@pytest.fixture(scope="module")
def ref_records(ref_proc, workdir):
    out, _ = ref_proc.communicate(timeout=1200)
    assert ref_proc.returncode == 0, out[-4000:]
    with open(workdir / "ref.jsonl") as f:
        recs = [json.loads(line) for line in f]
    return dict(zip(["roadnet48k-panel-mat-plan", *CELLS], recs))


@pytest.mark.parametrize("cell", ["roadnet48k-panel-mat-plan", *CELLS])
def test_plan_fields_equal_the_reference(cell, port_records, ref_records):
    port, ref = port_records[cell], ref_records[cell]
    for k in PLAN_FIELDS:
        if k.startswith("verify") and "verify_ok" not in ref:
            continue
        assert (k in port) == (k in ref), k
        assert port.get(k) == ref.get(k), (k, port.get(k), ref.get(k))
    assert ("t_model_additive_s" in port) == ("t_model_additive_s" in ref)
    assert port["machine"] == "h100-1card"


def test_the_plan_is_the_reference_s_at_256_chips(port_records, ref_records):
    """The roadnet48k cell: the compressed engine's matching rounds at
    N_row = 16 and the planner's choice, priced on h100-1card."""
    port = port_records["roadnet48k-panel-mat-plan"]
    assert port["shape"] == "fd_iter[panel+mat,Ns=64,deg=32]"
    assert (port["n_chips"], port["mesh"]) == (256, "16x16")
    assert port["nbr_rounds"] > 0 and port["plan_best"].endswith("(16x16)")
    assert ref_records["roadnet48k-panel-mat-plan"]["verify_ok"]


def test_verify_passes_on_the_cpu_grid(port_records):
    r = port_records["roadnet48k-panel-mat-plan"]
    assert r["grid"] == "4x2" and r["grid_layout"] == "panel(4x2)"
    assert r["grid_device"] == "cpu" and r["grid_dtype"] == "float32"
    assert r["verify_ok"] and r["verify_errors"] == []
    # the shard groups' bytes are the planner's prediction for the grid
    assert r["grid_coll_match"]
    assert set(r["grid_coll_bytes"]) == {"ppermute", "redistribute"}
    # T1 of each bundle, then 31 fused steps, each one launch for the 4
    # row shards of each of 2 bundles: the launches the card makes
    assert {k: v["calls"] for k, v in r["grid_kernels"].items()} == \
        {"ell_gather": 2, "ell_gather_cheb": 62}
    roof = r["grid_roofline"]
    for v in (r["grid_ms"], r["grid_flops"], r["grid_hbm_bytes"],
              roof["t_memory_s"], roof["t_compute_s"],
              roof["t_collective_s"]):
        assert np.isfinite(v) and v > 0
    assert r["grid_hbm_bytes"] > sum(
        v["bytes"] for v in r["grid_kernels"].values())


def test_a_grid_without_collectives():
    """The Hubbard stack on one shard runs the DIA kernel's route: no
    collective, one cheb_dia call a filter step (degree 32: T1 on the
    ELL route, then 31 fused steps)."""
    r = dryrun.run_eigen("hubbard16", "stack", grid=(1, 1),
                         grid_params=dict(n_sites=6, n_fermions=3),
                         grid_n_search=16, verify=True, device="cpu",
                         reps=1, verbose=False)
    assert r["verify_ok"] and r["grid_coll_match"]
    assert r["grid_coll_bytes"] == {} == r["grid_coll_pred_bytes"]
    assert r["grid_matrix"].startswith("Hubbard,n_sites=6,n_fermions=3")
    assert {k: v["calls"] for k, v in r["grid_kernels"].items()} == \
        {"ell_gather": 1, "cheb_dia": 31}


@pytest.mark.parametrize("family,params", [
    ("RoadNet", dict(n=48000, w=2, m=1200, k=4)),
    ("HubNet", dict(n=48000, w=2, h=5, m=512, k=4)),
    ("Hubbard", dict(n_sites=10, n_fermions=5, U=25.0, ranpot=1.0)),
    ("SpinChainXXZ", dict(n_sites=14, n_up=7)),
])
def test_est_nnz_equals_the_reference(family, params):
    assert get_family(family, **params).est_nnz() == \
        ref_matrices.get_family(family, **params).est_nnz()


def test_lm_cell_counted_on_the_meta_device():
    r = dryrun.run_cell("qwen3-0.6b", "decode_32k", verbose=False)
    assert r["status"] == "ok" and (r["n_chips"], r["mesh"]) == (256, "16x16")
    cfg = get_config("qwen3-0.6b")
    assert r["model_flops"] == 2.0 * cfg.n_active_params() * 128
    assert r["coll_bytes_per_chip"] is None and r["t_collective_s"] is None
    assert r["flops_per_chip"] > 0 and r["hbm_bytes_per_chip"] > 0
    place = r["placement"]
    assert set(place) == {"params", "decode_state", "token"}
    assert r["memory"]["argument_size_in_bytes"] == sum(
        p["bytes_per_chip"] for p in place.values())
    assert r["memory"]["output_size_in_bytes"] == \
        place["decode_state"]["bytes_per_chip"]
    leaf = place["params"]["leaves"]["embed/table"]
    assert leaf["spec"] == ["model", None]
    assert leaf["per_chip"] == [leaf["shape"][0] // 16, leaf["shape"][1]]


def test_an_op_without_a_meta_kernel_is_an_error_record(monkeypatch):
    def make_decode_step(cfg):
        def decode_step(params, state, token, pos):
            return torch.nonzero(token)  # a data-dependent shape
        return decode_step

    monkeypatch.setattr(steps_mod, "make_decode_step", make_decode_step)
    r = dryrun.run_cell("qwen3-0.6b", "decode_32k", verbose=False)
    assert r["status"] == "error" and "nonzero" in r["error_op"]


def test_every_cell_is_listed_and_skips_are_recorded(tmp_path):
    cells = list(dryrun.iter_cells())
    assert len(cells) == sum(len(applicable_shapes(get_config(a)))
                             for a in ARCHS)
    skips = [(a, s) for a, s, c in cells if c is None]
    assert ("hubert-xlarge", "decode_32k") in skips
    out = tmp_path / "skip.jsonl"
    dryrun.main(["--arch", "hubert-xlarge", "--shape", "decode_32k",
                 "--out", str(out)])
    assert json.loads(out.read_text())["status"] == "skip"
