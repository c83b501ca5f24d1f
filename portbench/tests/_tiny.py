"""Tiny cells for the CPU tests: the real traffic files and limits with a
matrix of a few hundred rows, written to a temporary configuration file."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

CONFIG = ROOT / "portbench" / "configs" / "hubbard10_lower_band.json"
#: the tiny cell's matrix and N_t
MATRIX = dict(family="Hubbard", n_sites=6, n_fermions=3, U=4.0, ranpot=1.0)
N_TARGET = 4


def tiny_config(tmp_path: Path, **fd) -> Path:
    """hubbard10_lower_band's solver settings and limits on Hubbard(6, 3) at
    U = 4 (D = 400: low filter degrees, a solve in about a second), N_s
    16, N_t 4, the target 0.1 below the lowest eigenvalue."""
    from portbench.reference import check

    cfg = json.loads(CONFIG.read_text())
    cfg.update(name="tiny_hubbard", reference_k=12, matrix=dict(MATRIX))
    lam = np.linalg.eigvalsh(check.operator(cfg).toarray())[0]
    cfg["fd"] = dict(cfg["fd"], n_target=N_TARGET, n_search=16,
                     target=float(lam) - 0.1, max_iters=40, **fd)
    path = tmp_path / "tiny_hubbard.json"
    path.write_text(json.dumps(cfg))
    return path


def tiny_bench(config_path: Path) -> dict:
    """BENCHMARK.json with one cell of the tiny configuration a traffic
    file, named ``tiny.<traffic>``, in every per-layer metric's list."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="tiny", file=str(config_path)))
    for traffic in ("stack_1x1", "pillar_1x4", "stack_4x1_compressed_overlap"):
        name = f"tiny.{traffic}"
        bench["workloads"].append(dict(name=name, config="tiny",
                                       traffic=traffic, chips=1))
        for m in bench["per_layer"] + bench["end_to_end"]:
            if "workloads" in m:
                m["workloads"].append(name)
    return bench
