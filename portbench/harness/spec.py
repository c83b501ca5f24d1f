"""Find a cell's files by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own, found by name:

* ``configs[].file``: the configuration (JSON), whose ``driver`` names the
  module of ``portbench/drivers/`` that runs it and whose ``reference``
  names its frozen generator in ``portbench/reference/``;
* ``portbench/traffic/<traffic>.json``: the traffic mix of a cell;
* ``portbench/metrics/<metric name>.py``: the reader of a metric, a
  function ``read(run)`` that returns its value or None.

So a cell, a configuration or a metric comes in as new files and new
entries, and no file that is there changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, workload: str) -> dict:
    """The cell named ``workload`` with its configuration and traffic
    loaded, and the metrics it reports under ``--trace 0`` (``end_to_end``)
    and ``--trace 1`` (``per_layer``)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return dict(workload=w, config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])


def reader(name: str):
    """The ``read`` function of ``portbench/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver(name: str):
    """The module of ``portbench/drivers/<name>.py``."""
    return importlib.import_module(f"portbench.drivers.{name}")
