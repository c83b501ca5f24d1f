#!/usr/bin/env python3
"""Run one cell of the benchmark of ``repro_torch`` and print its result.

    python3 portbench/run.py --workload hubbard_stack_1x1 --seed 12345 \\
        --seconds 10 --trace 0

Run from the root of a checkout on a machine with an NVIDIA card.
``--workload`` names an entry of ``workloads`` in ``BENCHMARK.json``; its
configuration and traffic files, its driver and its metric readers are
found by name (``portbench/harness/spec.py``). ``--trace 0`` measures the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics under
``torch.profiler``. The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``compared``: each number the
reference compared with its limit); the last lines of standard error
repeat the numbers compared.

Without a card, with fewer cards than the cell asks for, without the
program beside the benchmark, or when JAX or the JAX package was loaded
by the time the window closed, it prints no result and exits non-zero.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: modules no run may hold once the window has closed (top-level names)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _paths() -> None:
    """The program's package and this one on the path, every kernel and
    compiler cache at a fixed place inside the checkout."""
    cache = ROOT / "portbench" / "_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card(torch) -> dict:
    """The card's name and power limit (``nvidia-smi``)."""
    out = dict(name=torch.cuda.get_device_name(0), power_limit_w=None)
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits", "-i", "0"],
                           capture_output=True, text=True, timeout=30)
        out["power_limit_w"] = float(q.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return out


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device=None, bench=None) -> int:
    """Run the cell; returns the exit code. ``device`` is the card unless
    a test passes ``"cpu"``, which skips the look for a card; a test may
    pass its own ``bench`` in place of ``BENCHMARK.json``."""
    args = parse(argv)
    _paths()
    import torch

    from portbench.harness import spec

    cell = spec.cell(bench or spec.load_benchmark(), args.workload)
    chips = int(cell["workload"]["chips"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
                  f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                  f"device_count={torch.cuda.device_count()}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    device = torch.device(device)
    driver = spec.driver(cell["config"]["driver"])
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                     T_START, device)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}: the benchmark runs the "
              "port alone", file=sys.stderr)
        return 3
    run = out["run"]
    metrics = {}
    for m in cell["per_layer" if args.trace else "end_to_end"]:
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    if device.type == "cuda":
        info = card(torch)
        dev = dict(platform="gpu", kind=info["name"], count=chips,
                   memory_peak_bytes=int(out["memory_peak_bytes"]))
    else:
        info = dict(name="cpu", power_limit_w=None)
        dev = dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)
    result = dict(correct=out["correct"], attempted=out["attempted"],
                  failed=out["failed"], metrics=metrics, device=dev)
    if args.trace:
        tr = run.trace
        if tr is not None:
            dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
            result["breakdown"] = dict(device_ops=tr["device_ops"],
                                       idle_gaps=tr["idle_gaps"])
    result["card"] = info
    result["solves"] = [dict(wall_s=s["wall_s"], iterations=s["iterations"])
                        for s in run.solves]
    result["compared"] = out["compared"]
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
