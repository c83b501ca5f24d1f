"""The port's examples (``examples/torch_*.py``) run on ``--device cpu``,
each checking its result as its JAX original does, and the port's code
(``src/repro_torch/``, those examples, ``chip_smoke.py``) imports neither
``jax`` nor the JAX package.

Each example runs in a subprocess on one thread. Two run at a cut size
here (a CPU runs the plain versions of the kernels): the quickstart's
chain at 10 sites (D = 252; 14 on the card: 1.8 M SpMVs for its interior
pairs), the layouts example over 4 shards (8 on the card); and the
training example 30 steps of 128 tokens of the SMOKE config.
"""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

EXAMPLES = {
    "torch_quickstart.py": ["--n-sites", "10"],
    "torch_eigensolve_panel.py": ["--shards", "4"],
    "torch_dos_kpm.py": [],
    "torch_serve_eigensolve.py": [],
    "torch_train_lm.py": ["--small", "--steps", "30", "--seq", "128"],
}


@pytest.mark.parametrize("script", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(script, tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
    args = list(EXAMPLES[script])
    if script == "torch_serve_eigensolve.py":
        args += ["--work", str(tmp_path)]
    if script == "torch_train_lm.py":
        args += ["--ckpt-dir", str(tmp_path / "ckpt")]
    r = subprocess.run([sys.executable, os.path.join(ROOT, "examples", script),
                        "--device", "cpu", *args], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    last = r.stdout.strip().splitlines()[-1]
    assert last.startswith("OK") or "bit-identical demux): True" in last


def _port_files() -> list:
    files = [os.path.join(ROOT, "chip_smoke.py")]
    files += [os.path.join(ROOT, "examples", f) for f in EXAMPLES]
    for d, _, names in os.walk(os.path.join(SRC, "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def test_the_port_imports_no_jax_and_nothing_of_repro():
    bad = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, ROOT)}:{node.lineno} {m}"
                    for m in mods if m.split(".")[0] in ("jax", "jaxlib",
                                                         "repro")]
    assert len(_port_files()) > 60 and bad == []
