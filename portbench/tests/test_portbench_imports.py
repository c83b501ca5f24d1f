"""Nothing the benchmark runs loads JAX or the JAX package (``repro``:
top-level names compared whole, ``repro_torch`` is the port), and the
reference loads nothing of the program."""
import json
import subprocess
import sys

import _tiny

WALK = r"""
import json, sys
from pathlib import Path
sys.path[:0] = [{root!r}, {src!r}]
sys.path.insert(0, {tests!r})
import _tiny
from portbench import run
bench = _tiny.tiny_bench(Path({cfg!r}))
for trace in ("0", "1"):
    rc = run.main(["--workload", "tiny.stack_1x1", "--seed", "5",
                   "--seconds", "0", "--trace", trace], device="cpu",
                  bench=bench)
    assert rc == 0, rc
from portbench.harness import spec
for m in bench["end_to_end"] + bench["per_layer"]:
    spec.reader(m["name"])
import portbench.control
top = {{m.split(".")[0] for m in sys.modules}}
print("MODULES " + json.dumps(sorted(top)))
"""

REFERENCE = r"""
import json, sys
sys.path[:0] = [{root!r}]
from portbench.reference import check, exciton, hubbard
A = check.operator(dict(reference="hubbard", matrix=dict(
    family="Hubbard", n_sites=6, n_fermions=3, U=25.0, ranpot=1.0)))
check.lowest(A, 4)
top = {{m.split(".")[0] for m in sys.modules}}
print("MODULES " + json.dumps(sorted(top)))
"""


def _modules(script: str) -> set:
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("MODULES ")]
    return set(json.loads(line[-1][len("MODULES "):]))


def test_the_run_path_loads_no_jax(tmp_path):
    cfg = _tiny.tiny_config(tmp_path)
    mods = _modules(WALK.format(root=str(_tiny.ROOT),
                                src=str(_tiny.ROOT / "src"),
                                tests=str(_tiny.ROOT / "portbench" / "tests"),
                                cfg=str(cfg)))
    assert "repro_torch" in mods and "portbench" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules(REFERENCE.format(root=str(_tiny.ROOT)))
    assert not mods & {"repro_torch", "repro", "jax", "jaxlib", "torch"}
