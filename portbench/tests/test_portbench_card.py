"""A short run of hubbard_stack_1x1 on the card (skips where there is
none): a whole result line, correct."""
import json
import subprocess
import sys

import pytest

import _tiny


@pytest.mark.cuda
def test_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "hubbard_stack_1x1", "--seed", "3000000011",
                        "--seconds", "2", "--trace", "0"], cwd=_tiny.ROOT,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["attempted"] >= 1
    assert out["device"]["platform"] == "gpu"
    assert set(out["metrics"]) == {"solve_s", "peak_mem_gib", "setup_s"}
