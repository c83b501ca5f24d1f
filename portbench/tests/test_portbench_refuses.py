"""The harness measures nothing without a card, or without the program
beside it."""
import os
import shutil
import subprocess
import sys

import _tiny

ARGS = ["--workload", "hubbard_stack_1x1", "--seed", "3000000000",
        "--seconds", "1", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=600, env=env)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _run(_tiny.ROOT, env)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA card" in r.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(_tiny.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(_tiny.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = _run(tmp_path, env)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
