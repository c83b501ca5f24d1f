"""The port's training launcher (``repro_torch.launch.train``) on the CPU:
the loss falls through ``train``, a run stopped at step 7 and resumed to
10 equals the uninterrupted run bit for bit, a checkpoint the
reference's ``train`` wrote resumes in the port's (the same manifest
leaves, the parameters within the step tolerance of the reference's
unbroken run), and the CLI prints the reference's log lines."""
import json
import os
import re
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro_torch.launch import train as ttrain
from repro_torch.models import steps as tsteps
from repro_torch.optim import adamw


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """SMOKE tensors are small: one intra-op thread (more spin against the
    suite's other workers and add nothing here)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_flat(tree):
    return [adamw.value(leaf).detach().numpy()
            for _, leaf in adamw.tree_paths(tree)]


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_training_loss_decreases():
    """The counterpart of ``tests/test_system.py::
    test_training_loss_decreases``, through the port's ``train`` (its
    10-step warmup, a cosine over the 60 steps)."""
    _, _, losses = ttrain.train("qwen3-0.6b", steps=60, batch=8, seq=64,
                                log_every=100, opt_overrides={"lr": 3e-3},
                                device="cpu")
    assert np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < np.mean(losses[:5]) - 0.5, (
        losses[:5], losses[-10:])


def _port_params(model):
    return _port_flat(tsteps.param_tree(model))


def test_train_restart_reproduces(tmp_path):
    """Stop at step 7, resume from the checkpoint: the parameters equal the
    uninterrupted run's bit for bit (with 10 steps the cosine never starts,
    so the schedule does not depend on ``steps``)."""
    full, _, _ = ttrain.train("qwen3-0.6b", steps=10, batch=2, seq=32,
                              log_every=100, device="cpu")
    ck = str(tmp_path / "ck")
    ttrain.train("qwen3-0.6b", steps=7, batch=2, seq=32, ckpt_dir=ck,
                 log_every=100, device="cpu")
    res, _, losses = ttrain.train("qwen3-0.6b", steps=10, batch=2, seq=32,
                                  ckpt_dir=ck, log_every=100, device="cpu")
    assert len(losses) == 3  # resumed at step 7
    for a, b in zip(_port_params(full), _port_params(res)):
        np.testing.assert_array_equal(a, b)


def _manifest(directory):
    steps = sorted(n for n in os.listdir(directory) if n.startswith("step_"))
    with open(os.path.join(directory, steps[-1], "manifest.json")) as f:
        m = json.load(f)
    return m["n_leaves"], [(lm["shape"], lm["dtype"]) for lm in m["leaves"]]


def test_resumes_a_checkpoint_the_reference_wrote(tmp_path, capsys):
    """The reference's 7-step run writes its checkpoints; the port's 10-step
    run restores step 6, runs steps 7-9, and ends within 1e-5 of each
    leaf's max of the reference's uninterrupted 10-step run (the step
    tolerance; no element needs the small-grad exception here). Both write
    the same leaves (count, order, shapes, dtypes)."""
    ref_ck, port_ck = str(tmp_path / "ref"), str(tmp_path / "port")
    jtrain.train("qwen3-0.6b", steps=7, batch=2, seq=32, ckpt_dir=ref_ck,
                 log_every=100)
    p_full, _, ref_losses = jtrain.train("qwen3-0.6b", steps=10, batch=2,
                                         seq=32, log_every=100)
    shutil.copytree(ref_ck, port_ck)
    capsys.readouterr()
    model, state, losses = ttrain.train("qwen3-0.6b", steps=10, batch=2,
                                        seq=32, ckpt_dir=port_ck,
                                        log_every=1, device="cpu")
    out = capsys.readouterr().out
    assert "[train qwen3-0.6b] step     7 loss" in out
    assert "step     6 loss" not in out
    assert len(losses) == 3 and int(state["step"]) == 10
    assert _manifest(port_ck) == _manifest(ref_ck)
    for a, b in zip(losses, ref_losses[7:]):
        assert abs(a - b) <= 1e-5 * abs(b)
    for p, w in zip(_port_params(model),
                    [np.asarray(a) for a in jax.tree.leaves(p_full)]):
        assert _rel(p, w) <= 1e-5


def test_cli_prints_the_reference_s_log_lines(capsys):
    """``python -m repro_torch.launch.train ... --device cpu`` prints the
    reference CLI's lines (the same steps, the same format; the losses
    differ, the weights being each package's own draws)."""
    args = ["--arch", "qwen3-0.6b", "--steps", "10", "--batch", "2",
            "--seq", "32"]
    jtrain.main(args)
    want = capsys.readouterr().out.splitlines()
    ttrain.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    line = re.compile(r"^\[train qwen3-0\.6b\] step +(\d+) loss \d+\.\d{4} "
                      r"\(\d+\.\d{3}s/step ewma\)$")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert line.match(g) and line.match(w), (g, w)
        assert g[:30] == w[:30]  # "[train qwen3-0.6b] step     N"


def test_cli_needs_the_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--arch", "qwen3-0.6b", "--steps", "1"])
