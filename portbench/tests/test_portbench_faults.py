"""The comparison that decides ``correct`` fails what it must: the
program's lower-precision path (the control) and a timed path broken
underneath a whole run (the look for a card skipped, a tiny cell on the
CPU, every other part of the run as it is), while a sound run passes."""
import json

import numpy as np
import pytest

import _tiny

from portbench import run
from portbench.reference import check
from repro_torch.core import FilterDiag
from repro_torch.core.shards import ShardGroup


def _result(capsys, tmp_path, traffic="stack_1x1", **fd):
    bench = _tiny.tiny_bench(_tiny.tiny_config(tmp_path, **fd))
    rc = run.main(["--workload", f"tiny.{traffic}", "--seed", "3000000007",
                   "--seconds", "0", "--trace", "0"], device="cpu",
                  bench=bench)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("traffic", ["stack_1x1", "pillar_1x4",
                                     "stack_4x1_compressed_overlap"])
def test_a_sound_run_is_correct(capsys, tmp_path, traffic):
    out = _result(capsys, tmp_path, traffic)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] == 1
    assert list(out)[-1] == "compared"
    for c in out["compared"].values():
        assert c["value"] <= c["limit"]
    # no memory reading on the CPU: peak_mem_gib is left out there
    assert set(out["metrics"]) == {"solve_s", "setup_s"}


def test_the_control_float32_fails(capsys, tmp_path):
    out = _result(capsys, tmp_path, dtype="float32")
    assert out["correct"] is False
    over = [k for k, c in out["compared"].items() if c["value"] > c["limit"]]
    assert over or out["failed"]


def test_a_filter_that_returns_its_state_unchanged_fails(capsys, tmp_path,
                                                         monkeypatch):
    def unchanged(self, state, cfg=None):
        state.pending = None
        state.iteration += 1
        return state

    monkeypatch.setattr(FilterDiag, "step_filter", unchanged)
    out = _result(capsys, tmp_path)
    assert out["correct"] is False


def test_the_exchange_left_out_fails(capsys, tmp_path, monkeypatch):
    real = ShardGroup.gather_ppermute

    def dropped(self, *a, **k):
        return real(self, *a, **k).zero_()

    monkeypatch.setattr(ShardGroup, "gather_ppermute", dropped)
    out = _result(capsys, tmp_path, "stack_4x1_compressed_overlap")
    assert out["correct"] is False


@pytest.mark.parametrize("part", ["eigenvalue", "eigenvector",
                                  "stepped_over"])
def test_an_answer_altered_where_it_is_produced_fails(capsys, tmp_path,
                                                      monkeypatch, part):
    """``stepped_over``: the pair nearest the target is replaced by the
    exact (n_target + 1)-th eigenpair, so every returned pair is sound and
    only the set is wrong."""
    real = FilterDiag.step_analyze
    A = check.operator(dict(reference="hubbard", matrix=_tiny.MATRIX))
    w, X = np.linalg.eigh(A.toarray())

    def altered(self, state, cfg=None, verbose=False):
        state = real(self, state, cfg, verbose)
        if state.done:
            r = state.result
            if part == "stepped_over":
                nearest = int(np.argmin(r.eigenvalues))
                r.eigenvalues = r.eigenvalues.copy()
                r.eigenvectors = r.eigenvectors.copy()
                r.eigenvalues[nearest] = w[_tiny.N_TARGET]
                r.eigenvectors[:, nearest] = X[:, _tiny.N_TARGET]
            elif part == "eigenvalue":
                r.eigenvalues = r.eigenvalues + np.where(
                    np.arange(len(r.eigenvalues)) == 0, 1e-7, 0.0)
            else:
                r.eigenvectors = r.eigenvectors.copy()
                r.eigenvectors[:, 0] = np.roll(r.eigenvectors[:, 0], 1)
        return state

    monkeypatch.setattr(FilterDiag, "step_analyze", altered)
    out = _result(capsys, tmp_path)
    assert out["correct"] is False
    if part == "stepped_over":
        c = out["compared"]
        assert c["resid"]["value"] <= c["resid"]["limit"]
        assert c["orth_err"]["value"] <= c["orth_err"]["limit"]
        assert c["eig_err"]["value"] > c["eig_err"]["limit"]
