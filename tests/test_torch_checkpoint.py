"""The port's checkpointing (``repro_torch/checkpoint``) on the CPU: the
counterparts of ``tests/test_checkpoint.py`` (roundtrip, an uncommitted
step ignored, a missing checkpoint raising, the manager's interval and
garbage collection, elastic restore), the reference's on-disk format
(each package restores what the other wrote, bit for bit), and a solver's
search block saved from a 4×1 grid restored into 2×2 and 1×4 solvers with
the same ``D_pad`` and row map.

The card's half (a CUDA leaf restored onto the card with its bits) is in
``tests/test_torch_cuda.py``.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as ref_restore
from repro.checkpoint import save as ref_save
from repro_torch.checkpoint import (CheckpointManager, latest_step, restore,
                                    save)
from repro_torch.core import FDConfig, FilterDiag, plan_rowmap
from repro_torch.matrices import get_family
from repro_torch.service.jobs import FilterDiagJob, state_template

DTYPES = [torch.float64, torch.float32, torch.complex128, torch.complex64,
          torch.int64, torch.int32]


def _tree(seed: int, dtype=torch.float64) -> dict:
    g = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point or dtype.is_complex:
        w = torch.randn((16, 8), generator=g, dtype=dtype)
        b = torch.randn((8,), generator=g, dtype=dtype)
    else:
        w = torch.randint(-1000, 1000, (16, 8), generator=g, dtype=dtype)
        b = torch.randint(-1000, 1000, (8,), generator=g, dtype=dtype)
    return {"layer": {"w": w, "b": b}, "step_count": torch.tensor(7)}


def _leaves(tree):
    return [tree["layer"]["b"], tree["layer"]["w"], tree["step_count"]]


@pytest.mark.parametrize("dtype", DTYPES)
def test_roundtrip(tmp_path, dtype):
    t = _tree(0, dtype)
    save(str(tmp_path), 5, t, extra={"pipeline_index": 5})
    t2, step, extra = restore(str(tmp_path), t, device="cpu")
    assert step == 5 and extra["pipeline_index"] == 5
    for a, b in zip(_leaves(t), _leaves(t2)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_uncommitted_ignored(tmp_path):
    t = _tree(0)
    save(str(tmp_path), 1, t)
    save(str(tmp_path), 2, t)
    # a crash mid-write: the newest step lost its commit marker
    os.remove(tmp_path / "step_00000002" / "_COMMITTED")
    assert latest_step(str(tmp_path)) == 1
    _, step, _ = restore(str(tmp_path), t)
    assert step == 1


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path), {"x": torch.zeros(3)})


def test_restore_refuses_a_changed_structure(tmp_path):
    save(str(tmp_path), 1, _tree(0))
    with pytest.raises(ValueError, match="structure"):
        restore(str(tmp_path), {"x": torch.zeros(3)})


def test_manager_interval_and_gc(tmp_path):
    m = CheckpointManager(str(tmp_path), interval=2, keep=2)
    t = _tree(1)
    saved = [i for i in range(10) if m.maybe_save(i, t)]
    assert saved == [0, 2, 4, 6, 8]
    kept = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert kept == ["step_00000006", "step_00000008"]


def test_manifest_is_the_reference_format(tmp_path):
    """``step_<8 digits>/``, ``arr_<i>.npy`` in sorted-key order, the
    manifest's step, n_leaves, extra, mesh and leaves, the marker."""
    t = _tree(3)
    save(str(tmp_path), 12, t, specs={"layer": {"w": [["row", "col"], None]}},
         extra={"k": [1, 2.5]}, grid=(2, 4))
    path = tmp_path / "step_00000012"
    assert sorted(os.listdir(path)) == ["_COMMITTED", "arr_0.npy",
                                        "arr_1.npy", "arr_2.npy",
                                        "manifest.json"]
    meta = json.loads((path / "manifest.json").read_text())
    assert meta["step"] == 12 and meta["n_leaves"] == 3
    assert meta["extra"] == {"k": [1, 2.5]}
    assert meta["mesh"] == {"axes": ["row", "col"], "shape": [2, 4]}
    assert [lm["shape"] for lm in meta["leaves"]] == [[8], [16, 8], []]
    assert [lm["spec"] for lm in meta["leaves"]] == [
        None, [["row", "col"], None], None]
    for i, leaf in enumerate(_leaves(t)):
        assert np.array_equal(np.load(path / f"arr_{i}.npy"), leaf.numpy())


def _ref_tree(seed: int) -> dict:
    a, b = jax.random.split(jax.random.PRNGKey(seed))
    return {"layer": {"w": jax.random.normal(a, (16, 8)),
                      "b": jax.random.normal(b, (8,)).astype(jnp.float32)},
            "step_count": jnp.asarray(7)}


def test_reference_step_restores_in_the_port(tmp_path):
    t = _ref_tree(0)
    ref_save(str(tmp_path), 4, t, extra={"pipeline_index": 4})
    template = {"layer": {"w": torch.zeros((16, 8), dtype=torch.float64),
                          "b": torch.zeros(8)},
                "step_count": torch.tensor(0)}
    t2, step, extra = restore(str(tmp_path), template)
    assert step == 4 and extra == {"pipeline_index": 4}
    for want, got in ((t["layer"]["w"], t2["layer"]["w"]),
                      (t["layer"]["b"], t2["layer"]["b"]),
                      (t["step_count"], t2["step_count"])):
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype
        assert np.array_equal(got.numpy(), want)


def test_port_step_restores_in_the_reference(tmp_path):
    t = _tree(5)
    save(str(tmp_path), 9, t, extra={"note": "port"}, grid=(4, 1))
    template = {"layer": {"w": jnp.zeros((16, 8)), "b": jnp.zeros(8)},
                "step_count": jnp.asarray(0)}
    t2, step, extra = ref_restore(str(tmp_path), template)
    assert step == 9 and extra == {"note": "port"}
    for a, b in zip(_leaves(t), (t2["layer"]["b"], t2["layer"]["w"],
                                 t2["step_count"])):
        assert np.array_equal(np.asarray(b), a.numpy())


# --------------------------------------------- elastic restore of a solve --

SPIN = get_family("SpinChainXXZ", n_sites=8, n_up=4)
FD = dict(n_search=8, n_target=3, target=-1.5, tol=1e-8, max_iters=30)
GRIDS = [("panel", 2, 2), ("pillar", 1, 4), ("stack", 4, 1)]


@pytest.fixture(scope="module")
def saved_4x1(tmp_path_factory):
    """A solve on a 4×1 grid (commvol map at P = 4) stepped 3 iterations
    and checkpointed, and the same solve run to its end."""
    rm = plan_rowmap(SPIN, 4, balance="commvol")
    d = str(tmp_path_factory.mktemp("elastic"))
    fd = FilterDiag(SPIN, FDConfig(layout="stack", **FD), device="cpu",
                    n_row=4, n_col=1, rowmap=rm)
    job = FilterDiagJob(fd)
    state = job.init()
    for _ in range(3):
        state = job.step(state)
    tree, extra = job.pack(state)
    save(d, state.iteration, tree, specs=job.specs, extra=extra,
         grid=job.grid)
    V = state.V.clone()
    while not state.done:
        state = job.step(state)
    return d, rm, V, state.result


@pytest.mark.parametrize("layout,n_row,n_col", GRIDS)
def test_elastic_restore_across_grids(saved_4x1, layout, n_row, n_col):
    """The block saved from 4×1 restores bit for bit into a 2×2, 1×4 and
    4×1 solver of the same D_pad and row map, and the solve finishes with
    the uninterrupted 4×1 solve's eigenvalues (to 1e-9, the tolerance of
    solves across layouts)."""
    d, rm, V, clean = saved_4x1
    with open(os.path.join(d, "step_00000003", "manifest.json")) as f:
        assert json.load(f)["mesh"] == {"axes": ["row", "col"],
                                        "shape": [4, 1]}
    fd = FilterDiag(SPIN, FDConfig(layout=layout, **FD), device="cpu",
                    n_row=n_row, n_col=n_col, rowmap=rm)
    job = FilterDiagJob(fd)
    tree, step, extra = restore(d, job.template(), device="cpu")
    state = job.unpack(tree, extra)
    assert step == 3 and state.iteration == 3
    assert torch.equal(state.V, V)
    while not state.done:
        state = job.step(state)
    res = state.result
    assert res.iterations == clean.iterations
    assert np.abs(np.sort(res.eigenvalues)
                  - np.sort(clean.eigenvalues)).max() <= 1e-9


def test_state_template_matches_the_solver(saved_4x1):
    _, rm, _, _ = saved_4x1
    fd = FilterDiag(SPIN, FDConfig(layout="panel", **FD), device="cpu",
                    n_row=2, n_col=2, rowmap=rm)
    t = state_template(fd)
    assert t["V"].shape == (fd.D_pad, FD["n_search"])
    assert t["V"].dtype == fd.dtype and t["eigenvectors"].shape == (fd.D, 0)
