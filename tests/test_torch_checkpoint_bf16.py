"""bfloat16 leaves in the port's checkpoints, on the CPU.

numpy has no bfloat16 without ``ml_dtypes`` (which the card's machine
does not have), so the port writes a bf16 leaf as the reference writes it
through ``ml_dtypes``: its 2-byte bit patterns under the ``.npy`` descr
``'<V2'``, manifest dtype ``"bfloat16"``. A bf16 tree the reference
saved restores in the port with the same bits; the port's files for the
same tree are byte-equal to the reference's; and a training run in bf16
saves and resumes through ``launch.train``. (The reference's own
``restore`` cannot read its bf16 leaves back: ROADMAP, reference-side
drift.)
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save as ref_save
from repro_torch.checkpoint import restore, save
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as train_mod
from repro_torch.models import steps
from repro_torch.optim import adamw


def _values(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((16, 8)).astype(np.float32),
            "b": rng.standard_normal((8,)).astype(np.float32),
            "s": np.float32(2.5)}


def _port_tree(v: dict) -> dict:
    return {"layer": {"w": torch.from_numpy(v["w"]).to(torch.bfloat16),
                      "b": torch.from_numpy(v["b"])},
            "scale": torch.tensor(v["s"]).to(torch.bfloat16)}


def _ref_tree(v: dict) -> dict:
    return {"layer": {"w": jnp.asarray(v["w"], dtype=jnp.bfloat16),
                      "b": jnp.asarray(v["b"])},
            "scale": jnp.asarray(v["s"], dtype=jnp.bfloat16)}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_port_files_are_byte_equal_to_the_reference_s(tmp_path):
    v = _values(0)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_save(ref_dir, 3, _ref_tree(v))
    save(port_dir, 3, _port_tree(v))
    names = sorted(os.listdir(os.path.join(ref_dir, "step_00000003")))
    assert names == sorted(os.listdir(os.path.join(port_dir,
                                                   "step_00000003")))
    for n in names:
        with open(os.path.join(ref_dir, "step_00000003", n), "rb") as f:
            want = f.read()
        with open(os.path.join(port_dir, "step_00000003", n), "rb") as f:
            assert f.read() == want, n
    with open(os.path.join(port_dir, "step_00000003", "arr_1.npy"),
              "rb") as f:
        assert b"'descr': '<V2'" in f.read(128)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_bf16_leaves_restore_with_their_bits(tmp_path, writer):
    v = _values(1)
    want = _port_tree(v)
    if writer == "reference":
        ref_save(str(tmp_path), 5, _ref_tree(v))
    else:
        save(str(tmp_path), 5, want)
    got, step, _ = restore(str(tmp_path), want, device="cpu")
    assert step == 5
    for a, b in ((got["layer"]["w"], want["layer"]["w"]),
                 (got["layer"]["b"], want["layer"]["b"]),
                 (got["scale"], want["scale"])):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bf16_training_saves_and_resumes(tmp_path, monkeypatch, one_thread):
    """``launch.train``'s save path on a bf16 model (the SMOKE config cast
    to bf16, as ``--full`` trains): the checkpoint holds bf16 leaves and a
    resumed run starts from their bits."""
    smoke = get_smoke_config

    def bf16_smoke(arch):
        return dataclasses.replace(smoke(arch), dtype="bfloat16")

    monkeypatch.setattr(train_mod, "get_smoke_config", bf16_smoke)
    ckpt = str(tmp_path / "ckpt")
    model, opt, losses = train_mod.train("qwen3-0.6b", steps=3, batch=2,
                                         seq=16, ckpt_dir=ckpt, device="cpu")
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert sorted(os.listdir(ckpt))[-1] == "step_00000002"
    tree = (adamw.tree_map(adamw.value, steps.param_tree(model)), opt)
    saved, step, extra = restore(ckpt, tree, device="cpu")
    assert step == 2 and extra["pipeline_index"] == 2
    flat = adamw.tree_paths(tree)
    assert any(leaf.dtype == torch.bfloat16 for _, leaf in flat)
    for (_, a), (_, b) in zip(flat, adamw.tree_paths(saved)):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    # a resumed run reads the bf16 checkpoint back (nothing left to run)
    _, _, resumed = train_mod.train("qwen3-0.6b", steps=3, batch=2, seq=16,
                                    ckpt_dir=ckpt, device="cpu")
    assert resumed == []
