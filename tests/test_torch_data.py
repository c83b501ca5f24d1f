"""The port's token pipeline (``repro_torch.data``) against the reference
(``repro.data``) on the CPU: every batch bit for bit, dtypes included
(bf16 features and patches rounded from fp32 as JAX rounds them), and the
counterparts of ``tests/test_data.py``."""
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import DataConfig as JDataConfig
from repro.data import TokenPipeline as JTokenPipeline
from repro_torch import configs as tconfigs
from repro_torch.data import DataConfig, TokenPipeline


def _host(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "hubert-xlarge",
                                  "internvl2-1b", "rwkv6-1.6b"])
def test_batches_bit_equal_to_the_reference(arch, size):
    get = "get_smoke_config" if size == "smoke" else "get_config"
    jcfg = getattr(jconfigs, get)(arch)
    cfg = getattr(tconfigs, get)(arch)
    for seed in (1234, 7):
        jp = JTokenPipeline(jcfg, JDataConfig(seed=seed))
        tp = TokenPipeline(cfg, DataConfig(seed=seed), device="cpu")
        np.testing.assert_array_equal(tp.succ, jp.succ)
        for index, (b, s) in ((0, (2, 24)), (5, (3, 32)), (123, (2, 40))):
            want = jp.batch(index, b, s)
            got = tp.batch(index, b, s)
            assert sorted(got) == sorted(want)
            for k in want:
                w = np.asarray(want[k])
                assert str(got[k].dtype).removeprefix("torch.") == \
                    w.dtype.name, k
                if w.dtype.name == "bfloat16":
                    w = w.astype(np.float32)
                np.testing.assert_array_equal(_host(got[k]), w, err_msg=k)


def test_deterministic_and_restartable():
    cfg = tconfigs.get_smoke_config("qwen3-0.6b")
    p1 = TokenPipeline(cfg, DataConfig(seed=7), device="cpu")
    p2 = TokenPipeline(cfg, DataConfig(seed=7), device="cpu")
    b1 = p1.batch(12, 4, 32)
    b2 = p2.batch(12, 4, 32)  # fresh pipeline, same index -> same batch
    assert torch.equal(b1["tokens"], b2["tokens"])
    b3 = p1.batch(13, 4, 32)
    assert not torch.equal(b1["tokens"], b3["tokens"])


def test_labels_are_shifted_tokens():
    cfg = tconfigs.get_smoke_config("qwen3-0.6b")
    b = TokenPipeline(cfg, device="cpu").batch(0, 2, 16)
    t, lab = b["tokens"], b["labels"]
    assert torch.equal(lab[:, :-1], t[:, 1:])
    assert (lab[:, -1] == -1).all()


def test_family_contracts():
    for arch in ("hubert-xlarge", "internvl2-1b", "rwkv6-1.6b"):
        cfg = tconfigs.get_smoke_config(arch)
        b = TokenPipeline(cfg, device="cpu").batch(0, 2, 24)
        if cfg.family == "audio":
            assert b["features"].shape == (2, 24, cfg.frontend_dim)
            assert b["mask"].shape == (2, 24)
        elif cfg.family == "vlm":
            npfx = b["patches"].shape[1]
            assert b["tokens"].shape[1] + npfx == 24
        else:
            assert b["tokens"].shape == (2, 24)
            assert int(b["tokens"].max()) < cfg.vocab


def test_structure_learnable():
    """The injected n-gram structure gives sub-uniform entropy."""
    cfg = tconfigs.get_smoke_config("qwen3-0.6b")
    pipe = TokenPipeline(cfg, device="cpu")
    toks = pipe.batch(0, 8, 256)["tokens"].numpy()
    cur = toks[:, :-1].reshape(-1)
    nxt = toks[:, 1:].reshape(-1)
    hit = (pipe.succ[cur] == nxt).mean()
    assert hit > 0.2  # chance level would be ~1/V


def test_pipeline_needs_the_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TokenPipeline(tconfigs.get_smoke_config("qwen3-0.6b"))
