"""The port's ring-cache decode (``repro_torch.models.decode``) against the
reference's (``repro.models.decode``) on the CPU.

Each decodable SMOKE config runs prefill on a 16-token prompt and three
greedy decode steps in both packages, from the reference's weights
(``init_params(cfg, PRNGKey(0))``, carried across by
``convert.lm_params_from_arrays``), fp32: every step's logits and every
decode-state leaf to 1e-4 of their largest magnitude. At 16 tokens
RWKV6 prefills through the per-token scan and Hymba's 16-deep
sliding-window rings wrap at the first decode step.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import decode as jdec
from repro.models import steps as jsteps
from repro.models import transformer as jtfm
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import attention as tattn
from repro_torch.models import decode as tdec
from repro_torch.models import steps as tsteps
from repro_torch.models import transformer as ttfm

DECODABLE = [a for a in jconfigs.ARCHS
             if not jconfigs.get_config(a).encoder_only]
PROMPT, MAX_LEN, STEPS = 16, 48, 3


def _close(got, want, tol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol * scale, (err, scale)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.cache
def _ref_params(arch):
    jcfg = jconfigs.get_smoke_config(arch)
    return jcfg, jtfm.init_params(jcfg, jax.random.PRNGKey(0))


def _port_model(arch):
    jcfg, params = _ref_params(arch)
    cfg = convert.model_config_from_fields(jcfg)
    return cfg, convert.lm_params_from_arrays(
        cfg, jax.tree.map(np.asarray, params), device="cpu")


@pytest.fixture(scope="module", params=DECODABLE)
def decoded(request):
    """Prefill and three decode steps in both packages; the tokens fed at
    each step are the reference's greedy choices."""
    arch = request.param
    jcfg, params = _ref_params(arch)
    cfg, model = _port_model(arch)
    jb = jsteps.make_batch(jcfg, 2, PROMPT)
    tb = tsteps.make_batch(cfg, 2, PROMPT, device="cpu")
    if cfg.family != "vlm":
        jb, tb = {"tokens": jb["tokens"]}, {"tokens": tb["tokens"]}
    jl, jst = jax.jit(jsteps.make_prefill_step(jcfg, MAX_LEN))(params, jb)
    tl, tst = tsteps.make_prefill_step(cfg, MAX_LEN)(model, tb)
    jstep = jax.jit(jsteps.make_decode_step(jcfg))
    tstep = tsteps.make_decode_step(cfg)
    ref_start = convert.decode_state_from_arrays(
        jax.tree.map(np.asarray, jst), device="cpu")
    steps = []
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for pos in range(PROMPT, PROMPT + STEPS):  # a VLM's patches included
        jl, jst = jstep(params, jst, jnp.asarray(tok), jnp.asarray(pos, jnp.int32))
        tl, tst = tstep(model, tst, torch.as_tensor(tok), pos)
        steps.append(dict(jl=np.asarray(jl), tl=tl.clone(),
                          jst=jax.tree.map(np.asarray, jst),
                          tst=[{k: v.clone() for k, v in s.items()}
                               for s in tst], tok=tok, pos=pos))
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    return dict(arch=arch, cfg=cfg, model=model, steps=steps,
                ref_start=ref_start, tstep=tstep)


def test_decode_logits_match_the_reference(decoded):
    for s in decoded["steps"]:
        assert s["tl"].shape == (2, decoded["cfg"].vocab)
        _close(s["tl"], s["jl"], 1e-4)


def test_decode_state_matches_the_reference(decoded):
    for s in decoded["steps"]:
        for js, ts in zip(s["jst"], s["tst"], strict=True):
            assert sorted(js) == sorted(ts)
            for k in js:
                _close(ts[k], js[k], 1e-4)


def test_decode_from_the_reference_state(decoded):
    """Decode started from the reference's prefill state, carried across
    by ``convert.decode_state_from_arrays``, gives the reference's first
    step."""
    s = decoded["steps"][0]
    tl, _ = decoded["tstep"](decoded["model"], decoded["ref_start"],
                             torch.as_tensor(s["tok"]), s["pos"])
    _close(tl, s["jl"], 1e-4)


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", DECODABLE)
def test_init_decode_state_shapes_equal_the_reference(arch, size):
    get = "get_smoke_config" if size == "smoke" else "get_config"
    jcfg = getattr(jconfigs, get)(arch)
    cfg = getattr(tconfigs, get)(arch)
    want = jax.eval_shape(lambda: jdec.init_decode_state(jcfg, 2, 4096))
    got = tdec.init_decode_state(cfg, 2, 4096, device="meta")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert tuple(g[k].shape) == w[k].shape, (k, g[k].shape)
            assert str(g[k].dtype).removeprefix("torch.") == w[k].dtype.name


# ------------------------------------------------------------ ring caches --

@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("pos", [0, 3, 7, 8, 21])
def test_ring_attend_matches_the_reference(pos, window, rng):
    """The ring's slot positions p_j = pos - ((pos - j) % W), a floor
    modulo, including slots not yet written (pos < W) and after wraps."""
    cfg = tconfigs.get_smoke_config("hymba-1.5b")
    jcfg = jconfigs.get_smoke_config("hymba-1.5b")
    W, H, hd = 8, cfg.n_kv_heads, cfg.hd
    q = rng.standard_normal((2, 1, cfg.n_heads, hd)).astype(np.float32)
    ck = rng.standard_normal((2, W, H, hd)).astype(np.float32)
    cv = rng.standard_normal((2, W, H, hd)).astype(np.float32)
    got = tdec.ring_attend(cfg, _t(q), _t(ck), _t(cv), pos, window)
    want = jdec.ring_attend(None, jcfg, jnp.asarray(q), jnp.asarray(ck),
                            jnp.asarray(cv), jnp.asarray(pos, jnp.int32),
                            window)
    _close(got, want, 1e-6)
    k = rng.standard_normal((2, 1, H, hd)).astype(np.float32)
    jk, _ = jdec.ring_update(jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(k),
                             jnp.asarray(k), jnp.asarray(pos, jnp.int32))
    tk, _ = tdec.ring_update(_t(ck), _t(cv), _t(k), _t(k), pos)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


@pytest.mark.parametrize("window", [0, 6])
def test_flat_cache_decode_attention_matches_the_reference(window, rng):
    jcfg, params = _ref_params("qwen3-0.6b")
    cfg, model = _port_model("qwen3-0.6b")
    jp = jax.tree.map(lambda a: a[0], params["segments"][0]["attn"])
    tp = model.segments[0][0].attn
    jc = jattn.init_kv_cache(jcfg, 2, 12, layers=1)
    tc = tattn.init_kv_cache(cfg, 2, 12, layers=1)
    jk, jv, tk, tv = jc["k"][0], jc["v"][0], tc["k"][0], tc["v"][0]
    for pos in range(9):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jk, jv = jattn.decode_attention(jp, jcfg, jnp.asarray(x), jk, jv,
                                            jnp.asarray(pos, jnp.int32),
                                            window=window)
        with torch.no_grad():
            ty, tk, tv = tattn.decode_attention(tp, cfg, _t(x), tk, tv, pos,
                                                window=window)
        _close(ty, jy, 1e-5)
        _close(tk, jk, 1e-6)


def test_hymba_ring_wrap_decode_equals_the_full_forward():
    """Hymba decode across its 16-token window boundary equals the full
    forward of the grown sequence (the port against itself, as
    ``tests/test_models.py`` holds the reference)."""
    cfg, model = _port_model("hymba-1.5b")
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (1, 20), generator=g, dtype=torch.int32)
    logits, state = tsteps.make_prefill_step(cfg, 64)(model, {"tokens": toks})
    step = tsteps.make_decode_step(cfg)
    seq = toks
    for pos in range(20, 26):  # crosses the 16-token window repeatedly
        nxt = torch.tensor([[pos % cfg.vocab]], dtype=torch.int32)
        lg, state = step(model, state, nxt[:, 0], pos)
        seq = torch.cat([seq, nxt], dim=1)
        with torch.no_grad():
            x, p_, _, _ = ttfm.embed_batch(model, cfg, {"tokens": seq})
            h, _ = ttfm.backbone(model, cfg, x, p_)
            full = h[:, -1] @ ttfm.lm_head_table(model, cfg).T
        torch.testing.assert_close(lg, full, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", DECODABLE)
def test_decode_equals_the_full_forward_in_fp64(arch):
    """Every decodable family's decode, after prefill, equals the last
    position of one forward of the grown sequence to 1e-10 in fp64 (the
    MoE at a capacity that drops no token; the steps cross Hymba's
    16-token window)."""
    cfg, model = _port_model(arch)
    model = model.double().requires_grad_(False)
    cf = cfg.n_experts / cfg.top_k if cfg.n_experts else 1.25
    batch = tsteps.make_batch(cfg, 2, PROMPT, device="cpu")
    batch = {k: v.double() if v.is_floating_point() else v
             for k, v in batch.items() if k != "labels"}
    with torch.no_grad():
        logits, state = ttfm.backbone_with_state(model, cfg, batch, MAX_LEN,
                                                 capacity_factor=cf)
        toks = batch["tokens"]
        for pos in range(PROMPT, PROMPT + 6):
            nxt = logits.argmax(-1)
            logits, state = tdec.decode_step(model, cfg, state, nxt, pos)
            toks = torch.cat([toks, nxt[:, None].to(toks.dtype)], dim=1)
        x, positions, _, _ = ttfm.embed_batch(model, cfg,
                                              dict(batch, tokens=toks))
        h, _ = ttfm.backbone(model, cfg, x, positions, capacity_factor=cf)
        full = h[:, -1] @ ttfm.lm_head_table(model, cfg).T
    assert logits.dtype == torch.float64
    _close(logits, full.numpy(), 1e-10)
