"""The port's LM side (``repro_torch.models``) against the reference
(``repro.models``) on the CPU: configs, batches, layers, prefill and the
loss forward.

Every comparison runs the reference with the weights of
``repro.models.transformer.init_params(cfg, PRNGKey(0))``, carried across
by ``convert.lm_params_from_arrays``, and the same batch (``make_batch``
draws the same numpy values in both packages). fp32 throughout (the
SMOKE configs); prefill logits and decode-state leaves to 1e-4 of their
largest magnitude, the loss and the MoE aux loss to 1e-5 relative.
Decode is in ``tests/test_torch_lm_decode.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import config as jconfig
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models import steps as jsteps
from repro.models import transformer as jtfm
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import attention as tattn
from repro_torch.models import config as tconfig
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models import steps as tsteps
from repro_torch.models import transformer as ttfm

CPU = torch.device("cpu")
ARCHS = jconfigs.ARCHS
PROMPT, BATCH = 128, 2  # a multiple of ssm_chunk: RWKV6's chunked WKV


def _close(got, want, tol):
    """|got - want| ≤ tol · max|want|, elementwise over the arrays."""
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


def _pair(arch):
    """(reference cfg, its params, port cfg, the port's model with the
    reference's weights)."""
    jcfg, params = _ref_params(arch)
    cfg = convert.model_config_from_fields(jcfg)
    model = convert.lm_params_from_arrays(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, cfg, model.requires_grad_(False)


def _batches(jcfg, cfg, seq):
    jb = jsteps.make_batch(jcfg, BATCH, seq)
    tb = tsteps.make_batch(cfg, BATCH, seq, device="cpu")
    if cfg.family not in ("vlm", "audio"):  # prefill takes the tokens
        jb, tb = {"tokens": jb["tokens"]}, {"tokens": tb["tokens"]}
    return jb, tb


# ---------------------------------------------------------------- configs --

@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_and_counts_equal_the_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        j = getattr(jconfigs, get)(arch)
        t = getattr(tconfigs, get)(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), (arch, get)
        assert t.n_params() == j.n_params()
        assert t.n_active_params() == j.n_active_params()
        assert t.segments() == j.segments()
        assert (t.hd, t.q_dim, t.kv_dim, t.d_inner, t.is_subquadratic) == \
            (j.hd, j.q_dim, j.kv_dim, j.d_inner, j.is_subquadratic)
        assert convert.model_config_from_fields(j) == t
        assert {k: c and c.name for k, c in
                tconfig.applicable_shapes(t).items()} == \
            {k: c and c.name for k, c in jconfig.applicable_shapes(j).items()}


def test_registry_and_shape_cells_equal_the_reference():
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert tconfigs.EIGEN_CONFIGS == jconfigs.EIGEN_CONFIGS
    assert {k: dataclasses.asdict(v) for k, v in tconfig.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfig.SHAPES.items()}
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_bit_equal(arch, size):
    get = "get_smoke_config" if size == "smoke" else "get_config"
    jcfg = getattr(jconfigs, get)(arch)
    cfg = getattr(tconfigs, get)(arch)
    jb = jsteps.make_batch(jcfg, 2, 24, key=7)
    tb = tsteps.make_batch(cfg, 2, 24, key=7, device="cpu")
    assert sorted(jb) == sorted(tb)
    for k in jb:
        want = np.asarray(jb[k])
        got = tb[k]
        assert str(got.dtype).removeprefix("torch.") == want.dtype.name, k
        if want.dtype.name == "bfloat16":
            want, got = want.astype(np.float32), got.float()
        np.testing.assert_array_equal(got.numpy(), want, err_msg=k)


# ---------------------------------------------------------------- weights --

@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_shapes_and_distributions(arch):
    """The port's own draws have the reference tree's shapes, dtypes and
    scales (the draws are torch's, not JAX's)."""
    jcfg, params, cfg, carried = _pair(arch)
    g = torch.Generator().manual_seed(0)
    own = ttfm.init_params(cfg, g, device="cpu")
    ref = dict(carried.named_parameters())
    names = [n for n, _ in own.named_parameters()]
    assert names == list(ref)
    n_random = 0
    for n, p in own.named_parameters():
        assert p.shape == ref[n].shape and p.dtype == ref[n].dtype, n
        p, r = p.detach(), ref[n].detach()
        if torch.allclose(p, r, rtol=1e-6, atol=0):  # ones, zeros, A_log
            continue
        n_random += 1
        if r.numel() >= 512:  # a draw: the same scale
            assert abs(float(p.std() / r.std()) - 1) < 0.15, n
            assert abs(float(p.mean())) < 0.2 * float(r.std()), n
    assert n_random > 0


def test_lm_params_from_arrays_rejects_a_mismatch():
    jcfg, params = _ref_params("qwen3-0.6b")
    tree = jax.tree.map(np.asarray, params)
    bad = dict(tree, final_norm={"scale": np.ones(7, np.float32)})
    with pytest.raises(ValueError, match="final_norm"):
        convert.lm_params_from_arrays(jcfg, bad, device="cpu")
    extra = dict(tree, spare={"w": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="spare"):
        convert.lm_params_from_arrays(jcfg, extra, device="cpu")


def test_entry_points_need_the_card_unless_told_cpu():
    """With no card, the entry points raise rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = tconfigs.get_smoke_config("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttfm.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsteps.make_batch(cfg, 1, 4)
    jcfg, params = _ref_params("qwen3-0.6b")
    tree = jax.tree.map(np.asarray, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.lm_params_from_arrays(jcfg, tree)


# ----------------------------------------------------------------- layers --

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_the_reference(kind, rng):
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(48).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    jp = {"scale": jnp.asarray(scale)}
    n = tlayers.Norm(48, kind, torch.float32)
    n.scale.data = _t(scale)
    if kind == "layernorm":
        jp["bias"] = jnp.asarray(bias)
        n.bias.data = _t(bias)
    _close(n(_t(x)), jlayers.apply_norm(jp, jnp.asarray(x)), 1e-6)
    _close(tlayers.rms_head_norm(_t(scale[:8]), _t(x.reshape(2, 5, 6, 8))),
           jlayers.rms_head_norm(jnp.asarray(scale[:8]),
                                 jnp.asarray(x.reshape(2, 5, 6, 8))), 1e-6)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_the_reference(theta, rng):
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = np.arange(100, 109)
    _close(tlayers.apply_rope(_t(x), _t(pos), theta),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta), 1e-6)
    one = x[:, :1]  # a decode token at a single position
    _close(tlayers.apply_rope(_t(one), torch.tensor([4099]), theta),
           jlayers.apply_rope(jnp.asarray(one), jnp.asarray([4099]), theta),
           1e-5)


@pytest.mark.parametrize("act", ["swiglu", "squared_relu", "gelu"])
def test_mlp_matches_the_reference(act, rng):
    """``gelu`` is the tanh form, ``jax.nn.gelu``'s default."""
    cfg = dataclasses.replace(jconfigs.get_smoke_config("qwen3-0.6b"),
                              activation=act)
    jp = jlayers.init_mlp(jax.random.PRNGKey(3), 32, 64, cfg)
    m = tlayers.MLP(32, 64, act, torch.float32)
    for name, sub in jp.items():
        getattr(m, name).w.data = _t(sub["w"])
    x = rng.standard_normal((2, 7, 32)).astype(np.float32) * 2
    _close(m(_t(x)), jlayers.apply_mlp(jp, jnp.asarray(x), act), 1e-6)


@pytest.mark.parametrize("causal,window,chunk", [
    (True, 0, 1024), (True, 0, 16), (True, 7, 16), (False, 0, 16),
    (True, 40, 13)])
def test_chunked_attention_matches_the_reference(causal, window, chunk, rng):
    q = rng.standard_normal((2, 45, 6, 8)).astype(np.float32)
    k = rng.standard_normal((2, 45, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 45, 2, 8)).astype(np.float32)
    got = tattn.chunked_attention(_t(q), _t(k), _t(v), causal=causal,
                                  window=window, chunk=chunk, group=3)
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   window=window, chunk=chunk, group=3)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("S", [16, 128])
def test_rwkv_time_mix_matches_the_reference(S, rng):
    """S = 16 takes the per-token scan, S = 128 the chunked WKV, both from
    a carried state."""
    jcfg = jconfigs.get_smoke_config("rwkv6-1.6b")
    cfg = convert.model_config_from_fields(jcfg)
    jp = jssm.init_rwkv_time_mix(jax.random.PRNGKey(5), jcfg)
    tp = tssm.RWKVTimeMix(cfg, torch.float32)
    for name, a in jp.items():
        getattr(tp, name).data = _t(a)
    H, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    st = rng.standard_normal((2, H, hd, hd)).astype(np.float32) * 0.1
    xp = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    want = jssm.rwkv_time_mix(jp, jcfg, jnp.asarray(x), state=jnp.asarray(st),
                              x_prev=jnp.asarray(xp))
    got = tssm.rwkv_time_mix(tp, cfg, _t(x), state=_t(st), x_prev=_t(xp))
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


def test_wkv_chunked_equals_the_scan(rng):
    B, S, H, hd = 2, 128, 3, 8
    r, k, v = (_t(rng.standard_normal((B, S, H, hd)).astype(np.float32))
               for _ in range(3))
    w = _t(rng.uniform(0.9, 1.0, (B, S, H, hd)).astype(np.float32))
    u = _t(rng.standard_normal((H, hd)).astype(np.float32))
    s0 = _t(rng.standard_normal((B, H, hd, hd)).astype(np.float32))
    y1, s1 = tssm._wkv_chunked(r, k, v, w, u, s0, 32)
    y2, s2 = tssm._wkv_scan(r, k, v, w, u, s0)
    _close(y1, y2.numpy(), 1e-4)
    _close(s1, s2.numpy(), 1e-4)


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_block_matches_the_reference(with_state, rng):
    jcfg = jconfigs.get_smoke_config("hymba-1.5b")
    cfg = convert.model_config_from_fields(jcfg)
    jp = jssm.init_mamba(jax.random.PRNGKey(6), jcfg)
    tp = tssm.Mamba(cfg, torch.float32)
    for name, a in jp.items():
        getattr(tp, name).data = _t(a)
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if with_state:
        st = rng.standard_normal((2, cfg.d_inner, cfg.ssm_state)).astype(
            np.float32)
        cv = rng.standard_normal((2, 3, cfg.d_inner)).astype(np.float32)
        kw_j = dict(state=jnp.asarray(st), conv_state=jnp.asarray(cv))
        kw_t = dict(state=_t(st), conv_state=_t(cv))
    want = jssm.mamba_block(jp, jcfg, jnp.asarray(x), **kw_j)
    got = tssm.mamba_block(tp, cfg, _t(x), **kw_t)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


# -------------------------------------------------------------------- MoE --

@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "arctic-480b"])
def test_moe_output_aux_loss_and_routing(arch, capacity_factor, rng):
    """Layer 0's MoE on the same input: the experts chosen are equal, the
    aux loss to 1e-5 relative, the output (drops included at 1.25) to
    1e-5 of its largest value."""
    jcfg, params, cfg, model = _pair(arch)
    jp = jax.tree.map(lambda a: a[0], params["segments"][0]["moe"])
    tp = model.segments[0][0].moe
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    y, aux = jmoe.apply_moe(jp, jcfg, jnp.asarray(x),
                            capacity_factor=capacity_factor)
    ty, taux = tmoe.apply_moe(tp, cfg, _t(x), capacity_factor=capacity_factor)
    _close(ty, y, 1e-5)
    assert abs(float(taux) - float(aux)) <= 1e-5 * abs(float(aux))
    logits = (jnp.asarray(x).reshape(2, 24, -1) @ jp["router"]).astype(
        jnp.float32)
    _, want_idx = jax.lax.top_k(logits, cfg.top_k)
    _, _, idx = tmoe.route(tp, cfg, _t(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    # decode: each token's top-k experts evaluated directly
    _close(tmoe.apply_moe_decode(tp, cfg, _t(x[:, :1])),
           jmoe.apply_moe_decode(jp, jcfg, jnp.asarray(x[:, :1])), 1e-5)


def test_moe_dispatch_matches_per_token_dense_evaluation():
    """Capacity dispatch with no token dropped equals evaluating each
    token's top-k experts directly (the reference's own check)."""
    cfg = tconfig.ModelConfig(name="m", family="moe", n_layers=1, d_model=16,
                              n_heads=2, n_kv_heads=1, d_ff=8, vocab=32,
                              n_experts=4, top_k=2, dtype="float32")
    g = torch.Generator().manual_seed(0)
    p = tmoe.MoE(cfg, torch.float32).requires_grad_(False)
    p.reset_parameters(g)
    p.experts.reset_parameters(g)
    x = torch.randn((2, 6, 16), generator=g)
    y, aux = tmoe.apply_moe(p, cfg, x, capacity_factor=8.0)  # no drops
    y_ref = torch.cat([tmoe.apply_moe_decode(p, cfg, x[:, i:i + 1])
                       for i in range(6)], dim=1)
    torch.testing.assert_close(y, y_ref, rtol=2e-4, atol=2e-4)
    assert float(aux) >= 0.0


# ---------------------------------------------------------------- prefill --

@pytest.fixture(scope="module", params=ARCHS)
def prefilled(request):
    """One arch's prefill in both packages, the weights and batch shared."""
    arch = request.param
    jcfg, params, cfg, model = _pair(arch)
    jb, tb = _batches(jcfg, cfg, PROMPT)
    max_len = PROMPT + 8
    jl, jst = jax.jit(jsteps.make_prefill_step(jcfg, max_len))(params, jb)
    tl, tst = tsteps.make_prefill_step(cfg, max_len)(model, tb)
    return dict(arch=arch, jcfg=jcfg, cfg=cfg, params=params, model=model,
                jl=np.asarray(jl), jst=jax.tree.map(np.asarray, jst),
                tl=tl, tst=tst)


def test_prefill_logits_match_the_reference(prefilled):
    assert prefilled["tl"].shape == (BATCH, prefilled["cfg"].vocab)
    _close(prefilled["tl"], prefilled["jl"], 1e-4)


def test_prefill_decode_state_matches_the_reference(prefilled):
    jst, tst = prefilled["jst"], prefilled["tst"]
    assert len(tst) == len(jst) == len(prefilled["cfg"].segments())
    for js, ts in zip(jst, tst):
        assert sorted(js) == sorted(ts)
        for k in js:
            assert str(ts[k].dtype).removeprefix("torch.") == js[k].dtype.name
            _close(ts[k], js[k], 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_forward_matches_the_reference(arch):
    jcfg, params, cfg, model = _pair(arch)
    jb = jsteps.make_batch(jcfg, BATCH, 48)
    tb = tsteps.make_batch(cfg, BATCH, 48, device="cpu")
    jloss, jparts = jax.jit(lambda p, b: jtfm.loss_fn(p, jcfg, b))(params, jb)
    with torch.no_grad():
        tloss, tparts = ttfm.loss_fn(model, cfg, tb)
    for got, want in ((tloss, jloss), (tparts["ce"], jparts["ce"]),
                      (tparts["aux"], jparts["aux"])):
        assert abs(float(got) - float(want)) <= 1e-5 * max(abs(float(want)),
                                                          1e-30)
    assert np.isfinite(float(tloss))


def test_chunked_wkv_clamp_is_the_reference_s():
    """The chunked WKV clamps exp(-L_s) at e^30 (``ssm._EXP_CLAMP``), which
    is not exact once a chunk's cumulative decay passes e^-30: at a
    per-token decay of 0.6 (64·log w = -32.7) both packages' chunked forms
    stand ~20 % off the per-token recurrence, and equal to each other. At
    the decays the configs' init gives (w ≈ 0.998) the two forms agree."""
    rng = np.random.default_rng(0)
    B, S, H, hd = 1, 128, 2, 8
    r, k, v = (rng.standard_normal((B, S, H, hd)) for _ in range(3))
    u = rng.standard_normal((H, hd))
    s0 = np.zeros((B, H, hd, hd))
    for w0, off in ((0.998, False), (0.6, True)):
        w = np.full((B, S, H, hd), w0)
        args = (r, k, v, w, u, s0)
        jy, _ = jssm._wkv_chunked(*map(jnp.asarray, args), 64)
        ty, _ = tssm._wkv_chunked(*map(_t, args), 64)
        sy, _ = tssm._wkv_scan(*map(_t, args))
        _close(ty, jy, 1e-12)
        rel = float((ty - sy).abs().max() / sy.abs().max())
        assert (rel > 0.1) if off else (rel < 1e-12), (w0, rel)
