"""The port's optimizer (``repro_torch.optim``) against the reference
(``repro.optim``) on the CPU.

The codecs (``_q8_encode``/``_q8_decode``, ``_store_v``/``_load_v`` in
int8 and bfloat16, the cross-pod ``_quantize``/``_dequantize``) are held
bit for bit on the same numpy inputs, sizes that are not a multiple of
the block included. The schedule is held to 1 ulp (fp32: both compute it
in fp32, their ``cos`` may round apart). One ``apply_updates`` from the
same params, grads and state: params and moments to 1e-6 of their
leaf's largest magnitude (XLA may contract the update's multiply-adds
into FMAs, torch does not), int8 codes within one step and only where the
reference's value before rounding lies within 1e-6 of a half. The
cross-pod reduce equals a numpy ring of the reference's codec bit for
bit, and the reference's ``make_cross_pod_reduce`` on a (2, 2, 2) pod ×
data × model mesh of 8 fake devices to fp32 rounding (1e-6).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._hypothesis_compat import given, settings, st
from tests.conftest import run_distributed

from repro import configs as jconfigs
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import steps as tsteps
from repro_torch.optim import adamw
from repro_torch.optim import compress

SIZES = [1, 96, 256, 257, 1000, 3 * 32 * 11]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread (more spin against the suite's
    other workers and add nothing here)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _equal(got, want):
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert _np(got).dtype == np.asarray(want).dtype


# ------------------------------------------------------------------ codecs --

@pytest.mark.parametrize("n", SIZES)
def test_q8_codec_bit_equal(n, rng):
    x = (rng.standard_normal(n) * 10.0 ** rng.uniform(-6, 3, n)).astype(
        np.float32)
    x[::7] = 0.0
    jc, js = jadamw._q8_encode(jnp.asarray(x))
    tc, ts = adamw._q8_encode(_t(x))
    _equal(tc, jc)
    _equal(ts, js)
    _equal(adamw._q8_decode(tc, ts, (n,)), jadamw._q8_decode(jc, js, (n,)))


@pytest.mark.parametrize("dt", ["int8", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 32), (3, 96), (1000,), (5, 17, 9)])
def test_second_moment_store_load_bit_equal(dt, shape, rng):
    v = np.square(rng.standard_normal(shape) * 10.0 ** rng.uniform(
        -8, 1, shape)).astype(np.float32)
    v.reshape(-1)[::5] = 0.0
    js = jadamw._store_v(jnp.asarray(v), dt)
    ts = adamw._store_v(_t(v), dt)
    if dt == "int8":
        _equal(ts[0], js[0])
        _equal(ts[1], js[1])
    else:
        _equal(ts.float(), np.asarray(js).astype(np.float32))
    jl = jadamw._load_v(js, dt, shape)
    _equal(adamw._load_v(ts, dt, shape), jl)
    # the first moment's pair too
    jm = jadamw._store(jnp.asarray(v - v.mean()), dt)
    tm = adamw._store(_t(v - v.mean()), dt)
    _equal(adamw._load(tm, dt, shape), jadamw._load(jm, dt, shape))


@pytest.mark.parametrize("n", SIZES + [512, 513, 4096 + 3])
def test_compress_codec_bit_equal(n, rng):
    x = rng.standard_normal(n).astype(np.float32)
    jc, js = jcompress._quantize(jnp.asarray(x))
    tc, ts = compress._quantize(_t(x))
    _equal(tc, jc)
    _equal(ts, js)
    _equal(compress._dequantize(tc, ts, (n,)),
           jcompress._dequantize(jc, js, (n,)))


# ---------------------------------------------------------------- schedule --

@pytest.mark.parametrize("warmup,total", [(10, 60), (5, 60), (100, 10_000),
                                          (0, 1), (10, 7)])
def test_lr_schedule_within_one_ulp(warmup, total):
    cfg = jadamw.AdamWConfig(lr=3e-3, warmup_steps=warmup, total_steps=total)
    tcfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=warmup, total_steps=total)
    for s in range(61):
        want = np.asarray(jadamw._lr_at(cfg, jnp.asarray(s, jnp.int32)))
        got = adamw._lr_at(tcfg, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and want.dtype == np.float32
        ulp = np.spacing(np.float32(abs(want)))
        assert abs(float(got) - float(want)) <= ulp, (s, float(got),
                                                       float(want))


# --------------------------------------------------------- apply_updates --

SHAPES = {"w": (64, 32), "b": (32,), "scale": (3, 96), "q_norm": (3, 32),
          "big": (2, 700), "layers": (4, 16, 32)}


def _toy(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _port_tree(arrays, stacked=("scale", "q_norm", "layers")):
    """The port's params: a stacked leaf held as per-layer tensors."""
    return {k: adamw.Stack(_t(a) for a in v) if k in stacked else _t(v)
            for k, v in arrays.items()}


@pytest.mark.parametrize("dt", ["float32", "bfloat16", "int8"])
def test_apply_updates_matches_the_reference(dt, rng):
    kw = dict(lr=1e-2, moment_dtype=dt, warmup_steps=2, total_steps=10)
    jcfg, tcfg = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    p0, g0, g1 = _toy(rng), _toy(rng, 0.3), _toy(rng, 0.3)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    step = jax.jit(functools.partial(jadamw.apply_updates, jcfg))
    # a first reference step gives a non-zero state to start both from
    jp, jst, _ = step(jp, {k: jnp.asarray(v) for k, v in g0.items()},
                      jadamw.init_state(jcfg, jp))
    host = jax.tree.map(np.asarray, (jp, jst))
    tp = _port_tree(host[0])
    tst = convert.opt_state_from_arrays(tcfg, host[1], device="cpu")
    jp2, jst2, jm = step(jp, {k: jnp.asarray(v) for k, v in g1.items()}, jst)
    tst2, tm = adamw.apply_updates(tcfg, tp, _port_tree(g1), tst)
    assert int(tst2["step"]) == int(jst2["step"]) == 2
    for k in ("grad_norm", "lr"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-6 * abs(float(jm[k]))
    flips = 0
    for k in SHAPES:
        want = np.asarray(jp2[k])
        got = _np(adamw.value(tp[k]))
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), k
        for mom in ("m", "v"):
            jw, tw = jst2[mom][k], tst2[mom][k]
            if dt != "int8":
                a, b = np.asarray(jw).astype(np.float32), _np(tw.float())
                assert np.abs(b - a).max() <= 1e-6 * np.abs(a).max(), (k, mom)
                continue
            _close_scales(tw[1], jw[1], 1e-6)
            diff = np.abs(_np(tw[0]).astype(int) - np.asarray(jw[0]).astype(
                int))
            assert diff.max() <= 1
            if diff.any():  # only at a value that rounds either way
                x = _pre_round(jcfg, mom, jst, jnp.asarray(g1[k]), jm, k)
                frac = np.abs(np.abs(x - np.trunc(x)) - 0.5)
                assert (frac[diff == 1] <= 1e-6 * np.maximum(
                    1, np.abs(x[diff == 1]))).all(), (k, mom)
                flips += int(diff.sum())
    print(f"{dt}: int8 codes one step apart: {flips}")


@pytest.mark.parametrize("chunk", [600, 1100])  # 1 or 2 layers a piece
@pytest.mark.parametrize("dt", ["float32", "bfloat16", "int8"])
def test_update_in_pieces_equals_the_stacked_leaf(dt, chunk, rng,
                                                  monkeypatch):
    """A Stack whose layers hold whole int8 blocks ("layers": 512 a layer)
    is updated a few layers at a time; every leaf ends with the bits of
    the same update on the stacked tensor. (The clip is kept at 1: the global
    norm sums a Stack's squares layer by layer, another order.)"""
    cfg = adamw.AdamWConfig(lr=1e-2, moment_dtype=dt, warmup_steps=2,
                            grad_clip=1e3)
    monkeypatch.setattr(adamw, "UPDATE_CHUNK", chunk)
    p0, g0, g1 = _toy(rng), _toy(rng, 0.3), _toy(rng, 0.3)
    trees = [(_port_tree(p0), _port_tree), (_port_tree(p0, ()),
                                            lambda a: _port_tree(a, ()))]
    out = []
    for params, make in trees:
        state = adamw.init_state(cfg, params)
        for g in (g0, g1):
            state, m = adamw.apply_updates(cfg, params, make(g), state)
        out.append((params, state, float(m["grad_norm"])))
    (a, sa, na), (b, sb, nb) = out
    assert abs(na - nb) <= 1e-6 * nb
    for k in SHAPES:
        assert torch.equal(adamw.value(a[k]), b[k]), k
        for mom in ("m", "v"):
            x, y = sa[mom][k], sb[mom][k]
            for u, w in zip(*((x, y) if dt == "int8" else ((x,), (y,)))):
                assert torch.equal(u, w), (k, mom)


def _close_scales(got, want, tol):
    a, b = np.asarray(want), _np(got)
    assert np.abs(b - a).max() <= tol * np.abs(a).max()


def _pre_round(cfg, mom, state, g, metrics, k):
    """The reference's moment of leaf ``k`` over its block scale, before
    rounding to a code (its ``blk / scale`` in ``_q8_encode``)."""
    gn = metrics["grad_norm"]
    clip = jnp.minimum(1.0, cfg.grad_clip / jnp.maximum(gn, 1e-12))
    g = g.astype(jnp.float32) * clip
    shape = g.shape
    if mom == "m":
        x = cfg.b1 * jadamw._load(state["m"][k], "int8", shape) + \
            (1 - cfg.b1) * g
    else:
        v = cfg.b2 * jadamw._load_v(state["v"][k], "int8", shape) + \
            (1 - cfg.b2) * g * g
        x = jnp.sqrt(jnp.maximum(v, 0.0))
    flat = np.asarray(x, np.float32).reshape(-1)
    blk = np.pad(flat, (0, (-flat.size) % jadamw.BLOCK)).reshape(
        -1, jadamw.BLOCK)
    scale = np.abs(blk).max(axis=1, keepdims=True) / np.float32(127.0)
    return blk / np.maximum(scale, np.float32(1e-30))


# ------------------------------------- the counterparts of test_optim.py --

def _run_steps(moment_dtype, n=120):
    cfg = adamw.AdamWConfig(lr=5e-2, moment_dtype=moment_dtype, grad_clip=1e3,
                            warmup_steps=2, total_steps=n, weight_decay=0.0)
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((64, 32), generator=g),
              "b": torch.randn((32,), generator=g)}
    state = adamw.init_state(cfg, params)
    for _ in range(n):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss = sum(torch.sum((a - 1.0) ** 2) for a in leaves.values())
        loss.backward()
        state, _ = adamw.apply_updates(cfg, params,
                                       {k: v.grad for k, v in leaves.items()},
                                       state)
    return params, float(loss.detach())


def test_adamw_descends():
    _, l32 = _run_steps("float32")
    assert l32 < 400.0  # started at ~4100 (sum of squares of N(0,1)-1)


@pytest.mark.parametrize("dt", ["bfloat16", "int8"])
def test_quantized_moments_track_fp32(dt):
    p32, l32 = _run_steps("float32")
    pq, lq = _run_steps(dt)
    assert lq < 2.5 * l32 + 50.0, (dt, lq, l32)
    for k in p32:
        err = float((p32[k] - pq[k]).abs().max())
        assert err < 0.5, (dt, err)


@given(seed=st.integers(0, 1000), scale=st.floats(1e-6, 1e3))
@settings(max_examples=20, deadline=None)
def test_q8_roundtrip_error_bound(seed, scale):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal(1000) * scale, dtype=torch.float32)
    codes, scales = adamw._q8_encode(x)
    y = adamw._q8_decode(codes, scales, x.shape)
    blockmax = float(x.abs().max())
    assert float((y - x).abs().max()) <= blockmax / 127.0 + 1e-12


def test_grad_clip_applied():
    cfg = adamw.AdamWConfig(grad_clip=1e-3, moment_dtype="float32")
    params = {"w": torch.ones((8,))}
    st_ = adamw.init_state(cfg, params)
    _, m = adamw.apply_updates(cfg, params, {"w": torch.full((8,), 1e3)}, st_)
    assert float(m["grad_norm"]) > 1e3  # reported raw norm
    assert float((params["w"] - 1.0).abs().max()) < 0.1


def test_int8_state_has_the_reference_leaf_shapes():
    """qwen3-0.6b SMOKE in int8: every (codes, scales) pair has the
    reference's shape, blocks over the stacked leaf ([3, 32] q_norm: one
    block of 96, not three of 32)."""
    jcfg = jconfigs.get_smoke_config("qwen3-0.6b")
    jst = jax.eval_shape(lambda: jadamw.init_state(
        jadamw.AdamWConfig(moment_dtype="int8"),
        jtfm.init_params(jcfg, jax.random.PRNGKey(0))))
    cfg = tconfigs.get_smoke_config("qwen3-0.6b")
    _, tst = tsteps.init_train_state(
        cfg, adamw.AdamWConfig(moment_dtype="int8"), device="cpu")
    for mom in ("m", "v"):
        want = [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p),
                 tuple(a.shape), a.dtype.name)
                for p, a in jax.tree_util.tree_flatten_with_path(jst[mom])[0]]
        got = [(path, tuple(t.shape), str(t.dtype).removeprefix("torch."))
               for path, t in _leaves(tst[mom])]
        assert got == want, mom
    q = tst["m"]["segments"][0]["attn"]["q_norm"]
    assert tuple(q[0].shape) == (1, 256)


def _leaves(tree, prefix=()):
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        for i, t in enumerate(tree):
            yield from _leaves(t, prefix + (i,))


# ------------------------------------------------------- cross-pod reduce --

def _np_ring(gs, es):
    """The reference's algorithm in numpy: each pod quantizes g + e with
    the reference's ``_quantize``, keeps its own error, then sums the
    dequantized parts of the others in ring order."""
    n = len(gs)
    parts, errs = [], []
    for g, e in zip(gs, es):
        acc = g + e
        c, s = (np.asarray(a) for a in jcompress._quantize(jnp.asarray(acc)))
        own = np.asarray(jcompress._dequantize(jnp.asarray(c), jnp.asarray(s),
                                               g.shape))
        parts.append((c, s))
        errs.append(acc - own)
    means = []
    for i in range(n):
        c, s = parts[i]
        total = (c.astype(np.float32) * s).reshape(-1)[:gs[i].size].reshape(
            gs[i].shape)
        for shift in range(1, n):
            c, s = parts[(i - shift) % n]
            total = total + (c.astype(np.float32) * s).reshape(-1)[
                :gs[i].size].reshape(gs[i].shape)
        means.append(total / np.float32(n))
    return np.stack(means), np.stack(errs)


@pytest.mark.parametrize("n_pods", [2, 4])
def test_cross_pod_reduce_equals_a_numpy_ring(n_pods, rng):
    shapes = {"w": (16, 8), "b": (700,), "s": (3, 513)}
    red = compress.make_cross_pod_reduce(n_pods, device="cpu")
    err = {k: np.zeros((n_pods,) + s, np.float32) for k, s in shapes.items()}
    terr = {k: _t(v) for k, v in err.items()}
    for _ in range(2):  # the second step carries the error feedback
        g = {k: rng.standard_normal((n_pods,) + s).astype(np.float32)
             for k, s in shapes.items()}
        mean, terr = red({k: _t(v) for k, v in g.items()}, terr)
        for k in shapes:
            want_mean, want_err = _np_ring(list(g[k]), list(err[k]))
            _equal(mean[k], want_mean)
            _equal(terr[k], want_err)
            err[k] = want_err
            # within quantization error of the exact mean
            exact = g[k].mean(axis=0)
            assert np.abs(_np(mean[k]) - exact).max() < 0.1


def test_cross_pod_reduce_disabled_is_the_plain_mean(rng):
    g = rng.standard_normal((4, 33, 7)).astype(np.float32)
    e = rng.standard_normal((4, 33, 7)).astype(np.float32)
    red = compress.make_cross_pod_reduce(4, enabled=False, device="cpu")
    mean, err = red({"g": _t(g)}, {"g": _t(e)})
    want = ((g[0] + g[1]) + g[2] + g[3]) / np.float32(4)
    np.testing.assert_array_equal(_np(mean["g"]), np.broadcast_to(
        want, g.shape))
    _equal(err["g"], e)
    assert red.group.calls["ppermute"] == 0


def test_cross_pod_reduce_counts_int8_bytes(rng):
    n_pods, shape = 4, (1000, 3)  # 3,000 values: 6 blocks of 512
    red = compress.make_cross_pod_reduce(n_pods, device="cpu")
    g = _t(rng.standard_normal((n_pods,) + shape).astype(np.float32))
    red({"g": g}, {"g": torch.zeros_like(g)})
    n_blocks = -(-3000 // compress.BLOCK)
    per_shift = n_pods * n_blocks * (compress.BLOCK * 1 + 4)
    assert red.group.calls["ppermute"] == 2 * (n_pods - 1)
    assert red.group.bytes["ppermute"] == (n_pods - 1) * per_shift
    assert per_shift < n_pods * 3000 * 4 / 3  # not the fp32 gradient


_REF_REDUCE = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.optim.compress import make_cross_pod_reduce
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
rng = np.random.default_rng(3)
g = rng.standard_normal((2, 2, 16, 8)).astype(np.float32)  # [step, pod, ...]
out = {}
for name, spec in (("whole", P()), ("model", P(None, "model"))):
    red = make_cross_pod_reduce(mesh, {"w": spec}, enabled=True)
    inner = P(*spec) if len(spec) else P(None, None)
    pod_in = P("pod", *inner)
    to_pod = shard_map(lambda x: x[0], mesh=mesh, in_specs=(pod_in,),
                       out_specs=spec, check_rep=False)
    from_pod = shard_map(lambda x: x[None], mesh=mesh, in_specs=(spec,),
                         out_specs=pod_in, check_rep=False)
    e = {"w": to_pod(jnp.zeros((2, 16, 8), jnp.float32))}
    for s in range(2):
        gm, e = red({"w": to_pod(jnp.asarray(g[s]))}, e)
        out[(name, s, "mean")] = np.asarray(from_pod(gm["w"]))
        out[(name, s, "err")] = np.asarray(from_pod(e["w"]))
np.savez(OUT, **{"/".join(map(str, k)): v for k, v in out.items()}, g=g)
print("REF REDUCE OK")
"""


def test_cross_pod_reduce_matches_the_reference(tmp_path):
    """The reference's reduce on 8 fake devices, (pod, data, model) =
    (2, 2, 2), two steps with the error fed back: a leaf whole within each
    pod, and one split over ``model`` (its int8 blocks then run over each
    model shard, which the port reproduces by reducing each shard's
    columns on their own)."""
    path = str(tmp_path / "ref.npz")
    out = run_distributed(f"OUT = {path!r}\n" + _REF_REDUCE, n_devices=8)
    assert "REF REDUCE OK" in out
    ref = np.load(path)
    g = ref["g"]
    for name, cols in (("whole", [slice(0, 8)]),
                       ("model", [slice(0, 4), slice(4, 8)])):
        red = compress.make_cross_pod_reduce(2, device="cpu")
        errs = [torch.zeros((2, 16, c.stop - c.start)) for c in cols]
        for s in range(2):
            means = []
            for j, c in enumerate(cols):
                m, e = red({"w": _t(g[s][:, :, c])}, {"w": errs[j]})
                means.append(m["w"])
                errs[j] = e["w"]
            for got, key in ((torch.cat(means, dim=2), "mean"),
                             (torch.cat(errs, dim=2), "err")):
                want = ref[f"{name}/{s}/{key}"]
                assert np.abs(_np(got) - want).max() <= 1e-6 * max(
                    np.abs(want).max(), 1.0), (name, s, key)
