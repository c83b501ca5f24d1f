"""The port's training path (``repro_torch.models.steps.make_train_step``,
``repro_torch.launch.train``) against the reference on the CPU.

Every arch starts from the reference's ``init_params(cfg, PRNGKey(0))``
weights (``convert.lm_params_from_arrays``) and the same batch, in its
SMOKE config (fp32; an fp64 run is no tighter: both packages compute the
CE's logits and running sum in fp32 whatever the model's dtype):

* autograd's gradients against ``jax.grad`` of the reference's
  ``loss_fn``, each leaf of the reference's tree to 1e-4 of the leaf's
  largest magnitude;
* one ``make_train_step`` against the reference's: the metrics to 1e-5
  (relative), the moments m and v (linear in g) to 1e-4 of the leaf's
  max, the updated parameters to 1e-5 of the leaf's max, except where the
  reference's gradient is below 1e-3 of the leaf's max |g|: there Adam's
  first step ``g / (|g| + eps)`` can flip sign with rounding, and those
  elements are held to 2·lr (their count is printed).

The port's second step from the reference's first is held to 1e-4; two
free-running steps are not comparable (``test_two_adam_steps_amplify_a_
one_ulp_change``). Then the port alone: remat on and off give the same
loss and grads bit for bit, and two steps are finite and move the
parameters. The launcher is in ``tests/test_torch_train_launch.py``.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import steps as jsteps
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.models import steps as tsteps
from repro_torch.models import transformer as ttfm
from repro_torch.optim import adamw

ARCHS = jconfigs.ARCHS
BATCH, SEQ = 2, 32
OPT = dict(moment_dtype="float32", warmup_steps=2, total_steps=10)
SMALL_GRAD = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """SMOKE tensors are small: one intra-op thread (more spin against the
    suite's other workers and add nothing here)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _reference(arch):
    """The reference's weights, batch, grads and one train step."""
    jcfg = jconfigs.get_smoke_config(arch)
    params = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    batch = jsteps.make_batch(jcfg, BATCH, SEQ)
    grad = jax.jit(jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, jcfg, batch), has_aux=True))
    (loss, _), grads = grad(params)
    ocfg = jadamw.AdamWConfig(**OPT)
    step = jax.jit(jsteps.make_train_step(jcfg, ocfg))
    p1, o1, m1 = step(params, jadamw.init_state(ocfg, params), batch)
    p2, o2, m2 = step(p1, o1, batch)
    host = functools.partial(jax.tree.map, np.asarray)
    return dict(jcfg=jcfg, params=host(params), loss=float(loss),
                grads=host(grads), p1=host(p1), o1=host(o1),
                m1={k: float(v) for k, v in m1.items()}, p2=host(p2),
                o2=host(o2), m2={k: float(v) for k, v in m2.items()},
                batch=batch, step=step, grad=grad)


def _port(arch):
    ref = _reference(arch)
    cfg = convert.model_config_from_fields(ref["jcfg"])
    model = convert.lm_params_from_arrays(cfg, ref["params"], device="cpu")
    return ref, cfg, model, tsteps.make_batch(cfg, BATCH, SEQ, device="cpu")


def _flat(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


def _port_flat(tree):
    return [adamw.value(leaf).detach().numpy()
            for _, leaf in adamw.tree_paths(tree)]


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_to_arrays_inverts_from_arrays(arch):
    """The reference's tree through the port's model and back: the same
    structure, shapes, dtypes and values."""
    ref, _, model, _ = _port(arch)
    back = convert.lm_params_to_arrays(model)
    assert jax.tree.structure(back) == jax.tree.structure(ref["params"])
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref["params"])):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_jax_grad(arch):
    ref, cfg, model, batch = _port(arch)
    loss, _ = ttfm.loss_fn(model, cfg, batch)
    loss.backward()
    assert abs(float(loss) - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    got = _port_flat(tsteps.grad_tree(tsteps.param_tree(model)))
    want = _flat(ref["grads"])
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        assert _rel(g, w) <= 1e-4, (arch, i, _rel(g, w))


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_the_reference(arch):
    ref, cfg, model, batch = _port(arch)
    ocfg = adamw.AdamWConfig(**OPT)
    state = adamw.init_state(ocfg, tsteps.param_tree(model))
    step = tsteps.make_train_step(cfg, ocfg)
    model, state, metrics = step(model, state, batch)
    assert sorted(metrics) == sorted(ref["m1"])
    for k, want in ref["m1"].items():
        got = float(metrics[k])
        assert metrics[k].dim() == 0
        assert abs(got - want) <= 1e-5 * max(abs(want), 1e-30), (k, got, want)
    assert int(state["step"]) == 1
    for mom in ("m", "v"):
        for i, (g, w) in enumerate(zip(_port_flat(state[mom]),
                                       _flat(ref["o1"][mom]))):
            assert _rel(g, w) <= 1e-4, (arch, mom, i, _rel(g, w))
    lr = ref["m1"]["lr"]
    n_small = 0
    got = convert.lm_params_to_arrays(model)
    assert jax.tree.structure(got) == jax.tree.structure(ref["p1"])
    for i, (p, w, g) in enumerate(zip(_flat(got), _flat(ref["p1"]),
                                      _flat(ref["grads"]))):
        small = np.abs(g) < SMALL_GRAD * np.abs(g).max()
        err = np.abs(p - w)
        assert (err[~small] <= 1e-5 * np.abs(w).max()).all(), (arch, i)
        assert (err[small] <= 2 * lr).all(), (arch, i)
        n_small += int((small & (err > 1e-5 * np.abs(w).max())).sum())
    print(f"{arch}: {n_small} small-grad elements beyond 1e-5, within 2·lr")


@pytest.mark.parametrize("arch", ARCHS)
def test_second_train_step_from_the_reference_state(arch):
    """The port's second step from the reference's first (its parameters
    and moments carried across): metrics to 1e-5, parameters to 1e-4 of
    the leaf's max outside the small-grad elements of this step's grads
    (2·lr there). Two Adam steps held end to end could not be: they
    amplify fp32 rounding on the zero-init leaves
    (``test_two_adam_steps_amplify_a_one_ulp_change``)."""
    ref = _reference(arch)
    cfg = convert.model_config_from_fields(ref["jcfg"])
    model = convert.lm_params_from_arrays(cfg, ref["p1"], device="cpu")
    ocfg = adamw.AdamWConfig(**OPT)
    state = convert.opt_state_from_arrays(ocfg, ref["o1"], device="cpu")
    model, state, metrics = tsteps.make_train_step(cfg, ocfg)(
        model, state, tsteps.make_batch(cfg, BATCH, SEQ, device="cpu"))
    for k, want in ref["m2"].items():
        got = float(metrics[k])
        assert abs(got - want) <= 1e-5 * max(abs(want), 1e-30), (k, got, want)
    grads = _port_flat(tsteps.grad_tree(tsteps.param_tree(model)))
    lr = ref["m2"]["lr"]
    worst = 0.0
    for i, (p, w, g) in enumerate(zip(_port_flat(tsteps.param_tree(model)),
                                      _flat(ref["p2"]), grads)):
        small = np.abs(g) < SMALL_GRAD * np.abs(g).max()
        err = np.abs(p - w)
        if (~small).any():
            worst = max(worst, float(err[~small].max() / np.abs(w).max()))
        assert (err[small] <= 2 * lr).all(), (arch, i)
    print(f"{arch}: second step, worst parameter difference outside the "
          f"small-grad elements {worst:.3e} of its leaf's max")
    assert worst <= 1e-4


def test_two_adam_steps_amplify_a_one_ulp_change():
    """Pins why the card is held to the CPU step by step: in the reference
    itself, a 1-ulp nudge of hymba's weights moves a zero-init leaf
    (``dt_bias``, whose max after two steps is ≈ lr₁ + lr₂) by more than
    1e-4 of its max after two steps, outside the small-grad elements of
    either step. The first step's update ``lr·g/(|g| + eps)`` flips on
    near-zero grads; those ±lr moves reach every grad of the second step,
    which Adam then normalizes element by element."""
    ref = _reference("hymba-1.5b")
    params = ref["params"]
    rng = np.random.default_rng(0)
    nudged = jax.tree.map(lambda a: np.nextafter(a, np.where(
        rng.random(a.shape) < 0.5, np.inf, -np.inf).astype(a.dtype)), params)
    ocfg = jadamw.AdamWConfig(**OPT)
    step, batch = ref["step"], ref["batch"]
    ends, small = [], None
    for p in (params, nudged):
        st = jadamw.init_state(ocfg, p)
        for _ in range(2):
            g = jax.tree.map(np.asarray, ref["grad"](p)[1])
            now = [np.abs(x) < SMALL_GRAD * np.abs(x).max()
                   for x in jax.tree.leaves(g)]
            small = now if small is None else [a | b for a, b in
                                               zip(small, now)]
            p, st, _ = step(p, st, batch)
        ends.append(p)
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(ends[0])[0]]
    worst = {}
    for path, a, b, sm in zip(paths, _flat(ends[0]), _flat(ends[1]), small):
        if (~sm).any():
            worst[path] = float(np.abs(a - b)[~sm].max() / np.abs(a).max())
    top = max(worst, key=worst.get)
    print(f"hymba: 1-ulp nudge, two steps: {top} moves by {worst[top]:.3e} "
          f"of its max outside the small-grad elements")
    assert "dt_bias" in top and worst[top] > 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_bit(arch):
    _, cfg, model, batch = _port(arch)
    out = []
    for remat in (True, False):
        model.zero_grad(set_to_none=True)
        loss, _ = ttfm.loss_fn(model, dataclasses.replace(cfg, remat=remat),
                               batch)
        loss.backward()
        out.append((loss.detach(), _port_flat(tsteps.grad_tree(
            tsteps.param_tree(model)))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_train_step(arch):
    """The counterpart of ``tests/test_models.py::test_smoke_train_step``:
    two steps are finite and the parameters move."""
    _, cfg, model, batch = _port(arch)
    w0 = adamw.value(adamw.tree_paths(tsteps.param_tree(model))[0][1]).clone()
    ocfg = adamw.AdamWConfig(**OPT)
    state = adamw.init_state(ocfg, tsteps.param_tree(model))
    step = tsteps.make_train_step(cfg, ocfg)
    for _ in range(2):
        model, state, m = step(model, state, batch)
        assert np.isfinite(float(m["loss"])), arch
    w1 = adamw.value(adamw.tree_paths(tsteps.param_tree(model))[0][1])
    assert not torch.equal(w0, w1)
