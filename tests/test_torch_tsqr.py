"""TSQR, the Gram all-reduce and SVQB over P row shards, port against the
JAX package on the CPU, at P ∈ {2, 4, 8} on the same random block.

The reference runs ``make_tsqr``, ``make_gram`` and ``make_svqb`` in one
subprocess with 8 fake CPU devices on an Auto-axis mesh; the results come
back through an ``.npz``. Tolerance: 1e-12 relative, not bitwise — the
two backends' LAPACK QR and ``eigh`` round differently in the last bits
(as on one shard, ``tests/test_torch_spmv.py``), and the butterfly
multiplies those differences through log2(P) small QRs.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import ShardGroup, make_gram, make_svqb, make_tsqr
from tests.conftest import run_distributed

PS = (2, 4, 8)
D_PAD, NS = 8 * 40, 12
TOL = 1e-12

@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the blocks here are small, so more threads
    only contend with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REF_SCRIPT = r"""
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType
from repro.core import stack
from repro.core.orthogonalize import make_gram, make_svqb, make_tsqr
inp = np.load({inputs!r})
out = {{}}
for P in {ps!r}:
    mesh = jax.make_mesh((P, 1), ("row", "col"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:P])
    lay = stack(mesh)
    with mesh:
        for kind in ("real", "complex"):
            V, W = inp[kind + "_V"], inp[kind + "_W"]
            Q, R = jax.jit(make_tsqr(mesh, lay))(V)
            out[f"{{P}}_{{kind}}_Q"] = np.asarray(Q)
            out[f"{{P}}_{{kind}}_R"] = np.asarray(R)
            out[f"{{P}}_{{kind}}_G"] = np.asarray(
                jax.jit(make_gram(mesh, lay))(V, W))
            out[f"{{P}}_{{kind}}_S"] = np.asarray(
                jax.jit(make_svqb(mesh, lay))(V))
np.savez({path!r}, **out)
print("ok")
"""


def _blocks():
    rng = np.random.default_rng(42)
    out = {}
    for kind in ("real", "complex"):
        for name in ("V", "W"):
            a = rng.standard_normal((D_PAD, NS))
            if kind == "complex":
                a = a + 1j * rng.standard_normal((D_PAD, NS))
            out[f"{kind}_{name}"] = a
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("tsqr")
    np.savez(d / "inputs.npz", **_blocks())
    run_distributed(REF_SCRIPT.format(ps=PS, inputs=str(d / "inputs.npz"),
                                      path=str(d / "ref.npz")),
                    n_devices=8, timeout=600)
    return dict(np.load(d / "ref.npz"))


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("kind", ["real", "complex"])
@pytest.mark.parametrize("P", PS)
def test_tsqr_gram_svqb_match_reference(reference, P, kind):
    """Q, R, the Gram matrix and the SVQB basis within 1e-12 relative;
    Q is row-major and orthonormal, Q·R = V; each collective's bytes are
    counted (log2(P) ppermute rounds of R factors, one psum)."""
    inp = _blocks()
    V, W = (torch.from_numpy(inp[f"{kind}_{n}"]) for n in ("V", "W"))
    g = ShardGroup(P, "cpu")
    Q, R = make_tsqr(g)(V)
    S = V.element_size()
    assert g.calls["ppermute"] == int(np.log2(P))
    assert g.bytes["ppermute"] == int(np.log2(P)) * P * NS * NS * S
    assert Q.is_contiguous()
    k = f"{P}_{kind}"
    assert _rel(Q.numpy(), reference[k + "_Q"]) <= TOL
    assert _rel(R.numpy(), reference[k + "_R"]) <= TOL
    assert _rel((Q @ R).numpy(), V.numpy()) <= TOL
    eye = torch.eye(NS, dtype=V.dtype)
    assert (Q.conj().T @ Q - eye).abs().max() <= TOL
    G = make_gram(g)(V, W)
    assert g.calls["psum"] == 1 and g.bytes["psum"] == P * NS * NS * S
    assert _rel(G.numpy(), reference[k + "_G"]) <= TOL
    # SVQB's basis is eigh's eigenvectors, whose signs (phases) each
    # backend picks on its own: compare column by column up to them
    Sv = make_svqb(g)(V).numpy()
    Sr = reference[k + "_S"]
    phase = np.sum(Sv.conj() * Sr, axis=0)
    phase /= np.abs(phase)
    assert _rel(Sv * phase[None, :], Sr) <= TOL


def test_tsqr_keeps_pad_rows_zero():
    """A block whose last rows are padding (D = 310 of D_pad = 320 at
    P = 8) keeps them exactly zero in Q."""
    V = torch.from_numpy(_blocks()["real_V"]).clone()
    V[310:] = 0
    Q, _ = make_tsqr(ShardGroup(8, "cpu"))(V)
    assert not Q[310:].any()


def test_tsqr_needs_a_power_of_two():
    with pytest.raises(ValueError, match="power-of-two"):
        make_tsqr(ShardGroup(3, "cpu"))
