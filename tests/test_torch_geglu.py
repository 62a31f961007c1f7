"""Port GEGLU feed-forward (dpm_solver_tpu_torch/ops/geglu.py) against the JAX
`geglu_ff`: its Pallas kernel `_geglu_pallas` forced on in interpret mode,
its XLA composition `_ref_impl`, and its VJP (`_bwd`: jax.vjp of `_ref_impl`)
against the port's `geglu_vjp`, within 1e-5 of max|grad| in fp32.

The port takes w1 and w2 in torch's Linear layout, the JAX function their
transposes. On the CPU the wrapper takes its plain version. fp32 within
1e-4, the JAX package's own kernel bound (tests/test_geglu.py:38-39); bf16
within 2e-2 (a bf16 rounding of the gated tile and of the output may fall on
either side).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu.ops.geglu import _gelu_exact, _ref_impl
from dpm_solver_tpu.ops.geglu import geglu_ff as jax_geglu_ff
from dpm_solver_tpu_torch.ops import _build
from dpm_solver_tpu_torch.ops import geglu as port_geglu
from dpm_solver_tpu_torch.ops.geglu import geglu_ff, geglu_plain, geglu_vjp, gelu_exact

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# fp32 gradients: each within 1e-5 of its max|grad| (summation order only)
GRAD_TOL = 1e-5


def _make(m, d, inner, seed=0):
    rs = np.random.default_rng(seed)
    return (rs.standard_normal((m, d)).astype(np.float32),
            (rs.standard_normal((d, 2 * inner)) * 0.05).astype(np.float32),
            (rs.standard_normal((2 * inner,)) * 0.1).astype(np.float32),
            (rs.standard_normal((inner, d)) * 0.05).astype(np.float32),
            (rs.standard_normal((d,)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(128, 32, 128), (128, 64, 256)], ids=["one-tile", "two-tiles"])
def test_plain_matches_pallas_interpret(shape, dtype):
    x, w1, b1, w2, b2 = _make(*shape)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_geglu_ff(jnp.asarray(x, jdt), jnp.asarray(w1), jnp.asarray(b1),
                        jnp.asarray(w2), jnp.asarray(b2), True, True)  # force, interpret
    got = geglu_ff(torch.tensor(x).to(tdt), torch.tensor(w1.T).to(tdt), torch.tensor(b1),
                   torch.tensor(w2.T).to(tdt), torch.tensor(b2))
    assert got.dtype == tdt and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=TOL[dtype])


def test_plain_matches_xla_reference_leading_dims():
    x, w1, b1, w2, b2 = _make(2 * 45, 40, 100, seed=1)  # ragged rows and widths
    xb = x.reshape(2, 45, 40)
    want = _ref_impl(*(jnp.asarray(a) for a in (xb, w1, b1, w2, b2)))
    got = geglu_plain(*(torch.tensor(a) for a in (xb, w1.T, b1, w2.T, b2)))
    assert got.shape == xb.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL["float32"])


def test_gelu_is_the_exact_one():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    got = gelu_exact(torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(_gelu_exact(jnp.asarray(x))),
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(got, torch.nn.functional.gelu(torch.tensor(x)), rtol=0, atol=1e-6)


def _assert_grad_close(got, want, name):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.detach().float().numpy() - want).max()) / scale
    assert err <= GRAD_TOL, f"{name}: {err:.2e} of max|grad|"


def _port_args(x, w1, b1, w2, b2):
    """The JAX function's arguments as the port takes them (Linear layout)."""
    return (torch.tensor(x), torch.tensor(w1.T.copy()), torch.tensor(b1),
            torch.tensor(w2.T.copy()), torch.tensor(b2))


def _check_grads(got, want):
    """got: the port's (dx, dw1, db1, dw2, db2); want: JAX's, w1 and w2 transposed."""
    for name, g, w, t in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want,
                             (False, True, False, True, False)):
        _assert_grad_close(g.t() if t else g, w, name)


@pytest.mark.parametrize("shape", [(64, 32, 128), (90, 40, 100)], ids=["aligned", "ragged"])
def test_vjp_matches_jax_vjp(shape):
    """geglu_vjp is jax.vjp of `_ref_impl` (the JAX package's `_bwd`)."""
    x, w1, b1, w2, b2 = _make(*shape, seed=3)
    g = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(_ref_impl, *(jnp.asarray(a) for a in (x, w1, b1, w2, b2)))
    want = vjp(jnp.asarray(g))
    got = geglu_vjp(torch.tensor(g), *_port_args(x, w1, b1, w2, b2))
    assert all(a.dtype == torch.float32 for a in got)
    _check_grads(got, want)


def _backward(x, w1, b1, w2, b2, g):
    args = [t.clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
    with torch.enable_grad():
        out = geglu_ff(*args)
    assert out.grad_fn is not None
    out.backward(g)
    return out.detach(), [a.grad for a in args]


def test_cpu_call_differentiates():
    """With grad on, a CPU call takes the autograd Function: the forward is
    the plain twin's, the gradients those of jax.vjp."""
    x, w1, b1, w2, b2 = _make(48, 32, 64, seed=5)
    g = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    args = _port_args(x, w1, b1, w2, b2)
    out, grads = _backward(*args, torch.tensor(g))
    assert torch.equal(out, geglu_plain(*args))
    _, vjp = jax.vjp(_ref_impl, *(jnp.asarray(a) for a in (x, w1, b1, w2, b2)))
    _check_grads(grads, vjp(jnp.asarray(g)))


def test_card_call_carries_the_gradient(monkeypatch):
    """The card's branch returns what the kernels write, a tensor with no
    grad_fn; the autograd Function around it must still give every gradient.
    Here the launch is stood in for by the plain twin under no_grad."""
    launched = []

    def fake_launch(x2, w1, b1, w2, b2, plan):
        launched.append(plan.route)
        with torch.no_grad():
            return geglu_plain(x2, w1, b1, w2, b2)

    monkeypatch.setattr(_build, "device_type", lambda t, what: "cuda")
    monkeypatch.setattr(port_geglu, "geglu_launch", fake_launch)
    x, w1, b1, w2, b2 = _make(48, 32, 64, seed=7)
    g = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)
    args = _port_args(x, w1, b1, w2, b2)
    out, grads = _backward(*args, torch.tensor(g))
    assert launched == ["f32"]
    _, vjp = jax.vjp(_ref_impl, *(jnp.asarray(a) for a in (x, w1, b1, w2, b2)))
    _check_grads(grads, vjp(jnp.asarray(g)))
