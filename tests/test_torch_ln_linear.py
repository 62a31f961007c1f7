"""Port LayerNorm -> Linear (dpm_solver_tpu_torch/ops/ln_linear.py) against the JAX
`ln_linear`: its Pallas kernel `_fused_call` in interpret mode with explicit
blocks, its XLA composition `ln_linear_reference`, and its VJP (`_bwd`:
jax.vjp of `ln_linear_reference`) against the port's `ln_linear_vjp`, within
1e-5 of max|grad| in fp32.

The port takes w in torch's Linear layout (n, d), the JAX function its
transpose (d, n). On the CPU the wrapper takes its plain version. fp32
within 1e-5; bf16 inputs within 2e-2, the JAX package's own kernel bound
(tests/test_ln_linear.py:32), since one bf16 rounding of the normalised rows
may fall on either side.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu.ops.ln_linear import layer_norm_fp32 as jax_layer_norm_fp32
from dpm_solver_tpu.ops.ln_linear import ln_linear as jax_ln_linear
from dpm_solver_tpu.ops.ln_linear import ln_linear_reference
from dpm_solver_tpu_torch.ops import _build
from dpm_solver_tpu_torch.ops.ln_linear import (layer_norm_fp32, ln_linear, ln_linear_plain,
                                                ln_linear_vjp)

# the module (the package's `ops.ln_linear` is the function)
port_ln_linear = importlib.import_module("dpm_solver_tpu_torch.ops.ln_linear")
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# fp32 gradients: each within 1e-5 of its max|grad| (summation order only)
GRAD_TOL = 1e-5


def _data(m, d, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (m, d)).astype(np.float32),
            rng.normal(1, 0.2, (d,)).astype(np.float32),
            rng.normal(0, 0.2, (d,)).astype(np.float32),
            rng.normal(0, d ** -0.5, (d, n)).astype(np.float32),
            rng.normal(0, 0.1, (n,)).astype(np.float32))


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(dtype, bias):
    x, g, b, w, c = _data(128, 32, 96)
    c = c if bias else None
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_ln_linear(jnp.asarray(x, jdt), jnp.asarray(g), jnp.asarray(b),
                         jnp.asarray(w, jdt), None if c is None else jnp.asarray(c),
                         1e-5, 64, 32, True)  # block_m, block_n, interpret
    got = ln_linear(torch.tensor(x).to(tdt), torch.tensor(g), torch.tensor(b),
                    torch.tensor(w.T).to(tdt), None if c is None else torch.tensor(c))
    assert got.dtype == tdt and got.shape == (128, 96)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("shape", [(2, 37, 40, 70), (3, 5, 320, 960)],
                         ids=["ragged", "sd-qkv-width"])
def test_plain_matches_xla_reference(shape):
    *lead, d, n = shape
    x, g, b, w, c = _data(int(np.prod(lead)), d, n, seed=1)
    x = x.reshape(*lead, d)
    want = ln_linear_reference(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                               jnp.asarray(w), jnp.asarray(c))
    got = ln_linear_plain(*(torch.tensor(a) for a in (x, g, b, w.T, c)))
    assert got.shape == (*lead, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL["float32"])


def test_layer_norm_matches_jax_and_torch():
    x, g, b, _, _ = _data(16, 48, 8, seed=2)
    x = x * 3 + 5  # an offset mean: the two-pass variance matters
    got = layer_norm_fp32(torch.tensor(x), torch.tensor(g), torch.tensor(b))
    want = np.asarray(jax_layer_norm_fp32(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    ref = torch.nn.functional.layer_norm(torch.tensor(x), (48,), torch.tensor(g),
                                         torch.tensor(b), eps=1e-5)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


def _jax_vjp(x, g, b, w, c, cot):
    """jax.vjp of ln_linear_reference (the JAX package's `_bwd`); w is (d, n)."""
    args = [jnp.asarray(a) for a in (x, g, b, w)] + ([] if c is None else [jnp.asarray(c)])
    _, vjp = jax.vjp(lambda *a: ln_linear_reference(*a[:4], a[4] if len(a) > 4 else None),
                     *args)
    return list(vjp(jnp.asarray(cot))) + ([None] if c is None else [])


def _check_grads(got, want):
    """got: the port's (dx, dgamma, dbeta, dw, dbias), dw (n, d); want: JAX's."""
    for name, gr, wa in zip(("dx", "dgamma", "dbeta", "dw", "dbias"), got, want):
        if wa is None:
            assert gr is None, name
            continue
        gr = gr.t() if name == "dw" else gr
        wa = np.asarray(wa, np.float32)
        err = float(np.abs(gr.detach().float().numpy() - wa).max()) / float(np.abs(wa).max())
        assert err <= GRAD_TOL, f"{name}: {err:.2e} of max|grad|"


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
def test_vjp_matches_jax_vjp(bias):
    x, g, b, w, c = _data(96, 40, 72, seed=3)
    x = x * 2 + 1
    c = c if bias else None
    cot = np.random.default_rng(4).standard_normal((96, 72)).astype(np.float32)
    got = ln_linear_vjp(torch.tensor(cot), torch.tensor(x), torch.tensor(g), torch.tensor(b),
                        torch.tensor(w.T.copy()), None if c is None else torch.tensor(c))
    _check_grads(got, _jax_vjp(x, g, b, w, c, cot))


def _backward(x, g, b, w, c, cot):
    args = [None if t is None else t.clone().requires_grad_(True) for t in (x, g, b, w, c)]
    with torch.enable_grad():
        out = ln_linear(*args)
    assert out.grad_fn is not None
    out.backward(cot)
    return out.detach(), [None if a is None else a.grad for a in args]


def test_cpu_call_differentiates():
    """With grad on, a CPU call takes the autograd Function: the forward is
    the plain twin's, the gradients those of jax.vjp."""
    x, g, b, w, c = _data(64, 32, 48, seed=5)
    cot = np.random.default_rng(6).standard_normal((64, 48)).astype(np.float32)
    args = [torch.tensor(a) for a in (x, g, b, w.T.copy(), c)]
    out, grads = _backward(*args, torch.tensor(cot))
    assert torch.equal(out, ln_linear_plain(*args))
    _check_grads(grads, _jax_vjp(x, g, b, w, c, cot))


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
def test_card_call_carries_the_gradient(monkeypatch, bias):
    """The card's branch returns what the kernel writes, a tensor with no
    grad_fn; the autograd Function around it must still give every gradient.
    Here the launch is stood in for by the plain twin under no_grad."""
    launched = []

    def fake_launch(x2, gamma, beta, w, bias_, eps, plan):
        launched.append(plan.route)
        with torch.no_grad():
            return ln_linear_plain(x2, gamma, beta, w, bias_, eps=eps)

    monkeypatch.setattr(_build, "device_type", lambda t, what: "cuda")
    monkeypatch.setattr(port_ln_linear, "ln_linear_launch", fake_launch)
    x, g, b, w, c = _data(64, 32, 48, seed=7)
    c = c if bias else None
    cot = np.random.default_rng(8).standard_normal((64, 48)).astype(np.float32)
    args = [None if a is None else torch.tensor(a) for a in (x, g, b, w.T.copy(), c)]
    out, grads = _backward(*args, torch.tensor(cot))
    assert launched == ["f32"]
    _check_grads(grads, _jax_vjp(x, g, b, w, c, cot))
