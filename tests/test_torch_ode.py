"""Port RK45 (dpm_solver_tpu_torch/ode.py) against the JAX `odeint_rk45`.

On tests/test_likelihood.py's problems (the linear 2x2 system, backward
integration, the pytree state) and two more (a time-dependent nonlinear
system, and a VP-like drift, stiff towards t = 1), the port takes the same number of function
evaluations as the JAX `lax.while_loop` (same accept/reject decisions: t
and h in float32, one RMS error norm over the whole flattened state) and
ends within 1e-5 relative of it (both integrate in fp32; the stages sum in
another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu.ode import odeint_rk45 as jax_odeint
from dpm_solver_tpu_torch.ode import odeint_rk45

RTOL = 1e-5
A = np.array([[-0.5, 0.2], [-0.1, -0.3]], dtype=np.float32)


def _vp_drift(lib, as_f32=lambda t: t):
    """A VP-like drift: the VP SDE's linear beta(t), a rate per row and a
    sine term; stiff towards t = 1. t in fp32 on both sides."""
    def f(y, t):
        beta = 0.1 + as_f32(t) * (20.0 - 0.1)
        w = lib.reshape(lib.arange(y.shape[0]) * 1.0 + 1.0, (-1, 1))
        return -0.5 * beta * y * w + 0.25 * beta * lib.sin(y)
    return f


# name: (jax func, torch func, y0 leaves, t0, t1, kwargs)
PROBLEMS = {
    "linear": (lambda y, t: jnp.asarray(A) @ y, lambda y, t: torch.tensor(A) @ y,
               [np.array([1.0, -2.0], np.float32)], 0.0, 3.0, dict(rtol=1e-6, atol=1e-8)),
    "backward": (lambda y, t: y, lambda y, t: y, [np.array([2.0], np.float32)], 1.0, 0.0,
                 dict(rtol=1e-6, atol=1e-8)),
    "pytree": (lambda s, t: (s[0] * 0.0 + 1.0, -s[1]), lambda s, t: (s[0] * 0.0 + 1.0, -s[1]),
               [np.zeros((2, 2), np.float32), np.ones((3,), np.float32)], 0.0, 2.0, {}),
    "time-dependent": (lambda y, t: jnp.cos(3.0 * t) * y - 0.5 * y ** 3,
                       lambda y, t: torch.cos(3.0 * torch.tensor(t)) * y - 0.5 * y ** 3,
                       [np.linspace(-1.5, 1.5, 12, dtype=np.float32).reshape(3, 4)], 0.0, 4.0,
                       dict(rtol=1e-5, atol=1e-6)),
    "vp-drift": (_vp_drift(jnp), _vp_drift(torch, torch.tensor),
                 [np.random.default_rng(0).standard_normal((4, 8)).astype(np.float32)],
                 1e-5, 1.0, {}),
}


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_rk45_matches_jax_with_the_same_nfe(name):
    f_jax, f_torch, leaves, t0, t1, kw = PROBLEMS[name]
    pack = (lambda ls: ls[0]) if len(leaves) == 1 else tuple
    want, nfe_j = jax_odeint(f_jax, pack([jnp.asarray(u) for u in leaves]), t0, t1, **kw)
    got, nfe_t = odeint_rk45(f_torch, pack([torch.tensor(u) for u in leaves]), t0, t1, **kw)
    assert nfe_t == int(nfe_j) and nfe_t > 6
    got = (got,) if len(leaves) == 1 else got
    want = (want,) if len(leaves) == 1 else want
    assert len(got) == len(leaves)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=RTOL * 1e-3)


def test_rk45_linear_system_matches_scipy():
    """The port alone against scipy's solve_ivp at tight tolerances, as
    tests/test_likelihood.py holds the JAX integrator (1e-4 relative)."""
    from scipy.integrate import solve_ivp

    y0 = np.array([1.0, -2.0], dtype=np.float32)
    got, _ = odeint_rk45(lambda y, t: torch.tensor(A) @ y, torch.tensor(y0), 0.0, 3.0,
                         rtol=1e-6, atol=1e-8)
    sol = solve_ivp(lambda t, y: A @ y, (0.0, 3.0), y0, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(got.numpy(), sol.y[:, -1], rtol=1e-4, atol=1e-6)


def test_rk45_stops_at_max_steps_as_jax_does():
    """A step cap ends the loop where the JAX one ends: nfe = 6 * max + 1,
    and the state where the accepted steps left it. (dy/dt = y: both sides
    evaluate it exactly, so their error norms, which rounding dominates at
    the first tiny steps, and their step sizes agree from the first step.)"""
    f_jax, f_torch, leaves, t0, t1, kw = PROBLEMS["backward"]
    want, nfe_j = jax_odeint(f_jax, jnp.asarray(leaves[0]), t0, t1, max_steps=5, **kw)
    got, nfe_t = odeint_rk45(f_torch, torch.tensor(leaves[0]), t0, t1, max_steps=5, **kw)
    assert nfe_t == int(nfe_j) == 31
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
