"""Adaptive Dormand–Prince RK45, as a host loop on torch.

Port of `dpm_solver_tpu/ode.py` (the score_sde reference integrates its
probability-flow ODEs with scipy's `solve_ivp`, examples/score_sde_jax/
likelihood.py:108-110 and sampling.py:459-536). The same RK45(4)5 pair with
FSAL reuse and the same step control: a scaled RMS error norm over the whole
flattened state, the 0.9 safety factor with its [0.2, 10] clamp, the step
clamped to the time left, and the span-relative stop. The JAX
`lax.while_loop` becomes a Python loop: the state and the stages stay on
the device, and each step reads one scalar back, the error norm, whose
accept test and next step size decide the loop. That read is inherent: the
next step depends on it.

t and h live on the host as float32, as `jnp.float32(t0)` keeps them in
the JAX loop, so both packages take the same accept/reject decisions and
the same number of function evaluations on the same problem.
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import numpy as np
import torch

# Dormand–Prince Butcher tableau (RK45, FSAL)
_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
_A = np.zeros((7, 7))
_A[1, 0] = 1 / 5
_A[2, :2] = [3 / 40, 9 / 40]
_A[3, :3] = [44 / 45, -56 / 15, 32 / 9]
_A[4, :4] = [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729]
_A[5, :5] = [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656]
_A[6, :6] = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]
_B5 = _A[6, :7].copy()  # 5th-order solution weights
_B4 = np.array([5179 / 57600, 0.0, 7571 / 16695, 393 / 640,
                -92097 / 339200, 187 / 2100, 1 / 40])
_E = _B5 - _B4  # embedded error weights
_F32 = np.float32

State = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


def _flat(state: State):
    """(one fp32 vector of every leaf, concatenated; its inverse). A leaf
    comes back fp32, as the JAX `_flat` gives it back."""
    leaves = (state,) if isinstance(state, torch.Tensor) else tuple(state)
    shapes = [u.shape for u in leaves]
    vec = torch.cat([u.reshape(-1).float() for u in leaves])

    def unflatten(v: torch.Tensor) -> State:
        out, o = [], 0
        for shape in shapes:
            n = shape.numel()
            out.append(v[o:o + n].reshape(shape))
            o += n
        return out[0] if isinstance(state, torch.Tensor) else tuple(out)

    return vec, unflatten


def odeint_rk45(
    func: Callable,
    y0: State,
    t0: float,
    t1: float,
    *,
    rtol: float = 1e-5,
    atol: float = 1e-5,
    max_steps: int = 20_000,
    first_step: float = 1e-4,
) -> Tuple[State, int]:
    """Integrate dy/dt = func(y, t) from t0 to t1 (either direction).

    y0 is a tensor or a tuple of tensors; func(y, t) takes the same
    structure and a Python float t and returns it. Returns (y(t1), nfe),
    every leaf of y fp32 on y0's device; nfe = 6 per attempted step (FSAL
    reuses the seventh stage) + 1.
    """
    y, unflatten = _flat(y0)
    direction = _F32(1.0 if t1 >= t0 else -1.0)
    span = abs(float(t1) - float(t0))
    t1_f, stop = _F32(t1), _F32(1e-6 * span)
    a, b5, e = (torch.as_tensor(m, dtype=torch.float32, device=y.device) for m in (_A, _B5, _E))
    c = _C.astype(np.float32)

    def f(vec: torch.Tensor, t) -> torch.Tensor:
        return _flat(func(unflatten(vec), float(t)))[0]

    t, h = _F32(t0), direction * abs(_F32(first_step))
    k0 = f(y, t)
    n_steps = 0
    while n_steps < max_steps:
        # clamp the step to not overshoot t1
        h = direction * min(abs(h), abs(t1_f - t))
        ks = y.new_zeros((7, y.shape[0]))
        ks[0] = k0
        for i in range(1, 7):
            ks[i] = f(y + float(h) * (a[i] @ ks), t + h * c[i])
        y_new = y + float(h) * (b5 @ ks)
        err = float(h) * (e @ ks)
        scale = atol + rtol * torch.maximum(y.abs(), y_new.abs())
        err_norm = _F32(torch.sqrt(torch.mean((err / scale) ** 2)).item())
        factor = np.clip(_F32(0.9) * (err_norm + _F32(1e-16)) ** _F32(-0.2), _F32(0.2),
                         _F32(10.0))
        n_steps += 1
        if err_norm <= 1.0:
            t, y, k0 = t + h, y_new, ks[6]  # FSAL: k7 == f(y_new, t + h)
        h = h * factor
        # span-relative termination: an absolute fp32 test near small t1
        # (e.g. 1e-3) is unreachable and would spin until max_steps
        if abs(t - t1_f) <= stop:
            break
    return unflatten(y), 6 * n_steps + 1
