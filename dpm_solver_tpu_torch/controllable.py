"""Controllable generation on torch: PC inpainting, colorization, class-conditional sampling.

Port of `dpm_solver_tpu/controllable.py`, twin of
score_sde_jax/controllable_generation.py:10-301, on the port's
predictor/corrector registry (`samplers.py`). Each task runs N steps of the
PC loop and, after the corrector's and the predictor's update, re-imposes
what is known at the current noise level: re-noised data for inpainting, the
decoupled luma channel for colorization; class conditioning adds a
classifier gradient to the score.

Randomness, as in `samplers.py`: `noise=` (draws, *x.shape) in the JAX
loop's order, or `generator=` on x's device. Each task states its count.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from dpm_solver_tpu_torch.samplers import Draws, get_corrector, get_predictor, time_grid
from dpm_solver_tpu_torch.sde import VESDE, batch_mul

# Orthonormal basis that isolates the gray-scale (luma) direction in RGB
# (ref controllable_generation.py:121-127).
_COLOR_BASIS = np.array(
    [[5.7735014e-01, -8.1649649e-01, 4.7008697e-08],
     [5.7735026e-01, 4.0824834e-01, 7.0710671e-01],
     [5.7735026e-01, 4.0824822e-01, -7.0710683e-01]], dtype=np.float32)
_COLOR_BASIS_INV = np.linalg.inv(_COLOR_BASIS)


def decouple(x):
    return torch.einsum("bhwi,ij->bhwj", x, torch.as_tensor(_COLOR_BASIS, device=x.device))


def couple(x):
    return torch.einsum("bhwi,ij->bhwj", x, torch.as_tensor(_COLOR_BASIS_INV, device=x.device))


def _pc_loop(sde, step_fn, x, eps):
    x_mean = x
    for t in time_grid(sde.T, eps, sde.N, device=x.device):
        x, x_mean = step_fn(x, t.to(x.dtype).expand(x.shape[0]))
    return x, x_mean


def task_draws(sde, *, predictor: str = "reverse_diffusion", corrector: str = "langevin",
               n_corrector_steps: int = 1, constrained: bool = True) -> int:
    """The standard-normal draws of one inpaint or colorize call
    (`constrained`) or one conditional-sampler call: the prior's, then per
    step the corrector's inner steps', (the constraint's,) the predictor's
    (and the constraint's)."""
    per_step = (get_corrector(corrector).draws * n_corrector_steps
                + get_predictor(predictor).draws + (2 if constrained else 0))
    return 1 + sde.N * per_step


def _prior(sde, draw) -> torch.Tensor:
    """A prior draw (`sde.prior_sampling`'s law) made from the next standard
    normal of `draw`."""
    z = draw()
    return z * sde.sigma_max if isinstance(sde, VESDE) else z


def get_pc_inpainter(
    sde,
    score_fn: Callable,
    *,
    predictor: str = "reverse_diffusion",
    corrector: str = "langevin",
    snr: float = 0.16,
    n_corrector_steps: int = 1,
    probability_flow: bool = False,
    denoise: bool = True,
    eps: float = 1e-5,
) -> Callable:
    """Returns `inpaint(data, mask, noise=None, generator=None) -> x`; mask==1
    marks known pixels (ref controllable_generation.py:10-95). Draws:
    `task_draws(sde, ...)`."""
    pred = get_predictor(predictor)
    corr = get_corrector(corrector)

    def constrain(draw, x, data, mask, tb):
        known_mean, std = sde.marginal_prob(data, tb)
        known = known_mean + batch_mul(std, draw())
        x = x * (1.0 - mask) + known * mask
        return x, x * (1.0 - mask) + known_mean * mask

    def inpaint(data, mask, noise=None, generator=None):
        draw = Draws(task_draws(sde, predictor=predictor, corrector=corrector,
                                n_corrector_steps=n_corrector_steps), data, noise, generator)
        x = data * mask + _prior(sde, draw) * (1.0 - mask)

        def step(x, tb):
            x, _ = corr(draw, x, tb, sde, score_fn, snr, n_corrector_steps)
            x, _ = constrain(draw, x, data, mask, tb)
            x, _ = pred(draw, x, tb, sde, score_fn, probability_flow)
            return constrain(draw, x, data, mask, tb)

        x, x_mean = _pc_loop(sde, step, x, eps)
        return x_mean if denoise else x

    return inpaint


def get_pc_colorizer(
    sde,
    score_fn: Callable,
    *,
    predictor: str = "reverse_diffusion",
    corrector: str = "langevin",
    snr: float = 0.16,
    n_corrector_steps: int = 1,
    probability_flow: bool = False,
    denoise: bool = True,
    eps: float = 1e-5,
) -> Callable:
    """Returns `colorize(gray, noise=None, generator=None) -> x` where `gray`
    has equal RGB channels (ref controllable_generation.py:98-210). The luma
    channel of the decoupled space is pinned to the (re-noised) gray image
    each step. Draws: `task_draws(sde, ...)`."""
    pred = get_predictor(predictor)
    corr = get_corrector(corrector)

    def luma_mask(x):
        return torch.cat([torch.ones_like(x[..., :1]), torch.zeros_like(x[..., 1:])], dim=-1)

    def constrain(draw, x, gray, tb):
        mask = luma_mask(x)
        known_mean, std = sde.marginal_prob(decouple(gray), tb)
        known = known_mean + batch_mul(std, draw())
        x = couple(decouple(x) * (1.0 - mask) + known * mask)
        # NB the reference blends the *noised* x into x_mean here too
        # (controllable_generation.py:163-164)
        return x, couple(decouple(x) * (1.0 - mask) + known_mean * mask)

    def colorize(gray, noise=None, generator=None):
        draw = Draws(task_draws(sde, predictor=predictor, corrector=corrector,
                                n_corrector_steps=n_corrector_steps), gray, noise, generator)
        mask = luma_mask(gray)
        x = couple(decouple(gray) * mask + decouple(_prior(sde, draw)) * (1.0 - mask))

        def step(x, tb):
            x, _ = corr(draw, x, tb, sde, score_fn, snr, n_corrector_steps)
            x, _ = constrain(draw, x, gray, tb)
            x, _ = pred(draw, x, tb, sde, score_fn, probability_flow)
            return constrain(draw, x, gray, tb)

        x, x_mean = _pc_loop(sde, step, x, eps)
        return x_mean if denoise else x

    return colorize


def get_pc_conditional_sampler(
    sde,
    score_fn: Callable,
    classifier_grad_fn: Callable,
    *,
    predictor: str = "reverse_diffusion",
    corrector: str = "langevin",
    snr: float = 0.16,
    n_corrector_steps: int = 1,
    probability_flow: bool = False,
    denoise: bool = True,
    eps: float = 1e-5,
) -> Callable:
    """Returns `sample(shape, labels, noise=None, generator=None, device=None)
    -> x`. The classifier gradient grad_x log p(y | x_t) is added to the
    score: the noise-conditional classifier pattern (ref
    controllable_generation.py:213-301; classifier_grad_fn(x, t, labels)).
    Draws: `task_draws(sde, ..., constrained=False)`, on `device` (else the
    noise's or the generator's)."""
    pred = get_predictor(predictor)
    corr = get_corrector(corrector)

    def sample(shape, labels, noise=None, generator=None, device=None):
        def guided_score(x, t):
            return score_fn(x, t) + classifier_grad_fn(x, t, labels)

        device = device or (noise.device if noise is not None else generator.device)
        like = torch.empty(shape, device=device)
        draw = Draws(task_draws(sde, predictor=predictor, corrector=corrector,
                                n_corrector_steps=n_corrector_steps, constrained=False),
                     like, noise, generator)

        def step(x, tb):
            x, _ = corr(draw, x, tb, sde, guided_score, snr, n_corrector_steps)
            return pred(draw, x, tb, sde, guided_score, probability_flow)

        x, x_mean = _pc_loop(sde, step, _prior(sde, draw), eps)
        return x_mean if denoise else x

    return sample
