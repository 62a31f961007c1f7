"""Model abstraction layer: normalize any diffusion net into eps_hat(x, t), on torch.

Port of `dpm_solver_tpu/wrapper.py` (ref: dpm_solver_pytorch.py:170-334).
Four parameterizations ("noise" | "x_start" | "v" | "score") and three
guidance modes ("uncond" | "classifier" | "classifier-free") are normalized
to one continuous-time noise-prediction function

    model_fn(x, t_continuous) -> eps_hat        # t_continuous: scalar or (B,)

Classifier-free guidance evaluates cond and uncond as one 2x-batched call.
Classifier guidance takes grad_x log p(cond | x_t) through autograd, under
`torch.enable_grad()` so that it works inside `torch.no_grad()` (the
reference's dpm_solver_pytorch.py:300-307); the classifier's parameters
should be frozen (`requires_grad_(False)`), or every NFE also computes their
gradients.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from dpm_solver_tpu_torch.schedule import NoiseScheduleVP
from dpm_solver_tpu_torch.utils.trees import bcast_right

MODEL_TYPES = ("noise", "x_start", "v", "score")
GUIDANCE_TYPES = ("uncond", "classifier", "classifier-free")


def _broadcast_t(t, x: torch.Tensor) -> torch.Tensor:
    t = torch.as_tensor(t, device=x.device)
    if not t.is_floating_point():
        t = t.float()
    return t.expand(x.shape[0]) if t.dim() == 0 else t


def _concat_cond(u, c):
    """Concatenate an uncond/cond pair along the batch: tensors, or dicts,
    lists and tuples of them."""
    if isinstance(u, dict):
        return {k: _concat_cond(u[k], c[k]) for k in u}
    if isinstance(u, (list, tuple)):
        return type(u)(_concat_cond(a, b) for a, b in zip(u, c))
    return torch.cat([torch.as_tensor(u), torch.as_tensor(c)], dim=0)


def model_wrapper(
    model: Callable,
    noise_schedule: NoiseScheduleVP,
    model_type: str = "noise",
    model_kwargs: Optional[dict] = None,
    guidance_type: str = "uncond",
    condition: Any = None,
    unconditional_condition: Any = None,
    guidance_scale: float = 1.0,
    classifier_fn: Optional[Callable] = None,
    classifier_kwargs: Optional[dict] = None,
) -> Callable:
    """Wrap `model` into a continuous-time noise prediction function.

    Args mirror the reference API (dpm_solver_pytorch.py:170-181). `model` has
    signature `model(x, t_input, **model_kwargs)` (uncond) or
    `model(x, t_input, cond, **model_kwargs)` (classifier-free).
    `classifier_fn(x, t_input, cond, **classifier_kwargs)` returns per-example
    log-probabilities (summed over the batch before differentiation).
    Returns `model_fn(x, t_continuous) -> eps_hat`.
    """
    if model_type not in MODEL_TYPES:
        raise ValueError(f"model_type must be one of {MODEL_TYPES}, got {model_type!r}")
    if guidance_type not in GUIDANCE_TYPES:
        raise ValueError(f"guidance_type must be one of {GUIDANCE_TYPES}, got {guidance_type!r}")
    if guidance_type == "classifier" and classifier_fn is None:
        raise ValueError("classifier guidance requires classifier_fn")
    model_kwargs = model_kwargs or {}
    classifier_kwargs = classifier_kwargs or {}
    ns = noise_schedule

    def get_model_input_time(t_continuous):
        """Discrete nets trained on n = 0..N-1 get (t - 1/N) * 1000
        (ref: dpm_solver_pytorch.py:271-280); continuous nets get t."""
        if ns.schedule == "discrete":
            return (t_continuous - 1.0 / ns.total_N) * 1000.0
        return t_continuous

    def noise_pred_fn(x, t_continuous, cond=None):
        t_input = get_model_input_time(t_continuous)
        if cond is None:
            output = model(x, t_input, **model_kwargs)
        else:
            output = model(x, t_input, cond, **model_kwargs)
        if model_type == "noise":
            return output
        if model_type == "x_start":
            alpha_t, sigma_t = ns.marginal_alpha(t_continuous), ns.marginal_std(t_continuous)
            return (x - bcast_right(alpha_t, x.dim()) * output) / bcast_right(sigma_t, x.dim())
        if model_type == "v":
            alpha_t, sigma_t = ns.marginal_alpha(t_continuous), ns.marginal_std(t_continuous)
            return bcast_right(alpha_t, x.dim()) * output + bcast_right(sigma_t, x.dim()) * x
        sigma_t = ns.marginal_std(t_continuous)  # score
        return -bcast_right(sigma_t, x.dim()) * output

    def cond_grad_fn(x, t_input):
        """grad_x of sum(log p(cond | x_t)), the graph built under enable_grad."""
        with torch.enable_grad():
            x_in = x.detach().requires_grad_(True)
            log_prob = classifier_fn(x_in, t_input, condition, **classifier_kwargs)
            return torch.autograd.grad(log_prob.sum(), x_in)[0]

    def model_fn(x, t_continuous):
        t_continuous = _broadcast_t(t_continuous, x)
        if guidance_type == "uncond":
            return noise_pred_fn(x, t_continuous)
        if guidance_type == "classifier":
            cond_grad = cond_grad_fn(x, get_model_input_time(t_continuous))
            sigma_t = ns.marginal_std(t_continuous)
            noise = noise_pred_fn(x, t_continuous)
            return noise - guidance_scale * bcast_right(sigma_t, x.dim()) * cond_grad
        if guidance_scale == 1.0 or unconditional_condition is None:
            return noise_pred_fn(x, t_continuous, cond=condition)
        # one doubled batch for cond and uncond (ref: dpm_solver_pytorch.py:322-330)
        x_in = torch.cat([x, x], dim=0)
        t_in = torch.cat([t_continuous, t_continuous], dim=0)
        c_in = _concat_cond(unconditional_condition, condition)
        noise_uncond, noise = noise_pred_fn(x_in, t_in, cond=c_in).chunk(2, dim=0)
        return noise_uncond + guidance_scale * (noise - noise_uncond)

    return model_fn
