"""The optimisers of the JAX training loops, with optax's semantics.

The JAX package chains optax transforms (`optax.chain(clip_by_global_norm,
adam(linear_schedule))`, `optax.adafactor`); these are the port's own copies
of what those chains compute, in plain PyTorch (`torch._foreach_*` where a
rule is the same for every tensor), as in the JAX package, where optax sits
outside any Pallas kernel. torch's own optimisers differ where it matters:
`clip_grad_norm_` adds 1e-6 to the norm, `torch.optim.Adafactor` has other
defaults (a weight decay of 1e-2 among them) and no parameter scaling.

Parameters and state are dictionaries of fp32 tensors keyed by parameter
name. `step` updates the parameters and the state in place (where JAX
returns new trees) and returns the gradients' global norm.

- Schedules take the optimiser's step count before the update, as optax's
  `scale_by_schedule` does: `linear_schedule(0, lr, warmup)` gives the first
  update a learning rate of 0.
- `clip_by_global_norm(max_norm)`: optax's, unchanged below the norm, else
  each tensor (t / norm) * max_norm, no epsilon.
- `Adam`: optax's `scale_by_adam` (b1 0.9 and b2 0.999 by default, eps
  1e-8, the moments' bias corrections at count + 1) then `-lr(count)`; the
  first-stage trainer's is `adam(lr, b1=0.5, b2=0.9)` with no clip.
- `Adafactor`: optax 0.2.6's `adafactor(learning_rate=...)` with its
  defaults: `scale_by_factored_rms` (min_dim_size_to_factor 128, decay_rate
  0.8, eps 1e-30), `clip_by_block_rms(1.0)`, `lr(count)`,
  `scale_by_param_block_rms` (the parameter's rms, at least 1e-3), no
  momentum, no weight decay. The factored axes are optax's on the Flax
  layout (the two largest axes; ties in Flax's axis order), mapped to the
  same physical axes of the torch layout (`flax_layouts`).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

Params = Dict[str, torch.Tensor]
Schedule = Union[float, Callable[[int], float]]


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Callable:
    """optax.linear_schedule: init_value to end_value over transition_steps counts."""

    def sched(count: int) -> float:
        frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return sched


def _lr(schedule: Schedule, count: int) -> float:
    return float(schedule(count)) if callable(schedule) else float(schedule)


def global_norm(tensors, sharded=(), group=None) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of every element's square, fp32.
    `sharded` tensors are one rank's slices of tensors split over the
    process `group` (tensor parallelism): their squares are summed over it."""
    tensors = list(tensors)
    sq = torch.stack(torch._foreach_norm(tensors)).square().sum() if tensors else None
    if sharded:
        from dpm_solver_tpu_torch.parallel.mesh import all_reduce_

        part = torch.stack(torch._foreach_norm(list(sharded))).square().sum()
        part = all_reduce_(part.float().clone(), group)
        sq = part if sq is None else sq + part
        return sq.sqrt()
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def clip_by_global_norm_(grads: Params, max_norm: float,
                         sharded: Optional[Mapping[str, object]] = None) -> torch.Tensor:
    """optax.clip_by_global_norm, in place; returns the norm before clipping.
    `sharded`: {name: process group} of gradients that are slices of a
    tensor split over that group (one group), whose squares the norm sums
    over it."""
    g = list(grads.values())
    if sharded:
        group = next(iter(sharded.values()))
        norm = global_norm([v for k, v in grads.items() if k not in sharded],
                           [grads[k] for k in sharded], group)
    else:
        norm = global_norm(g)
    # below max_norm unchanged, else (t / norm) * max_norm, with no epsilon: a
    # factor that is 1 where the norm is under the limit keeps this on the card
    keep = norm < max_norm
    torch._foreach_mul_(g, torch.where(keep, 1.0, max_norm / norm))
    return norm


def flax_order(p: torch.Tensor, stored_as_flax: bool = False) -> tuple:
    """The torch axis that is each Flax axis of `p`: a Linear's (out, in) ->
    (in, out), a conv's (out, in, *k) -> (*k, in, out); vectors, and tensors
    stored in Flax's order (embeddings, NCSN++'s NIN `W`), unchanged."""
    if stored_as_flax or p.dim() < 2:
        return tuple(range(p.dim()))
    return (1, 0) if p.dim() == 2 else tuple(range(2, p.dim())) + (1, 0)


def flax_layouts(model: nn.Module) -> Dict[str, tuple]:
    """`flax_order` of each parameter of `model`, by name."""
    return {f"{mod_name}.{name}" if mod_name else name:
            flax_order(p, isinstance(mod, nn.Embedding) or name == "W")
            for mod_name, mod in model.named_modules()
            for name, p in mod.named_parameters(recurse=False)}


class _Optimizer:
    """Clip by global norm, then the rule of a subclass, at `schedule`.
    `elementwise`: whether the rule updates each element from its own
    gradient and moments alone (ZeRO-1 then updates parameter slices,
    `parallel/zero.py`)."""

    elementwise = False

    def __init__(self, schedule: Schedule, grad_clip: Optional[float] = 1.0):
        self.schedule, self.grad_clip = schedule, grad_clip

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        raise NotImplementedError

    def lr(self, count: int) -> float:
        return _lr(self.schedule, count)

    @torch.no_grad()
    def step(self, params: Params, grads: Params, state: dict) -> Optional[torch.Tensor]:
        """One update of `params` and `state` in place from `grads` (which
        the clip scales in place); returns the gradients' global norm before
        the clip, or None where there is no clip."""
        # tensor parallelism's slices (parallel/tp.py) mark their group
        sharded = {k: p.tp_group for k, p in params.items() if hasattr(p, "tp_group")}
        norm = None if self.grad_clip is None else \
            clip_by_global_norm_(grads, self.grad_clip, sharded)
        zero = state.get("zero")   # a ZeRO-1 sharded state (parallel/zero.py)
        if zero is None:
            self._apply(params, grads, state)
        else:
            zero.apply(self, params, grads, state)
        state["count"] += 1
        return norm

    def _apply(self, params: Params, grads: Params, state: dict) -> None:
        raise NotImplementedError


# optax.adam's defaults, and optax 0.2.6 adafactor's
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
AF_DECAY_RATE, AF_EPS, AF_CLIPPING, AF_MIN_SCALE = 0.8, 1e-30, 1.0, 1e-3


class Adam(_Optimizer):
    """optax.chain(clip_by_global_norm(grad_clip), adam(schedule, b1, b2)),
    or optax.adam(schedule, b1, b2) alone with grad_clip=None.
    State: {"count": int, "mu": {name: fp32}, "nu": {name: fp32}}."""

    elementwise = True

    def __init__(self, schedule: Schedule, grad_clip: Optional[float] = 1.0,
                 b1: float = ADAM_B1, b2: float = ADAM_B2):
        super().__init__(schedule, grad_clip)
        self.b1, self.b2 = b1, b2

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        return {"count": 0, "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def _apply(self, params: Params, grads: Params, state: dict) -> None:
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        mu = [state["mu"][k] for k in names]
        nu = [state["nu"][k] for k in names]
        b1, b2, count = self.b1, self.b2, state["count"] + 1
        # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - b2)
        # update = (mu / c1) / (sqrt(nu / c2) + eps), times -lr(count - 1)
        c1, c2 = (float(np.float32(1) - np.float32(b) ** np.float32(count)) for b in (b1, b2))
        den = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, ADAM_EPS)
        num = torch._foreach_div(mu, c1)
        torch._foreach_div_(num, den)
        torch._foreach_add_(p, num, alpha=-self.lr(count - 1))


def _factored_dims(shape, min_dim: int) -> Optional[tuple]:
    """optax's `_factored_dims` on a Flax-layout shape: (d1, d0), the second
    largest and the largest axis, or None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(_Optimizer):
    """optax.chain(clip_by_global_norm(grad_clip), adafactor(schedule)) with
    optax 0.2.6's defaults. `layouts` maps each parameter name to its Flax
    axis order (`flax_layouts(model)`; by default a 2-D weight is (out, in)
    and a 4-D one (out, in, kh, kw)). State: {"count": int, "v_row",
    "v_col", "v": {name: fp32}}, zeros((1,)) where a tensor has no such
    statistic (optax's layout), the factored rows and columns on the torch
    axes."""

    def __init__(self, schedule: Schedule, grad_clip: Optional[float] = 1.0,
                 layouts: Optional[Mapping[str, tuple]] = None, min_dim_size_to_factor: int = 128):
        super().__init__(schedule, grad_clip)
        self.layouts = dict(layouts or {})
        self.min_dim = min_dim_size_to_factor

    def factored_axes(self, name: str, p: torch.Tensor) -> Optional[tuple]:
        """(d1, d0) on the torch axes of `p`, or None (not factored)."""
        perm = self.layouts.get(name) or flax_order(p)
        dims = _factored_dims([p.shape[i] for i in perm], self.min_dim)
        return None if dims is None else (perm[dims[0]], perm[dims[1]])

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        state = {"count": 0, "v_row": {}, "v_col": {}, "v": {}}
        for k, p in params.items():
            dims = self.factored_axes(k, p)
            one = p.new_zeros((1,))
            if dims is None:
                state["v_row"][k], state["v_col"][k], state["v"][k] = one, one.clone(), \
                    torch.zeros_like(p)
            else:
                d1, d0 = dims
                row = [n for i, n in enumerate(p.shape) if i != d0]
                col = [n for i, n in enumerate(p.shape) if i != d1]
                state["v_row"][k], state["v_col"][k], state["v"][k] = p.new_zeros(row), \
                    p.new_zeros(col), one
        return state

    def _apply(self, params: Params, grads: Params, state: dict) -> None:
        count = state["count"]
        decay = float(np.float32(1) - np.float32(count + 1) ** np.float32(-AF_DECAY_RATE))
        lr = self.lr(count)
        for k, p in params.items():
            g = grads[k]
            g2 = g * g + AF_EPS
            dims = self.factored_axes(k, p)
            if dims is not None:
                d1, d0 = dims
                v_row = state["v_row"][k].mul_(decay).add_(g2.mean(d0), alpha=1 - decay)
                v_col = state["v_col"][k].mul_(decay).add_(g2.mean(d1), alpha=1 - decay)
                r1 = d1 - 1 if d1 > d0 else d1
                row_factor = (v_row / v_row.mean(r1, keepdim=True)).rsqrt()
                u = g * row_factor.unsqueeze(d0) * v_col.rsqrt().unsqueeze(d1)
            else:
                v = state["v"][k].mul_(decay).add_(g2, alpha=1 - decay)
                u = g * v.rsqrt()
            # clip_by_block_rms, the learning rate, scale_by_param_block_rms, -1
            u = u / torch.clamp(u.square().mean().sqrt() / AF_CLIPPING, min=1.0)
            rms = p.square().mean().sqrt()
            scale = torch.where(rms <= AF_MIN_SCALE, AF_MIN_SCALE, rms)
            p.sub_(u * (lr * scale))


def trainable(model_or_params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> Params:
    """{name: parameter} of the parameters that take gradients (a module's
    own tensors, so updating them updates the module)."""
    if isinstance(model_or_params, nn.Module):
        return {k: p for k, p in model_or_params.named_parameters() if p.requires_grad}
    return dict(model_or_params)


__all__ = ["Adafactor", "Adam", "clip_by_global_norm_", "flax_layouts", "flax_order",
           "global_norm", "linear_schedule", "trainable"]
