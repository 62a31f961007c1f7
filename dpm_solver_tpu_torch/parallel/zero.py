"""ZeRO-1: the optimiser state sharded over the data axis.

Port of `dpm_solver_tpu/parallel/zero.py`. In JAX each moment tensor gets a
sharding over the mesh's data axis along its largest divisible axis and XLA
partitions the optimiser update; parameters and gradients stay replicated.
Here the port's own optimisers (`training/optim.py`, which the trainers use
in place of `torch.optim`) keep, on each rank, only its slice of every
sharded moment:

- `_leaf_spec` is the JAX rule, applied to each moment's shape in Flax's
  axis order (`optim.flax_order`, or the model's `flax_layouts`): the
  largest axis (the first in Flax order among equals) that the rank count
  divides, for a moment of at least `min_size` elements; the torch axis is
  the same physical axis. Smaller or indivisible moments stay replicated.
- Adam's update is elementwise: each rank updates its slice of each sharded
  parameter with its slice of the moments, then the slices are all-gathered
  into the parameter. Adafactor's is not (its factored statistics and its
  clip read the whole tensor): each rank gathers the moments, updates the
  whole parameter, and keeps its slices; the state at rest is sharded all
  the same.

The gradients are the data-parallel step's averaged ones (replicated), so
the global-norm clip is the unsharded one. The two-optimizer adversarial
state shards `gen_opt` and `disc_opt` the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from dpm_solver_tpu_torch.parallel.mesh import all_gather, axis_group, axis_rank, axis_size
from dpm_solver_tpu_torch.training.optim import flax_order

MIN_SIZE = 2 ** 12
# the optimiser-state fields of the port's train states, and the parameters
# each one belongs to
_FIELDS = {"opt_state": "params", "gen_opt": "gen_params", "disc_opt": "disc_params"}


def _leaf_spec(shape, n_shards: int, min_size: int) -> Optional[int]:
    """The JAX rule on one (Flax-ordered) shape: the axis to shard, or None
    (replicated)."""
    shape = tuple(shape)
    if not shape or int(np.prod(shape)) < min_size:
        return None
    for ax in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[ax] % n_shards == 0:
            return ax
    return None


def _moment_order(perm: tuple, removed: Optional[int]) -> tuple:
    """The torch axes of a moment in Flax's order: `perm` (the parameter's
    `flax_order`), without the parameter axis `removed` (an Adafactor row or
    column statistic), renumbered as the moment's own axes."""
    if removed is None:
        return tuple(perm)
    return tuple(a - (a > removed) for a in perm if a != removed)


def _moment_axis(opt, key: str, name: str, p: torch.Tensor, moment: torch.Tensor,
                 perm: tuple, n: int, min_size: int) -> Optional[int]:
    """The torch axis along which `moment` (the optimiser's `key` of
    parameter `name`) is sharded, or None."""
    removed = None
    if key in ("v_row", "v_col") and moment.dim() == p.dim() - 1:
        d1, d0 = opt.factored_axes(name, p)
        removed = d0 if key == "v_row" else d1
    elif tuple(moment.shape) != tuple(p.shape):
        perm = tuple(range(moment.dim()))   # a placeholder statistic, (1,)
    order = _moment_order(perm, removed)
    ax = _leaf_spec([moment.shape[a] for a in order], n, min_size)
    return None if ax is None else order[ax]


def optstate_shardings(state, mesh, tx, *, axis: str = "data", min_size: int = MIN_SIZE,
                       layouts: Optional[Mapping[str, tuple]] = None) -> Dict[str, dict]:
    """{field: {moment key: {parameter name: torch axis or None}}} for a
    train state's optimiser fields (`opt_state`; `gen_opt` and `disc_opt`
    of the adversarial state). `tx` is the state's optimiser; `layouts` the
    Flax axis order of parameters stored otherwise than `flax_order` assumes
    (`optim.flax_layouts(model)`)."""
    if axis not in mesh.mesh_dim_names:
        raise ValueError(f"mesh has axes {mesh.mesh_dim_names}, not {axis!r}")
    n = axis_size(mesh, axis)
    layouts = dict(layouts or {})
    out = {}
    for field, params_field in _FIELDS.items():
        if not hasattr(state, field):
            continue
        params, opt = getattr(state, params_field), getattr(state, field)
        out[field] = {
            key: {name: _moment_axis(tx, key, name, params[name], m,
                                     layouts.get(name) or flax_order(params[name]), n, min_size)
                  for name, m in moments.items()}
            for key, moments in opt.items() if isinstance(moments, dict)}
    if not out:
        raise ValueError("state has no optimizer-state field to shard")
    return out


def _narrow(t: torch.Tensor, ax: int, rank: int, n: int) -> torch.Tensor:
    k = t.shape[ax] // n
    return t.narrow(ax, rank * k, k)


@dataclasses.dataclass
class ZeroShard:
    """What a sharded optimiser state carries (its "zero" entry): the data
    group, this rank's place in it, and each moment's shard axis."""

    group: object
    rank: int
    size: int
    axes: Dict[str, Dict[str, Optional[int]]]

    def param_axis(self, name: str) -> Optional[int]:
        """The axis the parameter is updated in slices along (its moments'
        common one), or None."""
        found = {moments[name] for moments in self.axes.values() if name in moments}
        return found.pop() if len(found) == 1 else None

    def apply(self, opt, params, grads, state) -> None:
        """One update of `params` (replicated) from `grads` (replicated),
        with this rank's moment slices in `state`, in place."""
        if getattr(opt, "elementwise", False) and all(
                len({m[k] for m in self.axes.values()}) == 1 for k in params):
            self._apply_slices(opt, params, grads, state)
        else:
            self._apply_gathered(opt, params, grads, state)

    def _apply_slices(self, opt, params, grads, state) -> None:
        local_p, local_g = {}, {}
        for k, p in params.items():
            ax = self.param_axis(k)
            local_p[k] = p if ax is None else _narrow(p, ax, self.rank, self.size)
            local_g[k] = grads[k] if ax is None else _narrow(grads[k], ax, self.rank, self.size)
        opt._apply(local_p, local_g, state)
        for k, p in params.items():
            ax = self.param_axis(k)
            if ax is not None:
                p.copy_(all_gather(local_p[k], self.group, ax))

    def _apply_gathered(self, opt, params, grads, state) -> None:
        full = {key: {k: m if self.axes[key][k] is None
                      else all_gather(m, self.group, self.axes[key][k]) for k, m in moments.items()}
                for key, moments in state.items() if key in self.axes}
        opt._apply(params, grads, {**state, **full})
        for key, moments in full.items():
            for k, m in moments.items():
                ax = self.axes[key][k]
                if ax is not None:
                    state[key][k].copy_(_narrow(m, ax, self.rank, self.size))


def shard_optimizer_state(state, mesh, tx, *, axis: str = "data", min_size: int = MIN_SIZE,
                          layouts: Optional[Mapping[str, tuple]] = None) -> Dict[str, dict]:
    """Keep only this rank's slice of each sharded moment of `state`'s
    optimiser fields, in place, and mark each field for `tx.step` (its
    "zero" entry). Returns the shardings (`optstate_shardings`)."""
    shardings = optstate_shardings(state, mesh, tx, axis=axis, min_size=min_size,
                                   layouts=layouts)
    group, rank, n = axis_group(mesh, axis), axis_rank(mesh, axis), axis_size(mesh, axis)
    for field, axes in shardings.items():
        opt = getattr(state, field)
        for key, by_name in axes.items():
            for name, ax in by_name.items():
                if ax is not None:
                    opt[key][name] = _narrow(opt[key][name], ax, rank, n).clone()
        opt["zero"] = ZeroShard(group, rank, n, axes)
    return shardings


def shard_train_step(step_fn: Callable, mesh, state, tx, *, axis: str = "data",
                     min_size: int = MIN_SIZE, layouts: Optional[Mapping[str, tuple]] = None):
    """ZeRO-1 for a data-parallel step: `step_fn` built with `mesh=` (its
    gradients averaged over `axis`), `state` its train state, `tx` its
    optimiser. Shards the optimiser state in place (`shard_optimizer_state`)
    and returns (step_fn, state, shardings), as JAX returns (the jitted step,
    the placed state, the shardings); the step itself is unchanged, the
    optimiser reads the state's layout."""
    if getattr(step_fn, "mesh", None) is not mesh:
        raise ValueError("shard_train_step takes a data-parallel step built with mesh= over "
                         "the same mesh (its gradients must be averaged over the data axis)")
    return step_fn, state, shard_optimizer_state(state, mesh, tx, axis=axis,
                                                 min_size=min_size, layouts=layouts)


def state_bytes(opt_state) -> int:
    """The bytes of the tensors of an optimiser state (this rank's)."""
    total = 0
    for v in opt_state.values():
        if isinstance(v, dict):
            total += sum(t.numel() * t.element_size() for t in v.values())
        elif isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
    return total
