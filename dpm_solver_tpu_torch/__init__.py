"""dpm_solver_tpu_torch: the PyTorch and CUDA port of dpm_solver_tpu, for one H100.

The JAX package `dpm_solver_tpu` is the reference this port is held against;
this package never imports it (nor jax or flax). Modules mirror the JAX
package's paths. Plain tensor code is PyTorch; the kernels the JAX package
wrote in Pallas are hand-written for Hopper in `ops/` (CUDA C++ in `csrc/`,
and Triton), built at first use.

Public API (mirrors the reference's three symbols, plus the functional layer):
    NoiseScheduleVP   -- alpha/sigma/lambda(t) bijection      (schedule.py)
    model_wrapper     -- parameterization + guidance adapter  (wrapper.py)
    DPM_Solver        -- solver object with .sample/.inverse  (solver/)
    build_sampler, GraphedSampler -- the functional layer: a planned
                         sampler, and its CUDA-graph replay (solver/sample.py)
"""

from dpm_solver_tpu_torch.schedule import (
    NoiseScheduleVP,
    expand_dims,
    interp_linear_extrap,
    interpolate_fn,
)
from dpm_solver_tpu_torch.solver import DPM_Solver, GraphedSampler, build_sampler
from dpm_solver_tpu_torch.wrapper import model_wrapper

__all__ = [
    "DPM_Solver",
    "GraphedSampler",
    "NoiseScheduleVP",
    "build_sampler",
    "expand_dims",
    "interp_linear_extrap",
    "interpolate_fn",
    "model_wrapper",
]
__version__ = "0.1.0"
