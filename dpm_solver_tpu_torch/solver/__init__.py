from dpm_solver_tpu_torch.solver.adaptive import adaptive_sample
from dpm_solver_tpu_torch.solver.correctors import make_dynamic_thresholding
from dpm_solver_tpu_torch.solver.plan import (
    PlanRows,
    SamplePlan,
    build_multistep_plan,
    build_singlestep_plan,
    build_unipc_plan,
    get_orders_and_timesteps_for_singlestep_solver,
    get_time_steps,
)
from dpm_solver_tpu_torch.solver.sample import (
    DPM_Solver,
    GraphedSampler,
    build_sampler,
    execute_plan,
    graph_key,
    make_plan,
)

__all__ = [
    "DPM_Solver",
    "GraphedSampler",
    "PlanRows",
    "SamplePlan",
    "adaptive_sample",
    "build_multistep_plan",
    "build_sampler",
    "build_singlestep_plan",
    "build_unipc_plan",
    "execute_plan",
    "get_orders_and_timesteps_for_singlestep_solver",
    "get_time_steps",
    "graph_key",
    "make_dynamic_thresholding",
    "make_plan",
]
