"""Parallelism for the port: the mesh, sharded samplers and train steps, ZeRO-1,
tensor parallelism and the multi-process helpers.

Port of `dpm_solver_tpu/parallel/`, on `torch.distributed` with one process a
rank (`launch.run_ranks` starts them); see `mesh.py` for the design.
"""

from dpm_solver_tpu_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    make_sharded_sampler,
    replicate,
)
from dpm_solver_tpu_torch.parallel.rng import per_process_key, sample_noise

__all__ = [
    "batch_sharding",
    "make_mesh",
    "make_sharded_sampler",
    "per_process_key",
    "replicate",
    "sample_noise",
]
