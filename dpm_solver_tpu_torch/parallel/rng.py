"""RNG discipline for multi-rank sampling and training.

Port of `dpm_solver_tpu/parallel/rng.py`. JAX's partitionable threefry gives
one logical key the same global batch under any sharding; torch generators
have no such property, so the port keeps it by construction: every rank
draws the whole global tensor from an explicit `torch.Generator` seeded with
the logical seed, then takes its rows. The global batch is then the same for
every world size (bitwise), at the cost of each rank drawing all of it. The
streams are torch's, not `jax.random`'s: the values differ from the JAX
package's for the same seed.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist


def per_process_key(seed: int) -> int:
    """The logical seed folded with this process's rank (distinct
    host-local streams; `jax.random.fold_in(key, jax.process_index())`)."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    ss = np.random.SeedSequence([int(seed) % 2 ** 63, rank])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def sample_noise(seed, shape: Sequence[int], dtype: torch.dtype = torch.float32,
                 sharding=None) -> torch.Tensor:
    """x_T ~ N(0, I) of the global `shape`, drawn on the CPU from a generator
    seeded with `seed` (an int, or a torch.Generator to draw from), so that
    the draw is bitwise the same on every rank and for every world size. With
    a `sharding` (`parallel.batch_sharding`), this rank's rows of it on the
    mesh's device; else the global tensor on the CPU."""
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    x = torch.randn(tuple(shape), generator=gen, device=gen.device).to(dtype)
    return x if sharding is None else sharding.local(x)
