"""Multi-process coordination utilities.

Port of `dpm_solver_tpu/parallel/multihost.py`. The JAX helpers wrap
`jax.process_index()` and `multihost_utils`; here a process is a rank of the
default `torch.distributed` group, and the collectives are its gloo or NCCL
ones. Each helper is a no-op on one process (or with no process group), as in
JAX, so run_lib and eval loops stay count-agnostic.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.distributed as dist


def _count_and_index():
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def host_fold(seed: int, *, host_id: int | None = None) -> int:
    """Per-process seed (`jax.random.fold_in(rng, jax.process_index())`):
    `seed` folded with the process index (or `host_id`)."""
    h = _count_and_index()[1] if host_id is None else host_id
    ss = np.random.SeedSequence([int(seed) % 2 ** 63, int(h)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def allgather_metrics(tree: Any) -> Any:
    """Gather per-process metric trees (numbers, arrays or tensors) onto
    every process: numpy leaves that gain a leading [n_processes] axis."""
    n, _ = _count_and_index()
    if n == 1:
        return _map(lambda a: np.asarray(_host(a))[None], tree)

    def gather(a):
        arr = np.asarray(_host(a))
        t = torch.from_numpy(np.ascontiguousarray(arr)).reshape(-1)
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t)
        return torch.stack(parts).numpy().reshape((n,) + arr.shape)

    return _map(gather, tree)


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a


def barrier(name: str = "barrier") -> None:
    """Cross-process sync point (the reference's file-existence barrier,
    run_lib.py:564-568). `name` labels it, as in JAX."""
    if _count_and_index()[0] == 1:
        return
    dist.barrier()


def host_subset(items, *, host_id: int | None = None, n_hosts: int | None = None):
    """Shard a host-side work list across processes (per-process sampling
    rounds and file shards, ref run_lib.py:452-503): item i goes to process
    i mod n."""
    count, index = _count_and_index()
    h = index if host_id is None else host_id
    n = count if n_hosts is None else n_hosts
    return [x for i, x in enumerate(items) if i % n == h]


def _smoke_worker(process_id: int, num_processes: int) -> str:
    """One process of the multi-process smoke (a rank of a gloo world that
    `parallel.launch.run_ranks` started): a cross-process collective over a
    sharded global batch, every helper above, and the barrier. Returns and
    prints MULTIHOST_OK on success."""
    from dpm_solver_tpu_torch.parallel.mesh import batch_sharding, make_mesh

    assert dist.get_world_size() == num_processes and dist.get_rank() == process_id
    mesh = make_mesh(device="cpu")
    sharding = batch_sharding(mesh)

    # a global batch assembled from each process's rows; its sum over all of
    # them is a real cross-process collective
    local = torch.full((2, 2), float(process_id))
    total = float(sharding.gather(local).sum())
    expect = sum(4.0 * p for p in range(num_processes))
    assert total == expect, (total, expect)

    # per-process seed folding: every process's stream must differ, and
    # allgather_metrics must deliver all of them everywhere
    seeds = allgather_metrics(np.asarray([host_fold(0)], np.int64))
    assert seeds.shape == (num_processes, 1)
    assert len({int(s) for s in seeds.ravel()}) == num_processes

    # work-list sharding: the subsets partition the list exactly
    sub = host_subset(list(range(10)))
    counts = allgather_metrics(np.asarray([len(sub)], np.int64))
    assert int(np.sum(counts)) == 10

    barrier("multihost-smoke")
    line = f"MULTIHOST_OK {process_id}"
    print(line, flush=True)
    return line
