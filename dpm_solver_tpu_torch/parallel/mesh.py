"""The device mesh, batch shardings, the collectives, and the sharded batch sampler.

Port of `dpm_solver_tpu/parallel/mesh.py`. The JAX package lays one
`jax.sharding.Mesh` over every device from a single controller and lets
GSPMD insert the collectives. The port runs one process a rank
(`torch.distributed`, started by `parallel/launch.py::run_ranks`, torchrun or
the like) and the mesh is a `torch.distributed.device_mesh.DeviceMesh` over
the world, with a `data` axis (and a `model` axis for tensor parallelism,
`parallel/tp.py`).

The backend is explicit:
- on CUDA, NCCL, one rank a visible card; more ranks than cards raise,
  unless the caller names `backend="gloo"`, a test transport that runs
  several ranks on one card (gloo copies each collective through the host;
  it takes CUDA tensors for every collective the port calls);
- on the CPU, gloo.
The port never picks gloo for CUDA tensors by itself.

A sharded call takes the global batch on every rank, runs the rank's rows,
and gathers the result, so every rank returns the global result: the
counterpart of a global `jax.Array`. Per-sample tensors (conditioning,
labels, masks, SDE noise) are sliced with x; a model function must not close
over a full-batch tensor (its rows would not match x's: the executor's shape
check raises).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from dpm_solver_tpu_torch.utils import graphs
from dpm_solver_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

# DeviceMesh -> the device its ranks' tensors live on
_DEVICES = {}


def _init_world(dev: torch.device, backend: str) -> None:
    """A world of one rank, when no process group exists yet."""
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(devices: Union[None, int, Sequence] = None,
              axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None, *,
              device: Union[str, torch.device] = DEFAULT_DEVICE,
              backend: Optional[str] = None) -> DeviceMesh:
    """A DeviceMesh over the world's ranks.

    `devices` is the JAX argument: None (every rank), a rank count, or a
    sequence whose length is the rank count; it must match the world size.
    With no process group yet, a world of one rank is started (on NCCL on
    the card). `shape` is required for several axes, as in JAX. `device` is
    where the ranks' tensors live: "cuda" (the card, by default) puts rank r
    on card r (mod the visible cards, under gloo), "cpu" on the host.
    `backend`: None picks NCCL on CUDA and gloo on the CPU; "gloo" on CUDA
    must be named.
    """
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if dev.type != "cuda" and backend == "nccl":
        raise ValueError("NCCL takes CUDA tensors only; the CPU mesh runs on gloo")
    if not dist.is_initialized():
        _init_world(torch.device("cuda", dev.index or 0) if dev.type == "cuda" else dev, backend)
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, the mesh asks for "
                         f"{backend!r}" + (" (gloo on CUDA is a test transport the caller "
                                           "names: backend='gloo')" if dev.type == "cuda" else ""))
    world, rank = dist.get_world_size(), dist.get_rank()
    if devices is not None:
        n = devices if isinstance(devices, int) else len(devices)
        if n != world:
            raise ValueError(f"a mesh over {n} devices needs a world of {n} ranks; this one has "
                             f"{world}")
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if backend == "nccl" and world > cards:
            raise ValueError(f"{world} ranks on NCCL need {world} visible cards; torch sees "
                             f"{cards} (NCCL takes one rank a card: pass backend='gloo' to run "
                             f"several ranks on one card as a test transport)")
        dev = torch.device("cuda", rank % cards)
        torch.cuda.set_device(dev)
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("explicit shape required for multi-axis meshes")
        shape = (world,)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or torch.Size(shape).numel() != world:
        raise ValueError(f"mesh shape {shape} over axes {tuple(axis_names)} does not cover "
                         f"{world} ranks")
    # the mesh's own device type is the backend's: a gloo mesh is a host
    # transport whatever its tensors' device
    mesh = DeviceMesh("cuda" if backend == "nccl" else "cpu",
                      torch.arange(world).reshape(shape), mesh_dim_names=tuple(axis_names))
    _DEVICES[id(mesh)] = dev
    return mesh


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors live on under `mesh`."""
    return _DEVICES[id(mesh)]


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str):
    return mesh.get_group(axis)


# --------------------------------------------------------------------------- #
# collectives
# --------------------------------------------------------------------------- #


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Sum (or `op`) `t` over `group`, in place. An NCCL all-reduce is device
    work that a CUDA graph captures; another backend's (gloo: host work)
    becomes, inside a `SegmentedGraph` capture, a host step between two
    graphs."""
    if dist.get_backend(group) == "nccl":
        dist.all_reduce(t, op=op, group=group)
    else:
        graphs.host_step(lambda: dist.all_reduce(t, op=op, group=group))
    return t


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group,
                     bucket_bytes: int = 2 ** 25) -> None:
    """Average each tensor over `group`, in place: one all-reduce a bucket of
    about `bucket_bytes` (tensors of one dtype flattened into it)."""
    n = dist.get_world_size(group)
    if n == 1:
        return
    bucket, size = [], 0

    def flush():
        flat = torch.cat([t.reshape(-1) for t in bucket])
        all_reduce_(flat, group)
        flat.div_(n)
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(part.view_as(t))
        bucket.clear()

    for t in tensors:
        if bucket and (t.dtype != bucket[0].dtype or size + t.nbytes > bucket_bytes):
            flush()
            size = 0
        bucket.append(t)
        size += t.nbytes
    if bucket:
        flush()


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Each rank's `t` (one shape on every rank) joined along `dim` in rank
    order."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


# --------------------------------------------------------------------------- #
# shardings
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a tensor lies on `mesh`: its leading (batch) dim split over
    `axis` in rank order, or replicated (axis None)."""

    mesh: DeviceMesh
    axis: Optional[str] = None

    @property
    def device(self) -> torch.device:
        return mesh_device(self.mesh)

    @property
    def size(self) -> int:
        return 1 if self.axis is None else axis_size(self.mesh, self.axis)

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of `n`."""
        if self.axis is None:
            return slice(0, n)
        k = self.size
        if n % k:
            raise ValueError(f"a batch of {n} does not divide over the {k} ranks of mesh axis "
                             f"{self.axis!r}")
        r = axis_rank(self.mesh, self.axis)
        return slice(r * (n // k), (r + 1) * (n // k))

    def local(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's rows of the global `t` (along `dim`), on the mesh's device."""
        rows = self.rows(t.shape[dim])
        return t.to(self.device).narrow(dim, rows.start, rows.stop - rows.start)

    def gather(self, t, dim: int = 0):
        """Every rank's rows of the batch (along `dim`) joined: the global
        tensor (of each tensor of a tuple or list, such as a sampler's x0
        and intermediates)."""
        if not isinstance(t, torch.Tensor):
            return type(t)(self.gather(u, dim) for u in t)
        if self.axis is None:
            return t
        return all_gather(t, axis_group(self.mesh, self.axis), dim)


def batch_sharding(mesh: DeviceMesh, axis: str = "data") -> Sharding:
    """Shard the leading (batch) dim over `axis`; everything else replicated."""
    if axis not in mesh.mesh_dim_names:
        raise ValueError(f"mesh has axes {mesh.mesh_dim_names}, not {axis!r}")
    return Sharding(mesh, axis)


def replicate(mesh: DeviceMesh) -> Sharding:
    return Sharding(mesh)


def make_sharded_sampler(sample_fn: Callable, mesh: DeviceMesh, *, axis: str = "data") -> Callable:
    """`sampler(x, noise=None, *batched) -> x0` over the global batch, its
    rows split over `axis`.

    `sample_fn(x, noise=None, *batched)` is a trajectory (`build_sampler`'s
    fn, model weights bound) that each rank runs on its rows: x's, the SDE
    noise's (steps, B, ...) along dim 1, and those of each per-sample tensor
    in `batched` (leading dim B), which `sample_fn` takes as arguments
    rather than closing over them. The trajectory makes no collective; the
    result (x0, or x0 and its intermediates) is gathered, so every rank
    returns the global batch. On CUDA tensors each rank replays its
    trajectory as a CUDA graph (`GraphedSampler`: one capture a rank and
    shard shape); on the CPU it runs eagerly.
    """
    from dpm_solver_tpu_torch.solver.sample import GraphedSampler

    sharding = batch_sharding(mesh, axis)
    run = GraphedSampler(sample_fn)

    def sampler(x: torch.Tensor, noise: Optional[torch.Tensor] = None, *batched):
        n = x.shape[0]
        for b in batched:
            if b.shape[0] != n:
                raise ValueError(f"a per-sample tensor of {b.shape[0]} rows for a batch of {n}")
        noise_l = None if noise is None else sharding.local(noise, dim=1).contiguous()
        out = run(sharding.local(x).contiguous(), noise_l,
                  *(sharding.local(b).contiguous() for b in batched))
        return sharding.gather(out)

    return sampler
