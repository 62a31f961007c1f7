"""Tensor parallelism for the attention- and MLP-heavy UNets, Megatron style.

Port of `dpm_solver_tpu/parallel/tp.py`. The JAX package writes the
Megatron pattern as GSPMD sharding annotations over a 2-D (data, model) mesh
and lets XLA insert the all-reduces. The port shards the modules explicitly:
each rank of a `model` group keeps its slices of the projections and runs the
same kernels on them, and the collectives are written out.

Per transformer block (`models/transformer.py`), and per ADM attention block:
- column-parallel: to_q, to_k, to_v (the self-attention's q|k|v is one
  `ln_linear` over the rank's rows of the three), the GEGLU in-projection
  `ff.net.0.proj` (each of its [h | gate] halves split by the same rows) and
  the ADM block's `qkv` (split per head, in the layout the block uses):
  each rank computes its heads, or its slice of the MLP;
- row-parallel: to_out, `ff.net.2`, `proj_out` (the transformer's, whose
  replicated input each rank slices locally, and the ADM block's): each rank
  multiplies its input features, the partial sums are all-reduced over the
  group (in the activations' dtype, as Megatron does), and the bias is added
  once, after the reduce;
- everything else (convs, norms, embeddings, proj_in) is replicated.

Heads are split as evenly as the count allows (SD-2.1's 5 heads of 64 at 320
channels go 3 + 2 on two ranks), where GSPMD pads: the port keeps JAX's
reach. Autograd: a replicated tensor entering a column-parallel product goes
through an identity whose backward all-reduces its gradient (the fused
LayerNorm's weight and bias with it), and a row-parallel output through an
all-reduce whose backward is the identity. The global-norm clip of a train
step sums the sharded parameters' squares over the group (`optim.py`).
Under a `SegmentedGraph` capture (the graphed trajectory) an NCCL all-reduce
is captured in the graph; a gloo all-reduce splits it (`utils/graphs.py`).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Mapping, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from dpm_solver_tpu_torch.parallel.mesh import (all_reduce_, axis_group, axis_rank, axis_size,
                                                batch_sharding, make_mesh)

# the reference state-dict names of the JAX column and row kernels
# (`_COLUMN`, `_ROW` of dpm_solver_tpu/parallel/tp.py): torch layout, so a
# column-parallel weight splits its out features (dim 0) and a row-parallel
# one its in features (dim 1)
_COLUMN = re.compile(r"(^|\.)(to_q|to_k|to_v|qkv)\.(weight|bias)$"
                     r"|(^|\.)ff\.net\.0\.proj\.(weight|bias)$")
_ROW = re.compile(r"(^|\.)(to_out\.0|proj_out|ff\.net\.2)\.weight$")


def tp_spec_for(name: str, ndim: int) -> Optional[int]:
    """The torch axis the parameter `name` is split along over the model
    axis (0: a column-parallel weight or bias, 1: a row-parallel weight), or
    None (replicated; a row-parallel bias is added after the reduce)."""
    if _COLUMN.search(name):
        return 0
    if _ROW.search(name) and ndim >= 2:
        return 1
    return None


def tp_param_specs(params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> Dict[str, Optional[int]]:
    """{name: `tp_spec_for`} over a module's parameters (or a state dict)."""
    items = params.named_parameters() if isinstance(params, nn.Module) else params.items()
    return {k: tp_spec_for(k, v.dim()) for k, v in items}


def split_sizes(n: int, parts: int) -> List[int]:
    """`n` split into `parts` counts as even as possible, larger first."""
    return [n // parts + (i < n % parts) for i in range(parts)]


def _span(n: int, parts: int, rank: int) -> slice:
    sizes = split_sizes(n, parts)
    lo = sum(sizes[:rank])
    return slice(lo, lo + sizes[rank])


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the group."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward; the gradient passed through."""

    @staticmethod
    def forward(ctx, t, group):
        return _reduced(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _reduced(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of `t` over `group` (a new tensor)."""
    return all_reduce_(t.clone(), group)


class TPSite:
    """A sharded module's share: its model group, and (for a row-parallel
    product over a replicated input) the input features it keeps."""

    def __init__(self, group, cols: Optional[slice] = None):
        self.group, self.cols = group, cols

    def copy(self, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        if t is None or not (torch.is_grad_enabled() and t.requires_grad):
            return t
        return _CopyToModel.apply(t, self.group)

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        return _ReduceFromModel.apply(t, self.group)

    def row_linear(self, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
        """x @ weight.T + bias for a row-parallel weight (out, local in):
        x is this rank's input features (or the replicated input, sliced to
        `cols` here), the partial products summed over the group, the bias
        added once."""
        if self.cols is not None:
            x = self.copy(x)[..., self.cols]
        return self.reduce(F.linear(x.to(dtype), weight.to(dtype))) + bias.to(dtype)


def _param(t: torch.Tensor, group) -> nn.Parameter:
    p = nn.Parameter(t.detach().clone().contiguous(), requires_grad=t.requires_grad)
    p.tp_group = group   # a sharded parameter: the clip's norm sums it over the group
    return p


def _shard_cross_attention(name: str, mod, rank: int, n: int, group) -> None:
    if mod.quant is not None:
        raise ValueError(f"tensor parallelism does not shard the int8 ({mod.quant}) "
                         f"projections of {name}")
    if mod.heads < n:
        raise ValueError(f"{name} has {mod.heads} heads, fewer than the {n} ranks of the "
                         f"model axis")
    heads = _span(mod.heads, n, rank)
    rows = slice(heads.start * mod.dim_head, heads.stop * mod.dim_head)
    for proj in (mod.to_q, mod.to_k, mod.to_v):
        proj.weight = _param(proj.weight[rows], group)
    out = mod.to_out[0]
    out.weight = _param(out.weight[:, rows], group)
    mod.heads = heads.stop - heads.start
    mod.tp = TPSite(group)


def _shard_geglu(name: str, mod, rank: int, n: int, group) -> None:
    if mod.quant is not None:
        raise ValueError(f"tensor parallelism does not shard the int8 ({mod.quant}) "
                         f"feed-forward of {name}")
    proj, out = mod.net[0].proj, mod.net[2]
    inner = out.weight.shape[1]
    span = _span(inner, n, rank)
    # [h | gate]: each half split by the same rows
    idx = torch.cat([torch.arange(span.start, span.stop),
                     inner + torch.arange(span.start, span.stop)]).to(proj.weight.device)
    proj.weight = _param(proj.weight[idx], group)
    proj.bias = _param(proj.bias[idx], group)
    out.weight = _param(out.weight[:, span], group)
    mod.tp = TPSite(group)


def _shard_proj_out(name: str, mod, rank: int, n: int, group) -> None:
    proj = mod.proj_out
    cols = _span(proj.weight.shape[1], n, rank)
    proj.weight = _param(proj.weight[:, cols], group)
    mod.tp = TPSite(group, cols)


def _shard_adm_attention(name: str, mod, rank: int, n: int, group) -> None:
    if mod.num_heads < n:
        raise ValueError(f"{name} has {mod.num_heads} heads, fewer than the {n} ranks of the "
                         f"model axis")
    c = mod.proj_out.weight.shape[0]
    ch = c // mod.num_heads
    heads = _span(mod.num_heads, n, rank)
    mine = torch.arange(heads.start * ch, heads.stop * ch)
    if mod.new_order:    # [q all heads | k all heads | v all heads]
        idx = torch.cat([mine, c + mine, 2 * c + mine])
    else:                # legacy: head-major [h0: q k v, h1: q k v, ...]
        idx = torch.arange(heads.start * 3 * ch, heads.stop * 3 * ch)
    idx = idx.to(mod.qkv.weight.device)
    mod.qkv.weight = _param(mod.qkv.weight[idx], group)
    mod.qkv.bias = _param(mod.qkv.bias[idx], group)
    mod.proj_out.weight = _param(mod.proj_out.weight[:, mine.to(idx.device)], group)
    mod.num_heads = heads.stop - heads.start
    mod.tp = TPSite(group)


def shard_params(model: nn.Module, mesh, model_axis: str = "model") -> nn.Module:
    """Shard `model`'s transformer blocks and ADM attention blocks over the
    mesh's `model_axis`, in place, and return it: each rank keeps its slices
    (`tp_param_specs`) and its modules run the tensor-parallel forward. A
    parameter the specs split that no shardable module holds raises, naming
    it."""
    from dpm_solver_tpu_torch.models.adm_unet import ADMAttention
    from dpm_solver_tpu_torch.models.transformer import (CrossAttention, GEGLUFeedForward,
                                                         SpatialTransformer)

    group, rank, n = axis_group(mesh, model_axis), axis_rank(mesh, model_axis), \
        axis_size(mesh, model_axis)
    wanted = {k for k, ax in tp_param_specs(model).items() if ax is not None}
    for name, mod in list(model.named_modules()):
        for kind, fn, owns in ((CrossAttention, _shard_cross_attention,
                                ("to_q.weight", "to_k.weight", "to_v.weight", "to_out.0.weight")),
                               (GEGLUFeedForward, _shard_geglu,
                                ("net.0.proj.weight", "net.0.proj.bias", "net.2.weight")),
                               (SpatialTransformer, _shard_proj_out, ("proj_out.weight",)),
                               (ADMAttention, _shard_adm_attention,
                                ("qkv.weight", "qkv.bias", "proj_out.weight"))):
            if isinstance(mod, kind):
                fn(name, mod, rank, n, group)
                wanted -= {f"{name}.{k}" if name else k for k in owns}
    if wanted:
        raise ValueError(f"tensor parallelism cannot shard {sorted(wanted)[:4]} "
                         f"({len(wanted)} parameters): no shardable module holds them")
    return model


def make_tp_mesh(devices=None, *, data: Optional[int] = None, model: int = 2, device="cuda",
                 backend: Optional[str] = None):
    """A (data, model) mesh over the world's ranks; data fills the remainder."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    count = world if devices is None else (devices if isinstance(devices, int) else len(devices))
    if data is None:
        data = count // model
    if data * model != count:
        raise ValueError(f"a ({data}, {model}) mesh does not cover {count} ranks")
    return make_mesh(devices, ("data", "model"), (data, model), device=device, backend=backend)


def make_tp_fn(fn: Callable, mesh, model: nn.Module, *, model_axis: str = "model"):
    """`fn(model, x, *batched)` with the model tensor-parallel over
    `model_axis` and the batch split over the data axis. Returns
    (tp_fn(x, *batched) -> the gathered global output, the sharded model).
    x and each per-sample tensor of `batched` are global; each rank runs its
    data rows, its model group splitting the network."""
    shard_params(model, mesh, model_axis)
    sharding = batch_sharding(mesh, "data")

    def tp_fn(x: torch.Tensor, *batched):
        return sharding.gather(fn(model, sharding.local(x),
                                  *(sharding.local(b) for b in batched)))

    return tp_fn, model
