"""Flax DDPM UNet parameters -> the port's torch state dict.

The inverse of `dpm_solver_tpu/utils/convert.py::convert_ddpm_unet`, so
weights made by the JAX package (random inits in tests, or converted
checkpoints) load into `models.DDPMUNet` with a plain `load_state_dict`.
It reads nested dicts of arrays (numpy, or anything `np.asarray` takes) and
imports nothing of JAX. Layout rules, the converter's in reverse:

  conv  kernel [kH, kW, I, O]   -> weight [O, I, kH, kW]
  dense kernel [I, O]           -> weight [O, I]
  GroupNorm32 norm.scale / bias -> weight / bias
  temb_dense{i}                 -> temb.dense.{i}
  {down,up}_{l}_{block,attn}_{i} -> {down,up}.{l}.{block,attn}.{i}
  {down,up}_{l}_{down,up}sample -> {down,up}.{l}.{down,up}sample
  mid_{name}                    -> mid.{name}
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_LEVEL = re.compile(r"^(down|up)_(\d+)_(block|attn)_(\d+)$")
_RESAMPLE = re.compile(r"^(down|up)_(\d+)_(downsample|upsample)$")
_TEMB = re.compile(r"^temb_dense(\d+)$")


def _module_path(name: str) -> str:
    for pattern, fmt in ((_LEVEL, "{0}.{1}.{2}.{3}"), (_RESAMPLE, "{0}.{1}.{2}"),
                         (_TEMB, "temb.dense.{0}")):
        m = pattern.match(name)
        if m:
            return fmt.format(*m.groups())
    if name.startswith("mid_"):
        return "mid." + name[len("mid_"):]
    return name  # conv_in, conv_out, norm_out


def _leaves(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def ddpm_unet_state_dict_from_flax(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """DDPMUNet flax params ({'params': {...}} or the inner dict) -> torch state dict."""
    tree = flax_params.get("params", flax_params)
    out: Dict[str, torch.Tensor] = {}
    for path, val in _leaves(tree):
        arr = np.asarray(val)
        mods, leaf = list(path[:-1]), path[-1]
        mods[0] = _module_path(mods[0])
        if leaf == "scale" or (len(mods) > 1 and mods[-1] == "norm"):
            # GroupNorm32 wraps nn.GroupNorm in a child called 'norm'
            mods = mods[:-1]
            leaf = "weight" if leaf == "scale" else "bias"
        elif leaf == "kernel":
            leaf = "weight"
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:
                arr = arr.transpose(1, 0)
            else:
                raise ValueError(f"unexpected kernel rank at {'/'.join(path)}: {arr.shape}")
        elif leaf != "bias":
            raise ValueError(f"unexpected leaf {'/'.join(path)}")
        out[".".join(mods + [leaf])] = torch.tensor(arr)
    return out
