"""Seeded random weights, made on the device in a few large draws.

The names and shapes come from the reference networks, whose keys are the
published checkpoints' keys; the program loads the same state dict through
its own loaders. Every value is a function of the seed alone: the
parameters in sorted-name order take consecutive slices of one stream of
standard normals, drawn `CHUNK` values a call from a generator on the
device. Weights take N(0, 1/fan_in) (fan_in: the product of the trailing
dims), biases N(0, 0.01^2), norm scales 1 + N(0, 0.1^2): no layer is zero,
so every block of the network changes the result.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

CHUNK = 1 << 27   # values a draw (512 MiB of float32)


def seed_value(*parts: int) -> int:
    """A 63-bit generator seed from whole numbers of any size."""
    h = 1469598103934665603
    for p in parts:
        for byte in int(p).to_bytes(16, "little", signed=True):
            h = ((h ^ byte) * 1099511628211) % (1 << 64)
    return h & ((1 << 63) - 1)


def _scale(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(scale, offset) of a parameter's standard normals."""
    if name.endswith("bias"):
        return 0.01, 0.0
    if len(shape) == 1:
        return 0.1, 1.0
    return 1.0 / math.sqrt(math.prod(shape[1:])), 0.0


def seeded_state_dict(shapes: Iterable[Tuple[str, Tuple[int, ...]]], seed: int,
                      device: torch.device, stream: int = 0) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on `device`} for (name, shape) pairs; `stream`
    tells apart the networks drawn under one seed."""
    items = sorted((name, tuple(shape)) for name, shape in shapes)
    g = torch.Generator(device=device).manual_seed(seed_value(seed, stream))
    left = sum(math.prod(shape) for _, shape in items)
    out, buf, pos = {}, None, 0
    for name, shape in items:
        n, parts, filled = math.prod(shape), [], 0
        while filled < n:
            if buf is None or pos == buf.numel():
                buf, pos = torch.randn(min(CHUNK, left), generator=g, device=device), 0
                left -= buf.numel()
            take = min(n - filled, buf.numel() - pos)
            parts.append(buf[pos:pos + take])
            pos += take
            filled += take
        flat = parts[0].clone() if len(parts) == 1 else torch.cat(parts)
        scale, offset = _scale(name, shape)
        out[name] = flat.mul_(scale).add_(offset).reshape(shape)
    return out


def shapes_of(module: torch.nn.Module, prefix: str = ""):
    return [(prefix + k, tuple(v.shape)) for k, v in module.state_dict().items()]
