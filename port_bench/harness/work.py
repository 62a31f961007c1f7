"""The yardstick's arithmetic: the chip's published peaks, the work and bytes
of each kernel launch counted from its shape, and the FLOPs a request needs
counted from the configuration's shapes.

`launch_work` is the arithmetic of chip_smoke.py's `Case` (tensor-core
flops of bf16 products, fp32 operations on the CUDA cores, bytes with each
input read once and each output written once) for the kernels whose
roofline the benchmark reports, for bf16 calls (every cell's). `least_seconds`
is its bound: the larger of the operations' time at the peaks and the
bytes' time at HBM's rate.

`model_flops` counts a network call by running the plain reference network
on the meta device under `torch.utils.flop_counter.FlopCounterMode`: the
multiply-adds of its convolutions and matmuls (2 flops each), whatever
implements them in the program.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

# one NVIDIA H100 SXM, NVIDIA's data sheet, dense: bf16 tensor cores, fp32
# on the CUDA cores, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
HBM_BYTES_S = 3.35e12


def launch_work(kernel: str, spec: tuple) -> Tuple[float, float, float]:
    """(tensor-core flops, fp32 operations, bytes) of one bf16 launch of
    `kernel` at `spec`: conv3x3 (b, h, w, c, co); token_attention (b, t, s,
    heads, dh, fused)."""
    if kernel == "conv3x3":
        b, h, w, c, co = spec
        nbytes = 2 * (b * h * w * (c + co) + 9 * c * co) + 4 * co
        return 18 * b * h * w * c * co, b * h * w * co, nbytes
    if kernel == "token_attention":
        b, t, s, heads, dh, _ = spec
        return 4 * b * heads * t * s * dh, 5 * b * heads * t * s, 2 * 2 * b * heads * dh * (t + s)
    raise ValueError(f"no work is counted for kernel {kernel!r}")


def least_seconds(kernel: str, spec: tuple) -> float:
    tc, fp32, nbytes = launch_work(kernel, spec)
    return max(tc / PEAK_BF16, fp32 / PEAK_FP32, nbytes / HBM_BYTES_S)


def model_flops(build: Callable[[], torch.nn.Module], make_inputs: Callable[[], tuple]) -> float:
    """FLOPs of one call `build()(*make_inputs())`, the module and its
    inputs made, and the call run, on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        net, args = build(), make_inputs()
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        net(*args)
    return float(counter.get_total_flops())
