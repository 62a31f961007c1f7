"""What the entry drivers share: the port's kernel names, the benchmark's
spans and clocks, the configuration's dtypes, and TF32 off for the
reference.

The port's own kernels are found in a device trace by name: the CUDA
kernels of `dpm_solver_tpu_torch/csrc/*.cu` and the Triton kernels of its
`ops/`. Every other device operation is the library's (PyTorch, cuBLAS,
cuDNN).
"""

from __future__ import annotations

import contextlib
import time

import torch

OWN = (r"\b(conv3x3_\w+|attention_fwd_\w+|attention_out_\w+|attn_d\w+|attn_bwd_\w+|geglu_\w+"
       r"|ln_linear_\w+|fused_update_kernel|bias_act_\w+)")
KERNELS = {"own": OWN, "conv3x3": r"\bconv3x3_(wgmma|narrow|f32)\b",
           "token_attention": r"\battention_fwd_(wgmma|f32)\b"}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def span(name: str, on: bool):
    """The benchmark's span `bench.<name>` in a profiler trace (nothing when off)."""
    return torch.profiler.record_function("bench." + name) if on else contextlib.nullcontext()


def host_clock(dev: torch.device):
    """Starts a host-clock span after a synchronize; the function it returns
    ends it after another and returns a reader of its seconds."""
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()

    def stop():
        sync()
        seconds = time.perf_counter() - t0
        return lambda: seconds
    return stop


def device_clock(dev: torch.device):
    """Starts a span at a CUDA event (the host clock off the card); the
    function it returns ends it and returns a reader of its seconds, to be
    called once the work is done."""
    if dev.type != "cuda":
        return host_clock(dev)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()

    def stop():
        b.record()
        return lambda: a.elapsed_time(b) / 1e3
    return stop


@contextlib.contextmanager
def tf32_off():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
