"""Hand-written Hopper kernels of the port, each beside its plain PyTorch twin.

    fused_update    -- the solver update, Triton             (fused_update.py)
    conv3x3         -- 3x3 SAME NHWC conv, CUDA C++           (conv3x3.py, csrc/conv3x3.cu)
    conv3x3_dx      -- its input gradient, the same kernel    (conv3x3.py, csrc/conv3x3.cu)
    token_attention -- attention forward, CUDA C++            (attention.py, csrc/attention.cu)
    attention_lse   -- the forward writing its base-2 lse     (attention.py, csrc/attention.cu)
    attention_dq    -- attention backward, dq, CUDA C++       (attention.py, csrc/attention_bwd.cu)
    attention_dkv   -- attention backward, dk/dv, CUDA C++    (attention.py, csrc/attention_bwd.cu)
    ln_linear       -- LayerNorm -> Linear, CUDA C++          (ln_linear.py, csrc/ln_linear.cu)
    geglu_ff        -- GEGLU feed-forward, CUDA C++           (geglu.py, csrc/geglu.cu)
    fused_bias_act  -- bias + scaled LeakyReLU, Triton        (fused_act.py)
    fused_bias_act_bwd -- its input gradient, Triton          (fused_act.py)
    attention_out_fused -- attention -> out-projection -> residual, CUDA C++
                                                              (attention.py, csrc/attention_out.cu)

A CPU tensor takes the plain twin; a CUDA tensor launches the kernel or
raises. Each wrapper counts its launches in `<wrapper>.launches`; one launch
counts under one wrapper only (a `geglu_ff` call counts one, whichever of
its route's kernels it runs). The wrappers of the kernels with more than
one route (`ROUTED`: conv3x3 and its dx, "wgmma" / "narrow" / "f32";
ln_linear and geglu_ff, "wgmma" / "wmma" / "f32"; the attention forward,
its lse form, dq and dk/dv, and attention_out_fused, "wgmma" / "f32") also
count them by route, in
`<wrapper>.launches_by_route`. `conv3x3` and `token_attention` are
differentiable (torch.autograd.Function): their backwards launch `conv3x3_dx`,
`attention_dq` and `attention_dkv`, and a forward that keeps its residual
for them launches as `attention_lse`. `ln_linear` and `geglu_ff` are
differentiable too; their backwards are recompute VJPs of their plain
twins (`ln_linear_vjp`, `geglu_vjp`), as in the JAX package. `fused_bias_act` and
`attention_out_fused` are differentiable too, and, as in the JAX package,
no sampling path calls them. `resample` holds the FIR resampling ops:
library convs, no kernel.
"""

from dpm_solver_tpu_torch.ops.attention import (
    attention_backward_plain,
    attention_dkv,
    attention_dq,
    attention_lse,
    attention_lse_plain,
    attention_out_fused,
    attention_out_plain,
    attention_plain,
    token_attention,
)
from collections import Counter

from dpm_solver_tpu_torch.ops.conv3x3 import Conv3x3, conv3x3, conv3x3_dx, conv3x3_plain
from dpm_solver_tpu_torch.ops.fused_act import (bias_act_grad_plain, bias_act_plain,
                                                fused_bias_act, fused_bias_act_bwd)
from dpm_solver_tpu_torch.ops.fused_update import fused_update, fused_update_plain
from dpm_solver_tpu_torch.ops.geglu import geglu_ff, geglu_plain, geglu_vjp, gelu_exact
from dpm_solver_tpu_torch.ops.ln_linear import (layer_norm_fp32, ln_linear, ln_linear_plain,
                                               ln_linear_vjp)

KERNELS = (conv3x3, token_attention, fused_update, ln_linear, geglu_ff, attention_lse,
           attention_dq, attention_dkv, conv3x3_dx, fused_bias_act, fused_bias_act_bwd,
           attention_out_fused)
ROUTED = (conv3x3, conv3x3_dx, token_attention, attention_lse, attention_dq, attention_dkv,
          ln_linear, geglu_ff, attention_out_fused)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    for fn in ROUTED:
        fn.launches_by_route = Counter()


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


def launch_routes() -> dict:
    """{wrapper: {route: launches}} of the wrappers in ROUTED."""
    return {fn.__name__: dict(fn.launches_by_route) for fn in ROUTED}


__all__ = [
    "Conv3x3",
    "KERNELS",
    "ROUTED",
    "attention_backward_plain",
    "attention_dkv",
    "attention_dq",
    "attention_lse",
    "attention_lse_plain",
    "attention_out_fused",
    "attention_out_plain",
    "attention_plain",
    "bias_act_grad_plain",
    "bias_act_plain",
    "conv3x3",
    "conv3x3_dx",
    "conv3x3_plain",
    "fused_bias_act",
    "fused_bias_act_bwd",
    "fused_update",
    "fused_update_plain",
    "geglu_ff",
    "geglu_plain",
    "geglu_vjp",
    "gelu_exact",
    "launch_counts",
    "launch_routes",
    "layer_norm_fp32",
    "ln_linear",
    "ln_linear_plain",
    "ln_linear_vjp",
    "reset_launch_counts",
    "token_attention",
]
