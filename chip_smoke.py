#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py

Run from the root of a checkout. It needs one CUDA device, nvcc and triton,
and nothing of JAX. Phases, each fatal on failure:

1. environment: torch and CUDA versions, the card's name and power limit;
   exits non-zero at once when `torch.cuda.is_available()` is false;
2. build: nvcc compiles `dpm_solver_tpu_torch/csrc/*.cu` for sm_90a into the
   ignored `dpm_solver_tpu_torch/_build/`;
3. kernels: each hand-written kernel against its plain PyTorch version on the
   card, at the slice's shapes and at tiny and ragged ones, fp32 and bf16;
4. the slice: the CIFAR-10 DDPM UNet at full width with seeded random weights
   in bf16, sampled at batch 64 by DPM-Solver++ 3M for 10 NFE on the logSNR
   grid of the discrete schedule, through `NoiseScheduleVP`, `model_wrapper`
   and `DPM_Solver.sample`; the launch counters must rise by exactly the
   expected counts; then batch 4 in fp32 against the plain path on the CPU;
5. timing: the batch-64 sample's median wall time, and each kernel against
   its plain version at the slice's shapes, each beside the card's name and
   power limit.

The last two lines are the kernels' JSON record and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BATCH, STEPS, ORDER = 64, 10, 3
# bounds on max|kernel - plain| / max|plain| (plain in fp32 on the same inputs,
# TF32 off): fp32 -> different summation order only; bf16 -> the kernel's one
# rounding of its output to bf16 (unit roundoff 2^-8 = 3.9e-3) plus order
BOUND = {"float32": 1e-5, "bfloat16": 1e-2}
FUSED_BOUND = {"float32": 1e-6, "bfloat16": 1e-2}
# batch-4 fp32 trajectory, kernels on the card vs plain ops on the CPU, relative
# to max|x|: the repo's trajectory parity bound (tests/test_solver_parity.py:70-75)
SLICE_BOUND = 1e-4
REPLACES = {
    "conv3x3": ("cuda", "dpm_solver_tpu_torch/csrc/conv3x3.cu",
                "dpm_solver_tpu/ops/conv3x3.py:125"),
    "token_attention": ("cuda", "dpm_solver_tpu_torch/csrc/attention.cu",
                        "dpm_solver_tpu/ops/attention.py:442"),
    "fused_update": ("triton", "dpm_solver_tpu_torch/ops/fused_update.py",
                     "dpm_solver_tpu/ops/fused_update.py:92"),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` calls, after 3 warm calls."""
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got, want) -> tuple:
    d = (got.float() - want.float()).abs().max().item()
    return d, d / max(want.float().abs().max().item(), 1e-30)


def main() -> int:
    # ---- 1. environment ----------------------------------------------------
    import torch

    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this smoke runs on a GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import dpm_solver_tpu_torch as P
    from dpm_solver_tpu_torch import ops
    from dpm_solver_tpu_torch.models import DDPMUNet, DDPMUNetConfig, init_random_
    from dpm_solver_tpu_torch.ops import _build

    smi = card()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"nvidia-smi: {smi}  (torch: {kind}, {count} device(s))")
    dev = torch.device("cuda", 0)
    # every fp32 comparison below runs without TF32 (hopper guide §6)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)

    # ---- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {lib.relative_to(ROOT)}")

    # ---- 3. kernels against their plain versions ---------------------------
    g = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(*s, device=dev, generator=g)
    max_abs = {name: 0.0 for name in REPLACES}

    def report(name, shape, dtype, got, want, bound):
        torch.cuda.synchronize()
        d, r = rel_err(got, want)
        max_abs[name] = max(max_abs[name], d)
        ok = r <= bound and bool(torch.isfinite(got).all())
        log(f"  {name} {shape} {str(dtype)[6:]}: max|d| {d:.3e}, /max|plain| {r:.3e} "
            f"(bound {bound:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{name} {shape} {dtype} disagrees with its plain version")

    log("kernels vs plain (plain in fp32 on the same inputs, TF32 off):")
    for b, h, w, c, co in [(64, 32, 32, 128, 128), (64, 16, 16, 512, 256),
                           (64, 4, 4, 256, 256), (2, 8, 8, 32, 64), (3, 5, 7, 20, 9)]:
        for dt in (torch.float32, torch.bfloat16):
            x, wt = randn(b, h, w, c).to(dt), (randn(3, 3, c, co) * c ** -0.5).to(dt)
            bias = randn(co) * 0.1
            report("conv3x3", (b, h, w, c, co), dt, ops.conv3x3(x, wt, bias),
                   ops.conv3x3_plain(x.float(), wt.float(), bias), BOUND[str(dt)[6:]])
    for b, t, s, heads, dh in [(64, 256, 256, 1, 256), (64, 16, 16, 1, 256), (2, 64, 64, 1, 32),
                               (2, 77, 77, 1, 64), (2, 50, 77, 2, 64), (3, 33, 129, 4, 128)]:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (randn(b, n, heads * dh).to(dt) for n in (t, s, s))
            report("token_attention", (b, t, s, heads, dh), dt,
                   ops.token_attention(q, k, v, num_heads=heads),
                   ops.attention_plain(q.float(), k.float(), v.float(), num_heads=heads),
                   BOUND[str(dt)[6:]])
    coef = randn(4, 8)
    for shape in [(BATCH, 32, 32, 3), (1000,)]:
        for dt in (torch.float32, torch.bfloat16):
            xs = [randn(*shape).to(dt) for _ in range(5)]
            for z in (None, xs[4]):
                report("fused_update", (shape, "z" if z is not None else "ode"), dt,
                       ops.fused_update(coef, 2, *xs[:4], z),
                       ops.fused_update_plain(coef, 2, *[u.float() for u in xs[:4]],
                                              None if z is None else z.float()),
                       FUSED_BOUND[str(dt)[6:]])

    # ---- 4. the slice --------------------------------------------------------
    cfg = DDPMUNetConfig.cifar10()
    net_cpu = init_random_(DDPMUNet(cfg), torch.Generator().manual_seed(0)).eval()
    n_params = sum(p.numel() for p in net_cpu.parameters())
    net = DDPMUNet(cfg, compute_dtype=torch.bfloat16).to(dev).eval()
    net.load_state_dict(net_cpu.state_dict())
    ns = P.NoiseScheduleVP.discrete(betas=np.linspace(1e-4, 0.02, 1000))
    solver = P.DPM_Solver(P.model_wrapper(net, ns, model_type="noise"), ns,
                          algorithm_type="dpmsolver++")
    sample_kw = dict(steps=STEPS, order=ORDER, method="multistep", skip_type="logSNR")
    x_T = torch.randn(BATCH, cfg.resolution, cfg.resolution, 3, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(1))

    # conv3x3 shapes of one forward, for the timing phase
    conv_calls = []
    hooks = [m.register_forward_pre_hook(
        lambda m, a: conv_calls.append((tuple(a[0].shape), tuple(m.weight.shape))))
        for m in net.modules() if isinstance(m, ops.Conv3x3)]
    net(x_T.to(torch.bfloat16), torch.full((BATCH,), 500.0, device=dev))
    for hk in hooks:
        hk.remove()

    log(f"slice: CIFAR-10 DDPM UNet ({n_params / 1e6:.2f}M params, bf16 compute), "
        f"b{BATCH}, DPM-Solver++ {ORDER}M, {STEPS} NFE, logSNR, discrete betas")
    ops.reset_launch_counts()
    out = solver.sample(x_T, **sample_kw)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    expected = {"conv3x3": STEPS * 47, "token_attention": STEPS * 6, "fused_update": STEPS}
    log(f"  launches {launches} (expected {expected})")
    if launches != expected:
        fail(f"launch counts {launches} != {expected}")
    if out.shape != x_T.shape or out.dtype != torch.float32 or not torch.isfinite(out).all():
        fail(f"slice output {tuple(out.shape)} {out.dtype} is not finite fp32 of x_T's shape")
    log(f"  output {tuple(out.shape)} finite, max|x| {out.abs().max().item():.4f}")

    # batch 4 in fp32: kernels on the card against the plain ops on the CPU
    net32 = DDPMUNet(cfg).to(dev).eval()
    net32.load_state_dict(net_cpu.state_dict())
    x4 = x_T[:4].float()
    got = P.DPM_Solver(P.model_wrapper(net32, ns), ns).sample(x4, **sample_kw)
    t0 = time.perf_counter()
    want = P.DPM_Solver(P.model_wrapper(net_cpu, ns), ns).sample(x4.cpu(), **sample_kw)
    d, r = rel_err(got.cpu(), want)
    log(f"  b4 fp32 kernels (card) vs plain (cpu, {time.perf_counter() - t0:.1f} s): "
        f"max|d| {d:.3e}, /max|x| {r:.3e} (bound {SLICE_BOUND:g})")
    if not r <= SLICE_BOUND:
        fail("the fp32 slice on the card disagrees with the plain path")

    # ---- 5. timing -------------------------------------------------------------
    solver.sample(x_T, **sample_kw)  # warm
    walls = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.sample(x_T, **sample_kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    log(f"slice time on {smi}: median {wall * 1e3:.2f} ms over {len(walls)} runs "
        f"(min {min(walls) * 1e3:.2f}, max {max(walls) * 1e3:.2f}) -> "
        f"{BATCH / wall:.1f} samples/s")

    timing = {}
    shapes = {}
    for xs, ws in conv_calls:
        shapes[(xs, ws)] = shapes.get((xs, ws), 0) + 1
    k_ms = p_ms = 0.0
    for (xs, ws), n in sorted(shapes.items()):
        x = randn(*xs).to(torch.bfloat16)
        w = randn(ws[2], ws[3], ws[1], ws[0]).to(torch.bfloat16).contiguous()
        bias = randn(ws[0])
        k = cuda_ms(lambda: ops.conv3x3(x, w, bias), 20)
        p = cuda_ms(lambda: ops.conv3x3_plain(x, w, bias), 20)
        log(f"  conv3x3 x{n} {xs}->{ws[0]} bf16: kernel {k:.4f} ms, plain {p:.4f} ms")
        k_ms, p_ms = k_ms + n * k, p_ms + n * p
    timing["conv3x3"] = (k_ms, p_ms, f"{len(conv_calls)} launches = one UNet forward, b{BATCH} bf16")
    k_ms = p_ms = 0.0
    for t, n in ((256, 5), (16, 1)):
        q, kk, v = (randn(BATCH, t, 256).to(torch.bfloat16) for _ in range(3))
        k = cuda_ms(lambda: ops.token_attention(q, kk, v, num_heads=1), 20)
        p = cuda_ms(lambda: ops.attention_plain(q, kk, v, num_heads=1), 20)
        log(f"  token_attention x{n} ({BATCH}, {t}, 256) bf16: kernel {k:.4f} ms, plain {p:.4f} ms")
        k_ms, p_ms = k_ms + n * k, p_ms + n * p
    timing["token_attention"] = (k_ms, p_ms, f"6 launches = one UNet forward, b{BATCH} bf16")
    xs = [randn(BATCH, 32, 32, 3) for _ in range(4)]
    k = cuda_ms(lambda: ops.fused_update(coef, 1, *xs), 200)
    p = cuda_ms(lambda: ops.fused_update_plain(coef, 1, *xs), 200)
    log(f"  fused_update ({BATCH}, 32, 32, 3) fp32: kernel {k:.4f} ms, plain {p:.4f} ms")
    timing["fused_update"] = (k, p, f"1 launch = one solver step, ({BATCH},32,32,3) fp32")
    for name, (k, p, what) in timing.items():
        log(f"kernel time on {smi}: {name} {k:.4f} ms vs plain {p:.4f} ms ({what})")

    kernels = [dict(name=name, route=route, source=src, replaces=rep,
                    launches=launches[name], max_abs_err=max_abs[name],
                    ms=timing[name][0], plain_ms=timing[name][1], timed=timing[name][2])
               for name, (route, src, rep) in REPLACES.items()]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
