"""Entry driver: pixel-space DPM-Solver++ sampling of the DDPM UNet.

A request is one `DPM_Solver.sample` call (graphed: `jit=True`) over
`model_wrapper(net, NoiseScheduleVP('discrete', betas), model_type="noise")`
at the traffic's batch, from x_T drawn on the device from (seed, request),
its samples copied to the host. The network is the port's `DDPMUNet` of the
configuration's widths, its state dict the seeded weights. The variant
"fp8" puts the plain reference in the program's place, its products'
operands rounded to float8: the control of this entry's check.

The check, per sampled request: `traffic["check"]["rows"]` rows drawn from
the seed, the program's samples against the float32 reference's
trajectory from the same x_T (`sample_rel`: the worst row's relative L2 gap).
"""

from __future__ import annotations

import gc
import random
from collections import Counter
from typing import Dict, Optional

import numpy as np
import torch

from port_bench.harness import work
from port_bench.harness.probes import DTYPES, KERNELS, device_clock, span, tf32_off
from port_bench.harness.weights import seed_value, seeded_state_dict, shapes_of
from port_bench.reference import dpm_solver as ref_dpm
from port_bench.reference.ddpm_unet import DDPMUNet as RefUNet
from port_bench.reference.layers import FP32, Precision



def seeded_weights(cfg: dict, seed: int, device) -> dict:
    with torch.device("meta"):
        net = RefUNet(cfg["model"])
    return seeded_state_dict(shapes_of(net), seed, device, stream=1)


def betas(cfg: dict) -> np.ndarray:
    d = cfg["diffusion"]
    if d["beta_schedule"] != "linear":
        raise ValueError("the entry takes the linear beta schedule")
    return np.linspace(d["beta_start"], d["beta_end"], d["num_diffusion_timesteps"],
                       dtype=np.float64)


def x_shape(cfg: dict, batch: int) -> tuple:
    d = cfg["data"]
    return batch, d["image_size"], d["image_size"], d["channels"]


class Entry:
    KERNELS = KERNELS

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device,
                 variant: Optional[str] = None):
        self.cfg, self.traffic, self.seed, self.dev = config, traffic, seed, device
        self.batch = int(traffic["batch"])
        s = self.solver_options = dict(config["sampler"])
        self.variant = variant
        w = seeded_weights(config, seed, device)
        if variant == "fp8":
            with torch.device("meta"):
                self.net = RefUNet(config["model"])
            self.net.load_state_dict(w, assign=True)
            self.ns = ref_dpm.DiscreteVP(betas=betas(config))
            self.sample = self._reference_sample
        elif variant is None:
            from dpm_solver_tpu_torch import DPM_Solver, NoiseScheduleVP, model_wrapper
            from dpm_solver_tpu_torch.models import DDPMUNet, DDPMUNetConfig

            m = config["model"]
            fields = {k: tuple(v) if isinstance(v, list) else v for k, v in m.items()
                      if k in DDPMUNetConfig.__dataclass_fields__}
            self.net = DDPMUNet(DDPMUNetConfig(**fields), DTYPES[config["dtype"]], device=device)
            self.net.load_state_dict(w)
            self.net.eval()
            ns = NoiseScheduleVP("discrete", betas=betas(config))
            solver = DPM_Solver(model_wrapper(self.net, ns, model_type=s["model_type"]), ns,
                                algorithm_type=s["algorithm_type"])
            self.sample = lambda x: solver.sample(
                x, steps=s["steps"], order=s["order"], skip_type=s["skip_type"],
                method=s["method"], lower_order_final=s["lower_order_final"], jit=s["jit"])
        else:
            raise ValueError(f"unknown variant {variant!r}")
        del w
        self._spans: Optional[dict] = None
        self._least: Dict[str, float] = {}

    def reseed(self, seed: int) -> None:
        """The weights of another seed, loaded in place (captured graphs stay valid)."""
        self.seed = seed
        self.net.load_state_dict(seeded_weights(self.cfg, seed, self.dev))

    @torch.no_grad()
    def _reference_sample(self, x: torch.Tensor) -> torch.Tensor:
        prec = Precision("fp8")
        s = self.solver_options
        with tf32_off():
            return ref_dpm.sample(lambda xx, t: self.net(xx, t, prec), self.ns, x,
                                  steps=s["steps"], order=s["order"], skip_type=s["skip_type"],
                                  lower_order_final=s["lower_order_final"]).float()

    def x_T(self, i: int) -> torch.Tensor:
        g = torch.Generator(device=self.dev).manual_seed(seed_value(self.seed, i, 1))
        return torch.randn(x_shape(self.cfg, self.batch), generator=g, device=self.dev)

    def request(self, i: int, keep: bool):
        traced = self._spans is not None
        with span("request", traced):
            x = self.x_T(i)
            stop = device_clock(self.dev) if traced else None
            with span("trajectory", traced), torch.no_grad():
                out = self.sample(x)
            read = stop() if traced else None
            with span("to_host", traced):
                host = out.cpu()
        spans = {"trajectory": read()} if traced else {}
        return self.batch, (host if keep else None), spans

    def warm(self) -> None:
        """Two requests of the cell's batch (the first captures the
        trajectory's graph), the kernels' launches by shape recorded over
        the first."""
        specs, forwards = Counter(), Counter()
        handles = _spec_hooks(self.net, specs, forwards) if self.variant is None else []
        try:
            self.request(-1, False)
        finally:
            for h in handles:
                h.remove()
        self.request(-2, False)
        nfe = self.solver_options["steps"]
        self._least = {}
        for (kernel, spec), n in specs.items():
            launches = n / max(forwards["net"], 1) * nfe
            self._least[kernel] = (self._least.get(kernel, 0.0)
                                   + launches * work.least_seconds(kernel, spec))

    def least_seconds(self) -> Dict[str, float]:
        return self._least

    def flops_per_request(self) -> float:
        shape = x_shape(self.cfg, self.batch)
        return self.solver_options["steps"] * work.model_flops(
            lambda: RefUNet(self.cfg["model"]),
            lambda: (torch.empty(shape), torch.empty(shape[0])))

    def spans_on(self) -> None:
        self._spans = {}

    def release(self) -> None:
        del self.net, self.sample
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def check(self, kept: list) -> Dict[str, float]:
        """`sample_rel` over the kept requests' sampled rows: float32
        reference network, TF32 off, float64 solver coefficients."""
        rows = int(self.traffic["check"]["rows"])
        with torch.device("meta"):
            net = RefUNet(self.cfg["model"])
        net.load_state_dict(seeded_weights(self.cfg, self.seed, self.dev), assign=True)
        ns = ref_dpm.DiscreteVP(betas=betas(self.cfg))
        s = self.solver_options
        worst = 0.0
        with tf32_off():
            for i, host in kept:
                idx = sorted(random.Random(seed_value(self.seed, i, 3)).sample(
                    range(self.batch), min(rows, self.batch)))
                x = self.x_T(i)[idx]
                for k in range(0, len(idx), 125):
                    ref = ref_dpm.sample(lambda xx, t: net(xx, t, FP32), ns, x[k:k + 125],
                                         steps=s["steps"], order=s["order"],
                                         skip_type=s["skip_type"],
                                         lower_order_final=s["lower_order_final"]).float()
                    got = host[idx[k:k + 125]].to(self.dev)
                    rel = (got - ref).flatten(1).norm(dim=1) / ref.flatten(1).norm(dim=1)
                    worst = max(worst, float(rel.max()))
        return {"sample_rel": worst}


def _spec_hooks(net, specs: Counter, forwards: Counter) -> list:
    """Forward pre-hooks counting each kernel launch by shape (conv3x3 (b, h,
    w, c, co); token_attention (b, t, s, heads, dh, fused)) and each network
    call. Hooks fire on eager and capture calls, not on replays."""
    from dpm_solver_tpu_torch import ops
    from dpm_solver_tpu_torch.models.ddpm_unet import AttnBlock

    def hook(mod, args):
        x = args[0]
        if isinstance(mod, ops.Conv3x3):
            specs["conv3x3", (*x.shape, mod.weight.shape[0])] += 1
        else:
            b, h, w, c = x.shape
            specs["token_attention", (b, h * w, h * w, 1, c, False)] += 1

    handles = [net.register_forward_pre_hook(lambda m, a: forwards.update(["net"]))]
    handles += [m.register_forward_pre_hook(hook) for m in net.modules()
                if isinstance(m, (ops.Conv3x3, AttnBlock))]
    return handles
