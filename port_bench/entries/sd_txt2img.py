"""Entry driver: Stable Diffusion txt2img through the port's pipeline.

A request is one `StableDiffusionPipeline.txt2img` call of the traffic's
batch of prompts (the negative prompt empty, CFG as one doubled batch),
with its initial latents drawn by the pipeline from a generator on the
device seeded with (seed, request), its images copied to the host. The
networks are the port's (`load_sd_checkpoint` from a state dict of seeded
weights, `FrozenCLIPEmbedder` over a CLIP text tower of the configuration's
widths and the synthetic vocabulary). The variant "w8a8_conv" is the
program's own int8 serving path, the control of this entry's check.

The check, per sampled request: the token ids the program's tokenizer gave
against the reference tokenizer's (`ids_mismatch`, exact); the program's
final latents against the reference's own trajectory from the same
prompts and initial latents (`latent_off`: the worst image's share of
latent values more than 5% of the reference latent's RMS away); the
program's images against the reference decoder's images of the program's
latents (`pixels_off`: the worst image's share of pixel values more than
4/255 away).
"""

from __future__ import annotations

import dataclasses
import gc
from collections import Counter
from typing import Dict, List, Optional

import numpy as np
import torch

from port_bench.harness import inputs, work
from port_bench.harness.cell import HERE
from port_bench.harness.probes import (DTYPES, KERNELS, device_clock, host_clock, span,
                                         tf32_off)
from port_bench.harness.weights import seed_value, seeded_state_dict, shapes_of
from port_bench.reference import clip as ref_clip
from port_bench.reference import dpm_solver as ref_dpm
from port_bench.reference.layers import FP32
from port_bench.reference.sd_unet import SDUNet
from port_bench.reference.vae import AutoencoderKL as RefVAE, to_images

STREAMS = {"unet": 1, "vae": 2, "clip": 3}
# what counts as off in the check: a latent value further than 5% of the
# reference latent's RMS from it; a pixel value further than 4 levels of 255
LATENT_OFF, PIXEL_OFF = 0.05, 4 / 255


def _fields(cls, d: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items() if k in names}


def reference_nets(cfg: dict):
    return SDUNet(cfg["unet"]), RefVAE(cfg["first_stage"]), ref_clip.CLIPText(cfg["text_encoder"])


def seeded_weights(cfg: dict, seed: int, device) -> Dict[str, dict]:
    """{"unet", "vae", "clip"}: state dicts of the checkpoints' keys (the
    reference networks' names), drawn from the seed on `device`."""
    with torch.device("meta"):
        nets = dict(zip(("unet", "vae", "clip"), reference_nets(cfg)))
    return {k: seeded_state_dict(shapes_of(net), seed, device, STREAMS[k])
            for k, net in nets.items()}


class _Recorder:
    """Calls `fn` and, while `box.on`, keeps what `take` makes of its
    arguments and result."""

    def __init__(self, fn, box, take):
        self.fn, self.box, self.take = fn, box, take

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        if self.box.on:
            self.box.items.append(self.take(args, out))
        return out


class _Box:
    def __init__(self):
        self.on, self.items = False, []


class Entry:
    KERNELS = KERNELS

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device,
                 variant: Optional[str] = None):
        from dpm_solver_tpu_torch.models import (ADMConfig, CLIPTextModel, CLIPTokenizer,
                                                 CLIPTowerConfig, FrozenCLIPEmbedder, VAEConfig)
        from dpm_solver_tpu_torch.pipelines import StableDiffusionPipeline, load_sd_checkpoint

        self.cfg, self.traffic, self.seed, self.dev = config, traffic, seed, device
        self.batch = int(traffic["batch"])
        self.words = inputs.read_words(HERE / "traffic" / traffic["words"])
        self.vocab = inputs.vocab_dir(self.words)
        s = config["sampler"]
        self.steps, self.scale = int(s["steps"]), float(s["guidance_scale"])

        w = seeded_weights(config, seed, device)
        text = FrozenCLIPEmbedder.__new__(FrozenCLIPEmbedder)
        text.tokenizer = CLIPTokenizer(self.vocab)
        with torch.device(device):
            tower = CLIPTextModel(CLIPTowerConfig.from_dict(config["text_encoder"]))
        tower.load_state_dict(w.pop("clip"))
        text.model = tower.eval().requires_grad_(False).to(DTYPES[config["text_encoder_dtype"]])
        text.max_length = config["text_encoder"]["max_position_embeddings"]
        state = {**{"model.diffusion_model." + k: v for k, v in w.pop("unet").items()},
                 **{"first_stage_model." + k: v for k, v in w.pop("vae").items()}}
        del w
        self.ldm = load_sd_checkpoint(
            state, preset="sd_v1", unet_config=ADMConfig(**_fields(ADMConfig, config["unet"])),
            vae_config=VAEConfig(**_fields(VAEConfig, config["first_stage"])), text_encode=text,
            parameterization=config["parameterization"],
            conditioning_key=config["conditioning_key"], quant=variant,
            compute_dtype=DTYPES[config["dtype"]], device=device)
        del state
        self.pipe = StableDiffusionPipeline(self.ldm, device=device)
        self.text = text
        # what the check reads: the token ids the program's tokenizer gave
        # and the latents the program decoded, for the sampled requests only
        self._ids, self._latents = _Box(), _Box()
        text.tokenizer = _Recorder(text.tokenizer, self._ids, lambda a, out: out.clone())
        self.ldm.decode_first_stage = _Recorder(self.ldm.decode_first_stage, self._latents,
                                                lambda a, out: a[0].detach().float().cpu())
        self._spans: Optional[dict] = None
        self._least: Dict[str, float] = {}

    def reseed(self, seed: int) -> None:
        """The weights of another seed, loaded in place (captured graphs stay valid)."""
        self.seed = seed
        w = seeded_weights(self.cfg, seed, self.dev)
        self.text.model.load_state_dict(w.pop("clip"))
        self.ldm.unet.load_state_dict(w.pop("unet"))
        self.ldm.vae.load_state_dict(w.pop("vae"))

    # -- requests ------------------------------------------------------------

    def prompts(self, i: int) -> List[str]:
        return inputs.prompts(self.words, self.traffic["prompt_words"], self.batch, self.seed, i)

    def generator(self, i: int) -> torch.Generator:
        return torch.Generator(device=self.dev).manual_seed(seed_value(self.seed, i, 1))

    def request(self, i: int, keep: bool):
        self._ids.on = self._latents.on = keep
        self._ids.items, self._latents.items = [], []
        traced = self._spans is not None
        if traced:
            self._spans.clear()
        c = self.cfg
        with span("pipeline", traced):
            imgs = self.pipe.txt2img(
                self.prompts(i), negative_prompt="", steps=self.steps,
                guidance_scale=self.scale, height=c["height"], width=c["width"],
                generator=self.generator(i), order=c["sampler"]["order"],
                method=c["sampler"]["method"], jit=c["sampler"]["jit"])
        with span("to_host", traced):
            host = imgs.cpu()
        payload = (host, list(self._ids.items), self._latents.items[0]) if keep else None
        spans = ({k: sum(r() for r in v) for k, v in self._spans.items()} if traced else {})
        return self.batch, payload, spans

    def warm(self) -> None:
        """Two requests of the cell's shapes (the first captures the
        trajectory's graph), the kernels' launches by shape recorded over
        the first."""
        specs, forwards = Counter(), Counter()
        handles = _spec_hooks(self.ldm, specs, forwards)
        try:
            self.request(-1, False)
        finally:
            for h in handles:
                h.remove()
        self.request(-2, False)
        per = Counter()
        for (where, kernel, spec), n in specs.items():
            calls = self.steps if where == "unet" else 1
            per[kernel, spec] += n / forwards[where] * calls
        self._least = {}
        for (kernel, spec), n in per.items():
            self._least[kernel] = self._least.get(kernel, 0.0) + n * work.least_seconds(kernel,
                                                                                         spec)

    def least_seconds(self) -> Dict[str, float]:
        return self._least

    def flops_per_request(self) -> float:
        c, b = self.cfg, self.batch
        t = c["text_encoder"]["max_position_embeddings"]
        f = 2 ** (len(c["first_stage"]["ch_mult"]) - 1)
        h, w, z = c["height"] // f, c["width"] // f, c["first_stage"]["z_channels"]
        ctx = c["unet"]["context_dim"]
        text = work.model_flops(lambda: ref_clip.CLIPText(c["text_encoder"]),
                                lambda: (torch.zeros((b, t), dtype=torch.int64),))
        unet = work.model_flops(lambda: SDUNet(c["unet"]),
                                lambda: (torch.empty(2 * b, h, w, z), torch.empty(2 * b),
                                         torch.empty(2 * b, t, ctx)))
        decode = work.model_flops(lambda: _Decode(c["first_stage"]),
                                  lambda: (torch.empty(b, h, w, z),))
        return 2 * text + self.steps * unet + decode

    def spans_on(self) -> None:
        """Time the conditioner (host clock after synchronize), the
        trajectory and the decode (CUDA events) in every request."""
        self._spans = {}
        ldm, sampler = self.ldm, self.pipe.sampler

        def timed(name, fn, clock):
            def call(*a, **k):
                with span(name, True):
                    started = clock(self.dev)
                    out = fn(*a, **k)
                    self._spans.setdefault(name, []).append(started())
                return out
            return call

        ldm.get_learned_conditioning = timed("text_encode", ldm.get_learned_conditioning,
                                             host_clock)
        sampler.sample = timed("trajectory", sampler.sample, device_clock)
        ldm.decode_first_stage = timed("vae_decode", ldm.decode_first_stage, device_clock)

    def release(self) -> None:
        del self.pipe, self.ldm, self.text
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------------

    def check(self, kept: list) -> Dict[str, float]:
        return check(self.cfg, self.seed, self.dev, self.vocab, kept,
                     lambda i: (self.prompts(i), self.generator(i)))


class _Decode(torch.nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.vae = RefVAE(cfg)

    def forward(self, z):
        return self.vae.decode(z)


def _spec_hooks(ldm, specs: Counter, forwards: Counter) -> list:
    """Forward pre-hooks that count, by network, each kernel launch by shape
    (read from the modules' inputs: chip_smoke.py's `spec_hooks`) and each
    network call. Hooks fire on eager and capture calls, not on replays."""
    from dpm_solver_tpu_torch import ops
    from dpm_solver_tpu_torch.models.transformer import CrossAttention
    from dpm_solver_tpu_torch.models.vae import VAEAttnBlock

    def pre(where):
        def hook(mod, args, kwargs):
            x = args[0]
            if isinstance(mod, ops.Conv3x3):
                specs[where, "conv3x3", (*x.shape, mod.weight.shape[0])] += 1
            elif isinstance(mod, CrossAttention):
                b, t, _ = x.shape
                ctx = kwargs.get("context")
                s = t if ctx is None else ctx.shape[1]
                specs[where, "token_attention", (b, t, s, mod.heads, mod.dim_head,
                                                 ctx is None)] += 1
            elif isinstance(mod, VAEAttnBlock):
                b, h, w, c = x.shape
                specs[where, "token_attention", (b, h * w, h * w, 1, c, True)] += 1
        return hook

    handles = []
    for where, net in (("unet", ldm.unet), ("vae", ldm.vae.decoder)):
        handles.append(net.register_forward_pre_hook(
            lambda m, a, where=where: forwards.update([where])))
        handles += [m.register_forward_pre_hook(pre(where), with_kwargs=True)
                    for m in net.modules()
                    if isinstance(m, (ops.Conv3x3, CrossAttention, VAEAttnBlock))]
    return handles


# --------------------------------------------------------------------------- #
# the plain reference, after the window
# --------------------------------------------------------------------------- #


def betas(cfg: dict) -> np.ndarray:
    return np.linspace(cfg["linear_start"] ** 0.5, cfg["linear_end"] ** 0.5, cfg["timesteps"],
                       dtype=np.float64) ** 2


@torch.no_grad()
def check(cfg: dict, seed: int, dev, vocab, kept: list, request_inputs) -> Dict[str, float]:
    """The numbers compared for the kept requests [(i, (images, [ids of the
    prompts, ids of the negative prompts], latents))]: float32 reference
    networks with TF32 off, float64 solver coefficients."""
    with tf32_off():
        with torch.device("meta"):
            unet, vae, text = reference_nets(cfg)
        w = seeded_weights(cfg, seed, dev)
        for net, key in ((unet, "unet"), (vae, "vae"), (text, "clip")):
            net.load_state_dict(w.pop(key), assign=True)
        tok = ref_clip.Tokenizer(vocab)
        ns = ref_dpm.DiscreteVP(alphas_cumprod=np.cumprod(1.0 - betas(cfg)))
        s = cfg["sampler"]
        out = {"ids_mismatch": 0.0, "latent_off": 0.0, "pixels_off": 0.0}
        for i, (images, ids, latents) in kept:
            prompts, gen = request_inputs(i)
            b = len(prompts)
            ids_r, ids_u = tok(prompts), tok([""] * b)
            out["ids_mismatch"] += float((ids[0] != ids_r).sum() + (ids[1] != ids_u).sum())
            ctx = torch.cat([text(ids_u.to(dev), FP32), text(ids_r.to(dev), FP32)])
            f = 2 ** (len(cfg["first_stage"]["ch_mult"]) - 1)
            shape = (b, cfg["height"] // f, cfg["width"] // f, cfg["first_stage"]["z_channels"])
            x_T = torch.randn(shape, generator=gen, device=gen.device).to(dev)

            def eps(x, t):
                e_u, e_c = unet(torch.cat([x, x]), torch.cat([t, t]), ctx).chunk(2)
                return e_u + s["guidance_scale"] * (e_c - e_u)

            z = ref_dpm.sample(eps, ns, x_T, steps=s["steps"], order=s["order"],
                               skip_type=s["skip_type"],
                               lower_order_final=s["lower_order_final"]).float().flatten(1)
            zp = latents.to(dev)
            rms = z.pow(2).mean(1, keepdim=True).sqrt()
            off = ((zp.flatten(1) - z).abs() > LATENT_OFF * rms).float().mean(1)
            out["latent_off"] = max(out["latent_off"], float(off.max()))
            img_r = to_images(vae.decode(zp / cfg["scale_factor"]))
            off = ((images.to(dev) - img_r).abs() > PIXEL_OFF).flatten(1).float().mean(1)
            out["pixels_off"] = max(out["pixels_off"], float(off.max()))
        return out
