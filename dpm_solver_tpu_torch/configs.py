"""Config system: a typed dataclass tree + named registry (the port's copy
of `dpm_solver_tpu/configs.py`, with the same names, fields and entries,
building the port's model configs).

Replaces the reference's three config idioms (SURVEY.md §5: argparse+YAML in
ddpm_and_guided-diffusion/main.py:19-240, ml_collections in
score_sde_jax/configs/**, OmegaConf in stable-diffusion) with one:
frozen dataclasses (hashable, jit-static-friendly, typo-proof) and a
`get_config(name)` registry carrying the canonical benchmark entries from
the reference sample.sh files.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """DPM-Solver knobs (ref main.py flags + score_sde config.sampling)."""

    algorithm_type: str = "dpmsolver++"
    method: str = "multistep"
    order: int = 3
    steps: int = 10
    skip_type: str = "logSNR"
    lower_order_final: bool = True
    denoise_to_zero: bool = False
    thresholding: bool = False
    t_start: Optional[float] = None
    t_end: Optional[float] = None
    atol: float = 0.0078
    rtol: float = 0.05
    guidance_scale: float = 1.0
    classifier_scale: float = 0.0
    # PC-sampler knobs for VE-SDE configs (ref config.sampling.{predictor,
    # corrector,snr,n_steps_each}); DPM-Solver is VP-form only
    predictor: str = "reverse_diffusion"
    corrector: str = "none"
    snr: float = 0.16
    n_steps_each: int = 1


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """Discrete forward-process table (ref runners/diffusion.py:81-117 and
    the configs' `diffusion:` block). `betas()` reproduces the reference's
    `get_beta_schedule` exactly, including the iDDPM cosine alpha-bar
    discretization with max_beta=0.999 (:62-79)."""

    beta_schedule: str = "linear"
    beta_start: Optional[float] = 1e-4
    beta_end: Optional[float] = 0.02
    num_diffusion_timesteps: int = 1000

    def betas(self):
        import numpy as np

        n = self.num_diffusion_timesteps
        kind = self.beta_schedule
        if kind == "linear":
            return np.linspace(self.beta_start, self.beta_end, n,
                               dtype=np.float64)
        if kind == "quad":
            return np.linspace(self.beta_start ** 0.5, self.beta_end ** 0.5,
                               n, dtype=np.float64) ** 2
        if kind == "cosine":
            def alpha_bar(t):
                return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2

            i = np.arange(n, dtype=np.float64)
            return np.minimum(1.0 - alpha_bar((i + 1) / n) / alpha_bar(i / n),
                              0.999)
        if kind == "const":
            return self.beta_end * np.ones(n, dtype=np.float64)
        if kind == "jsd":
            return 1.0 / np.linspace(n, 1, n, dtype=np.float64)
        if kind == "sigmoid":
            x = np.linspace(-6, 6, n)
            return (1 / (np.exp(-x) + 1)) * (self.beta_end - self.beta_start) \
                + self.beta_start
        raise NotImplementedError(kind)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "cifar10"
    image_size: int = 32
    channels: int = 3
    centered: bool = True
    uniform_dequantization: bool = False
    gaussian_dequantization: bool = False
    logit_transform: bool = False  # ref datasets/__init__.py:197-198,210
    random_flip: bool = True
    path: Optional[str] = None  # local data root (zero-egress image)


@dataclasses.dataclass(frozen=True)
class TrainingConfig:
    batch_size: int = 128
    n_iters: int = 950_001
    lr: float = 2e-4
    warmup: int = 5000
    grad_clip: float = 1.0
    ema_rate: float = 0.9999
    n_jitted_steps: int = 1
    snapshot_freq: int = 50_000
    snapshot_freq_for_preemption: int = 10_000
    log_freq: int = 50
    eval_freq: int = 100
    sde: str = "vpsde"  # vpsde | subvpsde | vesde
    continuous: bool = True
    reduce_mean: bool = True
    likelihood_weighting: bool = False
    # SDE parameters (ref default_*_configs.py model.{beta_min,beta_max,
    # sigma_min,sigma_max,num_scales})
    beta_min: float = 0.1
    beta_max: float = 20.0
    sigma_min: float = 0.01
    sigma_max: float = 50.0
    num_scales: int = 1000


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    batch_size: int = 1000
    num_samples: int = 50_000
    begin_ckpt: int = 1
    end_ckpt: int = 26
    enable_sampling: bool = True
    enable_bpd: bool = False
    enable_loss: bool = True
    fid_stats_path: Optional[str] = None
    inception_ckpt_path: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Config:
    name: str
    model_family: str  # ddpm_unet | ncsnpp | adm | sd
    model_config: object
    classifier_config: object = None
    diffusion: DiffusionConfig = DiffusionConfig()
    data: DataConfig = DataConfig()
    sampling: SamplingConfig = SamplingConfig()
    training: TrainingConfig = TrainingConfig()
    eval: EvalConfig = EvalConfig()
    ckpt_path: Optional[str] = None
    classifier_ckpt_path: Optional[str] = None
    workdir: str = "./workdir"
    seed: int = 42


_REGISTRY: Dict[str, Callable[[], Config]] = {}


def register_config(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str, **overrides) -> Config:
    if name not in _REGISTRY:
        raise KeyError(f"unknown config {name!r}; have {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def list_configs():
    return sorted(_REGISTRY)


# --------------------------------------------------------------------------- #
# canonical benchmark entries (ref sample.sh files; SURVEY.md §6)
# --------------------------------------------------------------------------- #


@register_config("cifar10_ddpm")
def _cifar10_ddpm() -> Config:
    """CIFAR-10 DDPM ckpt: dpmsolver++ multistep order-3, 10 NFE, logSNR
    (ddpm_and_guided-diffusion/sample.sh:6-17)."""
    from dpm_solver_tpu_torch.models import DDPMUNetConfig

    return Config(
        name="cifar10_ddpm", model_family="ddpm_unet",
        model_config=DDPMUNetConfig.cifar10(),
        data=DataConfig(dataset="cifar10", image_size=32, centered=True),
        sampling=SamplingConfig(order=3, steps=10, skip_type="logSNR",
                                method="multistep"),
        eval=EvalConfig(batch_size=1000, num_samples=50_000),
    )


@register_config("imagenet64_iddpm")
def _imagenet64() -> Config:
    """ImageNet64 i-DDPM (cosine, learned sigma): same solver settings
    (sample.sh:19-30; configs/imagenet64.yml)."""
    from dpm_solver_tpu_torch.models import ADMConfig

    return Config(
        name="imagenet64_iddpm", model_family="adm",
        model_config=ADMConfig.imagenet64_iddpm(),
        diffusion=DiffusionConfig(beta_schedule="cosine", beta_start=None,
                                  beta_end=None,
                                  num_diffusion_timesteps=4000),
        data=DataConfig(dataset="imagenet64", image_size=64),
        sampling=SamplingConfig(order=3, steps=10, skip_type="logSNR",
                                method="multistep"),
    )


@register_config("imagenet256_guided")
def _imagenet256() -> Config:
    """ImageNet256 ADM classifier-guided, scale 8: dpmsolver++ multistep
    order-2, 20 NFE, time_uniform + dynamic thresholding
    (sample.sh:32-50; configs/imagenet256_guided.yml)."""
    from dpm_solver_tpu_torch.models import ADMConfig

    classifier = dataclasses.replace(
        ADMConfig.imagenet256_guided(), model_channels=128,
        num_res_blocks=2, out_channels=1000, pool="attention",
        num_classes=None, resblock_updown=True, use_scale_shift_norm=True)
    return Config(
        name="imagenet256_guided", model_family="adm",
        model_config=ADMConfig.imagenet256_guided(),
        classifier_config=classifier,
        data=DataConfig(dataset="imagenet", image_size=256),
        sampling=SamplingConfig(order=2, steps=20, skip_type="time_uniform",
                                method="multistep", thresholding=True,
                                classifier_scale=8.0),
        eval=EvalConfig(batch_size=50, num_samples=10_000),
    )


@register_config("celeba64_ddpm")
def _celeba64() -> Config:
    """CelebA 64x64 DDPM ckpt (configs/celeba.yml): same solver settings as
    the CIFAR-10 entry."""
    from dpm_solver_tpu_torch.models import DDPMUNetConfig

    return Config(
        name="celeba64_ddpm", model_family="ddpm_unet",
        model_config=DDPMUNetConfig.celeba(),
        data=DataConfig(dataset="celeba", image_size=64, centered=True),
        sampling=SamplingConfig(order=3, steps=10, skip_type="logSNR",
                                method="multistep"),
        eval=EvalConfig(batch_size=500, num_samples=50_000),
    )


@register_config("imagenet128_guided")
def _imagenet128() -> Config:
    """ImageNet128 ADM classifier-guided, scale 1.25
    (configs/imagenet128_guided.yml)."""
    from dpm_solver_tpu_torch.models import ADMConfig

    classifier = dataclasses.replace(
        ADMConfig.imagenet128_guided(), model_channels=128,
        out_channels=1000, pool="attention", num_classes=None,
        num_head_channels=64)
    return Config(
        name="imagenet128_guided", model_family="adm",
        model_config=ADMConfig.imagenet128_guided(),
        classifier_config=classifier,
        data=DataConfig(dataset="imagenet", image_size=128),
        sampling=SamplingConfig(order=2, steps=20, skip_type="time_uniform",
                                method="multistep", classifier_scale=1.25),
        eval=EvalConfig(batch_size=200, num_samples=50_000),
    )


@register_config("imagenet512_guided")
def _imagenet512() -> Config:
    """ImageNet512 ADM classifier-guided, scale 4.0
    (configs/imagenet512_guided.yml; fractional first channel mult)."""
    from dpm_solver_tpu_torch.models import ADMConfig

    classifier = dataclasses.replace(
        ADMConfig.imagenet512_guided(), model_channels=128,
        out_channels=1000, pool="attention", num_classes=None)
    return Config(
        name="imagenet512_guided", model_family="adm",
        model_config=ADMConfig.imagenet512_guided(),
        classifier_config=classifier,
        data=DataConfig(dataset="imagenet", image_size=512),
        sampling=SamplingConfig(order=2, steps=20, skip_type="time_uniform",
                                method="multistep", thresholding=True,
                                classifier_scale=4.0),
        eval=EvalConfig(batch_size=20, num_samples=10_000),
    )


@register_config("lsun_bedroom")
def _lsun_bedroom() -> Config:
    """LSUN bedroom 256 unconditional ADM (configs/bedroom_guided.yml,
    cond_class: false / classifier_scale 0)."""
    from dpm_solver_tpu_torch.models import ADMConfig

    return Config(
        name="lsun_bedroom", model_family="adm",
        model_config=ADMConfig.lsun_bedroom_guided(),
        data=DataConfig(dataset="lsun_bedroom", image_size=256),
        sampling=SamplingConfig(order=2, steps=20, skip_type="time_uniform",
                                method="multistep"),
        eval=EvalConfig(batch_size=50, num_samples=50_000),
    )


@register_config("score_sde_cifar10_vp_deep")
def _score_sde_vp() -> Config:
    """score_sde ddpmpp_deep cont. VP ckpt_8: singlestep order-3, 10 NFE,
    logSNR, eps 1e-3, batch 1000 (score_sde_jax/sample.sh:1-10)."""
    from dpm_solver_tpu_torch.models import NCSNppConfig

    return Config(
        name="score_sde_cifar10_vp_deep", model_family="ncsnpp",
        model_config=NCSNppConfig.cifar10_ddpmpp(deep=True),
        data=DataConfig(dataset="cifar10", image_size=32, centered=True),
        sampling=SamplingConfig(order=3, steps=10, skip_type="logSNR",
                                method="singlestep", t_end=1e-3),
        training=TrainingConfig(sde="vpsde", continuous=True),
        eval=EvalConfig(batch_size=1000, num_samples=50_000),
    )


# --------------------------------------------------------------------------- #
# score_sde experiment matrix (ref score_sde_jax/configs/{vp,subvp,ve}/**)
# --------------------------------------------------------------------------- #

def _score_sde_config(name, *, sde, model_preset, continuous, dataset,
                      image_size, centered, batch_size=128, eval_batch=1000,
                      sigma_max=50.0, num_scales=1000, n_jitted_steps=5,
                      family="ncsnpp", predictor="reverse_diffusion",
                      corrector="none", snr=0.16, n_steps_each=1,
                      reduce_mean=False, ema_rate=0.9999):
    def make() -> Config:
        from dpm_solver_tpu_torch.models import DDPMUNetConfig, NCSNppConfig, NCSNv2Config

        presets = {
            "ddpmpp": lambda: NCSNppConfig.cifar10_ddpmpp(),
            "ddpmpp_deep": lambda: NCSNppConfig.cifar10_ddpmpp(deep=True),
            "ncsnpp_vp": lambda: NCSNppConfig.cifar10_ncsnpp_vp(),
            "ncsnpp_vp_deep": lambda: NCSNppConfig.cifar10_ncsnpp_vp(True),
            "ncsnpp_ve": lambda: NCSNppConfig.cifar10_ncsnpp(),
            "ncsnpp_ve_deep": lambda: NCSNppConfig.cifar10_ncsnpp(deep=True),
            # discrete VE twin: positional embedding over the sigma ladder
            # (ve/cifar10_ncsnpp.py: embedding_type='positional')
            "ncsnpp_ve_discrete": lambda: dataclasses.replace(
                NCSNppConfig.celeba64(), image_size=32, sigma_max=50.0),
            "ncsnpp_celeba64": NCSNppConfig.celeba64,
            "ncsnpp_px256": NCSNppConfig.px256,
            "ncsnpp_px1024": NCSNppConfig.px1024,
            "ddpm": DDPMUNetConfig.cifar10,
            "ddpm_lsun256": DDPMUNetConfig.lsun256,
            "ncsn_v1": lambda: dataclasses.replace(
                NCSNv2Config.cifar10(), conditional_norm=True,
                scale_by_sigma=False, num_scales=10, sigma_max=1.0),
            # NCSN v1 net under the improved-technique sigma ladders
            # (ve/ncsn/{cifar10,celeba}_{124,1245}.py: num_scales
            # 232/500, sigma_max back to the dataset default)
            "ncsn_v1_t124": lambda: dataclasses.replace(
                NCSNv2Config.cifar10(), conditional_norm=True,
                scale_by_sigma=False, num_scales=232, sigma_max=50.0),
            "ncsn_v1_celeba": lambda: dataclasses.replace(
                NCSNv2Config.cifar10(), conditional_norm=True,
                scale_by_sigma=False, image_size=64, num_scales=10,
                sigma_max=1.0),
            "ncsn_v1_celeba_t124": lambda: dataclasses.replace(
                NCSNv2Config.cifar10(), conditional_norm=True,
                scale_by_sigma=False, image_size=64, num_scales=500,
                sigma_max=90.0),
            # time-unconditional DDPM (vp/ddpm/cifar10_unconditional.py
            # model.conditional=False — NCSNv2 technique 3)
            "ddpm_unconditional": lambda: dataclasses.replace(
                DDPMUNetConfig.cifar10(), conditional=False),
            "ncsnv2_cifar10": NCSNv2Config.cifar10,
            "ncsnv2_celeba": lambda: dataclasses.replace(
                NCSNv2Config.cifar10(), image_size=64, num_scales=500,
                sigma_max=90.0),
            "ncsnv2_bedroom": lambda: dataclasses.replace(
                NCSNv2Config.px128(), num_scales=1086, sigma_max=190.0),
        }
        mc = presets[model_preset]()
        if family == "ncsnpp" and mc.image_size != image_size:
            mc = dataclasses.replace(mc, image_size=image_size)
        return Config(
            name=name, model_family=family, model_config=mc,
            data=DataConfig(dataset=dataset, image_size=image_size,
                            centered=centered,
                            uniform_dequantization=False),
            sampling=SamplingConfig(order=3, steps=10, skip_type="logSNR",
                                    method="singlestep", t_end=1e-3,
                                    predictor=predictor, corrector=corrector,
                                    snr=snr, n_steps_each=n_steps_each),
            training=TrainingConfig(
                batch_size=batch_size, sde=sde + "sde",
                continuous=continuous, reduce_mean=reduce_mean,
                n_jitted_steps=n_jitted_steps, sigma_max=sigma_max,
                num_scales=num_scales, ema_rate=ema_rate),
            eval=EvalConfig(batch_size=eval_batch, num_samples=50_000),
        )

    _REGISTRY[name] = make
    return make


def _register_score_sde_matrix():
    """The reference's per-experiment config tree, one registry entry per
    file (score_sde_jax/configs/{vp,subvp,ve}/*.py + vp/ddpm/* +
    ve/{ncsn,ncsnv2}/*) — all 39 files, including the NCSN
    improved-technique ablations and vp/ddpm/cifar10_unconditional;
    test_score_sde_configs.py asserts the count against the reference
    file list."""
    # vp/subvp files all set training.reduce_mean=True and sample with
    # pc/euler_maruyama (e.g. vp/cifar10_ddpmpp_continuous.py)
    C = dict(dataset="cifar10", image_size=32, centered=True,
             reduce_mean=True, predictor="euler_maruyama")
    CU = dict(dataset="cifar10", image_size=32, centered=False)
    # CIFAR-10: vp / subvp (ref configs/{vp,subvp}/cifar10_*.py)
    for sde in ("vp", "subvp"):
        for preset, deep in (("ddpmpp", False), ("ddpmpp_deep", True),
                             ("ncsnpp_vp", False), ("ncsnpp_vp_deep", True)):
            arch = "ddpmpp" if preset.startswith("ddpmpp") else "ncsnpp"
            d = "_deep" if deep else ""
            if sde == "vp":  # vp has discrete twins; subvp is continuous-only
                if not deep:
                    _score_sde_config(
                        f"score_sde_cifar10_vp_{arch}", sde="vp",
                        model_preset=preset, continuous=False, **C)
                _score_sde_config(
                    f"score_sde_cifar10_vp_{arch}{d}_continuous", sde="vp",
                    model_preset=preset, continuous=True, **C)
            else:
                _score_sde_config(
                    f"score_sde_cifar10_subvp_{arch}{d}_continuous",
                    sde="subvp", model_preset=preset, continuous=True, **C)
    _score_sde_config("score_sde_cifar10_subvp_ddpm_continuous", sde="subvp",
                      model_preset="ddpm", continuous=True,
                      family="ddpm_unet", **C)
    _score_sde_config("score_sde_cifar10_vp_ddpm", sde="vp",
                      model_preset="ddpm", continuous=False,
                      family="ddpm_unet", **C)
    _score_sde_config("score_sde_cifar10_vp_ddpm_continuous", sde="vp",
                      model_preset="ddpm", continuous=True,
                      family="ddpm_unet", **C)
    # CIFAR-10: ve (ref configs/ve/cifar10_*.py)
    VE = dict(corrector="langevin", snr=0.16, ema_rate=0.999)
    _score_sde_config("score_sde_cifar10_ve_ddpm", sde="ve",
                      model_preset="ddpm", continuous=False,
                      family="ddpm_unet", **VE, **CU)
    _score_sde_config("score_sde_cifar10_ve_ncsnpp", sde="ve",
                      model_preset="ncsnpp_ve_discrete", continuous=False,
                      **VE, **CU)
    _score_sde_config("score_sde_cifar10_ve_ncsnpp_continuous", sde="ve",
                      model_preset="ncsnpp_ve", continuous=True, **VE, **CU)
    _score_sde_config("score_sde_cifar10_ve_ncsnpp_deep_continuous",
                      sde="ve", model_preset="ncsnpp_ve_deep",
                      continuous=True, **VE, **CU)
    # high-res VE NCSN++ (ref configs/ve/{celeba,celebahq,ffhq,church,
    # bedroom}*.py; sigma_max per file / default_{celeba,lsun}_configs.py)
    _score_sde_config("score_sde_celeba64_ve_ncsnpp", sde="ve",
                      model_preset="ncsnpp_celeba64", continuous=False,
                      dataset="celeba", image_size=64, centered=False,
                      sigma_max=90.0, eval_batch=500,
                      corrector="langevin", snr=0.17, ema_rate=0.999)
    for nm, ds, smax in (("celebahq256", "celebahq", 348.0),
                         ("ffhq256", "ffhq", 348.0),
                         ("church", "lsun_church", 380.0),
                         ("bedroom", "lsun_bedroom", 378.0)):
        _score_sde_config(f"score_sde_{nm}_ve_ncsnpp_continuous", sde="ve",
                          model_preset="ncsnpp_px256", continuous=True,
                          dataset=ds, image_size=256, centered=False,
                          batch_size=64, eval_batch=64, sigma_max=smax,
                          num_scales=2000, corrector="langevin", snr=0.075,
                          ema_rate=0.999)
    for nm, ds in (("celebahq1024", "celebahq"), ("ffhq1024", "ffhq")):
        _score_sde_config(f"score_sde_{nm}_ve_ncsnpp_continuous", sde="ve",
                          model_preset="ncsnpp_px1024", continuous=True,
                          dataset=ds, image_size=1024, centered=False,
                          batch_size=8, eval_batch=8, sigma_max=1348.0,
                          num_scales=2000, corrector="langevin", snr=0.15,
                          reduce_mean=(nm == "ffhq1024"))
    # LSUN/CelebAHQ 256px discrete DDPM (ref configs/vp/ddpm/{church,
    # bedroom,celebahq}.py); the unconditional cifar10 variant is
    # registered further down
    for nm, ds in (("church", "lsun_church"), ("bedroom", "lsun_bedroom"),
                   ("celebahq", "celebahq")):
        _score_sde_config(f"score_sde_{nm}_vp_ddpm", sde="vp",
                          model_preset="ddpm_lsun256", continuous=False,
                          family="ddpm_unet", dataset=ds, image_size=256,
                          centered=True, batch_size=64, eval_batch=64,
                          reduce_mean=True, predictor="euler_maruyama")
    # discrete time-unconditional DDPM (ref vp/ddpm/cifar10_unconditional.py:
    # model.conditional=False, ancestral PC sampling, reduce_mean=True)
    _score_sde_config("score_sde_cifar10_vp_ddpm_unconditional", sde="vp",
                      model_preset="ddpm_unconditional", continuous=False,
                      family="ddpm_unet", dataset="cifar10", image_size=32,
                      centered=True, reduce_mean=True,
                      predictor="ancestral_sampling")
    # NCSN v1 (ref configs/ve/ncsn/{cifar10,celeba}.py: conditional
    # InstanceNorm++, 10-sigma ladder to 1.0, ALD 100 steps snr .316, no EMA)
    _score_sde_config("score_sde_cifar10_ve_ncsn", sde="ve",
                      model_preset="ncsn_v1", continuous=False,
                      family="ncsnv2", num_scales=10, sigma_max=1.0,
                      predictor="none", corrector="ald", snr=0.316,
                      n_steps_each=100, ema_rate=0.0, **CU)
    _score_sde_config("score_sde_celeba64_ve_ncsn", sde="ve",
                      model_preset="ncsn_v1_celeba", continuous=False,
                      family="ncsnv2", dataset="celeba", image_size=64,
                      centered=False, num_scales=10, sigma_max=1.0,
                      predictor="none", corrector="ald", snr=0.316,
                      n_steps_each=100, ema_rate=0.0)
    # NCSN improved-technique ablations (ref ve/ncsn/*_{124,1245,5}.py):
    # _124 = techniques 1+2+4 (dataset-default sigma_max, geometric ladder
    # 232/500, ALD 5 steps at tuned snr), no EMA; _1245 adds EMA .999;
    # _5 = EMA alone on the original NCSNv1 recipe.
    for ds, preset, scales, s in (("cifar10", "ncsn_v1_t124", 232, 0.176),
                                  ("celeba", "ncsn_v1_celeba_t124", 500,
                                   0.128)):
        size = 32 if ds == "cifar10" else 64
        smax = 50.0 if ds == "cifar10" else 90.0
        base = dict(sde="ve", model_preset=preset, continuous=False,
                    family="ncsnv2", dataset=ds, image_size=size,
                    centered=False, num_scales=scales, sigma_max=smax,
                    predictor="none", corrector="ald", snr=s,
                    n_steps_each=5)
        nm = "cifar10" if ds == "cifar10" else "celeba64"
        _score_sde_config(f"score_sde_{nm}_ve_ncsn_124", ema_rate=0.0,
                          **base)
        _score_sde_config(f"score_sde_{nm}_ve_ncsn_1245", ema_rate=0.999,
                          **base)
        _score_sde_config(
            f"score_sde_{nm}_ve_ncsn_5", sde="ve",
            model_preset="ncsn_v1" if ds == "cifar10" else "ncsn_v1_celeba",
            continuous=False, family="ncsnv2", dataset=ds, image_size=size,
            centered=False, num_scales=10, sigma_max=1.0, predictor="none",
            corrector="ald", snr=0.316, n_steps_each=100, ema_rate=0.999)
    # legacy NCSNv2 (ref configs/ve/ncsnv2/*.py: annealed Langevin only;
    # per-file snr/n_steps_each)
    _score_sde_config("score_sde_cifar10_ve_ncsnv2", sde="ve",
                      model_preset="ncsnv2_cifar10", continuous=False,
                      family="ncsnv2", num_scales=232, predictor="none",
                      corrector="ald", snr=0.176, n_steps_each=5,
                      ema_rate=0.999, **CU)
    _score_sde_config("score_sde_celeba64_ve_ncsnv2", sde="ve",
                      model_preset="ncsnv2_celeba", continuous=False,
                      family="ncsnv2", dataset="celeba", image_size=64,
                      centered=False, sigma_max=90.0, num_scales=500,
                      predictor="none", corrector="ald", snr=0.128,
                      n_steps_each=5, ema_rate=0.999)
    _score_sde_config("score_sde_bedroom_ve_ncsnv2", sde="ve",
                      model_preset="ncsnv2_bedroom", continuous=False,
                      family="ncsnv2", dataset="lsun_bedroom",
                      image_size=128, centered=False, sigma_max=190.0,
                      num_scales=1086, batch_size=32, eval_batch=64,
                      predictor="none", corrector="ald", snr=0.095,
                      n_steps_each=3)


_register_score_sde_matrix()


@register_config("tiny_test")
def _tiny_test() -> Config:
    """Small DDPM UNet at 16px: smoke tests, docs examples, CI."""
    from dpm_solver_tpu_torch.models import DDPMUNetConfig

    return Config(
        name="tiny_test", model_family="ddpm_unet",
        model_config=DDPMUNetConfig.tiny(resolution=16),
        data=DataConfig(dataset="arrays", image_size=16, centered=True),
        sampling=SamplingConfig(order=2, steps=6, skip_type="time_uniform",
                                method="multistep"),
        training=TrainingConfig(batch_size=8, n_iters=10, warmup=2,
                                snapshot_freq=2,
                                snapshot_freq_for_preemption=2, log_freq=1),
        eval=EvalConfig(batch_size=4, num_samples=4, begin_ckpt=1,
                        end_ckpt=100),
    )


@register_config("tiny_ve_ncsnv2")
def _tiny_ve_ncsnv2() -> Config:
    """Small NCSNv2 under a 10-scale VE ladder: smoke tests for the legacy
    annealed-Langevin (PC) sampling path."""
    from dpm_solver_tpu_torch.models import NCSNv2Config

    return Config(
        name="tiny_ve_ncsnv2", model_family="ncsnv2",
        model_config=NCSNv2Config.tiny(),
        data=DataConfig(dataset="arrays", image_size=16, centered=False),
        sampling=SamplingConfig(predictor="none", corrector="ald",
                                snr=0.176, n_steps_each=2),
        training=TrainingConfig(sde="vesde", continuous=False, batch_size=8,
                                num_scales=10, sigma_max=50.0, n_iters=10,
                                warmup=2, snapshot_freq=2,
                                snapshot_freq_for_preemption=2, log_freq=1),
        eval=EvalConfig(batch_size=4, num_samples=4),
    )


@register_config("tiny_superres")
def _tiny_superres() -> Config:
    """Small SuperRes ADM UNet (low-res concat conditioning) at 16px:
    exercises the runner's base_samples upsampling flow
    (ref runners/diffusion.py:420-446, unet.py:666-680)."""
    from dpm_solver_tpu_torch.models import ADMConfig

    return Config(
        name="tiny_superres", model_family="adm",
        model_config=ADMConfig(
            image_size=16, in_channels=6, model_channels=32, out_channels=3,
            num_res_blocks=1, attention_resolutions=(4,),
            channel_mult=(1, 2), num_heads=2),
        data=DataConfig(dataset="arrays", image_size=16, centered=True),
        sampling=SamplingConfig(order=2, steps=6, skip_type="time_uniform",
                                method="multistep"),
        eval=EvalConfig(batch_size=4, num_samples=4),
    )


@register_config("sd_v1")
def _sd_v1() -> Config:
    """Stable Diffusion v1: CFG 7.5, 25 steps, multistep order-2
    (stable-diffusion/README.md:22-25, txt2img.py defaults)."""
    from dpm_solver_tpu_torch.models import ADMConfig

    return Config(
        name="sd_v1", model_family="sd",
        model_config=ADMConfig.sd_v1(),
        data=DataConfig(dataset="laion", image_size=512, channels=3),
        sampling=SamplingConfig(order=2, steps=25, skip_type="time_uniform",
                                method="multistep", guidance_scale=7.5),
    )
