"""Training and evaluation orchestration (the reference's run_lib layer).

Counterpart of `dpm_solver_tpu/run_lib.py`: `build_model`,
`score_net_apply`, `uses_legacy_discrete_loss`, `legacy_loss_fn`,
`_make_sde`, `train` (score_sde_jax/run_lib.py:51-214), `evaluate`
(:217-595, the checkpoint-polling evaluation), `train_latent` (the LDM
p_losses loop) and `train_autoencoder` (the first stage's adversarial
loop). The training loops are preemption-safe: they restore the newest meta
checkpoint or start afresh, write a meta checkpoint every
`snapshot_freq_for_preemption` steps and a full one every `snapshot_freq`.

The loops run on `device` (the card by default; "cpu" for the tests). Each
step's randomness is `StepRng(seed, step)` (training/train.py): a restarted
run repeats the draws of an uninterrupted one; an evaluation round's is
`StepRng(seed, checkpoint)`'s stream r, where the JAX package folds keys.
`compute_dtype` is the networks' (parameters, gradients, optimiser state
and EMA stay fp32).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from dpm_solver_tpu_torch.configs import Config
from dpm_solver_tpu_torch.training.checkpoints import (CheckpointManager, EvalMeta,
                                                       delete_eval_meta, load_eval_meta,
                                                       restore_or_init, save_eval_meta,
                                                       wait_for_checkpoint)
from dpm_solver_tpu_torch.training.train import (StepRng, TrainState, make_optimizer,
                                                 make_train_state)
from dpm_solver_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

log = logging.getLogger("dpm_solver_tpu_torch")

# the streams of the models' initial weights
_INIT_STREAM, _FIRST_STAGE_STREAM, _DISC_STREAM, _LPIPS_STREAM = 0, 1, 2, 3
# the streams of an evaluation's loss and bits/dim rounds (its sampling round
# r takes stream r): the JAX package's fold_in data (run_lib.py:277, :283)
_EVAL_LOSS_STREAM, _EVAL_BPD_STREAM = 10_000, 20_000


def _init_generator(seed: int, stream: int, device) -> torch.Generator:
    """The generator a run draws its initial weights from (apart from every
    step's: a key of two words where a step's has three)."""
    key = np.random.SeedSequence([seed % 2 ** 63, stream]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(key >> np.uint64(1)))


def build_model(config: Config, *, compute_dtype: torch.dtype = torch.float32,
                device=DEFAULT_DEVICE) -> Tuple[nn.Module, Callable]:
    """Config -> (module on `device`, init_fn(generator) -> the module with
    the JAX model's training initialisers drawn, `models/init.py`)."""
    from dpm_solver_tpu_torch import models
    from dpm_solver_tpu_torch.models.init import init_train_

    family, mc = config.model_family, config.model_config
    dev = resolve_device(device)
    if family == "ddpm_unet":
        model = models.DDPMUNet(mc, compute_dtype, device=dev)
    elif family == "ncsnpp":
        model = models.NCSNpp(mc, compute_dtype, device=dev)
    elif family == "ncsnv2":
        # fp32 whatever compute_dtype says: the JAX model has no compute dtype
        model = models.NCSNv2(mc, device=dev)
    elif family in ("adm", "sd"):
        model = models.ADMUNet(mc, compute_dtype, device=dev)
    else:
        raise ValueError(f"unknown model family {family!r}")

    def init_fn(generator: torch.Generator) -> nn.Module:
        return init_train_(model, generator)

    return model, init_fn


def score_net_apply(model: nn.Module, family: str, *, train: bool = False) -> Callable:
    """apply_fn(x, labels) with the family's label convention (NCSNv2/NCSN
    take integer sigma-ladder indices, truncated as the JAX astype(int32);
    NCSN++ and DDPM UNets float labels), the model in train mode (dropout
    live) when `train`, else in eval mode."""

    def apply_fn(x, labels):
        if model.training != train:
            model.train(train)
        return model(x, labels.long() if family == "ncsnv2" else labels.float())

    return apply_fn


def uses_legacy_discrete_loss(config: Config) -> bool:
    """Discretely-labelled score nets train with the legacy SMLD / DDPM
    objectives (ref losses.py:124-178) instead of the continuous score
    matching loss or the ddpm example's eps-MSE."""
    if config.training.continuous:
        return False
    return (config.model_family in ("ncsnpp", "ncsnv2")
            or (config.model_family == "ddpm_unet" and config.training.sde == "vesde"))


def _make_sde(config: Config):
    from dpm_solver_tpu_torch.sde import VESDE, VPSDE, SubVPSDE

    t = config.training
    if t.sde == "vesde":
        return VESDE(sigma_min=t.sigma_min, sigma_max=t.sigma_max, N=t.num_scales)
    cls = {"vpsde": VPSDE, "subvpsde": SubVPSDE}[t.sde]
    return cls(beta_0=t.beta_min, beta_1=t.beta_max, N=t.num_scales)


def legacy_loss_fn(config: Config, model: nn.Module, *, train: bool = False) -> Callable:
    """The SMLD / legacy-DDPM loss for a `uses_legacy_discrete_loss` config,
    with the family's label convention and, when training, live dropout."""
    from dpm_solver_tpu_torch.training.losses import ddpm_loss_fn, smld_loss_fn

    if config.training.sde == "subvpsde":
        # as the reference: sub-VP has no discrete objective
        raise ValueError("discrete training is undefined for the sub-VP SDE")
    sde = _make_sde(config)
    apply_fn = score_net_apply(model, config.model_family, train=train)
    make = smld_loss_fn if config.training.sde == "vesde" else ddpm_loss_fn
    return make(sde, apply_fn, reduce_mean=config.training.reduce_mean, model_rng=train)


def _tensor(x, device: torch.device) -> torch.Tensor:
    """A batch (numpy or torch) as an fp32 tensor on `device`."""
    x = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
    return x.to(device, torch.float32)


def _log_step(step: int, metrics: dict) -> None:
    """The loops' log line (reading the metrics waits for the step)."""
    log.info("step %d loss %.5g grad_norm %.5g", step, float(metrics["loss"]),
             float(metrics["grad_norm"]))


def _managers(workdir: str) -> Tuple[CheckpointManager, CheckpointManager]:
    return (CheckpointManager(os.path.join(workdir, "checkpoints"), max_to_keep=5),
            CheckpointManager(os.path.join(workdir, "checkpoints-meta"), max_to_keep=1))


def _snapshot(step: int, state, ckpts, meta, preempt_freq: int,
              freq: int) -> None:
    """The loop's checkpoints after loop index `step` (state.step = step + 1)."""
    if step and step % preempt_freq == 0:
        meta.save(step, state)
    if step and step % freq == 0:
        ckpts.save(step, state)


def train(config: Config, data_iter: Iterator, *, workdir: Optional[str] = None,
          max_steps: Optional[int] = None, compute_dtype: torch.dtype = torch.float32,
          device=DEFAULT_DEVICE, mesh=None) -> TrainState:
    """Preemption-safe training (ref run_lib.py:51-214): the continuous SDE
    loss, the legacy discrete SMLD / DDPM loss, or the DDPM eps-MSE with
    antithetic times, by the config. `data_iter` yields (devices,
    per_device, H, W, C) or (B, H, W, C) batches (numpy or torch) in model
    space. `mesh` (`parallel.make_mesh`, one call a rank): the step is
    data-parallel over its data axis (`training/train.py`), each rank fed
    the same global batches; every rank keeps the same state and rank 0
    alone writes the checkpoints. The model lives on the mesh's device."""
    workdir = workdir or config.workdir
    tcfg = config.training
    if mesh is not None:
        from dpm_solver_tpu_torch.parallel.mesh import mesh_device

        device = mesh_device(mesh)
    dev = resolve_device(device)
    model, init_fn = build_model(config, compute_dtype=compute_dtype, device=dev)
    init_fn(_init_generator(config.seed, _INIT_STREAM, dev))
    tx = make_optimizer(tcfg.lr, tcfg.warmup, tcfg.grad_clip)
    state, _ = make_train_state(model, ema_rate=tcfg.ema_rate, tx=tx)
    ckpts, meta = _managers(workdir)
    state = restore_or_init(meta, state)
    start = state.step
    log.info("training from step %d", start)

    if tcfg.continuous:
        from dpm_solver_tpu_torch.score import get_score_fn
        from dpm_solver_tpu_torch.training.losses import make_score_train_step, sde_loss_fn

        sde = _make_sde(config)
        score_fn = get_score_fn(sde, score_net_apply(model, config.model_family, train=True),
                                continuous=True)
        loss_fn = sde_loss_fn(sde, score_fn, reduce_mean=tcfg.reduce_mean,
                              likelihood_weighting=tcfg.likelihood_weighting, score_rng=True)
        step_fn = make_score_train_step(loss_fn, tx, mesh=mesh)
    elif uses_legacy_discrete_loss(config):
        from dpm_solver_tpu_torch.training.losses import make_score_train_step

        step_fn = make_score_train_step(legacy_loss_fn(config, model, train=True), tx, mesh=mesh)
    else:
        from dpm_solver_tpu_torch.schedule import NoiseScheduleVP
        from dpm_solver_tpu_torch.training.train import make_train_step

        ns = NoiseScheduleVP.discrete(betas=config.diffusion.betas())
        step_fn = make_train_step(score_net_apply(model, config.model_family, train=True),
                                  ns, tx, dropout_rng=True, mesh=mesh)

    total = max_steps if max_steps is not None else tcfg.n_iters
    writer = mesh is None or mesh.get_rank() == 0
    for step in range(start, total):
        batch = _tensor(next(data_iter), dev)
        state, metrics = step_fn(state, batch.reshape((-1,) + tuple(batch.shape[-3:])),
                                 config.seed)
        if step % tcfg.log_freq == 0:
            _log_step(step, metrics)
        if writer:
            _snapshot(step, state, ckpts, meta, tcfg.snapshot_freq_for_preemption,
                      tcfg.snapshot_freq)
    return state


def evaluate(config: Config, *, workdir: Optional[str] = None, sample_fn: Optional[Callable] = None,
             feature_fn: Optional[Callable] = None, loss_fn: Optional[Callable] = None,
             bpd_fn: Optional[Callable] = None, bpd_rounds: int = 0, rounds: Optional[int] = None,
             poll_timeout: Optional[float] = 0.0, device=DEFAULT_DEVICE) -> dict:
    """Checkpoint-polling evaluation that resumes where it was stopped (ref
    run_lib.py:217-595): each SAVED checkpoint step in [begin_ckpt,
    end_ckpt] (keyed by training step, not consecutive ids), restored into
    a `TrainState` on `device`. Hooks, all optional, each given the state
    and a torch.Generator on `device`:
      sample_fn(state, generator) -> (B, H, W, C)  one sampling round;
      feature_fn(images) -> (features, logits)     FID/IS features; each
          round's are written to `stats_ckpt{c}_round{r}.npz` (the samples
          to `samples_ckpt{c}_round{r}.npz` without it), so a resumed run
          aggregates all rounds (ref statistics_r.npz);
      loss_fn(state, generator) -> float           the eval loss (enable_loss);
      bpd_fn(state, generator) -> (B,) bits/dim    likelihood rounds (enable_bpd).
    Progress is `EvalMeta` in workdir/eval after every round. Returns
    {checkpoint step: {"rounds", "loss", "bpd", "inception_score", "fid"}}
    (the keys whose hooks ran)."""
    from dpm_solver_tpu_torch.eval import fid_from_features, inception_score, load_statistics

    workdir = workdir or config.workdir
    ecfg, tcfg = config.eval, config.training
    eval_dir = os.path.join(workdir, "eval")
    os.makedirs(eval_dir, exist_ok=True)
    dev = resolve_device(device)
    ckpts = CheckpointManager(os.path.join(workdir, "checkpoints"))
    # the optimiser's hyperparameters shape its state: the restore template
    # must match what training saved
    model, _ = build_model(config, device=dev)
    template, _ = make_train_state(model, ema_rate=tcfg.ema_rate,
                                   tx=make_optimizer(tcfg.lr, tcfg.warmup, tcfg.grad_clip))
    n_rounds = rounds if rounds is not None else int(np.ceil(ecfg.num_samples / ecfg.batch_size))
    meta = load_eval_meta(eval_dir)
    results = {}

    def path(kind: str, ckpt: int, r: int) -> str:
        return os.path.join(eval_dir, f"{kind}_ckpt{ckpt}_round{r}.npz")

    if not wait_for_checkpoint(ckpts, ecfg.begin_ckpt, poll_seconds=5.0, timeout=poll_timeout):
        log.info("no checkpoint >= %d available", ecfg.begin_ckpt)
        return results
    steps = [s for s in ckpts.all_steps()
             if ecfg.begin_ckpt <= s <= ecfg.end_ckpt and s >= meta.ckpt_id]
    for ckpt_id in steps:
        state = ckpts.restore(template, ckpt_id)
        rng = StepRng(config.seed, ckpt_id)
        entry = {"rounds": n_rounds}

        if loss_fn is not None and ecfg.enable_loss:
            entry["loss"] = float(loss_fn(state, rng.generator(dev, _EVAL_LOSS_STREAM)))

        if bpd_fn is not None and ecfg.enable_bpd:
            for r in range(meta.bpd_round_id + 1 if meta.ckpt_id == ckpt_id else 0, bpd_rounds):
                bpd = bpd_fn(state, rng.generator(dev, _EVAL_BPD_STREAM + r))
                np.savez(path("bpd", ckpt_id, r), bpd=_host(bpd))
                meta = EvalMeta(ckpt_id=ckpt_id, bpd_round_id=r,
                                sampling_round_id=meta.sampling_round_id
                                if meta.ckpt_id == ckpt_id else -1)
                save_eval_meta(meta, eval_dir)
            bpds = [np.load(path("bpd", ckpt_id, r))["bpd"] for r in range(bpd_rounds)]
            if bpds:
                entry["bpd"] = float(np.mean(np.concatenate(bpds)))

        if sample_fn is not None:
            for r in range(meta.sampling_round_id + 1 if meta.ckpt_id == ckpt_id else 0, n_rounds):
                samples = sample_fn(state, rng.generator(dev, r))
                if feature_fn is not None:
                    feats, logits = feature_fn(samples)
                    np.savez(path("stats", ckpt_id, r), feats=_host(feats), logits=_host(logits))
                else:
                    np.savez(path("samples", ckpt_id, r), samples=_host(samples))
                meta = EvalMeta(ckpt_id=ckpt_id, sampling_round_id=r,
                                bpd_round_id=meta.bpd_round_id if meta.ckpt_id == ckpt_id else -1
                                ).with_rng(rng.key(r))
                save_eval_meta(meta, eval_dir)
            if feature_fn is not None:
                stats = [np.load(path("stats", ckpt_id, r)) for r in range(n_rounds)]
                entry["inception_score"] = inception_score(
                    np.concatenate([s["logits"] for s in stats]))[0]
                if ecfg.fid_stats_path:
                    entry["fid"] = fid_from_features(np.concatenate([s["feats"] for s in stats]),
                                                     load_statistics(ecfg.fid_stats_path))

        results[ckpt_id] = entry
        meta = EvalMeta(ckpt_id=ckpt_id + 1)
        save_eval_meta(meta, eval_dir)

    delete_eval_meta(eval_dir)
    return results


def _host(x) -> np.ndarray:
    """A tensor (or array) as a NumPy array on the host."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def train_latent(preset: str, data_iter: Iterator, *, workdir: str, unet_config=None,
                 vae_config=None, init_model=None, parameterization: Optional[str] = None,
                 cond_dropout: float = 0.0, uncond_context=None, lr: float = 1e-4,
                 warmup: int = 0, grad_clip: float = 1.0, ema_rate: float = 0.9999,
                 optimizer: str = "adam", remat: bool = False, max_steps: int = 1000,
                 log_freq: int = 50, snapshot_freq: int = 10_000,
                 snapshot_freq_for_preemption: int = 1_000, seed: int = 0,
                 compute_dtype: torch.dtype = torch.float32,
                 device=DEFAULT_DEVICE) -> TrainState:
    """The latent-diffusion loop: a frozen first stage, the UNet trains
    (the JAX `train_latent`, the LDM p_losses objective).

    preset: sd_v1 | sd_v2_1 | cin256 | rdm_768 (`pipelines.stable_diffusion`'s
    presets); `unet_config` / `vae_config` override its geometry.
    data_iter yields image batches (B, H, W, 3) in [-1, 1], or (images,
    context) pairs. init_model: a `LatentDiffusion` bundle (e.g. from
    `load_sd_checkpoint`) to fine-tune: its UNet trains, its first stage is
    the frozen encoder. parameterization: eps | x0 | v; None: the preset's
    (v for SD-2.x's linear-transformer geometry, else eps). cond_dropout /
    uncond_context: classifier-free-guidance training. optimizer: adam |
    adafactor (optax 0.2.6's, `training/optim.py`). remat: per-block
    checkpointing in the UNet. The UNet runs as the JAX loop runs it, with
    dropout off (deterministic=True).
    """
    from dpm_solver_tpu_torch.models import ADMUNet, AutoencoderKL, VQModel
    from dpm_solver_tpu_torch.models.init import init_train_
    from dpm_solver_tpu_torch.pipelines.stable_diffusion import _LDM_PRESETS, make_ldm_betas
    from dpm_solver_tpu_torch.training.latent import make_latent_train_step, vae_encode_fn
    from dpm_solver_tpu_torch.training.optim import Adafactor, flax_layouts, linear_schedule

    if preset not in _LDM_PRESETS:
        raise ValueError(f"unknown preset {preset!r}; one of {sorted(_LDM_PRESETS)}")
    if optimizer not in ("adam", "adafactor"):
        raise ValueError(f"unknown optimizer {optimizer!r}; one of ('adam', 'adafactor')")
    dev = resolve_device(device)
    u_default, v_default, beta_kw, scale = _LDM_PRESETS[preset]
    unet_config = unet_config or (init_model.unet.config if init_model else u_default())
    vae_config = vae_config or (init_model.vae.config if init_model else v_default())
    if parameterization is None:
        parameterization = (init_model.parameterization if init_model
                            else "v" if unet_config.use_linear_in_transformer else "eps")
    if remat and not unet_config.remat:
        unet_config = dataclasses.replace(unet_config, remat=True)
    betas = init_model.betas if init_model else make_ldm_betas(1000, **beta_kw)

    if init_model is not None:
        vae, unet = init_model.vae, init_model.unet
        if unet.config != unet_config:  # remat, or an explicit override
            sd = unet.state_dict()
            unet = ADMUNet(unet_config, compute_dtype, device=dev)
            unet.load_state_dict(sd)
    else:
        is_vq = preset == "cin256"
        vae = (VQModel(vae_config, compute_dtype=compute_dtype, device=dev) if is_vq
               else AutoencoderKL(vae_config, compute_dtype, device=dev))
        init_train_(vae, _init_generator(seed, _FIRST_STAGE_STREAM, dev))
        unet = init_train_(ADMUNet(unet_config, compute_dtype, device=dev),
                           _init_generator(seed, _INIT_STREAM, dev))
    vae.eval().requires_grad_(False)
    unet.eval()  # dropout off, as the JAX loop's deterministic=True
    if isinstance(vae, VQModel):
        def encode_fn(images, _generator):
            return scale * vae.encode(images).float()
    else:
        encode_fn = vae_encode_fn(vae, scale_factor=scale)

    sched = linear_schedule(0.0, lr, warmup) if warmup else lr
    tx = (make_optimizer(lr, warmup, grad_clip) if optimizer == "adam"
          else Adafactor(sched, grad_clip, layouts=flax_layouts(unet)))
    state, _ = make_train_state(unet, ema_rate=ema_rate, tx=tx)
    ckpts, meta = _managers(workdir)
    state = restore_or_init(meta, state)
    start = state.step
    log.info("latent training (%s, %s) from step %d", preset, parameterization, start)

    uc = None if uncond_context is None else torch.as_tensor(
        np.asarray(uncond_context), dtype=torch.float32, device=dev)
    if cond_dropout and uc is None and unet_config.context_dim is not None:
        # the null context for CFG training: zeros (the empty prompt's
        # embedding where a text encoder is wired)
        uc = torch.zeros((1, unet_config.context_dim), device=dev)
    step_fn = make_latent_train_step(lambda z, t, c: unet(z, t, None, c), tx, betas,
                                     encode_fn=encode_fn, parameterization=parameterization,
                                     cond_dropout=cond_dropout, uncond_context=uc)

    for step in range(start, max_steps):
        batch = next(data_iter)
        images, context = batch if isinstance(batch, (tuple, list)) else (batch, None)
        images = _tensor(images, dev)
        if context is not None:
            context = _tensor(context, dev)
        elif unet_config.context_dim is not None:
            # unconditional training of a conditional UNet: every sample gets
            # the null-context row
            row = uc if uc is not None else torch.zeros((1, unet_config.context_dim), device=dev)
            context = row[None].expand((images.shape[0],) + tuple(row.shape))
        state, metrics = step_fn(state, images, context, seed)
        if step % log_freq == 0:
            _log_step(step, metrics)
        _snapshot(step, state, ckpts, meta, snapshot_freq_for_preemption, snapshot_freq)
    return state


def train_autoencoder(data_iter: Iterator, *, workdir: str, kind: str = "kl", vae_config=None,
                      n_embed: int = 16384, loss_config=None, disc_ndf: int = 64,
                      disc_n_layers: int = 3, use_actnorm: bool = False, lpips_params=None,
                      lr: float = 4.5e-6, max_steps: int = 1000, log_freq: int = 50,
                      snapshot_freq: int = 10_000, snapshot_freq_for_preemption: int = 1_000,
                      image_freq: int = 0, seed: int = 0, device=DEFAULT_DEVICE):
    """The first-stage (AutoencoderKL / VQModel) adversarial training loop,
    fp32 (the JAX package's): the reference's autoencoder training (its
    PyTorch-Lightning harness, examples/stable-diffusion/main.py, driving
    `AutoencoderKL.training_step`'s two optimisers with the
    LPIPSWithDiscriminator / VQLPIPSWithDiscriminator losses). One step runs
    both optimiser passes (`training/autoencoder.py`); checkpoints as
    `train`'s; `image_freq` writes input | reconstruction grids under
    workdir/recon (the ImageLogger callback's role, main.py:289-394).

    data_iter yields (B, H, W, 3) batches in [-1, 1]. kind: 'kl' | 'vq'.
    loss_config: `training.perceptual.KLLossConfig` / `VQLossConfig`
    (default: disc_start 0 with the reference's weights). lpips_params: an
    LPIPS state dict (`models.lpips.lpips_state_dict`'s namings); without
    one the LPIPS is random (a random-feature perceptual metric: load
    published weights for the reference's loss). Returns the
    `AdversarialTrainState`."""
    from dpm_solver_tpu_torch.models.discriminator import NLayerDiscriminator
    from dpm_solver_tpu_torch.models.init import init_train_
    from dpm_solver_tpu_torch.models.lpips import LPIPS
    from dpm_solver_tpu_torch.models.vae import AutoencoderKL, VAEConfig, VQModel
    from dpm_solver_tpu_torch.training import perceptual as PL
    from dpm_solver_tpu_torch.training.autoencoder import (bind_autoencoder,
                                                           make_adversarial_state,
                                                           make_kl_train_step, make_vq_train_step)
    from dpm_solver_tpu_torch.utils.logging import save_image_grid

    if kind not in ("kl", "vq"):
        raise ValueError(f"kind must be 'kl' or 'vq', got {kind!r}")
    is_kl = kind == "kl"
    vae_config = vae_config or (VAEConfig.sd_v1() if is_kl else VAEConfig.vq_cin256())
    loss_config = loss_config or (PL.KLLossConfig() if is_kl else PL.VQLossConfig())
    dev = resolve_device(device)
    model = (AutoencoderKL(vae_config, device=dev) if is_kl
             else VQModel(vae_config, n_embed=n_embed, device=dev))
    init_train_(model, _init_generator(seed, _FIRST_STAGE_STREAM, dev))
    disc = init_train_(NLayerDiscriminator(disc_ndf, disc_n_layers, use_actnorm,
                                           input_nc=vae_config.in_channels, device=dev),
                       _init_generator(seed, _DISC_STREAM, dev))
    lpips = LPIPS(device=dev).eval()
    if lpips_params is not None:
        lpips.load_state_dict(lpips_params)
    elif loss_config.perceptual_weight > 0:
        log.warning("train_autoencoder: random-init LPIPS (no weights supplied); load "
                    "published weights for the reference's loss")
        init_train_(lpips, _init_generator(seed, _LPIPS_STREAM, dev))
    fns = bind_autoencoder(model, disc, lpips)

    state, tx = make_adversarial_state(model, disc, lr=lr)
    step_fn = (make_kl_train_step(loss_config, tx=tx, **fns) if is_kl
               else make_vq_train_step(loss_config, tx=tx, n_embed=n_embed, **fns))
    ckpts, meta = _managers(workdir)
    state = restore_or_init(meta, state)
    start = state.step
    log.info("autoencoder training (%s, %dpx) from step %d", kind, vae_config.resolution, start)

    for step in range(start, max_steps):
        images = _tensor(next(data_iter), dev)
        state, metrics = step_fn(state, images, seed)
        if step % log_freq == 0:
            log.info("step %d nll %.5g disc %.5g", step,
                     float(metrics.get("train/nll_loss", float("nan"))),
                     float(metrics.get("train/disc_loss", float("nan"))))
        if image_freq and step % image_freq == 0:
            with torch.no_grad():
                recon = model(images)[0]  # the KL posterior's mode
            pair = torch.cat([images, recon.float()], dim=2)  # input | reconstruction
            save_image_grid(torch.clamp((pair + 1.0) / 2.0, 0.0, 1.0),
                            os.path.join(workdir, "recon", f"recon_{step:07d}.png"))
        _snapshot(step, state, ckpts, meta, snapshot_freq_for_preemption, snapshot_freq)
    return state
