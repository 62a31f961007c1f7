"""Command-line entry points: `python -m dpm_solver_tpu_torch.cli <cmd>`.

Port of `dpm_solver_tpu/cli.py` (the twin of the reference CLIs:
ddpm_and_guided-diffusion/main.py:19-277, score_sde_jax/main.py:28-63,
stable-diffusion/scripts/txt2img.py:97-345), with every subcommand and flag
of it, on the port's backends (`run_lib`, `pipelines`, `eval`, `samplers`,
`data`):

  sample       generate a batch with DPM-Solver (or the PC loop for VE /
               sub-VP configs) from a named config, optionally from a
               reference torch checkpoint; save npz + PNGs
  train        the training loop on a local dataset
  train-ae     first-stage adversarial training (LPIPS + PatchGAN)
  train-latent latent-diffusion training (frozen first stage)
  eval         checkpoint-polling FID/IS evaluation
  txt2img      Stable-Diffusion text-to-image from a CompVis checkpoint,
               with the invisible watermark, the safety screen and the
               int8 serving path (`--quant`)
  img2img, inpaint, knn2img, clscond   the other latent-diffusion front ends
  fid          FID between two sample sources
  wmdecode     read an invisible watermark back
  configs      list registered configs

Where it differs from the JAX CLI:
- `--device` (global, default "cuda"): where the networks run; "cpu" is for
  tests. With no card, "cuda" raises (`utils.device.resolve_device`).
- JAX's `--compile-cache` (XLA's persistent cache) has no counterpart and is
  not carried.
- Seeds go into `torch.Generator`s on the CPU (the noise is drawn there and
  moved), as the port's pipelines draw theirs: the images differ from the
  JAX CLI's for the same seed, and do not depend on the device.
- The latent-diffusion subcommands compute in bfloat16 on the card (the
  TPU's default matmul precision) and in float32 on the CPU.
- `sample --devices N` raises for N > 1 (the mesh is Slice G), and
  `--trace-dir` writes a `torch.profiler` trace of one warm call
  (`trace.json`, Chrome's format, and `ops.txt`, the ops by device time).
- Checkpoints load by reference keys (`utils.convert.load_torch_state_dict`,
  `torch.load(weights_only=True)`); a score_sde_pytorch `.pth` has its EMA
  shadow list paired with its model's parameters here. Flax `State` files
  (score_sde_jax checkpoints, and NCSNv2 ones) need flax's msgpack and
  raise, naming the format.
- Images are written by the port's own PNG encoder (`native`).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys

import numpy as np
import torch



def _device(args) -> torch.device:
    from dpm_solver_tpu_torch.utils.device import resolve_device

    return resolve_device(args.device)


def _sd_dtype(dev: torch.device) -> torch.dtype:
    return torch.bfloat16 if dev.type == "cuda" else torch.float32


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(seed))


def _host(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _save_images(arr, outdir: str, prefix: str = "sample") -> None:
    """[B,H,W,C] floats in [0,1] -> one PNG each (the port's threaded
    encoder, `native.write_png_batch`) + one npz."""
    from dpm_solver_tpu_torch import native

    arr = _host(arr)
    os.makedirs(outdir, exist_ok=True)
    np.savez(os.path.join(outdir, f"{prefix}.npz"), samples=arr)
    imgs = (arr * 255).clip(0, 255).astype(np.uint8)
    native.write_png_batch(imgs, [os.path.join(outdir, f"{prefix}_{i:05d}.png")
                                  for i in range(len(imgs))])


# --------------------------------------------------------------------------- #
# sample: checkpoints, the solver, the PC loop
# --------------------------------------------------------------------------- #


def _strip_module(sd: dict) -> dict:
    return {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}


def load_score_sde_torch_checkpoint(path: str, cfg, *, use_ema: bool = True) -> dict:
    """A score_sde_pytorch checkpoint (`dict(optimizer=, model=, ema=, step=)`)
    -> the port NCSN++'s state dict (the reference's keys, `module.` dropped).

    With `use_ema`, the EMA's `shadow_params` (a list in the order of the
    reference model's trainable parameters) replace the model's values, as
    the reference's sampling-time `ema.copy_to(model.parameters())` does.
    The pairing takes the checkpoint's own key order with the buffers and
    frozen parameters left out (`sigmas`, and the Fourier projection's W),
    which is the order of `model.parameters()` (the JAX package's
    `models/ncsnpp_convert.py::load_score_sde_torch_checkpoint` pairs the
    same way)."""
    d = torch.load(path, map_location="cpu", weights_only=True)
    sd = _strip_module(d["model"] if isinstance(d, dict) and "model" in d else d)
    sd = {k: v for k, v in sd.items() if torch.is_tensor(v)}
    ema = d.get("ema") if isinstance(d, dict) else None
    if use_ema and isinstance(ema, dict) and "shadow_params" in ema:
        # the buffer and the frozen parameter that ExponentialMovingAverage
        # (requires_grad parameters only) leaves out of its list
        frozen = {"sigmas"}
        if cfg.embedding_type == "fourier":
            frozen.add("all_modules.0.W")
        names = [k for k in sd if k not in frozen]
        shadow = ema["shadow_params"]
        if len(names) != len(shadow):
            raise ValueError(f"EMA shadow list has {len(shadow)} entries but the model "
                             f"has {len(names)} trainable params")
        sd.update(zip(names, shadow))
    return sd


def _load_sample_weights(config, model, ckpt: str) -> None:
    """Reference weights into the port model, by the config's family."""
    from dpm_solver_tpu_torch.utils.convert import load_torch_state_dict

    family = config.model_family
    if family == "ncsnpp" and ckpt.endswith((".pth", ".pt", ".ckpt")):
        sd = load_score_sde_torch_checkpoint(ckpt, config.model_config)
    elif family in ("ncsnpp", "ncsnv2"):
        raise SystemExit(
            f"{ckpt}: a Flax State checkpoint ({'score_sde_jax' if family == 'ncsnpp' else 'NCSNv2'}"
            ", read by flax.serialization's msgpack) is not readable by dpm_solver_tpu_torch; "
            "convert it to a score_sde_pytorch .pth checkpoint first")
    else:
        sd = _strip_module(load_torch_state_dict(ckpt))
    model.load_state_dict(sd, strict=True)


def _uses_pc_sampling(config) -> bool:
    """VE and sub-VP nets are not VP-form, so DPM-Solver does not apply; the
    reference samples them with the PC loop (score_sde get_noise_fn raises
    for anything but continuous VPSDE, models/utils.py:178-191)."""
    return (config.training.sde in ("vesde", "subvpsde")
            and config.model_family in ("ncsnpp", "ncsnv2", "ddpm_unet"))


def _build_sampler_from_config(config, model, *, labels=None, classifier=None, low_res=None):
    """The reference runner's solver assembly (runners/diffusion.py:594-639):
    class-conditional nets get labels and an optional classifier-guidance
    term; learned-sigma nets (out = 2 * in) use the mean half (:600-603);
    `low_res` feeds SuperResModel conditioning (:540-546)."""
    from dpm_solver_tpu_torch import DPM_Solver, NoiseScheduleVP, model_wrapper
    from dpm_solver_tpu_torch.models import super_res_inputs

    scfg, d, tcfg = config.sampling, config.data, config.training
    # continuously-trained score_sde nets: the closed-form linear schedule and
    # t * 999 labels (ref sampling.py:562,571); discrete nets: the beta table
    continuous_score = (config.model_family == "ncsnpp" and tcfg.continuous
                        and tcfg.sde == "vpsde")
    if continuous_score:
        ns = NoiseScheduleVP.linear(tcfg.beta_min, tcfg.beta_max)
    else:
        ns = NoiseScheduleVP.discrete(betas=config.diffusion.betas())
    split_mean = getattr(config.model_config, "out_channels", d.channels) == 2 * d.channels

    def raw(x, t):
        if low_res is not None:
            x = super_res_inputs(x, low_res)
        if continuous_score:
            out = model(x, t * 999.0)
        elif labels is not None:
            out = model(x, t, labels)
        else:
            out = model(x, t)
        return out[..., :d.channels] if split_mean else out

    if classifier is not None and scfg.classifier_scale > 0:
        def log_prob(x, t, y):
            logp = torch.log_softmax(classifier(x, t).float(), dim=-1)
            return logp[torch.arange(x.shape[0], device=x.device), y]

        model_fn = model_wrapper(raw, ns, model_type="noise", guidance_type="classifier",
                                 condition=labels, guidance_scale=scfg.classifier_scale,
                                 classifier_fn=log_prob)
    else:
        model_fn = model_wrapper(raw, ns, model_type="noise")
    solver = DPM_Solver(model_fn, ns, algorithm_type=scfg.algorithm_type,
                        correcting_x0_fn="dynamic_thresholding" if scfg.thresholding else None)
    return solver, ns


def _build_pc_sampler_from_config(config, model):
    """(sde, sampler(x_T, generator) -> (x0, nfe)): the PC loop (ref
    sampling.py:391-456; sampling eps 1e-5 for VE, 1e-3 for VP / sub-VP)."""
    from dpm_solver_tpu_torch.run_lib import _make_sde, score_net_apply
    from dpm_solver_tpu_torch.samplers import get_pc_sampler
    from dpm_solver_tpu_torch.score import get_score_fn

    scfg = config.sampling
    sde = _make_sde(config)
    eps = 1e-5 if config.training.sde == "vesde" else 1e-3
    score_fn = get_score_fn(sde, score_net_apply(model, config.model_family),
                            continuous=config.training.continuous)
    pc = get_pc_sampler(sde, score_fn, predictor=scfg.predictor, corrector=scfg.corrector,
                        snr=scfg.snr, n_corrector_steps=scfg.n_steps_each, eps=eps)

    def sampler(x_T, generator):
        # the loop draws on the generator's device; the result moves to x_T's
        noise_dev = generator.device
        if noise_dev == x_T.device:
            return pc(x_T, generator=generator)
        from dpm_solver_tpu_torch.samplers import pc_draws

        n = pc_draws(sde, scfg.predictor, scfg.corrector, scfg.n_steps_each)
        noise = torch.randn((n, *x_T.shape), generator=generator, device=noise_dev)
        return pc(x_T, noise=noise.to(x_T.device))

    return sde, sampler


def _trace(run, trace_dir: str):
    """One warm call of `run` under `torch.profiler` (CPU and, on the card,
    CUDA activity): `trace.json` (Chrome's trace format) and `ops.txt`
    (the ops by device time, else by CPU time) in `trace_dir`."""
    from torch.profiler import ProfilerActivity, profile

    run()   # warm: builds, plans and captures outside the trace
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        out = run()
        if cuda:
            torch.cuda.synchronize()
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    key = "self_cuda_time_total" if cuda else "self_cpu_time_total"
    with open(os.path.join(trace_dir, "ops.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=key, row_limit=50))
    print(f"profiler trace written to {trace_dir}")
    return out


def cmd_sample(args):
    from dpm_solver_tpu_torch.configs import get_config
    from dpm_solver_tpu_torch.data import inverse_data_transform
    from dpm_solver_tpu_torch.run_lib import _init_generator, build_model

    dev = _device(args)
    config = get_config(args.config)
    scfg = config.sampling
    overrides = {k: getattr(args, k) for k in ("steps", "order", "method")
                 if getattr(args, k, None) is not None}
    if overrides:
        if _uses_pc_sampling(config):
            raise SystemExit(
                "--steps/--order/--method are DPM-Solver knobs; config "
                f"{args.config!r} samples through the PC loop (VE/subVP) which ignores them")
        scfg = dataclasses.replace(scfg, **overrides)
    if args.devices is not None and args.devices > 1:
        raise NotImplementedError(
            f"--devices {args.devices}: sharding the batch over several devices (the mesh) is "
            "not ported to dpm_solver_tpu_torch yet (Slice G)")
    model, init_fn = build_model(config, device=dev)
    if args.ckpt:
        _load_sample_weights(config, model, args.ckpt)
    else:
        logging.warning("no --ckpt given; sampling from RANDOM weights")
        init_fn(_init_generator(config.seed, 0, dev))
    model.eval().requires_grad_(False)

    d = config.data
    labels = None
    n_classes = getattr(config.model_config, "num_classes", None)
    if n_classes:
        labels = torch.randint(0, n_classes, (args.batch,),
                               generator=_generator(args.seed + 1)).to(dev)
    classifier = None
    if args.classifier_ckpt and config.classifier_config is not None:
        from dpm_solver_tpu_torch.models import ADMClassifier
        from dpm_solver_tpu_torch.utils.convert import load_torch_state_dict

        classifier = ADMClassifier(config.classifier_config, device=dev)
        classifier.load_state_dict(_strip_module(load_torch_state_dict(args.classifier_ckpt)))
        classifier.eval().requires_grad_(False)
    low_res = None
    if args.base_samples:
        # upsampling runs (ref runners/diffusion.py:31-52,420-446): uint8 NHWC
        # images in arr_0 and optional labels in arr_1
        obj = np.load(args.base_samples)
        arr = obj["arr_0"][:args.batch]
        if arr.shape[0] < args.batch:
            raise SystemExit(f"--base-samples holds {arr.shape[0]} images < batch {args.batch}")
        low_res = torch.from_numpy(np.asarray(arr, np.float32) / 127.5 - 1.0).to(dev)
        if "arr_1" in getattr(obj, "files", ()):
            labels = torch.as_tensor(obj["arr_1"][:args.batch]).long().to(dev)

    shape = (args.batch, d.image_size, d.image_size, d.channels)
    if _uses_pc_sampling(config):
        sde, sampler = _build_pc_sampler_from_config(config, model)
        g = _generator(args.seed)   # the prior's draw, then the loop's
        x_T = sde.prior_sampling(shape, generator=g, device="cpu").to(dev)
        with torch.no_grad():
            out, nfe = sampler(x_T, g)
        imgs = inverse_data_transform(d, out)
        _save_images(imgs, args.outdir)
        print(f"wrote {imgs.shape[0]} samples to {args.outdir} "
              f"(pc {scfg.predictor}/{scfg.corrector}, nfe={int(nfe)})")
        return

    solver, _ = _build_sampler_from_config(config, model, labels=labels, classifier=classifier,
                                           low_res=low_res)
    mode = args.mode
    if mode == "interpolation":
        # slerp grid between two noise draws (ref runners/diffusion.py:484-522)
        from dpm_solver_tpu_torch.samplers import interpolation_grid

        x_T = interpolation_grid(shape[1:], n=args.batch, generator=_generator(args.seed),
                                 device="cpu").to(dev)
    else:
        x_T = torch.randn(shape, generator=_generator(args.seed)).to(dev)

    def run():
        # (classifier guidance takes its gradient under its own enable_grad)
        with torch.no_grad():
            return solver.sample(
                x_T, steps=scfg.steps, t_start=scfg.t_start, t_end=scfg.t_end or 1e-3,
                order=scfg.order, skip_type=scfg.skip_type, method=scfg.method,
                lower_order_final=scfg.lower_order_final,
                return_intermediate=(mode == "sequence"))

    out = _trace(run, args.trace_dir) if args.trace_dir else run()
    if mode == "sequence":
        # per-step trajectory snapshots (ref runners/diffusion.py:461-482)
        out, intermediates = out
        for step_i, x_i in enumerate(intermediates):
            _save_images(inverse_data_transform(d, x_i), args.outdir,
                         prefix=f"seq_step{step_i:03d}")
    imgs = inverse_data_transform(d, out)
    _save_images(imgs, args.outdir)
    print(f"wrote {imgs.shape[0]} samples to {args.outdir} (mode={mode})")


# --------------------------------------------------------------------------- #
# training and evaluation
# --------------------------------------------------------------------------- #


def cmd_train(args):
    from dpm_solver_tpu_torch.configs import get_config
    from dpm_solver_tpu_torch.data import (load_cifar10_dir, lsun_dataset, make_dataset,
                                           numpy_iterator)
    from dpm_solver_tpu_torch.run_lib import train

    dev = _device(args)
    config = get_config(args.config, workdir=args.workdir)
    if args.batch_size:
        config = dataclasses.replace(config, training=dataclasses.replace(
            config.training, batch_size=args.batch_size))
    if args.data_path and (args.data_path.endswith(".mdb") or os.path.exists(
            os.path.join(args.data_path, "data.mdb"))):
        # an LSUN-style LMDB environment (ref datasets/lsun.py)
        ds = lsun_dataset(args.data_path, resolution=config.data.image_size,
                          batch_size=config.training.batch_size, centered=config.data.centered)
    else:
        if args.data_path and os.path.isdir(args.data_path) and \
                config.data.dataset == "cifar10":
            images = load_cifar10_dir(args.data_path)
        elif args.data_path:
            images = np.load(args.data_path)["images"]
        else:
            raise SystemExit("--data-path required (nothing is downloaded)")
        ds = make_dataset(images, batch_size=config.training.batch_size,
                          centered=config.data.centered,
                          uniform_dequantization=config.data.uniform_dequantization)
    state = train(config, numpy_iterator(ds), workdir=args.workdir, max_steps=args.max_steps,
                  device=dev)
    print(f"finished at step {int(state.step)}")


def _npz_images(path: str, key: str = "images") -> np.ndarray:
    data = np.load(path)
    images = np.asarray(data[key] if hasattr(data, "files") and key in data.files else data)
    if images.dtype == np.uint8:
        images = images.astype(np.float32) / 127.5 - 1.0
    return images


def cmd_train_ae(args):
    """First-stage adversarial training (LPIPS + PatchGAN two-optimizer
    loop; ref main.py + ldm/models/autoencoder.py training_step)."""
    from dpm_solver_tpu_torch.run_lib import train_autoencoder
    from dpm_solver_tpu_torch.training import perceptual as PL

    dev = _device(args)
    images = _npz_images(args.data_path)
    rs = np.random.default_rng(0)

    def batches():
        n = images.shape[0]
        while True:
            yield images[rs.integers(0, n, size=args.batch_size)]

    vae_config = None
    disc_kw = dict(disc_ndf=args.disc_ndf, disc_n_layers=args.disc_n_layers)
    if args.tiny:
        from dpm_solver_tpu_torch.models.vae import VAEConfig

        vae_config = VAEConfig.tiny(resolution=images.shape[1], attn_resolutions=(),
                                    double_z=(args.kind == "kl"))
        disc_kw = dict(disc_ndf=8, disc_n_layers=2)
    cfg_cls = PL.KLLossConfig if args.kind == "kl" else PL.VQLossConfig
    loss_config = cfg_cls(disc_start=args.disc_start, perceptual_weight=args.perceptual_weight)
    lpips_params = None
    if args.lpips_ckpt:
        from dpm_solver_tpu_torch.models.lpips import lpips_state_dict
        from dpm_solver_tpu_torch.utils.convert import load_torch_state_dict

        lpips_params = lpips_state_dict(load_torch_state_dict(args.lpips_ckpt))
    state = train_autoencoder(
        batches(), workdir=args.workdir, kind=args.kind, vae_config=vae_config,
        loss_config=loss_config, lpips_params=lpips_params, lr=args.lr,
        max_steps=args.max_steps, log_freq=args.log_freq, snapshot_freq=args.snapshot_freq,
        snapshot_freq_for_preemption=args.snapshot_freq_for_preemption,
        image_freq=args.image_freq, device=dev, **disc_kw)
    print(f"finished at step {int(state.step)}")


def cmd_train_latent(args):
    """LDM training / fine-tuning: frozen first stage, the UNet trains (ref
    main.py's Lightning harness -> run_lib.train_latent's plain loop)."""
    from dpm_solver_tpu_torch.run_lib import train_latent

    dev = _device(args)
    data = np.load(args.data_path)
    images = _npz_images(args.data_path)
    context = np.asarray(data["context"]) if "context" in data.files else None
    rs = np.random.default_rng(0)

    def batches():
        n = images.shape[0]
        while True:
            idx = rs.integers(0, n, size=args.batch_size)
            yield images[idx] if context is None else (images[idx], context[idx])

    init_model = unet_config = vae_config = None
    if args.sd_ckpt:
        from dpm_solver_tpu_torch.pipelines import load_sd_checkpoint

        init_model = load_sd_checkpoint(args.sd_ckpt, preset=args.preset, device=dev)
    elif args.tiny:
        from dpm_solver_tpu_torch.models import ADMConfig, VAEConfig

        unet_config = ADMConfig(
            image_size=8, in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
            attention_resolutions=(2,), channel_mult=(1, 2), num_heads=2,
            use_spatial_transformer=True, transformer_depth=1,
            context_dim=context.shape[-1] if context is not None else 24)
        vae_config = VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4,
                               embed_dim=4, resolution=images.shape[1])
    state = train_latent(
        args.preset, batches(), workdir=args.workdir, unet_config=unet_config,
        vae_config=vae_config, init_model=init_model, parameterization=args.parameterization,
        cond_dropout=args.cond_dropout, lr=args.lr, optimizer=args.optimizer, remat=args.remat,
        max_steps=args.max_steps, log_freq=args.log_freq, snapshot_freq=args.snapshot_freq,
        snapshot_freq_for_preemption=args.snapshot_freq_for_preemption, device=dev)
    print(f"finished at step {int(state.step)}")


def cmd_eval(args):
    from dpm_solver_tpu_torch.configs import get_config
    from dpm_solver_tpu_torch.data import inverse_data_transform, make_dataset, numpy_iterator
    from dpm_solver_tpu_torch.run_lib import (_make_sde, build_model, evaluate,
                                              legacy_loss_fn, uses_legacy_discrete_loss)
    from dpm_solver_tpu_torch.training.train import StepRng

    dev = _device(args)
    config = get_config(args.config, workdir=args.workdir)
    if args.batch_size:
        config = dataclasses.replace(config, eval=dataclasses.replace(
            config.eval, batch_size=args.batch_size))
    if args.bpd_rounds:
        config = dataclasses.replace(config, eval=dataclasses.replace(config.eval,
                                                                      enable_bpd=True))
    model, _ = build_model(config, device=dev)
    model.eval().requires_grad_(False)
    params = dict(model.named_parameters())
    scfg, d = config.sampling, config.data
    n_classes = getattr(config.model_config, "num_classes", None)
    shape = (config.eval.batch_size, d.image_size, d.image_size, d.channels)
    pc = _build_pc_sampler_from_config(config, model) if _uses_pc_sampling(config) else None

    def use_ema(state):
        for k, v in state.ema_params.items():
            params[k].copy_(v)

    @torch.no_grad()
    def sample_fn(state, generator):
        use_ema(state)
        if pc is not None:
            sde, sampler = pc
            out, _ = sampler(sde.prior_sampling(shape, generator=generator, device=dev),
                             generator)
            return inverse_data_transform(d, out)
        # class-conditional nets need labels
        labels = (torch.randint(0, n_classes, (shape[0],), generator=generator, device=dev)
                  if n_classes else None)
        solver, _ = _build_sampler_from_config(config, model, labels=labels)
        x_T = torch.randn(shape, generator=generator, device=dev)
        out = solver.sample(x_T, steps=scfg.steps, t_end=scfg.t_end or 1e-3, order=scfg.order,
                            skip_type=scfg.skip_type, method=scfg.method)
        return inverse_data_transform(d, out)

    feature_fn = None
    if config.eval.inception_ckpt_path:
        from dpm_solver_tpu_torch.eval.inception import make_feature_fn
        from dpm_solver_tpu_torch.utils.convert import load_torch_state_dict

        feature_fn = make_feature_fn(load_torch_state_dict(config.eval.inception_ckpt_path),
                                     device=dev)

    # the loss / bits-per-dim hooks need eval data (ref run_lib.py:253-311):
    # wired when --data-path is given, for continuous score models and the
    # legacy discrete objectives
    loss_fn = bpd_fn = None
    if args.data_path and (config.training.continuous or uses_legacy_discrete_loss(config)):
        images = np.load(args.data_path)["images"]
        ds = make_dataset(images, batch_size=config.eval.batch_size, num_local_devices=1,
                          random_flip=False, centered=config.data.centered,
                          uniform_dequantization=config.training.continuous, shuffle=True)
        data_iter = numpy_iterator(ds)

        def batch():
            b = next(data_iter)
            return torch.from_numpy(np.asarray(b, np.float32)).reshape(
                (-1,) + b.shape[-3:]).to(dev)

        def step_rng(state, generator):
            return StepRng(int(generator.initial_seed()), int(state.step))

        if config.training.continuous:
            from dpm_solver_tpu_torch.likelihood import get_likelihood_fn
            from dpm_solver_tpu_torch.score import get_score_fn
            from dpm_solver_tpu_torch.training.losses import sde_loss_fn

            sde = _make_sde(config)
            score = get_score_fn(sde, lambda x, t: model(x, t), continuous=True)
            loss = sde_loss_fn(sde, score, reduce_mean=config.training.reduce_mean)
            likelihood = get_likelihood_fn(
                sde, score, inverse_scaler_grad=0.5 if config.data.centered else 1.0)

            def bpd_fn(state, generator):
                use_ema(state)
                return likelihood(batch(), generator=generator)[0]
        else:
            loss = legacy_loss_fn(config, model)

        @torch.no_grad()
        def loss_fn(state, generator):
            use_ema(state)
            return loss(batch(), step_rng(state, generator))

    results = evaluate(config, workdir=args.workdir, sample_fn=sample_fn, feature_fn=feature_fn,
                       rounds=args.rounds, loss_fn=loss_fn, bpd_fn=bpd_fn,
                       bpd_rounds=args.bpd_rounds, device=dev)
    print(results)


# --------------------------------------------------------------------------- #
# the latent-diffusion front ends
# --------------------------------------------------------------------------- #


def cmd_txt2img(args):
    from dpm_solver_tpu_torch.models import FrozenCLIPEmbedder
    from dpm_solver_tpu_torch.pipelines import StableDiffusionPipeline, load_sd_checkpoint

    dev = _device(args)
    if args.safety_ckpt and not args.clip:
        raise SystemExit("--safety-ckpt needs --clip (the CLIP vision tower that embeds "
                         "images for the concept screen)")
    text = FrozenCLIPEmbedder(args.clip, device=dev) if args.clip else None
    ldm = load_sd_checkpoint(args.ckpt, text_encode=text, quant=args.quant,
                             compute_dtype=_sd_dtype(dev), device=dev)
    pipe = StableDiffusionPipeline(ldm, device=dev)
    imgs = _host(pipe.txt2img([args.prompt] * args.batch, steps=args.steps,
                              guidance_scale=args.scale, height=args.H, width=args.W,
                              generator=_generator(args.seed), method=args.method))
    if args.safety_ckpt:
        # ref txt2img.py:88-95 check_safety: flagged samples are replaced
        from dpm_solver_tpu_torch.models import FrozenCLIPImageEmbedder
        from dpm_solver_tpu_torch.utils.safety import load_safety_checker

        embed = FrozenCLIPImageEmbedder(args.clip, device=dev)
        checker = load_safety_checker(args.safety_ckpt, lambda x: embed(torch.from_numpy(x)))
        imgs, flags = checker(imgs * 2.0 - 1.0)
        imgs = (imgs + 1.0) / 2.0
        if flags.any():
            print(f"safety checker replaced {int(flags.sum())} sample(s)")
    if args.wm:
        # ref txt2img.py:261-264,325: the invisible watermark on every output
        from dpm_solver_tpu_torch.utils.watermark import put_watermark

        u8 = (imgs * 255).clip(0, 255).astype(np.uint8)
        imgs = np.stack([put_watermark(im, args.wm) for im in u8]) / 255.0
    _save_images(imgs, args.outdir, prefix="txt2img")
    print(f"wrote {args.batch} images to {args.outdir}")


def _load_image(path, *, gray: bool = False) -> np.ndarray:
    """PNG/JPEG/npz -> float array; images map to [-1,1], masks to [0,1]."""
    if path.endswith(".npz"):
        d = np.load(path)
        return np.asarray(d[list(d.keys())[0]], np.float32)
    from PIL import Image

    arr = np.asarray(Image.open(path).convert("L" if gray else "RGB"), np.float32) / 255.0
    return arr[None] if gray else (arr[None] * 2.0 - 1.0)


def _make_sd_pipe(args, dev):
    from dpm_solver_tpu_torch.models import FrozenCLIPEmbedder
    from dpm_solver_tpu_torch.pipelines import StableDiffusionPipeline, load_sd_checkpoint

    text = FrozenCLIPEmbedder(args.clip, device=dev) if args.clip else None
    return StableDiffusionPipeline(
        load_sd_checkpoint(args.ckpt, text_encode=text, compute_dtype=_sd_dtype(dev),
                           device=dev), device=dev)


def cmd_img2img(args):
    dev = _device(args)
    pipe = _make_sd_pipe(args, dev)
    init = torch.from_numpy(np.repeat(_load_image(args.init_img), args.batch, axis=0))
    imgs = pipe.img2img(init, [args.prompt] * args.batch, strength=args.strength,
                        steps=args.steps, guidance_scale=args.scale,
                        generator=_generator(args.seed))
    _save_images(imgs, args.outdir, prefix="img2img")
    print(f"wrote {args.batch} images to {args.outdir}")


def cmd_inpaint(args):
    dev = _device(args)
    pipe = _make_sd_pipe(args, dev)
    init = torch.from_numpy(np.repeat(_load_image(args.init_img), args.batch, axis=0))
    mask = torch.from_numpy(np.repeat((_load_image(args.mask, gray=True) >= 0.5)
                                      .astype(np.float32), args.batch, axis=0))
    imgs = pipe.inpaint(init, mask, [args.prompt] * args.batch, steps=args.steps,
                        guidance_scale=args.scale, generator=_generator(args.seed))
    _save_images(imgs, args.outdir, prefix="inpaint")
    print(f"wrote {args.batch} images to {args.outdir}")


def cmd_knn2img(args):
    """Retrieval-augmented sampling (ref scripts/knn2img.py): CLIP text
    query + k nearest database image embeddings -> RDM -> images."""
    from dpm_solver_tpu_torch.models import FrozenCLIPTextJointEmbedder
    from dpm_solver_tpu_torch.pipelines import load_sd_checkpoint
    from dpm_solver_tpu_torch.pipelines.retrieval import Searcher, knn2img

    dev = _device(args)
    # the rdm_768 preset carries the 768x768.yaml schedule and scale constants
    ldm = load_sd_checkpoint(args.ckpt, preset="rdm_768", parameterization="eps",
                             compute_dtype=_sd_dtype(dev), device=dev)
    text = FrozenCLIPTextJointEmbedder(args.clip, device=dev)
    searcher = Searcher(args.database, device=dev) if args.database else None
    imgs = knn2img(ldm, [args.prompt] * args.batch, text_embedder=text, searcher=searcher,
                   knn=args.knn, steps=args.steps, guidance_scale=args.scale, height=args.H,
                   width=args.W, generator=_generator(args.seed))
    _save_images(imgs, args.outdir, prefix="knn2img")
    print(f"wrote {args.batch} images to {args.outdir}")


def cmd_clscond(args):
    """Class-conditional LDM sampling (ref scripts/sample_diffusion.py)."""
    from dpm_solver_tpu_torch.models import ClassEmbedder
    from dpm_solver_tpu_torch.pipelines import class_conditional_sample, load_sd_checkpoint

    dev = _device(args)
    ldm = load_sd_checkpoint(args.ckpt, preset=args.preset, compute_dtype=_sd_dtype(dev),
                             device=dev)
    labels = np.asarray([int(c) for c in args.classes.split(",")], np.int64)
    embedder = ClassEmbedder(args.num_classes + 1, args.embed_dim, device=dev)
    imgs = class_conditional_sample(
        ldm, embedder, labels, steps=args.steps, guidance_scale=args.scale,
        uncond_label=args.num_classes if args.scale != 1.0 else None,
        generator=_generator(args.seed))
    _save_images(imgs, args.outdir, prefix="clscond")
    print(f"wrote {len(labels)} images to {args.outdir}")


def cmd_fid(args):
    from dpm_solver_tpu_torch.eval.fid import calculate_fid_given_paths
    from dpm_solver_tpu_torch.eval.inception import make_feature_fn
    from dpm_solver_tpu_torch.utils.convert import load_torch_state_dict

    dev = _device(args)
    feature_fn = make_feature_fn(load_torch_state_dict(args.inception_ckpt), device=dev)
    print(calculate_fid_given_paths(args.paths, feature_fn, batch_size=args.batch_size))


def cmd_wmdecode(args):
    from PIL import Image

    from dpm_solver_tpu_torch.utils.watermark import decode_watermark_text

    arr = np.asarray(Image.open(args.image).convert("RGB"), np.uint8)
    print(decode_watermark_text(arr, args.bits) or "null")


def cmd_configs(args):
    from dpm_solver_tpu_torch.configs import list_configs

    print("\n".join(list_configs()))


# --------------------------------------------------------------------------- #
# the parser
# --------------------------------------------------------------------------- #


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dpm_solver_tpu_torch")
    p.add_argument("--device", default="cuda",
                   help="where the networks run: 'cuda' (the card, the default; raises "
                        "without one) or 'cpu'")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("sample", help="DPM-Solver sampling from a config")
    sp.add_argument("--config", required=True)
    sp.add_argument("--ckpt", default=None, help="torch checkpoint to convert")
    sp.add_argument("--classifier-ckpt", default=None,
                    help="torch classifier checkpoint for guided configs")
    sp.add_argument("--batch", type=int, default=16)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--outdir", default="./samples")
    sp.add_argument("--base-samples", default=None,
                    help="npz of low-res images (arr_0 [+labels arr_1]) for SuperRes "
                         "upsampling runs")
    sp.add_argument("--mode", choices=("fid", "sequence", "interpolation"), default="fid",
                    help="fid: iid batch; sequence: save per-step trajectory; "
                         "interpolation: slerp grid between two noise draws (ref runner modes)")
    sp.add_argument("--steps", type=int, default=None, help="override the config's NFE budget")
    sp.add_argument("--order", type=int, default=None)
    sp.add_argument("--method", default=None,
                    choices=("multistep", "singlestep", "singlestep_fixed", "adaptive", "unipc"),
                    help="override the config's solver method (unipc = predictor-corrector, "
                         "beyond the reference)")
    sp.add_argument("--devices", type=int, default=None,
                    help="shard the batch over the first N visible devices; only 1 (the "
                         "default, one device) is ported: N > 1 raises until the mesh lands")
    sp.add_argument("--trace-dir", default=None,
                    help="write a torch.profiler trace of one warm sampling call into this "
                         "directory (trace.json and ops.txt; the warm-up runs outside it)")
    sp.set_defaults(fn=cmd_sample)

    tp = sub.add_parser("train")
    tp.add_argument("--config", required=True)
    tp.add_argument("--workdir", default="./workdir")
    tp.add_argument("--data-path", default=None)
    tp.add_argument("--max-steps", type=int, default=None)
    tp.add_argument("--batch-size", type=int, default=None,
                    help="override the config's training batch size")
    tp.set_defaults(fn=cmd_train)

    ta = sub.add_parser("train-ae", help="first-stage autoencoder training "
                                         "(LPIPS + PatchGAN adversarial loop)")
    ta.add_argument("--kind", default="kl", choices=("kl", "vq"))
    ta.add_argument("--workdir", default="./workdir")
    ta.add_argument("--data-path", required=True,
                    help="npz/npy with 'images' [N,H,W,3] (uint8 or [-1,1] float)")
    ta.add_argument("--tiny", action="store_true", help="shrunken geometry (hermetic smoke)")
    ta.add_argument("--batch-size", type=int, default=4)
    ta.add_argument("--max-steps", type=int, default=1000)
    ta.add_argument("--lr", type=float, default=4.5e-6)
    ta.add_argument("--disc-start", type=int, default=50_001)
    ta.add_argument("--disc-ndf", type=int, default=64)
    ta.add_argument("--disc-n-layers", type=int, default=3)
    ta.add_argument("--perceptual-weight", type=float, default=1.0)
    ta.add_argument("--lpips-ckpt", default=None, help="torch LPIPS/VGG state dict to load")
    ta.add_argument("--image-freq", type=int, default=0,
                    help="dump input|recon grids every N steps")
    ta.add_argument("--log-freq", type=int, default=50)
    ta.add_argument("--snapshot-freq", type=int, default=10_000)
    ta.add_argument("--snapshot-freq-for-preemption", type=int, default=1_000)
    ta.set_defaults(fn=cmd_train_ae)

    tl = sub.add_parser("train-latent", help="latent-diffusion training: frozen first stage, "
                                             "UNet trains (LDM p_losses)")
    tl.add_argument("--preset", default="sd_v1", choices=("sd_v1", "sd_v2_1", "cin256", "rdm_768"))
    tl.add_argument("--workdir", default="./workdir")
    tl.add_argument("--data-path", required=True,
                    help="npz with 'images' [N,H,W,3] (uint8 or [-1,1] float) and optional "
                         "'context' [N,L,D]")
    tl.add_argument("--sd-ckpt", default=None,
                    help="CompVis checkpoint to fine-tune from (UNet init + frozen first "
                         "stage + schedule)")
    tl.add_argument("--tiny", action="store_true",
                    help="shrunken random-init geometry (hermetic smoke)")
    tl.add_argument("--batch-size", type=int, default=4)
    tl.add_argument("--max-steps", type=int, default=1000)
    tl.add_argument("--lr", type=float, default=1e-4)
    tl.add_argument("--cond-dropout", type=float, default=0.0)
    tl.add_argument("--parameterization", default=None, choices=("eps", "x0", "v"))
    tl.add_argument("--optimizer", default="adam", choices=("adam", "adafactor"),
                    help="adafactor = the one-chip full-size-SD recipe (no 2x-params Adam "
                         "states)")
    tl.add_argument("--remat", action="store_true",
                    help="per-block UNet rematerialization (bounds backward activation "
                         "memory)")
    tl.add_argument("--log-freq", type=int, default=50)
    tl.add_argument("--snapshot-freq", type=int, default=10_000)
    tl.add_argument("--snapshot-freq-for-preemption", type=int, default=1_000)
    tl.set_defaults(fn=cmd_train_latent)

    ep = sub.add_parser("eval")
    ep.add_argument("--config", required=True)
    ep.add_argument("--workdir", default="./workdir")
    ep.add_argument("--rounds", type=int, default=None)
    ep.add_argument("--data-path", default=None,
                    help="npz with 'images' for eval loss / bits-per-dim")
    ep.add_argument("--bpd-rounds", type=int, default=0)
    ep.add_argument("--batch-size", type=int, default=None,
                    help="override the config's eval batch size")
    ep.set_defaults(fn=cmd_eval)

    xp = sub.add_parser("txt2img")
    xp.add_argument("--ckpt", required=True)
    xp.add_argument("--prompt", required=True)
    xp.add_argument("--clip", default=None, help="local CLIP checkpoint dir")
    xp.add_argument("--steps", type=int, default=25)
    xp.add_argument("--scale", type=float, default=7.5)
    xp.add_argument("--H", type=int, default=512)
    xp.add_argument("--W", type=int, default=512)
    xp.add_argument("--batch", type=int, default=1)
    xp.add_argument("--seed", type=int, default=42)
    xp.add_argument("--outdir", default="./outputs")
    xp.add_argument("--wm", default="StableDiffusionV1",
                    help="invisible watermark payload ('' disables)")
    xp.add_argument("--safety-ckpt", default=None, help="local safety-checker torch checkpoint")
    xp.add_argument("--method", default="multistep", choices=("multistep", "singlestep", "unipc"))
    xp.add_argument("--quant", default=None, choices=("w8a8", "w8a8_conv"),
                    help="int8 dynamic-quantized serving path: transformer stack, or "
                         "transformer + conv trunk (ops/quant.py)")
    xp.set_defaults(fn=cmd_txt2img)

    for name, fn, extra in (("img2img", cmd_img2img, "--strength"),
                            ("inpaint", cmd_inpaint, "--mask")):
        gp = sub.add_parser(name)
        gp.add_argument("--ckpt", required=True)
        gp.add_argument("--init-img", required=True, help="input image (png/jpg/npz)")
        if extra == "--mask":
            gp.add_argument("--mask", required=True, help="mask image, white = regenerate")
        else:
            gp.add_argument("--strength", type=float, default=0.75)
        gp.add_argument("--prompt", required=True)
        gp.add_argument("--clip", default=None)
        gp.add_argument("--steps", type=int, default=25)
        gp.add_argument("--scale", type=float, default=7.5)
        gp.add_argument("--batch", type=int, default=1)
        gp.add_argument("--seed", type=int, default=42)
        gp.add_argument("--outdir", default="./outputs")
        gp.set_defaults(fn=fn)

    kp = sub.add_parser("knn2img", help="retrieval-augmented sampling")
    kp.add_argument("--ckpt", required=True, help="RDM checkpoint")
    kp.add_argument("--prompt", required=True)
    kp.add_argument("--clip", default="openai/clip-vit-large-patch14",
                    help="local CLIP checkpoint dir (joint-space embedder)")
    kp.add_argument("--database", default=None,
                    help=".npz embedding database (file or shard dir); omit for text-only "
                         "conditioning")
    kp.add_argument("--knn", type=int, default=10)
    kp.add_argument("--steps", type=int, default=50)
    kp.add_argument("--scale", type=float, default=5.0)
    kp.add_argument("--H", type=int, default=768)
    kp.add_argument("--W", type=int, default=768)
    kp.add_argument("--batch", type=int, default=3)
    kp.add_argument("--seed", type=int, default=42)
    kp.add_argument("--outdir", default="./outputs")
    kp.set_defaults(fn=cmd_knn2img)

    cp = sub.add_parser("clscond", help="class-conditional LDM sampling")
    cp.add_argument("--ckpt", required=True)
    cp.add_argument("--classes", required=True, help="comma-separated class ids, one image each")
    cp.add_argument("--preset", default="cin256",
                    help="checkpoint geometry preset (cin256 | sd_v1 | ...)")
    cp.add_argument("--num-classes", type=int, default=1000)
    cp.add_argument("--embed-dim", type=int, default=512)
    cp.add_argument("--steps", type=int, default=20)
    cp.add_argument("--scale", type=float, default=1.5)
    cp.add_argument("--seed", type=int, default=42)
    cp.add_argument("--outdir", default="./outputs")
    cp.set_defaults(fn=cmd_clscond)

    fp = sub.add_parser("fid", help="FID between two sample sources "
                                    "(image folder / images npz / stats npz)")
    fp.add_argument("paths", nargs=2)
    fp.add_argument("--inception-ckpt", required=True,
                    help="local torch FID-InceptionV3 checkpoint")
    fp.add_argument("--batch-size", type=int, default=50)
    fp.set_defaults(fn=cmd_fid)

    wd = sub.add_parser("wmdecode", help="decode an invisible watermark from an image "
                                         "(ref scripts/tests/test_watermark.py)")
    wd.add_argument("image")
    wd.add_argument("--bits", type=int, default=136)
    wd.set_defaults(fn=cmd_wmdecode)

    lp = sub.add_parser("configs", help="list registered configs")
    lp.set_defaults(fn=cmd_configs)
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
