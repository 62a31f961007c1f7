"""Entry points of the port: a one-device forward check, and the multi-rank dry runs.

Port of `__graft_entry__.py`:

- `entry()`: the full-size CIFAR-10 DDPM UNet forward in bf16 (35.7M
  parameters), on the card unless asked otherwise -> (fn, example_args);
- `dryrun_multichip(n)`: on `n` gloo ranks on the CPU (the JAX function's
  virtual CPU mesh), once each at tiny shapes: a data-parallel train step, a
  sharded sampling trajectory, a ZeRO-1 step whose moments must be sharded,
  the adversarial first-stage step, data-parallel; and at n >= 4, on a
  (2, n/2) (data, model) mesh, a tensor-parallel SD-UNet forward, a
  tensor-parallel train step whose `to_q` must be sharded, and a
  tensor-parallel 20-NFE trajectory. Each stage prints a `[dryrun]` line;
- `dryrun_multihost(n)`: `n` gloo processes running
  `parallel.multihost._smoke_worker`, each printing `MULTIHOST_OK {pid}`.

    python -m dpm_solver_tpu_torch.dryrun [--device cpu]

runs the two dry runs, then `entry()` on `--device` (the card by default).
"""

from __future__ import annotations

import argparse
from typing import List

import numpy as np
import torch

from dpm_solver_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


def entry(device=DEFAULT_DEVICE):
    """The forward step of the flagship model (full-size CIFAR-10 DDPM UNet,
    bf16 activations, seeded random weights) -> (fn, example_args)."""
    from dpm_solver_tpu_torch.models import DDPMUNet, DDPMUNetConfig, init_random_

    dev = resolve_device(device)
    model = DDPMUNet(DDPMUNetConfig.cifar10(), compute_dtype=torch.bfloat16, device=dev)
    init_random_(model, torch.Generator(device=dev).manual_seed(0)).eval()

    @torch.no_grad()
    def fn(x, t):
        return model(x, t)

    example_args = (
        torch.from_numpy(np.random.default_rng(0).standard_normal((8, 32, 32, 3))
                         .astype(np.float32)).to(dev),
        torch.linspace(1.0, 999.0, 8, device=dev),
    )
    return fn, example_args


def _seeded(module, seed: int):
    from dpm_solver_tpu_torch.models import init_random_

    return init_random_(module, torch.Generator().manual_seed(seed))


def _multichip_rank(rank: int, world: int) -> List[str]:
    """One rank of `dryrun_multichip`; returns rank 0's `[dryrun]` lines."""
    import dpm_solver_tpu_torch as P
    from dpm_solver_tpu_torch.models import DDPMUNet, DDPMUNetConfig
    from dpm_solver_tpu_torch.parallel import (batch_sharding, make_mesh, make_sharded_sampler,
                                               sample_noise)
    from dpm_solver_tpu_torch.parallel.zero import shard_train_step
    from dpm_solver_tpu_torch.training.losses import ema_swapped
    from dpm_solver_tpu_torch.training.optim import Adam
    from dpm_solver_tpu_torch.training.train import make_train_state, make_train_step

    lines = []

    def say(msg):
        if rank == 0:
            lines.append(f"[dryrun] {msg}")

    mesh = make_mesh(world, device="cpu")
    say(f"mesh over {world} ranks: {mesh}")
    net = _seeded(DDPMUNet(DDPMUNetConfig.tiny(resolution=16), device="cpu"), 0)
    ns = P.NoiseScheduleVP("discrete", betas=torch.linspace(1e-4, 0.02, 1000))
    apply = lambda x, t: net(x, t)

    # --- training step: batch sharded over the mesh, params replicated ---
    tx = Adam(1e-4, grad_clip=None)
    state, _ = make_train_state(net, tx=tx)
    step = make_train_step(apply, ns, tx, mesh=mesh)
    x0 = sample_noise(1, (2 * world, 16, 16, 3))
    state, metrics = step(state, x0, 2)
    assert np.isfinite(float(metrics["loss"])) and state.step == 1
    say(f"DP train step ok (loss={float(metrics['loss']):.4f})")

    # --- full sampling trajectory on the EMA, batch sharded ---
    with torch.no_grad(), ema_swapped(state):
        fn = P.build_sampler(P.model_wrapper(apply, ns), ns, steps=4, order=2,
                             method="multistep")
        x_T = sample_noise(3, (2 * world, 16, 16, 3))
        out = make_sharded_sampler(fn, mesh)(x_T)
    assert out.shape == x_T.shape and torch.isfinite(out).all()
    say(f"sharded sampling trajectory ok {tuple(out.shape)}")

    # --- ZeRO-1: the same step, the Adam moments sharded over the data axis ---
    z_step, z_state, _ = shard_train_step(make_train_step(apply, ns, tx, mesh=mesh), mesh,
                                          state, tx)
    z_state, z_metrics = z_step(z_state, x0, 10)
    assert np.isfinite(float(z_metrics["loss"]))
    big = [(k, m) for key in ("mu", "nu") for k, m in z_state.opt_state[key].items()
           if z_state.params[k].numel() >= 4096
           and any(s % world == 0 for s in z_state.params[k].shape)]
    assert big and all(m.numel() < z_state.params[k].numel() for k, m in big), \
        "optimizer state failed to shard"
    say(f"ZeRO-1 step ok ({len(big)} sharded moment tensors)")

    # --- first-stage adversarial step (LPIPS + PatchGAN, two optimizers),
    # batch sharded over the mesh ---
    from dpm_solver_tpu_torch.models.discriminator import NLayerDiscriminator
    from dpm_solver_tpu_torch.models.lpips import LPIPS
    from dpm_solver_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from dpm_solver_tpu_torch.training import perceptual as PL
    from dpm_solver_tpu_torch.training.autoencoder import (bind_autoencoder,
                                                           make_adversarial_state,
                                                           make_kl_train_step)

    vae = _seeded(AutoencoderKL(VAEConfig.tiny(resolution=16, attn_resolutions=()),
                                device="cpu"), 6)
    disc = _seeded(NLayerDiscriminator(ndf=8, n_layers=2, device="cpu"), 7)
    lp = _seeded(LPIPS(device="cpu"), 8)
    imgs = sample_noise(5, (2 * world, 16, 16, 3))
    ae_state, ae_tx = make_adversarial_state(vae, disc, lr=1e-4)
    ae_step = make_kl_train_step(PL.KLLossConfig(disc_start=0, perceptual_weight=0.5),
                                 tx=ae_tx, mesh=mesh, **bind_autoencoder(vae, disc, lp))
    ae_state, ae_logs = ae_step(ae_state, imgs, 9)
    assert ae_state.step == 1 and all(np.isfinite(float(v)) for v in ae_logs.values())
    say(f"adversarial first-stage step ok ({sorted(ae_logs)})")

    # --- tensor parallelism: an SD-style cross-attention UNet over a 2-D
    # (data, model) mesh, Megatron column/row sharding ---
    if world >= 4:
        from dpm_solver_tpu_torch.models import ADMConfig, ADMUNet
        from dpm_solver_tpu_torch.parallel.tp import make_tp_fn, make_tp_mesh

        sd_cfg = ADMConfig(image_size=8, in_channels=4, model_channels=32, out_channels=4,
                           num_res_blocks=1, attention_resolutions=(1, 2), channel_mult=(1, 2),
                           num_heads=2, use_spatial_transformer=True, transformer_depth=1,
                           context_dim=24)
        sd_unet = _seeded(ADMUNet(sd_cfg, device="cpu"), 4)
        bsz = 2 * world
        ctx = torch.zeros(bsz, 7, 24)
        tt = torch.linspace(1.0, 999.0, bsz)
        tp_mesh = make_tp_mesh(world, data=2, model=world // 2, device="cpu")
        tp_fn, sd_unet = make_tp_fn(lambda m, x, t, c: m(x, t, None, c), tp_mesh, sd_unet)
        with torch.no_grad():
            out_tp = tp_fn(torch.zeros(bsz, 8, 8, 4), tt, ctx)
        assert torch.isfinite(out_tp).all()
        say(f"TP SD-UNet forward ok on {tp_mesh}")

        # --- TP training step: the sharded slices trained in place ---
        data = batch_sharding(tp_mesh)
        ctx_local = data.local(ctx)
        tp_state, _ = make_train_state(sd_unet, tx=tx)
        tp_step = make_train_step(lambda x, t: sd_unet(x, t, None, ctx_local), ns, tx,
                                  mesh=tp_mesh)
        x0_tp = torch.from_numpy(np.random.default_rng(11).standard_normal(
            (bsz, 8, 8, 4)).astype(np.float32))
        tp_state, tp_metrics = tp_step(tp_state, x0_tp, 12)
        assert np.isfinite(float(tp_metrics["loss"]))
        q = tp_state.params["input_blocks.1.1.transformer_blocks.0.attn1.to_q.weight"]
        assert q.shape[0] == 32 // (world // 2), q.shape
        say(f"TP train step ok (loss={float(tp_metrics['loss']):.4f}, to_q weight sharded "
            f"{tuple(q.shape)} of (32, 32))")

        # --- TP-sharded 20-NFE trajectory: the data axis splits the batch
        # (the context with it), the model axis every transformer projection ---
        def tp_traj(x, noise, c):
            model_fn = P.model_wrapper(lambda u, t: sd_unet(u, t, None, c), ns)
            return P.build_sampler(model_fn, ns, steps=20, order=2, method="multistep")(x)

        x_T_tp = torch.from_numpy(np.random.default_rng(13).standard_normal(
            (bsz, 8, 8, 4)).astype(np.float32))
        with torch.no_grad(), ema_swapped(tp_state):
            out_traj = make_sharded_sampler(tp_traj, tp_mesh)(x_T_tp, None, ctx)
        assert out_traj.shape == x_T_tp.shape and torch.isfinite(out_traj).all()
        say(f"TP 20-NFE sampling trajectory ok {tuple(out_traj.shape)} on {tp_mesh}")
    return lines


def dryrun_multichip(n_devices: int) -> None:
    """The JAX dry run's stages on `n_devices` gloo ranks on the CPU; prints
    rank 0's `[dryrun]` lines."""
    from dpm_solver_tpu_torch.parallel.launch import run_ranks

    for line in run_ranks(_multichip_rank, n_devices, threads=1)[0]:
        print(line, flush=True)


def dryrun_multihost(n_processes: int = 2) -> None:
    """`n_processes` gloo processes, each running the multihost helpers'
    smoke (`parallel.multihost._smoke_worker`)."""
    from dpm_solver_tpu_torch.parallel.launch import run_ranks
    from dpm_solver_tpu_torch.parallel.multihost import _smoke_worker

    lines = run_ranks(_smoke_worker, n_processes, threads=1)
    for pid, line in enumerate(lines):
        assert line == f"MULTIHOST_OK {pid}", (pid, line)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=DEFAULT_DEVICE,
                        help="where entry() runs (the dry runs are gloo ranks on the CPU)")
    args = parser.parse_args(argv)
    dryrun_multichip(8)
    print("dryrun_multichip ok")
    dryrun_multihost(2)
    print("dryrun_multihost ok")
    fn, example_args = entry(args.device)
    y = fn(*example_args)
    print("entry ok:", tuple(y.shape), y.dtype)


if __name__ == "__main__":
    main()
