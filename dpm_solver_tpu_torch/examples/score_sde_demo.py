"""Score-SDE demo: PC sampling vs DPM-Solver vs likelihood on one model.

Port of `examples/score_sde_demo.py`, the script twin of the reference's
Score_SDE_demo notebook (examples/score_sde_pytorch/Score_SDE_demo_PyTorch.ipynb):
load a score model, draw samples with the predictor-corrector sampler and
with DPM-Solver, and report bits/dim.

With no --ckpt this runs a tiny random-weight NCSN++, so the whole flow runs
anywhere (the samples are noise, but every stage executes); pass a
score_sde_pytorch checkpoint (.pth, the DDPM++ deep continuous VP) for real
samples.

Run: python -m dpm_solver_tpu_torch.examples.score_sde_demo [--ckpt ckpt.pth]
         [--outdir demo_out] [--device cpu]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    from dpm_solver_tpu_torch.examples._common import add_device_flag, save_png, seeded

    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", default=None,
                   help="score_sde_pytorch checkpoint (.pth); random tiny model if omitted")
    p.add_argument("--outdir", default="./demo_out")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--steps", type=int, default=10)
    add_device_flag(p)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from dpm_solver_tpu_torch import NoiseScheduleVP, build_sampler, model_wrapper
    from dpm_solver_tpu_torch.likelihood import get_likelihood_fn
    from dpm_solver_tpu_torch.models import NCSNpp, NCSNppConfig
    from dpm_solver_tpu_torch.samplers import get_pc_sampler
    from dpm_solver_tpu_torch.score import get_score_fn
    from dpm_solver_tpu_torch.sde import VPSDE
    from dpm_solver_tpu_torch.utils.device import resolve_device
    from dpm_solver_tpu_torch.utils.logging import image_grid

    dev = resolve_device(args.device)
    if args.ckpt:
        from dpm_solver_tpu_torch.cli import load_score_sde_torch_checkpoint

        cfg = NCSNppConfig.cifar10_ddpmpp(deep=True)
        model = NCSNpp(cfg, device=dev).eval()
        model.load_state_dict(load_score_sde_torch_checkpoint(args.ckpt, cfg))
    else:
        print("no --ckpt: tiny random-weight model (structure demo only)")
        cfg = NCSNppConfig.tiny()
        model = seeded(NCSNpp(cfg, device=dev), 0)

    sde = VPSDE()
    score_fn = get_score_fn(sde, model, continuous=True)
    shape = (args.batch, cfg.image_size, cfg.image_size, 3)
    gen = torch.Generator(device=dev).manual_seed(42)

    with torch.no_grad():
        # --- cell: PC sampling (reverse-diffusion predictor + Langevin) ---
        pc = get_pc_sampler(sde, score_fn, predictor="reverse_diffusion", corrector="langevin",
                            snr=0.16)
        x_pc, nfe = pc(sde.prior_sampling(shape, generator=gen, device=dev), generator=gen)
        print(f"PC sampler: {int(nfe)} NFE")

        # --- cell: DPM-Solver sampling (10 NFE vs PC's hundreds) ---
        # continuous-VP noise labels are t*999 (ref models/utils.py:164)
        ns = NoiseScheduleVP.linear(sde.beta_0, sde.beta_1)
        model_fn = model_wrapper(lambda x, t: model(x, t * 999.0), ns, model_type="noise")
        fn = build_sampler(model_fn, ns, steps=args.steps, order=3, method="singlestep",
                           skip_type="logSNR", t_end=1e-3)
        x_dpm = fn(torch.randn(shape, generator=gen, device=dev))
        print(f"DPM-Solver: {args.steps} NFE")

    # --- cell: likelihood (bits/dim via Hutchinson + RK45) ---
    # data is centred in [-1, 1]: the inverse scaler's gradient is 0.5
    lf = get_likelihood_fn(sde, score_fn, inverse_scaler_grad=0.5)
    bpd = lf(torch.clamp((x_dpm + 1.0) / 2.0, 0.0, 1.0) * 2.0 - 1.0, generator=gen)[0]
    print(f"bits/dim of the DPM samples: {float(bpd.mean()):.3f}")

    os.makedirs(args.outdir, exist_ok=True)
    for name, x in (("pc", x_pc), ("dpm", x_dpm)):
        grid = image_grid(np.clip((x.float().cpu().numpy() + 1.0) / 2.0, 0, 1))
        path = os.path.join(args.outdir, f"demo_{name}.png")
        save_png(grid, path)
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
