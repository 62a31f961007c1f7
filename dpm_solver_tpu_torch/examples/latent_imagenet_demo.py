"""Class-conditional latent-diffusion demo (ImageNet cin256 style).

Port of `examples/latent_imagenet_demo.py`, the script twin of the reference
notebook (examples/stable-diffusion/scripts/latent_imagenet_diffusion.ipynb):
embed a handful of class labels, sample the conditional LDM with
classifier-free guidance through DPM-Solver++, decode with the first stage,
save a grid.

With no --ckpt a tiny random-weight bundle runs the whole flow; pass a
CompVis cin256 checkpoint (and its embed dim and class count) for real
samples: its class embeddings (`cond_stage_model.embedding.weight`) condition
the samples, where the JAX demo draws a fresh random table.

Run: python -m dpm_solver_tpu_torch.examples.latent_imagenet_demo \
         --classes 25,187,448,992 [--device cpu]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    from dpm_solver_tpu_torch.examples._common import add_device_flag, save_png, tiny_sd_bundle

    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", default=None, help="CompVis LDM checkpoint")
    p.add_argument("--classes", default="25,187,448,992")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--scale", type=float, default=3.0)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--embed-dim", type=int, default=512)
    p.add_argument("--outdir", default="./demo_out")
    add_device_flag(p)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from dpm_solver_tpu_torch.models import ClassEmbedder
    from dpm_solver_tpu_torch.pipelines import class_conditional_sample, load_sd_checkpoint
    from dpm_solver_tpu_torch.utils.convert import load_torch_state_dict
    from dpm_solver_tpu_torch.utils.device import resolve_device
    from dpm_solver_tpu_torch.utils.logging import image_grid

    dev = resolve_device(args.device)
    labels = np.asarray([int(c) for c in args.classes.split(",")])
    table = None
    if args.ckpt:
        # the cin256 preset: the VQ-f4 first stage, the 192-channel
        # cross-attention UNet and the 0.0015..0.0195 schedule
        # (configs/latent-diffusion/cin256-v2.yaml)
        sd = load_torch_state_dict(args.ckpt)
        # bf16 on the card, fp32 on the CPU, as the CLI's latent subcommands
        ldm = load_sd_checkpoint(sd, preset="cin256", device=dev,
                                 compute_dtype=torch.bfloat16 if dev.type == "cuda"
                                 else torch.float32)
        embed_dim = args.embed_dim
        # the trained class embeddings: the conditioner's table in the checkpoint
        table = sd.get("cond_stage_model.embedding.weight")
        if table is not None and tuple(table.shape) != (args.num_classes + 1, embed_dim):
            raise ValueError(f"the checkpoint's class embedding is {tuple(table.shape)}, not "
                             f"(--num-classes + 1, --embed-dim) = "
                             f"{(args.num_classes + 1, embed_dim)}")
        del sd
    else:
        print("no --ckpt: tiny random-weight bundle (structure demo only)")
        embed_dim = 16
        ldm = tiny_sd_bundle(dev, embed_dim)
    # the cin256 convention: class id n_classes is the unconditional token
    embedder = ClassEmbedder(args.num_classes + 1, embed_dim, device=dev,
                             embedding=None if table is None else table.float().numpy())
    with torch.no_grad():
        imgs = class_conditional_sample(ldm, embedder, labels, steps=args.steps,
                                        guidance_scale=args.scale, uncond_label=args.num_classes,
                                        generator=torch.Generator().manual_seed(7))
    grid = image_grid(imgs.float().cpu().numpy())
    path = os.path.join(args.outdir, "demo_clscond.png")
    save_png(grid, path)
    print(f"wrote {path} (classes {labels.tolist()})")


if __name__ == "__main__":
    main()
