"""DiffEdit demo: mask-free prompt-to-prompt image editing.

Port of `examples/diffedit_demo.py`, the script twin of the reference
notebook (examples/stable-diffusion/scripts/diffedit_inpaint.ipynb): estimate
the edit mask from the noise-prediction disagreement between the source and
target prompts (cell 4), encode the image (stochastic or deterministic ODE
inversion), then resample with the masked `correcting_xt_fn` blend
(cells 5-13).

With no --ckpt a tiny random-weight SD-shaped bundle runs the whole flow on a
synthetic image (at the UNet's own size: 512 px for SD-1, where the JAX demo
takes the first stage's 256 px training crop); pass an SD checkpoint and a
CLIP directory for real edits.

Run: python -m dpm_solver_tpu_torch.examples.diffedit_demo --src "a bowl of apples" \
         --dst "a bowl of oranges" [--init-img img.png] [--device cpu]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    from dpm_solver_tpu_torch.examples._common import add_device_flag, save_png, tiny_sd_bundle

    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", default=None)
    p.add_argument("--clip", default=None, help="local CLIP dir")
    p.add_argument("--init-img", default=None, help="png/jpg to edit")
    p.add_argument("--src", default="a photograph")
    p.add_argument("--dst", default="an oil painting")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--encode", choices=("stochastic", "deterministic"), default="stochastic")
    p.add_argument("--outdir", default="./demo_out")
    add_device_flag(p)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from dpm_solver_tpu_torch.models import FrozenCLIPEmbedder, constant_context_encoder
    from dpm_solver_tpu_torch.pipelines import diffedit, load_sd_checkpoint
    from dpm_solver_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if args.ckpt:
        text = FrozenCLIPEmbedder(args.clip, device=dev) if args.clip else None
        # bf16 on the card, fp32 on the CPU, as the CLI's latent subcommands
        ldm = load_sd_checkpoint(args.ckpt, text_encode=text, device=dev,
                                 compute_dtype=torch.bfloat16 if dev.type == "cuda"
                                 else torch.float32)
    else:
        print("no --ckpt: tiny random-weight bundle (structure demo only)")
        ldm = tiny_sd_bundle(dev, 16, text_encode=constant_context_encoder(16))

    if args.init_img:
        from PIL import Image

        arr = np.asarray(Image.open(args.init_img).convert("RGB"), np.float32) / 255.0
        init = arr[None] * 2.0 - 1.0
    else:
        # a synthetic image at the UNet's own size (SD-1: 64x64 latents, 512 px);
        # the first stage's config resolution (256 for SD's) is its training crop
        r = ldm.unet.config.image_size * 2 ** (len(ldm.vae.config.ch_mult) - 1)
        yy, xx = np.mgrid[0:r, 0:r].astype(np.float32) / r
        init = np.stack([np.sin(7 * yy), np.cos(5 * xx), yy * xx], -1)[None] * 0.8
    init = torch.from_numpy(np.ascontiguousarray(init, np.float32)).to(dev)
    with torch.no_grad():
        edited, mask = diffedit(ldm, init, args.src, args.dst, steps=args.steps,
                                encode_type=args.encode,
                                generator=torch.Generator().manual_seed(3), return_mask=True)

    pairs = {"original": np.clip((init.cpu().numpy() + 1.0) / 2.0, 0, 1)[0],
             "edited": np.clip(edited.float().cpu().numpy(), 0, 1)[0]}
    for name, im in pairs.items():
        path = os.path.join(args.outdir, f"diffedit_{name}.png")
        save_png(im, path)
        print(f"wrote {path}")
    m = mask.float().cpu().numpy()
    m = m.reshape(m.shape[-3:-1]) if m.ndim >= 3 else m
    save_png(m, os.path.join(args.outdir, "diffedit_mask.png"))
    print(f"mask covers {float(m.mean()):.1%} of latents")


if __name__ == "__main__":
    main()
