"""First-stage (AutoencoderKL / VQModel) adversarial training.

Port of `dpm_solver_tpu/training/autoencoder.py`, the twin of the
reference's two-optimizer loop (ldm/models/autoencoder.py: `training_step`
branching on optimizer_idx; `configure_optimizers`: one Adam for the
encoder, decoder and logvar and one for the discriminator, the same lr,
betas (0.5, 0.9)) over the losses of `training/perceptual.py`.

One step runs both optimiser passes, in the JAX step's order:
  1. the forward once, split at the decoder's final conv (`forward_trunk`);
  2. the generator loss (the discriminator's BatchNorm statistics frozen:
     the pass's new ones are dropped) and its update;
  3. the discriminator update on the detached reconstruction, with the
     discriminator's parameters and `state.step` as they were before the
     step, its statistics threaded real -> fake.

As in the port's other steps (`training/train.py`), the state holds the
modules' own tensors and the step updates them in place: `gen_params` the
autoencoder's parameters (`ae.<name>`) and `logvar`, `disc_params` and
`disc_batch_stats` the discriminator's parameters and running moments. The
posterior noise is drawn from `StepRng(seed, state.step)`, or passed in
(`noise=`), which the CPU tests use to feed the JAX step's own draws.

With a `mesh` a step is data-parallel over its data axis: it takes the
global batch, draws the posterior noise for it, runs this rank's rows, and
averages both passes' gradients over the axis before each optimiser (an
explicit all-reduce: the passes take `torch.autograd.grad`). As under the
reference's own DistributedDataParallel training, the adaptive
discriminator weight and the discriminator's BatchNorm statistics are each
rank's (GSPMD computes them over the global batch).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from dpm_solver_tpu_torch.training import perceptual as P
from dpm_solver_tpu_torch.training.optim import Adam
from dpm_solver_tpu_torch.training.train import StepRng, data_parallel

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class AdversarialTrainState:
    """The generator's (autoencoder + logvar) and the discriminator's
    optimisation state: step (a host int), gen_params ({"ae.<name>": the
    autoencoder's own parameter, "logvar": a 0-d fp32 parameter}), gen_opt,
    disc_params, disc_batch_stats (the discriminator's own running-moment
    buffers, empty for ActNorm), disc_opt."""

    step: int
    gen_params: Params
    gen_opt: dict
    disc_params: Params
    disc_batch_stats: Params
    disc_opt: dict


def make_adversarial_state(ae: nn.Module, discriminator: nn.Module, *, lr: float = 4.5e-6,
                           logvar_init: float = 0.0, tx: Optional[Adam] = None
                           ) -> Tuple[AdversarialTrainState, Adam]:
    """`AutoencoderKL.configure_optimizers`: two Adams with the same lr and
    betas (0.5, 0.9), no clip (optax.adam(lr, b1=0.5, b2=0.9)), over the
    modules' own parameters."""
    tx = Adam(lr, grad_clip=None, b1=0.5, b2=0.9) if tx is None else tx
    p0 = next(ae.parameters())
    logvar = nn.Parameter(torch.tensor(float(logvar_init), device=p0.device))
    gen = {f"ae.{k}": p for k, p in ae.named_parameters()}
    gen["logvar"] = logvar
    disc = dict(discriminator.named_parameters())
    state = AdversarialTrainState(step=0, gen_params=gen, gen_opt=tx.init(gen), disc_params=disc,
                                  disc_batch_stats=discriminator.batch_stats(),
                                  disc_opt=tx.init(disc))
    return state, tx


def _grads(loss: torch.Tensor, params: Params, group=None) -> Params:
    """d loss / d params, zeros where a parameter does not reach the loss
    (the VQ model's logvar, as under jax.grad); averaged over `group`."""
    names = list(params)
    grads = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
    grads = {k: torch.zeros_like(params[k]) if g is None else g for k, g in zip(names, grads)}
    if group is not None:
        from dpm_solver_tpu_torch.parallel.mesh import all_reduce_mean_

        all_reduce_mean_(list(grads.values()), group)
    return grads


def _mean_logs(log: dict, group) -> dict:
    """The logs' values averaged over `group` (the data-parallel step's)."""
    if group is None or not log:
        return log
    from dpm_solver_tpu_torch.parallel.mesh import all_reduce_mean_

    vals = {k: torch.as_tensor(v).detach().float().clone() for k, v in log.items()}
    all_reduce_mean_(list(vals.values()), group)
    return vals


def _disc_update(cfg, disc_apply: Callable, tx: Adam, state: AdversarialTrainState,
                 images: torch.Tensor, recon: torch.Tensor, group=None) -> dict:
    """The optimizer-1 pass shared by the KL and VQ steps; updates the
    discriminator's parameters and statistics in place, returns its log."""
    box = [state.disc_batch_stats]

    def disc_fn(x):
        # torch runs the real batch, then the fake one, through the same
        # BatchNorm layers, updating the running moments twice in sequence
        # (contperceptual.py:94-104): thread them through both calls
        logits, box[0] = disc_apply(x, box[0])
        return logits

    out = P.discriminator_loss(cfg, disc_fn, images, recon, state.step)
    tx.step(state.disc_params, _grads(out.loss, state.disc_params, group), state.disc_opt)
    with torch.no_grad():
        for k, v in box[0].items():
            state.disc_batch_stats[k].copy_(v)
    return out.log


def _finish(state: AdversarialTrainState, glog: dict, dlog: dict, group=None):
    state.step += 1
    return state, {f"train/{k}": v for k, v in _mean_logs({**glog, **dlog}, group).items()}


def _generator_pass(loss_fn: Callable, epilogue: Callable, last_layer_of: Callable,
                    disc_apply: Callable, tx: Adam, state: AdversarialTrainState, trunk: Tuple,
                    group=None):
    """The optimizer-0 pass from the trunk's outputs: the reconstruction, the
    loss (`loss_fn(recon, disc_fn, last_layer_fn, w_last, *trunk[1:])`) and
    the generator's update. Returns (detached reconstruction, log)."""
    h = trunk[0]
    recon = epilogue(None, h)
    frozen = h.detach()
    stats = state.disc_batch_stats

    def disc_fn(x):
        return disc_apply(x, stats)[0]  # generator pass: statistics frozen

    out = loss_fn(recon, disc_fn, lambda w: epilogue(w, frozen), last_layer_of(), *trunk[1:])
    tx.step(state.gen_params, _grads(out.loss, state.gen_params, group), state.gen_opt)
    return recon.detach(), out.log


def make_kl_train_step(cfg: P.KLLossConfig, *, encode_decode: Callable, epilogue: Callable,
                       last_layer_of: Callable, perceptual_fn: Callable, disc_apply: Callable,
                       latent_shape: Callable, tx: Adam, sample_posterior: bool = True,
                       mesh=None) -> Callable:
    """step(state, images, seed, *, noise=None) -> (state, logs).

    encode_decode(images, noise) -> (the decoder's trunk, posterior), the
    posterior's mode when noise is None; epilogue(w, h) -> reconstructions,
    the final conv with weight w (None: the module's own) on trunk h;
    last_layer_of() -> that weight; perceptual_fn(x, y) -> (B, 1, 1, 1);
    disc_apply(x, stats) -> (patch logits, new stats); latent_shape(images)
    -> the posterior's shape. `noise` replaces the step's standard-normal
    draw of that shape. `mesh`: data-parallel (module docstring); images
    and noise global."""
    sharding, group = data_parallel(mesh)

    def step(state: AdversarialTrainState, images: torch.Tensor, seed: int, *,
             noise: Optional[torch.Tensor] = None):
        if sample_posterior and noise is None:
            noise = torch.randn(latent_shape(images), device=images.device,
                                generator=StepRng(seed, state.step).generator(images.device))
        if sharding is not None:
            images = sharding.local(images)
            noise = None if noise is None else sharding.local(noise)
        trunk = encode_decode(images, noise if sample_posterior else None)
        logvar = state.gen_params["logvar"]

        def loss_fn(recon, disc_fn, last_layer_fn, w_last, posterior):
            return P.kl_generator_loss(cfg, perceptual_fn, disc_fn, images, recon, posterior,
                                       logvar, state.step, last_layer_fn=last_layer_fn,
                                       last_layer=w_last)

        recon, glog = _generator_pass(loss_fn, epilogue, last_layer_of, disc_apply, tx, state,
                                      trunk, group)
        dlog = _disc_update(cfg, disc_apply, tx, state, images, recon, group)
        return _finish(state, glog, dlog, group)

    step.mesh = mesh
    return step


def make_vq_train_step(cfg: P.VQLossConfig, *, encode_decode: Callable, epilogue: Callable,
                       last_layer_of: Callable, perceptual_fn: Callable, disc_apply: Callable,
                       tx: Adam, n_embed: Optional[int] = None, mesh=None) -> Callable:
    """The VQ twin: encode_decode(images) -> (trunk, codebook loss, indices);
    step(state, images, seed) -> (state, logs) (the VQ forward draws
    nothing). With n_embed, the logs hold the codebook's perplexity (the
    ranks' mean under a `mesh`, as every log)."""
    sharding, group = data_parallel(mesh)

    def step(state: AdversarialTrainState, images: torch.Tensor, seed: int):
        if sharding is not None:
            images = sharding.local(images)

        def loss_fn(recon, disc_fn, last_layer_fn, w_last, qloss, idx):
            return P.vq_generator_loss(cfg, perceptual_fn, disc_fn, qloss, images, recon,
                                       state.step, last_layer_fn=last_layer_fn,
                                       last_layer=w_last,
                                       predicted_indices=idx if n_embed else None,
                                       n_embed=n_embed)

        recon, glog = _generator_pass(loss_fn, epilogue, last_layer_of, disc_apply, tx, state,
                                      encode_decode(images), group)
        dlog = _disc_update(cfg, disc_apply, tx, state, images, recon, group)
        return _finish(state, glog, dlog, group)

    step.mesh = mesh
    return step


def bind_autoencoder(model: nn.Module, discriminator: nn.Module, lpips: nn.Module) -> dict:
    """The callables the step builders take, bound to the modules: `model`
    an AutoencoderKL or VQModel, `discriminator` an NLayerDiscriminator,
    `lpips` an LPIPS (frozen here)."""
    from dpm_solver_tpu_torch.models.vae import AutoencoderKL, decoder_epilogue

    lpips.requires_grad_(False)
    cfg = model.config
    conv_out = model.decoder.conv_out

    def epilogue(weight, h):
        return decoder_epilogue(conv_out, h, weight=weight, tanh_out=cfg.tanh_out)

    def latent_shape(images):
        f = 2 ** (len(cfg.ch_mult) - 1)
        return (images.shape[0], images.shape[1] // f, images.shape[2] // f, cfg.embed_dim)

    fns = dict(encode_decode=model.forward_trunk, epilogue=epilogue,
               last_layer_of=lambda: conv_out.weight, perceptual_fn=lpips,
               disc_apply=discriminator)
    if isinstance(model, AutoencoderKL):
        fns["latent_shape"] = latent_shape  # the KL step draws the posterior's noise
    return fns


__all__ = ["AdversarialTrainState", "bind_autoencoder", "make_adversarial_state",
           "make_kl_train_step", "make_vq_train_step"]
