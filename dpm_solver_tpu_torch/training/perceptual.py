"""First-stage (autoencoder) losses: LPIPS and the patch GAN.

Port of `dpm_solver_tpu/training/perceptual.py`, the twin of the
reference's first-stage losses:
  * `LPIPSWithDiscriminator` (ldm/modules/losses/contperceptual.py:7-110,
    KL autoencoders: L1 + LPIPS + the learned-logvar NLL + KL + the
    adversarial term with its adaptive weight);
  * `VQLPIPSWithDiscriminator` (vqperceptual.py:43-167, VQ models: pixel +
    LPIPS + codebook + adversarial);
  * `adopt_weight`, `hinge_d_loss`, `vanilla_d_loss`,
    `hinge_d_loss_with_exemplar_weights`, `measure_perplexity`
    (vqperceptual.py:11-40).

Each loss is a function of explicit callables (the perceptual distance,
the discriminator), as in the JAX package; sums run over everything and
are divided by the batch, as torch's losses do (contperceptual.py:57-58).
The adaptive discriminator weight (`calculate_adaptive_weight`,
contperceptual.py:32-43) takes `torch.autograd.grad` with respect to the
decoder's last-layer weight alone, through the final conv re-applied to the
detached decoder trunk: each gradient is one conv backward (and the loss
heads'), not a decoder backward. `global_step` is the host's step count.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Union

import torch
import torch.nn.functional as F


def adopt_weight(weight: float, global_step: int, threshold: int = 0, value: float = 0.0) -> float:
    """weight if global_step >= threshold else value (vqperceptual.py:20-23)."""
    return value if global_step < threshold else weight


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.mean(F.relu(1.0 - logits_real)) + torch.mean(F.relu(1.0 + logits_fake)))


def vanilla_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.mean(F.softplus(-logits_real)) + torch.mean(F.softplus(logits_fake)))


def hinge_d_loss_with_exemplar_weights(logits_real: torch.Tensor, logits_fake: torch.Tensor,
                                       weights: torch.Tensor) -> torch.Tensor:
    """The hinge loss weighted per exemplar (vqperceptual.py:11-18)."""
    loss_real = torch.mean(F.relu(1.0 - logits_real), dim=(1, 2, 3))
    loss_fake = torch.mean(F.relu(1.0 + logits_fake), dim=(1, 2, 3))
    wsum = torch.sum(weights)
    return 0.5 * (torch.sum(weights * loss_real) / wsum + torch.sum(weights * loss_fake) / wsum)


def measure_perplexity(predicted_indices: torch.Tensor, n_embed: int):
    """(perplexity, clusters used) of the codebook (vqperceptual.py:26-33)."""
    onehot = F.one_hot(predicted_indices.reshape(-1).long(), n_embed).float()
    avg_probs = onehot.mean(0)
    perplexity = torch.exp(-torch.sum(avg_probs * torch.log(avg_probs + 1e-10)))
    return perplexity, torch.sum(avg_probs > 0)


def l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.abs(x - y)


def l2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.square(x - y)


def adaptive_gan_weight(last_layer_fn: Callable, last_layer: torch.Tensor, nll_of: Callable,
                        g_of: Callable, disc_weight: float = 1.0) -> torch.Tensor:
    """`calculate_adaptive_weight` (contperceptual.py:32-43):
    ||d nll / d w|| / (||d g / d w|| + 1e-4), clipped to [0, 1e4], detached,
    times `disc_weight`; w is a detached copy of `last_layer`.

    last_layer_fn: w -> reconstructions (the decoder's final conv on its
    detached trunk); nll_of, g_of: reconstructions -> scalar."""
    w = last_layer.detach().requires_grad_()
    rec = last_layer_fn(w)
    nll_grad, = torch.autograd.grad(nll_of(rec), w, retain_graph=True)
    g_grad, = torch.autograd.grad(g_of(rec), w)
    d_weight = torch.linalg.vector_norm(nll_grad) / (torch.linalg.vector_norm(g_grad) + 1e-4)
    return torch.clamp(d_weight, 0.0, 1e4).detach() * disc_weight


class GeneratorLossOut(NamedTuple):
    loss: torch.Tensor
    log: dict


class KLLossConfig(NamedTuple):
    """LPIPSWithDiscriminator's hyperparameters (contperceptual.py:8-30)."""
    disc_start: int = 0
    kl_weight: float = 1.0
    pixelloss_weight: float = 1.0
    disc_factor: float = 1.0
    disc_weight: float = 1.0
    perceptual_weight: float = 1.0
    disc_loss: str = "hinge"  # 'hinge' | 'vanilla'


class VQLossConfig(NamedTuple):
    """VQLPIPSWithDiscriminator's hyperparameters (vqperceptual.py:44-83)."""
    disc_start: int = 0
    codebook_weight: float = 1.0
    pixelloss_weight: float = 1.0
    disc_factor: float = 1.0
    disc_weight: float = 1.0
    perceptual_weight: float = 1.0
    disc_loss: str = "hinge"
    pixel_loss: str = "l1"  # 'l1' | 'l2'


def _d_loss_fn(kind: str) -> Callable:
    if kind == "hinge":
        return hinge_d_loss
    if kind == "vanilla":
        return vanilla_d_loss
    raise ValueError(f"unknown disc_loss {kind!r}")


def _scalar(v: Union[float, torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def kl_generator_loss(cfg: KLLossConfig, perceptual_fn: Callable, disc_fn: Callable,
                      inputs: torch.Tensor, reconstructions: torch.Tensor, posterior,
                      logvar: torch.Tensor, global_step: int, *,
                      last_layer_fn: Optional[Callable] = None, last_layer: Any = None,
                      weights: Optional[torch.Tensor] = None) -> GeneratorLossOut:
    """The optimizer-0 branch of LPIPSWithDiscriminator.forward
    (contperceptual.py:45-92). `logvar` is the learned scalar output
    log-variance (a generator parameter); `disc_fn` maps images to patch
    logits."""
    rec_loss = torch.abs(inputs - reconstructions)
    if cfg.perceptual_weight > 0:
        rec_loss = rec_loss + cfg.perceptual_weight * perceptual_fn(inputs, reconstructions)
    nll_loss = rec_loss / torch.exp(logvar) + logvar
    weighted_nll = nll_loss if weights is None else weights * nll_loss
    batch = inputs.shape[0]
    weighted_nll = torch.sum(weighted_nll) / batch
    nll_scalar = torch.sum(nll_loss) / batch
    kl_loss = torch.sum(posterior.kl()) / batch

    g_loss = -torch.mean(disc_fn(reconstructions))

    if cfg.disc_factor > 0.0 and last_layer_fn is not None:
        def nll_of(rec):
            r = torch.abs(inputs - rec)
            if cfg.perceptual_weight > 0:
                r = r + cfg.perceptual_weight * perceptual_fn(inputs, rec)
            return torch.sum(r / torch.exp(logvar.detach()) + logvar.detach()) / batch

        d_weight = adaptive_gan_weight(last_layer_fn, last_layer, nll_of,
                                       lambda rec: -torch.mean(disc_fn(rec)), cfg.disc_weight)
    else:
        d_weight = _scalar(0.0, inputs)

    disc_factor = adopt_weight(cfg.disc_factor, global_step, threshold=cfg.disc_start)
    loss = weighted_nll + cfg.kl_weight * kl_loss + d_weight * disc_factor * g_loss
    log = {"total_loss": loss, "logvar": logvar.clone(), "kl_loss": kl_loss, "nll_loss": nll_scalar,
           "rec_loss": torch.mean(rec_loss), "d_weight": d_weight,
           "disc_factor": _scalar(disc_factor, inputs), "g_loss": g_loss}
    return GeneratorLossOut(loss, {k: v.detach() for k, v in log.items()})


def vq_generator_loss(cfg: VQLossConfig, perceptual_fn: Callable, disc_fn: Callable,
                      codebook_loss: torch.Tensor, inputs: torch.Tensor,
                      reconstructions: torch.Tensor, global_step: int, *,
                      last_layer_fn: Optional[Callable] = None, last_layer: Any = None,
                      predicted_indices: Optional[torch.Tensor] = None,
                      n_embed: Optional[int] = None) -> GeneratorLossOut:
    """The optimizer-0 branch of VQLPIPSWithDiscriminator.forward
    (vqperceptual.py:98-149)."""
    pixel = l1 if cfg.pixel_loss == "l1" else l2
    rec_loss = pixel(inputs, reconstructions)
    if cfg.perceptual_weight > 0:
        p_loss = perceptual_fn(inputs, reconstructions)
        rec_loss = rec_loss + cfg.perceptual_weight * p_loss
    else:
        p_loss = _scalar(0.0, inputs)
    nll_loss = torch.mean(rec_loss)

    g_loss = -torch.mean(disc_fn(reconstructions))

    if last_layer_fn is not None:
        def nll_of(rec):
            r = pixel(inputs, rec)
            if cfg.perceptual_weight > 0:
                r = r + cfg.perceptual_weight * perceptual_fn(inputs, rec)
            return torch.mean(r)

        d_weight = adaptive_gan_weight(last_layer_fn, last_layer, nll_of,
                                       lambda rec: -torch.mean(disc_fn(rec)), cfg.disc_weight)
    else:
        d_weight = _scalar(0.0, inputs)

    disc_factor = adopt_weight(cfg.disc_factor, global_step, threshold=cfg.disc_start)
    loss = nll_loss + d_weight * disc_factor * g_loss \
        + cfg.codebook_weight * torch.mean(codebook_loss)
    log = {"total_loss": loss, "quant_loss": torch.mean(codebook_loss), "nll_loss": nll_loss,
           "rec_loss": torch.mean(rec_loss), "p_loss": torch.mean(p_loss), "d_weight": d_weight,
           "disc_factor": _scalar(disc_factor, inputs), "g_loss": g_loss}
    if predicted_indices is not None:
        if n_embed is None:
            raise ValueError("predicted_indices needs n_embed")
        log["perplexity"], log["cluster_usage"] = measure_perplexity(predicted_indices, n_embed)
    return GeneratorLossOut(loss, {k: v.detach() for k, v in log.items()})


def discriminator_loss(cfg, disc_fn: Callable, inputs: torch.Tensor,
                       reconstructions: torch.Tensor, global_step: int) -> GeneratorLossOut:
    """The optimizer-1 branch, shared by both losses (contperceptual.py:94-110,
    vqperceptual.py:151-167): the images and reconstructions detached."""
    logits_real = disc_fn(inputs.detach())
    logits_fake = disc_fn(reconstructions.detach())
    disc_factor = adopt_weight(cfg.disc_factor, global_step, threshold=cfg.disc_start)
    d_loss = disc_factor * _d_loss_fn(cfg.disc_loss)(logits_real, logits_fake)
    log = {"disc_loss": d_loss, "logits_real": torch.mean(logits_real),
           "logits_fake": torch.mean(logits_fake)}
    return GeneratorLossOut(d_loss, {k: v.detach() for k, v in log.items()})


__all__ = ["GeneratorLossOut", "KLLossConfig", "VQLossConfig", "adaptive_gan_weight",
           "adopt_weight", "discriminator_loss", "hinge_d_loss",
           "hinge_d_loss_with_exemplar_weights", "kl_generator_loss", "l1", "l2",
           "measure_perplexity", "vanilla_d_loss", "vq_generator_loss"]
