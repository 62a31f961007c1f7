"""Training: the score-model, latent-diffusion and first-stage adversarial
steps, optimisers with optax's semantics, checkpoints (the counterpart of
`dpm_solver_tpu.training`)."""

from dpm_solver_tpu_torch.training.autoencoder import (AdversarialTrainState, bind_autoencoder,
                                                       make_adversarial_state, make_kl_train_step,
                                                       make_vq_train_step)
from dpm_solver_tpu_torch.training.latent import make_latent_train_step, vae_encode_fn
from dpm_solver_tpu_torch.training.optim import Adafactor, Adam, flax_layouts
from dpm_solver_tpu_torch.training.train import (StepRng, TrainState, ema_update,
                                                 make_multi_step, make_optimizer,
                                                 make_train_state, make_train_step)

__all__ = ["Adafactor", "Adam", "AdversarialTrainState", "StepRng", "TrainState",
           "bind_autoencoder", "ema_update", "flax_layouts", "make_adversarial_state",
           "make_kl_train_step", "make_latent_train_step", "make_multi_step", "make_optimizer",
           "make_train_state", "make_train_step", "make_vq_train_step", "vae_encode_fn"]
