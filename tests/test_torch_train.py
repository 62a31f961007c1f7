"""The port's training step (dpm_solver_tpu_torch/training/train.py,
optim.py) against the JAX package's, on the CPU.

- `make_train_step` on a tiny DDPM UNet (dropout 0), fed the JAX step's own
  draws (t, eps from `fold_in(rng, step)`), 3 steps of Adam after a linear
  warmup from 0 with global-norm clipping (the clip acts: the norm is far
  above 1): the loss and the gradients' norm each step within 1e-5
  (relative); Adam's moments after the 3 steps within 1e-4 of each
  tensor's largest element plus 1e-7 of the model's largest (the gradient
  sums' rounding, which is all a noise tensor's moment is); the
  parameters and the EMA within 1e-3 of the summed learning rates. Units
  of lr: Adam's update mu_hat / (sqrt(nu_hat) + eps) is of order 1 wherever
  a gradient is. Where a whole tensor's gradient is rounding noise (a bias
  added per channel before a one-channel GroupNorm group, whose gradient is
  0 in exact arithmetic: its first moment under 1e-6 of the model's
  largest), a difference in the last bits moves the update by up to lr, so
  those tensors are held within the summed lr instead.
- The first update's learning rate is 0 (optax's linear_schedule), so the
  parameters after step 1 are the initial ones on both sides.
- A JAX `TrainState` after one step, carried across with
  `utils.convert.train_state_from_flax` (params, EMA, Adam's moments and
  count, step), continues to the same place as the JAX run.
- `make_multi_step` equals stepping one batch at a time; optax's Adam
  semantics (lr 0 at the first update, the clip's max_norm / norm).

The models' training mode and initialisers: tests/test_torch_train_modes.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpm_solver_tpu_torch as P
from dpm_solver_tpu.models import DDPMUNet as JDDPMUNet
from dpm_solver_tpu.models import DDPMUNetConfig as JDDPMUNetConfig
from dpm_solver_tpu.schedule import NoiseScheduleVP as JNoiseScheduleVP
from dpm_solver_tpu.training import train as jtrain
from dpm_solver_tpu_torch.models import DDPMUNet, DDPMUNetConfig
from dpm_solver_tpu_torch.models.init import init_train_
from dpm_solver_tpu_torch.training import train as ptrain
from dpm_solver_tpu_torch.training.optim import Adam
from dpm_solver_tpu_torch.utils.convert import (_find_adam, ddpm_unet_state_dict_from_flax,
                                                train_state_from_flax)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's CPU work: these small shapes gain
    nothing from more, and the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BETAS = np.linspace(1e-4, 0.02, 1000)
LR, WARMUP, CLIP, EMA = 1e-3, 2, 1.0, 0.9


@functools.lru_cache(maxsize=None)
def _jax_setup(res=16, dropout=0.0):
    """The JAX side, once per module (its jitted step compiles once; the
    state is immutable)."""
    cfg = dataclasses.replace(JDDPMUNetConfig.tiny(resolution=res), dropout=dropout)
    model = JDDPMUNet(cfg)
    x = jnp.zeros((2, res, res, 3))
    params = model.init(jax.random.PRNGKey(0), x, jnp.ones((2,)))
    tx = jtrain.make_optimizer(LR, WARMUP, CLIP)
    state, _ = jtrain.make_train_state(params, tx=tx, ema_rate=EMA)
    ns = JNoiseScheduleVP.discrete(betas=BETAS)
    step = jax.jit(jtrain.make_train_step(lambda p, xx, t: model.apply(p, xx, t), ns, tx))
    return cfg, params, state, step


def _jax_draws(state, x0, rng):
    """The JAX step's t and eps (its own split of fold_in(rng, step))."""
    rng_t, rng_e, _ = jax.random.split(jax.random.fold_in(rng, state.step), 3)
    t = jtrain.antithetic_times(rng_t, x0.shape[0], 1000)
    eps = jax.random.normal(rng_e, x0.shape, x0.dtype)
    return torch.tensor(np.asarray(t)).long(), torch.tensor(np.asarray(eps))


def _port_setup(cfg, params):
    net = DDPMUNet(DDPMUNetConfig(**dataclasses.asdict(cfg)), device="cpu")
    net.load_state_dict(ddpm_unet_state_dict_from_flax(params))
    tx = ptrain.make_optimizer(LR, WARMUP, CLIP)
    state, _ = ptrain.make_train_state(net, tx=tx, ema_rate=EMA)
    ns = P.NoiseScheduleVP.discrete(betas=BETAS)
    return net, state, ptrain.make_train_step(lambda x, t: net(x, t), ns, tx), tx


def _batches(n, res=16, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, res, res, 3)).astype(np.float32) for _ in range(n)]


def _check_in_lr_units(got, want, mu, lr_sum):
    """max |got - want| / lr_sum: within 1e-3 for each tensor with a
    gradient, within 1 for those whose gradient is rounding noise (first
    moment `mu` under 1e-6 of the model's largest)."""
    top = max(float(v.abs().max()) for v in mu.values())
    for k in got:
        err = float((got[k].detach() - want[k]).abs().max()) / lr_sum
        noise = float(mu[k].abs().max()) <= 1e-6 * top
        assert err <= (1.0 if noise else 1e-3), (k, err, noise)


def test_train_step_matches_jax_adam_clip_warmup_ema():
    cfg, params, jstate, jstep = _jax_setup()
    net, pstate, pstep, tx = _port_setup(cfg, params)
    before = {k: v.detach().clone() for k, v in pstate.params.items()}
    rng = jax.random.PRNGKey(1)
    lr_sum = sum(tx.lr(c) for c in range(3))
    for i, x0 in enumerate(_batches(3)):
        t, eps = _jax_draws(jstate, jnp.asarray(x0), rng)
        jstate, jm = jstep(jstate, jnp.asarray(x0), rng)
        pstate, pm = pstep(pstate, torch.tensor(x0), 0, t=t, eps=eps)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        assert float(jm["grad_norm"]) > 10 * CLIP  # the clip acts
        if i == 0:  # lr(0) = 0: the first update moves nothing
            for k, p in pstate.params.items():
                torch.testing.assert_close(p.detach(), before[k], rtol=0, atol=0)
    assert pstate.step == int(jstate.step) == 3 and pstate.opt_state["count"] == 3
    adam = _find_adam(jstate.opt_state)
    mu = ddpm_unet_state_dict_from_flax(adam.mu)
    for name in ("mu", "nu"):
        want = ddpm_unet_state_dict_from_flax(getattr(adam, name))
        top = max(float(v.abs().max()) for v in want.values())
        for k, got in pstate.opt_state[name].items():
            bound = 1e-4 * float(want[k].abs().max()) + 1e-7 * top
            assert float((got - want[k]).abs().max()) <= bound, (name, k)
    for tree, got in ((jstate.params, pstate.params), (jstate.ema_params, pstate.ema_params)):
        _check_in_lr_units(got, ddpm_unet_state_dict_from_flax(tree), mu, lr_sum)


def test_jax_train_state_carries_across_and_continues():
    cfg, params, jstate, jstep = _jax_setup()
    rng = jax.random.PRNGKey(4)
    batches = _batches(3, seed=5)
    jstate, _ = jstep(jstate, jnp.asarray(batches[0]), rng)
    net = DDPMUNet(DDPMUNetConfig(**dataclasses.asdict(cfg)), device="cpu")
    tx = ptrain.make_optimizer(LR, WARMUP, CLIP)
    pstate = train_state_from_flax(jstate, ddpm_unet_state_dict_from_flax, net, tx)
    assert pstate.step == 1 and pstate.opt_state["count"] == 1 and pstate.ema_rate == EMA
    pstep = ptrain.make_train_step(lambda x, t: net(x, t), P.NoiseScheduleVP.discrete(
        betas=BETAS), tx)
    for x0 in batches[1:]:
        t, eps = _jax_draws(jstate, jnp.asarray(x0), rng)
        jstate, jm = jstep(jstate, jnp.asarray(x0), rng)
        pstate, pm = pstep(pstate, torch.tensor(x0), 0, t=t, eps=eps)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
    _check_in_lr_units(pstate.params, ddpm_unet_state_dict_from_flax(jstate.params),
                       ddpm_unet_state_dict_from_flax(_find_adam(jstate.opt_state).mu),
                       tx.lr(1) + tx.lr(2))


def test_multi_step_equals_stepping():
    cfg = DDPMUNetConfig.tiny(resolution=8)
    batches = [torch.tensor(b) for b in _batches(3, res=8, seed=6)]
    outs = []
    for multi in (False, True):
        net = init_train_(DDPMUNet(cfg, device="cpu"), torch.Generator().manual_seed(0))
        state, tx = ptrain.make_train_state(net, lr=1e-3, warmup=1)
        step = ptrain.make_train_step(lambda x, t: net(x, t), P.NoiseScheduleVP.discrete(
            betas=BETAS), tx)
        if multi:
            state, m = ptrain.make_multi_step(step, 3)(state, batches, 11)
            losses = m["loss"]
        else:
            losses = torch.stack([step(state, b, 11)[1]["loss"] for b in batches])
        outs.append((losses, {k: v.detach().clone() for k, v in state.params.items()}))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
    for k in outs[0][1]:
        torch.testing.assert_close(outs[0][1][k], outs[1][1][k], rtol=0, atol=0)


def test_optax_adam_first_update_and_clip_semantics():
    """lr(0) = 0 under warmup; the clip scales by max_norm / norm (no eps)."""
    p = {"w": torch.ones(4)}
    tx = Adam(ptrain.linear_schedule(0.0, 0.1, 2), grad_clip=1.0)
    st = tx.init(p)
    g = {"w": torch.full((4,), 3.0)}
    norm = tx.step(p, g, st)
    assert float(norm) == 6.0 and torch.equal(p["w"], torch.ones(4))
    torch.testing.assert_close(st["mu"]["w"], torch.full((4,), 0.1 * 0.5), rtol=0, atol=1e-8)
    tx.step(p, {"w": torch.full((4,), 0.25)}, st)  # under the norm: unclipped, lr(1) = 0.05
    assert bool((p["w"] < 1.0).all())
