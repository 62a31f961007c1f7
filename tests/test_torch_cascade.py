"""The port's cascade pipeline (dpm_solver_tpu_torch/pipelines/cascade.py) against
the JAX package's `dpm_solver_tpu/pipelines/cascade.py`, on the CPU.

tests/test_cascade_and_logging.py's two-stage tiny cascade: an 8 px base
ADM stage (DPM-Solver++ 2M, 4 steps) and a 16 px upsampler that takes the
base's output through `super_res_inputs` (6 input channels), its low-res
input noise-augmented at `aug_level` 0.25 and sampled by SDE-DPM-Solver++.
Random weights of the JAX init's shapes go into the port through the ADM
converter; the JAX cascade's draws (per stage: x_T, the augmentation's noise,
the SDE solver's fold_in(rng, step) draws) are regenerated here by replaying
its key splits and passed to the port. Both stages' outputs within 1e-4 of
max|x| (tests/test_solver_parity.py:70-75). Then the port alone: a repeat
call with another generator reuses each stage's solver, and equal
generators give equal samples.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu.models.adm_unet import ADMConfig as JaxADMConfig
from dpm_solver_tpu.models.adm_unet import ADMUNet as JaxADMUNet
from dpm_solver_tpu.models.adm_unet import super_res_inputs as jax_super_res
from dpm_solver_tpu.pipelines.cascade import CascadePipeline as JaxPipeline
from dpm_solver_tpu.pipelines.cascade import CascadeStage as JaxStage
from dpm_solver_tpu.schedule import NoiseScheduleVP as JaxNS
from dpm_solver_tpu_torch.models import ADMConfig, ADMUNet, super_res_inputs
from dpm_solver_tpu_torch.pipelines import CascadePipeline, CascadeStage
from dpm_solver_tpu_torch.schedule import NoiseScheduleVP
from dpm_solver_tpu_torch.utils.convert import adm_unet_state_dict_from_flax
from tests.test_torch_wideresnet import random_params

TRAJ_BOUND = 1e-4     # of max|x|: tests/test_solver_parity.py:70-75
BETAS = np.linspace(1e-4, 0.02, 1000)
STEPS, BATCH = 4, 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's CPU work: these small shapes gain
    nothing from more, and the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stage_models(resolution, in_ch, seed):
    """The SuperResModel contract on both sides: the model concatenates the
    low-res conditioning itself, the pipeline passes raw x + low_res."""
    kw = dict(image_size=resolution, in_channels=in_ch, model_channels=32, out_channels=3,
              num_res_blocks=1, attention_resolutions=(), channel_mult=(1, 2), num_heads=1)
    jnet = JaxADMUNet(config=JaxADMConfig(**kw))
    params = random_params(jnet, seed, jnp.zeros((1, resolution, resolution, in_ch)),
                           jnp.ones((1,)))
    apply = jax.jit(lambda x, t: jnet.apply(params, x, t, deterministic=True))
    cfg = ADMConfig(**kw)
    port = ADMUNet(cfg, device="cpu").eval()
    port.load_state_dict(adm_unet_state_dict_from_flax(params, cfg))

    def jax_fn(x, t, c, low):
        return apply(x if low is None else jax_super_res(x, low), t)

    def port_fn(x, t, c, low):
        return port(x if low is None else super_res_inputs(x, low), t)

    return jax_fn, port_fn


@pytest.fixture(scope="module")
def pipelines():
    stages = dict(base=dict(resolution=8, steps=STEPS, order=2),
                  up=dict(resolution=16, steps=STEPS, order=2, aug_level=0.25,
                          algorithm_type="sde-dpmsolver++"))
    models = [_stage_models(8, 3, 1), _stage_models(16, 6, 2)]
    jns, pns = JaxNS.discrete(betas=BETAS), NoiseScheduleVP.discrete(betas=BETAS)
    jax_pipe = JaxPipeline([JaxStage(model=m[0], noise_schedule=jns, **kw)
                            for m, kw in zip(models, stages.values())])
    port_pipe = CascadePipeline([CascadeStage(model=m[1], noise_schedule=pns, **kw)
                                 for m, kw in zip(models, stages.values())])
    return jax_pipe, port_pipe


def cascade_noise(key, pipe):
    """The JAX cascade's draws: per stage `rng, stage_rng = split(rng)` and
    `rng_T, rng_aug, rng_sde = split(stage_rng, 3)`; x_T from rng_T, the
    augmentation's (1, *low-res shape) from rng_aug, step k's SDE noise
    (k = 1..steps) from fold_in(rng_sde, k)."""
    rng, out = key, []
    for i, stage in enumerate(pipe.stages):
        rng, stage_rng = jax.random.split(rng)
        r_t, r_aug, r_sde = jax.random.split(stage_rng, 3)
        shape = (BATCH, stage.resolution, stage.resolution, stage.channels)
        draws = {"x_T": jax.random.normal(r_t, shape)}
        if i:
            low = pipe.stages[i - 1]
            draws["aug"] = jax.random.normal(
                r_aug, (1, BATCH, low.resolution, low.resolution, low.channels))
        if stage.algorithm_type.startswith("sde"):
            draws["sde"] = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(r_sde, k),
                                                                  shape))
                                     for k in range(1, stage.steps + 1)])
        out.append({k: torch.tensor(np.asarray(v)) for k, v in draws.items()})
    return out


def test_two_stage_cascade_with_an_sde_upsampler_matches_jax(pipelines):
    jax_pipe, port_pipe = pipelines
    key = jax.random.PRNGKey(1)
    want = jax_pipe.sample(rng=key, batch=BATCH, return_all_stages=True)
    with torch.no_grad():
        got = port_pipe.sample(batch=BATCH, noise=cascade_noise(key, port_pipe),
                               return_all_stages=True)
    assert [tuple(g.shape) for g in got] == [(BATCH, 8, 8, 3), (BATCH, 16, 16, 3)]
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= TRAJ_BOUND * np.abs(w).max()


def test_cascade_reuses_its_solvers_and_repeats_given_a_generator(pipelines):
    _, port_pipe = pipelines
    with torch.no_grad():
        a = port_pipe.sample(batch=BATCH, generator=torch.Generator().manual_seed(7))
        solvers = [port_pipe._solvers[i][2] for i in range(2)]
        b = port_pipe.sample(batch=BATCH, generator=torch.Generator().manual_seed(7))
        c = port_pipe.sample(batch=BATCH, generator=torch.Generator().manual_seed(8))
    assert [port_pipe._solvers[i][2] for i in range(2)] == solvers
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a - c).abs().max() > 0
    with pytest.raises(ValueError, match="noise"):
        port_pipe.sample(batch=BATCH)
