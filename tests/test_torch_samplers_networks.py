"""The port's sampler zoo (dpm_solver_tpu_torch/samplers.py) on networks, against
the JAX package's `dpm_solver_tpu/samplers.py`, on the CPU: the companion of
tests/test_torch_samplers.py (which holds the PC registries on the exact
Gaussian score and the time grid), with its draw replays.

- `get_pc_sampler` on a tiny VE NCSN++ (Fourier features, continuous VE
  labels), reverse diffusion with Langevin correction: the same NFE, x0
  within 1e-4 of max|x| (tests/test_solver_parity.py:70-75);
- DDIM (eta 0 and 1), ancestral DDPM and PLMS on a tiny DDPM UNet, the JAX
  weights carried across by the converter, within 1e-4; PLMS's extra NFE;
- `slerp` and `interpolation_grid` from the same draws, within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu import samplers as J
from dpm_solver_tpu import sde as jsde
from dpm_solver_tpu.models.ddpm_unet import DDPMUNet as JaxDDPMUNet
from dpm_solver_tpu.models.ddpm_unet import DDPMUNetConfig as JaxDDPMConfig
from dpm_solver_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from dpm_solver_tpu.models.ncsnpp import NCSNppConfig as JaxNCSNppConfig
from dpm_solver_tpu.models.ncsnpp_convert import params_from_torch
from dpm_solver_tpu.schedule import NoiseScheduleVP as JaxNS
from dpm_solver_tpu.score import get_score_fn as jax_score_fn
from dpm_solver_tpu_torch import samplers as P
from dpm_solver_tpu_torch import sde as psde
from dpm_solver_tpu_torch.models import DDPMUNet, DDPMUNetConfig, NCSNpp, NCSNppConfig, init_random_
from dpm_solver_tpu_torch.schedule import NoiseScheduleVP
from dpm_solver_tpu_torch.score import get_score_fn
from dpm_solver_tpu_torch.utils.convert import ddpm_unet_state_dict_from_flax
from tests.test_torch_samplers import SHAPE, TRAJ_BOUND, _rel, fold_in_noise, pc_noise

SLERP_TOL = 1e-6
BETAS = np.linspace(1e-4, 0.02, 1000)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's CPU work: these small shapes gain
    nothing from more, and the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_ve_ncsnpp():
    """A tiny continuous-VE NCSN++ (Fourier features of log sigma), the port's
    random weights carried to the JAX model."""
    kw = dict(fir=True, progressive_input="residual", embedding_type="fourier",
              num_res_blocks=1, image_size=8, attn_resolutions=(4,))
    port = init_random_(NCSNpp(NCSNppConfig.tiny(**kw), device="cpu"),
                        torch.Generator().manual_seed(0)).eval().requires_grad_(False)
    params = params_from_torch({k: v.numpy() for k, v in port.state_dict().items()},
                               JaxNCSNppConfig.tiny(**kw))
    jnet = JaxNCSNpp(config=JaxNCSNppConfig.tiny(**kw))
    return port, jax.jit(lambda x, t: jnet.apply(params, x, t, deterministic=True))


def test_pc_sampler_on_a_tiny_ve_ncsnpp_matches_jax(tiny_ve_ncsnpp):
    port, jnet = tiny_ve_ncsnpp
    jsd, psd = jsde.VESDE(N=5), psde.VESDE(N=5)
    kw = dict(predictor="reverse_diffusion", corrector="langevin", snr=0.16)
    shape = (2, 8, 8, 3)
    x = (50.0 * np.random.default_rng(2).standard_normal(shape)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want, nfe_j = J.get_pc_sampler(jsd, jax_score_fn(jsd, jnet, continuous=True), **kw)(
        jnp.asarray(x), key)
    with torch.no_grad():
        got, nfe = P.get_pc_sampler(psd, get_score_fn(psd, port, continuous=True), **kw)(
            torch.tensor(x), noise=pc_noise(key, 5, shape, "reverse_diffusion", "langevin", 1))
    assert nfe == int(nfe_j) == 10
    assert _rel(got.numpy(), want) <= TRAJ_BOUND


@pytest.fixture(scope="module")
def tiny_ddpm():
    """A tiny DDPM UNet: JAX init (every leaf perturbed) carried to the port."""
    cfg = JaxDDPMConfig.tiny(resolution=8)
    jnet = JaxDDPMUNet(cfg)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)), jnp.ones((1,)))
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape))
                          .astype(np.float32), params)
    port = DDPMUNet(DDPMUNetConfig.tiny(resolution=8), device="cpu").eval()
    port.load_state_dict(ddpm_unet_state_dict_from_flax(params))
    return port, jax.jit(lambda x, t: jnet.apply(params, x, t))


@pytest.mark.parametrize("kind", ["ddim_eta0", "ddim_eta1", "ddpm", "plms"])
def test_discrete_samplers_match_jax_on_a_tiny_ddpm_unet(tiny_ddpm, kind):
    port, jnet = tiny_ddpm
    jns, pns = JaxNS.discrete(betas=BETAS), NoiseScheduleVP.discrete(betas=BETAS)
    shape = (2, 8, 8, 3)
    x = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    key = jax.random.PRNGKey(9)
    steps, noise = 5, None
    if kind.startswith("ddim"):
        eta = float(kind[-1])
        jax_s = J.ddim_sampler(jnet, jns, steps=steps, eta=eta)
        port_s = P.ddim_sampler(port, pns, steps=steps, eta=eta)
        noise = fold_in_noise(key, len(port_s.t_seq), shape) if eta else None
    elif kind == "ddpm":
        jax_s = J.ddpm_ancestral_sampler(jnet, jns, steps=steps)
        port_s = P.ddpm_ancestral_sampler(port, pns, steps=steps)
        noise = fold_in_noise(key, steps, shape)
    else:
        jax_s, port_s = J.plms_sampler(jnet, jns, steps=steps), P.plms_sampler(port, pns, steps=steps)
    want = jax_s(jnp.asarray(x), key)
    with torch.no_grad():
        got = port_s(torch.tensor(x), noise=noise)
    assert _rel(got.numpy(), want) <= TRAJ_BOUND


def test_plms_spends_one_extra_evaluation():
    evals = []

    def model(x, t):
        evals.append(float(t[0]))
        return 0.1 * x

    ns = NoiseScheduleVP.discrete(betas=BETAS)
    P.plms_sampler(model, ns, steps=6)(torch.ones(SHAPE))
    assert len(evals) == 7
    # the first step's correction evaluates at the next lower grid time
    assert evals[0] == 999.0 and evals[1] == evals[2]


@pytest.mark.parametrize("alpha", [0.3, [0.0, 0.25, 1.0]])
def test_slerp_matches_jax(alpha):
    rng = np.random.default_rng(7)
    z1, z2 = (rng.standard_normal((2, 4, 4, 3)).astype(np.float32) for _ in range(2))
    want = J.slerp(jnp.asarray(z1), jnp.asarray(z2), jnp.asarray(alpha))
    got = P.slerp(torch.tensor(z1), torch.tensor(z2), alpha)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=SLERP_TOL)


def test_interpolation_grid_matches_jax():
    key, shape = jax.random.PRNGKey(11), (4, 4, 3)
    want = J.interpolation_grid(key, shape, n=11)
    r1, r2 = jax.random.split(key)
    noise = torch.tensor(np.stack([np.asarray(jax.random.normal(r, shape)) for r in (r1, r2)]))
    got = P.interpolation_grid(shape, 11, noise=noise)
    assert got.shape == (11, *shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=SLERP_TOL)
    # the ends are the two draws
    np.testing.assert_allclose(got[0].numpy(), noise[0].numpy(), rtol=0, atol=SLERP_TOL)
    np.testing.assert_allclose(got[-1].numpy(), noise[1].numpy(), rtol=0, atol=SLERP_TOL)
