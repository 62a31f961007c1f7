"""The port's controllable generation (dpm_solver_tpu_torch/controllable.py)
against the JAX package's `dpm_solver_tpu/controllable.py`, on the CPU.

A tiny continuous-VE NCSN++ (the port's random weights carried to the JAX
model) and a tiny noise-conditional WideResNet (1 block a group, multiplier
1; random weights of the JAX init's shapes carried to the port) on 8x8
images; the JAX tasks' draws regenerated here by replaying their key splits
and passed to the port as `noise=`:

- the inpainter, with one rectangle as the mask: within 1e-4 of max|x|
  (tests/test_solver_parity.py:70-75), the known pixels kept;
- the colorizer on a gray image: within 1e-4, its luma the gray image's
  within 1e-5 of max|x| (the basis change's fp32 rounding);
- the class-conditional sampler, the classifier gradient (autograd through
  the WRN at sigma(t)) added to the score at every evaluation: within 1e-4;
- `decouple` / `couple`: the JAX ones within 1e-6, and each other's inverse.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu import controllable as J
from dpm_solver_tpu import sde as jsde
from dpm_solver_tpu.models import wideresnet as JW
from dpm_solver_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from dpm_solver_tpu.models.ncsnpp import NCSNppConfig as JaxNCSNppConfig
from dpm_solver_tpu.models.ncsnpp_convert import params_from_torch
from dpm_solver_tpu.score import get_score_fn as jax_score_fn
from dpm_solver_tpu_torch import controllable as P
from dpm_solver_tpu_torch import sde as psde
from dpm_solver_tpu_torch.models import NCSNpp, NCSNppConfig, init_random_
from dpm_solver_tpu_torch.models import wideresnet as PW
from dpm_solver_tpu_torch.score import get_score_fn
from tests.test_torch_wideresnet import pair

TRAJ_BOUND = 1e-4     # of max|x|: tests/test_solver_parity.py:70-75
BASIS_TOL = 1e-6
STEPS = 4
SHAPE = (2, 8, 8, 3)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's CPU work: these small shapes gain
    nothing from more, and the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def nets():
    """The tiny VE NCSN++ on both sides (score functions of a VE SDE of STEPS
    steps) and the tiny WRN's classifier gradient at sigma(t)."""
    kw = dict(fir=True, progressive_input="residual", embedding_type="fourier",
              num_res_blocks=1, image_size=8, attn_resolutions=(4,))
    port = init_random_(NCSNpp(NCSNppConfig.tiny(**kw), device="cpu"),
                        torch.Generator().manual_seed(0)).eval().requires_grad_(False)
    params = params_from_torch({k: v.numpy() for k, v in port.state_dict().items()},
                               JaxNCSNppConfig.tiny(**kw))
    jnet = JaxNCSNpp(config=JaxNCSNppConfig.tiny(**kw))
    jsd, psd = jsde.VESDE(N=STEPS), psde.VESDE(N=STEPS)
    score_j = jax_score_fn(jsd, lambda x, t: jnet.apply(params, x, t, deterministic=True),
                           continuous=True)
    score_p = get_score_fn(psd, port, continuous=True)
    x, sig = np.zeros(SHAPE, np.float32), np.ones((2,), np.float32)
    jm, wparams, pm = pair(1, 1, x, sig, seed=4)
    jgrad = JW.get_classifier_grad_fn(JW.get_logit_fn(jm, wparams))
    pgrad = PW.get_classifier_grad_fn(PW.get_logit_fn(pm))
    grad_j = lambda x, t, y: jgrad(x, jsd.marginal_prob(jnp.zeros_like(x), t)[1], y)
    grad_p = lambda x, t, y: pgrad(x, psd.marginal_prob(torch.zeros_like(x), t)[1], y)
    return (jsd, score_j, grad_j), (psd, score_p, grad_p)


def task_noise(key, shape, constrained):
    """The JAX task's draws in its order: the prior from the first half of
    split(rng); per step `rng, r1, r2 = split(rng, 3)`, then (constrained)
    r1 -> (corrector, constraint), r2 -> (predictor, constraint), else r1 ->
    corrector, r2 -> predictor; the Langevin corrector splits its key once
    and draws from the second half."""
    normal = lambda k: np.asarray(jax.random.normal(k, shape))
    rng, prior = jax.random.split(key)
    out = [normal(prior)]
    for _ in range(STEPS):
        rng, r1, r2 = jax.random.split(rng, 3)
        c, c_con = jax.random.split(r1) if constrained else (r1, None)
        p, p_con = jax.random.split(r2) if constrained else (r2, None)
        out.append(normal(jax.random.split(c)[1]))
        if constrained:
            out.append(normal(c_con))
        out.append(normal(p))
        if constrained:
            out.append(normal(p_con))
    return torch.tensor(np.stack(out))


def _data(seed):
    return np.random.default_rng(seed).uniform(0.0, 1.0, SHAPE).astype(np.float32)


def test_inpainter_matches_jax_and_keeps_the_known_pixels(nets):
    (jsd, score_j, _), (psd, score_p, _) = nets
    data = _data(1)
    mask = np.zeros(SHAPE, np.float32)
    mask[:, 2:6, 1:5] = 1.0
    key = jax.random.PRNGKey(2)
    want = J.get_pc_inpainter(jsd, score_j)(key, jnp.asarray(data), jnp.asarray(mask))
    noise = task_noise(key, SHAPE, True)
    assert noise.shape[0] == P.task_draws(psd)
    with torch.no_grad():
        got = P.get_pc_inpainter(psd, score_p)(torch.tensor(data), torch.tensor(mask),
                                               noise=noise).numpy()
    assert _rel(got, want) <= TRAJ_BOUND
    known = mask.astype(bool)
    np.testing.assert_allclose(got[known], data[known], rtol=0, atol=1e-5)


def test_colorizer_matches_jax_and_keeps_the_luma(nets):
    (jsd, score_j, _), (psd, score_p, _) = nets
    gray = np.repeat(_data(3)[..., :1], 3, axis=-1)
    key = jax.random.PRNGKey(4)
    want = J.get_pc_colorizer(jsd, score_j)(key, jnp.asarray(gray))
    with torch.no_grad():
        got = P.get_pc_colorizer(psd, score_p)(torch.tensor(gray),
                                               noise=task_noise(key, SHAPE, True))
    assert _rel(got.numpy(), want) <= TRAJ_BOUND
    # the luma is pinned in the decoupled space, then coupled back: reading
    # it again carries the fp32 rounding of the basis change at the scale of
    # the output's other channels
    luma = P.decouple(got)[..., 0].numpy()
    np.testing.assert_allclose(luma, P.decouple(torch.tensor(gray))[..., 0].numpy(),
                               rtol=0, atol=1e-5 * np.abs(got.numpy()).max())


def test_conditional_sampler_matches_jax(nets):
    (jsd, score_j, grad_j), (psd, score_p, grad_p) = nets
    labels = np.asarray([1, 7])
    key = jax.random.PRNGKey(6)
    want = J.get_pc_conditional_sampler(jsd, score_j, grad_j)(key, SHAPE, jnp.asarray(labels))
    noise = task_noise(key, SHAPE, False)
    assert noise.shape[0] == P.task_draws(psd, constrained=False)
    with torch.no_grad():
        got = P.get_pc_conditional_sampler(psd, score_p, grad_p)(
            SHAPE, torch.tensor(labels), noise=noise)
    assert got.shape == SHAPE
    assert _rel(got.numpy(), want) <= TRAJ_BOUND


def test_color_basis_matches_jax_and_round_trips():
    x = np.random.default_rng(8).standard_normal((2, 4, 4, 3)).astype(np.float32)
    d = P.decouple(torch.tensor(x))
    np.testing.assert_allclose(d.numpy(), np.asarray(J.decouple(jnp.asarray(x))),
                               rtol=0, atol=BASIS_TOL)
    np.testing.assert_allclose(P.couple(d).numpy(), x, rtol=0, atol=BASIS_TOL)
    # gray images live on the luma axis alone
    gray = np.repeat(x[..., :1], 3, axis=-1)
    assert np.abs(P.decouple(torch.tensor(gray))[..., 1:].numpy()).max() <= BASIS_TOL
