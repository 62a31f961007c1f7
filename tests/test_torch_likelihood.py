"""Port bits/dim and the black-box ODE sampler (dpm_solver_tpu_torch/likelihood.py)
against the JAX package's `dpm_solver_tpu/likelihood.py`.

- The exact-Gaussian case of tests/test_likelihood.py: the exact score of
  N(0, I) data, where bits/dim must equal the standard-normal density's,
  within 2e-2 (that file's bound), for both probe kinds; and the same call
  against the JAX one: the same NFE, bpd within 1e-4.
- A tiny VP NCSN++ (FIR resampling, residual input pyramid, fp32), its
  random weights carried to the JAX model by the existing converter, the
  Hutchinson probe drawn by the JAX `sample_hutchinson` and passed in:
  the same NFE as the JAX call, bpd within 1e-3 absolute, z within 5e-3 of
  max|z| (the repo's adaptive bound, tests/test_solver_parity.py:286: each
  side accepts its steps on its own fp32 error estimate). The net is the
  unconditional twin of the adaptive check's model: random weights on the
  t*999 sinusoidal embedding make the drift oscillate in t with a period
  near 0.006, and RK45 at 1e-5 then takes thousands of NFE, minutes on the
  CPU; unconditional, a few hundred. The equal NFE is this input's, not a
  law: the step control rides fp32 error estimates of log p whose rounding
  differs between any two implementations, so on another input (batch 1)
  the JAX package's own jitted loop and the same loop stepped eagerly need
  not take the same NFE either.
- `ode_sampler` on the same net from a given x_init, with and without the
  final denoising step, against the JAX one: the same NFE, within 5e-3.

The JAX `hutchinson_divergence` takes one `jax.jvp` through the network,
and JAX has no forward-mode rule for the `custom_vjp` of its conv3x3
(`dpm_solver_tpu/ops/conv3x3.py:158`): on NCSN++ the JAX call raises. The
JAX side here takes the score_sde reference's vector-Jacobian form instead,
the form the port uses, by patching the module attribute for this module's
calls only; nothing in the JAX package changes. The JAX calls run once per
module (a module-scoped fixture).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpm_solver_tpu.likelihood as jax_likelihood
from dpm_solver_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from dpm_solver_tpu.models.ncsnpp import NCSNppConfig as JaxConfig
from dpm_solver_tpu.models.ncsnpp_convert import params_from_torch
from dpm_solver_tpu.score import get_score_fn as jax_score_fn
from dpm_solver_tpu.sde import VPSDE as JaxVPSDE
from dpm_solver_tpu_torch.likelihood import (get_likelihood_fn, hutchinson_divergence,
                                             ode_sampler, sample_hutchinson)
from dpm_solver_tpu_torch.models import NCSNpp, NCSNppConfig, init_random_
from dpm_solver_tpu_torch.score import get_score_fn
from dpm_solver_tpu_torch.sde import VPSDE

GAUSSIAN_TOL = 2e-2   # tests/test_likelihood.py:77
BPD_TOL = 1e-3
Z_TOL = 5e-3          # of max|z|: tests/test_solver_parity.py:286
NET_KW = dict(fir=True, progressive_input="residual", num_res_blocks=1, conditional=False)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's CPU work, the module fixtures' too:
    these small shapes gain nothing from more, and the suite runs several
    workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vjp_divergence(fn, x, t, eps):
    """The score_sde reference's divergence form (one vjp), in JAX."""
    primal, pull = jax.vjp(lambda xi: fn(xi, t), x)
    grad, = pull(eps)
    return primal, jnp.sum(grad * eps, axis=tuple(range(1, x.ndim)))


def _exact_score(sde, lib):
    """Score of the marginal when data ~ N(0, I): -x / (alpha_t^2 + sigma_t^2)."""
    def score_fn(x, t):
        mean_coef, sigma = sde.marginal_prob(lib.ones_like(x), t)
        sigma = sigma.reshape(tuple(sigma.shape) + (1,) * (x.ndim - sigma.ndim))
        return -x / (mean_coef ** 2 + sigma ** 2)
    return score_fn


def _gaussian_data():
    return np.random.default_rng(1).standard_normal((4, 4, 4, 2)).astype(np.float32)


def _closed_form_bpd(data):
    n = data[0].size
    logp = -0.5 * (np.sum(data.astype(np.float64) ** 2, axis=(1, 2, 3))
                   + n * math.log(2 * math.pi))
    return -logp / n / math.log(2.0) + 8.0


@pytest.fixture(scope="module")
def tiny():
    """The tiny net on both sides, its data, probe and start, and the JAX
    package's results on them (bpd, z, nfe; the sampler's x and nfe with
    and without denoising)."""
    port = init_random_(NCSNpp(NCSNppConfig.tiny(**NET_KW), device="cpu"),
                        torch.Generator().manual_seed(0)).eval().requires_grad_(False)
    params = params_from_torch({k: v.numpy() for k, v in port.state_dict().items()},
                               JaxConfig.tiny(**NET_KW))
    net = JaxNCSNpp(config=JaxConfig.tiny(**NET_KW))
    score_j = jax_score_fn(JaxVPSDE(), lambda x, t: net.apply(params, x, t, deterministic=True))
    data = np.random.default_rng(1).uniform(-1.0, 1.0, (2, 16, 16, 3)).astype(np.float32)
    x_init = np.random.default_rng(2).standard_normal((2, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    eps = np.asarray(jax_likelihood.sample_hutchinson(key, data.shape))
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_likelihood, "hutchinson_divergence", _vjp_divergence)
    try:
        bpd, z, nfe = jax_likelihood.get_likelihood_fn(
            JaxVPSDE(), score_j, inverse_scaler_grad=0.5)(key, jnp.asarray(data))
    finally:
        mp.undo()
    sampled = {}
    for denoise in (False, True):
        x, n = jax_likelihood.ode_sampler(JaxVPSDE(), score_j, x_init.shape, None,
                                          x_init=jnp.asarray(x_init), denoise=denoise)
        sampled[denoise] = (np.asarray(x), int(n))
    return dict(score=get_score_fn(VPSDE(), port), data=data, eps=eps, x_init=x_init,
                likelihood=(np.asarray(bpd), np.asarray(z), int(nfe)), sampled=sampled)


@pytest.mark.parametrize("kind", ["Rademacher", "Gaussian"])
def test_bits_per_dim_exact_gaussian(kind):
    data = _gaussian_data()
    lik = get_likelihood_fn(VPSDE(), _exact_score(VPSDE(), torch), hutchinson_type=kind,
                            inverse_scaler_grad=1.0)
    bpd, z, nfe = lik(torch.tensor(data), generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(bpd.numpy(), _closed_form_bpd(data), atol=GAUSSIAN_TOL)
    assert nfe > 10 and z.shape == data.shape and torch.isfinite(z).all()


def test_exact_gaussian_matches_jax_with_the_same_nfe():
    data = _gaussian_data()
    key = jax.random.PRNGKey(0)
    eps = np.asarray(jax_likelihood.sample_hutchinson(key, data.shape))
    want, z_j, nfe_j = jax_likelihood.get_likelihood_fn(
        JaxVPSDE(), _exact_score(JaxVPSDE(), jnp))(key, jnp.asarray(data))
    got, z_t, nfe_t = get_likelihood_fn(VPSDE(), _exact_score(VPSDE(), torch))(
        torch.tensor(data), epsilon=torch.tensor(eps))
    assert nfe_t == int(nfe_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=0, atol=1e-4)


def test_tiny_ncsnpp_bits_per_dim_matches_jax(tiny):
    want_bpd, want_z, want_nfe = tiny["likelihood"]
    lik = get_likelihood_fn(VPSDE(), tiny["score"], inverse_scaler_grad=0.5)
    bpd, z, nfe = lik(torch.tensor(tiny["data"]), epsilon=torch.tensor(tiny["eps"]))
    assert nfe == want_nfe
    assert bpd.shape == (2,) and z.dtype == torch.float32
    np.testing.assert_allclose(bpd.numpy(), want_bpd, rtol=0, atol=BPD_TOL)
    np.testing.assert_allclose(z.numpy(), want_z, rtol=0,
                               atol=Z_TOL * float(np.abs(want_z).max()))


@pytest.mark.parametrize("denoise", [False, True], ids=["ode", "denoise"])
def test_ode_sampler_matches_jax(tiny, denoise):
    want, want_nfe = tiny["sampled"][denoise]
    got, nfe = ode_sampler(VPSDE(), tiny["score"], tiny["x_init"].shape,
                           x_init=torch.tensor(tiny["x_init"]), denoise=denoise)
    assert nfe == want_nfe and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=Z_TOL * float(np.abs(want).max()))


def test_sample_hutchinson_kinds():
    g = torch.Generator().manual_seed(0)
    r = sample_hutchinson((4000,), "Rademacher", device="cpu", generator=g)
    assert set(r.unique().tolist()) == {-1.0, 1.0} and abs(r.mean().item()) < 0.05
    n = sample_hutchinson((4000,), "Gaussian", torch.float64, device="cpu", generator=g)
    assert n.dtype == torch.float64 and abs(n.std().item() - 1.0) < 0.05
    with pytest.raises(ValueError, match="Hutchinson"):
        sample_hutchinson((4,), "Uniform", device="cpu")


def test_hutchinson_divergence_is_eps_j_eps():
    """On a linear map x -> x M (per row), eps^T J eps is exactly computable:
    the vector-Jacobian form gives it, and the primal."""
    rng = np.random.default_rng(3)
    m = torch.tensor(rng.standard_normal((6, 6)).astype(np.float32))
    x, eps = (torch.tensor(rng.standard_normal((3, 6)).astype(np.float32)) for _ in range(2))
    out, div = hutchinson_divergence(lambda xi, t: xi @ m * t[:, None], x, torch.full((3,), 2.0),
                                     eps)
    torch.testing.assert_close(out, x @ m * 2.0)
    torch.testing.assert_close(div, 2.0 * ((eps @ m) * eps).sum(1), rtol=1e-5, atol=1e-5)
    assert not out.requires_grad
