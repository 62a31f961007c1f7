"""The port's classic sampler zoo (dpm_solver_tpu_torch/samplers.py) against the
JAX package's `dpm_solver_tpu/samplers.py`, on the CPU.

The JAX loops draw their noise from split keys inside `lax.scan`; the JAX
draws are regenerated here with `jax.random`, replaying the loops' splits,
and passed to the port as `noise=` in the order the loop uses them. Both
sides then compute the same function:

- every predictor x corrector pair of the registries on VP, sub-VP and VE,
  with the exact score of N(0, I) data (tests/test_torch_likelihood.py's):
  the same NFE, x0 within 1e-4 of max|x| (tests/test_solver_parity.py:
  70-75); the ancestral predictor raises on sub-VP on both sides;
- the time grid: the port's `time_grid` gives the index t * (N - 1) that
  the ancestral predictor and `_alpha_for` cut, and the discrete-VE label,
  equal to the JAX ones at every point for N = 1,000 and 2,000 at eps 1e-3
  and 1e-5 (torch.linspace does not).

tests/test_torch_samplers_networks.py holds the samplers on networks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu import samplers as J
from dpm_solver_tpu import sde as jsde
from dpm_solver_tpu_torch import samplers as P
from dpm_solver_tpu_torch import sde as psde
from dpm_solver_tpu_torch.sde import _grid_index

TRAJ_BOUND = 1e-4     # of max|x|: tests/test_solver_parity.py:70-75
SHAPE = (3, 4, 4, 2)
N = 40
PREDICTORS = ["euler_maruyama", "reverse_diffusion", "ancestral_sampling", "none"]
CORRECTORS = ["langevin", "ald", "none"]
SDES = {"vp": (jsde.VPSDE, psde.VPSDE), "subvp": (jsde.SubVPSDE, psde.SubVPSDE),
        "ve": (jsde.VESDE, psde.VESDE)}


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


def _exact_score(sde, lib):
    """Score of the marginal when data ~ N(0, I): -x / (alpha_t^2 + sigma_t^2)."""
    def score_fn(x, t):
        mean_coef, sigma = sde.marginal_prob(lib.ones_like(x), t)
        sigma = sigma.reshape(tuple(sigma.shape) + (1,) * (x.ndim - sigma.ndim))
        return -x / (mean_coef ** 2 + sigma ** 2)
    return score_fn


def pc_noise(key, n_steps, shape, predictor, corrector, n_corrector_steps):
    """The JAX PC loop's draws in its order: per step `rng, r1, r2 =
    split(rng, 3)`; the corrector splits r1 once an inner step and draws from
    the second half; the predictor draws from r2."""
    rng, out = key, []
    for _ in range(n_steps):
        rng, r1, r2 = jax.random.split(rng, 3)
        if corrector != "none":
            for _ in range(n_corrector_steps):
                r1, step = jax.random.split(r1)
                out.append(np.asarray(jax.random.normal(step, shape)))
        if predictor != "none":
            out.append(np.asarray(jax.random.normal(r2, shape)))
    return torch.tensor(np.stack(out)) if out else torch.zeros((0, *shape))


def fold_in_noise(key, n, shape):
    """normal(fold_in(rng, i)) for i < n: the JAX DDIM / DDPM scans' draws."""
    return torch.tensor(np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, i), shape))
                                  for i in range(n)]))


@pytest.mark.parametrize("sde_name", list(SDES))
@pytest.mark.parametrize("predictor", PREDICTORS)
@pytest.mark.parametrize("corrector", CORRECTORS)
def test_pc_sampler_matches_jax_on_the_exact_gaussian_score(sde_name, predictor, corrector):
    jcls, pcls = SDES[sde_name]
    jsd, psd = jcls(N=N), pcls(N=N)
    kw = dict(predictor=predictor, corrector=corrector, snr=0.16, n_corrector_steps=2)
    x = np.random.default_rng(1).standard_normal(SHAPE).astype(np.float32)
    if sde_name == "ve":
        x *= 50.0
    key = jax.random.PRNGKey(3)
    jax_sampler = J.get_pc_sampler(jsd, _exact_score(jsd, jnp), **kw)
    port_sampler = P.get_pc_sampler(psd, _exact_score(psd, torch), **kw)
    if predictor == "ancestral_sampling" and sde_name == "subvp":
        with pytest.raises(NotImplementedError):
            jax_sampler(jnp.asarray(x), key)
        with pytest.raises(NotImplementedError):
            port_sampler(torch.tensor(x), generator=torch.Generator().manual_seed(0))
        return
    want, nfe_j = jax_sampler(jnp.asarray(x), key)
    noise = pc_noise(key, N, SHAPE, predictor, corrector, 2)
    assert noise.shape[0] == P.pc_draws(psd, predictor, corrector, 2)
    got, nfe = port_sampler(torch.tensor(x), noise=noise)
    assert nfe == int(nfe_j)
    assert _rel(got.numpy(), want) <= TRAJ_BOUND


def test_pc_sampler_counts_and_refuses_draws():
    psd = psde.VESDE(N=4)
    sampler = P.get_pc_sampler(psd, _exact_score(psd, torch), corrector="langevin")
    x = torch.randn(SHAPE, generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="noise"):
        sampler(x)
    with pytest.raises(ValueError, match=r"\(8, 3, 4, 4, 2\)"):
        sampler(x, noise=torch.zeros((7, *SHAPE)))
    # a generator draws as many as the stated count
    out, nfe = sampler(x, generator=torch.Generator().manual_seed(0))
    assert nfe == 8 and torch.isfinite(out).all()


@pytest.mark.parametrize("n, eps", [(1000, 1e-3), (1000, 1e-5), (2000, 1e-3), (2000, 1e-5)])
def test_time_grid_gives_the_jax_indices(n, eps):
    grid_j = jnp.linspace(1.0, eps, n)
    idx_j = np.asarray(jax.jit(lambda t: (t * (n - 1) / 1.0).astype(jnp.int32))(grid_j))
    lab_j = np.asarray(jax.jit(lambda t: jnp.round((1.0 - t) * (n - 1)))(grid_j))
    grid = P.time_grid(1.0, eps, n)
    assert grid.dtype == torch.float32 and grid.shape == (n,)
    np.testing.assert_array_equal(_grid_index(grid, n, 1.0).numpy(), idx_j)
    np.testing.assert_array_equal(torch.round((1.0 - grid) * (n - 1)).numpy(), lab_j)
    # XLA's CPU code fuses 1 - i * (1 / (n - 1)) into an FMA on some of the
    # points: the points then differ by the rounding of that product, at
    # most an ulp of the grid's start
    np.testing.assert_allclose(grid.numpy(), np.asarray(grid_j), rtol=0, atol=2.0 ** -23)
