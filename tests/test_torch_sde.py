"""Port SDEs and score/noise conventions (dpm_solver_tpu_torch/{sde,score}.py)
against the JAX package's `dpm_solver_tpu.sde` and `dpm_solver_tpu.score`.

The same numpy inputs go through both; every method of the three SDEs, the
reverse processes, and the label conventions of `score.py:8-11` agree in
fp32 within 1e-6 relative to the largest value. Prior sampling takes a
torch.Generator (its stream is not jax.random's), so it is held to its
shape, dtype, device and scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu import score as jscore
from dpm_solver_tpu import sde as jsde
from dpm_solver_tpu_torch import score as tscore
from dpm_solver_tpu_torch import sde as tsde

REL = 1e-6
T = np.asarray([1e-3, 0.25, 0.5, 0.77, 1.0], dtype=np.float32)
X = np.random.default_rng(0).standard_normal((5, 4, 4, 3)).astype(np.float32)
SDES = {
    "vp": (jsde.VPSDE(), tsde.VPSDE()),
    "subvp": (jsde.SubVPSDE(beta_0=0.2, beta_1=15.0, N=500), tsde.SubVPSDE(0.2, 15.0, 500)),
    "ve": (jsde.VESDE(), tsde.VESDE()),
}


def close(got, want, rel=REL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name", sorted(SDES))
@pytest.mark.parametrize("method", ["sde", "marginal_prob", "discretize"])
def test_sde_methods_match_jax(name, method):
    j, t = SDES[name]
    want = getattr(j, method)(jnp.asarray(X), jnp.asarray(T))
    got = getattr(t, method)(torch.tensor(X), torch.tensor(T))
    for a, b in zip(got, want):
        close(torch.as_tensor(a).expand(np.shape(b)), b)


@pytest.mark.parametrize("name", sorted(SDES))
def test_prior_logp_matches_jax(name):
    j, t = SDES[name]
    close(t.prior_logp(torch.tensor(X)), j.prior_logp(jnp.asarray(X)))


@pytest.mark.parametrize("name", sorted(SDES))
def test_prior_sampling_defaults_to_the_card(name):
    """With neither a generator nor a device the prior is drawn on the card,
    so without one it raises; device="cpu" draws on the CPU."""
    _, t = SDES[name]
    if torch.cuda.is_available():
        assert t.prior_sampling((2, 3)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t.prior_sampling((2, 3))
    a = t.prior_sampling((2, 3), device="cpu")
    assert a.shape == (2, 3) and a.device.type == "cpu"


@pytest.mark.parametrize("name", sorted(SDES))
def test_prior_sampling_takes_a_generator(name):
    _, t = SDES[name]
    a = t.prior_sampling((4000, 3), torch.Generator().manual_seed(1))
    b = t.prior_sampling((4000, 3), torch.Generator().manual_seed(1))
    assert a.shape == (4000, 3) and a.dtype == torch.float32 and torch.equal(a, b)
    scale = t.sigma_max if name == "ve" else 1.0
    assert abs(a.std().item() / scale - 1.0) < 0.05


@pytest.mark.parametrize("name", sorted(SDES))
@pytest.mark.parametrize("probability_flow", [False, True])
def test_reverse_sde_matches_jax(name, probability_flow):
    j, t = SDES[name]
    rev_j = jsde.reverse_sde(j, lambda x, s: jnp.sin(x) * (1.0 + s[:, None, None, None]),
                             probability_flow)
    rev_t = tsde.reverse_sde(t, lambda x, s: torch.sin(x) * (1.0 + s[:, None, None, None]),
                             probability_flow)
    assert (rev_t.T, rev_t.N, rev_t.probability_flow) == (rev_j.T, rev_j.N, probability_flow)
    for fn in ("sde", "discretize"):
        want = getattr(rev_j, fn)(jnp.asarray(X), jnp.asarray(T))
        got = getattr(rev_t, fn)(torch.tensor(X), torch.tensor(T))
        for a, b in zip(got, want):
            close(torch.as_tensor(a).expand(np.shape(b)), b)


def _nets():
    jax_net = lambda x, labels: jnp.sin(x) * (1.0 + 0.001 * labels[:, None, None, None])
    torch_net = lambda x, labels: torch.sin(x) * (1.0 + 0.001 * labels[:, None, None, None])
    return jax_net, torch_net


@pytest.mark.parametrize("name,continuous", [("vp", True), ("vp", False), ("subvp", True),
                                             ("ve", True), ("ve", False)])
def test_score_fn_conventions_match_jax(name, continuous):
    j, t = SDES[name]
    jax_net, torch_net = _nets()
    want = jscore.get_score_fn(j, jax_net, continuous)(jnp.asarray(X), jnp.asarray(T))
    got = tscore.get_score_fn(t, torch_net, continuous)(torch.tensor(X), torch.tensor(T))
    close(got, want)


@pytest.mark.parametrize("name,continuous", [("vp", True), ("vp", False), ("ve", True)])
def test_noise_fn_conventions_match_jax(name, continuous):
    j, t = SDES[name]
    jax_net, torch_net = _nets()
    want = jscore.get_noise_fn(j, jax_net, continuous)(jnp.asarray(X), jnp.asarray(T))
    got = tscore.get_noise_fn(t, torch_net, continuous)(torch.tensor(X), torch.tensor(T))
    close(got, want)


def test_continuous_vp_labels_are_t_times_999():
    seen = []
    tscore.get_noise_fn(tsde.VPSDE(), lambda x, labels: seen.append(labels) or x)(
        torch.tensor(X), torch.tensor(T))
    close(seen[0], T * 999.0)


def test_vp_to_noise_schedule_is_the_linear_schedule():
    ns = tsde.VPSDE(beta_0=0.1, beta_1=20.0).to_noise_schedule()
    ref = jsde.VPSDE().to_noise_schedule()
    assert (ns.schedule, ns.beta_0, ns.beta_1) == ("linear", ref.beta_0, ref.beta_1)
    close(ns.marginal_std(torch.tensor(T)), ref.marginal_std(jnp.asarray(T)))
    with pytest.raises(NotImplementedError):
        tscore.get_score_fn(object(), lambda x, s: x)
