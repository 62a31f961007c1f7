"""The port's noise-conditional WideResNet classifier (dpm_solver_tpu_torch/models/
wideresnet.py) against the JAX package's `dpm_solver_tpu/models/wideresnet.py`,
on the CPU.

Random weights of the JAX init's shapes go into the port through
`utils/convert.py::wideresnet_state_dict_from_flax`:

- the logits on an even map, where flax's SAME stride-2 convs pad (0, 1),
  at two depths and widths, within 2e-5 of max|logits| (tests/test_models.py:64);
- `get_classifier_grad_fn(get_logit_fn(...))`, grad_x of the summed
  log-softmax at the labels, within 1e-4 of its max;
- the parameter count of WRN-28-10 (the default) equal to the JAX model's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu.models import wideresnet as J
from dpm_solver_tpu_torch.models import wideresnet as P
from dpm_solver_tpu_torch.utils.convert import wideresnet_state_dict_from_flax

NET_TOL = 2e-5        # of max|out|: tests/test_models.py:64
GRAD_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's CPU work: these small shapes gain
    nothing from more, and the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_params(model, seed, *args):
    """Random weights of the init's shapes (without compiling the init): a
    kernel normal(1 / sqrt(fan_in)), a GroupNorm scale 1 + normal(0.05),
    biases normal(0.05), the Fourier features' W normal(16) as its init."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        z = rng.standard_normal(leaf.shape)
        if "kernel" in name:
            return (z / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        if "'W'" in name:
            return (16.0 * z).astype(np.float32)
        return ((0.0 if "bias" in name else 1.0) + 0.05 * z).astype(np.float32)

    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def pair(blocks, mult, x, sig, seed=0):
    jm = J.WideResNetClassifier(blocks_per_group=blocks, channel_multiplier=mult)
    params = random_params(jm, seed, x, sig)
    pm = P.WideResNetClassifier(blocks, mult, device="cpu")
    pm.load_state_dict(wideresnet_state_dict_from_flax(params))
    return jm, params, pm.requires_grad_(False)


def _inputs(b, size, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (b, size, size, 3)).astype(np.float32)
    return x, np.exp(rng.uniform(np.log(0.01), np.log(50.0), b)).astype(np.float32)


@pytest.mark.parametrize("blocks, mult, size", [(1, 1, 16), (2, 2, 8)])
def test_logits_on_an_even_map_match_jax(blocks, mult, size):
    x, sig = _inputs(3, size, 1)
    jm, params, pm = pair(blocks, mult, x, sig)
    want = np.asarray(jax.jit(jm.apply)(params, x, sig))
    with torch.no_grad():
        got = pm(torch.tensor(x), torch.tensor(sig)).numpy()
    assert got.shape == want.shape == (3, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=NET_TOL * np.abs(want).max())


def test_classifier_grad_fn_matches_jax():
    x, sig = _inputs(3, 16, 2)
    labels = np.asarray([0, 3, 9])
    jm, params, pm = pair(1, 1, x, sig, seed=3)
    want = np.asarray(jax.jit(J.get_classifier_grad_fn(J.get_logit_fn(jm, params)))(
        x, sig, labels))
    got = P.get_classifier_grad_fn(P.get_logit_fn(pm))(
        torch.tensor(x), torch.tensor(sig), torch.tensor(labels)).numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * np.abs(want).max())


def test_wrn_28_10_parameter_count_equals_jax():
    shapes = jax.eval_shape(J.WideResNetClassifier().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)), jnp.ones((1,)))
    n = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in P.WideResNetClassifier(device="meta").parameters()) == n
    assert n > 36_000_000   # WRN-28-10
