"""Port FIR resampling (dpm_solver_tpu_torch/ops/resample.py) against
`dpm_solver_tpu/ops/resample.py`.

Every public function runs on the same numpy input through both, at odd
(13x11) and even (12x12) sizes, with the score_sde FIR kernel (1, 3, 3, 1),
the default box kernel, a 2-D window and negative (cropping) padding; fp32
within 1e-5 absolute, the JAX package's own bound against the reference
(tests/test_ncsnpp.py::test_resample_ops_match_reference).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu.ops import resample as J
from dpm_solver_tpu_torch.ops import resample as P

TOL = 1e-5
K = [1.0, 3.0, 3.0, 1.0]
_RNG = np.random.default_rng(0)
INPUTS = {"odd": _RNG.standard_normal((2, 13, 11, 5)).astype(np.float32),
          "even": _RNG.standard_normal((2, 12, 12, 5)).astype(np.float32)}
W = (_RNG.standard_normal((3, 3, 5, 7)) * 0.1).astype(np.float32)

CASES = {
    "upsample": lambda m, x, w: m.upsample_2d(x, K),
    "downsample": lambda m, x, w: m.downsample_2d(x, K),
    "upsample_x4": lambda m, x, w: m.upsample_2d(x, K, factor=4),
    "upsample_box": lambda m, x, w: m.upsample_2d(x),
    "downsample_box_gain": lambda m, x, w: m.downsample_2d(x, gain=2.0),
    "upsample_conv": lambda m, x, w: m.upsample_conv_2d(x, w, k=K),
    "conv_downsample": lambda m, x, w: m.conv_downsample_2d(x, w, k=K),
    "upfirdn_negpad": lambda m, x, w: m.upfirdn2d(x, K, up=2, pad=(-1, 3), gain=4.0),
    "upfirdn_2d_window": lambda m, x, w: m.upfirdn2d(x, np.outer(K, K), up=2, down=3,
                                                     pad=(2, 1)),
    "nearest": lambda m, x, w: m.nearest_upsample_2d(x),
}


@pytest.mark.parametrize("size", sorted(INPUTS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_resample_matches_jax(case, size):
    x = INPUTS[size]
    want = np.asarray(CASES[case](J, jnp.asarray(x), jnp.asarray(W)))
    got = CASES[case](P, torch.tensor(x), torch.tensor(W))
    assert got.shape == want.shape and got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_mean_downsample_matches_jax():
    x = INPUTS["even"]
    np.testing.assert_allclose(P.mean_downsample_2d(torch.tensor(x)).numpy(),
                               np.asarray(J.mean_downsample_2d(jnp.asarray(x))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("k,separable", [(K, True), (K, False), (np.outer(K, K), True)])
def test_fir_taps_match_jax(k, separable):
    for a, b in zip(P.fir_taps(k, gain=3.0, separable=separable),
                    J.fir_taps(k, gain=3.0, separable=separable)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
