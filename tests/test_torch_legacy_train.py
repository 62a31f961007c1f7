"""The port's legacy discrete score losses (dpm_solver_tpu_torch/training/
losses.py: `smld_loss_fn`, the descending-sigma NCSN objective on discrete
VE labels, and `ddpm_loss_fn`, the discrete VP eps-MSE) through
`make_score_train_step`, against the JAX package's on the CPU, on
tests/test_torch_score_train.py's toy score net, with its draws and bounds.
"""

import pytest

from test_torch_score_train import CASES, _one_torch_thread, _run_case  # noqa: F401


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][2] != "sde"])
def test_legacy_train_step_matches_jax(case):
    _run_case(case)
