"""The port's dry-run entry points (dpm_solver_tpu_torch/dryrun.py, the port of
`__graft_entry__.py`): `dryrun_multichip(4)` on four gloo ranks prints each
stage's `[dryrun]` line (data-parallel step, sharded trajectory, ZeRO-1,
the adversarial step, and on the (2, 2) mesh the TP forward, train step and
20-NFE trajectory); `dryrun_multihost(2)` prints MULTIHOST_OK for each
process; `entry()` on the CPU is the full-size CIFAR-10 UNet's bf16 forward,
and asks for the card by default."""

import pytest
import torch

from dpm_solver_tpu_torch import dryrun

STAGES = ("mesh over 4 ranks", "DP train step ok", "sharded sampling trajectory ok",
          "ZeRO-1 step ok", "adversarial first-stage step ok", "TP SD-UNet forward ok",
          "TP train step ok", "TP 20-NFE sampling trajectory ok")


@pytest.fixture(scope="module")
def multichip_lines(tmp_path_factory):
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun.dryrun_multichip(4)
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("stage", STAGES)
def test_dryrun_multichip_prints_each_stage(multichip_lines, stage):
    assert any(line.startswith(f"[dryrun] {stage}") for line in multichip_lines), multichip_lines


def test_dryrun_multihost(capfd):
    dryrun.dryrun_multihost(2)
    out = capfd.readouterr().out
    assert "MULTIHOST_OK 0" in out and "MULTIHOST_OK 1" in out


def test_entry_forward_on_the_cpu():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        fn, args = dryrun.entry(device="cpu")
        y = fn(*args)
    finally:
        torch.set_num_threads(n)
    assert y.shape == (8, 32, 32, 3) and torch.isfinite(y.float()).all()


def test_entry_asks_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.entry()
