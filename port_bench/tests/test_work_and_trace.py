"""The yardstick's arithmetic against hand counts, and the trace reduction."""

from collections import Counter
from types import SimpleNamespace

import pytest
import torch

from port_bench.harness import trace as tr, work
from port_bench.harness.runner import Reading


def test_conv3x3_work():
    tc, fp32, nbytes = work.launch_work("conv3x3", (2, 4, 4, 8, 16))
    assert tc == 2 * 9 * (2 * 4 * 4) * 8 * 16     # 2 flops a multiply-add, 9 taps
    assert fp32 == 2 * 4 * 4 * 16                  # the bias add
    assert nbytes == 2 * (2 * 16 * (8 + 16) + 9 * 8 * 16) + 4 * 16


def test_attention_work():
    tc, fp32, nbytes = work.launch_work("token_attention", (2, 64, 77, 8, 40, False))
    assert tc == 2 * 2 * (2 * 8 * 64 * 77 * 40)    # q.k^T and p.v
    assert fp32 == 5 * 2 * 8 * 64 * 77
    assert nbytes == 2 * (2 * 2 * 64 * 320 + 2 * 2 * 77 * 320)   # q and o; k and v


def test_least_seconds_is_the_larger_bound():
    spec = (1, 1, 1, 8, 8)   # tiny: the bytes bound it
    _, _, nbytes = work.launch_work("conv3x3", spec)
    assert work.least_seconds("conv3x3", spec) == nbytes / work.HBM_BYTES_S
    spec = (64, 64, 64, 1280, 1280)   # large: the products bound it
    tc, _, _ = work.launch_work("conv3x3", spec)
    assert work.least_seconds("conv3x3", spec) == tc / work.PEAK_BF16


def test_model_flops_counts_products():
    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(16, 32)
            self.conv = torch.nn.Conv2d(3, 5, 3, padding=1)

        def forward(self, x, img):
            return self.lin(x), self.conv(img)

    flops = work.model_flops(Net, lambda: (torch.empty(4, 16), torch.empty(2, 3, 8, 8)))
    assert flops == 2 * 4 * 16 * 32 + 2 * 2 * 8 * 8 * 5 * 3 * 9


def _ev(name, start, end, device, annotation=False):
    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=DeviceType.CUDA if device else DeviceType.CPU,
                           is_user_annotation=annotation)


def test_summarize():
    events = [
        _ev("bench.window", 0, 100, False, True),
        _ev("bench.trajectory", 5, 60, False, True),
        _ev("bench.to_host", 70, 90, False, True),
        _ev("bench.trajectory", 5, 60, True, True),        # the device-side annotation: ignored
        _ev("conv3x3_wgmma", 10, 30, True),
        _ev("elementwise", 20, 40, True),                   # overlaps: busy is the union
        _ev("attention_fwd_wgmma", 50, 55, True),
        _ev("before", -10, -5, True),                       # outside the window: ignored
    ]
    s = tr.summarize(events)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(35e-6)
    assert s.ops == pytest.approx({"elementwise": 20e-6, "conv3x3_wgmma": 20e-6,
                                   "attention_fwd_wgmma": 5e-6})
    # gaps 0-10 (no span open), 40-50 and 55-100 (each named by the span open at its start)
    assert s.gaps["between spans"] == pytest.approx(10e-6)
    assert s.gaps["trajectory"] == pytest.approx(55e-6)
    assert sum(s.gaps.values()) == pytest.approx(65e-6)
    assert s.seconds_matching(r"\bconv3x3_") == pytest.approx(20e-6)


def _reading(summary, least):
    entry = SimpleNamespace(KERNELS={"own": r"\b(conv3x3_\w+|attention_fwd_\w+)",
                                     "conv3x3": r"\bconv3x3_", "token_attention": r"attention_fwd"},
                            least_seconds=lambda: least, flops_per_request=lambda: 1e12)
    reqs = [{"latency_s": 1.0, "spans": {"trajectory": 0.5}}, {"latency_s": 3.0, "spans": {}}]
    return Reading(entry, reqs, 2, summary, 2 ** 31)


def test_reading():
    s = tr.TraceSummary(Counter({"conv3x3_wgmma": 0.02, "attention_fwd_wgmma": 0.01,
                                 "gemm": 0.07}), 0.09, 0.1, Counter())
    r = _reading(s, {"conv3x3": 0.004})
    assert r.roofline("conv3x3") == pytest.approx(100 * 0.004 * 2 / 0.02)
    assert r.roofline("token_attention") is None            # nothing counted: silent, not 0
    assert r.library_share() == pytest.approx(70.0)
    assert r.idle_share() == pytest.approx(10.0)
    assert r.mfu() == pytest.approx(100 * 2e12 / 4.0 / work.PEAK_BF16)
    assert r.span_mean_ms("trajectory") == pytest.approx(500.0)
    assert r.span_mean_ms("vae_decode") is None
    assert r.peak_mem_gib() == 2.0
    assert _reading(None, {}).roofline("conv3x3") is None
