"""One run of one cell: set-up, the measured window, the check, the result line.

The window is a closed loop of one client: each request is issued when the
previous one's images are on the host, until `seconds` have passed since
the first was issued; the request running at that moment completes and
counts, and the window ends at the last completion. A rate is the images
completed over the window's seconds; a latency is a request's issue to its
images on the host.

With `trace`, the entry's spans are on for every request, and
`torch.profiler` records `traffic["trace_requests"]` requests from the
second of the window on; the per-layer readers then take the spans of the
requests outside that segment and the device trace of those inside it.

The requests whose outputs are checked are a uniform sample of those the
window completed (reservoir sampling from the seed), `traffic["check"]
["requests"]` of them. Their check runs after the window, after the device
memory peak has been read and the program has been freed.
"""

from __future__ import annotations

import math
import random
import statistics
import sys
import time
from typing import Dict, List, Optional

import torch

from port_bench.harness import guard, trace as tr, work
from port_bench.harness.cell import Cell
from port_bench.harness.weights import seed_value


class Reading:
    """What the per-layer readers read."""

    def __init__(self, entry, requests: List[dict], traced: int,
                 summary: Optional[tr.TraceSummary], memory_peak_bytes: int):
        self.entry, self.requests, self.traced = entry, requests, traced
        self.trace, self.memory_peak_bytes = summary, memory_peak_bytes

    def latency_quantile(self, q: float) -> Optional[float]:
        lat = sorted(r["latency_s"] for r in self.requests)
        if len(lat) < 2:
            return None
        return statistics.quantiles(lat, n=100, method="inclusive")[round(q * 100) - 1]

    def span_mean_ms(self, name: str) -> Optional[float]:
        vals = [r["spans"][name] for r in self.requests if name in r.get("spans", {})]
        return 1e3 * sum(vals) / len(vals) if vals else None

    def roofline(self, kernel: str) -> Optional[float]:
        """% of the least time the traced requests' launches of `kernel`
        need, over their device time in the trace."""
        least = self.entry.least_seconds().get(kernel, 0.0) * self.traced
        if self.trace is None or least <= 0:
            return None
        spent = self.trace.seconds_matching(self.entry.KERNELS[kernel])
        return 100.0 * least / spent if spent > 0 else None

    def library_share(self) -> Optional[float]:
        if self.trace is None or self.trace.device_s <= 0:
            return None
        own = self.trace.seconds_matching(self.entry.KERNELS["own"])
        return 100.0 * (self.trace.device_s - own) / self.trace.device_s

    def idle_share(self) -> Optional[float]:
        if self.trace is None or self.trace.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)

    def mfu(self) -> Optional[float]:
        busy = sum(r["latency_s"] for r in self.requests)
        if busy <= 0:
            return None
        flops = self.entry.flops_per_request() * len(self.requests)
        return 100.0 * flops / busy / work.PEAK_BF16

    def peak_mem_gib(self) -> Optional[float]:
        return self.memory_peak_bytes / 2 ** 30 if self.memory_peak_bytes else None


def _device_info(device: torch.device, count: int, peak: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
                "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": peak}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, log=print) -> dict:
    """The result object of one run; its "checks" hold every number compared."""
    t_entry = time.perf_counter()
    entry = cell.entry().Entry(cell.config, cell.traffic, seed, device)
    t_warm = time.perf_counter()
    entry.warm()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    log(f"setup {setup_s:.3f} s: imports {t_entry - t_start:.3f}, program and weights "
        f"{t_warm - t_entry:.3f}, warm requests {t_start + setup_s - t_warm:.3f}", file=sys.stderr)
    if trace:
        entry.spans_on()

    keep_n = int(cell.traffic["check"]["requests"])
    pick = random.Random(seed_value(seed, 77))
    kept: Dict[int, object] = {}
    n_trace = int(cell.traffic.get("trace_requests", 1)) if trace else 0
    prof, summary, requests, images = None, None, [], 0
    t0 = time.perf_counter()
    deadline, i, t_end = t0 + seconds, 0, t0
    # the traced requests complete even where they outlast the window
    while time.perf_counter() < deadline or (trace and i <= n_trace):
        slot = i if i < keep_n else pick.randrange(i + 1)
        keep = slot < keep_n
        traced = 1 <= i <= n_trace
        if trace and i == 1:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            window_span = torch.profiler.record_function(tr.WINDOW)
            window_span.__enter__()
        issued = time.perf_counter()
        n_img, payload, spans = entry.request(i, keep)
        t_end = time.perf_counter()
        if keep:
            kept[slot] = (i, payload)
        if not traced:
            requests.append({"latency_s": t_end - issued, "spans": spans})
        images += n_img
        i += 1
        if traced and i == n_trace + 1:
            window_span.__exit__(None, None, None)
            prof.stop()
    window_s = t_end - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if prof is not None:   # read after the window: the reduction takes seconds
        summary = tr.summarize(prof.events())
        del prof

    metrics: Dict[str, dict] = {}
    if trace:
        reading = Reading(entry, requests, n_trace, summary, peak)
        for name, read in cell.readers().items():
            value = read(reading)
            if value is not None and math.isfinite(value):
                unit = next(m["unit"] for m in cell.per_layer if m["name"] == name)
                metrics[name] = {"value": value, "unit": unit}
    else:
        all_lat = [r["latency_s"] for r in requests]
        values = {"setup_s": setup_s, "images_per_s": images / window_s,
                  "latency_p90_s": (statistics.quantiles(all_lat, n=10, method="inclusive")[8]
                                    if len(all_lat) >= 2 else None)}
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    entry.release()
    numbers = entry.check([kept[k] for k in sorted(kept)])
    checks = {name: {"value": numbers[name], "limit": limit} for name, limit in cell.limits.items()}
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
    bad = guard.loaded_forbidden()
    if bad:
        raise SystemExit(f"forbidden modules loaded: {', '.join(bad)}")
    out = {"correct": correct, "attempted": i, "failed": 0, "metrics": metrics,
           "device": _device_info(device, cell.chips, peak)}
    if summary is not None:
        out["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        out["breakdown"] = {"device_ops": tr.top(summary.ops), "idle_gaps": tr.top(summary.gaps)}
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    out["checks"] = checks
    return out
