#!/usr/bin/env python3
"""Time path E's fp32 kernels of two checkouts on one GPU, in turns, and trace one RK45 stage of each.

    python3 fp32_ab.py --parent DIR [--nfe N] [--out FILE]

DIR is an unpacked checkout of the commit to compare against (for example
`git archive <commit> | tar -x -C DIR`); the checkout this script lives in
is the other side. Each side runs in its own process, which imports that
side's `dpm_solver_tpu_torch` and builds its kernels into that side's build
directory. The order is parent, this, this, parent; each side's number is
the mean of its two runs. A run:

- builds path E's network (`NCSNppConfig.cifar10_ddpmpp(deep=True)`, fp32,
  seeded random weights, frozen) and records the conv3x3 and attention
  specs of one forward at b8 (`chip_smoke.py` 7b's hook);
- times `conv3x3` and `conv3x3_dx` (fp32, route "f32") at each of those
  conv specs and `attention_lse` (fp32) at each attention spec, one launch a
  call (`chip_smoke.py`'s `cuda_ms` and `make_case`, on inputs drawn from
  one seed per spec): the time of back-to-back wrapper calls, which is the
  host's where a call's host work outlasts its kernels, and the device time
  alone, from calls captured in a CUDA graph (`graph_ms`); the runs of this
  side also time the plain version, the library call (cuDNN with TF32 off;
  memory-efficient SDPA) and the bound (`Case.bound`);
- traces one stage of the likelihood ODE (`hutchinson_divergence` of the
  probability-flow drift: one network forward and one vector-Jacobian
  product, the work of one NFE) at b1 and at b8 under `torch.profiler`,
  three stages each after two warm ones: the stage's wall (host clock,
  synchronised), the union of the device's kernel intervals inside it
  (its busy share, of that wall and of the same stage's wall without the
  profiler, whose host work the profiler slows) and the kernel time by
  kernel.

Per-call sums multiply each spec's time by its launches in one forward
and by N, the NFE of one bits/dim call (default 625: path E's count on its
seeded inputs, `chip_smoke.py`). Prints one line a spec and kernel, the
sums, the traces, and the card's name and power limit, and writes the JSON
record to FILE (default chiprun_out/fp32_ab.json).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

HERE = Path(__file__).resolve().parent
KERNELS = ("conv3x3", "conv3x3_dx", "attention_lse")
STAGE_BATCHES = (1, 8)


def _merged(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def trace_stage(stage, path: Path) -> dict:
    """Profile three calls of `stage` (after two warm ones): per call its
    wall, the union of kernel time inside it and the busy share; the
    kernel time by name over the three."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(2):
        stage()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            torch.cuda.synchronize()
            with record_function(f"fp32_ab_stage_{i}"):
                stage()
                torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    windows = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                     if str(e.get("name", "")).startswith("fp32_ab_stage_") and "dur" in e
                     and e.get("cat") == "user_annotation")
    kernels = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
               if e.get("cat") == "kernel" and "dur" in e]
    calls, by_name = [], Counter()
    for w0, w1 in windows:
        inside = [(max(s, w0), min(e, w1)) for s, e, _ in kernels if e > w0 and s < w1]
        busy = _merged(inside)
        calls.append(dict(wall_ms=(w1 - w0) / 1e3, busy_ms=busy / 1e3,
                          busy_share=busy / (w1 - w0), kernels=len(inside)))
    for s, e, name in kernels:
        by_name[name[:80]] += (e - s) / 1e3 / max(len(windows), 1)
    return dict(calls=calls, top_kernels_ms=dict(by_name.most_common(8)))


def graph_ms(fn, calls: int = 20, replays: int = 5):
    """Device time of one fn() with no host in the way: `calls` calls
    captured in one CUDA graph, replayed `replays` times between two CUDA
    events. None where fn cannot be captured."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
    except RuntimeError:
        return None
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def worker(root: Path, with_reference: bool) -> dict:
    """One side's kernel times at path E's specs and its stage traces; the
    plain versions, library calls and bounds too when `with_reference`."""
    import importlib.util

    import torch

    sys.path.insert(0, str(root))   # this side's package; this checkout's Case helpers
    found = importlib.util.spec_from_file_location("ab_chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(found)
    found.loader.exec_module(cs)
    from dpm_solver_tpu_torch import ops
    from dpm_solver_tpu_torch.likelihood import hutchinson_divergence
    from dpm_solver_tpu_torch.models import NCSNpp, NCSNppConfig, init_random_
    from dpm_solver_tpu_torch.models.ncsnpp import SelfAttention2D
    from dpm_solver_tpu_torch.ops import _build
    from dpm_solver_tpu_torch.score import get_score_fn
    from dpm_solver_tpu_torch.sde import VPSDE, reverse_sde

    assert Path(_build.__file__).resolve().is_relative_to(root)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    _build.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    dev = torch.device("cuda", 0)

    cfg = NCSNppConfig.cifar10_ddpmpp(deep=True)
    net = init_random_(NCSNpp(cfg, device=dev), torch.Generator(device=dev).manual_seed(0))
    net.eval().requires_grad_(False)
    specs = Counter()

    def hook(mod, args):
        b, h, w, c = args[0].shape
        if isinstance(mod, ops.Conv3x3):
            specs["conv3x3", (b, h, w, c, mod.weight.shape[0])] += 1
        else:
            specs["attention_lse", (b, h * w, h * w, 1, c, True)] += 1

    handles = [m.register_forward_pre_hook(hook) for m in net.modules()
               if isinstance(m, (ops.Conv3x3, SelfAttention2D))]
    side = cfg.image_size
    gen = torch.Generator(device=dev).manual_seed(7)
    x8 = torch.rand(8, side, side, 3, device=dev, generator=gen) * 2 - 1
    net(x8, torch.full((8,), 500.0, device=dev))
    for h in handles:
        h.remove()

    out = {"kernels": {}, "stages": {}}
    for i, ((name, spec), n) in enumerate(sorted(specs.items(), key=str)):
        for kname in ((name, "conv3x3_dx") if name == "conv3x3" else (name,)):
            g = torch.Generator(device=dev).manual_seed(1000 + i)
            randn = lambda *s: torch.randn(*s, device=dev, generator=g)
            case = cs.make_case(kname, spec, randn, dtype=torch.float32)
            row = dict(spec=list(spec), per_forward=n, ms=cs.cuda_ms(case.kernel),
                       device_ms=graph_ms(case.kernel))
            if with_reference:
                row.update(plain_ms=cs.cuda_ms(case.plain), library_ms=cs.cuda_ms(case.library),
                           library_device_ms=graph_ms(case.library),
                           bound_ms=max(case.bound()) * 1e3, work=case.work)
            out["kernels"][f"{kname} {spec}"] = row
            del case
            torch.cuda.empty_cache()

    drift = reverse_sde(VPSDE(), get_score_fn(VPSDE(), net), probability_flow=True).sde
    probe = torch.randint(0, 2, x8.shape, device=dev, generator=gen).float() * 2 - 1
    for b in STAGE_BATCHES:
        x, p, t = x8[:b], probe[:b], torch.full((b,), 0.5, device=dev)
        stage = lambda: hutchinson_divergence(lambda xi, ti: drift(xi, ti)[0], x, t, p)
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stage()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        traced = trace_stage(stage, HERE / "chiprun_out" / f"fp32_ab_trace_{b}.json")
        traced["unprofiled_wall_ms"] = statistics.median(walls[2:]) * 1e3
        out["stages"][f"b{b}"] = traced
    return out


def _mean(values):
    values = list(values)
    return None if any(v is None for v in values) else statistics.mean(values)


def _ms(v, digits: int = 4) -> str:
    return "not captured" if v is None else f"{v:.{digits}f} ms"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="unpacked checkout of the other commit")
    ap.add_argument("--nfe", type=int, default=625, help="NFE of one bits/dim call")
    ap.add_argument("--out", type=Path, default=HERE / "chiprun_out" / "fp32_ab.json")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--reference", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        print(json.dumps(worker(args.worker.resolve(), args.reference)), flush=True)
        return 0
    if args.parent is None or not (args.parent / "dpm_solver_tpu_torch").is_dir():
        ap.error("--parent must be an unpacked checkout holding dpm_solver_tpu_torch/")
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    (HERE / "chiprun_out").mkdir(exist_ok=True)
    runs = {"parent": [], "this": []}
    for side in ("parent", "this", "this", "parent"):
        root = args.parent.resolve() if side == "parent" else HERE
        cmd = [sys.executable, str(HERE / "fp32_ab.py"), "--worker", str(root)]
        if side == "this":
            cmd.append("--reference")
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=1800)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        runs[side].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"{side} run done", flush=True)

    record = {"card": smi, "order": "parent, this, this, parent", "nfe": args.nfe,
              "kernels": {}, "per_call": {}, "stages": {}}
    sums = ("ms", "parent_ms", "device_ms", "parent_device_ms", "plain_ms", "library_ms",
            "library_device_ms", "bound_ms", "work")
    per_call = {name: dict({f: 0.0 for f in sums}, launches=0) for name in KERNELS}
    for key, first in runs["this"][0]["kernels"].items():
        this = [r["kernels"][key] for r in runs["this"]]
        parent = [r["kernels"][key] for r in runs["parent"]]
        row = dict(first, **{f: _mean(r[f] for r in this) for f in (
            "ms", "device_ms", "plain_ms", "library_ms", "library_device_ms")},
            parent_ms=_mean(r["ms"] for r in parent),
            parent_device_ms=_mean(r["device_ms"] for r in parent))
        row["tflops"] = row["work"] / row["ms"] / 1e9
        row["bound_share"] = row["bound_ms"] / row["ms"]
        record["kernels"][key] = row
        name = key.split(" ", 1)[0]
        n = row["per_forward"] * args.nfe
        tot = per_call[name]
        tot["launches"] += n
        for f in sums:
            tot[f] = None if tot[f] is None or row[f] is None else tot[f] + n * row[f]
        print(f"{key} x{n} on {smi}: kernel {row['ms']:.4f} ms ({row['tflops']:.1f} TFLOP/s, "
              f"bound share {row['bound_share']:.3f}; device {_ms(row['device_ms'])}), parent "
              f"{row['parent_ms']:.4f} ms (device {_ms(row['parent_device_ms'])}), plain "
              f"{row['plain_ms']:.4f}, library {row['library_ms']:.4f} (device "
              f"{_ms(row['library_device_ms'])}), bound {row['bound_ms']:.4f}", flush=True)
    for name, tot in per_call.items():
        tot["tflops"] = tot.pop("work") / tot["ms"] / 1e9
        tot["bound_share"] = tot["bound_ms"] / tot["ms"]
        record["per_call"][name] = tot
        print(f"per bits/dim call ({args.nfe} NFE) on {smi}: {name} {tot['ms']:.2f} ms "
              f"(parent {tot['parent_ms']:.2f}), plain {tot['plain_ms']:.2f}, library "
              f"{tot['library_ms']:.2f}, bound {tot['bound_ms']:.2f} ({tot['tflops']:.1f} "
              f"TFLOP/s; {tot['bound_share']:.3f} of the kernel's time); device time alone "
              f"(CUDA graphs): {_ms(tot['device_ms'], 2)} (parent {_ms(tot['parent_device_ms'], 2)}, "
              f"library {_ms(tot['library_device_ms'], 2)}); {tot['launches']} launches",
              flush=True)
    for side in ("parent", "this"):
        for b in STAGE_BATCHES:
            calls = [c for r in runs[side] for c in r["stages"][f"b{b}"]["calls"]]
            share = statistics.median(c["busy_share"] for c in calls)
            wall = statistics.median(c["wall_ms"] for c in calls)
            busy = statistics.median(c["busy_ms"] for c in calls)
            plain_wall = statistics.mean(r["stages"][f"b{b}"]["unprofiled_wall_ms"]
                                         for r in runs[side])
            tops = runs[side][-1]["stages"][f"b{b}"]["top_kernels_ms"]
            record["stages"][f"{side} b{b}"] = dict(
                busy_share=share, wall_ms=wall, busy_ms=busy, unprofiled_wall_ms=plain_wall,
                busy_share_of_unprofiled_wall=busy / plain_wall, kernels=calls[0]["kernels"],
                top_kernels_ms=tops)
            print(f"stage trace {side} b{b} on {smi}: wall {wall:.2f} ms under the profiler "
                  f"({plain_wall:.2f} without), kernels busy {busy:.2f} ms, busy share "
                  f"{share:.3f} of the profiled wall, {busy / plain_wall:.3f} of the wall "
                  f"without the profiler ({calls[0]['kernels']} kernels; median of "
                  f"{len(calls)})", flush=True)
            for name, ms in tops.items():
                print(f"    {ms:9.3f} ms  {name}", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(record, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
