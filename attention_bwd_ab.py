#!/usr/bin/env python3
"""Time the attention backward kernels of two checkouts on one GPU, in turns.

    python3 attention_bwd_ab.py --parent DIR [--out FILE]

DIR is an unpacked checkout of the commit to compare against (for example
`git archive <commit> | tar -x -C DIR`); the checkout this script lives in
is the other side. Each side runs in its own process, which imports that
side's `dpm_solver_tpu_torch`, builds its kernels into that side's build
directory and times `attention_dq` and `attention_dkv` (CUDA events, one
launch a call, as `chip_smoke.py`'s `cuda_ms`) at every site below in fp32
and bf16, on inputs drawn from one seed per site and dtype. The order is
parent, this, this, parent; each side's time is the mean of its two runs.
The runs of this side also time the plain twin and SDPA's backward, which
compute dq, dk and dv in one call, and the sites' bound (`chip_smoke.py`'s
`Case.bound`). A site that one side refuses (the parent's bf16 dh 512) is
reported as such. Prints one line a site and dtype, the card's name and
power limit, and writes the JSON record to FILE (default
chiprun_out/attention_bwd_ab.json).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
# (b, t, s, heads, dh, q/k/v as slices of one projection): chip_smoke.py's
# timed BWD_SHAPES sites (path E's dh 256 among them), then path C's
# classifier attentions (32x32, 16x16, 8x8, the attention pool)
SITES = [(8, 256, 256, 1, 256, True), (8, 256, 256, 1, 256, False),
         (2, 4096, 4096, 8, 40, False), (2, 4096, 77, 8, 40, False),
         (2, 1024, 1024, 8, 80, False), (2, 1024, 77, 8, 80, False),
         (2, 256, 256, 8, 160, False), (2, 256, 77, 8, 160, False),
         (2, 64, 64, 8, 160, False), (2, 64, 64, 8, 32, False), (2, 256, 256, 4, 128, False),
         (1, 1024, 1024, 1, 512, False),
         (8, 1024, 1024, 4, 64, False), (8, 256, 256, 8, 64, False), (8, 64, 64, 8, 64, False),
         (8, 65, 65, 8, 64, True)]


def worker(root: Path, with_reference: bool) -> dict:
    """Time one side's kernels at every site; the plain twin, SDPA's
    backward and the bound too when `with_reference`."""
    import importlib.util

    import torch

    sys.path.insert(0, str(root))   # this side's package; this checkout's Case helpers
    found = importlib.util.spec_from_file_location("ab_chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(found)
    found.loader.exec_module(cs)
    from dpm_solver_tpu_torch.ops import _build

    assert Path(_build.__file__).resolve().is_relative_to(root)

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    _build.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    dev = torch.device("cuda", 0)
    out = {}
    for i, spec in enumerate(SITES):
        for dt in (torch.float32, torch.bfloat16):
            key = f"{spec} {str(dt)[6:]}"
            row = {}
            for name in ("attention_dq", "attention_dkv"):
                g = torch.Generator(device=dev).manual_seed(1000 * i + (dt == torch.bfloat16))
                randn = lambda *s: torch.randn(*s, device=dev, generator=g)
                case = cs.make_case(name, spec, randn, dtype=dt)
                try:
                    case.kernel()
                    torch.cuda.synchronize()
                except (ValueError, RuntimeError) as err:
                    row[name] = f"refused: {str(err)[:80]}"
                    continue
                row[name] = cs.cuda_ms(case.kernel)
                if with_reference:
                    row[name + "_bound_ms"] = max(case.bound()) * 1e3
                    row[name + "_work"] = case.work
            if with_reference:   # the plain twin and SDPA each compute all three
                row["plain_ms"] = cs.cuda_ms(case.plain)
                row["library_ms"] = cs.cuda_ms(case.library)
            del case
            torch.cuda.empty_cache()
            out[key] = row
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="unpacked checkout of the other commit")
    ap.add_argument("--out", type=Path, default=HERE / "chiprun_out" / "attention_bwd_ab.json")
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
    runs = {"parent": [], "this": []}
    for side in ("parent", "this", "this", "parent"):
        root = args.parent.resolve() if side == "parent" else HERE
        cmd = [sys.executable, str(HERE / "attention_bwd_ab.py"), "--worker", str(root)]
        if side == "this":
            cmd.append("--reference")
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=1800)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        runs[side].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"{side} run done", flush=True)
    record = {"card": smi, "order": "parent, this, this, parent", "sites": {}}
    for key in runs["this"][0]:
        this, parent = [r[key] for r in runs["this"]], [r[key] for r in runs["parent"]]
        row = {}
        for name in ("attention_dq", "attention_dkv"):
            row[name] = statistics.mean(r[name] for r in this)
            pv = [r[name] for r in parent]
            row[name + "_parent"] = pv[0] if isinstance(pv[0], str) else statistics.mean(pv)
            row[name + "_bound_ms"] = this[0][name + "_bound_ms"]
            row[name + "_work"] = this[0][name + "_work"]
        for ref in ("plain_ms", "library_ms"):
            row[ref] = statistics.mean(r[ref] for r in this)
        total = row["attention_dq"] + row["attention_dkv"]
        bound = row["attention_dq_bound_ms"] + row["attention_dkv_bound_ms"]
        row["tflops"] = (row["attention_dq_work"] + row["attention_dkv_work"]) / total / 1e9
        row["bound_share"] = bound / total
        parent_total = (None if isinstance(row["attention_dq_parent"], str) else
                        row["attention_dq_parent"] + row["attention_dkv_parent"])
        record["sites"][key] = row
        was = (f"parent {row['attention_dq_parent']:.4f} + {row['attention_dkv_parent']:.4f} = "
               f"{parent_total:.4f}" if parent_total is not None else
               f"parent {row['attention_dq_parent']}")
        print(f"{key} on {smi}: dq {row['attention_dq']:.4f} + dk/dv {row['attention_dkv']:.4f} "
              f"= {total:.4f} ms ({row['tflops']:.1f} TFLOP/s, bound {bound:.4f}, share "
              f"{row['bound_share']:.3f}); {was}; plain {row['plain_ms']:.4f}, SDPA backward "
              f"{row['library_ms']:.4f}", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(record, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
