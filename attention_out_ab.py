#!/usr/bin/env python3
"""Time `attention_out_fused` of two checkouts on one GPU, in turns.

    python3 attention_out_ab.py --parent DIR [--out FILE]

DIR is an unpacked checkout of the commit to compare against (for example
`git archive <commit> | tar -x -C DIR`); the checkout this script lives in
is the other side. Each side runs in its own process, which imports that
side's `dpm_solver_tpu_torch`, builds its kernels into that side's build
directory and times `attention_out_fused` in bf16 (CUDA events, one launch
a call, as `chip_smoke.py`'s `cuda_ms`) at `chip_smoke.py`'s timed sites of
it, on inputs drawn from one seed per site. The order is parent, this,
this, parent; each side's time is the mean of its two runs. The runs of
this side also time the port's unfused composition (token_attention, then
F.linear with the bias, then the add), the library composition (SDPA, then
torch.addmm onto the residual) and the site's bound (`chip_smoke.py`'s
`Case.bound`). A site that one side refuses (the parent takes dh 64 with
H*dh <= 1024 only) is reported as such. Prints one line a site, the card's
name and power limit, and writes the JSON record to FILE (default
chiprun_out/attention_out_ab.json).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
# (b, t, s, heads, dh, c): SD-2.1 768 px at CFG b8 (96x96 and 48x48: row 10's first
# sites; 24x24, 12x12), SD-1 512 px at CFG b2 (self- and
# cross-attention), the single heads of dh 256 and 512
SITES = [(8, 9216, 9216, 5, 64, 320), (8, 2304, 2304, 10, 64, 640),
         (8, 576, 576, 20, 64, 1280), (8, 144, 144, 20, 64, 1280),
         (2, 4096, 4096, 8, 40, 320), (2, 1024, 1024, 8, 80, 640),
         (2, 256, 256, 8, 160, 1280), (2, 64, 64, 8, 160, 1280),
         (2, 4096, 77, 8, 40, 320), (2, 1024, 77, 8, 80, 640), (2, 256, 77, 8, 160, 1280),
         (8, 256, 256, 1, 256, 256), (1, 1024, 1024, 1, 512, 512)]


def worker(root: Path, with_reference: bool) -> dict:
    """Time one side's kernel at every site; the yardsticks and the bound
    too when `with_reference`."""
    import importlib.util

    import torch
    import torch.nn.functional as F

    sys.path.insert(0, str(root))   # this side's package; this checkout's Case helpers
    found = importlib.util.spec_from_file_location("ab_chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(found)
    found.loader.exec_module(cs)
    from dpm_solver_tpu_torch import ops
    from dpm_solver_tpu_torch.ops import _build

    assert Path(_build.__file__).resolve().is_relative_to(root)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    _build.library()
    torch.set_grad_enabled(False)
    dev = torch.device("cuda", 0)
    out = {}
    for i, spec in enumerate(SITES):
        g = torch.Generator(device=dev).manual_seed(1000 + i)
        randn = lambda *s: torch.randn(*s, device=dev, generator=g)
        case = cs.make_case("attention_out_fused", spec, randn)
        row = {}
        try:
            case.kernel()
            torch.cuda.synchronize()
            row["ms"] = cs.cuda_ms(case.kernel)
        except (ValueError, RuntimeError) as err:
            row["ms"] = f"refused: {str(err)[:80]}"
        if with_reference:
            b, t, s, heads, dh, c = spec
            inner = heads * dh
            q, k, v = (randn(b, n, inner).to(torch.bfloat16) for n in (t, s, s))
            wt = (randn(c, inner) * inner ** -0.5).to(torch.bfloat16)
            bias, res = (randn(c) * 0.1).to(torch.bfloat16), randn(b, t, c).to(torch.bfloat16)
            row["unfused_ms"] = cs.cuda_ms(lambda: torch.add(F.linear(
                ops.token_attention(q, k, v, num_heads=heads), wt, bias), res))
            row["library_ms"] = cs.cuda_ms(case.library)
            row["bound_ms"] = max(case.bound()) * 1e3
            row["work"] = case.work
            del q, k, v, wt, res
        del case
        torch.cuda.empty_cache()
        out[str(spec)] = row
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="unpacked checkout of the other commit")
    ap.add_argument("--out", type=Path, default=HERE / "chiprun_out" / "attention_out_ab.json")
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
        cmd = [sys.executable, str(HERE / "attention_out_ab.py"), "--worker", str(root)]
        if side == "this":
            cmd.append("--reference")
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=1800)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        runs[side].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"{side} run done", flush=True)
    mean = lambda vals: vals[0] if isinstance(vals[0], str) else statistics.mean(vals)
    record = {"card": smi, "order": "parent, this, this, parent", "sites": {}}
    for key in runs["this"][0]:
        row = {name: mean([r[key][name] for r in runs["this"]])
               for name in ("ms", "unfused_ms", "library_ms")}
        row.update(bound_ms=runs["this"][0][key]["bound_ms"],
                   parent_ms=mean([r[key]["ms"] for r in runs["parent"]]))
        row["tflops"] = runs["this"][0][key]["work"] / row["ms"] / 1e9
        row["bound_share"] = row["bound_ms"] / row["ms"]
        record["sites"][key] = row
        was = (f"{row['parent_ms']:.4f} ms" if not isinstance(row["parent_ms"], str)
               else row["parent_ms"])
        print(f"{key} on {smi}: fused {row['ms']:.4f} ms ({row['tflops']:.1f} TFLOP/s, bound "
              f"{row['bound_ms']:.4f}, share {row['bound_share']:.3f}); parent {was}; unfused "
              f"{row['unfused_ms']:.4f}, library {row['library_ms']:.4f}", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(record, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
