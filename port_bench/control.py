"""Readings of a cell's check over many seeds, for its limits: the program
as the cell runs it (no --variant), or the control (--variant w8a8_conv
for the SD entry: the program's own int8 path; fp8 for the DDPM entry: the
reference with its products' operands rounded to float8).

    python3 port_bench/control.py --workload <cell> --seeds 1,2,3 [--variant V] [--requests N]

One process builds the entry once and, for each seed, loads that seed's
weights in place, runs N requests of the cell's timed path (its batch, its
sizes; N defaults to the requests a run checks), checks them against the
reference as a run does, and prints one JSON line of the numbers. Nothing
is timed. A test under port_bench/tests/ runs it on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "port_bench" / ".cache" / "triton")
sys.path.insert(0, str(ROOT))


def readings(cell, seeds, variant, requests, device, log=print) -> list:
    entry = cell.entry().Entry(cell.config, cell.traffic, seeds[0], device, variant=variant)
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        entry.reseed(seed)
        kept = [(i, entry.request(i, True)[1]) for i in range(requests)]
        numbers = entry.check(kept)
        row = {"workload": cell.name, "variant": variant, "seed": seed, "numbers": numbers,
               "limits": cell.limits, "seconds": time.perf_counter() - t0}
        log(json.dumps(row), flush=True)
        out.append(row)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated whole numbers")
    p.add_argument("--variant", default=None)
    p.add_argument("--requests", type=int, default=None)
    args = p.parse_args(argv)
    import torch

    from port_bench.harness.cell import Cell, load_benchmark

    if not torch.cuda.is_available():
        print("control readings need a CUDA device", file=sys.stderr)
        return 2
    cell = Cell(load_benchmark(ROOT), args.workload, ROOT)
    seeds = [int(s) for s in args.seeds.split(",")]
    n = args.requests or int(cell.traffic["check"]["requests"])
    readings(cell, seeds, args.variant, n, torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
