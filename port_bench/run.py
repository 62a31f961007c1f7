"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json, port_bench/ and the
program (dpm_solver_tpu_torch/). It needs as many CUDA cards as the cell
asks for and exits 2, printing no result, without them. The last line of
standard output is one JSON object (correct, attempted, failed, metrics,
device, with --trace 1 breakdown, and last the checks: every number
compared beside its limit), and the last lines of standard error are those
checks. With --trace 0 the metrics are the cell's end-to-end metrics, with
--trace 1 its per-layer ones.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the program's kernel caches live at fixed paths inside the checkout, so
# that every run after a checkout's first finds its kernels built
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "port_bench" / ".cache" / "triton")
sys.path.insert(0, str(ROOT))


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from port_bench.harness import guard, runner
    from port_bench.harness.cell import Cell, load_benchmark

    bad = guard.loaded_forbidden()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    cell = Cell(load_benchmark(ROOT), args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                        torch.device("cuda", 0), T_START)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
