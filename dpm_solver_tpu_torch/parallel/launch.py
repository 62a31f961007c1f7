"""Start ranks as processes, each in one `torch.distributed` world, and collect their results.

The JAX package is single-controller: one process drives every device. The
port runs one process a rank (`torch.distributed`'s idiom); `run_ranks`
starts them with the spawn method, joins them within a timeout, and returns
each rank's result. A rank that raises, dies or outlives the timeout fails
the whole run: every other rank is killed (a rank blocked in a collective
with a dead peer would never return) and the error names the rank and
carries its traceback.

The ranks meet through a file under a fresh temporary directory (a
`FileStore`), never a fixed port, so that several worlds run side by side.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

DEFAULT_TIMEOUT = 600.0


def _rank_main(fn: Callable, rank: int, world: int, backend: str, directory: str,
               args: Sequence, threads: Optional[int]) -> None:
    import torch
    import torch.distributed as dist

    if threads is not None:
        torch.set_num_threads(threads)
    out = os.path.join(directory, f"rank{rank}")
    try:
        dist.init_process_group(backend, init_method=f"file://{os.path.join(directory, 'store')}",
                                rank=rank, world_size=world)
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        with open(out + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(out + ".tmp", out + ".pkl")
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn: Callable, world: int, *, args: Sequence = (), backend: str = "gloo",
              timeout: float = DEFAULT_TIMEOUT, threads: Optional[int] = None,
              directory: Optional[str] = None) -> List[Any]:
    """Run `fn(rank, world, *args)` in `world` new processes, each a rank of
    one process group on `backend` ("gloo" or "nccl"), and return the
    results in rank order (each pickled; return host values). `fn` must be
    importable by name (a module-level function). `threads` sets each rank's
    torch intra-op threads (1 where several ranks share a few cores).
    The store and the results go to a new directory under `directory` (the
    system's temporary directory by default), removed at the end. Raises
    RuntimeError when a rank fails and TimeoutError when the ranks have not
    all finished `timeout` seconds after the start."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    directory = tempfile.mkdtemp(prefix="dpm_ranks_", dir=directory)
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, backend, directory, tuple(args),
                                                   threads), daemon=True)
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while True:
            failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if failed:
                r = failed[0]
                err = os.path.join(directory, f"rank{r}.err")
                detail = open(err).read() if os.path.exists(err) else "(no traceback written)"
                raise RuntimeError(f"rank {r} of {world} failed with exit code "
                                   f"{procs[r].exitcode}:\n{detail}")
            if all(p.exitcode == 0 for p in procs):
                break
            if time.monotonic() > deadline:
                hung = [r for r, p in enumerate(procs) if p.exitcode is None]
                raise TimeoutError(f"ranks {hung} of {world} still running after {timeout:.0f} s")
            for p in procs:
                if p.exitcode is None:
                    p.join(0.05)
                    break
        results = []
        for r in range(world):
            with open(os.path.join(directory, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.kill()
        for p in started:
            p.join(5)
        shutil.rmtree(directory, ignore_errors=True)
