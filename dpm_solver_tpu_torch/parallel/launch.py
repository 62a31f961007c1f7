"""Start ranks as processes, each in one `torch.distributed` world, and collect their results.

The JAX package is single-controller: one process drives every device. The
port runs one process a rank (`torch.distributed`'s idiom); `run_ranks`
starts them with the spawn method, joins them within a timeout, and returns
each rank's result. A rank that raises, dies or outlives the timeout fails
the whole run: every other rank is killed (a rank blocked in a collective
with a dead peer would never return) and the error names the rank and
carries its traceback. Each rank's file descriptor 2 (and `faulthandler`)
goes to a file in the run's directory, so a rank that dies in native code
(an abort, a signal) without a Python traceback still names its cause: the
error carries that file's tail. A run that succeeds echoes each rank's
captured stderr on the caller's.

The ranks meet through a file under a fresh temporary directory (a
`FileStore`), never a fixed port, so that several worlds run side by side.
"""

from __future__ import annotations

import faulthandler
import gc
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

DEFAULT_TIMEOUT = 600.0
# how much of a dead rank's captured stderr its error carries
STDERR_TAIL = 8000


def _rank_main(fn: Callable, rank: int, world: int, backend: str, directory: str,
               args: Sequence, threads: Optional[int]) -> None:
    """One rank: join the group, run `fn`, tear the group down, write the
    result (or the traceback), then end the process at once.

    The teardown is explicit. `destroy_process_group` unregisters the groups,
    but their native state (gloo's socket loop and the backend's worker
    threads) lives on while Python objects still hold the groups (a
    DeviceMesh, a sampler's closures, a reference cycle). Left to the
    interpreter's exit, that state is torn down in no set order while a peer
    closes its sockets, and the rank can die with "terminate called without
    an active exception" (SIGABRT). So every rank first waits at a barrier
    for the others to leave their last collective, then destroys the groups
    and collects the garbage that holds them, and finally leaves by
    `os._exit`, with no second teardown at exit."""
    import torch
    import torch.distributed as dist

    out = os.path.join(directory, f"rank{rank}")
    # fd 2 itself, so that native code's messages (gloo's, an abort's) land there too
    log = open(out + ".stderr", "w")
    os.dup2(log.fileno(), 2)
    faulthandler.enable(log)
    if threads is not None:
        torch.set_num_threads(threads)
    code = 1
    try:
        dist.init_process_group(backend, init_method=f"file://{os.path.join(directory, 'store')}",
                                rank=rank, world_size=world)
        try:
            result = fn(rank, world, *args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
            gc.collect()
        with open(out + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(out + ".tmp", out + ".pkl")
        code = 0
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        traceback.print_exc()
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)


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
            if failed:   # each failed rank (a peer's death may fail the others too)
                raise RuntimeError("\n".join(_failure(directory, r, world, procs[r].exitcode)
                                             for r in failed))
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
            sys.stderr.write(_read(directory, r))
        return results
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.kill()
        for p in started:
            p.join(5)
        shutil.rmtree(directory, ignore_errors=True)


def _failure(directory: str, rank: int, world: int, code: int) -> str:
    """What a failed rank left: its traceback, else (a native death) whether
    it had written its result and the tail of its stderr."""
    err = os.path.join(directory, f"rank{rank}.err")
    if os.path.exists(err):
        with open(err) as f:
            detail = f.read()
    else:
        done = os.path.exists(os.path.join(directory, f"rank{rank}.pkl"))
        detail = (f"(no traceback written; the rank had {'' if done else 'not '}written its "
                  f"result; its stderr ends:)\n" + _read(directory, rank)[-STDERR_TAIL:])
    return f"rank {rank} of {world} failed with exit code {code}:\n{detail}"


def _read(directory: str, rank: int) -> str:
    """What `rank` wrote to its stderr so far ("" if nothing)."""
    try:
        with open(os.path.join(directory, f"rank{rank}.stderr"), errors="replace") as f:
            return f.read()
    except FileNotFoundError:
        return ""
