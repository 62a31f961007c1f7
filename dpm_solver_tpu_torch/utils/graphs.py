"""A CUDA-graph capture that host steps split into segments.

`GraphedSampler` captures a whole fixed-grid trajectory as CUDA graphs. A
trajectory that communicates between ranks inside its network (tensor
parallelism, `parallel/tp.py`) reaches a collective. An NCCL collective is
device work, which the graph holds. A gloo collective is host work, which a
graph may not hold: it calls `host_step(fn)` (`parallel/mesh.py::all_reduce_`).
While a `SegmentedGraph` captures, this ends the current graph, records `fn` to
run between it and the next one, and begins the next; outside a capture it runs
`fn` at once. A replay launches each segment's graph, then that segment's host
step, in capture order, on the current stream. A capture that meets no host
step is one graph, as `torch.cuda.graph` would make it.

The segments share one memory pool (the tensor a host step works on lives
across the split), which CUDA graphs allow when they replay in the order they
were captured, as here.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

_ACTIVE: List["SegmentedGraph"] = []


def host_step(fn: Callable[[], None]) -> None:
    """Run `fn` now, or, inside a `SegmentedGraph` capture, at that point of
    every replay (the capture is split there)."""
    if _ACTIVE:
        _ACTIVE[-1]._split(fn)
    else:
        fn()


class SegmentedGraph:
    """`capture(fn, *args)` once, then `replay()`."""

    def __init__(self):
        self._graphs: List[torch.cuda.CUDAGraph] = []
        self._steps: List[Callable[[], None]] = []
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None

    def _begin(self) -> None:
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self._pool)
        self._graphs.append(graph)

    def _split(self, fn: Callable[[], None]) -> None:
        self._graphs[-1].capture_end()
        self._steps.append(fn)
        self._begin()

    def capture(self, fn: Callable, *args):
        """Capture `fn(*args)` on a side stream; returns its output (static
        tensors a replay rewrites)."""
        # what torch.cuda.graph does before a capture: free what it can
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        self._pool = torch.cuda.graph_pool_handle()
        self._stream = torch.cuda.Stream()
        _ACTIVE.append(self)
        try:
            with torch.cuda.stream(self._stream):
                self._begin()
                try:
                    out = fn(*args)
                finally:
                    self._graphs[-1].capture_end()
        finally:
            _ACTIVE.pop()
        return out

    def replay(self) -> None:
        for i, graph in enumerate(self._graphs):
            graph.replay()
            if i < len(self._steps):
                self._steps[i]()
