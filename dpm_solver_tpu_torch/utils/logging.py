"""Observability: a metrics writer, image grids, profiler spans, a wall timer.

Port of `dpm_solver_tpu/utils/logging.py`, the counterpart of the
reference's TensorBoard writers (score_sde run_lib.py:34,68,165), its
multi-format key-value logger (guided_diffusion/logger.py:26-490) and its
image-grid savers (score_sde utils.py:51-101). The files are the JAX
package's, byte for byte but the wall-clock `time` field: `metrics.jsonl`
(one record a `write`), `metrics.csv` (its header rewritten when new keys
appear). TensorBoard is written through PyTorch's own writer
(`torch.utils.tensorboard`, where the `tensorboard` package imports; the JAX
package's goes through `tensorflow`, which the port does not use); PNG only
where PIL imports, else the grid goes to `<path>.npy` as uint8. Spans are
`torch.profiler.record_function` ranges (the JAX package's
`jax.profiler.TraceAnnotation`).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Iterator, Optional

import numpy as np


class MetricWriter:
    """Scalars to JSONL (always), and to CSV, stdout and TensorBoard on request."""

    def __init__(self, logdir: str, *, tensorboard: bool = True, csv: bool = False,
                 stdout: bool = False):
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self._csv_path = os.path.join(logdir, "metrics.csv") if csv else None
        self._csv_keys = []
        self._csv_rows = []
        self._stdout = stdout
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass
            else:
                self._tb = SummaryWriter(logdir)

    def _write_csv(self) -> None:
        with open(self._csv_path, "w") as f:
            f.write(",".join(["step"] + self._csv_keys) + "\n")
            for row in self._csv_rows:
                f.write(",".join(str(row.get(k, "")) for k in ["step"] + self._csv_keys) + "\n")

    def write(self, step: int, **scalars) -> None:
        values = {k: float(v) for k, v in scalars.items()}
        self._jsonl.write(json.dumps({"step": int(step), "time": time.time(), **values}) + "\n")
        self._jsonl.flush()
        if self._csv_path is not None:
            self._csv_keys.extend(sorted(k for k in scalars if k not in self._csv_keys))
            self._csv_rows.append({"step": int(step), **values})
            self._write_csv()
        if self._stdout:
            kv = " | ".join(f"{k} {v:.6g}" for k, v in sorted(values.items()))
            print(f"step {int(step):>9} | {kv}", flush=True)
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, v, global_step=int(step))
            self._tb.flush()

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def image_grid(images, *, ncols: Optional[int] = None, pad: int = 2) -> np.ndarray:
    """(B, H, W, C) in [0, 1] (numpy or a tensor) -> one (gH, gW, C) grid,
    padded with ones (ref utils.py:51-101)."""
    if hasattr(images, "detach"):
        images = images.detach().cpu().numpy()
    images = np.asarray(images)
    b, h, w, c = images.shape
    ncols = ncols or int(np.ceil(np.sqrt(b)))
    nrows = int(np.ceil(b / ncols))
    grid = np.ones((nrows * (h + pad) - pad, ncols * (w + pad) - pad, c), images.dtype)
    for i, img in enumerate(images):
        r, k = divmod(i, ncols)
        grid[r * (h + pad):r * (h + pad) + h, k * (w + pad):k * (w + pad) + w] = img
    return grid


def save_image_grid(images, path: str, **kwargs) -> None:
    """`image_grid` as a PNG at `path`, or as `<path>.npy` (uint8) without PIL."""
    grid = image_grid(images, **kwargs)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arr = (np.clip(grid, 0.0, 1.0) * 255).astype(np.uint8)
    try:
        from PIL import Image
    except ImportError:
        np.save(path + ".npy", arr)
        return
    Image.fromarray(arr.squeeze()).save(path)


@contextlib.contextmanager
def trace_span(name: str) -> Iterator[None]:
    """A named range in `torch.profiler` traces."""
    import torch

    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def wall_timer() -> Iterator[dict]:
    """The host's wall clock over the block: yields a dict whose "seconds" is
    set on exit (time device work only after synchronising it)."""
    out = {}
    t0 = time.perf_counter()
    yield out
    out["seconds"] = time.perf_counter() - t0


__all__ = ["MetricWriter", "image_grid", "save_image_grid", "trace_span", "wall_timer"]
