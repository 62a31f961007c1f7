"""Checkpointing and preemption recovery.

Counterpart of `dpm_solver_tpu/training/checkpoints.py` (the reference's
score_sde_jax/run_lib.py:83-90, 167-194, 314-372): step-keyed checkpoints
of a training state with a bound on how many are kept, restore-or-init at
start, a poll for a checkpoint's arrival, and the `EvalMeta` JSON sidecar
that makes evaluation rounds resumable.

Where the JAX package writes with orbax, the port writes one `torch.save`
file a step (`<directory>/<step>/state.pt`), first into a temporary
directory beside it and then renamed into place, so a reader sees a whole
checkpoint or none. A tree is a state dataclass (`TrainState`,
`AdversarialTrainState`: its fields), or dictionaries, lists and tuples of
tensors and Python scalars; tensors are stored from host copies
and restored into the template's own tensors in place (so a restored
state updates its modules' parameters). `EvalMeta` files are the
JAX package's JSON, field for field.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
import time
from typing import Any, Optional

import torch

_FILE = "state.pt"


def _fields(tree: Any) -> Optional[list]:
    """The field names of a state dataclass (a `TrainState`, an
    `AdversarialTrainState`), else None."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [f.name for f in dataclasses.fields(tree)]
    return None


def _to_host(tree: Any) -> Any:
    if _fields(tree) is not None:
        return {name: _to_host(getattr(tree, name)) for name in _fields(tree)}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


@torch.no_grad()
def _fill(template: Any, saved: Any, where: str = "") -> Any:
    """`saved` into `template`'s structure: tensors copied into the
    template's in place, everything else replaced."""
    if _fields(template) is not None:
        for name in _fields(template):
            setattr(template, name, _fill(getattr(template, name), saved[name],
                                          f"{where}.{name}" if where else name))
        return template
    if isinstance(template, torch.Tensor):
        if tuple(template.shape) != tuple(saved.shape):
            raise ValueError(f"checkpoint {where}: shape {tuple(saved.shape)} where the "
                             f"template has {tuple(template.shape)}")
        return template.copy_(saved)
    if isinstance(template, dict):
        if set(template) != set(saved):
            raise ValueError(f"checkpoint {where}: keys differ from the template's "
                             f"({sorted(set(template) ^ set(saved))[:5]} ...)")
        for k in template:
            template[k] = _fill(template[k], saved[k], f"{where}.{k}")
        return template
    if isinstance(template, (list, tuple)):
        return type(template)(_fill(t, s, f"{where}[{i}]")
                              for i, (t, s) in enumerate(zip(template, saved)))
    return saved


class CheckpointManager:
    """Step-keyed checkpoints of a tree (a TrainState, parameters, ...) in
    `directory`, the newest `max_to_keep` kept (None: all)."""

    def __init__(self, directory: str, *, max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def save(self, step: int, tree: Any) -> None:
        """Write `tree` as checkpoint `step` (atomically: a temporary
        directory renamed into place, synchronously), then drop the oldest
        beyond max_to_keep."""
        tmp = tempfile.mkdtemp(prefix=f".{step}-", dir=self.directory)
        try:
            torch.save(_to_host(tree), os.path.join(tmp, _FILE))
            final = self._path(step)
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._path(old), ignore_errors=True)

    def restore(self, tree_like: Any, step: Optional[int] = None) -> Any:
        """Checkpoint `step` (the newest by default) into `tree_like`."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        saved = torch.load(os.path.join(self._path(step), _FILE), map_location="cpu",
                           weights_only=True)
        return _fill(tree_like, saved)

    def all_steps(self) -> list:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isfile(os.path.join(self._path(int(d)), _FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None


def restore_or_init(manager: CheckpointManager, init_tree: Any) -> Any:
    """Preemption-safe start: the newest checkpoint if there is one, else
    `init_tree` as it is (ref run_lib.py:83-90)."""
    if manager.latest_step() is None:
        return init_tree
    return manager.restore(init_tree)


def wait_for_checkpoint(manager: CheckpointManager, step: int, *, poll_seconds: float = 60.0,
                        timeout: Optional[float] = None) -> bool:
    """Block until checkpoint `step` or a later one exists (ref polling loop,
    run_lib.py:353-372). False on timeout."""
    t0 = time.time()
    while True:
        latest = manager.latest_step()
        if latest is not None and latest >= step:
            return True
        if timeout is not None and time.time() - t0 > timeout:
            return False
        time.sleep(poll_seconds)


@dataclasses.dataclass
class EvalMeta:
    """Resumable-evaluation progress (ref run_lib.py:314-346): the
    checkpoint, sampling round and bpd round to continue from, and the seed
    of the rounds' randomness as a JAX key's two uint32 words (so the JSON is
    the JAX package's: `PRNGKey(s)` is (0, s) for s < 2^32)."""

    ckpt_id: int = 0
    sampling_round_id: int = -1
    bpd_round_id: int = -1
    rng_key_data: tuple = (0, 0)

    @property
    def seed(self) -> int:
        hi, lo = (int(v) for v in self.rng_key_data)
        return (hi << 32) | lo

    @property
    def rng(self) -> torch.Generator:
        """A CPU generator seeded from the key data."""
        return torch.Generator().manual_seed(self.seed)

    def with_rng(self, seed: int) -> "EvalMeta":
        seed = int(seed)
        return dataclasses.replace(self, rng_key_data=((seed >> 32) & 0xFFFFFFFF,
                                                       seed & 0xFFFFFFFF))


def _host_id(host_id: Optional[int]) -> int:
    if host_id is not None:
        return host_id
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _meta_path(directory: str, host_id: Optional[int]) -> str:
    return os.path.join(directory, f"eval_meta_host{_host_id(host_id)}.json")


def save_eval_meta(meta: EvalMeta, directory: str, *, host_id: Optional[int] = None) -> str:
    """Atomic JSON write, one file a host (ref run_lib.py:426-433)."""
    os.makedirs(directory, exist_ok=True)
    path = _meta_path(directory, host_id)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(dataclasses.asdict(meta), f)
    os.replace(tmp, path)
    return path


def load_eval_meta(directory: str, *, host_id: Optional[int] = None) -> EvalMeta:
    path = _meta_path(directory, host_id)
    if not os.path.exists(path):
        return EvalMeta()
    with open(path) as f:
        d = json.load(f)
    d["rng_key_data"] = tuple(d.get("rng_key_data", (0, 0)))
    return EvalMeta(**d)


def delete_eval_meta(directory: str, *, host_id: Optional[int] = None) -> None:
    """Remove the progress marker once evaluation completes (ref
    run_lib.py:591-595)."""
    path = _meta_path(directory, host_id)
    if os.path.exists(path):
        os.remove(path)
