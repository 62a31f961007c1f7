"""Text conditioning: the hermetic stand-in encoder.

Port of `dpm_solver_tpu/models/text_encoder.py::constant_context_encoder`.
The CLIP and BERT encoders (`FrozenCLIPEmbedder`, `BERTEmbedder`) are not
ported yet: no weights for them are in the repository.
"""

from __future__ import annotations

from typing import Callable, Sequence, Union

import numpy as np
import torch


def constant_context_encoder(context_dim: int, max_length: int = 77,
                             seed: int = 0) -> Callable:
    """Deterministic stand-in encoder for tests and smoke runs: hashes each
    prompt to a fixed pseudo-random (max_length, context_dim) block.

    The same function as the JAX one: numpy's RandomState seeded from
    `hash((seed, prompt))`, so within one process both give the same values.
    Returns fp32 (B, max_length, context_dim) on the CPU; the caller moves it
    (`LatentDiffusion.get_learned_conditioning` moves it to the UNet's device).
    """

    def encode(prompts: Union[str, Sequence[str]]) -> torch.Tensor:
        if isinstance(prompts, str):
            prompts = [prompts]
        rows = []
        for p in prompts:
            h = abs(hash((seed, p))) % (2 ** 31)
            rows.append(np.random.RandomState(h).randn(max_length, context_dim)
                        .astype(np.float32))
        return torch.from_numpy(np.stack(rows))

    return encode
