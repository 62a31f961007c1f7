"""Safety checker: CLIP-space concept screening of generated images.

Port of `dpm_solver_tpu/utils/safety.py`, the twin of the checker the
reference wires into txt2img (scripts/txt2img.py:26-29,88-95: diffusers'
StableDiffusionSafetyChecker + ``check_safety`` replacing flagged samples).
Same decision rule as the diffusers module: cosine similarity of the
projected CLIP image embedding against "special care" and concept
embeddings, per-concept thresholds, and a 0.01 threshold bonus when any
special-care concept fires.

The concept/threshold tensors come from a local safety-checker torch
checkpoint (nothing is downloaded); the image embedder is any callable
mapping [-1,1] NHWC images -> (B, D) projected CLIP embeddings, a numpy
array or a tensor on any device (`models.FrozenCLIPImageEmbedder`, or a stub
in tests). The rule itself runs in numpy on the host, as in the JAX module.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np


def _host(x) -> np.ndarray:
    """An embedding as numpy (a tensor on any device is read back)."""
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x)


def _cosine(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-12)
    b = b / np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-12)
    return a @ b.T


class SafetyChecker:
    """images -> (checked_images, has_nsfw_concept) like the reference's
    ``check_safety`` (txt2img.py:88-95). Flagged samples are replaced with
    ``replacement`` (an image array) or zeroed, standing in for the
    reference's ``load_replacement`` asset swap (:77-85)."""

    def __init__(self, image_embedder: Callable,
                 concept_embeds: np.ndarray,
                 concept_thresholds: Sequence[float],
                 special_embeds: Optional[np.ndarray] = None,
                 special_thresholds: Optional[Sequence[float]] = None,
                 replacement: Optional[np.ndarray] = None):
        self.image_embedder = image_embedder
        self.concept_embeds = np.asarray(concept_embeds, np.float32)
        self.concept_thresholds = np.asarray(concept_thresholds, np.float32)
        if (special_embeds is None) != (special_thresholds is None):
            raise ValueError("special_embeds and special_thresholds must be "
                             "given together")
        self.special_embeds = (None if special_embeds is None
                               else np.asarray(special_embeds, np.float32))
        self.special_thresholds = (None if special_thresholds is None
                                   else np.asarray(special_thresholds,
                                                   np.float32))
        self.replacement = replacement

    def flag(self, images) -> np.ndarray:
        """[-1,1] NHWC images -> bool (B,) nsfw flags (diffusers rule)."""
        emb = _host(self.image_embedder(images))
        adjustment = np.zeros((emb.shape[0], 1), np.float32)
        if self.special_embeds is not None:
            special = _cosine(emb, self.special_embeds) - self.special_thresholds
            # any special-care hit makes the concept screen stricter
            adjustment = np.where(
                (special > 0.0).any(axis=1, keepdims=True), 0.01, 0.0)
        scores = _cosine(emb, self.concept_embeds) \
            - self.concept_thresholds + adjustment
        return (scores > 0.0).any(axis=1)

    def __call__(self, images) -> Tuple[np.ndarray, np.ndarray]:
        images = np.asarray(images)
        flags = self.flag(images)
        checked = images.copy()
        for i in np.nonzero(flags)[0]:
            checked[i] = (self.replacement if self.replacement is not None
                          else np.zeros_like(checked[i]))
        return checked, flags


def load_safety_checker(path: str, image_embedder: Callable,
                        replacement: Optional[np.ndarray] = None
                        ) -> SafetyChecker:
    """Build from a diffusers StableDiffusionSafetyChecker torch checkpoint:
    reads concept_embeds / special_care_embeds and their *_weights
    (threshold) tensors. The CLIP vision tower itself is supplied as
    ``image_embedder`` (e.g. `models.FrozenCLIPImageEmbedder` over the same
    local CLIP checkout)."""
    from dpm_solver_tpu_torch.utils.convert import load_torch_state_dict

    sd = {k: v.numpy() for k, v in load_torch_state_dict(path).items()}
    need = ("concept_embeds", "concept_embeds_weights")
    for k in need:
        if k not in sd:
            raise ValueError(f"{path}: missing {k} (not a safety checker?)")
    has_special = ("special_care_embeds" in sd
                   and "special_care_embeds_weights" in sd)
    return SafetyChecker(
        image_embedder,
        concept_embeds=sd["concept_embeds"],
        concept_thresholds=sd["concept_embeds_weights"],
        special_embeds=sd["special_care_embeds"] if has_special else None,
        special_thresholds=(sd["special_care_embeds_weights"]
                            if has_special else None),
        replacement=replacement)
