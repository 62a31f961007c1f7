"""The port's invisible watermark and safety checker
(dpm_solver_tpu_torch/utils/{watermark,safety}.py) against the JAX package's.

- `put_watermark` stamps the same bytes as the JAX function on seeded
  images and payloads; the decoders read the same payloads back, through a
  PNG cycle too, and a mark stamped by one package is read by the other.
- The safety checker's decision rule (cosine against the concept embeddings
  minus each threshold, the 0.01 special-care bonus) flags what the JAX one
  flags on seeded embeddings through a stub embedder, with the same
  replacements, numpy and tensor embeddings alike.
- `load_safety_checker` reads a synthesized diffusers-layout checkpoint
  (concept_embeds, special_care_embeds and their *_weights thresholds).
"""

import io

import numpy as np
import pytest
import torch

from dpm_solver_tpu.utils import safety as jsafety
from dpm_solver_tpu.utils import watermark as jwm
from dpm_solver_tpu_torch.utils import safety as psafety
from dpm_solver_tpu_torch.utils import watermark as pwm

D = 8


def _photo(h=256, w=256, seed=0):
    """tests/test_watermark_safety.py's smooth synthetic photo."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 90 * np.sin(xx / 23.0) * np.cos(yy / 31.0),
                     128 + 80 * np.cos(xx / 17.0 + 1.0),
                     128 + 70 * np.sin((xx + yy) / 41.0)], axis=-1)
    return np.clip(base + rng.normal(0, 6, (h, w, 3)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("seed,hw,payload", [(0, (256, 256), pwm.DEFAULT_WM),
                                             (3, (128, 192), "hello-h100"),
                                             (7, (512, 512), pwm.DEFAULT_WM),
                                             (1, (32, 32), "ok")])
def test_put_watermark_is_byte_equal_to_jax(seed, hw, payload):
    img = _photo(*hw, seed=seed)
    got = pwm.put_watermark(img, payload)
    np.testing.assert_array_equal(got, jwm.put_watermark(img, payload))
    n = 8 * len(payload.encode())
    assert pwm.decode_watermark(got, n) == jwm.decode_watermark(got, n) == payload.encode()


def test_decode_round_trips_through_png_and_across_packages():
    from PIL import Image

    out = pwm.put_watermark(_photo(seed=5))
    bio = io.BytesIO()
    Image.fromarray(out).save(bio, format="PNG")
    bio.seek(0)
    back = np.asarray(Image.open(bio).convert("RGB"), np.uint8)
    assert pwm.decode_watermark_text(back) == pwm.DEFAULT_WM
    assert pwm.decode_watermark_text(jwm.put_watermark(_photo(seed=6))) == pwm.DEFAULT_WM
    # an unmarked image decodes to what the JAX decoder reads from it
    plain = _photo(seed=9)
    assert pwm.decode_watermark_text(plain) == jwm.decode_watermark_text(plain) != pwm.DEFAULT_WM


def test_watermark_input_validation_matches_jax():
    for bad in (np.zeros((10, 10, 3), np.float32), np.zeros((33, 32, 3), np.uint8),
                _photo(32, 32)):
        for mod in (pwm, jwm):
            with pytest.raises(ValueError):
                mod.put_watermark(bad)


def _embedder(mapping, as_tensor=False):
    """Stub image embedder: the image index (pixel 0) -> its row."""

    def embed(images):
        rows = mapping[np.asarray(images)[:, 0, 0, 0].astype(int)]
        return torch.from_numpy(rows) if as_tensor else rows

    return embed


@pytest.mark.parametrize("as_tensor", [False, True])
def test_safety_decision_rule_matches_jax(as_tensor):
    rng = np.random.default_rng(0)
    n, k, s = 64, 5, 3
    concepts = rng.standard_normal((k, D)).astype(np.float32)
    special = rng.standard_normal((s, D)).astype(np.float32)
    emb = rng.standard_normal((n, D)).astype(np.float32)
    emb[:8] = concepts[rng.integers(0, k, 8)] + 0.3 * rng.standard_normal((8, D))
    emb[8:16] = special[rng.integers(0, s, 8)] + 0.3 * rng.standard_normal((8, D))
    thr = rng.uniform(0.3, 0.8, k).astype(np.float32)
    sthr = rng.uniform(0.3, 0.8, s).astype(np.float32)
    images = rng.uniform(-1, 1, (n, 4, 4, 3)).astype(np.float32)
    images[:, 0, 0, 0] = np.arange(n)
    rep = np.full((4, 4, 3), 0.25, np.float32)
    for kw in (dict(), dict(special_embeds=special, special_thresholds=sthr),
               dict(replacement=rep)):
        got = psafety.SafetyChecker(_embedder(emb, as_tensor), concepts, thr, **kw)(images)
        want = jsafety.SafetyChecker(_embedder(emb), concepts, thr, **kw)(images)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
        assert 0 < got[1].sum() < n


def test_special_care_bonus_is_001():
    """A special-care hit lowers every concept threshold by 0.01: a concept
    0.005 under its threshold is flagged with it, not without."""
    concept = np.array([[1.0] + [0.0] * (D - 1)], np.float32)
    special = np.array([[0.0, 1.0] + [0.0] * (D - 2)], np.float32)
    v = np.zeros((1, D), np.float32)
    v[0, :2] = 1.0, 0.4
    cos_c = float(v[0, 0] / np.linalg.norm(v[0]))
    images = np.zeros((1, 2, 2, 3), np.float32)
    for delta, flagged in ((0.005, True), (0.015, False)):
        for mod in (psafety, jsafety):
            base = mod.SafetyChecker(_embedder(v), concept, [cos_c + delta])
            assert not base.flag(images)[0]
            sc = mod.SafetyChecker(_embedder(v), concept, [cos_c + delta],
                                   special_embeds=special, special_thresholds=[0.2])
            assert sc.flag(images)[0] == flagged
    with pytest.raises(ValueError, match="together"):
        psafety.SafetyChecker(_embedder(v), concept, [0.5], special_embeds=special)


@pytest.mark.parametrize("special", [True, False])
def test_load_safety_checker_from_a_synthesized_checkpoint(tmp_path, special):
    rng = np.random.default_rng(1)
    sd = {"concept_embeds": torch.from_numpy(rng.standard_normal((17, 768)).astype(np.float32)),
          "concept_embeds_weights": torch.from_numpy(rng.uniform(0.1, 0.3, 17)
                                                     .astype(np.float32)),
          "vision_model.vision_model.post_layernorm.weight": torch.ones(1024)}
    if special:
        sd["special_care_embeds"] = torch.from_numpy(rng.standard_normal((3, 768))
                                                     .astype(np.float32))
        sd["special_care_embeds_weights"] = torch.full((3,), 0.2)
    path = tmp_path / "safety.pt"
    torch.save(sd, path)
    emb = rng.standard_normal((6, 768)).astype(np.float32)
    emb[:2] = sd["concept_embeds"][:2].numpy()
    images = np.zeros((6, 2, 2, 3), np.float32)
    images[:, 0, 0, 0] = np.arange(6)
    got = psafety.load_safety_checker(str(path), _embedder(emb, True))
    want = jsafety.load_safety_checker(str(path), _embedder(emb))
    assert (got.special_embeds is None) == (not special)
    np.testing.assert_array_equal(got.concept_embeds, want.concept_embeds)
    np.testing.assert_array_equal(got.flag(images), want.flag(images))
    assert got.flag(images)[:2].all()
    torch.save({"concept_embeds": sd["concept_embeds"]}, tmp_path / "bad.pt")
    with pytest.raises(ValueError, match="concept_embeds_weights"):
        psafety.load_safety_checker(str(tmp_path / "bad.pt"), _embedder(emb))
