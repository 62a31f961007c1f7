"""Port conditioners (dpm_solver_tpu_torch/models/text_encoder.py, clip.py,
clip_tokenizer.py, utils/resize.py) against the JAX package's.

- The port's CLIP BPE tokenizer gives the ids of transformers' CLIPTokenizer
  (as it runs without ftfy, the JAX side's tokenizer) on one vocabulary,
  written by `write_synthetic_vocab`: prompts with punctuation, digits,
  contractions, accents, CJK, emoji and more than 77 tokens.
- CLIP: one random-init HF-format directory (written with transformers'
  torch classes, `pytorch_model.bin`) is read by the JAX embedders through
  Flax CLIP (`from_pt=True`) and by the port's own towers; the context, the
  joint text embedding and the image embedding agree within 2e-5 of
  max|ref| (tests/test_models.py:64's fp32 network bound).
- BERTEmbedder: JAX parameters carried across by
  `bert_embedder_state_dict_from_flax`, within 2e-5 of max|ref|; the key
  round trip through the JAX `convert_bert_embedder` is exact.
- ClassEmbedder takes the JAX table and gives (B, 1, D) exactly;
  SpatialRescaler and `resize` agree with `jax.image.resize` within 2e-5 of
  max|ref| (the port's resize weights are float64, JAX's float32).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from dpm_solver_tpu.models import text_encoder as J
from dpm_solver_tpu_torch.models import (BERTEmbedder, ClassEmbedder, CLIPTokenizer,
                                         FrozenCLIPEmbedder, FrozenCLIPImageEmbedder,
                                         FrozenCLIPTextJointEmbedder, SpatialRescaler)
from dpm_solver_tpu_torch.models.clip import CLIPTextModel
from dpm_solver_tpu_torch.models.clip_tokenizer import N_MERGES, write_synthetic_vocab
from dpm_solver_tpu_torch.utils.convert import bert_embedder_state_dict_from_flax
from dpm_solver_tpu_torch.utils.resize import resize

TOL = 2e-5
N_TINY_MERGES = 1500
PROMPTS = [
    "a photograph of an astronaut riding a horse",
    "It's a RED teapot, on the table!! 42 cats & 7 dogs...",
    "café naïve résumé — Ünïcödé façade",
    "don't we'll they're I'm you've he'd O'NEIL's 'sam",
    "  tabs\tand\nnewlines   and spaces ",
    "数学 and émoji 🎉 ½ ² Ⅻ x²",
    " ".join(["photograph of a castle"] * 30),
    "",
]


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    return write_synthetic_vocab(tmp_path_factory.mktemp("clip_vocab"), N_TINY_MERGES)


def _text_config(vocab_dir):
    vocab = json.loads((vocab_dir / "vocab.json").read_text())
    return dict(vocab_size=len(vocab), hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4, max_position_embeddings=77,
                bos_token_id=vocab["<|startoftext|>"], eos_token_id=vocab["<|endoftext|>"],
                pad_token_id=vocab["<|endoftext|>"])


def _copy_vocab(src, dst):
    for name in ("vocab.json", "merges.txt"):
        (dst / name).write_text((src / name).read_text())


def _perturb(model, seed):
    """Every weight moved off transformers' small init, so each layer matters."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model


@pytest.fixture(scope="module")
def text_dir(tmp_path_factory, vocab_dir):
    d = tmp_path_factory.mktemp("clip_text")
    model = transformers.CLIPTextModel(transformers.CLIPTextConfig(**_text_config(vocab_dir)))
    _perturb(model, 0).save_pretrained(d, safe_serialization=False)
    _copy_vocab(vocab_dir, d)
    return d


@pytest.fixture(scope="module")
def joint_dir(tmp_path_factory, vocab_dir):
    d = tmp_path_factory.mktemp("clip_joint")
    cfg = transformers.CLIPConfig(
        text_config=_text_config(vocab_dir),
        vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=4, image_size=224, patch_size=32),
        projection_dim=16)
    _perturb(transformers.CLIPModel(cfg), 1).save_pretrained(d, safe_serialization=False)
    _copy_vocab(vocab_dir, d)
    return d


@pytest.mark.parametrize("prompt", PROMPTS, ids=range(len(PROMPTS)))
def test_tokenizer_ids_match_transformers(vocab_dir, prompt):
    hf = transformers.CLIPTokenizer.from_pretrained(vocab_dir)
    want = hf([prompt], truncation=True, max_length=77, padding="max_length")["input_ids"]
    got = CLIPTokenizer(vocab_dir)([prompt])
    assert got.shape == (1, 77) and got.dtype == torch.int64
    assert got.tolist() == want


def test_synthetic_vocab_has_clips_size_and_matches_transformers(tmp_path):
    d = write_synthetic_vocab(tmp_path)
    vocab = json.loads((d / "vocab.json").read_text())
    assert len(vocab) == 49408 == 512 + N_MERGES + 2
    hf = transformers.CLIPTokenizer.from_pretrained(d)
    got = CLIPTokenizer(d)(PROMPTS[:3])
    want = hf(PROMPTS[:3], truncation=True, max_length=77, padding="max_length")["input_ids"]
    assert got.tolist() == want


def test_clip_text_context_matches_flax(text_dir):
    want = J.FrozenCLIPEmbedder(str(text_dir), from_pt=True)(PROMPTS[:4])
    got = FrozenCLIPEmbedder(text_dir, device="cpu")(PROMPTS[:4])
    assert got.shape == (4, 77, 32)
    assert _rel(got.numpy(), want) < TOL


def test_clip_text_pools_at_the_end_token(text_dir):
    """The pooled output is the final-normed state at the first <|endoftext|>."""
    model = CLIPTextModel.from_pretrained(text_dir, device="cpu")
    ids = CLIPTokenizer(text_dir)(PROMPTS[:2])
    with torch.no_grad():
        h, pooled = model(ids)
        hf = transformers.CLIPTextModel.from_pretrained(text_dir)(ids)
    at = (ids == model.config.eos_token_id).int().argmax(-1)
    torch.testing.assert_close(pooled, h[torch.arange(2), at], rtol=0, atol=0)
    assert _rel(pooled.numpy(), hf.pooler_output.numpy()) < TOL
    assert _rel(h.numpy(), hf.last_hidden_state.numpy()) < TOL


@pytest.mark.parametrize("n_repeat,normalize", [(1, True), (3, False)])
def test_clip_joint_text_embedding_matches_flax(joint_dir, n_repeat, normalize):
    want = J.FrozenCLIPTextJointEmbedder(str(joint_dir), n_repeat=n_repeat, normalize=normalize,
                                         from_pt=True)(PROMPTS[:3])
    got = FrozenCLIPTextJointEmbedder(joint_dir, n_repeat=n_repeat, normalize=normalize,
                                      device="cpu")(PROMPTS[:3])
    assert got.shape == (3, n_repeat, 16)
    assert _rel(got.numpy(), want) < TOL


@pytest.mark.parametrize("hw", [(64, 48), (256, 256)])
def test_clip_image_embedding_matches_flax(joint_dir, hw):
    x = np.random.default_rng(2).uniform(-1, 1, (2, *hw, 3)).astype(np.float32)
    jax_embedder = J.FrozenCLIPImageEmbedder(str(joint_dir), from_pt=True)
    port = FrozenCLIPImageEmbedder(joint_dir, device="cpu")
    assert _rel(port.preprocess(torch.tensor(x)).numpy(),
                jax_embedder.preprocess(jnp.asarray(x))) < TOL
    want = jax_embedder(jnp.asarray(x))
    got = port(torch.tensor(x))
    assert got.shape == (2, 16)
    assert _rel(got.numpy(), want) < TOL


def test_clip_loads_only_local_directories(tmp_path):
    with pytest.raises(FileNotFoundError, match="local"):
        FrozenCLIPEmbedder("openai/clip-vit-large-patch14", device="cpu")
    with pytest.raises(FileNotFoundError, match="local"):
        CLIPTextModel.from_pretrained(tmp_path / "missing", device="cpu")


def test_clip_from_pretrained_asks_for_the_card_by_default(text_dir, joint_dir, monkeypatch):
    from dpm_solver_tpu_torch.models.clip import CLIPModel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLIPTextModel.from_pretrained(text_dir)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLIPModel.from_pretrained(joint_dir)


BERT = dict(n_embed=64, n_layer=2, vocab_size=100, max_seq_len=16, num_heads=2, head_dim=32)


@pytest.fixture(scope="module")
def bert():
    tokens = np.random.default_rng(3).integers(0, BERT["vocab_size"], (3, 11))
    jmodel = J.BERTEmbedder(**BERT)
    params = jmodel.init(jax.random.key(0), jnp.asarray(tokens))
    rng = np.random.default_rng(4)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
                          .astype(np.float32), params)
    return jmodel, params, tokens


def test_bert_embedder_matches_jax(bert):
    jmodel, params, tokens = bert
    want = jmodel.apply(params, jnp.asarray(tokens))
    port = BERTEmbedder(**BERT, device="cpu")
    port.load_state_dict(bert_embedder_state_dict_from_flax(params, BERT["n_layer"]), strict=True)
    with torch.no_grad():
        got = port(torch.tensor(tokens))
    assert got.shape == (3, 11, 64)
    assert _rel(got.numpy(), want) < TOL


def test_bert_keys_round_trip_through_the_jax_converter(bert):
    _, params, _ = bert
    sd = bert_embedder_state_dict_from_flax(params, BERT["n_layer"])
    back = J.convert_bert_embedder({k: v.numpy() for k, v in sd.items()}, BERT["n_layer"])
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        other = back
        for key in path:
            other = other[key.key]
        np.testing.assert_array_equal(np.asarray(other), np.asarray(leaf))
    assert set(sd) == set(BERTEmbedder(**BERT, device="meta").state_dict())


def test_class_embedder_takes_the_jax_table():
    jax_embedder = J.ClassEmbedder(11, 8, seed=3)
    table = np.asarray(jax_embedder.params["params"]["embedding"])
    port = ClassEmbedder(11, 8, embedding=table, device="cpu")
    labels = np.array([0, 10, 3, 3])
    got = port(labels)
    assert got.shape == (4, 1, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_embedder(labels)))
    assert set(port.state_dict()) == {"embedding.weight"}
    seeded = ClassEmbedder(11, 8, seed=3, device="cpu")
    assert torch.equal(seeded(labels), ClassEmbedder(11, 8, seed=3, device="cpu")(labels))


@pytest.mark.parametrize("kw,hw", [
    (dict(n_stages=1), (32, 32)),
    (dict(n_stages=2, method="bicubic", multiplier=0.5, out_channels=5), (33, 20)),
    (dict(n_stages=1, method="nearest", multiplier=0.25), (32, 48)),
    (dict(n_stages=1, method="bilinear", multiplier=1.5, out_channels=4, use_bias=True), (9, 7)),
], ids=["bilinear", "bicubic-mapper", "nearest", "upsample-bias"])
def test_spatial_rescaler_matches_jax(kw, hw):
    x = np.random.default_rng(5).standard_normal((2, *hw, 3)).astype(np.float32)
    jmodule = J.SpatialRescaler(**kw)
    params = jmodule.init(jax.random.key(1), jnp.asarray(x))
    want = jmodule.apply(params, jnp.asarray(x))
    port = SpatialRescaler(**kw, device="cpu")
    if "out_channels" in kw:
        mapper = params["params"]["channel_mapper"]
        with torch.no_grad():
            port.channel_mapper.weight.copy_(
                torch.tensor(np.asarray(mapper["kernel"])).permute(3, 2, 0, 1))
            if kw.get("use_bias"):
                port.channel_mapper.bias.copy_(torch.tensor(np.asarray(mapper["bias"])))
    with torch.no_grad():
        got = port(torch.tensor(x))
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) < TOL


@pytest.mark.parametrize("method", ["linear", "cubic", "lanczos3", "lanczos5", "nearest"])
@pytest.mark.parametrize("size", [(224, 224), (5, 9), (40, 13)], ids=str)
def test_resize_matches_jax_image_resize(method, size):
    x = np.random.default_rng(6).standard_normal((2, 37, 26, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, *size, 3), method)
    got = resize(torch.tensor(x), size, method)
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) < TOL
