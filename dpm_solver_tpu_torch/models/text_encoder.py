"""Conditioning encoders of the latent-diffusion models.

Port of `dpm_solver_tpu/models/text_encoder.py`:
  * `FrozenCLIPEmbedder` (SD-1's text conditioner: the last hidden state of
    CLIP's text tower), `FrozenCLIPTextJointEmbedder` (the projected pooled
    text feature, normalised, repeated: the retrieval models' conditioning)
    and `FrozenCLIPImageEmbedder` (the projected image feature, after CLIP's
    bicubic resize to 224 and mean/std normalisation): the JAX package runs
    transformers' Flax CLIP; the port runs its own towers and BPE tokenizer
    (`models/clip.py`, `models/clip_tokenizer.py`) from the same local
    HF-format directory, so no `transformers` is needed.
    `version` is a local directory: nothing is downloaded;
  * `BERTEmbedder`: the legacy LDM text encoder (x_transformer's pre-LN
    encoder over BERT token ids), its parameters under the reference's
    keys (`transformer.attn_layers.layers.{2i}.1.to_q`, ...); its attention
    is `ops.token_attention` (8 heads of 64, T = S = 77 on the card);
  * `ClassEmbedder`: class labels -> (B, 1, D) cross-attention context;
  * `SpatialRescaler`: n stages of `jax.image.resize`-exact rescaling
    (`utils/resize.py`), then an optional 1x1 channel map;
  * `constant_context_encoder`: the hermetic stand-in encoder.

Each module is built on `device`, the card by default (raises when there is
none); the CLIP embedders move their inputs there.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dpm_solver_tpu_torch.models.clip import CLIPModel, CLIPTextModel
from dpm_solver_tpu_torch.models.clip_tokenizer import CLIPTokenizer
from dpm_solver_tpu_torch.ops.attention import token_attention
from dpm_solver_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from dpm_solver_tpu_torch.utils.resize import resize

Prompts = Union[str, Sequence[str]]


def _as_list(prompts: Prompts) -> list:
    return [prompts] if isinstance(prompts, str) else list(prompts)


class FrozenCLIPEmbedder:
    """prompts -> (B, max_length, D) context: CLIP's text tower's last
    hidden state (ldm/modules/encoders/modules.py:137-160)."""

    def __init__(self, version: Union[str, Path], max_length: int = 77, device=DEFAULT_DEVICE):
        dev = resolve_device(device)
        self.tokenizer = CLIPTokenizer(version)
        self.model = CLIPTextModel.from_pretrained(version, device=dev)
        self.max_length = max_length

    def __call__(self, prompts: Prompts) -> torch.Tensor:
        return self.encode(prompts)

    @torch.no_grad()
    def encode(self, prompts: Prompts) -> torch.Tensor:
        ids = self.tokenizer(_as_list(prompts), self.max_length)
        return self.model(ids.to(next(self.model.parameters()).device))[0]


class FrozenCLIPTextJointEmbedder:
    """prompts -> L2-normalised CLIP joint-space embeddings (B, n_repeat, D)
    (the reference FrozenCLIPTextEmbedder, modules.py:165-194)."""

    def __init__(self, version: Union[str, Path], max_length: int = 77, n_repeat: int = 1,
                 normalize: bool = True, device=DEFAULT_DEVICE):
        dev = resolve_device(device)
        self.tokenizer = CLIPTokenizer(version)
        self.model = CLIPModel.from_pretrained(version, device=dev)
        self.max_length, self.n_repeat, self.normalize = max_length, n_repeat, normalize

    @torch.no_grad()
    def __call__(self, prompts: Prompts) -> torch.Tensor:
        ids = self.tokenizer(_as_list(prompts), self.max_length)
        z = self.model.get_text_features(ids.to(next(self.model.parameters()).device))
        if self.normalize:
            z = z / z.norm(dim=-1, keepdim=True)
        return z[:, None, :].repeat(1, self.n_repeat, 1)

    def encode(self, prompts: Prompts) -> torch.Tensor:
        return self(prompts)


class FrozenCLIPImageEmbedder:
    """images in [-1, 1] NHWC -> CLIP joint-space embeddings (B, D)
    (FrozenClipImageEmbedder, modules.py:197-228): bicubic resize to 224
    (antialiased, as `jax.image.resize`), CLIP's mean/std, the projected
    image feature."""

    MEAN = torch.tensor([0.48145466, 0.4578275, 0.40821073])
    STD = torch.tensor([0.26862954, 0.26130258, 0.27577711])

    def __init__(self, version: Union[str, Path], normalize: bool = True, device=DEFAULT_DEVICE):
        self.model = CLIPModel.from_pretrained(version, device=resolve_device(device))
        self.normalize = normalize

    def preprocess(self, x: torch.Tensor) -> torch.Tensor:
        x = resize(x.float(), (224, 224), "bicubic")
        x = (x + 1.0) / 2.0
        return (x - self.MEAN.to(x.device)) / self.STD.to(x.device)

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(next(self.model.parameters()).device)
        z = self.model.get_image_features(self.preprocess(x).permute(0, 3, 1, 2))
        if self.normalize:
            z = z / z.norm(dim=-1, keepdim=True)
        return z


def constant_context_encoder(context_dim: int, max_length: int = 77,
                             seed: int = 0) -> Callable:
    """Deterministic stand-in encoder for tests and smoke runs: hashes each
    prompt to a fixed pseudo-random (max_length, context_dim) block.

    The same function as the JAX one: numpy's RandomState seeded from
    `hash((seed, prompt))`, so within one process both give the same values;
    two processes give different ones (the string hash is per process), so
    ranks of a mesh each need another encoder.
    Returns fp32 (B, max_length, context_dim) on the CPU; the caller moves it
    (`LatentDiffusion.get_learned_conditioning` moves it to the UNet's device).
    """

    def encode(prompts: Prompts) -> torch.Tensor:
        rows = []
        for p in _as_list(prompts):
            h = abs(hash((seed, p))) % (2 ** 31)
            rows.append(np.random.RandomState(h).randn(max_length, context_dim)
                        .astype(np.float32))
        return torch.from_numpy(np.stack(rows))

    return encode


class SpatialRescaler(nn.Module):
    """Spatial conditioning rescaler (ldm/modules/encoders/modules.py:106-135):
    `n_stages` resizes by `multiplier` (to max(1, int(size * multiplier))),
    then an optional bias-free 1x1 `channel_mapper`. NHWC."""

    def __init__(self, n_stages: int = 1, method: str = "bilinear", multiplier: float = 0.5,
                 in_channels: int = 3, out_channels: Optional[int] = None,
                 use_bias: bool = False, device=DEFAULT_DEVICE):
        super().__init__()
        self.n_stages, self.method, self.multiplier = n_stages, method, multiplier
        if out_channels is not None:
            with torch.device(resolve_device(device)):
                self.channel_mapper = nn.Conv2d(in_channels, out_channels, 1, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for _ in range(self.n_stages):
            _, h, w, _ = x.shape
            x = resize(x, (max(1, int(h * self.multiplier)), max(1, int(w * self.multiplier))),
                       self.method)
        if hasattr(self, "channel_mapper"):
            m = self.channel_mapper
            x = F.linear(x, m.weight[:, :, 0, 0], m.bias)
        return x

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self(x)


class ClassEmbedder(nn.Module):
    """Class-label conditioner of the class-conditional LDMs (the reference
    ClassEmbedder of the cin256 configs): labels -> (B, 1, embed_dim). The
    table is `embedding.weight`: `embedding` (a (num_classes, embed_dim)
    array, e.g. the JAX ClassEmbedder's) or N(0, 1) draws seeded by `seed`."""

    def __init__(self, num_classes: int, embed_dim: int, seed: int = 0, embedding=None,
                 device=DEFAULT_DEVICE):
        super().__init__()
        dev = resolve_device(device)
        with torch.device(dev):
            self.embedding = nn.Embedding(num_classes, embed_dim)
        with torch.no_grad():
            if embedding is not None:
                self.embedding.weight.copy_(torch.from_numpy(np.array(embedding, np.float32)))
            else:
                g = torch.Generator().manual_seed(seed)
                self.embedding.weight.copy_(torch.randn(num_classes, embed_dim, generator=g))
        self.requires_grad_(False)

    def forward(self, labels) -> torch.Tensor:
        labels = torch.as_tensor(labels, dtype=torch.int64, device=self.embedding.weight.device)
        return self.embedding(labels)[:, None, :]


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.to_q, self.to_k, self.to_v = (nn.Linear(dim, inner, bias=False) for _ in range(3))
        self.to_out = nn.Linear(inner, dim)


class _FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(nn.Sequential(nn.Linear(dim, mult * dim), nn.GELU()),
                                 nn.Dropout(0.0), nn.Linear(mult * dim, dim))


class _AbsolutePositionalEmbedding(nn.Module):
    def __init__(self, dim: int, max_seq_len: int):
        super().__init__()
        self.emb = nn.Embedding(max_seq_len, dim)


class _TransformerWrapper(nn.Module):
    """x_transformer's TransformerWrapper(return_embeddings=True) over an
    Encoder: token and absolute position embeddings, then `attn_layers.layers`
    alternating [LayerNorm, attention] and [LayerNorm, feed-forward], then
    `norm`."""

    def __init__(self, vocab_size: int, max_seq_len: int, dim: int, depth: int, heads: int,
                 dim_head: int):
        super().__init__()
        self.token_emb = nn.Embedding(vocab_size, dim)
        self.pos_emb = _AbsolutePositionalEmbedding(dim, max_seq_len)
        self.attn_layers = nn.Module()
        self.attn_layers.layers = nn.ModuleList()
        for _ in range(depth):
            for block in (_Attention(dim, heads, dim_head), _FeedForward(dim)):
                self.attn_layers.layers.append(nn.ModuleList([nn.LayerNorm(dim), block]))
        self.norm = nn.LayerNorm(dim)


class BERTEmbedder(nn.Module):
    """Legacy LDM text encoder (ldm/modules/encoders/modules.py:80-101 over
    x_transformer.py, Encoder defaults: pre-LN, 8 heads of 64, bias-free
    q/k/v, exact-GELU feed-forward x4, learned absolute positions, a final
    LayerNorm, the embeddings returned). Token ids in, (B, T, n_embed) out;
    tokenisation is external, as in the JAX package. The projections and the
    attention run in `compute_dtype` (fp32 parameters cast per call), the
    LayerNorms in fp32. A reference checkpoint's `transformer.to_logits.*`
    (unused when embeddings are returned) has no counterpart here."""

    def __init__(self, n_embed: int, n_layer: int, vocab_size: int = 30522,
                 max_seq_len: int = 77, num_heads: int = 8, head_dim: int = 64,
                 compute_dtype: torch.dtype = torch.float32, device=DEFAULT_DEVICE):
        super().__init__()
        self.compute_dtype = compute_dtype
        with torch.device(resolve_device(device)):
            self.transformer = _TransformerWrapper(vocab_size, max_seq_len, n_embed, n_layer,
                                                   num_heads, head_dim)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        tw, dt = self.transformer, self.compute_dtype
        tokens = torch.as_tensor(tokens, device=tw.token_emb.weight.device)
        x = tw.token_emb(tokens) + tw.pos_emb.emb.weight[:tokens.shape[1]][None]

        def linear(m: nn.Linear, h: torch.Tensor) -> torch.Tensor:
            return F.linear(h.to(dt), m.weight.to(dt), None if m.bias is None else m.bias.to(dt))

        layers = tw.attn_layers.layers
        for i in range(0, len(layers), 2):
            (norm_a, attn), (norm_f, ff) = layers[i], layers[i + 1]
            h = norm_a(x)
            q, k, v = (linear(m, h) for m in (attn.to_q, attn.to_k, attn.to_v))
            a = token_attention(q, k, v, num_heads=attn.heads)
            x = x + linear(attn.to_out, a).float()
            h = F.gelu(linear(ff.net[0][0], norm_f(x)).float())
            x = x + linear(ff.net[2], h).float()
        return tw.norm(x)
