"""CLIP's text and vision towers, read from a local HF-format directory.

The port's own copy of transformers' torch CLIP (models/clip/
modeling_clip.py), so that the port needs no `transformers`: the same module
tree and parameter names (`text_model.encoder.layers.0.self_attn.q_proj`,
`vision_model.pre_layrnorm`, `text_projection`, ...), so a directory that
`CLIPTextModel.save_pretrained` or `CLIPModel.save_pretrained` wrote
(`config.json` and `pytorch_model.bin`) loads with `load_state_dict`.
`from_pretrained` reads `pytorch_model.bin` with `torch.load(...,
weights_only=True)`; a safetensors file is not read (the port depends on
PyTorch alone).

The towers are pre-LN transformers: the text tower causal, its pooled output
the final-normed state at the first <|endoftext|> (the largest id when the
config's eos_token_id is the old 2), the vision tower a ViT over patch
embeddings and a class token, pooled at that token. Attention is plain
PyTorch (logits, mask, fp32 softmax, P.V), as the JAX package leaves the
Flax CLIP to XLA: no Pallas kernel runs in it.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from dpm_solver_tpu_torch.models.clip_tokenizer import local_directory

# the activations of CLIP's configs: OpenAI's (quick_gelu) and OpenCLIP's (gelu)
_ACT = {"quick_gelu": lambda x: x * torch.sigmoid(1.702 * x), "gelu": F.gelu}


@dataclasses.dataclass(frozen=True)
class CLIPTowerConfig:
    """The fields of a CLIPTextConfig or CLIPVisionConfig the towers read."""

    hidden_size: int = 512
    intermediate_size: int = 2048
    num_hidden_layers: int = 12
    num_attention_heads: int = 8
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    # text
    vocab_size: int = 49408
    max_position_embeddings: int = 77
    eos_token_id: int = 49407
    # vision
    image_size: int = 224
    patch_size: int = 32
    num_channels: int = 3

    @staticmethod
    def from_dict(d: dict, vision: bool = False) -> "CLIPTowerConfig":
        """From a config.json's (sub)dict, whose absent fields take the
        defaults of transformers' CLIPTextConfig or CLIPVisionConfig (which
        differ: a `save_pretrained` config may list only what differs)."""
        base = dict(_VISION_DEFAULTS if vision else {})
        base.update({f.name: d[f.name] for f in dataclasses.fields(CLIPTowerConfig)
                     if f.name in d})
        return CLIPTowerConfig(**base)

    @staticmethod
    def vit_l14_text() -> "CLIPTowerConfig":
        """openai/clip-vit-large-patch14's text tower (SD-1's conditioner)."""
        return CLIPTowerConfig(hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
                               num_attention_heads=12)


# CLIPVisionConfig's defaults where they differ from CLIPTextConfig's (this
# dataclass's own)
_VISION_DEFAULTS = dict(hidden_size=768, intermediate_size=3072, num_attention_heads=12)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTowerConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (nn.Linear(d, d) for _ in range(4))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        b, t, d = x.shape
        dh = d // self.heads
        q, k, v = ((proj(x)).reshape(b, t, self.heads, dh).transpose(1, 2)
                   for proj in (self.q_proj, self.k_proj, self.v_proj))
        z = (q @ k.transpose(-1, -2)) * dh ** -0.5
        if mask is not None:
            z = z + mask
        p = torch.softmax(z, dim=-1, dtype=torch.float32).to(q.dtype)
        return self.out_proj((p @ v).transpose(1, 2).reshape(b, t, d))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTowerConfig):
        super().__init__()
        self.act = _ACT[cfg.hidden_act]
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTowerConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTowerConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg) for _ in range(cfg.num_hidden_layers))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, mask)
        return x


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTowerConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(ids.shape[-1], device=ids.device)
        return self.token_embedding(ids) + self.position_embedding(pos)[None]


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTowerConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = CLIPTextEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, ids: torch.Tensor):
        """(last hidden state (B, T, D), pooled (B, D)) of int ids (B, T)."""
        x = self.embeddings(ids)
        t = ids.shape[-1]
        causal = torch.full((t, t), torch.finfo(x.dtype).min, device=x.device).triu(1)
        h = self.final_layer_norm(self.encoder(x, causal[None, None]))
        rows = torch.arange(ids.shape[0], device=ids.device)
        if self.config.eos_token_id == 2:  # older configs: the end token is the largest id
            at = ids.to(torch.int32).argmax(-1)
        else:
            at = (ids.to(torch.int32) == self.config.eos_token_id).int().argmax(-1)
        return h, h[rows, at]


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTowerConfig):
        super().__init__()
        d = cfg.hidden_size
        self.class_embedding = nn.Parameter(torch.randn(d))
        self.patch_embedding = nn.Conv2d(cfg.num_channels, d, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding((cfg.image_size // cfg.patch_size) ** 2 + 1, d)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels NCHW -> (B, 1 + patches, D)."""
        patches = self.patch_embedding(pixels.to(self.patch_embedding.weight.dtype))
        patches = patches.flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(pixels.shape[0], 1, -1)
        return torch.cat([cls, patches], dim=1) + self.position_embedding.weight[None]


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPTowerConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)  # HF's name
        self.encoder = CLIPEncoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, pixels: torch.Tensor):
        """(last hidden state, pooled: the class token post-normed)."""
        h = self.encoder(self.pre_layrnorm(self.embeddings(pixels)))
        return h, self.post_layernorm(h[:, 0])


def _read_config(directory: Path) -> dict:
    return json.loads((local_directory(directory) / "config.json").read_text("utf-8"))


def _load_weights(module: nn.Module, directory: Path, prefix: str = "") -> None:
    """The directory's weights into `module`, every key of it; only the keys
    under `prefix` are read (the text tower of a joint CLIPModel, as
    transformers' CLIPTextModel.from_pretrained reads it)."""
    sd = torch.load(directory / "pytorch_model.bin", map_location="cpu", weights_only=True)
    # buffers HF keeps (position ids) have no counterpart here
    sd = {k: v for k, v in sd.items() if k.startswith(prefix) and not k.endswith("position_ids")}
    module.load_state_dict(sd, strict=True)


class CLIPTextModel(nn.Module):
    """transformers' CLIPTextModel: `text_model`; `forward(ids)` ->
    (last_hidden_state, pooler_output)."""

    def __init__(self, cfg: CLIPTowerConfig):
        super().__init__()
        self.config = cfg
        self.text_model = CLIPTextTransformer(cfg)

    def forward(self, ids: torch.Tensor):
        return self.text_model(ids)

    @staticmethod
    def from_pretrained(directory: Union[str, Path], device="cpu") -> "CLIPTextModel":
        directory = Path(directory)
        cfg = _read_config(directory)
        joint = "text_config" in cfg
        cfg = cfg.get("text_config", cfg)
        with torch.device(device):
            model = CLIPTextModel(CLIPTowerConfig.from_dict(cfg))
        _load_weights(model, directory, "text_model." if joint else "")
        return model.eval().requires_grad_(False)


class CLIPModel(nn.Module):
    """transformers' CLIPModel: both towers and their projections to the
    joint space (`get_text_features`, `get_image_features`)."""

    def __init__(self, text: CLIPTowerConfig, vision: CLIPTowerConfig, projection_dim: int,
                 logit_scale_init_value: float = 2.6592):
        super().__init__()
        self.text_model = CLIPTextTransformer(text)
        self.vision_model = CLIPVisionTransformer(vision)
        self.visual_projection = nn.Linear(vision.hidden_size, projection_dim, bias=False)
        self.text_projection = nn.Linear(text.hidden_size, projection_dim, bias=False)
        self.logit_scale = nn.Parameter(torch.tensor(logit_scale_init_value))

    def get_text_features(self, ids: torch.Tensor) -> torch.Tensor:
        return self.text_projection(self.text_model(ids)[1])

    def get_image_features(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels NCHW, normalised as CLIP's preprocessing leaves them."""
        return self.visual_projection(self.vision_model(pixels)[1])

    @staticmethod
    def from_pretrained(directory: Union[str, Path], device="cpu") -> "CLIPModel":
        directory = Path(directory)
        cfg = _read_config(directory)
        if "vision_config" not in cfg:
            raise ValueError(f"{directory} holds a text-only CLIP; the joint model needs both towers")
        with torch.device(device):
            model = CLIPModel(CLIPTowerConfig.from_dict(cfg.get("text_config") or {}),
                              CLIPTowerConfig.from_dict(cfg["vision_config"] or {}, vision=True),
                              cfg.get("projection_dim", 512),
                              cfg.get("logit_scale_init_value", math.log(1 / 0.07)))
        _load_weights(model, directory)
        return model.eval().requires_grad_(False)
