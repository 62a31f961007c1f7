"""ADM / guided-diffusion UNet and the Stable Diffusion UNet, NHWC.

Port of `dpm_solver_tpu/models/adm_unet.py` (UNetModel, unet.py:396-663 of the
reference guided-diffusion code, with the latent-diffusion SpatialTransformer
extension of openaimodel.py:443-468). Parameter names are the reference's
torch state-dict keys (`time_embed.0`, `input_blocks.1.0.in_layers.2`,
`middle_block.1.transformer_blocks.0.attn1.to_q`, `out.2`, ...) in its
layouts, so `utils/convert.py::adm_unet_state_dict_from_flax` carries JAX
parameters across and a reference checkpoint loads with `load_state_dict`.
The same `layout()` walk drives the model and the converter.

Where the kernels run: every ADMResBlock conv (in_layers.2, out_layers.3, a
3x3 skip) and the upsample conv go through `ops.conv3x3` (47 launches per
SD-2.1 forward); the SpatialTransformers run `ops.ln_linear`,
`ops.token_attention` and `ops.geglu_ff` (models/transformer.py); ADMAttention
runs `ops.token_attention`. The convs the JAX model leaves to XLA stay
library ops: the input conv, `out.2` and the stride-2 downsample are
`F.conv2d`, and the 1x1 skips are matmuls.

`ADMClassifier` (EncoderUNetModel, unet.py:683-894) reuses the encoder half
of the same walk (`layout(cfg, encoder_only=True)`) and adds the four pooling
heads, `AttentionPool2d` among them; `super_res_inputs` is SuperResModel's
low-res conditioning. Both are differentiable in x: classifier guidance takes
the classifier's input gradient through the kernels' backwards (conv3x3 dx,
attention dq and dk/dv).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dpm_solver_tpu_torch.models.ddpm_unet import Conv1x1, Conv2d, GroupNorm32, Linear
from dpm_solver_tpu_torch.models.transformer import SpatialTransformer
from dpm_solver_tpu_torch.ops.attention import token_attention
from dpm_solver_tpu_torch.ops.conv3x3 import Conv3x3
from dpm_solver_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass(frozen=True)
class ADMConfig:
    """Mirrors UNetModel.__init__ (unet.py:427-448). `attention_resolutions`
    holds DOWNSAMPLE RATES (ds), as in the reference module."""

    image_size: int = 64
    in_channels: int = 3
    model_channels: int = 128
    out_channels: int = 3
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 8)
    dropout: float = 0.0
    channel_mult: Tuple[float, ...] = (1, 2, 3, 4)  # 512-model uses 0.5 first
    conv_resample: bool = True
    num_classes: Optional[int] = None
    num_heads: int = 1
    num_head_channels: int = -1
    num_heads_upsample: int = -1
    use_scale_shift_norm: bool = False
    resblock_updown: bool = False
    use_new_attention_order: bool = False
    # SD / latent-diffusion extension (openaimodel.py:443-468):
    use_spatial_transformer: bool = False
    transformer_depth: int = 1
    context_dim: Optional[int] = None
    use_linear_in_transformer: bool = False  # SD-2.x variant
    legacy: bool = True
    # gradient checkpointing for training (the reference's use_checkpoint
    # flag): with grad on, each res block and spatial transformer
    # recomputes its forward in the backward (torch.utils.checkpoint,
    # non-reentrant)
    remat: bool = False
    # the int8 serving path (ops/quant.py): "w8a8" quantizes the transformer
    # stack, "w8a8_conv" also the res-block and upsample 3x3 convs; the state
    # dict and checkpoints are the same either way
    quant: Optional[str] = None
    # EncoderUNetModel (ADMClassifier) only:
    pool: str = "adaptive"  # adaptive | attention | spatial | spatial_v2

    @staticmethod
    def imagenet256_guided() -> "ADMConfig":
        """configs/imagenet256_guided.yml model section (ADM 256x256 cond)."""
        return ADMConfig(
            image_size=256, model_channels=256, out_channels=6,
            num_res_blocks=2, attention_resolutions=(8, 16, 32),
            channel_mult=(1, 1, 2, 2, 4, 4), num_classes=1000,
            num_head_channels=64, use_scale_shift_norm=True,
            resblock_updown=True, use_new_attention_order=False,
        )

    @staticmethod
    def sd_v1() -> "ADMConfig":
        """Stable Diffusion v1 UNet (configs/stable-diffusion/v1-inference.yaml):
        4-ch latents at 64x64, cross-attention on 768-d CLIP context."""
        return ADMConfig(
            image_size=64, in_channels=4, model_channels=320, out_channels=4,
            num_res_blocks=2, attention_resolutions=(1, 2, 4),
            channel_mult=(1, 2, 4, 4), num_heads=8,
            use_spatial_transformer=True, transformer_depth=1,
            context_dim=768,
        )

    @staticmethod
    def sd_v2_1() -> "ADMConfig":
        """Stable Diffusion 2.1 UNet (768 px, v-prediction): 1024-d OpenCLIP
        context, 64-ch attention heads, linear transformer projections."""
        return ADMConfig(
            image_size=96, in_channels=4, model_channels=320, out_channels=4,
            num_res_blocks=2, attention_resolutions=(1, 2, 4),
            channel_mult=(1, 2, 4, 4), num_heads=-1, num_head_channels=64,
            use_spatial_transformer=True, transformer_depth=1,
            context_dim=1024, use_linear_in_transformer=True, legacy=False,
        )

    @staticmethod
    def cin256() -> "ADMConfig":
        """Class-conditional ImageNet LDM UNet (configs/latent-diffusion/cin256-v2.yaml)."""
        return ADMConfig(
            image_size=64, in_channels=3, model_channels=192, out_channels=3,
            num_res_blocks=2, attention_resolutions=(2, 4, 8),
            channel_mult=(1, 2, 3, 5), num_heads=1,
            use_spatial_transformer=True, transformer_depth=1,
            context_dim=512,
        )

    @staticmethod
    def rdm_768() -> "ADMConfig":
        """Retrieval-augmented diffusion UNet
        (configs/retrieval-augmented-diffusion/768x768.yaml)."""
        return ADMConfig(
            image_size=48, in_channels=16, model_channels=448,
            out_channels=16, num_res_blocks=2, attention_resolutions=(1, 2, 4),
            channel_mult=(1, 2, 3, 4), num_head_channels=32,
            use_spatial_transformer=True, transformer_depth=1,
            context_dim=768,
        )

    @staticmethod
    def imagenet64_iddpm() -> "ADMConfig":
        """configs/imagenet64.yml (improved-DDPM cosine, learned sigma)."""
        return ADMConfig(
            image_size=64, model_channels=128, out_channels=6,
            num_res_blocks=3, attention_resolutions=(4, 8),
            channel_mult=(1, 2, 3, 4), num_heads=4,
        )

    @staticmethod
    def imagenet128_guided() -> "ADMConfig":
        """configs/imagenet128_guided.yml model section (ADM 128x128 cond)."""
        return ADMConfig(
            image_size=128, model_channels=256, out_channels=6,
            num_res_blocks=2, attention_resolutions=(4, 8, 16),
            channel_mult=(1, 1, 2, 3, 4), num_classes=1000, num_heads=4,
            use_scale_shift_norm=True, resblock_updown=True,
        )

    @staticmethod
    def imagenet512_guided() -> "ADMConfig":
        """configs/imagenet512_guided.yml model section (ADM 512x512 cond)."""
        return ADMConfig(
            image_size=512, model_channels=256, out_channels=6,
            num_res_blocks=2, attention_resolutions=(16, 32, 64),
            channel_mult=(0.5, 1, 1, 2, 2, 4, 4), num_classes=1000,
            num_heads=4, num_head_channels=64, use_scale_shift_norm=True,
            resblock_updown=True,
        )

    @staticmethod
    def lsun_bedroom_guided() -> "ADMConfig":
        """configs/bedroom_guided.yml model section (unconditional ADM 256)."""
        return ADMConfig(
            image_size=256, model_channels=256, out_channels=6,
            num_res_blocks=2, attention_resolutions=(8, 16, 32), dropout=0.1,
            channel_mult=(1, 1, 2, 2, 4, 4), num_heads=4,
            num_head_channels=64, use_scale_shift_norm=True,
            resblock_updown=True,
        )

    @staticmethod
    def tiny(**overrides) -> "ADMConfig":
        base = dict(image_size=16, model_channels=32, num_res_blocks=1,
                    attention_resolutions=(2, 4), channel_mult=(1, 2, 4),
                    num_heads=2)
        base.update(overrides)
        return ADMConfig(**base)


def adm_timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """OpenAI convention: [cos | sin], freqs = exp(-ln(P) * i / half), fp32
    (guided_diffusion/nn.py:103-121; cos first, unlike DDPM)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) / half
                      * torch.arange(half, dtype=torch.float32, device=t.device))
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def _nearest_x2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _avgpool_x2(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1).contiguous()


def _adm_norm(channels: int) -> GroupNorm32:
    # guided_diffusion GroupNorm32: 32 groups, fp32 statistics, torch's eps 1e-5
    return GroupNorm32(channels, eps=1e-5)


class ADMResample(nn.Module):
    """Upsample/Downsample with optional conv (unet.py:81-140): the up conv is
    `conv` (through `ops.conv3x3`), the stride-2 down conv is `op`, padded
    symmetrically as torch does."""

    def __init__(self, direction: str, channels: int, out_ch: Optional[int] = None,
                 with_conv: bool = True, compute_dtype: torch.dtype = torch.float32,
                 quant: Optional[str] = None):
        super().__init__()
        self.direction, self.with_conv = direction, with_conv
        out_ch = out_ch or channels
        if with_conv and direction == "up":
            self.conv = Conv3x3(channels, out_ch, compute_dtype, quant)
        elif with_conv:
            self.op = Conv2d(channels, out_ch, compute_dtype, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.direction == "up":
            x = _nearest_x2(x)
            return self.conv(x) if self.with_conv else x
        return self.op(x) if self.with_conv else _avgpool_x2(x)


class ADMResBlock(nn.Module):
    """ResBlock with optional FiLM (scale-shift) conditioning and in-block
    up/downsampling (unet.py:143-256). Reference keys: in_layers.{0,2},
    emb_layers.1, out_layers.{0,3}, skip_connection."""

    def __init__(self, in_ch: int, out_ch: int, emb_ch: int, use_scale_shift_norm: bool = False,
                 direction: Optional[str] = None, compute_dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0, quant: Optional[str] = None):
        super().__init__()
        dt = compute_dtype
        self.use_scale_shift_norm, self.direction = use_scale_shift_norm, direction
        self.in_layers = nn.ModuleList([_adm_norm(in_ch), nn.SiLU(),
                                        Conv3x3(in_ch, out_ch, dt, quant)])
        emb_width = 2 * out_ch if use_scale_shift_norm else out_ch
        self.emb_layers = nn.ModuleList([nn.SiLU(), Linear(emb_ch, emb_width, dt)])
        self.out_layers = nn.ModuleList([_adm_norm(out_ch), nn.SiLU(), nn.Dropout(dropout),
                                         Conv3x3(out_ch, out_ch, dt, quant)])
        if in_ch != out_ch:
            # unlike the BigGAN block, ADM keeps an identity skip whenever the
            # channel count is unchanged, even for up/down blocks (unet.py:215-222)
            self.skip_connection = Conv1x1(in_ch, out_ch, dt)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.in_layers[0](x))
        if self.direction is not None:
            resample = _nearest_x2 if self.direction == "up" else _avgpool_x2
            h, x = resample(h), resample(x)
        h = self.in_layers[2](h)
        e = self.emb_layers[1](F.silu(emb))[:, None, None, :]
        if self.use_scale_shift_norm:
            scale, shift = e.chunk(2, dim=-1)
            h = self.out_layers[0](h) * (1.0 + scale) + shift
        else:
            h = self.out_layers[0](h + e)
        # live under .train(), off under .eval() (the JAX deterministic flag)
        h = self.out_layers[3](self.out_layers[2](F.silu(h)))
        if hasattr(self, "skip_connection"):
            x = self.skip_connection(x)
        return x + h


def qkv_attention(qkv: torch.Tensor, num_heads: int, *, new_order: bool) -> torch.Tensor:
    """Multi-head attention over tokens from a fused (B, T, 3C) projection.

    `new_order=False` (legacy, QKVAttentionLegacy unet.py:328-354): the 3C
    channels are head-major [h0:(q k v), h1:(q k v), ...]; q, k and v are
    gathered into head-major copies. `new_order=True` (QKVAttention
    unet.py:361-389): [q all heads | k all heads | v all heads], read in place.
    The reference's ch^-1/4 scaling of q and k is one ch^-1/2 on the fp32
    logits.
    """
    b, t, w = qkv.shape
    c = w // 3
    ch = c // num_heads
    if new_order:
        q, k, v = qkv.split(c, dim=-1)
    else:
        grouped = qkv.reshape(b, t, num_heads, 3 * ch)
        q, k, v = (u.reshape(b, t, c) for u in grouped.split(ch, dim=-1))
    return token_attention(q, k, v, num_heads=num_heads, scale=1.0 / math.sqrt(ch))


class ADMAttention(nn.Module):
    """Spatial self-attention block (unet.py:259-305): `norm`, `qkv` and
    `proj_out` keep the reference's Conv1d weights (O, I, 1)."""

    def __init__(self, channels: int, num_heads: int = 1, new_order: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.new_order, self.compute_dtype = num_heads, new_order, compute_dtype
        self.norm = _adm_norm(channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv1d(channels, channels, 1)
        # tensor parallelism's site (parallel/tp.py): qkv column-parallel by
        # heads, proj_out row-parallel
        self.tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        dt = self.compute_dtype
        tokens = self.norm(x).reshape(b, hh * ww, c).to(dt)
        if self.tp is not None:
            tokens = self.tp.copy(tokens)
        qkv = F.linear(tokens, self.qkv.weight[:, :, 0].to(dt), self.qkv.bias.to(dt))
        h = qkv_attention(qkv, self.num_heads, new_order=self.new_order)
        if self.tp is not None:
            h = self.tp.row_linear(h, self.proj_out.weight[:, :, 0], self.proj_out.bias, dt)
        else:
            h = F.linear(h, self.proj_out.weight[:, :, 0].to(dt), self.proj_out.bias.to(dt))
        return x + h.reshape(b, hh, ww, c)


# --------------------------------------------------------------------------- #
# structural layout shared by the model and the converter
# --------------------------------------------------------------------------- #


class _HeadPlanner:
    """Replays the reference's per-site head arithmetic, including the fact
    that `num_heads` is a *mutable local* in the torch constructor: once
    num_head_channels is set it is overwritten at every attention site and
    the new value leaks into later SpatialTransformer sites
    (openaimodel.py:543-553,589-596,644-651; guided unet.py:277-283)."""

    def __init__(self, cfg: ADMConfig):
        self.cfg = cfg
        self.num_heads = cfg.num_heads
        self.heads_up = (cfg.num_heads_upsample
                         if cfg.num_heads_upsample != -1 else cfg.num_heads)

    def spec(self, ch: int, upsample: bool = False) -> dict:
        cfg = self.cfg
        if cfg.num_head_channels == -1:
            dim_head = ch // self.num_heads
        else:
            self.num_heads = ch // cfg.num_head_channels
            dim_head = cfg.num_head_channels
        if cfg.legacy:
            dim_head = (ch // self.num_heads if cfg.use_spatial_transformer
                        else cfg.num_head_channels)
        if cfg.use_spatial_transformer:
            return dict(kind="xattn", heads=self.num_heads, dim_head=dim_head,
                        depth=cfg.transformer_depth,
                        linear=cfg.use_linear_in_transformer)
        site_heads = self.heads_up if upsample else self.num_heads
        eff = ch // dim_head if dim_head != -1 else site_heads
        return dict(kind="attn", heads=eff)


def layout(cfg: ADMConfig, encoder_only: bool = False) -> Dict[str, Any]:
    """Replay of the reference constructor loops (unet.py:480-616) producing,
    per torch module index, the layer specs inside each TimestepEmbedSequential.
    Spec kinds: conv_in | res | attn | xattn | resample."""
    mc = cfg.model_channels
    heads = _HeadPlanner(cfg)
    ch = int(cfg.channel_mult[0] * mc)
    input_blocks: List[List[dict]] = [[dict(kind="conv_in", out_ch=ch)]]
    chans = [ch]
    ds = 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            layers = [dict(kind="res", out_ch=int(mult * mc))]
            ch = int(mult * mc)
            if ds in cfg.attention_resolutions:
                layers.append(heads.spec(ch))
            input_blocks.append(layers)
            chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            if cfg.resblock_updown:
                input_blocks.append([dict(kind="res", out_ch=ch, direction="down")])
            else:
                input_blocks.append([dict(kind="resample", direction="down", out_ch=ch,
                                          with_conv=cfg.conv_resample)])
            chans.append(ch)
            ds *= 2

    middle = [dict(kind="res", out_ch=ch), heads.spec(ch), dict(kind="res", out_ch=ch)]

    output_blocks: List[List[dict]] = []
    if not encoder_only:
        for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
            for i in range(cfg.num_res_blocks + 1):
                layers = [dict(kind="res", out_ch=int(mult * mc))]
                ch = int(mult * mc)
                if ds in cfg.attention_resolutions:
                    layers.append(heads.spec(ch, upsample=True))
                if level and i == cfg.num_res_blocks:
                    if cfg.resblock_updown:
                        layers.append(dict(kind="res", out_ch=ch, direction="up"))
                    else:
                        layers.append(dict(kind="resample", direction="up", out_ch=ch,
                                           with_conv=cfg.conv_resample))
                    ds //= 2
                output_blocks.append(layers)
    return dict(input_blocks=input_blocks, middle=middle, output_blocks=output_blocks)


class _ADMBase(nn.Module):
    """Encoder machinery shared by ADMUNet and ADMClassifier: the time
    embedding, the input blocks and the middle block of `layout(cfg)`.

    Built on `device`, the card by default (raises when there is none), in
    eval mode (dropout off, the JAX default deterministic=True); `.train()`
    makes dropout live at `config.dropout`.
    Parameters are fp32 and cast to `compute_dtype` where they are used.
    """

    def __init__(self, config: ADMConfig, compute_dtype: torch.dtype = torch.float32,
                 device=DEFAULT_DEVICE):
        super().__init__()
        dev = resolve_device(device)
        self.config, self.compute_dtype = config, compute_dtype
        with torch.device(dev):
            self._construct(dev)
        self.eval()

    def _construct(self, dev: torch.device):
        raise NotImplementedError

    def _encoder(self, dev: torch.device, encoder_only: bool):
        """Build time_embed, input_blocks and middle_block; return the layout,
        the block builder, the input blocks' output widths and the width."""
        cfg, dt = self.config, self.compute_dtype
        plan = layout(cfg, encoder_only=encoder_only)
        emb_ch = cfg.model_channels * 4
        self.time_embed = nn.ModuleList([Linear(cfg.model_channels, emb_ch, dt), nn.SiLU(),
                                         Linear(emb_ch, emb_ch, dt)])

        def make(spec: dict, ch: int):
            kind = spec["kind"]
            if kind == "conv_in":
                return Conv2d(ch, spec["out_ch"], dt), spec["out_ch"]
            if kind == "res":
                return ADMResBlock(ch, spec["out_ch"], emb_ch, cfg.use_scale_shift_norm,
                                   spec.get("direction"), compute_dtype=dt,
                                   dropout=cfg.dropout, quant=cfg.quant), spec["out_ch"]
            if kind == "attn":
                return ADMAttention(ch, spec["heads"], cfg.use_new_attention_order, dt), ch
            if kind == "xattn":
                return SpatialTransformer(ch, spec["heads"], spec["dim_head"], spec["depth"],
                                          cfg.context_dim, spec.get("linear", False), dt,
                                          device=dev, quant=cfg.quant), ch
            if kind == "resample":
                return ADMResample(spec["direction"], ch, spec["out_ch"], spec["with_conv"],
                                   dt, cfg.quant), spec["out_ch"]
            raise ValueError(kind)

        def seq(layers, ch):
            mods = nn.ModuleList()
            for spec in layers:
                mod, ch = make(spec, ch)
                mods.append(mod)
            return mods, ch

        ch, chans = cfg.in_channels, []
        self.input_blocks = nn.ModuleList()
        for layers in plan["input_blocks"]:
            mods, ch = seq(layers, ch)
            self.input_blocks.append(mods)
            chans.append(ch)
        self.middle_block, ch = seq(plan["middle"], ch)
        return plan, seq, chans, ch

    def _embed(self, t: torch.Tensor) -> torch.Tensor:
        emb = self.time_embed[0](adm_timestep_embedding(t, self.config.model_channels))
        return self.time_embed[2](F.silu(emb))

    def _run(self, mods: nn.ModuleList, h, emb, context=None):
        # remat as the JAX model's nn.remat: res blocks and transformers,
        # where autograd records; the checkpoint keeps the default
        # generators' state, so a block's dropout mask is drawn again on
        # recompute
        remat = self.config.remat and torch.is_grad_enabled()
        for mod in mods:
            if isinstance(mod, ADMResBlock):
                h = checkpoint(mod, h, emb, use_reentrant=False) if remat else mod(h, emb)
            elif isinstance(mod, SpatialTransformer):
                h = (checkpoint(mod, h, context, use_reentrant=False) if remat
                     else mod(h, context=context))
            else:
                h = mod(h)
        return h


class ADMUNet(_ADMBase):
    """UNetModel (unet.py:396-663). x NHWC (B, H, W, C); t (B,) labels
    (fractional ones too); y (B,) int class labels iff config.num_classes is
    set; context (B, S, context_dim) for the SpatialTransformers. Returns fp32.
    """

    def _construct(self, dev: torch.device):
        cfg, dt = self.config, self.compute_dtype
        plan, seq, chans, ch = self._encoder(dev, encoder_only=False)
        if cfg.num_classes is not None:
            self.label_emb = nn.Embedding(cfg.num_classes, cfg.model_channels * 4)
        self.output_blocks = nn.ModuleList()
        for layers in plan["output_blocks"]:
            mods, ch = seq(layers, ch + chans.pop())
            self.output_blocks.append(mods)
        self.out = nn.ModuleList([_adm_norm(ch), nn.SiLU(), Conv2d(ch, cfg.out_channels, dt)])

    def forward(self, x: torch.Tensor, t: torch.Tensor, y: Optional[torch.Tensor] = None,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        if (y is not None) != (cfg.num_classes is not None):
            raise ValueError("pass y exactly when config.num_classes is set")
        emb = self._embed(t)
        if cfg.num_classes is not None:
            emb = emb + self.label_emb(y).to(emb.dtype)
        h = x.to(self.compute_dtype)
        hs = []
        for mods in self.input_blocks:
            h = self._run(mods, h, emb, context)
            hs.append(h)
        h = self._run(self.middle_block, h, emb, context)
        for mods in self.output_blocks:
            h = self._run(mods, torch.cat([h, hs.pop()], dim=-1), emb, context)
        h = F.silu(self.out[0](h.to(x.dtype)))
        return self.out[2](h).float()


def super_res_inputs(x: torch.Tensor, low_res: torch.Tensor) -> torch.Tensor:
    """SuperResModel conditioning (unet.py:666-680): bilinear-upsample the
    NHWC low-res image to x's resolution and concatenate on channels."""
    up = F.interpolate(low_res.permute(0, 3, 1, 2), size=x.shape[1:3], mode="bilinear",
                       align_corners=False)
    return torch.cat([x, up.permute(0, 2, 3, 1).to(x.dtype)], dim=-1)


class AttentionPool2d(nn.Module):
    """CLIP-style attention pooling with a mean-token query (unet.py:22-51).

    Reference layouts: `positional_embedding` (C, HW+1), `qkv_proj` and
    `c_proj` Conv1d weights (O, I, 1). The attention runs over all HW+1
    tokens with `ops.token_attention` (qkv-major order, q/k/v read in place)
    and the pooled output is token 0.
    """

    def __init__(self, spacial_dim: int, embed_dim: int, num_head_channels: int,
                 output_dim: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.positional_embedding = nn.Parameter(
            torch.randn(embed_dim, spacial_dim ** 2 + 1) / embed_dim ** 0.5)
        self.qkv_proj = nn.Conv1d(embed_dim, 3 * embed_dim, 1)
        self.c_proj = nn.Conv1d(embed_dim, output_dim, 1)
        self.num_heads = embed_dim // num_head_channels
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        dt = self.compute_dtype
        tokens = x.reshape(b, hh * ww, c)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding.t()[None].to(tokens.dtype)
        qkv = F.linear(tokens.to(dt), self.qkv_proj.weight[:, :, 0].to(dt),
                       self.qkv_proj.bias.to(dt))
        h = qkv_attention(qkv, self.num_heads, new_order=True)
        h = F.linear(h, self.c_proj.weight[:, :, 0].to(dt), self.c_proj.bias.to(dt))
        return h[:, 0]


POOLS = ("adaptive", "attention", "spatial", "spatial_v2")


class ADMClassifier(_ADMBase):
    """EncoderUNetModel (unet.py:683-894): the UNet's encoder half and one of
    four pooling heads (`config.pool`). x NHWC; t (B,) labels. Returns fp32
    (B, out_channels) logits. Head keys as the reference's `out` Sequential:
    adaptive `out.0` (norm), `out.3` (1x1 conv); attention `out.0`, `out.2`
    (AttentionPool2d); spatial `out.0`, `out.2` (Linear); spatial_v2 `out.0`
    (Linear), `out.1` (norm), `out.3` (Linear).
    """

    def _construct(self, dev: torch.device):
        cfg, dt = self.config, self.compute_dtype
        _, _, chans, ch = self._encoder(dev, encoder_only=True)
        out = cfg.out_channels
        if cfg.pool == "adaptive":
            self.out = nn.ModuleList([_adm_norm(ch), nn.SiLU(), nn.AdaptiveAvgPool2d((1, 1)),
                                      Conv1x1(ch, out, dt), nn.Flatten()])
        elif cfg.pool == "attention":
            if cfg.num_head_channels == -1:
                raise ValueError("the attention pool needs num_head_channels")
            side = cfg.image_size // 2 ** (len(cfg.channel_mult) - 1)
            self.out = nn.ModuleList([_adm_norm(ch), nn.SiLU(), AttentionPool2d(
                side, ch, cfg.num_head_channels, out, dt)])
        elif cfg.pool == "spatial":
            self.out = nn.ModuleList([Linear(sum(chans) + ch, 2048, dt), nn.ReLU(),
                                      Linear(2048, out, dt)])
        elif cfg.pool == "spatial_v2":
            self.out = nn.ModuleList([Linear(sum(chans) + ch, 2048, dt), _adm_norm(2048),
                                      nn.SiLU(), Linear(2048, out, dt)])
        else:
            raise ValueError(f"pool must be one of {POOLS}, got {cfg.pool!r}")

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        pool = self.config.pool
        emb = self._embed(t)
        h = x.to(self.compute_dtype)
        spatial = []
        for mods in self.input_blocks:
            h = self._run(mods, h, emb)
            if pool.startswith("spatial"):
                spatial.append(h.mean(dim=(1, 2)))
        h = self._run(self.middle_block, h, emb)
        if pool == "adaptive":
            return self.out[3](F.silu(self.out[0](h)).mean(dim=(1, 2))).float()
        if pool == "attention":
            return self.out[2](F.silu(self.out[0](h))).float()
        spatial.append(h.mean(dim=(1, 2)))
        h = self.out[0](torch.cat(spatial, dim=-1))
        if pool == "spatial":
            return self.out[2](F.relu(h)).float()
        return self.out[3](F.silu(self.out[1](h))).float()
