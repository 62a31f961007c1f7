"""The latent-diffusion first stages, NHWC: AutoencoderKL (Stable Diffusion)
and VQModel (the class-conditional ImageNet LDM, cin256).

Port of `dpm_solver_tpu/models/vae.py`, twin of the reference
ldm/modules/diffusionmodules/model.py (ResnetBlock :82-141, AttnBlock
:150-207, Encoder :368-460, Decoder :462-569), ldm/models/autoencoder.py
(VQModel :14-282, AutoencoderKL :285-343) and
ldm/modules/distributions/distributions.py:24-62. Parameter names are the
reference's state-dict keys (`decoder.up.3.block.0.conv1`,
`encoder.mid.attn_1.q`, `post_quant_conv`, `quantize.embedding.weight`, ...)
in its layouts. The VQ quantizer's nearest-code search is one distance
matrix product (`torch.matmul`, as the JAX package leaves it to XLA) and an
argmin.

Where the kernels run: every 3x3 stride-1 conv, `conv_in` and `conv_out`
included (JAX `Conv3x3`), goes through `ops.conv3x3` (33 launches per SD
decode: there the kernel sees 4 input channels at `decoder.conv_in` and 3
output channels at `decoder.conv_out`); the single-head attention goes
through `ops.token_attention` with a 512-wide head. Its q, k and v 1x1
convs run as one (C, 3C) product and the attention reads the three column
slices of that output in place. The stride-2 downsample conv is `F.conv2d`
and the 1x1 convs are matmuls, as the JAX model leaves them to XLA.

Adversarial training (`training/autoencoder.py`) takes the forward split
at the decoder's final conv (`forward_trunk`, then `decoder_epilogue`,
bitwise equal to `decode`) and the posterior's `kl`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dpm_solver_tpu_torch.models.ddpm_unet import Conv1x1, Conv2d, GroupNorm32, swish
from dpm_solver_tpu_torch.ops.attention import token_attention
from dpm_solver_tpu_torch.ops.conv3x3 import Conv3x3
from dpm_solver_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """ddconfig + embed_dim (ref configs/stable-diffusion/v1-inference.yaml
    first_stage_config)."""

    ch: int = 128
    out_ch: int = 3
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = ()
    in_channels: int = 3
    resolution: int = 256
    z_channels: int = 4
    double_z: bool = True
    embed_dim: int = 4
    dropout: float = 0.0
    resamp_with_conv: bool = True
    tanh_out: bool = False

    @staticmethod
    def sd_v1() -> "VAEConfig":
        return VAEConfig()

    @staticmethod
    def vq_cin256() -> "VAEConfig":
        """f4 VQ first stage of the class-conditional ImageNet LDM
        (configs/latent-diffusion/cin256-v2.yaml: z=3, ch_mult (1,2,4),
        n_embed 8192, no attention, double_z false)."""
        return VAEConfig(ch_mult=(1, 2, 4), z_channels=3, embed_dim=3,
                         double_z=False, attn_resolutions=())

    @staticmethod
    def rdm_768() -> "VAEConfig":
        """f16/z16 KL first stage of the retrieval-augmented model."""
        return VAEConfig(ch_mult=(1, 1, 2, 2, 4), z_channels=16,
                         embed_dim=16, attn_resolutions=(16,))

    @staticmethod
    def tiny(**overrides) -> "VAEConfig":
        base = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, resolution=32,
                    z_channels=4, embed_dim=4, attn_resolutions=(16,))
        base.update(overrides)
        return VAEConfig(**base)


class VAEResBlock(nn.Module):
    """ResnetBlock with temb_channels=0 (model.py:82-141)."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        out_ch = out_ch or in_ch
        self.norm1 = GroupNorm32(in_ch)
        self.conv1 = Conv3x3(in_ch, out_ch, compute_dtype)
        self.norm2 = GroupNorm32(out_ch)
        self.conv2 = Conv3x3(out_ch, out_ch, compute_dtype)
        if in_ch != out_ch:
            self.nin_shortcut = Conv1x1(in_ch, out_ch, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(swish(self.norm1(x)))
        h = self.conv2(swish(self.norm2(h)))  # dropout is a no-op when sampling
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class VAEAttnBlock(nn.Module):
    """Single-head spatial attention (model.py:150-207); the q/k/v 1x1 convs
    (reference weights (C, C, 1, 1)) run as one (C, 3C) token product."""

    def __init__(self, channels: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.norm = GroupNorm32(channels)
        self.q, self.k, self.v = (Conv1x1(channels, channels, compute_dtype) for _ in range(3))
        self.proj_out = Conv1x1(channels, channels, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        dt = self.compute_dtype
        tokens = self.norm(x).reshape(b, hh * ww, c).to(dt)
        w = torch.cat([m.weight[:, :, 0, 0] for m in (self.q, self.k, self.v)]).to(dt)
        bias = torch.cat([m.bias for m in (self.q, self.k, self.v)]).to(dt)
        q, k, v = F.linear(tokens, w, bias).split(c, dim=-1)  # read in place
        h = token_attention(q, k, v, num_heads=1, scale=c ** -0.5)
        return x + self.proj_out(h).reshape(b, hh, ww, c)


class _Level(nn.Module):
    """One resolution level: `block` and `attn` lists plus its resampler."""

    def __init__(self):
        super().__init__()
        self.block, self.attn = nn.ModuleList(), nn.ModuleList()


class _Downsample(nn.Module):
    """torch pads (0, 1, 0, 1) by hand, then a VALID stride-2 conv (model.py:72-76)."""

    def __init__(self, channels: int, compute_dtype: torch.dtype):
        super().__init__()
        self.conv = Conv2d(channels, channels, compute_dtype, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))


class _Upsample(nn.Module):
    def __init__(self, channels: int, compute_dtype: torch.dtype):
        super().__init__()
        self.conv = Conv3x3(channels, channels, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))


def _mid(ch: int, dt: torch.dtype) -> nn.Module:
    mid = nn.Module()
    mid.block_1, mid.attn_1, mid.block_2 = VAEResBlock(ch, ch, dt), VAEAttnBlock(ch, dt), \
        VAEResBlock(ch, ch, dt)
    return mid


class VAEEncoder(nn.Module):
    """model.py:368-460; emits 2*z_channels moments when double_z. Built on
    `device`, the card by default."""

    def __init__(self, config: VAEConfig, compute_dtype: torch.dtype = torch.float32,
                 device=DEFAULT_DEVICE):
        super().__init__()
        cfg, dt = config, compute_dtype
        self.config = cfg
        with torch.device(resolve_device(device)):
            self.conv_in = Conv3x3(cfg.in_channels, cfg.ch, dt)
            res, in_mult = cfg.resolution, (1,) + tuple(cfg.ch_mult)
            self.down = nn.ModuleList()
            for i, mult in enumerate(cfg.ch_mult):
                level = _Level()
                block_in = cfg.ch * in_mult[i]
                for _ in range(cfg.num_res_blocks):
                    level.block.append(VAEResBlock(block_in, cfg.ch * mult, dt))
                    block_in = cfg.ch * mult
                    if res in cfg.attn_resolutions:
                        level.attn.append(VAEAttnBlock(block_in, dt))
                if i != len(cfg.ch_mult) - 1:
                    if cfg.resamp_with_conv:
                        level.downsample = _Downsample(block_in, dt)
                    res //= 2
                self.down.append(level)
            self.mid = _mid(block_in, dt)
            self.norm_out = GroupNorm32(block_in)
            self.conv_out = Conv3x3(block_in, 2 * cfg.z_channels if cfg.double_z
                                    else cfg.z_channels, dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        h = self.conv_in(x)
        for i, level in enumerate(self.down):
            for j, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[j](h)
            if i != len(cfg.ch_mult) - 1:
                h = level.downsample(h) if cfg.resamp_with_conv else F.avg_pool2d(
                    h.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1).contiguous()
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(swish(self.norm_out(h)))


class VAEDecoder(nn.Module):
    """model.py:462-569. Built on `device`, the card by default."""

    def __init__(self, config: VAEConfig, compute_dtype: torch.dtype = torch.float32,
                 device=DEFAULT_DEVICE):
        super().__init__()
        cfg, dt = config, compute_dtype
        self.config = cfg
        levels = len(cfg.ch_mult)
        with torch.device(resolve_device(device)):
            block_in = cfg.ch * cfg.ch_mult[-1]
            self.conv_in = Conv3x3(cfg.z_channels, block_in, dt)
            self.mid = _mid(block_in, dt)
            res = cfg.resolution // 2 ** (levels - 1)
            up = []
            for i in reversed(range(levels)):
                level = _Level()
                for _ in range(cfg.num_res_blocks + 1):
                    level.block.append(VAEResBlock(block_in, cfg.ch * cfg.ch_mult[i], dt))
                    block_in = cfg.ch * cfg.ch_mult[i]
                    if res in cfg.attn_resolutions:
                        level.attn.append(VAEAttnBlock(block_in, dt))
                if i != 0:
                    if cfg.resamp_with_conv:
                        level.upsample = _Upsample(block_in, dt)
                    res *= 2
                up.insert(0, level)
            self.up = nn.ModuleList(up)  # up[i] is level i, as in the reference
            self.norm_out = GroupNorm32(block_in)
            self.conv_out = Conv3x3(block_in, cfg.out_ch, dt)

    def forward(self, z: torch.Tensor, return_trunk: bool = False) -> torch.Tensor:
        """The image; with `return_trunk`, the activations before `conv_out`
        (adversarial training re-applies `decoder_epilogue` to them as a
        function of conv_out's weight, so the adaptive GAN weight,
        contperceptual.py:32-43, costs one conv backward, not a decoder's)."""
        cfg = self.config
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for i in reversed(range(len(cfg.ch_mult))):
            level = self.up[i]
            for j, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[j](h)
            if i != 0:
                h = level.upsample(h) if cfg.resamp_with_conv else \
                    h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        h = swish(self.norm_out(h))
        return h if return_trunk else decoder_epilogue(self.conv_out, h, tanh_out=cfg.tanh_out)


def decoder_epilogue(conv_out: Conv3x3, h: torch.Tensor, *, weight: Optional[torch.Tensor] = None,
                     tanh_out: bool = False) -> torch.Tensor:
    """The decoder's final conv (and tanh) on its trunk `h`, with `weight` in
    place of conv_out's own when given (the adaptive GAN weight
    differentiates with respect to it alone). The module's own forward, so
    the split path is bitwise equal to `decode`."""
    out = conv_out(h) if weight is None else torch.func.functional_call(
        conv_out, {"weight": weight}, (h,))
    return torch.tanh(out) if tanh_out else out


class DiagonalGaussian(NamedTuple):
    """Posterior over latents (distributions.py:24-62); moments NHWC with
    channels = 2*z (mean | logvar)."""

    mean: torch.Tensor
    logvar: torch.Tensor

    @staticmethod
    def from_moments(moments: torch.Tensor) -> "DiagonalGaussian":
        mean, logvar = moments.chunk(2, dim=-1)
        return DiagonalGaussian(mean, logvar.clamp(-30.0, 20.0))

    @property
    def std(self) -> torch.Tensor:
        return torch.exp(0.5 * self.logvar)

    def sample(self, noise: torch.Tensor) -> torch.Tensor:
        """mean + std * noise, for a standard normal `noise` of mean's shape."""
        return self.mean + self.std * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        """KL(q || N(0, I)) of each sample, (B,)."""
        return 0.5 * torch.sum(self.mean ** 2 + torch.exp(self.logvar) - 1.0 - self.logvar,
                               dim=(1, 2, 3))

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        """-log q(sample) of each sample, (B,)."""
        return 0.5 * torch.sum(math.log(2.0 * math.pi) + self.logvar
                               + (sample - self.mean) ** 2 / torch.exp(self.logvar),
                               dim=(1, 2, 3))


class AutoencoderKL(nn.Module):
    """Encoder/Decoder + 1x1 quant convs (autoencoder.py:285-343):
    `encode(x) -> DiagonalGaussian`, `decode(z)`, and `forward` for the
    round trip. Built on `device`, the card by default (raises when there is
    none); parameters fp32, cast to `compute_dtype` where they are used."""

    def __init__(self, config: VAEConfig, compute_dtype: torch.dtype = torch.float32,
                 device=DEFAULT_DEVICE):
        super().__init__()
        dev = resolve_device(device)
        cfg = self.config = config
        self.encoder = VAEEncoder(cfg, compute_dtype, device=dev)
        self.decoder = VAEDecoder(cfg, compute_dtype, device=dev)
        with torch.device(dev):
            self.quant_conv = Conv1x1(2 * cfg.z_channels if cfg.double_z else cfg.z_channels,
                                      2 * cfg.embed_dim if cfg.double_z else cfg.embed_dim,
                                      compute_dtype)
            self.post_quant_conv = Conv1x1(cfg.embed_dim, cfg.z_channels, compute_dtype)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        return DiagonalGaussian.from_moments(self.quant_conv(self.encoder(x)))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None):
        """Reconstruction and posterior; the posterior's sample when `noise` is given,
        else its mode."""
        posterior = self.encode(x)
        z = posterior.mode() if noise is None else posterior.sample(noise)
        return self.decode(z), posterior

    def forward_trunk(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None):
        """The training forward split at the decoder's final conv: (the
        activations before conv_out, posterior); pair with
        `decoder_epilogue(self.decoder.conv_out, h)`."""
        posterior = self.encode(x)
        z = posterior.mode() if noise is None else posterior.sample(noise)
        return self.decoder(self.post_quant_conv(z), return_trunk=True), posterior


class VectorQuantizer(nn.Module):
    """Nearest-codebook quantizer with the straight-through gradient (the
    taming-transformers VectorQuantizer2 the reference VQModel imports,
    autoencoder.py:6,39-41). z NHWC with channels == embed_dim; the codebook
    is `embedding.weight` (n_embed, embed_dim). The distances
    ||z||^2 - 2 z.E + ||E||^2, the argmin and the loss run in fp32."""

    def __init__(self, n_embed: int, embed_dim: int, beta: float = 0.25):
        super().__init__()
        self.n_embed, self.embed_dim, self.beta = n_embed, embed_dim, beta
        self.embedding = nn.Embedding(n_embed, embed_dim)
        nn.init.uniform_(self.embedding.weight, -1.0 / n_embed, 1.0 / n_embed)

    def indices(self, z: torch.Tensor) -> torch.Tensor:
        """The nearest code of each position, (B, H, W) int64."""
        flat = z.float().reshape(-1, self.embed_dim)
        codebook = self.embedding.weight.float()
        d = ((flat ** 2).sum(1, keepdim=True) - 2.0 * flat @ codebook.t()
             + (codebook ** 2).sum(1)[None, :])
        return d.argmin(1).reshape(z.shape[:-1])

    def forward(self, z: torch.Tensor):
        """(z_q, codebook loss, indices); z_q = z + (E[idx] - z), its
        gradient passing straight through to z, fp32."""
        idx = self.indices(z)
        z = z.float()
        z_q = self.embedding.weight.float()[idx]
        loss = ((z_q.detach() - z) ** 2).mean() + self.beta * ((z_q - z.detach()) ** 2).mean()
        return z + (z_q - z).detach(), loss, idx


class VQModel(nn.Module):
    """VQ first stage (autoencoder.py:14-282, the VQModelInterface
    convention): `encode` returns the PRE-quant latent, `decode` quantises
    unless `force_not_quantize`, `forward` returns (reconstruction, codebook
    loss, indices). Built on `device`, the card by default (raises when
    there is none); parameters fp32, cast to `compute_dtype` where used (the
    quantizer stays fp32)."""

    def __init__(self, config: VAEConfig, n_embed: int = 16384,
                 compute_dtype: torch.dtype = torch.float32, device=DEFAULT_DEVICE):
        super().__init__()
        if config.double_z:
            raise ValueError("the VQ first stage uses double_z=False")
        dev = resolve_device(device)
        cfg = self.config = config
        self.n_embed = n_embed
        self.encoder = VAEEncoder(cfg, compute_dtype, device=dev)
        self.decoder = VAEDecoder(cfg, compute_dtype, device=dev)
        with torch.device(dev):
            self.quantize = VectorQuantizer(n_embed, cfg.embed_dim)
            self.quant_conv = Conv1x1(cfg.z_channels, cfg.embed_dim, compute_dtype)
            self.post_quant_conv = Conv1x1(cfg.embed_dim, cfg.z_channels, compute_dtype)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.quant_conv(self.encoder(x))

    def decode(self, h: torch.Tensor, force_not_quantize: bool = False) -> torch.Tensor:
        if not force_not_quantize:
            h = self.quantize(h)[0]
        return self.decoder(self.post_quant_conv(h))

    def forward(self, x: torch.Tensor):
        z_q, loss, idx = self.quantize(self.encode(x))
        return self.decoder(self.post_quant_conv(z_q)), loss, idx

    def forward_trunk(self, x: torch.Tensor):
        """The training forward split at the decoder's final conv: (the
        activations before conv_out, codebook loss, indices)."""
        z_q, loss, idx = self.quantize(self.encode(x))
        return self.decoder(self.post_quant_conv(z_q), return_trunk=True), loss, idx
