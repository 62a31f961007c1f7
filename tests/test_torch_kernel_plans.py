"""The host-side plans of the two TMA + wgmma kernels, held on the CPU.

Every shape decision of `csrc/conv3x3.cu` and `csrc/attention.cu` is made in
Python and handed to the kernel: the conv route and its 128-pixel output
patch (`ops/conv3x3.py::conv3x3_plan`), and the attention tile per head dim
(`ops/attention.py::attention_plan`). The kernels run on the card only, so
these tests hold, on the CPU, what the plans promise:

- every conv shape of paths A-D, the SD VAE decoder and SD-1 (listed below,
  and checked against the configs by tracing them on the meta device), and
  ragged ones: the route follows the TMA rule (bf16 with C % 8 == 0 and
  CO % 8 == 0 takes "wgmma"), and a "wgmma" patch is 128 pixels, a legal
  TMA box, and tiles each path's map with no pixel past it (the kernel's
  decode of a patch, and its masks on a ragged edge, are held on the card
  by `chip_smoke.py`);
- every head dim: the tile fits the 227 KB a block may use, and its shapes
  are what `wgmma` and the 128-byte swizzle take.
"""

import dataclasses
from collections import Counter
from itertools import chain

import pytest
import torch

from dpm_solver_tpu_torch import ops
from dpm_solver_tpu_torch.models import (ADMClassifier, ADMConfig, ADMUNet, AutoencoderKL,
                                         DDPMUNet, DDPMUNetConfig, NCSNpp, NCSNppConfig,
                                         VAEConfig, layout, transformer)
from dpm_solver_tpu_torch.ops import _build
from dpm_solver_tpu_torch.ops.attention import (HEAD_DIMS, SMEM_PER_BLOCK, AttentionTile,
                                                attention_plan)
from dpm_solver_tpu_torch.ops.conv3x3 import (PATCH_PIXELS, WGMMA_BLOCK_N, WGMMA_SMEM,
                                              conv3x3_patch, conv3x3_plan)

# (B, H, W, C, CO) of every Conv3x3 call of one network forward at each
# path's batch: A CIFAR-10 DDPM b64; D DDPM++ deep b256; B SD-2.1 UNet at
# 96x96 latents, CFG b8, and the VAE decoder b4; C the guided ImageNet-256
# UNet and its classifier, b8; SD-1 at 64x64 latents, CFG b2
CONV_SHAPES = {
    "A": [(64, 4, 4, 256, 256), (64, 4, 4, 512, 256), (64, 8, 8, 256, 256),
          (64, 8, 8, 512, 256), (64, 16, 16, 128, 256), (64, 16, 16, 256, 256),
          (64, 16, 16, 384, 256), (64, 16, 16, 512, 256), (64, 32, 32, 128, 128),
          (64, 32, 32, 256, 128), (64, 32, 32, 256, 256), (64, 32, 32, 384, 128)],
    "D": [(256, 4, 4, 256, 256), (256, 4, 4, 512, 256), (256, 8, 8, 256, 256),
          (256, 8, 8, 512, 256), (256, 16, 16, 128, 128), (256, 16, 16, 128, 256),
          (256, 16, 16, 256, 256), (256, 16, 16, 384, 256), (256, 16, 16, 512, 256),
          (256, 32, 32, 128, 128), (256, 32, 32, 256, 128), (256, 32, 32, 256, 256),
          (256, 32, 32, 384, 128)],
    "B": [(8, 12, 12, 1280, 1280), (8, 12, 12, 2560, 1280), (8, 24, 24, 640, 1280),
          (8, 24, 24, 1280, 1280), (8, 24, 24, 1920, 1280), (8, 24, 24, 2560, 1280),
          (8, 48, 48, 320, 640), (8, 48, 48, 640, 640), (8, 48, 48, 960, 640),
          (8, 48, 48, 1280, 640), (8, 48, 48, 1280, 1280), (8, 48, 48, 1920, 640),
          (8, 96, 96, 320, 320), (8, 96, 96, 640, 320), (8, 96, 96, 640, 640),
          (8, 96, 96, 960, 320)],
    "B-vae": [(4, 96, 96, 4, 512), (4, 96, 96, 512, 512), (4, 192, 192, 512, 512),
              (4, 384, 384, 256, 256), (4, 384, 384, 512, 256), (4, 384, 384, 512, 512),
              (4, 768, 768, 128, 3), (4, 768, 768, 128, 128), (4, 768, 768, 256, 128),
              (4, 768, 768, 256, 256)],
    "C": [(8, 8, 8, 1024, 1024), (8, 8, 8, 2048, 1024), (8, 16, 16, 512, 512),
          (8, 16, 16, 512, 1024), (8, 16, 16, 1024, 1024), (8, 16, 16, 1536, 1024),
          (8, 16, 16, 2048, 1024), (8, 32, 32, 512, 512), (8, 32, 32, 1024, 512),
          (8, 32, 32, 1024, 1024), (8, 32, 32, 1536, 512), (8, 64, 64, 256, 256),
          (8, 64, 64, 256, 512), (8, 64, 64, 512, 512), (8, 64, 64, 768, 512),
          (8, 64, 64, 1024, 512), (8, 128, 128, 256, 256), (8, 128, 128, 512, 256),
          (8, 128, 128, 512, 512), (8, 128, 128, 768, 256), (8, 256, 256, 256, 256),
          (8, 256, 256, 512, 256)],
    "C-classifier": [(8, 8, 8, 512, 512), (8, 16, 16, 256, 256), (8, 16, 16, 256, 512),
                     (8, 16, 16, 512, 512), (8, 32, 32, 256, 256), (8, 64, 64, 128, 128),
                     (8, 64, 64, 128, 256), (8, 64, 64, 256, 256), (8, 128, 128, 128, 128),
                     (8, 256, 256, 128, 128)],
    "SD-1": [(2, 8, 8, 1280, 1280), (2, 8, 8, 2560, 1280), (2, 16, 16, 640, 1280),
             (2, 16, 16, 1280, 1280), (2, 16, 16, 1920, 1280), (2, 16, 16, 2560, 1280),
             (2, 32, 32, 320, 640), (2, 32, 32, 640, 640), (2, 32, 32, 960, 640),
             (2, 32, 32, 1280, 640), (2, 32, 32, 1280, 1280), (2, 32, 32, 1920, 640),
             (2, 64, 64, 320, 320), (2, 64, 64, 640, 320), (2, 64, 64, 640, 640),
             (2, 64, 64, 960, 320)],
}
# ragged maps, channel counts and patches past the batch
RAGGED = [(2, 8, 8, 32, 64), (3, 5, 7, 20, 9), (3, 5, 7, 24, 16), (1, 13, 19, 200, 136),
          (2, 4, 4, 64, 32), (1, 16, 16, 4, 3), (2, 3, 3, 8, 8), (1, 1, 1, 64, 64),
          (5, 2, 33, 16, 24)]
GROUPS = {**CONV_SHAPES, "ragged": RAGGED}
SHARED_MEMORY_PER_SM = 233472  # 228 KB on the H100, of which 1 KB a block is reserved


def _meta_forward(path: str):
    """(net, args) of one forward of `path` at its batch on the meta device."""
    meta = torch.device("meta")
    e = lambda *s: torch.empty(*s, device=meta)
    if path == "A":
        return DDPMUNet(DDPMUNetConfig.cifar10(), device=meta), (e(64, 32, 32, 3), e(64))
    if path == "D":
        return (NCSNpp(NCSNppConfig.cifar10_ddpmpp(deep=True), device=meta),
                (e(256, 32, 32, 3), e(256)))
    if path in ("B", "SD-1"):
        cfg, b, side, ctx = ((ADMConfig.sd_v2_1(), 8, 96, 1024) if path == "B"
                             else (ADMConfig.sd_v1(), 2, 64, 768))
        return ADMUNet(cfg, device=meta), (e(b, side, side, 4), e(b), None, e(b, 77, ctx))
    if path == "B-vae":
        return AutoencoderKL(VAEConfig.sd_v1(), device=meta).decoder, (e(4, 96, 96, 4),)
    gcfg = ADMConfig.imagenet256_guided()
    if path == "C":
        return ADMUNet(gcfg, device=meta), (e(8, 256, 256, 3), e(8),
                                           torch.zeros(8, dtype=torch.long, device=meta))
    ccfg = dataclasses.replace(gcfg, model_channels=128, num_res_blocks=2, out_channels=1000,
                               pool="attention", num_classes=None, resblock_updown=True,
                               use_scale_shift_norm=True)
    return ADMClassifier(ccfg, device=meta), (e(8, 256, 256, 3), e(8))


@pytest.mark.parametrize("path", sorted(CONV_SHAPES))
def test_conv_shapes_are_the_paths(path, monkeypatch):
    """The listed shapes are exactly the configs' Conv3x3 calls: each
    network's forward traced on the meta device through the plain twins."""
    monkeypatch.setattr(_build, "device_type", lambda t, what: "cpu")
    monkeypatch.setattr(transformer, "ln_linear", ops.ln_linear_plain)
    monkeypatch.setattr(transformer, "geglu_ff", ops.geglu_plain)
    net, args = _meta_forward(path)
    seen = Counter()
    hooks = [m.register_forward_pre_hook(
        lambda m, a: seen.update([(*a[0].shape, m.weight.shape[0])]))
        for m in net.modules() if isinstance(m, ops.Conv3x3)]
    with torch.no_grad():
        net(*args)
    for h in hooks:
        h.remove()
    assert sorted(seen) == CONV_SHAPES[path]


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_conv_route_follows_the_tma_rule(group):
    for b, h, w, c, co in GROUPS[group]:
        tma = c % 8 == 0 and co % 8 == 0
        plan = conv3x3_plan((b, h, w, c), co, torch.bfloat16)
        assert plan.route == ("wgmma" if tma else "wmma"), (b, h, w, c, co)
        assert (plan.patch != (0, 0, 0)) == tma
        assert conv3x3_plan((b, h, w, c), co, torch.bfloat16, aligned=False).route == "wmma"
        assert conv3x3_plan((b, h, w, c), co, torch.float32).route == "f32"


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_conv_patch_is_a_128_pixel_box(group):
    """The patch is one legal TMA box of 128 pixels (64 channels x w_t x h_t x
    b_t, powers of two, each box dim <= 256, at most 16 columns wide). On
    every path's map the patches tile it exactly, no block computing a pixel
    past it; on a ragged map the last patch of each dim reaches past the
    edge by less than a patch, and never more patches than the default
    16x8x1 box would take."""
    for b, h, w, _, _ in GROUPS[group]:
        pw, ph, pb = conv3x3_patch(b, h, w)
        assert pw * ph * pb == PATCH_PIXELS and max(pw, ph, pb) <= 256 and pw <= 16
        assert all(d & (d - 1) == 0 for d in (pw, ph, pb))
        tiles = -(-w // pw) * -(-h // ph) * -(-b // pb)
        assert tiles <= -(-w // 16) * -(-h // 8) * b
        if group == "ragged":
            assert tiles * PATCH_PIXELS >= b * h * w
        else:
            assert tiles * PATCH_PIXELS == b * h * w, (b, h, w, (pw, ph, pb))


@pytest.mark.parametrize("bhw,patch", [
    ((64, 32, 32), (16, 8, 1)), ((8, 96, 96), (16, 8, 1)), ((4, 768, 768), (16, 8, 1)),
    ((2, 8, 8), (8, 8, 2)), ((8, 24, 24), (8, 8, 2)), ((256, 4, 4), (4, 4, 8)),
    ((8, 12, 12), (4, 4, 8))], ids=str)
def test_conv_patch_of_each_map(bhw, patch):
    """The patches `conv3x3_patch` names: 16x8x1 where W >= 16 divides by
    16, 8x8x2 at 8x8 and 24x24, 4x4x8 at 4x4 and 12x12."""
    assert conv3x3_patch(*bhw) == patch


def test_conv_blocks_fit_two_to_an_sm():
    """The "wgmma" block's ring fits twice on an SM, so one block's epilogue
    overlaps the other's products."""
    assert 2 * (WGMMA_SMEM + 1024) <= SHARED_MEMORY_PER_SM
    assert WGMMA_BLOCK_N % 64 == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_attention_tile_fits(dh, dtype):
    tile = attention_plan(dh, dtype)
    assert isinstance(tile, AttentionTile) and tile.smem_bytes <= SMEM_PER_BLOCK
    if dtype == torch.float32:
        assert tile == AttentionTile("f32", 16, 32, dh, dh, 1)
        return
    assert tile.route == "wgmma"
    assert tile.block_q in (64, 128) and tile.block_kv % 16 == 0 and tile.stages >= 2
    # q/k staged in whole 64-column swizzle tiles; the pad is less than one
    assert tile.d_pad % 64 == 0 and 0 <= tile.d_pad - dh < 64
    # the output split: whole `wgmma` widths (multiples of 8, at most 256)
    assert dh % tile.dv == 0 and tile.dv % 8 == 0 and tile.dv <= 256


def test_attention_plan_refuses_other_head_dims():
    for dh in (16, 48, 96, 1024):
        with pytest.raises(ValueError, match="head dims"):
            attention_plan(dh)


@pytest.mark.parametrize("cfg,want", [("sd_v1", {40, 80, 160}), ("sd_v2_1", {64})])
def test_attention_head_dims_of_the_sd_unets_are_taken(cfg, want):
    """Every transformer site of the SD UNets has a head dim the kernel takes."""
    plan = layout(getattr(ADMConfig, cfg)())
    dims = {spec["dim_head"] for spec in chain(*plan["input_blocks"], plan["middle"],
                                               *plan["output_blocks"])
            if spec["kind"] == "xattn"}
    assert dims == want and dims <= set(HEAD_DIMS)
