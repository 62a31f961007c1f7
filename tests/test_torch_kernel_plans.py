"""The host-side plans of the TMA + wgmma kernels, held on the CPU.

Every shape decision of `csrc/conv3x3.cu`, `csrc/attention.cu`,
`csrc/geglu.cu` and `csrc/ln_linear.cu` is made in Python and handed to the
kernel: the conv route and its 128-pixel output patch
(`ops/conv3x3.py::conv3x3_plan`), the attention tile per head dim
(`ops/attention.py::attention_plan`), GEGLU's route, row tiles and split
(`ops/geglu.py::geglu_plan`) and LayerNorm->Linear's route, rows, ring and
column runs (`ops/ln_linear.py::ln_linear_plan`). The kernels run on the card
only, so these tests hold, on the CPU, what the plans promise:

- every conv shape of paths A-D, the SD VAE decoder and SD-1 (listed below,
  and checked against the configs by tracing them on the meta device), and
  ragged ones: the route follows the TMA rule (bf16 with C % 8 == 0 and
  CO % 8 == 0 takes "wgmma", the rest "narrow"), and a "wgmma" patch is 128 pixels, a legal
  TMA box, and tiles each path's map with no pixel past it (the kernel's
  decode of a patch, and its masks on a ragged edge, are held on the card
  by `chip_smoke.py`);
- every head dim: the tile fits the 227 KB a block may use, and its shapes
  are what `wgmma` and the 128-byte swizzle take; the attention backward's
  tiles (`ops/attention.py::attention_bwd_plan`, dq and dk/dv) at every
  head dim in both dtypes fit too, their registers fit the budget, their
  column slices cover the head once, and their grids at path C's and path
  E's sites cover every row tile; head dims no kernel takes are refused;
- every GEGLU and LayerNorm->Linear site of the SD-2.1 and SD-1 UNets
  (listed below, and checked against the configs on the meta device) takes
  "wgmma", its tiles cover M, N and K, its blocks fit their shared memory,
  and its grid covers the card's 132 SMs (GEGLU's down-projection by a
  split of its reduction where 64-row blocks fall short; LayerNorm->Linear
  wherever its 128-column tiles allow); ragged widths take "wmma";
- the fused attention with its out-projection
  (`ops/attention.py::attention_out_plan`): at every head dim and every H
  with H*dh <= 1280, in both dtypes, the tile is a compiled one and fits
  227 KB, and at the SD-2.1 and SD-1 sites the cluster splits the heads
  evenly and the grid covers the query tiles;
- the tiles the plans name are the ones the C sources compile.
"""

import dataclasses
import importlib
import re
from collections import Counter
from itertools import chain

import pytest
import torch

from dpm_solver_tpu_torch import ops
from dpm_solver_tpu_torch.models import (ADMClassifier, ADMConfig, ADMUNet, AutoencoderKL,
                                         DDPMUNet, DDPMUNetConfig, NCSNpp, NCSNppConfig,
                                         VAEConfig, layout, transformer)
from dpm_solver_tpu_torch.ops import _build
from dpm_solver_tpu_torch.ops.attention import (HEAD_DIMS, SMEM_PER_BLOCK, AttentionBwdTile,
                                                AttentionOutTile, AttentionTile,
                                                attention_bwd_plan, attention_out_plan,
                                                attention_plan)
from dpm_solver_tpu_torch.ops.conv3x3 import (PATCH_PIXELS, WGMMA_BLOCK_N, WGMMA_SMEM,
                                              conv3x3_patch, conv3x3_plan, f32_steps)
from dpm_solver_tpu_torch.ops import geglu as geglu_mod
from dpm_solver_tpu_torch.ops.geglu import geglu_plan
from dpm_solver_tpu_torch.ops.ln_linear import LnLinearPlan, ln_linear_plan

ln_linear_mod = importlib.import_module("dpm_solver_tpu_torch.ops.ln_linear")
attention_mod = importlib.import_module("dpm_solver_tpu_torch.ops.attention")
conv_mod = importlib.import_module("dpm_solver_tpu_torch.ops.conv3x3")

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
SMEM_PER_BLOCK = 232448        # what one block may use (227 KB)


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
        assert plan.route == ("wgmma" if tma else "narrow"), (b, h, w, c, co)
        assert (plan.patch != (0, 0, 0)) == tma
        assert conv3x3_plan((b, h, w, c), co, torch.bfloat16, aligned=False).route == "narrow"
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


# the "narrow" route's rule: every bf16 shape with C or CO % 8 != 0, or a
# tensor off a 16-byte boundary; C in {1, 3, 4, 5, 12} x CO in {3, 4, 6, 20,
# 512} as chip_smoke.py checks them, the VAE's ends, and C = CO = 64
NARROW_CIN = (1, 3, 4, 5, 12)
NARROW_COUT = (3, 4, 6, 20, 512)


@pytest.mark.parametrize("cin", NARROW_CIN + (128,))
def test_conv_narrow_route_takes_every_ragged_bf16_shape(cin):
    """C or CO % 8 != 0 (or unaligned) in bf16 takes "narrow", forward and
    dx, its tile fitted to the narrow side (kc 8 for C <= 8: one m16n8k8 a
    tap; nt 1 for CO <= 8: N padded to 8; else kc 64 beside nt 1, 32 beside
    nt 8); the rest keep "wgmma"; fp32
    keeps "f32" whatever the widths."""
    for co in NARROW_COUT + (64, 128):
        for dx in (False, True):
            plan = conv3x3_plan((2, 7, 9, cin), co, torch.bfloat16, dx=dx)
            want = "wgmma" if cin % 8 == 0 and co % 8 == 0 else "narrow"
            assert plan.route == want and plan.dx == dx, (cin, co, dx)
            if want == "narrow":
                assert plan.tile == ((8 if cin <= 8 else 64 if co <= 8 else 32),
                                     (1 if co <= 8 else 8))
            unaligned = conv3x3_plan((2, 7, 9, cin), co, torch.bfloat16, aligned=False, dx=dx)
            assert unaligned.route == "narrow"
            assert conv3x3_plan((2, 7, 9, cin), co, torch.float32, dx=dx).route == "f32"


@pytest.mark.parametrize("shape", [(4, 96, 96, 4, 512), (4, 768, 768, 128, 3),
                                   (2, 7, 9, 12, 20), (1, 16, 16, 4, 3), (3, 5, 7, 64, 64)],
                         ids=str)
def test_conv_narrow_tile_fits_and_covers_the_map(shape):
    """The "narrow" block's ring fits the 227 KB a block may use, and its
    units of 16 x 16 output patches cover the map, forward
    and dx, in units of a patch and a pass of 8 nt output channels; the
    VAE's ends take one pass over CO (conv_out's 3 -> 8) or one chunk of C
    (conv_in's 4 -> 8)."""
    b, h, w, c, co = shape
    for cin, cout, dx in ((c, co, False), (co, c, True)):
        plan = conv3x3_plan((b, h, w, cin), cout, torch.bfloat16, aligned=False, dx=dx)
        assert plan.route == "narrow" and plan.smem_bytes == conv_mod.narrow_smem(plan.tile)
        assert plan.smem_bytes <= SMEM_PER_BLOCK
        kc, nt = plan.tile
        units, passes = plan.grid((b, h, w, cin), cout)[0], -(-cout // (8 * nt))
        assert units % passes == 0 and passes * 8 * nt >= cout > (passes - 1) * 8 * nt
        patches = units // passes
        assert patches * conv_mod.NARROW_PATCH[0] * conv_mod.NARROW_PATCH[1] >= b * h * w
        assert patches == b * -(-h // 16) * -(-w // 16)
    assert conv3x3_plan((4, 96, 96, 4), 512, torch.bfloat16).tile == (8, 8)
    assert conv3x3_plan((4, 768, 768, 128), 3, torch.bfloat16).tile == (64, 1)


def test_conv_narrow_weight_layout():
    """`narrow_weight` lays the weight out as the kernel copies it:
    [9][npad][cpad], row (tap, n) holding w[tap][k][n] (forward) or the
    flipped w[8 - tap][n][k] (dx) over k < C, zero past C and CO, cpad a
    multiple of kc and npad of 8 nt (16-byte rows)."""
    g = torch.Generator().manual_seed(0)
    for c, co in ((4, 512), (128, 3), (5, 20), (12, 6)):
        w = torch.randn(3, 3, c, co, generator=g).to(torch.bfloat16)
        for dx in (False, True):
            cin, cout = (co, c) if dx else (c, co)
            kc, nt = conv_mod.narrow_tile(cin, cout)
            wp = conv_mod.narrow_weight(w, (kc, nt), dx)
            assert wp.is_contiguous() and wp.shape == (9, -(-cout // (8 * nt)) * 8 * nt,
                                                       -(-cin // kc) * kc)
            taps = w.reshape(9, c, co)
            want = taps.flip(0) if dx else taps.transpose(1, 2)
            assert torch.equal(wp[:, :cout, :cin], want)
            assert not wp[:, cout:].any() and not wp[:, :, cin:].any()


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
        # the fp32 backward's register-tiled rule: 16 queries, key tiles of
        # 256 / parts (one 4x4 patch a thread), two cp.async buffers
        parts = attention_mod._f32_parts(dh)
        assert tile == AttentionTile("f32", 16, 256 // parts, dh, dh, 2)
        assert parts * (16 // 4) * (tile.block_kv // 4) == 256 and dh / parts <= 40
        return
    assert tile.route == "wgmma"
    assert tile.block_q in (64, 128) and tile.block_kv % 16 == 0 and tile.stages >= 2
    # q/k staged in whole 64-column swizzle tiles; the pad is less than one
    assert tile.d_pad % 64 == 0 and 0 <= tile.d_pad - dh < 64
    # the output split: whole `wgmma` widths (multiples of 8, at most 256)
    assert dh % tile.dv == 0 and tile.dv % 8 == 0 and tile.dv <= 256


NEW_FWD_DIMS = [dh for dh in attention_mod.FWD_HEAD_DIMS if dh not in HEAD_DIMS]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("dh", NEW_FWD_DIMS)
def test_attention_forward_tile_at_the_wide_preset_head_dims(dh, dtype):
    """dh 96 and 192 (the ADM ImageNet presets) and cin256's single heads of
    384, 576 and 960: a tile that fits, whole 64-column output slices."""
    assert NEW_FWD_DIMS == [96, 192, 384, 576, 960]
    tile = attention_plan(dh, dtype)
    assert tile.smem_bytes <= SMEM_PER_BLOCK
    if dtype == torch.float32:
        parts = attention_mod._f32_parts(dh)
        # 16 parts at most (a 16-row tile, the softmax's 16 threads a row);
        # one K/V buffer only where two do not fit (dh 960)
        assert tile == AttentionTile("f32", 16, 256 // parts, dh, dh, 1 if dh == 960 else 2)
        assert parts <= 16 and dh % parts == 0
        return
    if dh <= 256:  # the tiles of dh 80 and 160
        assert (tile.block_q, tile.block_kv, tile.dv) == (128, 128 if dh < 160 else 64, dh)
        return
    # one warpgroup, WIDE_DV-column slices, the widest key tile that fits
    assert (tile.block_q, tile.dv, tile.stages) == (64, attention_mod.WIDE_DV, 2)
    assert dh % tile.dv == 0 and tile.dv % 64 == 0
    wider = dataclasses.replace(tile, block_kv=2 * tile.block_kv)
    assert tile.block_kv == 64 or wider.smem_bytes > SMEM_PER_BLOCK
    assert tile.grid(16, 1024, 1) == (16, 16, dh // attention_mod.WIDE_DV)


def test_cin256_attention_tiles():
    """cin256's transformer heads (dh 384 at 32x32, 576 at 16x16, 960 at 8x8;
    self-attention and S = 1 cross-attention share the tile): 64-, 32- and
    16-key tiles, 2, 3 and 5 output slices; fp32 16-key tiles."""
    got = {dh: attention_plan(dh) for dh in (384, 576, 960)}
    assert {dh: (t.block_kv, dh // t.dv) for dh, t in got.items()} == {
        384: (64, 2), 576: (32, 3), 960: (16, 5)}
    assert {attention_plan(dh, torch.float32).block_kv for dh in got} == {16}


def test_attention_plan_refuses_other_head_dims():
    for dh in (16, 48, 88, 1024):  # 96 is a preset's head dim since the forward took them all
        with pytest.raises(ValueError, match="head dims"):
            attention_plan(dh)


BWD_CASES = [(dh, dt) for dt in (torch.bfloat16, torch.float32)
             for dh in attention_mod.FWD_HEAD_DIMS]
BWD_IDS = [f"{dh}-{str(dt)[6:]}" for dh, dt in BWD_CASES]
# (b, t, s, heads, dh): path C's classifier attentions (32x32, 16x16, 8x8
# and the attention pool, bf16 dh 64) and path E's single head (b8, 16x16,
# fp32 dh 256)
BWD_SITES = {"C": [(8, 1024, 1024, 4, 64), (8, 256, 256, 8, 64), (8, 64, 64, 8, 64),
                   (8, 65, 65, 8, 64)],
             "E": [(8, 256, 256, 1, 256)]}


@pytest.mark.parametrize("dh,dtype", BWD_CASES, ids=BWD_IDS)
def test_attention_bwd_tile_fits(dh, dtype):
    """Both dtypes take every head dim of the forward; bf16 runs "wgmma"
    with 64 owned rows (one consumer warpgroup) and streamed tiles that are
    whole `wgmma` widths, fp32 "f32" with 16 owned rows; each tile fits a
    block, and dk/dv keeps both outputs in one block exactly where their
    sums fit the register budget beside a 32-row tile."""
    tile = attention_bwd_plan(dh, dtype)
    assert isinstance(tile, AttentionBwdTile)
    for kt in (tile.dq, tile.dkv):
        assert kt.smem_bytes <= SMEM_PER_BLOCK and kt.dh == dh
        if dtype == torch.float32:
            # two cp.async buffers but at dh 960, where one fits
            assert (kt.route, kt.rows, kt.cols) == ("f32", 16, dh)
            assert kt.stages == (1 if dh == 960 else 2)
            # 256 threads: (16 / 4) x (tile / 4) patches x slices of <= 40 columns
            parts = 256 // kt.tile
            assert parts >= 2 and dh % parts == 0 and dh / parts <= 40
            assert parts == 2 or dh / (parts // 2) > 40
            continue
        assert (kt.route, kt.rows) == ("wgmma", 64) and kt.tile in (16, 32, 64)
        assert kt.cols % 8 == 0 and kt.cols <= 256
        # the owned-operand ring (2 or 3 stages) but at dh 960 (chunked, 4)
        assert (kt.chunked, kt.stages) == (True, 4) if dh == 960 else kt.stages in (2, 3)
    if dtype == torch.bfloat16:
        assert tile.dkv.outs == (2 if dh <= 128 else 1) and tile.dq.outs == 1


@pytest.mark.parametrize("dh,dtype", BWD_CASES, ids=BWD_IDS)
def test_attention_bwd_tile_budget_columns_and_grid(dh, dtype):
    """At each head dim and dtype, for dq and dk/dv: the block's shared
    memory fits, its fp32 registers (output sums, logits, fragments) fit the
    plan's budget, its output column slices cover [0, dh) exactly once, and
    its grid at path C's and path E's sites has a block for every owned row
    tile, head and (slice, pass); path E's fp32 site fills 128 of the 132 SMs."""
    tile = attention_bwd_plan(dh, dtype)
    for kt in (tile.dq, tile.dkv):
        assert kt.smem_bytes <= SMEM_PER_BLOCK
        assert kt.regs <= kt.reg_budget
        covered = [c for lo, hi in kt.col_slices() for c in range(lo, hi)]
        assert sorted(covered) == list(range(dh))
        assert kt.passes * kt.outs == (2 if kt.kernel == "dkv" else 1)
        for b, t, s, heads, _ in BWD_SITES["C"] + BWD_SITES["E"]:
            owned = s if kt.kernel == "dkv" else t
            grid = kt.grid(b, t, s, heads)
            assert grid == (-(-owned // kt.rows), b * heads, kt.slices * kt.passes)
            assert (grid[0] - 1) * kt.rows < owned <= grid[0] * kt.rows
    if dh == 64 and dtype == torch.bfloat16:  # path C: 4 key tiles x 64 heads at 16x16
        assert tile.dq.grid(8, 256, 256, 8) == tile.dkv.grid(8, 256, 256, 8) == (4, 64, 1)
    if dh == 256 and dtype == torch.float32:  # path E
        assert tile.dq.grid(8, 256, 256, 1) == tile.dkv.grid(8, 256, 256, 1) == (16, 8, 1)


def test_attention_bwd_plan_takes_bf16_512_and_refuses_other_head_dims():
    """bf16 dh 512 is taken: 16-row tiles, two 256-column slices, dk and dv
    in separate blocks, within 227 KB; a head dim no kernel takes is refused
    by name, in either dtype."""
    tile = attention_bwd_plan(512, torch.bfloat16)
    assert tile.route == "wgmma" and tile.dq.tile == tile.dkv.tile == 16
    assert tile.dq.col_slices() == [(0, 256), (256, 512)] and tile.dkv.passes == 2
    assert tile.dq.grid(1, 1024, 1024, 1) == (16, 1, 2)
    assert tile.dkv.grid(1, 1024, 1024, 1) == (16, 1, 4)
    assert max(tile.dq.smem_bytes, tile.dkv.smem_bytes) <= SMEM_PER_BLOCK
    assert attention_bwd_plan(512, torch.float32).dq.smem_bytes == 200192
    for dh in (16, 48, 88, 1024):  # 96: a preset's head dim since the backward took them all
        for dtype in (torch.float32, torch.bfloat16):
            with pytest.raises(ValueError, match="head dims"):
                attention_bwd_plan(dh, dtype)


# cin256's single heads at train_latent's b8 (32x32 at 384, 16x16 at 576,
# 8x8 at 960; self-attention and the one-key cross-attention), the ADM
# ImageNet-64 and -128 heads
WIDE_BWD_SITES = [(8, 1024, 1024, 1, 384), (8, 1024, 1, 1, 384), (8, 256, 256, 1, 576),
                  (8, 256, 1, 1, 576), (8, 64, 64, 1, 960), (8, 64, 1, 1, 960),
                  (8, 256, 256, 4, 96), (8, 256, 256, 4, 192)]


@pytest.mark.parametrize("site", WIDE_BWD_SITES, ids=str)
def test_attention_bwd_plan_at_the_wide_heads(site):
    """The new head dims: bf16 slices 384, 576 and 960 into WIDE_DV-column
    output blocks (dk and dv a block each); 576 keeps its two owned 64-row
    operands beside two 16-row stages (222,248 bytes of 232,448); 960 streams
    them in 64-column chunks through a 4-stage ring; fp32 960 takes 8-row
    tiles (32 slices a patch), one buffer, dk and dv a block each; 96 and 192
    run on the tiles of whole 64-column runs (128, 192) as 80 and 160 do."""
    b, t, s, heads, dh = site
    bf, f32 = attention_bwd_plan(dh, torch.bfloat16), attention_bwd_plan(dh, torch.float32)
    for kt in (bf.dq, bf.dkv, f32.dq, f32.dkv):
        assert kt.smem_bytes <= SMEM_PER_BLOCK and kt.regs <= kt.reg_budget
        owned = s if kt.kernel == "dkv" else t
        assert kt.grid(b, t, s, heads) == (-(-owned // kt.rows), b * heads,
                                           kt.slices * kt.passes)
    if dh > 256:
        assert bf.dq.col_slices() == [(i, i + 192) for i in range(0, dh, 192)]
        assert bf.dkv.outs == 1 and bf.dkv.passes == 2
    if dh == 576:
        assert (bf.dq.tile, bf.dq.stages, bf.dq.smem_bytes) == (16, 2, 222248)
    if dh == 960:
        assert bf.dq.chunked and bf.dkv.chunked and bf.dq.tile == 32
        assert bf.dq.smem_bytes == 1024 + 4 * 2 * (64 + 32) * 128 + 8 * 9
        assert (f32.dq.tile, f32.dq.stages, f32.dkv.outs) == (8, 1, 1)
        assert f32.dq.smem_bytes == 186048
    if dh in (96, 192):
        assert bf.dq.cols == dh and not bf.dq.chunked


@pytest.mark.parametrize("cfg,want", [("sd_v1", {40, 80, 160}), ("sd_v2_1", {64})])
def test_attention_head_dims_of_the_sd_unets_are_taken(cfg, want):
    """Every transformer site of the SD UNets has a head dim the kernel takes."""
    plan = layout(getattr(ADMConfig, cfg)())
    dims = {spec["dim_head"] for spec in chain(*plan["input_blocks"], plan["middle"],
                                               *plan["output_blocks"])
            if spec["kind"] == "xattn"}
    assert dims == want and dims <= set(HEAD_DIMS)


# (M, d) of every transformer site of one UNet forward: M = batch x tokens
# (SD-2.1 at 96x96 latents, CFG b8; SD-1 at 64x64, CFG b2), d the width. A
# site runs LayerNorm->Linear at n = 3d (norm1 -> qkv) and n = d (norm2 ->
# to_q), and GEGLU at inner = 4d.
SD_SITES = {"B": [(73728, 320), (18432, 640), (4608, 1280), (1152, 1280)],
            "SD-1": [(8192, 320), (2048, 640), (512, 1280), (128, 1280)]}
SITES = [(path, m, d) for path, sites in SD_SITES.items() for m, d in sites]
SMS = 132
RAGGED_FF = [(1000, 36, 144), (300, 36, 100), (77, 40, 100), (64, 12, 48)]


@pytest.mark.parametrize("path", sorted(SD_SITES))
def test_sd_sites_are_the_configs(path, monkeypatch):
    """The listed sites are exactly the UNets' ln_linear and geglu_ff calls:
    each network's forward traced on the meta device through the plain twins."""
    seen = Counter()

    def ln(x, gamma, beta, w, bias=None, *, eps=1e-5):
        seen["ln_linear", x.shape[0] * x.shape[1], x.shape[-1], w.shape[0]] += 1
        return ops.ln_linear_plain(x, gamma, beta, w, bias, eps=eps)

    def ff(x, w1, b1, w2, b2):
        seen["geglu_ff", x.shape[0] * x.shape[1], x.shape[-1], w2.shape[1]] += 1
        return ops.geglu_plain(x, w1, b1, w2, b2)

    monkeypatch.setattr(_build, "device_type", lambda t, what: "cpu")
    monkeypatch.setattr(transformer, "ln_linear", ln)
    monkeypatch.setattr(transformer, "geglu_ff", ff)
    net, args = _meta_forward(path)
    with torch.no_grad():
        net(*args)
    want = set()
    for m, d in SD_SITES[path]:
        want |= {("ln_linear", m, d, 3 * d), ("ln_linear", m, d, d), ("geglu_ff", m, d, 4 * d)}
    assert set(seen) == want


@pytest.mark.parametrize("path,m,d", SITES, ids=[f"{p}-{m}x{d}" for p, m, d in SITES])
def test_geglu_plan_at_the_sd_sites(path, m, d):
    inner = 4 * d
    plan = geglu_plan(m, d, inner, torch.bfloat16)
    assert plan.route == "wgmma" and plan.gate_rows in (64, 128) and plan.down_rows in (64, 128)
    # tiles cover M and the columns; the split covers K, no split empty
    assert plan.gate_blocks(m, inner) * plan.gate_rows * geglu_mod.GATE_COLS >= m * inner
    chunks = -(-inner // 64)
    per = -(-chunks // plan.splits)
    assert plan.splits * per >= chunks and (plan.splits - 1) * per < chunks
    assert plan.splits == 1 or chunks // plan.splits >= 4
    # shared memory: the gate block fits twice on an SM, the down block once
    assert 2 * (geglu_mod.gate_smem(plan.gate_rows) + 1024) <= SHARED_MEMORY_PER_SM
    assert geglu_mod.down_smem(plan.down_rows) <= SMEM_PER_BLOCK
    # the grid covers the card: the gate kernel runs two blocks an SM
    assert plan.gate_blocks(m, inner) >= 2 * SMS or plan.gate_rows == 64
    assert plan.gate_blocks(m, inner) >= SMS
    assert plan.down_blocks(m, d) >= SMS
    small = -(-m // 128) * -(-d // geglu_mod.DOWN_COLS) < SMS
    assert (plan.down_rows == 64 or plan.splits > 1) == small


@pytest.mark.parametrize("n_of_d", [3, 1], ids=["qkv", "to_q"])
@pytest.mark.parametrize("path,m,d", SITES, ids=[f"{p}-{m}x{d}" for p, m, d in SITES])
def test_ln_linear_plan_at_the_sd_sites(path, m, d, n_of_d):
    n = n_of_d * d
    plan = ln_linear_plan(m, d, n, torch.bfloat16)
    assert plan.route == "wgmma" and plan.rows in (64, 128) and plan.stages >= 2
    assert plan.rows == 64 or d <= 640
    smem = ln_linear_mod.wgmma_smem(plan.rows, d, plan.stages)
    assert smem <= SMEM_PER_BLOCK
    # the resident row tile covers d; the runs cover the column tiles
    col_tiles = -(-n // ln_linear_mod.BLOCK_N)
    runs = -(-col_tiles // plan.run)
    assert 1 <= plan.run <= col_tiles and runs * plan.run >= col_tiles
    assert (runs - 1) * plan.run < col_tiles
    assert plan.blocks(m, n) == -(-m // plan.rows) * runs
    # the grid covers the card wherever 64-row blocks of one column tile can
    assert plan.blocks(m, n) >= min(SMS, -(-m // 64) * col_tiles)


@pytest.mark.parametrize("m,d,inner", RAGGED_FF, ids=str)
def test_ragged_widths_take_wmma(m, d, inner):
    """TMA strides rows in 16-byte steps: d, inner or n not a multiple of 8,
    or a tensor off a 16-byte boundary, takes the WMMA ("wmma") kernels; fp32
    takes "f32"."""
    tma = d % 8 == 0 and inner % 8 == 0
    assert geglu_plan(m, d, inner, torch.bfloat16).route == ("wgmma" if tma else "wmma")
    assert ln_linear_plan(m, d, inner, torch.bfloat16).route == ("wgmma" if tma else "wmma")
    assert geglu_plan(m, d, inner, torch.float32).route == "f32"
    assert ln_linear_plan(m, d, inner, torch.float32).route == "f32"
    assert geglu_plan(m, 320, 1280, torch.bfloat16, aligned=False).route == "wmma"
    assert ln_linear_plan(m, 320, 960, torch.bfloat16, aligned=False).route == "wmma"


def test_ln_linear_row_tile_past_the_budget_takes_wmma():
    """64 rows of width d fit beside two W stages up to d = 1,536; past that
    the row tile was left to "wmma" (which takes d <= 1,536 too, so such a
    width raised on the card) and is now kept in segments on "wgmma"."""
    resident = ln_linear_plan(4096, 1536, 1536, torch.bfloat16)
    assert resident.route == "wgmma" and resident.seg == 0
    past = ln_linear_plan(4096, 1600, 1600, torch.bfloat16)
    assert past.route == "wgmma" and past.seg == 13 and past.rows == 64


@pytest.mark.parametrize("d", [1600, 1792, 2560, 3584])
def test_ln_linear_segments_fit_and_cover_the_row(d):
    """Past the resident budget: 64 rows, a 4-stage ring, and the fewest
    segments of equal width (64-column tiles) that fit 227 KB beside it."""
    plan = ln_linear_plan(72, d, 3 * d, torch.bfloat16)
    kch = -(-d // 64)
    assert (plan.route, plan.rows, plan.stages) == ("wgmma", 64, ln_linear_mod.MAX_STAGES)
    assert 0 < plan.seg < kch
    assert ln_linear_mod.wgmma_seg_smem(64, plan.seg, plan.stages) <= SMEM_PER_BLOCK
    nseg = -(-kch // plan.seg)
    wider = ln_linear_mod.wgmma_seg_smem(64, -(-kch // (nseg - 1)), plan.stages)
    assert nseg == 1 or wider > SMEM_PER_BLOCK      # no fewer segments fit
    assert plan.seg * (nseg - 1) < kch <= plan.seg * nseg


@pytest.mark.parametrize("preset", ["cin256", "rdm_768", "sd_v1", "sd_v2_1"])
def test_ln_linear_and_geglu_take_wgmma_at_every_transformer_width(preset):
    """Every SpatialTransformer width of the LDM presets (cin256's 384, 576
    and 960; the retrieval LDM's 448 to 1,792) runs the "wgmma" kernels in
    bf16 and "f32" in fp32; none raises."""
    cfg = getattr(ADMConfig, preset)()
    plan, ch, widths = layout(cfg), None, set()
    for spec in chain(*plan["input_blocks"], plan["middle"], *plan["output_blocks"]):
        ch = spec.get("out_ch", ch)
        if spec["kind"] == "xattn":
            widths.add(spec["heads"] * spec["dim_head"])
    assert widths
    for d in sorted(widths):
        for n in (3 * d, d):
            assert ln_linear_plan(8 * 36, d, n, torch.bfloat16).route == "wgmma"
            assert ln_linear_plan(8 * 36, d, n, torch.float32).route == "f32"
            x2, w = torch.zeros(8, d), torch.zeros(n, d)
            ln_linear_mod._check(x2, torch.zeros(d), torch.zeros(d), w, None,
                                 ln_linear_plan(8, d, n, torch.float32))
        assert geglu_mod.geglu_plan(8 * 36, d, 4 * d, torch.bfloat16).route == "wgmma"


def test_ln_linear_checks_take_each_routes_widths():
    """"f32" keeps 16 fp32 rows (d <= 3,632), "wmma" 64 bf16 rows (d <= 1,536)."""
    x, g = torch.zeros(2, 1792), torch.zeros(1792)
    ln_linear_mod._check(x, g, g, torch.zeros(8, 1792), None, LnLinearPlan("f32"))
    with pytest.raises(ValueError, match="wmma kernel takes d <= 1536"):
        ln_linear_mod._check(x.bfloat16(), g, g, torch.zeros(8, 1792).bfloat16(), None,
                             LnLinearPlan("wmma"))
    big, gb = torch.zeros(2, 3640), torch.zeros(3640)
    with pytest.raises(ValueError, match="f32 kernel takes d <= 3632"):
        ln_linear_mod._check(big, gb, gb, torch.zeros(8, 3640), None, LnLinearPlan("f32"))


def _cu_constant(source: str, name: str) -> int:
    """A constant of `source` or of the local headers it includes."""
    text = (_build.CSRC / source).read_text()
    for header in re.findall(r'#include "([^"]+)"', text):
        text += (_build.CSRC / header).read_text()
    found = re.search(rf"constexpr (?:int|uint32_t|size_t) {name} = ([0-9]+);", text)
    assert found, f"{name} in {source}"
    return int(found.group(1))


@pytest.mark.parametrize("source,name,value", [
    ("geglu.cu", "GATE_COLS", geglu_mod.GATE_COLS),
    ("geglu.cu", "GATE_STAGES", geglu_mod.GATE_STAGES),
    ("geglu.cu", "DOWN_COLS", geglu_mod.DOWN_COLS),
    ("geglu.cu", "DOWN_STAGES", geglu_mod.DOWN_STAGES),
    ("ln_linear.cu", "LN_BN", ln_linear_mod.BLOCK_N),
    ("ln_linear.cu", "LN_SMEM_MAX", ln_linear_mod.SMEM_PER_BLOCK),
    ("attention_bwd.cu", "SMEM_LIMIT", SMEM_PER_BLOCK),
    ("attention_bwd.cu", "SM_SMEM", attention_mod.SM_SMEM),
    ("attention_bwd.cu", "BF16_ROWS", attention_bwd_plan(64).dq.rows),
    ("attention_bwd.cu", "BF16_THREADS", attention_mod.BF16_THREADS),
    ("attention_bwd.cu", "BF16_MAX_COLS", attention_bwd_plan(512).dq.cols),
    ("attention_bwd.cu", "BF16_REG_BUDGET", attention_bwd_plan(64).dq.reg_budget),
    ("attention_bwd.cu", "BF16_MAX_STAGES", attention_mod.BF16_MAX_STAGES),
    ("attention_bwd.cu", "BF16_BLOCKS_PER_SM", attention_mod.BF16_BLOCKS_PER_SM),
    ("attention_bwd.cu", "F32_ROWS", attention_bwd_plan(64, torch.float32).dq.rows),
    ("attention_bwd.cu", "F32_SLICE", attention_mod.F32_SLICE),
    ("attention_bwd.cu", "F32_THREADS", attention_mod.F32_THREADS),
    ("attention_bwd.cu", "F32_REG_BUDGET", attention_bwd_plan(64, torch.float32).dq.reg_budget),
    ("attention_bwd.cu", "WIDE_DV", attention_bwd_plan(960).dq.cols),
    ("attention_bwd.cu", "BF16_CHUNK_STAGES", attention_bwd_plan(960).dq.stages),
    ("attention.cu", "F32_ROWS", attention_plan(256, torch.float32).block_q),
    ("attention.cu", "F32_THREADS", attention_mod.F32_THREADS),
    ("attention.cu", "F32_SLICE", attention_mod.F32_SLICE),
    ("attention.cu", "F32_STAGES", attention_plan(256, torch.float32).stages),
    ("attention.cu", "WIDE_DV", attention_plan(960).dv),
    ("conv3x3.cu", "F32_BM", conv_mod.F32_BLOCK_M),
    ("conv3x3.cu", "F32_BN", conv_mod.F32_BLOCK_N),
    ("conv3x3.cu", "F32_BK", conv_mod.F32_BLOCK_K),
    ("conv3x3.cu", "F32_STAGES", conv_mod.F32_STAGES),
    ("conv3x3.cu", "F32_THREADS", conv_mod.F32_THREADS),
    ("conv3x3.cu", "NR_THREADS", conv_mod.NARROW_THREADS),
    ("conv3x3.cu", "NR_PH", conv_mod.NARROW_PATCH[0]),
    ("conv3x3.cu", "NR_PW", conv_mod.NARROW_PATCH[1]),
    ("conv3x3.cu", "NR_STAGES", conv_mod.NARROW_STAGES),
    ("attention_out.cu", "MAX_INNER", attention_mod.OUT_MAX_INNER),
    ("attention_out.cu", "MAX_C", attention_mod.OUT_MAX_C),
    ("attention_out.cu", "OUT_NCH", attention_mod.OUT_N_CHUNK),
    ("attention_out.cu", "OUT_SMEM_LIMIT", SMEM_PER_BLOCK),
    ("attention_out.cu", "MAX_CLUSTER", attention_mod.OUT_MAX_CLUSTER),
    ("attention_out.cu", "F32_ROWS", attention_out_plan(64, 64, 8, torch.float32).rows),
    ("attention_out.cu", "F32_THREADS", attention_out_plan(64, 64, 8, torch.float32).n_chunk)],
    ids=lambda v: str(v))
def test_plans_name_the_compiled_tiles(source, name, value):
    """The plans' tile constants are the C sources' (the entries refuse others)."""
    assert _cu_constant(source, name) == value


# path E's conv3x3 calls, (B, H, W, C, CO) of one DDPM++ deep forward at b8
# (path D's list at b8); each also runs its dx, the kernel's dx mode on the
# cotangent (B, H, W, CO) -> C channels
PATH_E_CONVS = [(8, h, w, c, co) for _, h, w, c, co in CONV_SHAPES["D"]]
F32_RAGGED = [(2, 4, 4, 3, 128), (1, 16, 16, 4, 3), (3, 5, 7, 20, 9), (1, 1, 1, 64, 64),
              (2, 768, 768, 128, 3), (8, 256, 256, 256, 256)]


def _f32_plans(b, h, w, c, co):
    """The forward's and the input gradient's "f32" plans, with their
    (input channels, output channels)."""
    return [(conv3x3_plan((b, h, w, c), co, torch.float32), c, co),
            (conv3x3_plan((b, h, w, co), c, torch.float32, dx=True), co, c)]


@pytest.mark.parametrize("shape", PATH_E_CONVS + F32_RAGGED, ids=str)
def test_conv_f32_plan_splits_small_grids(shape):
    """At each of path E's conv sites (forward and dx) and at ragged ones:
    the block's ring fits its shared memory; the split cuts the 9 *
    ceil(C / 16) steps into non-empty contiguous ranges that cover them
    once; and the kernel running one block an SM, every wave of tiles x
    split blocks keeps 90% of the 132 SMs busy (where the unsplit grid is
    under a wave, that is 119-132 blocks), with the least split that does
    (or one range a step)."""
    b, h, w, _, _ = shape
    for plan, cin, cout in _f32_plans(*shape):
        assert plan.route == "f32" and plan.smem_bytes <= SMEM_PER_BLOCK
        ranges = plan.ranges(cin)
        assert ranges[0][0] == 0 and ranges[-1][1] == f32_steps(cin)
        assert all(lo < hi for lo, hi in ranges)
        assert all(a[1] == b_[0] for a, b_ in zip(ranges, ranges[1:]))
        gm, gn, gz = plan.grid((b, h, w, cin), cout)
        assert gz == plan.split and gm * 128 >= b * h * w and gn * 128 >= cout
        blocks, waves = gm * gn * plan.split, -(-gm * gn * plan.split // 132)
        assert blocks >= 0.9 * 132 * waves or plan.split == f32_steps(cin)
        if gm * gn < 132 and plan.split < f32_steps(cin):
            assert blocks >= 0.9 * 132
        least = max(1, 132 // (gm * gn))
        assert plan.split == least or (plan.split - 1) * gm * gn < 0.9 * 132 * -(
            -(plan.split - 1) * gm * gn // 132)


def test_conv_f32_plan_at_path_e_small_maps():
    """The splits path E's maps take at b8 (one block an SM): 2 tiles of
    128 x 128 at 4x4 -> 132 blocks, 8 at 8x8 -> 128 (not the 136 of 17
    ranges, whose 4 blocks past the wave nearly double the launch), 32 at
    16x16 -> 128, 64 at 32x32 -> 128; 128 tiles stay whole."""
    assert conv3x3_plan((8, 4, 4, 256), 256, torch.float32).split == 66
    assert conv3x3_plan((8, 8, 8, 512), 256, torch.float32).split == 16
    assert conv3x3_plan((8, 16, 16, 256), 256, torch.float32).split == 4
    assert conv3x3_plan((8, 32, 32, 128), 128, torch.float32).split == 2
    assert conv3x3_plan((8, 32, 32, 256), 256, torch.float32).split == 1
    assert conv3x3_plan((64, 32, 32, 128), 128, torch.float32).split == 1


# path E's attention sites (b, t, heads, dh), and the blocks each launch runs
ATTN_E_SITES = [((8, 256, 1, 256), 128), ((8, 16, 1, 256), 32)]


@pytest.mark.parametrize("site,blocks", ATTN_E_SITES, ids=str)
def test_attention_f32_grid_at_path_e(site, blocks):
    """The fp32 forward keeps 128 blocks at the 16x16 site (16 queries a
    block) and splits the 4x4 mid-block's 8 row blocks over 4 column
    slices of 64: every slice a whole 64-column run of the head."""
    b, t, heads, dh = site
    tile = attention_plan(dh, torch.float32)
    gx, gy, gz = tile.grid(b, t, heads)
    assert gx * gy * gz == blocks and gx * tile.block_q >= t and gy == b * heads
    dv = tile.launch_dv(b, t, heads)
    assert dv * gz == dh and (dv == dh or dv % 64 == 0)


# ---- attention -> out-projection -> residual (csrc/attention_out.cu) ---------

OUT_CASES = [(dh, heads, dt) for dt in (torch.bfloat16, torch.float32) for dh in HEAD_DIMS
             for heads in range(1, attention_mod.OUT_MAX_INNER // dh + 1)]


def _compiled_out_tiles() -> set:
    """(dh, rows, keys a tile, stages) of every OUT_TILE the C source compiles."""
    text = (_build.CSRC / "attention_out.cu").read_text()
    return {tuple(map(int, m)) for m in
            re.findall(r"OUT_TILE\((\d+), (\d+), (\d+), (\d+)\)", text)}


def test_out_tile_list_is_the_compiled_one():
    """OUT_TILES names exactly the bf16 instances csrc/attention_out.cu
    compiles, in the order the C source lists them."""
    text = (_build.CSRC / "attention_out.cu").read_text()
    listed = [tuple(map(int, m)) for m in
              re.findall(r"OUT_TILE\((\d+), (\d+), (\d+), (\d+)\)", text)]
    assert listed == [(dh, *tile) for dh in HEAD_DIMS for tile in attention_mod.OUT_TILES[dh]]


@pytest.mark.parametrize("dh,heads,dtype", OUT_CASES,
                         ids=[f"{dh}x{h}-{str(dt)[6:]}" for dh, h, dt in OUT_CASES])
def test_out_tile_fits_every_width(dh, heads, dtype):
    """At every head dim and every H with H*dh <= 1280 the plan's tile is a
    compiled one and fits 227 KB: bf16 on "wgmma" (64-row warpgroups, a
    ring stage that also holds w_rows x 128 of w_out), fp32 on "f32"."""
    inner = heads * dh
    tile = attention_out_plan(dh, inner, 1280, dtype)
    assert isinstance(tile, AttentionOutTile) and tile.smem_bytes <= SMEM_PER_BLOCK
    assert (tile.dh, tile.inner, tile.cluster) == (dh, inner, 1)
    if dtype == torch.float32:
        parts = attention_mod._f32_parts(dh)
        assert tile.route == "f32" and tile.rows == 16 and tile.block_kv == 256 // parts
        assert tile.stages in (1, 2) and tile.n_chunk == 256 and tile.w_rows == 0
        return
    assert tile.route == "wgmma" and (dh, tile.rows, tile.block_kv, tile.stages) in \
        _compiled_out_tiles()
    assert tile.rows % 64 == 0 and tile.block_kv % 16 == 0 and tile.n_chunk == 128
    # a w_out stage: whole 16-deep steps, a legal TMA box, inside a K/V stage
    stage = 128 * tile.block_kv * (-(-dh // 64) + -(-min(dh, 256) // 64))
    assert tile.w_rows % 16 == 0 and 16 <= tile.w_rows <= 256
    assert tile.w_rows * tile.n_chunk * 2 <= stage
    # the first compiled tile that fits: no earlier one would
    first = attention_mod.OUT_TILES[dh].index((tile.rows, tile.block_kv, tile.stages))
    for rows, kv, stages in attention_mod.OUT_TILES[dh][:first]:
        wider = dataclasses.replace(tile, rows=rows, block_kv=kv, stages=stages)
        assert wider.smem_bytes > SMEM_PER_BLOCK


def test_out_f32_buffers_are_the_compiled_ones():
    """Two cp.async buffers where they fit beside the head dim's widest
    concat buffer, else one: the instances the card's build compiles
    (`attention_out_f32<D, NBUF>`)."""
    got = {dh: attention_out_plan(dh, dh, 8, torch.float32).stages for dh in HEAD_DIMS}
    assert got == {32: 2, 40: 2, 64: 2, 80: 1, 128: 2, 160: 1, 256: 1, 512: 2}


# the fused kernel's SD sites (b, t, s, heads, dh, c): SD-2.1 768 px at CFG
# b8 (96x96, 48x48, 24x24, 12x12), SD-1 512 px at CFG b2 (64x64 ... 8x8 and
# a cross-attention), the VAE's 512-wide head, DDPM's 256-wide head at b64
OUT_SITES = [(8, 9216, 9216, 5, 64, 320), (8, 2304, 2304, 10, 64, 640),
             (8, 576, 576, 20, 64, 1280), (8, 144, 144, 20, 64, 1280),
             (2, 4096, 4096, 8, 40, 320), (2, 1024, 1024, 8, 80, 640),
             (2, 256, 256, 8, 160, 1280), (2, 64, 64, 8, 160, 1280),
             (2, 4096, 77, 8, 40, 320), (1, 9216, 9216, 1, 512, 512),
             (64, 256, 256, 1, 256, 256)]


@pytest.mark.parametrize("site", OUT_SITES, ids=str)
def test_out_plan_splits_heads_over_a_cluster(site):
    """With the launch's b, t and s the plan picks a tile that fits and a
    cluster of 1, 2, 4 or 8 CTAs that divides H; its grid covers every
    query tile of every batch element, and no CTA of a cluster is left
    without heads."""
    b, t, s, heads, dh, c = site
    tile = attention_out_plan(dh, heads * dh, c, torch.bfloat16, b, t, s)
    assert tile.smem_bytes <= SMEM_PER_BLOCK and tile.cluster in (1, 2, 4, 8)
    assert heads % tile.cluster == 0
    gx, gy = tile.grid(b, t)
    assert gy == b and gx % tile.cluster == 0 and gx // tile.cluster * tile.rows >= t
    est = attention_mod._out_estimate(tile, b, t, s, c)
    for other in (dataclasses.replace(tile, cluster=n) for n in (1, 2, 4, 8)
                  if heads % n == 0):
        assert est <= attention_mod._out_estimate(other, b, t, s, c)


def test_out_plan_at_the_sd_sites():
    """The picks the timings behind the estimate's constants made: 192 rows
    at SD-2.1's 96x96 site (384 CTAs, one cluster each), 128 rows in pairs at
    48x48, 64-row clusters of 4 at the 1280-wide levels, 8 at SD-1's 16x16."""
    pick = lambda site: (lambda p: (p.rows, p.cluster))(attention_out_plan(
        site[4], site[3] * site[4], site[5], torch.bfloat16, *site[:3]))
    assert [pick(site) for site in OUT_SITES[:4]] == [(192, 1), (128, 2), (64, 4), (64, 4)]
    assert pick(OUT_SITES[6]) == (64, 8)
