"""Flax parameters -> the port's torch state dicts, and the checkpoint reader.

`load_torch_state_dict` reads a reference torch checkpoint file (a plain
state dict, a `{"state_dict": ...}` wrapper, or the DDPM runner's list with
its EMA shadow last) into one flat {name: tensor} dict, as
`dpm_solver_tpu/utils/convert.py::load_torch_state_dict` does into numpy;
the port's models take its keys directly (no Flax in between).

The inverses of the JAX package's torch -> Flax converters, so weights made
by the JAX package (random inits in tests, or converted checkpoints) load
into the port's models with a plain `load_state_dict`:

- `ddpm_unet_state_dict_from_flax`: of `dpm_solver_tpu/utils/convert.py::
  convert_ddpm_unet`, for `models.DDPMUNet`;
- `adm_unet_state_dict_from_flax`: of `convert_adm_unet`, for
  `models.ADMUNet`, driven by the port's own `layout()`
  (`spatial_transformer_state_dict_from_flax` for one SpatialTransformer);
- `adm_classifier_state_dict_from_flax`: of `convert_adm_unet(...,
  classifier=True)`, for `models.ADMClassifier` and its four pooling heads;
- `autoencoder_kl_state_dict_from_flax`: of `dpm_solver_tpu/models/vae.py::
  convert_autoencoder_kl`, for `models.AutoencoderKL`;
- `vq_model_state_dict_from_flax`: of `convert_vq_model`, for
  `models.VQModel`;
- `bert_embedder_state_dict_from_flax`: of `dpm_solver_tpu/models/
  text_encoder.py::convert_bert_embedder`, for `models.BERTEmbedder` (the
  reference x_transformer keys);
- `ncsnpp_state_dict_from_flax`: of `dpm_solver_tpu/models/ncsnpp_convert.py::
  params_from_torch`, for `models.NCSNpp` (the reference score_sde layout);
- `ncsnv2_state_dict_from_flax` and `wideresnet_state_dict_from_flax`: the
  JAX `NCSNv2` and `WideResNetClassifier` params, for `models.NCSNv2` and
  `models.WideResNetClassifier`, whose modules carry the Flax names;
- `lpips_state_dict_from_flax`, `discriminator_state_dict_from_flax` (with
  its `batch_stats`) and `inception_state_dict_from_flax`: of
  `convert_torch_lpips`, `convert_torch_discriminator` and
  `convert_fid_inception`, for `models.LPIPS`, `models.NLayerDiscriminator`
  and `eval.inception.FIDInceptionV3` (taming's and pt_inception's keys);
- `train_state_from_flax` and `adversarial_state_from_flax`: a JAX
  training state (`TrainState`, first-stage `AdversarialTrainState`) as
  the port's, over its modules.

They read nested dicts of arrays (numpy, or anything `np.asarray` takes) and
import nothing of JAX. The DDPM layout rules, the converter's in reverse:

  conv  kernel [kH, kW, I, O]   -> weight [O, I, kH, kW]
  dense kernel [I, O]           -> weight [O, I]
  GroupNorm32 norm.scale / bias -> weight / bias
  temb_dense{i}                 -> temb.dense.{i}
  {down,up}_{l}_{block,attn}_{i} -> {down,up}.{l}.{block,attn}.{i}
  {down,up}_{l}_{down,up}sample -> {down,up}.{l}.{down,up}sample
  mid_{name}                    -> mid.{name}
"""

from __future__ import annotations

import itertools
import re
from typing import Dict, Mapping

import numpy as np
import torch



def load_torch_state_dict(path: str, *, prefer_ema: bool = True) -> Dict[str, torch.Tensor]:
    """A torch checkpoint file as a flat {name: CPU tensor} dict.

    Handles the reference's list-style checkpoints (runners/diffusion.py:
    torch.save([model_sd, opt_sd, epoch, step, ema_sd])), plain state dicts
    and {'state_dict': ...} wrappers. For list checkpoints the EMA shadow
    (the trailing dict of tensors) is laid over the raw weights by default,
    as the reference samples from EMA weights when `model.ema` is set
    (runners/diffusion.py:337-341); `prefer_ema=False` keeps the raw
    training weights. Read with `torch.load(weights_only=True)`: tensors and
    plain containers only, no pickled code.
    """
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, (list, tuple)):
        dicts = [x for x in obj if isinstance(x, Mapping)
                 and any(torch.is_tensor(v) for v in x.values())]
        base = dict(dicts[0]) if dicts else {}
        if prefer_ema and len(dicts) > 1:
            # EMA shadows hold parameters only (no buffers): laid over the base
            base.update(dicts[-1])
        obj = base
    if isinstance(obj, Mapping) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v.detach() for k, v in obj.items() if torch.is_tensor(v)}


_LEVEL = re.compile(r"^(down|up)_(\d+)_(block|attn)_(\d+)$")
_RESAMPLE = re.compile(r"^(down|up)_(\d+)_(downsample|upsample)$")
_TEMB = re.compile(r"^temb_dense(\d+)$")


def _module_path(name: str) -> str:
    for pattern, fmt in ((_LEVEL, "{0}.{1}.{2}.{3}"), (_RESAMPLE, "{0}.{1}.{2}"),
                         (_TEMB, "temb.dense.{0}")):
        m = pattern.match(name)
        if m:
            return fmt.format(*m.groups())
    if name.startswith("mid_"):
        return "mid." + name[len("mid_"):]
    return name  # conv_in, conv_out, norm_out


def _leaves(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def ddpm_unet_state_dict_from_flax(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """DDPMUNet flax params ({'params': {...}} or the inner dict) -> torch state dict."""
    tree = flax_params.get("params", flax_params)
    out: Dict[str, torch.Tensor] = {}
    for path, val in _leaves(tree):
        arr = np.asarray(val)
        mods, leaf = list(path[:-1]), path[-1]
        mods[0] = _module_path(mods[0])
        if leaf == "scale" or (len(mods) > 1 and mods[-1] == "norm"):
            # GroupNorm32 wraps nn.GroupNorm in a child called 'norm'
            mods = mods[:-1]
            leaf = "weight" if leaf == "scale" else "bias"
        elif leaf == "kernel":
            leaf = "weight"
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:
                arr = arr.transpose(1, 0)
            else:
                raise ValueError(f"unexpected kernel rank at {'/'.join(path)}: {arr.shape}")
        elif leaf != "bias":
            raise ValueError(f"unexpected leaf {'/'.join(path)}")
        out[".".join(mods + [leaf])] = torch.tensor(arr)
    return out


# --------------------------------------------------------------------------- #
# ADM / Stable Diffusion UNet and the KL autoencoder
# --------------------------------------------------------------------------- #


def _join(*parts: str) -> str:
    return ".".join(p for p in parts if p)


class _Writer:
    """Writes Flax leaves into a torch state dict in the reference layouts."""

    def __init__(self):
        self.sd: Dict[str, torch.Tensor] = {}

    def put(self, key: str, arr) -> None:
        self.sd[key] = torch.tensor(np.ascontiguousarray(np.asarray(arr)))

    def conv(self, dst: str, node: Mapping) -> None:   # kernel [kH, kW, I, O]
        self.put(_join(dst, "weight"), np.asarray(node["kernel"]).transpose(3, 2, 0, 1))
        self.put(_join(dst, "bias"), node["bias"])

    def dense(self, dst: str, node: Mapping) -> None:  # kernel [I, O]
        self.put(_join(dst, "weight"), np.asarray(node["kernel"]).T)
        if "bias" in node:
            self.put(_join(dst, "bias"), node["bias"])

    def conv1d(self, dst: str, node: Mapping) -> None:  # dense kernel -> (O, I, 1)
        self.put(_join(dst, "weight"), np.asarray(node["kernel"]).T[:, :, None])
        self.put(_join(dst, "bias"), node["bias"])

    def conv1x1(self, dst: str, node: Mapping) -> None:  # dense kernel -> (O, I, 1, 1)
        self.put(_join(dst, "weight"), np.asarray(node["kernel"]).T[:, :, None, None])
        self.put(_join(dst, "bias"), node["bias"])

    def affine(self, dst: str, node: Mapping) -> None:  # LayerNorm / bare GroupNorm
        self.put(_join(dst, "weight"), node["scale"])
        self.put(_join(dst, "bias"), node["bias"])

    def gn(self, dst: str, node: Mapping) -> None:  # GroupNorm32 wraps a child 'norm'
        self.affine(dst, node["norm"])

    def proj(self, dst: str, node: Mapping) -> None:  # Linear (SD-2.x) or 1x1 conv
        (self.dense if np.ndim(node["kernel"]) == 2 else self.conv)(dst, node)

    def spatial_transformer(self, dst: str, node: Mapping) -> None:
        self.affine(_join(dst, "norm"), node["norm"])
        self.proj(_join(dst, "proj_in"), node["proj_in"])
        self.proj(_join(dst, "proj_out"), node["proj_out"])
        depth = sum(1 for name in node if name.startswith("block_"))
        for d in range(depth):
            blk, t = node[f"block_{d}"], _join(dst, f"transformer_blocks.{d}")
            for norm in ("norm1", "norm2", "norm3"):
                self.affine(f"{t}.{norm}", blk[norm])
            for attn in ("attn1", "attn2"):
                for leaf in ("to_q", "to_k", "to_v"):
                    self.dense(f"{t}.{attn}.{leaf}", blk[attn][leaf])
                self.dense(f"{t}.{attn}.to_out.0", blk[attn]["to_out"])
            self.dense(t + ".ff.net.0.proj", blk["ff"]["proj"])
            self.dense(t + ".ff.net.2", blk["ff"]["out"])


def spatial_transformer_state_dict_from_flax(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """SpatialTransformer flax params -> the torch state dict of
    `models.SpatialTransformer` (reference key names)."""
    w = _Writer()
    w.spatial_transformer("", flax_params.get("params", flax_params))
    return w.sd


def _adm_trunk(flax_params: Mapping, config, encoder_only: bool):
    """Write the ADM trunk shared by the UNet and the classifier (time
    embedding, label embedding, the blocks of `layout()`); return the inner
    params and the writer."""
    from dpm_solver_tpu_torch.models.adm_unet import layout

    p = flax_params.get("params", flax_params)
    w = _Writer()

    def put_layer(src: str, spec: dict, dst: str) -> None:
        kind = spec["kind"]
        if kind == "resample" and not spec["with_conv"]:
            return  # parameter-free
        node = p[src]
        if kind == "conv_in":
            w.conv(dst, node)
        elif kind == "res":
            w.gn(dst + ".in_layers.0", node["in_norm"])
            w.conv(dst + ".in_layers.2", node["in_conv"])
            w.dense(dst + ".emb_layers.1", node["emb_proj"])
            w.gn(dst + ".out_layers.0", node["out_norm"])
            w.conv(dst + ".out_layers.3", node["out_conv"])
            if "skip" in node:
                w.conv(dst + ".skip_connection", node["skip"])
        elif kind == "attn":
            w.gn(dst + ".norm", node["norm"])
            w.conv1d(dst + ".qkv", node["qkv"])
            w.conv1d(dst + ".proj_out", node["proj_out"])
        elif kind == "xattn":
            w.spatial_transformer(dst, node)
        elif kind == "resample":
            w.conv(f"{dst}.{'conv' if spec['direction'] == 'up' else 'op'}", node["conv"])
        else:
            raise ValueError(kind)

    w.dense("time_embed.0", p["time_embed_0"])
    w.dense("time_embed.2", p["time_embed_2"])
    if "label_emb" in p:
        w.put("label_emb.weight", p["label_emb"]["embedding"])
    plan = layout(config, encoder_only=encoder_only)
    for n, layers in enumerate(plan["input_blocks"]):
        for m, spec in enumerate(layers):
            put_layer(f"input_blocks_{n}_{m}", spec, f"input_blocks.{n}.{m}")
    for m, spec in enumerate(plan["middle"]):
        put_layer(f"middle_block_{m}", spec, f"middle_block.{m}")
    for n, layers in enumerate(plan["output_blocks"]):
        for m, spec in enumerate(layers):
            put_layer(f"output_blocks_{n}_{m}", spec, f"output_blocks.{n}.{m}")
    return p, w


def adm_unet_state_dict_from_flax(flax_params: Mapping, config) -> Dict[str, torch.Tensor]:
    """ADMUNet flax params ({'params': {...}} or the inner dict) -> the torch
    state dict of `models.ADMUNet(config)` (reference key names)."""
    p, w = _adm_trunk(flax_params, config, encoder_only=False)
    w.gn("out.0", p["out_norm"])
    w.conv("out.2", p["out_conv"])
    return w.sd


def adm_classifier_state_dict_from_flax(flax_params: Mapping, config) -> Dict[str, torch.Tensor]:
    """ADMClassifier flax params -> the torch state dict of
    `models.ADMClassifier(config)`, head keys as `convert_adm_unet(...,
    classifier=True)` reads them for `config.pool`."""
    p, w = _adm_trunk(flax_params, config, encoder_only=True)
    if config.pool == "adaptive":
        w.gn("out.0", p["out_norm"])
        w.conv("out.3", p["out_conv"])
    elif config.pool == "attention":
        w.gn("out.0", p["out_norm"])
        pool = p["out_pool"]
        w.put("out.2.positional_embedding", np.asarray(pool["positional_embedding"]).T)
        w.conv1d("out.2.qkv_proj", pool["qkv_proj"])
        w.conv1d("out.2.c_proj", pool["c_proj"])
    elif config.pool == "spatial":
        w.dense("out.0", p["out_fc0"])
        w.dense("out.2", p["out_fc1"])
    elif config.pool == "spatial_v2":
        w.dense("out.0", p["out_fc0"])
        w.gn("out.1", p["out_norm"])
        w.dense("out.3", p["out_fc1"])
    else:
        raise ValueError(f"unknown pool {config.pool!r}")
    return w.sd


def autoencoder_kl_state_dict_from_flax(flax_params: Mapping, config) -> Dict[str, torch.Tensor]:
    """AutoencoderKL flax params -> the torch state dict of
    `models.AutoencoderKL(config)`; the fused qkv splits back into the
    reference's q, k and v 1x1 convs."""
    p = flax_params.get("params", flax_params)
    w = _Writer()

    def resblock(dst: str, node: Mapping) -> None:
        for leaf in ("norm1", "norm2"):
            w.affine(f"{dst}.{leaf}", node[leaf])
        for leaf in ("conv1", "conv2"):
            w.conv(f"{dst}.{leaf}", node[leaf])
        if "nin_shortcut" in node:
            w.conv(dst + ".nin_shortcut", node["nin_shortcut"])

    def attn(dst: str, node: Mapping) -> None:
        w.affine(dst + ".norm", node["norm"])
        kernel, bias = np.asarray(node["qkv"]["kernel"]), np.asarray(node["qkv"]["bias"])
        c = kernel.shape[0]
        for i, leaf in enumerate(("q", "k", "v")):
            w.conv1x1(f"{dst}.{leaf}", {"kernel": kernel[:, i * c:(i + 1) * c],
                                        "bias": bias[i * c:(i + 1) * c]})
        w.conv1x1(dst + ".proj_out", node["proj_out"])

    def half(prefix: str, node: Mapping, decoder: bool) -> None:
        w.conv(prefix + ".conv_in", node["conv_in"])
        resblock(prefix + ".mid.block_1", node["mid_block_1"])
        attn(prefix + ".mid.attn_1", node["mid_attn_1"])
        resblock(prefix + ".mid.block_2", node["mid_block_2"])
        w.affine(prefix + ".norm_out", node["norm_out"])
        w.conv(prefix + ".conv_out", node["conv_out"])
        side = "up" if decoder else "down"
        resample = "upsample" if decoder else "downsample"
        for i in range(len(config.ch_mult)):
            for j in range(config.num_res_blocks + (1 if decoder else 0)):
                if f"{side}_{i}_block_{j}" in node:
                    resblock(f"{prefix}.{side}.{i}.block.{j}", node[f"{side}_{i}_block_{j}"])
                if f"{side}_{i}_attn_{j}" in node:
                    attn(f"{prefix}.{side}.{i}.attn.{j}", node[f"{side}_{i}_attn_{j}"])
            if f"{side}_{i}_{resample}" in node:
                w.conv(f"{prefix}.{side}.{i}.{resample}.conv", node[f"{side}_{i}_{resample}"])

    half("encoder", p["encoder"], decoder=False)
    half("decoder", p["decoder"], decoder=True)
    w.conv("quant_conv", p["quant_conv"])
    w.conv("post_quant_conv", p["post_quant_conv"])
    return w.sd


def vq_model_state_dict_from_flax(flax_params: Mapping, config) -> Dict[str, torch.Tensor]:
    """VQModel flax params -> the torch state dict of `models.VQModel(config)`:
    the AutoencoderKL layout and the codebook `quantize.embedding.weight`."""
    p = flax_params.get("params", flax_params)
    sd = autoencoder_kl_state_dict_from_flax(p, config)
    sd["quantize.embedding.weight"] = torch.from_numpy(
        np.array(p["quantize"]["embedding"], dtype=np.float32))
    return sd


def bert_embedder_state_dict_from_flax(flax_params: Mapping,
                                       n_layer: int) -> Dict[str, torch.Tensor]:
    """BERTEmbedder flax params -> the torch state dict of
    `models.BERTEmbedder`, under the reference x_transformer keys (the
    inverse of `convert_bert_embedder`)."""
    p = flax_params.get("params", flax_params)
    w = _Writer()
    w.put("transformer.token_emb.weight", p["token_emb"]["embedding"])
    w.put("transformer.pos_emb.emb.weight", p["pos_emb"]["embedding"])
    w.affine("transformer.norm", p["final_norm"])
    for i in range(n_layer):
        a = f"transformer.attn_layers.layers.{2 * i}"
        f = f"transformer.attn_layers.layers.{2 * i + 1}"
        w.affine(a + ".0", p[f"attn_norm_{i}"])
        for name in ("to_q", "to_k", "to_v", "to_out"):
            w.dense(f"{a}.1.{name}", p[f"{name}_{i}"])
        w.affine(f + ".0", p[f"ff_norm_{i}"])
        w.dense(f + ".1.net.0.0", p[f"ff_in_{i}"])
        w.dense(f + ".1.net.2", p[f"ff_out_{i}"])
    return w.sd


# --------------------------------------------------------------------------- #
# NCSN++ / DDPM++ (score_sde)
# --------------------------------------------------------------------------- #


def ncsnpp_state_dict_from_flax(flax_params: Mapping, config) -> Dict[str, torch.Tensor]:
    """NCSNpp flax params -> the torch state dict of `models.NCSNpp(config)`:
    the reference score_sde layout `all_modules.<i>.<submodule>.<param>`,
    walked in the reference constructor's order. The exact inverse of
    `dpm_solver_tpu/models/ncsnpp_convert.py::params_from_torch`: the fused
    (C, 3C) qkv splits back into the NIN q, k, v projections, 1x1 shortcuts
    become BigGAN `Conv_2` convs or DDPM `NIN_0` matrices, and parameter-free
    resamples take an index but write nothing. `sigmas` is the config's
    sigma ladder, as the reference registers it."""
    from dpm_solver_tpu_torch.models.ncsnpp import get_sigmas

    cfg, p = config, flax_params.get("params", flax_params)
    w = _Writer()
    index = itertools.count()
    biggan = cfg.resblock_type == "biggan"
    levels = len(cfg.ch_mult)
    res_at = [cfg.image_size // (2 ** i) for i in range(levels)]

    def slot() -> str:
        return f"all_modules.{next(index)}"

    def nin(dst: str, kernel, bias) -> None:
        w.put(dst + ".W", kernel)
        w.put(dst + ".b", bias)

    def resblock(name: str) -> None:
        node, dst = p[name], slot()
        w.affine(dst + ".GroupNorm_0", node["norm1"])
        w.conv(dst + ".Conv_0", node["conv1"])
        if "temb_proj" in node:
            w.dense(dst + ".Dense_0", node["temb_proj"])
        w.affine(dst + ".GroupNorm_1", node["norm2"])
        w.conv(dst + ".Conv_1", node["conv2"])
        if "shortcut" in node:
            if biggan:
                w.conv(dst + ".Conv_2", node["shortcut"])
            else:
                nin(dst + ".NIN_0", np.asarray(node["shortcut"]["kernel"])[0, 0],
                    node["shortcut"]["bias"])

    def attn(name: str) -> None:
        node, dst = p[name], slot()
        w.affine(dst + ".GroupNorm_0", node["norm"])
        kernel, bias = np.asarray(node["qkv"]["kernel"]), np.asarray(node["qkv"]["bias"])
        c = kernel.shape[0]
        for i in range(3):
            nin(f"{dst}.NIN_{i}", kernel[:, i * c:(i + 1) * c], bias[i * c:(i + 1) * c])
        nin(dst + ".NIN_3", node["proj"]["kernel"], node["proj"]["bias"])

    def resample(name: str) -> None:
        node, dst = p.get(name), slot()
        if node is None:
            return  # parameter-free
        if "conv" in node:
            w.conv(dst + ".Conv_0", node["conv"])
        else:  # the StyleGAN2 FIR conv: kernel HWIO -> Conv2d_0.weight OIHW
            w.conv(dst + ".Conv2d_0", node)

    w.put("sigmas", get_sigmas(cfg.sigma_min, cfg.sigma_max, cfg.num_scales))
    if cfg.embedding_type == "fourier":
        w.put(slot() + ".W", p["fourier"]["W"])
    if cfg.conditional:
        w.dense(slot(), p["time_embed_0"])
        w.dense(slot(), p["time_embed_1"])
    w.conv(slot(), p["conv_in"])
    for i in range(levels):
        for j in range(cfg.num_res_blocks):
            resblock(f"down_{i}_block_{j}")
            if res_at[i] in cfg.attn_resolutions:
                attn(f"down_{i}_attn_{j}")
        if i == levels - 1:
            continue
        (resblock if biggan else resample)(f"down_{i}_resample")
        if cfg.progressive_input == "input_skip":
            w.conv(slot() + ".Conv_0", p[f"down_{i}_combine"])
        elif cfg.progressive_input == "residual":
            resample(f"down_{i}_pyr")
    resblock("mid_block_1")
    attn("mid_attn")
    resblock("mid_block_2")
    for i in reversed(range(levels)):
        for j in range(cfg.num_res_blocks + 1):
            resblock(f"up_{i}_block_{j}")
        if res_at[i] in cfg.attn_resolutions:
            attn(f"up_{i}_attn")
        if cfg.progressive == "output_skip" or (cfg.progressive == "residual"
                                                and i == levels - 1):
            w.affine(slot(), p[f"up_{i}_pyr_norm"])
            w.conv(slot(), p[f"up_{i}_pyr_conv"])
        elif cfg.progressive == "residual":
            resample(f"up_{i}_pyr_up")
        if i != 0:
            (resblock if biggan else resample)(f"up_{i}_resample")
    if cfg.progressive != "output_skip":
        w.affine(slot(), p["norm_out"])
        w.conv(slot(), p["conv_out"])
    return w.sd


def _flax_named_state_dict(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """The state dict of a port module whose submodules carry the Flax module
    names: each path joined by dots; a conv kernel (kH, kW, I, O) -> weight
    (O, I, kH, kW), a dense kernel (I, O) -> weight (O, I), an embedding or a
    GroupNorm scale -> weight, a per-channel (1, 1, 1, C) parameter -> (C,)."""
    out: Dict[str, torch.Tensor] = {}
    for path, val in _leaves(flax_params.get("params", flax_params)):
        arr, leaf = np.asarray(val), path[-1]
        if leaf == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.transpose(1, 0)
            leaf = "weight"
        elif leaf in ("embedding", "scale"):
            leaf = "weight"
        elif leaf != "W":
            arr = arr.reshape(-1)
        out[".".join(path[:-1] + (leaf,))] = torch.tensor(np.ascontiguousarray(arr))
    return out


def ncsnv2_state_dict_from_flax(flax_params: Mapping, config) -> Dict[str, torch.Tensor]:
    """JAX `NCSNv2` params -> the state dict of `models.NCSNv2(config)`, the
    `sigmas` buffer the config's ladder."""
    from dpm_solver_tpu_torch.models.ncsnv2 import get_sigmas

    out = _flax_named_state_dict(flax_params)
    out["sigmas"] = torch.tensor(get_sigmas(config.sigma_min, config.sigma_max,
                                            config.num_scales))
    return out


def wideresnet_state_dict_from_flax(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX `WideResNetClassifier` params -> the state dict of
    `models.WideResNetClassifier` of the same blocks and widths."""
    return _flax_named_state_dict(flax_params)


# --------------------------------------------------------------------------- #
# a JAX training state
# --------------------------------------------------------------------------- #


def _find_adam(tree):
    """optax's ScaleByAdamState (count, mu, nu) inside a chain's state."""
    if all(hasattr(tree, f) for f in ("count", "mu", "nu")):
        return tree
    if isinstance(tree, (tuple, list)):
        for item in tree:
            found = _find_adam(item)
            if found is not None:
                return found
    return None


def train_state_from_flax(flax_state, to_state_dict, model: torch.nn.Module, tx):
    """A JAX `TrainState` (`dpm_solver_tpu/training/train.py`: step,
    params, opt_state of an optax chain holding Adam's state, ema_params,
    ema_rate) as the port's `training.TrainState` over `model`.

    `to_state_dict` is this file's Flax -> torch converter of the model
    (e.g. `lambda p: ncsnpp_state_dict_from_flax(p, cfg)`): the params go
    through it into `model`, and so do the EMA and Adam's first and second
    moments, whose trees are the params'; Adam's count and the step carry
    over. `tx` is the port's `training.optim.Adam` the run continues with."""
    from dpm_solver_tpu_torch.training.train import make_train_state

    model.load_state_dict(to_state_dict(flax_state.params))
    state, _ = make_train_state(model, ema_rate=float(flax_state.ema_rate), tx=tx)
    adam = _find_adam(flax_state.opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the JAX optimiser state")
    keys = list(state.params)
    with torch.no_grad():
        for dst, tree in ((state.ema_params, flax_state.ema_params),
                          (state.opt_state["mu"], adam.mu), (state.opt_state["nu"], adam.nu)):
            sd = to_state_dict(tree)
            for k in keys:
                dst[k].copy_(sd[k])
    state.opt_state["count"] = int(np.asarray(adam.count))
    state.step = int(np.asarray(flax_state.step))
    return state


def adversarial_state_from_flax(flax_state, ae_to_state_dict, ae: torch.nn.Module,
                                discriminator: torch.nn.Module, tx=None):
    """A JAX first-stage `AdversarialTrainState` (`dpm_solver_tpu/training/
    autoencoder.py`: step, gen_params {'ae', 'logvar'}, gen_opt, disc_params,
    disc_batch_stats, disc_opt, each optimiser optax.adam's state) as the
    port's `training.autoencoder.AdversarialTrainState` over `ae` and
    `discriminator`, which take the parameters and statistics.

    `ae_to_state_dict` is the autoencoder's Flax -> torch converter (e.g.
    `lambda p: autoencoder_kl_state_dict_from_flax(p, cfg)`); Adam's moments,
    whose trees are the parameters', go through it and through
    `discriminator_state_dict_from_flax`; the counts and the step carry over.
    `tx` is the port's Adam the run continues with (default: the trainer's)."""
    from dpm_solver_tpu_torch.training.autoencoder import make_adversarial_state

    n_layers = discriminator.n_layers
    ae.load_state_dict(ae_to_state_dict(flax_state.gen_params["ae"]))
    discriminator.load_state_dict(discriminator_state_dict_from_flax(
        {"params": flax_state.disc_params, "batch_stats": flax_state.disc_batch_stats},
        n_layers), strict=False)
    state, _ = make_adversarial_state(ae, discriminator, tx=tx,
                                      logvar_init=float(np.asarray(flax_state.gen_params["logvar"])))
    for opt, tree, to_sd, prefix in (
            (state.gen_opt, flax_state.gen_opt, ae_to_state_dict, "ae."),
            (state.disc_opt, flax_state.disc_opt,
             lambda t: discriminator_state_dict_from_flax({"params": t}, n_layers), "")):
        adam = _find_adam(tree)
        if adam is None:
            raise ValueError("no Adam state (count, mu, nu) in the JAX optimiser state")
        with torch.no_grad():
            for moment in ("mu", "nu"):
                flax_tree = getattr(adam, moment)
                sd = to_sd(flax_tree["ae"] if prefix else flax_tree)
                for k, v in opt[moment].items():
                    v.copy_(torch.as_tensor(np.asarray(flax_tree["logvar"])) if k == "logvar"
                            else sd[k[len(prefix):]])
        opt["count"] = int(np.asarray(adam.count))
    state.step = int(np.asarray(flax_state.step))
    return state


# --------------------------------------------------------------------------- #
# LPIPS, the PatchGAN discriminator, the FID Inception
# --------------------------------------------------------------------------- #


def lpips_state_dict_from_flax(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX `LPIPS` params -> the state dict of `models.LPIPS` (taming's
    keys): `vgg/conv{i}` -> `net.slice{s}.{i}`, `lin{k}` (C,) ->
    `lin{k}.model.1.weight` (1, C, 1, 1)."""
    from dpm_solver_tpu_torch.models.lpips import _VGG_SLICES

    p = flax_params.get("params", flax_params)
    w = _Writer()
    for si, convs in enumerate(_VGG_SLICES):
        for idx, _ in convs:
            w.conv(f"net.slice{si + 1}.{idx}", p["vgg"][f"conv{idx}"])
    for k in range(len(_VGG_SLICES)):
        w.put(f"lin{k}.model.1.weight", np.asarray(p[f"lin{k}"]).reshape(1, -1, 1, 1))
    return w.sd


def discriminator_state_dict_from_flax(flax_vars: Mapping, n_layers: int = 3
                                       ) -> Dict[str, torch.Tensor]:
    """JAX `NLayerDiscriminator` variables ({'params', 'batch_stats'}) -> the
    state dict of `models.NLayerDiscriminator` (taming's `main.{i}` keys:
    conv, LeakyReLU, [conv, norm, LeakyReLU] * n_layers, conv). BatchNorm's
    running moments come from 'batch_stats' where it is given (its
    `num_batches_tracked` 0); ActNorm's loc and scale become (1, C, 1, 1)."""
    p, stats = flax_vars["params"], flax_vars.get("batch_stats") or {}
    w = _Writer()

    def conv(dst, node):
        w.put(dst + ".weight", np.asarray(node["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in node:
            w.put(dst + ".bias", node["bias"])

    conv("main.0", p["conv0"])
    i = 2
    for n in range(1, n_layers + 1):
        conv(f"main.{i}", p[f"conv{n}"])
        norm = p[f"norm{n}"]
        if "loc" in norm:
            w.put(f"main.{i + 1}.loc", np.asarray(norm["loc"]).reshape(1, -1, 1, 1))
            w.put(f"main.{i + 1}.scale", np.asarray(norm["scale"]).reshape(1, -1, 1, 1))
        else:
            w.affine(f"main.{i + 1}", norm)
            if f"norm{n}" in stats:
                w.put(f"main.{i + 1}.running_mean", stats[f"norm{n}"]["mean"])
                w.put(f"main.{i + 1}.running_var", stats[f"norm{n}"]["var"])
                w.sd[f"main.{i + 1}.num_batches_tracked"] = torch.tensor(0)
        i += 3
    conv(f"main.{i}", p["conv_out"])
    return w.sd


def inception_state_dict_from_flax(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX `FIDInceptionV3` params -> the state dict of
    `eval.inception.FIDInceptionV3` (pt_inception-2015-12-05's keys: each
    ConvBN's `conv/kernel` -> `.conv.weight`, `bn_scale`, `bn_bias`,
    `bn_mean`, `bn_var` -> `.bn.weight`, `.bn.bias`, `.bn.running_mean`,
    `.bn.running_var`; `fc`)."""
    leaf_names = {"bn_scale": "bn.weight", "bn_bias": "bn.bias", "bn_mean": "bn.running_mean",
                  "bn_var": "bn.running_var"}
    w = _Writer()
    for path, val in _leaves(flax_params.get("params", flax_params)):
        mods, leaf = ".".join(path[:-1]), path[-1]
        if path[0] == "fc":
            w.put("fc." + ("weight" if leaf == "kernel" else "bias"),
                  np.asarray(val).T if leaf == "kernel" else val)
        elif leaf == "kernel":
            w.put(mods + ".weight", np.asarray(val).transpose(3, 2, 0, 1))
        else:
            w.put(f"{mods}.{leaf_names[leaf]}", val)
            if leaf == "bn_var":
                w.sd[f"{mods}.bn.num_batches_tracked"] = torch.tensor(0)
    return w.sd
