"""The configuration files against the port's presets, and the plain
reference against the port at tiny sizes on the CPU (float32)."""

import copy

import numpy as np
import pytest
import torch

from port_bench.entries import dpm_sample, sd_txt2img
from port_bench.harness.cell import Cell, load_benchmark
from port_bench.harness.weights import seeded_state_dict, shapes_of
from port_bench.reference import clip as ref_clip, dpm_solver as ref_dpm
from port_bench.reference.ddpm_unet import DDPMUNet as RefDDPM
from port_bench.reference.layers import FP32, Precision
from port_bench.reference.sd_unet import SDUNet
from port_bench.reference.vae import AutoencoderKL as RefVAE
from port_bench.tests.tiny import tiny_config

BENCH = load_benchmark()
SD = Cell(BENCH, "sd_v1_512.txt2img_b4").config
CIFAR = Cell(BENCH, "cifar10_ddpm.fid_b1000").config
CPU = torch.device("cpu")


def test_sd_widths_are_the_ports_presets():
    from dpm_solver_tpu_torch.models import ADMConfig, CLIPTowerConfig, VAEConfig

    u, preset = SD["unet"], ADMConfig.sd_v1()
    for key in ("in_channels", "out_channels", "model_channels", "num_res_blocks", "num_heads",
                "transformer_depth", "context_dim", "use_spatial_transformer"):
        assert u[key] == getattr(preset, key), key
    assert tuple(u["channel_mult"]) == preset.channel_mult
    assert sorted(u["attention_resolutions"]) == sorted(preset.attention_resolutions)
    v, vp = SD["first_stage"], VAEConfig.sd_v1()
    for key in ("embed_dim", "double_z", "z_channels", "resolution", "in_channels", "out_ch",
                "ch", "num_res_blocks"):
        assert v[key] == getattr(vp, key), key
    assert tuple(v["ch_mult"]) == vp.ch_mult and tuple(v["attn_resolutions"]) == vp.attn_resolutions
    t, tp = SD["text_encoder"], CLIPTowerConfig.vit_l14_text()
    for key in ("hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
                "hidden_act", "layer_norm_eps", "vocab_size", "max_position_embeddings"):
        assert t[key] == getattr(tp, key), key
    assert SD["scale_factor"] == 0.18215 and SD["sampler"]["steps"] == 25


def test_cifar_widths_are_the_ports_preset():
    from dpm_solver_tpu_torch.models import DDPMUNetConfig

    m, preset = CIFAR["model"], DDPMUNetConfig.cifar10()
    for key in ("ch", "out_ch", "num_res_blocks", "in_channels", "resolution", "resamp_with_conv"):
        assert m[key] == getattr(preset, key), key
    assert tuple(m["ch_mult"]) == preset.ch_mult
    assert tuple(m["attn_resolutions"]) == preset.attn_resolutions


def _same_keys(ref: torch.nn.Module, port: torch.nn.Module):
    a = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    b = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert a == b


@pytest.mark.parametrize("which", ["full", "tiny"])
def test_reference_keys_are_the_ports(which):
    from dpm_solver_tpu_torch.models import (ADMConfig, ADMUNet, AutoencoderKL, CLIPTextModel,
                                             CLIPTowerConfig, DDPMUNet, DDPMUNetConfig,
                                             VAEConfig)

    sd = SD if which == "full" else tiny_config(SD)
    cf = CIFAR if which == "full" else tiny_config(CIFAR)
    with torch.device("meta"):
        pairs = [
            (SDUNet(sd["unet"]),
             ADMUNet(ADMConfig(**sd_txt2img._fields(ADMConfig, sd["unet"])), device="meta")),
            (RefVAE(sd["first_stage"]),
             AutoencoderKL(VAEConfig(**sd_txt2img._fields(VAEConfig, sd["first_stage"])),
                           device="meta")),
            (ref_clip.CLIPText(sd["text_encoder"]),
             CLIPTextModel(CLIPTowerConfig.from_dict(sd["text_encoder"]))),
            (RefDDPM(cf["model"]),
             DDPMUNet(DDPMUNetConfig(**{k: tuple(v) if isinstance(v, list) else v
                                        for k, v in cf["model"].items()
                                        if k in DDPMUNetConfig.__dataclass_fields__}),
                      device="meta")),
        ]
    for ref, port in pairs:
        _same_keys(ref, port)


def _port_sd(cfg):
    from dpm_solver_tpu_torch.models import (ADMConfig, ADMUNet, AutoencoderKL, CLIPTextModel,
                                             CLIPTowerConfig, VAEConfig)

    w = sd_txt2img.seeded_weights(cfg, 7, CPU)
    unet = ADMUNet(ADMConfig(**sd_txt2img._fields(ADMConfig, cfg["unet"])), device="cpu")
    vae = AutoencoderKL(VAEConfig(**sd_txt2img._fields(VAEConfig, cfg["first_stage"])),
                        device="cpu")
    text = CLIPTextModel(CLIPTowerConfig.from_dict(cfg["text_encoder"]))
    refs = sd_txt2img.reference_nets(cfg)
    for port, ref, key in zip((unet, vae, text), refs, ("unet", "vae", "clip")):
        port.load_state_dict(w[key])
        ref.load_state_dict(w[key])
    return (unet.eval(), vae.eval(), text.eval()), refs


@torch.no_grad()
def test_sd_networks_agree_with_the_port():
    cfg = tiny_config(SD)
    (unet, vae, text), (r_unet, r_vae, r_text) = _port_sd(cfg)
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 49408, (2, 77), generator=g)
    ctx = text(ids)[0]
    assert torch.allclose(ctx, r_text(ids, FP32), atol=1e-5, rtol=1e-5)
    x, t = torch.randn(2, 8, 8, 4, generator=g), torch.tensor([10.0, 700.0])
    assert torch.allclose(unet(x, t, None, ctx), r_unet(x, t, ctx, FP32), atol=1e-4, rtol=1e-4)
    assert torch.allclose(vae.decode(x), r_vae.decode(x, FP32), atol=1e-4, rtol=1e-4)


@torch.no_grad()
def test_ddpm_network_agrees_with_the_port():
    from dpm_solver_tpu_torch.models import DDPMUNet, DDPMUNetConfig

    cfg = tiny_config(CIFAR)
    w = dpm_sample.seeded_weights(cfg, 5, CPU)
    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["model"].items()
              if k in DDPMUNetConfig.__dataclass_fields__}
    port = DDPMUNet(DDPMUNetConfig(**fields), device="cpu")
    port.load_state_dict(w)
    ref = RefDDPM(cfg["model"])
    ref.load_state_dict(w)
    x = torch.randn(3, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    t = torch.tensor([1.0, 400.0, 999.0])
    assert torch.allclose(port.eval()(x, t), ref(x, t, FP32), atol=1e-4, rtol=1e-4)


def test_tokenizer_agrees_with_the_port(tmp_path):
    from dpm_solver_tpu_torch.models import CLIPTokenizer

    from port_bench.harness import inputs

    words = inputs.read_words(inputs.Path(__file__).resolve().parents[1] / "traffic" / "words.txt")
    d = inputs.vocab_dir(words)
    prompts = inputs.prompts(words, [5, 40], 6, 123, 4) + ["", "Émile's CAT, 42 dogs! 東京"]
    assert torch.equal(CLIPTokenizer(d)(prompts), ref_clip.Tokenizer(d)(prompts))


def test_schedule_and_grid_agree_with_the_port():
    from dpm_solver_tpu_torch import NoiseScheduleVP
    from dpm_solver_tpu_torch.solver.plan import get_time_steps

    betas = dpm_sample.betas(CIFAR)
    ns, ref = NoiseScheduleVP("discrete", betas=betas), ref_dpm.DiscreteVP(betas=betas)
    assert ns.total_N == ref.N
    for skip in ("logSNR", "time_uniform"):
        want = get_time_steps(ns, skip, 1.0, 1.0 / ns.total_N, 10)
        assert np.allclose(ref_dpm.time_grid(ref, skip, 10), want, rtol=0, atol=1e-12)
    t = np.linspace(1e-3, 1.0, 17)
    assert np.allclose(ref.lam(t), ns.marginal_lambda_np(t), atol=1e-12)


@pytest.mark.parametrize("steps,order,lof,want", [
    (25, 2, True, [1] + [2] * 24), (10, 3, True, [1, 2] + [3] * 8),
    (6, 3, True, [1, 2, 3, 3, 2, 1])])
def test_order_schedule(steps, order, lof, want):
    assert ref_dpm.orders(steps, order, lof) == want


def test_weights_are_a_function_of_the_seed():
    shapes = [("a.weight", (4, 3)), ("a.bias", (4,)), ("n.weight", (4,))]
    a = seeded_state_dict(shapes, 2 ** 31 + 5, CPU)
    b = seeded_state_dict(shapes, 2 ** 31 + 5, CPU)
    c = seeded_state_dict(shapes, 2 ** 31 + 6, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["a.weight"], c["a.weight"])
    assert a["a.bias"].abs().max() < 0.1 and (a["n.weight"] - 1).abs().max() < 1.0


def test_fp8_precision_rounds():
    x = torch.linspace(-3, 3, 101)
    y = Precision("fp8").act(x)
    # e4m3 keeps 3 mantissa bits: a value moves by at most half a step, 1/16 of itself
    assert 0 < (x - y).abs().max() and ((x - y).abs() <= x.abs() / 16 + 1e-6).all()
    assert torch.equal(FP32.act(x), x)


def test_meta_shapes_match_seeded_shapes():
    cfg = copy.deepcopy(tiny_config(CIFAR))
    with torch.device("meta"):
        net = RefDDPM(cfg["model"])
    w = dpm_sample.seeded_weights(cfg, 1, CPU)
    assert {k: tuple(v.shape) for k, v in w.items()} == dict(shapes_of(net))
