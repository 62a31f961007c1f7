"""The demos of `examples/`, ported (dpm_solver_tpu_torch/examples/): each
`main` completes on the CPU at its tiny random-weight default and writes the
files the JAX demo writes; with no card, the default device raises."""

import os

import pytest
import torch

from dpm_solver_tpu_torch.examples import diffedit_demo, latent_imagenet_demo, score_sde_demo

DEMOS = {
    "score_sde": (score_sde_demo, ["--batch", "2", "--steps", "4"],
                  ["demo_pc.png", "demo_dpm.png"]),
    "latent_imagenet": (latent_imagenet_demo, ["--steps", "4"], ["demo_clscond.png"]),
    "diffedit": (diffedit_demo, ["--steps", "4"],
                 ["diffedit_original.png", "diffedit_edited.png", "diffedit_mask.png"]),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(DEMOS))
def test_demo_writes_its_files(name, tmp_path, capsys):
    from PIL import Image

    module, argv, files = DEMOS[name]
    module.main(["--device", "cpu", "--outdir", str(tmp_path)] + argv)
    assert "no --ckpt" in capsys.readouterr().out
    for f in files:
        path = tmp_path / f
        assert path.exists(), sorted(os.listdir(tmp_path))
        assert Image.open(path).size[0] > 0


@pytest.mark.parametrize("name", sorted(DEMOS))
def test_demo_asks_for_the_card_by_default(name, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DEMOS[name][0].main(["--outdir", str(tmp_path)])


# --------------------------------------------------------------------------- #
# the checkpoint routes (--ckpt), on tiny CompVis checkpoints: the presets'
# geometry replaced by tiny configs, as tests/test_torch_cli.py does
# --------------------------------------------------------------------------- #

WIDTH, CLASSES, EMBED = 32, 7, 24


def _tiny_preset(monkeypatch, name, unet_cfg, vae_cfg):
    from dpm_solver_tpu_torch.pipelines import stable_diffusion as psd

    betas, scale = psd._LDM_PRESETS[name][2:]
    monkeypatch.setitem(psd._LDM_PRESETS, name, (lambda: unet_cfg, lambda: vae_cfg, betas, scale))


def _compvis(path, unet, vae, **extra):
    sd = {f"model.diffusion_model.{k}": v for k, v in unet.state_dict().items()}
    sd.update({f"first_stage_model.{k}": v for k, v in vae.state_dict().items()})
    torch.save({"state_dict": dict(sd, **extra)}, path)
    return str(path)


def test_diffedit_demo_from_a_checkpoint_edits_at_the_unets_size(tmp_path, monkeypatch):
    """`--ckpt` and `--clip` (a joint CLIP directory): the synthetic image is
    the UNet's latent size times the first stage's factor (SD-1: 512 px),
    not the first stage's training resolution."""
    import json

    from PIL import Image

    from dpm_solver_tpu_torch.models import ADMConfig, ADMUNet, AutoencoderKL, init_random_
    from dpm_solver_tpu_torch.models.clip import CLIPModel, CLIPTowerConfig
    from dpm_solver_tpu_torch.models.clip_tokenizer import write_synthetic_vocab
    from dpm_solver_tpu_torch.models.vae import VAEConfig

    ucfg = ADMConfig(image_size=8, in_channels=4, model_channels=32, out_channels=4,
                     num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                     num_heads=2, use_spatial_transformer=True, context_dim=WIDTH)
    vcfg = VAEConfig.tiny(resolution=64, ch_mult=(1, 2, 2), attn_resolutions=())
    _tiny_preset(monkeypatch, "sd_v1", ucfg, vcfg)
    g = torch.Generator().manual_seed(0)
    ckpt = _compvis(tmp_path / "sd.ckpt", init_random_(ADMUNet(ucfg, device="cpu"), g),
                    init_random_(AutoencoderKL(vcfg, device="cpu"), g))
    clip = tmp_path / "clip"
    write_synthetic_vocab(clip)
    text = CLIPTowerConfig(hidden_size=WIDTH, intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=2)
    vision = CLIPTowerConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                             num_attention_heads=2)
    model = CLIPModel(text, vision, WIDTH)
    for part in (model.text_model, model.vision_model, model.text_projection,
                 model.visual_projection):
        init_random_(part, g)
    torch.save(model.state_dict(), clip / "pytorch_model.bin")
    (clip / "config.json").write_text(json.dumps(dict(
        architectures=["CLIPModel"], model_type="clip", projection_dim=WIDTH,
        text_config=dict(vars(text), bos_token_id=49406, pad_token_id=1),
        vision_config=vars(vision))))

    out = tmp_path / "out"
    diffedit_demo.main(["--device", "cpu", "--ckpt", ckpt, "--clip", str(clip), "--steps", "3",
                        "--outdir", str(out)])
    side = ucfg.image_size * 2 ** (len(vcfg.ch_mult) - 1)   # 32, the first stage's 64 aside
    for f in DEMOS["diffedit"][2]:
        assert Image.open(out / f).size == ((side, side) if f != "diffedit_mask.png"
                                            else (ucfg.image_size, ucfg.image_size))


def test_latent_imagenet_demo_conditions_on_the_checkpoints_class_table(tmp_path, monkeypatch):
    """`--ckpt`: the class embeddings are the checkpoint's
    `cond_stage_model.embedding.weight`, not a fresh random table; a table of
    another shape than the flags' raises."""
    import numpy as np

    from dpm_solver_tpu_torch import pipelines
    from dpm_solver_tpu_torch.models import ADMConfig, ADMUNet, VQModel, init_random_
    from dpm_solver_tpu_torch.models.vae import VAEConfig

    ucfg = ADMConfig(image_size=8, in_channels=3, model_channels=32, out_channels=3,
                     num_res_blocks=1, attention_resolutions=(1, 2), channel_mult=(1, 2),
                     num_heads=1, use_spatial_transformer=True, context_dim=EMBED)
    vcfg = VAEConfig.tiny(ch_mult=(1, 2), z_channels=3, embed_dim=3, double_z=False,
                          resolution=16, attn_resolutions=())
    _tiny_preset(monkeypatch, "cin256", ucfg, vcfg)
    g = torch.Generator().manual_seed(0)
    unet = init_random_(ADMUNet(ucfg, device="cpu"), g)
    vq = init_random_(VQModel(vcfg, n_embed=16, device="cpu"), g)
    table = torch.randn(CLASSES + 1, EMBED, generator=g)
    ckpt = _compvis(tmp_path / "cin.ckpt", unet, vq, **{"cond_stage_model.embedding.weight": table})
    seen = {}
    orig = pipelines.class_conditional_sample

    def spy(model, embedder, *a, **k):
        seen["table"] = embedder.embedding.weight.detach().clone()
        return orig(model, embedder, *a, **k)

    monkeypatch.setattr(pipelines, "class_conditional_sample", spy)
    flags = ["--device", "cpu", "--ckpt", ckpt, "--classes", "1,5", "--steps", "2",
             "--num-classes", str(CLASSES), "--embed-dim", str(EMBED)]
    latent_imagenet_demo.main(flags + ["--outdir", str(tmp_path / "out")])
    np.testing.assert_array_equal(seen["table"].numpy(), table.numpy())
    assert (tmp_path / "out" / "demo_clscond.png").exists()
    with pytest.raises(ValueError, match="class embedding"):
        latent_imagenet_demo.main(flags[:-2] + ["--embed-dim", str(EMBED + 1), "--outdir",
                                                str(tmp_path / "bad")])
