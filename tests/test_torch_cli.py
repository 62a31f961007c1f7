"""The port's CLI (`python -m dpm_solver_tpu_torch.cli`) on the CPU, at tiny size.

- The parser: the same subcommands, options, defaults' choices and
  positionals as the JAX CLI's, read through each subcommand's `--help`;
  the only difference is the global option (JAX's `--compile-cache`, the
  port's `--device`).
- `sample` writes the pixels of the port's library call with the same
  generator (and its sequence, interpolation and trace modes run);
  `train` -> resume -> `eval` as tests/test_cli.py:22 drives the JAX CLI.
- `txt2img` in the three modes (float, `--quant w8a8`, `--quant w8a8_conv`)
  on a CompVis-layout checkpoint of random tiny weights, with the watermark
  and a synthesized safety checkpoint over a local tiny CLIP directory;
  `wmdecode` reads the payload back from a written PNG.
- `img2img`, `inpaint`, `clscond`, `knn2img`, `train-ae` and
  `train-latent` once each; `fid` prints `calculate_fid_given_paths`'s
  value; `--device cuda` without a card raises, and so do `--devices 2`
  with an indivisible batch and with fewer visible cards than ranks.
The SD-family presets are swapped for tiny geometries in the port's preset
table (the CLI reaches them by name, as the JAX CLI does).
"""

import json
import os
import re

import numpy as np
import pytest
import torch

import dpm_solver_tpu_torch as P
from dpm_solver_tpu_torch import cli
from dpm_solver_tpu_torch.models import (ADMConfig, ADMUNet, AutoencoderKL, VAEConfig,
                                         init_random_)
from dpm_solver_tpu_torch.pipelines import stable_diffusion as psd

WIDTH = 32    # the tiny CLIP's text width = its joint-space width = the UNet's context
TINY_UNET = ADMConfig(image_size=8, in_channels=4, model_channels=32, out_channels=4,
                      num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                      num_heads=2, use_spatial_transformer=True, transformer_depth=1,
                      context_dim=WIDTH)
TINY_VAE = VAEConfig.tiny(resolution=64, ch_mult=(1, 2, 2), attn_resolutions=())
SIDE = 128    # 32 x 32 latents; 256 watermark blocks a plane for the 136 bits


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for these host loops: the suite runs several
    workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def tiny_presets(monkeypatch):
    for name in ("sd_v1", "cin256", "rdm_768"):
        betas, scale = psd._LDM_PRESETS[name][2:]
        monkeypatch.setitem(psd._LDM_PRESETS, name,
                            (lambda: TINY_UNET, lambda: TINY_VAE, betas, scale))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A CompVis checkpoint of random tiny weights, a tiny joint CLIP
    directory (HF layout), a safety checkpoint and an image with its mask."""
    from PIL import Image

    from dpm_solver_tpu_torch.models.clip import CLIPModel, CLIPTowerConfig
    from dpm_solver_tpu_torch.models.clip_tokenizer import write_synthetic_vocab

    d = tmp_path_factory.mktemp("cli_files")
    g = torch.Generator().manual_seed(0)
    unet = init_random_(ADMUNet(TINY_UNET, device="cpu"), g)
    vae = init_random_(AutoencoderKL(TINY_VAE, device="cpu"), g)
    sd = {f"model.diffusion_model.{k}": v for k, v in unet.state_dict().items()}
    sd.update({f"first_stage_model.{k}": v for k, v in vae.state_dict().items()})
    torch.save({"state_dict": sd}, d / "sd.ckpt")

    clip = d / "clip"
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

    rng = np.random.default_rng(1)

    def safety(name, thresholds):
        torch.save({"concept_embeds": torch.from_numpy(
                        rng.standard_normal((3, WIDTH)).astype(np.float32)),
                    "concept_embeds_weights": torch.full((3,), float(thresholds)),
                    "special_care_embeds": torch.from_numpy(
                        rng.standard_normal((2, WIDTH)).astype(np.float32)),
                    "special_care_embeds_weights": torch.full((2,), float(thresholds))},
                   d / name)
        return str(d / name)

    Image.fromarray(rng.integers(0, 256, (SIDE, SIDE, 3), dtype=np.uint8)).save(d / "init.png")
    mask = np.zeros((SIDE, SIDE), np.uint8)
    mask[SIDE // 4:SIDE // 2] = 255
    Image.fromarray(mask).save(d / "mask.png")
    return dict(ckpt=str(d / "sd.ckpt"), clip=str(clip), init=str(d / "init.png"),
                mask=str(d / "mask.png"), safe=safety("safe.pt", 2.0),
                unsafe=safety("unsafe.pt", -2.0), root=d)


def _run(*argv):
    cli.main(["--device", "cpu", *map(str, argv)])


def _pngs(outdir, prefix):
    from PIL import Image

    names = sorted(f for f in os.listdir(outdir) if f.startswith(prefix) and f.endswith(".png"))
    return [np.asarray(Image.open(os.path.join(outdir, f)).convert("RGB")) for f in names]


# --------------------------------------------------------------------------- #
# the parser
# --------------------------------------------------------------------------- #


def _usage_tokens(main, argv, capsys):
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 0
    text = capsys.readouterr().out
    usage = text.split("\n\n")[0]
    return set(usage.replace("usage:", " ").split()) - {"dpm_solver_tpu", "dpm_solver_tpu_torch"}


SUBCOMMANDS = ["sample", "train", "train-ae", "train-latent", "eval", "txt2img", "img2img",
               "inpaint", "knn2img", "clscond", "fid", "wmdecode", "configs"]


@pytest.mark.parametrize("cmd", [None] + SUBCOMMANDS)
def test_parser_matches_the_jax_cli(cmd, capsys):
    from dpm_solver_tpu.cli import main as jmain

    argv = ["--help"] if cmd is None else [cmd, "--help"]
    port, jax_ = _usage_tokens(cli.main, argv, capsys), _usage_tokens(jmain, argv, capsys)
    if cmd is None:
        # the subcommands, and the one global option each has of its own
        subs = "{" + ",".join(SUBCOMMANDS) + "}"
        assert subs in port and subs in jax_
        assert port - jax_ == {"[--device", "DEVICE]"}
        assert jax_ - port == {"[--compile-cache", "COMPILE_CACHE]"}
    else:
        assert port == jax_


# --------------------------------------------------------------------------- #
# sample, train, eval
# --------------------------------------------------------------------------- #


def test_sample_writes_the_library_calls_pixels(tmp_path):
    from dpm_solver_tpu_torch.configs import get_config
    from dpm_solver_tpu_torch.data import inverse_data_transform
    from dpm_solver_tpu_torch.run_lib import _init_generator, build_model

    out = tmp_path / "out"
    _run("sample", "--config", "tiny_test", "--batch", 2, "--seed", 3, "--outdir", out)
    got = np.load(out / "sample.npz")["samples"]

    config = get_config("tiny_test")
    s = config.sampling
    net, init_fn = build_model(config, device="cpu")
    init_fn(_init_generator(config.seed, 0, "cpu"))
    ns = P.NoiseScheduleVP.discrete(betas=config.diffusion.betas())
    solver = P.DPM_Solver(P.model_wrapper(net.eval(), ns), ns, algorithm_type=s.algorithm_type)
    x_T = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = inverse_data_transform(config.data, solver.sample(
            x_T, steps=s.steps, t_start=s.t_start, t_end=s.t_end or 1e-3, order=s.order,
            skip_type=s.skip_type, method=s.method, lower_order_final=s.lower_order_final))
    np.testing.assert_array_equal(got, want.numpy())
    pixels = (want.numpy() * 255).clip(0, 255).astype(np.uint8)
    for i, png in enumerate(_pngs(out, "sample_")):
        np.testing.assert_array_equal(png, pixels[i])


def test_sample_modes_and_trace(tmp_path):
    seq, interp, tr = tmp_path / "seq", tmp_path / "interp", tmp_path / "trace"
    _run("sample", "--config", "tiny_test", "--batch", 2, "--outdir", seq, "--mode", "sequence",
         "--steps", 3)
    assert len(_pngs(seq, "seq_step")) == 2 * 4 and len(_pngs(seq, "sample_")) == 2
    _run("sample", "--config", "tiny_test", "--batch", 5, "--outdir", interp,
         "--mode", "interpolation", "--trace-dir", tr)
    assert len(_pngs(interp, "sample_")) == 5
    trace = json.loads((tr / "trace.json").read_text())
    assert any(ev.get("name", "").startswith("aten::") for ev in trace["traceEvents"])
    assert "Self CPU" in (tr / "ops.txt").read_text()
    # the PC loop (VE / NCSNv2) and the SuperRes conditioning
    pc = tmp_path / "pc"
    _run("sample", "--config", "tiny_ve_ncsnv2", "--batch", 2, "--outdir", pc)
    assert len(_pngs(pc, "sample_")) == 2
    npz = tmp_path / "base.npz"
    np.savez(npz, arr_0=np.random.default_rng(0).integers(0, 256, (4, 16, 16, 3),
                                                          dtype=np.uint8))
    _run("sample", "--config", "tiny_superres", "--batch", 2, "--base-samples", npz,
         "--outdir", tmp_path / "sr")
    assert len(_pngs(tmp_path / "sr", "sample_")) == 2
    with pytest.raises(SystemExit):
        _run("sample", "--config", "tiny_superres", "--batch", 8, "--base-samples", npz,
             "--outdir", tmp_path / "sr")
    with pytest.raises(SystemExit, match="PC loop"):
        _run("sample", "--config", "tiny_ve_ncsnv2", "--steps", 3, "--outdir", pc)


def test_sample_loads_reference_checkpoints(tmp_path):
    """A DDPM list checkpoint (its EMA shadow wins, as the reference
    samples), and a score_sde_pytorch `.pth` with its EMA shadow list."""
    from dpm_solver_tpu_torch.configs import get_config
    from dpm_solver_tpu_torch.run_lib import build_model

    config = get_config("tiny_test")
    net, _ = build_model(config, device="cpu")
    g = torch.Generator().manual_seed(5)
    raw = init_random_(net, g).state_dict()
    ema = {k: v + 0.01 for k, v in raw.items()}
    path = tmp_path / "ddpm.pth"
    torch.save([raw, {"state": {}, "param_groups": []}, 3, 100, ema], path)
    from dpm_solver_tpu_torch.utils.convert import load_torch_state_dict

    for prefer_ema, want in ((True, ema), (False, raw)):
        got = load_torch_state_dict(str(path), prefer_ema=prefer_ema)
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)
    _run("sample", "--config", "tiny_test", "--batch", 1, "--ckpt", path,
         "--outdir", tmp_path / "d")
    assert len(_pngs(tmp_path / "d", "sample_")) == 1

    from dpm_solver_tpu_torch.models import NCSNpp, NCSNppConfig

    cfg = NCSNppConfig.tiny()
    ncsn = init_random_(NCSNpp(cfg, device="cpu"), g)
    model_sd = {f"module.{k}": v for k, v in ncsn.state_dict().items()}
    trainable = [v + 1.0 for k, v in ncsn.state_dict().items() if k != "sigmas"]
    torch.save({"model": model_sd, "ema": {"shadow_params": trainable, "decay": 0.999},
                "step": 7}, tmp_path / "score.pth")
    got = cli.load_score_sde_torch_checkpoint(str(tmp_path / "score.pth"), cfg)
    names = [k for k in ncsn.state_dict() if k != "sigmas"]
    for k, v in zip(names, trainable):
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    torch.testing.assert_close(got["sigmas"], ncsn.state_dict()["sigmas"], rtol=0, atol=0)
    with pytest.raises(SystemExit, match="Flax State"):
        _run("sample", "--config", "tiny_ve_ncsnv2", "--ckpt", tmp_path / "checkpoint_5",
             "--outdir", tmp_path / "x")


def test_train_resume_eval(tmp_path):
    """tests/test_cli.py:22's cycle on the port's CLI."""
    imgs = (np.random.RandomState(0).rand(32, 16, 16, 3) * 255).astype(np.uint8)
    data = tmp_path / "data.npz"
    np.savez(data, images=imgs)
    wd = tmp_path / "wd"
    _run("train", "--config", "tiny_test", "--workdir", wd, "--data-path", data,
         "--max-steps", 3)
    assert os.listdir(wd / "checkpoints")
    _run("train", "--config", "tiny_test", "--workdir", wd, "--data-path", data,
         "--max-steps", 5)
    _run("eval", "--config", "tiny_test", "--workdir", wd, "--rounds", 1, "--data-path", data)
    samples = [f for f in os.listdir(wd / "eval") if f.startswith("samples_")]
    assert samples
    arr = np.load(wd / "eval" / samples[0])["samples"]
    assert arr.shape == (4, 16, 16, 3)
    assert np.isfinite(arr).all() and arr.min() >= 0.0 and arr.max() <= 1.0


def test_train_ae_and_train_latent(tmp_path, files):
    rng = np.random.default_rng(2)
    data = tmp_path / "ae.npz"
    np.savez(data, images=rng.integers(0, 256, (8, 16, 16, 3), dtype=np.uint8))
    snap = ["--snapshot-freq", 1, "--snapshot-freq-for-preemption", 1, "--log-freq", 1]
    _run("train-ae", "--tiny", "--kind", "kl", "--workdir", tmp_path / "ae", "--data-path", data,
         "--batch-size", 2, "--max-steps", 2, "--disc-start", 1, *snap)
    assert os.listdir(tmp_path / "ae" / "checkpoints")
    lat = tmp_path / "lat.npz"
    np.savez(lat, images=rng.uniform(-1, 1, (6, 16, 16, 3)).astype(np.float32),
             context=rng.standard_normal((6, 7, 24)).astype(np.float32))
    _run("train-latent", "--tiny", "--workdir", tmp_path / "lat", "--data-path", lat,
         "--batch-size", 2, "--max-steps", 2, *snap)
    assert os.listdir(tmp_path / "lat" / "checkpoints")
    # fine-tuning from a CompVis checkpoint (the tiny sd_v1 preset)
    big = tmp_path / "big.npz"
    np.savez(big, images=rng.uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32),
             context=rng.standard_normal((4, 7, WIDTH)).astype(np.float32))
    _run("train-latent", "--sd-ckpt", files["ckpt"], "--workdir", tmp_path / "ft",
         "--data-path", big, "--batch-size", 2, "--max-steps", 2, *snap)
    assert os.listdir(tmp_path / "ft" / "checkpoints")


# --------------------------------------------------------------------------- #
# the latent-diffusion front ends
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("quant", [None, "w8a8", "w8a8_conv"])
def test_txt2img_watermark_and_safety_then_wmdecode(tmp_path, files, quant, capsys):
    out = tmp_path / "out"
    _run("txt2img", "--ckpt", files["ckpt"], "--prompt", "a watercolour fox", "--clip",
         files["clip"], "--steps", 3, "--H", SIDE, "--W", SIDE, "--batch", 2, "--outdir", out,
         "--safety-ckpt", files["safe"], *(["--quant", quant] if quant else []))
    imgs = _pngs(out, "txt2img_")
    assert len(imgs) == 2 and imgs[0].shape == (SIDE, SIDE, 3)
    assert "replaced" not in capsys.readouterr().out
    _run("wmdecode", out / "txt2img_00000.png")
    assert capsys.readouterr().out.strip() == "StableDiffusionV1"
    if quant is None:
        # a screen that flags everything replaces every sample by zeros in
        # [-1, 1], mid-grey once mapped back (the JAX CLI's replacement)
        _run("txt2img", "--ckpt", files["ckpt"], "--prompt", "x", "--clip", files["clip"],
             "--steps", 2, "--H", SIDE, "--W", SIDE, "--batch", 2, "--outdir", tmp_path / "u",
             "--safety-ckpt", files["unsafe"], "--wm", "")
        assert "safety checker replaced 2 sample(s)" in capsys.readouterr().out
        assert all((im == 127).all() for im in _pngs(tmp_path / "u", "txt2img_"))
        with pytest.raises(SystemExit, match="--clip"):
            _run("txt2img", "--ckpt", files["ckpt"], "--prompt", "x",
                 "--safety-ckpt", files["safe"])


def test_img2img_inpaint_clscond_knn2img(tmp_path, files):
    common = ["--ckpt", files["ckpt"], "--prompt", "a lighthouse", "--clip", files["clip"],
              "--steps", 4, "--batch", 2]
    _run("img2img", *common, "--init-img", files["init"], "--strength", 0.5,
         "--outdir", tmp_path / "i2i")
    _run("inpaint", *common, "--init-img", files["init"], "--mask", files["mask"],
         "--outdir", tmp_path / "inp")
    for name in ("i2i", "inp"):
        imgs = _pngs(tmp_path / name, "img2img_" if name == "i2i" else "inpaint_")
        assert len(imgs) == 2 and imgs[0].shape == (SIDE, SIDE, 3)
    # inpainting keeps the unmasked rows of the init image (up to PNG rounding)
    from PIL import Image

    init = np.asarray(Image.open(files["init"]).convert("RGB")).astype(int)
    got = _pngs(tmp_path / "inp", "inpaint_")[0].astype(int)
    assert np.abs(got[SIDE // 2:] - init[SIDE // 2:]).max() <= 1
    _run("clscond", "--ckpt", files["ckpt"], "--classes", "3,7,1", "--num-classes", 10,
         "--embed-dim", WIDTH, "--steps", 3, "--outdir", tmp_path / "cls")
    assert len(_pngs(tmp_path / "cls", "clscond_")) == 3
    db = tmp_path / "db.npz"
    emb = np.random.default_rng(4).standard_normal((20, WIDTH)).astype(np.float32)
    np.savez(db, embedding=emb / np.linalg.norm(emb, axis=1, keepdims=True))
    _run("knn2img", "--ckpt", files["ckpt"], "--prompt", "a harbour", "--clip", files["clip"],
         "--database", db, "--knn", 2, "--steps", 3, "--H", 64, "--W", 64, "--batch", 2,
         "--outdir", tmp_path / "knn")
    assert _pngs(tmp_path / "knn", "knn2img_")[1].shape == (64, 64, 3)


def test_fid_prints_calculate_fid_given_paths(tmp_path, capsys):
    from PIL import Image

    from dpm_solver_tpu_torch.eval.fid import calculate_fid_given_paths
    from dpm_solver_tpu_torch.eval.inception import make_feature_fn, random_feature_params

    sd = random_feature_params(3)
    torch.save(sd, tmp_path / "inception.pt")
    rng = np.random.default_rng(6)
    for name in ("a", "b"):
        (tmp_path / name).mkdir()
        for i in range(2):
            Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(
                tmp_path / name / f"{i}.png")
    _run("fid", tmp_path / "a", tmp_path / "b", "--inception-ckpt", tmp_path / "inception.pt",
         "--batch-size", 2)
    got = float(capsys.readouterr().out.strip().splitlines()[-1])
    want = calculate_fid_given_paths([str(tmp_path / "a"), str(tmp_path / "b")],
                                     make_feature_fn(sd, device="cpu"), batch_size=2)
    assert got == want and np.isfinite(got)


def test_configs_lists_the_registry(capsys):
    from dpm_solver_tpu_torch.configs import list_configs

    _run("configs")
    assert capsys.readouterr().out.split() == list_configs()


def test_device_and_devices_errors(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["sample", "--config", "tiny_test", "--outdir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--device", "cuda", "fid", "a", "b", "--inception-ckpt", "x"])
    # --devices N shards the batch over N ranks: the batch must divide, and
    # on the card N may not pass the visible cards (both counts named)
    with pytest.raises(SystemExit, match="--batch 3 not divisible by --devices 2"):
        _run("sample", "--config", "tiny_test", "--batch", 3, "--devices", 2, "--outdir", tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--devices 2 but only 1 visible card"):
        cli.main(["--device", "cuda", "sample", "--config", "tiny_test", "--batch", "4",
                  "--devices", "2", "--outdir", str(tmp_path)])


def test_module_entry_point():
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for mod in ("dpm_solver_tpu_torch.cli", "dpm_solver_tpu_torch"):
        res = subprocess.run([sys.executable, "-m", mod, "--device", "cpu", "configs"],
                             cwd=root, capture_output=True, text=True, timeout=120)
        assert res.returncode == 0 and "tiny_test" in res.stdout.split()
    assert re.search(r"txt2img", subprocess.run(
        [sys.executable, "-m", "dpm_solver_tpu_torch.cli", "--help"], cwd=root,
        capture_output=True, text=True, timeout=120).stdout)
