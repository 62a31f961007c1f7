"""The port stands alone, and its kernel wrappers hide no device.

- An AST scan: no file under dpm_solver_tpu_torch/ (the training package,
  configs.py, run_lib.py, data.py, native/, utils/lmdb*.py, the CLI, the
  int8 path and the host utilities among them),
  and not chip_smoke.py, imports jax, flax, optax, orbax or dpm_solver_tpu
  (a `sys.modules` check cannot show it: the test process imports jax
  anyway), nor tensorflow (not even inside a function), transformers,
  regex, ftfy or safetensors: the port depends on PyTorch alone.
- On the CPU every wrapper takes its plain version and launches nothing:
  the launch counters stay at 0 through a whole tiny sampling run, a tiny
  txt2img run, a tiny classifier-guided run (whose backward takes the
  plain twins of the dq, dk/dv and conv3x3-dx kernels), tiny NCSN++
  runs of the singlestep and adaptive solvers, a tiny bits/dim and
  black-box ODE sampler run, tiny first-stage training runs (KL and VQ) and
  a tiny evaluation (a DPM-Solver sampling hook and the FID Inception),
  and a tiny `run_lib.train` fed by `data.make_dataset`.
- The models and the pipeline default to the card: with no card, a
  constructor without `device=` raises and never falls back to the CPU.
- The wrappers' input checks, which guard the CUDA launches, refuse what the
  kernels do not take (they run on tensors of any device).
"""

import ast
import importlib
import pathlib

import numpy as np
import pytest
import torch

import dpm_solver_tpu_torch as P
from dpm_solver_tpu_torch import ops
from dpm_solver_tpu_torch.models import (ADMClassifier, ADMConfig, ADMUNet, AutoencoderKL,
                                         BERTEmbedder, ClassEmbedder, DDPMUNet, DDPMUNetConfig,
                                         NCSNpp, NCSNppConfig, SpatialRescaler,
                                         SpatialTransformer, VAEConfig, VQModel,
                                         constant_context_encoder, init_random_)
from dpm_solver_tpu_torch.eval.inception import FIDInceptionV3
from dpm_solver_tpu_torch.models.discriminator import NLayerDiscriminator
from dpm_solver_tpu_torch.models.lpips import LPIPS
from dpm_solver_tpu_torch.score import get_noise_fn
from dpm_solver_tpu_torch.sde import VPSDE
from dpm_solver_tpu_torch.pipelines import (LatentDiffusion, StableDiffusionPipeline,
                                            load_sd_checkpoint)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these tiny CPU runs (they check launch
    counts, not values): the suite runs several workers at once, and a
    host loop of small ops slows most under oversubscribed thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the modules themselves: `ops` re-exports functions of the same names
attention, conv3x3, fused_update, geglu, ln_linear = (
    importlib.import_module(f"dpm_solver_tpu_torch.ops.{m}")
    for m in ("attention", "conv3x3", "fused_update", "geglu", "ln_linear"))

PKG = pathlib.Path(P.__file__).resolve().parent
CHIP_SMOKE = PKG.parent / "chip_smoke.py"
NO_LAUNCHES = {"conv3x3": 0, "token_attention": 0, "fused_update": 0, "ln_linear": 0,
               "geglu_ff": 0, "attention_lse": 0, "attention_dq": 0, "attention_dkv": 0,
               "conv3x3_dx": 0, "fused_bias_act": 0, "fused_bias_act_bwd": 0,
               "attention_out_fused": 0}
# jax and the JAX package, and the JAX training stack (the port's optimisers
# and checkpoints are its own); tensorflow, whose tf.data the port's readers
# replace; and the packages the port replaces with its own CLIP, tokenizer
# and checkpoint reading (torch.load), so that it needs PyTorch alone
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "dpm_solver_tpu", "tensorflow",
             "transformers", "regex", "ftfy", "safetensors")
SCANNED = sorted(PKG.rglob("*.py")) + [CHIP_SMOKE]


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SCANNED, ids=lambda p: str(p.relative_to(PKG.parent)))
def test_port_never_imports_jax(path):
    roots = set(_imported_roots(ast.parse(path.read_text(), str(path))))
    assert not roots & set(FORBIDDEN), f"{path} imports {roots & set(FORBIDDEN)}"


def test_the_data_path_is_scanned():
    """The data path's modules are among the files the scan reads (a
    function-level `import tensorflow` among them would fail it)."""
    names = {str(p.relative_to(PKG)) for p in SCANNED if PKG in p.parents}
    assert {"data.py", "native/__init__.py", "native/build.py", "utils/lmdb.py",
            "utils/lmdb_native.py", "eval/fid.py"} <= names
    lazy = ast.parse("def f():\n    import tensorflow as tf\n")
    assert "tensorflow" in set(_imported_roots(lazy))


def test_the_cli_and_serving_modules_are_scanned():
    """The CLI, the int8 path and the host utilities are among the files the
    scan reads: they import torch, numpy, scipy, cv2 and PIL, never the JAX
    package, whose numpy-only twins (safety, watermark, degradation,
    ckpt_util) they copy rather than import."""
    names = {str(p.relative_to(PKG)) for p in SCANNED if PKG in p.parents}
    assert {"cli.py", "__main__.py", "ops/quant.py", "utils/ckpt_util.py", "utils/safety.py",
            "utils/watermark.py", "utils/degradation.py"} <= names
    lazy = ast.parse("def f():\n    from dpm_solver_tpu.utils import watermark\n")
    assert "dpm_solver_tpu" in set(_imported_roots(lazy))


def test_the_parallel_dryrun_and_demo_modules_are_scanned():
    """The parallel package, the dry runs and the demos are among the files
    the scan reads: they import torch and torch.distributed, never jax,
    flax or the JAX package (`__graft_entry__.py` and `examples/` stay the
    JAX package's own)."""
    names = {str(p.relative_to(PKG)) for p in SCANNED if PKG in p.parents}
    assert {"parallel/__init__.py", "parallel/mesh.py", "parallel/rng.py",
            "parallel/multihost.py", "parallel/tp.py", "parallel/zero.py",
            "parallel/launch.py", "utils/graphs.py", "dryrun.py",
            "examples/score_sde_demo.py", "examples/latent_imagenet_demo.py",
            "examples/diffedit_demo.py"} <= names


@pytest.mark.parametrize("quant", ["w8a8", "w8a8_conv"])
def test_cpu_quant_txt2img_launches_nothing(quant):
    """The int8 serving path on the CPU: the transformer stack's products
    are int8 library calls and the other wrappers take their plain twins."""
    ucfg = ADMConfig(image_size=8, in_channels=4, model_channels=32, out_channels=4,
                     num_res_blocks=1, attention_resolutions=(1, 2), channel_mult=(1, 2),
                     num_heads=2, use_spatial_transformer=True, context_dim=24, quant=quant)
    g = torch.Generator().manual_seed(0)
    unet = init_random_(ADMUNet(ucfg, device="cpu"), g).eval()
    vae = init_random_(AutoencoderKL(VAEConfig.tiny(resolution=16, quant=quant), device="cpu"),
                       g).eval()
    pipe = StableDiffusionPipeline(
        LatentDiffusion(unet, vae, text_encode=constant_context_encoder(24)), device="cpu")
    ops.reset_launch_counts()
    img = pipe.txt2img(["a", "b"], steps=2, height=16, width=16,
                       generator=torch.Generator().manual_seed(1))
    assert img.shape == (2, 16, 16, 3) and torch.isfinite(img).all()
    assert ops.launch_counts() == NO_LAUNCHES


def test_cpu_run_takes_plain_path_and_launches_nothing():
    ops.reset_launch_counts()
    net = init_random_(DDPMUNet(DDPMUNetConfig.tiny(resolution=8), device="cpu"),
                       torch.Generator().manual_seed(0)).eval()
    ns = P.NoiseScheduleVP.discrete(betas=np.linspace(1e-4, 0.02, 1000))
    solver = P.DPM_Solver(P.model_wrapper(net, ns), ns, algorithm_type="dpmsolver++")
    with torch.no_grad():
        out = solver.sample(torch.randn(1, 8, 8, 3, generator=torch.Generator().manual_seed(1)),
                            steps=3, order=3, skip_type="logSNR", method="multistep")
    assert out.shape == (1, 8, 8, 3) and torch.isfinite(out).all()
    assert ops.launch_counts() == NO_LAUNCHES


def test_cpu_txt2img_takes_plain_path_and_launches_nothing():
    """The SD path runs every kernel of the port: on the CPU, none launches."""
    ucfg = ADMConfig(image_size=8, in_channels=4, model_channels=32, out_channels=4,
                     num_res_blocks=1, attention_resolutions=(1, 2), channel_mult=(1, 2),
                     num_heads=-1, num_head_channels=16, use_spatial_transformer=True,
                     context_dim=24, use_linear_in_transformer=True, legacy=False)
    g = torch.Generator().manual_seed(0)
    unet = init_random_(ADMUNet(ucfg, device="cpu"), g).eval()
    vae = init_random_(AutoencoderKL(VAEConfig.tiny(resolution=16), device="cpu"), g).eval()
    pipe = StableDiffusionPipeline(
        LatentDiffusion(unet, vae, text_encode=constant_context_encoder(24),
                        parameterization="v"), device="cpu")
    ops.reset_launch_counts()
    img = pipe.txt2img(["a", "b"], steps=2, height=16, width=16,
                       generator=torch.Generator().manual_seed(1))
    assert img.shape == (2, 16, 16, 3) and torch.isfinite(img).all()
    assert ops.launch_counts() == NO_LAUNCHES


def test_cpu_ldm_surface_takes_plain_path_and_launches_nothing(tmp_path):
    """img2img, inpaint, the VQ first stage, class-conditional sampling and
    the BERT and CLIP conditioners: on the CPU, no kernel launches."""
    from dpm_solver_tpu_torch.models import BERTEmbedder, ClassEmbedder, VQModel
    from dpm_solver_tpu_torch.pipelines import class_conditional_sample

    g = torch.Generator().manual_seed(0)
    ucfg = ADMConfig(image_size=8, in_channels=3, model_channels=32, out_channels=3,
                     num_res_blocks=1, attention_resolutions=(1, 2), channel_mult=(1, 2),
                     num_heads=1, use_spatial_transformer=True, context_dim=16)
    vq = VQModel(VAEConfig.tiny(ch_mult=(1, 2), z_channels=3, embed_dim=3, double_z=False,
                                resolution=16, attn_resolutions=()), n_embed=32, device="cpu")
    ldm = LatentDiffusion(init_random_(ADMUNet(ucfg, device="cpu"), g).eval(),
                          init_random_(vq, g).eval(), text_encode=constant_context_encoder(16),
                          scale_factor=1.0)
    pipe = StableDiffusionPipeline(ldm, device="cpu")
    image = torch.rand(2, 16, 16, 3, generator=g) * 2 - 1
    ops.reset_launch_counts()
    out = [pipe.img2img(image, ["a", "b"], steps=3, generator=g),
           pipe.inpaint(image, (torch.rand(2, 16, 16, generator=g) > 0.5).float(), ["a", "b"],
                        steps=2, generator=g),
           class_conditional_sample(ldm, ClassEmbedder(5, 16, device="cpu"), [1, 2], steps=2,
                                    guidance_scale=2.0, uncond_label=4, generator=g)]
    with torch.no_grad():
        bert = BERTEmbedder(64, 1, vocab_size=50, device="cpu")(torch.tensor([[1, 2, 3]]))
    assert all(o.shape == (2, 16, 16, 3) and torch.isfinite(o).all() for o in out)
    assert bert.shape == (1, 3, 64)
    assert ops.launch_counts() == NO_LAUNCHES


def test_cpu_guided_run_takes_plain_path_and_launches_nothing():
    """Classifier guidance differentiates the classifier every NFE: on the
    CPU its forward and backward launch nothing."""
    g = torch.Generator().manual_seed(0)
    kw = dict(image_size=8, model_channels=32, num_res_blocks=1, attention_resolutions=(2,),
              channel_mult=(1, 2), num_head_channels=16, use_scale_shift_norm=True,
              resblock_updown=True)
    unet = init_random_(ADMUNet(ADMConfig(**kw, out_channels=6, num_classes=4), device="cpu"),
                        g).eval()
    clf = init_random_(ADMClassifier(ADMConfig(**kw, out_channels=4, pool="attention"),
                                     device="cpu"), g).eval().requires_grad_(False)
    y = torch.tensor([1, 3])
    ns = P.NoiseScheduleVP.discrete(betas=np.linspace(1e-4, 0.02, 1000))
    log_prob = lambda x, t, c: torch.log_softmax(clf(x, t), -1)[torch.arange(2), c]
    model_fn = P.model_wrapper(lambda x, t: unet(x, t, y)[..., :3], ns, condition=y,
                               guidance_type="classifier", guidance_scale=8.0,
                               classifier_fn=log_prob)
    ops.reset_launch_counts()
    with torch.no_grad():
        out = P.build_sampler(model_fn, ns, steps=2, order=2, method="multistep")(
            torch.randn(2, 8, 8, 3, generator=g))
    assert out.shape == (2, 8, 8, 3) and torch.isfinite(out).all()
    assert ops.launch_counts() == NO_LAUNCHES


@pytest.mark.parametrize("method", ["singlestep", "adaptive"])
def test_cpu_ncsnpp_run_takes_plain_path_and_launches_nothing(method):
    """Slice D: continuous VP, labels t*999, singlestep order 3 or adaptive."""
    cfg = NCSNppConfig.tiny(fir=True, progressive_input="residual", num_res_blocks=1,
                            image_size=8, attn_resolutions=(4,))
    net = init_random_(NCSNpp(cfg, device="cpu"), torch.Generator().manual_seed(0)).eval()
    ns = VPSDE().to_noise_schedule()
    solver = P.DPM_Solver(P.model_wrapper(get_noise_fn(VPSDE(), net), ns), ns)
    ops.reset_launch_counts()
    with torch.no_grad():
        out = solver.sample(torch.randn(2, 8, 8, 3, generator=torch.Generator().manual_seed(1)),
                            steps=3, order=3, method=method, skip_type="logSNR", t_end=1e-3)
    assert out.shape == (2, 8, 8, 3) and torch.isfinite(out).all()
    assert ops.launch_counts() == NO_LAUNCHES


def test_cpu_likelihood_and_ode_sampler_launch_nothing():
    """Bits/dim differentiates the network at every stage (its backward takes
    the plain twins of the dq, dk/dv and conv3x3-dx kernels on the CPU), and
    the black-box ODE sampler runs it forward: on the CPU neither launches."""
    from dpm_solver_tpu_torch.likelihood import get_likelihood_fn, ode_sampler
    from dpm_solver_tpu_torch.score import get_score_fn

    cfg = NCSNppConfig.tiny(conditional=False, num_res_blocks=1, image_size=8,
                            attn_resolutions=(4,))
    net = init_random_(NCSNpp(cfg, device="cpu"), torch.Generator().manual_seed(0)).eval()
    score = get_score_fn(VPSDE(), net.requires_grad_(False))
    x = torch.rand(1, 8, 8, 3, generator=torch.Generator().manual_seed(1)) * 2 - 1
    ops.reset_launch_counts()
    bpd, z, nfe = get_likelihood_fn(VPSDE(), score, rtol=1e-3, atol=1e-3)(
        x, generator=torch.Generator().manual_seed(2))
    xs, nfe_s = ode_sampler(VPSDE(), score, (1, 8, 8, 3), rtol=1e-3, atol=1e-3,
                            generator=torch.Generator().manual_seed(3), device="cpu")
    assert bpd.shape == (1,) and torch.isfinite(bpd).all() and z.shape == x.shape
    assert xs.shape == x.shape and torch.isfinite(xs).all() and nfe > 6 and nfe_s > 6
    assert ops.launch_counts() == NO_LAUNCHES


@pytest.mark.parametrize("kind", ["kl", "vq"])
def test_cpu_first_stage_training_launches_nothing(kind, tmp_path):
    """First-stage adversarial training: the VAE's forward and backward (its
    conv3x3, conv3x3-dx and attention forward and backward), LPIPS and the
    discriminator, both optimiser passes: on the CPU no kernel launches."""
    from dpm_solver_tpu_torch import run_lib
    from dpm_solver_tpu_torch.training.perceptual import KLLossConfig, VQLossConfig

    cfg = VAEConfig.tiny(resolution=16) if kind == "kl" else VAEConfig.tiny(
        resolution=16, double_z=False, z_channels=3, embed_dim=3)
    rng = np.random.default_rng(0)
    batches = (rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32) for _ in range(2))
    ops.reset_launch_counts()
    state = run_lib.train_autoencoder(
        batches, workdir=str(tmp_path), kind=kind, vae_config=cfg, n_embed=16,
        loss_config=(KLLossConfig if kind == "kl" else VQLossConfig)(perceptual_weight=0.5),
        disc_ndf=8, disc_n_layers=2, max_steps=2, log_freq=10, device="cpu")
    assert state.step == 2
    assert all(torch.isfinite(p).all() for p in state.gen_params.values())
    assert ops.launch_counts() == NO_LAUNCHES


def test_cpu_evaluation_launches_nothing(tmp_path):
    """`run_lib.evaluate` with a DPM-Solver sampling hook on the EMA
    parameters and the FID Inception's features: on the CPU no kernel
    launches."""
    import dataclasses

    from dpm_solver_tpu_torch import configs, run_lib
    from dpm_solver_tpu_torch.eval.inception import make_feature_fn, random_feature_params
    from dpm_solver_tpu_torch.training.checkpoints import CheckpointManager
    from dpm_solver_tpu_torch.training.train import make_train_state

    cfg = configs.get_config("tiny_test")
    cfg = dataclasses.replace(cfg, workdir=str(tmp_path))
    net, init_fn = run_lib.build_model(cfg, device="cpu")
    init_fn(torch.Generator().manual_seed(0))
    state, _ = make_train_state(net)
    CheckpointManager(str(tmp_path / "checkpoints")).save(2, state)
    ns = P.NoiseScheduleVP.discrete(betas=cfg.diffusion.betas())
    features = make_feature_fn(random_feature_params(0), device="cpu")

    def sample_fn(st, generator):
        net.load_state_dict(st.ema_params, strict=False)
        x = torch.randn(2, 16, 16, 3, generator=generator)
        with torch.no_grad():
            return P.DPM_Solver(P.model_wrapper(net.eval(), ns), ns).sample(
                x, steps=2, order=2, method="multistep").clamp(-1, 1) * 0.5 + 0.5

    ops.reset_launch_counts()
    res = run_lib.evaluate(cfg, sample_fn=sample_fn, feature_fn=features, rounds=1,
                           device="cpu")
    assert list(res) == [2] and np.isfinite(res[2]["inception_score"])
    assert ops.launch_counts() == NO_LAUNCHES


def test_cpu_training_fed_by_make_dataset_launches_nothing(tmp_path):
    """`run_lib.train` on tiny_test fed by `make_dataset`'s [devices,
    per_device, H, W, C] batches (one device): each reaches the step through
    `_tensor` and the reshape, and on the CPU no kernel launches."""
    import dataclasses

    from dpm_solver_tpu_torch import configs, run_lib
    from dpm_solver_tpu_torch.data import make_dataset

    cfg = configs.get_config("tiny_test")
    cfg = dataclasses.replace(cfg, workdir=str(tmp_path))
    images = np.random.default_rng(0).integers(0, 256, (20, 16, 16, 3), dtype=np.uint8)
    seen = []

    def batches():
        for b in make_dataset(images, batch_size=cfg.training.batch_size,
                              centered=cfg.data.centered):
            seen.append(b.shape)
            yield b

    ops.reset_launch_counts()
    state = run_lib.train(cfg, batches(), max_steps=2, device="cpu")
    assert state.step == 2 and seen[:2] == [(1, 8, 16, 16, 3)] * 2
    assert all(torch.isfinite(p).all() for p in state.params.values())
    assert ops.launch_counts() == NO_LAUNCHES


@pytest.mark.parametrize("build", [
    lambda: NCSNpp(NCSNppConfig.tiny()),
    lambda: DDPMUNet(DDPMUNetConfig.tiny(resolution=8)),
    lambda: ADMUNet(ADMConfig.tiny()),
    lambda: ADMClassifier(ADMConfig.tiny(pool="attention", num_head_channels=16)),
    lambda: AutoencoderKL(VAEConfig.tiny()),
    lambda: SpatialTransformer(32, 2, 16, context_dim=24),
    lambda: StableDiffusionPipeline(LatentDiffusion(
        ADMUNet(ADMConfig.tiny(), device="cpu"), AutoencoderKL(VAEConfig.tiny(), device="cpu"))),
    lambda: VQModel(VAEConfig.tiny(double_z=False)),
    lambda: BERTEmbedder(64, 1),
    lambda: ClassEmbedder(10, 8),
    lambda: SpatialRescaler(out_channels=4),
    lambda: load_sd_checkpoint({"model.diffusion_model.x": torch.zeros(1)},
                               unet_config=ADMConfig.tiny()),
    lambda: LPIPS(),
    lambda: NLayerDiscriminator(8, 2),
    lambda: FIDInceptionV3(),
], ids=["NCSNpp", "DDPMUNet", "ADMUNet", "ADMClassifier", "AutoencoderKL", "SpatialTransformer",
        "StableDiffusionPipeline", "VQModel", "BERTEmbedder", "ClassEmbedder", "SpatialRescaler",
        "load_sd_checkpoint", "LPIPS", "NLayerDiscriminator", "FIDInceptionV3"])
def test_default_device_is_the_card_and_raises_without_one(build, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()


def test_conv3x3_checks_refuse_what_the_kernel_does_not_take():
    x, w, b = torch.zeros(1, 4, 4, 8), torch.zeros(3, 3, 8, 16), torch.zeros(16)
    conv3x3._check(x, w, b)
    with pytest.raises(TypeError):
        conv3x3._check(x.half(), w.half(), b)
    with pytest.raises(TypeError):
        conv3x3._check(x, w.bfloat16(), b)
    with pytest.raises(ValueError):
        conv3x3._check(x.transpose(1, 2), w, b)          # not contiguous
    with pytest.raises(ValueError):
        conv3x3._check(x, torch.zeros(3, 3, 4, 16), b)   # channel mismatch
    with pytest.raises(ValueError):
        conv3x3._check(x, w, b.bfloat16())              # bias must be fp32
    with pytest.raises(ValueError):
        conv3x3._check(x, torch.zeros(1, 1, 8, 16), b)   # not 3x3


def test_attention_checks_refuse_what_the_kernel_does_not_take():
    q = torch.zeros(2, 16, 256)
    attention._check(q, q, q, 1)
    attention._check(q, q, q, 8)                         # dh = 32
    attention._check(q, q, q, 2)                         # dh = 128
    u = torch.zeros(2, 16, 80)
    attention._check(u, u, u, 2)                         # dh = 40 (SD-1)
    attention._check(u, u, u, 1)                         # dh = 80
    with pytest.raises(ValueError, match="head dims"):
        attention._check(u, u, u, 5)                     # dh = 16: no tile for it
    with pytest.raises(TypeError):
        attention._check(q.half(), q.half(), q.half(), 1)
    with pytest.raises(ValueError):
        attention._check(q, q[:, :0], q[:, :0], 1)       # no keys
    with pytest.raises(ValueError):
        attention._check(q[:, :, ::2].contiguous(), q, q, 1)
    qb = q.bfloat16()
    attention._check(qb, qb, qb, 1)
    shifted = torch.zeros(qb.numel() + 1, dtype=torch.bfloat16)[1:].view(qb.shape)
    with pytest.raises(ValueError, match="aligned"):
        attention._check(shifted, qb, qb, 1)                 # 2-byte offset


def test_attention_backward_checks_refuse_what_the_kernels_do_not_take():
    q = torch.zeros(2, 16, 128)
    attention._check_bwd(q, q, q, q, 2)                      # dh = 64
    attention._check_bwd(q, q, q, q, 4)                      # dh = 32
    w = torch.zeros(2, 16, 512)
    assert attention._check_bwd(w, w, w, w, 1).route == "f32"           # dh = 512, fp32
    wb = w.bfloat16()
    assert attention._check_bwd(wb, wb, wb, wb, 1).route == "wgmma"     # dh = 512, bf16
    u = torch.zeros(2, 16, 96)
    with pytest.raises(ValueError, match="head dims"):
        attention._check_bwd(u, u, u, u, 2)                  # dh = 48: no kernel takes it
    with pytest.raises(ValueError, match="cotangent"):
        attention._check_bwd(q, q, q, q.bfloat16(), 2)       # cotangent dtype
    with pytest.raises(ValueError, match="cotangent"):
        attention._check_bwd(q, q, q, q[:, :8], 2)           # cotangent shape
    with pytest.raises(ValueError, match="cotangent"):
        attention._check_bwd(q, q, q, q.transpose(0, 1).contiguous().transpose(0, 1), 2)


def test_ln_linear_checks_refuse_what_the_kernel_does_not_take():
    x, g, w, c = torch.zeros(8, 32), torch.ones(32), torch.zeros(96, 32), torch.zeros(96)
    ln_linear._check(x, g, g, w, c)
    ln_linear._check(x, g, g, w, None)                   # bias is optional
    with pytest.raises(ValueError):
        ln_linear._check(x, g, g, torch.zeros(96, 16), c)     # d mismatch
    with pytest.raises(TypeError):
        ln_linear._check(x, g, g, w.bfloat16(), c)            # mixed dtypes
    with pytest.raises(TypeError):
        ln_linear._check(x.half(), g, g, w.half(), c)
    with pytest.raises(ValueError):
        ln_linear._check(x, g.bfloat16(), g, w, c)            # gamma must be fp32
    with pytest.raises(ValueError):
        ln_linear._check(x, g, g, w, c[:48])                  # bias shape
    with pytest.raises(ValueError):
        ln_linear._check(x, g, g, torch.zeros(32, 96).t(), c)  # w not contiguous
    big = torch.zeros(1, ln_linear.MAX_D + 8)
    with pytest.raises(ValueError, match="d <="):
        ln_linear._check(big, torch.ones(big.shape[1]), torch.ones(big.shape[1]),
                         torch.zeros(8, big.shape[1]), None)


def test_geglu_checks_refuse_what_the_kernel_does_not_take():
    x, w1, b1 = torch.zeros(8, 32), torch.zeros(256, 32), torch.zeros(256)
    w2, b2 = torch.zeros(32, 128), torch.zeros(32)
    geglu._check(x, w1, b1, w2, b2)
    with pytest.raises(ValueError):
        geglu._check(x, torch.zeros(128, 32), b1, w2, b2)     # w1 not (2 * inner, d)
    with pytest.raises(ValueError):
        geglu._check(x, w1, b1, torch.zeros(16, 128), b2)     # w2 not (d, inner)
    with pytest.raises(TypeError):
        geglu._check(x.bfloat16(), w1, b1, w2, b2)           # mixed dtypes
    with pytest.raises(ValueError):
        geglu._check(x, w1, b1.bfloat16(), w2, b2)           # b1 must be fp32
    with pytest.raises(ValueError):
        geglu._check(x, torch.zeros(32, 256).t(), b1, w2, b2)  # w1 not contiguous


def test_attention_reads_fused_qkv_slices_in_place():
    qkv = torch.zeros(2, 16, 3 * 512)
    q, k, v = qkv.split(512, dim=-1)
    attention._check(q, k, v, 1)                         # dh = 512, token stride 3C
    qb, kb, vb = qkv.bfloat16().split(512, dim=-1)
    attention._check(qb, kb, vb, 1)
    odd = torch.zeros(2, 16, 3 * 512 + 1, dtype=torch.bfloat16)[:, :, :512]
    with pytest.raises(ValueError, match="aligned"):
        attention._check(odd, odd, odd, 1)               # token stride not a multiple of 8


def test_fused_update_checks_refuse_what_the_kernel_does_not_take():
    coef, x = torch.zeros(3, 8), torch.zeros(2, 5)
    fused_update._check(coef, 2, x, (x, x, x), x)
    with pytest.raises(IndexError):
        fused_update._check(coef, 3, x, (x, x, x), None)
    with pytest.raises(ValueError):
        fused_update._check(coef.double(), 0, x, (x, x, x), None)
    with pytest.raises(ValueError):
        fused_update._check(coef, 0, x.bfloat16(), (x, x, x), None)
    with pytest.raises(ValueError):
        fused_update._check(coef, 0, x, (x, x, torch.zeros(5, 2).t()), None)
    with pytest.raises(ValueError):
        fused_update._check(coef[:, ::2], 0, x, (x, x, x), None)  # 4 columns


def test_wrappers_refuse_other_devices():
    meta = torch.zeros(1, 4, 4, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.conv3x3(meta, torch.zeros(3, 3, 8, 8, device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.token_attention(meta[0], meta[0], meta[0], num_heads=1)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.attention_lse(meta[0], meta[0], meta[0], num_heads=1)
    row = torch.zeros(4, 4, device="meta")
    for fn in (ops.attention_dq, ops.attention_dkv):
        with pytest.raises(ValueError, match="cpu or cuda"):
            fn(meta[0], meta[0], meta[0], meta[0], row, row, num_heads=1, scale=0.5)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.conv3x3_dx(meta, torch.zeros(3, 3, 8, 8, device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.fused_update(torch.zeros(1, 8, device="meta"), 0, meta, meta, meta, meta)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.ln_linear(meta[0], meta[0, 0, 0], meta[0, 0, 0], torch.zeros(8, 8, device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.geglu_ff(meta[0], torch.zeros(16, 8, device="meta"), torch.zeros(16, device="meta"),
                     torch.zeros(8, 8, device="meta"), meta[0, 0, 0])
