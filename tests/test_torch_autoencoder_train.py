"""The port's first-stage adversarial training (dpm_solver_tpu_torch/
training/autoencoder.py, run_lib.train_autoencoder) against the JAX
package's, on the CPU.

- Three KL and three VQ steps (`VAEConfig.tiny(resolution=16)`: attention at
  16 px and in the middle; LPIPS at 16 px in the KL loss (`LOSS` says why
  not in the VQ one); `NLayerDiscriminator(8, 2)` with
  BatchNorm; disc_start 1, so step 0 has no adversarial term and steps 1-2
  have it and the adaptive weight): each port step starts from the JAX
  state before it, carried across by `adversarial_state_from_flax`, and is
  fed the JAX step's own posterior draw. After each step every autoencoder
  parameter, logvar, both Adam states (mu, and nu as sqrt(nu): the
  gradient's units), the discriminator's
  parameters and BatchNorm statistics, and every log agree with the JAX
  jitted step in fp32 within 1e-5 of the tree's max (each log of its own
  magnitude). Leaves whose gradient is 0 by construction (key biases; a
  per-channel constant before a GroupNorm of one channel a group: the
  tiny config's 32-channel level) get Adam updates of rounding noise on
  both sides, each at most a few lr: they are held within 4 lr of the JAX
  value instead.
- `train_autoencoder` restarted from its meta checkpoint ends bitwise equal
  to an uninterrupted run (KL and VQ), and writes input | reconstruction
  grids at `image_freq` (PNG, or `.npy` where PIL does not import).
"""

import builtins
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu.models.discriminator import NLayerDiscriminator as JDisc
from dpm_solver_tpu.models.lpips import LPIPS as JLPIPS
from dpm_solver_tpu.models.vae import AutoencoderKL as JKL
from dpm_solver_tpu.models.vae import VAEConfig as JVAEConfig
from dpm_solver_tpu.models.vae import VQModel as JVQ
from dpm_solver_tpu.training import autoencoder as jae
from dpm_solver_tpu.training import perceptual as JP
from dpm_solver_tpu_torch import run_lib
from dpm_solver_tpu_torch.models import AutoencoderKL, VAEConfig, VQModel
from dpm_solver_tpu_torch.models.discriminator import NLayerDiscriminator
from dpm_solver_tpu_torch.models.lpips import LPIPS
from dpm_solver_tpu_torch.training import autoencoder as pae
from dpm_solver_tpu_torch.training import perceptual as PP
from dpm_solver_tpu_torch.utils import convert as C


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's CPU work: these small shapes gain
    nothing from more, and the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LR, STEPS, N_EMBED, BOUND = 4.5e-6, 3, 32, 1e-5
CFG = {"kl": dict(resolution=16), "vq": dict(resolution=16, double_z=False, z_channels=3,
                                             embed_dim=3)}
# the VQ steps without LPIPS: its encoder's gradient reaches LPIPS's ReLUs
# through the straight-through estimator, and at these random weights a
# relative change of 1e-6 in the input moves that gradient by 3e-3 of its max
# (a ReLU's pre-activation crossing 0), 1e-7 by 1e-5: fp32 rounding alone can
# cross the bound. LPIPS's own value and gradient are held to JAX in
# tests/test_torch_lpips.py, and through the KL steps here.
LOSS = {"kl": dict(disc_start=1, kl_weight=1e-3, perceptual_weight=0.5),
        "vq": dict(disc_start=1, perceptual_weight=0.0)}


@pytest.fixture(scope="module", params=["kl", "vq"])
def pair(request):
    kind = request.param
    jc, pc = JVAEConfig.tiny(**CFG[kind]), VAEConfig.tiny(**CFG[kind])
    x = np.random.default_rng(0).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    xj, key = jnp.asarray(x), jax.random.PRNGKey(0)
    if kind == "kl":
        jm = JKL(jc)
        ae = jax.jit(lambda: jm.init(key, xj, key))()["params"]
        pm = AutoencoderKL(pc, device="cpu")
        to_sd = lambda p: C.autoencoder_kl_state_dict_from_flax(p, pc)  # noqa: E731
    else:
        jm = JVQ(jc, n_embed=N_EMBED)
        ae = jax.jit(lambda: jm.init(key, xj))()["params"]
        pm = VQModel(pc, n_embed=N_EMBED, device="cpu")
        to_sd = lambda p: C.vq_model_state_dict_from_flax(p, pc)  # noqa: E731
    jd = JDisc(ndf=8, n_layers=2)
    dv = jax.jit(lambda: jd.init(jax.random.PRNGKey(1), xj))()
    jl = JLPIPS()
    lp = jax.jit(lambda: jl.init(jax.random.PRNGKey(2), xj, xj))()
    # the lin heads off their constant init of 1, so that LPIPS is no plain sum
    heads = np.random.default_rng(4)
    lp = {"params": {k: (jnp.asarray(heads.uniform(0.5, 1.5, v.shape), jnp.float32)
                         if k.startswith("lin") else v) for k, v in lp["params"].items()}}
    pl = LPIPS(device="cpu")
    pl.load_state_dict(C.lpips_state_dict_from_flax(lp))
    pd = NLayerDiscriminator(8, 2, device="cpu")
    jstate, jtx = jae.make_adversarial_state(ae, dv, lr=LR)
    jfns = jae.bind_autoencoder(jm, jd, jl)
    ptx = pae.make_adversarial_state(pm, pd, lr=LR)[1]
    pfns = pae.bind_autoencoder(pm, pd, pl)
    if kind == "kl":
        cfg = JP.KLLossConfig(**LOSS[kind])
        jstep = jae.make_kl_train_step(cfg, tx=jtx, **jfns)
        pstep = pae.make_kl_train_step(PP.KLLossConfig(**LOSS[kind]), tx=ptx, **pfns)
    else:
        cfg = JP.VQLossConfig(**LOSS[kind])
        jstep = jae.make_vq_train_step(cfg, tx=jtx, n_embed=N_EMBED, **jfns)
        pstep = pae.make_vq_train_step(PP.VQLossConfig(**LOSS[kind]), tx=ptx, n_embed=N_EMBED,
                                       **pfns)
    return dict(kind=kind, x=x, lp=lp, jstate=jstate, jstep=jax.jit(jstep), pstep=pstep,
                pm=pm, pd=pd, ptx=ptx, to_sd=to_sd)


def _close(want: dict, got: dict, what: str, skip=()):
    """Every tensor of `got` within BOUND of the max over `want`'s tensors."""
    top = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    for k, v in got.items():
        if k in skip:
            continue
        d = float(np.abs(np.asarray(want[k]) - v.detach().numpy()).max())
        assert d <= BOUND * top, f"{what} {k}: max|d| {d:.3e} > {BOUND:g} * {top:.4g}"


def test_adversarial_steps_match_jax(pair):
    p = pair
    n_layers = p["pd"].n_layers
    dsd = lambda params, stats=None: C.discriminator_state_dict_from_flax(  # noqa: E731
        {"params": params, "batch_stats": stats}, n_layers)
    js, key = p["jstate"], jax.random.PRNGKey(3)
    for i in range(STEPS):
        key, sub = jax.random.split(key)
        ps = C.adversarial_state_from_flax(js, p["to_sd"], p["pm"], p["pd"], tx=p["ptx"])
        assert ps.step == i
        js, jlog = p["jstep"](js, jnp.asarray(p["x"]), sub, p["lp"])
        images = torch.from_numpy(p["x"])
        if p["kind"] == "kl":
            noise = np.asarray(jax.random.normal(sub, (2, 8, 8, 4), jnp.float32))
            ps, plog = p["pstep"](ps, images, 0, noise=torch.from_numpy(noise))
        else:
            ps, plog = p["pstep"](ps, images, 0)
        assert ps.step == int(js.step) == i + 1
        assert set(plog) == set(jlog)
        for k in jlog:
            a, b = float(jlog[k]), float(plog[k])
            assert abs(a - b) <= BOUND * max(abs(a), 1e-6), f"step {i} {k}: {a} vs {b}"
        assert float(plog["train/disc_factor"]) == (0.0 if i == 0 else 1.0)

        jadam, gadam = C._find_adam(js.gen_opt), C._find_adam(js.disc_opt)
        mu = p["to_sd"](jadam.mu["ae"])
        mu_top = max(float(np.abs(v.numpy()).max()) for v in mu.values())
        zero = {k for k, v in mu.items() if float(np.abs(v.numpy()).max()) <= 1e-6 * mu_top}
        assert all(k.endswith("bias") for k in zero), sorted(zero)
        ae = lambda tree: {k[3:]: v for k, v in tree.items() if k.startswith("ae.")}  # noqa
        want = p["to_sd"](js.gen_params["ae"])
        _close(want, ae(ps.gen_params), f"step {i} params", skip=zero)
        for k in zero:
            d = float(np.abs(want[k].numpy() - ps.gen_params["ae." + k].detach().numpy()).max())
            assert d <= 4 * LR, f"step {i} zero-gradient leaf {k}: {d:.3e}"
        for moment in ("mu", "nu"):
            # nu as sqrt(nu), the gradient's units (Adam divides by it): a
            # relative error e of the gradient is 2e in nu
            f = np.sqrt if moment == "nu" else np.asarray
            g = torch.sqrt if moment == "nu" else torch.clone
            _close({k: f(v.numpy()) for k, v in p["to_sd"](getattr(jadam, moment)["ae"]).items()},
                   {k: g(v) for k, v in ae(ps.gen_opt[moment]).items()}, f"step {i} gen {moment}")
            _close({k: f(v.numpy()) for k, v in dsd(getattr(gadam, moment)).items()},
                   {k: g(v) for k, v in ps.disc_opt[moment].items()}, f"step {i} disc {moment}")
            assert abs(float(f(np.asarray(getattr(jadam, moment)["logvar"])))
                       - float(g(ps.gen_opt[moment]["logvar"]))) <= BOUND * max(
                abs(float(f(np.asarray(getattr(jadam, moment)["logvar"])))), 1e-12)
        assert abs(float(js.gen_params["logvar"]) - ps.gen_params["logvar"].item()) <= BOUND
        assert ps.gen_opt["count"] == ps.disc_opt["count"] == i + 1
        want_d = dsd(js.disc_params, js.disc_batch_stats)
        _close(want_d, ps.disc_params, f"step {i} disc params")
        _close(want_d, ps.disc_batch_stats, f"step {i} BatchNorm statistics")


def _batches(start: int):
    """The batch of each step from `start` on (a restart resumes the stream
    where the killed run left it)."""
    step = start
    while True:
        yield np.random.default_rng(100 + step).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
        step += 1


def _state_tensors(state) -> dict:
    out = {}
    for group in ("gen_params", "disc_params", "disc_batch_stats"):
        out.update({f"{group}.{k}": v.detach().clone() for k, v in getattr(state, group).items()})
    for group in ("gen_opt", "disc_opt"):
        for moment in ("mu", "nu"):
            out.update({f"{group}.{moment}.{k}": v.clone()
                        for k, v in getattr(state, group)[moment].items()})
    return out


@pytest.mark.parametrize("kind", ["kl", "vq"])
def test_train_autoencoder_resumes_bitwise(kind, tmp_path):
    """A run killed after its loop-index-2 meta checkpoint (state.step 3)
    and restarted ends bitwise equal to an uninterrupted 4-step run."""
    loss = (PP.KLLossConfig if kind == "kl" else PP.VQLossConfig)(**LOSS[kind])
    kw = dict(kind=kind, vae_config=VAEConfig.tiny(**CFG[kind]), n_embed=N_EMBED,
              loss_config=loss, disc_ndf=8, disc_n_layers=2, lr=1e-4, log_freq=1,
              snapshot_freq_for_preemption=2, snapshot_freq=100, seed=5, device="cpu")
    whole = run_lib.train_autoencoder(_batches(0), workdir=str(tmp_path / "a"), max_steps=4, **kw)
    killed = run_lib.train_autoencoder(_batches(0), workdir=str(tmp_path / "b"), max_steps=3,
                                       **kw)
    assert killed.step == 3
    resumed = run_lib.train_autoencoder(_batches(3), workdir=str(tmp_path / "b"), max_steps=4,
                                        **kw)
    assert whole.step == resumed.step == 4
    want, got = _state_tensors(whole), _state_tensors(resumed)
    assert set(want) == set(got)
    for k in want:
        assert torch.equal(want[k], got[k]), k
    assert whole.gen_opt["count"] == resumed.gen_opt["count"] == 4


@pytest.mark.parametrize("pil", [True, False], ids=["png", "npy-without-PIL"])
def test_train_autoencoder_writes_reconstruction_grids(pil, tmp_path, monkeypatch):
    if not pil:
        real_import = builtins.__import__

        def no_pil(name, *args, **kwargs):
            if name == "PIL" or name.startswith("PIL."):
                raise ImportError("no PIL")
            return real_import(name, *args, **kwargs)

        monkeypatch.setattr(builtins, "__import__", no_pil)
    else:
        pytest.importorskip("PIL")
    state = run_lib.train_autoencoder(
        _batches(0), workdir=str(tmp_path), kind="kl", vae_config=VAEConfig.tiny(**CFG["kl"]),
        loss_config=PP.KLLossConfig(perceptual_weight=0.0), disc_ndf=8, disc_n_layers=2,
        max_steps=3, image_freq=2, log_freq=10, device="cpu")
    assert state.step == 3
    ext = ".png" if pil else ".png.npy"
    assert sorted(os.listdir(tmp_path / "recon")) == [f"recon_{s:07d}{ext}" for s in (0, 2)]
    if not pil:
        grid = np.load(tmp_path / "recon" / f"recon_0000000{ext}")
        # a 2 x 1 grid of (16, 32) input | reconstruction pairs, 2 px apart
        assert grid.shape == (16, 2 * 32 + 2, 3) and grid.dtype == np.uint8
