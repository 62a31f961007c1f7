"""The port's first-stage loss networks and losses (dpm_solver_tpu_torch/
models/{lpips,discriminator}.py, training/perceptual.py, the VAE's training
split, the first-stage Adam) against the JAX package's, on the CPU, fp32.

- LPIPS at 16 and 32 px: the distance within 2e-6 of the JAX one, its
  gradient within 1e-5 of max; a taming-style state dict and a torchvision
  VGG16 with `lin{k}.weight` heads load to the same network.
- The PatchGAN discriminator (BatchNorm, flax's semantics): the logits, and
  the running statistics after the real -> fake thread of the
  discriminator pass, against flax's `mutable=["batch_stats"]`, within
  1e-5; ActNorm's logits and `actnorm_stats_from_batch`.
- Every loss of training/perceptual.py and `adaptive_gan_weight`, within
  1e-5 (float32 inputs, the JAX callables and the port's twins on the same
  weights).
- `forward_trunk` + `decoder_epilogue` bitwise equal to `decode` (KL and
  VQ), and `DiagonalGaussian.kl` / `nll` against the JAX posterior.
- `Adam(b1=0.5, b2=0.9, grad_clip=None)` against `optax.adam` over 3 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dpm_solver_tpu.models import discriminator as jdisc
from dpm_solver_tpu.models import lpips as jlpips
from dpm_solver_tpu.models import vae as jvae
from dpm_solver_tpu.training import perceptual as JP
from dpm_solver_tpu_torch.models import AutoencoderKL, VAEConfig, VQModel
from dpm_solver_tpu_torch.models import discriminator as pdisc
from dpm_solver_tpu_torch.models.lpips import LPIPS
from dpm_solver_tpu_torch.models.vae import DiagonalGaussian, decoder_epilogue
from dpm_solver_tpu_torch.training import perceptual as PP
from dpm_solver_tpu_torch.training.optim import Adam
from dpm_solver_tpu_torch.utils import convert as C


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's CPU work: these small shapes gain
    nothing from more, and the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(seed, shape, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


@pytest.fixture(scope="module")
def lpips_pair():
    x = jnp.asarray(_rand(0, (1, 16, 16, 3)))
    jl = jlpips.LPIPS()
    params = jax.jit(lambda: jl.init(jax.random.PRNGKey(0), x, x))()
    heads = np.random.default_rng(1)
    params = {"params": {k: (jnp.asarray(heads.uniform(0.5, 1.5, v.shape), jnp.float32)
                             if k.startswith("lin") else v) for k, v in params["params"].items()}}
    pl = LPIPS(device="cpu")
    pl.load_state_dict(C.lpips_state_dict_from_flax(params))
    return jl, params, pl


@pytest.mark.parametrize("size", [16, 32])
def test_lpips_matches_jax(lpips_pair, size):
    jl, params, pl = lpips_pair
    x, y = _rand(2, (2, size, size, 3)), _rand(3, (2, size, size, 3))
    # jitted: the VGG16 op by op takes seconds
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda v: jnp.sum(jl.apply(params, jnp.asarray(x), v))))
    want = np.asarray(jax.jit(jl.apply)(params, jnp.asarray(x), jnp.asarray(y)))
    yt = torch.from_numpy(y).requires_grad_()
    got = pl(torch.from_numpy(x), yt)
    assert got.shape == want.shape == (2, 1, 1, 1)
    assert _rel(want, got.detach().numpy()) <= 2e-6
    gj = np.asarray(value_and_grad(jnp.asarray(y))[1])
    got.sum().backward()
    assert _rel(gj, yt.grad.numpy()) <= 1e-5


@pytest.mark.parametrize("naming", ["taming", "torchvision"])
def test_lpips_loads_both_state_dict_namings(lpips_pair, naming):
    jl, params, pl = lpips_pair
    own = pl.state_dict()
    if naming == "taming":   # the checkpoint's own keys, plus the ScalingLayer's buffers
        sd = {**own, "scaling_layer.shift": torch.zeros(1, 3, 1, 1)}
        sd = {k.replace("lin1.model", "lins.1.model"): v for k, v in sd.items()}
    else:                    # torchvision's VGG16 `features.{i}` with lin{k}.weight heads
        sd = {}
        for k, v in own.items():
            if k.startswith("net.slice"):
                sd["features." + k.split(".", 2)[2]] = v
            else:
                sd[k.replace(".model.1.weight", ".weight")] = v.reshape(-1)
        sd["classifier.0.weight"] = torch.zeros(4, 4)
    other = LPIPS(device="cpu")
    other.load_state_dict(sd)
    x, y = torch.from_numpy(_rand(4, (1, 16, 16, 3))), torch.from_numpy(_rand(5, (1, 16, 16, 3)))
    with torch.no_grad():
        assert torch.equal(other(x, y), pl(x, y))


@pytest.fixture(scope="module", params=["batchnorm", "actnorm"])
def disc_pair(request):
    actnorm = request.param == "actnorm"
    x = jnp.asarray(_rand(6, (2, 32, 32, 3)))
    jd = jdisc.NLayerDiscriminator(ndf=8, n_layers=3, use_actnorm=actnorm)
    dv = jax.jit(lambda: jd.init(jax.random.PRNGKey(2), x))()
    if actnorm:  # loc and scale off the identity
        rng = np.random.default_rng(7)
        dv = {"params": {k: ({n: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32)
                              for n, a in v.items()} if k.startswith("norm") else v)
                         for k, v in dv["params"].items()}}
    else:        # running statistics off zeros and ones
        rng = np.random.default_rng(8)
        dv = {"params": dv["params"], "batch_stats": jax.tree.map(
            lambda a: jnp.asarray(rng.uniform(0.2, 1.2, a.shape), jnp.float32),
            dv["batch_stats"])}
    pd = pdisc.NLayerDiscriminator(8, 3, use_actnorm=actnorm, device="cpu")
    pd.load_state_dict(C.discriminator_state_dict_from_flax(dv, 3), strict=not actnorm)
    return jd, dv, pd


def test_discriminator_logits_and_threaded_statistics_match_flax(disc_pair):
    jd, dv, pd = disc_pair
    real, fake = _rand(9, (2, 32, 32, 3)), _rand(10, (2, 32, 32, 3), -0.5, 0.5)
    # the discriminator pass: real, then fake, the statistics threaded through both
    stats = dv.get("batch_stats", {})
    outs = []
    for img in (real, fake):
        logits, upd = jd.apply({"params": dv["params"], "batch_stats": stats}, jnp.asarray(img),
                               mutable=["batch_stats"])
        stats = upd.get("batch_stats", {})
        outs.append(np.asarray(logits))
    ps = None
    for img, want in zip((real, fake), outs):
        got, ps = pd(torch.from_numpy(img), ps)
        assert got.shape == want.shape and got.dtype == torch.float32
        assert _rel(want, got.detach().numpy()) <= 1e-5
    want_sd = C.discriminator_state_dict_from_flax({"params": dv["params"],
                                                    "batch_stats": stats}, 3)
    assert set(ps) == {k for k in want_sd if k.endswith(("running_mean", "running_var"))}
    for k, v in ps.items():
        assert _rel(want_sd[k].numpy(), v.numpy()) <= 1e-5, k
    # the module's own buffers are not changed by a forward
    for k, v in pd.batch_stats().items():
        assert torch.equal(v, torch.as_tensor(np.asarray(
            C.discriminator_state_dict_from_flax(dv, 3)[k])))


def test_actnorm_stats_from_batch_matches_jax():
    x = _rand(11, (2, 5, 7, 6), -2.0, 3.0)
    want = jdisc.actnorm_stats_from_batch(jnp.asarray(x))
    got = pdisc.actnorm_stats_from_batch(torch.from_numpy(x))
    for w, g in zip(want, got):
        assert _rel(np.asarray(w), g.numpy()) <= 1e-6


def test_discriminator_init_follows_weights_init():
    from dpm_solver_tpu_torch.models.init import init_train_

    pd = init_train_(pdisc.NLayerDiscriminator(64, 3, device="cpu"),
                     torch.Generator().manual_seed(0))
    convs = [m for m in pd.main if isinstance(m, torch.nn.Conv2d)]
    w = torch.cat([c.weight.detach().flatten() for c in convs])
    assert abs(float(w.std()) - 0.02) < 1e-3 and abs(float(w.mean())) < 1e-3
    assert all(c.bias is None or not c.bias.any() for c in convs)
    scales = torch.cat([m.weight.detach() for m in pd.main if isinstance(m, pdisc.BatchNorm)])
    assert abs(float(scales.mean()) - 1.0) < 5e-3 and abs(float(scales.std()) - 0.02) < 5e-3


LOGITS = [(_rand(12, (2, 3, 3, 1), -2, 2), _rand(13, (2, 3, 3, 1), -2, 2))]


@pytest.mark.parametrize("name", ["hinge_d_loss", "vanilla_d_loss"])
def test_discriminator_losses_match_jax(name):
    real, fake = LOGITS[0]
    want = getattr(JP, name)(jnp.asarray(real), jnp.asarray(fake))
    got = getattr(PP, name)(torch.from_numpy(real), torch.from_numpy(fake))
    assert _rel(np.asarray(want), got.numpy()) <= 1e-6


def test_exemplar_weights_perplexity_and_pixel_losses_match_jax():
    real, fake = LOGITS[0]
    wts = np.array([0.3, 1.7], np.float32)
    assert _rel(np.asarray(JP.hinge_d_loss_with_exemplar_weights(
        jnp.asarray(real), jnp.asarray(fake), jnp.asarray(wts))),
        PP.hinge_d_loss_with_exemplar_weights(torch.from_numpy(real), torch.from_numpy(fake),
                                              torch.from_numpy(wts)).numpy()) <= 1e-6
    idx = np.random.default_rng(14).integers(0, 16, (2, 4, 4))
    for w, g in zip(JP.measure_perplexity(jnp.asarray(idx), 32),
                    PP.measure_perplexity(torch.from_numpy(idx), 32)):
        assert _rel(np.asarray(w), g.numpy()) <= 1e-6
    a, b = _rand(15, (2, 4)), _rand(16, (2, 4))
    for f in ("l1", "l2"):
        assert _rel(np.asarray(getattr(JP, f)(jnp.asarray(a), jnp.asarray(b))),
                    getattr(PP, f)(torch.from_numpy(a), torch.from_numpy(b)).numpy()) <= 1e-7
    for step, thr in ((0, 1), (1, 1), (5, 2)):
        assert float(JP.adopt_weight(0.7, step, thr)) == pytest.approx(
            PP.adopt_weight(0.7, step, thr))


@pytest.fixture(scope="module")
def loss_parts():
    """A linear 'decoder epilogue' w -> h @ w, a small dense 'discriminator'
    and an 'LPIPS' of squared pixel differences, the same weights on both
    sides: the losses' arithmetic, apart from the networks."""
    rng = np.random.default_rng(17)
    h = rng.standard_normal((2, 4, 4, 5)).astype(np.float32)
    w = (0.3 * rng.standard_normal((5, 3))).astype(np.float32)
    dw = (0.5 * rng.standard_normal((3, 1))).astype(np.float32)
    x = _rand(18, (2, 4, 4, 3))
    mom = rng.standard_normal((2, 2, 2, 4)).astype(np.float32)
    j = dict(last=lambda w_: jnp.asarray(h) @ w_, disc=lambda r: jnp.tanh(r @ jnp.asarray(dw)),
             perc=lambda a, b: jnp.mean((a - b) ** 2, axis=(1, 2, 3), keepdims=True))
    p = dict(last=lambda w_: torch.from_numpy(h) @ w_,
             disc=lambda r: torch.tanh(r @ torch.from_numpy(dw)),
             perc=lambda a, b: torch.mean((a - b) ** 2, dim=(1, 2, 3), keepdim=True))
    return dict(h=h, w=w, x=x, mom=mom, j=j, p=p)


def test_adaptive_gan_weight_matches_jax(loss_parts):
    lp = loss_parts
    x = lp["x"]
    want = JP.adaptive_gan_weight(lp["j"]["last"], jnp.asarray(lp["w"]),
                                  lambda r: jnp.mean(jnp.abs(jnp.asarray(x) - r)),
                                  lambda r: -jnp.mean(lp["j"]["disc"](r)), 0.8)
    w = torch.from_numpy(lp["w"]).requires_grad_()
    got = PP.adaptive_gan_weight(lp["p"]["last"], w,
                                 lambda r: torch.mean(torch.abs(torch.from_numpy(x) - r)),
                                 lambda r: -torch.mean(lp["p"]["disc"](r)), 0.8)
    assert not got.requires_grad and w.grad is None
    assert _rel(np.asarray(want), got.numpy()) <= 1e-5


@pytest.mark.parametrize("kind,disc_loss,step", [("kl", "hinge", 0), ("kl", "vanilla", 3),
                                                 ("vq", "hinge", 3), ("vq", "vanilla", 0)])
def test_generator_and_discriminator_losses_match_jax(loss_parts, kind, disc_loss, step):
    lp = loss_parts
    x, w = lp["x"], lp["w"]
    rec_j = lp["j"]["last"](jnp.asarray(w))
    wt = torch.from_numpy(w)
    rec_p = lp["p"]["last"](wt)
    if kind == "kl":
        kw = dict(disc_start=2, kl_weight=0.3, perceptual_weight=0.5, disc_loss=disc_loss)
        logvar = np.float32(0.2)
        want = JP.kl_generator_loss(
            JP.KLLossConfig(**kw), lp["j"]["perc"], lp["j"]["disc"], jnp.asarray(x), rec_j,
            jvae.DiagonalGaussian.from_moments(jnp.asarray(lp["mom"])), jnp.float32(logvar),
            step, last_layer_fn=lp["j"]["last"], last_layer_params=jnp.asarray(w))
        got = PP.kl_generator_loss(
            PP.KLLossConfig(**kw), lp["p"]["perc"], lp["p"]["disc"], torch.from_numpy(x), rec_p,
            DiagonalGaussian.from_moments(torch.from_numpy(lp["mom"])),
            torch.tensor(logvar), step, last_layer_fn=lp["p"]["last"], last_layer=wt)
        cfg_j, cfg_p = JP.KLLossConfig(**kw), PP.KLLossConfig(**kw)
    else:
        kw = dict(disc_start=2, codebook_weight=0.7, perceptual_weight=0.5, disc_loss=disc_loss,
                  pixel_loss="l2" if disc_loss == "vanilla" else "l1")
        idx = np.random.default_rng(19).integers(0, 8, (2, 2, 2))
        want = JP.vq_generator_loss(
            JP.VQLossConfig(**kw), lp["j"]["perc"], lp["j"]["disc"], jnp.float32(0.4),
            jnp.asarray(x), rec_j, step, last_layer_fn=lp["j"]["last"],
            last_layer_params=jnp.asarray(w), predicted_indices=jnp.asarray(idx), n_embed=8)
        got = PP.vq_generator_loss(
            PP.VQLossConfig(**kw), lp["p"]["perc"], lp["p"]["disc"], torch.tensor(0.4),
            torch.from_numpy(x), rec_p, step, last_layer_fn=lp["p"]["last"], last_layer=wt,
            predicted_indices=torch.from_numpy(idx), n_embed=8)
        cfg_j, cfg_p = JP.VQLossConfig(**kw), PP.VQLossConfig(**kw)
    assert set(got.log) == set(want.log)
    assert _rel(np.asarray(want.loss), got.loss.detach().numpy()) <= 1e-5
    for k in want.log:
        assert abs(float(want.log[k]) - float(got.log[k])) <= 1e-5 * max(
            abs(float(want.log[k])), 1e-6), k
    dj = JP.discriminator_loss(cfg_j, lp["j"]["disc"], jnp.asarray(x), rec_j, step)
    dp = PP.discriminator_loss(cfg_p, lp["p"]["disc"], torch.from_numpy(x), rec_p, step)
    for k in dj.log:
        assert abs(float(dj.log[k]) - float(dp.log[k])) <= 1e-5 * max(abs(float(dj.log[k])),
                                                                       1e-6), k


@pytest.mark.parametrize("kind", ["kl", "vq"])
def test_trunk_and_epilogue_equal_decode_bitwise(kind):
    g = torch.Generator().manual_seed(20)
    if kind == "kl":
        from dpm_solver_tpu_torch.models import init_random_
        model = init_random_(AutoencoderKL(VAEConfig.tiny(resolution=16, tanh_out=True),
                                           device="cpu"), g)
    else:
        from dpm_solver_tpu_torch.models import init_random_
        model = init_random_(VQModel(VAEConfig.tiny(resolution=16, double_z=False, z_channels=3,
                                                    embed_dim=3), n_embed=16, device="cpu"), g)
    x = torch.rand(2, 16, 16, 3, generator=g) * 2 - 1
    with torch.no_grad():
        if kind == "kl":
            noise = torch.randn(2, 8, 8, 4, generator=g)
            h, post = model.forward_trunk(x, noise)
            want = model.decode(post.sample(noise))
        else:
            h, _, idx = model.forward_trunk(x)
            want = model.decode(model.encode(x))
        conv_out = model.decoder.conv_out
        got = decoder_epilogue(conv_out, h, tanh_out=model.config.tanh_out)
        again = decoder_epilogue(conv_out, h, weight=conv_out.weight.clone(),
                                 tanh_out=model.config.tanh_out)
    assert torch.equal(got, want) and torch.equal(again, want)


def test_diagonal_gaussian_kl_and_nll_match_jax():
    mom = np.random.default_rng(21).standard_normal((2, 3, 3, 8)).astype(np.float32) * 2
    sample = np.random.default_rng(22).standard_normal((2, 3, 3, 4)).astype(np.float32)
    jd = jvae.DiagonalGaussian.from_moments(jnp.asarray(mom))
    pd = DiagonalGaussian.from_moments(torch.from_numpy(mom))
    assert _rel(np.asarray(jd.kl()), pd.kl().numpy()) <= 1e-6
    assert _rel(np.asarray(jd.nll(jnp.asarray(sample))),
                pd.nll(torch.from_numpy(sample)).numpy()) <= 1e-6


def test_first_stage_adam_matches_optax():
    rng = np.random.default_rng(23)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal((3,)).astype(np.float32)}
    grads = [{k: (5 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    tx = optax.adam(1e-2, b1=0.5, b2=0.9)
    jp, st = {k: jnp.asarray(v) for k, v in params.items()}, None
    st = tx.init(jp)
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ptx = Adam(1e-2, grad_clip=None, b1=0.5, b2=0.9)
    pst = ptx.init(pp)
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        assert ptx.step(pp, {k: torch.from_numpy(v.copy()) for k, v in g.items()}, pst) is None
    assert pst["count"] == 3
    for k in params:
        assert _rel(np.asarray(jp[k]), pp[k].numpy()) <= 1e-6
        assert _rel(np.asarray(st[0].mu[k]), pst["mu"][k].numpy()) <= 1e-6
        assert _rel(np.asarray(st[0].nu[k]), pst["nu"][k].numpy()) <= 1e-6
