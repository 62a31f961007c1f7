"""Slice C, classifier-guided ADM sampling, against the JAX package.

- The whole slice, tiny: an ADM UNet with class labels, scale-shift norm and
  resblock up/down (learned sigma, the model takes out[..., :3]) and an
  attention-pool classifier, one random init of each carried into both
  frameworks; fp32, batch 2 at 16x16; classifier guidance at scale 8 through
  `model_wrapper(guidance_type="classifier")`, DPM-Solver++ 2M for 6 NFE on the
  time-uniform grid with dynamic thresholding, through `build_sampler` on both
  sides; within 1e-4 of max|x| (tests/test_solver_parity.py:70-75).
- `make_dynamic_thresholding` against the JAX one at the guided call's shape:
  8 rows of 256*256*3 = 196,608 values.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

import dpm_solver_tpu as J
import dpm_solver_tpu_torch as P
from dpm_solver_tpu.models.adm_unet import ADMClassifier as JaxADMClassifier
from dpm_solver_tpu.models.adm_unet import ADMConfig as JaxConfig
from dpm_solver_tpu.models.adm_unet import ADMUNet as JaxADMUNet
from dpm_solver_tpu.solver.correctors import make_dynamic_thresholding as jax_thresholding
from dpm_solver_tpu.utils.convert import convert_adm_unet
from dpm_solver_tpu_torch.models import ADMClassifier, ADMConfig, ADMUNet, init_random_
from dpm_solver_tpu_torch.solver.correctors import make_dynamic_thresholding

TOL = 1e-4
BETAS = np.linspace(1e-4, 0.02, 1000, dtype=np.float64)
UNET = dict(image_size=16, model_channels=32, out_channels=6, num_res_blocks=1,
            attention_resolutions=(2, 4), channel_mult=(1, 2, 2), num_classes=10,
            num_head_channels=16, use_scale_shift_norm=True, resblock_updown=True)
CLASSIFIER = dict(UNET, out_channels=10, num_classes=None, pool="attention")


def test_whole_slice_tiny_guided_matches_jax():
    g = torch.Generator().manual_seed(0)
    unet = init_random_(ADMUNet(ADMConfig(**UNET), device="cpu"), g).eval()
    clf = init_random_(ADMClassifier(ADMConfig(**CLASSIFIER), device="cpu"), g).eval()
    clf.requires_grad_(False)
    numpy_sd = lambda net: {k: v.numpy() for k, v in net.state_dict().items()}
    uparams = convert_adm_unet(numpy_sd(unet), JaxConfig(**UNET))
    cparams = convert_adm_unet(numpy_sd(clf), JaxConfig(**CLASSIFIER), classifier=True)
    jax_unet, jax_clf = JaxADMUNet(JaxConfig(**UNET)), JaxADMClassifier(JaxConfig(**CLASSIFIER))

    rng = np.random.default_rng(1)
    x_T = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 10, 2)
    plan = dict(steps=6, order=2, method="multistep", skip_type="time_uniform")
    guide = dict(model_type="noise", guidance_type="classifier", guidance_scale=8.0)

    def jax_log_prob(x, t, yy):
        logits = jax_clf.apply(cparams, x, t)
        return jax.nn.log_softmax(logits, axis=-1)[jnp.arange(x.shape[0]), yy]

    ns_j = J.NoiseScheduleVP.discrete(betas=BETAS)
    model_j = J.model_wrapper(lambda x, t: jax_unet.apply(uparams, x, t, jnp.asarray(y))[..., :3],
                              ns_j, condition=jnp.asarray(y), classifier_fn=jax_log_prob, **guide)
    sample_j = J.build_sampler(model_j, ns_j, correcting_x0_fn=jax_thresholding(0.995, 1.0), **plan)
    want = np.asarray(jax.jit(sample_j)(jnp.asarray(x_T)))

    def log_prob(x, t, yy):
        return F.log_softmax(clf(x, t), dim=-1)[torch.arange(x.shape[0]), yy]

    ns_t = P.NoiseScheduleVP.discrete(betas=BETAS)
    yt = torch.tensor(y)
    model_t = P.model_wrapper(lambda x, t: unet(x, t, yt)[..., :3], ns_t, condition=yt,
                              classifier_fn=log_prob, **guide)
    with torch.no_grad():
        got = P.build_sampler(model_t, ns_t, correcting_x0_fn=make_dynamic_thresholding(0.995, 1.0),
                              **plan)(torch.tensor(x_T))
    assert got.shape == x_T.shape and got.dtype == torch.float32 and torch.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy() / scale, want / scale, rtol=0, atol=TOL)


def test_dynamic_thresholding_at_the_guided_shape_matches_jax():
    x0 = (np.random.default_rng(2).standard_normal((8, 256, 256, 3)) * 1.5).astype(np.float32)
    want = np.asarray(jax_thresholding(0.995, 1.0)(jnp.asarray(x0)))
    got = make_dynamic_thresholding(0.995, 1.0)(torch.tensor(x0)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_guided_configs_match_the_jax_registry():
    """The chip smoke builds the guided networks from `ADMConfig` alone; they
    are the ones `configs.py` registers for imagenet256_guided."""
    from dpm_solver_tpu.configs import get_config

    jc = get_config("imagenet256_guided")
    ours_u = ADMConfig.imagenet256_guided()
    ours_c = dataclasses.replace(ours_u, model_channels=128, num_res_blocks=2, out_channels=1000,
                                 pool="attention", num_classes=None, resblock_updown=True,
                                 use_scale_shift_norm=True)
    for ours, theirs in ((ours_u, jc.model_config), (ours_c, jc.classifier_config)):
        assert dataclasses.asdict(ours) == {f: getattr(theirs, f) for f in dataclasses.asdict(ours)}
    np.testing.assert_array_equal(jc.diffusion.betas(), BETAS)
    assert (jc.sampling.classifier_scale, jc.sampling.steps, jc.sampling.order) == (8.0, 20, 2)
