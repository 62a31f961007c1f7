"""Port NCSN++ / DDPM++ (dpm_solver_tpu_torch/models/ncsnpp.py) against the JAX model.

- Forward parity: one seeded torch init is carried into the JAX model's
  parameter tree by the JAX package's own torch converter
  (`ncsnpp_convert.params_from_torch`) and back into a fresh port model by
  `ncsnpp_state_dict_from_flax`; on the same x and labels the fp32 forwards
  agree within 5e-5 of max|out| (the bound of
  tests/test_torch_ncsnpp_convert.py:253-254), for the tiny configs of that
  file (:207-216) and the tiny twins of the VP NCSN++ and discrete-VE nets.
- The converter is the exact inverse of `params_from_torch`, and its tree has
  the JAX model's own parameter layout.
- The presets and the deep preset's parameter count match the JAX package.
- The whole Slice D path, small: a tiny DDPM++ on the continuous-VP schedule
  (labels t*999 through `score.get_noise_fn`) sampled by singlestep order 3
  on the logSNR grid, within 1e-4 of max|x| of the JAX sampler.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpm_solver_tpu as J
import dpm_solver_tpu_torch as P
from dpm_solver_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from dpm_solver_tpu.models.ncsnpp import NCSNppConfig as JaxConfig
from dpm_solver_tpu.models.ncsnpp_convert import params_from_torch
from dpm_solver_tpu.score import get_noise_fn as jax_noise_fn
from dpm_solver_tpu.sde import VPSDE as JaxVPSDE
from dpm_solver_tpu_torch.models import NCSNpp, NCSNppConfig, init_random_
from dpm_solver_tpu_torch.score import get_noise_fn
from dpm_solver_tpu_torch.sde import VPSDE
from dpm_solver_tpu_torch.utils.convert import ncsnpp_state_dict_from_flax

TOL = 5e-5
CONFIGS = {
    "ddpmpp_vp": dict(),
    "ncsnpp_ve": dict(fir=True, progressive_input="residual", embedding_type="fourier",
                      scale_by_sigma=True, data_centered=False),
    "output_skip": dict(fir=True, progressive="output_skip", progressive_input="input_skip",
                        embedding_type="fourier"),
    "ddpm_blocks": dict(resblock_type="ddpm", ch_mult=(1, 2, 2)),
    "ncsnpp_vp": dict(fir=True, progressive_input="residual"),
    "celeba_ve_discrete": dict(fir=True, progressive_input="residual", scale_by_sigma=True,
                               data_centered=False, sigma_max=90.0),
    "residual_cat": dict(progressive="residual", progressive_input="input_skip",
                         progressive_combine="cat"),
}
PRESETS = ["cifar10_ddpmpp", "cifar10_ncsnpp", "cifar10_ncsnpp_vp", "celeba64", "px256",
           "px1024", "tiny"]


def _torch_init(name, seed=0):
    cfg = NCSNppConfig.tiny(**CONFIGS[name])
    net = init_random_(NCSNpp(cfg, device="cpu"), torch.Generator().manual_seed(seed)).eval()
    return cfg, net, {k: v.numpy() for k, v in net.state_dict().items()}


def _inputs(cfg, batch=2):
    x = np.random.default_rng(1).standard_normal(
        (batch, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    if not cfg.data_centered:
        x = 1.0 / (1.0 + np.exp(-x))
    if cfg.embedding_type == "fourier":
        t = np.asarray([0.5, 37.2], dtype=np.float32)  # sigmas
    else:
        t = np.asarray([3.0, 700.0], dtype=np.float32)  # labels
    return x, t[:batch]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax(name):
    cfg, _, sd = _torch_init(name)
    jcfg = JaxConfig.tiny(**CONFIGS[name])
    params = params_from_torch(sd, jcfg)
    x, t = _inputs(cfg)
    want = np.asarray(JaxNCSNpp(config=jcfg).apply(params, jnp.asarray(x), jnp.asarray(t),
                                                   deterministic=True))
    port = NCSNpp(cfg, device="cpu").eval()
    port.load_state_dict(ncsnpp_state_dict_from_flax(params, cfg), strict=True)
    with torch.no_grad():
        got = port(torch.tensor(x), torch.tensor(t))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_converter_is_the_exact_inverse_of_params_from_torch(name):
    cfg, net, sd = _torch_init(name, seed=3)
    jcfg = JaxConfig.tiny(**CONFIGS[name])
    params = params_from_torch(sd, jcfg)
    # the tree has the JAX model's own parameter layout
    x, t = _inputs(cfg, batch=1)
    shapes = jax.eval_shape(lambda: JaxNCSNpp(config=jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t), deterministic=True))
    assert jax.tree.structure(shapes) == jax.tree.structure(params)
    assert all(a.shape == np.shape(b) for a, b in zip(jax.tree.leaves(shapes),
                                                      jax.tree.leaves(params)))
    back_sd = ncsnpp_state_dict_from_flax(params, cfg)
    assert set(back_sd) == set(sd)
    for k, v in sd.items():
        assert np.array_equal(back_sd[k].numpy(), v), k
    again = params_from_torch({k: v.numpy() for k, v in back_sd.items()}, jcfg)
    assert jax.tree.structure(again) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(params)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_state_dict_uses_the_reference_layout():
    cfg = NCSNppConfig.tiny(**CONFIGS["ncsnpp_ve"])
    sd = NCSNpp(cfg, device="cpu").state_dict()
    assert "sigmas" in sd and sd["all_modules.0.W"].shape == (cfg.nf,)       # fourier
    assert sd["all_modules.1.weight"].shape == (4 * cfg.nf, 2 * cfg.nf)       # Dense
    assert sd["all_modules.3.weight"].shape == (cfg.nf, 3, 3, 3)              # conv_in
    assert sd["all_modules.4.Conv_0.weight"].shape == (cfg.nf, cfg.nf, 3, 3)  # a res block
    assert "all_modules.4.GroupNorm_0.weight" in sd and "all_modules.4.Dense_0.bias" in sd
    attn = [k for k in sd if k.endswith("NIN_3.W")]
    assert len(attn) == 4 and all(sd[k].shape == (2 * cfg.nf,) * 2 for k in attn)
    assert any(k.endswith("Conv2d_0.weight") for k in sd)  # the FIR pyramid convs


@pytest.mark.parametrize("preset", PRESETS)
def test_presets_match_jax(preset):
    ours, theirs = getattr(NCSNppConfig, preset)(), getattr(JaxConfig, preset)()
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name


def test_deep_preset_parameter_count_matches_jax():
    cfg = NCSNppConfig.cifar10_ddpmpp(deep=True)
    n_ours = sum(p.numel() for p in NCSNpp(cfg, device="meta").parameters())
    shapes = jax.eval_shape(lambda: JaxNCSNpp(config=JaxConfig.cifar10_ddpmpp(deep=True)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), jnp.ones((1,)), deterministic=True))
    assert n_ours == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    assert 100e6 < n_ours < 115e6  # DDPM++ cont. (deep): ~108M parameters


def test_bf16_compute_close_to_fp32():
    """bf16 convs and matmuls, fp32 GroupNorm statistics and fp32 output."""
    cfg, net, sd = _torch_init("ncsnpp_ve")
    net16 = NCSNpp(cfg, compute_dtype=torch.bfloat16, device="cpu").eval()
    net16.load_state_dict(net.state_dict())
    x, t = (torch.tensor(a) for a in _inputs(cfg))
    with torch.no_grad():
        a, b = net(x, t), net16(x, t)
    assert b.dtype == torch.float32
    assert ((a - b).abs().mean() / a.abs().mean()).item() < 0.05


def test_whole_slice_tiny_ddpmpp_matches_jax():
    """Continuous VP, labels t*999, singlestep order 3, 6 NFE, logSNR, t_end 1e-3."""
    cfg = NCSNppConfig.tiny(num_res_blocks=1)
    port = init_random_(NCSNpp(cfg, device="cpu"), torch.Generator().manual_seed(0)).eval()
    jcfg = JaxConfig.tiny(num_res_blocks=1)
    params = params_from_torch({k: v.numpy() for k, v in port.state_dict().items()}, jcfg)
    jax_net = JaxNCSNpp(config=jcfg)
    kwargs = dict(steps=6, order=3, method="singlestep", skip_type="logSNR", t_end=1e-3)
    x = np.random.default_rng(2).standard_normal((2, 16, 16, 3)).astype(np.float32)

    ns_j = J.NoiseScheduleVP.linear()
    raw = jax_noise_fn(JaxVPSDE(), lambda u, s: jax_net.apply(params, u, s, deterministic=True))
    want = np.asarray(J.DPM_Solver(J.model_wrapper(raw, ns_j), ns_j).sample(jnp.asarray(x),
                                                                          **kwargs))
    ns_t = VPSDE().to_noise_schedule()
    solver = P.DPM_Solver(P.model_wrapper(get_noise_fn(VPSDE(), port), ns_t), ns_t)
    with torch.no_grad():
        got = solver.sample(torch.tensor(x), **kwargs).numpy()
    assert np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-4)
