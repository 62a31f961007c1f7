"""The models' training mode and training initialisers (the port's
models/ddpm_unet.py, adm_unet.py, ncsnpp.py, init.py), on the CPU.

- Dropout: live under `.train()` at the config's rate (keep rate 1 - p
  within 4 sigma, kept values scaled by 1 / (1 - p)), a no-op under
  `.eval()` (the models are built in eval mode, the JAX default
  deterministic=True); the step's dropout seed (`StepRng.dropout`) makes a
  call repeatable.
- Remat (ADMConfig.remat, NCSNppConfig.remat: `torch.utils.checkpoint` per
  block) equals no remat with dropout on: the loss bitwise, the gradients
  within 1e-6 (the recompute draws the same masks from the default
  generators the checkpoint restores).
- The training initialisers draw the JAX `model.init`'s distribution,
  tensor by tensor (the JAX init through the port's Flax -> torch
  converters, against `init_train_`), on tiny DDPM, NCSN++ (FIR, output
  skip, residual input pyramid, Fourier features) and ADM (class labels,
  a spatial transformer) configs: constant tensors (zeros, unit scales)
  equal; elsewhere the same std within 15% and the same bound (within 1.6x
  of the JAX draw's largest element, a truncated normal's 2 sigma or a
  uniform's limit).
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from dpm_solver_tpu.models import DDPMUNet as JDDPMUNet
from dpm_solver_tpu.models import DDPMUNetConfig as JDDPMUNetConfig
from dpm_solver_tpu_torch.models import ADMConfig, ADMUNet, DDPMUNet, DDPMUNetConfig, NCSNpp, \
    NCSNppConfig
from dpm_solver_tpu_torch.models.init import init_train_
from dpm_solver_tpu_torch.training import train as ptrain
from dpm_solver_tpu_torch.utils.convert import ddpm_unet_state_dict_from_flax


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's CPU work: these small shapes gain
    nothing from more, and the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dropout_net(p, remat=False, kind="ddpm"):
    gen = torch.Generator().manual_seed(0)
    if kind == "ddpm":
        net = DDPMUNet(dataclasses.replace(DDPMUNetConfig.tiny(resolution=8), dropout=p),
                       device="cpu")
    elif kind == "adm":
        net = ADMUNet(ADMConfig.tiny(image_size=8, dropout=p, remat=remat), device="cpu")
    else:
        net = NCSNpp(NCSNppConfig.tiny(image_size=8, dropout=p, remat=remat), device="cpu")
    return init_train_(net, gen)


def test_dropout_live_in_train_mode_at_the_config_rate():
    p = 0.3
    net = _dropout_net(p)
    x = torch.randn(4, 8, 8, 3, generator=torch.Generator().manual_seed(1))
    t = torch.full((4,), 500.0)
    seen = []
    hook = net.mid.block_1.dropout.register_forward_hook(lambda m, i, o: seen.append((i[0], o)))
    assert not net.training  # built in eval mode
    with torch.no_grad():
        a, b = net(x, t), net(x, t)
        assert torch.equal(a, b)
        inp, out = seen[-1]
        assert torch.equal(inp, out)  # a no-op under eval
        net.train()
        rng = ptrain.StepRng(0, 0)
        with rng.dropout("cpu"):
            c = net(x, t)
        with rng.dropout("cpu"):
            d = net(x, t)
        assert torch.equal(c, d) and not torch.equal(a, c)
        inp, out = seen[-1]
    hook.remove()
    kept = out != 0
    keep = float(kept.float().mean())
    n = kept.numel()
    assert abs(keep - (1 - p)) <= 4 * (p * (1 - p) / n) ** 0.5, keep
    torch.testing.assert_close(out[kept], inp[kept] / (1 - p), rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind", ["adm", "ncsnpp"])
def test_remat_equals_no_remat_with_dropout_on(kind):
    x = torch.randn(2, 8, 8, 3, generator=torch.Generator().manual_seed(2))
    t = torch.tensor([10.0, 700.0])
    results = []
    for remat in (False, True):
        net = _dropout_net(0.3, remat=remat, kind=kind).train()
        with ptrain.StepRng(5, 7).dropout("cpu"):
            loss = net(x, t).square().mean()
        grads = torch.autograd.grad(loss, [p for p in net.parameters() if p.requires_grad])
        results.append((loss.detach(), grads))
    torch.testing.assert_close(results[0][0], results[1][0], rtol=0, atol=0)
    for g0, g1 in zip(results[0][1], results[1][1]):
        torch.testing.assert_close(g0, g1, rtol=1e-6, atol=1e-7)


def _init_pair(kind):
    """(the JAX init as a torch state dict, the port's init_train_ draw)."""
    from dpm_solver_tpu.models import ADMConfig as JADM, ADMUNet as JADMUNet
    from dpm_solver_tpu.models import NCSNpp as JNCSNpp, NCSNppConfig as JNCSN
    from dpm_solver_tpu_torch.utils.convert import (adm_unet_state_dict_from_flax,
                                                    ncsnpp_state_dict_from_flax)

    key = jax.random.PRNGKey(3)
    if kind == "ddpm":
        cfg = JDDPMUNetConfig.tiny(resolution=8)
        params = jax.jit(JDDPMUNet(cfg).init)(key, jnp.zeros((1, 8, 8, 3)), jnp.ones((1,)))
        net = DDPMUNet(DDPMUNetConfig(**dataclasses.asdict(cfg)), device="cpu")
        want = ddpm_unet_state_dict_from_flax(params)
    elif kind == "ncsnpp":
        over = dict(nf=64, image_size=8, fir=True, progressive="output_skip",
                    progressive_input="residual", embedding_type="fourier")
        cfg = JNCSN.tiny(**over)
        params = jax.jit(JNCSNpp(config=cfg).init)(key, jnp.zeros((1, 8, 8, 3)),
                                                   jnp.ones((1,)))
        pcfg = NCSNppConfig.tiny(**over)
        net = NCSNpp(pcfg, device="cpu")
        want = ncsnpp_state_dict_from_flax(params, pcfg)
    else:
        over = dict(image_size=8, in_channels=4, out_channels=4, model_channels=64,
                    attention_resolutions=(1,), channel_mult=(1,), num_classes=10,
                    use_spatial_transformer=True, context_dim=32, num_head_channels=32)
        cfg = JADM(**over)
        params = jax.jit(lambda k: JADMUNet(config=cfg).init(
            k, jnp.zeros((1, 8, 8, 4)), jnp.ones((1,)), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, 3, 32)), deterministic=True))(key)
        pcfg = ADMConfig(**over)
        net = ADMUNet(pcfg, device="cpu")
        want = adm_unet_state_dict_from_flax(params, pcfg)
    init_train_(net, torch.Generator().manual_seed(3))
    return want, dict(net.named_parameters())


@pytest.mark.parametrize("kind", ["ddpm", "ncsnpp", "adm"])
def test_training_init_draws_the_jax_distribution(kind):
    want, got = _init_pair(kind)
    assert set(got) <= set(want)
    for k, p in got.items():
        w, g = want[k].float(), p.detach().float()
        assert w.shape == g.shape, k
        if bool((w == w.flatten()[0]).all()):
            # zeros (biases, zero-init projections) and norm scales: equal
            torch.testing.assert_close(g, w, rtol=0, atol=0, msg=k)
            continue
        if w.numel() < 64:  # too short for its std: within the same bound
            assert float(g.abs().max()) <= 3 * float(w.abs().max()), k
            continue
        ratio = float(g.std()) / float(w.std())
        assert 0.85 <= ratio <= 1.15, (k, ratio)
        assert float(g.abs().max()) <= 1.05 * float(w.abs().max()) * 1.6 + 1e-12, k
