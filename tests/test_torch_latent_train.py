"""The port's latent-diffusion step (dpm_solver_tpu_torch/training/latent.py)
and its Adafactor (training/optim.py) against the JAX package's, on the CPU.

`make_latent_train_step` on latents (no encode: the first stage is frozen
and outside the gradient), fed the JAX step's own draws (t, eps and the
`cond_dropout` mask from its split of `fold_in(rng, step)`), 3 steps:
  * on a small conditional ADM UNet with a spatial transformer (a random
    torch init carried into Flax by the JAX package's `convert_adm_unet`,
    so every layer has a gradient): the v target with `cond_dropout` 0.5
    against a null context, under Adam after a linear warmup from 0 with
    global-norm clipping;
  * on a toy conditional net of Linear layers (the same weights on both
    sides; each JAX step compiles in a fraction of a second): the eps and
    x0 targets under Adam, and eps under Adafactor (optax 0.2.6's, with
    min_dim_size_to_factor 32 so its square and its 64 x 128 weights
    factor: the factored axes must be the Flax layout's on the torch
    layout), after the same warmup and clip.
The loss and the gradients' norm each step within 1e-5 (relative); the
parameters and the EMA after 3 steps, in units of the summed learning rates
(Adam), or of the summed learning rates times each tensor's rms
(Adafactor's update scale: `scale_by_param_block_rms`), as
tests/test_torch_train.py says: 99.9% of each tensor's elements within
1e-3, and every element within 1 (an element whose gradient is near 0 has
an update that a rounding-level change of the gradient moves by up to
the learning rate: Adam divides it by its own rms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dpm_solver_tpu.models import ADMConfig as JADMConfig
from dpm_solver_tpu.models import ADMUNet as JADMUNet
from dpm_solver_tpu.training import latent as jlatent
from dpm_solver_tpu.training import train as jtrain
from dpm_solver_tpu.utils.convert import convert_adm_unet
from dpm_solver_tpu_torch.models import ADMConfig, ADMUNet, init_random_
from dpm_solver_tpu_torch.pipelines.stable_diffusion import make_ldm_betas
from dpm_solver_tpu_torch.training import latent as platent
from dpm_solver_tpu_torch.training import train as ptrain
from dpm_solver_tpu_torch.training.optim import Adafactor, flax_layouts, linear_schedule
from dpm_solver_tpu_torch.utils.convert import adm_unet_state_dict_from_flax


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's CPU work: these small shapes gain
    nothing from more, and the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# one level (a res block and a transformer in, in the middle and out): the
# JAX step's compile, which sets this file's time, grows with the levels
UNET = dict(image_size=8, in_channels=4, model_channels=64, out_channels=4, num_res_blocks=1,
            attention_resolutions=(1,), channel_mult=(1,), num_heads=2,
            use_spatial_transformer=True, transformer_depth=1, context_dim=16)
LR, WARMUP, CLIP, EMA, MIN_FACTOR = 1e-3, 2, 1.0, 0.9, 32
BETAS = make_ldm_betas(1000)


class _Toy(torch.nn.Module):
    """A toy conditional latent net: Linear layers over the channels (4 ->
    64 -> 64 -> 128 -> 4), the context's mean and sin(t / 1000) added after
    the first; no biases (the JAX twin's params are the weights, (in, out))."""

    def __init__(self, gen):
        super().__init__()
        dims = {"w_in": (4, 64), "w_sq": (64, 64), "w_mid": (64, 128), "w_out": (128, 4),
                "w_ctx": (16, 64)}
        for k, (i, o) in dims.items():
            lin = torch.nn.Linear(i, o, bias=False)
            torch.nn.init.normal_(lin.weight, std=i ** -0.5, generator=gen)
            setattr(self, k, lin)

    def forward(self, z, t, context):
        h = self.w_in(z) + self.w_ctx(context.mean(1))[:, None, None, :]
        h = torch.tanh(self.w_sq(h + torch.sin(t / 1000)[:, None, None, None]))
        return self.w_out(torch.tanh(self.w_mid(h)))


def _jax_toy(p, z, t, context):
    h = z @ p["w_in"] + (context.mean(1) @ p["w_ctx"])[:, None, None, :]
    h = jnp.tanh((h + jnp.sin(t / 1000)[:, None, None, None]) @ p["w_sq"])
    return jnp.tanh(h @ p["w_mid"]) @ p["w_out"]


def _txs(opt):
    if opt == "adam":
        return jtrain.make_optimizer(LR, WARMUP, CLIP), ptrain.make_optimizer(LR, WARMUP, CLIP)
    jtx = optax.chain(optax.clip_by_global_norm(CLIP), optax.adafactor(
        learning_rate=optax.linear_schedule(0.0, LR, WARMUP), min_dim_size_to_factor=MIN_FACTOR))
    return jtx, None


@pytest.mark.parametrize("net_kind,param,opt,p_drop", [
    ("unet", "v", "adam", 0.5), ("toy", "eps", "adam", 0.0), ("toy", "x0", "adam", 0.0),
    ("toy", "eps", "adafactor", 0.0)])
def test_latent_train_step_matches_jax(net_kind, param, opt, p_drop):
    if net_kind == "unet":
        pcfg, jcfg = ADMConfig(**UNET), JADMConfig(**UNET)
        net = init_random_(ADMUNet(pcfg, device="cpu"), torch.Generator().manual_seed(5))
        params = convert_adm_unet({k: v.numpy() for k, v in net.state_dict().items()}, jcfg)
        model = JADMUNet(config=jcfg)
        japply = lambda p, z, t, c: model.apply(p, z, t, None, c, deterministic=True)
        papply = lambda z, t, c: net(z, t, None, c)
        to_torch = lambda tree: adm_unet_state_dict_from_flax(tree, pcfg)
    else:
        net = _Toy(torch.Generator().manual_seed(5))
        params = {k: jnp.asarray(m.weight.detach().numpy().T) for k, m in net.named_children()}
        japply, papply = _jax_toy, net
        to_torch = lambda tree: {f"{k}.weight": torch.tensor(np.asarray(v).T)
                                 for k, v in tree.items()}
    jtx, ptx = _txs(opt)
    if ptx is None:
        ptx = Adafactor(linear_schedule(0.0, LR, WARMUP), CLIP, layouts=flax_layouts(net),
                        min_dim_size_to_factor=MIN_FACTOR)
        assert sum(ptx.factored_axes(k, p) is not None for k, p in net.named_parameters()) == 2
    uc = np.zeros((1, 16), np.float32)
    jstep = jax.jit(jlatent.make_latent_train_step(
        japply, jtx, BETAS, parameterization=param, cond_dropout=p_drop,
        uncond_context=uc if p_drop else None))
    jstate, _ = jtrain.make_train_state(params, tx=jtx, ema_rate=EMA)
    pstep = platent.make_latent_train_step(
        papply, ptx, BETAS, parameterization=param, cond_dropout=p_drop,
        uncond_context=torch.tensor(uc) if p_drop else None)
    pstate, _ = ptrain.make_train_state(net, tx=ptx, ema_rate=EMA)
    rms = {k: max(float(v.detach().square().mean().sqrt()), 1e-3)
           for k, v in pstate.params.items()}
    rng = jax.random.PRNGKey(9)
    data = np.random.default_rng(2)
    drops = []
    for _ in range(3):
        z = data.standard_normal((4, 8, 8, 4)).astype(np.float32)
        ctx = data.standard_normal((4, 3, 16)).astype(np.float32)
        rng_t, rng_e, _, rng_c = jax.random.split(jax.random.fold_in(rng, jstate.step), 4)
        t = jax.random.randint(rng_t, (4,), 0, len(BETAS))
        eps = jax.random.normal(rng_e, z.shape, jnp.float32)
        drop = jax.random.bernoulli(rng_c, p_drop, (4,)) if p_drop else None
        drops += [] if drop is None else list(np.asarray(drop))
        jstate, jm = jstep(jstate, None, jnp.asarray(z), jnp.asarray(ctx), rng)
        pstate, pm = pstep(pstate, torch.tensor(z), torch.tensor(ctx), 0,
                           t=torch.tensor(np.asarray(t)).long(), eps=torch.tensor(np.asarray(eps)),
                           drop=None if drop is None else torch.tensor(np.asarray(drop)))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    if p_drop:  # the null context replaced some samples' and kept others'
        assert any(drops) and not all(drops)
    lr_sum = sum(ptx.lr(c) for c in range(3))
    for tree, got in ((jstate.params, pstate.params), (jstate.ema_params, pstate.ema_params)):
        want = to_torch(tree)
        for k in got:
            unit = lr_sum * (rms[k] if opt == "adafactor" else 1.0)
            err = (got[k].detach() - want[k]).abs().flatten() / unit
            q999 = float(torch.quantile(err, 0.999)) if err.numel() > 1 else float(err[0])
            assert q999 <= 1e-3 and float(err.max()) <= 1.0, (k, q999, float(err.max()))


def test_adafactor_factors_the_flax_layouts_axes():
    """Each parameter's factored axes are optax's `_factored_dims` on its
    Flax shape (the two largest axes, ties in Flax order: a conv's (3, 3, I,
    O) gives (I, O), which is (1, 0) on the torch (O, I, 3, 3)), mapped to
    the torch axes through `flax_layouts`."""
    from optax._src.factorized import _factored_dims

    net = ADMUNet(ADMConfig(**UNET), device="cpu")
    tx = Adafactor(1e-3, layouts=flax_layouts(net), min_dim_size_to_factor=MIN_FACTOR)
    layouts = flax_layouts(net)
    seen = 0
    for k, p in net.named_parameters():
        perm = layouts[k]
        flax_shape = tuple(p.shape[i] for i in perm)
        want = _factored_dims(flax_shape, True, MIN_FACTOR)
        got = tx.factored_axes(k, p)
        assert (got is None) == (want is None), k
        if want is not None:
            seen += 1
            assert got == (perm[want[0]], perm[want[1]]), k
    assert seen > 5
