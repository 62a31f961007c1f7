"""The port's score-matching losses and step (dpm_solver_tpu_torch/
training/losses.py) against the JAX package's, on the CPU.

`make_score_train_step` over each loss, fed the JAX loss's own draws (t
and z, or labels and z, from its split of `fold_in(rng, step)`), 3 steps
of Adam after a linear warmup from 0 with global-norm clipping:
  * on a one-level NCSN++ VE (Fourier features; dropout 0; the JAX init
    through the port's converter) with path H's loss, `sde_loss_fn` on the
    continuous VE SDE with the sigma^2 weighting and sum reduction;
  * on a toy score net (x W * a + b log(1 + t), the same three tensors on
    both sides: each JAX step compiles in a fraction of a second), every
    other loss: `sde_loss_fn` on the continuous VP SDE with the sigma^2
    weighting and mean reduction, and with likelihood weighting and sum
    reduction; `smld_loss_fn` (descending-sigma NCSN, discrete VE labels)
    and `ddpm_loss_fn` (discrete VP eps-MSE): tests/test_torch_legacy_train.py.
The loss and the gradients' norm each step within 1e-5 (relative); Adam's
moments after 3 steps within 1e-4 of each tensor's largest element plus
1e-7 of the model's largest; the parameters and the EMA within 1e-3 of the
summed learning rates, or within it where a tensor's gradient is rounding
noise (tests/test_torch_train.py says why updates are held in units of lr).
`make_eval_loss_step` gives the loss on the EMA and leaves the trained
parameters in place. A JAX `TrainState` of the NCSN++ (from a torch init
bridged through the JAX package's `ncsnpp_convert.params_from_torch`)
carries across and continues to the same place.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu import sde as jsde
from dpm_solver_tpu.models import NCSNpp as JNCSNpp
from dpm_solver_tpu.models import NCSNppConfig as JNCSNppConfig
from dpm_solver_tpu.models.ncsnpp_convert import params_from_torch
from dpm_solver_tpu.score import get_score_fn as jget_score_fn
from dpm_solver_tpu.training import losses as jlosses
from dpm_solver_tpu.training import train as jtrain
from dpm_solver_tpu_torch import sde as psde
from dpm_solver_tpu_torch.models import NCSNpp, NCSNppConfig
from dpm_solver_tpu_torch.models.init import init_train_
from dpm_solver_tpu_torch.score import get_score_fn
from dpm_solver_tpu_torch.training import losses as plosses
from dpm_solver_tpu_torch.training import train as ptrain
from dpm_solver_tpu_torch.utils.convert import (_find_adam, ncsnpp_state_dict_from_flax,
                                                train_state_from_flax)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's CPU work: these small shapes gain
    nothing from more, and the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Toy(torch.nn.Module):
    """A toy score net: x W * a + b log(1 + t)."""

    def __init__(self, rng):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(rng.standard_normal((3, 3)) * 0.5,
                                                 dtype=torch.float32))
        self.a = torch.nn.Parameter(torch.tensor(rng.standard_normal(3), dtype=torch.float32))
        self.b = torch.nn.Parameter(torch.tensor(rng.standard_normal(3), dtype=torch.float32))

    def forward(self, x, t):
        return (x @ self.w) * self.a + self.b * torch.log1p(t.float())[:, None, None, None]


def _jax_toy(p, x, t):
    return (x @ p["w"]) * p["a"] + p["b"] * jnp.log1p(t.astype(jnp.float32))[:, None, None, None]

LR, WARMUP, CLIP, EMA = 1e-3, 2, 1.0, 0.9
# path H's network at one level (the JAX step's compile sets this file's
# time, and grows with the levels): Fourier features, a res block and an
# attention a side
VE_NET = dict(nf=16, ch_mult=(1,), num_res_blocks=1, attn_resolutions=(8,), image_size=8,
              embedding_type="fourier")

# name: (network: "ncsnpp" or "toy", SDE, loss, loss kwargs)
CASES = {
    "vp-sigma2-mean": ("toy", "vp", "sde", dict(reduce_mean=True, likelihood_weighting=False)),
    "vp-likelihood-sum": ("toy", "vp", "sde", dict(reduce_mean=False,
                                                   likelihood_weighting=True)),
    "ve-sigma2-sum-ncsnpp": ("ncsnpp", "ve", "sde", dict(reduce_mean=False)),
    "smld": ("toy", "ve10", "smld", dict(reduce_mean=False)),
    "ddpm": ("toy", "vp", "ddpm", dict(reduce_mean=True)),
}


def _sdes(kind):
    if kind == "vp":
        return jsde.VPSDE(), psde.VPSDE()
    if kind == "ve":
        return jsde.VESDE(sigma_max=50.0), psde.VESDE(sigma_max=50.0)
    return jsde.VESDE(sigma_max=50.0, N=10), psde.VESDE(sigma_max=50.0, N=10)


def _losses(case):
    kind_net, kind, loss, kw = CASES[case]
    if kind_net == "ncsnpp":
        jcfg, pcfg = JNCSNppConfig.tiny(**VE_NET), NCSNppConfig.tiny(**VE_NET)
        model = JNCSNpp(config=jcfg)
        params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)), jnp.ones((1,)),
                            deterministic=True)
        net = NCSNpp(pcfg, device="cpu")
        net.load_state_dict(ncsnpp_state_dict_from_flax(params, pcfg))
        japply = lambda p, x, t: model.apply(p, x, t, deterministic=True)
        to_torch = lambda tree: ncsnpp_state_dict_from_flax(tree, pcfg)
    else:
        net = _Toy(np.random.default_rng(7))
        params = {k: jnp.asarray(v.detach().numpy()) for k, v in net.named_parameters()}
        japply = _jax_toy
        to_torch = lambda tree: {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}
    j_sde, p_sde = _sdes(kind)
    papply = lambda x, t: net(x, t.float())
    if loss == "sde":
        jfn = jlosses.sde_loss_fn(j_sde, lambda p, x, t: jget_score_fn(
            j_sde, lambda xx, tt: japply(p, xx, tt), continuous=True)(x, t), **kw)
        pfn = plosses.sde_loss_fn(p_sde, get_score_fn(p_sde, papply, continuous=True), **kw)
    else:
        make_j = jlosses.smld_loss_fn if loss == "smld" else jlosses.ddpm_loss_fn
        make_p = plosses.smld_loss_fn if loss == "smld" else plosses.ddpm_loss_fn
        jfn = make_j(j_sde, lambda p, x, labels: japply(p, x, labels.astype(jnp.float32)), **kw)
        pfn = make_p(p_sde, papply, **kw)
    return params, net, to_torch, j_sde, loss, jfn, pfn


def _draws(loss, j_sde, state, x0, rng):
    """The JAX loss's draws at this step: (t, z) or (labels, z)."""
    first, rng_z, _ = jax.random.split(jax.random.fold_in(rng, state.step), 3)
    z = torch.tensor(np.asarray(jax.random.normal(rng_z, x0.shape, x0.dtype)))
    if loss == "sde":
        t = jax.random.uniform(first, (x0.shape[0],), minval=1e-5, maxval=j_sde.T)
        return {"t": torch.tensor(np.asarray(t)), "z": z}
    labels = jax.random.randint(first, (x0.shape[0],), 0, j_sde.N)
    return {"labels": torch.tensor(np.asarray(labels)).long(), "z": z}


def _check_state(jstate, pstate, to_torch, lr_sum):
    """Adam's moments, the parameters and the EMA of the port's state against
    the JAX state's, within the module docstring's bounds."""
    adam = _find_adam(jstate.opt_state)
    moments = {n: to_torch(getattr(adam, n)) for n in ("mu", "nu")}
    for name, want in moments.items():
        top = max(float(want[k].abs().max()) for k in pstate.params)
        for k, got in pstate.opt_state[name].items():
            bound = 1e-4 * float(want[k].abs().max()) + 1e-7 * top
            assert float((got - want[k]).abs().max()) <= bound, (name, k)
    top = max(float(moments["mu"][k].abs().max()) for k in pstate.params)
    for tree, got in ((jstate.params, pstate.params), (jstate.ema_params, pstate.ema_params)):
        want = to_torch(tree)
        for k in got:
            err = float((got[k].detach() - want[k]).abs().max()) / lr_sum
            noise = float(moments["mu"][k].abs().max()) <= 1e-6 * top
            assert err <= (1.0 if noise else 1e-3), (k, err)


def _run_case(case):
    params, net, to_torch, j_sde, loss, jfn, pfn = _losses(case)
    jtx = jtrain.make_optimizer(LR, WARMUP, CLIP)
    jstate, _ = jtrain.make_train_state(params, tx=jtx, ema_rate=EMA)
    jstep = jax.jit(jlosses.make_score_train_step(jfn, jtx))
    ptx = ptrain.make_optimizer(LR, WARMUP, CLIP)
    pstate, _ = ptrain.make_train_state(net, tx=ptx, ema_rate=EMA)
    pstep = plosses.make_score_train_step(pfn, ptx)
    rng = jax.random.PRNGKey(2)
    data = np.random.default_rng(1)
    for _ in range(3):
        x0 = data.standard_normal((4, 8, 8, 3)).astype(np.float32)
        draws = _draws(loss, j_sde, jstate, jnp.asarray(x0), rng)
        jstate, jm = jstep(jstate, jnp.asarray(x0), rng)
        pstate, pm = pstep(pstate, torch.tensor(x0), 0, **draws)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    _check_state(jstate, pstate, to_torch, sum(ptx.lr(c) for c in range(3)))
    trained = {k: v.detach().clone() for k, v in pstate.params.items()}
    ev = plosses.make_eval_loss_step(pfn)(pstate, torch.tensor(x0), 0, **draws)
    assert torch.isfinite(ev)
    for k, v in pstate.params.items():
        assert torch.equal(v.detach(), trained[k])


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][2] == "sde"])
def test_score_train_step_matches_jax(case):
    _run_case(case)


def test_ncsnpp_jax_train_state_carries_across():
    """A torch init of the one-level NCSN++ VE (`init_train_`), bridged into
    Flax by the JAX package's `ncsnpp_convert.params_from_torch`, one JAX
    step of path H's loss, the JAX `TrainState` carried across with
    `utils.convert.train_state_from_flax` (through
    `ncsnpp_state_dict_from_flax`), then two more steps on each side on the
    JAX draws: the same losses and the same state, within the bounds above."""
    pcfg, jcfg = NCSNppConfig.tiny(**VE_NET), JNCSNppConfig.tiny(**VE_NET)
    net = init_train_(NCSNpp(pcfg, device="cpu"), torch.Generator().manual_seed(11))
    params = params_from_torch({k: v.numpy() for k, v in net.state_dict().items()}, jcfg)
    model = JNCSNpp(config=jcfg)
    j_sde, p_sde = _sdes("ve")
    jfn = jlosses.sde_loss_fn(j_sde, lambda p, x, t: jget_score_fn(
        j_sde, lambda xx, tt: model.apply(p, xx, tt, deterministic=True), continuous=True)(x, t),
        reduce_mean=False)
    jtx = jtrain.make_optimizer(LR, WARMUP, CLIP)
    jstate, _ = jtrain.make_train_state(params, tx=jtx, ema_rate=EMA)
    jstep = jax.jit(jlosses.make_score_train_step(jfn, jtx))
    rng, data = jax.random.PRNGKey(3), np.random.default_rng(4)
    xs = [data.standard_normal((4, 8, 8, 3)).astype(np.float32) for _ in range(3)]
    jstate, _ = jstep(jstate, jnp.asarray(xs[0]), rng)
    port = NCSNpp(pcfg, device="cpu")
    ptx = ptrain.make_optimizer(LR, WARMUP, CLIP)
    to_torch = lambda tree: ncsnpp_state_dict_from_flax(tree, pcfg)
    pstate = train_state_from_flax(jstate, to_torch, port, ptx)
    assert pstate.step == 1 and pstate.opt_state["count"] == 1
    pfn = plosses.sde_loss_fn(p_sde, get_score_fn(p_sde, lambda x, t: port(x, t.float()),
                                                  continuous=True), reduce_mean=False)
    pstep = plosses.make_score_train_step(pfn, ptx)
    for x0 in xs[1:]:
        draws = _draws("sde", j_sde, jstate, jnp.asarray(x0), rng)
        jstate, jm = jstep(jstate, jnp.asarray(x0), rng)
        pstate, pm = pstep(pstate, torch.tensor(x0), 0, **draws)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
    _check_state(jstate, pstate, to_torch, ptx.lr(1) + ptx.lr(2))
