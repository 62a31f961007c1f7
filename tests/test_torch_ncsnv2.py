"""The port's NCSNv2 / NCSNv1 (dpm_solver_tpu_torch/models/ncsnv2.py) against the
JAX package's `dpm_solver_tpu/models/ncsnv2.py`, on the CPU.

Random weights of the JAX init's shapes (no norm at its identity) go into
the port through `utils/convert.py::ncsnv2_state_dict_from_flax`; the same
inputs go through both:

- the forward of NCSNv2 tiny, NCSNv1 tiny (class-conditional norms, average
  pooling in CRP) and the 128 px layout (five levels, 4x channel mults) at
  tiny nf, within 2e-5 of max|out| (tests/test_models.py:64), with equal
  parameter counts;
- InstanceNorm++ and conditional InstanceNorm++ alone, within 1e-6;
- `get_sigmas`, equal;
- `ncsnv2_params_from_reference`: the port's copy maps a score_sde
  reference tree (auto-numbered `ResidualBlock_i`, `RefineBlock_j`,
  `RCUBlock_k`, `ConvMeanPool_k`, ... as tests/test_ncsnv2.py reads them from
  the reference model; here synthesised, since the reference is not
  mounted) to the same tree as the JAX function, leaf for leaf;
- the parameter count of every preset equal to the JAX model's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu.models import ncsnv2 as J
from dpm_solver_tpu_torch.models import ncsnv2 as P
from dpm_solver_tpu_torch.utils.convert import ncsnv2_state_dict_from_flax

NET_TOL = 2e-5        # of max|out|: tests/test_models.py:64
NORM_TOL = 1e-6
PX128 = dict(image_size=32, level_specs=((1, 1), (2, 1), (2, 1), (4, 2), (4, 4)),
             refine_mults=(4, 2, 2, 1, 1))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's CPU work: these small shapes gain
    nothing from more, and the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a)))
                        .astype(np.float32), params)


def _random_params(model, seed, *args):
    """Random weights of the init's shapes (without compiling the init): a
    kernel normal(1 / sqrt(fan_in)), any other leaf 1 + normal(0.05) (the
    norms' scales, the embeddings) or normal(0.05) (biases, betas)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        z = rng.standard_normal(leaf.shape)
        if "kernel" in name:
            return (z / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        offset = 0.0 if ("bias" in name or "beta" in name) else 1.0
        return (offset + 0.05 * z).astype(np.float32)

    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _count(tree):
    return sum(int(np.prod(np.shape(leaf))) for leaf in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("variant", ["v2", "v1", "px128"])
def test_forward_matches_jax(variant):
    kw = {"v2": {}, "v1": dict(conditional_norm=True), "px128": PX128}[variant]
    jcfg, pcfg = J.NCSNv2Config.tiny(**kw), P.NCSNv2Config.tiny(**kw)
    s = jcfg.image_size
    x = np.random.default_rng(1).uniform(0.0, 1.0, (2, s, s, 3)).astype(np.float32)
    labels = np.asarray([0, 7])
    model = J.NCSNv2(config=jcfg)
    params = _random_params(model, 2, x, labels)
    want = np.asarray(jax.jit(model.apply)(params, x, labels))
    net = P.NCSNv2(pcfg, device="cpu")
    net.load_state_dict(ncsnv2_state_dict_from_flax(params, pcfg))
    assert sum(p.numel() for p in net.parameters()) == _count(params)
    with torch.no_grad():
        got = net(torch.tensor(x), torch.tensor(labels)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=NET_TOL * np.abs(want).max())


def test_instance_norm_plus_matches_jax():
    x = (2.0 * np.random.default_rng(2).standard_normal((3, 5, 5, 8)) + 1.0).astype(np.float32)
    mod = J.InstanceNormPlus()
    p = _perturbed(mod.init(jax.random.PRNGKey(3), x), 4)
    want = np.asarray(mod.apply(p, x))
    port = P.InstanceNormPlus(8)
    port.load_state_dict({k: torch.tensor(v.reshape(-1)) for k, v in p["params"].items()})
    with torch.no_grad():
        np.testing.assert_allclose(port(torch.tensor(x)).numpy(), want, rtol=0, atol=NORM_TOL)


def test_cond_instance_norm_plus_matches_jax():
    x = np.random.default_rng(5).standard_normal((3, 5, 5, 8)).astype(np.float32)
    y = np.asarray([0, 3, 9])
    mod = J.CondInstanceNormPlus(num_classes=10)
    p = _perturbed(mod.init(jax.random.PRNGKey(6), x, y), 7)
    want = np.asarray(mod.apply(p, x, y))
    port = P.CondInstanceNormPlus(8, num_classes=10)
    port.load_state_dict({"embed.weight": torch.tensor(p["params"]["embed"]["embedding"])})
    with torch.no_grad():
        got = port(torch.tensor(x), torch.tensor(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=NORM_TOL)


def test_get_sigmas_equals_jax():
    for args in ((0.01, 50.0, 232), (0.01, 90.0, 500), (0.01, 1.0, 10)):
        np.testing.assert_array_equal(P.get_sigmas(*args), J.get_sigmas(*args))


def _reference_tree(cfg):
    """A score_sde reference NCSNv2 tree, its leaves distinct numbers: the
    auto-numbered names the reference model's init makes (ncsnv2.py:45-113 /
    NCSNv2_128: Conv_0, ResidualBlock_i, RefineBlock_j, the output norm and
    Conv_1), with the blocks' own children."""
    ids = iter(range(1, 1_000_000))

    def conv():
        return {"kernel": np.float32(next(ids)), "bias": np.float32(next(ids))}

    def norm():
        return {k: np.float32(next(ids)) for k in ("alpha", "gamma", "beta")}

    def resblock(resample, dilation, shortcut):
        sub = {"InstanceNorm2dPlus_0": norm(), "InstanceNorm2dPlus_1": norm()}
        if resample == "down" and dilation == 1:
            sub.update(Conv_0=conv(), ConvMeanPool_0={"Conv_0": conv()},
                       ConvMeanPool_1={"Conv_0": conv()})
        else:
            n = 3 if resample == "down" or shortcut else 2
            sub.update({f"Conv_{c}": conv() for c in range(n)})
        return sub

    def refine(n_inputs, end):
        sub = {f"RCUBlock_{i}": {f"Conv_{c}": conv() for c in range(4)}
               for i in range(n_inputs)}
        sub[f"RCUBlock_{n_inputs}"] = {f"Conv_{c}": conv() for c in range(6 if end else 2)}
        if n_inputs > 1:
            sub["MSFBlock_0"] = {f"Conv_{i}": conv() for i in range(n_inputs)}
        sub["CRPBlock_0"] = {f"Conv_{i}": conv() for i in range(2)}
        return sub

    tree, rb = {"Conv_0": conv()}, 0
    for i, (mult, dil) in enumerate(cfg.level_specs):
        tree[f"ResidualBlock_{rb}"] = (resblock(None, 1, mult != 1) if i == 0
                                       else resblock("down", dil, True))
        tree[f"ResidualBlock_{rb + 1}"] = resblock(None, dil, False)
        rb += 2
    n = len(cfg.level_specs)
    for j in range(len(cfg.refine_mults)):
        tree[f"RefineBlock_{j}"] = refine(1 if j == 0 else 2, j == n - 1)
    tree["InstanceNorm2dPlus_0"] = norm()
    tree["Conv_1"] = conv()
    return {"params": tree}


@pytest.mark.parametrize("kw", [{}, PX128, dict(level_specs=((2, 1), (2, 1), (2, 2), (2, 4)))],
                         ids=["cifar10", "px128", "level0_shortcut"])
def test_params_from_reference_maps_as_jax(kw):
    cfg_j, cfg_p = J.NCSNv2Config.tiny(**kw), P.NCSNv2Config.tiny(**kw)
    tree = _reference_tree(cfg_j)
    want = J.ncsnv2_params_from_reference(tree, cfg_j)
    got = P.ncsnv2_params_from_reference(tree, cfg_p)
    flat = lambda t: {jax.tree_util.keystr(k): float(v)
                      for k, v in jax.tree_util.tree_leaves_with_path(t)}
    assert flat(got) == flat(want)
    assert len(flat(got)) > 100
    with pytest.raises(AssertionError):
        P.ncsnv2_params_from_reference(tree, dataclasses.replace(cfg_p, conditional_norm=True))


@pytest.mark.parametrize("preset", ["cifar10", "px128", "px256", "tiny", "v1"])
def test_parameter_count_of_every_preset_equals_jax(preset):
    def make(mod):
        if preset == "v1":
            return dataclasses.replace(mod.NCSNv2Config.cifar10(), conditional_norm=True,
                                       num_scales=10)
        return getattr(mod.NCSNv2Config, preset)()

    jcfg, pcfg = make(J), make(P)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    s = jcfg.image_size
    shapes = jax.eval_shape(J.NCSNv2(config=jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, s, s, 3)), jnp.zeros((1,), jnp.int32))
    assert sum(p.numel() for p in P.NCSNv2(pcfg, device="meta").parameters()) == _count(shapes)
