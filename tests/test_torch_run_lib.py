"""The port's configs and training orchestration (dpm_solver_tpu_torch/
configs.py, run_lib.py) against the JAX package's, on the CPU.

- The registry holds the JAX package's entries, name for name, and every
  entry's fields equal the JAX entry's: sampling, training, diffusion,
  data, eval and the rest, and the model config's fields (but the JAX
  ADMConfig's `quant`, the serving int8 switch of ops/quant.py, not
  ported); the NCSNv2 / NCSN entries' `NCSNv2Config` too.
- `build_model` builds every entry (on the meta device, no memory), with
  the JAX model's parameter count at the configurations the paths and the
  benchmarks train (NCSN++ continuous VE, the CIFAR-10 DDPM, the tiny test
  config, NCSNv2 and NCSNv1 on CIFAR-10).
- `score_net_apply` on an NCSNv2 truncates float labels to the integer
  sigma index, as the JAX one (astype(int32)): the same scores as the JAX
  model through the converter, within 2e-5 of max|out|.
- `run_lib.train` takes steps on `tiny_ve_ncsnv2` (the legacy SMLD loss on
  an NCSNv2), and drives all three branches (continuous SDE with live
  dropout, the legacy discrete loss, the DDPM eps-MSE) and writes meta
  checkpoints at `snapshot_freq_for_preemption` (keeping one) and full ones
  at `snapshot_freq`; the JAX package's own resume test's semantics
  (tests/test_run_lib.py:84-106: the meta checkpoint of loop index 4 holds
  step 5, and a restart resumes from it).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from dpm_solver_tpu import configs as jconfigs
from dpm_solver_tpu_torch import configs as pconfigs
from dpm_solver_tpu_torch import run_lib
from dpm_solver_tpu_torch.training.checkpoints import CheckpointManager


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's CPU work: these small shapes gain
    nothing from more, and the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NAMES = jconfigs.list_configs()
NOT_PORTED = {"ADMConfig": {"quant"}}


def test_registry_holds_the_jax_entries():
    assert pconfigs.list_configs() == NAMES
    with pytest.raises(KeyError):
        pconfigs.get_config("nope")
    assert pconfigs.get_config("cifar10_ddpm", seed=7).seed == 7


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("name", NAMES)
def test_config_fields_equal_the_jax_entry(name):
    j, p = jconfigs.get_config(name), pconfigs.get_config(name)
    jf, pf = _fields(j), _fields(p)
    assert set(jf) == set(pf)
    for key in jf:
        if key in ("model_config", "classifier_config"):
            continue
        plain = lambda v: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
        assert plain(pf[key]) == plain(jf[key]), key
    for key in ("model_config", "classifier_config"):
        jm, pm = jf[key], pf[key]
        if jm is None:
            assert pm is None
            continue
        assert type(pm).__name__ == type(jm).__name__
        skip = NOT_PORTED.get(type(jm).__name__, set())
        jmf = {k: v for k, v in _fields(jm).items() if k not in skip}
        assert _fields(pm) == jmf, key


@pytest.mark.parametrize("name", NAMES)
def test_build_model_builds_every_ported_family(name):
    model, init_fn = run_lib.build_model(pconfigs.get_config(name), device="meta")
    assert sum(p.numel() for p in model.parameters()) > 0 and callable(init_fn)
    assert not model.training


def _jax_param_count(cfg):
    from dpm_solver_tpu.run_lib import build_model

    _, init_fn = build_model(cfg)
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
    return sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))


@pytest.mark.parametrize("name", ["score_sde_cifar10_ve_ncsnpp_continuous", "cifar10_ddpm",
                                  "tiny_test", "score_sde_cifar10_ve_ncsnv2",
                                  "score_sde_cifar10_ve_ncsn"])
def test_build_model_matches_the_jax_parameter_count(name):
    model, _ = run_lib.build_model(pconfigs.get_config(name), device="meta")
    assert sum(p.numel() for p in model.parameters()) == _jax_param_count(
        jconfigs.get_config(name))


def _tiny(name, workdir, **model_over):
    """A config entry at 16 px with a tiny net of its family (dropout 0.1)."""
    from dpm_solver_tpu_torch.models import DDPMUNetConfig, NCSNppConfig

    cfg = pconfigs.get_config(name)
    if cfg.model_family == "ncsnpp":
        mc = NCSNppConfig.tiny(nf=16, num_res_blocks=1, dropout=0.1, **model_over)
    else:
        mc = dataclasses.replace(DDPMUNetConfig.tiny(resolution=16), dropout=0.1)
    return dataclasses.replace(
        cfg, model_config=mc, workdir=str(workdir),
        data=dataclasses.replace(cfg.data, image_size=16),
        training=dataclasses.replace(cfg.training, warmup=2, snapshot_freq_for_preemption=2,
                                     snapshot_freq=4, log_freq=100, lr=1e-3))


BRANCHES = {  # the config entry, the model overrides, the branch of `train`
    "continuous-ve": ("score_sde_cifar10_ve_ncsnpp_continuous",
                      dict(fir=True, progressive_input="residual", embedding_type="fourier")),
    "legacy-smld": ("score_sde_cifar10_ve_ncsnpp", {}),
    "ddpm-eps": ("tiny_test", {}),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_train_checkpoints_and_resumes_from_the_meta_checkpoint(branch, tmp_path):
    name, over = BRANCHES[branch]
    config = _tiny(name, tmp_path, **over)
    uses = run_lib.uses_legacy_discrete_loss(config)
    assert uses == (branch == "legacy-smld")
    batches = np.random.default_rng(0).standard_normal((6, 4, 16, 16, 3)).astype(np.float32)

    state = run_lib.train(config, iter(batches), max_steps=5, device="cpu")
    assert state.step == 5
    meta = CheckpointManager(os.path.join(str(tmp_path), "checkpoints-meta"))
    full = CheckpointManager(os.path.join(str(tmp_path), "checkpoints"))
    assert meta.all_steps() == [4] and full.all_steps() == [4]
    # a restart resumes from loop index 4's meta checkpoint (step 5)
    state2 = run_lib.train(config, iter(batches[5:]), max_steps=6, device="cpu")
    assert state2.step == 6
    assert all(torch.isfinite(p).all() for p in state2.params.values())


def test_build_model_refuses_families_it_does_not_have():
    with pytest.raises(ValueError, match="unknown model family"):
        run_lib.build_model(dataclasses.replace(pconfigs.get_config("tiny_test"),
                                                model_family="nope"), device="meta")
    with pytest.raises(ValueError, match="sub-VP"):
        run_lib.legacy_loss_fn(dataclasses.replace(
            pconfigs.get_config("score_sde_cifar10_vp_ddpm"),
            training=dataclasses.replace(pconfigs.get_config("score_sde_cifar10_vp_ddpm").training,
                                         sde="subvpsde")), torch.nn.Identity())


def test_jax_param_count_helper_is_exact_at_the_tiny_config():
    """The eval_shape count above is the JAX model's own init count."""
    cfg = jconfigs.get_config("tiny_test")
    from dpm_solver_tpu.run_lib import build_model

    _, init_fn = build_model(cfg)
    params = init_fn(jax.random.PRNGKey(0))
    assert _jax_param_count(cfg) == sum(int(np.prod(np.shape(x)))
                                        for x in jax.tree_util.tree_leaves(params))


def test_score_net_apply_takes_ncsnv2_labels_as_the_jax_one():
    from dpm_solver_tpu.run_lib import build_model as jbuild
    from dpm_solver_tpu.run_lib import score_net_apply as japply
    from dpm_solver_tpu_torch.utils.convert import ncsnv2_state_dict_from_flax

    jcfg, pcfg = jconfigs.get_config("tiny_ve_ncsnv2"), pconfigs.get_config("tiny_ve_ncsnv2")
    jmodel, init_fn = jbuild(jcfg)
    params = init_fn(jax.random.PRNGKey(0))
    model, _ = run_lib.build_model(pcfg, device="cpu")
    model.load_state_dict(ncsnv2_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params), pcfg.model_config))
    x = np.random.default_rng(3).uniform(0.0, 1.0, (2, 16, 16, 3)).astype(np.float32)
    labels = np.asarray([3.7, 8.2], np.float32)   # truncated to 3 and 8
    want = np.asarray(jax.jit(japply(jmodel, "ncsnv2"))(params, x, labels))
    with torch.no_grad():
        got = run_lib.score_net_apply(model, "ncsnv2")(torch.tensor(x),
                                                       torch.tensor(labels)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())


def test_train_takes_steps_on_tiny_ve_ncsnv2(tmp_path):
    config = dataclasses.replace(pconfigs.get_config("tiny_ve_ncsnv2"), workdir=str(tmp_path))
    assert run_lib.uses_legacy_discrete_loss(config)
    batches = np.random.default_rng(0).uniform(0.0, 1.0, (3, 4, 16, 16, 3)).astype(np.float32)
    state = run_lib.train(config, iter(batches), max_steps=3, device="cpu")
    assert state.step == 3
    assert all(torch.isfinite(p).all() for p in state.params.values())
    # the meta checkpoint of loop index 2 (snapshot_freq_for_preemption 2)
    assert CheckpointManager(os.path.join(str(tmp_path), "checkpoints-meta")).all_steps() == [2]
