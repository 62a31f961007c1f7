"""The port's configs and training orchestration (dpm_solver_tpu_torch/
configs.py, run_lib.py) against the JAX package's, on the CPU.

- The registry holds the JAX package's entries, name for name, and every
  entry's fields equal the JAX entry's: sampling, training, diffusion,
  data, eval and the rest, and the model config's fields (but the JAX
  ADMConfig's `quant`, the serving int8 switch of ops/quant.py, not
  ported). An entry of a family the port lacks (NCSNv2) keeps the preset
  and overrides it would build, and `build_model` raises naming the
  missing module.
- `build_model` builds every other entry (on the meta device, no memory),
  with the JAX model's parameter count at the configurations the paths and
  the benchmarks train (NCSN++ continuous VE, the CIFAR-10 DDPM, the tiny
  test config).
- `run_lib.train` drives all three branches (continuous SDE with live
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
        if isinstance(pm, pconfigs.PendingModelConfig):
            assert p.model_family == "ncsnv2" and type(jm).__name__ == "NCSNv2Config"
            with pytest.raises(NotImplementedError, match="models/ncsnv2.py"):
                run_lib.build_model(p, device="meta")
            continue
        assert type(pm).__name__ == type(jm).__name__
        skip = NOT_PORTED.get(type(jm).__name__, set())
        jmf = {k: v for k, v in _fields(jm).items() if k not in skip}
        assert _fields(pm) == jmf, key


@pytest.mark.parametrize("name", [n for n in NAMES
                                  if pconfigs.get_config(n).model_family != "ncsnv2"])
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
                                  "tiny_test"])
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
    cfg = pconfigs.get_config("tiny_ve_ncsnv2")
    assert isinstance(cfg.model_config, pconfigs.PendingModelConfig)
    with pytest.raises(NotImplementedError, match="ncsnv2"):
        run_lib.build_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ncsnv2"):
        run_lib.score_net_apply(torch.nn.Identity(), "ncsnv2")
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
