"""The port's checkpoints (dpm_solver_tpu_torch/training/checkpoints.py),
with the JAX package's semantics (training/checkpoints.py), on the CPU.

- A `TrainState` round trip: every tensor back bitwise, into the template's
  own tensors (a restored state updates its module's parameters), the step,
  Adam's count and the EMA rate; a mismatched template is refused.
- `restore_or_init` returns the template where there is no checkpoint;
  `max_to_keep` keeps the newest; a checkpoint directory's leftover
  temporary write is no checkpoint; `wait_for_checkpoint` times out.
- `EvalMeta`: the JSON sidecar reads and writes the JAX package's files,
  both ways (its key `PRNGKey(s)` is (0, s)).
- Kill and resume: `run_lib.train` (live dropout) and
  `run_lib.train_latent` (the VAE encode's posterior sample, Adafactor,
  remat) stopped after 5 steps and restarted from the meta checkpoint end
  bitwise where an uninterrupted 6-step run ends: the step's draws are
  `StepRng(seed, step)`, and the checkpoint holds all the state.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from dpm_solver_tpu.training import checkpoints as jckpt
from dpm_solver_tpu_torch import configs, run_lib
from dpm_solver_tpu_torch.models import ADMConfig, DDPMUNet, DDPMUNetConfig, VAEConfig
from dpm_solver_tpu_torch.models.init import init_train_
from dpm_solver_tpu_torch.training import checkpoints as ck
from dpm_solver_tpu_torch.training.train import make_train_state


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's CPU work: these small shapes gain
    nothing from more, and the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(seed):
    net = init_train_(DDPMUNet(DDPMUNetConfig.tiny(resolution=8), device="cpu"),
                      torch.Generator().manual_seed(seed))
    state, tx = make_train_state(net, lr=1e-3, warmup=2, ema_rate=0.99)
    grads = {k: torch.randn(p.shape, generator=torch.Generator().manual_seed(1))
             for k, p in state.params.items()}
    tx.step(state.params, grads, state.opt_state)
    state.step = 7
    return net, state


def test_train_state_round_trip_into_the_module(tmp_path):
    _, saved = _state(0)
    mgr = ck.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(3, saved)
    net, template = _state(1)
    template.step, template.ema_rate = 0, 0.5
    back = mgr.restore(template)
    assert back is template and back.step == 7 and back.ema_rate == 0.99
    assert back.opt_state["count"] == 1
    for k, p in dict(net.named_parameters()).items():
        assert back.params[k] is p and torch.equal(p, saved.params[k])
    for name in ("mu", "nu"):
        for k, v in back.opt_state[name].items():
            assert torch.equal(v, saved.opt_state[name][k])
    for k, v in back.ema_params.items():
        assert torch.equal(v, saved.ema_params[k])
    other = {"w": torch.zeros(3)}
    mgr.save(4, {"w": torch.arange(4.0)})
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(other, step=4)


def test_restore_or_init_max_to_keep_and_atomic_writes(tmp_path):
    template = {"w": torch.zeros(2, 3), "n": 0}
    empty = ck.CheckpointManager(str(tmp_path / "empty"))
    assert ck.restore_or_init(empty, template) is template and empty.latest_step() is None
    assert not ck.wait_for_checkpoint(empty, 1, poll_seconds=0.01, timeout=0.05)
    mgr = ck.CheckpointManager(str(tmp_path / "k"), max_to_keep=2)
    for step in (1, 2, 3):
        mgr.save(step, {"w": torch.full((2, 3), float(step)), "n": step})
    assert mgr.all_steps() == [2, 3]
    os.makedirs(os.path.join(mgr.directory, ".4-partial"))   # a write cut short
    assert mgr.latest_step() == 3
    got = ck.restore_or_init(mgr, template)
    assert got["n"] == 3 and torch.equal(template["w"], torch.full((2, 3), 3.0))
    assert ck.wait_for_checkpoint(mgr, 3, poll_seconds=0.01, timeout=1.0)


def test_eval_meta_json_is_the_jax_packages(tmp_path):
    meta = ck.EvalMeta(ckpt_id=3, sampling_round_id=7).with_rng(5)
    ck.save_eval_meta(meta, str(tmp_path), host_id=0)
    back = jckpt.load_eval_meta(str(tmp_path), host_id=0)
    assert (back.ckpt_id, back.sampling_round_id, back.bpd_round_id) == (3, 7, -1)
    assert np.array_equal(jax.random.key_data(back.rng),
                          jax.random.key_data(jax.random.PRNGKey(5)))
    jmeta = jckpt.EvalMeta(ckpt_id=2, bpd_round_id=4).with_rng(jax.random.PRNGKey(9))
    jckpt.save_eval_meta(jmeta, str(tmp_path / "j"), host_id=1)
    got = ck.load_eval_meta(str(tmp_path / "j"), host_id=1)
    assert (got.ckpt_id, got.bpd_round_id, got.seed) == (2, 4, 9)
    assert got.rng.initial_seed() == 9
    assert ck.load_eval_meta(str(tmp_path / "none"), host_id=0) == ck.EvalMeta()
    ck.delete_eval_meta(str(tmp_path / "j"), host_id=1)
    assert ck.load_eval_meta(str(tmp_path / "j"), host_id=1) == ck.EvalMeta()


def _params(state):
    return {k: v.detach().clone() for k, v in state.params.items()}


def test_train_kill_and_resume_is_bitwise(tmp_path):
    cfg = configs.get_config("tiny_test")
    cfg = dataclasses.replace(
        cfg, model_config=dataclasses.replace(cfg.model_config, dropout=0.1),
        training=dataclasses.replace(cfg.training, snapshot_freq_for_preemption=2,
                                     snapshot_freq=100, log_freq=100))
    batches = np.random.default_rng(3).standard_normal((6, 2, 16, 16, 3)).astype(np.float32)
    whole = run_lib.train(cfg, iter(batches), workdir=str(tmp_path / "a"), max_steps=6,
                          device="cpu")
    run_lib.train(cfg, iter(batches), workdir=str(tmp_path / "b"), max_steps=5, device="cpu")
    resumed = run_lib.train(cfg, iter(batches[5:]), workdir=str(tmp_path / "b"), max_steps=6,
                            device="cpu")
    assert whole.step == resumed.step == 6
    for k, v in _params(whole).items():
        assert torch.equal(v, resumed.params[k]), k
        assert torch.equal(whole.ema_params[k], resumed.ema_params[k]), k


def test_train_latent_kill_and_resume_is_bitwise(tmp_path):
    ucfg = ADMConfig(image_size=8, in_channels=4, model_channels=32, out_channels=4,
                     num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                     num_heads=2, use_spatial_transformer=True, transformer_depth=1,
                     context_dim=16)
    vcfg = VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, embed_dim=4,
                     resolution=16)
    rs = np.random.default_rng(4)
    batches = [(rs.standard_normal((2, 16, 16, 3)).astype(np.float32) * 0.5,
                rs.standard_normal((2, 3, 16)).astype(np.float32)) for _ in range(6)]
    kw = dict(unet_config=ucfg, vae_config=vcfg, optimizer="adafactor", remat=True,
              cond_dropout=0.5, warmup=2, snapshot_freq_for_preemption=2, log_freq=100,
              device="cpu")
    whole = run_lib.train_latent("sd_v2_1", iter(batches), workdir=str(tmp_path / "a"),
                                 max_steps=6, **kw)
    run_lib.train_latent("sd_v2_1", iter(batches), workdir=str(tmp_path / "b"), max_steps=5,
                         **kw)
    resumed = run_lib.train_latent("sd_v2_1", iter(batches[5:]), workdir=str(tmp_path / "b"),
                                   max_steps=6, **kw)
    assert whole.step == resumed.step == 6
    for k, v in _params(whole).items():
        assert torch.equal(v, resumed.params[k]), k
        assert torch.equal(whole.ema_params[k], resumed.ema_params[k]), k
