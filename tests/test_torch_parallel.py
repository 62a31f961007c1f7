"""The port's data parallelism (dpm_solver_tpu_torch/parallel/) against the
single-process port and the JAX package, on gloo ranks on the CPU.

One world of two ranks (`_torch_parallel_workers.data_parallel_rank`) runs,
on the tiny DDPM UNet at 16x16, b8:
- the sharded sampler and `DPM_Solver.sample(mesh=)` (6 steps of order-2
  multistep; an SDE solver with its noise split with x): within 1e-6 of
  max|x| of the single-process port, and the sharded sampler within 1e-4 of
  JAX's `make_sharded_sampler` on a 2-device CPU mesh (the weights carried
  across by `convert_ddpm_unet`), JAX's bound at tests/test_sharding.py:51-52;
- the refusals of tests/test_sharding.py:131-148 (adaptive, jit=False, an
  SDE plan without noise), a model function closed over a full-batch tensor
  and an indivisible batch;
- `sample_noise`: a rank's rows of the global draw, bitwise, for world
  sizes 1 and 2 (4 in test_torch_tp.py);
- the data-parallel train step against the single-process one (dropout 0):
  the loss within rtol 1e-4, the averaged gradients within 1e-5 of their
  max, and Adam applied to equal gradients equal;
- ZeRO-1 on that step: the moments' shard axes are JAX `_leaf_spec`'s on the
  Flax-ordered shapes, each rank holds about half the state, and the step
  equals the data-parallel one within 1e-6;
- the multihost helpers across the two ranks.
A second world runs `StableDiffusionPipeline.txt2img(mesh=)` and
`DPMSolverSampler.sample(mesh=)` (CFG, a per-sample blend) against the calls
without a mesh. The CLI's `sample --devices 2` writes the samples of
`--devices 1`.
"""

import os

import numpy as np
import pytest
import torch

import _torch_parallel_workers as W
from dpm_solver_tpu_torch.parallel import sample_noise
from dpm_solver_tpu_torch.parallel import multihost as mh
from dpm_solver_tpu_torch.parallel.launch import run_ranks
from dpm_solver_tpu_torch.parallel.zero import _leaf_spec as port_leaf_spec
from dpm_solver_tpu_torch.training.optim import flax_order

TIMEOUT = 300


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ranks"))
    return run_ranks(W.data_parallel_rank, 2, args=(d,), threads=1, timeout=TIMEOUT, directory=d)


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pipe"))
    return run_ranks(W.pipeline_rank, 2, threads=1, timeout=TIMEOUT, directory=d)


def _close(got, want, bound):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=bound)


def test_sharded_sampler_matches_single_process(dp):
    for r in dp:   # every rank returns the global batch
        _close(r["sharded_sampler"], r["sample_single"], 1e-6)
    np.testing.assert_array_equal(dp[0]["sharded_sampler"], dp[1]["sharded_sampler"])


def test_dpm_solver_sample_mesh_matches_single_process(dp):
    for r in dp:
        _close(r["sample_mesh"], r["sample_single"], 1e-6)
        _close(r["sde_mesh"], r["sde_single"], 1e-6)


def test_sharded_sampler_matches_jax(dp):
    import jax
    import jax.numpy as jnp

    from dpm_solver_tpu import NoiseScheduleVP, build_sampler, model_wrapper
    from dpm_solver_tpu.models import DDPMUNet as JaxDDPMUNet
    from dpm_solver_tpu.models import DDPMUNetConfig as JaxConfig
    from dpm_solver_tpu.parallel import make_mesh, make_sharded_sampler
    from dpm_solver_tpu.utils.convert import convert_ddpm_unet

    params = convert_ddpm_unet({k: v.numpy() for k, v in W.tiny_unet().state_dict().items()})
    net = JaxDDPMUNet(JaxConfig.tiny(resolution=16))
    ns = NoiseScheduleVP.discrete(betas=W.BETAS)
    fn = build_sampler(model_wrapper(lambda x, t: net.apply(params, x, t), ns), ns, steps=6,
                       order=2, method="multistep", use_pallas=False)
    sampler = make_sharded_sampler(fn, make_mesh(jax.devices()[:2]), donate_x=False)
    want = np.asarray(sampler(jnp.asarray(W.x_batch(0, (8, 16, 16, 3)).numpy())))
    _close(dp[0]["sharded_sampler"], want, 1e-4)


@pytest.mark.parametrize("name,kind,match", [
    ("adaptive", "ValueError", "adaptive"),
    ("jit", "ValueError", "jit"),
    ("noise", "ValueError", "noise"),
    ("closed_over", "RuntimeError", "size"),
    ("indivisible", "ValueError", "does not divide"),
])
def test_mesh_refusals(dp, name, kind, match):
    err = dp[0]["errors"][name]
    assert err is not None and err[0] == kind and match in err[1], err


@pytest.mark.parametrize("world", [1, 2])
def test_noise_is_world_size_invariant(dp, world):
    glob = sample_noise(42, (16, 4, 4, 3)).numpy()
    if world == 1:
        np.testing.assert_array_equal(glob, dp[0]["noise_global"])
        return
    rows = np.concatenate([r["noise_rows"] for r in dp])
    np.testing.assert_array_equal(rows, glob)


def test_data_parallel_step_matches_single_process(dp):
    single, par = dp[0]["train"]["single"], dp[0]["train"]["dp"]
    np.testing.assert_allclose(par["loss"], single["loss"], rtol=1e-4)
    gmax = max(float(np.abs(g).max()) for g in single["grads"].values())
    for k, g in single["grads"].items():
        np.testing.assert_allclose(par["grads"][k] / gmax, g / gmax, rtol=0, atol=1e-5,
                                   err_msg=k)
    # Adam on equal gradients is the same update
    for k, p in par["params"].items():
        np.testing.assert_array_equal(dp[0]["adam_from_dp_grads"][k], p, err_msg=k)
    # and every rank keeps the same parameters
    for k, p in par["params"].items():
        np.testing.assert_array_equal(dp[1]["train"]["dp"]["params"][k], p, err_msg=k)


def test_data_parallel_latent_step_matches_single_process(dp):
    single, par = dp[0]["latent"]["single"], dp[0]["latent"]["dp"]
    np.testing.assert_allclose(par["loss"], single["loss"], rtol=1e-4)
    gmax = max(float(np.abs(g).max()) for g in single["grads"].values())
    for k, g in single["grads"].items():
        np.testing.assert_allclose(par["grads"][k] / gmax, g / gmax, rtol=0, atol=1e-5,
                                   err_msg=k)


def test_zero1_axes_follow_jax_leaf_spec(dp):
    from jax.sharding import PartitionSpec

    from dpm_solver_tpu.parallel.zero import _leaf_spec

    net = W.tiny_unet()
    checked = 0
    for name, p in net.named_parameters():
        perm = flax_order(p)
        flax_shape = [p.shape[a] for a in perm]
        for n in (2, 8):
            spec = _leaf_spec(np.zeros(flax_shape, np.float32), n, 2 ** 12)
            want = None if spec == PartitionSpec() else perm[list(spec).index("data")]
            ax = port_leaf_spec(flax_shape, n, 2 ** 12)
            assert (None if ax is None else perm[ax]) == want, (name, n)
        # and the state the ranks shard: the 2-rank axis of each moment
        spec = _leaf_spec(np.zeros(flax_shape, np.float32), 2, 2 ** 12)
        want = None if spec == PartitionSpec() else perm[list(spec).index("data")]
        assert dp[0]["zero_axes"][name] == want, name
        checked += want is not None
    assert checked >= 5


def test_zero1_step_matches_and_shards(dp):
    par, zero = dp[0]["train"]["dp"], dp[0]["train"]["zero"]
    assert zero["loss"] == par["loss"]
    for k, p in par["params"].items():
        np.testing.assert_allclose(zero["params"][k], p, rtol=1e-6, atol=0, err_msg=k)
    # about half the replicated state, plus the replicated small moments
    assert dp[0]["bytes_zero"] < 0.6 * dp[0]["bytes_replicated"]
    for r in dp:
        for k, ax in r["zero_axes"].items():
            full = r["train"]["single"]["params"][k].shape
            want = full if ax is None else full[:ax] + (full[ax] // 2,) + full[ax + 1:]
            assert r["zero_local_shapes"][k] == want, k


def test_zero1_adafactor_step_matches(dp):
    assert dp[0]["adafactor_sharded"] >= 5
    rep, zero = dp[0]["adafactor"]["replicated"], dp[0]["adafactor"]["zero"]
    for k, p in rep.items():
        np.testing.assert_allclose(zero[k], p, rtol=1e-6, atol=0, err_msg=k)
    for k, p in zero.items():   # every rank keeps the same parameters
        np.testing.assert_array_equal(dp[1]["adafactor"]["zero"][k], p, err_msg=k)


def test_multihost_helpers_across_ranks(dp):
    assert dp[0]["host_fold"].shape == (2, 1) and len(set(dp[0]["host_fold"].ravel())) == 2
    assert dp[0]["metric_shapes"] == {"loss": (2,), "vec": (2, 3), "t": (2, 2, 2)}
    assert sorted(dp[0]["subset"] + dp[1]["subset"]) == list(range(10))
    assert [r["smoke"] for r in dp] == ["MULTIHOST_OK 0", "MULTIHOST_OK 1"]


@pytest.mark.parametrize("h,n", [(0, 1), (0, 2), (1, 2), (0, 3), (2, 3), (1, 4), (3, 4)])
def test_host_subset_partitions_as_jax(h, n):
    from dpm_solver_tpu.parallel import multihost as jmh

    items = list(range(11))
    assert mh.host_subset(items, host_id=h, n_hosts=n) == \
        jmh.host_subset(items, host_id=h, n_hosts=n)


def test_per_process_key_folds_the_rank(dp):
    from dpm_solver_tpu_torch.parallel import per_process_key

    keys = [r["per_process_key"] for r in dp]
    assert len(set(keys)) == 2 and keys[0] == per_process_key(0)   # rank 0's is one process's


def test_multihost_helpers_on_one_process():
    assert mh.allgather_metrics({"a": 2.0})["a"].shape == (1,)
    assert mh.host_subset([1, 2, 3]) == [1, 2, 3]
    assert mh.host_fold(0) != mh.host_fold(0, host_id=1)
    mh.barrier()


def test_txt2img_mesh_matches_single_process(pipe):
    # each rank encodes the prompts itself (an encoder that gives every
    # process the same values)
    for r in pipe:
        _close(r["txt2img_mesh"], r["txt2img_single"], 1e-4)
        _close(r["txt2img_mesh"], pipe[0]["txt2img_single"], 1e-4)


def test_sampler_mesh_with_blend_matches_single_process(pipe):
    for r in pipe:
        (x, inter), (x1, inter1) = r["sample_mesh"], r["sample_single"]
        _close(x, x1, 1e-4)
        assert len(inter) == len(inter1)
        for a, b in zip(inter, inter1):
            _close(a, b, 1e-4)


def test_run_lib_train_takes_a_mesh(tmp_path, monkeypatch):
    import dataclasses

    from dpm_solver_tpu_torch import run_lib
    from dpm_solver_tpu_torch.configs import get_config
    from dpm_solver_tpu_torch.training.checkpoints import CheckpointManager

    work = tmp_path / "mesh"
    ranks = run_ranks(W.run_lib_rank, 2, args=(str(work),), threads=1, timeout=TIMEOUT,
                      directory=str(tmp_path))
    assert [r["step"] for r in ranks] == [3, 3]
    for k, p in ranks[0]["params"].items():   # replicas stay equal
        np.testing.assert_array_equal(ranks[1]["params"][k], p, err_msg=k)
    # rank 0 alone wrote the checkpoints, at the single-process steps
    config = dataclasses.replace(get_config("tiny_test"), workdir=str(tmp_path / "one"))
    batches = np.random.default_rng(0).standard_normal((3, 8, 16, 16, 3)).astype(np.float32)
    metrics = []
    monkeypatch.setattr(run_lib, "_log_step", lambda step, m: metrics.append(
        (step, float(m["loss"]), float(m["grad_norm"]))))
    single = run_lib.train(config, iter(batches), max_steps=3, device="cpu")
    # each step's loss and gradient norm (the all-reduced gradients, before
    # clipping) are the single process's: the ranks took their own rows of
    # the same global batch and draws, and reduced their gradients
    assert [m[0] for m in metrics] == [0, 1, 2]
    for r in ranks:
        assert [m[0] for m in r["metrics"]] == [0, 1, 2]
        np.testing.assert_allclose([m[1:] for m in r["metrics"]], [m[1:] for m in metrics],
                                   rtol=1e-4)
    assert CheckpointManager(str(work / "checkpoints")).all_steps() == \
        CheckpointManager(str(tmp_path / "one" / "checkpoints")).all_steps()
    # Adam's first steps move each parameter by about the learning rate
    # whatever its gradient's size, so near-zero gradients differ at that
    # scale between the two reduction orders; the rest agree
    lr = config.training.lr
    for k, p in single.params.items():
        np.testing.assert_allclose(ranks[0]["params"][k], p.detach().numpy(), rtol=0,
                                   atol=3 * lr, err_msg=k)


def test_run_ranks_names_a_native_abort_by_its_stderr(tmp_path):
    """A rank that dies in native code leaves no traceback: the error names
    the rank and its exit code, and carries what it wrote to its stderr."""
    text = "the rank's last words before its abort"
    with pytest.raises(RuntimeError) as e:
        run_ranks(W.aborting_rank, 2, args=(text,), threads=1, timeout=TIMEOUT,
                  directory=str(tmp_path))
    msg = str(e.value)
    assert "rank 1 of 2" in msg and "exit code -6" in msg and text in msg, msg
    assert "not written its result" in msg, msg


def test_cli_sample_devices_matches_one_device(tmp_path):
    from dpm_solver_tpu_torch import cli

    outs = {}
    for n in (1, 2):
        outdir = tmp_path / f"d{n}"
        cli.main(["--device", "cpu", "sample", "--config", "tiny_test", "--batch", "4",
                  "--devices", str(n), "--outdir", str(outdir)])
        outs[n] = np.load(outdir / "sample.npz")["samples"]
        assert len([f for f in os.listdir(outdir) if f.endswith(".png")]) == 4
    _close(outs[2], outs[1], 1e-5)
    with pytest.raises(SystemExit, match="not divisible"):
        cli.main(["--device", "cpu", "sample", "--config", "tiny_test", "--batch", "3",
                  "--devices", "2", "--outdir", str(tmp_path / "bad")])
