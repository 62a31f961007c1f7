"""The port's evaluation (dpm_solver_tpu_torch/eval/, run_lib.evaluate,
utils/logging.py) against the JAX package's, on the CPU.

- FID, IS and KID against `dpm_solver_tpu.eval` on the same float64
  features (equal to 1e-12 relative: the same NumPy/SciPy arithmetic);
  `frechet_distance_torch` (float64 eigh) against the JAX package's
  `frechet_distance_jax` in float64 within 1e-10, the host's scipy form
  within 1e-5 (the eigh form's eps jitter); `compute_statistics_of_path`
  on its two npz forms (statistics; images, uint8 or [0, 1]) against the
  JAX function with the same extractor, and an image folder (all PNG: the
  native reader; PNG and JPEG: PIL) against the JAX folder route;
  `calculate_fid_given_paths`.
- `FIDInceptionV3` from `random_feature_params` (the JAX package's random
  weights, drawn in its leaf order: the same values) and, separately, from
  `inception_state_dict_from_flax` of a JAX init: features and logits
  within 1e-4 of max (measured about 5e-7) at `(resize_input=False, 75
  px)` and `(True, 32 px)`, tests/test_inception_golden.py's sizes.
- `run_lib.evaluate` against the JAX `evaluate` on `tiny_test` checkpoints
  written at steps 2, 4 and 200 (outside [begin_ckpt, end_ckpt]), with
  hooks that do not depend on the rng: the same steps visited, the same
  round files (names and contents), the same loss, IS and FID; then a run
  stopped by its hook after checkpoint 4's first round resumes, in both
  packages, to the same results; with rng-dependent port hooks a resumed
  run ends with the uninterrupted run's IS and FID.
- `MetricWriter` writes the JAX writer's JSONL (but the clock) and CSV,
  and through `torch.utils.tensorboard` the TensorBoard scalars the JAX
  writer writes through tensorflow; and
  `image_grid` / `save_image_grid` the JAX package's grid.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu import eval as jeval
from dpm_solver_tpu import run_lib as jrun_lib
from dpm_solver_tpu.configs import get_config as jget_config
from dpm_solver_tpu.eval import inception as jinception
from dpm_solver_tpu.training import checkpoints as jckpt
from dpm_solver_tpu.training import train as jtrain
from dpm_solver_tpu.utils import logging as jlogging
from dpm_solver_tpu_torch import eval as peval
from dpm_solver_tpu_torch import run_lib
from dpm_solver_tpu_torch.configs import get_config
from dpm_solver_tpu_torch.eval import inception as pinception
from dpm_solver_tpu_torch.training.checkpoints import CheckpointManager
from dpm_solver_tpu_torch.training.train import make_optimizer, make_train_state
from dpm_solver_tpu_torch.utils import logging as plogging
from dpm_solver_tpu_torch.utils.convert import inception_state_dict_from_flax


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's CPU work: these small shapes gain
    nothing from more, and the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _feats(seed, n=64, d=16):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)) @ rng.standard_normal((d, d)) * 0.3 + rng.standard_normal(d)


def _same(a, b, rel=1e-12):
    assert abs(a - b) <= rel * max(abs(a), 1e-300), (a, b)


def test_fid_is_kid_match_jax():
    f1, f2 = _feats(0), _feats(1)
    mu1, s1 = peval.compute_statistics(f1)
    jmu, js = jeval.compute_statistics(f1)
    assert np.array_equal(mu1, jmu) and np.array_equal(s1, js)
    _same(peval.frechet_distance(mu1, s1, *peval.compute_statistics(f2)),
          jeval.frechet_distance(jmu, js, *jeval.compute_statistics(f2)))
    _same(peval.fid_from_features(f1, peval.compute_statistics(f2)),
          jeval.fid_from_features(f1, jeval.compute_statistics(f2)))
    logits = np.random.default_rng(2).standard_normal((50, 10)) * 3
    for splits in (1, 10):
        for a, b in zip(peval.inception_score(logits, splits),
                        jeval.inception_score(logits, splits)):
            _same(a, b)
    for seed in (None, 3):
        _same(peval.kid_from_features(f1, f2, max_block=20, seed=seed),
              jeval.kid_from_features(f1, f2, max_block=20, seed=seed))


def test_frechet_distance_torch_matches_the_host():
    mu1, s1 = peval.compute_statistics(_feats(4))
    mu2, s2 = peval.compute_statistics(_feats(5))
    want = peval.frechet_distance(mu1, s1, mu2, s2)
    got = peval.frechet_distance_torch(torch.from_numpy(mu1), torch.from_numpy(s1), mu2, s2)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    # the eigendecomposition takes both covariances with an eps * I jitter
    # (the host form only where its square root fails): O(eps * d) apart
    assert abs(float(got) - want) <= 1e-5 * abs(want)
    # the JAX package's on-device form, in float64: the same arithmetic
    with jax.enable_x64(True):
        jw = float(jeval.frechet_distance_jax(mu1, s1, mu2, s2))
    assert abs(float(got) - jw) <= 1e-10 * abs(want)


def _extractor(images):
    """A fixed linear 'feature extractor' of (B, 16, 16, 3) images."""
    w = np.random.default_rng(6).standard_normal((16 * 16 * 3, 8)).astype(np.float32) * 0.05
    x = np.asarray(images, np.float32).reshape(len(images), -1)
    f = x @ w
    return f, f[:, :5]


@pytest.mark.parametrize("form", ["stats", "uint8", "float"])
def test_compute_statistics_of_path_npz_forms(form, tmp_path):
    rng = np.random.default_rng(7)
    path = str(tmp_path / f"{form}.npz")
    if form == "stats":
        np.savez(path, mu=rng.standard_normal(8), sigma=np.eye(8))
    elif form == "uint8":
        np.savez(path, samples=rng.integers(0, 256, (30, 16, 16, 3), dtype=np.uint8))
    else:
        np.savez(path, images=rng.random((30, 16, 16, 3)).astype(np.float32))
    want = jeval.fid.compute_statistics_of_path(path, lambda b: _extractor(np.asarray(b)),
                                                batch_size=7)
    got = peval.compute_statistics_of_path(path, lambda b: tuple(
        torch.from_numpy(a) for a in _extractor(b.numpy())), batch_size=7)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-15)
    if form == "uint8":
        other = str(tmp_path / "other.npz")
        np.savez(other, samples=rng.integers(0, 256, (30, 16, 16, 3), dtype=np.uint8))
        fn = lambda b: _extractor(np.asarray(b))  # noqa: E731
        _same(peval.calculate_fid_given_paths([path, other], fn, batch_size=7),
              jeval.fid.calculate_fid_given_paths([path, other], fn, batch_size=7), 1e-9)


@pytest.mark.parametrize("kind", ["png", "mixed"])
def test_compute_statistics_of_a_folder_matches_jax(kind, tmp_path):
    """An image folder: all PNG (the native reader, in chunks of batch_size)
    or PNG and JPEG mixed (PIL), against the JAX function's folder route
    with the same extractor: the same pixels, so the same statistics."""
    from PIL import Image

    from dpm_solver_tpu_torch import native

    rng = np.random.default_rng(8)
    imgs = rng.integers(0, 256, (23, 16, 16, 3), dtype=np.uint8)
    native.write_png_batch(imgs, [str(tmp_path / f"s{i:03d}.png") for i in range(len(imgs))])
    if kind == "mixed":
        for i in range(0, len(imgs), 3):
            Image.fromarray(imgs[i]).save(tmp_path / f"s{i:03d}.jpg", quality=90)
            os.remove(tmp_path / f"s{i:03d}.png")
    want = jeval.fid.compute_statistics_of_path(str(tmp_path), lambda b: _extractor(
        np.asarray(b)), batch_size=7)
    got = peval.compute_statistics_of_path(str(tmp_path), lambda b: tuple(
        torch.from_numpy(a) for a in _extractor(b.numpy())), batch_size=7)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-15)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        peval.compute_statistics_of_path(str(tmp_path / "empty"), _extractor)


@pytest.fixture(scope="module")
def inception_params():
    return jinception.random_feature_params(0, input_hw=75)


@pytest.mark.parametrize("resize,size", [(False, 75), (True, 32)])
def test_inception_features_match_jax(inception_params, resize, size):
    x = np.random.default_rng(8).random((2, size, size, 3)).astype(np.float32)
    want = jinception.make_feature_fn(inception_params, resize_input=resize)(jnp.asarray(x))
    fn = pinception.make_feature_fn(pinception.random_feature_params(0), resize_input=resize,
                                    device="cpu")
    got = fn(x)
    assert got[0].shape == (2, 2048) and got[1].shape == (2, 1008)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert np.abs(w - g.numpy()).max() <= 1e-4 * np.abs(w).max()


def test_inception_loads_converted_jax_params():
    model = jinception.FIDInceptionV3(resize_input=False)
    x = np.random.default_rng(9).random((1, 75, 75, 3)).astype(np.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    # BatchNorm off its identity init, so that every statistic matters
    rng = np.random.default_rng(10)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32)
        if getattr(p[-1], "key", "").startswith("bn_") else a, params)
    want = jax.jit(model.apply)(params, jnp.asarray(x))
    port = pinception.FIDInceptionV3(resize_input=False, device="cpu")
    port.load_state_dict(inception_state_dict_from_flax(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert np.abs(w - g.numpy()).max() <= 1e-4 * np.abs(w).max()


# --------------------------------------------------------------------------- #
# run_lib.evaluate
# --------------------------------------------------------------------------- #

STEPS = (2, 4, 200)   # 200 lies past tiny_test's end_ckpt (100)


class Stop(Exception):
    pass


def _stats_file(tmp_path) -> str:
    path = str(tmp_path / "ref_stats.npz")
    if not os.path.exists(path):
        f = _feats(11, n=40, d=8)
        np.savez(path, mu=f.mean(0), sigma=np.cov(f, rowvar=False))
    return path


def _jax_workdir(tmp_path) -> tuple:
    cfg = jget_config("tiny_test")
    cfg = dataclasses.replace(cfg, workdir=str(tmp_path / "jax"), eval=dataclasses.replace(
        cfg.eval, fid_stats_path=_stats_file(tmp_path)))
    _, init_fn = jrun_lib.build_model(cfg)
    t = cfg.training
    state, _ = jtrain.make_train_state(jax.jit(init_fn)(jax.random.PRNGKey(0)),
                                       ema_rate=t.ema_rate,
                                       tx=jtrain.make_optimizer(t.lr, t.warmup, t.grad_clip))
    mgr = jckpt.CheckpointManager(os.path.join(cfg.workdir, "checkpoints"))
    for s in STEPS:
        mgr.save(s, dataclasses.replace(state, step=jnp.asarray(s, jnp.int32)))
    return cfg


def _port_workdir(tmp_path) -> tuple:
    cfg = get_config("tiny_test")
    cfg = dataclasses.replace(cfg, workdir=str(tmp_path / "port"), eval=dataclasses.replace(
        cfg.eval, fid_stats_path=_stats_file(tmp_path)))
    model, _ = run_lib.build_model(cfg, device="cpu")
    t = cfg.training
    state, _ = make_train_state(model, ema_rate=t.ema_rate,
                                tx=make_optimizer(t.lr, t.warmup, t.grad_clip))
    mgr = CheckpointManager(os.path.join(cfg.workdir, "checkpoints"))
    for s in STEPS:
        state.step = s
        mgr.save(s, state)
    return cfg


def _hooks(visited: list, stop_at=None):
    """rng-free hooks: the images of a round are a function of the
    checkpoint's step; `stop_at` (step, round count) raises there."""
    def sample_fn(state, rng):
        step = int(state.step)
        if stop_at is not None and (step, sum(v == step for v in visited)) == stop_at:
            raise Stop
        visited.append(step)
        return np.random.default_rng(step).random((4, 16, 16, 3)).astype(np.float32)

    def feature_fn(images):
        return _extractor(images)

    def loss_fn(state, rng):
        return 0.5 * int(state.step)

    return dict(sample_fn=sample_fn, feature_fn=feature_fn, loss_fn=loss_fn)


def _round_files(cfg) -> dict:
    eval_dir = os.path.join(cfg.workdir, "eval")
    return {f: dict(np.load(os.path.join(eval_dir, f)))
            for f in sorted(os.listdir(eval_dir)) if f.endswith(".npz")}


def _same_results(want: dict, got: dict):
    assert sorted(want) == sorted(got)
    for step in want:
        assert set(want[step]) == set(got[step]) == {"rounds", "loss", "inception_score", "fid"}
        for k in want[step]:
            _same(float(want[step][k]), float(got[step][k]), 1e-9)


def test_evaluate_matches_jax_and_resumes(tmp_path):
    jcfg, pcfg = _jax_workdir(tmp_path), _port_workdir(tmp_path)
    jvisit, pvisit = [], []
    jres = jrun_lib.evaluate(jcfg, rounds=2, **_hooks(jvisit))
    pres = run_lib.evaluate(pcfg, rounds=2, device="cpu", **_hooks(pvisit))
    assert pvisit == jvisit == [2, 2, 4, 4]
    _same_results(jres, pres)
    jfiles, pfiles = _round_files(jcfg), _round_files(pcfg)
    assert list(pfiles) == list(jfiles) == [f"stats_ckpt{s}_round{r}.npz"
                                            for s in (2, 4) for r in (0, 1)]
    for name in jfiles:
        for k in ("feats", "logits"):
            assert np.array_equal(jfiles[name][k], pfiles[name][k])
    assert not os.path.exists(os.path.join(pcfg.workdir, "eval", "eval_meta_host0.json"))

    # stopped by the hook after checkpoint 4's first round, then resumed
    for cfg, evaluate, kw in ((jcfg, jrun_lib.evaluate, {}),
                              (pcfg, run_lib.evaluate, {"device": "cpu"})):
        for f in os.listdir(os.path.join(cfg.workdir, "eval")):
            os.remove(os.path.join(cfg.workdir, "eval", f))
        visited = []
        with pytest.raises(Stop):
            evaluate(cfg, rounds=2, **kw, **_hooks(visited, stop_at=(4, 1)))
        with open(os.path.join(cfg.workdir, "eval", "eval_meta_host0.json")) as f:
            meta = json.load(f)
        assert (meta["ckpt_id"], meta["sampling_round_id"]) == (4, 0)
        resumed = evaluate(cfg, rounds=2, **kw, **_hooks(visited))
        assert visited == [2, 2, 4, 4]
        _same_results({4: jres[4]}, resumed)


def test_evaluate_with_rng_hooks_resumes_to_the_same_scores(tmp_path):
    cfg = _port_workdir(tmp_path)
    rounds_seen = []

    def hooks(stop=False):
        def sample_fn(state, generator):
            if stop and int(state.step) == 4 and len(rounds_seen) == 3:
                raise Stop
            rounds_seen.append(generator.initial_seed())
            return torch.rand(4, 16, 16, 3, generator=generator)

        return dict(sample_fn=sample_fn, feature_fn=lambda im: tuple(
            torch.from_numpy(a) for a in _extractor(im.numpy())))

    whole = run_lib.evaluate(cfg, rounds=2, device="cpu", **hooks())
    seeds = list(rounds_seen)
    assert len(set(seeds)) == 4   # a stream per checkpoint and round
    for f in os.listdir(os.path.join(cfg.workdir, "eval")):
        os.remove(os.path.join(cfg.workdir, "eval", f))
    rounds_seen.clear()
    with pytest.raises(Stop):
        run_lib.evaluate(cfg, rounds=2, device="cpu", **hooks(stop=True))
    resumed = run_lib.evaluate(cfg, rounds=2, device="cpu", **hooks())
    assert rounds_seen == seeds
    assert resumed[4]["inception_score"] == whole[4]["inception_score"]
    assert resumed[4]["fid"] == whole[4]["fid"]


# --------------------------------------------------------------------------- #
# utils/logging.py
# --------------------------------------------------------------------------- #


def test_metric_writer_matches_jax(tmp_path):
    rows = [(0, dict(loss=1.5, lr=0.1)), (5, dict(loss=np.float32(0.25), grad=3)),
            (7, dict(loss=torch.tensor(0.125)))]
    out = {}
    for name, mod in (("jax", jlogging), ("port", plogging)):
        w = mod.MetricWriter(str(tmp_path / name), tensorboard=False, csv=True)
        for step, scalars in rows:
            w.write(step, **{k: (float(v) if name == "jax" else v) for k, v in scalars.items()})
        w.close()
        with open(tmp_path / name / "metrics.jsonl") as f:
            recs = [json.loads(line) for line in f]
        for r in recs:
            r.pop("time")
        with open(tmp_path / name / "metrics.csv") as f:
            out[name] = (recs, f.read())
    assert out["port"] == out["jax"]


def _tensorboard_scalars(logdir):
    """{tag: [(step, value)]} of a TensorBoard log directory, scalar
    summaries (PyTorch's writer) or scalar tensors (tf.summary's)."""
    import tensorflow as tf
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(logdir, size_guidance={"scalars": 0, "tensors": 0}).Reload()
    out = {t: [(e.step, e.value) for e in acc.Scalars(t)] for t in acc.Tags()["scalars"]}
    out.update({t: [(e.step, float(tf.make_ndarray(e.tensor_proto))) for e in acc.Tensors(t)]
                for t in acc.Tags()["tensors"]})
    return out


def test_metric_writer_tensorboard_matches_jax(tmp_path):
    """TensorBoard through PyTorch's writer (the JAX package's goes through
    tensorflow): the same scalars at the same steps as the JAX writer's
    event file, read back by TensorBoard's reader."""
    pytest.importorskip("torch.utils.tensorboard")
    pytest.importorskip("tensorflow")
    for name, mod in (("jax", jlogging), ("port", plogging)):
        w = mod.MetricWriter(str(tmp_path / name))
        w.write(0, loss=1.5, lr=0.1)
        w.write(5, loss=0.25, grad=3.0)
        w.close()
    got = _tensorboard_scalars(str(tmp_path / "port"))
    assert got == _tensorboard_scalars(str(tmp_path / "jax"))
    assert sorted(got) == ["grad", "loss", "lr"] and got["loss"][1] == (5, 0.25)


@pytest.mark.parametrize("b,ncols", [(5, None), (6, 4)])
def test_image_grid_matches_jax(b, ncols, tmp_path):
    images = np.random.default_rng(12).random((b, 6, 5, 3)).astype(np.float32)
    want = jlogging.image_grid(images, ncols=ncols)
    assert np.array_equal(plogging.image_grid(torch.from_numpy(images), ncols=ncols), want)
    jlogging.save_image_grid(images, str(tmp_path / "j.png"), ncols=ncols)
    plogging.save_image_grid(images, str(tmp_path / "p.png"), ncols=ncols)
    assert sorted(os.listdir(tmp_path)) in (["j.png", "p.png"], ["j.png.npy", "p.png.npy"])
    with open(tmp_path / sorted(os.listdir(tmp_path))[0], "rb") as a, \
            open(tmp_path / sorted(os.listdir(tmp_path))[1], "rb") as c:
        assert a.read() == c.read()
    with plogging.wall_timer() as t, plogging.trace_span("grid"):
        plogging.image_grid(images)
    assert t["seconds"] >= 0.0
