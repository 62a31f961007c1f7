"""Tensor parallelism (dpm_solver_tpu_torch/parallel/tp.py) against the
unsharded port and the JAX package.

One world of four gloo ranks on the CPU, a (2, 2) (data, model) mesh
(`_torch_parallel_workers.tensor_parallel_rank`), b4:
- on the dryrun's tiny SD UNet (`__graft_entry__.py:154-158`'s ADMConfig),
  a 5-head config (heads of 8 at 40 channels, split 3 + 2 as SD-2.1's 5
  heads of 64 are), and ADM self-attention blocks in both qkv layouts: the
  tensor-parallel forward within 1e-5 of the unsharded port's, and the
  gradients (each rank's data rows, averaged over the data axis) within 1e-5
  of their max, a sharded parameter's against the rows of the unsharded
  gradient its slice holds;
- every leaf JAX `tp_param_specs` shards has its port counterpart sharded on
  the matching torch axis, and the full SD-2.1 tree splits as JAX's does
  (112 column and 64 row kernels);
- the forward within 1e-4 of JAX `make_tp_fn` on a (2, 2) CPU mesh, the
  weights carried across by `convert_adm_unet`;
- `sample_noise` at world size 4: the ranks' rows of the global draw.
"""

import numpy as np
import pytest
import torch

import _torch_parallel_workers as W
from dpm_solver_tpu_torch.models import ADMConfig, ADMUNet
from dpm_solver_tpu_torch.parallel import sample_noise
from dpm_solver_tpu_torch.parallel.launch import run_ranks
from dpm_solver_tpu_torch.parallel.tp import split_sizes, tp_param_specs, tp_spec_for
from dpm_solver_tpu_torch.training.optim import flax_order

CONFIGS = ("tiny", "five", "adm_legacy", "adm_new")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tp"))
    return run_ranks(W.tensor_parallel_rank, 4, threads=1, timeout=300, directory=d)


@pytest.mark.parametrize("name", CONFIGS)
def test_tp_forward_matches_unsharded(tp, name):
    for r in tp:
        want = r[name]["want"]
        np.testing.assert_allclose(r[name]["got"], want, rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(want).max())))


def _rows_of(local, full, ax):
    """The indices along `ax` of `full` whose slices `local` holds (by value)."""
    f = np.moveaxis(full, ax, 0).reshape(full.shape[ax], -1)
    idx = []
    for row in np.moveaxis(local, ax, 0).reshape(local.shape[ax], -1):
        hits = np.flatnonzero((f == row).all(axis=1))
        assert len(hits) >= 1
        idx.append(int(hits[0]))
    return idx


@pytest.mark.parametrize("name", CONFIGS)
def test_tp_gradients_match_unsharded(tp, name):
    full_state = tp[0][name]["state"]
    covered = {}
    for rank, r in enumerate(tp):
        rec = r[name]
        gmax = max(float(np.abs(g).max()) for g in rec["g_full"].values())
        for k, g in rec["g_tp"].items():
            ax, gf = rec["specs"][k], rec["g_full"][k]
            if ax is None:
                np.testing.assert_allclose(g / gmax, gf / gmax, rtol=0, atol=1e-5, err_msg=k)
                continue
            # a column-parallel bias follows its weight's rows (its own
            # values, one a row, may repeat)
            w = k[:-len("bias")] + "weight" if rec["local"][k].ndim == 1 else k
            idx = _rows_of(rec["local"][w], full_state[w], ax)
            np.testing.assert_allclose(g / gmax, np.take(gf, idx, axis=ax) / gmax, rtol=0,
                                       atol=1e-5, err_msg=k)
            covered.setdefault((k, r["coords"][0]), []).extend(idx)
    # the model ranks' slices cover each sharded tensor once
    for (k, _), idx in covered.items():
        ax = tp[0][name]["specs"][k]
        assert sorted(idx) == list(range(full_state[k].shape[ax])), k


def test_uneven_heads_split_three_and_two(tp):
    heads = sorted({r["five"]["heads"]["input_blocks.1.1.transformer_blocks.0.attn1"]
                    for r in tp})
    assert heads == [2, 3] and split_sizes(5, 2) == [3, 2]


def _flax_names(state, cfg_kw):
    """Port name of each Flax leaf of `convert_adm_unet(state)`, by value."""
    import jax

    from dpm_solver_tpu.models.adm_unet import ADMConfig as JaxConfig
    from dpm_solver_tpu.utils.convert import convert_adm_unet

    names = sorted(state)
    marked = {k: np.full(state[k].shape, float(i + 1), np.float32) for i, k in enumerate(names)}
    flat = jax.tree_util.tree_flatten_with_path(convert_adm_unet(marked, JaxConfig(**cfg_kw)))[0]
    out = {}
    for path, leaf in flat:
        vals = np.unique(np.asarray(leaf))
        if len(vals) == 1:
            out["/".join(getattr(p, "key", str(p)) for p in path)] = names[int(vals[0]) - 1]
    return out


def test_tp_specs_agree_with_jax_leaf_for_leaf(tp):
    import jax

    from dpm_solver_tpu.models.adm_unet import ADMConfig as JaxConfig
    from dpm_solver_tpu.parallel.tp import tp_param_specs as jax_specs
    from dpm_solver_tpu.utils.convert import convert_adm_unet

    state = tp[0]["tiny"]["state"]
    specs = jax_specs(convert_adm_unet(state, JaxConfig(**W.SD_TINY)))
    by_path = {"/".join(getattr(p, "key", str(p)) for p in path): s
               for path, s in jax.tree_util.tree_flatten_with_path(specs)[0]}
    names = _flax_names(state, W.SD_TINY)
    port = tp[0]["tiny"]["specs"]
    sharded = 0
    for path, name in names.items():
        spec = tuple(by_path[path])
        t = torch.from_numpy(state[name])
        if "model" in spec:
            perm = flax_order(t)
            assert port[name] == perm[spec.index("model")], (path, name, spec)
            sharded += 1
        else:
            assert port[name] is None, (path, name)
    assert sharded >= 20


def test_tp_specs_cover_full_sd21_tree():
    with torch.device("meta"):
        model = ADMUNet(ADMConfig.sd_v2_1(), device="meta")
    specs = tp_param_specs(model)
    col = [k for k, ax in specs.items() if ax == 0 and k.endswith("weight")]
    row = [k for k, ax in specs.items() if ax == 1]
    assert len(col) == 112 and len(row) == 64
    assert tp_spec_for("attn1.to_out.0.bias", 1) is None
    assert tp_spec_for("ff.net.0.proj.bias", 1) == 0


def test_tp_forward_matches_jax_make_tp_fn(tp):
    import jax
    import jax.numpy as jnp

    from dpm_solver_tpu.models.adm_unet import ADMConfig as JaxConfig
    from dpm_solver_tpu.models.adm_unet import ADMUNet as JaxADMUNet
    from dpm_solver_tpu.parallel.tp import make_tp_fn, make_tp_mesh
    from dpm_solver_tpu.utils.convert import convert_adm_unet

    params = convert_adm_unet(tp[0]["tiny"]["state"], JaxConfig(**W.SD_TINY))
    net = JaxADMUNet(config=JaxConfig(**W.SD_TINY))
    t = jnp.linspace(1.0, 999.0, 4)
    ctx = jnp.asarray(W.x_batch(11, (4, 7, 24)).numpy())

    def fn(p, x):
        return net.apply(p, x, t, None, ctx, deterministic=True)

    mesh = make_tp_mesh(jax.devices()[:4], data=2, model=2)
    jitted, sharded = make_tp_fn(fn, mesh, params)
    want = np.asarray(jitted(sharded, jnp.asarray(W.x_batch(10, (4, 8, 8, 4)).numpy())))
    np.testing.assert_allclose(tp[0]["tiny"]["got"], want, rtol=0,
                               atol=1e-4 * max(1.0, float(np.abs(want).max())))


def test_noise_is_world_size_invariant_at_four(tp):
    glob = sample_noise(42, (16, 4, 4, 3)).numpy()
    np.testing.assert_array_equal(np.concatenate([r["noise_rows4"] for r in tp]), glob)
    # on the (2, 2) mesh the data axis splits the draw in two; each model
    # pair holds the same rows
    by_data = {r["coords"][0]: r["noise_rows"] for r in tp}
    np.testing.assert_array_equal(np.concatenate([by_data[0], by_data[1]]), glob)
    for r in tp:
        np.testing.assert_array_equal(r["noise_rows"], by_data[r["coords"][0]])
