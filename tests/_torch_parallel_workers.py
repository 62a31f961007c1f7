"""Rank bodies of the port's multi-rank CPU tests (gloo ranks started by
`dpm_solver_tpu_torch.parallel.launch.run_ranks`). They import torch and the
port only, so that a spawned rank starts fast; each returns numpy arrays and
numbers for the test process to hold against the single-process port and the
JAX package."""

import numpy as np
import torch

import dpm_solver_tpu_torch as P
from dpm_solver_tpu_torch.models import (ADMConfig, ADMUNet, DDPMUNet, DDPMUNetConfig,
                                         init_random_)

BETAS = np.linspace(1e-4, 0.02, 1000)
SD_TINY = dict(image_size=8, in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
               attention_resolutions=(1, 2), channel_mult=(1, 2), num_heads=2,
               use_spatial_transformer=True, transformer_depth=1, context_dim=24)
# five heads of 8 at 40 channels: two ranks split them 3 + 2 (SD-2.1's case)
SD_FIVE = dict(SD_TINY, model_channels=40, channel_mult=(1,), attention_resolutions=(1,),
               num_heads=-1, num_head_channels=8, legacy=False, use_linear_in_transformer=True)
# ADM self-attention blocks (no spatial transformer), legacy and new qkv orders
ADM_ATTN = dict(image_size=8, in_channels=3, model_channels=32, out_channels=3,
                num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2), num_heads=4)


def tiny_unet(seed=0):
    net = DDPMUNet(DDPMUNetConfig.tiny(resolution=16), device="cpu")
    return init_random_(net, torch.Generator().manual_seed(seed)).eval()


def sd_unet(kw, seed=0):
    return init_random_(ADMUNet(ADMConfig(**kw), device="cpu"),
                        torch.Generator().manual_seed(seed)).eval()


def schedule():
    return P.NoiseScheduleVP("discrete", betas=torch.tensor(BETAS))


def x_batch(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


# --------------------------------------------------------------------------- #
# sampling, training, ZeRO-1 and the multihost helpers: one world of 2 ranks
# --------------------------------------------------------------------------- #


def data_parallel_rank(rank, world, outdir):
    from dpm_solver_tpu_torch.parallel import (batch_sharding, make_mesh, make_sharded_sampler,
                                               sample_noise)
    from dpm_solver_tpu_torch.parallel import multihost as mh
    from dpm_solver_tpu_torch.parallel.zero import (optstate_shardings, shard_train_step,
                                                    state_bytes)
    from dpm_solver_tpu_torch.training.optim import Adam
    from dpm_solver_tpu_torch.training.train import make_train_state, make_train_step

    out = {}
    mesh = make_mesh(device="cpu")
    sharding = batch_sharding(mesh)
    net, ns = tiny_unet(), schedule()
    model_fn = P.model_wrapper(lambda x, t: net(x, t), ns)
    x = x_batch(0, (8, 16, 16, 3))
    kw = dict(steps=6, order=2, method="multistep")
    with torch.no_grad():
        fn = P.build_sampler(model_fn, ns, **kw)
        out["sharded_sampler"] = make_sharded_sampler(fn, mesh)(x).numpy()
        out["sample_mesh"] = P.DPM_Solver(model_fn, ns).sample(x, mesh=mesh, **kw).numpy()
        out["sample_single"] = P.DPM_Solver(model_fn, ns).sample(x, **kw).numpy()
        # an SDE solver with its noise split with x
        noise = x_batch(1, (6, 8, 16, 16, 3))
        sde = P.DPM_Solver(model_fn, ns, algorithm_type="sde-dpmsolver++")
        out["sde_mesh"] = sde.sample(x, noise=noise, mesh=mesh, **kw).numpy()
        out["sde_single"] = sde.sample(x, noise=noise, **kw).numpy()
        errors = {}
        for name, call in (
                ("adaptive", lambda: P.DPM_Solver(model_fn, ns).sample(x, method="adaptive",
                                                                      mesh=mesh)),
                ("jit", lambda: P.DPM_Solver(model_fn, ns).sample(x, mesh=mesh, jit=False, **kw)),
                ("noise", lambda: sde.sample(x, mesh=mesh, **kw)),
                # a model function closed over a full-batch tensor fails loudly
                ("closed_over", lambda: P.DPM_Solver(
                    P.model_wrapper(lambda u, t: net(u, t) + 0 * x, ns), ns).sample(
                    x, mesh=mesh, **kw)),
                ("indivisible", lambda: P.DPM_Solver(model_fn, ns).sample(x[:3], mesh=mesh,
                                                                         **kw))):
            try:
                call()
                errors[name] = None
            except Exception as e:  # the test matches type and message
                errors[name] = (type(e).__name__, str(e))
        out["errors"] = errors

    # noise: the rank's rows of one global draw
    out["noise_rows"] = sample_noise(42, (16, 4, 4, 3), sharding=sharding).numpy()
    out["noise_global"] = sample_noise(42, (16, 4, 4, 3)).numpy()

    # the data-parallel step against the single-process one (dropout 0): the
    # gradients the optimiser sees, the loss, and the Adam update
    class Recorded(Adam):
        def _apply(self, params, grads, state):
            self.grads = {k: g.detach().clone() for k, g in grads.items()}
            super()._apply(params, grads, state)

    x0 = x_batch(2, (8, 16, 16, 3))
    runs = {}
    for mode in ("single", "dp", "zero"):
        net_m = tiny_unet()
        tx = Recorded(1e-3, grad_clip=1.0)
        state, _ = make_train_state(net_m, tx=tx)
        step = make_train_step(lambda u, t: net_m(u, t), ns, tx,
                               mesh=None if mode == "single" else mesh)
        if mode == "zero":
            out["zero_axes"] = optstate_shardings(state, mesh, tx)["opt_state"]["mu"]
            out["bytes_replicated"] = state_bytes(state.opt_state)
            step, state, _ = shard_train_step(step, mesh, state, tx)
            out["bytes_zero"] = state_bytes(state.opt_state)
            out["zero_local_shapes"] = {k: tuple(m.shape) for k, m in
                                        state.opt_state["mu"].items()}
        state, metrics = step(state, x0, 7)
        runs[mode] = dict(loss=float(metrics["loss"]), norm=float(metrics["grad_norm"]),
                          grads={k: g.numpy() for k, g in tx.grads.items()},
                          params={k: p.detach().numpy().copy() for k, p in state.params.items()})
    out["train"] = runs
    # Adam applied to equal gradients: the single-process update from the
    # data-parallel gradients equals the data-parallel update
    net_e = tiny_unet()
    tx_e = Adam(1e-3, grad_clip=1.0)
    state_e, _ = make_train_state(net_e, tx=tx_e)
    tx_e.step(state_e.params, {k: torch.from_numpy(g.copy()) for k, g in
                               runs["dp"]["grads"].items()}, state_e.opt_state)
    out["adam_from_dp_grads"] = {k: p.detach().numpy().copy() for k, p in state_e.params.items()}

    # ZeRO-1 over Adafactor (its factored statistics sharded too, at a small
    # min_size): the update from the data-parallel gradients equals the
    # unsharded one
    from dpm_solver_tpu_torch.parallel.zero import shard_optimizer_state
    from dpm_solver_tpu_torch.training.optim import Adafactor, flax_layouts

    adafactor = {}
    for mode in ("replicated", "zero"):
        net_a = tiny_unet()
        tx_a = Adafactor(1e-2, grad_clip=1.0, layouts=flax_layouts(net_a),
                         min_dim_size_to_factor=16)
        state_a, _ = make_train_state(net_a, tx=tx_a)
        if mode == "zero":
            axes = shard_optimizer_state(state_a, mesh, tx_a, min_size=16)["opt_state"]
            out["adafactor_sharded"] = sum(ax is not None for key in ("v_row", "v_col", "v")
                                           for ax in axes[key].values())
        tx_a.step(state_a.params, {k: torch.from_numpy(g.copy()) for k, g in
                                   runs["dp"]["grads"].items()}, state_a.opt_state)
        adafactor[mode] = {k: p.detach().numpy().copy() for k, p in state_a.params.items()}
    out["adafactor"] = adafactor

    # the latent step (per-sample contexts split with the batch), the same way
    from dpm_solver_tpu_torch.training.latent import make_latent_train_step

    z0, ctx = x_batch(3, (4, 8, 8, 4)), x_batch(4, (4, 7, 24))
    latent = {}
    for mode in ("single", "dp"):
        unet = sd_unet(SD_TINY, 5)
        tx = Recorded(1e-3, grad_clip=1.0)
        state, _ = make_train_state(unet, tx=tx)
        step = make_latent_train_step(lambda u, t, c: unet(u, t, None, c), tx, BETAS,
                                      mesh=None if mode == "single" else mesh)
        _, metrics = step(state, z0, ctx, 9)
        latent[mode] = dict(loss=float(metrics["loss"]),
                            grads={k: g.numpy() for k, g in tx.grads.items()})
    out["latent"] = latent

    # the multihost helpers across the ranks
    from dpm_solver_tpu_torch.parallel import per_process_key

    out["per_process_key"] = per_process_key(0)
    out["host_fold"] = mh.allgather_metrics(np.asarray([mh.host_fold(0)], np.int64))
    out["metric_shapes"] = {k: v.shape for k, v in mh.allgather_metrics(
        {"loss": 1.5, "vec": np.arange(3.0), "t": torch.ones(2, 2)}).items()}
    out["subset"] = mh.host_subset(list(range(10)))
    mh.barrier("test")
    out["smoke"] = mh._smoke_worker(rank, world)
    return out


def run_lib_rank(rank, world, workdir):
    """run_lib.train(mesh=) on the tiny_test config, 3 steps over the ranks:
    each step's metrics (the loss and gradient norm, logged every step),
    the parameters (every rank's the same) and the checkpoints (rank 0's)."""
    import dataclasses

    from dpm_solver_tpu_torch import run_lib
    from dpm_solver_tpu_torch.configs import get_config
    from dpm_solver_tpu_torch.parallel import make_mesh

    config = dataclasses.replace(get_config("tiny_test"), workdir=workdir)
    batches = np.random.default_rng(0).standard_normal((3, 8, 16, 16, 3)).astype(np.float32)
    metrics = []
    run_lib._log_step = lambda step, m: metrics.append(
        (step, float(m["loss"]), float(m["grad_norm"])))
    state = run_lib.train(config, iter(batches), max_steps=3, mesh=make_mesh(device="cpu"))
    return dict(step=state.step, metrics=metrics,
                params={k: p.detach().numpy().copy() for k, p in state.params.items()})


def stable_encoder(dim):
    """A prompt -> (77, dim) stand-in encoder that gives every process the
    same values (`constant_context_encoder` seeds from the per-process string
    hash), seeded by each prompt's crc32."""
    import zlib

    def encode(prompts):
        return torch.stack([torch.randn(77, dim, generator=torch.Generator().manual_seed(
            zlib.crc32(p.encode()))) for p in prompts])

    return encode


def pipeline_rank(rank, world):
    """StableDiffusionPipeline.txt2img / DPMSolverSampler.sample with a mesh,
    against the same calls without one, on the tiny SD bundle."""
    from dpm_solver_tpu_torch.models import AutoencoderKL, VAEConfig
    from dpm_solver_tpu_torch.parallel import make_mesh
    from dpm_solver_tpu_torch.pipelines import (LatentDiffusion, MaskedBlend,
                                                StableDiffusionPipeline)

    mesh = make_mesh(device="cpu")
    unet = sd_unet(SD_TINY, 1)
    vae = init_random_(AutoencoderKL(VAEConfig.tiny(resolution=16, attn_resolutions=()),
                                     device="cpu"), torch.Generator().manual_seed(2)).eval()
    pipe = StableDiffusionPipeline(LatentDiffusion(unet, vae, text_encode=stable_encoder(24)),
                                   device="cpu")
    prompts = ["a", "b", "c", "d"]
    out = {}
    with torch.no_grad():
        kw = dict(steps=4, height=16, width=16, generator=None, guidance_scale=7.5)
        out["txt2img_mesh"] = pipe.txt2img(prompts, mesh=mesh, **kw).numpy()
        out["txt2img_single"] = pipe.txt2img(prompts, **kw).numpy()
        # a per-sample context and a blend whose table and mask are per sample
        cond = x_batch(3, (4, 7, 24))
        uncond = torch.zeros(4, 7, 24)
        z = x_batch(4, (4, 2, 2, 4))
        table, mask = x_batch(5, (5, 4, 2, 2, 4)), (x_batch(6, (4, 2, 2, 1)) > 0).float()
        for name, mesh_arg in (("sample_mesh", mesh), ("sample_single", None)):
            x, inter = pipe.sampler.sample(4, 4, (2, 2, 4), cond, unconditional_guidance_scale=3.0,
                                           unconditional_conditioning=uncond, x_T=z,
                                           correcting_xt_fn=MaskedBlend(table, mask),
                                           mesh=mesh_arg)
            out[name] = (x.numpy(), [u.numpy() for u in inter])
    return out


# --------------------------------------------------------------------------- #
# tensor parallelism: one world of 4 ranks, a (2, 2) (data, model) mesh
# --------------------------------------------------------------------------- #


def _grads_of(model, x, t, ctx, weight):
    out = model(x, t, None, ctx)
    loss = (out * weight).sum()
    names = [k for k, p in model.named_parameters()]
    return loss, dict(zip(names, torch.autograd.grad(loss, [p for _, p in
                                                             model.named_parameters()])))


def tensor_parallel_rank(rank, world):
    from dpm_solver_tpu_torch.parallel import batch_sharding, make_mesh, sample_noise
    from dpm_solver_tpu_torch.parallel.mesh import all_reduce_mean_, axis_group
    from dpm_solver_tpu_torch.parallel.tp import make_tp_fn, make_tp_mesh, tp_param_specs

    out = {}
    mesh = make_tp_mesh(world, data=2, model=2, device="cpu")
    data = batch_sharding(mesh)
    out["noise_rows"] = sample_noise(42, (16, 4, 4, 3), sharding=data).numpy()
    # and over a 1-D mesh of all four ranks
    out["noise_rows4"] = sample_noise(42, (16, 4, 4, 3),
                                      sharding=batch_sharding(make_mesh(device="cpu"))).numpy()
    out["coords"] = (mesh.get_local_rank("data"), mesh.get_local_rank("model"))
    for name, kw in (("tiny", SD_TINY), ("five", SD_FIVE), ("adm_legacy", ADM_ATTN),
                     ("adm_new", dict(ADM_ATTN, use_new_attention_order=True))):
        b = 4
        shape = (b, kw["image_size"], kw["image_size"], kw["in_channels"])
        x, t = x_batch(10, shape), torch.linspace(1.0, 999.0, b)
        ctx = x_batch(11, (b, 7, 24)) if kw.get("context_dim") else None
        weight = x_batch(12, shape[:3] + (kw["out_channels"],))
        loc = lambda u: None if u is None else data.local(u)
        conds = () if ctx is None else (ctx,)
        full = sd_unet(kw, 3)
        with torch.no_grad():
            want = full(x, t, None, *conds).numpy()
        # the unsharded gradients of the rank's data rows, averaged over the
        # data axis as the sharded ones are
        _, g_full = _grads_of(full, loc(x), loc(t), loc(ctx), loc(weight))
        specs = tp_param_specs(full)
        tp_fn, model = make_tp_fn(lambda m, u, s, *c: m(u, s, None, *c), mesh, sd_unet(kw, 3))
        with torch.no_grad():
            got = tp_fn(x, t, *conds)
        _, g_tp = _grads_of(model, loc(x), loc(t), loc(ctx), loc(weight))
        all_reduce_mean_(list(g_tp.values()), axis_group(mesh, "data"))
        all_reduce_mean_(list(g_full.values()), axis_group(mesh, "data"))
        out[name] = dict(
            want=want, got=got.numpy(), specs=specs,
            shapes={k: tuple(p.shape) for k, p in model.named_parameters()},
            local={k: p.detach().numpy() for k, p in model.named_parameters()
                   if specs[k] is not None},
            full_shapes={k: tuple(p.shape) for k, p in full.named_parameters()},
            g_tp={k: g.numpy() for k, g in g_tp.items()},
            g_full={k: g.numpy() for k, g in g_full.items()},
            heads={n: m.heads for n, m in model.named_modules() if hasattr(m, "dim_head")},
            state={k: v.numpy() for k, v in full.state_dict().items()} if rank == 0 else None)
    return out


def aborting_rank(rank, world, text):
    """Rank `world - 1` writes `text` to its stderr and aborts (SIGABRT, no
    Python traceback); the others wait at a barrier for it."""
    import os
    import sys

    import torch.distributed as dist

    if rank == world - 1:
        sys.stderr.write(text + "\n")
        sys.stderr.flush()
        os.abort()
    dist.barrier()
    return rank
