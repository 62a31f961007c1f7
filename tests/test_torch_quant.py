"""The port's int8 W8A8 serving path (dpm_solver_tpu_torch/ops/quant.py) against
the JAX package's (dpm_solver_tpu/ops/quant.py), on seeded numpy inputs.

- `quantize`: the int8 codes equal JAX's on at least 99.9% of entries (a
  one-ulp difference of x / scale can land on the other side of a .5), the
  scales within one ulp.
- `w8a8_matmul` and `w8a8_conv`: bit-equal to numpy on representable inputs
  (integer values whose absmax is 127 quantize losslessly, so the int32 sums
  come back exact), and to JAX's within 5e-3 of max|out| on random inputs:
  the quantization-flip scale of tests/test_quant.py:172-180 (one activation
  across an int8 rounding boundary moves its product by ~amax/127).
- `int8_mm`'s zero padding (M <= 16; K or N not a multiple of 8) leaves the
  int32 product exact; a zero kernel stays exact.
- `w8a8_geglu`, the tiny SD UNet of tests/test_quant.py:236-262 in both
  modes, and a tiny latent trajectory through `load_sd_checkpoint(quant=)`
  at the JAX quant sampler test's scales against the JAX package on
  converted weights within 5e-3 of max; the quant forwards against the
  port's own float forward within the JAX tests' relative RMSE of 0.1.
- Where fp32 rounding upstream of a quantizer flips codes and the flips
  compound (the tiny VAE decode; CFG 7.5 trajectories), every int8 product
  of the JAX run, replayed on the port with the JAX inputs, is bit-equal,
  and the end-to-end gap is held within the JAX package's own gap under a
  rounding-level change (its jitted against its op-by-op decode; twice its
  move when x_T moves by one ulp, that move capped at the largest measured
  over a few seeds).
- The state dicts are the same for quant None, "w8a8" and "w8a8_conv".
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu.ops import quant as jq
from dpm_solver_tpu_torch.models import ADMConfig, ADMUNet, AutoencoderKL, VAEConfig
from dpm_solver_tpu_torch.ops import launch_counts
from dpm_solver_tpu_torch.ops import quant as pq
from dpm_solver_tpu_torch.utils.convert import (adm_unet_state_dict_from_flax,
                                                autoencoder_kl_state_dict_from_flax)

FLIP = 5e-3      # quantization-flip bound, relative to max|out|
RMSE = 0.1       # quant vs float, relative RMSE (tests/test_quant.py:262)
UNET = dict(image_size=8, in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
            attention_resolutions=(1, 2), channel_mult=(1, 2), num_heads=2,
            use_spatial_transformer=True, transformer_depth=1, context_dim=24,
            use_linear_in_transformer=True)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small CPU runs: the suite runs several
    workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _densify(params, scale=0.05, seed=9):
    """tests/test_quant.py's additive noise on every leaf (zero-initialised
    residual gates would otherwise make the float output identically x)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a + rng.standard_normal(a.shape) * scale, np.float32), params)


def _close(got, want, bound=FLIP):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= bound, err


def _rel_rmse(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2))


# --------------------------------------------------------------------------- #
# the functions
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("shape,dim", [((64, 96), 1), ((3, 9, 7, 24), (1, 2, 3)),
                                       ((3, 3, 40, 24), (0, 1, 2))])
def test_quantize_matches_jax(shape, dim):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 30.0, shape[-1])).astype(np.float32)
    x[0] = 0.0    # an all-zero slice along `dim` where dim=1: the guarded scale
    q, s = pq.quantize(torch.from_numpy(x), dim)
    jqv, js = jq.quantize(jnp.asarray(x), dim)
    jqv, js = np.asarray(jqv), np.asarray(js)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.mean(q.numpy() == jqv) >= 0.999
    assert np.abs(q.numpy().astype(np.int32) - jqv).max() <= 1
    np.testing.assert_array_max_ulp(s.numpy(), js, maxulp=1)
    assert np.abs(q.numpy()).max() <= 127


def test_quantize_rounds_half_to_even():
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 126.5]])
    q, s = pq.quantize(x, 1)
    assert s.item() == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2, 126]]
    np.testing.assert_array_equal(np.asarray(jq.quantize(jnp.asarray(x.numpy()), 1)[0]),
                                  q.numpy())


def test_w8a8_matmul_exact_on_representable_inputs():
    """tests/test_quant.py:20's exact case: the row and column scales are 1."""
    rng = np.random.default_rng(0)
    x = rng.integers(-127, 128, size=(16, 64)).astype(np.float32)
    w = rng.integers(-127, 128, size=(64, 32)).astype(np.float32)   # (K, N)
    x[:, 0] = 127
    w[0, :] = -127
    bias = rng.standard_normal(32).astype(np.float32)
    got = pq.w8a8_matmul(torch.from_numpy(x), torch.from_numpy(w.T.copy()), torch.from_numpy(bias))
    np.testing.assert_array_equal(got.numpy(), x @ w + bias)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jq.w8a8_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))))


@pytest.mark.parametrize("m,k,n", [(128, 256, 192), (5, 20, 12), (77, 768, 320)])
def test_w8a8_matmul_matches_jax(m, k, n):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    got = pq.w8a8_matmul(torch.from_numpy(x), torch.from_numpy(w.T.copy()), torch.from_numpy(b))
    want = np.asarray(jq.w8a8_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    _close(got.numpy(), want)
    assert _rel_rmse(got.numpy(), x @ w + b) < 0.03   # tests/test_quant.py:44


def test_w8a8_matmul_lead_dims_and_dtype():
    x = torch.zeros(2, 3, 32, dtype=torch.bfloat16)
    w = torch.from_numpy(np.random.default_rng(2).standard_normal((8, 32)).astype(np.float32))
    out = pq.w8a8_matmul(x, w)
    assert out.shape == (2, 3, 8) and out.dtype == torch.bfloat16
    assert torch.all(out == 0)


@pytest.mark.parametrize("m,k,n", [(1, 3, 1), (5, 13, 7), (16, 64, 32), (17, 24, 9),
                                   (40, 8, 8), (33, 100, 30)])
def test_int8_mm_padding_is_exact(m, k, n):
    g = torch.Generator().manual_seed(m * 1000 + k * 10 + n)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    got = pq.int8_mm(a, b)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    torch.testing.assert_close(got, a.int() @ b.int().T, rtol=0, atol=0)


def _conv_ref(x, w, bias):
    """float64 3x3 SAME NHWC conv (exact on these integer values)."""
    out = torch.nn.functional.conv2d(torch.from_numpy(x).double().permute(0, 3, 1, 2),
                                     torch.from_numpy(w).double().permute(3, 2, 0, 1), padding=1)
    return (out.permute(0, 2, 3, 1) + torch.from_numpy(bias).double()).numpy()


def test_w8a8_conv_exact_on_representable_inputs():
    """Per-image absmax 127 and per-channel weight absmax 127: the scales are
    1, so the int32 sums (here < 2^24, exact in fp32) come back as they are,
    equal to numpy's and to XLA's int8 convolution's."""
    rng = np.random.default_rng(3)
    x = rng.integers(-127, 128, size=(2, 7, 9, 16)).astype(np.float32)
    w = rng.integers(-127, 128, size=(3, 3, 16, 12)).astype(np.float32)
    x[:, 0, 0, 0] = 127
    w[0, 0, 0, :] = -127
    bias = rng.integers(-5, 5, size=12).astype(np.float32)
    got = pq.w8a8_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias))
    np.testing.assert_array_equal(got.numpy(), _conv_ref(x, w, bias).astype(np.float32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jq.w8a8_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))))


@pytest.mark.parametrize("shape,co", [((2, 8, 8, 32), 32), ((3, 5, 6, 4), 12),
                                      ((1, 16, 16, 64), 24)])
def test_w8a8_conv_matches_jax(shape, co, monkeypatch):
    rng = np.random.default_rng(4)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, shape[-1], co)) * 0.05).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    want = np.asarray(jq.w8a8_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = pq.w8a8_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    _close(got.numpy(), want)
    # one image an im2col block: the same numbers
    monkeypatch.setattr(pq, "CONV_CHUNK_BYTES", 1)
    torch.testing.assert_close(pq.w8a8_conv(torch.from_numpy(x), torch.from_numpy(w),
                                            torch.from_numpy(b)), got, rtol=0, atol=0)


def test_zero_kernel_stays_exact():
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 6, 6, 8)).astype(np.float32))
    bias = torch.tensor([0.5, -1.25, 3.0])
    out = pq.w8a8_conv(x, torch.zeros(3, 3, 8, 3), bias)
    torch.testing.assert_close(out, bias.expand(2, 6, 6, 3), rtol=0, atol=0)
    out = pq.w8a8_matmul(x.reshape(-1, 8), torch.zeros(3, 8), bias)
    torch.testing.assert_close(out, bias.expand(72, 3), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w8a8_geglu_matches_jax(dtype):
    rng = np.random.default_rng(6)
    d, inner = 32, 128
    x = rng.standard_normal((2, 24, d)).astype(np.float32)
    w1 = (rng.standard_normal((d, 2 * inner)) * d ** -0.5).astype(np.float32)
    b1 = (rng.standard_normal(2 * inner) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((inner, d)) * inner ** -0.5).astype(np.float32)
    b2 = (rng.standard_normal(d) * 0.1).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jq.w8a8_geglu(jnp.asarray(x, jdt), jnp.asarray(w1), jnp.asarray(b1),
                                    jnp.asarray(w2), jnp.asarray(b2)).astype(jnp.float32))
    got = pq.w8a8_geglu(torch.from_numpy(x).to(dtype), torch.from_numpy(w1.T.copy()),
                        torch.from_numpy(b1), torch.from_numpy(w2.T.copy()),
                        torch.from_numpy(b2))
    assert got.dtype == dtype
    _close(got.float().numpy(), want, FLIP if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("mode", pq.QUANT_MODES)
def test_projections_follow_the_mode(mode):
    """The JAX `dense` factory's rule, module by module: under "w8a8" and
    "w8a8_conv" every attention projection and a linear proj_in are
    `QuantLinear` (nn.Linear's state dict); proj_out, zero-initialised in
    the reference, stays float; an unknown mode raises."""
    from dpm_solver_tpu_torch.models.transformer import SpatialTransformer

    st = SpatialTransformer(16, 2, 8, context_dim=12, linear_proj=True, device="cpu",
                            quant=mode)
    attn = [m for m in st.modules() if type(m).__name__ == "CrossAttention"]
    projs = [p for a in attn for p in (a.to_q, a.to_k, a.to_v, a.to_out[0])] + [st.proj_in]
    want = pq.QuantLinear if pq.wants_dense_quant(mode) else torch.nn.Linear
    assert len(attn) == 2 and all(isinstance(p, want) for p in projs)
    assert not isinstance(st.proj_out, pq.QuantLinear)
    assert pq.QuantLinear(4, 8).state_dict().keys() == torch.nn.Linear(4, 8).state_dict().keys()
    with pytest.raises(ValueError):
        SpatialTransformer(16, 2, 8, device="cpu", quant="int4")


# --------------------------------------------------------------------------- #
# the networks
# --------------------------------------------------------------------------- #


def _unet_init():
    from dpm_solver_tpu.models.adm_unet import ADMConfig as JConfig
    from dpm_solver_tpu.models.adm_unet import ADMUNet as JUNet

    return JUNet(config=JConfig(**UNET)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)), jnp.ones((1,)),
        context=jnp.zeros((1, 7, 24)))


@pytest.fixture(scope="module")
def unet_weights():
    """tests/test_quant.py:236-262's UNet, inputs and perturbed weights."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.asarray([3.0, 500.0], np.float32)
    ctx = rng.standard_normal((2, 7, 24)).astype(np.float32)
    return _densify(_unet_init()), x, t, ctx


def _port_unet(params, quant):
    cfg = ADMConfig(**UNET, quant=quant)
    net = ADMUNet(cfg, device="cpu").eval()
    net.load_state_dict(adm_unet_state_dict_from_flax(params, cfg))
    return net


def test_state_dicts_do_not_depend_on_quant():
    sds = [ADMUNet(ADMConfig(**UNET, quant=q), device="cpu").state_dict()
           for q in pq.QUANT_MODES]
    vsds = [AutoencoderKL(VAEConfig.tiny(quant=q), device="cpu").state_dict()
            for q in pq.QUANT_MODES]
    for group in (sds, vsds):
        for sd in group[1:]:
            assert list(sd) == list(group[0])
            assert all(sd[k].shape == group[0][k].shape for k in sd)


@pytest.mark.parametrize("mode", ["w8a8", "w8a8_conv"])
def test_sd_unet_quant_forward_matches_jax(unet_weights, mode):
    from dpm_solver_tpu.models.adm_unet import ADMConfig as JConfig
    from dpm_solver_tpu.models.adm_unet import ADMUNet as JUNet

    params, x, t, ctx = unet_weights
    want = np.asarray(JUNet(config=JConfig(**UNET, quant=mode)).apply(
        params, jnp.asarray(x), jnp.asarray(t), context=jnp.asarray(ctx)))
    net_q, net_f = _port_unet(params, mode), _port_unet(params, None)
    args = torch.from_numpy(x), torch.from_numpy(t)
    with torch.no_grad():
        got = net_q(*args, context=torch.from_numpy(ctx))
        flt = net_f(*args, context=torch.from_numpy(ctx))
    assert torch.isfinite(got).all()
    _close(got.numpy(), want)
    assert _rel_rmse(got.numpy(), flt.numpy()) < RMSE
    # the transformer stack's products are int8: its float kernels stay idle
    # (on the CPU no wrapper counts; the modules say which path they take)
    blocks = [m for m in net_q.modules() if type(m).__name__ == "CrossAttention"]
    assert blocks and all(isinstance(m.to_q, pq.QuantLinear) for m in blocks)
    convs = [m for m in net_q.modules() if type(m).__name__ == "Conv3x3"]
    assert all(c.quant == mode for c in convs)
    assert set(launch_counts().values()) == {0}


def _record_jax_quant(monkeypatch):
    """Every JAX w8a8_conv / w8a8_matmul call's concrete inputs and output
    (run under jax.disable_jit)."""
    calls = []
    for name in ("w8a8_conv", "w8a8_matmul"):
        orig = getattr(jq, name)

        def rec(*a, _orig=orig, _name=name, **k):
            out = _orig(*a, **k)
            calls.append((_name, [None if v is None else np.asarray(v) for v in a], k,
                          np.asarray(out)))
            return out

        monkeypatch.setattr(jq, name, rec)
    return calls


def _replay_on_port(calls):
    """Each recorded JAX call through the port's function on the same inputs:
    equal bit for bit (the int32 sums and the fp32 rescale alike)."""
    for name, args, kw, out in calls:
        t = [None if a is None else torch.from_numpy(np.ascontiguousarray(a)) for a in args]
        if name == "w8a8_matmul":
            t[1] = t[1].T.contiguous()         # (K, N) -> the port's (N, K)
        got = getattr(pq, name)(*t, **({"out_dtype": torch.float32} if kw else {}))
        np.testing.assert_array_equal(got.float().numpy(), out.astype(np.float32))


def test_vae_decode_w8a8_conv_matches_jax(monkeypatch):
    """Every quantized conv of the JAX decode, replayed on the port with the
    JAX inputs, is bit-equal. End to end, the two decodes differ by the
    quantization flips that fp32 rounding differences upstream of each conv
    set off (a code one level over); they are held within the JAX package's
    own gap between its jitted and its op-by-op decode of the same input,
    which the same flips set (ROADMAP section 3)."""
    from dpm_solver_tpu.models.vae import AutoencoderKL as JVAE
    from dpm_solver_tpu.models.vae import VAEConfig as JVConfig

    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32) * 0.5
    params = _densify(JVAE(config=JVConfig.tiny()).init(jax.random.PRNGKey(0), jnp.asarray(x)),
                      scale=0.02)
    z = jnp.asarray(rng.standard_normal((2, 16, 16, 4)).astype(np.float32))
    jvae = JVAE(config=JVConfig.tiny(quant="w8a8_conv"))
    want = np.asarray(jax.jit(lambda p, v: jvae.apply(p, v, method="decode"))(params, z))
    calls = _record_jax_quant(monkeypatch)
    with jax.disable_jit():
        eager = np.asarray(jvae.apply(params, z, method="decode"))
    assert len(calls) == 13     # 6 res blocks x 2 convs + the upsample
    _replay_on_port(calls)

    sd = autoencoder_kl_state_dict_from_flax(params, VAEConfig.tiny())
    vae_q = AutoencoderKL(VAEConfig.tiny(quant="w8a8_conv"), device="cpu").eval()
    vae_f = AutoencoderKL(VAEConfig.tiny(), device="cpu").eval()
    vae_q.load_state_dict(sd)
    vae_f.load_state_dict(sd)
    with torch.no_grad():
        got = vae_q.decode(torch.from_numpy(np.asarray(z)))
        flt = vae_f.decode(torch.from_numpy(np.asarray(z)))
    jax_gap = np.abs(eager - want).max() / np.abs(want).max()
    _close(got.numpy(), want, max(FLIP, jax_gap))
    assert _rel_rmse(got.numpy(), flt.numpy()) < RMSE
    # conv_in / conv_out (the pixel boundary) stay on the float kernel
    assert vae_q.decoder.conv_in.quant is None and vae_q.decoder.conv_out.quant is None
    assert vae_q.decoder.mid.block_1.conv1.quant == "w8a8_conv"


def test_unet_quant_products_replay_bit_exactly(unet_weights, monkeypatch):
    """The tiny SD UNet's int8 products (q|k|v, the context's k and v,
    to_out, proj_in, GEGLU's two, the convs), recorded from an op-by-op JAX
    forward under "w8a8_conv" and replayed on the port: bit-equal."""
    from dpm_solver_tpu.models.adm_unet import ADMConfig as JConfig
    from dpm_solver_tpu.models.adm_unet import ADMUNet as JUNet

    params, x, t, ctx = unet_weights
    calls = _record_jax_quant(monkeypatch)
    with jax.disable_jit():
        JUNet(config=JConfig(**UNET, quant="w8a8_conv")).apply(
            params, jnp.asarray(x), jnp.asarray(t), context=jnp.asarray(ctx))
    kinds = {name for name, *_ in calls}
    assert kinds == {"w8a8_conv", "w8a8_matmul"} and len(calls) > 20
    _replay_on_port(calls)


def _sd_state_dict(params, vcfg, vscale, seed):
    from dpm_solver_tpu.models.vae import AutoencoderKL as JVAE
    from dpm_solver_tpu.models.vae import VAEConfig as JVConfig

    vparams = _densify(JVAE(config=JVConfig.tiny(**vcfg)).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3))), scale=vscale, seed=seed)
    sd = {f"model.diffusion_model.{k}": v.numpy() for k, v in
          adm_unet_state_dict_from_flax(params, ADMConfig(**UNET)).items()}
    sd.update({f"first_stage_model.{k}": v.numpy() for k, v in
               autoencoder_kl_state_dict_from_flax(vparams, VAEConfig.tiny(**vcfg)).items()})
    return sd


def _trajectories(sd, vcfg, mode, scale, x_T, *shifted):
    """The JAX latent trajectory from x_T and from each of `shifted`, and
    the port's from x_T: load_sd_checkpoint(quant=mode), 5 steps of
    DPM-Solver++ 2M, CFG at `scale`, on a conditional and an unconditional
    context drawn from a numpy seed (N(0, 1), as the constant encoder's;
    that encoder seeds from the per-process string hash)."""
    from dpm_solver_tpu.models.adm_unet import ADMConfig as JConfig
    from dpm_solver_tpu.models.text_encoder import constant_context_encoder as jenc
    from dpm_solver_tpu.models.vae import VAEConfig as JVConfig
    from dpm_solver_tpu.pipelines import StableDiffusionPipeline as JPipe
    from dpm_solver_tpu.pipelines import load_sd_checkpoint as jload
    from dpm_solver_tpu_torch.models import constant_context_encoder
    from dpm_solver_tpu_torch.pipelines import StableDiffusionPipeline, load_sd_checkpoint

    jpipe = JPipe(jload(sd, unet_config=JConfig(**UNET), vae_config=JVConfig.tiny(**vcfg),
                        text_encode=jenc(24), quant=mode))
    ldm = load_sd_checkpoint(sd, unet_config=ADMConfig(**UNET), vae_config=VAEConfig.tiny(**vcfg),
                             text_encode=constant_context_encoder(24), quant=mode, device="cpu")
    assert ldm.unet.config.quant == mode and ldm.vae.config.quant == mode
    pipe = StableDiffusionPipeline(ldm, device="cpu")
    cond, unc = np.random.default_rng(0).standard_normal((2, 2, 77, 24), np.float32)
    kw = dict(unconditional_guidance_scale=scale, return_intermediate=False)
    want, *shifts = (np.asarray(jpipe.sampler.sample(5, 2, (8, 8, 4), jnp.asarray(cond),
                                                     x_T=jnp.asarray(x),
                                                     unconditional_conditioning=jnp.asarray(unc),
                                                     **kw)[0])
                     for x in (x_T, *shifted))
    with torch.no_grad():
        got = pipe.sampler.sample(5, 2, (8, 8, 4), torch.from_numpy(cond),
                                  x_T=torch.from_numpy(x_T),
                                  unconditional_conditioning=torch.from_numpy(unc), **kw)[0]
    return want, shifts, got.numpy(), pipe


@pytest.mark.parametrize("mode", ["w8a8", "w8a8_conv"])
def test_load_sd_checkpoint_quant_trajectory_matches_jax(mode):
    """A tiny latent trajectory through `load_sd_checkpoint(quant=)` in both
    packages, from one CompVis-layout state dict, on explicit noise, without
    CFG, at the weights and context scale of the JAX package's quant sampler
    test (tests/test_quant.py:203-214, where 5e-3 is the flip scale): within
    5e-3 of max|x|."""
    sd = _sd_state_dict(_densify(_unet_init(), scale=0.02), dict(resolution=16,
                                                                   attn_resolutions=()), 0.02, 3)
    x_T = np.random.default_rng(9).standard_normal((2, 8, 8, 4)).astype(np.float32)
    want, _, got, pipe = _trajectories(sd, dict(resolution=16, attn_resolutions=()), mode, 1.0,
                                       x_T)
    _close(got, want)
    img = pipe.txt2img(["a red cube", "a teapot"], x_T=torch.from_numpy(x_T), steps=5,
                       guidance_scale=7.5, height=16, width=16)
    assert img.shape == (2, 16, 16, 3) and torch.isfinite(img).all()


# JAX's own trajectory move (of max|x|) when x_T moves by one ulp, the
# largest over x_T = normal(PRNGKey(0-3)), contexts from seeds 0-1, up and
# down: 0.0606 and 0.1120 measured. Over the same 8 inputs the port's gap
# to JAX was 0.83-1.46x (w8a8) and 0.81-1.54x (w8a8_conv) JAX's move up.
SENSITIVITY_CAP = {"w8a8": 0.061, "w8a8_conv": 0.113}


@pytest.mark.parametrize("mode", ["w8a8", "w8a8_conv"])
def test_quant_cfg_trajectory_within_jax_rounding_sensitivity(unet_weights, mode):
    """At CFG 7.5 the int8 trajectory is as sensitive to rounding as it is
    to the implementation: JAX's own trajectory moves by 3.5-11% of max|x|
    when x_T moves by one ulp (quantization flips, amplified by the guidance
    and the steps; ROADMAP section 3). That move must stay within
    SENSITIVITY_CAP, and the port's gap to JAX within twice it; the float
    trajectory of the same weights within 1e-4
    (tests/test_solver_parity.py:70-75). The bit-exact replays of every JAX
    int8 product above are the guard of the arithmetic; this test bounds
    what the flips do end to end."""
    vcfg = dict(resolution=16, attn_resolutions=())
    sd = _sd_state_dict(unet_weights[0], vcfg, 0.02, 3)
    x_T = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (2, 8, 8, 4)))
    want, _, got, _ = _trajectories(sd, vcfg, None, 7.5, x_T)
    _close(got, want, 1e-4)
    shifted = np.nextafter(x_T, np.float32(np.inf)).astype(np.float32)
    want, (shift,), got, _ = _trajectories(sd, vcfg, mode, 7.5, x_T, shifted)
    sensitivity = np.abs(shift - want).max() / np.abs(want).max()
    assert sensitivity <= SENSITIVITY_CAP[mode], sensitivity
    _close(got, want, 2.0 * sensitivity)
    with pytest.raises(ValueError):
        from dpm_solver_tpu_torch.pipelines import load_sd_checkpoint

        load_sd_checkpoint(sd, unet_config=ADMConfig(**UNET), vae_config=VAEConfig.tiny(**vcfg),
                           quant="int4", device="cpu")
