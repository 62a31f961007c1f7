#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU, and check them.

    python3 chip_smoke.py

Run from the root of a checkout. It needs one CUDA device, nvcc and triton,
and nothing of JAX. Phases, each fatal on failure:

1. environment: torch and CUDA versions, the card's name and power limit;
   exits non-zero at once when `torch.cuda.is_available()` is false;
2. build: nvcc compiles `dpm_solver_tpu_torch/csrc/*.cu` for sm_90a into the
   ignored `dpm_solver_tpu_torch/_build/`, one nvcc per source in parallel,
   with `-Xptxas -v`; each instance of the attention backward's kernels
   and of the fp32 conv3x3 (forward and dx modes, its split sum) and fp32
   attention forward is logged with its registers and spilled bytes;
3. kernels: each hand-written kernel against its plain PyTorch version on the
   card, at the paths' shapes and at tiny and ragged ones, fp32 and bf16
   (every fp32 conv3x3, its dx and the attention forward with its lse
   launched twice on the same inputs: the two results bitwise equal, the
   determinism path E's RK45 needs): the forwards, and the attention
   forward's lse, the attention backward's
   dq and dk/dv (at dh 64, and at every other head dim in both dtypes: dh
   256 at 16x16, SD-1's 40/80/160, 32, 128, 512 at T = S = 1024 and ragged
   on qkv slices; at each, the forward's o and lse are checked first on the
   same inputs); the forward and its lse at the wide presets' head dims
   (cin256's 384, 576 and 960 at CFG b8 with S = 1, 96 and 192, ragged and
   on qkv slices), each launch on its route; the backward (dq and dk/dv) at
   those head dims too, both dtypes, at the training paths' b8 sites, with
   one key (S = 1: dq and dk held to an absolute bound, S1_BOUND * max|dO|
   * max|v|, being rounding noise on both sides) and ragged, each launch on
   its route; LayerNorm->Linear and GEGLU at cin256's widths too
   and conv3x3's input gradient; the bf16 "narrow" conv route (forward and
   dx) at the SD VAE's conv_in and conv_out, at C in {1, 3, 4, 5, 12} x CO in
   {3, 4, 6, 20, 512} on a 7x9 map and at C = CO = 64 off a 16-byte
   boundary, each launch on "narrow"; the fused update at paths A-D's
   sizes; and the two kernels no path
   launches (as in the JAX package): bias + LeakyReLU forward and backward
   at path D's activation shapes and ragged ones, and attention with its
   out-projection and residual fused (its plan's tile and cluster logged)
   at SD-2.1's four self-attention sites (CFG b8, H*dh up to 1280), SD-1's
   four (CFG b2, dh 40/80/160) with a cross-attention case at each of those
   head dims, single heads of dh 256 and 512, and ragged ones, with its
   gradient through the autograd Function at dh 40 against the plain
   version's autograd;
   and SD-1's attention sites at 512 px, CFG b2 (head dims 40, 80, 160:
   self-attention at T = 4096, 1024, 256, 64, cross-attention at S = 77,
   ragged and fused-qkv cases, output and lse); LayerNorm->Linear and GEGLU
   at every SD-2.1 and SD-1 transformer site, at row counts off the row
   tiles, and at tiny and ragged widths, each on its plan's route ("wgmma"
   for bf16 but at d % 8 != 0, "wmma" there, "f32" for fp32) and the bf16
   "wgmma" shapes on the fused WMMA kernels ("wmma") too; their gradients through the
   autograd Functions against autograd of the plain twins at two SD sites,
   bf16 and fp32; then one full-width SD-1
   UNet forward (`ADMConfig.sd_v1()`, bf16, 64x64 latents, b2, the hermetic
   `constant_context_encoder(768)`): finite, with the launch counters rising
   by exactly what `layout()` implies;
4. path A, CIFAR-10: the DDPM UNet at full width with seeded random weights
   in bf16, sampled at batch 64 by DPM-Solver++ 3M for 10 NFE on the logSNR
   grid of the discrete schedule, through `NoiseScheduleVP`, `model_wrapper`
   and `DPM_Solver.sample(jit=False)`; the launch counters must rise by
   exactly the expected counts. Then `jit=True`, the trajectory captured
   as one CUDA graph: the first call (a warm eager call, then the capture)
   counts the expected launches twice and makes one capture, a repeat call
   replays with no launch counted and no capture. Then batch 4 in fp32: the
   eager call on the card against the plain path on the CPU, and the
   replayed call against the eager one on the card (within 1e-6 of max|x|),
   also on a second x, with its intermediates, and an SDE solver's on two
   (x, noise) pairs;
5. path B, Stable Diffusion 2.1 txt2img: `ADMConfig.sd_v2_1()` (865.9M
   parameters) and `VAEConfig.sd_v1()` at full width with seeded random
   weights in bf16, the hermetic `constant_context_encoder(1024)`, and
   `StableDiffusionPipeline.txt2img` for 4 prompts at 768x768 (96x96
   latents), 20 NFE of DPM-Solver++ 2M on the time-uniform grid, CFG 7.5,
   v-prediction; the images must be (4, 768, 768, 3), finite, in [0, 1], and
   the launch counters must rise by exactly what `layout()` and the VAE
   config imply (`jit=False`); then the same call graphed (`jit=True`: the
   sampler's trajectory replayed, the VAE decode eager): the first call
   counts the sampler's launches twice (warm call, capture) and the decode's
   once, a repeat call only the decode's, with no new capture; then the
   same networks in fp32 at 16x16 latents, batch 1, CFG, 3 NFE, on the card
   against the plain path on the CPU, and the replayed sampler against the
   eager one on the card, again with a new x_T and another prompt's context
   (no new capture: the conditioning is copied into the graph's inputs);
5b. path G, SD-2.1 img2img and inpaint: path B's networks, b4 at 768 px,
   CFG 7.5: img2img at strength 0.75 (15 of 20 steps) and inpaint (20
   steps, one seeded rectangle a mask), each encoding its images with the
   VAE encoder (its first run on the card; conv_in 3 -> 128 on "narrow");
   launch counts and routes as path B's plus the encode's; inpaint keeps
   its masked-out pixels; both graphed (`jit=True`) as path B. Then fp32 at
   128 px, b1: both card vs CPU within 1e-4 of max|x|, and a second inpaint
   call with another image, mask and noise replays the first's graph within
   1e-6 of its own eager call (the sampler's held blend table). Then
   DiffEdit at SD-2.1 width, 512 px, b1, encode ratio 0.5, bf16: finite,
   and graphed (captured once, replayed) equal to eager within 1e-6;
5c. path F, class-conditional cin256: `load_sd_checkpoint(...,
   preset="cin256")` on a CompVis-style state dict synthesised on the host
   with seeded random weights (`ADMConfig.cin256()`, 400.9M parameters; the
   VQ-f4 first stage `VAEConfig.vq_cin256()` with 8192 codes, 55.3M),
   `ClassEmbedder(1001, 512)`, `class_conditional_sample` b8, CFG 3.0
   against class 1000, 20 NFE, bf16, 256 px: launch counts and routes from
   the configs, the attentions recorded by head dim (384, 576, 960, each
   self- and S = 1 cross-attention), graphed as path B; fp32 at 32x32
   latents, b2, 3 NFE, card vs CPU: latents within 1e-4 of max|x|, the VQ
   indices each side picks (flips counted), the decoder on the CPU's
   indices within 1e-4;
5d. the conditioners and upscale, fp32, card vs CPU within 1e-4 of max|x|:
   `FrozenCLIPEmbedder` at ViT-L/14's text width (12 layers, 768 wide,
   vocab 49,408, 77 tokens) from an HF-format directory written to a
   temporary path (synthetic vocab, seeded random weights); `BERTEmbedder`
   at LDM txt2img-f8's width (1280, 32 layers; its 32 attentions on the
   fp32 kernel); `ClassEmbedder` (equal); `upscale` on a small
   concat-conditioned LDM (64 channels, KL-f4), 32 -> 128 px;
6. path C, classifier-guided ImageNet-256 (benchmarks/guided_bench.py's
   call): `ADMConfig.imagenet256_guided()` (553.8M parameters, learned
   sigma, the model takes out[..., :3]) and its 54.1M-parameter
   attention-pool classifier at full width with seeded random weights in
   bf16, the classifier frozen; batch 8 at 256x256, labels from
   default_rng(1), `model_wrapper(guidance_type="classifier")` at scale 8,
   DPM-Solver++ 2M for 20 NFE on the time-uniform grid with
   `make_dynamic_thresholding(0.995, 1.0)`, through `build_sampler`; every
   NFE differentiates the classifier, so its backward runs the dq, dk/dv and
   conv3x3-dx kernels (dq and dk/dv are also checked at the classifier's
   own attention sites, recorded from the call, in phase 8). The samples
   must be finite (8, 256, 256, 3) fp32 and
   the launch counters must rise by exactly what `layout()` implies; then the
   same networks in fp32 at 64x64, batch 1, 3 NFE, on the card against the
   plain path on the CPU;
7. path D, ScoreSDE continuous VP (benchmarks/score_sde_bench.py's call,
   BASELINE config[1]): `NCSNppConfig.cifar10_ddpmpp(deep=True)` at full
   width with seeded random weights in bf16, `NoiseScheduleVP.linear()`,
   labels t*999 through `score.get_noise_fn`, batch 256, singlestep order 3,
   10 NFE, logSNR, t_end 1e-3, through `build_sampler`; the samples must be
   finite and the launch counters must rise by exactly what the config and
   the plan's rows imply; then the same sampler through `GraphedSampler`
   (the counterpart of JAX's `jit_hoisting_constants`), counted as path A's.
   Then the adaptive solver (order 3) at full width,
   batch 16, its NFE printed; the deep net in fp32 at batch 2, 3 NFE, on the
   card against the plain path on the CPU and graphed against eager on the
   card (as path A); and the adaptive solver on a tiny
   FIR VP NCSN++ in fp32, card against CPU: the same NFE and within 5e-3;
7b. path E, ScoreSDE bits/dim: `likelihood.get_likelihood_fn` on path D's
   DDPM++ deep at full width in fp32 (the dtype score_sde reports bits/dim
   in), frozen, continuous VP, labels t*999, batch LIK_BATCH of seeded
   8-bit images uniformly dequantised to [-1, 1], a Rademacher probe. First
   each conv3x3 and its dx, and the attention's lse form (o and lse), its
   form without the lse and its dq and dk/dv, at every spec of the path's
   network forward, in fp32 against the plain versions (the forwards and
   dx launched twice, bitwise equal). Then the likelihood call, RK45
   at rtol = atol = LIK_TOL (the JAX default 1e-5 loosened for time, PERF.md
   section 4) and eps LIK_EPS (the JAX default). Every stage
   differentiates the network once (one vector-Jacobian product), so its
   backward runs the attention dq and dk/dv kernels at dh 256 and the
   conv3x3 dx: the launch counters must rise by exactly the config's counts
   per stage times the call's NFE, and no conv3x3 weight gradient may run
   (`torch.nn.grad.conv2d_weight` counted by a wrapper here). Then one
   stage of the same network at b2, card against CPU within 1e-4 of each
   value's max: the network's vector-Jacobian product with the probe, the
   probability-flow drift and its divergence estimate. Then the tiny
   FIR VP NCSN++ (unconditional: random weights on the t*999 embedding make
   RK45 take thousands of NFE) in fp32, card against CPU, bits/dim and the
   black-box `ode_sampler` (with its denoising step): the same NFE, bits/dim
   within 1e-3, z and the samples within 5e-3 of their max;
7c. path H, score-model training: `run_lib.train` on
   `score_sde_cifar10_ve_ncsnpp_continuous` (benchmarks/train_bench.py's
   configuration: NCSN++ continuous VE, b128 of synthetic 32x32 8-bit
   images from TRAIN_SEED, bf16 compute, dropout 0.1 live, Adam after the
   config's warmup, clipping, EMA) for H_STEPS steps: launches (and by
   route) against the config's counts per step (each conv3x3 with its dx,
   each attention with its lse, dq and dk/dv at dh 256), every step's loss
   and grad norm finite, the median step after a warm one, images/s and
   peak memory (cuDNN's default algorithm choice, as a user's run); then,
   under cuDNN's deterministic algorithms, a run killed after H_RESUME_AT
   steps and restarted from its meta checkpoint ends within SLICE_BOUND of
   an uninterrupted H_RESTART_STEPS-step run; `cifar10_ddpm` through the
   DDPM eps-MSE branch (continuous off) for H_DDPM_STEPS steps, counted and
   timed the same way; then one fp32 step at reduced width (a small NCSN++
   VE, the continuous VE loss; a small DDPM UNet, the eps-MSE), card
   against CPU through the step functions themselves, from the same random
   weights (every layer live) and draws: the step's loss and grad norm,
   Adam's first moment after the step (the clipped gradient times 1 - b1)
   leaf by leaf, and the parameters after the step (in units of the
   learning rate);
7d. path I, latent-diffusion training: `run_lib.train_latent` on "sd_v2_1"
   (b4 at 768 px through the frozen KL-VAE encode, v target, a random 77 x
   1024 context, Adam), the same with adafactor and remat, and on "cin256"
   (b8 at 256 px through the VQ-f4 encode, one class token a sample: the
   backward at dh 384, 576 and 960 and at S = 1), each counted, timed and
   checked as path H; one fp32 `make_latent_train_step` at reduced width
   (v target, CFG dropout, a small KL-VAE's encode), card against CPU as
   path H's; a
   restarted small `train_latent` run against an uninterrupted one;
7e. paths J-N, the rest of the sampling surface, at full width with seeded
   random weights, steps cut (`sampling_surface`; each run's launches and
   routes against its configuration and NFE, its wall logged): J,
   `samplers.get_pc_sampler` on `score_sde_cifar10_ve_ncsnpp_continuous`
   (reverse diffusion + Langevin at snr 0.16, the config's fields; b64,
   bf16, N cut from 1,000 to J_STEPS; NFE 2N); J', annealed Langevin on
   `score_sde_cifar10_ve_ncsnv2` (NCSNv2 cifar10, fp32 on F.conv2d: no
   kernel launches; J2_SCALES of the 232-scale ladder, 5 steps each, b64),
   then J2_TRAIN_STEPS steps of `run_lib.train` on that config (finite
   losses); K, `controllable` inpaint (one seeded rectangle a mask: the
   known pixels kept), colorize (the luma kept, within 1e-5 of max|x|: it
   is read back through the fp32 basis change) and the class-conditional
   sampler (the WRN-28-10 gradient by autograd at every NFE) on J's
   network, b16, N cut to K_STEPS; L, DDIM (eta 0 and 1) and PLMS at
   L_STEPS and ancestral DDPM cut to L_DDPM_STEPS on path A's DDPM UNet,
   b64, bf16 (launches exact per NFE; PLMS one NFE more); M,
   `CascadePipeline` 64 -> 256 (base `ADMConfig.imagenet64_iddpm()`,
   DPM-Solver++ 2M; the upsampler from guided-diffusion's
   64_256_upsampler.pt flags, 4 heads, SDE-DPM-Solver++ 2M at aug_level M_AUG;
   M_STEPS each, b4, graphed: the first call counts each stage twice and
   captures twice, a repeat call replays); N, `knn2img` on
   `load_sd_checkpoint(preset="rdm_768")` (a state dict synthesised on the
   card) with `FrozenCLIPTextJointEmbedder` at ViT-L/14's text width and a
   `Searcher` over a seeded N_DB x 768 fp32 database on the card (4
   prompts, k N_K, 768 px, CFG N_SCALE, N_STEPS steps, graphed): the top-k
   indices against a float64 NumPy top-k on the host wherever the scores
   are more than 1e-5 apart, the search's time logged. Then each path in
   fp32 at small width, batch and steps, the same explicit noise on both
   sides, card against CPU within SLICE_BOUND of max|x| (K's classifier
   gradient: WRN-28-1 in fp32 and WRN-28-10 in float64; N's neighbours
   equal). Forward pre-hooks on the networks' modules record the spec of
   every conv3x3, attention, LayerNorm->Linear and GEGLU launch of the
   counted runs (`record_kernel_specs`; they must account for every
   launch), and each kernel is then held against its plain version at
   each of those specs in bf16, the paths' dtype, within the phase-3
   bounds; the fused update at M's and N's solver states, both dtypes;
7f. paths O and P (`first_stage_and_eval`), first-stage training and
   evaluation, at full width with seeded random weights, steps and rounds
   cut; run inside phase 8, after its wall timings, once the earlier
   paths' networks and CUDA graphs are freed (O's KL step takes 62 GiB): O, `run_lib.train_autoencoder(kind="kl")` on KL-f8 (`VAEConfig.sd_v1()`,
   256 px, fp32, `KLLossConfig()`: the adversarial term and the adaptive
   weight from step 0, a random-init LPIPS, `NLayerDiscriminator(64, 3)`
   with BatchNorm), b O_KL_BATCH, a warm step and O_KL_STEPS timed (ms a
   step, images/s, peak GiB); launches against the config's counts
   (conv3x3 and its dx at the VAE's 256 px sites, the mid attention's lse,
   dq and dk/dv at fp32 dh 512, T = S = 1,024), all on "f32"; a run killed
   after its meta checkpoint and restarted, bitwise equal to an
   uninterrupted one (cuDNN's deterministic algorithms); `kind="vq"` on
   VQ-f4 (`vq_cin256`, 8,192 codes, T = S = 4,096 in the middle), b
   O_VQ_BATCH; then one KL and one VQ step (b2, full width at O_CHECK_SIZE
   px) card against CPU: parameters and logvar, BatchNorm statistics,
   Adam's mu and sqrt(nu), each group within SLICE_BOUND of its largest,
   and the logs. P, `run_lib.train` on cifar10_ddpm writes checkpoints 1
   and 2, then `run_lib.evaluate` over both, P_ROUNDS rounds each at the
   config's eval batch: DPM-Solver++ 3M 10 NFE graphed on the EMA
   parameters (bf16), `FIDInceptionV3` at 299 px from
   `random_feature_params`, the eps-MSE loss, FID against the statistics
   of seeded images (seconds a round, sampling and features apart); a run
   stopped by its hook after checkpoint 2's first round resumes to the
   same IS and FID; Inception's features card against CPU (b4, fp32).
   A global forward pre-hook records every launch's spec
   (`record_training_specs`, which must account for all); each spec is
   then checked against its plain version in its run's dtype;
7g. path Q (`data_path`), the data path from disk, host work beside the
   card's name and the host's nproc: first a probe of the host (g++, the
   PNG, JPEG and zlib headers and libraries, PIL, cv2, tensorflow, the CPU
   count); the host-IO libraries built by g++; (a) CIFAR-10's pickles at
   full size read by `load_cifar10_dir`, `make_dataset` alone (images/s),
   then `run_lib.train` on cifar10_ddpm b128 bf16 fed by it and on random
   tensors (each counted by route against the DDPM UNet's launches, a warm
   step and Q_STEPS - 1 timed); (b) FFHQ-layout 256 px TFRecords: the
   CRC32C known answer, the C++ index against the Python one, both
   TFRecord readers with shuffle, flips and dequantization, the first
   batch equal to a numpy decode to the bit (images/s); (c) a folder of
   PNGs of 256-512 px through `image_folder_dataset` (generic and
   `lsun_scoresde`); (d) an LMDB of 256 px PNGs through `lsun_dataset`; (e)
   path P's first round as a PNG folder through `compute_statistics_of_path`
   on the card's Inception, its mu and sigma within 1e-6 of their max of the
   npz route's; all in a temporary directory, removed after;
7h. path R, the CLI (`dpm_solver_tpu_torch.cli.main`, what `python -m
   dpm_solver_tpu_torch.cli` runs) on files it writes to a temporary
   directory (a CompVis sd_v1 checkpoint of seeded random weights, a joint
   CLIP directory at ViT-L/14's text width, a safety checkpoint): `txt2img`
   at 512 px, b4, 25 NFE, CFG 7.5, graphed, with the watermark and the
   safety screen, in bf16 float, `--quant w8a8` and `--quant w8a8_conv`,
   each call's launches and routes checked (under quant, no `ln_linear` or
   `geglu_ff` launch), its load, call and sampler walls and the same
   pipeline's replayed second call timed, `wmdecode` reading
   "StableDiffusionV1" back from a written PNG, the quant images' relative
   RMSE against float's; `img2img` and `inpaint` on the checkpoint; `fid`
   over two output folders; `configs`; `sample --config cifar10_ddpm
   --trace-dir` with the trace's 10 largest device ops; every int8 product
   of one SD-1 UNet forward and decode under "w8a8_conv", card against CPU
   on the same codes bit for bit, timed beside bf16 and the bound, and each
   quantized call beside its float twin (the calls recorded must number the
   int8 sites of the UNet and the decoder); the small-width int8 trajectory
   card against CPU; then the float call's kernel specs held to plain;
7i. path S, parallelism (`dpm_solver_tpu_torch.parallel`): S0 in this
   process over a world of one NCCL rank (`make_mesh()`), path A through
   `DPM_Solver.sample(mesh=)` at b64 bf16 graphed, bitwise equal to the
   unsharded graphed call; then one spawn of two ranks on cuda:0 over gloo
   (`parallel.launch.run_ranks`; gloo on the card is the test transport the
   script names, NCCL refusing two ranks on one card): S1 path A sharded at
   b64 (32 rows a rank, one capture a rank, a repeat call replaying with no
   launch counted, each rank's rows bitwise its unsharded rows, the whole
   within S_TRAJ_BOUND of the unsharded b64 call) and fp32 b4 within 1e-4;
   S3 the data-parallel `cifar10_ddpm` step at full width, fp32, dropout 0,
   b128 (64 a rank): the loss within 1e-5 relative and the averaged
   gradients within 1e-4 of max of the single-process step's, three steps
   and the gradient all-reduce timed; S4 ZeRO-1: each rank's optimizer-state
   bytes against the unsharded state's, the parameters after a step on the
   same gradients within 1e-6 of the unsharded Adam's, and a sharded step
   run; S2 SD-1 `txt2img(mesh=)` at 512 px b4, CFG 7.5, 20 NFE, graphed,
   bf16, within S_TRAJ_BOUND, and fp32 at 16x16 latents b2 (2 NFE) within
   1e-4; S5 tensor parallelism over a (1, 2) mesh: the SD-1 and SD-2.1
   (heads 3 + 2) UNet forwards at full width in bf16 within S_BF16_BOUND,
   their launches as `layout()` implies, a graphed TP SD-1 trajectory of
   S_TP_STEPS NFE at 512 px b2 (its gloo all-reduces host steps between graph
   segments) within S_TRAJ_BOUND, an SD-1 TP train step in fp32 at 16x16
   latents b2 with its gradients within 1e-4 of max of the unsharded step's;
   S6 the multihost helpers; the unsharded references run on rank 0 alone.
   S0 also captures an NCCL all-reduce in a CUDA graph: one segment, whose
   replay reduces the new input. The score_sde demo runs on the card at its
   tiny default, started after the build and waited for here (it overlaps
   phases 3-7b, which time nothing). Then `cli sample --devices 2` must
   refuse the one card, naming both counts, and each kernel is held to
   plain at the specs the ranks recorded (and conv3x3_dx at S3-S5's
   train-step specs, the attention backward, LayerNorm->Linear's and
   GEGLU's gradients at the TP train step's local shapes, the fused update
   at the per-rank states);
8. timing: each path's median wall time (A, B, D, F and G both eager and
   replayed from their CUDA graphs, in this one call), the SD call's UNet and VAE-decode
   shares, the guided call's UNet-forward and classifier forward+backward
   shares, the ScoreSDE call's network-forward share, the bits/dim call's
   wall (the counted call's, and the median with LIK_TIMED_RUNS more), NFE, ms per NFE
   and its network forward and backward shares, and each kernel
   against its plain version, the one PyTorch call that computes the same
   function (where there is one; for LayerNorm->Linear and GEGLU, which no
   one call computes, the bf16 composition of library calls, labelled
   "composition", and their "wmma" route, the fused WMMA kernels) and its bound, at
   the shapes and launch counts of one call of each path and of the SD-1
   forward (the kernels no
   path launches: one launch at each shape where they would run; the fused
   attention output at every SD site it is checked at, beside the port's
   unfused composition and the library composition, SDPA then
   `torch.addmm`), each beside the card's
   name and power limit, with the tensor-core rate and the bound's share;
   path E's kernels in fp32 (their bound counts fp32 operations at the CUDA
   cores' peak); and the dq and dk/dv kernels at each head dim and dtype,
   one launch at each site, beside the plain twin, SDPA's backward and the
   bound; the "narrow" conv route alone at its path-B launches (the VAE's
   conv_in and conv_out) beside the plain conv, cuDNN and the bound; and the
   fused update at A-D's sizes both back to back and device alone (the
   path's launches captured in one CUDA graph); path G's img2img call's
   kernels (the VAE encoder's included, and the "narrow" route at its
   three launches) and path F's call's, recorded from the calls, with the
   attention at F's sites by spec; the attention kernels (lse, dq, dk/dv)
   of path H's run and of path I's cin256 run, the latter by site; the dq
   and dk/dv kernels at WIDE_BWD's sites too; path O's fp32 kernels at the KL
   run's launches, the VQ run's attention (dh 512, T = 4,096), and path
   P's bf16 sampler at the eval batch.

Paths H and I print their steps' walls, images/s, peak memory, losses and
grad norms, the card-vs-CPU step checks and the restart checks as one JSON
line (`{"training": ...}`) before the kernels' record; paths J-N their
walls (seconds) under "walls_j_to_n_s" of the `{"walls": ...}` line; paths
O and P theirs and their checks as `{"first_stage_and_eval": ...}`; path Q
its walls, rates, probe and checks as `{"data_path_q": ...}`; path R its
walls, checks and int8 products as `{"cli_path_r": ...}`; path S its
walls, each rank's checks, times, launches and optimizer-state bytes as
`{"parallel_path_s": ...}`.

After each path's call the redesigned kernels' launches are also checked by
route (`ops.launch_routes()`): every bf16 attention (forward, lse, dq and
dk/dv), LayerNorm->Linear and GEGLU on "wgmma", every bf16 conv with C % 8
== CO % 8 == 0 on "wgmma", the others (the SD VAE's conv_in and conv_out)
on "narrow"; path E's fp32 ones on "f32". A GEGLU call counts one
launch of `geglu_ff`, whichever of its route's kernels it runs (on "wgmma"
the gate and the down-projection, and at a split reduction the sum of the
partials), so `adm_unet_launches` counts one per feed-forward.

The last two lines are the kernels' JSON record (each kernel's times on the
newest path that runs it at the top level, or under "none" for a kernel no
path launches, every path's and the SD-1 forward's in `timing_by_path`, its
launches on every path; the attention kernels' head dims by dtype, and the
backward's times by head dim under `by_head_dim`)
and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import io
import json
import logging
import re
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from itertools import chain
from pathlib import Path
from typing import Callable, NamedTuple, Optional

ROOT = Path(__file__).resolve().parent
BATCH, STEPS, ORDER = 64, 10, 3                    # path A
SD_PROMPTS = ["a photograph of an astronaut riding a horse", "a red teapot on a table",
              "a lighthouse at dusk, oil painting", "a bowl of ramen, studio light"]
SD_SIZE, SD_STEPS, SD_SCALE = 768, 20, 7.5          # path B
SD_TIMED_RUNS = 3
GUIDED_BATCH, GUIDED_SIZE, GUIDED_STEPS, GUIDED_SCALE = 8, 256, 20, 8.0   # path C
GUIDED_TIMED_RUNS = 3
SCORE_BATCH, SCORE_STEPS, SCORE_T_END = 256, 10, 1e-3                     # path D
I2I_STRENGTH = 0.75                                 # path G: img2img, 15 of 20 steps
CIN_LABELS, CIN_STEPS, CIN_SCALE, CIN_UNCOND = 8, 20, 3.0, 1000           # path F
CIN_CLASSES, CIN_CONTEXT, CIN_CODES = 1001, 512, 8192
CIN_TIMED_RUNS = 3
DIFFEDIT_SIZE, DIFFEDIT_RATIO = 512, 0.5            # DiffEdit at SD-2.1 width, b1
# the attention forward (and its lse) at the head dims the wide presets give:
# cin256's single heads of 384 (32x32), 576 (16x16) and 960 (8x8) at CFG b8,
# self-attention and the S = 1 cross-attention to the class token, fused qkv
# slices, ragged lengths; the ADM ImageNet-64 and -128 presets' 96 and 192
WIDE_ATTENTION = [(16, 1024, 1024, 1, 384, False), (16, 1024, 1, 1, 384, False),
                  (16, 256, 256, 1, 576, False), (16, 256, 1, 1, 576, False),
                  (16, 64, 64, 1, 960, False), (16, 64, 1, 1, 960, False),
                  (16, 1024, 1024, 1, 384, True), (16, 64, 64, 1, 960, True),
                  (2, 100, 37, 1, 960, False), (3, 77, 200, 1, 384, False),
                  (2, 65, 9, 2, 576, False), (1, 17, 300, 1, 960, False),
                  (4, 256, 256, 4, 96, False), (4, 1024, 77, 4, 96, False),
                  (4, 256, 256, 4, 192, True)]
SCORE_ADAPTIVE_BATCH, SCORE_TIMED_RUNS = 16, 5
# path E: the JAX defaults are rtol = atol = eps = 1e-5; the tolerance is
# loosened to 1e-2 to keep the phase near its time budget (PERF.md section 4:
# the call is host-bound, so a smaller batch would not be faster; 1e-4 until
# path R came, whose ~120 s took the script to 1,154 s of its 1,200; 1e-3
# until path S came, with which it took 1,057.8 and 1,213.2 s)
# E is timed on its counted call, with no second call (one until path Q
# came, three until paths F and G: the script's time limit; PERF.md
# section 4)
LIK_BATCH, LIK_TOL, LIK_EPS, LIK_TIMED_RUNS = 8, 1e-2, 1e-5, 0
# the adaptive solver's bound, card against CPU: each side accepts its steps
# on its own fp32 error estimate (tests/test_solver_parity.py:286)
ADAPTIVE_BOUND = 5e-3
# bits/dim, card against CPU, absolute (tests/test_torch_likelihood.py)
BPD_BOUND = 1e-3
# bounds on max|kernel - plain| / max|plain| (plain in fp32 on the same inputs,
# TF32 off): fp32 -> different summation order only; bf16 -> the kernel's one
# rounding of its output to bf16 (unit roundoff 2^-8 = 3.9e-3) plus order
BOUND = {"float32": 1e-5, "bfloat16": 1e-2}
FUSED_BOUND = {"float32": 1e-6, "bfloat16": 1e-2}
# the attention backward at the head dims past 64, relative to max|plain|:
# tests/test_torch_attention_bwd.py's bounds (:29-30)
BWD_BOUND = {"float32": 2e-5, "bfloat16": 0.05}
# (b, t, s, heads, dh, q/k/v as column slices of one projection): dh 256 at
# 16x16 (NCSN++/DDPM's single head; path E's b8, its qkv slices), SD-1's
# sites at 512 px CFG b2 (dh 40/80/160, self- and cross-attention), dh 32
# and 128 at one site each, dh 512 at T = S = 1024 (the VAE's mid-block at
# 256 px), and ragged T, S (S >= 2: ROADMAP's S = 1 note; T % 64 != 0
# marks a ragged check shape, not timed), all in fp32 and bf16
BWD_SHAPES = [(8, 256, 256, 1, 256, True), (8, 256, 256, 1, 256, False),
              (1, 77, 50, 2, 256, False), (2, 4096, 4096, 8, 40, False),
              (2, 4096, 77, 8, 40, False), (2, 1024, 1024, 8, 80, False),
              (2, 1024, 77, 8, 80, False), (2, 256, 256, 8, 160, False),
              (2, 256, 77, 8, 160, False), (2, 64, 64, 8, 160, False),
              (3, 333, 117, 2, 40, False), (3, 333, 333, 2, 80, True),
              (3, 333, 237, 2, 160, False), (2, 64, 64, 8, 32, False),
              (3, 33, 129, 4, 128, False), (2, 256, 256, 4, 128, False),
              (1, 1024, 1024, 1, 512, False),
              (1, 77, 77, 1, 512, True)]
# the backward at the head dims the forward took for the wide presets (the
# training paths' cin256 heads at b8: self-attention on qkv slices and the
# one-key cross-attention; the ADM ImageNet-64/-128 heads 96 and 192) and
# ragged ones, both dtypes; with one key (S = 1) ds is 0 up to rounding, so
# dq and dk are held to S1_BOUND * max|dO| * max|v| absolute
# (tests/test_torch_attention_bwd_wide.py), dv to BWD_BOUND
WIDE_BWD = [(8, 1024, 1024, 1, 384, True), (8, 1024, 1, 1, 384, False),
            (8, 256, 256, 1, 576, True), (8, 256, 1, 1, 576, False),
            (8, 64, 64, 1, 960, True), (8, 64, 1, 1, 960, False),
            (8, 256, 256, 4, 96, False), (8, 256, 256, 4, 192, False),
            (8, 64, 77, 4, 192, False), (3, 100, 70, 1, 960, False),
            (2, 77, 33, 2, 96, "odd"), (3, 33, 1, 1, 576, False)]
S1_BOUND = 2.0 ** -12
# fp32 trajectories, kernels on the card vs plain ops on the CPU, relative to
# max|x|: the repo's trajectory parity bound (tests/test_solver_parity.py:70-75)
SLICE_BOUND = 1e-4
# paths H and I, training (phases 7c and 7d): the seed of the weights, the
# data and every step's draws; H: the timed steps of `run_lib.train` at the
# config's batch (NCSN++ continuous VE b128, 32x32), the restart check's
# steps and the step its killed run resumes from, the DDPM eps-MSE steps;
# I: `run_lib.train_latent` steps on sd_v2_1 (b4, 768 px) and cin256 (b8,
# 256 px), and the adafactor + remat steps; the learning rate of the fp32
# card-vs-CPU steps
TRAIN_SEED = 13
H_STEPS, H_RESTART_STEPS, H_RESUME_AT, H_DDPM_STEPS = 6, 3, 2, 4
I_SD_BATCH, I_SD_STEPS, I_CIN_BATCH, I_CIN_STEPS, I_REMAT_STEPS = 4, 4, 8, 4, 2
CHECK_LR = 2e-4
# paths J-N (phase 7e), at full width with steps cut (PERF.md section 4):
# J, PC sampling on NCSN++ VE (N cut from 1,000; NFE 2N) at score_sde's VE
# sampling eps; J', ALD on NCSNv2 (J2_SCALES of the 232-scale ladder, the
# config's 5 steps a scale) and J2_TRAIN_STEPS steps of run_lib.train; K,
# inpaint, colorize and the class-conditional sampler (N cut to K_STEPS);
# L, DDIM and PLMS at L_STEPS, ancestral DDPM cut to L_DDPM_STEPS; M, the
# 64 -> 256 cascade, M_STEPS each stage, the upsampler built from
# guided-diffusion's README flags for 64_256_upsampler.pt (`--num_heads 4`:
# heads of 96 at 32x32, of 192 at 16x16 and 8x8); N, knn2img on
# rdm_768 over an N_DB-row database
J_BATCH, J_STEPS, J2_SCALES, J2_TRAIN_STEPS, VE_EPS = 64, 100, 20, 2, 1e-5
K_BATCH, K_STEPS = 16, 30
L_BATCH, L_STEPS, L_DDPM_STEPS = 64, 10, 100
M_BATCH, M_STEPS, M_AUG = 4, 10, 0.25
M_UPSAMPLER = dict(image_size=256, in_channels=6, model_channels=192, out_channels=6,
                   num_res_blocks=2, attention_resolutions=(8, 16, 32),
                   channel_mult=(1, 1, 2, 2, 4, 4), num_classes=1000, num_heads=4,
                   use_scale_shift_norm=True, resblock_updown=True)
N_DB, N_K, N_STEPS, N_SIZE, N_SCALE = 1_000_000, 10, 10, 768, 5.0
# paths O and P (phase 7f), at full width with steps and rounds cut (PERF.md
# section 4): O, `run_lib.train_autoencoder` on KL-f8 (sd_v1, 256 px) at
# O_KL_BATCH (latent-diffusion's autoencoder_kl_32x32x4.yaml trains at 12), a
# warm step and O_KL_STEPS timed; the restart check's O_RESTART_STEPS steps,
# killed after O_RESUME_AT; VQ-f4 (vq_cin256, O_CODES codes) at O_VQ_BATCH, a
# warm step and O_VQ_STEPS timed; the trainer's lr; the card-vs-CPU steps at
# b2, full width, O_CHECK_SIZE px. P, `run_lib.train` on cifar10_ddpm for
# P_TRAIN_STEPS steps (a checkpoint after each of the last two), then
# `run_lib.evaluate`: P_ROUNDS rounds a checkpoint at the config's eval batch,
# Inception in chunks of P_CHUNK images, the eps-MSE loss at P_LOSS_BATCH, the
# FID's reference statistics from P_REF_IMAGES seeded images (more than the
# 2,048 features, so that their covariance has full rank)
O_KL_BATCH, O_KL_STEPS, O_VQ_BATCH, O_VQ_STEPS, O_CODES = 12, 4, 8, 2, 8192
O_RESTART_STEPS, O_RESUME_AT, O_CHECK_SIZE, O_LR = 3, 2, 64, 4.5e-6
P_TRAIN_STEPS, P_ROUNDS, P_CHUNK, P_LOSS_BATCH, P_REF_IMAGES = 3, 2, 250, 128, 2500
# path Q (phase 7g), the data path from disk (PERF.md section 4): (a) CIFAR-10
# at its real size (50,000 + 10,000 seeded images in the python-pickle
# layout) through load_cifar10_dir and make_dataset into run_lib.train on
# cifar10_ddpm, a warm step and Q_STEPS - 1 timed, beside the same call on
# random tensors; the loader alone over Q_LOADER_BATCHES batches; (b) FFHQ's
# raw-CHW TFRecord layout at 256 px, Q_FFHQ_RECORDS of its 70,000 records,
# each reader timed over Q_READ_BATCHES batches of Q_BATCH after its first;
# (c) Q_FOLDER_IMAGES PNGs with sides from 256 to 512 in a folder; (d)
# Q_LMDB_IMAGES 256-px PNG payloads in an LMDB; (e) path P's first round as
# a PNG folder, the FID's chunks of Q_FID_CHUNK
Q_STEPS, Q_LOADER_BATCHES, Q_FFHQ_RECORDS, Q_BATCH, Q_READ_BATCHES = 5, 100, 2048, 32, 15
Q_FOLDER_IMAGES, Q_LMDB_IMAGES, Q_FID_CHUNK = 1024, 1024, 250
# the readers path Q runs, fixed from the card machine's probe (g++ 13.3 and
# zlib; no png.h, no jpeglib.h, no libpng or libjpeg; PIL and cv2; no
# tensorflow): the core library (TFRecords) and the PNG codec (on zlib) build
# there, the JPEG decoder (jpeglib.h) does not, so every payload here is PNG
# or raw; a JPEG or WebP reader path is not exercised on the card
Q_READERS = ("load_cifar10_dir", "make_dataset", "tfrecord_dataset_native", "tfrecord_dataset",
             "image_folder_dataset", "image_folder_dataset lsun_scoresde", "lsun_dataset",
             "compute_statistics_of_path folder")
# path R (phase 7h), SD-1.x txt2img through the CLI (PERF.md section 4): a
# CompVis checkpoint of the sd_v1 preset (UNet + KL VAE, seeded random
# weights, fp16 tensors) with a joint CLIP directory at ViT-L/14's text
# width and a safety checkpoint of R_CONCEPTS + R_SPECIAL 768-wide concept
# embeddings (thresholds as diffusers' range), written to a temporary
# directory; `txt2img` at R_SIZE px, b R_BATCH, R_STEPS NFE, CFG R_SCALE, in
# each of R_MODES; img2img and inpaint at R_EDIT_STEPS on b R_EDIT_BATCH;
# `sample --config cifar10_ddpm --batch BATCH --trace-dir`; the small-width
# card-vs-CPU int8 trajectory (tests/test_quant.py:203-214's UNet, weights
# and sampler: no CFG, R_SMALL_STEPS steps), and the int8 products' rows
# checked card vs CPU (R_ROWS rows of each product, on the same codes)
R_SIZE, R_BATCH, R_STEPS, R_SCALE, R_SEED = 512, 4, 25, 7.5, 42
R_MODES = (None, "w8a8", "w8a8_conv")
R_EDIT_STEPS, R_EDIT_BATCH, R_CONCEPTS, R_SPECIAL = 10, 2, 17, 3
R_SMALL_STEPS, R_ROWS, R_GRAPH = 5, 256, 10
R_PROMPT = "a watercolour painting of a fox in a snowy forest"
# the int8 bound (one H100 SXM at 700 W, dense int8 tensor cores)
PEAK_INT8 = 1979e12
# fp32 trajectories replayed from a CUDA graph vs the eager call on the card,
# relative to max|x|: the same kernels on the same inputs
GRAPH_BOUND = 1e-6
# the least time the card could take (one H100 SXM at 700 W, dense peaks):
# bf16 tensor-core products, fp32 elementwise work, device memory. The three
# units work at once, so the bound is the largest of the three times.
PEAK_BF16, PEAK_FP32, HBM = 989e12, 67e12, 3.35e12
# cuda_ms times as many calls as fit about this many ms, 3 to TIMED_MAX
# (200 ms until path S came: the script's time limit, PERF.md section 4)
TIMED_BUDGET_MS, TIMED_MAX = 100.0, 50
REPLACES = {
    "conv3x3": ("cuda", "dpm_solver_tpu_torch/csrc/conv3x3.cu",
                "dpm_solver_tpu/ops/conv3x3.py:125"),
    "token_attention": ("cuda", "dpm_solver_tpu_torch/csrc/attention.cu",
                        "dpm_solver_tpu/ops/attention.py:442 (_forward), :812 "
                        "(_flash_forward), :585 (_flash_forward_T), :641 (_panel_forward_T)"),
    "fused_update": ("triton", "dpm_solver_tpu_torch/ops/fused_update.py",
                     "dpm_solver_tpu/ops/fused_update.py:92"),
    "ln_linear": ("cuda", "dpm_solver_tpu_torch/csrc/ln_linear.cu",
                  "dpm_solver_tpu/ops/ln_linear.py:112"),
    "geglu_ff": ("cuda", "dpm_solver_tpu_torch/csrc/geglu.cu",
                 "dpm_solver_tpu/ops/geglu.py:125"),
    "attention_lse": ("cuda", "dpm_solver_tpu_torch/csrc/attention.cu",
                      "dpm_solver_tpu/ops/attention.py:187 (_lse, _lse_kernel :157)"),
    # rows 8-9 and the forward take FWD_HEAD_DIMS in both dtypes: the JSON
    # record's "head_dims" (ops/attention.py)
    "attention_dq": ("cuda", "dpm_solver_tpu_torch/csrc/attention_bwd.cu",
                     "dpm_solver_tpu/ops/attention.py:375 (_mha_backward dq: _dq_kernel :226, "
                     "_dq_kernel_T :245)"),
    "attention_dkv": ("cuda", "dpm_solver_tpu_torch/csrc/attention_bwd.cu",
                      "dpm_solver_tpu/ops/attention.py:410 (_mha_backward dk/dv: _dkv_kernel "
                      ":301, _dkv_kernel_T :269)"),
    "conv3x3_dx": ("cuda", "dpm_solver_tpu_torch/csrc/conv3x3.cu",
                   "dpm_solver_tpu/ops/conv3x3.py:185 (_conv3x3_bwd: dx through "
                   "_pallas_conv3x3 :125)"),
    "fused_bias_act": ("triton", "dpm_solver_tpu_torch/ops/fused_act.py",
                       "dpm_solver_tpu/ops/fused_act.py:51 (_row_call with _fwd_kernel :36)"),
    "fused_bias_act_bwd": ("triton", "dpm_solver_tpu_torch/ops/fused_act.py",
                           "dpm_solver_tpu/ops/fused_act.py:51 (_row_call with _bwd_kernel :41)"),
    "attention_out_fused": ("cuda", "dpm_solver_tpu_torch/csrc/attention_out.cu",
                            "dpm_solver_tpu/ops/attention.py:1190 (_attn_out_forward, "
                            "_attn_out_kernel :1007)"),
}
# kernels that no path launches, as in the JAX package: timed at the shapes
# where they would run, one launch each
NO_PATH = ("fused_bias_act", "fused_bias_act_bwd", "attention_out_fused")
# kernels that no one library call computes: timed beside the bf16
# composition of library calls, and beside their "wmma" route (the fused WMMA kernel)
COMPOSED = ("ln_linear", "geglu_ff")
# the kernels whose specs paths J-N record from their modules' inputs
# (record_kernel_specs), each spec then checked in bf16 against its plain version
HOOKED = ("conv3x3", "token_attention", "ln_linear", "geglu_ff")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def host_probe() -> dict:
    """What the host offers path Q (phase 7g), printed first: g++ and its
    version, whether png.h and jpeglib.h preprocess and libpng, libjpeg and
    zlib link, whether PIL, cv2 and tensorflow import (each in a child
    process), and the host's CPU count."""
    import os

    found = {}
    gxx = shutil.which("g++")
    ver = subprocess.run([gxx, "--version"], capture_output=True, text=True,
                         timeout=60).stdout.splitlines()[0] if gxx else None
    found["g++"] = ver
    log(f"probe: g++ {ver or 'not found'}")
    with tempfile.TemporaryDirectory(prefix="probe_") as tmp:
        for header, lib in (("png.h", "png"), ("jpeglib.h", "jpeg"), ("zlib.h", "z")):
            src = Path(tmp) / f"{lib}.cpp"
            # jpeglib.h wants FILE and size_t declared first
            src.write_text(f"#include <cstdio>\n#include <{header}>\nint main() {{ return 0; }}\n")
            pre = gxx and subprocess.run([gxx, "-E", str(src)], capture_output=True,
                                         timeout=60).returncode == 0
            link = gxx and subprocess.run([gxx, str(src), "-o", str(Path(tmp) / lib), f"-l{lib}"],
                                          capture_output=True, timeout=120).returncode == 0
            found[header] = dict(preprocesses=bool(pre), links=bool(link))
            log(f"probe: {header} preprocesses {bool(pre)}, -l{lib} links {bool(link)}")
    for mod in ("PIL", "cv2", "tensorflow"):
        run = subprocess.run([sys.executable, "-c", f"import {mod}; print({mod}.__version__)"],
                             capture_output=True, text=True, timeout=300)
        found[mod] = run.stdout.strip() if run.returncode == 0 else None
        log(f"probe: import {mod}: "
            f"{found[mod] or 'fails (' + (run.stderr.strip().splitlines() or ['?'])[-1] + ')'}")
    found["cpu_count"] = os.cpu_count()
    log(f"probe: os.cpu_count() {found['cpu_count']}")
    return found


def cuda_ms(fn) -> float:
    """Mean device time of fn() (CUDA events), after warm calls, over as many
    calls as fit about TIMED_BUDGET_MS (3 to TIMED_MAX)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    iters = max(3, min(TIMED_MAX, int(TIMED_BUDGET_MS / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fns: list, calls: int) -> float:
    """Device time of `calls` calls, fns[i % len(fns)]() the i-th, captured in
    one CUDA graph and replayed (no host work between the launches): ms a
    replay, by cuda_ms."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()   # warm: compiled and loaded before the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fns[i % len(fns)]()
    ms = cuda_ms(graph.replay)
    del graph
    return ms


def kernel_modules() -> tuple:
    """The modules ops/geglu.py and ops/ln_linear.py (the package's
    `ops.ln_linear` is the function)."""
    return (importlib.import_module("dpm_solver_tpu_torch.ops.geglu"),
            importlib.import_module("dpm_solver_tpu_torch.ops.ln_linear"))


def ptxas_usage(build_log: str, pattern: str) -> dict:
    """{kernel instance: (registers, spilled bytes)} from nvcc's `-Xptxas -v`
    output, for the entry functions whose mangled name matches `pattern`;
    an instance reads as its name and template arguments ("attn_dq_wgmma
    dh 64", "attn_bwd_f32 dh 256 dkv", "conv3x3_f32 dx", "conv3x3_narrow
    kc 32 nt 1")."""
    usage, name, spill = {}, None, 0
    for line in build_log.splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            name, spill = found.group(1), 0
        found = re.search(r"(\d+) bytes spill stores", line)
        if found:
            spill = int(found.group(1))
        found = re.search(r"Used (\d+) registers", line)
        if found and name and re.search(pattern, name):
            kernel = re.search(pattern, name).group(0)
            args = re.findall(r"L([ib])(\d+)E", name[name.index(kernel):])
            dh = [v for t, v in args if t == "i"]
            flags = [v for t, v in args if t == "b"]
            if kernel == "ln_linear_wgmma":  # <WM, SEG>
                usage[f"{kernel} rows {64 * int(dh[0])} "
                      f"{'segmented' if flags[0] == '1' else 'resident'}"] = (
                    int(found.group(1)), spill)
                continue
            tag = (f"{kernel} kc {dh[0]} nt {dh[1]}" if kernel == "conv3x3_narrow"
                   else f"{kernel} dh {dh[0]} kv {dh[1]} rows {64 * int(dh[2])} stages {dh[3]}"
                   if kernel == "attention_out_wgmma"
                   else f"{kernel} dh {dh[0]} buffers {dh[1]}" if kernel == "attention_out_f32"
                   else f"{kernel} dh {dh[0]}" if dh else kernel)
            if flags:
                tag += ((" dx" if flags[0] == "1" else " fwd") if kernel.startswith("conv")
                        else (" dkv" if flags[0] == "1" else " dq"))
            usage[tag] = (int(found.group(1)), spill)
    return usage


def rel_err(got, want) -> tuple:
    d = (got.float() - want.float()).abs().max().item()
    return d, d / max(want.float().abs().max().item(), 1e-30)


# --------------------------------------------------------------------------- #
# one kernel call at one shape: its inputs, the three ways to compute it, and
# the work it must do (for the bound)
# --------------------------------------------------------------------------- #


class Case(NamedTuple):
    """One kernel call at one shape: the kernel, its plain version, the
    library call (for COMPOSED, the bf16 composition of library calls) or
    None, and the work its bound counts: tensor-core flops (bf16 products),
    fp32 operations (on the CUDA cores: elementwise work, and the products
    of an fp32 call) and bytes (each input read once, each output written
    once)."""
    kernel: Callable
    plain: Callable
    library: Optional[Callable]
    tc_flops: float
    fp32_ops: float
    nbytes: float

    @property
    def work(self) -> float:
        """What the rate ("TFLOP/s", the JSON's "tflops") counts: the
        tensor-core flops, or the fp32 operations of a call that has none
        (an fp32 call, an elementwise kernel)."""
        return self.tc_flops or self.fp32_ops

    def bound(self) -> tuple:
        """(seconds the operations take at the peaks, seconds the bytes take)."""
        return max(self.tc_flops / PEAK_BF16, self.fp32_ops / PEAK_FP32), self.nbytes / HBM


def make_case(name: str, spec: tuple, randn, route: str = None, dtype=None) -> Case:
    """The Case of one bf16 call (fp32 for the fused update) at `spec`.
    `route` forces the kernel's route ("wmma": the fused WMMA kernel) of the
    kernels in COMPOSED in place of the plan's. `dtype` float32 (conv3x3,
    its dx and the attention kernels) makes the call fp32: its products then
    count as fp32 operations, and its bytes are 4 a value."""
    import torch
    import torch.nn.functional as F

    from dpm_solver_tpu_torch import ops
    from dpm_solver_tpu_torch.ops.attention import attention_delta
    from dpm_solver_tpu_torch.ops.conv3x3 import flip_weight

    GE, LN = kernel_modules()
    bf = torch.bfloat16 if dtype is None else dtype
    es = bf.itemsize   # bytes a value of the conv and attention calls

    def work(products, elementwise):  # -> (tensor-core flops, fp32 operations)
        return (products, elementwise) if bf == torch.bfloat16 else (0, products + elementwise)

    if name == "conv3x3":
        b, h, w, c, co = spec
        x, wt = randn(b, h, w, c).to(bf), (randn(3, 3, c, co) * c ** -0.5).to(bf)
        bias = randn(co) * 0.1
        # NHWC memory is NCHW in channels_last: cuDNN reads it in place
        xc, wc = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bc = bias.to(bf)
        return Case(lambda: ops.conv3x3(x, wt, bias), lambda: ops.conv3x3_plain(x, wt, bias),
                    lambda: F.conv2d(xc, wc, bc, padding=1),
                    *work(18 * b * h * w * c * co, b * h * w * co),
                    es * (b * h * w * (c + co) + 9 * c * co) + 4 * co)
    if name == "conv3x3_dx":  # spec: the forward conv's (b, h, w, c, co)
        b, h, w, c, co = spec
        g, wt = randn(b, h, w, co).to(bf), (randn(3, 3, c, co) * c ** -0.5).to(bf)
        gc = g.permute(0, 3, 1, 2)
        wc = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        return Case(lambda: ops.conv3x3_dx(g, wt),
                    lambda: ops.conv3x3_plain(g, flip_weight(wt)),
                    lambda: torch.nn.grad.conv2d_input((b, c, h, w), wc, gc, padding=1),
                    *work(18 * b * h * w * c * co, b * h * w * c),
                    es * (b * h * w * (c + co) + 9 * c * co))
    if name in ("token_attention", "attention_lse", "attention_dq", "attention_dkv"):
        b, t, s, heads, dh, fused = spec
        inner = heads * dh
        if fused:  # q, k, v as column slices of one (B, T, 3*inner) projection
            q, k, v = randn(b, t, 3 * inner).to(bf).split(inner, dim=-1)
        else:
            q, k, v = randn(b, t, inner).to(bf), randn(b, s, inner).to(bf), randn(b, s, inner).to(bf)
        qh, kh, vh = (u.unflatten(-1, (heads, dh)).transpose(1, 2) for u in (q, k, v))
        fwd_ops, fwd_bytes = 4 * b * heads * t * s * dh, es * 2 * b * inner * (t + s)
        if name == "token_attention":
            return Case(lambda: ops.token_attention(q, k, v, num_heads=heads),
                        lambda: ops.attention_plain(q, k, v, num_heads=heads),
                        lambda: F.scaled_dot_product_attention(qh, kh, vh),
                        *work(fwd_ops, 5 * b * heads * t * s), fwd_bytes)
        if name == "attention_lse":  # the library: flash attention (bf16 up to
            # dh 256) or memory-efficient attention (fp32, and the wider bf16
            # heads), which return the output and each row's natural-log lse
            # (ours times ln 2)
            aten = torch.ops.aten
            library = ((lambda: aten._scaled_dot_product_flash_attention(qh, kh, vh))
                       if bf == torch.bfloat16 and dh <= 256 else
                       (lambda: aten._scaled_dot_product_efficient_attention(qh, kh, vh, None,
                                                                             True)))
            return Case(lambda: ops.attention_lse(q, k, v, num_heads=heads),
                        lambda: (ops.attention_plain(q, k, v, num_heads=heads),
                                 ops.attention_lse_plain(q, k, num_heads=heads)),
                        library, *work(fwd_ops, 5 * b * heads * t * s),
                        fwd_bytes + 4 * b * heads * t)
        # the backward: dq or dk/dv from one forward's o and lse
        scale, g = dh ** -0.5, randn(b, t, inner).to(bf)
        o, lse = ops.attention_lse(q, k, v, num_heads=heads)
        delta = attention_delta(o, g, heads)
        args = (q, k, v, g, lse, delta)
        with torch.enable_grad():  # the library: SDPA's backward, timed alone
            lq, lk, lv = (u.detach().requires_grad_(True) for u in (qh, kh, vh))
            lo = F.scaled_dot_product_attention(lq, lk, lv)
        gh = g.unflatten(-1, (heads, dh)).transpose(1, 2)
        library = lambda: torch.autograd.grad(lo, (lq, lk, lv), gh, retain_graph=True)
        # the plain twin computes dq, dk and dv in one pass: its time, and the
        # library's, stand in both rows
        plain = lambda: ops.attention_backward_plain(q, k, v, o, lse, g, heads, scale)
        in_bytes = fwd_bytes + 8 * b * heads * t
        if name == "attention_dq":   # z, dp and ds.K: 3 products; dq out
            return Case(lambda: ops.attention_dq(*args, num_heads=heads, scale=scale), plain,
                        library, *work(6 * b * heads * t * s * dh, 5 * b * heads * t * s),
                        in_bytes + es * b * t * inner)
        return Case(lambda: ops.attention_dkv(*args, num_heads=heads, scale=scale), plain, library,
                    *work(8 * b * heads * t * s * dh,      # z, dp, p^T.dO, ds^T.Q
                          5 * b * heads * t * s), in_bytes + es * 2 * b * s * inner)
    if name == "ln_linear":
        m, d, n = spec
        x, w = randn(m, d).to(bf), (randn(n, d) * d ** -0.5).to(bf)
        g, be = 1 + 0.1 * randn(d), 0.1 * randn(d)
        kernel = lambda: ops.ln_linear(x, g, be, w)
        if route is not None:
            plan = dataclasses.replace(LN.ln_linear_plan(m, d, n, bf), route=route)
            kernel = lambda: LN.ln_linear_launch(x, g, be, w, None, 1e-5, plan)
        gb, beb = g.to(bf), be.to(bf)   # the composition: F.layer_norm, F.linear
        return Case(kernel, lambda: ops.ln_linear_plain(x, g, be, w),
                    lambda: F.linear(F.layer_norm(x, (d,), gb, beb), w),
                    2 * m * d * n, 8 * m * d, 2 * (m * d + m * n + d * n) + 8 * d)
    if name == "geglu_ff":
        m, d, inner = spec
        x, w1 = randn(m, d).to(bf), (randn(2 * inner, d) * d ** -0.5).to(bf)
        w2, b1, b2 = (randn(d, inner) * inner ** -0.5).to(bf), randn(2 * inner) * 0.1, randn(d) * 0.1
        kernel = lambda: ops.geglu_ff(x, w1, b1, w2, b2)
        if route is not None:
            plan = dataclasses.replace(GE.geglu_plan(m, d, inner, bf), route=route)
            kernel = lambda: GE.geglu_launch(x, w1, b1, w2, b2, plan)
        b1b, b2b = b1.to(bf), b2.to(bf)

        def composition():  # F.linear, gelu * h, F.linear, all bf16
            h, gate = F.linear(x, w1, b1b).chunk(2, dim=-1)
            return F.linear(h * F.gelu(gate), w2, b2b)
        return Case(kernel, lambda: ops.geglu_plain(x, w1, b1, w2, b2), composition,
                    6 * m * d * inner, 10 * m * inner,
                    2 * (2 * m * d + 3 * d * inner) + 4 * (2 * inner + d))
    if name == "fused_update":
        shape, = spec
        xs, coef = [randn(*shape) for _ in range(4)], randn(4, 8)
        n = xs[0].numel()
        return Case(lambda: ops.fused_update(coef, 1, *xs),
                    lambda: ops.fused_update_plain(coef, 1, *xs), None, 0, 7 * n, 4 * 5 * n)
    if name == "fused_bias_act":  # add, select, scale per element
        shape, = spec
        x, bias = randn(*shape).to(bf), randn(shape[-1]) * 0.1
        n = x.numel()
        return Case(lambda: ops.fused_bias_act(x, bias), lambda: ops.bias_act_plain(x, bias),
                    None, 0, 3 * n, 2 * 2 * n + 4 * shape[-1])
    if name == "fused_bias_act_bwd":  # select, multiply per element
        shape, = spec
        g, out = randn(*shape).to(bf), randn(*shape).to(bf)
        n = g.numel()
        return Case(lambda: ops.fused_bias_act_bwd(g, out),
                    lambda: ops.bias_act_grad_plain(g, out), None, 0, 2 * n, 3 * 2 * n)
    if name == "attention_out_fused":  # spec: (b, t, s, heads, dh, c)
        b, t, s, heads, dh, c = spec
        inner = heads * dh
        q, k, v = randn(b, t, inner).to(bf), randn(b, s, inner).to(bf), randn(b, s, inner).to(bf)
        w, res = (randn(inner, c) * inner ** -0.5).to(bf), randn(b, t, c).to(bf)
        bias = randn(c) * 0.1
        args = (q, k, v, w, bias, res)
        # the library composition: SDPA, then torch.addmm onto the residual
        # (the bias folded into it once, outside the timing)
        qh, kh, vh = (u.unflatten(-1, (heads, dh)).transpose(1, 2) for u in (q, k, v))
        res_bias = (res.float() + bias).to(bf).reshape(b * t, c)

        def library():
            o = F.scaled_dot_product_attention(qh, kh, vh)
            return torch.addmm(res_bias, o.transpose(1, 2).reshape(b * t, inner), w)
        return Case(lambda: ops.attention_out_fused(*args, heads),
                    lambda: ops.attention_out_plain(*args, num_heads=heads), library,
                    *work(4 * b * heads * t * s * dh + 2 * b * t * inner * c,
                          5 * b * heads * t * s),
                    es * (b * t * inner + 2 * b * s * inner + inner * c + 2 * b * t * c) + 4 * c)
    raise ValueError(name)


def time_kernel(name: str, calls: Counter, randn, smi: str, what: str, dtype=None,
                per_spec: bool = False) -> dict:
    """Kernel, plain and library device time over `calls` (spec -> launches),
    and the bound (Case.bound), with the rate of Case.work ("tflops"). For
    the kernels in COMPOSED the library slot's time is the composition's
    ("composition_ms"; "library_ms" is null: no one library call computes
    the function), and their "wmma" route (the fused WMMA kernel) is timed
    beside the plan's at the same shapes ("wmma_ms"). `dtype` float32 times
    the fp32 calls (make_case). `per_spec` also returns each spec's times
    under "by_spec"."""
    import torch

    composed = name in COMPOSED
    by_spec = []
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    if composed:
        tot.update(wmma_ms=0.0)
    ops_s = bytes_s = flops = 0.0
    has_library = True
    lib_label = "composition" if composed else "library"
    for spec, n in sorted(calls.items(), key=lambda kv: str(kv[0])):
        case = make_case(name, spec, randn, dtype=dtype)
        k, p = cuda_ms(case.kernel), cuda_ms(case.plain)
        lib = cuda_ms(case.library) if case.library is not None else None
        t_ops, t_bytes = case.bound()
        bound = max(t_ops, t_bytes) * 1e3
        wmma_note = ""
        if composed:
            wmma = cuda_ms(make_case(name, spec, randn, route="wmma").kernel)
            tot["wmma_ms"] += n * wmma
            wmma_note = f", wmma route {wmma:.4f} ms ({case.work / wmma / 1e9:.1f} TFLOP/s)"
        log(f"  {name} x{n} {spec}: kernel {k:.4f} ms ({case.work / k / 1e9:.1f} TFLOP/s)"
            f"{wmma_note}, plain {p:.4f} ms, {lib_label} "
            f"{'none' if lib is None else f'{lib:.4f} ms'}, bound {bound:.4f} ms "
            f"({'operations' if t_ops >= t_bytes else 'bytes'})")
        if per_spec:
            by_spec.append(dict(spec=list(spec), launches=n, ms=k, plain_ms=p, library_ms=lib,
                                bound_ms=bound, bound_by="operations" if t_ops >= t_bytes
                                else "bytes", tflops=case.work / k / 1e9, bound_share=bound / k))
        flops += n * case.work
        tot["ms"] += n * k
        tot["plain_ms"] += n * p
        tot["bound_ms"] += n * bound
        ops_s, bytes_s = ops_s + n * t_ops, bytes_s + n * t_bytes
        if lib is None:
            has_library = False
        else:
            tot["library_ms"] += n * lib
        del case
        torch.cuda.empty_cache()
    tot["library_ms"] = tot["library_ms"] if has_library else None
    if composed:
        tot["composition_ms"], tot["library_ms"] = tot["library_ms"], None
    tot["bound_by"] = "operations" if ops_s >= bytes_s else "bytes"
    tot["tflops"] = flops / tot["ms"] / 1e9   # Case.work over kernel time
    tot["bound_share"] = tot["bound_ms"] / tot["ms"]
    tot["timed"] = what
    if per_spec:
        tot["by_spec"] = by_spec
    lib = tot["composition_ms"] if composed else tot["library_ms"]
    wmma_note = (f", wmma route {tot['wmma_ms']:.3f} ms ({flops / tot['wmma_ms'] / 1e9:.1f} "
                 f"TFLOP/s)" if composed else "")
    log(f"kernel time on {smi}: {name} {tot['ms']:.3f} ms{wmma_note} vs plain {tot['plain_ms']:.3f} ms, "
        f"{lib_label} {'none' if lib is None else f'{lib:.3f} ms'}, bound {tot['bound_ms']:.3f} ms "
        f"({tot['bound_by']}; {tot['bound_share']:.3f} of the kernel's time, "
        f"{tot['tflops']:.1f} TFLOP/s); {sum(calls.values())} launches = {what}")
    return tot


# --------------------------------------------------------------------------- #
# launch counts implied by the configurations
# --------------------------------------------------------------------------- #


def adm_unet_launches(cfg, encoder_only: bool = False) -> Counter:
    """Kernel launches of one ADMUNet forward (or, encoder_only, of the
    trunk of one ADMClassifier forward), from the port's `layout()`: a res
    block runs two 3x3 convs (its skip is 1x1), an up-resample one; a
    SpatialTransformer of depth n runs 2n attentions, 2n LayerNorm->Linear
    and n GEGLU; an ADM attention block one attention."""
    from dpm_solver_tpu_torch.models import layout

    plan = layout(cfg, encoder_only=encoder_only)
    n = Counter()
    for spec in chain(*plan["input_blocks"], plan["middle"], *plan["output_blocks"]):
        if spec["kind"] == "res":
            n["conv3x3"] += 2
        elif spec["kind"] == "resample" and spec["direction"] == "up" and spec["with_conv"]:
            n["conv3x3"] += 1
        elif spec["kind"] == "xattn":
            n.update({"token_attention": 2 * spec["depth"], "ln_linear": 2 * spec["depth"],
                      "geglu_ff": spec["depth"]})
        elif spec["kind"] == "attn":
            n["token_attention"] += 1
    return n


def vae_decoder_launches(cfg) -> Counter:
    """Kernel launches of one VAE decode, from the config: conv_in, conv_out,
    two per res block, one per up-resample; one attention in the middle and
    one after each res block at an attention resolution."""
    levels = len(cfg.ch_mult)
    blocks = 2 + levels * (cfg.num_res_blocks + 1)
    res = [cfg.resolution // 2 ** i for i in range(levels)]
    attn = 1 + sum(cfg.num_res_blocks + 1 for r in res if r in cfg.attn_resolutions)
    conv = 2 + 2 * blocks + (levels - 1 if cfg.resamp_with_conv else 0)
    return Counter({"conv3x3": conv, "token_attention": attn})


def vae_encoder_launches(cfg) -> Counter:
    """Kernel launches of one VAE encode, from the config: conv_in, conv_out,
    two per res block (the stride-2 downsample is a library conv); one
    attention in the middle and one after each res block at an attention
    resolution."""
    levels = len(cfg.ch_mult)
    res = [cfg.resolution // 2 ** i for i in range(levels)]
    attn = 1 + sum(cfg.num_res_blocks for r in res if r in cfg.attn_resolutions)
    return Counter({"conv3x3": 2 + 2 * (levels * cfg.num_res_blocks + 2),
                    "token_attention": attn})


def inpaint_masks(b: int, size: int, seed: int):
    """(b, size, size) masks of one seeded rectangle each (1 = regenerate),
    half the side long, at a seeded corner."""
    import torch

    corners = torch.randint(0, size // 2, (b, 2), generator=torch.Generator().manual_seed(seed))
    mask = torch.zeros(b, size, size)
    for i, (y, x) in enumerate(corners.tolist()):
        mask[i, y:y + size // 2, x:x + size // 2] = 1.0
    return mask


def write_clip_text_dir(directory: Path, seed: int, joint: bool = False) -> Path:
    """An HF-format CLIP text directory at ViT-L/14's text width (12 layers,
    768 wide, 12 heads, vocab 49,408, 77 positions): config.json, seeded
    random weights as pytorch_model.bin under transformers' names, and a
    synthetic vocab.json and merges.txt (no pretrained CLIP is in the repo).
    `joint`: a CLIPModel (the joint space, 768 wide, for
    `FrozenCLIPTextJointEmbedder`) of that text tower and a one-layer
    64-wide vision tower, which the text features never run."""
    import torch

    from dpm_solver_tpu_torch.models import init_random_
    from dpm_solver_tpu_torch.models.clip import CLIPModel, CLIPTextModel, CLIPTowerConfig
    from dpm_solver_tpu_torch.models.clip_tokenizer import write_synthetic_vocab

    cfg = CLIPTowerConfig.vit_l14_text()
    write_synthetic_vocab(directory)
    text = dict(dataclasses.asdict(cfg), bos_token_id=49406, pad_token_id=1)
    if joint:
        vision = CLIPTowerConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=1,
                                 num_attention_heads=2)
        config = dict(architectures=["CLIPModel"], model_type="clip", projection_dim=768,
                      text_config=text, vision_config=dataclasses.asdict(vision))
        model = CLIPModel(cfg, vision, 768)
        parts = (model.text_model, model.vision_model, model.text_projection,
                 model.visual_projection)   # the scalar logit_scale keeps its init
    else:
        config = dict(text, architectures=["CLIPTextModel"], model_type="clip_text_model")
        model = CLIPTextModel(cfg)
        parts = (model,)
    (directory / "config.json").write_text(json.dumps(config))
    g = torch.Generator().manual_seed(seed)
    for part in parts:
        init_random_(part, g)
    torch.save(model.state_dict(), directory / "pytorch_model.bin")
    return directory


def guided_launches(ucfg, ccfg, steps: int) -> dict:
    """Kernel launches of one guided sample call of `steps` NFE: per NFE one
    UNet forward and one classifier forward and backward. The classifier's
    attentions (its blocks and the attention pool) keep their lse for the
    backward, which runs one dq and one dk/dv per attention and one conv3x3
    dx per conv3x3; the solver makes one fused update per step."""
    unet, clf = adm_unet_launches(ucfg), adm_unet_launches(ccfg, encoder_only=True)
    clf_attn = clf["token_attention"] + (ccfg.pool == "attention")
    per_nfe = {"conv3x3": unet["conv3x3"] + clf["conv3x3"], "conv3x3_dx": clf["conv3x3"],
               "token_attention": unet["token_attention"], "attention_lse": clf_attn,
               "attention_dq": clf_attn, "attention_dkv": clf_attn}
    out = {name: steps * per_nfe.get(name, 0) for name in REPLACES}
    out["fused_update"] = steps
    return out


def ncsnpp_launches(cfg) -> Counter:
    """Kernel launches of one NCSNpp forward, from its config: a ResBlockpp
    runs two 3x3 convs (its skip is 1x1; a BigGAN net also resamples with
    one between levels, down and up), a non-FIR up-resample with a conv
    (DDPM blocks, or the residual output pyramid) one; a SelfAttention2D one
    attention: after each down block and once up at an attention
    resolution, and once in the middle."""
    levels, blocks = len(cfg.ch_mult), cfg.num_res_blocks
    res = [cfg.image_size // 2 ** i for i in range(levels)]
    biggan = cfg.resblock_type == "biggan"
    resblocks = levels * blocks + 2 + levels * (blocks + 1) + (2 * (levels - 1) if biggan else 0)
    up_convs = 0 if cfg.fir else (levels - 1) * (
        (not biggan and cfg.resamp_with_conv) + (cfg.progressive == "residual"))
    attn = 1 + sum(blocks + 1 for r in res if r in cfg.attn_resolutions)
    return Counter({"conv3x3": 2 * resblocks + up_convs, "token_attention": attn})


def plan_rows(plan) -> int:
    """The fused updates of one sample call of `plan`: one a row."""
    rows = sum(g.n_seg * len(g.eval_after) for g in plan.seg_scans)
    for tab in (plan.scan_rows, plan.tail_rows):
        rows += 0 if tab is None else tab.n_ops
    if plan.scan_rows is not None and plan.scan_rows.b_corr is not None:
        rows += plan.scan_rows.n_ops
    return rows


def plan_launches(cfg, plan) -> dict:
    """Kernel launches of one sample call of `plan` over an NCSNpp of `cfg`:
    per model evaluation one forward, per row of the plan one fused update."""
    evals = plan.n_nfe + plan.denoise_final
    out = {name: evals * n for name, n in ncsnpp_launches(cfg).items()}
    out["fused_update"] = plan_rows(plan)
    return {name: out.get(name, 0) for name in REPLACES}


def train_launches(fwd: Counter, again: Optional[Counter] = None) -> dict:
    """Kernel launches of one training step whose network forward makes
    `fwd` (and whose backward recomputes `again` under remat): each conv3x3
    runs its dx, each attention keeps its lse (counted under attention_lse)
    and runs one dq and one dk/dv; LayerNorm->Linear and GEGLU differentiate
    through their plain twins (no launch)."""
    again = again or Counter()
    out = {name: 0 for name in REPLACES}
    out.update(conv3x3=fwd["conv3x3"] + again["conv3x3"], conv3x3_dx=fwd["conv3x3"],
               attention_lse=fwd["token_attention"] + again["token_attention"],
               attention_dq=fwd["token_attention"], attention_dkv=fwd["token_attention"],
               ln_linear=fwd["ln_linear"] + again["ln_linear"],
               geglu_ff=fwd["geglu_ff"] + again["geglu_ff"])
    return out


def adm_remat_launches(cfg) -> Counter:
    """What one ADMUNet backward recomputes under `cfg.remat`: the forward
    launches of its res blocks and spatial transformers (`layout()`)."""
    from dpm_solver_tpu_torch.models import layout

    plan = layout(cfg)
    n = Counter()
    for spec in chain(*plan["input_blocks"], plan["middle"], *plan["output_blocks"]):
        if spec["kind"] == "res":
            n["conv3x3"] += 2
        elif spec["kind"] == "xattn":
            n.update({"token_attention": 2 * spec["depth"], "ln_linear": 2 * spec["depth"],
                      "geglu_ff": spec["depth"]})
    return n


def scaled(counts: dict, k: int, extra: Optional[Counter] = None) -> dict:
    """k times `counts`, plus `extra` (launches made outside the k repeats)."""
    extra = extra or Counter()
    return {name: k * counts.get(name, 0) + extra[name] for name in REPLACES}


def check_routes(what: str, launches: dict, routes: dict, narrow_convs: int = 0) -> None:
    """`routes` (`ops.launch_routes()` read with `launches`, just after a bf16
    run): attention (forward, lse, dq, dk/dv), LayerNorm->Linear and GEGLU
    all on "wgmma"; conv3x3 (and its dx) on "wgmma" but for `narrow_convs`
    launches with C or CO not a multiple of 8, on "narrow"."""
    want = {"conv3x3": {"wgmma": launches["conv3x3"] - narrow_convs, "narrow": narrow_convs},
            "conv3x3_dx": {"wgmma": launches["conv3x3_dx"]},
            "token_attention": {"wgmma": launches["token_attention"]},
            "attention_lse": {"wgmma": launches["attention_lse"]},
            "attention_dq": {"wgmma": launches["attention_dq"]},
            "attention_dkv": {"wgmma": launches["attention_dkv"]},
            "ln_linear": {"wgmma": launches["ln_linear"]},
            "geglu_ff": {"wgmma": launches["geglu_ff"]},
            "attention_out_fused": {"wgmma": launches["attention_out_fused"]}}
    want = {k: {r: n for r, n in v.items() if n} for k, v in want.items()}
    log(f"  launches by route {routes} (expected {want})")
    if routes != want:
        fail(f"{what}: launches by route {routes} != {want}")


def record_guided_calls(unet, clf, run) -> tuple:
    """The kernel specs of one UNet forward and one classifier forward and
    backward, read from the modules' inputs by forward pre-hooks while `run`
    makes one of each. A classifier conv3x3 also runs its dx at its forward's
    spec; a classifier attention runs lse, dq and dk/dv at its spec."""
    from dpm_solver_tpu_torch import ops
    from dpm_solver_tpu_torch.models.adm_unet import ADMAttention, AttentionPool2d

    calls = {"unet": Counter(), "classifier": Counter()}

    def hook(where):
        def pre(mod, args):
            c, x = calls[where], args[0]
            specs = []
            if isinstance(mod, ops.Conv3x3):
                spec = (*x.shape, mod.weight.shape[0])
                specs = [("conv3x3", spec)] + ([("conv3x3_dx", spec)] if where != "unet" else [])
            elif isinstance(mod, (ADMAttention, AttentionPool2d)):
                b, h, w, ch = x.shape
                pool = isinstance(mod, AttentionPool2d)
                spec = (b, h * w + pool, h * w + pool, mod.num_heads, ch // mod.num_heads, pool)
                specs = ([("token_attention", spec)] if where == "unet" else
                         [(name, spec) for name in ("attention_lse", "attention_dq",
                                                    "attention_dkv")])
            c.update(specs)
        return pre

    kinds = (ops.Conv3x3, ADMAttention, AttentionPool2d)
    handles = [m.register_forward_pre_hook(hook(where))
               for where, net in (("unet", unet), ("classifier", clf))
               for m in net.modules() if isinstance(m, kinds)]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return calls["unet"], calls["classifier"]


def record_sd_calls(unet, vae, run, encoder: bool = False) -> tuple:
    """The kernel specs of the UNet forwards and VAE decodes (vae may be
    None) that `run` makes, read from the modules' inputs by forward hooks;
    with `encoder`, also the VAE encodes' (a third Counter)."""
    from dpm_solver_tpu_torch import ops
    from dpm_solver_tpu_torch.models.transformer import CrossAttention, GEGLUFeedForward
    from dpm_solver_tpu_torch.models.vae import VAEAttnBlock

    calls = {"unet": Counter(), "vae": Counter(), "encoder": Counter()}

    def hook(where):
        def pre(mod, args, kwargs):
            c = calls[where]
            x = args[0]
            if isinstance(mod, ops.Conv3x3):
                c["conv3x3", (*x.shape, mod.weight.shape[0])] += 1
            elif isinstance(mod, CrossAttention):
                b, t, d = x.shape
                ctx = kwargs.get("context")
                s = t if ctx is None else ctx.shape[1]
                inner = mod.heads * mod.dim_head
                c["token_attention", (b, t, s, mod.heads, mod.dim_head, ctx is None)] += 1
                c["ln_linear", (b * t, d, 3 * inner if ctx is None else inner)] += 1
            elif isinstance(mod, GEGLUFeedForward):
                b, t, d = x.shape
                c["geglu_ff", (b * t, d, mod.net[2].weight.shape[1])] += 1
            elif isinstance(mod, VAEAttnBlock):
                b, h, w, ch = x.shape
                c["token_attention", (b, h * w, h * w, 1, ch, True)] += 1
        return pre

    kinds = (ops.Conv3x3, CrossAttention, GEGLUFeedForward, VAEAttnBlock)
    nets = (("unet", unet), ("vae", None if vae is None else vae.decoder),
            ("encoder", vae.encoder if encoder else None))
    handles = [m.register_forward_pre_hook(hook(where), with_kwargs=True)
               for where, net in nets if net is not None
               for m in net.modules() if isinstance(m, kinds)]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return (calls["unet"], calls["vae"]) + ((calls["encoder"],) if encoder else ())


def record_kernel_specs(nets, run, specs: Counter):
    """run(), adding to `specs` one per launch of the kernels that the
    modules of `nets` make, keyed by (kernel, spec) as read from the
    modules' inputs by forward pre-hooks: conv3x3 (b, h, w, c, co);
    token_attention (b, t, s, heads, dh, q/k/v as column slices of one
    fused projection); ln_linear (m, d, n); geglu_ff (m, d, inner).
    Returns run()'s result."""
    from dpm_solver_tpu_torch import ops
    from dpm_solver_tpu_torch.models.adm_unet import ADMAttention
    from dpm_solver_tpu_torch.models.ddpm_unet import AttnBlock
    from dpm_solver_tpu_torch.models.ncsnpp import SelfAttention2D
    from dpm_solver_tpu_torch.models.transformer import CrossAttention, GEGLUFeedForward
    from dpm_solver_tpu_torch.models.vae import VAEAttnBlock

    def pre(mod, args, kwargs):
        x = args[0]
        if isinstance(mod, ops.Conv3x3):
            specs["conv3x3", (*x.shape, mod.weight.shape[0])] += 1
        elif isinstance(mod, CrossAttention):
            b, t, d = x.shape
            ctx = kwargs.get("context")
            s = t if ctx is None else ctx.shape[1]
            inner = mod.heads * mod.dim_head
            specs["token_attention", (b, t, s, mod.heads, mod.dim_head, ctx is None)] += 1
            specs["ln_linear", (b * t, d, 3 * inner if ctx is None else inner)] += 1
        elif isinstance(mod, GEGLUFeedForward):
            b, t, d = x.shape
            specs["geglu_ff", (b * t, d, mod.net[2].weight.shape[1])] += 1
        else:   # one head over the map's pixels, or ADM's heads
            b, h, w, c = x.shape
            heads = getattr(mod, "num_heads", 1)
            # q/k/v: column slices of one projection, but for the separate
            # 1x1 convs of AttnBlock and the head-major copies of ADM's
            # legacy order
            fused = mod.new_order if isinstance(mod, ADMAttention) else not isinstance(
                mod, AttnBlock)
            specs["token_attention", (b, h * w, h * w, heads, c // heads, fused)] += 1

    kinds = (ops.Conv3x3, CrossAttention, GEGLUFeedForward, ADMAttention, AttnBlock,
             SelfAttention2D, VAEAttnBlock)
    handles = [m.register_forward_pre_hook(pre, with_kwargs=True)
               for net in nets for m in net.modules() if isinstance(m, kinds)]
    try:
        return run()
    finally:
        for h in handles:
            h.remove()


@contextlib.contextmanager
def step_metrics():
    """The training loops' per-step log lines, (step, loss, grad norm), in
    the list it yields, for as long as the block runs."""
    records = []

    class Handler(logging.Handler):
        def emit(self, record):
            if record.msg.startswith("step %d loss"):
                records.append(record.args)

    handler, run_log = Handler(), logging.getLogger("dpm_solver_tpu_torch")
    run_log.addHandler(handler)
    run_log.setLevel(logging.INFO)
    try:
        yield records
    finally:
        run_log.removeHandler(handler)


def span_hooks(spans: dict, where: str) -> tuple:
    """Forward pre- and post-hooks that record a CUDA event pair per call
    into spans[where]."""
    import torch

    def pre(mod, args):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        spans[where].append([ev])

    def post(mod, args, out):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        spans[where][-1].append(ev)
    return pre, post


# --------------------------------------------------------------------------- #
# paths J-N: the rest of the sampling surface
# --------------------------------------------------------------------------- #


def counted(fn, box: list):
    """fn, adding one to box[0] at each call (a sampler's network evaluations)."""
    def call(*args, **kwargs):
        box[0] += 1
        return fn(*args, **kwargs)
    return call


def per_forward(forward: Counter, nfe: int, rows: int = 0) -> dict:
    """The launches of nfe network forwards of `forward` and `rows` fused updates."""
    out = {name: nfe * forward.get(name, 0) for name in REPLACES}
    out["fused_update"] += rows
    return out


def summed(dicts) -> dict:
    """Launch counts (or launches by route) of several runs, added."""
    dicts = list(dicts)
    out = {}
    for name in dicts[0]:
        if isinstance(dicts[0][name], dict):
            out[name] = dict(sum((Counter(d[name]) for d in dicts), Counter()))
        else:
            out[name] = sum(d[name] for d in dicts)
    return out


def narrow_convs(*nets) -> int:
    """The Conv3x3 modules of `nets` whose C or CO is not a multiple of 8 (the
    bf16 conv's "narrow" route)."""
    from dpm_solver_tpu_torch import ops

    return sum(1 for net in nets for m in net.modules() if isinstance(m, ops.Conv3x3)
               and (m.weight.shape[0] % 8 or m.weight.shape[1] % 8))


def host_top_k_agrees(db, q: "np.ndarray", got: "np.ndarray", k: int, gap: float) -> tuple:
    """The exact top-k of the normalised queries `q` against the normalised
    rows of `db` (a tensor on the card, read to the host in chunks), by a
    float64 NumPy product; `got` (Q, k) agrees where the scores are apart:
    a position whose score is more than `gap` from both neighbours holds the
    host's index, and where the k-th and (k+1)-th scores differ by more than
    `gap` the two sets are equal. Returns (positions compared, sets
    compared, mismatches)."""
    import numpy as np

    q = q.astype(np.float64)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    scores = np.empty((q.shape[0], db.shape[0]))
    for i in range(0, db.shape[0], 100_000):
        rows = db[i:i + 100_000].cpu().numpy().astype(np.float64)
        rows /= np.maximum(np.linalg.norm(rows, axis=1, keepdims=True), 1e-12)
        scores[:, i:i + 100_000] = q @ rows.T
    positions = sets = bad = 0
    for row, want_scores, mine in zip(range(q.shape[0]), scores, got):
        top = np.argpartition(-want_scores, k + 1)[:k + 1]
        top = top[np.argsort(-want_scores[top])]
        s = want_scores[top]
        for j in range(k):
            left = s[j - 1] - s[j] if j else np.inf
            if left > gap and s[j] - s[j + 1] > gap:
                positions += 1
                bad += int(mine[j] != top[j])
        if s[k - 1] - s[k] > gap:
            sets += 1
            bad += int(set(mine.tolist()) != set(top[:k].tolist()))
    return positions, sets, bad


def sampling_surface(dev, smi: str) -> dict:
    """Paths J-N (phase 7e): full width, seeded random weights, steps cut
    (PERF.md section 4). Each run's launches (and by route) against what
    its configuration and NFE imply; then each path in fp32 at small width,
    batch and steps, the same explicit noise on both sides, the card
    (kernels) against the CPU (plain) within SLICE_BOUND of max|x|.
    Returns each path's launches, routes and walls, the (kernel, spec)
    pairs of its launches (`specs`) and the solver states of its fused
    updates (`updates`), for main to check each kernel there."""
    import numpy as np
    import torch

    import dpm_solver_tpu_torch as P
    from dpm_solver_tpu_torch import configs as port_configs
    from dpm_solver_tpu_torch import ops, run_lib
    from dpm_solver_tpu_torch.controllable import (decouple, get_pc_colorizer,
                                                   get_pc_conditional_sampler, get_pc_inpainter)
    from dpm_solver_tpu_torch.models import (ADMConfig, ADMUNet, AutoencoderKL, DDPMUNet,
                                             DDPMUNetConfig, FrozenCLIPTextJointEmbedder, NCSNpp,
                                             NCSNppConfig, VAEConfig, WideResNetClassifier,
                                             init_random_, super_res_inputs)
    from dpm_solver_tpu_torch.models.wideresnet import get_classifier_grad_fn, get_logit_fn
    from dpm_solver_tpu_torch.pipelines import (CascadePipeline, CascadeStage, LatentDiffusion,
                                                Searcher, knn2img, load_sd_checkpoint)
    from dpm_solver_tpu_torch.samplers import (ddim_sampler, ddpm_ancestral_sampler,
                                               get_pc_sampler, pc_draws, plms_sampler)
    from dpm_solver_tpu_torch.score import get_score_fn
    from dpm_solver_tpu_torch.sde import VESDE
    from dpm_solver_tpu_torch.solver.sample import make_plan

    bf16 = torch.bfloat16
    launches, routes, walls = {}, {}, {}
    specs = Counter()   # (kernel, spec) -> launches, over the counted runs
    cpu = torch.device("cpu")
    places = {"cuda": dev, "cpu": cpu}   # the card (kernels), the CPU (plain)

    def gen(seed, where=dev):
        return torch.Generator(device=where).manual_seed(seed)

    def run(what, call, expected, narrow=0, captures=None, nets=()):
        """One counted call: launches (and by route) against `expected`, and
        the CUDA-graph captures it makes against `captures` (None: not
        checked). The specs of the launches that the modules of `nets` make
        are recorded into `specs` (record_kernel_specs), and must account
        for every launch of the kernels HOOKED. Returns (result, launches,
        routes, wall s)."""
        ops.reset_launch_counts()
        made, seen = P.GraphedSampler.captures, Counter()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = record_kernel_specs(nets, call, seen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got, by_route = ops.launch_counts(), ops.launch_routes()
        made = P.GraphedSampler.captures - made
        log(f"  {what}: {wall:.2f} s on {smi}; launches {got} (expected {expected})"
            + ("" if captures is None else f", {made} capture(s) (expected {captures})"))
        if got != expected or (captures is not None and made != captures):
            fail(f"{what}: launches {got} != {expected}, or {made} captures")
        check_routes(what, got, by_route, narrow_convs=narrow)
        for name in HOOKED:
            n = sum(k for (kernel, _), k in seen.items() if kernel == name)
            if n != got[name]:
                fail(f"{what}: the hooks recorded {n} {name} launches of its {got[name]}")
        specs.update(seen)
        return out, got, by_route, wall

    def finite(what, x, shape):
        if tuple(x.shape) != tuple(shape) or not torch.isfinite(x).all():
            fail(f"{what}: {tuple(x.shape)} is not finite of shape {tuple(shape)}")
        log(f"    {what}: {tuple(x.shape)} finite, max|x| {x.abs().max().item():.4g}")

    def card_vs_cpu(what, results, bound=SLICE_BOUND):
        """results: {"cuda": tensor, "cpu": tensor}."""
        d, r = rel_err(results["cuda"].cpu(), results["cpu"])
        ok = r <= bound and bool(torch.isfinite(results["cuda"]).all())
        log(f"  {what}, kernels (card) vs plain (cpu): max|d| {d:.3e}, /max|x| {r:.3e} "
            f"(bound {bound:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{what}: the card disagrees with the plain path on the CPU")

    def twins(build, seed):
        """`build(device)` on the card and on the CPU, fp32, frozen, with the
        same random weights (`init_random_` from `seed`)."""
        state = init_random_(build(cpu), gen(seed, cpu)).state_dict()
        out = {}
        for key, where in places.items():
            net = build(where)
            net.load_state_dict(state)
            out[key] = net.eval().requires_grad_(False)
        return out

    def each(nets, fn):
        """fn(net, device) for the card's and the CPU's twin."""
        return {key: fn(net, places[key]) for key, net in nets.items()}

    tiny_ve = NCSNppConfig.tiny(fir=True, progressive_input="residual", embedding_type="fourier",
                                num_res_blocks=1)
    tiny_ve_nets = twins(lambda where: NCSNpp(tiny_ve, device=where), 41)

    # ---- J: PC sampling on NCSN++ VE (score_sde_cifar10_ve_ncsnpp_continuous) --
    t_path = time.perf_counter()
    cfg_j = port_configs.get_config("score_sde_cifar10_ve_ncsnpp_continuous")
    sde_full = run_lib._make_sde(cfg_j)
    sde_j = dataclasses.replace(sde_full, N=J_STEPS)
    net_j = init_random_(NCSNpp(cfg_j.model_config, compute_dtype=bf16, device=dev),
                         gen(42)).eval().requires_grad_(False)
    fwd_j = ncsnpp_launches(cfg_j.model_config)
    s = cfg_j.sampling
    pc_kw = dict(predictor=s.predictor, corrector=s.corrector, snr=s.snr,
                 n_corrector_steps=s.n_steps_each, eps=VE_EPS)
    nfe = [0]
    pc = get_pc_sampler(sde_j, get_score_fn(sde_j, counted(net_j, nfe), continuous=True), **pc_kw)
    side = cfg_j.data.image_size
    g = gen(43)
    x_T = sde_j.prior_sampling((J_BATCH, side, side, 3), generator=g)
    log(f"path J: PC sampling ({s.predictor} + {s.corrector}, snr {s.snr}), NCSN++ VE "
        f"continuous ({sum(p.numel() for p in net_j.parameters()) / 1e6:.2f}M params, bf16), "
        f"b{J_BATCH}, N cut from {sde_full.N} to {J_STEPS}, eps {VE_EPS:g}")
    (x0, nfe_j), launches["j"], routes["j"], walls["j"] = run(
        "path J", lambda: pc(x_T, generator=g), per_forward(fwd_j, 2 * J_STEPS),
        nets=[net_j])
    if not nfe[0] == nfe_j == 2 * J_STEPS:
        fail(f"path J: {nfe[0]} network evaluations, the sampler says {nfe_j}, not {2 * J_STEPS}")
    finite("path J samples", x0, x_T.shape)
    sde_t = VESDE(N=4)
    noise = torch.randn((pc_draws(sde_t, s.predictor, s.corrector, 1), 2, 16, 16, 3),
                        generator=gen(44, cpu))
    xt = sde_t.prior_sampling((2, 16, 16, 3), generator=gen(45, cpu))
    card_vs_cpu("path J (fp32, tiny VE NCSN++, b2, N 4)", each(tiny_ve_nets, lambda net, where: (
        get_pc_sampler(sde_t, get_score_fn(sde_t, net, continuous=True), **pc_kw)(
            xt.to(where), noise=noise.to(where))[0])))
    log(f"path J done in {time.perf_counter() - t_path:.1f} s")

    # ---- J': annealed Langevin on NCSNv2 (score_sde_cifar10_ve_ncsnv2) ---------
    t_path = time.perf_counter()
    cfg_v = port_configs.get_config("score_sde_cifar10_ve_ncsnv2")
    net_v, init_v = run_lib.build_model(cfg_v, device=dev)
    init_v(gen(46))
    sde_v = run_lib._make_sde(cfg_v)
    sde_vc = dataclasses.replace(sde_v, N=J2_SCALES)
    sv = cfg_v.sampling
    nfe = [0]
    # the labels index the config's ladder of sde_v.N scales; the loop visits
    # J2_SCALES of them (the grid of sde_vc)
    score_v = get_score_fn(sde_v, counted(run_lib.score_net_apply(net_v, "ncsnv2"), nfe),
                           continuous=False)
    ald = get_pc_sampler(sde_vc, score_v, predictor=sv.predictor, corrector=sv.corrector,
                         snr=sv.snr, n_corrector_steps=sv.n_steps_each, eps=VE_EPS)
    g = gen(47)
    xv = sde_vc.prior_sampling((J_BATCH, side, side, 3), generator=g)
    log(f"path J': ALD ({sv.predictor} + {sv.corrector}, snr {sv.snr}, {sv.n_steps_each} steps a "
        f"scale), NCSNv2 cifar10 ({sum(p.numel() for p in net_v.parameters()) / 1e6:.2f}M params, "
        f"fp32, F.conv2d), b{J_BATCH}, {J2_SCALES} of the {sde_v.N} scales")
    (xv0, nfe_v), launches["j_ald"], routes["j_ald"], walls["j_ald"] = run(
        "path J'", lambda: ald(xv, generator=g), {name: 0 for name in REPLACES})
    if not nfe[0] == nfe_v == J2_SCALES * sv.n_steps_each:
        fail(f"path J': {nfe[0]} network evaluations, the sampler says {nfe_v}")
    finite("path J' samples", xv0, xv.shape)
    # the same NCSNv2 (tiny), card vs CPU
    from dpm_solver_tpu_torch.models import NCSNv2, NCSNv2Config

    tv = NCSNv2Config.tiny()
    tv_nets = twins(lambda where: NCSNv2(tv, device=where), 48)
    sde_tv = VESDE(sigma_max=tv.sigma_max, N=tv.num_scales)
    sde_tvc = dataclasses.replace(sde_tv, N=4)
    noise = torch.randn((pc_draws(sde_tvc, "none", "ald", 2), 2, 16, 16, 3),
                        generator=gen(49, cpu))
    xt = sde_tvc.prior_sampling((2, 16, 16, 3), generator=gen(50, cpu))
    card_vs_cpu("path J' (fp32, tiny NCSNv2, b2, 4 scales x 2 steps)", each(
        tv_nets, lambda net, where: get_pc_sampler(
            sde_tvc, get_score_fn(sde_tv, run_lib.score_net_apply(net, "ncsnv2"), continuous=False),
            predictor="none", corrector="ald", snr=sv.snr, n_corrector_steps=2, eps=VE_EPS)(
            xt.to(where), noise=noise.to(where))[0]))
    # two steps of run_lib.train on the config (the legacy SMLD loss)
    batches = [np.random.default_rng(51 + i).uniform(
        0.0, 1.0, (cfg_v.training.batch_size, side, side, 3)).astype(np.float32)
        for i in range(J2_TRAIN_STEPS)]
    workdir = tempfile.mkdtemp(prefix="ncsnv2_train_")
    try:
        with torch.enable_grad(), step_metrics() as losses:
            t0 = time.perf_counter()
            run_lib.train(dataclasses.replace(cfg_v, workdir=workdir, training=dataclasses.replace(
                cfg_v.training, log_freq=1)), iter(batches), max_steps=J2_TRAIN_STEPS, device=dev)
            torch.cuda.synchronize()
            walls["j_ald_train"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"  path J' run_lib.train, b{cfg_v.training.batch_size}, {J2_TRAIN_STEPS} steps: "
        f"{walls['j_ald_train']:.2f} s; (step, loss, grad norm) {losses}")
    if len(losses) != J2_TRAIN_STEPS or not all(math.isfinite(v) for m in losses for v in m[1:]):
        fail(f"path J' training: the steps' loss and grad norm {losses} are not finite")
    del net_v, tv_nets
    log(f"path J' done in {time.perf_counter() - t_path:.1f} s")

    # ---- K: controllable generation on NCSN++ VE + WRN-28-10 ---------------------
    t_path = time.perf_counter()
    sde_k = dataclasses.replace(sde_full, N=K_STEPS)
    nfe = [0]
    score_k = get_score_fn(sde_k, counted(net_j, nfe), continuous=True)
    wrn = init_random_(WideResNetClassifier(device=dev), gen(52)).eval().requires_grad_(False)
    with torch.no_grad():   # init_random_ sets a vector to ones: W is a normal(16) draw
        wrn.fourier.W.copy_(torch.randn(wrn.fourier.W.shape, generator=gen(53), device=dev) * 16)
    grad_fn = get_classifier_grad_fn(get_logit_fn(wrn))

    def classifier_grad(sde):
        return lambda x, t, y: grad_fn(x, sde.marginal_prob(torch.zeros_like(x), t)[1], y)

    g = gen(54)
    data = torch.rand((K_BATCH, side, side, 3), generator=g, device=dev)
    known = 1.0 - inpaint_masks(K_BATCH, side, 55)[..., None].expand(-1, -1, -1, 3).to(dev)
    gray = data.mean(dim=-1, keepdim=True).expand(-1, -1, -1, 3).contiguous()
    labels = torch.from_numpy(np.random.default_rng(56).integers(0, 10, K_BATCH)).to(dev)
    log(f"path K: controllable generation on path J's NCSN++ VE (bf16) and WRN-28-10 "
        f"({sum(p.numel() for p in wrn.parameters()) / 1e6:.2f}M params, fp32, frozen), "
        f"b{K_BATCH}, N cut from {sde_full.N} to {K_STEPS}, reverse diffusion + Langevin")
    fwd_k = per_forward(fwd_j, 2 * K_STEPS)
    calls_k = {"inpaint": lambda: get_pc_inpainter(sde_k, score_k)(data, known, generator=g),
               "colorize": lambda: get_pc_colorizer(sde_k, score_k)(gray, generator=g),
               "conditional": lambda: get_pc_conditional_sampler(
                   sde_k, score_k, classifier_grad(sde_k))(data.shape, labels, generator=g)}
    outs_k, runs_k = {}, []
    for what, call in calls_k.items():
        nfe[0] = 0
        outs_k[what], got, by_route, wall = run(f"path K {what}", call, fwd_k, nets=[net_j])
        runs_k.append((got, by_route))
        walls[f"k_{what}"] = wall
        if nfe[0] != 2 * K_STEPS:
            fail(f"path K {what}: {nfe[0]} network evaluations, not {2 * K_STEPS}")
        finite(f"path K {what}", outs_k[what], data.shape)
    launches["k"], routes["k"] = summed(r[0] for r in runs_k), summed(r[1] for r in runs_k)
    kept = ((outs_k["inpaint"] - data) * known).abs().max().item()
    ok = kept <= 1e-5 * data.abs().max().item()
    log(f"  inpaint keeps the known pixels: max|x - data| there {kept:.3e} (bound 1e-5 of "
        f"max|data| {data.abs().max().item():.4f}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("path K: inpainting moved the known pixels")
    # the luma is pinned in the decoupled space and coupled back: read again,
    # it carries the fp32 rounding of the basis change at the output's scale
    luma = (decouple(outs_k["colorize"])[..., 0] - decouple(gray)[..., 0]).abs().max().item()
    scale = outs_k["colorize"].abs().max().item()
    ok = luma <= 1e-5 * scale
    log(f"  colorize keeps the gray image's luma: max|d| {luma:.3e} (bound 1e-5 of max|x| "
        f"{scale:.4g}; /max|data| {luma / data.abs().max().item():.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("path K: colorization moved the luma")
    # card vs CPU: the classifier gradient at b2, of WRN-28-1 in fp32 and of
    # WRN-28-10 in float64: at these random weights WRN-28-10's input
    # gradient is ill-conditioned in fp32 (logged: its fp32 gradient against
    # float64 on the CPU, and fp32 card against CPU); then the three tasks on
    # the tiny VE NCSN++ and a tiny WRN, b2, N 3, fp32
    xs = torch.rand((2, side, side, 3), generator=gen(57, cpu))
    sig = torch.tensor([0.05, 20.0])

    def wrn_grad(net, where, dtype):
        return get_classifier_grad_fn(get_logit_fn(net.to(dtype)))(
            xs.to(where, dtype), sig.to(where, dtype), labels[:2].to(where))

    card_vs_cpu("path K classifier gradient (WRN-28-1, fp32, b2)", each(
        twins(lambda where: WideResNetClassifier(4, 1, device=where), 52),
        lambda net, where: wrn_grad(net, where, torch.float32)))
    nets = twins(lambda where: WideResNetClassifier(device=where), 52)
    g32 = each(nets, lambda net, where: wrn_grad(net, where, torch.float32))
    g64 = each(nets, lambda net, where: wrn_grad(net, where, torch.float64))
    card_vs_cpu("path K classifier gradient (WRN-28-10, float64, b2)", g64)
    log(f"  WRN-28-10's fp32 gradient (not held): against float64 on the CPU, /max "
        f"{rel_err(g32['cpu'].double(), g64['cpu'])[1]:.3e}; card against CPU, /max "
        f"{rel_err(g32['cuda'].cpu(), g32['cpu'])[1]:.3e}")
    del nets
    tiny_wrn = twins(lambda where: WideResNetClassifier(1, 1, device=where), 58)
    sde_t = VESDE(N=3)
    from dpm_solver_tpu_torch.controllable import task_draws

    for what in ("inpaint", "colorize", "conditional"):
        noise = torch.randn((task_draws(sde_t, constrained=what != "conditional"), 2, 16, 16, 3),
                            generator=gen(59, cpu))
        small = torch.rand((2, 16, 16, 3), generator=gen(60, cpu))
        mask = 1.0 - inpaint_masks(2, 16, 61)[..., None].expand(-1, -1, -1, 3)
        res = {}
        for key, net in tiny_ve_nets.items():
            score, where = get_score_fn(sde_t, net, continuous=True), places[key]
            nz = noise.to(where)
            if what == "inpaint":
                res[key] = get_pc_inpainter(sde_t, score)(small.to(where), mask.to(where), noise=nz)
            elif what == "colorize":
                res[key] = get_pc_colorizer(sde_t, score)(
                    small.mean(-1, keepdim=True).expand(-1, -1, -1, 3).to(where), noise=nz)
            else:
                gfn = get_classifier_grad_fn(get_logit_fn(tiny_wrn[key]))
                res[key] = get_pc_conditional_sampler(
                    sde_t, score, lambda x, t, y: gfn(x, sde_t.marginal_prob(x, t)[1], y))(
                    small.shape, labels[:2].to(where), noise=nz)
        card_vs_cpu(f"path K {what} (fp32, tiny VE NCSN++, tiny WRN, b2, N 3)", res)
    del wrn, net_j
    log(f"path K done in {time.perf_counter() - t_path:.1f} s")

    # ---- L: DDIM, PLMS and ancestral DDPM on path A's DDPM UNet -----------------
    t_path = time.perf_counter()
    cfg_l = DDPMUNetConfig.cifar10()
    net_l = DDPMUNet(cfg_l, compute_dtype=bf16, device=dev).eval()
    net_l.load_state_dict(init_random_(DDPMUNet(cfg_l, device="cpu"),
                                       gen(0, cpu)).state_dict())   # path A's weights
    ns_l = P.NoiseScheduleVP.discrete(betas=np.linspace(1e-4, 0.02, 1000))
    fwd_l = Counter(conv3x3=47, token_attention=6)   # one CIFAR-10 forward (path A)
    g = gen(62)
    x_l = torch.randn((L_BATCH, 32, 32, 3), generator=g, device=dev)
    samplers_l = {"ddim_eta0": (lambda m: ddim_sampler(m, ns_l, steps=L_STEPS, eta=0.0), L_STEPS),
                  "ddim_eta1": (lambda m: ddim_sampler(m, ns_l, steps=L_STEPS, eta=1.0), L_STEPS),
                  "plms": (lambda m: plms_sampler(m, ns_l, steps=L_STEPS), L_STEPS + 1),
                  "ddpm": (lambda m: ddpm_ancestral_sampler(m, ns_l, steps=L_DDPM_STEPS),
                           L_DDPM_STEPS)}
    log(f"path L: DDIM (eta 0, 1) and PLMS at {L_STEPS} steps, ancestral DDPM cut from 1,000 to "
        f"{L_DDPM_STEPS} steps, on path A's CIFAR-10 DDPM UNet (bf16), b{L_BATCH}")
    runs_l = []
    for what, (make, n) in samplers_l.items():
        nfe = [0]
        out, got, by_route, walls[f"l_{what}"] = run(
            f"path L {what}", lambda: make(counted(net_l, nfe))(x_l, generator=g),
            per_forward(fwd_l, n), nets=[net_l])
        if nfe[0] != n:
            fail(f"path L {what}: {nfe[0]} network evaluations, not {n}")
        finite(f"path L {what}", out, x_l.shape)
        runs_l.append((got, by_route))
    launches["l"], routes["l"] = summed(r[0] for r in runs_l), summed(r[1] for r in runs_l)
    tl = DDPMUNetConfig.tiny()
    tl_nets = twins(lambda where: DDPMUNet(tl, device=where), 63)
    xt = torch.randn((2, 16, 16, 3), generator=gen(64, cpu))
    noise = torch.randn((3, 2, 16, 16, 3), generator=gen(65, cpu))
    for what, make in (("ddim_eta1", lambda m: ddim_sampler(m, ns_l, steps=3, eta=1.0)),
                       ("plms", lambda m: plms_sampler(m, ns_l, steps=3)),
                       ("ddpm", lambda m: ddpm_ancestral_sampler(m, ns_l, steps=3))):
        card_vs_cpu(f"path L {what} (fp32, tiny DDPM UNet, b2, 3 steps)", each(
            tl_nets, lambda net, where: make(net)(
                xt.to(where), noise=None if what == "plms" else noise.to(where))))
    del net_l, tl_nets
    log(f"path L done in {time.perf_counter() - t_path:.1f} s")

    # ---- M: the 64 -> 256 cascade (ImageNet-64 iDDPM + the 64->256 upsampler) ---
    t_path = time.perf_counter()
    base_cfg = ADMConfig.imagenet64_iddpm()
    up_cfg = ADMConfig(**M_UPSAMPLER)
    g = gen(66)
    base = init_random_(ADMUNet(base_cfg, compute_dtype=bf16, device=dev), g).eval()
    up = init_random_(ADMUNet(up_cfg, compute_dtype=bf16, device=dev), g).eval()
    base_ns = P.NoiseScheduleVP.discrete(
        betas=port_configs.DiffusionConfig(beta_schedule="cosine").betas())
    up_ns = P.NoiseScheduleVP.discrete(betas=np.linspace(1e-4, 0.02, 1000))
    labels_m = torch.from_numpy(np.random.default_rng(67).integers(0, 1000, M_BATCH)).to(dev)

    def cascade(base_net, up_net, steps, base_res=64, up_res=256):
        """Guided-diffusion's learned-sigma models: the eps half of the output."""
        return CascadePipeline([
            CascadeStage(model=lambda x, t, c, low: base_net(x, t)[..., :3],
                         noise_schedule=base_ns, resolution=base_res, steps=steps, order=2),
            CascadeStage(model=lambda x, t, c, low: up_net(super_res_inputs(x, low), t, c)[..., :3],
                         noise_schedule=up_ns, resolution=up_res, steps=steps, order=2,
                         algorithm_type="sde-dpmsolver++", aug_level=M_AUG)])

    pipe_m = cascade(base, up, M_STEPS)
    rows = [plan_rows(make_plan(st.noise_schedule, steps=M_STEPS, order=2, method="multistep",
                                skip_type="time_uniform", t_end=1e-3,
                                algorithm_type=st.algorithm_type)) for st in pipe_m.stages]
    sampler_m = summed([per_forward(adm_unet_launches(base_cfg), M_STEPS, rows[0]),
                        per_forward(adm_unet_launches(up_cfg), M_STEPS, rows[1])])
    n_base, n_up = (sum(p.numel() for p in net.parameters()) for net in (base, up))
    log(f"path M: cascade 64 -> 256, base ImageNet-64 iDDPM ({n_base / 1e6:.2f}M params) "
        f"DPM-Solver++ 2M, upsampler (guided-diffusion's 64_256 flags, {n_up / 1e6:.2f}M params) "
        f"SDE-DPM-Solver++ 2M, aug_level {M_AUG}, {M_STEPS} steps each, bf16, b{M_BATCH}, graphed")
    narrow_m = narrow_convs(base, up) * M_STEPS
    outs_m, launches["m"], routes["m"], walls["m_first"] = run(
        "path M, first call (warm call + capture, each stage)",
        lambda: pipe_m.sample(labels_m, batch=M_BATCH, generator=gen(68), return_all_stages=True),
        {name: 2 * n for name, n in sampler_m.items()}, narrow=2 * narrow_m, captures=2,
        nets=[base, up])
    finite("path M base", outs_m[0], (M_BATCH, 64, 64, 3))
    finite("path M upsampled", outs_m[1], (M_BATCH, 256, 256, 3))
    again, _, _, walls["m"] = run(
        "path M, repeat call (replays)",
        lambda: pipe_m.sample(labels_m, batch=M_BATCH, generator=gen(68), return_all_stages=True),
        {name: 0 for name in REPLACES}, captures=0, nets=[base, up])
    d, r = rel_err(again[1], outs_m[1])
    log(f"    replayed vs first call: max|d| {d:.3e}, /max|x| {r:.3e}")
    if not r <= GRAPH_BOUND:
        fail("path M: the replayed cascade disagrees with its first call")
    del base, up, pipe_m
    small = dict(model_channels=32, num_res_blocks=1, attention_resolutions=(2,),
                 channel_mult=(1, 2), num_head_channels=32)
    tb_cfg = dataclasses.replace(base_cfg, image_size=8, **small)
    tu_cfg = dataclasses.replace(up_cfg, image_size=16, **small)
    tb = twins(lambda where: ADMUNet(tb_cfg, device=where), 69)
    tu = twins(lambda where: ADMUNet(tu_cfg, device=where), 70)
    draws = [cascade(None, None, 4, 8, 16).stage_noise(i, 2, gen(71, cpu)) for i in range(2)]
    card_vs_cpu("path M (fp32, tiny two-stage cascade, b2, 4 steps each, the card's graphed)", {
        key: cascade(tb[key], tu[key], 4, 8, 16).sample(
            labels_m[:2].to(where), batch=2,
            noise=[{k: v.to(where) for k, v in d.items()} for d in draws])
        for key, where in places.items()})
    log(f"path M done in {time.perf_counter() - t_path:.1f} s")

    # ---- N: knn2img on rdm_768 over a 10^6 x 768 database -----------------------
    t_path = time.perf_counter()
    ucfg_n, vcfg_n = ADMConfig.rdm_768(), VAEConfig.rdm_768()
    gh = gen(72)   # the state dict drawn on the card: 1.3G parameters
    ckpt = {f"model.diffusion_model.{k}": v for k, v in
            init_random_(ADMUNet(ucfg_n, device=dev), gh).state_dict().items()}
    ckpt.update({f"first_stage_model.{k}": v for k, v in
                 init_random_(AutoencoderKL(vcfg_n, device=dev), gh).state_dict().items()})
    model_n = load_sd_checkpoint(ckpt, preset="rdm_768", compute_dtype=bf16, device=dev)
    del ckpt
    clip_tmp = Path(tempfile.mkdtemp(prefix="clip_joint_"))
    try:
        embedder = FrozenCLIPTextJointEmbedder(write_clip_text_dir(clip_tmp, 73, joint=True),
                                               device=dev)
    finally:
        shutil.rmtree(clip_tmp, ignore_errors=True)
    db = torch.randn((N_DB, ucfg_n.context_dim), generator=gen(74), device=dev)
    searcher = Searcher({"embedding": db, "img_id": torch.arange(N_DB, device=dev)}, device=dev)
    torch.cuda.synchronize()
    n_unet, n_vae = (sum(p.numel() for p in net.parameters())
                     for net in (model_n.unet, model_n.vae))
    log(f"path N: knn2img on rdm_768 (UNet {n_unet / 1e6:.2f}M params, KL-f16 "
        f"{n_vae / 1e6:.2f}M, bf16, "
        f"load_sd_checkpoint on a synthesised state dict), FrozenCLIPTextJointEmbedder at "
        f"ViT-L/14's text width, a seeded {N_DB} x {ucfg_n.context_dim} fp32 database "
        f"({db.numel() * 4 / 1e9:.2f} GB on the card), {len(SD_PROMPTS)} prompts, k {N_K}, "
        f"{N_SIZE} px, CFG {N_SCALE}, {N_STEPS} steps, graphed")
    sampler_nl = per_forward(adm_unet_launches(ucfg_n), N_STEPS, N_STEPS)
    decode_n = per_forward(vae_decoder_launches(vcfg_n), 1)
    narrow_n = narrow_convs(model_n.vae.decoder)

    def knn_call():
        return knn2img(model_n, SD_PROMPTS, text_embedder=embedder, searcher=searcher, knn=N_K,
                       steps=N_STEPS, guidance_scale=N_SCALE, height=N_SIZE, width=N_SIZE,
                       generator=gen(75), return_nn_info=True)

    (img_n, info), launches["n"], routes["n"], walls["n_first"] = run(
        "path N, first call (warm call + capture)", knn_call,
        {name: 2 * sampler_nl[name] + decode_n[name] for name in REPLACES}, narrow=narrow_n,
        captures=1, nets=[model_n.unet, model_n.vae])
    finite("path N images", img_n, (len(SD_PROMPTS), N_SIZE, N_SIZE, 3))
    (img_n2, _), _, _, walls["n"] = run("path N, repeat call (replay)", knn_call, decode_n,
                                        narrow=narrow_n, captures=0,
                                        nets=[model_n.unet, model_n.vae])
    d, r = rel_err(img_n2, img_n)
    log(f"    replayed vs first call: max|d| {d:.3e}, /max|x| {r:.3e}")
    if not r <= GRAPH_BOUND:
        fail("path N: the replayed knn2img disagrees with its first call")
    times = [searcher.search(info["q_embeddings"], N_K)["exec_time"] for _ in range(5)]
    walls["n_search_s"] = statistics.median(times)
    log(f"  Searcher.search over {N_DB} rows, {len(SD_PROMPTS)} queries, k {N_K} on {smi}: median "
        f"{walls['n_search_s'] * 1e3:.3f} ms of 5 (all {[round(t * 1e3, 3) for t in times]}; "
        f"the first, in knn2img: {info['exec_time'] * 1e3:.3f} ms), host clock, product, top-k "
        f"and the read of the indices")
    t0 = time.perf_counter()
    positions, sets, bad = host_top_k_agrees(db, info["queries"], info["nns"], N_K, 1e-5)
    log(f"  top-{N_K} indices vs a float64 NumPy top-k on the host ({time.perf_counter() - t0:.1f}"
        f" s): {positions} positions and {sets} sets whose scores are more than 1e-5 apart, "
        f"{bad} mismatches")
    if bad or not positions:
        fail(f"path N: the card's top-k disagrees with the host's ({bad} mismatches)")
    del searcher, db, model_n
    gc.collect()   # the model and the sampler knn2img keeps on it hold each other
    torch.cuda.empty_cache()
    # a tiny RDM-shaped LDM in fp32, card vs CPU: the images and the neighbours
    z = 6
    tu_n = ADMConfig(image_size=8, in_channels=z, model_channels=32, out_channels=z,
                     num_res_blocks=1, attention_resolutions=(1, 2), channel_mult=(1, 2),
                     num_heads=1, use_spatial_transformer=True, transformer_depth=1,
                     context_dim=16)
    tv_n = VAEConfig.tiny(resolution=16, attn_resolutions=(), z_channels=z, embed_dim=z)
    tun = twins(lambda where: ADMUNet(tu_n, device=where), 76)
    tvn = twins(lambda where: AutoencoderKL(tv_n, device=where), 77)
    small_db = {"embedding": np.random.default_rng(78).standard_normal((64, 16)).astype(np.float32)}
    ctx = np.random.default_rng(79).standard_normal((2, 1, 16)).astype(np.float32)
    xt = torch.randn((2, 8, 8, z), generator=gen(80, cpu))
    res, nns = {}, {}
    for key, where in places.items():
        res[key], info = knn2img(
            LatentDiffusion(tun[key], tvn[key]), ["a", "b"], text_embedder=lambda p: ctx,
            searcher=Searcher(small_db, device=where), knn=4, steps=4, guidance_scale=N_SCALE,
            height=16, width=16, x_T=xt.to(where), return_nn_info=True)
        nns[key] = info["nns"]
    if not np.array_equal(nns["cuda"], nns["cpu"]):
        fail("path N: the card's and the CPU's Searcher pick different neighbours")
    card_vs_cpu("path N (fp32, tiny RDM knn2img, b2, 4 steps, k 4)", res)
    log(f"path N done in {time.perf_counter() - t_path:.1f} s")
    f = 2 ** (len(vcfg_n.ch_mult) - 1)
    updates = [(M_BATCH, 64, 64, 3), (M_BATCH, 256, 256, 3),
               (len(SD_PROMPTS), N_SIZE // f, N_SIZE // f, vcfg_n.z_channels)]
    return dict(launches=launches, routes=routes, walls=walls, specs=specs, updates=updates)


# --------------------------------------------------------------------------- #
# paths O and P: first-stage training and evaluation
# --------------------------------------------------------------------------- #


def record_training_specs(run) -> tuple:
    """run() under a global forward pre-hook (the runs build their modules
    inside themselves): (its result, Counter of (kernel, spec) -> launches).
    A Conv3x3 forward is one conv3x3 launch at (b, h, w, c, co), and one
    conv3x3_dx in the backward where grad mode is on and its input requires
    grad; a single-head VAE or DDPM attention at (b, t, t, 1, c, q/k/v as
    column slices of one projection) is one token_attention launch, or, with
    grad on and its parameters trained, attention_lse, attention_dq and
    attention_dkv one each."""
    import torch

    from dpm_solver_tpu_torch import ops
    from dpm_solver_tpu_torch.models.ddpm_unet import AttnBlock
    from dpm_solver_tpu_torch.models.vae import VAEAttnBlock

    seen = Counter()

    def pre(mod, args):
        if isinstance(mod, ops.Conv3x3):
            x = args[0]
            spec = (*x.shape, mod.weight.shape[0])
            seen["conv3x3", spec] += 1
            if torch.is_grad_enabled() and x.requires_grad:
                seen["conv3x3_dx", spec] += 1
        elif isinstance(mod, (VAEAttnBlock, AttnBlock)):
            b, h, w, c = args[0].shape
            spec = (b, h * w, h * w, 1, c, isinstance(mod, VAEAttnBlock))
            if torch.is_grad_enabled() and any(p.requires_grad for p in mod.parameters()):
                for name in ("attention_lse", "attention_dq", "attention_dkv"):
                    seen[name, spec] += 1
            else:
                seen["token_attention", spec] += 1

    handle = torch.nn.modules.module.register_module_forward_pre_hook(pre)
    try:
        return run(), seen
    finally:
        handle.remove()


def first_stage_and_eval(dev, smi: str) -> dict:
    """Paths O and P (phase 7f): full width, seeded random weights, steps
    and rounds cut (PERF.md section 4). O: `run_lib.train_autoencoder` on
    KL-f8 and VQ-f4, each counted (launches against the configs, by route
    "f32"), timed and hooked; the KL run's restart bitwise equal to an
    uninterrupted one; one KL and one VQ step, card against CPU. P:
    `run_lib.train` writes two checkpoints, `run_lib.evaluate` runs the
    DPM-Solver++ sampling hook, the FID Inception, the eps-MSE loss and
    FID/IS over both; a run stopped after the second checkpoint's first
    round resumes to the uninterrupted run's IS and FID; Inception's
    features card against CPU. Returns each run's launches, routes, walls
    and kernel specs, and the checks' numbers."""
    import numpy as np
    import torch

    import dpm_solver_tpu_torch as P
    from dpm_solver_tpu_torch import configs as port_configs
    from dpm_solver_tpu_torch import ops, run_lib
    from dpm_solver_tpu_torch.eval.inception import FIDInceptionV3, random_feature_params
    from dpm_solver_tpu_torch.models import (AutoencoderKL, DDPMUNet, VAEConfig, VQModel,
                                             init_random_)
    from dpm_solver_tpu_torch.models.discriminator import NLayerDiscriminator
    from dpm_solver_tpu_torch.models.init import init_train_
    from dpm_solver_tpu_torch.models.lpips import LPIPS
    from dpm_solver_tpu_torch.training import autoencoder as tae
    from dpm_solver_tpu_torch.training import perceptual as tper
    from dpm_solver_tpu_torch.training.checkpoints import (CheckpointManager, EvalMeta,
                                                           save_eval_meta)
    from dpm_solver_tpu_torch.training.train import antithetic_times

    launches, routes, walls, specs, checks = {}, {}, {}, {}, {}
    cpu = torch.device("cpu")
    torch.set_grad_enabled(True)
    log_lines = []

    class Steps(logging.Handler):   # the first-stage loop's per-step log lines
        def emit(self, record):
            if record.msg.startswith("step %d nll"):
                log_lines.append(record.args)

    handler, run_log = Steps(), logging.getLogger("dpm_solver_tpu_torch")
    run_log.addHandler(handler)
    run_log.setLevel(logging.INFO)

    def counted(what, call, expected, route=None, captures=None):
        """One counted call: its launches against `expected` (and, with
        `route`, every launch on it; bf16 takes check_routes), the CUDA-graph
        captures against `captures`, the hooks' specs against its launches.
        Returns (result, launches, routes, specs)."""
        ops.reset_launch_counts()
        made = P.GraphedSampler.captures
        out, seen = record_training_specs(call)
        torch.cuda.synchronize()
        got, by_route = ops.launch_counts(), ops.launch_routes()
        made = P.GraphedSampler.captures - made
        log(f"  {what}: launches {got} (expected {expected})"
            + ("" if captures is None else f", {made} capture(s) (expected {captures})"))
        if got != expected or (captures is not None and made != captures):
            fail(f"{what}: launches {got} != {expected}, or {made} captures")
        if route is None:
            check_routes(what, got, by_route)
        else:
            want = {k: ({route: got[k]} if got[k] else {}) for k in by_route}
            log(f"  launches by route {by_route} (expected {want})")
            if by_route != want:
                fail(f"{what}: launches by route {by_route} != {want}")
        for name in set(REPLACES) - {"fused_update"}:
            n = sum(k for (kernel, _), k in seen.items() if kernel == name)
            if n != got[name]:
                fail(f"{what}: the hooks recorded {n} {name} launches of its {got[name]}")
        return out, got, by_route, seen

    def ae_step_launches(cfg) -> dict:
        """One adversarial step (fp32): the encoder, the decoder trunk and
        conv_out forward once, conv_out again for the adaptive weight (on
        the detached trunk: no dx); a dx for every conv but the encoder's
        conv_in (its input, the images, takes no gradient) and that second
        conv_out; each attention keeps its lse and runs one dq and one
        dk/dv. LPIPS and the discriminator are library convs."""
        enc, dec = vae_encoder_launches(cfg), vae_decoder_launches(cfg)
        attn = enc["token_attention"] + dec["token_attention"]
        out = {name: 0 for name in REPLACES}
        out.update(conv3x3=enc["conv3x3"] + dec["conv3x3"] + 1,
                   conv3x3_dx=enc["conv3x3"] - 1 + dec["conv3x3"], attention_lse=attn,
                   attention_dq=attn, attention_dkv=attn)
        return out

    def batches(rng, n, b, size):
        return [torch.tensor(rng.uniform(-1.0, 1.0, (b, size, size, 3)), dtype=torch.float32)
                for _ in range(n)]

    class Timed:
        """The loop's batches, with the host clock (after a synchronize) each
        time the loop asks for one: a step's wall is the gap to the next."""

        def __init__(self, items):
            self.items, self.stamps = iter(items), []

        def __iter__(self):
            return self

        def __next__(self):
            torch.cuda.synchronize()
            self.stamps.append(time.perf_counter())
            return next(self.items)

        def step_ms(self):
            torch.cuda.synchronize()
            s = self.stamps + [time.perf_counter()]
            return [(b - a) * 1e3 for a, b in zip(s, s[1:])]

    o_rng = np.random.default_rng(TRAIN_SEED + 2)
    o_dir = Path(tempfile.mkdtemp(prefix="path_o_"))

    def train_ae(kind, cfg, data, workdir, max_steps, preempt=10 ** 9, **kw):
        return run_lib.train_autoencoder(
            data, workdir=str(workdir), kind=kind, vae_config=cfg, n_embed=O_CODES,
            lr=O_LR, max_steps=max_steps, log_freq=1, snapshot_freq=10 ** 9,
            snapshot_freq_for_preemption=preempt, seed=TRAIN_SEED, device=dev, **kw)

    def timed_ae(what, kind, cfg, b, steps):
        """A warm step and `steps` timed ones, counted: ms a step (the median
        after the warm one), images/s, peak memory."""
        data = Timed(batches(o_rng, steps + 1, b, cfg.resolution))
        log_lines.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 2 ** 30
        state, got, by_route, seen = counted(
            what, lambda: train_ae(kind, cfg, data, o_dir / kind, steps + 1),
            scaled(ae_step_launches(cfg), steps + 1), route="f32")
        ms = data.step_ms()
        med = statistics.median(ms[1:])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        finite = all(math.isfinite(v) for line in log_lines for v in line[1:])
        if state.step != steps + 1 or len(log_lines) != steps + 1 or not finite or not all(
                torch.isfinite(p).all() for p in state.gen_params.values()):
            fail(f"{what}: {state.step} steps, logs {log_lines}: not {steps + 1} finite steps")
        walls[what] = dict(step_ms=med, step_ms_all=ms, images_per_s=b / med * 1e3,
                           peak_gib=peak, peak_above_start_gib=peak - base, batch=b,
                           steps=steps, nll=[line[1] for line in log_lines],
                           disc=[line[2] for line in log_lines])
        log(f"  {what} on {smi}: median step {med:.2f} ms of {steps} after a warm one (all "
            f"{[round(v, 2) for v in ms]}) -> {b / med * 1e3:.3f} images/s; peak memory "
            f"{peak:.2f} GiB ({peak - base:.2f} above the {base:.2f} held before); nll "
            f"{[round(v, 4) for v in walls[what]['nll']]}, disc loss "
            f"{[round(v, 4) for v in walls[what]['disc']]}")
        return state, got, by_route, seen

    # ---- O: KL-f8 (sd_v1, 256 px), b12, KLLossConfig(): disc_start 0 ----------
    t_path = time.perf_counter()
    kl_cfg = VAEConfig.sd_v1()
    n_ae = sum(p.numel() for p in AutoencoderKL(kl_cfg, device="meta").parameters())
    n_disc = sum(p.numel() for p in NLayerDiscriminator(device="meta").parameters())
    n_lpips = sum(p.numel() for p in LPIPS(device="meta").parameters())
    log(f"path O: run_lib.train_autoencoder(kind='kl') on KL-f8 (VAEConfig.sd_v1(), "
        f"{n_ae / 1e6:.2f}M params, {kl_cfg.resolution} px, fp32), KLLossConfig() (disc_start "
        f"0), LPIPS ({n_lpips / 1e6:.2f}M, random init) and NLayerDiscriminator(64, 3) "
        f"({n_disc / 1e6:.2f}M, BatchNorm); Adam(lr {O_LR:g}, b1 0.5, b2 0.9) both; "
        f"b{O_KL_BATCH}, a warm step and {O_KL_STEPS} timed")
    _, launches["o"], routes["o"], specs["o"] = timed_ae("O kl", "kl", kl_cfg, O_KL_BATCH,
                                                         O_KL_STEPS)
    torch.cuda.empty_cache()
    # the restart: under cuDNN's deterministic algorithms (the library convs
    # of LPIPS, the discriminator and the conv weight gradients), an
    # uninterrupted O_RESTART_STEPS-step run, and a run killed after
    # O_RESUME_AT steps (its meta checkpoint at loop index O_RESUME_AT - 1),
    # restarted: bitwise equal at the end
    torch.backends.cudnn.deterministic = True
    data = batches(o_rng, O_RESTART_STEPS, O_KL_BATCH, kl_cfg.resolution)

    def on_host(st):   # the state's tensors by name, copied to the host
        out = {f"{g}.{k}": v.detach().cpu() for g in ("gen_params", "disc_params",
                                                      "disc_batch_stats")
               for k, v in getattr(st, g).items()}
        out.update({f"{g}.{m}.{k}": v.cpu() for g in ("gen_opt", "disc_opt") for m in ("mu", "nu")
                    for k, v in getattr(st, g)[m].items()})
        return st.step, st.gen_opt["count"], out

    whole = on_host(train_ae("kl", kl_cfg, iter(data), o_dir / "whole", O_RESTART_STEPS))
    torch.cuda.empty_cache()
    train_ae("kl", kl_cfg, iter(data), o_dir / "killed", O_RESUME_AT, O_RESUME_AT - 1)
    meta = CheckpointManager(str(o_dir / "killed" / "checkpoints-meta"))
    if meta.all_steps() != [O_RESUME_AT - 1]:
        fail(f"path O: meta checkpoints {meta.all_steps()}, expected [{O_RESUME_AT - 1}]")
    resumed = on_host(train_ae("kl", kl_cfg, iter(data[O_RESUME_AT:]), o_dir / "killed",
                               O_RESTART_STEPS, O_RESUME_AT - 1))
    torch.backends.cudnn.deterministic = False
    differ = [k for k, v in whole[2].items() if not torch.equal(v, resumed[2][k])]
    log(f"  path O restart: resumed vs uninterrupted at step {whole[0]}: {len(whole[2])} "
        f"tensors (parameters, logvar, both Adam states, BatchNorm statistics), "
        f"{len(differ)} differ {'ok' if not differ else 'FAIL ' + str(differ[:5])}")
    if whole[:2] != resumed[:2] or set(whole[2]) != set(resumed[2]) or differ:
        fail("path O: the resumed first-stage run is not bitwise equal to the uninterrupted one")
    checks["o_restart_tensors"] = len(whole[2])
    del whole, resumed
    torch.cuda.empty_cache()

    # ---- O: VQ-f4 (vq_cin256, 8192 codes, 256 px), b8, VQLossConfig() ----------
    vq_cfg = VAEConfig.vq_cin256()
    log(f"path O: run_lib.train_autoencoder(kind='vq') on VQ-f4 (VAEConfig.vq_cin256(), "
        f"{O_CODES} codes, {vq_cfg.resolution} px, fp32), VQLossConfig(); b{O_VQ_BATCH}, a "
        f"warm step and {O_VQ_STEPS} timed")
    _, launches["o_vq"], routes["o_vq"], specs["o_vq"] = timed_ae(
        "O vq", "vq", vq_cfg, O_VQ_BATCH, O_VQ_STEPS)
    shutil.rmtree(o_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- O: one KL and one VQ step, card (kernels) vs CPU (plain), fp32 ---------
    def ae_twins(kind, cfg, seed):
        """The autoencoder, discriminator and LPIPS on the card and on the CPU
        with the same weights: `init_random_` for the autoencoder (no layer
        left at zero) and the discriminator, LPIPS' Flax-default init."""
        build = {"kl": lambda w: AutoencoderKL(cfg, device=w),
                 "vq": lambda w: VQModel(cfg, n_embed=O_CODES, device=w)}[kind]
        g = torch.Generator().manual_seed(seed)
        parts = [init_random_(build(cpu), g), init_random_(NLayerDiscriminator(device=cpu), g),
                 init_train_(LPIPS(device=cpu), g)]
        out = {"cpu": parts}
        out["cuda"] = [build(dev), NLayerDiscriminator(device=dev), LPIPS(device=dev)]
        for a, c in zip(out["cuda"], parts):
            a.load_state_dict(c.state_dict())
        return out

    def state_of(st):
        g = {f"gen.{k}": v.detach().cpu() for k, v in st.gen_params.items()}
        g.update({f"disc.{k}": v.detach().cpu() for k, v in st.disc_params.items()})
        stats = {k: v.cpu() for k, v in st.disc_batch_stats.items()}
        mom = {}
        for o in ("gen_opt", "disc_opt"):
            for m in ("mu", "nu"):
                for k, v in getattr(st, o)[m].items():
                    mom[f"{o}.{m}.{k}"] = (v.sqrt() if m == "nu" else v).cpu()
        return g, stats, mom

    def ae_card_vs_cpu(what, kind, cfg, loss_cfg, seed):
        """One adversarial step at b2 on both sides from the same weights and
        draws: each group (parameters and logvar; BatchNorm statistics; Adam's
        mu and sqrt(nu), the gradient's units) within SLICE_BOUND of the
        group's largest element, and the logs within SLICE_BOUND. Leaves whose
        gradient is 0 by construction (the attention's key biases) are
        rounding noise on both sides: held absolutely (their moments within
        SLICE_BOUND / 100 of the largest, their parameters within 4 lr)."""
        nets = ae_twins(kind, cfg, seed)
        x = torch.tensor(o_rng.uniform(-1, 1, (2, cfg.resolution, cfg.resolution, 3)),
                         dtype=torch.float32)
        f = 2 ** (len(cfg.ch_mult) - 1)
        noise = torch.randn(2, cfg.resolution // f, cfg.resolution // f, cfg.embed_dim,
                            generator=torch.Generator().manual_seed(seed + 1))
        res = {}
        for key, where in (("cpu", cpu), ("cuda", dev)):
            t1 = time.perf_counter()
            ae, disc, lp = nets[key]
            state, tx = tae.make_adversarial_state(ae, disc, lr=O_LR)
            fns = tae.bind_autoencoder(ae, disc, lp)
            if kind == "kl":
                step = tae.make_kl_train_step(loss_cfg, tx=tx, **fns)
                state, logs = step(state, x.to(where), TRAIN_SEED, noise=noise.to(where))
            else:
                step = tae.make_vq_train_step(loss_cfg, tx=tx, n_embed=O_CODES, **fns)
                state, logs = step(state, x.to(where), TRAIN_SEED)
            res[key] = (state_of(state), {k: float(v) for k, v in logs.items()})
            log(f"  {what}: step on {where} ({time.perf_counter() - t1:.1f} s)")
        (pc, sc, mc), lc = res["cuda"]
        (pp, sp, mp), lp_ = res["cpu"]
        out, zero = {}, 0
        for group, got, want in (("params", pc, pp), ("statistics", sc, sp), ("moments", mc, mp)):
            top = max(float(v.abs().max()) for v in want.values())
            worst = 0.0
            for k, v in want.items():
                d = float((got[k] - v).abs().max())
                if re.search(r"\.k\.bias$", k):   # zero by construction
                    zero += group == "params"
                    lim = 4 * O_LR if group == "params" else SLICE_BOUND / 100 * top
                else:
                    lim = SLICE_BOUND * top
                worst = max(worst, d / lim)
            out[group] = worst
        r_logs = max(abs(lc[k] - lp_[k]) / max(abs(lp_[k]), 1e-6) for k in lp_)
        ok = all(v <= 1.0 for v in out.values()) and r_logs <= SLICE_BOUND and set(lc) == set(lp_)
        log(f"  {what}, card vs CPU: parameters at {out['params']:.3f}, BatchNorm statistics "
            f"at {out['statistics']:.3f}, Adam moments at {out['moments']:.3f} of their bound "
            f"(SLICE_BOUND {SLICE_BOUND:g} of each group's largest; the {zero} key biases, "
            f"zero-gradient leaves, held absolutely); logs /|x| {r_logs:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{what}: the fp32 adversarial step on the card disagrees with the CPU's")
        out["logs_rel"] = r_logs
        return out

    small_kl = dataclasses.replace(kl_cfg, resolution=O_CHECK_SIZE)
    small_vq = dataclasses.replace(vq_cfg, resolution=O_CHECK_SIZE)
    checks["o_kl_card_vs_cpu"] = ae_card_vs_cpu(
        f"path O, KL-f8 at full width, {O_CHECK_SIZE} px, b2", "kl", small_kl,
        tper.KLLossConfig(), TRAIN_SEED + 3)
    # the VQ step without LPIPS: the encoder's gradient reaches LPIPS' ReLUs
    # through the straight-through estimator, where a pre-activation at 0
    # moves it in steps (tests/test_torch_autoencoder_train.py's LOSS)
    checks["o_vq_card_vs_cpu"] = ae_card_vs_cpu(
        f"path O, VQ-f4 at full width, {O_CHECK_SIZE} px, b2, {O_CODES} codes, no LPIPS", "vq",
        small_vq, tper.VQLossConfig(perceptual_weight=0.0), TRAIN_SEED + 4)
    walls["o_s"] = time.perf_counter() - t_path
    log(f"path O done in {walls['o_s']:.1f} s")
    torch.cuda.empty_cache()

    # ---- P: run_lib.train writes two checkpoints; run_lib.evaluate over them -------
    t_path = time.perf_counter()
    p_cfg = port_configs.get_config("cifar10_ddpm")
    p_dir = Path(tempfile.mkdtemp(prefix="path_p_"))
    p_cfg = dataclasses.replace(
        p_cfg, workdir=str(p_dir), training=dataclasses.replace(
            p_cfg.training, continuous=False, log_freq=10 ** 9, snapshot_freq=1,
            snapshot_freq_for_preemption=10 ** 9))
    b_eval, b_train = p_cfg.eval.batch_size, p_cfg.training.batch_size
    side = p_cfg.data.image_size
    p_rng = np.random.default_rng(TRAIN_SEED + 5)
    log(f"path P: run_lib.train on cifar10_ddpm (eps-MSE, b{b_train}, bf16) for "
        f"{P_TRAIN_STEPS} steps (checkpoints at loop indices 1 and 2); run_lib.evaluate over "
        f"both, {P_ROUNDS} rounds each at the config's eval batch {b_eval}: DPM-Solver++ "
        f"{ORDER}M {STEPS} NFE graphed on the EMA parameters (bf16), FIDInceptionV3 at 299 px "
        f"from random_feature_params (fp32, in chunks of {P_CHUNK}), the eps-MSE loss at "
        f"b{P_LOSS_BATCH}, FID against seeded images' statistics")
    data = p_rng.uniform(-1.0, 1.0, (P_TRAIN_STEPS, b_train, side, side, 3)).astype(np.float32)
    _, launches["p_train"], routes["p_train"], specs["p_train"] = counted(
        "path P, run_lib.train", lambda: run_lib.train(p_cfg, iter(data),
                                                       max_steps=P_TRAIN_STEPS,
                                                       compute_dtype=torch.bfloat16, device=dev),
        scaled(train_launches(Counter(conv3x3=47, token_attention=6)), P_TRAIN_STEPS))
    if CheckpointManager(str(p_dir / "checkpoints")).all_steps() != [1, 2]:
        fail("path P: run_lib.train did not write checkpoints 1 and 2")
    torch.set_grad_enabled(False)

    net = DDPMUNet(p_cfg.model_config, compute_dtype=torch.bfloat16, device=dev).eval()
    ns = P.NoiseScheduleVP.discrete(betas=p_cfg.diffusion.betas())
    solver = P.DPM_Solver(P.model_wrapper(net, ns, model_type="noise"), ns,
                          algorithm_type="dpmsolver++")
    sample_kw = dict(steps=STEPS, order=ORDER, method="multistep", skip_type="logSNR")
    inception = FIDInceptionV3(device=dev).eval()
    inception.load_state_dict(random_feature_params(TRAIN_SEED))
    spans = {"sample": [], "features": []}
    first_round = []
    params = dict(net.named_parameters())

    def sample_fn(state, generator):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for k, v in state.ema_params.items():
            params[k].copy_(v)
        x = torch.randn(b_eval, side, side, 3, generator=generator, device=dev)
        out = (solver.sample(x, jit=True, **sample_kw).clamp(-1.0, 1.0) + 1.0) / 2.0
        torch.cuda.synchronize()
        spans["sample"].append(time.perf_counter() - t1)
        if not first_round:  # path Q's FID folder (phase 7g), quantised as PNG samples are
            first_round.append((out * 255).clamp(0, 255).to(torch.uint8).cpu().numpy())
        return out

    def feature_fn(images):
        t1 = time.perf_counter()
        feats, logits = zip(*(inception(images[i:i + P_CHUNK])
                              for i in range(0, len(images), P_CHUNK)))
        out = torch.cat(feats), torch.cat(logits)
        torch.cuda.synchronize()
        spans["features"].append(time.perf_counter() - t1)
        return out

    def loss_fn(state, generator):
        for k, v in state.ema_params.items():
            params[k].copy_(v)
        x0 = torch.rand(P_LOSS_BATCH, side, side, 3, generator=generator, device=dev) * 2 - 1
        t = antithetic_times(generator, P_LOSS_BATCH, 1000)
        eps = torch.randn(x0.shape, generator=generator, device=dev)
        ab = torch.cumprod(1.0 - torch.tensor(p_cfg.diffusion.betas(), device=dev), 0).float()
        a = ab[t].sqrt()[:, None, None, None]
        xt = a * x0 + (1.0 - ab[t]).sqrt()[:, None, None, None] * eps
        return torch.mean(torch.sum((eps - net(xt, t.float()).float()) ** 2, dim=(1, 2, 3)))

    # the reference statistics: the features of seeded images in [0, 1]
    ref = torch.rand(P_REF_IMAGES, side, side, 3, generator=torch.Generator(device=dev)
                     .manual_seed(TRAIN_SEED + 6), device=dev)
    ref_feats = feature_fn(ref)[0].double().cpu().numpy()
    spans["features"].clear()
    stats_path = p_dir / "ref_stats.npz"
    np.savez(stats_path, mu=ref_feats.mean(0), sigma=np.cov(ref_feats, rowvar=False))
    e_cfg = dataclasses.replace(p_cfg, eval=dataclasses.replace(p_cfg.eval,
                                                                fid_stats_path=str(stats_path)))
    hooks = dict(sample_fn=sample_fn, feature_fn=feature_fn, loss_fn=loss_fn)
    sampler = per_forward(Counter(conv3x3=47, token_attention=6), STEPS, STEPS)
    loss_fwd = per_forward(Counter(conv3x3=47, token_attention=6), 1)
    # deterministic cuDNN for Inception's convs: the resumed run's features
    # must be the uninterrupted run's bits
    torch.backends.cudnn.deterministic = True
    t1 = time.perf_counter()
    whole, launches["p"], routes["p"], specs["p"] = counted(
        "path P, run_lib.evaluate (2 checkpoints x 2 rounds)",
        lambda: run_lib.evaluate(e_cfg, rounds=P_ROUNDS, device=dev, **hooks),
        {name: 2 * sampler[name] + 2 * loss_fwd[name] for name in REPLACES}, captures=1)
    walls["p_evaluate_s"] = time.perf_counter() - t1
    rounds_s = [a + b for a, b in zip(spans["sample"][1:], spans["features"][1:])]
    walls.update(p_round_s=statistics.median(rounds_s),
                 p_sample_s=statistics.median(spans["sample"][1:]),
                 p_features_s=statistics.median(spans["features"][1:]),
                 p_first_round_s=spans["sample"][0] + spans["features"][0],
                 p_sample_all_s=list(spans["sample"]), p_features_all_s=list(spans["features"]))
    log(f"  path P on {smi}: {walls['p_evaluate_s']:.2f} s for the evaluation; a round "
        f"{walls['p_round_s']:.3f} s (median of the {len(rounds_s)} after the first, which "
        f"captures the sampler: {walls['p_first_round_s']:.3f} s): sampling "
        f"{walls['p_sample_s']:.3f} s ({b_eval / walls['p_sample_s']:.1f} samples/s), features "
        f"{walls['p_features_s']:.3f} s ({b_eval / walls['p_features_s']:.1f} images/s); "
        f"results {whole}")
    if sorted(whole) != [1, 2] or not all(
            math.isfinite(e[k]) for e in whole.values() for k in ("loss", "inception_score",
                                                                   "fid")):
        fail(f"path P: evaluate returned {whole}, not finite loss, IS and FID for 1 and 2")
    # the same evaluation stopped by its hook after checkpoint 2's first
    # round, then resumed from its EvalMeta: the same IS and FID. It starts
    # where a run stands once checkpoint 1 is done (the EvalMeta evaluate
    # writes then; checkpoint 2's round files gone), so that checkpoint 1's
    # FID, the host's 2,048 x 2,048 square root, is not computed again
    for f in (p_dir / "eval").glob("stats_ckpt2_*"):
        f.unlink()
    save_eval_meta(EvalMeta(ckpt_id=2), str(p_dir / "eval"))

    class Stop(Exception):
        pass

    def stopping(state, generator):
        if int(state.step) == 3 and len(spans["sample"]) == 1:
            raise Stop
        return sample_fn(state, generator)

    spans["sample"].clear()
    try:
        run_lib.evaluate(e_cfg, rounds=P_ROUNDS, device=dev, **dict(hooks, sample_fn=stopping))
        fail("path P: the stopping hook did not stop the evaluation")
    except Stop:
        pass
    meta = json.loads((p_dir / "eval" / "eval_meta_host0.json").read_text())
    resumed, launches["p_resume"], _, _ = counted(
        "path P, resumed run_lib.evaluate", lambda: run_lib.evaluate(
            e_cfg, rounds=P_ROUNDS, device=dev, **hooks), loss_fwd, captures=0)
    torch.backends.cudnn.deterministic = False
    same = {k: resumed[2][k] == whole[2][k] for k in ("inception_score", "fid", "loss")}
    log(f"  path P resume: stopped at {meta}; resumed checkpoint 2: IS "
        f"{resumed[2]['inception_score']!r} vs {whole[2]['inception_score']!r}, FID "
        f"{resumed[2]['fid']!r} vs {whole[2]['fid']!r} "
        f"{'equal' if all(same.values()) else 'DIFFERENT'}")
    if list(resumed) != [2] or (meta["ckpt_id"], meta["sampling_round_id"]) != (2, 0) \
            or not all(same.values()):
        fail("path P: the resumed evaluation disagrees with the uninterrupted one")
    checks["p_results"] = {str(k): v for k, v in whole.items()}
    # Inception's features, card vs CPU, fp32 (TF32 off): b4 at 32 px
    x4 = torch.rand(4, side, side, 3, generator=torch.Generator().manual_seed(TRAIN_SEED + 7))
    cpu_inc = FIDInceptionV3(device=cpu).eval()
    cpu_inc.load_state_dict(inception.state_dict())
    errs = []
    for got, want in zip(inception(x4.to(dev)), cpu_inc(x4)):
        errs.append(rel_err(got.cpu(), want)[1])
    ok = max(errs) <= SLICE_BOUND
    log(f"  path P: FIDInceptionV3 features and logits, card vs CPU, fp32, b4 at {side} px: "
        f"/max|x| {errs[0]:.3e}, {errs[1]:.3e} (bound {SLICE_BOUND:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("path P: Inception's features on the card disagree with the CPU's")
    checks["p_inception_rel"] = errs
    shutil.rmtree(p_dir, ignore_errors=True)
    del net, solver, inception, cpu_inc
    torch.cuda.empty_cache()
    walls["p_s"] = time.perf_counter() - t_path
    log(f"path P done in {walls['p_s']:.1f} s")
    run_log.removeHandler(handler)
    return dict(launches=launches, routes=routes, walls=walls, specs=specs, checks=checks,
                eval_batch=b_eval, p_samples=first_round[0])


def _ld(field: int, payload: bytes) -> bytes:
    """A length-delimited protobuf field."""
    out, n = bytes([field << 3 | 2]), len(payload)
    while True:
        out += bytes([n & 0x7F | (0x80 if n >> 7 else 0)])
        n >>= 7
        if not n:
            return out + payload


def raw_record(img_chw) -> bytes:
    """A tf.train.Example in FFHQ's raw layout: {'shape': int64[3] (C, H, W),
    'data': CHW uint8 bytes}."""
    shape = b"".join(bytes([v]) if v < 128 else bytes([v & 0x7F | 0x80, v >> 7])
                     for v in img_chw.shape)
    data = _ld(1, _ld(1, img_chw.tobytes()))
    return _ld(1, _ld(1, _ld(1, b"data") + _ld(2, data))
               + _ld(1, _ld(1, b"shape") + _ld(2, _ld(3, _ld(1, shape)))))


def write_tfrecord(path: Path, payloads, crc32c) -> None:
    """TFRecord framing: u64 length, masked CRC32C of it, payload, masked
    CRC32C of the payload."""
    import struct

    mask = lambda c: (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF  # noqa: E731
    with open(path, "wb") as f:
        for p in payloads:
            head = struct.pack("<Q", len(p))
            f.write(head + struct.pack("<I", mask(crc32c(head))))
            f.write(p + struct.pack("<I", mask(crc32c(p))))


def data_path(dev, smi: str, p_samples) -> dict:
    """Path Q (phase 7g): real-format datasets written to a temporary
    directory, read through the port's readers (host work: numpy, torch on
    the CPU and the native host-IO libraries), feeding `run_lib.train` at
    full width, and the FID folder route on the card's Inception. Returns
    the launches and routes of the data-fed training run, the walls and
    rates, and the checks."""
    import os
    import pickle
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from dpm_solver_tpu_torch import configs as port_configs
    from dpm_solver_tpu_torch import data as pdata
    from dpm_solver_tpu_torch import native, ops, run_lib
    from dpm_solver_tpu_torch.eval import fid as pfid
    from dpm_solver_tpu_torch.eval.inception import make_feature_fn, random_feature_params
    from dpm_solver_tpu_torch.native import build as nbuild
    from dpm_solver_tpu_torch.utils.lmdb import LMDBReader, write_lmdb

    nproc = os.cpu_count()
    probe = host_probe()
    rates, walls, checks = {}, {}, {"probe": probe}
    log(f"path Q: readers run here {list(Q_READERS)}; host nproc {nproc}, card {smi}")
    tmp = Path(tempfile.mkdtemp(prefix="path_q_"))
    rng = np.random.default_rng(TRAIN_SEED + 8)
    t_phase = time.perf_counter()
    try:
        t0 = time.perf_counter()
        for name in ("io", "png", "lmdb_walk"):
            nbuild.build(name)
        walls["host_build_s"] = time.perf_counter() - t0
        log(f"  the host-IO libraries (io, png, lmdb_walk) built by g++ in "
            f"{walls['host_build_s']:.1f} s")

        # ---- (a) CIFAR-10 at its real size into run_lib.train ------------------
        cifar = tmp / "cifar-10-batches-py"
        cifar.mkdir()
        t0 = time.perf_counter()
        for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
            with open(cifar / name, "wb") as f:
                pickle.dump({b"batch_label": name.encode(),
                             b"labels": rng.integers(0, 10, 10_000).tolist(),
                             b"data": rng.integers(0, 256, (10_000, 3072), dtype=np.uint8)},
                            f, protocol=4)
        walls["a_write_s"] = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in cifar.iterdir())
        t0 = time.perf_counter()
        images = pdata.load_cifar10_dir(str(cifar))
        test = pdata.load_cifar10_dir(str(cifar), train=False)
        walls["a_load_s"] = time.perf_counter() - t0
        if images.shape != (50_000, 32, 32, 3) or test.shape != (10_000, 32, 32, 3):
            fail(f"path Q (a): load_cifar10_dir gave {images.shape}, {test.shape}")
        log(f"  (a) CIFAR-10: {size / 1e6:.1f} MB of pickles written in {walls['a_write_s']:.2f} s, "
            f"read by load_cifar10_dir in {walls['a_load_s']:.2f} s")
        d_cfg = port_configs.get_config("cifar10_ddpm")
        d_cfg = dataclasses.replace(d_cfg, training=dataclasses.replace(
            d_cfg.training, continuous=False, log_freq=1, snapshot_freq=10 ** 9,
            snapshot_freq_for_preemption=10 ** 9))
        batch = d_cfg.training.batch_size
        loader = pdata.make_dataset(images, batch_size=batch, random_flip=True,
                                    centered=d_cfg.data.centered, seed=TRAIN_SEED)
        first = next(loader)
        if first.shape != (1, batch, 32, 32, 3) or first.dtype != np.float32 \
                or not -1.0 <= first.min() < first.max() <= 1.0:
            fail(f"path Q (a): make_dataset's batch {first.shape} {first.dtype} "
                 f"[{first.min()}, {first.max()}]")
        t0 = time.perf_counter()
        for _ in range(Q_LOADER_BATCHES):
            next(loader)
        rates["a_loader_images_per_s"] = Q_LOADER_BATCHES * batch / (time.perf_counter() - t0)
        log(f"  (a) make_dataset(b{batch}, flips, centred) alone, host nproc {nproc}: "
            f"{rates['a_loader_images_per_s']:.0f} images/s over {Q_LOADER_BATCHES} batches")

        per_step = train_launches(Counter(conv3x3=47, token_attention=6))
        torch.set_grad_enabled(True)

        def run(what, batches):
            """Q_STEPS counted steps of run_lib.train on the card, each step's
            wall from the host clock after a synchronize at each batch."""
            stamps = []

            def timed():
                for b in batches:
                    torch.cuda.synchronize()
                    stamps.append(time.perf_counter())
                    yield b

            with step_metrics() as steps_log:
                ops.reset_launch_counts()
                run_lib.train(d_cfg, timed(), workdir=str(tmp / what.split()[0]),
                              max_steps=Q_STEPS, compute_dtype=torch.bfloat16, device=dev)
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
                launches, routes = ops.launch_counts(), ops.launch_routes()
            expected = scaled(per_step, Q_STEPS)
            if launches != expected:
                fail(f"path Q (a) {what}: launches {launches} != {expected}")
            check_routes(f"path Q (a) {what}", launches, routes)
            if len(steps_log) != Q_STEPS or not all(math.isfinite(v) for m in steps_log
                                                    for v in m[1:]):
                fail(f"path Q (a) {what}: the steps' loss and grad norm {steps_log}")
            ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
            med = statistics.median(ms[1:])
            log(f"  (a) run_lib.train on cifar10_ddpm, {what}, b{batch} bf16, on {smi}: median "
                f"step {med:.2f} ms of {Q_STEPS - 1} after a warm one (all "
                f"{[round(v, 2) for v in ms]}) -> {batch / med * 1e3:.2f} images/s; launches "
                f"{launches}; loss {[round(m[1], 5) for m in steps_log]}")
            return med, ms, launches, routes

        data_ms, data_all, launches, routes = run("fed by make_dataset", loader)
        random = rng.uniform(-1.0, 1.0, (Q_STEPS, batch, 32, 32, 3)).astype(np.float32)
        random_ms, random_all, _, _ = run("random tensors", iter(random))
        torch.set_grad_enabled(False)
        walls.update(a_step_ms=data_ms, a_step_ms_all=data_all, a_random_step_ms=random_ms,
                     a_random_step_ms_all=random_all)
        rates.update(a_train_images_per_s=batch / data_ms * 1e3,
                     a_random_images_per_s=batch / random_ms * 1e3)
        log(f"  (a) data-fed step {data_ms:.2f} ms vs random tensors {random_ms:.2f} ms "
            f"({data_ms / random_ms:.3f}x)")
        del images, test, loader, random
        shutil.rmtree(cifar, ignore_errors=True)
        torch.cuda.empty_cache()

        # ---- (b) FFHQ's raw-CHW TFRecords at 256 px --------------------------------
        if native.crc32c(b"123456789") != 0xE3069283:
            fail("path Q (b): the native CRC32C's known answer")
        t0 = time.perf_counter()
        src = rng.integers(0, 256, (Q_FFHQ_RECORDS, 3, 256, 256), dtype=np.uint8)
        rec_path = tmp / "ffhq-r08.tfrecords"
        write_tfrecord(rec_path, (raw_record(im) for im in src), native.crc32c)
        walls["b_write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        offs, lens = native.tfrecord_index(str(rec_path))
        walls["b_index_s"] = time.perf_counter() - t0
        py_offs, py_lens = native._tfrecord_index_py(str(rec_path))
        if len(offs) != Q_FFHQ_RECORDS or not (np.array_equal(offs, py_offs)
                                               and np.array_equal(lens, py_lens)):
            fail("path Q (b): the C++ TFRecord index differs from the Python one")
        log(f"  (b) FFHQ raw layout: {Q_FFHQ_RECORDS} records, "
            f"{rec_path.stat().st_size / 1e6:.1f} MB, written in {walls['b_write_s']:.2f} s; "
            f"the C++ index (CRC32C checked) in {walls['b_index_s'] * 1e3:.1f} ms equals the "
            f"Python one; CRC32C's known answer ok")
        seed = TRAIN_SEED + 9
        for reader in ("tfrecord_dataset_native", "tfrecord_dataset"):
            it = getattr(pdata, reader)(str(rec_path), resolution=256, batch_size=Q_BATCH,
                                        uniform_dequantization=True, centered=True,
                                        random_flip=True, shuffle=True, seed=seed)
            got = next(it)
            # the same batch from numpy alone: one default_rng(seed) draws the
            # permutation, the flips, the dequantization noise
            want_rng = np.random.default_rng(seed)
            idx = want_rng.permutation(Q_FFHQ_RECORDS)[:Q_BATCH]
            want = src[idx].transpose(0, 2, 3, 1).astype(np.float32)
            want = want / 255.0 if reader == "tfrecord_dataset_native" else want * pdata._U8_SCALE
            flips = want_rng.random(Q_BATCH) < 0.5
            want[flips] = want[flips, :, ::-1]
            noise = (want_rng.random(want.shape).astype(np.float32)
                     if reader == "tfrecord_dataset_native"
                     else want_rng.random(want.shape, dtype=np.float32))
            want = ((noise + want * 255.0) / 256.0) * 2.0 - 1.0
            if not np.array_equal(got, want):
                fail(f"path Q (b): {reader}'s first batch differs from the numpy decode "
                     f"(max |d| {np.abs(got - want).max()})")
            t0 = time.perf_counter()
            for _ in range(Q_READ_BATCHES):
                next(it)
            rates[f"b_{reader}_images_per_s"] = Q_READ_BATCHES * Q_BATCH / (
                time.perf_counter() - t0)
            log(f"  (b) {reader}(256 px, b{Q_BATCH}, shuffle, flips, dequantization), host "
                f"nproc {nproc}: first batch equal to the numpy decode to the bit; "
                f"{rates[f'b_{reader}_images_per_s']:.0f} images/s over {Q_READ_BATCHES} "
                f"batches")
            del it
        del src
        rec_path.unlink()

        # ---- (c) a PNG folder in ImageNet's manner ------------------------------
        yy, xx = np.mgrid[0:1024, 0:1024].astype(np.float32)
        texture = np.stack([127 + 90 * np.sin(xx / (9 + 4 * c)) * np.cos(yy / (13 + 3 * c))
                            for c in range(3)], -1)
        texture = np.clip(texture + rng.normal(0, 12, texture.shape), 0, 255).astype(np.uint8)
        folder = tmp / "imagenet_like"
        folder.mkdir()
        sides = rng.integers(256, 513, (Q_FOLDER_IMAGES, 2))
        corners = rng.integers(0, 1024 - 512, (Q_FOLDER_IMAGES, 2))

        def write_one(i):
            (h, w), (y, x) = sides[i], corners[i]
            native.write_png_batch(np.ascontiguousarray(texture[y:y + h, x:x + w])[None],
                                   [str(folder / f"n{i:05d}.png")], threads=1)

        t0 = time.perf_counter()
        with ThreadPoolExecutor(nproc) as pool:
            list(pool.map(write_one, range(Q_FOLDER_IMAGES)))
        walls["c_write_s"] = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in folder.iterdir())
        log(f"  (c) {Q_FOLDER_IMAGES} PNGs, sides 256-512, {size / 1e6:.1f} MB, written by "
            f"write_png_batch in {walls['c_write_s']:.2f} s")
        for label, transform, n_batches in (("generic", None, Q_FOLDER_IMAGES // Q_BATCH),
                                            ("lsun_scoresde", "lsun_scoresde",
                                             Q_FOLDER_IMAGES // Q_BATCH // 2)):
            t0 = time.perf_counter()
            it = pdata.image_folder_dataset(str(folder), resolution=256, batch_size=Q_BATCH,
                                            shuffle=True, seed=seed, transform=transform)
            for _ in range(n_batches):
                b = next(it)
                if b.shape != (Q_BATCH, 256, 256, 3) or not 0.0 <= b.min() <= b.max() <= 1.0:
                    fail(f"path Q (c) {label}: a batch {b.shape} [{b.min()}, {b.max()}]")
            rates[f"c_{label}_images_per_s"] = n_batches * Q_BATCH / (time.perf_counter() - t0)
            log(f"  (c) image_folder_dataset(256 px, b{Q_BATCH}, {label}), host nproc {nproc}: "
                f"{rates[f'c_{label}_images_per_s']:.0f} images/s over {n_batches} batches")
            del it
        shutil.rmtree(folder, ignore_errors=True)

        # ---- (d) an LMDB in LSUN's layout ---------------------------------------
        pngs = tmp / "lmdb_payloads"
        pngs.mkdir()
        crops = np.stack([texture[y:y + 256, x:x + 256]
                          for y, x in rng.integers(0, 1024 - 256, (Q_LMDB_IMAGES, 2))])
        t0 = time.perf_counter()
        paths = [str(pngs / f"{i:07d}.png") for i in range(Q_LMDB_IMAGES)]
        native.write_png_batch(crops, paths)
        env = tmp / "bedroom_train_lmdb"
        write_lmdb(str(env), ((os.path.basename(p)[:-4].encode(), open(p, "rb").read())
                              for p in paths))
        walls["d_write_s"] = time.perf_counter() - t0
        shutil.rmtree(pngs, ignore_errors=True)
        with LMDBReader(str(env)) as reader:
            table = reader.entry_table()
        if table.shape != (Q_LMDB_IMAGES, 4):
            fail(f"path Q (d): the native walker's entry table is {table.shape}")
        t0 = time.perf_counter()
        it = pdata.lsun_dataset(str(env), resolution=256, batch_size=Q_BATCH, repeat=False,
                                seed=seed)
        n_images = 0
        for b in it:
            n_images += len(b)
        rates["d_lsun_images_per_s"] = n_images / (time.perf_counter() - t0)
        if n_images != Q_LMDB_IMAGES // Q_BATCH * Q_BATCH:
            fail(f"path Q (d): lsun_dataset gave {n_images} images")
        log(f"  (d) LMDB of {Q_LMDB_IMAGES} 256-px PNGs ({(env / 'data.mdb').stat().st_size / 1e6:.1f}"
            f" MB) written in {walls['d_write_s']:.2f} s; lsun_dataset(256 px, b{Q_BATCH}) on the "
            f"native walker's table, host nproc {nproc}: {rates['d_lsun_images_per_s']:.0f} "
            f"images/s over one epoch")
        shutil.rmtree(env, ignore_errors=True)
        del texture, crops

        # ---- (e) the FID folder route ---------------------------------------------
        samples = tmp / "p_first_round"
        samples.mkdir()
        native.write_png_batch(p_samples, [str(samples / f"{i:05d}.png")
                                           for i in range(len(p_samples))])
        npz = tmp / "p_first_round.npz"
        np.savez(npz, samples=p_samples)
        t0 = time.perf_counter()
        n_read = sum(len(b) for b in pfid._folder_batches(str(samples), Q_FID_CHUNK))
        walls["e_folder_read_s"] = time.perf_counter() - t0
        feature_fn = make_feature_fn(random_feature_params(TRAIN_SEED), device=dev)
        torch.backends.cudnn.deterministic = True
        t0 = time.perf_counter()
        mu_f, sigma_f = pfid.compute_statistics_of_path(str(samples), feature_fn,
                                                        batch_size=Q_FID_CHUNK)
        walls["e_folder_stats_s"] = time.perf_counter() - t0
        mu_n, sigma_n = pfid.compute_statistics_of_path(str(npz), feature_fn,
                                                        batch_size=Q_FID_CHUNK)
        torch.backends.cudnn.deterministic = False
        d_mu = float(np.abs(mu_f - mu_n).max() / np.abs(mu_n).max())
        d_sigma = float(np.abs(sigma_f - sigma_n).max() / np.abs(sigma_n).max())
        checks.update(e_mu_rel=d_mu, e_sigma_rel=d_sigma)
        log(f"  (e) path P's first round, {n_read} PNGs {p_samples.shape[1:]}: the folder read "
            f"(native, chunks of {Q_FID_CHUNK}) {walls['e_folder_read_s'] * 1e3:.1f} ms; "
            f"compute_statistics_of_path(folder) on {smi} {walls['e_folder_stats_s']:.2f} s; "
            f"against the npz of the same uint8 samples: mu {d_mu:.3e}, sigma {d_sigma:.3e} of "
            f"their max (bound 1e-6)")
        if n_read != len(p_samples) or d_mu > 1e-6 or d_sigma > 1e-6:
            fail("path Q (e): the folder's statistics differ from the npz's")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    walls["q_s"] = time.perf_counter() - t_phase
    log(f"path Q done in {walls['q_s']:.1f} s")
    return dict(launches=launches, routes=routes, walls=walls, rates=rates, checks=checks,
                nproc=nproc)


def _cli(argv: list) -> str:
    """`python -m dpm_solver_tpu_torch.cli <argv>` in this process: its
    standard output (echoed here). A failed subcommand raises."""
    from dpm_solver_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main([str(a) for a in argv])
    log("  cli " + " ".join(str(a) for a in argv[:2]) + ": " + buf.getvalue().strip()[-500:])
    return buf.getvalue()


def int8_products(dev, smi: str, ckpt: Path) -> dict:
    """The int8 products of one SD-1 UNet forward (CFG b 2 * R_BATCH, 64x64
    latents) and one VAE decode (b R_BATCH, R_SIZE px) under "w8a8_conv",
    recorded by shape (M, K, N), and the calls that made them: each shape's
    int32 sums on the card against the CPU's (`torch._int_mm` there) on
    R_ROWS rows of the same codes, bit for bit; each product timed per
    launch on prequantized codes beside the bf16 product at the shape and
    the bound (the ops at PEAK_INT8, the bytes at HBM); and each call
    (`w8a8_matmul` at its input, `w8a8_conv` at its image) with its
    quantizes beside its float twin (`F.linear`, the conv3x3 kernel) in
    bf16; the calls recorded must number the int8 sites, else the run
    fails. Times are the device's alone: R_GRAPH launches captured in one
    CUDA graph, a replay's time over R_GRAPH (`graph_ms`)."""
    import torch
    import torch.nn.functional as F

    from dpm_solver_tpu_torch import ops
    from dpm_solver_tpu_torch.models import constant_context_encoder
    from dpm_solver_tpu_torch.pipelines import load_sd_checkpoint

    global TIMED_BUDGET_MS   # graph_ms times its replays through cuda_ms
    pq = importlib.import_module("dpm_solver_tpu_torch.ops.quant")
    c3 = importlib.import_module("dpm_solver_tpu_torch.ops.conv3x3")
    ldm = load_sd_checkpoint(str(ckpt), quant="w8a8_conv", compute_dtype=torch.bfloat16,
                             device=dev)
    shapes = {"unet": Counter(), "vae": Counter()}
    calls = {"unet": Counter(), "vae": Counter()}
    where = ["unet"]
    orig_mm, orig_mat, orig_conv = pq.int8_mm, pq.w8a8_matmul, c3.w8a8_conv

    def rec_mm(a, b_t):
        shapes[where[0]][(a.shape[0], a.shape[1], b_t.shape[0])] += 1
        return orig_mm(a, b_t)

    def rec_mat(x, w, bias=None, out_dtype=None):
        calls[where[0]][("linear", tuple(x.shape), tuple(w.shape), str(x.dtype))] += 1
        return orig_mat(x, w, bias, out_dtype)

    def rec_conv(x, w, bias=None, out_dtype=None):
        calls[where[0]][("conv", tuple(x.shape), tuple(w.shape), str(x.dtype))] += 1
        return orig_conv(x, w, bias, out_dtype)

    g = torch.Generator(device=dev).manual_seed(TRAIN_SEED + 12)
    x = torch.randn(2 * R_BATCH, R_SIZE // 8, R_SIZE // 8, 4, generator=g, device=dev)
    ctx = constant_context_encoder(768)([R_PROMPT] * R_BATCH + [""] * R_BATCH).to(dev)
    pq.int8_mm, pq.w8a8_matmul, c3.w8a8_conv = rec_mm, rec_mat, rec_conv
    try:
        ldm.unet(x, torch.full((2 * R_BATCH,), 500.0, device=dev), context=ctx)
        where[0] = "vae"
        ldm.vae.decode(x[:R_BATCH])
    finally:
        pq.int8_mm, pq.w8a8_matmul, c3.w8a8_conv = orig_mm, orig_mat, orig_conv
    # every int8 site called once: the QuantLinears (a self-attention's
    # to_q/to_k/to_v make one fused product), GEGLU's two, the int8 convs
    for part, net in (("unet", ldm.unet), ("vae", ldm.vae.decoder)):
        mods = list(net.modules())
        n_self = sum(1 for m in mods if type(m).__name__ == "TransformerBlock")
        want = dict(
            linear=sum(isinstance(m, pq.QuantLinear) for m in mods) - 2 * n_self
            + 2 * sum(type(m).__name__ == "GEGLUFeedForward" for m in mods),
            conv=sum(type(m).__name__ == "Conv3x3" and m.quant == "w8a8_conv" for m in mods))
        got = {kind: sum(v for key, v in calls[part].items() if key[0] == kind)
               for kind in want}
        if got != want:
            fail(f"path R: the {part}'s int8 calls recorded {got}, its sites {want}")
        log(f"  int8 calls a {part} pass: {got} (every site)")
    del ldm
    torch.cuda.empty_cache()
    budget, TIMED_BUDGET_MS = TIMED_BUDGET_MS, 50.0
    products, modules, worst = {}, {}, 0
    try:
        for (m, k, n) in sorted(set(shapes["unet"]) | set(shapes["vae"])):
            a_d = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=g, device=dev)
            b_d = torch.randint(-127, 128, (n, k), dtype=torch.int8, generator=g, device=dev)
            got = pq.int8_mm(a_d, b_d)
            sel = torch.linspace(0, m - 1, min(R_ROWS, m), device=dev).round().long()
            # the same codes on the CPU: torch._int_mm there, or an int32 product
            a, b = a_d[sel].cpu(), b_d.cpu()
            want = torch._int_mm(a, b.t().contiguous()) if len(sel) > 16 else \
                a.int() @ b.int().t()
            bad = int((got[sel].cpu() != want).sum())
            worst = max(worst, bad)
            a16, b16 = a_d.to(torch.bfloat16), b_d.to(torch.bfloat16)
            rec = dict(launches_unet=shapes["unet"][(m, k, n)],
                       launches_vae=shapes["vae"][(m, k, n)],
                       int8_ms=graph_ms([lambda: pq.int8_mm(a_d, b_d)], R_GRAPH) / R_GRAPH,
                       bf16_ms=graph_ms([lambda: torch.mm(a16, b16.t())], R_GRAPH) / R_GRAPH,
                       bound_ms=1e3 * max(2 * m * k * n / PEAK_INT8,
                                          (m * k + n * k + 4 * m * n) / HBM),
                       rows_checked=len(sel), mismatches=bad)
            products[f"{m}x{k}x{n}"] = rec
            log(f"  int8 product {m}x{k}x{n} (x{rec['launches_unet']} a UNet forward, "
                f"x{rec['launches_vae']} a decode) on {smi}: _int_mm {rec['int8_ms']:.4f} ms, "
                f"bf16 mm {rec['bf16_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms; card vs CPU "
                f"int32 on {len(sel)} rows: {bad} differ")
            del a_d, b_d, a16, b16, got
        if worst:
            fail(f"path R: int8 products on the card differ from the CPU's ({worst} int32 sums)")
        for key in sorted(set(calls["unet"]) | set(calls["vae"]), key=str):
            kind, xs, ws, dt = key
            xin = torch.randn(xs, generator=g, device=dev).to(torch.bfloat16)
            fan_in = ws[-1] if kind == "linear" else 9 * ws[2]
            wt = torch.randn(ws, generator=g, device=dev) * fan_in ** -0.5
            if kind == "linear":
                quant = lambda: pq.w8a8_matmul(xin, wt, out_dtype=torch.bfloat16)  # noqa: E731
                w16 = wt.to(torch.bfloat16)
                flt = lambda: F.linear(xin, w16)  # noqa: E731
            else:
                quant = lambda: pq.w8a8_conv(xin, wt)  # noqa: E731
                w16 = wt.to(torch.bfloat16).contiguous()
                flt = lambda: ops.conv3x3(xin, w16)  # noqa: E731
            rec = dict(kind=kind, x=list(xs), w=list(ws), calls_unet=calls["unet"][key],
                       calls_vae=calls["vae"][key], int8_ms=graph_ms([quant], R_GRAPH) / R_GRAPH,
                       float_ms=graph_ms([flt], R_GRAPH) / R_GRAPH)
            modules[f"{kind} {xs} {ws}"] = rec
            log(f"  {kind} x{list(xs)} w{list(ws)} (x{rec['calls_unet']} a UNet forward, "
                f"x{rec['calls_vae']} a decode) on {smi}: int8 with its quantizes "
                f"{rec['int8_ms']:.4f} ms, bf16 {'F.linear' if kind == 'linear' else 'conv3x3'} "
                f"{rec['float_ms']:.4f} ms")
            del xin, wt, w16
    finally:
        TIMED_BUDGET_MS = budget
    sums = {f"{part}_{key}": sum(rec[key] * rec[f"launches_{part}"] for rec in products.values())
            for part in ("unet", "vae") for key in ("int8_ms", "bf16_ms", "bound_ms")}
    sums.update({f"{part}_calls_{key}": sum(rec[key] * rec[f"calls_{part}"]
                                            for rec in modules.values())
                 for part in ("unet", "vae") for key in ("int8_ms", "float_ms")})
    log(f"  int8 over one SD-1 UNet forward (b{2 * R_BATCH}) and one decode (b{R_BATCH}) on "
        f"{smi}: " + ", ".join(f"{k} {v:.3f}" for k, v in sums.items()))
    return dict(products=products, calls=modules, sums=sums)


def small_quant_trajectory(dev) -> dict:
    """The small-width int8 trajectory, card against CPU, fp32: the UNet of
    tests/test_quant.py:236-262 (one head a block) with the JAX
    initialisers' zeroed outputs plus 0.02 N(0, 1) on every weight (that
    file's `_densify`), the tiny VAE, no CFG, R_SMALL_STEPS steps of
    DPM-Solver++ 2M, in both modes; within 5e-3 of max|x|
    (tests/test_quant.py:203-214's flip scale), or twice the CPU's own move
    when x_T moves by one ulp where that is larger (tests/test_torch_quant.py's
    rule)."""
    import torch

    from dpm_solver_tpu_torch.models import (ADMConfig, ADMUNet, AutoencoderKL, VAEConfig,
                                             constant_context_encoder)
    from dpm_solver_tpu_torch.models.init import init_train_
    from dpm_solver_tpu_torch.pipelines import StableDiffusionPipeline, load_sd_checkpoint

    # one head a block (dh 32 and 64: the attention kernel takes no dh 16)
    ucfg = ADMConfig(image_size=8, in_channels=4, model_channels=32, out_channels=4,
                     num_res_blocks=1, attention_resolutions=(1, 2), channel_mult=(1, 2),
                     num_heads=1, use_spatial_transformer=True, transformer_depth=1,
                     context_dim=24, use_linear_in_transformer=True)
    vcfg = VAEConfig.tiny(resolution=16, attn_resolutions=())
    g = torch.Generator().manual_seed(TRAIN_SEED + 14)
    nets = (init_train_(ADMUNet(ucfg, device="cpu"), g),
            init_train_(AutoencoderKL(vcfg, device="cpu"), g))
    for net in nets:
        for p in net.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    sd = {f"model.diffusion_model.{k}": v for k, v in nets[0].state_dict().items()}
    sd.update({f"first_stage_model.{k}": v for k, v in nets[1].state_dict().items()})
    x_T = torch.randn(2, 8, 8, 4, generator=g)
    shifted = torch.nextafter(x_T, torch.tensor(float("inf")))
    out = {}
    for mode in R_MODES[1:]:
        z = {}
        for key, where in (("card", dev), ("cpu", torch.device("cpu"))):
            ldm = load_sd_checkpoint(sd, unet_config=ucfg, vae_config=vcfg, quant=mode,
                                     text_encode=constant_context_encoder(24), device=where)
            pipe = StableDiffusionPipeline(ldm, device=where)
            cond = ldm.get_learned_conditioning(["a red cube", "a teapot"])
            for k, x in ((key, x_T), (key + "_shift", shifted))[:1 if key == "card" else 2]:
                z[k] = pipe.sampler.sample(R_SMALL_STEPS, 2, (8, 8, 4), cond, x_T=x,
                                           return_intermediate=False, jit=False)[0].cpu()
        d, r = rel_err(z["card"], z["cpu"])
        sens = rel_err(z["cpu_shift"], z["cpu"])[1]
        bound = max(5e-3, 2 * sens)
        ok = r <= bound and bool(torch.isfinite(z["card"]).all())
        log(f"  small-width {mode} trajectory, card vs CPU: max|d| {d:.3e}, /max|x| {r:.3e} "
            f"(bound {bound:.3e}; the CPU's own move for x_T + 1 ulp {sens:.3e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"path R: the small-width {mode} trajectory disagrees card vs CPU")
        out[mode] = dict(rel=r, bound=bound, cpu_ulp_move=sens)
    return out


def trace_top_ops(trace_dir: Path, k: int = 10) -> list:
    """The k device ops (Chrome trace events of category "kernel") with the
    most device time in a `--trace-dir` trace: [(name, ms, launches)]."""
    events = json.loads((trace_dir / "trace.json").read_text())["traceEvents"]
    total, count = Counter(), Counter()
    for ev in events:
        if ev.get("cat") == "kernel" and "dur" in ev:
            total[ev["name"]] += ev["dur"] / 1e3
            count[ev["name"]] += 1
    return [(name[:90], round(ms, 4), count[name]) for name, ms in total.most_common(k)]


def cli_path(dev, smi: str) -> dict:
    """Path R (phase 7h): the CLI (`dpm_solver_tpu_torch.cli.main`, as
    `python -m dpm_solver_tpu_torch.cli` runs it) on files written to a
    temporary directory: SD-1 `txt2img` in each of R_MODES with the
    watermark and the safety screen, `wmdecode`, img2img, inpaint, `fid`,
    `configs` and a traced `sample`. Returns the launches and routes of each
    counted run, the kernel specs of the float txt2img call, the walls and
    the checks."""
    import numpy as np
    import torch
    from PIL import Image

    from dpm_solver_tpu_torch import ops, pipelines
    from dpm_solver_tpu_torch.eval.inception import random_feature_params
    from dpm_solver_tpu_torch.models import (ADMConfig, ADMUNet, AutoencoderKL, VAEConfig,
                                             init_random_)
    from dpm_solver_tpu_torch.pipelines import stable_diffusion as psd

    walls, checks, launches, routes, specs = {}, {}, {}, {}, Counter()
    ucfg, vcfg = ADMConfig.sd_v1(), VAEConfig.sd_v1()
    tmp = Path(tempfile.mkdtemp(prefix="path_r_"))
    t_phase = time.perf_counter()
    orig_load, orig_t2i = pipelines.load_sd_checkpoint, psd.StableDiffusionPipeline.txt2img
    orig_sample = psd.DPMSolverSampler.sample
    try:
        # ---- the files: checkpoint, CLIP directory, safety checkpoint, images ----
        t0 = time.perf_counter()
        g = torch.Generator(device=dev).manual_seed(TRAIN_SEED + 9)
        unet = init_random_(ADMUNet(ucfg, device=dev), g)
        vae = init_random_(AutoencoderKL(vcfg, device=dev), g)
        n_params = (sum(p.numel() for p in unet.parameters()),
                    sum(p.numel() for p in vae.parameters()))
        sd = {f"model.diffusion_model.{k}": v.half().cpu() for k, v in unet.state_dict().items()}
        sd.update({f"first_stage_model.{k}": v.half().cpu() for k, v in vae.state_dict().items()})
        del unet, vae
        ckpt = tmp / "sd-v1-random.ckpt"
        torch.save({"state_dict": sd}, ckpt)
        del sd
        clip = write_clip_text_dir(tmp / "clip", TRAIN_SEED + 10, joint=True)
        rng = np.random.default_rng(TRAIN_SEED + 11)
        unit = lambda a: a / np.linalg.norm(a, axis=1, keepdims=True)   # noqa: E731
        safety = tmp / "safety_checker.pt"
        torch.save({"concept_embeds": torch.from_numpy(unit(rng.standard_normal(
                        (R_CONCEPTS, 768))).astype(np.float32)),
                    "concept_embeds_weights": torch.from_numpy(rng.uniform(
                        0.18, 0.23, R_CONCEPTS).astype(np.float32)),
                    "special_care_embeds": torch.from_numpy(unit(rng.standard_normal(
                        (R_SPECIAL, 768))).astype(np.float32)),
                    "special_care_embeds_weights": torch.from_numpy(rng.uniform(
                        0.18, 0.2, R_SPECIAL).astype(np.float32))}, safety)
        yy, xx = np.mgrid[0:R_SIZE, 0:R_SIZE]
        init = np.stack([128 + 90 * np.sin(xx / 23.0) * np.cos(yy / 31.0),
                         128 + 80 * np.cos(xx / 17.0 + 1.0),
                         128 + 70 * np.sin((xx + yy) / 41.0)], axis=-1)
        Image.fromarray(np.clip(init, 0, 255).astype(np.uint8)).save(tmp / "init.png")
        mask = np.zeros((R_SIZE, R_SIZE), np.uint8)
        mask[R_SIZE // 4:3 * R_SIZE // 4, R_SIZE // 4:3 * R_SIZE // 4] = 255
        Image.fromarray(mask).save(tmp / "mask.png")
        walls["r_files_s"] = time.perf_counter() - t0
        log(f"path R: a CompVis sd_v1 checkpoint (UNet {n_params[0] / 1e6:.2f}M + KL VAE "
            f"{n_params[1] / 1e6:.2f}M params, seeded random weights, fp16 tensors, "
            f"{ckpt.stat().st_size / 2 ** 30:.2f} GiB), a joint CLIP directory (ViT-L/14 text "
            f"width) and a safety checkpoint ({R_CONCEPTS} + {R_SPECIAL} concepts) written in "
            f"{walls['r_files_s']:.1f} s")

        # ---- the CLI's own calls, timed from inside (the patches only time and
        # keep the pipeline; the float call's kernel specs are recorded) ---------
        stats, kept = {}, {}

        def timed(key, fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            stats.setdefault(key, []).append(time.perf_counter() - t)
            return out

        def load(*a, **k):
            return timed("load_s", lambda: orig_load(*a, **k))

        def txt2img(self, *a, **k):
            kept["pipe"] = self
            run = lambda: orig_t2i(self, *a, **k)   # noqa: E731
            if kept.get("record"):
                return timed("call_s", lambda: record_kernel_specs(
                    [self.model.unet, self.model.vae], run, specs))
            return timed("call_s", run)

        def sample(self, *a, **k):
            return timed("sampler_s", lambda: orig_sample(self, *a, **k))

        pipelines.load_sd_checkpoint = load
        psd.StableDiffusionPipeline.txt2img = txt2img
        psd.DPMSolverSampler.sample = sample

        per_fwd, decode = adm_unet_launches(ucfg), vae_decoder_launches(vcfg)
        outs = {}
        for mode in R_MODES:
            name = mode or "float"
            fwd, dec = Counter(per_fwd), Counter(decode)
            if mode:
                fwd["ln_linear"] = fwd["geglu_ff"] = 0
            if mode == "w8a8_conv":
                fwd["conv3x3"] = 0
                dec["conv3x3"] = 2     # the VAE's conv_in and conv_out stay float
            once = {n: dec[n] for n in REPLACES}
            want = {n: 2 * R_STEPS * fwd[n] + once[n] for n in REPLACES}
            want["fused_update"] = 2 * R_STEPS
            out = tmp / f"txt2img_{name}"
            stats.clear()
            kept["record"] = mode is None
            gc.collect()
            torch.cuda.empty_cache()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            _cli(["txt2img", "--ckpt", ckpt, "--prompt", R_PROMPT, "--clip", clip,
                  "--steps", R_STEPS, "--scale", R_SCALE, "--H", R_SIZE, "--W", R_SIZE,
                  "--batch", R_BATCH, "--seed", R_SEED, "--outdir", out,
                  "--safety-ckpt", safety] + (["--quant", mode] if mode else []))
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            launches[f"r_{name}"], routes[f"r_{name}"] = ops.launch_counts(), ops.launch_routes()
            log(f"  txt2img {name}: launches {launches[f'r_{name}']} (expected {want})")
            if launches[f"r_{name}"] != want:
                fail(f"path R txt2img {name}: launches {launches[f'r_{name}']} != {want}")
            check_routes(f"path R txt2img {name}", launches[f"r_{name}"], routes[f"r_{name}"],
                         narrow_convs=2)
            if mode and (routes[f"r_{name}"]["ln_linear"] or routes[f"r_{name}"]["geglu_ff"]):
                fail(f"path R txt2img {name}: the transformer stack launched ln_linear / geglu_ff")
            # the same pipeline's second call: the sampler replays its graph
            pipe = kept.pop("pipe")
            kept["record"] = False
            ops.reset_launch_counts()
            again = pipe.txt2img([R_PROMPT] * R_BATCH, steps=R_STEPS, guidance_scale=R_SCALE,
                                 height=R_SIZE, width=R_SIZE,
                                 generator=torch.Generator().manual_seed(R_SEED))
            torch.cuda.synchronize()
            if ops.launch_counts() != once:
                fail(f"path R txt2img {name}: the replayed call launched {ops.launch_counts()}")
            del pipe
            imgs = np.load(out / "txt2img.npz")["samples"]
            if imgs.shape != (R_BATCH, R_SIZE, R_SIZE, 3) or not np.isfinite(imgs).all():
                fail(f"path R txt2img {name}: images {imgs.shape} are not finite")
            d_again = float(np.abs(again.cpu().numpy() - np.load(out / "txt2img.npz")["samples"])
                            .max())
            outs[name] = imgs
            text = _cli(["wmdecode", out / "txt2img_00000.png"]).strip().splitlines()[-1]
            if text != "StableDiffusionV1":
                fail(f"path R txt2img {name}: wmdecode read {text!r}")
            walls[f"r_txt2img_{name}"] = dict(
                cli_s=cli_s, load_s=stats["load_s"][0], call_s=stats["call_s"][0],
                sampler_s=stats["sampler_s"][0], replay_call_s=stats["call_s"][1],
                replay_sampler_s=stats["sampler_s"][1],
                unet_share_replay=stats["sampler_s"][1] / stats["call_s"][1])
            w = walls[f"r_txt2img_{name}"]
            log(f"  txt2img {name} on {smi}: the CLI call {cli_s:.2f} s (load "
                f"{w['load_s']:.2f} s, txt2img {w['call_s']:.2f} s of which the sampler's warm "
                f"call, capture and replay {w['sampler_s']:.2f} s); the pipeline's second call "
                f"{w['replay_call_s']:.3f} s, the sampler (25 NFE replayed) "
                f"{w['replay_sampler_s']:.3f} s = {100 * w['unet_share_replay']:.1f}% of it; "
                f"watermark read back; images mean {imgs.mean():.4f} std {imgs.std():.4f}; the "
                f"second call's images (no watermark) vs the CLI's saved ones (watermarked): "
                f"max|d| {d_again:.3e}")
        for name in ("w8a8", "w8a8_conv"):
            a, b = outs[name].astype(np.float64), outs["float"].astype(np.float64)
            checks[f"txt2img_{name}_rel_rmse_vs_float"] = float(
                np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))
            log(f"  txt2img {name} vs float images: relative RMSE "
                f"{checks[f'txt2img_{name}_rel_rmse_vs_float']:.4f}")

        # ---- img2img and inpaint on the same checkpoint ----------------------
        steps_i2i = max(1, int(R_EDIT_STEPS * 0.75))
        enc = vae_encoder_launches(vcfg)
        for cmd, steps, extra in (("img2img", steps_i2i, ["--strength", 0.75]),
                                  ("inpaint", R_EDIT_STEPS, ["--mask", tmp / "mask.png"])):
            want = {n: 2 * steps * per_fwd[n] + enc[n] + decode[n] for n in REPLACES}
            want["fused_update"] = 2 * steps
            out = tmp / cmd
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            _cli([cmd, "--ckpt", ckpt, "--init-img", tmp / "init.png", *extra, "--prompt",
                  R_PROMPT, "--clip", clip, "--steps", R_EDIT_STEPS, "--batch", R_EDIT_BATCH,
                  "--outdir", out])
            torch.cuda.synchronize()
            walls[f"r_{cmd}_s"] = time.perf_counter() - t0
            launches[f"r_{cmd}"], routes[f"r_{cmd}"] = ops.launch_counts(), ops.launch_routes()
            log(f"  {cmd}: launches {launches[f'r_{cmd}']} (expected {want}); "
                f"{walls[f'r_{cmd}_s']:.2f} s")
            if launches[f"r_{cmd}"] != want:
                fail(f"path R {cmd}: launches {launches[f'r_{cmd}']} != {want}")
            check_routes(f"path R {cmd}", launches[f"r_{cmd}"], routes[f"r_{cmd}"],
                         narrow_convs=3)
            imgs = np.load(out / f"{cmd}.npz")["samples"]
            if imgs.shape != (R_EDIT_BATCH, R_SIZE, R_SIZE, 3) or not np.isfinite(imgs).all():
                fail(f"path R {cmd}: images {imgs.shape} are not finite")
        pipelines.load_sd_checkpoint, psd.StableDiffusionPipeline.txt2img = orig_load, orig_t2i
        psd.DPMSolverSampler.sample = orig_sample
        gc.collect()
        torch.cuda.empty_cache()

        # ---- fid over two output folders, configs, a traced sample ------------
        torch.save(random_feature_params(TRAIN_SEED), tmp / "inception.pt")
        fid = float(_cli(["fid", tmp / "txt2img_float", tmp / "txt2img_w8a8",
                          "--inception-ckpt", tmp / "inception.pt"]).strip().splitlines()[-1])
        checks["fid_float_vs_w8a8"] = fid
        if not np.isfinite(fid):
            fail(f"path R: fid printed {fid}")
        names = _cli(["configs"]).split()
        if "sd_v1" not in names or "cifar10_ddpm" not in names:
            fail("path R: configs does not list the registry")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        _cli(["sample", "--config", "cifar10_ddpm", "--batch", BATCH, "--outdir",
              tmp / "sample", "--trace-dir", tmp / "trace"])
        walls["r_sample_trace_s"] = time.perf_counter() - t0
        launches["r_sample"], routes["r_sample"] = ops.launch_counts(), ops.launch_routes()
        top = trace_top_ops(tmp / "trace")
        if not top:
            fail("path R: the sample trace holds no device op")
        checks["sample_trace_top_ops"] = top
        log(f"  sample --trace-dir (cifar10_ddpm b{BATCH}, one warm call traced) on {smi}: "
            f"the 10 largest device ops (name, ms, launches): {json.dumps(top)}")

        # ---- the int8 products and the small-width card-vs-CPU trajectory ------
        t0 = time.perf_counter()
        int8 = int8_products(dev, smi, ckpt)
        checks["small_quant_trajectory"] = small_quant_trajectory(dev)
        walls["r_int8_checks_s"] = time.perf_counter() - t0
    finally:
        pipelines.load_sd_checkpoint, psd.StableDiffusionPipeline.txt2img = orig_load, orig_t2i
        psd.DPMSolverSampler.sample = orig_sample
        shutil.rmtree(tmp, ignore_errors=True)
    walls["r_s"] = time.perf_counter() - t_phase
    log(f"path R done in {walls['r_s']:.1f} s")
    return dict(launches=launches, routes=routes, specs=specs, walls=walls, checks=checks,
                int8=int8)


# --------------------------------------------------------------------------- #
# path S: parallelism (the mesh, sharded samplers, DP / ZeRO-1 / TP steps)
# --------------------------------------------------------------------------- #

# path S's bounds. fp32: JAX's for a sharded against an unsharded call
# (tests/test_sharding.py:51-52), 1e-4 of max|x|. bf16: a rank runs half the
# batch, where the library's GEMMs and convs may take other algorithms, and
# under tensor parallelism each row-parallel product is rounded to bf16 on
# each rank before the fp32 sum where the unsharded product is rounded once;
# one bf16 rounding is 2^-8 = 3.9e-3 relative, and a random-weight network
# compounds it over its ~100 layers and, in a trajectory, over its NFE:
# S_BF16_BOUND of max|x| for one forward, S_TRAJ_BOUND for a trajectory
S_FP32_BOUND, S_BF16_BOUND, S_TRAJ_BOUND = 1e-4, 5e-2, 1e-1
S_SEED, S_STEPS, S_TIMED = 50, 20, 3
# the TP trajectory's NFE: its check is of the tensor-parallel split, which
# every NFE runs alike (20 until the script's time limit, PERF.md section 4)
S_TP_STEPS = 4
S_GRAD_BOUND = 1e-4          # gradients, relative to their max over the tensors


def _s_text_encoder(dim: int):
    """A prompt -> (77, dim) stand-in encoder that gives every process the
    same values (the hashing `constant_context_encoder` differs between
    processes), seeded by each prompt's crc32."""
    import zlib

    import torch

    def encode(prompts):
        return torch.stack([torch.randn(77, dim, generator=torch.Generator().manual_seed(
            zlib.crc32(p.encode()))) for p in prompts])

    return encode


def _s_rows_of(local, full, ax: int):
    """The indices along `ax` of `full` whose slices `local` holds, matched by
    their values (an independent check of the tensor-parallel split)."""
    import torch

    lf = local.movedim(ax, 0).reshape(local.shape[ax], -1)[:, :8]
    ff = full.movedim(ax, 0).reshape(full.shape[ax], -1)[:, :8]
    eq = (lf[:, None, :] == ff[None, :, :]).all(-1)
    if not bool(eq.any(1).all()):
        fail("a tensor-parallel slice holds values of no row of the unsharded weight")
    return eq.float().argmax(1)


class _SGradOnly:
    """An optimiser that records the gradients it is given and updates
    nothing (no state): path S5's unsharded reference step."""

    def init(self, params):
        return {"count": 0}

    def step(self, params, grads, state):
        self.grads = {k: v.detach().clone() for k, v in grads.items()}


def path_s_rank(rank: int, world: int, smi: str) -> dict:
    """One of path S's two ranks on cuda:0 (a gloo world, the test transport):
    S1-S6. Returns its checks, launches, kernel specs and times."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    import dpm_solver_tpu_torch as P
    from dpm_solver_tpu_torch import ops
    from dpm_solver_tpu_torch.models import (ADMConfig, ADMUNet, AutoencoderKL, DDPMUNet,
                                             DDPMUNetConfig, VAEConfig, init_random_)
    from dpm_solver_tpu_torch.parallel import batch_sharding, make_mesh, sample_noise
    from dpm_solver_tpu_torch.parallel import multihost as mh
    from dpm_solver_tpu_torch.parallel.mesh import all_reduce_mean_, axis_group
    from dpm_solver_tpu_torch.parallel.tp import (make_tp_fn, make_tp_mesh, shard_params,
                                                  tp_param_specs)
    from dpm_solver_tpu_torch.parallel.zero import (shard_optimizer_state, shard_train_step,
                                                    state_bytes)
    from dpm_solver_tpu_torch.pipelines import LatentDiffusion, StableDiffusionPipeline
    from dpm_solver_tpu_torch.training.optim import Adam
    from dpm_solver_tpu_torch.training.train import make_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    dev = torch.device("cuda", 0)
    bf16 = torch.bfloat16
    mesh = make_mesh(world, device="cuda", backend="gloo")
    sh = batch_sharding(mesh)
    res = dict(checks={}, launches=Counter(), by_call={}, specs={"bfloat16": Counter(),
               "float32": Counter()}, dx_specs=set(), walls={}, times={}, bytes={})

    def say(msg):
        log(f"  [rank {rank}] {msg}")

    def check(name, got, want, bound):
        """got against want (or, a callable, want() on rank 0 alone: the
        unsharded references run once, not on both ranks of the one card)."""
        if callable(want):
            if rank:
                return
            want = want()
        d = float((got.float() - want.float()).abs().max())
        r = d / max(float(want.float().abs().max()), 1e-30)
        res["checks"][name] = r
        say(f"{name}: max|d| {d:.3e}, /max {r:.3e} (bound {bound:g})")
        if not (r <= bound and torch.isfinite(got).all()):
            fail(f"path S {name} on rank {rank}: /max {r:.3e} > {bound:g}, or not finite")

    def counted(label, nets, run, dtype="bfloat16", train=False):
        """run() with the launch counters from 0, its launches added to path
        S's (the sharded calls only) and its kernel specs recorded; `train`:
        a train step, whose conv3x3 specs also took conv3x3_dx."""
        ops.reset_launch_counts()
        seen = Counter()
        out = record_kernel_specs(nets, run, seen)
        res["specs"][dtype].update(seen)
        if train:
            res["dx_specs"].update((dtype, spec) for name, spec in seen if name == "conv3x3")
        torch.cuda.synchronize()
        got = ops.launch_counts()
        res["launches"].update(got)
        res["by_call"][label] = got
        return out

    def ms(fn, n=S_TIMED):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    # ---- S1: path A sharded: b64 bf16, 32 rows a rank, graphed -----------------
    t0 = time.perf_counter()
    cfg = DDPMUNetConfig.cifar10()
    net = init_random_(DDPMUNet(cfg, compute_dtype=bf16, device=dev),
                       torch.Generator(device=dev).manual_seed(0)).eval()
    ns = P.NoiseScheduleVP.discrete(betas=np.linspace(1e-4, 0.02, 1000))
    solver = P.DPM_Solver(P.model_wrapper(net, ns), ns)
    kw = dict(steps=STEPS, order=ORDER, method="multistep", skip_type="logSNR")
    x_T = sample_noise(S_SEED, (BATCH, 32, 32, 3)).to(dev)
    caps = P.GraphedSampler.captures
    out = counted("S1 b64", [net], lambda: solver.sample(x_T, mesh=mesh, **kw))
    if P.GraphedSampler.captures != caps + 1 or out.shape != x_T.shape:
        fail(f"path S1: {P.GraphedSampler.captures - caps} captures (one a rank), "
             f"shape {tuple(out.shape)}")
    ops.reset_launch_counts()
    again = solver.sample(x_T, mesh=mesh, **kw)
    torch.cuda.synchronize()
    if any(ops.launch_counts().values()) or P.GraphedSampler.captures != caps + 1 \
            or not torch.equal(again, out):
        fail("path S1: the repeat call launched a kernel, captured again or differs")
    rows = sh.rows(BATCH)
    mine = solver.sample(x_T[rows].contiguous(), **kw)        # the rank's rows, unsharded
    if not torch.equal(out[rows], mine):
        fail("path S1: a rank's rows differ from the unsharded call on the same rows")
    check("S1 b64 bf16 vs unsharded b64", out, lambda: solver.sample(x_T, **kw), S_TRAJ_BOUND)
    local = sh.local(x_T).contiguous()
    res["times"]["S1 per-rank call ms"] = ms(lambda: solver.sample(local, **kw))
    res["times"]["S1 gather ms"] = ms(lambda: sh.gather(mine))
    res["times"]["S1 sharded call ms"] = ms(lambda: solver.sample(x_T, mesh=mesh, **kw))
    net32 = DDPMUNet(cfg, device=dev).eval()
    net32.load_state_dict(net.state_dict())
    solver32 = P.DPM_Solver(P.model_wrapper(net32, ns), ns)
    x4 = x_T[:4].float()
    out4 = counted("S1 b4 fp32", [net32], lambda: solver32.sample(x4, mesh=mesh, **kw), "float32")
    check("S1 b4 fp32 vs unsharded", out4, lambda: solver32.sample(x4, **kw), S_FP32_BOUND)
    del net, net32, solver, solver32
    gc.collect()
    torch.cuda.empty_cache()
    res["walls"]["S1"] = time.perf_counter() - t0
    say(f"S1 done in {res['walls']['S1']:.1f} s")

    # ---- S3: the data-parallel step, cifar10_ddpm full width, fp32, b128 -------
    t0 = time.perf_counter()

    class Recorded(Adam):
        def step(self, params, grads, state):
            self.grads = {k: v.detach().clone() for k, v in grads.items()}
            return super().step(params, grads, state)

    dcfg = dataclasses.replace(DDPMUNetConfig.cifar10(), dropout=0.0)
    init = init_random_(DDPMUNet(dcfg, device=dev), torch.Generator(device=dev).manual_seed(3))
    x0 = sample_noise(S_SEED + 2, (128, 32, 32, 3)).to(dev)
    runs = {}
    with torch.enable_grad():
        for mode in ("single", "dp"):
            m = DDPMUNet(dcfg, device=dev).train()
            m.load_state_dict(init.state_dict())
            tx = Recorded(2e-4, grad_clip=1.0)
            state, _ = make_train_state(m, tx=tx)
            step = make_train_step(lambda x, t, m=m: m(x, t), ns, tx,
                                   mesh=None if mode == "single" else mesh)
            run = lambda: step(state, x0, S_SEED)
            metrics = counted("S3 dp step", [m], run, "float32", train=True)[1] \
                if mode == "dp" else run()[1]
            runs[mode] = (float(metrics["loss"]), tx.grads)
            if mode == "dp":
                res["times"]["S3 dp step ms"] = ms(lambda: step(state, x0, S_SEED))
                grads = [g.clone() for g in tx.grads.values()]
                res["times"]["S3 grad all-reduce ms"] = ms(
                    lambda: all_reduce_mean_(grads, axis_group(mesh, "data")))
                dp_grads = tx.grads
            del m, state, step, tx
    (l1, g1), (l2, g2) = runs["single"], runs["dp"]
    res["checks"]["S3 loss rel"] = abs(l2 - l1) / abs(l1)
    gmax = max(float(g.abs().max()) for g in g1.values())
    gerr = max(float((g2[k] - g).abs().max()) for k, g in g1.items()) / gmax
    res["checks"]["S3 grads /max"] = gerr
    say(f"S3 loss {l2:.6f} vs single {l1:.6f} (rel {res['checks']['S3 loss rel']:.2e}, bound "
        f"1e-5); averaged grads vs single /max {gerr:.2e} (bound {S_GRAD_BOUND:g})")
    if not (res["checks"]["S3 loss rel"] <= 1e-5 and gerr <= S_GRAD_BOUND):
        fail("path S3: the data-parallel step disagrees with the single-process step")
    del runs, g1
    gc.collect()
    torch.cuda.empty_cache()
    res["walls"]["S3"] = time.perf_counter() - t0
    say(f"S3 done in {res['walls']['S3']:.1f} s")

    # ---- S4: ZeRO-1 on S3's step ------------------------------------------------
    t0 = time.perf_counter()
    params = {}
    for mode in ("replicated", "zero"):
        m = DDPMUNet(dcfg, device=dev)
        m.load_state_dict(init.state_dict())
        tx = Adam(2e-4, grad_clip=1.0)
        state, _ = make_train_state(m, tx=tx)
        if mode == "zero":
            res["bytes"]["replicated"] = state_bytes(state.opt_state)
            shard_optimizer_state(state, mesh, tx)
            res["bytes"]["zero"] = state_bytes(state.opt_state)
        tx.step(state.params, {k: g.clone() for k, g in dp_grads.items()}, state.opt_state)
        params[mode] = {k: p.detach().clone() for k, p in state.params.items()}
        del m, state
    zerr = max(float((params["zero"][k] - p).abs().max() / p.abs().max().clamp_min(1e-30))
               for k, p in params["replicated"].items())
    res["checks"]["S4 zero vs replicated Adam rel"] = zerr
    say(f"S4 ZeRO-1: optimizer state {res['bytes']['zero'] / 2 ** 20:.2f} MiB a rank vs "
        f"{res['bytes']['replicated'] / 2 ** 20:.2f} MiB unsharded; parameters after the step "
        f"vs the unsharded Adam step, max rel {zerr:.2e} (bound 1e-6)")
    if not (zerr <= 1e-6 and res["bytes"]["zero"] < 0.6 * res["bytes"]["replicated"]):
        fail("path S4: the ZeRO-1 step differs from the unsharded one, or did not shard")
    with torch.enable_grad():
        m = DDPMUNet(dcfg, device=dev).train()
        m.load_state_dict(init.state_dict())
        tx = Adam(2e-4, grad_clip=1.0)
        state, _ = make_train_state(m, tx=tx)
        z_step, state, _ = shard_train_step(make_train_step(lambda x, t: m(x, t), ns, tx,
                                                            mesh=mesh), mesh, state, tx)
        zl = float(counted("S4 zero step", [m], lambda: z_step(state, x0, S_SEED),
                           "float32", train=True)[1]["loss"])
        res["times"]["S4 zero step ms"] = ms(lambda: z_step(state, x0, S_SEED))
    if abs(zl - l2) > 1e-5 * abs(l2):
        fail(f"path S4: the ZeRO-1 step's loss {zl} is not the data-parallel step's {l2}")
    del m, state, z_step, params, init, dp_grads
    torch.cuda.empty_cache()
    gc.collect()
    torch.cuda.empty_cache()
    res["walls"]["S4"] = time.perf_counter() - t0
    say(f"S4 done in {res['walls']['S4']:.1f} s")

    # ---- S2: SD-1 txt2img(mesh=) at 512 px, b4 (2 a rank), CFG 7.5, 20 NFE ----
    t0 = time.perf_counter()
    ucfg, vcfg = ADMConfig.sd_v1(), VAEConfig.sd_v1()
    g = torch.Generator(device=dev).manual_seed(S_SEED + 1)
    unet = init_random_(ADMUNet(ucfg, compute_dtype=bf16, device=dev), g).eval()
    vae = init_random_(AutoencoderKL(vcfg, compute_dtype=bf16, device=dev), g).eval()
    pipe = StableDiffusionPipeline(LatentDiffusion(unet, vae, text_encode=_s_text_encoder(768)),
                                   device=dev)
    prompts = (SD_PROMPTS * 2)[:4]
    t2i = dict(steps=S_STEPS, guidance_scale=7.5, height=512, width=512)
    imgs = counted("S2 txt2img 512px b4", [unet, vae],
                   lambda: pipe.txt2img(prompts, mesh=mesh, **t2i))
    if imgs.shape != (4, 512, 512, 3):
        fail(f"path S2: images {tuple(imgs.shape)}")
    say(f"S2 sharded txt2img (warm call, capture, replay) {time.perf_counter() - t0:.1f} s")
    check("S2 SD-1 txt2img bf16 vs unsharded", imgs,
          lambda: pipe.txt2img(prompts, jit=False, **t2i), S_TRAJ_BOUND)
    say(f"S2 unsharded reference done at {time.perf_counter() - t0:.1f} s")
    say(f"S2 fp32 networks built at {time.perf_counter() - t0:.1f} s")
    unet32 = ADMUNet(ucfg, device=dev).eval()
    unet32.load_state_dict(unet.state_dict())
    vae32 = AutoencoderKL(vcfg, device=dev).eval()
    vae32.load_state_dict(vae.state_dict())
    pipe32 = StableDiffusionPipeline(LatentDiffusion(unet32, vae32,
                                                     text_encode=_s_text_encoder(768)), device=dev)
    small = dict(steps=2, guidance_scale=7.5, height=128, width=128)
    say(f"S2 fp32 networks loaded at {time.perf_counter() - t0:.1f} s")
    img32 = counted("S2 fp32 b2", [unet32, vae32],
                    lambda: pipe32.txt2img(prompts[:2], mesh=mesh, **small), "float32")
    say(f"S2 fp32 sharded call done at {time.perf_counter() - t0:.1f} s")
    check("S2 fp32 16x16 latents b2 vs unsharded", img32,
          lambda: pipe32.txt2img(prompts[:2], jit=False, **small), S_FP32_BOUND)
    del pipe32, unet32, vae32
    gc.collect()
    torch.cuda.empty_cache()
    res["walls"]["S2"] = time.perf_counter() - t0
    say(f"S2 done in {res['walls']['S2']:.1f} s")

    # ---- S5: tensor parallelism over a (1, 2) mesh --------------------------------
    t0 = time.perf_counter()
    tp_mesh = make_tp_mesh(world, data=1, model=2, device="cuda", backend="gloo")
    fwd = lambda mm, x, t, c: mm(x, t, None, c)   # noqa: E731
    for name, cfg_s, size, full in (("SD-1", ucfg, 64, unet),
                                    ("SD-2.1", ADMConfig.sd_v2_1(), 96, None)):
        if full is None:
            full = init_random_(ADMUNet(cfg_s, compute_dtype=bf16, device=dev),
                                torch.Generator(device=dev).manual_seed(S_SEED + 4)).eval()
        tp_net = ADMUNet(cfg_s, compute_dtype=bf16, device=dev).eval()
        tp_net.load_state_dict(full.state_dict())
        tp_fn, tp_net = make_tp_fn(fwd, tp_mesh, tp_net)
        z = sample_noise(S_SEED + 5, (2, size, size, 4)).to(dev)
        tt = torch.full((2,), 500.0, device=dev)
        ctx = _s_text_encoder(cfg_s.context_dim)(SD_PROMPTS[:1] + [""]).to(dev)
        got = counted(f"S5 {name} forward", [tp_net], lambda: tp_fn(z, tt, ctx))
        want_l = dict(adm_unet_launches(cfg_s))
        got_l = {k: v for k, v in res["by_call"][f"S5 {name} forward"].items() if v}
        if got_l != want_l:
            fail(f"path S5 {name}: TP launches {got_l} != layout()'s {want_l}")
        res["heads"] = res.get("heads", {})
        res["heads"][name] = sorted({mm.heads for mm in tp_net.modules() if hasattr(mm, "dim_head")})
        check(f"S5 {name} TP forward bf16 vs unsharded", got, lambda: full(z, tt, None, ctx),
              S_BF16_BOUND)
        if name == "SD-1":
            tp_sd1 = tp_net
        else:
            del full, tp_net
    say(f"S5 TP forwards done at {time.perf_counter() - t0:.1f} s")
    # the TP SD-1 trajectory at 512 px, b2, graphed (each gloo all-reduce a
    # host step between two graph segments)
    tp_pipe = StableDiffusionPipeline(LatentDiffusion(tp_sd1, vae,
                                                      text_encode=_s_text_encoder(768)), device=dev)
    cond = _s_text_encoder(768)(SD_PROMPTS[:2]).to(dev)
    uncond = _s_text_encoder(768)(["", ""]).to(dev)
    z2 = sample_noise(S_SEED + 6, (2, 64, 64, 4)).to(dev)
    skw = dict(unconditional_guidance_scale=7.5, unconditional_conditioning=uncond, x_T=z2,
               return_intermediate=False)
    caps = P.GraphedSampler.captures
    lat = counted("S5 SD-1 TP trajectory", [tp_sd1],
                  lambda: tp_pipe.sampler.sample(S_TP_STEPS, 2, (64, 64, 4), cond, **skw))[0]
    if P.GraphedSampler.captures != caps + 1:
        fail("path S5: the TP trajectory was not captured once")
    check(f"S5 SD-1 TP {S_TP_STEPS}-NFE trajectory bf16 vs unsharded", lat,
          lambda: pipe.sampler.sample(S_TP_STEPS, 2, (64, 64, 4), cond, jit=False,
                                      **skw)[0],
          S_TRAJ_BOUND)
    del tp_pipe, tp_sd1, pipe, vae
    torch.cuda.empty_cache()
    say(f"S5 TP trajectory done at {time.perf_counter() - t0:.1f} s")
    # a TP train step of SD-1, fp32, 16x16 latents, b2: gradients against the
    # unsharded step's (a sharded slice against the rows of the unsharded
    # gradient it holds, found by value); both sets kept on the host
    ctx2 = _s_text_encoder(768)(SD_PROMPTS[:2]).to(dev)
    zt = sample_noise(S_SEED + 7, (2, 16, 16, 4)).to(dev)
    specs = tp_param_specs(unet)
    grads, rows = {}, {}
    with torch.enable_grad():
        for mode in ("full", "tp"):
            m = ADMUNet(ucfg, device=dev).train()
            m.load_state_dict(unet.state_dict())
            if mode == "tp":
                shard_params(m, tp_mesh)
                full_w = dict(unet.named_parameters())
                # a column-parallel bias follows its weight's rows (its own
                # values, one a row, may repeat)
                rows = {k: _s_rows_of(p.detach(), full_w[k].detach(), specs[k])
                        for k, p in m.named_parameters() if specs[k] is not None and p.dim() > 1}
                rows.update({k: rows[k[:-len("bias")] + "weight"] for k, p in m.named_parameters()
                             if specs[k] is not None and p.dim() == 1})
                del full_w
            # the reference records its gradients and keeps no optimiser state
            tx = Recorded(1e-4, grad_clip=1.0) if mode == "tp" else _SGradOnly()
            state, _ = make_train_state(m, tx=tx)
            step = make_train_step(lambda x, t, m=m: m(x, t, None, ctx2), ns, tx,
                                   mesh=tp_mesh if mode == "tp" else None)
            if mode == "tp":
                counted("S5 SD-1 TP train step", [m], lambda: step(state, zt, S_SEED), "float32",
                        train=True)
            else:
                step(state, zt, S_SEED)
            grads[mode] = {k: g.cpu() for k, g in tx.grads.items()}
            del m, state, step, tx
            gc.collect()
            torch.cuda.empty_cache()
    gmax = max(float(g.abs().max()) for g in grads["full"].values())
    errs = []
    for k, g in grads["tp"].items():
        gf = grads["full"][k]
        if k in rows:
            gf = gf.index_select(specs[k], rows[k].cpu())
        errs.append((float((g - gf).abs().max()) / gmax, k))
    errs.sort(reverse=True)
    gerr = errs[0][0]
    res["checks"]["S5 TP train step grads /max"] = gerr
    say(f"S5 SD-1 TP train step fp32: gradients vs the unsharded step /max {gerr:.2e} "
        f"(bound {S_GRAD_BOUND:g}); the largest at {errs[:4]}")
    if not gerr <= S_GRAD_BOUND:
        fail("path S5: the TP train step's gradients disagree with the unsharded step's")
    del grads, unet
    gc.collect()
    torch.cuda.empty_cache()
    res["walls"]["S5"] = time.perf_counter() - t0
    say(f"S5 done in {res['walls']['S5']:.1f} s")

    # ---- S6: the multihost helpers across the two ranks ----------------------------
    res["multihost"] = mh._smoke_worker(rank, world)
    res["host_fold_rows"] = mh.allgather_metrics(np.asarray([mh.host_fold(0)], np.int64)).shape
    res["subset"] = mh.host_subset(list(range(10)))
    mh.barrier("path-s")
    res["launches"] = dict(res["launches"])
    return res


def start_demo() -> tuple:
    """`python -m dpm_solver_tpu_torch.examples.score_sde_demo` at its tiny
    default on the card, started in the background (its PC sampler's 2,000
    and its bits/dim's ~1,600 NFE are host-bound eager loops: about two
    minutes): the process, its output directory and its start."""
    out = tempfile.mkdtemp(prefix="score_sde_demo_")
    proc = subprocess.Popen([sys.executable, "-m", "dpm_solver_tpu_torch.examples.score_sde_demo",
                             "--outdir", out], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, out, time.perf_counter()


def finish_demo(demo: tuple) -> None:
    """Wait for the demo `start_demo` started; fail unless it exited 0 and
    wrote its two grids."""
    proc, out_dir, t0 = demo
    try:
        out, err = proc.communicate(timeout=900)
        files = sorted(p.name for p in Path(out_dir).glob("demo_*.png"))
    finally:
        if proc.poll() is None:
            proc.kill()
        shutil.rmtree(out_dir, ignore_errors=True)
    if proc.returncode != 0 or files != ["demo_dpm.png", "demo_pc.png"]:
        fail(f"the score_sde demo failed on the card (exit {proc.returncode}, wrote {files}):\n"
             f"{err[-2000:]}")
    log(f"score_sde demo on the card: {out.strip().splitlines()[-4:]} (started after the "
        f"build {time.perf_counter() - t0:.1f} s ago, beside phases 3-7b, which time nothing)")


def parallel_path(dev, smi: str) -> dict:
    """Path S (phase 7i). S0 here, a world of one rank on NCCL; S1-S6 in one
    spawn of two ranks on cuda:0 over gloo (`path_s_rank`); then `cli sample
    --devices 2`, which must refuse one card. Returns the ranks' launches
    and kernel specs, the checks and the times."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import dpm_solver_tpu_torch as P
    from dpm_solver_tpu_torch import ops
    from dpm_solver_tpu_torch.models import DDPMUNet, DDPMUNetConfig, init_random_
    from dpm_solver_tpu_torch.parallel import make_mesh
    from dpm_solver_tpu_torch.parallel.launch import run_ranks
    from dpm_solver_tpu_torch.parallel.mesh import all_reduce_, axis_group
    from dpm_solver_tpu_torch.utils.graphs import SegmentedGraph

    t_phase = time.perf_counter()
    out = dict(walls={}, checks={})
    # ---- S0: a world of one rank on NCCL: path A through sample(mesh=) ------
    t0 = time.perf_counter()
    mesh = make_mesh()
    log(f"path S0: {mesh} on {dist.get_backend()} ({smi})")
    net = init_random_(DDPMUNet(DDPMUNetConfig.cifar10(), compute_dtype=torch.bfloat16,
                                device=dev), torch.Generator(device=dev).manual_seed(0)).eval()
    ns = P.NoiseScheduleVP.discrete(betas=np.linspace(1e-4, 0.02, 1000))
    solver = P.DPM_Solver(P.model_wrapper(net, ns), ns)
    kw = dict(steps=STEPS, order=ORDER, method="multistep", skip_type="logSNR")
    x_T = torch.randn(BATCH, 32, 32, 3, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(1))
    specs0 = Counter()
    ops.reset_launch_counts()
    got = record_kernel_specs([net], lambda: solver.sample(x_T, mesh=mesh, **kw), specs0)
    torch.cuda.synchronize()
    out["launches_s0"] = ops.launch_counts()
    want = solver.sample(x_T, **kw)
    if not torch.equal(got, want):
        fail("path S0: sample(mesh=) over one NCCL rank is not bitwise the unsharded call")
    log(f"  S0 b{BATCH} bf16 graphed over one NCCL rank: bitwise equal to the unsharded "
        f"graphed call; launches {out['launches_s0']}")
    # an NCCL all-reduce is captured in the graph (one segment), where a
    # gloo one splits it: one rank shows the capture, not the traffic
    group = axis_group(mesh, "data")
    v = torch.arange(8.0, device=dev)
    all_reduce_(v.clone(), group)                # the communicator, made eagerly
    torch.cuda.synchronize()
    graph = SegmentedGraph()
    o = graph.capture(lambda: all_reduce_(v * 2, group) + 1)
    v.add_(10)
    graph.replay()
    torch.cuda.synchronize()
    out["nccl_graph_segments"] = len(graph._graphs)
    if out["nccl_graph_segments"] != 1 or not torch.equal(o, v * 2 + 1):
        fail(f"path S0: an NCCL all-reduce under capture made {len(graph._graphs)} graph "
             f"segments (want 1), or its replay missed the new input")
    log("  S0 an NCCL all-reduce captured in a CUDA graph: one segment, its replay right")
    del graph, o, v
    dist.destroy_process_group()
    del net, solver, got, want
    gc.collect()
    torch.cuda.empty_cache()
    out["walls"]["S0"] = time.perf_counter() - t0

    # ---- S1-S6: two ranks on cuda:0 over gloo ----------------------------------
    t0 = time.perf_counter()
    log(f"path S1-S6: two ranks on cuda:0 over gloo (the test transport), {smi}")
    try:
        ranks = run_ranks(path_s_rank, 2, args=(smi,), backend="gloo", timeout=600)
    except (RuntimeError, TimeoutError) as e:
        fail(f"path S: {e}")
    out["walls"]["S1-S6 spawn"] = time.perf_counter() - t0
    out["ranks"] = [dict(checks=r["checks"], walls=r["walls"], times=r["times"],
                         bytes=r["bytes"], heads=r["heads"], launches=r["launches"],
                         by_call=r["by_call"], multihost=r["multihost"],
                         subset=r["subset"]) for r in ranks]
    if sorted(sum((r["subset"] for r in ranks), [])) != list(range(10)) or \
            [r["multihost"] for r in ranks] != ["MULTIHOST_OK 0", "MULTIHOST_OK 1"]:
        fail("path S6: the multihost helpers disagree across the ranks")
    out["specs"] = {dt: sum((Counter(r["specs"][dt]) for r in ranks), Counter())
                    for dt in ("bfloat16", "float32")}
    out["dx_specs"] = set().union(*(r["dx_specs"] for r in ranks))
    out["launches"] = summed([out["launches_s0"]] + [r["launches"] for r in ranks])
    for r, rec in enumerate(ranks):
        log(f"  rank {r}: walls {json.dumps({k: round(v, 1) for k, v in rec['walls'].items()})}"
            f"; times on {smi}: {json.dumps(rec['times'])}; heads {rec['heads']}")
    ms_step, ms_ar = (statistics.mean(r["times"][k] for r in ranks)
                      for k in ("S3 dp step ms", "S3 grad all-reduce ms"))
    out["allreduce_share"] = ms_ar / ms_step
    log(f"  S3 on {smi}: a data-parallel step {ms_step:.2f} ms a rank, its gradient "
        f"all-reduce (gloo, through the host) {ms_ar:.2f} ms ({out['allreduce_share']:.3f})")

    # ---- the CLI refuses more ranks than cards ----------------------------------
    tmp = Path(tempfile.mkdtemp(prefix="path_s_"))
    try:
        try:
            _cli(["--device", "cuda", "sample", "--config", "cifar10_ddpm", "--batch", 4,
                  "--devices", 2, "--outdir", tmp / "cli"])
            fail("cli sample --devices 2 ran on a one-card machine")
        except SystemExit as e:
            msg = str(e)
            if "--devices 2" not in msg or "only 1 visible" not in msg:
                raise
            log(f"  cli sample --devices 2 on one card refuses: {msg}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["walls"]["path S"] = time.perf_counter() - t_phase
    log(f"path S done in {out['walls']['path S']:.1f} s")
    return out



def main() -> int:
    # ---- 1. environment ----------------------------------------------------
    t_start = time.perf_counter()
    import torch

    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this smoke runs on a GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import dpm_solver_tpu_torch as P
    from dpm_solver_tpu_torch import ops
    import torch.nn.functional as F

    from dpm_solver_tpu_torch.models import (ADMClassifier, ADMConfig, ADMUNet, AutoencoderKL,
                                             BERTEmbedder, ClassEmbedder, DDPMUNet,
                                             DDPMUNetConfig, FrozenCLIPEmbedder, NCSNpp,
                                             NCSNppConfig, VAEConfig, VQModel,
                                             constant_context_encoder, init_random_)
    from dpm_solver_tpu_torch.models.ncsnpp import SelfAttention2D
    from dpm_solver_tpu_torch.ops import _build
    from dpm_solver_tpu_torch.ops.attention import FWD_HEAD_DIMS, HEAD_DIMS, attention_delta
    from dpm_solver_tpu_torch.ops.attention import attention_out_plan as out_plan
    from dpm_solver_tpu_torch.ops.conv3x3 import flip_weight
    from dpm_solver_tpu_torch.pipelines import (DPMSolverSampler, LatentDiffusion,
                                                StableDiffusionPipeline, class_conditional_sample,
                                                diffedit, load_sd_checkpoint)
    from dpm_solver_tpu_torch.likelihood import (get_likelihood_fn, hutchinson_divergence,
                                                 ode_sampler, sample_hutchinson)
    from dpm_solver_tpu_torch.score import get_noise_fn, get_score_fn
    from dpm_solver_tpu_torch.sde import VPSDE, reverse_sde
    from dpm_solver_tpu_torch.solver.adaptive import adaptive_sample
    from dpm_solver_tpu_torch.solver.correctors import make_dynamic_thresholding
    from dpm_solver_tpu_torch.solver.sample import make_plan

    smi = card()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"nvidia-smi: {smi}  (torch: {kind}, {count} device(s))")
    dev = torch.device("cuda", 0)
    # every fp32 comparison below runs without TF32 (hopper guide §6)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)

    # ---- 2. build ------------------------------------------------------------
    log(f"[{time.perf_counter() - t_start:.1f} s] phase 2")
    t0 = time.perf_counter()
    build_log = io.StringIO()
    with contextlib.redirect_stdout(build_log):
        lib = _build.build(verbose=True)
    log(build_log.getvalue())
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {lib.relative_to(ROOT)}")
    # (a library built by an earlier run of the same sources prints nothing)
    bwd_ptxas = ptxas_usage(build_log.getvalue(), r"attn_(dq_wgmma|dkv_wgmma|bwd_f32)")
    # the fp32 conv (forward and dx modes), its split sum, the fp32 attention forward
    f32_ptxas = ptxas_usage(build_log.getvalue(),
                            r"conv3x3_f32_sum|conv3x3_f32|attention_fwd_f32")
    # the "narrow" bf16 conv, one instance a (kc, nt) tile
    narrow_ptxas = ptxas_usage(build_log.getvalue(), r"conv3x3_narrow")
    # the fused attention output, one instance a tile (bf16) or head dim (fp32)
    out_ptxas = ptxas_usage(build_log.getvalue(), r"attention_out_(wgmma|f32)")
    # the bf16 attention forward, one instance a head dim (fp32: f32_ptxas);
    # LayerNorm->Linear's "wgmma" instances, resident and segmented
    fwd_ptxas = ptxas_usage(build_log.getvalue(), r"attention_fwd_wgmma")
    ln_ptxas = ptxas_usage(build_log.getvalue(), r"ln_linear_wgmma")
    for kernel, (regs, spill) in chain(bwd_ptxas.items(), f32_ptxas.items(),
                                       narrow_ptxas.items(), out_ptxas.items(),
                                       fwd_ptxas.items(), ln_ptxas.items()):
        log(f"  ptxas {kernel}: {regs} registers, {spill} bytes spilled")

    # the score_sde demo (path S's) runs in the background from here, beside
    # the phases that check and count but time nothing (3-7b)
    demo = start_demo()

    # ---- 3. kernels against their plain versions ---------------------------
    log(f"[{time.perf_counter() - t_start:.1f} s] phase 3")
    g = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(*s, device=dev, generator=g)
    max_abs = {name: 0.0 for name in chain(REPLACES, ("ln_linear_grad", "geglu_ff_grad",
                                                      "attention_out_fused_grad"))}

    def report(name, shape, dtype, got, want, bound):
        torch.cuda.synchronize()
        d, r = rel_err(got, want)
        max_abs[name] = max(max_abs[name], d)
        ok = r <= bound and bool(torch.isfinite(got).all())
        log(f"  {name} {shape} {str(dtype)[6:]}: max|d| {d:.3e}, /max|plain| {r:.3e} "
            f"(bound {bound:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{name} {shape} {dtype} disagrees with its plain version")

    def twice(name, shape, dt, fn):
        """fn() on the same inputs; in fp32 (the route path E's RK45 rides)
        twice, and the two results must be bitwise equal."""
        got = fn()
        if dt == torch.float32:
            again = fn()
            torch.cuda.synchronize()
            same = all(torch.equal(u, v) for u, v in zip(got, again)) \
                if isinstance(got, tuple) else torch.equal(got, again)
            log(f"  {name} {shape} float32, two launches: "
                f"{'bitwise equal' if same else 'DIFFERENT'}")
            if not same:
                fail(f"{name} {shape}: two launches on the same inputs differ")
        return got

    def check_graphed(what, call, eager_out, sampler, once=None):
        """The first call of a graphed path (a warm eager call, then the
        capture: twice `sampler`, one eager sampler call's launches, plus
        `once`, those the call makes outside the graph; one capture), then a
        repeat call (a replay: only `once`, no capture). Each result against
        the eager call's (bf16: max|d| printed; the fp32 bound is
        check_replays')."""
        once = once or {}
        for first in (True, False):
            ops.reset_launch_counts()
            captures = P.GraphedSampler.captures
            got = call()
            torch.cuda.synchronize()
            launches, made = ops.launch_counts(), P.GraphedSampler.captures - captures
            want = {k: (2 * n if first else 0) + once.get(k, 0) for k, n in sampler.items()}
            run = "first call (warm call + capture)" if first else "repeat call (replay)"
            log(f"  {what} jit=True, {run}: launches {launches} (expected {want}), "
                f"{made} capture(s)")
            if launches != want or made != int(first):
                fail(f"{what} jit=True {run}: launches {launches} != {want}, or {made} captures")
            d, r = rel_err(got, eager_out)
            log(f"    graphed vs eager on the card: max|d| {d:.3e}, /max|x| {r:.3e}")
            if not torch.isfinite(got).all():
                fail(f"{what}: the replayed result is not finite")

    def check_replays(what, graphed, eager, inputs, eager_first=None):
        """fp32: `graphed(u)` (captured at the first input, then replayed)
        against `eager(u)` on each of `inputs`, within GRAPH_BOUND of
        max|x|, with one capture in all."""
        captures = P.GraphedSampler.captures
        for i, u in enumerate(inputs):
            got = graphed(u)
            want = eager_first if i == 0 and eager_first is not None else eager(u)
            d, r = rel_err(got, want)
            ok = r <= GRAPH_BOUND and bool(torch.isfinite(got).all())
            log(f"  {what}, input {i}: graphed (replay) vs eager on the card: max|d| {d:.3e}, "
                f"/max|x| {r:.3e} (bound {GRAPH_BOUND:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"{what}: the replayed trajectory disagrees with the eager one")
        made = P.GraphedSampler.captures - captures
        log(f"  {what}: {made} capture(s) over {len(inputs)} calls")
        if made != 1:
            fail(f"{what}: {made} captures over {len(inputs)} calls of one key")

    def check_conv(spec, dt, dx):
        """conv3x3 at `spec` (b, h, w, c, co) and, if `dx`, its input
        gradient, against the plain versions within BOUND (fp32: launched
        twice, bitwise equal)."""
        b, h, w, c, co = spec
        x, wt = randn(b, h, w, c).to(dt), (randn(3, 3, c, co) * c ** -0.5).to(dt)
        bias = randn(co) * 0.1
        report("conv3x3", spec, dt, twice("conv3x3", spec, dt, lambda: ops.conv3x3(x, wt, bias)),
               ops.conv3x3_plain(x.float(), wt.float(), bias), BOUND[str(dt)[6:]])
        if dx:
            g_out = randn(b, h, w, co).to(dt)
            want = torch.nn.grad.conv2d_input((b, c, h, w), wt.float().permute(3, 2, 0, 1),
                                              g_out.float().permute(0, 3, 1, 2), padding=1)
            report("conv3x3_dx", spec, dt,
                   twice("conv3x3_dx", spec, dt, lambda: ops.conv3x3_dx(g_out, wt)),
                   want.permute(0, 2, 3, 1), BOUND[str(dt)[6:]])

    def check_attention(spec, dt):
        """token_attention at `spec` (b, t, s, heads, dh, q/k/v as column
        slices of one fused projection) against the plain version within BOUND."""
        b, t, s, heads, dh, fused = spec
        inner = heads * dh
        if fused:
            q, k, v = randn(b, t, 3 * inner).to(dt).split(inner, dim=-1)
        else:
            q, k, v = (randn(b, n, inner).to(dt) for n in (t, s, s))
        report("token_attention", (b, t, s, heads, dh) + (("qkv",) if fused else ()), dt,
               ops.token_attention(q, k, v, num_heads=heads),
               ops.attention_plain(q.float(), k.float(), v.float(), num_heads=heads),
               BOUND[str(dt)[6:]])

    def check_attention_bwd(spec, dt, bound):
        """attention_lse at `spec` (b, t, s, heads, dh, qkv slices; "odd": q,
        k, v each one element into a wider row): its o and lse against the
        plain forward within BOUND; then dq, dk and dv against the plain
        backward on the kernel's o and lse (cast to fp32) within `bound`."""
        b, t, s, heads, dh, fused = spec
        inner, scale = heads * dh, dh ** -0.5
        if fused == "odd":
            q, k, v = (randn(b, n, inner + 1).to(dt)[..., 1:] for n in (t, s, s))
        elif fused:
            q, k, v = randn(b, t, 3 * inner).to(dt).split(inner, dim=-1)
        else:
            q, k, v = (randn(b, n, inner).to(dt) for n in (t, s, s))
        g_out = randn(b, t, inner).to(dt)
        shape = (b, t, s, heads, dh) + ((fused if fused == "odd" else "qkv",) if fused else ())
        o, lse = twice("attention_lse", shape, dt,
                       lambda: ops.attention_lse(q, k, v, num_heads=heads))
        qf, kf, vf = q.float(), k.float(), v.float()
        report("attention_lse", shape + ("o",), dt, o,
               ops.attention_plain(qf, kf, vf, num_heads=heads), BOUND[str(dt)[6:]])
        report("attention_lse", shape + ("lse",), dt, lse,
               ops.attention_lse_plain(qf, kf, num_heads=heads), BOUND[str(dt)[6:]])
        want = ops.attention_backward_plain(qf, kf, vf, o.float(), lse, g_out.float(), heads, scale)
        args = (q, k, v, g_out, lse, attention_delta(o, g_out, heads))
        dq, route = routed(ops.attention_dq,
                           lambda: ops.attention_dq(*args, num_heads=heads, scale=scale))
        (dk, dv), route_kv = routed(ops.attention_dkv,
                                    lambda: ops.attention_dkv(*args, num_heads=heads, scale=scale))
        if {route, route_kv} != {"f32" if dt == torch.float32 else "wgmma"}:
            fail(f"attention backward {shape} {dt} took {route!r} / {route_kv!r}")
        if s > 1:
            report("attention_dq", shape, dt, dq, want[0], bound)
            report("attention_dkv", shape + ("dk",), dt, dk, want[1], bound)
        else:  # one key: dq and dk are rounding noise on both sides
            lim = S1_BOUND * float(g_out.float().abs().max()) * float(vf.abs().max())
            for name, got, ref in (("attention_dq", dq, want[0]), ("attention_dkv", dk, want[1])):
                torch.cuda.synchronize()
                d = float((got.float() - ref).abs().max())
                max_abs[name] = max(max_abs[name], d)
                ok = d <= lim and bool(torch.isfinite(got).all())
                log(f"  {name} {shape} {str(dt)[6:]} S = 1: max|d| {d:.3e} (absolute bound "
                    f"{S1_BOUND:g} * max|dO| * max|v| = {lim:.3e}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"{name} {shape} {dt} at S = 1 exceeds its absolute bound")
        report("attention_dkv", shape + ("dv",), dt, dv, want[2], bound)

    t0 = time.perf_counter()
    log("kernels vs plain (plain in fp32 on the same inputs, TF32 off):")
    for b, h, w, c, co in [(64, 32, 32, 128, 128), (64, 16, 16, 512, 256),
                           (64, 4, 4, 256, 256), (2, 8, 8, 32, 64), (3, 5, 7, 20, 9),
                           # the SD VAE's ends: 4 latent channels in, 3 image channels out
                           (4, 96, 96, 4, 512), (2, 768, 768, 128, 3), (1, 16, 16, 4, 3),
                           # the guided UNet's and classifier's widest and deepest convs
                           (8, 256, 256, 256, 256), (8, 256, 256, 128, 128),
                           (8, 8, 8, 1024, 1024), (8, 16, 16, 512, 256),
                           # the "wgmma" patches off the 16x8x1 one: SD-2.1's 4x4x8 at
                           # 12x12 and 8x8x2 at 24x24 (several patches each way, 40
                           # channel chunks), SD-1's 8x8x2 at 8x8 b2, path D at b256
                           (8, 12, 12, 2560, 1280), (8, 24, 24, 1920, 1280),
                           (2, 8, 8, 2560, 1280), (256, 8, 8, 512, 256),
                           (256, 32, 32, 384, 128),
                           # CO = 320: the second 128-channel block is half empty
                           (8, 96, 96, 640, 320),
                           # patches past the map on every side, C and CO not
                           # multiples of 64: the store's masks
                           (1, 13, 19, 200, 136), (5, 2, 33, 16, 24)]:
        for dt in (torch.float32, torch.bfloat16):
            # the input gradient at the guided and ragged shapes (path E's: 7b)
            check_conv((b, h, w, c, co), dt, dx=b == 8 or c < 40)
    # (b, t, s, heads, dh, q/k/v as column slices of one fused projection)
    for b, t, s, heads, dh, fused in [
            (64, 256, 256, 1, 256, False), (64, 16, 16, 1, 256, False), (2, 64, 64, 1, 32, False),
            (2, 77, 77, 1, 64, False), (2, 50, 77, 2, 64, False), (3, 33, 129, 4, 128, False),
            # SD-2.1 at 768 px: self- and cross-attention, and the VAE's 512-wide head
            (1, 9216, 9216, 5, 64, False), (8, 9216, 77, 5, 64, False),
            (8, 144, 77, 20, 64, False), (1, 9216, 9216, 1, 512, False),
            (1, 9216, 9216, 5, 64, True), (1, 9216, 9216, 1, 512, True), (2, 100, 100, 1, 512, True),
            # the guided UNet at 32x32, 16x16 and 8x8
            (8, 1024, 1024, 8, 64, False), (8, 256, 256, 16, 64, False), (8, 64, 64, 16, 64, False)]:
        for dt in (torch.float32, torch.bfloat16):
            check_attention((b, t, s, heads, dh, fused), dt)
    def routed(fn, call):
        """call(); the route `fn` counted it under."""
        before = Counter(fn.launches_by_route)
        out = call()
        taken = [r for r, k in (Counter(fn.launches_by_route) - before).items() if k]
        if len(taken) != 1:
            fail(f"{fn.__name__}: one call counted under routes {taken}")
        return out, taken[0]

    # the forward and its lse at the wide presets' head dims (cin256's 384,
    # 576 and 960 with S = 1; 96, 192): o and lse against the plain versions,
    # fp32 launched twice (bitwise equal); each launch on its plan's route
    for b, t, s, heads, dh, fused in WIDE_ATTENTION:
        for dt in (torch.float32, torch.bfloat16):
            inner = heads * dh
            if fused:
                q, k, v = randn(b, t, 3 * inner).to(dt).split(inner, dim=-1)
            else:
                q, k, v = (randn(b, n, inner).to(dt) for n in (t, s, s))
            shape = (b, t, s, heads, dh) + (("qkv",) if fused else ())
            qf, kf, vf = q.float(), k.float(), v.float()
            want = ops.attention_plain(qf, kf, vf, num_heads=heads)
            got, route = routed(ops.token_attention,
                                lambda: ops.token_attention(q, k, v, num_heads=heads))
            report("token_attention", shape + (route,), dt, got, want, BOUND[str(dt)[6:]])
            o, lse = twice("attention_lse", shape, dt,
                           lambda: ops.attention_lse(q, k, v, num_heads=heads))
            report("attention_lse", shape + ("o",), dt, o, want, BOUND[str(dt)[6:]])
            report("attention_lse", shape + ("lse",), dt, lse,
                   ops.attention_lse_plain(qf, kf, num_heads=heads), BOUND[str(dt)[6:]])
            if route != ("f32" if dt == torch.float32 else "wgmma"):
                fail(f"token_attention {shape} {dt} took {route!r}")
            del q, k, v, o, lse, want, got
    torch.cuda.empty_cache()
    # the forward's lse and the backward (dh 64): the guided classifier's
    # blocks at 32x32, 16x16 and 8x8 and its attention pool (qkv slices,
    # T = S = 65); tiny and ragged ones. (S >= 2: with one key ds is 0 and
    # dq, dk are rounding noise, which no relative bound can hold.)
    for spec in [
            (8, 1024, 1024, 4, 64, False), (8, 256, 256, 8, 64, False), (8, 64, 64, 8, 64, False),
            (8, 65, 65, 8, 64, True), (2, 200, 77, 2, 64, False), (1, 50, 130, 1, 64, False),
            (2, 77, 77, 1, 64, False), (1, 5, 5, 2, 64, True)]:
        for dt in (torch.float32, torch.bfloat16):
            check_attention_bwd(spec, dt, BOUND[str(dt)[6:]])
    # the forward's lse and the backward at every other head dim, both
    # dtypes, the backward within tests/test_torch_attention_bwd.py's bounds
    for spec in BWD_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            check_attention_bwd(spec, dt, BWD_BOUND[str(dt)[6:]])
    # fp32 rows 4 bytes off an 8-byte boundary: the fp32 kernel's 4-byte
    # copies (every other check takes its 8-byte ones)
    check_attention_bwd((3, 33, 129, 4, 128, "odd"), torch.float32, BWD_BOUND["float32"])
    # the head dims the forward took for the wide presets: 96 and 192 on the
    # tiles of whole 64-column runs, 384 and 576 in WIDE_DV-column slices,
    # 960 chunked (bf16) and on 8-row tiles (fp32), each also at S = 1
    for spec in WIDE_BWD:
        for dt in (torch.float32, torch.bfloat16):
            if spec[5] != "odd" or dt == torch.float32:
                check_attention_bwd(spec, dt, BWD_BOUND[str(dt)[6:]])
    torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    coef = randn(4, 8)

    def check_fused(shape):
        """fused_update on a state of `shape`, both dtypes, with and without
        the SDE noise term, against the plain version within FUSED_BOUND."""
        for dt in (torch.float32, torch.bfloat16):
            xs = [randn(*shape).to(dt) for _ in range(5)]
            for z in (None, xs[4]):
                report("fused_update", (shape, "z" if z is not None else "ode"), dt,
                       ops.fused_update(coef, 2, *xs[:4], z),
                       ops.fused_update_plain(coef, 2, *[u.float() for u in xs[:4]],
                                              None if z is None else z.float()),
                       FUSED_BOUND[str(dt)[6:]])

    # paths A-D's sizes (C's takes 3 blocks a program, D's 2: one wave) and a ragged one
    for shape in [(BATCH, 32, 32, 3), (1000,), (4, 96, 96, 4),
                  (GUIDED_BATCH, GUIDED_SIZE, GUIDED_SIZE, 3), (SCORE_BATCH, 32, 32, 3)]:
        check_fused(shape)
    # LayerNorm -> Linear and GEGLU at every transformer site of SD-2.1 at
    # 768 px (CFG b8) and SD-1 at 512 px (CFG b2): (m, d) = (batch * tokens,
    # width); M not a multiple of the row tiles; tiny, and ragged (d % 8 != 0:
    # TMA cannot stride, the fused WMMA "wmma" kernels). A bf16 shape runs its plan's
    # route, which must be "wgmma" but for the ragged ones, and where it is,
    # "wmma" too; fp32 runs "f32". The plain version in fp32 on the same
    # inputs (GEGLU's at bf16 inputs rounds the gated tile as the kernels do).
    GE, LN = kernel_modules()
    sd_rows = [(73728, 320), (18432, 640), (4608, 1280), (1152, 1280)]
    sd1_rows = [(8192, 320), (2048, 640), (512, 1280), (128, 1280)]
    # cin256 at CFG b8 (path F): 32x32 at d 384, 16x16 at 576, 8x8 at 960;
    # the retrieval LDM (rdm_768) at CFG b2: its 12x12 level at 1344 and its
    # middle block at 1792, LayerNorm->Linear's row tile in segments there
    cin_rows = [(16384, 384), (4096, 576), (1024, 960), (288, 1344), (72, 1792)]
    odd_rows = [(1000, 320), (100, 640), (1000, 1280)]
    ragged_d = 36

    def expected_route(d, dt):
        return "f32" if dt == torch.float32 else "wmma" if d == ragged_d else "wgmma"

    # the bf16 "narrow" conv route (C or CO % 8 != 0, or off a 16-byte
    # boundary): the SD VAE's conv_in and conv_out (path B's two launches),
    # ragged widths on an odd map, and C = CO = 64 one element past an
    # aligned base; forward and dx, each counted under "narrow", within the
    # bf16 bound against the plain conv in fp32 on the same values
    def bf16_at(shape, offset):
        """A bf16 tensor of `shape` starting `offset` elements into its storage."""
        return randn(math.prod(shape) + offset).to(torch.bfloat16)[offset:].view(shape)

    # (and, since path G and F, the SD VAE encoder's conv_in 3 -> 128 at 768 px
    # and the VQ-f4 decoder's ends, 3 -> 512 at 64x64 and 128 -> 3 at 256 px)
    for spec, offset in chain([((4, 96, 96, 4, 512), 0), ((4, 768, 768, 128, 3), 0),
                               ((4, 768, 768, 3, 128), 0), ((8, 64, 64, 3, 512), 0),
                               ((8, 256, 256, 128, 3), 0)],
                              [((2, 7, 9, c, co), 0) for c in (1, 3, 4, 5, 12)
                               for co in (3, 4, 6, 20, 512)],
                              [((3, 5, 7, 64, 64), 1)]):
        b, h, w, c, co = spec
        x, g_out = bf16_at((b, h, w, c), offset), bf16_at((b, h, w, co), offset)
        wt = (randn(3, 3, c, co) * c ** -0.5).to(torch.bfloat16)
        bias = randn(co) * 0.1
        label = spec + (("narrow", "unaligned") if offset else ("narrow",))
        got, route = routed(ops.conv3x3, lambda: ops.conv3x3(x, wt, bias))
        got_dx, route_dx = routed(ops.conv3x3_dx, lambda: ops.conv3x3_dx(g_out, wt))
        if (route, route_dx) != ("narrow", "narrow"):
            fail(f"conv3x3 {spec} (offset {offset}) took {route!r}, its dx {route_dx!r}")
        report("conv3x3", label, torch.bfloat16, got,
               ops.conv3x3_plain(x.float(), wt.float(), bias), BOUND["bfloat16"])
        want = torch.nn.grad.conv2d_input((b, c, h, w), wt.float().permute(3, 2, 0, 1),
                                          g_out.float().permute(0, 3, 1, 2), padding=1)
        report("conv3x3_dx", label, torch.bfloat16, got_dx, want.permute(0, 2, 3, 1),
               BOUND["bfloat16"])
        del x, g_out, got, got_dx, want
    torch.cuda.empty_cache()

    def check_ln_linear(m, d, n, dt, bias):
        """ln_linear at (m, d, n) on its plan's route (and, where that is
        "wgmma" and the row tile fits, on "wmma" too) against the plain version."""
        x, w = randn(m, d).to(dt), (randn(n, d) * d ** -0.5).to(dt)
        gam, bet = 1 + 0.1 * randn(d), 0.1 * randn(d)
        bb = randn(n) * 0.1 if bias else None
        want = ops.ln_linear_plain(x.float(), gam, bet, w.float(), bb)
        got, route = routed(ops.ln_linear, lambda: ops.ln_linear(x, gam, bet, w, bb))
        if route != expected_route(d, dt):
            fail(f"ln_linear {(m, d, n)} {dt} took {route!r}")
        seg = LN.ln_linear_plan(m, d, n, dt).seg if route == "wgmma" else 0
        report("ln_linear", (m, d, n, route) + ((f"seg {seg}",) if seg else ()), dt, got,
               want, BOUND[str(dt)[6:]])
        if route == "wgmma" and d <= LN.MAX_D:  # "wmma" keeps 64 rows resident
            plan = dataclasses.replace(LN.ln_linear_plan(m, d, n, dt), route="wmma")
            report("ln_linear", (m, d, n, "wmma"), dt,
                   LN.ln_linear_launch(x, gam, bet, w, bb, 1e-5, plan), want,
                   BOUND[str(dt)[6:]])

    def check_geglu(m, d, inner, dt):
        """geglu_ff at (m, d, inner), as check_ln_linear."""
        x, w1 = randn(m, d).to(dt), (randn(2 * inner, d) * d ** -0.5).to(dt)
        w2 = (randn(d, inner) * inner ** -0.5).to(dt)
        b1, b2 = randn(2 * inner) * 0.1, randn(d) * 0.1
        want = ops.geglu_plain(x, w1, b1, w2, b2)
        got, route = routed(ops.geglu_ff, lambda: ops.geglu_ff(x, w1, b1, w2, b2))
        if route != expected_route(d, dt):
            fail(f"geglu_ff {(m, d, inner)} {dt} took {route!r}")
        plan = GE.geglu_plan(m, d, inner, dt)
        tiles = (f"rows {plan.gate_rows}/{plan.down_rows} split {plan.splits}",) \
            if route == "wgmma" else ()
        report("geglu_ff", (m, d, inner, route) + tiles, dt, got, want, BOUND[str(dt)[6:]])
        if route == "wgmma" and d <= GE.MAX_D:  # "wmma" keeps 64 rows resident
            report("geglu_ff", (m, d, inner, "wmma"), dt,
                   GE.geglu_launch(x, w1, b1, w2, b2, dataclasses.replace(plan, route="wmma")),
                   want, BOUND[str(dt)[6:]])

    for (m, d), bias in chain(((r, False) for r in sd_rows + sd1_rows + cin_rows),
                              ((r, True) for r in odd_rows + [(100, 32), (1000, ragged_d)])):
        for n in (3 * d, d) if d > 40 else (96 if d == 32 else 70,):
            for dt in (torch.float32, torch.bfloat16):
                check_ln_linear(m, d, n, dt, bias)
    for m, d, inner in [(m, d, 4 * d) for m, d in sd_rows + sd1_rows + cin_rows + odd_rows] \
            + [(100, 32, 128), (300, ragged_d, 100)]:
        for dt in (torch.float32, torch.bfloat16):
            check_geglu(m, d, inner, dt)
    # gradients on the card: the autograd Functions of ln_linear and geglu_ff
    # (their forward on the kernels, their backward the recompute VJP of the
    # plain twin) against autograd of the plain twin on the same inputs, at
    # path B's middle site and SD-1's first, bf16 and fp32
    for m, d in [(1152, 1280), (8192, 320)]:
        for dt in (torch.float32, torch.bfloat16):
            bound = BOUND[str(dt)[6:]]
            n, inner = 3 * d, 4 * d
            cases = {
                "ln_linear": (ops.ln_linear, ops.ln_linear_plain,
                              (randn(m, d).to(dt), 1 + 0.1 * randn(d), 0.1 * randn(d),
                               (randn(n, d) * d ** -0.5).to(dt), 0.1 * randn(n)),
                              ("dx", "dgamma", "dbeta", "dw", "dbias"), (m, n)),
                "geglu_ff": (ops.geglu_ff, ops.geglu_plain,
                             (randn(m, d).to(dt), (randn(2 * inner, d) * d ** -0.5).to(dt),
                              0.1 * randn(2 * inner), (randn(d, inner) * inner ** -0.5).to(dt),
                              0.1 * randn(d)),
                             ("dx", "dw1", "db1", "dw2", "db2"), (m, d))}
            for name, (fn, plain, args, names, out_shape) in cases.items():
                cot = randn(*out_shape).to(dt)
                with torch.enable_grad():
                    ins = [a.clone().requires_grad_(True) for a in args]
                    before = fn.launches
                    out = fn(*ins)
                    if out.grad_fn is None or fn.launches != before + 1:
                        fail(f"{name} on the card: no gradient, or no kernel launch")
                    got = torch.autograd.grad(out, ins, cot)
                    ref = [a.clone().requires_grad_(True) for a in args]
                    want = torch.autograd.grad(plain(*ref), ref, cot)
                for what, a, b in zip(names, got, want):
                    report(f"{name}_grad", (m, d, what), dt, a, b, bound)
                del args, ins, out, got, ref, want
    torch.cuda.empty_cache()
    # bias + scaled LeakyReLU, forward and backward (dx, and db summed from
    # it), against the plain version's autograd in fp32: path D's activation
    # shapes, ragged row counts (no block multiple), 3 to 512 channels, and
    # non-default slopes and scales
    for shape, slope, gain in [((SCORE_BATCH, 32, 32, 128), 0.2, math.sqrt(2.0)),
                               ((SCORE_BATCH, 16, 16, 256), 0.2, math.sqrt(2.0)),
                               ((1000, 3), 0.1, 1.5), ((77, 512), 0.3, 0.7),
                               ((3, 5, 7, 20), 0.05, 2.0)]:
        for dt in (torch.float32, torch.bfloat16):
            x, bias, g_out = randn(*shape).to(dt), randn(shape[-1]) * 0.1, randn(*shape).to(dt)
            with torch.enable_grad():
                xs, bs = x.requires_grad_(True), bias.requires_grad_(True)
                out = ops.fused_bias_act(xs, bs, slope, gain)
                dx, db = torch.autograd.grad(out, (xs, bs), g_out)
                xf, bf = x.detach().float().requires_grad_(True), bias.detach().requires_grad_(True)
                want = ops.bias_act_plain(xf, bf, slope, gain)
                want_dx, want_db = torch.autograd.grad(want, (xf, bf), g_out.float())
            bound = FUSED_BOUND[str(dt)[6:]]
            report("fused_bias_act", shape, dt, out.detach(), want.detach(), bound)
            report("fused_bias_act_bwd", shape + ("dx",), dt, dx, want_dx, bound)
            report("fused_bias_act_bwd", shape + ("db",), dt, db, want_db, bound)
            del x, g_out, out, dx, want, want_dx
    # attention -> out-projection (+ bias) -> + residual: the SD-2.1 768 px
    # self-attention sites at CFG b8 (96x96 and 48x48; 24x24 and 12x12, 20
    # heads: H*dh = 1280), cross-attention (S = 77), ragged T and S, q/k/v as
    # column slices of one projection, H*dh = 1024, with and without bias;
    # SD-1's self-attention sites at 512 px, CFG b2 (64x64 ... 8x8: dh 40, 80,
    # 160, 160), a cross-attention case at each of those head dims; single
    # heads of dh 256 (DDPM/NCSN++ at 16x16) and dh 512 (the VAE's middle at
    # 256 px). Each launch's tile and cluster logged. The plain version in
    # fp32, one batch element at a time (its logits at 9216 tokens are 1.7 GB)
    for b, t, s, heads, dh, c, with_bias, fused in [
            (8, 9216, 9216, 5, 64, 320, True, False), (8, 2304, 2304, 10, 64, 640, True, False),
            (8, 9216, 77, 5, 64, 320, False, False), (2, 100, 77, 2, 64, 96, False, False),
            (2, 100, 100, 2, 64, 96, True, True), (3, 65, 200, 16, 64, 1024, True, False),
            (1, 5, 5, 1, 64, 8, False, False),
            (8, 576, 576, 20, 64, 1280, True, False), (8, 144, 144, 20, 64, 1280, True, False),
            (2, 4096, 4096, 8, 40, 320, True, False), (2, 1024, 1024, 8, 80, 640, True, False),
            (2, 256, 256, 8, 160, 1280, True, False), (2, 64, 64, 8, 160, 1280, True, False),
            (2, 4096, 77, 8, 40, 320, False, False), (2, 1024, 77, 8, 80, 640, True, False),
            (2, 256, 77, 8, 160, 1280, True, False),
            (8, 256, 256, 1, 256, 256, True, True), (1, 1024, 1024, 1, 512, 512, True, False)]:
        for dt in (torch.float32, torch.bfloat16):
            inner = heads * dh
            if fused:
                q, k, v = randn(b, t, 3 * inner).to(dt).split(inner, dim=-1)
            else:
                q, k, v = (randn(b, n, inner).to(dt) for n in (t, s, s))
            w, res = (randn(inner, c) * inner ** -0.5).to(dt), randn(b, t, c).to(dt)
            bias = randn(c) * 0.1 if with_bias else None
            tile = out_plan(dh, inner, c, dt, b, t, s)
            got, route = routed(ops.attention_out_fused,
                                lambda: ops.attention_out_fused(q, k, v, w, bias, res, heads))
            if route != tile.route:
                fail(f"attention_out_fused {(b, t, s, heads, dh, c)} {dt} took {route!r}")
            want = torch.cat([ops.attention_out_plain(
                q[i:i + 1].float(), k[i:i + 1].float(), v[i:i + 1].float(), w.float(), bias,
                res[i:i + 1].float(), num_heads=heads) for i in range(b)])
            report("attention_out_fused", (b, t, s, heads, dh, c)
                   + (("bias",) if with_bias else ()) + (("qkv",) if fused else ())
                   + (f"{route} rows {tile.rows} kv {tile.block_kv} stages {tile.stages} "
                      f"cluster {tile.cluster}",), dt, got, want, BOUND[str(dt)[6:]])
            del q, k, v, w, res, got, want
    # its gradient on the card at dh 40 (SD-1's 64x64 level, cross-attention):
    # the autograd Function (forward on the kernel, backward the recompute VJP
    # through token_attention's lse, dq and dk/dv kernels) against autograd of
    # the plain version on the same inputs in fp32, within the attention
    # backward's bound
    b, t, s, heads, dh, c = 2, 1024, 77, 8, 40, 320
    for dt in (torch.float32, torch.bfloat16):
        inner = heads * dh
        args = [randn(b, t, inner).to(dt), randn(b, s, inner).to(dt), randn(b, s, inner).to(dt),
                (randn(inner, c) * inner ** -0.5).to(dt), randn(c) * 0.1, randn(b, t, c).to(dt)]
        cot = randn(b, t, c).to(dt)
        with torch.enable_grad():
            ins = [a.clone().requires_grad_(True) for a in args]
            before = ops.attention_out_fused.launches
            out = ops.attention_out_fused(*ins, heads)
            if out.grad_fn is None or ops.attention_out_fused.launches != before + 1:
                fail("attention_out_fused on the card: no gradient, or no kernel launch")
            got = torch.autograd.grad(out, ins, cot)
            ref = [a.float().clone().requires_grad_(True) for a in args]
            want = torch.autograd.grad(ops.attention_out_plain(*ref, num_heads=heads), ref,
                                       cot.float())
        for what, a_, b_ in zip(("dq", "dk", "dv", "dw", "dbias", "dres"), got, want):
            report("attention_out_fused_grad", (b, t, s, heads, dh, c, what), dt, a_, b_,
                   BWD_BOUND[str(dt)[6:]])
        del args, ins, out, got, ref, want
    torch.cuda.empty_cache()
    # SD-1 at 512 px, CFG b2, 8 heads: self-attention at each level (64x64,
    # 32x32, 16x16 and the 8x8 middle), cross-attention to the 77 context
    # tokens, a ragged case and q/k/v as column slices of one projection at
    # each new head dim; the output, and the lse from the same kernel
    for b, t, s, heads, dh, fused in chain(
            [(2, 4096, 4096, 8, 40, False), (2, 1024, 1024, 8, 80, False),
             (2, 256, 256, 8, 160, False), (2, 64, 64, 8, 160, False)],
            [(2, t, 77, 8, dh, False) for t, dh in ((4096, 40), (1024, 80), (256, 160))],
            [(3, 333, 77 + dh, 2, dh, False) for dh in (40, 80, 160)],
            [(2, 300, 300, 8, dh, True) for dh in (40, 80, 160)]):
        for dt in (torch.float32, torch.bfloat16):
            inner = heads * dh
            if fused:
                q, k, v = randn(b, t, 3 * inner).to(dt).split(inner, dim=-1)
            else:
                q, k, v = (randn(b, n, inner).to(dt) for n in (t, s, s))
            shape = (b, t, s, heads, dh) + (("qkv",) if fused else ())
            qf, kf, vf = q.float(), k.float(), v.float()
            want = ops.attention_plain(qf, kf, vf, num_heads=heads)
            report("token_attention", shape, dt, ops.token_attention(q, k, v, num_heads=heads),
                   want, BOUND[str(dt)[6:]])
            o, lse = ops.attention_lse(q, k, v, num_heads=heads)
            report("attention_lse", shape + ("o",), dt, o, want, BOUND[str(dt)[6:]])
            report("attention_lse", shape + ("lse",), dt, lse,
                   ops.attention_lse_plain(qf, kf, num_heads=heads), BOUND[str(dt)[6:]])
            del q, k, v, o, lse, want
    torch.cuda.empty_cache()
    log(f"kernel checks: {time.perf_counter() - t0:.1f} s")

    # one full-width SD-1 UNet forward on the card: head dims 40, 80 and 160
    t0 = time.perf_counter()
    s1cfg = ADMConfig.sd_v1()
    s1 = init_random_(ADMUNet(s1cfg, compute_dtype=torch.bfloat16, device=dev),
                      torch.Generator(device=dev).manual_seed(0)).eval()
    n_s1 = sum(p.numel() for p in s1.parameters())
    ctx1 = constant_context_encoder(s1cfg.context_dim)(SD_PROMPTS[:1] + [""]).to(dev)
    z1 = torch.randn(2, 64, 64, 4, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    ops.reset_launch_counts()
    eps1 = s1(z1, torch.full((2,), 500.0, device=dev), None, ctx1)
    torch.cuda.synchronize()
    launches_s1 = ops.launch_counts()
    routes_s1 = ops.launch_routes()
    check_routes("SD-1", launches_s1, routes_s1)
    # its kernel specs, for the timing phase
    s1_calls = record_sd_calls(s1, None, lambda: s1(z1, torch.full((2,), 500.0, device=dev), None,
                                                     ctx1))[0]
    expected = {name: 0 for name in REPLACES}
    expected.update(adm_unet_launches(s1cfg))
    log(f"SD-1 UNet ({n_s1 / 1e6:.2f}M params, bf16, 8 heads: dh 40/80/160), one forward at "
        f"64x64 latents, CFG b2, {time.perf_counter() - t0:.1f} s with its set-up: launches "
        f"{launches_s1} (expected {expected})")
    if launches_s1 != expected:
        fail(f"SD-1 launch counts {launches_s1} != {expected}")
    if eps1.shape != z1.shape or not torch.isfinite(eps1).all():
        fail(f"SD-1 output {tuple(eps1.shape)} is not finite of the latents' shape")
    log(f"  output {tuple(eps1.shape)} finite, std {eps1.float().std().item():.4f}")
    del s1, eps1
    torch.cuda.empty_cache()

    # ---- 4. path A: CIFAR-10 -------------------------------------------------
    log(f"[{time.perf_counter() - t_start:.1f} s] phase 4")
    cfg = DDPMUNetConfig.cifar10()
    net_cpu = init_random_(DDPMUNet(cfg, device="cpu"), torch.Generator().manual_seed(0)).eval()
    n_params = sum(p.numel() for p in net_cpu.parameters())
    net = DDPMUNet(cfg, compute_dtype=torch.bfloat16, device=dev).eval()
    net.load_state_dict(net_cpu.state_dict())
    ns = P.NoiseScheduleVP.discrete(betas=np.linspace(1e-4, 0.02, 1000))
    solver = P.DPM_Solver(P.model_wrapper(net, ns, model_type="noise"), ns,
                          algorithm_type="dpmsolver++")
    sample_kw = dict(steps=STEPS, order=ORDER, method="multistep", skip_type="logSNR")
    x_T = torch.randn(BATCH, cfg.resolution, cfg.resolution, 3, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(1))

    # conv3x3 shapes of one forward, for the timing phase
    conv_calls = Counter()
    hooks = [m.register_forward_pre_hook(
        lambda m, a: conv_calls.update([(*a[0].shape, m.weight.shape[0])]))
        for m in net.modules() if isinstance(m, ops.Conv3x3)]
    net(x_T.to(torch.bfloat16), torch.full((BATCH,), 500.0, device=dev))
    for hk in hooks:
        hk.remove()

    log(f"path A: CIFAR-10 DDPM UNet ({n_params / 1e6:.2f}M params, bf16 compute), "
        f"b{BATCH}, DPM-Solver++ {ORDER}M, {STEPS} NFE, logSNR, discrete betas")
    ops.reset_launch_counts()
    out = solver.sample(x_T, jit=False, **sample_kw)
    torch.cuda.synchronize()
    launches_a, routes_a = ops.launch_counts(), ops.launch_routes()
    expected = {name: 0 for name in REPLACES}
    expected.update(conv3x3=STEPS * 47, token_attention=STEPS * 6, fused_update=STEPS)
    log(f"  launches {launches_a} (expected {expected})")
    if launches_a != expected:
        fail(f"path A launch counts {launches_a} != {expected}")
    check_routes("path A", launches_a, routes_a)
    if out.shape != x_T.shape or out.dtype != torch.float32 or not torch.isfinite(out).all():
        fail(f"path A output {tuple(out.shape)} {out.dtype} is not finite fp32 of x_T's shape")
    log(f"  output {tuple(out.shape)} finite, max|x| {out.abs().max().item():.4f}")
    check_graphed("path A", lambda: solver.sample(x_T, jit=True, **sample_kw), out, expected)

    # batch 4 in fp32: kernels on the card against the plain ops on the CPU,
    # and the trajectory replayed from its CUDA graph against the eager one
    net32 = DDPMUNet(cfg, device=dev).eval()
    net32.load_state_dict(net_cpu.state_dict())
    x4 = x_T[:4].float()
    solver32 = P.DPM_Solver(P.model_wrapper(net32, ns), ns)
    got = solver32.sample(x4, jit=False, **sample_kw)
    t0 = time.perf_counter()
    want = P.DPM_Solver(P.model_wrapper(net_cpu, ns), ns).sample(x4.cpu(), **sample_kw)
    d, r = rel_err(got.cpu(), want)
    log(f"  b4 fp32 kernels (card) vs plain (cpu, {time.perf_counter() - t0:.1f} s): "
        f"max|d| {d:.3e}, /max|x| {r:.3e} (bound {SLICE_BOUND:g})")
    if not r <= SLICE_BOUND:
        fail("the fp32 CIFAR-10 path on the card disagrees with the plain path")
    x4b = torch.randn(x4.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(9))
    check_replays("path A fp32 b4", lambda u: solver32.sample(u, jit=True, **sample_kw),
                  lambda u: solver32.sample(u, jit=False, **sample_kw), [x4, x4b], got)
    # the intermediates come out of the graph too (another key)
    graphed_mid = solver32.sample(x4b, jit=True, return_intermediate=True, **sample_kw)
    eager_mid = solver32.sample(x4b, jit=False, return_intermediate=True, **sample_kw)
    pairs = list(zip([graphed_mid[0], *graphed_mid[1]], [eager_mid[0], *eager_mid[1]]))
    r = max(rel_err(u, v)[1] for u, v in pairs)
    ok = len(graphed_mid[1]) == len(eager_mid[1]) == STEPS + 1 and r <= GRAPH_BOUND
    log(f"  path A fp32 b4, return_intermediate: {len(pairs)} tensors, graphed vs eager on the "
        f"card /max|x| {r:.3e} (bound {GRAPH_BOUND:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("path A fp32: the replayed intermediates disagree with the eager ones")
    # an SDE solver on the same net: x and the noise are both the graph's inputs
    sde32 = P.DPM_Solver(P.model_wrapper(net32, ns), ns, algorithm_type="sde-dpmsolver++")
    sde_kw = dict(steps=STEPS, order=2, method="multistep", skip_type="time_uniform")
    z1, z2 = (torch.randn((STEPS, *x4.shape), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(seed))
              for seed in (10, 11))
    check_replays("path A fp32 b4, SDE-DPM-Solver++ 2M",
                  lambda u: sde32.sample(u[0], noise=u[1], jit=True, **sde_kw),
                  lambda u: sde32.sample(u[0], noise=u[1], jit=False, **sde_kw),
                  [(x4, z1), (x4b, z2)])
    del net32, net_cpu, solver32, sde32

    # ---- 5. path B: Stable Diffusion 2.1 txt2img ------------------------------
    log(f"[{time.perf_counter() - t_start:.1f} s] phase 5")
    t0 = time.perf_counter()
    ucfg, vcfg = ADMConfig.sd_v2_1(), VAEConfig.sd_v1()
    gw = torch.Generator(device=dev).manual_seed(0)
    unet = init_random_(ADMUNet(ucfg, compute_dtype=torch.bfloat16, device=dev), gw).eval()
    vae = init_random_(AutoencoderKL(vcfg, compute_dtype=torch.bfloat16, device=dev), gw).eval()
    n_unet = sum(p.numel() for p in unet.parameters())
    n_vae = sum(p.numel() for p in vae.parameters())
    encode = constant_context_encoder(ucfg.context_dim)
    pipe = StableDiffusionPipeline(LatentDiffusion(unet, vae, text_encode=encode,
                                                   parameterization="v"), device=dev)
    sd_kw = dict(steps=SD_STEPS, guidance_scale=SD_SCALE, height=SD_SIZE, width=SD_SIZE)
    torch.cuda.synchronize()
    log(f"path B: SD-2.1 UNet ({n_unet / 1e6:.2f}M params) + KL VAE ({n_vae / 1e6:.2f}M), "
        f"bf16 compute, seeded random weights, built in {time.perf_counter() - t0:.1f} s; "
        f"txt2img b{len(SD_PROMPTS)} {SD_SIZE}x{SD_SIZE}, DPM-Solver++ 2M, {SD_STEPS} NFE, "
        f"time_uniform, CFG {SD_SCALE}, v-prediction")

    # the sampler's launches (20 UNet forwards, 20 fused updates) and the
    # VAE decode's, which stays outside the graph
    sampler_b = Counter({name: n * SD_STEPS for name, n in adm_unet_launches(ucfg).items()})
    sampler_b["fused_update"] = SD_STEPS
    sampler_b = {name: sampler_b[name] for name in REPLACES}
    decode_b = {name: vae_decoder_launches(vcfg)[name] for name in REPLACES}
    expected = {name: sampler_b[name] + decode_b[name] for name in REPLACES}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    img = pipe.txt2img(SD_PROMPTS, generator=torch.Generator(device=dev).manual_seed(1),
                       jit=False, **sd_kw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches_b, routes_b = ops.launch_counts(), ops.launch_routes()
    log(f"  launches {launches_b} (expected {expected}); first call {first_s:.2f} s")
    if launches_b != expected:
        fail(f"path B launch counts {launches_b} != {expected}")
    # the VAE's conv_in (C = 4) and conv_out (CO = 3) take the "narrow" route
    check_routes("path B", launches_b, routes_b, narrow_convs=2)
    shape = (len(SD_PROMPTS), SD_SIZE, SD_SIZE, 3)
    if tuple(img.shape) != shape or not torch.isfinite(img).all() \
            or img.min() < 0 or img.max() > 1:
        fail(f"path B images {tuple(img.shape)} are not finite {shape} in [0, 1]")
    log(f"  images {tuple(img.shape)} finite in [0, 1]: mean {img.mean().item():.4f}, "
        f"std {img.std().item():.4f}")
    check_graphed("path B", lambda: pipe.txt2img(
        SD_PROMPTS, generator=torch.Generator(device=dev).manual_seed(1), jit=True, **sd_kw),
        img, sampler_b, decode_b)

    # fp32 at 16x16 latents, b1, CFG, 3 NFE: kernels on the card vs plain on the CPU
    t0 = time.perf_counter()
    nets = {}
    for where in (dev, torch.device("cpu")):
        u = ADMUNet(ucfg, device=where).eval()
        u.load_state_dict(unet.state_dict())
        a = AutoencoderKL(vcfg, device=where).eval()
        a.load_state_dict(vae.state_dict())
        nets[where.type] = StableDiffusionPipeline(LatentDiffusion(
            u, a, text_encode=encode, parameterization="v"), device=where)
    z_T = torch.randn(1, 16, 16, 4, generator=torch.Generator().manual_seed(2))
    result = {}
    for where, p in nets.items():
        t1 = time.perf_counter()
        cond = p.model.get_learned_conditioning(SD_PROMPTS[:1])
        uncond = p.model.get_learned_conditioning([""])
        z, _ = p.sampler.sample(3, 1, (16, 16, 4), cond, unconditional_guidance_scale=SD_SCALE,
                                unconditional_conditioning=uncond, x_T=z_T,
                                return_intermediate=False, jit=False)
        result[where] = (z.cpu(), p.model.decode_first_stage(z).cpu())
        log(f"  fp32 b1 16x16 latents, 3 NFE on {where}: {time.perf_counter() - t1:.1f} s")
    for i, what in enumerate(("latents", "decoded image")):
        d, r = rel_err(result["cuda"][i], result["cpu"][i])
        ok = r <= SLICE_BOUND and bool(torch.isfinite(result["cuda"][i]).all())
        log(f"  {what}, kernels (card) vs plain (cpu): max|d| {d:.3e}, /max|x| {r:.3e} "
            f"(bound {SLICE_BOUND:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"the fp32 SD path on the card disagrees with the plain path ({what})")
    # the sampler replayed from its graph against the eager one on the card:
    # x_T and the first prompt, then another x_T and another prompt's
    # context at the same shapes (a replay with the new conditioning copied in)
    p32 = nets["cuda"]
    uncond32 = p32.model.get_learned_conditioning([""])

    def sd_sample(inputs, jit):
        z, prompt = inputs
        cond = p32.model.get_learned_conditioning([prompt])
        return p32.sampler.sample(3, 1, (16, 16, 4), cond, unconditional_guidance_scale=SD_SCALE,
                                  unconditional_conditioning=uncond32, x_T=z,
                                  return_intermediate=False, jit=jit)[0]

    z_T2 = torch.randn(1, 16, 16, 4, generator=torch.Generator().manual_seed(4))
    check_replays("path B fp32 b1", lambda u: sd_sample(u, True), lambda u: sd_sample(u, False),
                  [(z_T, SD_PROMPTS[0]), (z_T2, SD_PROMPTS[1])], result["cuda"][0].to(dev))
    del nets, result, p32
    torch.cuda.empty_cache()
    log(f"  fp32 trajectory check: {time.perf_counter() - t0:.1f} s")

    # ---- 5b. path G: SD-2.1 768 px img2img and inpaint --------------------------
    log(f"[{time.perf_counter() - t_start:.1f} s] phase 5b")
    # path B's networks (bf16): img2img at strength I2I_STRENGTH and inpaint
    # with seeded rectangular masks, b4, CFG; the VAE encoder runs on the card
    t0 = time.perf_counter()
    b_g = len(SD_PROMPTS)
    steps_g = max(1, int(SD_STEPS * I2I_STRENGTH))
    init_g = torch.rand(b_g, SD_SIZE, SD_SIZE, 3, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(5)) * 2 - 1
    mask_g = inpaint_masks(b_g, SD_SIZE, seed=6).to(dev)
    unet_n = adm_unet_launches(ucfg)
    enc_g = {name: vae_encoder_launches(vcfg)[name] for name in REPLACES}
    once_g = {name: enc_g[name] + decode_b[name] for name in REPLACES}

    def sampler_launches(per_forward, steps):
        out = {name: per_forward[name] * steps for name in REPLACES}
        out["fused_update"] = steps
        return out

    g_calls = {
        "img2img": (lambda jit: pipe.img2img(
            init_g, SD_PROMPTS, strength=I2I_STRENGTH, steps=SD_STEPS, guidance_scale=SD_SCALE,
            generator=torch.Generator(device=dev).manual_seed(7), jit=jit), steps_g),
        "inpaint": (lambda jit: pipe.inpaint(
            init_g, mask_g, SD_PROMPTS, steps=SD_STEPS, guidance_scale=SD_SCALE,
            generator=torch.Generator(device=dev).manual_seed(8), jit=jit), SD_STEPS)}
    log(f"path G: path B's networks (bf16); img2img b{b_g} {SD_SIZE}x{SD_SIZE} at strength "
        f"{I2I_STRENGTH} ({steps_g} of {SD_STEPS} steps) and inpaint b{b_g} ({SD_STEPS} steps, "
        f"one seeded rectangle a mask), CFG {SD_SCALE}, v-prediction, DPM-Solver++ 2M; each "
        f"encodes its images with the VAE encoder")
    launches_g = routes_g = None
    for what, (call, steps) in g_calls.items():
        sampler = sampler_launches(unet_n, steps)
        expected_run = {name: sampler[name] + once_g[name] for name in REPLACES}
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        img = call(False)
        torch.cuda.synchronize()
        launches_run, routes_run = ops.launch_counts(), ops.launch_routes()
        log(f"  {what}: launches {launches_run} (expected {expected_run}); first call "
            f"{time.perf_counter() - t1:.2f} s")
        if launches_run != expected_run:
            fail(f"path G {what} launch counts {launches_run} != {expected_run}")
        # the encoder's conv_in (C = 3), the decoder's conv_in (C = 4) and conv_out (CO = 3)
        check_routes(f"path G {what}", launches_run, routes_run, narrow_convs=3)
        if tuple(img.shape) != (b_g, SD_SIZE, SD_SIZE, 3) or not torch.isfinite(img).all() \
                or img.min() < 0 or img.max() > 1:
            fail(f"path G {what} images {tuple(img.shape)} are not finite in [0, 1]")
        log(f"  {what} images {tuple(img.shape)} finite in [0, 1]: mean {img.mean().item():.4f}, "
            f"std {img.std().item():.4f}")
        if what == "img2img":
            launches_g, routes_g = launches_run, routes_run
        else:  # the kept region is the init image itself
            keep = (mask_g == 0)[..., None].expand_as(img)
            d = (img - ((init_g + 1) / 2).clamp(0, 1))[keep].abs().max().item()
            log(f"  inpaint, kept pixels against the init image: max|d| {d:.3e}")
            if d > 1e-6:
                fail("path G inpaint changed pixels its mask keeps")
        check_graphed(f"path G {what}", lambda: call(True), img, sampler, once_g)
    log(f"  path G (bf16 b{b_g}): {time.perf_counter() - t0:.1f} s")

    # fp32 at 16x16 latents (128 px), b1: img2img and inpaint, kernels on the
    # card vs plain on the CPU; then a second inpaint call with another image,
    # mask and noise at the same shapes replays the first's graph, within
    # GRAPH_BOUND of its own eager call: the graph reads each call's blend table
    t0 = time.perf_counter()
    nets_g = {}
    for where in (dev, torch.device("cpu")):
        u = ADMUNet(ucfg, device=where).eval()
        u.load_state_dict(unet.state_dict())
        a = AutoencoderKL(vcfg, device=where).eval()
        a.load_state_dict(vae.state_dict())
        nets_g[where.type] = StableDiffusionPipeline(LatentDiffusion(
            u, a, text_encode=encode, parameterization="v"), device=where)
    gs = torch.Generator().manual_seed(9)
    small = [(torch.rand(1, 128, 128, 3, generator=gs) * 2 - 1, inpaint_masks(1, 128, seed=10 + i),
              torch.randn(4, 1, 16, 16, 4, generator=gs), torch.randn(1, 1, 16, 16, 4, generator=gs),
              SD_PROMPTS[i]) for i in range(2)]

    def small_g(p, inputs, what, jit):
        x, m, n_inp, n_i2i, prompt = inputs
        if what == "img2img":
            return p.img2img(x, [prompt], strength=I2I_STRENGTH, steps=4, guidance_scale=SD_SCALE,
                             noise=n_i2i, jit=jit)
        return p.inpaint(x, m, [prompt], steps=3, guidance_scale=SD_SCALE, noise=n_inp, jit=jit)

    result = {}
    for where, p in nets_g.items():
        t1 = time.perf_counter()
        result[where] = {what: small_g(p, small[0], what, False).cpu()
                         for what in ("img2img", "inpaint")}
        log(f"  fp32 b1 128 px img2img (3 NFE) and inpaint (3 NFE) on {where}: "
            f"{time.perf_counter() - t1:.1f} s")
    for what in ("img2img", "inpaint"):
        d, r = rel_err(result["cuda"][what], result["cpu"][what])
        ok = r <= SLICE_BOUND and bool(torch.isfinite(result["cuda"][what]).all())
        log(f"  {what} images, kernels (card) vs plain (cpu): max|d| {d:.3e}, /max|x| {r:.3e} "
            f"(bound {SLICE_BOUND:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"the fp32 {what} path on the card disagrees with the plain path")
    p32 = nets_g["cuda"]
    check_replays("path G fp32 b1 inpaint", lambda u: small_g(p32, u, "inpaint", True),
                  lambda u: small_g(p32, u, "inpaint", False), small,
                  result["cuda"]["inpaint"].to(dev))
    log(f"  fp32 checks: {time.perf_counter() - t0:.1f} s")

    del nets_g, p32, result
    torch.cuda.empty_cache()

    # DiffEdit at SD-2.1 width, 512 px, b1, encode ratio 0.5, the stochastic
    # encoding, on path B's networks (bf16; fp32 at 512 px takes minutes):
    # finite, and the edit replayed from its graph (the first graphed call
    # captures, the second replays) equal to the eager edit within
    # GRAPH_BOUND of max|x|
    t0 = time.perf_counter()
    sampler_de = DPMSolverSampler(pipe.model)
    gd = torch.Generator().manual_seed(11)
    lat_de = DIFFEDIT_SIZE // 8
    x_de = torch.rand(1, DIFFEDIT_SIZE, DIFFEDIT_SIZE, 3, generator=gd) * 2 - 1
    de_noise = (torch.randn(1, 3, lat_de, lat_de, 4, generator=gd),
                torch.randn(SD_STEPS + 1, 1, lat_de, lat_de, 4, generator=gd))
    de_call = lambda jit: diffedit(
        pipe.model, x_de, "a photograph of a cat", "a photograph of a dog",
        encode_ratio=DIFFEDIT_RATIO, steps=SD_STEPS, guidance_scale=SD_SCALE, clamp_rate=1.5,
        mask_noise=de_noise[0], noise=de_noise[1], return_mask=True, sampler=sampler_de, jit=jit)
    eager_de, mask_de = de_call(False)
    if tuple(eager_de.shape) != (1, DIFFEDIT_SIZE, DIFFEDIT_SIZE, 3) \
            or not torch.isfinite(eager_de).all():
        fail(f"DiffEdit gave {tuple(eager_de.shape)}, or values that are not finite")
    log(f"DiffEdit: SD-2.1 bf16 b1 {DIFFEDIT_SIZE}px, {SD_STEPS} steps from encode ratio "
        f"{DIFFEDIT_RATIO}, CFG {SD_SCALE}: image finite, edit mask covers "
        f"{mask_de.mean().item():.3f} of the latent")
    captures = P.GraphedSampler.captures
    for i in range(2):
        got, got_mask = de_call(True)
        d, r = rel_err(got, eager_de)
        ok = r <= GRAPH_BOUND and torch.equal(got_mask, mask_de)
        log(f"  DiffEdit jit=True call {i}: graphed vs eager on the card: max|d| {d:.3e}, "
            f"/max|x| {r:.3e} (bound {GRAPH_BOUND:g}), the same mask: "
            f"{torch.equal(got_mask, mask_de)} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("DiffEdit: the graphed edit disagrees with the eager one")
    if P.GraphedSampler.captures - captures != 1:
        fail(f"DiffEdit: {P.GraphedSampler.captures - captures} captures over two calls of one key")
    del sampler_de
    log(f"  DiffEdit: {time.perf_counter() - t0:.1f} s")

    # ---- 5c. path F: class-conditional cin256 -------------------------------------
    log(f"[{time.perf_counter() - t_start:.1f} s] phase 5c")
    # the UNet ADMConfig.cin256() and the VQ-f4 first stage VAEConfig.vq_cin256()
    # (8192 codes), built by load_sd_checkpoint from a CompVis-style checkpoint
    # synthesised on the host with seeded random weights; ClassEmbedder(1001,
    # 512); class_conditional_sample b8, CFG 3.0 against class 1000, 20 NFE, bf16
    t0 = time.perf_counter()
    cfg_f, vcfg_f = ADMConfig.cin256(), VAEConfig.vq_cin256()
    gh = torch.Generator().manual_seed(12)
    ckpt_f = {f"model.diffusion_model.{k}": v for k, v in
              init_random_(ADMUNet(cfg_f, device="cpu"), gh).state_dict().items()}
    ckpt_f.update({f"first_stage_model.{k}": v for k, v in init_random_(
        VQModel(vcfg_f, n_embed=CIN_CODES, device="cpu"), gh).state_dict().items()})
    model_f = load_sd_checkpoint(ckpt_f, preset="cin256", compute_dtype=torch.bfloat16, device=dev)
    embedder_f = ClassEmbedder(CIN_CLASSES, CIN_CONTEXT, seed=0, device=dev)
    if not model_f.is_vq or model_f.vae.n_embed != CIN_CODES \
            or model_f.conditioning_key != "crossattn" or model_f.scale_factor != 1.0:
        fail("load_sd_checkpoint(preset='cin256') did not build the VQ-f4 crossattn LDM")
    n_unet_f = sum(p.numel() for p in model_f.unet.parameters())
    n_vq_f = sum(p.numel() for p in model_f.vae.parameters())
    labels_f = torch.from_numpy(np.random.default_rng(1).integers(0, CIN_CLASSES - 1, CIN_LABELS))
    sampler_f = DPMSolverSampler(model_f)
    cin_call = lambda jit: class_conditional_sample(
        model_f, embedder_f, labels_f, steps=CIN_STEPS, guidance_scale=CIN_SCALE,
        uncond_label=CIN_UNCOND, generator=torch.Generator(device=dev).manual_seed(13),
        sampler=sampler_f, jit=jit)
    torch.cuda.synchronize()
    log(f"path F: cin256 UNet ({n_unet_f / 1e6:.2f}M params) + VQ-f4 ({n_vq_f / 1e6:.2f}M, "
        f"{CIN_CODES} codes) through load_sd_checkpoint(preset='cin256'), ClassEmbedder("
        f"{CIN_CLASSES}, {CIN_CONTEXT}), bf16, seeded random weights, built in "
        f"{time.perf_counter() - t0:.1f} s; class_conditional_sample b{CIN_LABELS} 256x256 (64x64x3 "
        f"latents), DPM-Solver++ 2M, {CIN_STEPS} NFE, CFG {CIN_SCALE} against class {CIN_UNCOND}")
    sampler_fl = sampler_launches(adm_unet_launches(cfg_f), CIN_STEPS)
    decode_f = {name: vae_decoder_launches(vcfg_f)[name] for name in REPLACES}
    expected_run = {name: sampler_fl[name] + decode_f[name] for name in REPLACES}
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    img_f = []
    unet_calls_f, vae_calls_f = record_sd_calls(model_f.unet, model_f.vae,
                                                lambda: img_f.append(cin_call(False)))
    torch.cuda.synchronize()
    img_f = img_f[0]
    launches_f, routes_f = ops.launch_counts(), ops.launch_routes()
    log(f"  launches {launches_f} (expected {expected_run}); first call "
        f"{time.perf_counter() - t1:.2f} s")
    if launches_f != expected_run:
        fail(f"path F launch counts {launches_f} != {expected_run}")
    # the VQ decoder's conv_in (C = 3) and conv_out (CO = 3)
    check_routes("path F", launches_f, routes_f, narrow_convs=2)
    attn_f = Counter()
    for (name, spec), n in unet_calls_f.items():
        if name == "token_attention":
            attn_f["dh", spec[4], "S = 1" if spec[2] == 1 else "self"] += n
    log(f"  attention launches by head dim and keys: {dict(attn_f)}")
    if {k[1] for k in attn_f} != {384, 576, 960} or not all(
            attn_f["dh", dh, kind] for dh in (384, 576, 960) for kind in ("self", "S = 1")):
        fail(f"path F's attentions {dict(attn_f)} are not cin256's dh 384/576/960 with S = 1")
    if tuple(img_f.shape) != (CIN_LABELS, 256, 256, 3) or not torch.isfinite(img_f).all() \
            or img_f.min() < 0 or img_f.max() > 1:
        fail(f"path F images {tuple(img_f.shape)} are not finite (8, 256, 256, 3) in [0, 1]")
    log(f"  images {tuple(img_f.shape)} finite in [0, 1]: mean {img_f.mean().item():.4f}, "
        f"std {img_f.std().item():.4f}")
    check_graphed("path F", lambda: cin_call(True), img_f, sampler_fl, decode_f)

    # fp32 at 32x32 latents, b2, CFG, 3 NFE: kernels on the card vs plain on
    # the CPU, both built from the same checkpoint. The latents within
    # SLICE_BOUND; the VQ indices each side picks (a near tie may flip one:
    # counted), then the decoder on the CPU's indices within SLICE_BOUND
    t0 = time.perf_counter()
    result = {}
    x_T_f = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(14))
    for where in (dev, torch.device("cpu")):
        t1 = time.perf_counter()
        m = load_sd_checkpoint(ckpt_f, preset="cin256", device=where)
        emb = ClassEmbedder(CIN_CLASSES, CIN_CONTEXT, embedding=embedder_f.embedding.weight.cpu(),
                            device=where)
        z, _ = DPMSolverSampler(m).sample(
            3, 2, (32, 32, 3), emb(labels_f[:2]), unconditional_guidance_scale=CIN_SCALE,
            unconditional_conditioning=emb([CIN_UNCOND] * 2), x_T=x_T_f, return_intermediate=False,
            jit=False)
        result[where.type] = (m, z)
        log(f"  fp32 b2 32x32 latents, 3 NFE on {where}: {time.perf_counter() - t1:.1f} s")
    d, r = rel_err(result["cuda"][1].cpu(), result["cpu"][1])
    ok = r <= SLICE_BOUND and bool(torch.isfinite(result["cuda"][1]).all())
    log(f"  latents, kernels (card) vs plain (cpu): max|d| {d:.3e}, /max|x| {r:.3e} "
        f"(bound {SLICE_BOUND:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the fp32 cin256 trajectory on the card disagrees with the plain path")
    idx = {w: m.vae.quantize.indices(z).cpu() for w, (m, z) in result.items()}
    flips = int((idx["cuda"] != idx["cpu"]).sum())
    images = {}
    for w, (m, _) in result.items():
        z_q = m.vae.quantize.embedding.weight[idx["cpu"].to(m.device)]
        images[w] = m.vae.decode(z_q, force_not_quantize=True).cpu()
    d, r = rel_err(images["cuda"], images["cpu"])
    ok = r <= SLICE_BOUND and bool(torch.isfinite(images["cuda"]).all())
    log(f"  VQ indices, card vs cpu: {flips} of {idx['cpu'].numel()} differ; the decode of the "
        f"cpu's indices, card vs cpu: max|d| {d:.3e}, /max|x| {r:.3e} (bound {SLICE_BOUND:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the fp32 VQ decode on the card disagrees with the plain path")
    del result, images, m, emb
    torch.cuda.empty_cache()
    log(f"  fp32 trajectory check: {time.perf_counter() - t0:.1f} s")

    # ---- 5d. conditioners and upscale, fp32, card vs CPU ---------------------------
    log(f"[{time.perf_counter() - t_start:.1f} s] phase 5d")
    t0 = time.perf_counter()
    # FrozenCLIPEmbedder at ViT-L/14's text width, from an HF-format directory
    # written here (synthetic vocab, seeded random weights)
    with tempfile.TemporaryDirectory() as tmp:
        clip_dir = write_clip_text_dir(Path(tmp), seed=15)
        clip = {w.type: FrozenCLIPEmbedder(clip_dir, device=w) for w in (dev, torch.device("cpu"))}
        n_clip = sum(p.numel() for p in clip["cpu"].model.parameters())
        ctx_clip = {w: e(SD_PROMPTS).cpu() for w, e in clip.items()}
        del clip
    d, r = rel_err(ctx_clip["cuda"], ctx_clip["cpu"])
    ok = ctx_clip["cuda"].shape == (len(SD_PROMPTS), 77, 768) and r <= SLICE_BOUND
    log(f"FrozenCLIPEmbedder (12 layers, 768 wide, vocab 49408, {n_clip / 1e6:.2f}M params) "
        f"b{len(SD_PROMPTS)}, card vs cpu: "
        f"{tuple(ctx_clip['cuda'].shape)}, max|d| {d:.3e}, /max|x| {r:.3e} (bound "
        f"{SLICE_BOUND:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("FrozenCLIPEmbedder on the card disagrees with its CPU run")
    # BERTEmbedder at the LDM txt2img-f8 width (n_embed 1280, 32 layers): its
    # attention is the forward kernel, fp32, dh 64, T = S = 77
    gb = torch.Generator().manual_seed(16)
    bert = {"cpu": init_random_(BERTEmbedder(1280, 32, device="cpu"), gb).eval()}
    bert["cuda"] = BERTEmbedder(1280, 32, device=dev).eval()
    bert["cuda"].load_state_dict(bert["cpu"].state_dict())
    tokens = torch.randint(0, 30522, (2, 77), generator=gb)
    ops.reset_launch_counts()
    out_bert = {w: m(tokens).cpu() for w, m in bert.items()}
    torch.cuda.synchronize()
    n_bert = sum(p.numel() for p in bert["cpu"].parameters())
    bert_launches = ops.launch_routes()["token_attention"]
    d, r = rel_err(out_bert["cuda"], out_bert["cpu"])
    ok = r <= SLICE_BOUND and bert_launches == {"f32": 32}
    log(f"BERTEmbedder (1280 wide, 32 layers, {n_bert / 1e6:.1f}M params) b2 x 77 tokens, card "
        f"vs cpu: max|d| {d:.3e}, /max|x| {r:.3e} (bound {SLICE_BOUND:g}); attention launches "
        f"by route {dict(bert_launches)} (expected {{'f32': 32}}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("BERTEmbedder on the card disagrees with its CPU run, or missed the kernel")
    cls = {w.type: ClassEmbedder(CIN_CLASSES, CIN_CONTEXT, seed=3, device=w)(labels_f).cpu()
           for w in (dev, torch.device("cpu"))}
    if not torch.equal(cls["cuda"], cls["cpu"]) or cls["cpu"].shape != (CIN_LABELS, 1, CIN_CONTEXT):
        fail("ClassEmbedder on the card differs from its CPU run")
    log(f"ClassEmbedder({CIN_CLASSES}, {CIN_CONTEXT}) b{CIN_LABELS}: card equal to cpu")
    del bert, out_bert, ctx_clip
    # upscale: no full-width preset exists; a small concat-conditioned LDM
    # (the LR image joins the latent along channels; a KL-f4 first stage),
    # b2 from 32x32 to 128x128, 4 NFE, card vs cpu, for correctness only
    ucfg_u = ADMConfig(image_size=32, in_channels=6, model_channels=64, out_channels=3,
                       num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                       num_heads=1)
    vcfg_u = VAEConfig(ch=64, ch_mult=(1, 2, 4), z_channels=3, embed_dim=3, resolution=128)
    gu = torch.Generator().manual_seed(17)
    nets_u = {"cpu": (init_random_(ADMUNet(ucfg_u, device="cpu"), gu).eval(),
                      init_random_(AutoencoderKL(vcfg_u, device="cpu"), gu).eval())}
    nets_u["cuda"] = (ADMUNet(ucfg_u, device=dev).eval(), AutoencoderKL(vcfg_u, device=dev).eval())
    for mod, ref in zip(nets_u["cuda"], nets_u["cpu"]):
        mod.load_state_dict(ref.state_dict())
    lr = torch.rand(2, 32, 32, 3, generator=gu) * 2 - 1
    x_T_u = torch.randn(2, 32, 32, 3, generator=gu)
    up = {w: StableDiffusionPipeline(LatentDiffusion(u, a, scale_factor=1.0,
                                                     conditioning_key="concat"), device=w)
          .upscale(lr, steps=4, x_T=x_T_u, jit=False).cpu()
          for w, (u, a) in nets_u.items()}
    d, r = rel_err(up["cuda"], up["cpu"])
    ok = up["cuda"].shape == (2, 128, 128, 3) and r <= SLICE_BOUND
    log(f"upscale (concat LDM, 64 channels, KL-f4) b2 32 -> 128 px, 4 NFE, card vs cpu: "
        f"max|d| {d:.3e}, /max|x| {r:.3e} (bound {SLICE_BOUND:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("upscale on the card disagrees with its CPU run")
    del nets_u, up
    torch.cuda.empty_cache()
    log(f"  conditioners and upscale: {time.perf_counter() - t0:.1f} s")

    # ---- 6. path C: classifier-guided ImageNet-256 -----------------------------
    log(f"[{time.perf_counter() - t_start:.1f} s] phase 6")
    t0 = time.perf_counter()
    gcfg = ADMConfig.imagenet256_guided()
    ccfg = dataclasses.replace(gcfg, model_channels=128, num_res_blocks=2, out_channels=1000,
                               pool="attention", num_classes=None, resblock_updown=True,
                               use_scale_shift_norm=True)
    gw = torch.Generator(device=dev).manual_seed(0)
    gunet = init_random_(ADMUNet(gcfg, compute_dtype=torch.bfloat16, device=dev), gw).eval()
    clf = init_random_(ADMClassifier(ccfg, compute_dtype=torch.bfloat16, device=dev), gw).eval()
    gunet.requires_grad_(False)
    clf.requires_grad_(False)   # guidance needs grad_x only: no dw at any conv
    n_gunet = sum(p.numel() for p in gunet.parameters())
    n_clf = sum(p.numel() for p in clf.parameters())
    labels = np.random.default_rng(1).integers(0, 1000, GUIDED_BATCH)
    gns = P.NoiseScheduleVP.discrete(betas=np.linspace(1e-4, 0.02, 1000))
    guided_kw = dict(steps=GUIDED_STEPS, order=2, method="multistep", skip_type="time_uniform",
                     correcting_x0_fn=make_dynamic_thresholding(0.995, 1.0))

    def guided_sampler(unet_, clf_, y, steps=GUIDED_STEPS, on_classifier=None):
        """`build_sampler` over the guided `model_wrapper`, as guided_bench.py
        drives it; `on_classifier(x_in)` is called on each classifier input."""
        def log_prob(x, t, yy):
            if on_classifier is not None:
                on_classifier(x)
            return F.log_softmax(clf_(x, t), dim=-1)[torch.arange(x.shape[0], device=x.device), yy]

        model_fn = P.model_wrapper(lambda x, t: unet_(x, t, y)[..., :3], gns, model_type="noise",
                                   guidance_type="classifier", condition=y,
                                   guidance_scale=GUIDED_SCALE, classifier_fn=log_prob)
        return P.build_sampler(model_fn, gns, **dict(guided_kw, steps=steps))

    y_dev = torch.tensor(labels, device=dev)
    sample_c = guided_sampler(gunet, clf, y_dev)
    gx_T = torch.tensor(np.random.default_rng(0).standard_normal(
        (GUIDED_BATCH, GUIDED_SIZE, GUIDED_SIZE, 3)), dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    log(f"path C: guided ImageNet-256, ADM UNet ({n_gunet / 1e6:.2f}M params) + classifier "
        f"({n_clf / 1e6:.2f}M, attention pool, frozen), bf16 compute, seeded random weights, "
        f"built in {time.perf_counter() - t0:.1f} s; b{GUIDED_BATCH} {GUIDED_SIZE}x{GUIDED_SIZE}, "
        f"classifier scale {GUIDED_SCALE}, DPM-Solver++ 2M, {GUIDED_STEPS} NFE, time_uniform, "
        f"dynamic thresholding (0.995, 1.0)")
    expected_c = guided_launches(gcfg, ccfg, GUIDED_STEPS)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    gout = sample_c(gx_T)
    torch.cuda.synchronize()
    first_c = time.perf_counter() - t0
    launches_c, routes_c = ops.launch_counts(), ops.launch_routes()
    log(f"  launches {launches_c} (expected {expected_c}); first call {first_c:.2f} s")
    if launches_c != expected_c:
        fail(f"path C launch counts {launches_c} != {expected_c}")
    check_routes("path C", launches_c, routes_c)
    if gout.shape != gx_T.shape or gout.dtype != torch.float32 or not torch.isfinite(gout).all():
        fail(f"path C samples {tuple(gout.shape)} {gout.dtype} are not finite fp32 of x_T's shape")
    log(f"  samples {tuple(gout.shape)} finite: min {gout.min().item():.4f}, max "
        f"{gout.max().item():.4f}, std {gout.std().item():.4f}")

    # fp32 at 64x64, b1, 3 NFE: kernels on the card vs plain on the CPU. The
    # same weights; the attention pool's positional embedding follows the
    # image size ((C, 2*2 + 1) here), so it is drawn anew from a seed.
    t0 = time.perf_counter()
    c64 = dataclasses.replace(ccfg, image_size=64)
    pos = torch.randn(512, 5, generator=torch.Generator().manual_seed(3)) / 5 ** 0.5
    csd = {k: (pos if k == "out.2.positional_embedding" else v) for k, v in clf.state_dict().items()}
    x64 = torch.randn(1, 64, 64, 3, generator=torch.Generator().manual_seed(2))
    result = {}
    for where in (dev, torch.device("cpu")):
        t1 = time.perf_counter()
        u = ADMUNet(dataclasses.replace(gcfg, image_size=64), device=where).eval()
        u.load_state_dict(gunet.state_dict())
        c = ADMClassifier(c64, device=where).eval()
        c.load_state_dict(csd)
        u.requires_grad_(False)
        c.requires_grad_(False)
        y1 = torch.tensor(labels[:1], device=where)
        result[where.type] = guided_sampler(u, c, y1, steps=3)(x64.to(where)).cpu()
        log(f"  fp32 b1 64x64, 3 NFE on {where}: {time.perf_counter() - t1:.1f} s")
        del u, c
    d, r = rel_err(result["cuda"], result["cpu"])
    ok = r <= SLICE_BOUND and bool(torch.isfinite(result["cuda"]).all())
    log(f"  guided samples, kernels (card) vs plain (cpu): max|d| {d:.3e}, /max|x| {r:.3e} "
        f"(bound {SLICE_BOUND:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the fp32 guided path on the card disagrees with the plain path")
    del result
    torch.cuda.empty_cache()
    log(f"  fp32 trajectory check: {time.perf_counter() - t0:.1f} s")

    # ---- 7. path D: ScoreSDE continuous VP, DDPM++ (deep) ----------------------
    log(f"[{time.perf_counter() - t_start:.1f} s] phase 7")
    t0 = time.perf_counter()
    dcfg = NCSNppConfig.cifar10_ddpmpp(deep=True)
    dnet = init_random_(NCSNpp(dcfg, compute_dtype=torch.bfloat16, device=dev),
                        torch.Generator(device=dev).manual_seed(0)).eval()
    n_dnet = sum(p.numel() for p in dnet.parameters())
    vns = P.NoiseScheduleVP.linear()

    def noise_model(net_):
        """The continuous-VP noise model: labels t * 999 (score.get_noise_fn)."""
        return P.model_wrapper(get_noise_fn(VPSDE(), net_), vns, model_type="noise")

    score_kw = dict(steps=SCORE_STEPS, order=3, method="singlestep", skip_type="logSNR",
                    t_end=SCORE_T_END)
    sample_d = P.build_sampler(noise_model(dnet), vns, **score_kw)
    side = dcfg.image_size
    dx_T = torch.tensor(np.random.default_rng(0).standard_normal((SCORE_BATCH, side, side, 3)),
                        dtype=torch.float32, device=dev)
    expected_d = plan_launches(dcfg, make_plan(vns, **score_kw))
    torch.cuda.synchronize()
    log(f"path D: ScoreSDE continuous VP, DDPM++ deep ({n_dnet / 1e6:.2f}M params), bf16 "
        f"compute, seeded random weights, built in {time.perf_counter() - t0:.1f} s; "
        f"b{SCORE_BATCH} {side}x{side}, singlestep order 3, {SCORE_STEPS} NFE, logSNR, "
        f"t_end {SCORE_T_END:g}, labels t*999")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    dout = sample_d(dx_T)
    torch.cuda.synchronize()
    first_d = time.perf_counter() - t0
    launches_d, routes_d = ops.launch_counts(), ops.launch_routes()
    log(f"  launches {launches_d} (expected {expected_d}); first call {first_d:.2f} s")
    if launches_d != expected_d:
        fail(f"path D launch counts {launches_d} != {expected_d}")
    check_routes("path D", launches_d, routes_d)
    if dout.shape != dx_T.shape or dout.dtype != torch.float32 or not torch.isfinite(dout).all():
        fail(f"path D samples {tuple(dout.shape)} {dout.dtype} are not finite fp32 of x_T's shape")
    log(f"  samples {tuple(dout.shape)} finite: min {dout.min().item():.4f}, max "
        f"{dout.max().item():.4f}, std {dout.std().item():.4f}")
    # the same sampler replayed from its CUDA graph (the counterpart of JAX's
    # jit_hoisting_constants for build_sampler users)
    graphed_d = P.GraphedSampler(sample_d)
    check_graphed("path D", lambda: graphed_d(dx_T), dout, expected_d)

    # the adaptive solver (DPM-Solver-23) through DPM_Solver.sample, full width:
    # a model evaluation is one network forward, counted at the network
    evals = [0]

    def counted(x, labels):
        evals[0] += 1
        return dnet(x, labels)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    aout = P.DPM_Solver(noise_model(counted), vns).sample(
        dx_T[:SCORE_ADAPTIVE_BATCH], order=3, method="adaptive", t_end=SCORE_T_END)
    torch.cuda.synchronize()
    launches_ad = ops.launch_counts()
    per_forward = ncsnpp_launches(dcfg)
    log(f"  adaptive order 3, b{SCORE_ADAPTIVE_BATCH}: {evals[0]} NFE in "
        f"{time.perf_counter() - t0:.2f} s; launches {launches_ad}")
    if evals[0] == 0 or evals[0] % 3 or any(
            launches_ad[k] != evals[0] * n for k, n in per_forward.items()) \
            or launches_ad["fused_update"] == 0:
        fail(f"adaptive path D: {evals[0]} NFE, launches {launches_ad}")
    if aout.shape != (SCORE_ADAPTIVE_BATCH, side, side, 3) or not torch.isfinite(aout).all():
        fail(f"adaptive path D samples {tuple(aout.shape)} are not finite")

    # fp32, b2, 3 NFE singlestep: kernels on the card vs plain on the CPU
    t0 = time.perf_counter()
    nets = {}
    for where in (dev, torch.device("cpu")):
        nets[where.type] = NCSNpp(dcfg, device=where).eval()
        nets[where.type].load_state_dict(dnet.state_dict())
    kw3 = dict(score_kw, steps=3)
    samplers = {where: P.build_sampler(noise_model(net_), vns, **kw3)
                for where, net_ in nets.items()}
    result = {where: fn(dx_T[:2].to(where)).cpu() for where, fn in samplers.items()}
    d, r = rel_err(result["cuda"], result["cpu"])
    ok = r <= SLICE_BOUND and bool(torch.isfinite(result["cuda"]).all())
    log(f"  fp32 b2 3 NFE, kernels (card) vs plain (cpu, {time.perf_counter() - t0:.1f} s): "
        f"max|d| {d:.3e}, /max|x| {r:.3e} (bound {SLICE_BOUND:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the fp32 ScoreSDE path on the card disagrees with the plain path")
    check_replays("path D fp32 b2", P.GraphedSampler(samplers["cuda"]), samplers["cuda"],
                  [dx_T[:2], dx_T[2:4]], result["cuda"].to(dev))
    del nets, result, samplers

    # the adaptive solver on the tiny twin of cifar10_ncsnpp_vp (FIR
    # resampling, residual input pyramid), fp32, card vs CPU: equal NFE
    tcfg = NCSNppConfig.tiny(fir=True, progressive_input="residual")
    tnet = init_random_(NCSNpp(tcfg, device="cpu"), torch.Generator().manual_seed(4)).eval()
    xt = torch.tensor(np.random.default_rng(5).standard_normal(
        (2, tcfg.image_size, tcfg.image_size, 3)), dtype=torch.float32)
    result = {}
    for where in (dev, torch.device("cpu")):
        net_ = NCSNpp(tcfg, device=where).eval()
        net_.load_state_dict(tnet.state_dict())
        xa, nfe = adaptive_sample(noise_model(net_), vns, xt.to(where), order=3,
                                  t_end=SCORE_T_END)
        result[where.type] = (xa.cpu(), nfe)
    d, r = rel_err(result["cuda"][0], result["cpu"][0])
    ok = result["cuda"][1] == result["cpu"][1] and r <= ADAPTIVE_BOUND
    log(f"  tiny FIR VP NCSN++ adaptive fp32, kernels (card) vs plain (cpu): NFE "
        f"{result['cuda'][1]} vs {result['cpu'][1]}, max|d| {d:.3e}, /max|x| {r:.3e} "
        f"(bound {ADAPTIVE_BOUND:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the adaptive solver on the card disagrees with the plain path")
    del result, tnet
    torch.cuda.empty_cache()

    # ---- 7b. path E: ScoreSDE bits/dim on DDPM++ deep --------------------------
    log(f"[{time.perf_counter() - t_start:.1f} s] phase 7b")
    t0 = time.perf_counter()
    enet = NCSNpp(dcfg, device=dev).eval()   # fp32 compute, path D's weights
    enet.load_state_dict(dnet.state_dict())
    enet.requires_grad_(False)  # the divergence needs grad_x only: no dw at any conv
    espans = {"forward": [], "backward": []}

    def timed_net(x, labels):
        """The network, with CUDA events around its forward and, when x
        requires grad, around its backward (from the cotangent of its output
        reaching it to the gradient of its input)."""
        ev0 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        out = enet(x, labels)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev1.record()
        espans["forward"].append((ev0, ev1))
        if x.requires_grad:
            pair = []

            def started(grad):
                pair.append(torch.cuda.Event(enable_timing=True))
                pair[-1].record()

            def ended(grad):
                started(grad)
                espans["backward"].append(tuple(pair))
            out.register_hook(started)
            x.register_hook(ended)
        return out

    lik_e = get_likelihood_fn(VPSDE(), get_score_fn(VPSDE(), timed_net), rtol=LIK_TOL,
                              atol=LIK_TOL, eps=LIK_EPS, inverse_scaler_grad=0.5)
    # seeded 8-bit images, uniformly dequantised, centred to [-1, 1]
    rng_e = np.random.default_rng(7)
    pixels = rng_e.integers(0, 256, (LIK_BATCH, side, side, 3)) + rng_e.uniform(size=(
        LIK_BATCH, side, side, 3))
    e_data = torch.tensor(pixels / 256.0 * 2.0 - 1.0, dtype=torch.float32, device=dev)
    e_probe = sample_hutchinson(e_data.shape, "Rademacher", device=dev,
                                generator=torch.Generator(device=dev).manual_seed(8))
    per_stage = ncsnpp_launches(dcfg)
    log(f"path E: ScoreSDE bits/dim, DDPM++ deep ({n_dnet / 1e6:.2f}M params, frozen), fp32, "
        f"seeded random weights, built in {time.perf_counter() - t0:.1f} s; b{LIK_BATCH} "
        f"{side}x{side} dequantised images, continuous VP, labels t*999, Rademacher probe, "
        f"RK45 rtol = atol = {LIK_TOL:g}, eps {LIK_EPS:g}")
    # the specs of one network forward at the path's batch: each conv3x3
    # also runs its dx, each attention its lse form, dq and dk/dv
    e_calls = Counter()

    def e_hook(mod, args):
        x = args[0]
        if isinstance(mod, ops.Conv3x3):
            e_calls[("conv3x3", "conv3x3_dx"), (*x.shape, mod.weight.shape[0])] += 1
        else:
            b, h, w, c = x.shape
            e_calls[("attention_lse", "attention_dq", "attention_dkv"),
                    (b, h * w, h * w, 1, c, True)] += 1

    handles = [m.register_forward_pre_hook(e_hook) for m in enet.modules()
               if isinstance(m, (ops.Conv3x3, SelfAttention2D))]
    enet(e_data, torch.full((LIK_BATCH,), 500.0, device=dev))
    for h in handles:
        h.remove()
    # each of those kernels at each of those specs, in fp32, against its
    # plain version (as in phase 3)
    log(f"  path E's kernels at its {len(e_calls)} specs, fp32, vs plain (each launched "
        f"twice: bitwise equal):")
    for names, spec in sorted(e_calls, key=str):
        if names[0] == "conv3x3":
            check_conv(spec, torch.float32, dx=True)
        else:
            check_attention_bwd(spec, torch.float32, BWD_BOUND["float32"])
            # the same kernel without its lse (the sampler's forward)
            b, t, s_, heads, dh, _ = spec
            q, k, v = randn(b, t, 3 * heads * dh).split(heads * dh, dim=-1)
            report("token_attention", spec, torch.float32,
                   twice("token_attention", spec, torch.float32,
                         lambda: ops.token_attention(q, k, v, num_heads=heads)),
                   ops.attention_plain(q, k, v, num_heads=heads), BOUND["float32"])
    torch.cuda.empty_cache()
    # every conv3x3 weight gradient goes through torch.nn.grad.conv2d_weight
    # (ops/conv3x3.py::_Conv3x3Fn.backward): count its calls
    weight_grads = [0]
    conv2d_weight = torch.nn.grad.conv2d_weight

    def counted_weight_grad(*args, **kwargs):
        weight_grads[0] += 1
        return conv2d_weight(*args, **kwargs)

    torch.nn.grad.conv2d_weight = counted_weight_grad
    try:
        ops.reset_launch_counts()
        for v in espans.values():
            v.clear()
        t0 = time.perf_counter()
        bpd_e, z_e, nfe_e = lik_e(e_data, epsilon=e_probe)
        torch.cuda.synchronize()
        first_e = time.perf_counter() - t0
        launches_e = ops.launch_counts()
        # the counted call's wall and device spans (phase 8 times no other
        # call unless LIK_TIMED_RUNS says so)
        e_runs = [(first_e, *(sum(a.elapsed_time(b) for a, b in espans[k]) / 1e3
                              for k in ("forward", "backward")))]
    finally:
        torch.nn.grad.conv2d_weight = conv2d_weight
    attn_stage = per_stage["token_attention"]
    expected_e = {name: 0 for name in REPLACES}
    expected_e.update(conv3x3=nfe_e * per_stage["conv3x3"], conv3x3_dx=nfe_e * per_stage["conv3x3"],
                      attention_lse=nfe_e * attn_stage, attention_dq=nfe_e * attn_stage,
                      attention_dkv=nfe_e * attn_stage)
    log(f"  {nfe_e} NFE; launches {launches_e} (expected {expected_e}); conv3x3 weight "
        f"gradients {weight_grads[0]} (expected 0); first call {first_e:.2f} s")
    if launches_e != expected_e or weight_grads[0] != 0:
        fail(f"path E launch counts {launches_e} != {expected_e}, or {weight_grads[0]} weight "
             f"gradients")
    routes_e = ops.launch_routes()
    want_routes = {"conv3x3": {"f32": expected_e["conv3x3"]},
                   "conv3x3_dx": {"f32": expected_e["conv3x3_dx"]},
                   "token_attention": {}, "attention_lse": {"f32": expected_e["attention_lse"]},
                   "attention_dq": {"f32": expected_e["attention_dq"]},
                   "attention_dkv": {"f32": expected_e["attention_dkv"]},
                   "ln_linear": {}, "geglu_ff": {}, "attention_out_fused": {}}
    log(f"  launches by route {routes_e} (expected {want_routes})")
    if routes_e != want_routes:
        fail(f"path E launches by route {routes_e} != {want_routes}")
    if bpd_e.shape != (LIK_BATCH,) or not torch.isfinite(bpd_e).all() \
            or z_e.shape != e_data.shape or not torch.isfinite(z_e).all():
        fail(f"path E: bits/dim {tuple(bpd_e.shape)} or z {tuple(z_e.shape)} not finite")
    log(f"  bits/dim {[round(v, 4) for v in bpd_e.tolist()]}, mean {bpd_e.mean().item():.4f}; "
        f"z finite, std {z_e.std().item():.4f}")

    # one full-width stage, kernels on the card against plain ops on the CPU
    # (fp32, b2, t = 0.5), relative to each value's max within SLICE_BOUND:
    # the network's vector-Jacobian product with the probe (the backward
    # that runs the dq, dk/dv and dx kernels), then the probability-flow
    # drift and its divergence estimate through hutchinson_divergence
    t0 = time.perf_counter()
    stage = {}
    for where in (dev, torch.device("cpu")):
        net_ = NCSNpp(dcfg, device=where).eval()
        net_.load_state_dict(enet.state_dict())
        net_.requires_grad_(False)
        x2, eps2 = e_data[:2].to(where), e_probe[:2].to(where)
        t2 = torch.full((2,), 0.5, device=where)
        with torch.enable_grad():
            xi = x2.clone().requires_grad_(True)
            vjp, = torch.autograd.grad((net_(xi, t2 * 999.0) * eps2).sum(), xi)
        drift = reverse_sde(VPSDE(), get_score_fn(VPSDE(), net_), probability_flow=True).sde
        out, div = hutchinson_divergence(lambda xs_, ts_: drift(xs_, ts_)[0], x2, t2, eps2)
        stage[where.type] = [u.cpu() for u in (vjp, out, div)]
        del net_, vjp, out, div
    for what, got, want in zip(("network vjp", "drift", "divergence"), stage["cuda"],
                               stage["cpu"]):
        d, r = rel_err(got, want)
        ok = r <= SLICE_BOUND and bool(torch.isfinite(got).all())
        log(f"  full-width stage b2 t 0.5, {what}, kernels (card) vs plain (cpu): max|d| "
            f"{d:.3e}, /max {r:.3e} (bound {SLICE_BOUND:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"path E's stage ({what}) on the card disagrees with the plain path")
    log(f"  divergence estimates {[round(v, 3) for v in stage['cuda'][2].tolist()]} (card), "
        f"{[round(v, 3) for v in stage['cpu'][2].tolist()]} (cpu); "
        f"{time.perf_counter() - t0:.1f} s")
    del stage
    torch.cuda.empty_cache()

    # the tiny FIR VP NCSN++ (unconditional: module docstring), fp32, the
    # likelihood and the black-box ODE sampler, kernels on the card against
    # plain ops on the CPU: the same NFE, z within ADAPTIVE_BOUND of max|z|,
    # bits/dim within BPD_BOUND
    tkw = dict(fir=True, progressive_input="residual", num_res_blocks=1, conditional=False)
    tcfg_e = NCSNppConfig.tiny(**tkw)
    tnet_e = init_random_(NCSNpp(tcfg_e, device="cpu"), torch.Generator().manual_seed(4)).eval()
    rng_t = np.random.default_rng(9)
    t_data = torch.tensor(rng_t.uniform(-1.0, 1.0, (2, 16, 16, 3)), dtype=torch.float32)
    t_probe = torch.tensor(rng_t.integers(0, 2, (2, 16, 16, 3)) * 2.0 - 1.0, dtype=torch.float32)
    t_init = torch.tensor(rng_t.standard_normal((2, 16, 16, 3)), dtype=torch.float32)
    result = {}
    for where in (dev, torch.device("cpu")):
        t1 = time.perf_counter()
        net_ = NCSNpp(tcfg_e, device=where).eval()
        net_.load_state_dict(tnet_e.state_dict())
        score_t = get_score_fn(VPSDE(), net_.requires_grad_(False))
        bpd, z, nfe = get_likelihood_fn(VPSDE(), score_t, inverse_scaler_grad=0.5)(
            t_data.to(where), epsilon=t_probe.to(where))
        xs, nfe_s = ode_sampler(VPSDE(), score_t, t_init.shape, x_init=t_init.to(where),
                                denoise=True)
        result[where.type] = (bpd.cpu(), z.cpu(), nfe, xs.cpu(), nfe_s)
        log(f"  tiny VP NCSN++ bits/dim and ODE sampler, fp32 on {where}: "
            f"{time.perf_counter() - t1:.1f} s")
    (bc, zc, nc, xc, sc), (bp, zp, ncpu, xp, scpu) = result["cuda"], result["cpu"]
    d_bpd = (bc - bp).abs().max().item()
    d_z, r_z = rel_err(zc, zp)
    d_x, r_x = rel_err(xc, xp)
    ok = (nc == ncpu and sc == scpu and d_bpd <= BPD_BOUND and r_z <= ADAPTIVE_BOUND
          and r_x <= ADAPTIVE_BOUND and bool(torch.isfinite(zc).all() and torch.isfinite(xc).all()))
    log(f"  tiny likelihood, kernels (card) vs plain (cpu): NFE {nc} vs {ncpu}, bits/dim "
        f"max|d| {d_bpd:.3e} (bound {BPD_BOUND:g}), z /max|z| {r_z:.3e}; ODE sampler: NFE "
        f"{sc} vs {scpu}, /max|x| {r_x:.3e} (bound {ADAPTIVE_BOUND:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("bits/dim or the ODE sampler on the card disagrees with the plain path")
    del result, tnet_e
    torch.cuda.empty_cache()

    # ---- 7c. path H: score-model training (run_lib.train) -------------------------
    log(f"[{time.perf_counter() - t_start:.1f} s] phase 7c")
    from dpm_solver_tpu_torch import configs as port_configs
    from dpm_solver_tpu_torch import run_lib
    from dpm_solver_tpu_torch.pipelines.stable_diffusion import make_ldm_betas
    from dpm_solver_tpu_torch.training import latent as tlatent
    from dpm_solver_tpu_torch.training import losses as tlosses
    from dpm_solver_tpu_torch.training import train as ttrain
    from dpm_solver_tpu_torch.training.checkpoints import CheckpointManager

    torch.set_grad_enabled(True)
    # the timed runs take cuDNN's defaults, as a user's run does; the
    # restart checks turn its deterministic algorithms on
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, False
    train_walls = {}
    # the loops' per-step (step, loss, grad norm), until path I ends
    training_logs = contextlib.ExitStack()
    metrics_log = training_logs.enter_context(step_metrics())

    class TimedBatches:
        """A training loop's batches; the host clock, after a synchronize,
        each time the loop asks for one (a step's wall is the gap to the next)."""

        def __init__(self, batches):
            self.batches, self.stamps = iter(batches), []

        def __iter__(self):
            return self

        def __next__(self):
            torch.cuda.synchronize()
            self.stamps.append(time.perf_counter())
            return next(self.batches)

        def step_ms(self) -> list:
            torch.cuda.synchronize()
            stamps = self.stamps + [time.perf_counter()]
            return [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]

    def train_run(what, run, batches, per_step, steps, images, narrow_convs=0):
        """One counted, timed training run: launches (and by route) against
        `per_step` x steps, the loss and grad norm of every step finite, the
        median step after the first (warm) one, images/s, peak memory."""
        timed = TimedBatches(batches)
        metrics_log.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 2 ** 30
        ops.reset_launch_counts()
        state = run(timed)
        torch.cuda.synchronize()
        launches, routes = ops.launch_counts(), ops.launch_routes()
        expected = scaled(per_step, steps)
        log(f"  launches {launches} (expected {expected})")
        if launches != expected:
            fail(f"{what}: launch counts {launches} != {expected}")
        check_routes(what, launches, routes, narrow_convs=narrow_convs * steps)
        if len(metrics_log) != steps or not all(math.isfinite(v) for m in metrics_log
                                                for v in m[1:]):
            fail(f"{what}: the steps' loss and grad norm {metrics_log} are not {steps} finite")
        ms = timed.step_ms()
        med = statistics.median(ms[1:])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        train_walls[what] = dict(step_ms=med, step_ms_all=ms, images_per_s=images / med * 1e3,
                                 peak_gib=peak, peak_above_start_gib=peak - base, steps=steps,
                                 loss=[m[1] for m in metrics_log],
                                 grad_norm=[m[2] for m in metrics_log])
        log(f"  {what} on {smi}: median step {med:.2f} ms of {steps - 1} after a warm one "
            f"(all {[round(v, 2) for v in ms]}) -> {images / med * 1e3:.2f} images/s; peak "
            f"memory {peak:.2f} GiB ({peak - base:.2f} above the {base:.2f} held before the "
            f"run); loss {[round(m[1], 5) for m in metrics_log]}, grad "
            f"norm {[round(m[2], 4) for m in metrics_log]}")
        return state, launches, routes

    def step_card_vs_cpu(what, build, make_step, zero_leaves=None):
        """One fp32 training step at reduced width on the card (kernels) and
        on the CPU (plain twins), through the step function itself
        (`make_step(net, tx, device)` returns step(state)), from the same
        random weights (`init_random_`: no layer left at zero) and draws.
        Held: the step's loss and grad norm within SLICE_BOUND; Adam's first
        moment after the step, (1 - b1) times the clipped gradient, leaf by
        leaf within SLICE_BOUND of the leaf's largest element. The leaves
        whose gradient is 0 in exact arithmetic (`zero_leaves`, a regex: a
        key bias under the softmax, a per-channel constant before a
        GroupNorm of one channel a group) must be exactly those under 1e-6
        of the model's largest on the CPU; being rounding noise on both
        sides, they are held within SLICE_BOUND / 100 of the model's largest.
        The parameters after the step, in units of the learning rate, over
        the other leaves: 99.9% of the elements within 1e-3, and every
        element whose moment is at least 1e-3 of its leaf's largest within
        0.1 (Adam's first update is lr g / (|g| + eps): with the moment
        held, such an element's update differs by at most lr / 40, where a
        flipped sign moves it by up to 2 lr)."""
        res = {}
        base = None
        for where in (torch.device("cpu"), dev):
            t1 = time.perf_counter()
            net_ = build(where)
            if base is None:
                init_random_(net_, torch.Generator().manual_seed(TRAIN_SEED))
                base = {k: v.clone() for k, v in net_.state_dict().items()}
            else:
                net_.load_state_dict(base)
            state, tx = ttrain.make_train_state(net_, lr=CHECK_LR, warmup=0)
            _, metrics = make_step(net_, tx, where)(state)
            res[where.type] = ({k: float(v) for k, v in metrics.items()},
                               {k: m.cpu() for k, m in state.opt_state["mu"].items()},
                               {k: p.detach().cpu() for k, p in state.params.items()})
            log(f"  {what}: fp32 step on {where}: loss {res[where.type][0]['loss']:.6f}, grad "
                f"norm {res[where.type][0]['grad_norm']:.6f} ({time.perf_counter() - t1:.1f} s)")
        (mc, muc, pc), (mp, mup, pp) = res["cuda"], res["cpu"]
        r_metrics = max(abs(mc[k] - mp[k]) / max(abs(mp[k]), 1e-30) for k in mp)
        top = max(float(m.abs().max()) for m in mup.values())
        zero = {k for k in mup if zero_leaves and re.search(zero_leaves, k)}
        noise = {k for k, m in mup.items() if float(m.abs().max()) < 1e-6 * top}
        worst_mu = max(float((muc[k] - m).abs().max())
                       / (SLICE_BOUND / 100 * top if k in zero
                          else SLICE_BOUND * float(m.abs().max())) for k, m in mup.items())
        least = min(float(m.abs().max()) / top for k, m in mup.items() if k not in zero)
        unit = {k: (pc[k] - pp[k]).abs().flatten() / CHECK_LR for k in pp if k not in zero}
        q999 = float(torch.quantile(torch.cat(list(unit.values())), 0.999))
        sure = torch.cat([u[(mup[k].abs() >= 1e-3 * mup[k].abs().max()).flatten()]
                          for k, u in unit.items()])
        worst_p = float(sure.max())
        ok = (noise == zero and r_metrics <= SLICE_BOUND and worst_mu <= 1.0 and q999 <= 1e-3
              and worst_p <= 0.1)
        log(f"  {what}, card vs CPU: loss and grad norm /|x| {r_metrics:.3e} (bound "
            f"{SLICE_BOUND:g}); first moments at {worst_mu:.3f} of their bound ({len(mup)} "
            f"leaves; zero by construction {sorted(zero)}, the CPU's rounding-noise leaves "
            f"{'the same' if noise == zero else sorted(noise)}; the least other leaf at "
            f"{least:.3e} of the largest); "
            f"parameters after the step in lr units: 99.9% {q999:.3e} (bound 1e-3), max over "
            f"the {sure.numel()} of {sum(u.numel() for u in unit.values())} elements with a "
            f"moment >= 1e-3 of their leaf's {worst_p:.3e} (bound 0.1) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{what}: the fp32 training step on the card disagrees with the CPU's")
        return dict(metrics_rel=r_metrics, mu_bound_share=worst_mu, least_leaf=least,
                    zero_leaves=len(zero), params_lr_q999=q999, params_lr_max_sure=worst_p)

    def params_close(what, a, b):
        """A restarted run's parameters and EMA against an uninterrupted
        run's, within SLICE_BOUND of each tensor's largest element."""
        worst = 0.0
        for tree_a, tree_b in ((a.params, b.params), (a.ema_params, b.ema_params)):
            for k, v in tree_a.items():
                scale = max(float(v.detach().abs().max()), 1e-30)
                worst = max(worst, float((v.detach() - tree_b[k].detach()).abs().max()) / scale)
        ok = a.step == b.step and worst <= SLICE_BOUND
        log(f"  {what}: resumed vs uninterrupted at step {a.step}: max|d| / max|p| {worst:.3e} "
            f"(bound {SLICE_BOUND:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{what}: the resumed run disagrees with the uninterrupted one")
        return worst

    t0 = time.perf_counter()
    h_cfg = port_configs.get_config("score_sde_cifar10_ve_ncsnpp_continuous")
    h_mc, h_tc = h_cfg.model_config, h_cfg.training
    if h_mc.dropout != 0.1 or h_tc.batch_size != 128 or not h_tc.continuous:
        fail(f"path H's config is not the train bench's: {h_mc}, {h_tc}")
    h_rng = np.random.default_rng(TRAIN_SEED)
    # synthetic 8-bit CIFAR-sized images, uncentred (the VE config's data)
    h_batches = (h_rng.integers(0, 256, (H_STEPS, h_tc.batch_size, 32, 32, 3))
                 / 255.0).astype(np.float32)
    h_params = run_lib.build_model(h_cfg, device="meta")[0]
    log(f"path H: run_lib.train, {h_cfg.name}: NCSN++ continuous VE "
        f"({sum(p.numel() for p in h_params.parameters()) / 1e6:.2f}M params, bf16 compute, "
        f"dropout {h_mc.dropout} live), b{h_tc.batch_size} at 32x32, Adam lr {h_tc.lr} after a "
        f"{h_tc.warmup}-step warmup, clip {h_tc.grad_clip}, EMA {h_tc.ema_rate}")
    del h_params
    h_per_step = train_launches(ncsnpp_launches(h_mc))
    h_dir = Path(tempfile.mkdtemp(prefix="path_h_"))

    def h_train(workdir, max_steps, preempt, cfg=h_cfg):
        tc = dataclasses.replace(cfg.training, log_freq=1, snapshot_freq=10 ** 9,
                                 snapshot_freq_for_preemption=preempt)
        return lambda data: run_lib.train(dataclasses.replace(cfg, training=tc), data,
                                          workdir=str(workdir), max_steps=max_steps,
                                          compute_dtype=torch.bfloat16, device=dev)

    launches_h, routes_h = train_run(
        "H", h_train(h_dir / "timed", H_STEPS, 10 ** 9), h_batches, h_per_step, H_STEPS,
        h_tc.batch_size)[1:]
    # the restart check, under cuDNN's deterministic algorithms for the
    # library convs and their weight gradients (the port's kernels have no
    # atomics): an uninterrupted run of H_RESTART_STEPS steps, and a run
    # killed after H_RESUME_AT steps (its meta checkpoint at loop index
    # H_RESUME_AT - 1), then restarted: it resumes there and ends where the
    # uninterrupted run ends
    torch.backends.cudnn.deterministic = True
    whole_h = h_train(h_dir / "whole", H_RESTART_STEPS, 10 ** 9)(iter(h_batches))
    h_train(h_dir / "killed", H_RESUME_AT, H_RESUME_AT - 1)(iter(h_batches))
    meta_h = CheckpointManager(str(h_dir / "killed" / "checkpoints-meta"))
    if meta_h.all_steps() != [H_RESUME_AT - 1]:
        fail(f"path H: meta checkpoints {meta_h.all_steps()}, expected [{H_RESUME_AT - 1}]")
    resumed_h = h_train(h_dir / "killed", H_RESTART_STEPS,
                        H_RESUME_AT - 1)(iter(h_batches[H_RESUME_AT:]))
    h_resume = params_close("path H", resumed_h, whole_h)
    torch.backends.cudnn.deterministic = False
    shutil.rmtree(h_dir, ignore_errors=True)
    del whole_h, resumed_h
    # the attention specs of one step's forward (for the timing phase: each
    # keeps its lse and runs one dq and one dk/dv), read by hooks from one
    # forward of the same network at the batch
    h_specs = Counter()
    with torch.no_grad():
        h_net = NCSNpp(h_mc, compute_dtype=torch.bfloat16, device=dev)
        hooks = [m.register_forward_pre_hook(lambda m, a: h_specs.update(
            [(a[0].shape[0], a[0].shape[1] * a[0].shape[2], a[0].shape[1] * a[0].shape[2], 1,
              a[0].shape[3], True)])) for m in h_net.modules() if isinstance(m, SelfAttention2D)]
        h_net(torch.zeros(h_tc.batch_size, 32, 32, 3, device=dev),
              torch.ones(h_tc.batch_size, device=dev))
        for hk in hooks:
            hk.remove()
    del h_net
    per_kernel_h = {name: Counter({spec: n * H_STEPS for spec, n in h_specs.items()})
                    for name in ("attention_lse", "attention_dq", "attention_dkv")}
    if sum(per_kernel_h["attention_dq"].values()) != launches_h["attention_dq"]:
        fail(f"path H: the recorded attention specs {dict(h_specs)} do not cover its launches")
    torch.cuda.empty_cache()

    # cifar10_ddpm through the DDPM eps-MSE branch (training.continuous off:
    # the entry's own default is the continuous VP loss), dropout 0.1 live
    d_cfg = port_configs.get_config("cifar10_ddpm")
    d_cfg = dataclasses.replace(d_cfg, training=dataclasses.replace(d_cfg.training,
                                                                    continuous=False))
    if run_lib.uses_legacy_discrete_loss(d_cfg) or d_cfg.training.continuous:
        fail("cifar10_ddpm with continuous=False must take the DDPM eps-MSE branch")
    log(f"path H: run_lib.train, cifar10_ddpm (DDPM UNet, eps-MSE with antithetic times, "
        f"dropout {d_cfg.model_config.dropout} live), b{d_cfg.training.batch_size}, bf16")
    d_dir = Path(tempfile.mkdtemp(prefix="path_h_ddpm_"))
    d_batches = (h_rng.uniform(-1.0, 1.0, (H_DDPM_STEPS, d_cfg.training.batch_size, 32, 32, 3))
                 .astype(np.float32))
    launches_hd = train_run(
        "H cifar10_ddpm", h_train(d_dir, H_DDPM_STEPS, 10 ** 9, cfg=d_cfg), d_batches,
        train_launches(Counter(conv3x3=47, token_attention=6)), H_DDPM_STEPS,
        d_cfg.training.batch_size)[1]
    shutil.rmtree(d_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # fp32 card vs CPU, reduced width: the continuous VE loss on a small
    # NCSN++ VE (FIR, residual input pyramid, Fourier features), and the
    # DDPM eps-MSE on a small DDPM UNet; dropout off, the same draws
    from dpm_solver_tpu_torch.sde import VESDE

    h_small = NCSNppConfig.tiny(fir=True, progressive_input="residual", embedding_type="fourier",
                                num_res_blocks=1)
    x_small = torch.tensor(h_rng.uniform(0.0, 1.0, (4, 16, 16, 3)), dtype=torch.float32)
    ve_draws = dict(t=torch.tensor(h_rng.uniform(1e-5, 1.0, 4), dtype=torch.float32),
                    z=torch.tensor(h_rng.standard_normal((4, 16, 16, 3)), dtype=torch.float32))

    def ve_step(net_, tx, where):
        score = get_score_fn(VESDE(sigma_max=50.0), lambda x, t: net_(x, t), continuous=True)
        step = tlosses.make_score_train_step(
            tlosses.sde_loss_fn(VESDE(sigma_max=50.0), score, reduce_mean=False), tx)
        d = {k: v.to(where) for k, v in ve_draws.items()}
        return lambda st: step(st, x_small.to(where), TRAIN_SEED, **d)

    # NIN_1: the attention's key projection (its bias shifts every logit of
    # a query alike)
    h_check = {"NCSN++ VE": step_card_vs_cpu(
        "path H, small NCSN++ VE, continuous VE loss",
        lambda where: NCSNpp(h_small, device=where).train(), ve_step, r"\.NIN_1\.b$")}
    ddpm_small = DDPMUNetConfig.tiny(resolution=16)
    ddpm_draws = dict(t=torch.tensor(h_rng.integers(0, 1000, 4)),
                      eps=torch.tensor(h_rng.standard_normal((4, 16, 16, 3)), dtype=torch.float32))

    def ddpm_step(net_, tx, where):
        step = ttrain.make_train_step(lambda x, t: net_(x, t), P.NoiseScheduleVP.discrete(
            betas=np.linspace(1e-4, 0.02, 1000)), tx)
        d = {k: v.to(where) for k, v in ddpm_draws.items()}
        return lambda st: step(st, x_small.to(where), TRAIN_SEED, **d)

    # the key biases, and at the first level (32 channels, GroupNorm's 32
    # groups: one channel a group) what adds a per-channel constant right
    # before a norm: conv1's bias and the time embedding's projection
    # (before norm2), and the last block's conv2 and shortcut biases (before
    # norm_out)
    h_check["DDPM"] = step_card_vs_cpu(
        "path H, small DDPM UNet, eps-MSE", lambda where: DDPMUNet(ddpm_small, device=where),
        ddpm_step, r"\.k\.bias$|^(down|up)\.0\.block\.\d\.(conv1\.bias|temb_proj\.)"
        r"|^up\.0\.block\.1\.(conv2|nin_shortcut)\.bias$")
    log(f"path H done in {time.perf_counter() - t0:.1f} s")

    # ---- 7d. path I: latent-diffusion training (run_lib.train_latent) -------------
    log(f"[{time.perf_counter() - t_start:.1f} s] phase 7d")
    # (cuDNN's own algorithm choice for the timed runs; deterministic again
    # for the restart check at the end)
    torch.backends.cudnn.deterministic = False
    t0 = time.perf_counter()
    i_rng = np.random.default_rng(TRAIN_SEED + 1)
    sd_ucfg, sd_vcfg = ADMConfig.sd_v2_1(), VAEConfig.sd_v1()
    sd_lat = SD_SIZE // 8
    i_dir = Path(tempfile.mkdtemp(prefix="path_i_"))
    # images in [-1, 1] and a 77 x 1024 random context (OpenCLIP ViT-H's width)
    sd_batches = [(i_rng.uniform(-1.0, 1.0, (I_SD_BATCH, SD_SIZE, SD_SIZE, 3)).astype(np.float32),
                   i_rng.standard_normal((I_SD_BATCH, 77, 1024)).astype(np.float32))
                  for _ in range(I_SD_STEPS)]

    def latent_train(preset, workdir, steps, **kw):
        return lambda data: run_lib.train_latent(
            preset, data, workdir=str(workdir), max_steps=steps, log_freq=1,
            snapshot_freq=10 ** 9, snapshot_freq_for_preemption=10 ** 9, seed=TRAIN_SEED,
            compute_dtype=torch.bfloat16, device=dev, **kw)

    enc = Counter(vae_encoder_launches(sd_vcfg))  # the frozen encode: forwards only
    i_per_step = scaled(train_launches(adm_unet_launches(sd_ucfg)), 1, enc)
    log(f"path I: run_lib.train_latent('sd_v2_1'): the SD-2.1 UNet (865.9M params, bf16 "
        f"compute, v target), Adam, b{I_SD_BATCH} at {SD_SIZE} px through the frozen KL-VAE "
        f"encode (posterior sample x 0.18215), a random 77 x 1024 context")
    launches_i, routes_i = train_run(
        "I sd_v2_1", latent_train("sd_v2_1", i_dir / "sd", I_SD_STEPS), sd_batches, i_per_step,
        I_SD_STEPS, I_SD_BATCH, narrow_convs=1)[1:]
    torch.cuda.empty_cache()
    log("path I: the same with adafactor and per-block remat (one warm step, one timed)")
    i_remat = scaled(train_launches(adm_unet_launches(sd_ucfg),
                                    adm_remat_launches(sd_ucfg)), 1, enc)
    launches_ir = train_run(
        "I sd_v2_1 adafactor remat", latent_train("sd_v2_1", i_dir / "sd_af", I_REMAT_STEPS,
                                                  optimizer="adafactor", remat=True),
        sd_batches, i_remat, I_REMAT_STEPS, I_SD_BATCH, narrow_convs=1)[1]
    del sd_batches
    torch.cuda.empty_cache()

    # cin256 at b8, 256 px through the VQ-f4 encode, a class-token context
    # (ClassEmbedder, one token): the only path of the dq and dk/dv kernels
    # at dh 384, 576 and 960 and at S = 1
    cin_ucfg, cin_vcfg = ADMConfig.cin256(), VAEConfig.vq_cin256()
    embedder_i = ClassEmbedder(CIN_CLASSES, CIN_CONTEXT, seed=TRAIN_SEED, device=dev)
    cin_batches = []
    for _ in range(I_CIN_STEPS):
        labels = torch.tensor(i_rng.integers(0, CIN_CLASSES - 1, I_CIN_BATCH), device=dev)
        with torch.no_grad():
            ctx = embedder_i(labels).float().cpu().numpy()
        cin_batches.append((i_rng.uniform(-1.0, 1.0, (I_CIN_BATCH, 256, 256, 3))
                            .astype(np.float32), ctx))
    cin_enc = Counter(vae_encoder_launches(cin_vcfg))
    log(f"path I: run_lib.train_latent('cin256'): the cin256 UNet (400.9M params, bf16, eps "
        f"target), Adam, b{I_CIN_BATCH} at 256 px through the frozen VQ-f4 encode, one "
        f"class token a sample (context {cin_batches[0][1].shape})")
    launches_ic, routes_ic = train_run(
        "I cin256", latent_train("cin256", i_dir / "cin", I_CIN_STEPS), cin_batches,
        scaled(train_launches(adm_unet_launches(cin_ucfg)), 1, cin_enc), I_CIN_STEPS,
        I_CIN_BATCH, narrow_convs=2)[1:]
    # the attention specs of one step's UNet forward (for the timing phase),
    # by hooks on one forward of the same UNet at the batch: the head dims
    # 384, 576 and 960, self-attention and the one-key cross-attention
    with torch.no_grad():
        cin_net = ADMUNet(cin_ucfg, compute_dtype=torch.bfloat16, device=dev)
        cin_lat = torch.zeros(I_CIN_BATCH, 64, 64, cin_ucfg.in_channels, device=dev)
        cin_calls, _ = record_sd_calls(cin_net, None, lambda: cin_net(
            cin_lat, torch.ones(I_CIN_BATCH, device=dev), None,
            torch.tensor(cin_batches[0][1], device=dev)))
    del cin_net, cin_lat, cin_batches
    per_kernel_ic = {name: Counter() for name in ("attention_lse", "attention_dq",
                                                  "attention_dkv")}
    for (name, spec), n in cin_calls.items():
        if name == "token_attention":
            for k in per_kernel_ic:
                per_kernel_ic[k][spec] += n * I_CIN_STEPS
    if sum(per_kernel_ic["attention_dq"].values()) != launches_ic["attention_dq"]:
        fail("path I cin256: the recorded attention specs do not cover its launches")
    cin_dims = sorted({(spec[4], spec[2] == 1) for spec in per_kernel_ic["attention_dq"]})
    log(f"  cin256's attention head dims (dh, S = 1): {cin_dims}")
    if {dh for dh, _ in cin_dims} != {384, 576, 960} or len(cin_dims) != 6:
        fail(f"path I cin256 must run the backward at dh 384, 576 and 960 with and without "
             f"S = 1, ran {cin_dims}")
    torch.cuda.empty_cache()

    # fp32 card vs CPU, reduced width: make_latent_train_step (v target, CFG
    # dropout against a null context, drop mask given) on a small SD-2.x-like
    # UNet (linear transformers, 32-wide heads) through a small KL-VAE's
    # encode (the posterior's mode: the same latents on both sides)
    i_small = ADMConfig(image_size=8, in_channels=4, model_channels=64, out_channels=4,
                        num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                        num_heads=-1, num_head_channels=32, use_spatial_transformer=True,
                        transformer_depth=1, context_dim=64, use_linear_in_transformer=True)
    vae_small = VAEConfig.tiny(resolution=16)
    vae_base = init_random_(AutoencoderKL(vae_small, device="cpu"),
                            torch.Generator().manual_seed(TRAIN_SEED)).eval().state_dict()
    img_small = torch.tensor(i_rng.uniform(-1, 1, (4, 16, 16, 3)), dtype=torch.float32)
    ctx_small = torch.tensor(i_rng.standard_normal((4, 5, 64)), dtype=torch.float32)
    lat_ch = vae_small.embed_dim
    i_draws = dict(t=torch.tensor(i_rng.integers(0, 1000, 4)),
                   eps=torch.tensor(i_rng.standard_normal((4, 8, 8, lat_ch)), dtype=torch.float32),
                   drop=torch.tensor([True, False, False, True]))
    betas = make_ldm_betas(1000)

    def latent_step(net_, tx, where):
        vae_ = AutoencoderKL(vae_small, device=where).eval().requires_grad_(False)
        vae_.load_state_dict(vae_base)
        step = tlatent.make_latent_train_step(
            lambda z, t, c: net_(z, t, None, c), tx, betas,
            encode_fn=tlatent.vae_encode_fn(vae_, sample=False), parameterization="v",
            cond_dropout=0.5, uncond_context=torch.zeros(1, 64, device=where))
        d = {k: v.to(where) for k, v in i_draws.items()}
        return lambda st: step(st, img_small.to(where), ctx_small.to(where), TRAIN_SEED, **d)

    i_check = step_card_vs_cpu("path I, small SD-2.x UNet, v target, CFG dropout",
                               lambda where: ADMUNet(i_small, device=where), latent_step)

    # resume, at reduced width (a full SD-2.1 state with Adam is 14 GB a
    # checkpoint): train_latent on the small UNet and VAE, killed after 3
    # steps and restarted, against an uninterrupted 4-step run
    torch.backends.cudnn.deterministic = True
    small_batches = [(i_rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32),
                      i_rng.standard_normal((2, 5, 64)).astype(np.float32)) for _ in range(4)]
    whole_i = run_lib.train_latent(
        "sd_v2_1", iter(small_batches), workdir=str(i_dir / "whole"), unet_config=i_small,
        vae_config=vae_small, max_steps=4, log_freq=10 ** 9, seed=TRAIN_SEED, cond_dropout=0.5,
        device=dev)
    run_lib.train_latent(
        "sd_v2_1", iter(small_batches), workdir=str(i_dir / "killed"), unet_config=i_small,
        vae_config=vae_small, max_steps=3, snapshot_freq_for_preemption=2, log_freq=10 ** 9,
        seed=TRAIN_SEED, cond_dropout=0.5, device=dev)
    resumed_i = run_lib.train_latent(
        "sd_v2_1", iter(small_batches[3:]), workdir=str(i_dir / "killed"), unet_config=i_small,
        vae_config=vae_small, max_steps=4, log_freq=10 ** 9, seed=TRAIN_SEED, cond_dropout=0.5,
        device=dev)
    i_resume = params_close("path I (small UNet)", resumed_i, whole_i)
    shutil.rmtree(i_dir, ignore_errors=True)
    del whole_i, resumed_i
    training_logs.close()
    torch.backends.cudnn.deterministic = False
    torch.set_grad_enabled(False)
    torch.cuda.empty_cache()
    log(f"path I done in {time.perf_counter() - t0:.1f} s")

    # ---- 7e. paths J-N: the rest of the sampling surface ----------------------------
    log(f"[{time.perf_counter() - t_start:.1f} s] phase 7e")
    t0 = time.perf_counter()
    surface = sampling_surface(dev, smi)
    torch.cuda.empty_cache()
    # each kernel at each spec the paths gave it, in their dtype (bf16),
    # against its plain version at the phase-3 bounds; the fused update at
    # M's and N's solver states
    t1 = time.perf_counter()
    log(f"paths J-N's kernels at their {len(surface['specs'])} specs, bf16, vs plain:")
    for name, spec in sorted(surface["specs"], key=str):
        if name == "conv3x3":
            check_conv(spec, torch.bfloat16, dx=False)
        elif name == "token_attention":
            check_attention(spec, torch.bfloat16)
        elif name == "ln_linear":
            check_ln_linear(*spec, torch.bfloat16, bias=False)
        else:
            check_geglu(*spec, torch.bfloat16)
    for shape in surface["updates"]:
        check_fused(shape)
    torch.cuda.empty_cache()
    log(f"  checked in {time.perf_counter() - t1:.1f} s")
    log(f"paths J-N done in {time.perf_counter() - t0:.1f} s")

    # ---- 8. timing -------------------------------------------------------------
    log(f"[{time.perf_counter() - t_start:.1f} s] phase 8")
    # paths A, B and D both ways in this one call: eager (jit=False, the
    # plain sampler) and replayed from the CUDA graph captured in phases 4,
    # 5 and 7 (jit=True, GraphedSampler), each after a warm call
    walls_by_path = {}

    def time_walls(call, runs):
        """Median, min and max wall (ms) of `runs` calls after a warm one."""
        call()
        walls = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return statistics.median(walls) * 1e3, min(walls) * 1e3, max(walls) * 1e3

    def log_walls(path, what, runs, eager, graphed, unit, per):
        walls_by_path[path] = dict(eager_ms=eager[0], graphed_ms=graphed[0], runs=runs,
                                   eager_range_ms=eager[1:], graphed_range_ms=graphed[1:])
        log(f"path {path} walls on {smi}: {what}, median of {runs}: eager (jit=False) "
            f"{eager[0]:.2f} ms (min {eager[1]:.2f}, max {eager[2]:.2f}) -> {per / eager[0] * 1e3:.4f} "
            f"{unit}; graphed (jit=True, replay) {graphed[0]:.2f} ms (min {graphed[1]:.2f}, max "
            f"{graphed[2]:.2f}) -> {per / graphed[0] * 1e3:.4f} {unit}; "
            f"{eager[0] / graphed[0]:.3f}x")

    runs_a = 7
    log_walls("A", f"b{BATCH} {STEPS} NFE", runs_a,
              time_walls(lambda: solver.sample(x_T, jit=False, **sample_kw), runs_a),
              time_walls(lambda: solver.sample(x_T, jit=True, **sample_kw), runs_a),
              "samples/s", BATCH)
    del solver, net

    # UNet-forward and VAE-decode device spans of each eager call, by CUDA
    # events (a replay runs no Python, so no hook marks its UNet forwards)
    spans = {"unet": [], "vae": []}
    handles = []
    for where, mod in (("unet", unet), ("vae", vae.decoder)):
        pre, post = span_hooks(spans, where)
        handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    pipe.txt2img(SD_PROMPTS, generator=torch.Generator(device=dev).manual_seed(1), jit=False,
                 **sd_kw)
    runs = []
    for _ in range(SD_TIMED_RUNS):
        for v in spans.values():
            v.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.txt2img(SD_PROMPTS, generator=torch.Generator(device=dev).manual_seed(1), jit=False,
                     **sd_kw)
        torch.cuda.synchronize()
        w = time.perf_counter() - t0
        runs.append((w, *(sum(a.elapsed_time(b) for a, b in spans[k]) / 1e3
                          for k in ("unet", "vae"))))
    for h in handles:
        h.remove()
    runs.sort()
    sd_wall, unet_s, vae_s = runs[len(runs) // 2]
    log(f"path B time on {smi}: txt2img b{len(SD_PROMPTS)} {SD_SIZE}px {SD_STEPS} NFE median "
        f"{sd_wall * 1e3:.2f} ms over {len(runs)} runs (min {runs[0][0] * 1e3:.2f}, max "
        f"{runs[-1][0] * 1e3:.2f}) -> {len(SD_PROMPTS) / sd_wall:.4f} images/s; in that run "
        f"UNet forwards {unet_s * 1e3:.2f} ms ({unet_s / sd_wall:.3f} of the wall), VAE decode "
        f"{vae_s * 1e3:.2f} ms ({vae_s / sd_wall:.3f})")
    sd_call = lambda jit: pipe.txt2img(SD_PROMPTS, generator=torch.Generator(device=dev)
                                       .manual_seed(1), jit=jit, **sd_kw)
    log_walls("B", f"txt2img b{len(SD_PROMPTS)} {SD_SIZE}px {SD_STEPS} NFE", SD_TIMED_RUNS,
              (sd_wall * 1e3, runs[0][0] * 1e3, runs[-1][0] * 1e3),
              time_walls(lambda: sd_call(True), SD_TIMED_RUNS), "images/s", len(SD_PROMPTS))
    # path G: img2img and inpaint, each both ways (the encode and decode eager)
    for what, (call, steps) in g_calls.items():
        log_walls(f"G {what}", f"{what} b{b_g} {SD_SIZE}px {steps} NFE", SD_TIMED_RUNS,
                  time_walls(lambda: call(False), SD_TIMED_RUNS),
                  time_walls(lambda: call(True), SD_TIMED_RUNS), "images/s", b_g)
    # path F: class_conditional_sample both ways (the VQ decode eager)
    log_walls("F", f"cin256 class_conditional_sample b{CIN_LABELS} 256px {CIN_STEPS} NFE",
              CIN_TIMED_RUNS, time_walls(lambda: cin_call(False), CIN_TIMED_RUNS),
              time_walls(lambda: cin_call(True), CIN_TIMED_RUNS), "images/s", CIN_LABELS)
    del model_f, sampler_f, embedder_f, ckpt_f
    torch.cuda.empty_cache()

    # path C: wall time, and the UNet-forward and classifier forward+backward
    # device spans by CUDA events (the classifier's ends at the hook on its
    # input's gradient)
    gspans = {"unet": [], "classifier": []}

    def on_classifier(x_in):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        gspans["classifier"].append([ev])

        def done(grad):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            gspans["classifier"][-1].append(end)
        x_in.register_hook(done)

    upre, upost = span_hooks(gspans, "unet")
    handles = [gunet.register_forward_pre_hook(upre), gunet.register_forward_hook(upost)]
    timed_c = guided_sampler(gunet, clf, y_dev, on_classifier=on_classifier)
    timed_c(gx_T)  # warm
    runs = []
    for _ in range(GUIDED_TIMED_RUNS):
        for v in gspans.values():
            v.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed_c(gx_T)
        torch.cuda.synchronize()
        w = time.perf_counter() - t0
        runs.append((w, *(sum(a.elapsed_time(b) for a, b in gspans[k]) / 1e3
                          for k in ("unet", "classifier"))))
    for h in handles:
        h.remove()
    runs.sort()
    c_wall, c_unet_s, c_clf_s = runs[len(runs) // 2]
    log(f"path C time on {smi}: guided b{GUIDED_BATCH} {GUIDED_SIZE}px {GUIDED_STEPS} NFE median "
        f"{c_wall * 1e3:.2f} ms over {len(runs)} runs (min {runs[0][0] * 1e3:.2f}, max "
        f"{runs[-1][0] * 1e3:.2f}) -> {GUIDED_BATCH / c_wall:.4f} samples/s; in that run UNet "
        f"forwards {c_unet_s * 1e3:.2f} ms ({c_unet_s / c_wall:.3f} of the wall), classifier "
        f"forward+backward {c_clf_s * 1e3:.2f} ms ({c_clf_s / c_wall:.3f})")

    # path D: wall time, and the network forwards' device spans by CUDA events
    # (eager); then the graphed sampler's wall
    dspans = {"net": []}
    pre, post = span_hooks(dspans, "net")
    handles = [dnet.register_forward_pre_hook(pre), dnet.register_forward_hook(post)]
    sample_d(dx_T)  # warm
    runs = []
    for _ in range(SCORE_TIMED_RUNS):
        dspans["net"].clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample_d(dx_T)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0,
                     sum(a.elapsed_time(b) for a, b in dspans["net"]) / 1e3))
    for h in handles:
        h.remove()
    runs.sort()
    d_wall, d_net_s = runs[len(runs) // 2]
    log(f"path D time on {smi}: ScoreSDE b{SCORE_BATCH} {SCORE_STEPS} NFE median "
        f"{d_wall * 1e3:.2f} ms over {len(runs)} runs (min {runs[0][0] * 1e3:.2f}, max "
        f"{runs[-1][0] * 1e3:.2f}) -> {SCORE_BATCH / d_wall:.2f} samples/s; in that run network "
        f"forwards {d_net_s * 1e3:.2f} ms ({d_net_s / d_wall:.3f} of the wall)")
    log_walls("D", f"ScoreSDE b{SCORE_BATCH} {SCORE_STEPS} NFE", SCORE_TIMED_RUNS,
              (d_wall * 1e3, runs[0][0] * 1e3, runs[-1][0] * 1e3),
              time_walls(lambda: graphed_d(dx_T), SCORE_TIMED_RUNS), "samples/s",
              SCORE_BATCH)
    del graphed_d

    # path E: the wall of the counted bits/dim call and of LIK_TIMED_RUNS
    # more, and the network's forward and backward device spans by CUDA events
    runs = e_runs
    for _ in range(LIK_TIMED_RUNS):
        for v in espans.values():
            v.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, nfe = lik_e(e_data, epsilon=e_probe)
        torch.cuda.synchronize()
        if nfe != nfe_e:
            fail(f"path E: {nfe} NFE on a repeated call, {nfe_e} on the first")
        runs.append((time.perf_counter() - t0,
                     *(sum(a.elapsed_time(b) for a, b in espans[k]) / 1e3
                       for k in ("forward", "backward"))))
    runs.sort()
    e_wall, e_fwd_s, e_bwd_s = runs[len(runs) // 2]
    log(f"path E time on {smi}: bits/dim b{LIK_BATCH} {nfe_e} NFE median {e_wall * 1e3:.2f} ms "
        f"over {len(runs)} runs (min {runs[0][0] * 1e3:.2f}, max {runs[-1][0] * 1e3:.2f}) -> "
        f"{e_wall / nfe_e * 1e3:.3f} ms per NFE, {LIK_BATCH / e_wall:.3f} images/s, bits/dim "
        f"{bpd_e.mean().item():.4f}; in that run network forwards {e_fwd_s * 1e3:.2f} ms "
        f"({e_fwd_s / e_wall:.3f} of the wall), backwards {e_bwd_s * 1e3:.2f} ms "
        f"({e_bwd_s / e_wall:.3f})")
    # one stage (forward + vector-Jacobian product) at b1 and at the path's
    # batch: where they take the same time, the stage is host-bound
    drift_e = reverse_sde(VPSDE(), get_score_fn(VPSDE(), enet), probability_flow=True).sde
    stage_ms = {}
    for b in (1, LIK_BATCH):
        x1, p1, t1 = e_data[:b], e_probe[:b], torch.full((b,), 0.5, device=dev)
        walls = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hutchinson_divergence(lambda xi, ti: drift_e(xi, ti)[0], x1, t1, p1)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        stage_ms[b] = statistics.median(walls[1:]) * 1e3
    log(f"  one stage (forward + vjp) on {smi}: b1 {stage_ms[1]:.2f} ms, b{LIK_BATCH} "
        f"{stage_ms[LIK_BATCH]:.2f} ms (median of 3 after a warm one)")

    # each kernel at the shapes and counts of one call of each path
    ctx = encode(SD_PROMPTS + [""] * len(SD_PROMPTS)).to(dev)
    lat = SD_SIZE // 8
    unet_calls, vae_calls = record_sd_calls(unet, vae, lambda: (
        unet(torch.randn(2 * len(SD_PROMPTS), lat, lat, 4, device=dev),
             torch.full((2 * len(SD_PROMPTS),), 500.0, device=dev), None, ctx),
        vae.decode(torch.randn(len(SD_PROMPTS), lat, lat, 4, device=dev))))
    # path G's img2img call, its encode included, recorded whole
    calls_g = record_sd_calls(unet, vae, lambda: g_calls["img2img"][0](False), encoder=True)
    del unet, vae, pipe
    torch.cuda.empty_cache()
    per_kernel_a = {"conv3x3": Counter({spec: n * STEPS for spec, n in conv_calls.items()}),
                    "token_attention": Counter({(BATCH, 256, 256, 1, 256, False): 5 * STEPS,
                                                (BATCH, 16, 16, 1, 256, False): STEPS}),
                    "fused_update": Counter({((BATCH, 32, 32, 3),): STEPS})}
    timing = {name: {} for name in REPLACES}   # kernel -> path -> its times there

    def time_path(path, per_kernel, launches, what, dtype=None):
        for name, calls in per_kernel.items():
            if calls:
                timing[name][path] = dict(time_kernel(name, calls, randn, smi, what, dtype),
                                          launches=launches[name])

    log(f"kernel times, path A (one {STEPS}-NFE sample call, b{BATCH}, bf16):")
    time_path("A", per_kernel_a, launches_a, f"one path-A sample call, b{BATCH}")
    per_kernel_b = {name: Counter() for name in REPLACES}
    for (name, spec), n in unet_calls.items():
        per_kernel_b[name][spec] += n * SD_STEPS
    for (name, spec), n in vae_calls.items():
        per_kernel_b[name][spec] += n
    per_kernel_b["fused_update"][((len(SD_PROMPTS), lat, lat, 4),)] = SD_STEPS
    for name, calls in per_kernel_b.items():
        if sum(calls.values()) != expected[name]:
            fail(f"{name}: the recorded shapes cover {sum(calls.values())} launches, "
                 f"the call makes {expected[name]}")
    log(f"kernel times, path B (one txt2img call: {SD_STEPS} UNet forwards at b"
        f"{2 * len(SD_PROMPTS)} and one VAE decode at b{len(SD_PROMPTS)}, bf16):")
    time_path("B", per_kernel_b, launches_b, f"one txt2img call, SD-2.1 {SD_SIZE}px "
              f"b{len(SD_PROMPTS)}")
    # the "narrow" route alone at its path-B launches (the VAE decoder's
    # conv_in and conv_out), beside the plain conv, cuDNN and the bound
    narrow_b = Counter({spec: n for spec, n in per_kernel_b["conv3x3"].items()
                        if spec[3] % 8 or spec[4] % 8})
    if sum(narrow_b.values()) != routes_b["conv3x3"].get("narrow", 0):
        fail(f"path B's narrow convs {dict(narrow_b)} are not its {routes_b['conv3x3']}")
    log("kernel times, the \"narrow\" conv route at its path-B launches (bf16):")
    rec = timing["conv3x3"]["B narrow"] = dict(
        time_kernel("conv3x3", narrow_b, randn, smi, "the narrow route's launches of one "
                    f"txt2img call, SD-2.1 {SD_SIZE}px b{len(SD_PROMPTS)}"),
        launches=sum(narrow_b.values()))
    # and device alone (one call captured in a CUDA graph, so the wrapper's
    # host work, ~40 us, is not in it), beside cuDNN's the same way
    rec.update(device_alone_ms=0.0, library_device_alone_ms=0.0)
    for spec, n in sorted(narrow_b.items()):
        case = make_case("conv3x3", spec, randn)
        k, lib = graph_ms([case.kernel], 1), graph_ms([case.library], 1)
        rec["device_alone_ms"] += n * k
        rec["library_device_alone_ms"] += n * lib
        log(f"  conv3x3 {spec} on {smi}, device alone: narrow {k:.4f} ms, cuDNN {lib:.4f} ms, "
            f"bound {max(case.bound()) * 1e3:.4f} ms")
        del case
    log(f"the narrow route's path-B launches, device alone: {rec['device_alone_ms']:.4f} ms "
        f"against cuDNN's {rec['library_device_alone_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_ms'] / rec['device_alone_ms']:.3f} of the kernel's time)")


    # path C: the specs of one NFE (a UNet forward, a classifier forward and
    # backward), times the NFE count
    t_mid = torch.full((GUIDED_BATCH,), 500.0, device=dev)

    def one_nfe():
        gunet(gx_T, t_mid, y_dev)
        with torch.enable_grad():
            x_in = gx_T.detach().requires_grad_(True)
            torch.autograd.grad(clf(x_in, t_mid).sum(), x_in)

    unet_c, clf_c = record_guided_calls(gunet, clf, one_nfe)
    del gunet, clf, sample_c, timed_c
    torch.cuda.empty_cache()

    # ---- 7f. paths O and P: first-stage training and evaluation ------------------
    log(f"[{time.perf_counter() - t_start:.1f} s] phase 7f")
    # (here, once the walls above are timed and the earlier paths' networks
    # and CUDA graphs are freed: O's KL-f8 step at b12 takes 62 GiB)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 7f starts with {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    t0 = time.perf_counter()
    fse = first_stage_and_eval(dev, smi)
    torch.set_grad_enabled(False)
    torch.cuda.empty_cache()
    # each kernel at each spec the runs gave it, in the run's dtype (O fp32,
    # P bf16), against its plain version: conv3x3 (with its dx where the run
    # took one) at the phase-3 bounds, the attention forward with its lse and
    # its dq and dk/dv at BWD_BOUND; the fused update at P's solver state
    t1 = time.perf_counter()
    fse_dtype = {"o": torch.float32, "o_vq": torch.float32, "p_train": torch.bfloat16,
                 "p": torch.bfloat16}
    fse_checks = set()
    for run, seen in fse["specs"].items():
        dt = fse_dtype[run]
        for name, spec in seen:
            if name == "conv3x3":
                fse_checks.add(("conv", spec, dt, ("conv3x3_dx", spec) in seen))
            elif name == "attention_lse":
                fse_checks.add(("bwd", spec, dt, True))
            elif name == "token_attention":
                fse_checks.add(("attn", spec, dt, False))
    log(f"paths O and P's kernels at their {len(fse_checks)} specs, each in its run's dtype, "
        f"vs plain:")
    for what, spec, dt, dx in sorted(fse_checks, key=str):
        if what == "conv":
            check_conv(spec, dt, dx=dx)
        elif what == "bwd":
            check_attention_bwd(spec, dt, BWD_BOUND[str(dt)[6:]])
        else:
            check_attention(spec, dt)
    check_fused((fse["eval_batch"], 32, 32, 3))
    torch.cuda.empty_cache()
    log(f"  checked in {time.perf_counter() - t1:.1f} s")
    log(f"paths O and P done in {time.perf_counter() - t0:.1f} s")

    # ---- 7g. path Q: the data path from disk ------------------------------------
    log(f"[{time.perf_counter() - t_start:.1f} s] phase 7g")
    # (here, once 7f's networks are freed; host work, each number beside the
    # host's nproc)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 7g starts with {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    path_q = data_path(dev, smi, fse.pop("p_samples"))
    torch.cuda.empty_cache()

    # ---- 7h. path R: SD-1 txt2img (and the rest of the CLI) through the CLI --------
    log(f"[{time.perf_counter() - t_start:.1f} s] phase 7h")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 7h starts with {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    path_r = cli_path(dev, smi)
    torch.set_grad_enabled(False)
    torch.cuda.empty_cache()
    # each kernel at each spec the float txt2img call gave it (bf16: the UNet at
    # CFG b8 on 64x64 latents, the VAE decode at 512 px), against its plain
    # version at the phase-3 bounds; the fused update at its solver state
    t1 = time.perf_counter()
    log(f"path R's kernels at their {len(path_r['specs'])} specs, bf16, vs plain:")
    for name, spec in sorted(path_r["specs"], key=str):
        if name == "conv3x3":
            check_conv(spec, torch.bfloat16, dx=False)
        elif name == "token_attention":
            check_attention(spec, torch.bfloat16)
        elif name == "ln_linear":
            check_ln_linear(*spec, torch.bfloat16, bias=False)
        else:
            check_geglu(*spec, torch.bfloat16)
    check_fused((R_BATCH, R_SIZE // 8, R_SIZE // 8, 4))
    torch.cuda.empty_cache()
    log(f"  checked in {time.perf_counter() - t1:.1f} s")

    # ---- 7i. path S: parallelism -------------------------------------------------
    log(f"[{time.perf_counter() - t_start:.1f} s] phase 7i")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 7i starts with {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    path_s = parallel_path(dev, smi)
    finish_demo(demo)
    torch.set_grad_enabled(False)
    torch.cuda.empty_cache()
    # each kernel at each spec path S's sharded calls gave it (a rank's rows,
    # the tensor-parallel local heads and widths), in the dtype it ran,
    # against its plain version at the phase-3 bounds (conv3x3 with its dx
    # where a train step took one: S3, S4 and S5's, fp32); the attention
    # backward, LayerNorm->Linear's and GEGLU's gradients at the TP train
    # step's local shapes; the fused update at the per-rank states
    t1 = time.perf_counter()
    n_specs = sum(len(v) for v in path_s["specs"].values())
    log(f"path S's kernels at their {n_specs} specs vs plain:")
    for dt_name, specs in path_s["specs"].items():
        dt = getattr(torch, dt_name)
        for (name, spec) in sorted(specs, key=str):
            if name == "conv3x3":
                check_conv(spec, dt, dx=(dt_name, spec) in path_s["dx_specs"])
            elif name == "token_attention":
                check_attention(spec, dt)
                if dt == torch.float32 and spec[1] <= 256:   # the TP train step's sites
                    check_attention_bwd(spec, dt, BWD_BOUND[dt_name])
            elif name == "ln_linear":
                check_ln_linear(*spec, dt, bias=False)
            else:
                check_geglu(*spec, dt)
    for shape in [(BATCH // 2, 32, 32, 3), (2, 32, 32, 3), (2, 64, 64, 4), (1, 16, 16, 4)]:
        check_fused(shape)
    for (name, spec) in sorted(path_s["specs"]["float32"], key=str):
        if name not in ("ln_linear", "geglu_ff") or spec[0] > 512:
            continue
        m, d, n = spec
        fn, plain = (ops.ln_linear, ops.ln_linear_plain) if name == "ln_linear" else \
            (ops.geglu_ff, ops.geglu_plain)
        if name == "ln_linear":
            args = (randn(m, d), 1 + 0.1 * randn(d), 0.1 * randn(d), randn(n, d) * d ** -0.5,
                    0.1 * randn(n))
            cot = randn(m, n)
        else:
            args = (randn(m, d), randn(2 * n, d) * d ** -0.5, 0.1 * randn(2 * n),
                    randn(d, n) * n ** -0.5, 0.1 * randn(d))
            cot = randn(m, d)
        with torch.enable_grad():
            ins = [a.clone().requires_grad_(True) for a in args]
            got = torch.autograd.grad(fn(*ins), ins, cot)
            ref = [a.clone().requires_grad_(True) for a in args]
            want = torch.autograd.grad(plain(*ref), ref, cot)
        for k, (a, b) in enumerate(zip(got, want)):
            report(f"{name}_grad", (m, d, n, k), torch.float32, a, b, BOUND["float32"])
    torch.cuda.empty_cache()
    log(f"  checked in {time.perf_counter() - t1:.1f} s")

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 8, the kernel times")
    # dq and dk/dv at the classifier's own attention sites, as the call
    # recorded them (its blocks at 32x32, 16x16, 8x8 and the attention pool)
    for spec in sorted({spec for name, spec in clf_c if name == "attention_dq"}, key=str):
        check_attention_bwd(spec, torch.bfloat16, BWD_BOUND["bfloat16"])
    per_kernel_c = {name: Counter() for name in REPLACES}
    for (name, spec), n in chain(unet_c.items(), clf_c.items()):
        per_kernel_c[name][spec] += n * GUIDED_STEPS
    per_kernel_c["fused_update"][((GUIDED_BATCH, GUIDED_SIZE, GUIDED_SIZE, 3),)] = GUIDED_STEPS
    for name, calls in per_kernel_c.items():
        if sum(calls.values()) != expected_c[name]:
            fail(f"{name}: the recorded shapes cover {sum(calls.values())} launches, "
                 f"the guided call makes {expected_c[name]}")
    log(f"kernel times, path C (one guided call: {GUIDED_STEPS} UNet forwards and classifier "
        f"forwards and backwards at b{GUIDED_BATCH}, bf16):")
    time_path("C", per_kernel_c, launches_c, f"one guided call, ImageNet-256 b{GUIDED_BATCH}")
    # what writing the lse costs: the forward without it, at the same shapes;
    # and the library call's output and lse against the kernel's
    for spec, n in sorted(per_kernel_c["attention_lse"].items(), key=lambda kv: str(kv[0])):
        kernel, _, library = make_case("attention_lse", spec, randn)[:3]
        lse_ms = cuda_ms(kernel)
        fwd_ms = cuda_ms(make_case("token_attention", spec, randn).kernel)
        (o, lse), lib = kernel(), library()
        d_o = rel_err(o, lib[0].transpose(1, 2).flatten(2))[1]
        lib_lse = lib[1][..., :spec[1]].reshape(lse.shape)
        d_lse = rel_err(lse, lib_lse * math.log2(math.e))[1]
        log(f"  lse cost x{n} {spec}: forward with lse {lse_ms:.4f} ms, without {fwd_ms:.4f} ms; "
            f"library vs kernel /max: o {d_o:.2e}, lse {d_lse:.2e}")
    # what conv3x3_dx's flipped-weight copy costs, at the classifier's convs
    flip_ms = 0.0
    for (b, h, w, c, co), n in per_kernel_c["conv3x3_dx"].items():
        wt = randn(3, 3, c, co).to(torch.bfloat16)
        flip_ms += n * cuda_ms(lambda: flip_weight(wt))
    dx = timing["conv3x3_dx"]["C"]
    dx["flip_ms"] = flip_ms
    log(f"conv3x3_dx: its {dx['launches']} weight flips take {flip_ms:.3f} ms of its "
        f"{dx['ms']:.3f} ms per guided call")

    # SD-1: the specs of the one UNet forward of phase 3 (CFG b2, 64x64)
    per_kernel_s1 = {name: Counter() for name in REPLACES}
    for (name, spec), n in s1_calls.items():
        per_kernel_s1[name][spec] += n
    log("kernel times, SD-1 (one UNet forward at 64x64 latents, CFG b2, bf16: dh 40/80/160):")
    time_path("SD-1", {k: v for k, v in per_kernel_s1.items()
                       if k in ("conv3x3", "token_attention", "ln_linear", "geglu_ff")},
              launches_s1, "one SD-1 UNet forward, 64x64 latents, CFG b2")

    # path D: the specs of one network forward, times the plan's evaluations
    d_calls = Counter()

    def d_hook(mod, args):
        x = args[0]
        if isinstance(mod, ops.Conv3x3):
            d_calls["conv3x3", (*x.shape, mod.weight.shape[0])] += 1
        else:
            b, h, w, c = x.shape
            d_calls["token_attention", (b, h * w, h * w, 1, c, True)] += 1

    handles = [m.register_forward_pre_hook(d_hook) for m in dnet.modules()
               if isinstance(m, (ops.Conv3x3, SelfAttention2D))]
    dnet(dx_T, torch.full((SCORE_BATCH,), 500.0, device=dev))
    for h in handles:
        h.remove()
    evals_d = expected_d["conv3x3"] // per_forward["conv3x3"]
    per_kernel_d = {name: Counter() for name in REPLACES}
    for (name, spec), n in d_calls.items():
        per_kernel_d[name][spec] += n * evals_d
    per_kernel_d["fused_update"][((SCORE_BATCH, side, side, 3),)] = expected_d["fused_update"]
    for name, calls in per_kernel_d.items():
        if sum(calls.values()) != expected_d[name]:
            fail(f"{name}: the recorded shapes cover {sum(calls.values())} launches, "
                 f"the ScoreSDE call makes {expected_d[name]}")
    log(f"kernel times, path D (one {SCORE_STEPS}-NFE singlestep call, b{SCORE_BATCH}, bf16):")
    time_path("D", per_kernel_d, launches_d, f"one ScoreSDE sample call, DDPM++ deep "
              f"b{SCORE_BATCH}")

    # the fused update's device time alone: each path's launches captured in
    # one CUDA graph and replayed (as the graphed executor runs them), beside
    # the back-to-back time above, which reads the host's work a launch. In
    # the trajectory a network evaluation passes between two updates, so each
    # finds its inputs out of the 50 MB L2: the launches rotate over input
    # sets at least 100 MB apart
    for path, calls in (("A", per_kernel_a), ("B", per_kernel_b), ("C", per_kernel_c),
                        ("D", per_kernel_d)):
        (spec, n), = calls["fused_update"].items()
        sets = min(n, -(-100_000_000 // (5 * 4 * math.prod(spec[0]))))
        cases = [make_case("fused_update", spec, randn) for _ in range(sets)]
        rec = timing["fused_update"][path]
        rec["device_alone_ms"] = graph_ms([c.kernel for c in cases], n)
        del cases
        rec["device_alone_bound_share"] = rec["bound_ms"] / rec["device_alone_ms"]
        log(f"fused_update on {smi}, path {path} {spec[0]} x{n}: device alone (one CUDA graph, "
            f"{sets} input sets) "
            f"{rec['device_alone_ms']:.4f} ms, back to back {rec['ms']:.4f} ms, bound "
            f"{rec['bound_ms']:.4f} ms ({rec['device_alone_bound_share']:.3f} of the device-alone "
            f"time, {rec['bound_share']:.3f} of the back-to-back)")

    # path E: the specs of one network forward (e_calls, 7b), times the NFE
    per_kernel_e = {name: Counter() for name in REPLACES}
    for (names, spec), n in e_calls.items():
        for name in names:
            per_kernel_e[name][spec] += n * nfe_e
    for name, calls in per_kernel_e.items():
        if sum(calls.values()) != expected_e[name]:
            fail(f"{name}: the recorded shapes cover {sum(calls.values())} launches, "
                 f"the bits/dim call makes {expected_e[name]}")
    log(f"kernel times, path E (one {nfe_e}-NFE bits/dim call, b{LIK_BATCH}, fp32):")
    time_path("E", per_kernel_e, launches_e, f"one bits/dim call, DDPM++ deep b{LIK_BATCH}, "
              f"{nfe_e} NFE", torch.float32)

    # path G's img2img call (15 UNet forwards at CFG b8, one VAE encode and
    # one decode at b4, bf16), the "narrow" conv at its launches (the
    # encoder's conv_in beside the decoder's two), then path F's call (20
    # cin256 UNet forwards at CFG b16, one VQ decode at b8): recorded from
    # the calls themselves
    def per_kernel(recorded, fused_spec, steps, launches):
        out = {name: Counter() for name in REPLACES}
        for calls in recorded:
            for (name, spec), n in calls.items():
                out[name][spec] += n
        out["fused_update"][fused_spec] = steps
        for name, calls in out.items():
            if sum(calls.values()) != launches[name]:
                fail(f"{name}: the recorded shapes cover {sum(calls.values())} launches, "
                     f"the call makes {launches[name]}")
        return out

    per_kernel_g = per_kernel(calls_g, ((b_g, lat, lat, 4),), steps_g, launches_g)
    log(f"kernel times, path G (one img2img call: {steps_g} UNet forwards at b{2 * b_g}, one VAE "
        f"encode and one decode at b{b_g}, bf16):")
    time_path("G", per_kernel_g, launches_g, f"one img2img call, SD-2.1 {SD_SIZE}px b{b_g}")
    narrow_g = Counter({spec: n for spec, n in per_kernel_g["conv3x3"].items()
                        if spec[3] % 8 or spec[4] % 8})
    if sum(narrow_g.values()) != routes_g["conv3x3"].get("narrow", 0):
        fail(f"path G's narrow convs {dict(narrow_g)} are not its {routes_g['conv3x3']}")
    log("kernel times, the \"narrow\" conv route at its path-G launches (bf16):")
    timing["conv3x3"]["G narrow"] = dict(
        time_kernel("conv3x3", narrow_g, randn, smi, "the narrow route's launches of one "
                    f"img2img call, SD-2.1 {SD_SIZE}px b{b_g}"), launches=sum(narrow_g.values()))
    per_kernel_f = per_kernel((unet_calls_f, vae_calls_f), ((CIN_LABELS, 64, 64, 3),),
                              CIN_STEPS, launches_f)
    log(f"kernel times, path F (one class_conditional_sample call: {CIN_STEPS} cin256 UNet "
        f"forwards at b{2 * CIN_LABELS}, one VQ decode at b{CIN_LABELS}, bf16):")
    time_path("F", per_kernel_f, launches_f, f"one cin256 class_conditional_sample call, "
              f"b{CIN_LABELS}")
    # the attention at cin256's sites alone, by spec (the new head dims)
    log("kernel times, the attention forward at path F's sites, by spec (bf16):")
    timing["token_attention"]["F by spec"] = time_kernel(
        "token_attention", per_kernel_f["token_attention"], randn, smi,
        "path F's attention launches", per_spec=True)

    # the training paths' attention kernels (the lse forward, dq, dk/dv) at
    # their sites and counted launches: H's NCSN++ (dh 256) and I's cin256
    # (dh 384, 576, 960, self-attention and S = 1)
    log(f"kernel times, path H (the attention of {H_STEPS} training steps, NCSN++ VE "
        f"b{h_tc.batch_size}, bf16):")
    time_path("H", per_kernel_h, launches_h, f"path H's {H_STEPS} run_lib.train steps")
    log(f"kernel times, path I cin256 (the attention of {I_CIN_STEPS} train_latent steps, "
        f"b{I_CIN_BATCH}, bf16):")
    for name, calls in per_kernel_ic.items():  # with each site's times ("by_spec")
        timing[name]["I"] = dict(time_kernel(
            name, calls, randn, smi, f"path I's {I_CIN_STEPS} cin256 train_latent steps",
            per_spec=True), launches=launches_ic[name])

    # path O: the fp32 kernels of the KL run's steps (conv3x3 and its dx at
    # the VAE's 256 px sites, the mid attention's lse, dq and dk/dv at dh 512,
    # T = S = 1,024) and the VQ run's attention (dh 512 at T = S = 4,096);
    # path P: the bf16 sampler's kernels at the eval batch, one sampling call
    # (the counted evaluation ran it twice, the warm call and the capture)
    def fse_calls(run, names, scale=1):
        out = {name: Counter() for name in names}
        for (name, spec), n in fse["specs"][run].items():
            if name in out and (run != "p" or spec[0] == fse["eval_batch"]):
                out[name][spec] += n // scale
        return out

    log(f"kernel times, path O (KL-f8 b{O_KL_BATCH} 256 px, {O_KL_STEPS + 1} "
        f"train_autoencoder steps, fp32):")
    time_path("O", fse_calls("o", REPLACES), fse["launches"]["o"],
              f"path O's {O_KL_STEPS + 1} KL-f8 train_autoencoder steps, b{O_KL_BATCH}",
              torch.float32)
    log(f"kernel times, path O VQ-f4 (the attention of {O_VQ_STEPS + 1} steps, b{O_VQ_BATCH}, "
        f"fp32):")
    time_path("O_vq", fse_calls("o_vq", ("attention_lse", "attention_dq", "attention_dkv")),
              fse["launches"]["o_vq"], f"path O's {O_VQ_STEPS + 1} VQ-f4 train_autoencoder "
              f"steps, b{O_VQ_BATCH}", torch.float32)
    per_kernel_p = fse_calls("p", ("conv3x3", "token_attention"), scale=2)
    per_kernel_p["fused_update"] = Counter({((fse["eval_batch"], 32, 32, 3),): STEPS})
    log(f"kernel times, path P (one {STEPS}-NFE sampling round at b{fse['eval_batch']}, bf16):")
    time_path("P", per_kernel_p, fse["launches"]["p"],
              f"one path-P sampling round, b{fse['eval_batch']}")

    # the dq and dk/dv kernels at each head dim and dtype they take, one
    # launch at each of BWD_SHAPES' and WIDE_BWD's sites (the ragged ones
    # aside), beside the plain twin (dq, dk and dv in one pass), SDPA's
    # backward and their bound
    bwd_by_dh = []
    for b, t, s, heads, dh, fused in BWD_SHAPES + WIDE_BWD:
        if t % 64:   # a ragged check shape, not a site
            continue
        for dt in (torch.float32, torch.bfloat16):
            spec, ms, bound, work = (b, t, s, heads, dh, fused), {}, 0.0, 0.0
            for name in ("attention_dq", "attention_dkv"):
                case = make_case(name, spec, randn, dtype=dt)
                ms[name] = cuda_ms(case.kernel)
                bound += max(case.bound()) * 1e3
                work += case.work
            # the plain twin and SDPA's backward each compute dq, dk and dv
            plain_ms, lib_ms = cuda_ms(case.plain), cuda_ms(case.library)
            del case
            torch.cuda.empty_cache()
            total = ms["attention_dq"] + ms["attention_dkv"]
            rate = work / total / 1e9
            log(f"  backward {spec} {str(dt)[6:]} on {smi}: dq {ms['attention_dq']:.4f} + dk/dv "
                f"{ms['attention_dkv']:.4f} = {total:.4f} ms ({rate:.1f} TFLOP/s), plain "
                f"{plain_ms:.4f} ms, SDPA backward {lib_ms:.4f} ms, bound {bound:.4f} ms "
                f"({bound / total:.3f} of the kernels' time)")
            bwd_by_dh.append(dict(spec=list(spec), dtype=str(dt)[6:], dq_ms=ms["attention_dq"],
                                  dkv_ms=ms["attention_dkv"], plain_ms=plain_ms,
                                  library_ms=lib_ms, bound_ms=bound, tflops=rate,
                                  bound_share=bound / total))

    # the kernels no path launches, one launch at each shape where they would
    # run: bias + LeakyReLU at path D's activations (every conv3x3 input), the
    # fused attention output at the SD sites it is checked at (phase 3): SD-2.1
    # 768 px at CFG b8 (its first two are row 10's first sites), SD-1 512
    # px at CFG b2 (self- and cross-attention), the single heads of dh 256 and
    # 512; its library yardstick is SDPA then torch.addmm (make_case)
    act_shapes = sorted({spec[:4] for spec in per_kernel_d["conv3x3"]})
    cfg_b = 2 * len(SD_PROMPTS)
    sd_sites = [(cfg_b, 9216, 9216, 5, 64, 320), (cfg_b, 2304, 2304, 10, 64, 640),
                (cfg_b, 576, 576, 20, 64, 1280), (cfg_b, 144, 144, 20, 64, 1280)]
    out_sites = sd_sites + [(2, 4096, 4096, 8, 40, 320), (2, 1024, 1024, 8, 80, 640),
                            (2, 256, 256, 8, 160, 1280), (2, 64, 64, 8, 160, 1280),
                            (2, 4096, 77, 8, 40, 320), (2, 1024, 77, 8, 80, 640),
                            (2, 256, 77, 8, 160, 1280), (8, 256, 256, 1, 256, 256),
                            (1, 1024, 1024, 1, 512, 512)]
    acts = f"path D's activations, b{SCORE_BATCH}"
    for name, specs, where in [
            ("fused_bias_act", [(s,) for s in act_shapes], acts),
            ("fused_bias_act_bwd", [(s,) for s in act_shapes], acts),
            ("attention_out_fused", out_sites,
             f"the SD-2.1 768 px (CFG b{cfg_b}) and SD-1 512 px (CFG b2) sites and the dh "
             f"256 and 512 single heads")]:
        log(f"kernel times, {name} (no path launches it; one launch at each of {where}):")
        timing[name]["none"] = dict(time_kernel(name, Counter(specs), randn, smi,
                                                f"one launch at each of {where}",
                                                per_spec=name == "attention_out_fused"),
                                    launches=0)
    # beside it, the port's unfused composition (what path B runs at those
    # sites today): the attention kernel, the out-projection (F.linear with
    # the bias) and the add; and each site's tile and cluster
    out_timing = timing["attention_out_fused"]["none"]
    for rec in out_timing["by_spec"]:
        b, t, s, heads, dh, c = rec["spec"]
        inner = heads * dh
        q, k, v = (randn(b, n, inner).to(torch.bfloat16) for n in (t, s, s))
        wt = (randn(c, inner) * inner ** -0.5).to(torch.bfloat16)
        bias, res = (randn(c) * 0.1).to(torch.bfloat16), randn(b, t, c).to(torch.bfloat16)
        rec["unfused_ms"] = cuda_ms(lambda: torch.add(F.linear(
            ops.token_attention(q, k, v, num_heads=heads), wt, bias), res))
        tile = out_plan(dh, inner, c, torch.bfloat16, b, t, s)
        rec["tile"] = dict(rows=tile.rows, block_kv=tile.block_kv, stages=tile.stages,
                           cluster=tile.cluster)
        log(f"  {(b, t, s, heads, dh, c)} on {smi}: fused {rec['ms']:.4f} ms vs unfused "
            f"(token_attention + F.linear + add) {rec['unfused_ms']:.4f} ms, library (SDPA + "
            f"addmm) {rec['library_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
            f"{rec['bound_ms']:.4f} ms; rows {tile.rows}, cluster {tile.cluster}"
            f"{'; FUSED WINS' if rec['ms'] < rec['unfused_ms'] else ''}")
        del q, k, v, wt, res
    out_timing["unfused_ms"] = sum(rec["unfused_ms"] for rec in out_timing["by_spec"])
    row10 = [rec for rec in out_timing["by_spec"] if tuple(rec["spec"]) in sd_sites[:2]]
    out_timing["row10_sites"] = {key: sum(rec[key] for rec in row10) for key in
                                 ("ms", "unfused_ms", "library_ms", "plain_ms", "bound_ms")}
    log(f"attention_out_fused on {smi}: {out_timing['ms']:.3f} ms vs the unfused composition "
        f"{out_timing['unfused_ms']:.3f} ms over {len(out_sites)} sites; at row 10's two "
        f"SD-2.1 sites {out_timing['row10_sites']['ms']:.3f} ms vs "
        f"{out_timing['row10_sites']['unfused_ms']:.3f} ms")

    # each kernel's times and launches ("launches") on the newest path that
    # runs it ("none": no path launches it), every path's times, and its
    # launches on every path
    paths = {"a": launches_a, "b": launches_b, "c": launches_c, "d": launches_d,
             "e": launches_e, "sd1": launches_s1, "f": launches_f, "g": launches_g,
             "h": launches_h, "h_ddpm": launches_hd, "i": launches_i, "i_remat": launches_ir,
             "i_cin256": launches_ic, **surface["launches"], **fse["launches"],
             "q": path_q["launches"], **path_r["launches"], "s": path_s["launches"]}
    routes = {"a": routes_a, "b": routes_b, "c": routes_c, "d": routes_d, "e": routes_e,
              "sd1": routes_s1, "f": routes_f, "g": routes_g, "h": routes_h,
              "i": routes_i, "i_cin256": routes_ic, **surface["routes"], **fse["routes"],
              "q": path_q["routes"], **path_r["routes"]}

    # the head dims each attention kernel takes, by dtype
    head_dims = {name: {"float32": list(dims), "bfloat16": list(dims)}
                 for name, dims in (("token_attention", FWD_HEAD_DIMS),
                                    ("attention_lse", FWD_HEAD_DIMS),
                                    ("attention_dq", FWD_HEAD_DIMS),
                                    ("attention_dkv", FWD_HEAD_DIMS),
                                    ("attention_out_fused", HEAD_DIMS))}
    ptxas_of = {"attention_dq": {k: v for k, v in bwd_ptxas.items() if "attn_dq" in k
                                 or "attn_bwd_f32" in k and k.endswith("dq")},
                "attention_dkv": {k: v for k, v in bwd_ptxas.items() if "attn_dkv" in k
                                  or "attn_bwd_f32" in k and k.endswith("dkv")},
                "conv3x3": {**{k: v for k, v in f32_ptxas.items()
                               if k.startswith("conv3x3_f32") and not k.endswith(" dx")},
                            **narrow_ptxas},
                "conv3x3_dx": {k: v for k, v in f32_ptxas.items() if k.endswith(" dx")},
                "attention_lse": {k: v for k, v in f32_ptxas.items()
                                  if k.startswith("attention_fwd_f32")},
                "token_attention": {**fwd_ptxas, **{k: v for k, v in f32_ptxas.items()
                                                    if k.startswith("attention_fwd_f32")}},
                "ln_linear": ln_ptxas,
                "attention_out_fused": out_ptxas}

    def newest(name):  # the newest path that timed the kernel ("none": no path runs it;
        # SD-1's forward only where no path does)
        # (nor a sub-record: "B narrow", "G narrow", "F by spec")
        timed = list(timing[name])
        return ([p for p in timed if p != "SD-1" and " " not in p] or timed)[-1]

    kernels = [dict(name=name, route=route, source=src, replaces=rep,
                    **{f"launches_path_{p}": counts[name] for p, counts in paths.items()},
                    **({f"routes_path_{p}": r[name] for p, r in routes.items()}
                       if name in routes["a"] else {}),
                    max_abs_err=max_abs[name], **timing[name][newest(name)],
                    path=newest(name), timing_by_path=timing[name],
                    **({"head_dims": head_dims[name]} if name in head_dims else {}),
                    **({"by_head_dim": bwd_by_dh} if name in ("attention_dq", "attention_dkv")
                       else {}),
                    **({"ptxas": {k: dict(registers=r, spilled_bytes=b)
                                  for k, (r, b) in ptxas_of[name].items()}}
                       if name in ptxas_of else {}))
               for name, (route, src, rep) in REPLACES.items()]
    log(json.dumps({"walls": walls_by_path, "walls_j_to_n_s": surface["walls"], "card": smi}))
    log(json.dumps({"training": train_walls, "card": smi, "card_vs_cpu": dict(
        h_check, i=i_check), "resume": {"h": h_resume, "i_small": i_resume}}))
    log(json.dumps({"first_stage_and_eval": {"walls": fse["walls"], "checks": fse["checks"]},
                    "card": smi}))
    log(json.dumps({"data_path_q": {"walls": path_q["walls"], "rates": path_q["rates"],
                                    "checks": path_q["checks"]}, "card": smi,
                    "nproc": path_q["nproc"]}))
    log(json.dumps({"cli_path_r": {"walls": path_r["walls"], "checks": path_r["checks"],
                                   "int8": path_r["int8"]}, "card": smi}))
    log(json.dumps({"parallel_path_s": {"walls": path_s["walls"], "ranks": path_s["ranks"],
                                        "allreduce_share": path_s["allreduce_share"]},
                    "card": smi}))
    log(f"whole run: {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
