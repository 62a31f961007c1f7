"""The demos of `examples/`, on the port: `python -m dpm_solver_tpu_torch.examples.<name>`
for score_sde_demo, latent_imagenet_demo and diffedit_demo (the card by default,
`--device cpu` for the host)."""
