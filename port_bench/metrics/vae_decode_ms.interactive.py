"""vae_decode_ms.interactive: the first stage's device time a request (CUDA
events around decode_first_stage). None where the run has nothing to read."""


def read(r):
    return r.span_mean_ms("vae_decode")
