"""trajectory_ms.interactive: the executor's device time a request (CUDA events
around the sampler call). None where the run has nothing to read."""


def read(r):
    return r.span_mean_ms("trajectory")
