"""latency_p50_s.interactive: the median latency of the window's requests
outside the traced segment. None where the run has nothing to read."""


def read(r):
    return r.latency_quantile(0.5)
