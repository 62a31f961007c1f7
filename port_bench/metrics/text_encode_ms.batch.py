"""text_encode_ms.batch: the conditioner's host time a request (both
get_learned_conditioning calls, after synchronize). None where the run has
nothing to read."""


def read(r):
    return r.span_mean_ms("text_encode")
