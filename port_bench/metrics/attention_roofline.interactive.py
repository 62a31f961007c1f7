"""attention_roofline.interactive: % of the least time the traced requests'
attention launches need at the peaks, over their device time. None where the
run has nothing to read."""


def read(r):
    return r.roofline("token_attention")
