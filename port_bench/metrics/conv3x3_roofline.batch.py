"""conv3x3_roofline.batch: % of the least time the traced requests' conv3x3
launches need at the peaks, over their device time. None where the run has
nothing to read."""


def read(r):
    return r.roofline("conv3x3")
