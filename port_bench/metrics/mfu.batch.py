"""mfu.batch: % of the bf16 peak that the FLOPs of the requests outside the
traced segment, counted from the configuration's shapes, reach over their
time. None where the run has nothing to read."""


def read(r):
    return r.mfu()
