"""library_share.batch: % of the traced requests' device time in operations
that are not the port's own kernels. None where the run has nothing to read."""


def read(r):
    return r.library_share()
