"""device_idle_share.batch: % of the traced segment in which no operation ran
on the device. None where the run has nothing to read."""


def read(r):
    return r.idle_share()
