"""peak_mem_gib.interactive: the run's device memory peak
(torch.cuda.max_memory_allocated), GiB. None where the run has nothing to
read."""


def read(r):
    return r.peak_mem_gib()
