"""GiB of device memory the window's peak allocation held
(torch.cuda.max_memory_allocated after a reset at the window's start)."""


def read(r):
    return r.peak_bytes / 2 ** 30 if not r.trace and r.peak_bytes else None
