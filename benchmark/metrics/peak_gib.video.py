"""The program's peak of allocated device memory, in GiB: the largest
``torch.cuda.max_memory_allocated()`` from the process's start to the
window's end. The programs' first (eager) calls during set-up set it: a
replay allocates inside the graph's pool, which the window's own reading
would not count."""


def read(r):
    return r.run.peak_bytes / 2**30
