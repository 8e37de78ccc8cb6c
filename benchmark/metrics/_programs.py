"""Device ms of a video chunk's programs, from the traced stretch: every
chunk launches two CUDA graphs, the trunk's and then the post-trunk
stage's; a kernel belongs to the graph launch it is correlated with."""


def per_chunk(r, which: int):
    """Summed device ms a chunk of the kernels of the chunks' graph
    launch `which` (0 trunk, 1 post-trunk); None without a trace or
    where the launches are not in pairs."""
    tr = r.trace
    if tr is None:
        return None
    launches = tr.graph_kernels()
    if not launches or len(launches) % 2 or not any(k for _, k in launches):
        return None
    mine = launches[which::2]
    total_us = sum(e - s for _, ks in mine for _, s, e in ks)
    return total_us / 1e3 / len(mine) if total_us else None
