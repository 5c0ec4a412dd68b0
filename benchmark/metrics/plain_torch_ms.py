"""Device time a request in operations that are not the port's `csrc/`
kernels (torch.profiler; kernel names from the program's sources)."""


def read(run):
    t = run["trace"]
    return t["plain_s"] / t["requests"] * 1e3 if t and t["requests"] else None
