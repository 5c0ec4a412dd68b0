"""Device operations in the traced stretch over its requests, the port's
`csrc/` kernels and plain torch alike (torch.profiler)."""


def read(run):
    t = run["trace"]
    return t["ops"] / t["requests"] if t and t["requests"] else None
