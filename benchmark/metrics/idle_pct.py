"""The share of the traced stretch in which no operation runs on the
device (torch.profiler: the union of device operations)."""


def read(run):
    t = run["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
