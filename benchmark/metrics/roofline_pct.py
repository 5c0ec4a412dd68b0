"""The least time the card could take for the traced requests (their
bytes at the HBM bandwidth or their 32-bit operations at the integer
rate, whichever is larger, from `harness/work.py`'s frozen counts) over
the device's busy time in the traced stretch."""


def read(run):
    t = run["trace"]
    if not t or not t["requests"] or t["busy_s"] <= 0:
        return None
    return 100.0 * t["least_s"] / t["busy_s"]
