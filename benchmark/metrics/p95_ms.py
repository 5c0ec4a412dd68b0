"""The 95th percentile of the latency of every request completed in the
window, from its issue to its event seen complete (host clock):
`p95_ms.ckks`, `p95_ms.binfhe`."""

import numpy as np


def read(run):
    lat = run["latencies_s"]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
