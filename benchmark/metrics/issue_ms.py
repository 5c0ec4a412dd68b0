"""Host time to enqueue one request: the harness's span around its calls
into the program's API, mean over the window's untraced requests
(`issue_ms.ckks`, `issue_ms.binfhe`)."""


def read(run):
    spans = run["issue_s"]
    return sum(spans) / len(spans) * 1e3 if spans else None
