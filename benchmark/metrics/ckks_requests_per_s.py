"""CKKS requests completed in the window over its length (host clock)."""


def read(run):
    return run["units"] / run["seconds"]
