"""Process start to the first timed request: imports, the kernels'
build or load, the inputs, keys and tables, the warm-up (host clock)."""


def read(run):
    return run["setup_s"]
