"""Gates completed in the window over its length (host clock): a
request's gates count when the request is seen complete."""


def read(run):
    return run["units"] / run["seconds"]
