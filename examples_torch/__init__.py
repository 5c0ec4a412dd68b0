"""Examples of the PyTorch port (`openfhe_tpu_torch`), counterparts of
`examples/`, one file each. Each has a `main(device=None, ...)` that runs
on the GPU unless asked for the CPU, with the JAX example's parameters
(ring, depth, scales, parameter set, seed) as the defaults of its keyword
arguments, and a `--device` flag:

    python examples_torch/simple_integers.py              # on the card
    python examples_torch/simple_integers.py --device cpu # plain PyTorch

`chip_smoke.py` phase 13 runs every one of them on the card, at its own
parameters and a few of them at full width as well.

The examples after the first five return `{"checks": {label: (got, want,
tol)}, ...}`: each decryption beside what it should be, held exactly
where `tol` is None and within `tol` (max |got - want|) otherwise;
`failed` lists the labels that do not hold.
"""

import numpy as np


def exact(got, want) -> tuple:
    return np.asarray(got), np.asarray(want), None


def close(got, want, tol: float) -> tuple:
    return np.asarray(got), np.asarray(want), float(tol)


def holds(got, want, tol) -> bool:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return False
    if tol is None:
        return bool(np.array_equal(got, want))
    return bool(np.abs(got - want).max() < tol)


def failed(out: dict) -> list:
    """The labels of `out["checks"]` that do not hold."""
    return [label for label, (got, want, tol) in out["checks"].items()
            if not holds(got, want, tol)]


def max_err(out: dict) -> float:
    """The largest |got - want| over the checks with a tolerance."""
    errs = [float(np.abs(np.asarray(g) - np.asarray(w)).max())
            for g, w, tol in out["checks"].values() if tol is not None]
    return max(errs, default=0.0)


def one(x) -> int:
    """A decryption of one LWE ciphertext as an int."""
    return int(np.asarray(x).reshape(-1)[0])


def bits(x) -> list:
    """A decryption of a batch of LWE ciphertexts as a list of ints."""
    return [int(v) for v in np.asarray(x).reshape(-1)]
