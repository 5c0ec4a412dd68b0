"""The check that nothing in the process loaded JAX or the JAX package."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "openfhe_tpu"})


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (the part before the first dot)
    is one of FORBIDDEN, compared whole: `openfhe_tpu_torch` passes."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)
