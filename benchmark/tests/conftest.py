"""The benchmark's tests: `python -m pytest benchmark/tests -q` from the
repository's root. They run on the CPU at small sizes; the tests marked
`card` need a CUDA card and skip without one (decided inside each test)."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for path in (str(HERE), str(HERE.parent), str(HERE.parent.parent)):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")
