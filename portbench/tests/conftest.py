"""The benchmark's own CPU tests: ``python -m pytest portbench/tests -q``
from the root of the checkout. Tests marked ``cuda`` run the benchmark on
the card and skip where there is none."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where "
                   "torch.cuda.is_available() is false")
