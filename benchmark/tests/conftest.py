"""The benchmark's tests: run with `python -m pytest benchmark/tests -q`
from the repository root.  Tests that need the card carry the `cuda`
marker and skip inside the test without one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; skips when torch.cuda.is_available() is False",
    )
