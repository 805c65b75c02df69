"""The benchmark's own tests (``python -m pytest benchmark/tests``): CPU
tests of the harness, the references, the bounds and the check; the tests
marked ``cuda`` run a cell on the card and skip themselves without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips itself when "
        "torch.cuda.is_available() is false")
