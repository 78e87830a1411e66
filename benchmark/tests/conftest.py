"""The benchmark's CPU tests (``python -m pytest benchmark/tests``).  A
test that needs the card is marked ``cuda`` and skips, deciding inside
the test, without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one (run "
        "`python -m pytest -m cuda benchmark/tests` on the card)")
