"""Set-up phases on the host clock, written to standard error as they end
(``setup <phase> <seconds since the process started>``), so that a slow
set-up shows where it goes."""

from __future__ import annotations

import sys
import time


class Phases:
    def __init__(self, t0: float):
        self.t0 = t0

    def __call__(self, name: str) -> None:
        print(f"setup {name} {time.perf_counter() - self.t0:.3f}",
              file=sys.stderr, flush=True)
