"""A progress deadline for long device jobs.

The port's copy of ``StallWatchdog`` from ``rau_vqa_tpu/utils/rigcheck.py``
(:291-334); the rest of that module (the rig probes and the bf16 canary) is
still to port (ROADMAP.md, queue 1, item 8, export).
"""

from __future__ import annotations

import os
import sys
import threading


class StallWatchdog:
    """If ``poke()`` is not called within ``timeout_s``, print a diagnosis
    and end the process with exit code 3: a device call that never returns
    blocks inside native code, where no exception can reach it, so a daemon
    timer and ``os._exit`` are the only sure way out.  Re-armed on every unit
    of progress, so a job may run as long as it keeps moving.
    ``timeout_s <= 0`` disables it."""

    def __init__(self, what: str, timeout_s: float = 900.0):
        self.what = what
        self.timeout_s = float(timeout_s)
        self._timer = None
        self.poke()

    def _fire(self):
        sys.stderr.write(f"{self.what}: no progress within {self.timeout_s:.0f}s; "
                         f"the device or the image decode is stuck\n")
        sys.stderr.flush()
        os._exit(3)

    def poke(self) -> None:
        if self.timeout_s <= 0:
            return
        if self._timer is not None:
            self._timer.cancel()
        self._timer = threading.Timer(self.timeout_s, self._fire)
        self._timer.daemon = True
        self._timer.start()

    def cancel(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
