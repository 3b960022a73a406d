"""Wall-clock timer: port of ``upflow_pytorch_tpu/utils/timer.py``, the
mirror of the reference's ``tools.time_clock`` (``utils/tools.py:327-348``).
It reads the host's clock only: a caller timing work on the card
synchronises first."""

from __future__ import annotations

import time


class TimeClock:
    def __init__(self):
        self.st = 0.0
        self.en = 0.0
        self.start_flag = False

    def start(self):
        self.start_flag = True
        self.st = time.time()

    def reset(self):
        self.start_flag = True
        self.st = time.time()

    def end(self):
        self.en = time.time()

    def get_during(self) -> float:
        return self.en - self.st
