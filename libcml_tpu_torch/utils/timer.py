"""Wall-clock timers: a copy of libcml_tpu/utils/timer.py (reference:
src/cml/utils/Timer.h — start/stop wall timers with fps accounting;
stopAndPrint scattered on SLAM phases, e.g. direct/Mapping.cpp:66-68)."""

from __future__ import annotations

import time


class Timer:
    """Accumulating wall timer usable as a context manager.

    t = Timer()
    with t: work()
    t.elapsed_ms, t.count, t.mean_ms
    """

    def __init__(self) -> None:
        self.elapsed = 0.0  # seconds, accumulated
        self.count = 0
        self._t0: float | None = None

    def start(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def stop(self) -> float:
        """Stop and return this interval in seconds."""
        if self._t0 is None:
            return 0.0
        dt = time.perf_counter() - self._t0
        self.elapsed += dt
        self.count += 1
        self._t0 = None
        return dt

    def __enter__(self) -> "Timer":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    @property
    def elapsed_ms(self) -> float:
        return self.elapsed * 1e3

    @property
    def mean_ms(self) -> float:
        return self.elapsed * 1e3 / max(self.count, 1)

    @property
    def fps(self) -> float:
        return self.count / max(self.elapsed, 1e-12)
