"""Statistics streams, timers and the run sheet.

TPU-native replacement for the reference's statistics layer (reference:
src/cml/base/Statistic.h:15 frame-indexed time series with NORMAL/AVERAGE
modes, :97 StatisticTimer, :123 StatisticsSheet CSV writer; the STAT-line
stdout protocol the python harness scrapes, modslam.cpp:174-190,309-324;
utils/Timer.h wall timers).

Host-side: statistics are tiny scalar streams produced by the orchestration
loop (the device math never blocks on them)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class Statistic:
    """Frame-indexed scalar series. mode='normal' records the last value per
    frame; mode='average' averages all values pushed within one frame
    (reference: Statistic.h:55-71)."""

    name: str
    mode: str = "normal"
    xs: list = field(default_factory=list)
    ys: list = field(default_factory=list)
    _acc: float = 0.0
    _n: int = 0
    _frame: int | None = None

    def push(self, frame: int, value: float):
        if self._frame is not None and frame != self._frame:
            self._flush()
        self._frame = frame
        if self.mode == "average":
            self._acc += value
            self._n += 1
        else:
            self._acc = value
            self._n = 1

    def _flush(self):
        if self._frame is not None and self._n:
            self.xs.append(self._frame)
            self.ys.append(self._acc / self._n if self.mode == "average"
                           else self._acc)
        self._acc, self._n = 0.0, 0

    def series(self):
        self._flush()
        self._frame = None
        return list(self.xs), list(self.ys)


class StatisticTimer:
    """Context-manager timer feeding a Statistic in milliseconds
    (reference: Statistic.h:97)."""

    def __init__(self, stat: Statistic):
        self.stat = stat
        self._frame = 0

    def frame(self, i: int) -> "StatisticTimer":
        self._frame = i
        return self

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.stat.push(self._frame, (time.perf_counter() - self._t0) * 1e3)
        return False


class StatsSheet:
    """Named statistic registry + CSV export + STAT-line stream
    (reference: StatisticsSheet Statistic.h:123; STAT protocol
    modslam.cpp:174-190)."""

    def __init__(self, emit_stat_lines: bool = False):
        self._stats: dict[str, Statistic] = {}
        self._timers: dict[str, StatisticTimer] = {}
        self.emit = emit_stat_lines

    def stat(self, name: str, mode: str = "normal") -> Statistic:
        if name not in self._stats:
            self._stats[name] = Statistic(name, mode)
        return self._stats[name]

    def timer(self, name: str) -> StatisticTimer:
        if name not in self._timers:
            self._timers[name] = StatisticTimer(self.stat(name, "average"))
        return self._timers[name]

    def push(self, name: str, frame: int, value: float):
        self.stat(name).push(frame, float(value))
        if self.emit:
            print(f"STAT {name} {frame} {float(value):.6f}")

    def to_csv(self, path: str):
        """One CSV per sheet: frame, <stat columns> (union of frames)."""
        series = {n: dict(zip(*s.series())) for n, s in self._stats.items()}
        frames = sorted({f for d in series.values() for f in d})
        names = sorted(series)
        with open(path, "w") as fh:
            fh.write("frame," + ",".join(names) + "\n")
            for f in frames:
                row = [str(f)]
                for n in names:
                    v = series[n].get(f)
                    row.append("" if v is None else f"{v:.6g}")
                fh.write(",".join(row) + "\n")
