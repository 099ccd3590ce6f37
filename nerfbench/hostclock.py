"""What the host did during a window, for standard error: the launching
thread's CPU seconds against the wall's, its involuntary context switches,
the machine's stolen time, and the rate in each quarter of the window.
None of it is a metric; it says where a run's host time went."""

from __future__ import annotations

import resource
import time
from typing import List, Optional


def _steal_jiffies() -> Optional[int]:
    """The machine's stolen CPU time (``/proc/stat``), or None."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8])
    except (OSError, IndexError, ValueError):
        return None


class HostClock:
    """Inside ``with``: call ``tick()`` at the end of each unit (an
    iteration, a frame); ``report()`` afterwards."""

    def __enter__(self):
        self.ends: List[float] = []
        self._steal = _steal_jiffies()
        self._ru = resource.getrusage(resource.RUSAGE_THREAD)
        self._thread, self._proc = time.thread_time(), time.process_time()
        self.t0 = time.perf_counter()
        return self

    def tick(self) -> None:
        self.ends.append(time.perf_counter())

    def __exit__(self, *exc):
        self.wall = time.perf_counter() - self.t0
        self.thread_s = time.thread_time() - self._thread
        self.proc_s = time.process_time() - self._proc
        ru = resource.getrusage(resource.RUSAGE_THREAD)
        self.invol = ru.ru_nivcsw - self._ru.ru_nivcsw
        steal = _steal_jiffies()
        self.steal = None if steal is None or self._steal is None else steal - self._steal
        return False

    def report(self) -> str:
        q = []
        n = len(self.ends)
        for k in range(4):
            a, b = self.t0 + k * self.wall / 4, self.t0 + (k + 1) * self.wall / 4
            q.append(sum(a <= e < b for e in self.ends) / (self.wall / 4))
        return (f"host: {n} units in {self.wall:.3f} s; launching thread CPU {self.thread_s:.3f} s "
                f"({100 * self.thread_s / self.wall:.1f}% of the wall), process CPU "
                f"{self.proc_s:.3f} s, involuntary switches {self.invol}, stolen jiffies "
                f"{self.steal}, units/s by quarter {[round(v, 3) for v in q]}")
