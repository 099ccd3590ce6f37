"""glog-style logging + windowed metric meters (copy of
``emernerf_tpu/utils/logging.py``; the logger is named ``emernerf_torch``).

A console/file logger in glog format, ``SmoothedValue`` windowed meters, and
``MetricLogger`` with a ``log_every`` generator printing iteration and
dispatch times and the ETA, and writing JSON-lines metric records.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import sys
import time
from collections import defaultdict, deque
from typing import Optional


class _GlogFormatter(logging.Formatter):
    LEVEL_MAP = {
        logging.FATAL: "F", logging.ERROR: "E", logging.WARNING: "W",
        logging.INFO: "I", logging.DEBUG: "D",
    }

    def format(self, record):
        level = self.LEVEL_MAP.get(record.levelno, "?")
        t = datetime.datetime.fromtimestamp(record.created)
        prefix = (
            f"{level}{t:%Y%m%d %H:%M:%S} {record.process} "
            f"{record.filename}:{record.lineno}]"
        )
        return f"{prefix} {record.getMessage()}"


def setup_logging(output: Optional[str] = None, name: str = "emernerf_torch",
                  level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False
    if logger.handlers:
        return logger
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(_GlogFormatter())
    logger.addHandler(sh)
    if output:
        path = output if output.endswith((".txt", ".log")) else os.path.join(
            output, "log.txt"
        )
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fh = logging.FileHandler(path)
        fh.setFormatter(_GlogFormatter())
        logger.addHandler(fh)
    return logger


class SmoothedValue:
    """Track a window of values + global average (utils/logging.py:150-211)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, num: int = 1):
        self.deque.append(value)
        self.count += num
        self.total += value * num

    @property
    def median(self):
        if not self.deque:
            return 0.0
        s = sorted(self.deque)
        return s[len(s) // 2]

    @property
    def avg(self):
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value,
        )


class MetricLogger:
    """Meter collection + ETA-printing iteration wrapper
    (utils/logging.py:24-147)."""

    def __init__(self, delimiter: str = "  ", output_file: Optional[str] = None):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.output_file = output_file
        self.logger = logging.getLogger("emernerf_torch")

    def update(self, **kwargs):
        for k, v in kwargs.items():
            if v is None:
                continue
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def dump_in_output_file(self, iteration, iter_time, dispatch_time=None):
        if self.output_file is None:
            return
        record = dict(iteration=iteration, iter_time=iter_time)
        if dispatch_time is not None:
            record["dispatch_time"] = dispatch_time
        record.update({k: v.median for k, v in self.meters.items()})
        with open(self.output_file, "a") as f:
            f.write(json.dumps(record) + "\n")

    def log_every(self, iterable, print_freq: int, header: str = ""):
        """Iterate + print progress.  Under JAX async dispatch a per-loop
        timer lies: 19 dispatches at ~0.04 s + one blocking fetch absorbing
        the queued device work averages to nonsense (round-4 flagship log
        printed `time: 7.55` at a true 0.76 s/step).  The printed/dumped
        ``time:`` is therefore WALL CLOCK since the previous print divided
        by the steps in between — the only honest per-step time an async
        client can report — while the per-loop measure is kept as
        ``disp:``/``dispatch_time`` (host-side dispatch + fetch cost)."""
        start_time = time.time()
        end = time.time()
        dispatch_time = SmoothedValue(fmt="{avg:.4f}")
        n = len(iterable)
        last_print_t = start_time
        last_print_i = -1

        for i, obj in enumerate(iterable):
            yield obj
            dispatch_time.update(time.time() - end)
            if i % print_freq == 0 or i == n - 1:
                now = time.time()
                wall_step = (now - last_print_t) / max(i - last_print_i, 1)
                last_print_t, last_print_i = now, i
                self.dump_in_output_file(
                    iteration=i, iter_time=wall_step,
                    dispatch_time=dispatch_time.avg,
                )
                # ETA from the global wall average (honest under async)
                eta_seconds = (now - start_time) / (i + 1) * (n - i)
                eta = str(datetime.timedelta(seconds=int(eta_seconds)))
                meters = self.delimiter.join(
                    f"{name}: {meter}" for name, meter in self.meters.items()
                )
                self.logger.info(
                    self.delimiter.join(
                        [
                            header, f"[{i}/{n}]", f"eta: {eta}", meters,
                            f"time: {wall_step:.4f}",
                            f"disp: {dispatch_time}",
                        ]
                    ).strip()
                )
            end = time.time()

        total = time.time() - start_time
        self.logger.info(
            f"{header} Total time: {datetime.timedelta(seconds=int(total))} "
            f"({total / max(n, 1):.4f} s / it)"
        )
