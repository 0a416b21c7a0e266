"""Wall-time averages and ETAs for long loops (counterpart of
``visualdet3d_tpu/utils/timer.py``'s ``Timer`` and ``formatting_time``).
They read the host clock: a caller timing device work synchronises
first."""
from __future__ import annotations

import time


def formatting_time(seconds: float) -> str:
    """Seconds -> 'Hh Mm Ss'."""
    seconds = max(0.0, float(seconds))
    hours = int(seconds // 3600)
    minutes = int((seconds % 3600) // 60)
    secs = seconds % 60
    if hours > 0:
        return f'{hours}h {minutes}m {secs:.0f}s'
    if minutes > 0:
        return f'{minutes}m {secs:.1f}s'
    return f'{secs:.2f}s'


class Timer:
    """Average time per tick and the ETA of a loop."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.start_time = time.time()
        self.last_time = self.start_time
        self.count = 0
        self.total = 0.0

    def tick(self) -> float:
        now = time.time()
        dt = now - self.last_time
        self.last_time = now
        self.count += 1
        self.total += dt
        return dt

    @property
    def avg(self) -> float:
        return self.total / max(self.count, 1)

    def compute_eta(self, current_step: int, total_steps: int) -> str:
        remaining = max(total_steps - current_step, 0)
        if self.count == 0:
            return formatting_time(remaining * self.elapsed() / max(current_step, 1))
        return formatting_time(remaining * self.avg)

    def elapsed(self) -> float:
        return time.time() - self.start_time
