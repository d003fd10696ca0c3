"""Background resource monitor: samples RSS + CPU while a phase runs.

Reference: joltworks/src/utils/monitor.rs (MetricsMonitor, a sysinfo-based
background sampler). This version reads /proc/self (no dependencies).
"""

from __future__ import annotations

import threading
import time


def _read_proc() -> tuple[int, float]:
    rss_kb = 0
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    rss_kb = int(line.split()[1])
                    break
    except OSError:
        pass
    try:
        with open("/proc/self/stat") as f:
            parts = f.read().split()
        cpu_ticks = int(parts[13]) + int(parts[14])  # utime + stime
    except (OSError, IndexError, ValueError):
        cpu_ticks = 0
    return rss_kb, cpu_ticks


class MetricsMonitor:
    """with MetricsMonitor(interval=0.2) as m: ... ; print(m.report())"""

    def __init__(self, interval: float = 0.25):
        self.interval = interval
        self.samples: list[tuple[float, int]] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._t0 = 0.0
        self._cpu0 = 0

    def __enter__(self) -> "MetricsMonitor":
        self._t0 = time.time()
        _, self._cpu0 = _read_proc()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            rss, _ = _read_proc()
            self.samples.append((time.time() - self._t0, rss))

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        rss, cpu1 = _read_proc()
        self.samples.append((time.time() - self._t0, rss))
        self._cpu_ticks = cpu1 - self._cpu0
        self._wall = time.time() - self._t0

    def peak_rss_mb(self) -> float:
        return max((r for _, r in self.samples), default=0) / 1024

    def report(self) -> str:
        import os
        hz = os.sysconf("SC_CLK_TCK")
        cpu_s = self._cpu_ticks / hz if hz else 0.0
        util = cpu_s / self._wall if self._wall else 0.0
        return (f"wall {self._wall:.2f}s  cpu {cpu_s:.2f}s "
                f"({util:.1f}x cores)  peak RSS {self.peak_rss_mb():.0f} MB "
                f"({len(self.samples)} samples)")
