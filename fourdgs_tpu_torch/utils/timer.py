"""Phase timers + JSON timing reports.

A copy of ``fourdgs_tpu/utils/timer.py``. Parity target: the reference's
profiling subsystem (utils/timer.py:6-338):
``Timer`` — a pausable wall clock excluded around I/O; ``DetailedTimer`` —
named per-phase timers wrapped around every part of each iteration, with
accumulated totals, per-iteration breakdowns, periodic training logs, and
``timing_report.json`` / ``training_logs.json`` outputs including percentage
accounting and unaccounted time (timer.py:193-264). The JSON schema is kept
compatible so the reference's visualize_timing.py-style tooling (reimplemented
in scripts/visualize_timing.py) works unchanged.

Phases here measure host-side wall clock around work queued on the card;
CUDA launches return before the work is done, so per-phase attribution is
meaningful only around explicit host syncs (the loop's log and gate points).
For device time use ``fourdgs_tpu_torch.scripts.time_ms`` or the profilers
(``profile_train_torch.py``).
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict


class Timer:
    """Pausable wall clock (reference utils/timer.py:6-28)."""

    def __init__(self):
        self._start = None
        self._elapsed = 0.0
        self._paused = True

    def start(self):
        if self._paused:
            self._start = time.time()
            self._paused = False

    def pause(self):
        if not self._paused:
            self._elapsed += time.time() - self._start
            self._paused = True

    def get_elapsed_time(self) -> float:
        if self._paused:
            return self._elapsed
        return self._elapsed + (time.time() - self._start)


class DetailedTimer:
    """Named phase timers with JSON reporting (reference utils/timer.py:30-338)."""

    def __init__(self, model_path: str | None = None):
        self.model_path = model_path
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._open: dict[str, float] = {}
        self.iteration_timings: list[dict] = []
        self.training_logs: list[dict] = []
        self._iter_start: float | None = None
        self._current_iter: int | None = None
        self._iter_phases: dict[str, float] = {}
        self.t0 = time.time()

    # -- per-phase -----------------------------------------------------------
    def start_timer(self, name: str):
        self._open[name] = time.time()

    def end_timer(self, name: str):
        t0 = self._open.pop(name, None)
        if t0 is None:
            return
        dt = time.time() - t0
        self.totals[name] += dt
        self.counts[name] += 1
        self._iter_phases[name] = self._iter_phases.get(name, 0.0) + dt

    # -- per-iteration -------------------------------------------------------
    def start_iteration(self, iteration: int):
        self._current_iter = iteration
        self._iter_start = time.time()
        self._iter_phases = {}

    def end_iteration(self, iteration: int, stage: str):
        if self._iter_start is None:
            return
        total = time.time() - self._iter_start
        accounted = sum(self._iter_phases.values())
        self.iteration_timings.append(
            {
                "iteration": iteration,
                "stage": stage,
                "total_time": total,
                "phases": dict(self._iter_phases),
                "unaccounted_time": max(total - accounted, 0.0),
            }
        )
        self._iter_start = None

    # alias matching the reference's record_iteration_timing call site
    record_iteration_timing = end_iteration

    def log_iteration(self, iteration: int, loss: float, psnr: float,
                      l1_loss: float, stage: str, total_points: int,
                      ema_loss: float = 0.0, ema_psnr: float = 0.0):
        self.training_logs.append(
            {
                "iteration": iteration,
                "stage": stage,
                "loss": loss,
                "l1_loss": l1_loss,
                "psnr": psnr,
                "ema_loss": ema_loss,
                "ema_psnr": ema_psnr,
                "total_points": total_points,
                "elapsed": time.time() - self.t0,
            }
        )

    # -- reports -------------------------------------------------------------
    def summary(self) -> dict:
        wall = time.time() - self.t0
        accounted = sum(self.totals.values())
        ops = {
            name: {
                "total_time": t,
                "count": self.counts[name],
                "avg_time": t / max(self.counts[name], 1),
                "percentage": 100.0 * t / wall if wall > 0 else 0.0,
            }
            for name, t in sorted(self.totals.items())
        }
        return {
            "total_wall_time": wall,
            "accounted_time": accounted,
            "unaccounted_time": max(wall - accounted, 0.0),
            "operations": ops,
        }

    def save_timing_report(self, path: str | None = None):
        path = path or os.path.join(self.model_path or ".", "timing_report.json")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(
                {"summary": self.summary(),
                 "iterations": self.iteration_timings},
                f, indent=1,
            )
        return path

    def save_training_logs(self, path: str | None = None):
        path = path or os.path.join(self.model_path or ".", "training_logs.json")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.training_logs, f, indent=1)
        return path

    def print_summary(self):
        s = self.summary()
        print(f"total wall time: {s['total_wall_time']:.2f}s "
              f"(unaccounted {s['unaccounted_time']:.2f}s)")
        for name, op in s["operations"].items():
            print(f"  {name:32s} {op['total_time']:9.3f}s "
                  f"x{op['count']:6d}  {op['percentage']:5.1f}%")
