"""The port's scripts: host tools and the cost experiments.

The host tools are the counterparts of the JAX package's preprocessing and
analysis scripts of the same names under ``scripts/``, with their
arguments: ``blender2colmap``, ``colmap_converter``, ``hypernerf2colmap``,
``llff2colmap``, ``llff_poses_from_colmap``, ``prepare_multipleview``,
``downsample_point``, ``database``, ``read_all_metrics``,
``analyze_gradients``, ``plot_events``, ``visualize_timing`` and
``render_oracle_gt`` (the oracle GT frames of ``bench_quality_torch.py``,
rendered on ``--device`` by the port's ``reference`` rasterizer):

    python -m fourdgs_tpu_torch.scripts.<name> ...

The plotting scripts need matplotlib, which they import where they plot
(:func:`pyplot`); without it they exit with an error that says so.

The cost experiments are the counterparts of ``scripts/exp_gather.py``,
``scripts/exp_grid_cost.py`` and ``scripts/exp_kernel_overhead.py``:

    python -m fourdgs_tpu_torch.scripts.exp_gather
    python -m fourdgs_tpu_torch.scripts.exp_grid_cost
    python -m fourdgs_tpu_torch.scripts.exp_kernel_overhead

Each module has ``run(device="cuda", **sizes) -> dict`` (the JAX script's
sizes by default; raises without CUDA unless ``device="cpu"``) and ``main()``,
which prints the JAX script's lines and then the result as one JSON line.
Their data come from the seed :data:`SEED`, as the JAX scripts' from 0.

:func:`time_ms` is the one timer of the port's measurements: the
experiments, the kernels line of ``chip_smoke.py`` and the profilers;
:func:`card` names the card every measurement is written beside.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from fourdgs_tpu_torch import resolve_device

SEED = 0
ITERS = 20    # calls per timed batch
REPS = 5      # timed batches; the median is reported
WARMUP = 2    # untimed calls first
# bounds on the cycles of the sleep kernel queued before a timed batch
# (10 ms and 2 s at 2 GHz)
_SLEEP_CYCLES = (20_000_000, 4_000_000_000)
_CYCLES_PER_S = 2e9   # at most the H100's boost clock (1.98 GHz)


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, dev: torch.device, iters: int | None = None,
            reps: int | None = None) -> tuple[float, float]:
    """(device ms, wall ms) per call of ``fn()``, each the median over
    ``reps`` batches of ``iters`` calls (:data:`REPS`, :data:`ITERS` when
    not given) after :data:`WARMUP` single calls.

    Device ms: CUDA events around a batch queued behind a sleep kernel that
    lasts three times what a batch took the host in the warm-up, so the
    card works through the batch without waiting for the host, and a call of
    a few microseconds is timed by the card, not by the host's launch rate.
    A ``fn`` that itself waits for the card leaves it idle inside the batch
    all the same: its device ms then hold host time too.

    Wall ms: the host's clock around a batch without the sleep, ended by a
    synchronize: what a call costs back to back, host and card together.
    On the CPU both numbers are that wall time."""
    iters = ITERS if iters is None else iters
    reps = REPS if reps is None else reps
    cuda = dev.type == "cuda"

    def batch(n: int) -> float:
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        if cuda:
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    per_call = min(batch(1) for _ in range(WARMUP))
    lo, hi = _SLEEP_CYCLES
    cycles = int(min(max(3 * per_call * iters * _CYCLES_PER_S, lo), hi))
    dev_ms, wall_ms = [], []
    for _ in range(reps):
        wall_ms.append(batch(iters) * 1e3 / iters)
        if not cuda:
            dev_ms.append(wall_ms[-1])
            continue
        torch.cuda.synchronize(dev)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        dev_ms.append(a.elapsed_time(b) / iters)
    return statistics.median(dev_ms), statistics.median(wall_ms)


def pyplot(script: str):
    """matplotlib's pyplot on the Agg backend; exits with an error naming
    ``script`` where matplotlib is not installed (no plot is written)."""
    try:
        import matplotlib
    except ImportError as e:
        raise SystemExit(f"{script}: matplotlib is not installed ({e}); "
                         "no plot was written") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def header(dev: torch.device) -> dict:
    """The device a result ran on and the clock that timed it."""
    if dev.type == "cuda":
        return {"device": torch.cuda.get_device_name(dev), "clock": "cuda_events"}
    return {"device": "cpu", "clock": "host"}


def main_with(run, description: str) -> None:
    """``main()`` of an experiment: ``--device`` (default cuda), run, and
    print the result as one JSON line after ``run``'s own lines."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    res = run(device=resolve_device(args.device))
    print(json.dumps(res))
