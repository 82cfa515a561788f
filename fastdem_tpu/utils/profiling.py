"""Profiling / benchmark statistics utilities.

Equivalents of the reference's benchmark harness
(/root/reference/fastdem/lib/nanoPCL/benchmarks/common/benchmark_common.hpp:
Stats{mean, stddev, median, CI95} with IQR outlier removal and platform
capture) plus jax.profiler trace capture for device-level inspection
(SURVEY.md sec. 5.1: the equivalent of the reference's timer tables).
"""

from __future__ import annotations

import contextlib
import dataclasses
import platform
import time
from typing import Callable, List, Optional

import numpy as np


@dataclasses.dataclass
class Stats:
    mean: float
    stddev: float
    median: float
    ci95_lo: float
    ci95_hi: float
    n_samples: int
    n_outliers: int

    def __str__(self):
        return (
            f"{self.mean:.3f} ms +/- {self.stddev:.3f} "
            f"(median {self.median:.3f}, CI95 [{self.ci95_lo:.3f}, "
            f"{self.ci95_hi:.3f}], n={self.n_samples}, "
            f"dropped {self.n_outliers} outliers)"
        )


def compute_stats(samples_ms: List[float], iqr_filter: bool = True) -> Stats:
    """IQR-filtered summary statistics (benchmark_common.hpp semantics:
    drop samples outside [Q1 - 1.5 IQR, Q3 + 1.5 IQR], then mean/stddev/
    median and a normal-approximation 95% CI)."""
    x = np.asarray(samples_ms, dtype=np.float64)
    n_out = 0
    if iqr_filter and x.size >= 4:
        q1, q3 = np.percentile(x, [25, 75])
        iqr = q3 - q1
        keep = (x >= q1 - 1.5 * iqr) & (x <= q3 + 1.5 * iqr)
        n_out = int((~keep).sum())
        x = x[keep]
    mean = float(np.mean(x))
    std = float(np.std(x, ddof=1)) if x.size > 1 else 0.0
    half = 1.96 * std / np.sqrt(max(x.size, 1))
    return Stats(
        mean=mean,
        stddev=std,
        median=float(np.median(x)),
        ci95_lo=mean - half,
        ci95_hi=mean + half,
        n_samples=int(x.size),
        n_outliers=n_out,
    )


def benchmark(
    fn: Callable[[], object],
    warmup: int = 2,
    reps: int = 20,
    sync: Optional[Callable[[object], None]] = None,
) -> Stats:
    """Time fn() reps times (ms), with warmup and optional device sync."""
    import jax

    sync = sync or (lambda out: jax.block_until_ready(out))
    for _ in range(warmup):
        sync(fn())
    samples = []
    for _ in range(reps):
        t0 = time.time()
        sync(fn())
        samples.append((time.time() - t0) * 1e3)
    return compute_stats(samples)


def platform_info() -> dict:
    import jax

    return {
        "device": str(jax.devices()[0]),
        "backend": jax.default_backend(),
        "jax": jax.__version__,
        "python": platform.python_version(),
        "machine": platform.machine(),
    }


@contextlib.contextmanager
def trace(log_dir: str = "fastdem_trace"):
    """Capture a jax.profiler trace around a block (view with xprof/
    tensorboard). The replacement for the reference's manual timer
    tables."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
