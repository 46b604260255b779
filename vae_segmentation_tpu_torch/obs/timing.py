"""Step timing and the profiler trace (counterpart of vae_segmentation_tpu/
obs/timing.py).

``StepTimer`` is the rate meter of the trainers' ``steps_per_sec``.
``profile_trace(logdir)`` records the run with ``torch.profiler`` (host
ops, and the card's kernels when CUDA is there) and writes it as a Chrome
trace into ``logdir``; it takes the place of the JAX package's
``jax.profiler.trace`` (--profile_dir). Every op of the run is kept in
memory until the end, so profile a short run (a small --max_epoch)."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional


class StepTimer:
    def __init__(self):
        self.reset()

    def reset(self):
        self.t0 = time.perf_counter()
        self.count = 0

    def tick(self, n: int = 1):
        self.count += n

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    @property
    def rate(self) -> float:
        e = self.elapsed
        return self.count / e if e > 0 else 0.0


def trace_path(logdir: str) -> str:
    """The trace file of this process: ``trace.json``, or
    ``trace_rank<r>.json`` for a rank of a torchrun world."""
    rank = os.environ.get("RANK")
    one = rank is None or int(os.environ.get("WORLD_SIZE", "1")) == 1
    name = "trace.json" if one else f"trace_rank{rank}.json"
    return os.path.join(logdir, name)


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """A torch.profiler trace of the block written to ``trace_path(logdir)``
    when a logdir is given, nothing otherwise."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(trace_path(logdir))
