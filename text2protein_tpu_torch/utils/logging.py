"""Scalars, wall-clock spans and profiler traces (counterpart of
text2protein_tpu/utils/logging.py).

`MetricsWriter` appends every scalar to `{logdir}/metrics.jsonl` and, when
`tensorboardX` imports, to TensorBoard event files beside it
(`logging.py:18-42`); `Timer` sums named wall-clock spans (`:60-73`);
`profile_trace` records a `torch.profiler` trace of its block, the
counterpart of the JAX package's `jax.profiler` trace (`:45-57`).
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path


class MetricsWriter:
    def __init__(self, logdir):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.logdir / "metrics.jsonl", "a")
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            self._tb = None
        else:
            self._tb = SummaryWriter(str(self.logdir))

    def scalar(self, tag: str, value: float, step: int):
        self._jsonl.write(json.dumps({
            "tag": tag, "value": float(value), "step": int(step),
            "time": time.time()}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


@contextlib.contextmanager
def profile_trace(logdir, enabled: bool = True):
    """A `torch.profiler` trace of the block (the host, and the GPU when
    there is one), written as a Chrome trace to `{logdir}/trace.json`;
    yields the profiler (None when not enabled)."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(logdir / "trace.json"))


class Timer:
    """Wall-clock time summed per named span."""

    def __init__(self):
        self.spans = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name] = (self.spans.get(name, 0.0)
                                + time.perf_counter() - t0)
