"""Profiling and tracing helpers.

Port of ``inference_tpu.utils.profiling``: ``device_trace`` records a
``torch.profiler`` trace (the CPU's operations, and the card's kernels and
copies when a CUDA device is present) into a Chrome/Perfetto trace file,
and ``PhaseTimer`` accumulates wall-clock time per named phase, waiting at
each phase's end for the work queued on every visible CUDA device.
"""

import os
import time
from collections import defaultdict
from contextlib import contextmanager

import torch


@contextmanager
def device_trace(log_dir: str):
    """
    Capture a ``torch.profiler`` trace (operations, kernels, copies) of
    everything executed inside the block::

        with device_trace("/tmp/trace"):
            chain.advance(10_000)

    The trace is written to ``log_dir/trace_<pid>_<ns>.json`` when the
    block ends, also when it raises; view it in ui.perfetto.dev or
    chrome://tracing.
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class PhaseTimer:
    """
    Accumulates wall-clock time per named phase. Waits for every visible
    CUDA device at phase exit, so times reflect the work queued in the
    phase and not only its launches.
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            # every device, not only the current one: work queued on
            # another mesh device must not leak into a later phase
            if torch.cuda.is_available():
                for d in range(torch.cuda.device_count()):
                    torch.cuda.synchronize(d)
            self.totals[name] += time.perf_counter() - start
            self.counts[name] += 1

    def summary(self) -> str:
        lines = ["[ PhaseTimer summary ]"]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"  {name:>24}: {total:8.3f}s total, {n:5d} calls, "
                f"{1e3 * total / n:8.2f} ms/call"
            )
        return "\n".join(lines)
