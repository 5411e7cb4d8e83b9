"""Profiling and tracing helpers.

Port of ``inference_tpu.utils.profiling``: ``device_trace`` records a
``torch.profiler`` trace (the CPU's operations, and the card's kernels and
copies when a CUDA device is present) into a Chrome/Perfetto trace file,
opening its session with work of its own on the current card and waiting
at its end for the work queued on every visible CUDA device; the block is
the ``"device_trace"`` annotation in the file. ``PhaseTimer`` accumulates
wall-clock time per named phase, waiting at each phase's end likewise.
"""

import os
import time
from collections import defaultdict
from contextlib import contextmanager

import torch


# the work a trace opens with before its block, on the current card:
# BUSY_PRODUCTS products of two BUSY_N x BUSY_N float32 matrices, then
# TINY_KERNELS one-element kernels and a synchronisation (43 ms on an H100
# in all), then GAP_S of idle. PERF.md §6: with it every trace kept every
# kernel of the block, 20 of 20 to 5 minutes into a process and late in
# chip_smoke.py's run, where a session started without it lost up to 10
# of 10
BUSY_N, BUSY_PRODUCTS, TINY_KERNELS, GAP_S = 2048, 60, 100, 0.02
BLOCK_MARK = "device_trace"


def _synchronize_all():
    """Wait for the work queued on every visible CUDA device."""
    if torch.cuda.is_available():
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)


def _opening_burst():
    """The work a trace opens with on the current card (``BUSY_PRODUCTS``,
    ``TINY_KERNELS``), then a synchronisation and ``GAP_S`` of idle."""
    a = torch.ones((BUSY_N, BUSY_N), device="cuda")
    b = torch.empty_like(a)
    for _ in range(BUSY_PRODUCTS):
        torch.matmul(a, a, out=b)
    x = torch.zeros(1, device="cuda")
    for _ in range(TINY_KERNELS):
        x.add_(1.0)
    torch.cuda.synchronize()
    del a, b, x
    time.sleep(GAP_S)


@contextmanager
def device_trace(log_dir: str):
    """
    Capture a ``torch.profiler`` trace (operations, kernels, copies) of
    everything executed inside the block::

        with device_trace("/tmp/trace"):
            chain.advance(10_000)

    The trace is written to ``log_dir/trace_<pid>_<ns>.json`` when the
    block ends, also when it raises; view it in ui.perfetto.dev or
    chrome://tracing. The block is the ``"device_trace"`` annotation.

    On a card the profiler drops the first kernels of a session as out of
    its window (kineto's "Out-of-range" records), more of them the older
    the process: four minutes into a process on an H100, the first 3 of 10
    launches of a block, with or without idle padding or synchronisation
    around it (PERF.md §6). So the session opens with work of its own on
    the current card (``_opening_burst``), which takes that loss; it lies
    before the block's annotation in the file. Every visible card is
    synchronised before the window closes, so the trace holds the work the
    block queued.
    """
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof = profile(activities=activities)
    _synchronize_all()
    prof.start()
    try:
        if cuda:
            _opening_burst()
        with record_function(BLOCK_MARK):
            yield
    finally:
        _synchronize_all()
        prof.stop()
        prof.export_chrome_trace(path)


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
            _synchronize_all()
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
