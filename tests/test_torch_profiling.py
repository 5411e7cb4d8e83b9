"""The port's profiling helpers (``inference_tpu_torch.utils.profiling``) on
the CPU: the JAX package's ``PhaseTimer`` case on torch operations, the
summary's format (JAX's, line for line), and ``device_trace`` writing a
Chrome trace that names an operation run inside it, also when the block
raises."""

import glob
import json
import os
import re

import numpy as np
import pytest
import torch

from inference_tpu.utils import PhaseTimer as JaxPhaseTimer
from inference_tpu_torch.utils import PhaseTimer, device_trace


def test_phase_timer_accumulates():
    timer = PhaseTimer()
    for _ in range(3):
        with timer.phase("matmul"):
            a = torch.ones((64, 64))
            a @ a
    with timer.phase("sum"):
        torch.arange(100).sum()

    assert timer.counts["matmul"] == 3
    assert timer.counts["sum"] == 1
    assert timer.totals["matmul"] > 0
    summary = timer.summary()
    assert "matmul" in summary and "sum" in summary


def test_phase_timer_counts_a_phase_that_raises():
    timer = PhaseTimer()
    with pytest.raises(ValueError):
        with timer.phase("failing"):
            raise ValueError("inside the phase")
    assert timer.counts["failing"] == 1 and timer.totals["failing"] >= 0.0


def test_summary_format_is_jax():
    """The same totals and counts print the same summary as JAX's."""
    ours, theirs = PhaseTimer(), JaxPhaseTimer()
    for timer in (ours, theirs):
        timer.totals.update({"advance": 12.3456, "swap": 0.5, "io": 3.0})
        timer.counts.update({"advance": 1000, "swap": 7, "io": 3})
    assert ours.summary() == theirs.summary()
    lines = ours.summary().splitlines()
    assert lines[0] == "[ PhaseTimer summary ]"
    assert [line.split(":")[0].strip() for line in lines[1:]] == ["advance", "io", "swap"]
    assert re.fullmatch(r"\s+advance:\s+12\.346s total,\s+1000 calls,\s+12\.35 ms/call",
                        lines[1])


def _events(log_dir):
    files = glob.glob(os.path.join(log_dir, "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


def test_device_trace_writes_a_trace_naming_the_op(tmp_path):
    a = torch.as_tensor(np.random.default_rng(0).normal(size=(96, 96)))
    with device_trace(str(tmp_path / "trace")):
        torch.linalg.cholesky(a @ a.T + 96 * torch.eye(96, dtype=a.dtype))
    names = {e.get("name") for e in _events(str(tmp_path / "trace"))}
    assert "aten::linalg_cholesky_ex" in names and "aten::matmul" in names


def test_device_trace_stops_when_the_block_raises(tmp_path):
    with pytest.raises(RuntimeError, match="inside the trace"):
        with device_trace(str(tmp_path / "t")):
            torch.ones(3).sum()
            raise RuntimeError("inside the trace")
    assert "aten::sum" in {e.get("name") for e in _events(str(tmp_path / "t"))}
    # the profiler was stopped: a second trace starts cleanly
    with device_trace(str(tmp_path / "u")):
        torch.zeros(2).add_(1)
    assert "aten::add_" in {e.get("name") for e in _events(str(tmp_path / "u"))}


def test_device_trace_marks_the_block(tmp_path):
    """The block is one ``"device_trace"`` annotation in the trace file,
    and the operations run inside the block lie within its span."""
    with device_trace(str(tmp_path / "t")):
        torch.ones(4).sum()
    events = [e for e in _events(str(tmp_path / "t")) if e.get("ph") != "M"]
    marks = [e for e in events if e.get("name") == "device_trace"]
    assert len(marks) == 1
    start, end = float(marks[0]["ts"]), float(marks[0]["ts"]) + float(marks[0]["dur"])
    inside = [e for e in events if e.get("name") == "aten::sum"]
    assert inside and all(start <= float(e["ts"]) <= end for e in inside)
