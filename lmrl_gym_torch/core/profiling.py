"""Profiling and throughput instrumentation: the port of
`lmrl_gym_tpu/core/profiling.py`.

Step timers with tokens/s and env-steps/s counters, and a
`torch.profiler` trace context that writes a Chrome trace. A phase that
names a tensor in `block_on` waits for that tensor's device before it
stops, so its time covers the device's work, not only the launches.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch


@dataclass
class Throughput:
    """Windowed throughput meter: call .tick(n_items) per step."""

    window: int = 50
    _times: List[float] = field(default_factory=list)
    _counts: List[float] = field(default_factory=list)

    def tick(self, n_items: float = 1.0) -> None:
        self._times.append(time.perf_counter())
        self._counts.append(n_items)
        if len(self._times) > self.window + 1:
            self._times.pop(0)
            self._counts.pop(0)

    def rate(self) -> Optional[float]:
        """items/s over the window (None until 2 ticks)."""
        if len(self._times) < 2:
            return None
        dt = self._times[-1] - self._times[0]
        if dt <= 0:
            return None
        return sum(self._counts[1:]) / dt


def _block(tree: Any) -> None:
    """Wait for the device of every tensor in `tree`."""
    if isinstance(tree, torch.Tensor):
        if tree.device.type == "cuda":
            torch.cuda.synchronize(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _block(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _block(v)


class StepTimer:
    """Accumulates named phase timings (host walls; name the phase's result
    in `block_on` for device-accurate numbers)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            _block(block_on)
        self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "mean_ms": 1000.0 * self.totals[name] / max(self.counts[name], 1),
                "count": self.counts[name],
            }
            for name in self.totals
        }


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """torch.profiler trace (CPU, and CUDA where there is a card) written
    to `log_dir/trace.json`; a no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def tokens_per_second(batch: int, seq_len: int, step_seconds: float) -> float:
    return batch * seq_len / max(step_seconds, 1e-9)
