"""The traced part of a `--trace 1` run: `torch.profiler` over the first
units of the window, reduced from its raw kineto events (the profiler's own
`key_averages` costs ~180 µs a kernel, too slow for GPT-J's ~117,000 kernels
a rollout).

A summary holds each kernel's device seconds and launches, the seconds by
kernel category, the device's busy time (the union of its operations'
intervals, not their sum) and the traced window on the host clock, from a
segment that traces the device alone; and, from a second segment that
traces the host too, the idle gaps between device operations labelled by
the host operation that was running at the gap's middle.
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Tuple

import torch

TRIES = 3  # the profiler now and then records no device event on the card's machine
MAX_LABELLED_GAPS = 5000
TOP = 10


def kernel_category(name: str) -> str:
    """A device operation's category by name: K1-K4 by route (the port's
    csrc/ kernels), GEMMs by operand type, the optimizer's foreach
    kernels, elementwise, reduce, other."""
    for kernel, kid in (("flash_fwd", "K1"), ("flash_bwd_dq", "K2"), ("flash_bwd_dkv", "K3")):
        if f"{kernel}_tc_wide_kernel" in name:
            return f"{kid} {kernel} (tensor cores, Dh > 128)"
        if f"{kernel}_tc_kernel" in name:
            return f"{kid} {kernel} (tensor cores)"
        if f"{kernel}_kernel" in name:
            return f"{kid} {kernel} (CUDA cores)"
    for route in ("split", "wide"):
        if f"decode_attn_{route}_kernel" in name:
            return f"K4 decode_attn ({route})"
    if "decode_attn_kernel" in name:
        return "K4 decode_attn"
    low = name.lower()
    if "multi_tensor_apply" in low:
        return "optimizer (foreach)"
    if "gemm" in low or "nvjet" in low or "cutlass" in low or "xmma" in low:
        return "gemm f32" if "f32f32" in low or "sgemm" in low else "gemm bf16"
    if "elementwise" in low or "vectorized" in low:
        return "elementwise"
    if "reduce" in low:
        return "reduce"
    if low.startswith("memcpy") or low.startswith("memset"):
        return "memory"
    return "other"


def category_seconds(summary: dict, prefix: str) -> float:
    """Device seconds of every category starting with `prefix`."""
    return sum(s for cat, s in summary["categories"].items() if cat.startswith(prefix))


class Tracer:
    """Profiles the window's first units in two segments of `units` units
    each: the device's activity alone (kernel times, busy time, the traced
    window: host events would slow the host, and so the device's idle
    share), then host and device together (the idle gaps' labels).
    `start()` before a segment's first unit, `stop()` after its last (it
    synchronises, so a segment ends when the device is done); `done` after
    both. A device segment with no device event is made again."""

    def __init__(self, units: int, device: torch.device):
        self.units = units
        self.device = device
        self.host_phase = False
        self.tries = 0
        self.done = False
        self.prof = None
        self.summary: Optional[dict] = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        cuda = [ProfilerActivity.CUDA] if self.device.type == "cuda" else []
        acts = [ProfilerActivity.CPU] + cuda if self.host_phase or not cuda else cuda
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        window_s = time.perf_counter() - self.t0
        self.prof.stop()
        s = summarize(self.prof, window_s, self.units)
        self.prof = None
        if self.host_phase:
            self.summary["idle_gaps"] = s["idle_gaps"]
            self.done = True
            return
        if self.device.type == "cuda" and s["busy_s"] == 0:
            self.tries += 1
            if self.tries >= TRIES:
                raise RuntimeError(f"the profiler recorded no device operation in {TRIES} tries")
            return
        self.summary = s
        self.host_phase = True


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(prof, window_s: float, units: int) -> dict:
    kernels: Dict[str, List[float]] = {}
    dev: List[Tuple[int, int]] = []
    host: List[Tuple[int, int, str]] = []
    for e in prof.profiler.kineto_results.events():
        a, d = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name(), [0.0, 0])
            k[0] += d / 1e9
            k[1] += 1
            dev.append((a, a + d))
        elif not e.name().startswith("cuda"):
            host.append((a, a + d, e.name()))
    busy = _merge(dev)
    categories: Dict[str, float] = {}
    for name, (s, _) in kernels.items():
        cat = kernel_category(name)
        categories[cat] = categories.get(cat, 0.0) + s
    return {
        "units": units,
        "window_s": window_s,
        "busy_s": sum(b - a for a, b in busy) / 1e9,
        "kernels": kernels,
        "categories": categories,
        "idle_gaps": _label_gaps(busy, host),
    }


def _label_gaps(busy: List[Tuple[int, int]], host: List[Tuple[int, int, str]]) -> Dict[str, float]:
    """Seconds of device idle between operations, by the innermost host
    operation running at each gap's middle (the longest gaps first)."""
    gaps = sorted(((busy[i + 1][0] - busy[i][1], (busy[i][1] + busy[i + 1][0]) // 2)
                   for i in range(len(busy) - 1)), reverse=True)[:MAX_LABELLED_GAPS]
    host.sort()
    starts = [a for a, _, _ in host]
    out: Dict[str, float] = {}
    for length, mid in gaps:
        label = "host: no profiled operation"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 2000, -1), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        out[label] = out.get(label, 0.0) + length / 1e9
    return out


def breakdown(summary: dict) -> dict:
    """The line's `breakdown`: the device operations that took most time
    and the idle gaps by host operation, at most ten of each."""
    ops = sorted(((n[:160], s) for n, (s, _) in summary["kernels"].items()), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(summary["idle_gaps"].items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n[:160], s] for n, s in gaps]}
