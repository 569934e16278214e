"""The benchmark's harness: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything particular to a cell is found by name: the cell in
`BENCHMARK.json` names its configuration (`benchmark/configs/<name>.json`)
and its traffic mix (`benchmark/traffic/<name>.json`), whose `kind` names
the generator and driver (`benchmark/kinds/<kind>.py`); the limits its
comparison is held to are in `benchmark/cells/<cell>.json`; each metric is
read by `benchmark/metrics/<metric>.py`. A later cell, mix or metric is a
new file and a new entry.

A run: refuse without enough CUDA devices; print the device, its power
limit and clocks; set up (the kind builds the program from the seed and
warms every shape the window uses); measure for `--seconds` (with
`--trace 1`, the window's first units under the profiler); read the peak
memory; check that no JAX module was loaded; free the program and compare
what the window produced with the plain reference; print the metrics, then
the compared numbers beside their limits (last on standard error and last
in the result's line).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from types import ModuleType
from typing import List, Optional

import torch

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "lmrl_gym_tpu")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def load_config(name: str) -> dict:
    return _json(os.path.join(BENCH_DIR, "configs", name + ".json"))


def load_traffic(name: str) -> dict:
    return _json(os.path.join(BENCH_DIR, "traffic", name + ".json"))


def load_limits(cell: str) -> dict:
    return _json(os.path.join(BENCH_DIR, "cells", cell + ".json"))["limits"]


def _module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_kind(kind: str) -> ModuleType:
    return importlib.import_module(f"benchmark.kinds.{kind}")


def metric_reader(name: str):
    """`read(run)` of `benchmark/metrics/<name>.py`: the metric's value, or
    None where the run has nothing for it to read."""
    return _module(os.path.join(BENCH_DIR, "metrics", name + ".py"), "benchmark_metric_" + name.replace(".", "_")).read


def metrics_for(bench: dict, cell: str, section: str) -> List[dict]:
    """The entries of `section` ("end_to_end" or "per_layer") the cell
    reports: those listing it, and those that list no cells."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark's process may
    not hold, compared whole (the port's name begins with the JAX
    package's)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


class Clock:
    """Marks between units of work: CUDA events on the card, read after the
    window's final synchronise (no host wait inside the loop); the host
    clock on the CPU."""

    def __init__(self, device: torch.device):
        self.device = device
        self.marks: list = []

    def mark(self) -> None:
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def gaps(self) -> List[float]:
        """Seconds between consecutive marks."""
        m = self.marks
        if self.device.type == "cuda":
            return [a.elapsed_time(b) / 1e3 for a, b in zip(m, m[1:])]
        return [b - a for a, b in zip(m, m[1:])]


def timed_loop(run, seconds: float, tracer, unit, min_units: int = 1):
    """Runs `unit(n)` for n = 0, 1, ... until `seconds` have passed on the
    host clock (and at least `min_units` units, and the traced segments
    are done), then synchronises: (what each unit returned, the window's
    seconds, each unit's seconds). With a tracer, the first units run
    under it, `tracer.units` to a segment."""
    clock = Clock(run.device)
    outs = []
    t0 = time.perf_counter()
    clock.mark()
    while True:
        if tracer is not None and not tracer.done and tracer.prof is None:
            tracer.start()
        outs.append(unit(len(outs)))
        clock.mark()
        if tracer is not None and tracer.prof is not None and len(outs) % tracer.units == 0:
            tracer.stop()
        if time.perf_counter() - t0 >= seconds and len(outs) >= min_units and (tracer is None or tracer.done):
            break
    clock.sync()
    return outs, time.perf_counter() - t0, clock.gaps()


class Run:
    """One run of one cell: what the kind and the metric readers see."""

    def __init__(self, cell: dict, cfg: dict, traffic: dict, seed: int, device: torch.device):
        self.cell, self.cfg, self.traffic, self.seed, self.device = cell, cfg, traffic, seed, device
        self.setup_s: Optional[float] = None
        self.window: dict = {}
        self.trace: Optional[dict] = None


def gpu_line() -> dict:
    """The card as `nvidia-smi` reads it: name, power limit and draw, SM
    clock and its maximum, temperature."""
    fields = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return {"nvidia_smi": f"unavailable: {e}"}
    return {"nvidia_smi": out, "fields": fields}


def measure(cell_name: str, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float,
            cfg: Optional[dict] = None, traffic: Optional[dict] = None, log=print) -> Optional[dict]:
    """Runs the cell once and returns its result line (None when a
    forbidden module was loaded). `cfg` and `traffic` replace the cell's
    own files, for the CPU tests at a tiny size."""
    bench = load_benchmark()
    cell = find_cell(bench, cell_name)
    cfg = cfg or load_config(cell["config"])
    traffic = traffic or load_traffic(cell["traffic"])
    limits = load_limits(cell_name)
    run = Run(cell, cfg, traffic, seed, device)
    kind = load_kind(traffic["kind"])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    session = kind.Session(run)
    run.setup_s = time.perf_counter() - t_start
    from benchmark.trace import Tracer

    tracer = Tracer(traffic["trace_units"], device) if trace else None
    run.window = session.window(seconds, tracer)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr, flush=True)
        return None
    if trace:
        from benchmark.program import route_counts

        run.trace = tracer.summary
        log(json.dumps({"routes": route_counts(), "traced_units": tracer.summary["units"]}))
    session.release()
    numbers = session.compare()
    log(json.dumps({"not_compared": {k: v for k, v in numbers.items() if k not in limits}}))
    checks = {k: {"value": numbers.get(k, float("inf")), "limit": lim} for k, lim in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_for(bench, cell_name, section):
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": run.window.get("attempted", run.window["units"]),
              "failed": run.window["failed"], "metrics": metrics, "device": dev}
    if trace:
        from benchmark.trace import breakdown

        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        result["breakdown"] = breakdown(run.trace)
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = load_benchmark()
    cell = find_cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"this cell needs {cell['chips']} CUDA device(s); found {n}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(json.dumps({"device": torch.cuda.get_device_name(device), "count": torch.cuda.device_count(),
                      "torch": torch.__version__, "cuda": torch.version.cuda, **gpu_line()}), flush=True)
    result = measure(args.workload, args.seed, args.seconds, bool(args.trace), device, t_start)
    if result is None:
        return 3
    print(json.dumps(result), flush=True)
    return 0
