"""The readings each cell's limits are set from, on the card, at the cell's
own size, in one process (set-up is long, and one process builds the
kernels once):

    python3 benchmark/calibrate.py --workload gpt2s-ilql-train --seeds 12 --control 3 --faults 3

- sound runs: the program on `--seeds` seeds, each compared with the plain
  reference as a run compares it (the lower readings);
- the control: the plain reference computed with the trunk's products in
  float8 (one precision below the configuration's bfloat16), on
  `--control` seeds, in the program's place (the upper readings);
- faults (training kinds), on `--faults` seeds: the step run on half of
  each batch's rows, its loss the mean over them. A step that returns its
  state unchanged reads 1 by construction (no leaf moves), and needs no run.

Prints one JSON line per reading (for a training kind with every leaf's
norms, so other numbers can be worked out from them). Not run by the
benchmark's own runs.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


def half_batch(step):
    """The fault: each update sees the first half of the batch's rows."""

    def faulty(state, batch, generator=None):
        h = batch.input_ids.shape[0] // 2
        return step(state, type(batch)(*(t[:h] for t in batch)), generator)

    return faulty


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first", type=int, default=5000)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    args = p.parse_args(argv)
    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, args.workload)
    cfg, traffic = harness.load_config(cell["config"]), harness.load_traffic(cell["traffic"])
    kind = harness.load_kind(traffic["kind"])
    device = torch.device("cuda", 0)
    train = traffic["kind"] == "ilql_train"

    def out(**kw):
        print(json.dumps(kw), flush=True)

    for i in range(args.seeds):
        seed = args.first + i
        t0 = time.perf_counter()
        run = harness.Run(cell, cfg, traffic, seed, device)
        s = kind.Session(run)
        if not train:
            s.window(0.0)
        s.release()
        if train:
            judge = {"program": s.first_grads}
            low = s.reference(control=True, keep_first_grads=True) if i < args.control else None
            if low is not None:
                judge["control"] = low.pop("first_grads")
            ref = s.reference(judge=judge)
            out(reading="sound", seed=seed, numbers=kind.compare(s.readings, ref), program=s.readings,
                reference=ref, seconds=time.perf_counter() - t0)
            if low is not None:
                out(reading="control", seed=seed, numbers=kind.compare(low, ref, "control"), control=low)
        else:
            out(reading="sound", seed=seed, numbers=s.compare(), gaps=s.gaps, seconds=time.perf_counter() - t0)
            if i < args.control:
                out(reading="control", seed=seed, numbers=s.compare(control=True), gaps=s.gaps)
        del s
    if train:
        for i in range(args.faults):
            seed = args.first + i
            run = harness.Run(cell, cfg, traffic, seed, device)
            orig = kind.Session._checked_steps

            def faulty_steps(self):
                self.step = half_batch(self.step)
                return orig(self)

            kind.Session._checked_steps = faulty_steps
            try:
                s = kind.Session(run)
            finally:
                kind.Session._checked_steps = orig
            s.release()
            out(reading="fault_half_batch", seed=seed, numbers=s.compare(), program=s.readings)
            del s


if __name__ == "__main__":
    main()
