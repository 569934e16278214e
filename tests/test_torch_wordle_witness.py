"""Witness (b) for the Wordle divergence (ROADMAP Queue 3): the port's
Wordle ILQL gate on the card at reduced configurations, each on seeds 5
and 7, looking for one in which the port's ILQL beats its BC by at least
0.3 (sampled return), as it does at full budget; such a configuration is
then run by the JAX gate on the CPU and replayed through the port.

Runs on the card only (no JAX there; `--noconftest`), one process per
case, all started together (the gate is host-paced, so they share the
card well), and writes each result to build/witness/:

    python -m pytest tests/test_torch_wordle_witness.py --noconftest -o addopts="" -m slow -q
"""
import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = ["--layers", "2", "--heads", "4", "--warmup", "100", "--eval-every", "500", "--eval-batch", "256",
          "--optimal-episodes", "0"]
CONFIGS = {  # in the order they are tried
    "A": ["--hidden", "64", "--bsize", "64", "--bc-steps", "2000", "--pbc-steps", "2000", "--ilql-steps", "1500"],
    "B": ["--hidden", "128", "--bsize", "128", "--bc-steps", "3000", "--pbc-steps", "3000", "--ilql-steps", "2000"],
    "C": ["--hidden", "128", "--bsize", "64", "--bc-steps", "4000", "--pbc-steps", "4000", "--ilql-steps", "2000"],
}
SEEDS = (5, 7)
GAP = 0.3


@pytest.mark.slow
@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="runs the port's gate on the card")
def test_reduced_configurations_on_the_card():
    out_dir = os.path.join(ROOT, "build", "witness")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, flags in CONFIGS.items():
        for seed in SEEDS:
            out = os.path.join(out_dir, f"wordle_{name}_s{seed}.json")
            log = open(os.path.join(out_dir, f"wordle_{name}_s{seed}.log"), "w")
            argv = [sys.executable, "-m", "lmrl_gym_torch.scripts.wordle_ilql_gate", *COMMON, *flags,
                    "--seed", str(seed), "--out", out]
            procs[name, seed] = (subprocess.Popen(argv, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT), out)
    gaps = {}
    for (name, seed), (proc, out) in procs.items():
        assert proc.wait() == 0, (name, seed)
        with open(out) as f:
            r = json.load(f)
        gaps[name, seed] = r["ilql_return"] - r["bc_return"]
        assert -6.0 <= r["bc_return"] <= 0.0 and -6.0 <= r["ilql_return"] <= 0.0
    kept = [n for n in CONFIGS if all(gaps[n, s] >= GAP for s in SEEDS)]
    print(f"ILQL - BC per (config, seed): {gaps}; kept: {kept[:1] or 'none'}")
