"""Witness for the maze CQL divergence (ROADMAP Queue 3): the JAX gate's own
spread at `GATE_MAZE_CQL_r05.json`'s flags, at its full budget, on the CPU.

The port's maze CQL gate reads 0.72-0.92 guided-legal accuracy on three
seeds where the JAX record reads 0.96-1.0; on the JAX gate's own initial
weights it swings 0.12-0.96. This file runs `scripts/maze_ilql_gate.py
--algo cql --lr-warmdown --guided-legal` itself (bf16 activations, as on
the TPU) on seed 5 (the record's), seeds 6 and 7 (other data) and seed 5
from another initial draw (every `init_params` / `init_head_params` key
folded with 1), and writes each curve to `build/witness/`; the eval
lines print as they come. A case runs for hours on the CPU (pinned to 2
cores, four at once, BC's 1,660 updates alone took over 90 minutes), so
run the cases as separate processes:

    XLA_FLAGS=--xla_force_host_platform_device_count=1 JAX_PLATFORMS=cpu taskset -c 0,1 \
        python -u -m pytest tests/test_torch_maze_cql_witness.py -m slow -o addopts="" -s -k seed6
"""
import importlib.util
import json
import os

import jax
import pytest

from lmrl_gym_tpu.models import heads as jheads
from lmrl_gym_tpu.models import transformer as jtransformer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--algo", "cql", "--lr-warmdown", "--guided-legal"]
CASES = {"seed5": (5, False), "seed6": (6, False), "seed7": (7, False), "seed5_init1": (5, True)}


def _load_jax_gate():
    spec = importlib.util.spec_from_file_location("jax_maze_ilql_gate",
                                                  os.path.join(ROOT, "scripts", "maze_ilql_gate.py"))
    jgate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jgate)
    return jgate


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_maze_cql_gate_spread(case, monkeypatch):
    seed, other_init = CASES[case]
    if other_init:
        init, head = jtransformer.init_params, jheads.init_head_params
        monkeypatch.setattr(jtransformer, "init_params",
                            lambda config, key, *a, **kw: init(config, jax.random.fold_in(key, 1), *a, **kw))
        monkeypatch.setattr(jheads, "init_head_params",
                            lambda module, dim, key: head(module, dim, jax.random.fold_in(key, 1)))
    out_dir = os.path.join(ROOT, "build", "witness")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"maze_cql_jax_{case}.json")
    result = _load_jax_gate().main(FLAGS + ["--seed", str(seed), "--out", out])
    guided = [p["acc"] for p in result["curve"] if p["kind"] == "cql_guided"]
    assert len(guided) == 6 and all(0.0 <= a <= 1.0 for a in guided)
    with open(out) as f:
        assert json.load(f)["curve"] == result["curve"]
