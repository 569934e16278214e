"""No JAX in the benchmark's process, and nothing of the program in the
reference: checked in fresh interpreters, by whole top-level names."""
import json
import os
import subprocess
import sys

from benchmark import harness

MODULES = ["benchmark.harness", "benchmark.flops", "benchmark.weights", "benchmark.trace", "benchmark.program",
           "benchmark.calibrate", "benchmark.kinds.ilql_train", "benchmark.kinds.guided_rollout",
           "benchmark.reference.gpt", "benchmark.reference.ilql", "benchmark.reference.wordle"]


def loaded_after(imports, extra=""):
    code = ("import importlib, json, sys\n"
            f"for m in {imports!r}: importlib.import_module(m)\n"
            f"{extra}\n"
            "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_reference_load_no_jax():
    readers = ("from benchmark import harness\n"
               "for s in ('end_to_end', 'per_layer'):\n"
               "    for m in harness.load_benchmark()[s]: harness.metric_reader(m['name'])\n"
               "import lmrl_gym_torch.algos.ilql, lmrl_gym_torch.loops.actor, lmrl_gym_torch.ops.flash_attention")
    top = loaded_after(MODULES, readers)
    assert not top & set(harness.FORBIDDEN)
    assert "lmrl_gym_torch" in top  # the program is loaded, and compared whole, not by prefix


def test_reference_loads_nothing_of_the_program():
    top = loaded_after(["benchmark.reference.gpt", "benchmark.reference.ilql", "benchmark.reference.wordle"])
    assert "lmrl_gym_torch" not in top and not top & set(harness.FORBIDDEN)


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlike_pkg", sys)
    monkeypatch.setitem(sys.modules, "lmrl_gym_tpu_extra", sys)
    assert "jax" not in harness.forbidden_modules() and "lmrl_gym_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax.linen", sys)
    assert "flax" in harness.forbidden_modules()
