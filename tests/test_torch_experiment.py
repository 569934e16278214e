"""The port's experiment and profiling helpers (`lmrl_gym_torch/core/
{experiment,profiling}.py`) against the JAX package's
(`lmrl_gym_tpu/core/{experiment,profiling}.py`): the same save layout,
names and path rules, meters that count the same, and `SeedStream`'s
streams, which the port makes stable across processes (the JAX package
folds in `hash(name)`, which Python salts per process)."""
import json
import os
import subprocess
import sys

import torch

from lmrl_gym_torch.core import experiment as texp
from lmrl_gym_torch.core import profiling as tprof
from lmrl_gym_tpu.core import experiment as jexp
from lmrl_gym_tpu.core import profiling as jprof

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_setup_experiment_save_matches(tmp_path):
    script = tmp_path / "train.py"
    script.write_text("print('hi')\n")
    args = dict(lr=1e-3, name="x", layers=[1, 2])
    out = {}
    for name, m in (("jax", jexp), ("port", texp)):
        save_dir, exp = m.setup_experiment_save("run1", str(tmp_path / name), args, str(script))
        assert exp == "run1" and save_dir == str(tmp_path / name / "run1")
        with open(os.path.join(save_dir, "input_args.json")) as f:
            out[name] = (json.load(f), sorted(os.listdir(save_dir)))
        assert m.setup_experiment_save("run1", None) == (None, "run1")
        auto = m.setup_experiment_save(None, None, script_path=str(script))[1]
        assert auto.startswith("train.") and len(auto.split(".")[-1]) == 8
    assert out["jax"] == out["port"] and out["port"][1] == ["input_args.json", "script.py"]


def test_convert_path_matches(monkeypatch):
    for p in (None, "/abs/path", "gcs://bucket/x"):
        assert texp.convert_path(p) == jexp.convert_path(p)
    assert texp.convert_path("outputs/a") == os.path.join(ROOT, "outputs/a")  # the port's root is the repo's
    monkeypatch.setenv("PROJECT_ROOT", "/elsewhere")
    assert texp.convert_path("outputs/a") == jexp.convert_path("outputs/a") == "/elsewhere/outputs/a"


def test_seed_stream_is_stable_and_distinct():
    s = texp.SeedStream(3)
    a0, a1, b0 = (torch.rand(4, generator=s.next(n)) for n in ("a", "a", "b"))
    assert not torch.equal(a0, a1) and not torch.equal(a0, b0)
    again = texp.SeedStream(3)
    assert torch.equal(torch.rand(4, generator=again.next("a")), a0)
    assert not torch.equal(torch.rand(4, generator=texp.SeedStream(4).next("a")), a0)
    code = ("import sys, torch; sys.path.insert(0, %r); from lmrl_gym_torch.core.experiment import SeedStream; "
            "s = SeedStream(3); print(torch.rand(4, generator=s.next('a')).tolist())" % ROOT)
    runs = {subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                           env=dict(os.environ, PYTHONHASHSEED=str(seed))).stdout for seed in (1, 2)}
    assert runs == {f"{a0.tolist()}\n"}  # the same stream under different string-hash salts


def test_meters_match(monkeypatch):
    rates = []
    for m in (jprof, tprof):
        clock = iter([0.0, 0.5, 1.5])
        monkeypatch.setattr("time.perf_counter", lambda: next(clock))
        t = m.Throughput(window=2)
        assert t.rate() is None
        for n in (4, 8, 16):
            t.tick(n)
        rates.append(t.rate())
    assert rates[0] == rates[1] == (8 + 16) / 1.5
    monkeypatch.undo()
    timers = {}
    for name, m in (("jax", jprof), ("port", tprof)):
        clock = iter([0.0, 0.25, 1.0, 1.5])
        monkeypatch.setattr("time.perf_counter", lambda: next(clock))
        timer = m.StepTimer()
        for _ in range(2):
            with timer.phase("step", block_on=None):
                pass
        timers[name] = timer.summary()
    monkeypatch.undo()
    assert timers["jax"] == timers["port"] and timers["port"]["step"]["count"] == 2
    assert tprof.tokens_per_second(4, 8, 0.5) == jprof.tokens_per_second(4, 8, 0.5) == 64.0


def test_profiler_trace_and_block_on(tmp_path):
    with tprof.profiler_trace(None):
        pass
    with tprof.profiler_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    timer = tprof.StepTimer()
    with timer.phase("cpu", block_on={"x": torch.ones(2), "y": [torch.zeros(1)]}):
        pass
    assert timer.summary()["cpu"]["count"] == 1


def test_uuid_names():
    a, b = texp.uuid_name("exp"), texp.uuid_name("exp")
    assert a != b and a.split(".")[0] == "exp" and len(a.split(".")) == len(jexp.uuid_name("exp").split("."))
