"""The harness finds every part of a cell by name, and a later cell,
traffic mix, configuration or metric is a new file and a new entry."""
import json
import os
import re
import shutil

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_finds_its_files():
    bench = harness.load_benchmark()
    for cell in bench["workloads"]:
        cfg = harness.load_config(cell["config"])
        traffic = harness.load_traffic(cell["traffic"])
        assert cfg["name"] == cell["config"]
        assert harness.load_kind(traffic["kind"]).Session
        assert harness.load_limits(cell["name"])
        for section in ("end_to_end", "per_layer"):
            for m in harness.metrics_for(bench, cell["name"], section):
                assert callable(harness.metric_reader(m["name"]))


def test_benchmark_json_keeps_to_its_contract():
    bench = harness.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["reduced"] == harness.load_config(c["name"])["reduced"]
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    layers = {m["layer"] for m in bench["per_layer"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["layer"] in layers
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))
    for w in bench["workloads"]:
        reported = [m["name"] for m in harness.metrics_for(bench, w["name"], "end_to_end")]
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.metrics_for(bench, w["name"], "per_layer")


def test_a_later_cell_is_a_new_file_and_a_new_entry(tmp_path, monkeypatch):
    """A configuration, a traffic mix, a cell's limits and a metric added as
    files of their own are found, with no existing file edited."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    cfg = harness.load_config("gpt2-small")
    cfg["name"] = "gpt2-medium"
    cfg.update(n_embd=1024, n_layer=24, n_head=16)
    (bench_dir / "configs" / "gpt2-medium.json").write_text(json.dumps(cfg))
    traffic = dict(harness.load_traffic("guided-b2048"), batch=512)
    (bench_dir / "traffic" / "guided-b512.json").write_text(json.dumps(traffic))
    (bench_dir / "cells" / "gpt2m-guided-rollout.json").write_text(json.dumps({"limits": {"logit_gap": 0.5}}))
    (bench_dir / "metrics" / "rollouts_per_s.py").write_text(
        "def read(run):\n    return run.window['units'] / run.window['window_s']\n")
    bench = harness.load_benchmark()
    bench["workloads"].append({"name": "gpt2m-guided-rollout", "config": "gpt2-medium", "traffic": "guided-b512",
                               "chips": 1, "why": "a later cell"})
    bench["per_layer"].append({"name": "rollouts_per_s", "unit": "1/s", "better": "higher", "source": "host_clock",
                               "layer": "loops.actor", "moves": "rollout_env_steps_per_s",
                               "workloads": ["gpt2m-guided-rollout"]})
    monkeypatch.setattr(harness, "BENCH_DIR", str(bench_dir))
    cell = harness.find_cell(bench, "gpt2m-guided-rollout")
    assert harness.load_config(cell["config"])["n_layer"] == 24
    assert harness.load_traffic(cell["traffic"])["batch"] == 512
    assert harness.load_limits(cell["name"]) == {"logit_gap": 0.5}
    names = [m["name"] for m in harness.metrics_for(bench, cell["name"], "per_layer")]
    assert "rollouts_per_s" in names and "f32_gemm_ms_per_rollout" not in names
    run = harness.Run(cell, {}, {}, 0, None)
    run.window = {"units": 3, "window_s": 1.5}
    assert harness.metric_reader("rollouts_per_s")(run) == 2.0


def test_a_reader_with_nothing_to_read_returns_nothing():
    bench = harness.load_benchmark()
    run = harness.Run(bench["workloads"][0], {}, {}, 0, None)
    run.window = {"units": 1, "window_s": 1.0, "unit_s": []}
    for m in bench["per_layer"] + bench["end_to_end"]:
        assert harness.metric_reader(m["name"])(run) is None


def test_no_device_no_run(monkeypatch, capsys):
    monkeypatch.setattr(harness.torch.cuda, "is_available", lambda: False)
    assert harness.main(["--workload", "gpt2s-ilql-train", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
