"""A run of the harness with the timed path broken underneath comes out
not correct: the whole run but the look for a chip, at a tiny size on the
CPU, with the cell's own limits. One case per fault a cell can have (one
chip: no exchange between chips to leave out), and the controls: the plain
reference one precision lower in the program's place.

The controls at the cells' own sizes run on the card (`cuda`):
    python -m pytest benchmark/tests/test_bench_faults.py --noconftest -o addopts="" -m cuda
"""
import time

import pytest
import torch

from benchmark import harness
from benchmark.kinds import guided_rollout, ilql_train
from benchmark.tests.tiny import tiny_inputs

CPU = torch.device("cpu")
SEEDS = (2**31 + 17, 3, 40)


def run_tiny(cell, seed):
    cfg, traffic = tiny_inputs(cell)
    return harness.measure(cell, seed, 0.2, False, CPU, time.perf_counter(), cfg=cfg, traffic=traffic,
                           log=lambda *a: None)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", ["gpt2s-ilql-train", "gptj6b-ilql-train-l6", "gpt2s-guided-rollout"])
def test_sound_tiny_run_is_correct(cell):
    r = run_tiny(cell, SEEDS[0])
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0 and "setup_s" in r["metrics"]
    assert list(r)[-1] == "checks"


def _patch_step(monkeypatch, wrap):
    from lmrl_gym_torch.algos import ilql

    make = ilql.make_ilql_train_step
    monkeypatch.setattr(ilql, "make_ilql_train_step", lambda *a, **k: wrap(make(*a, **k)))


def unchanged(step):
    """The fault: the step computes its loss and returns the state as it was."""
    from lmrl_gym_torch.algos import ilql

    def faulty(state, batch, generator=None):
        core, cfg, pad = faulty.args
        loss, _, _ = ilql.ilql_loss_and_grads(core, state, batch, cfg, pad)
        return state, loss, {}

    faulty.args = None
    return faulty


@pytest.mark.parametrize("cell", ["gpt2s-ilql-train", "gptj6b-ilql-train-l6"])
def test_state_left_unchanged_is_not_correct(cell, monkeypatch):
    from lmrl_gym_torch.algos import ilql

    def make(core, cfg, pad, mesh=None):
        f = unchanged(None)
        f.args = (core, cfg, pad)
        return f

    monkeypatch.setattr(ilql, "make_ilql_train_step", make)
    r = run_tiny(cell, SEEDS[1])
    assert not r["correct"]
    assert r["checks"]["update_norm_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", ["gpt2s-ilql-train", "gptj6b-ilql-train-l6"])
def test_half_the_batch_left_out_is_not_correct(cell, monkeypatch):
    from benchmark.calibrate import half_batch

    _patch_step(monkeypatch, half_batch)
    for seed in SEEDS:
        assert not run_tiny(cell, seed)["correct"]


@pytest.mark.parametrize("cell", ["gpt2s-guided-rollout"])
def test_a_token_altered_where_it_is_produced_is_not_correct(cell, monkeypatch):
    from lmrl_gym_torch.loops import actor

    sample = actor._sample

    def altered(logits, temperature, greedy, generator, gumbel):
        tok = sample(logits, temperature, greedy, generator, gumbel)
        return torch.where(tok == 97, 98, 97) if greedy else tok

    monkeypatch.setattr(actor, "_sample", altered)
    for seed in SEEDS:
        r = run_tiny(cell, seed)
        assert not r["correct"] and r["checks"]["logit_gap"]["value"] > r["checks"]["logit_gap"]["limit"]


@pytest.mark.parametrize("cell", ["gpt2s-guided-rollout"])
def test_an_answer_altered_where_it_is_produced_is_not_correct(cell, monkeypatch):
    from lmrl_gym_torch.envs.wordle import vector

    render = vector.render_feedback
    monkeypatch.setattr(vector, "render_feedback", lambda k, g: torch.where(render(k, g) == 0, 1, 0).to(torch.int8))
    r = run_tiny(cell, SEEDS[2])
    assert not r["correct"] and r["checks"]["env_mismatches"]["value"] > 0


def _session(cell, seed, device, cfg=None, traffic=None):
    bench = harness.load_benchmark()
    c = harness.find_cell(bench, cell)
    run = harness.Run(c, cfg or harness.load_config(c["config"]), traffic or harness.load_traffic(c["traffic"]),
                      seed, device)
    return harness.load_kind(run.traffic["kind"]).Session(run)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["gpt2s-ilql-train", "gptj6b-ilql-train-l6", "gpt2s-guided-rollout"])
def test_control_is_not_correct_at_the_cells_size(cell):
    """The control on the card, at the cell's size: the float8 reference in
    the program's place fails at least one of the cell's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's own size")
    limits = harness.load_limits(cell)
    for seed in (911, 912, 913):
        s = _session(cell, seed, torch.device("cuda", 0))
        if isinstance(s, ilql_train.Session):
            s.release()
            low = s.reference(control=True, keep_first_grads=True)
            numbers = ilql_train.compare(low, s.reference(judge={"control": low.pop("first_grads")}), "control")
        else:
            assert isinstance(s, guided_rollout.Session)
            s.window(0.0)
            s.release()
            numbers = s.compare(control=True)
        assert any(v > limits[k] for k, v in numbers.items() if k in limits), numbers
