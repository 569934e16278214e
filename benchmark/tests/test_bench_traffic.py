"""Inputs and weights come from `--seed` alone: the same seed gives the
same inputs, another seed other inputs."""
import torch

from benchmark import weights
from benchmark.kinds import guided_rollout, ilql_train
from benchmark.tests.tiny import tiny_inputs

CPU = torch.device("cpu")


def test_ilql_batches_repeat_from_the_seed():
    cfg, tr = tiny_inputs("gpt2s-ilql-train")
    a = ilql_train.make_batches(cfg, tr, 2**31 + 12345, CPU)
    b = ilql_train.make_batches(cfg, tr, 2**31 + 12345, CPU)
    c = ilql_train.make_batches(cfg, tr, 7, CPU)
    assert len(a) == tr["pool"]
    for x, y in zip(a, b):
        assert all(torch.equal(x[k], y[k]) for k in x)
    assert not torch.equal(a[0]["input_ids"], c[0]["input_ids"])
    rows = torch.cat([x["input_ids"] for x in a])
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]  # every row differs
    assert int(rows.max()) < cfg["vocab_size"] - 1  # no token is the pad id
    # the shapes of every batch are the same: one set of shapes to warm up
    assert {tuple(x["input_ids"].shape) for x in a} == {(tr["batch"], tr["seq"])}


def test_weights_repeat_from_the_seed():
    cfg, _ = tiny_inputs("gpt2s-ilql-train")
    spec = weights.model_spec(cfg, ("base", "q1"))
    for g in spec:
        a = dict(weights.draw(spec[g], weights.group_seed(2**32 + 5, g), CPU, torch.float32))
        b = dict(weights.draw(spec[g], weights.group_seed(2**32 + 5, g), CPU, torch.float32))
        c = dict(weights.draw(spec[g], weights.group_seed(6, g), CPU, torch.float32))
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
        assert not torch.equal(a["dense1.weight" if g == "q1" else "wte.weight"],
                               c["dense1.weight" if g == "q1" else "wte.weight"])


def test_weights_cut_from_chunks_like_one_draw(monkeypatch):
    """Leaves drawn across several chunks hold what their chunks give: a
    smaller chunk changes the values but never the shapes or names."""
    cfg, _ = tiny_inputs("gpt2s-ilql-train")
    spec = weights.model_spec(cfg, ("base",))["base"]
    whole = dict(weights.draw(spec, 3, CPU, torch.float32))
    monkeypatch.setattr(weights, "CHUNK", 5000)
    cut = dict(weights.draw(spec, 3, CPU, torch.float32))
    assert {k: v.shape for k, v in whole.items()} == {k: v.shape for k, v in cut.items()}
    assert torch.equal(whole["wte.weight"].flatten()[:100], cut["wte.weight"].flatten()[:100])


def test_game_draws_repeat_from_the_seed():
    g1 = torch.Generator().manual_seed(weights.derived_seed(99, 22))
    g2 = torch.Generator().manual_seed(weights.derived_seed(99, 22))
    a = guided_rollout.gumbel((6, 4, 400), g1, CPU)
    assert torch.equal(a, guided_rollout.gumbel((6, 4, 400), g2, CPU))
    assert torch.isfinite(a).all()
