"""Tiny stand-ins for a cell's configuration and traffic, so a whole run of
the harness fits a CPU test: the cell's own files with the widths, depth,
vocab and batch cut down."""
from benchmark import harness


def tiny_cfg(config: str) -> dict:
    c = harness.load_config(config)
    gptj = c["model_type"] == "gptj"
    c.update(vocab_size=259, n_embd=64, n_layer=2, n_head=2 if gptj else 4, n_positions=160)
    if gptj:
        c["rotary_dim"] = 16
    c["assumed"] = dict(c["assumed"], pad_vocab_to_multiple=64, q_head_hidden=128, v_head_hidden=128)
    return c


def tiny_traffic(traffic: str) -> dict:
    t = harness.load_traffic(traffic)
    if t["kind"] == "ilql_train":
        t.update(batch=4, seq=16, next_seq=4, pool=4, row_block=2, trace_units=2)
    else:
        t.update(batch=4, check_games=3, trace_units=1)
    return t


def tiny_inputs(cell: str):
    c = harness.find_cell(harness.load_benchmark(), cell)
    return tiny_cfg(c["config"]), tiny_traffic(c["traffic"])
