"""Seeded weights for both sides of a comparison.

The benchmark makes every weight itself, on the device, from `--seed`, and
hands the same values to the program (copied into its modules by name) and
to the plain reference. `model_spec` lists a model's leaves from the
configuration file alone, in a fixed order, under GPT-2 / GPT-J names;
`draw` fills them from a few large normal draws (`CHUNK` elements each) of
one `torch.Generator` on the device, in the dtype they are used in. The
same call gives the same bits again, so the reference regenerates what the
program was given instead of reading it back from the program.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import torch

CHUNK = 1 << 28  # elements per normal draw
STD = 0.02  # matrices, embeddings, biases
NORM_STD = 0.05  # layer-norm scales draw around 1

Leaf = Tuple[str, Tuple[int, ...], float, float, bool]  # name, shape, mean, std, rows centred


def padded_vocab(cfg: dict) -> int:
    m = cfg["assumed"]["pad_vocab_to_multiple"]
    return (cfg["vocab_size"] + m - 1) // m * m


def derived_seed(seed: int, purpose: int) -> int:
    """A seed of its own for each use of `--seed` (weights, traffic, draws)."""
    return (seed * 1_000_003 + purpose * 7_919) % (1 << 63)


def trunk_spec(cfg: dict, qkv_std: float = STD) -> List[Leaf]:
    """The trunk's leaves: GPT-2 (learned positions, serial MLP, tied
    embeddings, biases everywhere) or GPT-J (rotary, parallel MLP, no
    attention biases, untied lm_head with a bias). `qkv_std` sets how
    sharp the attention is: at init its logits spread by about
    n_embd·qkv_std² (GPT-2-small at 0.02: ~0.3, every position attending
    nearly evenly)."""
    gptj = cfg["model_type"] == "gptj"
    D, V, L = cfg["n_embd"], padded_vocab(cfg), cfg["n_layer"]
    M = cfg["n_inner"] or 4 * D
    out: List[Leaf] = [("wte.weight", (V, D), 0.0, STD, False)]
    if not gptj:
        out.append(("wpe.weight", (cfg["n_positions"], D), 0.0, STD, False))
    for i in range(L):
        p = f"h.{i}."
        out += [(p + "ln_1.weight", (D,), 1.0, NORM_STD, False), (p + "ln_1.bias", (D,), 0.0, STD, False),
                (p + "attn.qkv.weight", (3 * D, D), 0.0, qkv_std, False)]
        if not gptj:
            out.append((p + "attn.qkv.bias", (3 * D,), 0.0, STD, False))
        out.append((p + "attn.out.weight", (D, D), 0.0, STD, False))
        if not gptj:
            out += [(p + "attn.out.bias", (D,), 0.0, STD, False),
                    (p + "ln_2.weight", (D,), 1.0, NORM_STD, False), (p + "ln_2.bias", (D,), 0.0, STD, False)]
        out += [(p + "mlp.fc.weight", (M, D), 0.0, STD, False), (p + "mlp.fc.bias", (M,), 0.0, STD, False),
                (p + "mlp.proj.weight", (D, M), 0.0, STD, False), (p + "mlp.proj.bias", (D,), 0.0, STD, False)]
    out += [("ln_f.weight", (D,), 1.0, NORM_STD, False), ("ln_f.bias", (D,), 0.0, STD, False)]
    if not cfg["tie_word_embeddings"]:
        out += [("lm_head.weight", (V, D), 0.0, STD, False), ("lm_head.bias", (V,), 0.0, STD, False)]
    return out


def head_spec(d_in: int, hidden: int, d_out: int) -> List[Leaf]:
    """An MLP head: dense1 → gelu → dense2, both with biases. Each output's
    row of dense2 sums to zero: the gelu's outputs share a positive mean, and
    rows drawn freely would give every output a fixed offset, the same at
    every position (with β = 32 one letter then wins everywhere, and a
    rollout's greedy guesses collapse onto a few words)."""
    return [("dense1.weight", (hidden, d_in), 0.0, STD, False), ("dense1.bias", (hidden,), 0.0, STD, False),
            ("dense2.weight", (d_out, hidden), 0.0, STD, True), ("dense2.bias", (d_out,), 0.0, STD, False)]


def head_shape(cfg: dict, group: str) -> Tuple[int, int, int]:
    """(input, hidden, output) of a head: "q1" / "q2" vocab-wide, "v"
    scalar."""
    a = cfg["assumed"]
    if group == "v":
        return cfg["n_embd"], a["v_head_hidden"], 1
    return cfg["n_embd"], a["q_head_hidden"], padded_vocab(cfg)


def model_spec(cfg: dict, groups: Tuple[str, ...], qkv_std: float = STD) -> Dict[str, List[Leaf]]:
    """{group: leaves}: the trunks ("base", "pi_beta") and heads ("q1",
    "q2", "v") a kind trains or serves."""
    return {g: trunk_spec(cfg, qkv_std) if g in ("base", "pi_beta") else head_spec(*head_shape(cfg, g))
            for g in groups}


def draw(leaves: List[Leaf], seed: int, device, dtype: torch.dtype) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) for each leaf in order: mean + std·N(0, 1) (centred
    rows less their mean first), cut from
    normal draws of up to `CHUNK` elements made on `device` in `dtype`
    (a leaf larger than a chunk gets a draw of its own)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    i = 0
    while i < len(leaves):
        j, n = i, 0
        while j < len(leaves) and (j == i or n + _numel(leaves[j]) <= CHUNK):
            n += _numel(leaves[j])
            j += 1
        flat = torch.randn(n, generator=gen, device=device, dtype=dtype)
        off = 0
        for leaf in leaves[i:j]:
            name, shape, mean, std, centred = leaf
            k = _numel(leaf)
            t = flat[off:off + k].view(shape)
            if centred:
                t = t - t.mean(dim=-1, keepdim=True)
            yield name, t.mul(std).add(mean)
            off += k
        del flat
        i = j


def _numel(leaf: Leaf) -> int:
    n = 1
    for s in leaf[1]:
        n *= s
    return n


def group_seed(seed: int, group: str) -> int:
    return derived_seed(seed, {"base": 1, "pi_beta": 2, "q1": 3, "q2": 4, "v": 5}[group])
