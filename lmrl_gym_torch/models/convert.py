"""Carry weights from the JAX package's flax parameter trees into the port.

The input is a flax param tree given as nested mappings of numpy arrays
(e.g. `jax.tree.map(np.asarray, params)` on the JAX side); nothing here
imports JAX. The output is a state dict for `load_state_dict`:

- flax Dense kernels are [in, out]; they are transposed into
  `nn.Linear.weight` [out, in];
- `wte/embedding` keeps its padded vocab rows [V_pad, D];
- norm `scale` becomes `weight`.

The same maps carry gradient trees (same structure as the params), so a
test can hold the port's gradients to `jax.grad`'s by name.
`params_to_jax` and `head_params_to_jax` go the other way, so the port
writes checkpoints under the flax key paths (`core/checkpointing.py`).
`encdec_params_from_jax` and `encdec_params_to_jax` do the same for the
T5 `EncoderDecoder` (`models/encdec.py`): flax `Embed` tables
(`embedding`) become `nn.Embedding.weight`, `Dense` kernels are
transposed, `RMSNorm` scales become `weight`, and the block lists
`enc_blocks_<i>` / `dec_blocks_<i>` become `enc_blocks.<i>` / `dec_blocks.<i>`.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from lmrl_gym_torch.models.config import TransformerConfig


def _t(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):  # stays where it is: a rank's block on its mesh, a device tensor on its card
        return a.detach().to(dtype=torch.float32, copy=True)
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(sd: Dict[str, torch.Tensor], prefix: str, node: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(node["kernel"]).T.contiguous()
    if "bias" in node:
        sd[f"{prefix}.bias"] = _t(node["bias"])


def _norm(sd: Dict[str, torch.Tensor], prefix: str, node: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(node["scale"])
    if "bias" in node:
        sd[f"{prefix}.bias"] = _t(node["bias"])


def params_from_jax(tree: Mapping, config: TransformerConfig) -> Dict[str, torch.Tensor]:
    """flax `Transformer` params → the port's `Transformer` state dict."""
    sd: Dict[str, torch.Tensor] = {"wte.weight": _t(tree["wte"]["embedding"])}
    if config.position_embedding == "learned":
        sd["wpe.weight"] = _t(tree["wpe"]["embedding"])
    for i in range(config.num_layers):
        node = tree[f"h_{i}"]
        _norm(sd, f"h.{i}.ln_1", node["ln_1"])
        if not config.parallel_ffn:
            _norm(sd, f"h.{i}.ln_2", node["ln_2"])
        _dense(sd, f"h.{i}.attn.qkv", node["attn"]["qkv"])
        _dense(sd, f"h.{i}.attn.out", node["attn"]["out"])
        names = ("fc", "gate", "proj") if config.gated_mlp else ("fc", "proj")
        for name in names:
            _dense(sd, f"h.{i}.mlp.{name}", node["mlp"][name])
    _norm(sd, "ln_f", tree["ln_f"])
    if not config.tie_word_embeddings:
        _dense(sd, "lm_head", tree["lm_head"])
    return sd


def head_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax `LinearHead` (`dense`) or `MLPHead` (`dense1`, `dense2`) params →
    the port's head state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for name in ("dense", "dense1", "dense2"):
        if name in tree:
            _dense(sd, name, tree[name])
    return sd


def _to_dense(sd: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    node = {"kernel": sd[f"{prefix}.weight"].detach().T.contiguous().cpu()}  # transposed where it lives
    if f"{prefix}.bias" in sd:
        node["bias"] = sd[f"{prefix}.bias"].detach().cpu()
    return node


def _to_norm(sd: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    node = {"scale": sd[f"{prefix}.weight"].detach().cpu()}
    if f"{prefix}.bias" in sd:
        node["bias"] = sd[f"{prefix}.bias"].detach().cpu()
    return node


def params_to_jax(sd: Mapping[str, torch.Tensor], config: TransformerConfig) -> Dict[str, dict]:
    """The inverse of `params_from_jax`: the port's `Transformer` state dict
    → the flax param tree (nested dicts of CPU tensors in the parameters'
    dtype), whose '/'-joined key paths are the JAX package's checkpoint
    keys."""
    tree: Dict[str, dict] = {"wte": {"embedding": sd["wte.weight"].detach().cpu()}}
    if config.position_embedding == "learned":
        tree["wpe"] = {"embedding": sd["wpe.weight"].detach().cpu()}
    for i in range(config.num_layers):
        node = {"ln_1": _to_norm(sd, f"h.{i}.ln_1"),
                "attn": {name: _to_dense(sd, f"h.{i}.attn.{name}") for name in ("qkv", "out")}}
        if not config.parallel_ffn:
            node["ln_2"] = _to_norm(sd, f"h.{i}.ln_2")
        names = ("fc", "gate", "proj") if config.gated_mlp else ("fc", "proj")
        node["mlp"] = {name: _to_dense(sd, f"h.{i}.mlp.{name}") for name in names}
        tree[f"h_{i}"] = node
    tree["ln_f"] = _to_norm(sd, "ln_f")
    if not config.tie_word_embeddings:
        tree["lm_head"] = _to_dense(sd, "lm_head")
    return tree


def head_params_to_jax(sd: Mapping[str, torch.Tensor]) -> Dict[str, dict]:
    """The inverse of `head_params_from_jax`."""
    return {name: _to_dense(sd, name) for name in ("dense", "dense1", "dense2") if f"{name}.weight" in sd}


def ilql_state_from_jax(
    state,
    config: TransformerConfig,
    base: Mapping,
    target_base: Optional[Mapping],
    q1: Mapping,
    q2: Mapping,
    v: Mapping,
    q1_target: Mapping,
    q2_target: Mapping,
):
    """Load the parameter trees of a JAX `ILQLTrainState` (as numpy) into a
    port `ILQLTrainState` built with the same shapes, in place, and return
    it. Optimizer states and step counts are left as they are, so both
    packages start from one state when both are fresh."""
    state.base.params.load_state_dict(params_from_jax(base, config))
    if (target_base is None) != (state.target_base_params is None):
        raise ValueError("the JAX and the port state disagree on use_separate_target_base")
    if target_base is not None:
        state.target_base_params.load_state_dict(params_from_jax(target_base, config))
    _load_heads([(state.q1_head.params, q1), (state.q2_head.params, q2), (state.v_head.params, v),
                 (state.q1_target_params, q1_target), (state.q2_target_params, q2_target)])
    return state


def _load_heads(pairs) -> None:
    for module, tree in pairs:
        module.load_state_dict(head_params_from_jax(tree))


def mc_state_from_jax(state, config: TransformerConfig, base: Mapping, q: Mapping):
    """A JAX `MCTrainState`'s parameter trees (as numpy) into a port
    `MCTrainState`, in place; returns it."""
    state.base.params.load_state_dict(params_from_jax(base, config))
    _load_heads([(state.q_head.params, q)])
    return state


def cql_state_from_jax(
    state,
    config: TransformerConfig,
    base: Mapping,
    target_base: Optional[Mapping],
    q1: Mapping,
    q2: Mapping,
    q1_target: Mapping,
    q2_target: Mapping,
):
    """A JAX `CQLTrainState`'s parameter trees (as numpy) into a port
    `CQLTrainState`, in place; returns it."""
    state.base.params.load_state_dict(params_from_jax(base, config))
    if (target_base is None) != (state.target_base_params is None):
        raise ValueError("the JAX and the port state disagree on use_separate_target_base")
    if target_base is not None:
        state.target_base_params.load_state_dict(params_from_jax(target_base, config))
    _load_heads([(state.q1_head.params, q1), (state.q2_head.params, q2),
                 (state.q1_target_params, q1_target), (state.q2_target_params, q2_target)])
    return state


def ppo_state_from_jax(state, config: TransformerConfig, policy: Mapping, value_head: Mapping):
    """A JAX `PPOTrainState`'s parameter trees (as numpy) into a port
    `PPOTrainState`, in place; returns it."""
    state.policy.params.load_state_dict(params_from_jax(policy, config))
    _load_heads([(state.value_head.params, value_head)])
    return state


def _flatten(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, v


def encdec_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax `EncoderDecoder` params → the port's `EncoderDecoder` state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(tree):
        *mods, name = path.split("/")
        key = re.sub(r"^(enc|dec)_blocks_(\d+)", r"\1_blocks.\2", ".".join(mods))
        t = _t(leaf)
        sd[f"{key}.weight"] = t.T.contiguous() if name == "kernel" else t
    return sd


def encdec_params_to_jax(sd: Mapping[str, torch.Tensor]) -> Dict[str, dict]:
    """The inverse of `encdec_params_from_jax`: nested dicts of CPU tensors
    in the parameters' dtype under the flax key paths."""
    tree: Dict[str, dict] = {}
    for key, t in sd.items():
        mods = re.sub(r"^(enc|dec)_blocks\.(\d+)", r"\1_blocks_\2", key[: -len(".weight")]).split(".")
        t = t.detach()
        if mods[-1] in ("shared", "enc_rel_bias", "dec_rel_bias"):
            name = "embedding"
        elif mods[-1].startswith("ln") or mods[-1].endswith("ln_f"):
            name = "scale"
        else:
            name, t = "kernel", t.T.contiguous()  # transposed where it lives
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = t.cpu()
    return tree
