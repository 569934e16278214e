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
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from lmrl_gym_torch.models.config import TransformerConfig


def _t(a) -> torch.Tensor:
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
