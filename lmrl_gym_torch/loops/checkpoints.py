"""Checkpoint layout and loop-state persistence: the port of
`lmrl_gym_tpu/loops/checkpoints.py`.

A checkpoint directory holds one subdir per module (ILQL: base/,
target_base/, q1_head/, q2_head/, v_head/, q1_target_head/,
q2_target_head/; PPO: policy/, value_head/), each with config.json and
params.msgpack (or train_state.msgpack when optimizer state is saved),
plus loop_state.pkl (step / epoch / round / best_perf / checkpoint queue,
a pickle of a plain dict) for resume.

Modules are written under the flax key paths (`models/convert.py::
params_to_jax`, `head_params_to_jax`), so the JAX package's
`load_module_params(..., target=...)` reads the port's params files and
the port reads the JAX package's. A train_state.msgpack holds `params`,
`opt_state` and `step` in optax's layout: the port's optimizer state has
optax's tree (`core/optimizer.py`: chain tuples, `ScaleByAdamState`
count/mu/nu, `ScaleByScheduleState`, `MultiStepsState`), so its moments
and accumulators go under the flax key paths and its counts as int32
scalars. A JAX train_state.msgpack thus resumes in the port with its
moments and step, and the port's in JAX (`load_pytree` with optax's
state as the target).

Sharded modules (`parallel/mesh.py`) are gathered whole, on every rank,
and written by the main process only, so a sharded save writes the
unsharded save's bytes; a restore keeps each rank's block, and a sharded
module's params are cut as they are read (`stream_sharding_fn`).
"""
from __future__ import annotations

import os
import pickle
import shutil
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from lmrl_gym_torch.core.checkpointing import (
    create_path,
    load_config,
    load_pytree,
    save_config,
    save_pytree,
    stream_sharding_fn,
)
from lmrl_gym_torch.core.io import is_main_process
from lmrl_gym_torch.core.optimizer import TrainState
from lmrl_gym_torch.models.convert import (
    encdec_params_from_jax,
    encdec_params_to_jax,
    head_params_from_jax,
    head_params_to_jax,
    params_from_jax,
    params_to_jax,
)
from lmrl_gym_torch.models.encdec import EncoderDecoder
from lmrl_gym_torch.models.transformer import Transformer
from lmrl_gym_torch.parallel.mesh import full_state_dict, gather_tree, is_sharded, load_state, shard_like


@dataclass
class LoopState:
    step: int = 0
    epoch: int = 0
    round: int = 0
    best_perf: float = float("-inf")
    saved_checkpoints: deque = field(default_factory=deque)
    wandb_id: Optional[str] = None

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(
                dict(
                    step=self.step,
                    epoch=self.epoch,
                    round=self.round,
                    best_perf=self.best_perf,
                    saved_checkpoints=list(self.saved_checkpoints),
                    wandb_id=self.wandb_id,
                ),
                f,
            )

    @classmethod
    def load(cls, path: str) -> "LoopState":
        with open(path, "rb") as f:
            d = pickle.load(f)
        state = cls(step=d["step"], epoch=d["epoch"], round=d.get("round", 0), best_perf=d["best_perf"],
                    wandb_id=d.get("wandb_id"))
        state.saved_checkpoints = deque(d.get("saved_checkpoints", []))
        return state


def _to_flax(module: nn.Module):
    """{port parameter name: tensor} → the flax tree of `module`'s kind."""
    if isinstance(module, Transformer):
        return lambda sd: params_to_jax(sd, module.config)
    if isinstance(module, EncoderDecoder):
        return encdec_params_to_jax
    return head_params_to_jax


def _from_flax(module: nn.Module):
    if isinstance(module, Transformer):
        return lambda tree: params_from_jax(tree, module.config)
    if isinstance(module, EncoderDecoder):
        return encdec_params_from_jax
    return head_params_from_jax


def module_tree(module: Any) -> Any:
    """A module's parameters as the flax param tree the JAX package saves
    (a trunk, a T5 or a head; gathered whole when sharded); any other tree
    is saved as it is."""
    if isinstance(module, nn.Module):
        return _to_flax(module)(full_state_dict(module))
    return module


def opt_state_to_jax(opt_state: Any, module: nn.Module) -> Any:
    """The port's optimizer state as optax's tree: each per-parameter dict
    as the module's flax tree (gathered whole), each count an int32 scalar."""
    to_flax = _to_flax(module)

    def walk(node):
        if isinstance(node, dict):
            return to_flax(node)
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(x) for x in node))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(x) for x in node)
        if isinstance(node, int):
            return torch.tensor(node, dtype=torch.int32)
        return node

    return walk(gather_tree(opt_state))


def opt_state_from_jax(template: Any, tree: Any, module: nn.Module) -> Any:
    """Optax's state tree (nested dicts as `load_pytree` reads it) into the
    structure of the port's `template` state, each tensor in its template's
    device, dtype and layout (a rank's block when sharded)."""
    from_flax = _from_flax(module)
    device = next(module.parameters()).device

    def walk(node, sub):
        if isinstance(node, dict):
            whole = from_flax(_on(sub, device))
            return {k: shard_like(whole[k], t) for k, t in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(x, (sub or {}).get(f".{f}")) for f, x in zip(node._fields, node)))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(x, (sub or {}).get(str(i))) for i, x in enumerate(node))
        if isinstance(node, int):
            return int(sub)
        return node

    return walk(template, tree)


def dump_modules(
    save_dir: str,
    modules: Dict[str, Any],  # name → module, TrainState or tree
    configs: Optional[Dict[str, dict]] = None,
    save_dtype: Optional[torch.dtype] = None,
    save_train_state: bool = False,
) -> None:
    """Write one subdir per module. TrainStates save their optimizer state
    too when save_train_state, else params only. Every rank calls it (a
    sharded module is gathered); the main process writes."""
    main = is_main_process()
    if main:
        create_path(save_dir)
    for name, module in modules.items():
        if module is None:
            continue
        mod_dir = os.path.join(save_dir, name)
        if isinstance(module, TrainState) and save_train_state:
            tree, path = {"params": module_tree(module.params),
                          "opt_state": opt_state_to_jax(module.opt_state, module.params),
                          "step": module.step}, "train_state.msgpack"
        else:
            params = module.params if isinstance(module, TrainState) else module
            tree, path = module_tree(params), "params.msgpack"
        if main:
            create_path(mod_dir)
            save_pytree(tree, os.path.join(mod_dir, path), dtype=save_dtype)
            if configs and name in configs:
                save_config(configs[name], os.path.join(mod_dir, "config.json"))
    if dist.is_initialized():
        dist.barrier()  # the files are there for every rank


def load_module_params(save_dir: str, name: str, target: Any = None, sharding_fn=None) -> Any:
    """The module's params tree (flax layout, CPU tensors) from its
    params.msgpack, else the `params` subtree of its train_state.msgpack."""
    mod_dir = os.path.join(save_dir, name)
    params_path = os.path.join(mod_dir, "params.msgpack")
    ts_path = os.path.join(mod_dir, "train_state.msgpack")
    if os.path.exists(params_path):
        return load_pytree(params_path, target=target, sharding_fn=sharding_fn)
    if os.path.exists(ts_path):
        params_only = None if sharding_fn is None else (
            lambda key, a: sharding_fn(key, a) if key.startswith("params/") else a)
        return load_pytree(ts_path, sharding_fn=params_only)["params"]
    raise FileNotFoundError(f"no checkpoint in {mod_dir}")


def load_module_config(save_dir: str, name: str) -> dict:
    return load_config(os.path.join(save_dir, name, "config.json"))


def _spec_by_key(module: nn.Module):
    """flax key path → the module's rule spec (a checkpoint key may carry a
    leading 'params/')."""
    import re

    rules = module.config.partition_rules()

    def spec(key: str):
        path = key.split("/", 1)[1] if key.startswith("params/") else key
        return next(s for pattern, s in rules if re.search(pattern, path) is not None)

    return spec


def restore_module(save_dir: str, name: str, module: Any) -> Any:
    """Load a checkpointed module into the port's `module` in place: a
    trunk, a T5 or a head from its params tree, or a TrainState (its
    params, and its optimizer state and step when a train_state.msgpack —
    the port's or the JAX package's — is there). A sharded module keeps
    each rank's block, its params cut as they are read. Returns `module`."""
    state = module if isinstance(module, TrainState) else None
    target = state.params if state is not None else module
    ts_path = os.path.join(save_dir, name, "train_state.msgpack")
    if state is not None and os.path.exists(ts_path):
        tree = load_pytree(ts_path)
        state.opt_state = opt_state_from_jax(state.opt_state, tree["opt_state"], target)
        state.step = int(tree["step"])
        params = tree["params"]
    else:
        sharding_fn = stream_sharding_fn(target.shard_mesh, _spec_by_key(target)) if is_sharded(target) else None
        params = load_module_params(save_dir, name, sharding_fn=sharding_fn)
    load_state(target, _from_flax(target)(_on(params, next(target.parameters()).device)))
    return module


def _on(tree: Any, device) -> Any:
    """A tree's CPU tensors on `device` (a rank's `DTensor` blocks stay), so
    the layout conversions run there."""
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and not hasattr(tree, "device_mesh"):
        return tree.to(device)
    return tree


class CheckpointManager:
    """Rolling checkpoint queue and best-checkpoint tracking."""

    def __init__(self, save_dir: Optional[str], max_checkpoints: Optional[int] = None):
        self.save_dir = save_dir
        self.max_checkpoints = max_checkpoints

    def save(
        self,
        tag: str,
        loop_state: LoopState,
        modules: Dict[str, Any],
        configs: Optional[Dict[str, dict]] = None,
        save_dtype=None,
        save_train_state: bool = False,
        rolling: bool = True,
    ) -> Optional[str]:
        if self.save_dir is None:
            return None
        ckpt_dir = os.path.join(self.save_dir, tag)
        main = is_main_process()
        if main and os.path.exists(ckpt_dir):
            shutil.rmtree(ckpt_dir)
        dump_modules(ckpt_dir, modules, configs, save_dtype, save_train_state)
        if main:
            loop_state.save(os.path.join(ckpt_dir, "loop_state.pkl"))
        if rolling:
            loop_state.saved_checkpoints.append(ckpt_dir)
            if self.max_checkpoints is not None and len(loop_state.saved_checkpoints) > self.max_checkpoints:
                old = loop_state.saved_checkpoints.popleft()
                if main and os.path.exists(old):
                    shutil.rmtree(old)
        if dist.is_initialized():
            dist.barrier()
        return ckpt_dir


def export_hf_format(params: Any, config: dict, out_dir: str) -> None:
    """Export params + config for downstream HF-style consumption: msgpack
    weights (`flax_model.msgpack`, under the flax key paths for a port
    module; the JAX package's `load_pytree` reads it) and `config.json`."""
    create_path(out_dir)
    save_pytree(module_tree(params), os.path.join(out_dir, "flax_model.msgpack"))
    save_config(config, os.path.join(out_dir, "config.json"))
