"""Checkpoint layout and loop-state persistence: the port of
`lmrl_gym_tpu/loops/checkpoints.py` (less `export_hf_format`, which comes
with the HF interop).

A checkpoint directory holds one subdir per module (ILQL: base/,
target_base/, q1_head/, q2_head/, v_head/, q1_target_head/,
q2_target_head/; PPO: policy/, value_head/), each with config.json and
params.msgpack (or train_state.msgpack when optimizer state is saved),
plus loop_state.pkl (step / epoch / round / best_perf / checkpoint queue,
a pickle of a plain dict) for resume.

Modules are written under the flax key paths (`models/convert.py::
params_to_jax`, `head_params_to_jax`), so the JAX package's
`load_module_params(..., target=...)` reads the port's params files and
the port reads the JAX package's. A train_state.msgpack holds `params`
in that layout beside the port's own optimizer state, which is not
optax's: it resumes port to port, and from a JAX train_state.msgpack the
port reads only the `params` subtree, as `load_module_params` does.
"""
from __future__ import annotations

import os
import pickle
import shutil
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch
from torch import nn

from lmrl_gym_torch.core.checkpointing import create_path, load_config, load_pytree, save_config, save_pytree
from lmrl_gym_torch.core.optimizer import TrainState
from lmrl_gym_torch.models.convert import (
    encdec_params_to_jax,
    head_params_from_jax,
    head_params_to_jax,
    params_from_jax,
    params_to_jax,
)
from lmrl_gym_torch.models.encdec import EncoderDecoder
from lmrl_gym_torch.models.transformer import Transformer


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


def module_tree(module: Any) -> Any:
    """A module's parameters as the flax param tree the JAX package saves
    (a trunk, a T5 or a head); any other tree is saved as it is."""
    if isinstance(module, Transformer):
        return params_to_jax(module.state_dict(), module.config)
    if isinstance(module, EncoderDecoder):
        return encdec_params_to_jax(module.state_dict())
    if isinstance(module, nn.Module):
        return head_params_to_jax(module.state_dict())
    return module


def dump_modules(
    save_dir: str,
    modules: Dict[str, Any],  # name → module, TrainState or tree
    configs: Optional[Dict[str, dict]] = None,
    save_dtype: Optional[torch.dtype] = None,
    save_train_state: bool = False,
) -> None:
    """Write one subdir per module. TrainStates save their optimizer state
    too when save_train_state, else params only."""
    create_path(save_dir)
    for name, module in modules.items():
        if module is None:
            continue
        mod_dir = create_path(os.path.join(save_dir, name))
        if isinstance(module, TrainState):
            if save_train_state:
                save_pytree({"params": module_tree(module.params), "opt_state": module.opt_state, "step": module.step},
                            os.path.join(mod_dir, "train_state.msgpack"), dtype=save_dtype)
            else:
                save_pytree(module_tree(module.params), os.path.join(mod_dir, "params.msgpack"), dtype=save_dtype)
        else:
            save_pytree(module_tree(module), os.path.join(mod_dir, "params.msgpack"), dtype=save_dtype)
        if configs and name in configs:
            save_config(configs[name], os.path.join(mod_dir, "config.json"))


def load_module_params(save_dir: str, name: str, target: Any = None, sharding_fn=None) -> Any:
    """The module's params tree (flax layout, CPU tensors) from its
    params.msgpack, else the `params` subtree of its train_state.msgpack."""
    mod_dir = os.path.join(save_dir, name)
    params_path = os.path.join(mod_dir, "params.msgpack")
    ts_path = os.path.join(mod_dir, "train_state.msgpack")
    if os.path.exists(params_path):
        return load_pytree(params_path, target=target, sharding_fn=sharding_fn)
    if os.path.exists(ts_path):
        return load_pytree(ts_path, sharding_fn=sharding_fn)["params"]
    raise FileNotFoundError(f"no checkpoint in {mod_dir}")


def load_module_config(save_dir: str, name: str) -> dict:
    return load_config(os.path.join(save_dir, name, "config.json"))


def _place(loaded: Any, like: Any) -> Any:
    """`loaded` (a tree of CPU tensors) on `like`'s devices and dtypes."""
    if isinstance(like, torch.Tensor):
        return loaded.to(like.device, like.dtype)
    if isinstance(like, dict):
        return {k: _place(loaded[k], v) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_place(a, b) for a, b in zip(loaded, like)))
    if isinstance(like, (list, tuple)):
        return type(like)(_place(a, b) for a, b in zip(loaded, like))
    return loaded


def restore_module(save_dir: str, name: str, module: Any) -> Any:
    """Load a checkpointed module into the port's `module` in place: a
    trunk or a head from its params tree, or a TrainState (its params,
    and its optimizer state and step when a port train_state.msgpack is
    there). Returns `module`."""
    state = module if isinstance(module, TrainState) else None
    target = state.params if state is not None else module
    ts_path = os.path.join(save_dir, name, "train_state.msgpack")
    if state is not None and os.path.exists(ts_path):
        tree = load_pytree(ts_path, target={"params": module_tree(target), "opt_state": state.opt_state,
                                            "step": state.step})
        state.opt_state, state.step = _place(tree["opt_state"], state.opt_state), tree["step"]
        params = tree["params"]
    else:
        params = load_module_params(save_dir, name)
    if isinstance(target, Transformer):
        sd = params_from_jax(params, target.config)
    else:
        sd = head_params_from_jax(params)
    target.load_state_dict(sd)
    return module


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
        if os.path.exists(ckpt_dir):
            shutil.rmtree(ckpt_dir)
        dump_modules(ckpt_dir, modules, configs, save_dtype, save_train_state)
        loop_state.save(os.path.join(ckpt_dir, "loop_state.pkl"))
        if rolling:
            loop_state.saved_checkpoints.append(ckpt_dir)
            if self.max_checkpoints is not None and len(loop_state.saved_checkpoints) > self.max_checkpoints:
                old = loop_state.saved_checkpoints.popleft()
                if os.path.exists(old):
                    shutil.rmtree(old)
        return ckpt_dir
