"""Experiment bookkeeping: the port of `lmrl_gym_tpu/core/experiment.py`.

Creates a save directory, snapshots the invoking script and its
arguments, issues unique experiment names, and hands out deterministic
named random streams as `torch.Generator`s.

`SeedStream` folds a stable hash of the stream's name into the seed: the
JAX package folds in `hash(name) % 2**31`, which Python salts per process,
so its streams differ from run to run; the port's do not.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import time
import uuid
import hashlib
from typing import Any, Dict, Optional, Tuple

import torch


def uuid_name(name: str) -> str:
    return f"{name}.{time.strftime('%Y-%m-%d-%H-%M-%S')}.{uuid.uuid4().hex[:8]}"


def setup_experiment_save(
    exp_name: Optional[str],
    outputs_path: Optional[str],
    input_args: Optional[Dict[str, Any]] = None,
    script_path: Optional[str] = None,
    is_main_process: bool = True,
) -> Tuple[Optional[str], str]:
    """→ (save_dir | None, exp_name). Records the args and a copy of the
    launching script inside the save dir."""
    if exp_name is None:
        base = os.path.splitext(os.path.basename(script_path or sys.argv[0]))[0]
        exp_name = uuid_name(base)
    if outputs_path is None:
        return None, exp_name
    save_dir = os.path.join(outputs_path, exp_name)
    if is_main_process:
        os.makedirs(save_dir, exist_ok=True)
        if input_args is not None:
            with open(os.path.join(save_dir, "input_args.json"), "w") as f:
                json.dump({k: repr(v) for k, v in input_args.items()}, f, indent=2)
        if script_path is not None and os.path.exists(script_path):
            shutil.copy(script_path, os.path.join(save_dir, "script.py"))
    return save_dir, exp_name


def convert_path(path: Optional[str]) -> Optional[str]:
    """Paths relative to the port's project root (the directory that holds
    `lmrl_gym_torch/`), overridable with PROJECT_ROOT; absolute and
    gcs:// paths pass through."""
    if path is None:
        return None
    if path.startswith("/") or path.startswith("gcs://"):
        return path
    root = os.environ.get("PROJECT_ROOT", os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    return os.path.join(root, path)


class SeedStream:
    """Deterministic named random streams from one root seed: each call to
    `next(name)` gives a fresh `torch.Generator` seeded from (seed, name,
    the call's index in that stream)."""

    def __init__(self, seed: int):
        self.seed = seed
        self._counters: Dict[str, int] = {}

    def next(self, name: str = "default", device: Any = "cpu") -> torch.Generator:
        idx = self._counters.get(name, 0)
        self._counters[name] = idx + 1
        digest = hashlib.blake2b(f"{self.seed}/{name}/{idx}".encode(), digest_size=8).digest()
        return torch.Generator(device=device).manual_seed(int.from_bytes(digest, "little") >> 1)
